// Persistent LSTM and GRU scans, forward and backward, for Hopper (sm_90a).
// The GRU kernels (K10/K11) follow the LSTM ones; their own note is at
// gru_fwd_kernel below.
//
// Replaces the Pallas kernels of bigdl_tpu/ops/fused_rnn.py:
//   * lstm_fwd_kernel<T, SAVE=true>  <- _lstm_fwd_kernel (K6) and
//     _bilstm_fwd_kernel (K8);
//   * lstm_fwd_kernel<T, SAVE=false> <- _lstm_fwd_infer_kernel and
//     _bilstm_fwd_infer_kernel (the no-residual variants);
//   * lstm_bwd_kernel<T>             <- _lstm_bwd_kernel (K7) and
//     _bilstm_bwd_kernel (K9).
// The step bodies are those of _lstm_fwd_dir / _lstm_bwd_dir /
// _lstm_gate_math. One launch runs one or two directions: the grid is
// (batch tiles, directions), and a direction with `reverse` set walks
// time from T-1 down to 0 while reading and writing the true-time slots,
// as the TPU kernels' mirrored index maps do. Nothing is flipped.
//
// Layout (the public (N, T, .) layout, no transposes): zx, gates, dzx
// (N, T, 4H); ys, c, dy (N, T, H); w (H, 4H) row-major, gates in the
// order i, f, g, o; wt = w transposed, (4H, H); dw (tiles, H, 4H) fp32.
// zx, w and every sequence share one dtype T (fp32 or bf16).
//
// Numerics (kept from the Pallas kernels, and by the plain versions in
// bigdl_tpu_torch/ops/fused_rnn.py):
//   * h and c carries in fp32; h rounded to T before h . W, the product
//     accumulated in fp32; z = zx + h . W;
//   * ys, c and the activated gates stored in T;
//   * backward: h_prev and c_prev read back from the stored sequences,
//     zero at the direction's first step; dz in fp32, stored as dzx in
//     T and rounded to T for both products (dh = dz . W^T and
//     dW += h_prev^T . dz); dc carried in fp32.
//
// What bounds it: at the trainer's shape (N = 128, T = 128, H = 128,
// bf16, two directions) the forward moves ~34 MB (zx in; ys, c, gates
// out) and does 2 * 4H * H * N * T * 2 = 4.3 GFLOP of recurrent products;
// the backward moves ~50 MB and does twice the products. At the card's
// rates both are a few to ~15 us of work. The real limit is the
// recurrence: T dependent steps, each a small (BN, H) x (H, 4H) product
// with a barrier, so a step's latency, not the card's rate, sets the
// time. This first design keeps it simple:
// * one CTA of 512 threads owns kBlockN = 4 batch rows of one direction
//   for the whole sequence (tiles of 8 and 16 rows were slower: fewer
//   CTAs for the same per-step latency; PERF.md). Rows never mix, so no grid-wide barrier is needed;
//   the h/c (dh/dc) carries live in shared memory;
// * W (H x 4H) does not fit in shared memory at H = 128 in fp32
//   (256 KB), so each step streams it from L2 (coalesced along the 4H
//   columns); splitting W across CTAs or a cluster is later work;
// * forward step: each thread computes whole gate-columns of z for the
//   BN rows (h broadcast from shared memory as float4), then each thread
//   applies the gate math to (row, unit) pairs;
// * backward step: the gate-derivative chain over (row, unit) pairs,
//   then dh = dz . W^T with the 4H reduction split over up to 4 thread
//   groups and summed in a fixed order; after the sweep, the same CTA
//   computes its tile's dW = sum_t h_prev^T . dz from the dzx it wrote,
//   in shared-memory-staged blocks;
// * every sum runs in a fixed order and dW has no atomics: two runs
//   give the same bits. Rows past N are masked, never read or written.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlockN = 4;  // batch rows per CTA
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (H100)
constexpr int kMaxHidden = 512;
constexpr int kDwRows = 32;  // (t, row) pairs per staged dW block
constexpr int kDwK = 32;     // h_prev columns per staged dW block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, back in fp32 (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T>
struct FwdDir {
  const T* zx;
  const T* w;
  T* ys;
  T* c;
  T* g;
  int reverse;
};

template <typename T>
struct FwdArgs {
  FwdDir<T> d[2];
  int n, t, h;
};

template <typename T>
struct BwdDir {
  const T* wt;
  const T* ys;
  const T* c;
  const T* g;
  const T* dy;
  T* dzx;
  float* dw;
  int reverse;
};

template <typename T>
struct BwdArgs {
  BwdDir<T> d[2];
  int n, t, h;
};

// acc[r] += h[k][r] * w for the BN rows, h stored (k, BN) in shared
// memory so the BN values are float4 broadcasts.
template <int BN>
__device__ __forceinline__ void fma_rows(float* acc, const float* hk,
                                         float w) {
  const float4* h4 = reinterpret_cast<const float4*>(hk);
#pragma unroll
  for (int q = 0; q < BN / 4; ++q) {
    const float4 v = h4[q];
    acc[4 * q + 0] += v.x * w;
    acc[4 * q + 1] += v.y * w;
    acc[4 * q + 2] += v.z * w;
    acc[4 * q + 3] += v.w * w;
  }
}

// Forward. Shared memory: hop (H, BN) the h operand rounded to T,
// cs (BN, H) the c carry, zs (BN, 4H) the step's recurrent products.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(FwdArgs<T> a) {
  constexpr int BN = kBlockN;
  FwdDir<T> d = a.d[0];
  if (blockIdx.y == 1) d = a.d[1];
  const int H = a.h, H4 = 4 * a.h, nt = a.t;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  extern __shared__ __align__(16) float smem[];
  float* hop = smem;
  float* cs = hop + H * BN;
  float* zs = cs + BN * H;
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    hop[i] = 0.f;
    cs[i] = 0.f;
  }
  __syncthreads();
  for (int s = 0; s < nt; ++s) {
    const int t = d.reverse ? nt - 1 - s : s;
    // z's recurrent half, one gate-column per thread and pass
    for (int j = threadIdx.x; j < H4; j += kThreads) {
      float acc[BN];
#pragma unroll
      for (int r = 0; r < BN; ++r) acc[r] = 0.f;
      const T* wcol = d.w + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k)
        fma_rows<BN>(acc, hop + k * BN, to_f32(wcol[(size_t)k * H4]));
#pragma unroll
      for (int r = 0; r < BN; ++r) zs[r * H4 + j] = acc[r];
    }
    __syncthreads();
    // gates, carries and stores over the (row, unit) pairs
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const T* zx = d.zx + row * H4;
      const float* z = zs + r * H4;
      const float gi = sigmoid(to_f32(zx[u]) + z[u]);
      const float gf = sigmoid(to_f32(zx[H + u]) + z[H + u]);
      const float gg = tanhf(to_f32(zx[2 * H + u]) + z[2 * H + u]);
      const float go = sigmoid(to_f32(zx[3 * H + u]) + z[3 * H + u]);
      const float c = gf * cs[r * H + u] + gi * gg;
      const float h = go * tanhf(c);
      cs[r * H + u] = c;
      hop[u * BN + r] = round_to<T>(h);
      d.ys[row * H + u] = from_f32<T>(h);
      if (SAVE) {
        d.c[row * H + u] = from_f32<T>(c);
        T* g = d.g + row * H4;
        g[u] = from_f32<T>(gi);
        g[H + u] = from_f32<T>(gf);
        g[2 * H + u] = from_f32<T>(gg);
        g[3 * H + u] = from_f32<T>(go);
      }
    }
    __syncthreads();
  }
}

// Groups the 4H reduction of dh = dz . W^T splits over (fixed order).
__host__ __device__ __forceinline__ int dh_parts(int h) {
  return h <= kThreads / 4 ? 4 : (h <= kThreads / 2 ? 2 : 1);
}

// Backward. Shared memory: dzs (4H, BN) dz rounded to T, dhs and dcs
// (BN, H) the carries, red (parts, BN, H) dh partial sums when the 4H
// reduction is split, hs (kDwRows, kDwK) the staged h_prev block of dW.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(BwdArgs<T> a) {
  constexpr int BN = kBlockN;
  BwdDir<T> d = a.d[0];
  if (blockIdx.y == 1) d = a.d[1];
  const int H = a.h, H4 = 4 * a.h, nt = a.t;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int parts = dh_parts(H);
  extern __shared__ __align__(16) float smem[];
  float* dzs = smem;
  float* dhs = dzs + H4 * BN;
  float* dcs = dhs + BN * H;
  float* hs = dcs + BN * H;
  float* red = hs + kDwRows * kDwK;
  for (int i = threadIdx.x; i < H4 * BN; i += kThreads) dzs[i] = 0.f;
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    dhs[i] = 0.f;
    dcs[i] = 0.f;
  }
  __syncthreads();
  for (int s = 0; s < nt; ++s) {
    // forward direction: t = T-1-s, previous step t-1; reverse
    // direction: its time runs T-1 -> 0, so t = s, previous step t+1
    const int t = d.reverse ? s : nt - 1 - s;
    const int prev = d.reverse ? t + 1 : t - 1;
    const bool live = d.reverse ? (t < nt - 1) : (t > 0);
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const T* g = d.g + row * H4;
      const float gi = to_f32(g[u]), gf = to_f32(g[H + u]);
      const float gg = to_f32(g[2 * H + u]), go = to_f32(g[3 * H + u]);
      const float c = to_f32(d.c[row * H + u]);
      const float cp =
          live ? to_f32(d.c[((size_t)(n0 + r) * nt + prev) * H + u]) : 0.f;
      const float dh = to_f32(d.dy[row * H + u]) + dhs[r * H + u];
      const float tc = tanhf(c);
      const float do_pre = dh * tc * go * (1.f - go);
      const float dc = dcs[r * H + u] + dh * go * (1.f - tc * tc);
      const float di_pre = dc * gg * gi * (1.f - gi);
      const float df_pre = dc * cp * gf * (1.f - gf);
      const float dg_pre = dc * gi * (1.f - gg * gg);
      T* dz = d.dzx + row * H4;
      dz[u] = from_f32<T>(di_pre);
      dz[H + u] = from_f32<T>(df_pre);
      dz[2 * H + u] = from_f32<T>(dg_pre);
      dz[3 * H + u] = from_f32<T>(do_pre);
      dzs[u * BN + r] = round_to<T>(di_pre);
      dzs[(H + u) * BN + r] = round_to<T>(df_pre);
      dzs[(2 * H + u) * BN + r] = round_to<T>(dg_pre);
      dzs[(3 * H + u) * BN + r] = round_to<T>(do_pre);
      dcs[r * H + u] = dc * gf;
    }
    __syncthreads();
    // dh carry = dz . W^T: column k of W^T per thread, the 4H terms
    // split into `parts` contiguous ranges
    {
      const int per = kThreads / parts;
      const int part = threadIdx.x / per;
      const int span = H4 / parts;
      for (int k = threadIdx.x % per; k < H; k += per) {
        float acc[BN];
#pragma unroll
        for (int r = 0; r < BN; ++r) acc[r] = 0.f;
        const T* wcol = d.wt + k;
#pragma unroll 4
        for (int j = part * span; j < (part + 1) * span; ++j)
          fma_rows<BN>(acc, dzs + j * BN, to_f32(wcol[(size_t)j * H]));
        float* dst = parts > 1 ? red + part * BN * H : dhs;
#pragma unroll
        for (int r = 0; r < BN; ++r) dst[r * H + k] = acc[r];
      }
    }
    __syncthreads();
    if (parts > 1) {
      for (int i = threadIdx.x; i < BN * H; i += kThreads) {
        float v = red[i];
        for (int q = 1; q < parts; ++q) v += red[q * BN * H + i];
        dhs[i] = v;
      }
      __syncthreads();
    }
  }
  // this tile's dW = sum over (t, row) of h_prev^T . dz, read back from
  // the dzx this block wrote (visible to the block after the barrier)
  float* dw = d.dw + (size_t)blockIdx.x * H * H4;
  const int m_total = nt * nr;
  for (int j0 = 0; j0 < H4; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    for (int k0 = 0; k0 < H; k0 += kDwK) {
      float acc[kDwK];
#pragma unroll
      for (int kk = 0; kk < kDwK; ++kk) acc[kk] = 0.f;
      for (int m0 = 0; m0 < m_total; m0 += kDwRows) {
        __syncthreads();
        for (int i = threadIdx.x; i < kDwRows * kDwK; i += kThreads) {
          const int m = m0 + i / kDwK, k = k0 + i % kDwK;
          float v = 0.f;
          if (m < m_total && k < H) {
            const int t = m / nr, r = m - (m / nr) * nr;
            const int prev = d.reverse ? t + 1 : t - 1;
            const bool live = d.reverse ? (t < nt - 1) : (t > 0);
            if (live)
              v = round_to<T>(
                  to_f32(d.ys[((size_t)(n0 + r) * nt + prev) * H + k]));
          }
          hs[i] = v;
        }
        __syncthreads();
        if (j < H4) {
          const int mend = min(kDwRows, m_total - m0);
          for (int mm = 0; mm < mend; ++mm) {
            const int m = m0 + mm;
            const int t = m / nr, r = m - t * nr;
            const float dz =
                to_f32(d.dzx[((size_t)(n0 + r) * nt + t) * H4 + j]);
            fma_rows<kDwK>(acc, hs + mm * kDwK, dz);
          }
        }
      }
      if (j < H4) {
        for (int kk = 0; kk < kDwK && k0 + kk < H; ++kk)
          dw[(size_t)(k0 + kk) * H4 + j] = acc[kk];
      }
    }
  }
}

size_t fwd_smem(int h) { return (size_t)6 * h * kBlockN * sizeof(float); }

size_t bwd_smem(int h) {
  const int parts = dh_parts(h);
  return ((size_t)4 * h * kBlockN + 2 * (size_t)kBlockN * h +
          kDwRows * kDwK + (parts > 1 ? (size_t)parts * kBlockN * h : 0)) *
         sizeof(float);
}

template <typename T, bool SAVE>
cudaError_t launch_fwd(const FwdArgs<T>& a, int ndir, cudaStream_t s) {
  const size_t smem = fwd_smem(a.h);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(lstm_fwd_kernel<T, SAVE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + kBlockN - 1) / kBlockN, ndir);
  lstm_fwd_kernel<T, SAVE><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs<T>& a, int ndir, cudaStream_t s) {
  const size_t smem = bwd_smem(a.h);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + kBlockN - 1) / kBlockN, ndir);
  lstm_bwd_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int ndir, int n, int t, int h) {
  return ndir < 1 || ndir > 2 || n < 1 || t < 1 || h < 1 || h > kMaxHidden;
}

template <typename T>
cudaError_t fwd_typed(const void* const* zx, const void* const* w,
                      void* const* ys, void* const* c, void* const* g,
                      const int* rev, int ndir, int n, int t, int h,
                      int save, cudaStream_t s) {
  FwdArgs<T> a;
  for (int i = 0; i < 2; ++i) {
    const int k = i < ndir ? i : 0;
    a.d[i] = FwdDir<T>{static_cast<const T*>(zx[k]),
                       static_cast<const T*>(w[k]), static_cast<T*>(ys[k]),
                       static_cast<T*>(c[k]), static_cast<T*>(g[k]), rev[k]};
  }
  a.n = n;
  a.t = t;
  a.h = h;
  return save ? launch_fwd<T, true>(a, ndir, s)
              : launch_fwd<T, false>(a, ndir, s);
}

template <typename T>
cudaError_t bwd_typed(const void* const* wt, const void* const* ys,
                      const void* const* c, const void* const* g,
                      const void* const* dy, void* const* dzx,
                      void* const* dw, const int* rev, int ndir, int n,
                      int t, int h, cudaStream_t s) {
  BwdArgs<T> a;
  for (int i = 0; i < 2; ++i) {
    const int k = i < ndir ? i : 0;
    a.d[i] = BwdDir<T>{static_cast<const T*>(wt[k]),
                       static_cast<const T*>(ys[k]),
                       static_cast<const T*>(c[k]),
                       static_cast<const T*>(g[k]),
                       static_cast<const T*>(dy[k]),
                       static_cast<T*>(dzx[k]),
                       static_cast<float*>(dw[k]),
                       rev[k]};
  }
  a.n = n;
  a.t = t;
  a.h = h;
  return launch_bwd<T>(a, ndir, s);
}

// ------------------------------------------------------------------ GRU
// Persistent GRU scan, one direction a launch (BiRecurrent runs one
// launch per direction on time-flipped input, as the JAX package does):
//   * gru_fwd_kernel<T, SAVE=true>  <- _gru_fwd_kernel (K10);
//   * gru_fwd_kernel<T, SAVE=false> <- _gru_fwd_infer_kernel;
//   * gru_bwd_mma_kernel<kMT> (bf16) / gru_bwd_simt_kernel<float> (fp32),
//     then gru_dw_kernel<T>           <- _gru_bwd_kernel (K11).
//
// Layout: zg, zr, dzg (N, T, 2H), gates z then r; zc, cand, ys, dy, dzc
// (N, T, H); wg (H, 2H) and wc (H, H) row-major (the fp32 backward takes
// their transposes); dwg (H, 2H) and dwc (H, H) fp32, summed.
//
// Numerics (the Pallas kernels', kept by gru_forward_reference /
// gru_backward_reference in bigdl_tpu_torch/ops/fused_rnn.py):
//   * h carried in fp32; h rounded to T before h . W_g, and r * h (fp32)
//     rounded to T before (r h) . W_c; products accumulated in fp32;
//   * zr, cand and ys stored in T;
//   * backward: z, r, cand read back from the stored zr and cand, h_prev
//     from the stored ys at t - 1 (zero at t = 0); dcand_pre and dzr in
//     fp32, stored as dzc / dzg in T and rounded to T for the products
//     (drh = dcand_pre . W_c^T, dh_prev += dzr . W_g^T, and both dW);
//     dh carried in fp32.
//
// What bounds it: at the trainer's shape (N = T = H = 128, bf16, one
// direction) the forward moves ~13 MB and does 6 N T H^2 = 1.6 GFLOP;
// the backward ~17 MB and twice the flops: a few us of the card's rates
// each. As for the LSTM, the recurrence sets the time: T dependent
// steps, each two dependent products — r must be complete before
// (r h) . W_c reads it. The forward is the LSTM kernels' design (one CTA
// of kThreads owns kBlockN batch rows for the whole sequence, carries in
// shared memory, no grid-wide barrier, both weights read from L2 every
// step; a product's K terms split over up to 4 thread groups and the
// partial sums added in a fixed order, rows_times_w). The backward
// (below) keeps the batch tile and the no-atomics, fixed-order rule, and
// takes each step's loads off its critical path (residuals prefetched
// into shared memory with cp.async), puts the bf16 step products on the
// tensor cores with W held on chip, and computes dW after the sweep as
// one GEMM over all (t, row) pairs.

// dst[r * C + j] = base[r * C + j] + sum over k < K of op[k * BN + r] *
// w[k * C + j], for the BN rows and C columns (base may be null): op
// staged (K, BN) in shared memory, w row-major (K, C) in global memory.
// One column per thread and pass; when C leaves threads idle the K terms
// split into dh_parts(C) contiguous ranges whose sums are added in order.
// Ends with a barrier.
template <typename T>
__device__ __forceinline__ void rows_times_w(float* dst, const float* base,
                                             const float* op, const T* w,
                                             int K, int C, float* red) {
  constexpr int BN = kBlockN;
  const int parts = dh_parts(C);
  const int per = kThreads / parts;
  const int part = threadIdx.x / per;
  const int span = (K + parts - 1) / parts;
  const int k0 = part * span, k1 = min(K, k0 + span);
  for (int j = threadIdx.x - part * per; j < C; j += per) {
    float acc[BN];
#pragma unroll
    for (int r = 0; r < BN; ++r) acc[r] = 0.f;
    const T* wcol = w + j;
#pragma unroll 4
    for (int k = k0; k < k1; ++k)
      fma_rows<BN>(acc, op + k * BN, to_f32(wcol[(size_t)k * C]));
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      if (parts > 1)
        red[(part * BN + r) * C + j] = acc[r];
      else
        dst[r * C + j] = base ? base[r * C + j] + acc[r] : acc[r];
    }
  }
  __syncthreads();
  if (parts > 1) {
    for (int i = threadIdx.x; i < BN * C; i += kThreads) {
      float v = red[i];
      for (int q = 1; q < parts; ++q) v += red[q * BN * C + i];
      dst[i] = base ? base[i] + v : v;
    }
    __syncthreads();
  }
}

template <typename T>
struct GruFwdArgs {
  const T* zg;
  const T* zc;
  const T* wg;
  const T* wc;
  T* ys;
  T* zr;
  T* cand;
  int n, t, h;
};

// Forward. Shared memory: hs (BN, H) the h carry, hop (H, BN) h rounded
// to T, zrs (BN, 2H) h . W_g and then the activated z, r; rhop (H, BN)
// r * h rounded to T, cs (BN, H) (r h) . W_c; red the split sums.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(GruFwdArgs<T> a) {
  constexpr int BN = kBlockN;
  const int H = a.h, H2 = 2 * a.h, nt = a.t;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* hop = hs + BN * H;
  float* zrs = hop + H * BN;
  float* rhop = zrs + BN * H2;
  float* cs = rhop + H * BN;
  float* red = cs + BN * H;
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    hs[i] = 0.f;
    hop[i] = 0.f;
    rhop[i] = 0.f;
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    rows_times_w<T>(zrs, nullptr, hop, a.wg, H, H2, red);
    // z and r, and the second product's operand r * h
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const T* zg = a.zg + row * H2;
      const float z = sigmoid(to_f32(zg[u]) + zrs[r * H2 + u]);
      const float rg = sigmoid(to_f32(zg[H + u]) + zrs[r * H2 + H + u]);
      zrs[r * H2 + u] = z;
      zrs[r * H2 + H + u] = rg;
      rhop[u * BN + r] = round_to<T>(rg * hs[r * H + u]);
      if (SAVE) {
        a.zr[row * H2 + u] = from_f32<T>(z);
        a.zr[row * H2 + H + u] = from_f32<T>(rg);
      }
    }
    __syncthreads();
    rows_times_w<T>(cs, nullptr, rhop, a.wc, H, H, red);
    // candidate, carry and stores
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float cand = tanhf(to_f32(a.zc[row * H + u]) + cs[r * H + u]);
      const float z = zrs[r * H2 + u];
      const float h = (1.f - z) * hs[r * H + u] + z * cand;
      hs[r * H + u] = h;
      hop[u * BN + r] = round_to<T>(h);
      a.ys[row * H + u] = from_f32<T>(h);
      if (SAVE) a.cand[row * H + u] = from_f32<T>(cand);
    }
    __syncthreads();
  }
}

template <typename T>
struct GruBwdArgs {
  const T* wg;  // bf16: W_g (H, 2H) as stored; fp32: transposed, (2H, H)
  const T* wc;  // bf16: W_c (H, H) as stored; fp32: transposed
  const T* ys;
  const T* zr;
  const T* cand;
  const T* dy;
  T* dzg;
  T* dzc;
  float* dwg;
  float* dwc;
  int n, t, h;
};

// A step's residuals staged in shared memory: zr (BN, 2H), then cand,
// h_prev (ys at t - 1) and dy (BN, H) each, every row padded to
// gru_row(H) elements (a multiple of 16 bytes).
__host__ __device__ __forceinline__ int gru_row(int h) {
  return (h + 7) / 8 * 8;
}
__host__ __device__ __forceinline__ int gru_stage_elems(int h) {
  return kBlockN * 5 * gru_row(h);
}

// Copy n elements device -> shared by threads tid of nthr, asynchronously
// in 16- or 4-byte pieces where both ends allow, else with plain loads
// and stores; either way visible to the block after the waiting thread's
// cp_async_wait and the next barrier.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n,
                                           int tid, int nthr) {
  const int bytes = n * (int)sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | (uintptr_t)bytes;
  const char* s = reinterpret_cast<const char*>(src);
  const uint32_t d = sm90::smem_u32(dst);
  if ((a & 15) == 0) {
    for (int i = tid; i < bytes / 16; i += nthr)
      sm90::cp_async16(d + 16 * i, s + 16 * i, true);
  } else if ((a & 3) == 0) {
    for (int i = tid; i < bytes / 4; i += nthr)
      sm90::cp_async4(d + 4 * i, s + 4 * i, true);
  } else {
    for (int i = tid; i < n; i += nthr) dst[i] = src[i];
  }
}

// Stage step t's residuals of rows n0 .. n0 + nr - 1 into `st` and commit
// one cp.async group (an empty one when t < 0): each warp of the block
// copies whole (tensor, row) items, its lanes the pieces. h_prev at
// t = 0 is not copied: readers take zero there. Out of line, so the
// sweeps' loops stay small.
template <typename T>
__device__ __noinline__ void gru_stage(T* st, const T* zr, const T* cand,
                                       const T* ys, const T* dy, int H,
                                       int nt, int n0, int nr, int t,
                                       int nwarps) {
  if (t >= 0) {
    const int hs = gru_row(H), lane = threadIdx.x & 31;
    for (int it = threadIdx.x >> 5; it < 4 * nr; it += nwarps) {
      const int r = it >> 2, which = it & 3;
      const size_t row = (size_t)(n0 + r) * nt + t;
      if (which == 0)
        copy_async(st + r * 2 * hs, zr + row * 2 * H, 2 * H, lane, 32);
      else if (which == 1)
        copy_async(st + (2 * kBlockN + r) * hs, cand + row * H, H, lane, 32);
      else if (which == 2 && t > 0)
        copy_async(st + (3 * kBlockN + r) * hs, ys + (row - 1) * H, H, lane,
                   32);
      else if (which == 3)
        copy_async(st + (4 * kBlockN + r) * hs, dy + row * H, H, lane, 32);
    }
  }
  sm90::cp_async_commit();
}

// The same copies as gru_stage, planned once per thread: when every
// staged row is a whole number of 16-byte pieces (H * sizeof(T) % 16 ==
// 0), thread tid of nthr copies pieces tid, tid + nthr, ... of a stage
// (at most kMaxC), and a step's copy is one cp.async each from the
// piece's source advanced by t rows. Otherwise the sweeps call
// gru_stage.
template <typename T, int kMaxC>
struct StagePlan {
  const char* src[kMaxC];  // the piece at t = 0 (h_prev: at t = -1)
  int rb[kMaxC];           // bytes a row of the piece's tensor
  uint32_t dst[kMaxC];     // byte offset in a stage
  unsigned hp = 0;         // bit k: piece k is h_prev (none at t = 0)
  int n = 0;

  __device__ __forceinline__ void init(const GruBwdArgs<T>& a, int n0,
                                       int nr, int tid, int nthr) {
    const int H = a.h, hs = gru_row(a.h);
    const int pr = H * (int)sizeof(T) / 16;  // pieces a row of H
    const int total = nr * 5 * pr;           // zr rows count twice
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) {
      const int c = tid + k * nthr;
      src[k] = nullptr;
      rb[k] = 0;
      dst[k] = 0;
      if (c >= total) continue;
      n = k + 1;
      const int r = c / (5 * pr), rest = c % (5 * pr);
      const int which = rest < 2 * pr ? 0 : 1 + (rest - 2 * pr) / pr;
      const int piece = which == 0 ? rest : (rest - 2 * pr) % pr;
      const size_t row0 = (size_t)(n0 + r) * a.t;
      const T* base;
      int elems;
      uint32_t off;
      if (which == 0) {
        base = a.zr + row0 * 2 * H;
        elems = 2 * H;
        off = r * 2 * hs;
      } else {
        base = which == 1 ? a.cand : which == 2 ? a.ys - H : a.dy;
        base += row0 * H;
        elems = H;
        off = (2 * kBlockN + (which - 1) * kBlockN + r) * hs;
      }
      src[k] = reinterpret_cast<const char*>(base) + 16 * piece;
      rb[k] = elems * (int)sizeof(T);
      dst[k] = off * (uint32_t)sizeof(T) + 16 * piece;
      if (which == 2) hp |= 1u << k;
    }
  }

  // step t's pieces into the stage at shared address st; commits a group
  __device__ __forceinline__ void issue(uint32_t st, int t) const {
#pragma unroll
    for (int k = 0; k < kMaxC; ++k)
      if (k < n) {
        const bool live = !(hp >> k & 1) || t > 0;
        sm90::cp_async16(st + dst[k], src[k] + (live ? (size_t)t * rb[k] : 0),
                         live);
      }
    sm90::cp_async_commit();
  }
};

// Backward sweep, fp32: SIMT products (rows_times_w over the transposed
// weights). Shared memory: dhs (BN, H) the dh carry, dhp (BN, H) dh_prev
// before dzr . W_g^T is added, dzp (BN, H) dz_pre, drh (BN, H)
// dcand_pre . W_c^T, dcn (H, BN) dcand_pre, dzrn (2H, BN) dzr, red the
// split sums, then two residual stages: step t - 1's is copied while
// step t runs.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    gru_bwd_simt_kernel(GruBwdArgs<T> a) {
  constexpr int BN = kBlockN;
  const int H = a.h, H2 = 2 * a.h, nt = a.t, hs = gru_row(a.h);
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  extern __shared__ __align__(16) float smem[];
  float* dhs = smem;
  float* dhp = dhs + BN * H;
  float* dzp = dhp + BN * H;
  float* drh = dzp + BN * H;
  float* dcn = drh + BN * H;
  float* dzrn = dcn + H * BN;
  float* red = dzrn + H2 * BN;
  T* stages = reinterpret_cast<T*>(red + kThreads * BN);
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    dhs[i] = 0.f;
    dhp[i] = 0.f;
    dcn[i] = 0.f;
  }
  for (int i = threadIdx.x; i < H2 * BN; i += kThreads) dzrn[i] = 0.f;
  const bool planned = H * (int)sizeof(T) % 16 == 0;
  StagePlan<T, 5> plan;
  if (planned) plan.init(a, n0, nr, threadIdx.x, kThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = gru_stage_elems(H) * (uint32_t)sizeof(T);
  auto stage = [&](int t) {
    if (t < 0)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t & 1) * sb, t);
    else
      gru_stage(stages + (t & 1) * gru_stage_elems(H), a.zr, a.cand, a.ys,
                a.dy, H, nt, n0, nr, t, kThreads / 32);
  };
  stage(nt - 1);
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int t = nt - 1; t >= 0; --t) {
    const T* st = stages + (t & 1) * gru_stage_elems(H);
    stage(t - 1);
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float z = to_f32(st[r * 2 * hs + u]);
      const float c = to_f32(st[(2 * BN + r) * hs + u]);
      const float hp = t > 0 ? to_f32(st[(3 * BN + r) * hs + u]) : 0.f;
      const float dh = to_f32(st[(4 * BN + r) * hs + u]) + dhs[r * H + u];
      const float dz = dh * (c - hp);
      const float dcp = dh * z * (1.f - c * c);
      a.dzc[row * H + u] = from_f32<T>(dcp);
      dcn[u * BN + r] = round_to<T>(dcp);
      dhp[r * H + u] = dh * (1.f - z);
      dzp[r * H + u] = dz * z * (1.f - z);
    }
    __syncthreads();
    rows_times_w<T>(drh, nullptr, dcn, a.wc, H, H, red);
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float rg = to_f32(st[r * 2 * hs + H + u]);
      const float hp = t > 0 ? to_f32(st[(3 * BN + r) * hs + u]) : 0.f;
      const float d = drh[r * H + u];
      const float dr = d * hp;
      const float drp = dr * rg * (1.f - rg);
      const float dzv = dzp[r * H + u];
      dhp[r * H + u] = dhp[r * H + u] + d * rg;
      a.dzg[row * H2 + u] = from_f32<T>(dzv);
      a.dzg[row * H2 + H + u] = from_f32<T>(drp);
      dzrn[u * BN + r] = round_to<T>(dzv);
      dzrn[(H + u) * BN + r] = round_to<T>(drp);
    }
    sm90::cp_async_wait<0>();  // step t - 1's stage, published below
    __syncthreads();
    rows_times_w<T>(dhs, dhp, dzrn, a.wg, H2, H, red);
  }
}

// Backward sweep, bf16, on the tensor cores: both step products are
// mma.sync m16n8k16 with M = the H output units (one 16-unit tile a warp
// and pass), N = 8 batch rows (the tile's 4 rows and 4 zero rows), K = H
// (drh = dcand_pre . W_c^T) or 2H (dh += dzr . W_g^T), A = W_c / W_g as
// stored (row-major, so K-major), B = dcand_pre / dzr rounded to bf16 in
// shared memory. A thread's accumulator holds units (u, u + 8) of rows
// (2q, 2q + 1): lanes with q < 2 own those 4 (row, unit) pairs for the
// whole sweep and keep their dh carry and dz_pre in registers, so the
// elementwise phases run as the products' epilogues and a step has two
// barriers. kMT = 1 (H <= 128): each warp's W fragments stay in
// registers for the whole sweep; kMT = 4 (H <= 512): each warp takes 16-
// unit tiles warp, warp + 8, ... and streams their fragments from L2,
// the next k-step's loaded while the current one multiplies. W_g's K
// runs over [z units | r units], each half padded to hp = H rounded up
// to 16 (zero columns). Shared memory: op1 (BN, hp + 8) dcand_pre, op2
// (BN, 2 hp + 8) dzr (z half at 0, r half at hp), as bf16 bits, rows
// padded against bank conflicts; three residual stages (step t - 2's is
// copied while step t runs).
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;

// A fragment of rows u0 .. u0 + 15 of a row-major bf16 W (ldw columns, H
// rows) at padded columns kb .. kb + 15; col(k) is W's column of padded
// column k, or -1 for a zero.
template <typename Col>
__device__ __forceinline__ void load_w_frag(uint32_t (&f)[4],
                                            const unsigned short* w, int ldw,
                                            int H, int u0, int kb, Col col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + g + 8 * (i & 1);
    const int k = kb + 2 * q + 8 * (i >> 1);
    uint32_t lo = 0, hi = 0;
    if (u < H) {
      const int c0 = col(k), c1 = col(k + 1);
      if (c0 >= 0) lo = w[(size_t)u * ldw + c0];
      if (c1 >= 0) hi = w[(size_t)u * ldw + c1];
    }
    f[i] = lo | (hi << 16);
  }
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// padded K of the resident instantiation: W_c's K, and each half of W_g's
__host__ __device__ __forceinline__ int gru_mma_hp(int h) {
  return h <= 16 * kMmaWarps ? 16 * kMmaWarps : (h + 15) / 16 * 16;
}

template <int kMT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gru_bwd_mma_kernel(GruBwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int BN = kBlockN;
  constexpr bool kRes = kMT == 1;  // W resident: hp = 128, fixed k-steps
  const int H = a.h, H2 = 2 * a.h, nt = a.t, hs = gru_row(a.h);
  const int hp = gru_mma_hp(H);
  const int ld1 = hp + 8, ld2 = 2 * hp + 8;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* zero16 = reinterpret_cast<uint4*>(smem_raw);  // rows 4..7 of B
  unsigned short* op1 = reinterpret_cast<unsigned short*>(zero16 + 1);
  unsigned short* op2 = op1 + BN * ld1;
  T* stages = reinterpret_cast<T*>(op2 + BN * ld2);
  const int se = gru_stage_elems(H);
  const unsigned short* wc = reinterpret_cast<const unsigned short*>(a.wc);
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(a.wg);
  auto col_c = [H](int k) { return k < H ? k : -1; };
  auto col_g = [H, hp](int k) {
    return k < hp ? (k < H ? k : -1) : (k - hp < H ? H + k - hp : -1);
  };
  for (int i = threadIdx.x; i < BN * (ld1 + ld2); i += kMmaThreads)
    op1[i] = 0;
  if (threadIdx.x == 0) *zero16 = make_uint4(0, 0, 0, 0);
  const bool planned = H * (int)sizeof(T) % 16 == 0;
  StagePlan<T, kRes ? 2 : 5> plan;
  if (planned) plan.init(a, n0, nr, threadIdx.x, kMmaThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  // step t's residuals into stage t % 3 (t >= 0; an empty group else)
  auto stage = [&](int t) {
    if (t < 0)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t % 3) * sb, t);
    else
      gru_stage(stages + (t % 3) * se, a.zr, a.cand, a.ys, a.dy, H, nt, n0,
                nr, t, kMmaWarps);
  };
  stage(nt - 1);
  stage(nt - 2);

  uint32_t fc[kRes ? 8 : 1][4], fg[kRes ? 16 : 1][4];  // resident W
  if constexpr (kRes) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      load_w_frag(fc[ks], wc, H, H, 16 * warp, 16 * ks, col_c);
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      load_w_frag(fg[ks], wg, H2, H, 16 * warp, 16 * ks, col_g);
  }

  // acc[i] = W rows of tile warp + 8 i times the operand op (ld): with W
  // resident, all 8 (W_c) or 16 (W_g) k-steps, every B fragment loaded
  // first, the k-steps in 4 accumulator chains (k-step ks in chain
  // ks % 4); streamed, hp / 16 or 2 hp / 16 k-steps in 2 chains, the
  // next k-step's W fragment loaded while the current one multiplies.
  // The chains are added in a fixed order.
  auto product = [&](float (&acc)[kMT][4], const unsigned short* op, int ld,
                     auto gates) {
    constexpr bool kG = decltype(gates)::value;
#pragma unroll 1
    for (int i = 0; i < kMT; ++i) {
      float c[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[x][j] = 0.f;
      const int u0 = 16 * (warp + kMmaWarps * i);
      if constexpr (kRes) {
        constexpr int kKS = kG ? 16 : 8;
        // B fragments of two k-steps an ldmatrix: matrix m of lane l is
        // k-step 2 p + m / 2, columns 8 (m % 2) .. + 7, row l % 8 (a zero
        // row past the tile's 4)
        const int mi = lane >> 3, ri = lane & 7;
        const uint32_t za = sm90::smem_u32(zero16);
        const uint32_t ra = sm90::smem_u32(op + ri * ld + 16 * (mi >> 1) +
                                           8 * (mi & 1));
        uint32_t b[kKS][2];
#pragma unroll
        for (int pk = 0; pk < kKS / 2; ++pk) {
          uint32_t r4[4];
          sm90::ldmatrix_x4(r4, ri < BN ? ra + 64 * pk : za);
          b[2 * pk][0] = r4[0];
          b[2 * pk][1] = r4[1];
          b[2 * pk + 1][0] = r4[2];
          b[2 * pk + 1][1] = r4[3];
        }
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          if constexpr (kG)
            sm90::mma_bf16_16816(c[ks & 3], fg[ks], b[ks][0], b[ks][1]);
          else
            sm90::mma_bf16_16816(c[ks & 3], fc[ks], b[ks][0], b[ks][1]);
        }
      } else if (u0 < hp) {
        const int ks_n = (kG ? 2 * hp : hp) / 16;
        auto load = [&](uint32_t(&f)[4], int ks) {
          if constexpr (kG)
            load_w_frag(f, wg, H2, H, u0, 16 * ks, col_g);
          else
            load_w_frag(f, wc, H, H, u0, 16 * ks, col_c);
        };
        const unsigned short* pb = op + (g & 3) * ld + 2 * q;
        auto bfrag = [&](int ks, uint32_t& b0, uint32_t& b1) {
          b0 = g < BN ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks) : 0u;
          b1 = g < BN ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks + 8)
                      : 0u;
        };
        uint32_t fa[4], fb[4];
        load(fa, 0);
        for (int ks = 0; ks < ks_n; ks += 2) {
          uint32_t b0, b1;
          if (ks + 1 < ks_n) load(fb, ks + 1);
          bfrag(ks, b0, b1);
          sm90::mma_bf16_16816(c[0], fa, b0, b1);
          if (ks + 1 < ks_n) {
            if (ks + 2 < ks_n) load(fa, ks + 2);
            bfrag(ks + 1, b0, b1);
            sm90::mma_bf16_16816(c[1], fb, b0, b1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = (c[0][j] + c[1][j]) + (c[2][j] + c[3][j]);
    }
  };

  // The m-tile loops (i) are not unrolled: with W streamed (kMT = 4) the
  // per-tile state then lives in local memory instead of overflowing the
  // registers; with W resident there is one tile.
  // The (row, unit) pairs this thread owns: accumulator entry j of tile
  // i is unit 16 (warp + 8 i) + g + 8 (j >> 1) of row 2 q + (j & 1). The
  // epilogues run for every entry, reading in-range copies (row rc(j) =
  // row mod 4, unit uc(i, j) capped at H - 1) so that no branch is
  // taken; only owned pairs store.
  unsigned own = 0;  // bit 4 i + j: this thread owns the pair
#pragma unroll 1
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 2 * q + (j & 1);
      const int u = 16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1);
      if (q < 2 && r < nr && u < H) own |= 1u << (4 * i + j);
    }
  // With 16-byte rows (H % 8 == 0), dzc and dzg leave as 16-byte pieces
  // of op1 / op2, which hold exactly their bf16 values: thread tid
  // copies pieces tid, tid + kMmaThreads, ... of a step's 4 rows (at
  // most kOC of dzc, kOG of dzg). Otherwise each owned pair stores.
  constexpr int kOC = 1, kOG = kRes ? 1 : 2;
  int oc_s[kOC], og_s[kOG];  // op1 / op2 element offsets (-1: none)
  uint4* oc_g[kOC];          // dzc / dzg pieces at t = 0
  uint4* og_g[kOG];
  {
    const int pr = planned ? H / 8 : 0;
#pragma unroll
    for (int k = 0; k < kOC; ++k) {
      const int c = threadIdx.x + k * kMmaThreads, r = c / max(pr, 1);
      const bool on = c < nr * pr;
      oc_s[k] = on ? r * ld1 + 8 * (c - r * pr) : -1;
      oc_g[k] = reinterpret_cast<uint4*>(
          a.dzc + (on ? (size_t)(n0 + r) * nt * H + 8 * (c - r * pr) : 0));
    }
#pragma unroll
    for (int k = 0; k < kOG; ++k) {
      const int c = threadIdx.x + k * kMmaThreads, r = c / max(2 * pr, 1);
      const int e = c - r * 2 * pr;
      const bool on = c < nr * 2 * pr;
      og_s[k] = on ? r * ld2 + (e < pr ? 8 * e : hp + 8 * (e - pr)) : -1;
      og_g[k] = reinterpret_cast<uint4*>(
          a.dzg + (on ? (size_t)(n0 + r) * nt * H2 + 8 * e : 0));
    }
  }
  auto copy_out = [&](auto dzg_tag, int t) {
    if constexpr (decltype(dzg_tag)::value) {
      const size_t step = (size_t)t * H2 / 8;  // uint4 a row
#pragma unroll
      for (int k = 0; k < kOG; ++k)
        if (og_s[k] >= 0)
          og_g[k][step] = *reinterpret_cast<const uint4*>(op2 + og_s[k]);
    } else {
      const size_t step = (size_t)t * H / 8;
#pragma unroll
      for (int k = 0; k < kOC; ++k)
        if (oc_s[k] >= 0)
          oc_g[k][step] = *reinterpret_cast<const uint4*>(op1 + oc_s[k]);
    }
  };
  auto rc = [&](int j) { return (2 * q + (j & 1)) & 3; };
  auto uc = [&](int i, int j) {
    return min(16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1), H - 1);
  };
  float carry[kMT][4], dhp[kMT][4], dzp[kMT][4], acc[kMT][4];
  float va[kMT][4], vb[kMT][4], vc[kMT][4], vd[kMT][4];  // staged inputs
#pragma unroll 1
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) carry[i][j] = dhp[i][j] = dzp[i][j] = 0.f;
  // step t's inputs from its stage, read before the product they wait
  // on: z, cand, h_prev, dy (first phase) or r, h_prev (second)
  auto load_first = [&](int t) {
    const T* st = stages + (t % 3) * se;
#pragma unroll 1
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = rc(j) * hs + uc(i, j);
        va[i][j] = to_f32(st[o + rc(j) * hs]);
        vb[i][j] = to_f32(st[o + 2 * BN * hs]);
        vc[i][j] = t > 0 ? to_f32(st[o + 3 * BN * hs]) : 0.f;
        vd[i][j] = to_f32(st[o + 4 * BN * hs]);
      }
  };
  auto load_second = [&](int t) {
    const T* st = stages + (t % 3) * se;
#pragma unroll 1
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = rc(j) * hs + uc(i, j);
        va[i][j] = to_f32(st[o + rc(j) * hs + H]);
        vc[i][j] = t > 0 ? to_f32(st[o + 3 * BN * hs]) : 0.f;
      }
  };
  // step t's first phase, from the dh carry: dcand_pre (stored, and
  // rounded into op1), dh_prev's first term and dz_pre
  auto first = [&](int t) {
#pragma unroll 1
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = va[i][j], c = vb[i][j], hpv = vc[i][j];
        const float dh = vd[i][j] + carry[i][j];
        const float dz = dh * (c - hpv);
        const float dcp = dh * z * (1.f - c * c);
        dhp[i][j] = dh * (1.f - z);
        dzp[i][j] = dz * z * (1.f - z);
        if (own >> (4 * i + j) & 1) {
          if (!planned)
            a.dzc[((size_t)(n0 + rc(j)) * nt + t) * H + uc(i, j)] =
                from_f32<T>(dcp);
          op1[rc(j) * ld1 + uc(i, j)] = bf16_bits(dcp);
        }
      }
  };

  sm90::cp_async_wait<1>();
  __syncthreads();  // step nt - 1's stage and the zeroed operands
  load_first(nt - 1);
  first(nt - 1);
  for (int t = nt - 1; t >= 0; --t) {
    __syncthreads();  // op1 holds step t's dcand_pre
    // resident: the stage reads overlap the product; streamed, where the
    // registers are short, they follow it
    if constexpr (kRes) load_second(t);
    product(acc, op1, ld1, std::integral_constant<bool, false>());
    if constexpr (!kRes) load_second(t);
    copy_out(std::integral_constant<bool, false>(), t);  // dzc of step t
#pragma unroll 1
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float rg = va[i][j], hpv = vc[i][j];
        const float d = acc[i][j];
        const float dr = d * hpv;
        const float drp = dr * rg * (1.f - rg);
        const float dzv = dzp[i][j];
        dhp[i][j] = dhp[i][j] + d * rg;
        if (own >> (4 * i + j) & 1) {
          if (!planned) {
            T* dzg = a.dzg + ((size_t)(n0 + rc(j)) * nt + t) * H2 + uc(i, j);
            dzg[0] = from_f32<T>(dzv);
            dzg[H] = from_f32<T>(drp);
          }
          unsigned short* o2 = op2 + rc(j) * ld2 + uc(i, j);
          o2[0] = bf16_bits(dzv);
          o2[hp] = bf16_bits(drp);
        }
      }
    stage(t - 2);
    sm90::cp_async_wait<1>();  // step t - 1's stage
    __syncthreads();           // op2 holds step t's dzr; the stage landed
    if (kRes && t > 0) load_first(t - 1);
    product(acc, op2, ld2, std::integral_constant<bool, true>());
    if (!kRes && t > 0) load_first(t - 1);
    copy_out(std::integral_constant<bool, true>(), t);  // dzg of step t
#pragma unroll 1
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) carry[i][j] = dhp[i][j] + acc[i][j];
    if (t > 0) first(t - 1);
  }
}

// dW after the sweep, one GEMM over all N * T (t, row) pairs m:
//   dW_g (H, 2H) = sum_m h_prev[m]^T . dzg[m],
//   dW_c (H, H)  = sum_m rh[m]^T . dzc[m],  rh = r * h_prev rounded to T,
// h_prev = ys[m - 1] (zero at t = 0), r from zr: the operands and
// rounding points of the tail of _gru_bwd_kernel. A CTA owns a 64 x 64
// tile of one dW and a contiguous range of pairs; the `splits` CTAs of a
// tile form a cluster, and after a cluster barrier rank r sums slice r
// of the tile over every rank's partial in rank order (distributed
// shared memory) and writes it: no atomics, no scratch in device memory.
// Pairs stream through a kDwStages ring of kDwPairs pairs (h_prev, r,
// dz tiles; r * h_prev formed in place by the thread that copied them).
// bf16: mma.sync m16n8k16 (A = the operand tile, B = dz, both read with
// ldmatrix.trans), each of 4 warps 16 units x 64 columns; fp32: SIMT, a
// thread 8 units x 4 columns.
constexpr int kDwTile = 64;
constexpr int kDwPairs = 64;
constexpr int kDwStages = 3;
constexpr int kDwThreads = 128;
constexpr int kDwMaxSplits = 16;  // a non-portable cluster size
constexpr int kDwMinPairs = 512;  // pairs a split takes at least

template <typename T>
struct DwGeo {
  static constexpr int kEPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int kCPR = kDwTile / kEPC;       // chunks a tile row
  static constexpr int kLd = kDwTile + kEPC;        // padded row
  static constexpr int kTile = kDwPairs * kLd;
  static constexpr int kStage = 3 * kTile;  // h_prev (then rh), r, dz
};

__host__ __device__ __forceinline__ int dw_col_tiles(int h) {
  return (2 * h + kDwTile - 1) / kDwTile + (h + kDwTile - 1) / kDwTile;
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    gru_dw_kernel(GruBwdArgs<T> a, int splits, int span) {
  using G = DwGeo<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int H = a.h, nt = a.t, M = a.n * a.t;
  const int tiles_k = (H + kDwTile - 1) / kDwTile;
  const int tiles_g = (2 * H + kDwTile - 1) / kDwTile;
  const int tile = blockIdx.x / splits;
  const int k0 = (tile % tiles_k) * kDwTile;
  const int jt = tile / tiles_k;
  const bool rh = jt >= tiles_g;  // a dW_c tile
  const int j0 = (rh ? jt - tiles_g : jt) * kDwTile;
  const int C = rh ? H : 2 * H;
  const T* dz = rh ? a.dzc : a.dzg;
  const int m0 = rank * span, m1 = min(m0 + span, M);
  const int nst = (m1 - m0 + kDwPairs - 1) / kDwPairs;
  const bool vec = H % G::kEPC == 0;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(ring + kDwStages * G::kStage);

  // copy stage s (pairs m0 + s * kDwPairs ...); out-of-range pairs,
  // units and columns, and h_prev at t = 0, are zeros
  auto issue = [&](int s) {
    if (s < nst) {
      T* st = ring + (s % kDwStages) * G::kStage;
      for (int i = tid; i < kDwPairs * G::kCPR; i += kDwThreads) {
        const int p = i / G::kCPR, c = i % G::kCPR;
        const int m = m0 + s * kDwPairs + p;
        const int k = k0 + c * G::kEPC, j = j0 + c * G::kEPC;
        const int o = p * G::kLd + c * G::kEPC;
        const bool live = m < m1 && m % nt != 0;
        if (vec) {
          sm90::cp_async16(sm90::smem_u32(st + o),
                           a.ys + (live && k < H ? (size_t)(m - 1) * H + k : 0),
                           live && k < H);
          if (rh)
            sm90::cp_async16(
                sm90::smem_u32(st + G::kTile + o),
                a.zr + (live && k < H ? (size_t)m * 2 * H + H + k : 0),
                live && k < H);
          const bool dv = m < m1 && j + G::kEPC <= C;
          sm90::cp_async16(sm90::smem_u32(st + 2 * G::kTile + o),
                           dz + (dv ? (size_t)m * C + j : 0), dv);
        } else {
#pragma unroll
          for (int e = 0; e < G::kEPC; ++e) {
            float h = 0.f;
            if (live && k + e < H) {
              h = to_f32(a.ys[(size_t)(m - 1) * H + k + e]);
              if (rh)
                h = round_to<T>(to_f32(a.zr[(size_t)m * 2 * H + H + k + e]) *
                                h);
            }
            st[o + e] = from_f32<T>(h);
            st[2 * G::kTile + o + e] =
                m < m1 && j + e < C ? dz[(size_t)m * C + j + e]
                                    : from_f32<T>(0.f);
          }
        }
      }
    }
    sm90::cp_async_commit();
  };
  // r * h_prev, rounded to T, over the h_prev chunks this thread copied
  auto form_rh = [&](int s) {
    if (!rh || !vec) return;
    T* st = ring + (s % kDwStages) * G::kStage;
    for (int i = tid; i < kDwPairs * G::kCPR; i += kDwThreads) {
      const int o = (i / G::kCPR) * G::kLd + (i % G::kCPR) * G::kEPC;
#pragma unroll
      for (int e = 0; e < G::kEPC; ++e)
        st[o + e] = from_f32<T>(
            round_to<T>(to_f32(st[G::kTile + o + e]) * to_f32(st[o + e])));
    }
  };

  constexpr bool kMma = sizeof(T) == 2;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int warp = tid >> 5, lane = tid & 31;

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) issue(s);
  for (int s = 0; s < nst; ++s) {
    sm90::cp_async_wait<kDwStages - 2>();
    form_rh(s);
    __syncthreads();  // stage s complete; slot s - 1 free
    issue(s + kDwStages - 1);
    const T* st = ring + (s % kDwStages) * G::kStage;
    if constexpr (kMma) {
      const uint32_t ta = sm90::smem_u32(st);
      const uint32_t tb = sm90::smem_u32(st + 2 * G::kTile);
      const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
      for (int kk = 0; kk < kDwPairs / 16; ++kk) {
        uint32_t af[4];
        sm90::ldmatrix_x4_trans(
            af, ta + 2 * ((kk * 16 + (mi >> 1) * 8 + ri) * G::kLd +
                          16 * warp + (mi & 1) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          sm90::ldmatrix_x4_trans(
              bf, tb + 2 * ((kk * 16 + (mi & 1) * 8 + ri) * G::kLd +
                            16 * np + (mi >> 1) * 8));
          sm90::mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
          sm90::mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    } else {
      const int tk = tid >> 4, tj = tid & 15;
      for (int p = 0; p < kDwPairs; ++p) {
        const float* ar = reinterpret_cast<const float*>(st) + p * G::kLd;
        const float4 a0 = *reinterpret_cast<const float4*>(ar + 8 * tk);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 8 * tk + 4);
        const float4 b = *reinterpret_cast<const float4*>(
            ar + 2 * G::kTile + 4 * tj);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  sm90::cp_async_wait<0>();
  // this rank's partial tile, (64 units, 64 columns)
  if constexpr (kMma) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(16 * warp + g + 8 * (j >> 1)) * kDwTile + 8 * n + 2 * q +
             (j & 1)] = acc[n][j];
  } else {
    const int tk = tid >> 4, tj = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[(8 * tk + i) * kDwTile + 4 * tj + j] = acc[i][j];
  }
  cluster.sync();  // every rank's partial is written
  float* dw = rh ? a.dwc : a.dwg;
  for (int e = rank * kDwThreads + tid; e < kDwTile * kDwTile;
       e += splits * kDwThreads) {
    float v = 0.f;
    for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(part, r)[e];
    const int k = k0 + e / kDwTile, j = j0 + e % kDwTile;
    if (k < H && j < C) dw[(size_t)k * C + j] = v;
  }
  cluster.sync();  // no rank leaves while others read its partial
}

size_t gru_fwd_smem(int h) {
  return ((size_t)6 * kBlockN * h + kThreads * kBlockN) * sizeof(float);
}

size_t gru_bwd_simt_smem(int h) {
  return ((size_t)7 * kBlockN * h + kThreads * kBlockN +
          2 * (size_t)gru_stage_elems(h)) *
         sizeof(float);
}

size_t gru_bwd_mma_smem(int h) {
  const int hp = gru_mma_hp(h);
  return 16 + ((size_t)kBlockN * (3 * hp + 16) +
               3 * (size_t)gru_stage_elems(h)) *
                  sizeof(__nv_bfloat16);
}

template <typename T>
size_t gru_dw_smem() {
  return sizeof(T) * kDwStages * DwGeo<T>::kStage +
         sizeof(float) * kDwTile * kDwTile;
}

template <typename T, bool SAVE>
cudaError_t launch_gru_fwd(GruFwdArgs<T> a, cudaStream_t s) {
  const size_t smem = gru_fwd_smem(a.h);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gru_fwd_kernel<T, SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  gru_fwd_kernel<T, SAVE>
      <<<(a.n + kBlockN - 1) / kBlockN, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The sweep (fp32: SIMT; bf16: mma.sync, W resident in registers when H
// rounded up to 16 is at most 128, streamed from L2 above), then the dW
// GEMM, on one stream.
template <typename T>
cudaError_t launch_gru_bwd(GruBwdArgs<T> a, cudaStream_t s) {
  const int tiles = (a.n + kBlockN - 1) / kBlockN;
  cudaError_t e;
  if constexpr (sizeof(T) == 4) {
    const size_t smem = gru_bwd_simt_smem(a.h);
    if ((e = set_smem(gru_bwd_simt_kernel<T>, smem)) != cudaSuccess) return e;
    gru_bwd_simt_kernel<T><<<tiles, kThreads, smem, s>>>(a);
  } else {
    const size_t smem = gru_bwd_mma_smem(a.h);
    if (a.h <= 16 * kMmaWarps) {
      if ((e = set_smem(gru_bwd_mma_kernel<1>, smem)) != cudaSuccess) return e;
      gru_bwd_mma_kernel<1><<<tiles, kMmaThreads, smem, s>>>(a);
    } else {
      if ((e = set_smem(gru_bwd_mma_kernel<4>, smem)) != cudaSuccess) return e;
      gru_bwd_mma_kernel<4><<<tiles, kMmaThreads, smem, s>>>(a);
    }
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // dW: `splits` CTAs a tile (one cluster), each a range of `span` pairs;
  // 16-CTA clusters where the card can place one, else 8 (portable)
  const long long m = (long long)a.n * a.t;
  const size_t smem = gru_dw_smem<T>();
  if ((e = set_smem(gru_dw_kernel<T>, smem)) != cudaSuccess) return e;
  int splits = 0, span = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  auto plan = [&](int max_splits) {
    splits = (int)std::min<long long>(
        max_splits, std::max<long long>(1, (m + kDwMinPairs - 1) / kDwMinPairs));
    span = (int)((m + splits - 1) / splits);
    span = (span + kDwPairs - 1) / kDwPairs * kDwPairs;
    splits = (int)((m + span - 1) / span);
    cfg.gridDim = dim3((unsigned)(splits * ((a.h + kDwTile - 1) / kDwTile) *
                                  dw_col_tiles(a.h)));
    cfg.blockDim = dim3(kDwThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  };
  plan(kDwMaxSplits);
  if (splits > 8) {
    if ((e = cudaFuncSetAttribute(
             gru_dw_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
             1)) != cudaSuccess)
      return e;
    // whether a cluster of this size fits depends on the card and the
    // kernel only: asked once
    static const bool fits = [&] {
      int n = 0;
      const bool ok =
          cudaOccupancyMaxActiveClusters(&n, gru_dw_kernel<T>, &cfg) ==
          cudaSuccess;
      cudaGetLastError();  // a refused query leaves no error behind
      return ok && n >= 1;
    }();
    if (!fits) plan(8);
  }
  if ((e = cudaLaunchKernelEx(&cfg, gru_dw_kernel<T>, a, splits, span)) !=
      cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t gru_fwd_typed(const void* zg, const void* zc, const void* wg,
                          const void* wc, void* ys, void* zr, void* cand,
                          int n, int t, int h, int save, cudaStream_t s) {
  const GruFwdArgs<T> a{static_cast<const T*>(zg), static_cast<const T*>(zc),
                        static_cast<const T*>(wg), static_cast<const T*>(wc),
                        static_cast<T*>(ys), static_cast<T*>(zr),
                        static_cast<T*>(cand), n, t, h};
  return save ? launch_gru_fwd<T, true>(a, s)
              : launch_gru_fwd<T, false>(a, s);
}

template <typename T>
cudaError_t gru_bwd_typed(const void* wg, const void* wc, const void* ys,
                          const void* zr, const void* cand, const void* dy,
                          void* dzg, void* dzc, void* dwg, void* dwc, int n,
                          int t, int h, cudaStream_t s) {
  const GruBwdArgs<T> a{
      static_cast<const T*>(wg),  static_cast<const T*>(wc),
      static_cast<const T*>(ys),  static_cast<const T*>(zr),
      static_cast<const T*>(cand), static_cast<const T*>(dy),
      static_cast<T*>(dzg),       static_cast<T*>(dzc),
      static_cast<float*>(dwg),   static_cast<float*>(dwc),
      n, t, h};
  return launch_gru_bwd<T>(a, s);
}

}  // namespace

// The forward over one or two directions in one launch. Pointers come
// in pairs (direction 0, direction 1; the second unused when ndir == 1);
// c and g may be null when save == 0 (the inference variant).
extern "C" int bigdl_lstm_fwd(const void* zx0, const void* zx1,
                              const void* w0, const void* w1, void* ys0,
                              void* ys1, void* c0, void* c1, void* g0,
                              void* g1, int rev0, int rev1, int ndir, int n,
                              int t, int h, int save, int is_bf16,
                              void* stream) {
  if (bad_shape(ndir, n, t, h)) return (int)cudaErrorInvalidValue;
  const void* zx[2] = {zx0, zx1};
  const void* w[2] = {w0, w1};
  void* ys[2] = {ys0, ys1};
  void* c[2] = {c0, c1};
  void* g[2] = {g0, g1};
  const int rev[2] = {rev0, rev1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)fwd_typed<__nv_bfloat16>(zx, w, ys, c, g, rev, ndir, n, t,
                                         h, save, s);
  return (int)fwd_typed<float>(zx, w, ys, c, g, rev, ndir, n, t, h, save, s);
}

// The backward over one or two directions in one launch: dzx, and each
// batch tile's fp32 dW in dw (tiles, H, 4H) — the caller sums the tiles.
extern "C" int bigdl_lstm_bwd(const void* wt0, const void* wt1,
                              const void* ys0, const void* ys1,
                              const void* c0, const void* c1,
                              const void* g0, const void* g1,
                              const void* dy0, const void* dy1, void* dzx0,
                              void* dzx1, void* dw0, void* dw1, int rev0,
                              int rev1, int ndir, int n, int t, int h,
                              int is_bf16, void* stream) {
  if (bad_shape(ndir, n, t, h)) return (int)cudaErrorInvalidValue;
  const void* wt[2] = {wt0, wt1};
  const void* ys[2] = {ys0, ys1};
  const void* c[2] = {c0, c1};
  const void* g[2] = {g0, g1};
  const void* dy[2] = {dy0, dy1};
  void* dzx[2] = {dzx0, dzx1};
  void* dw[2] = {dw0, dw1};
  const int rev[2] = {rev0, rev1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)bwd_typed<__nv_bfloat16>(wt, ys, c, g, dy, dzx, dw, rev,
                                         ndir, n, t, h, s);
  return (int)bwd_typed<float>(wt, ys, c, g, dy, dzx, dw, rev, ndir, n, t, h,
                               s);
}

// The GRU forward over one direction; zr and cand may be null when
// save == 0 (the inference variant).
extern "C" int bigdl_gru_fwd(const void* zg, const void* zc, const void* wg,
                             const void* wc, void* ys, void* zr, void* cand,
                             int n, int t, int h, int save, int is_bf16,
                             void* stream) {
  if (bad_shape(1, n, t, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)gru_fwd_typed<__nv_bfloat16>(zg, zc, wg, wc, ys, zr, cand, n,
                                             t, h, save, s);
  return (int)gru_fwd_typed<float>(zg, zc, wg, wc, ys, zr, cand, n, t, h,
                                   save, s);
}

// The GRU backward over one direction: dzg, dzc, and the summed fp32
// dW_g (H, 2H) in dwg and dW_c (H, H) in dwc; two launches (the sweep,
// then the dW GEMM) on `stream`. wg, wc: W_g and W_c as stored for bf16
// (the tensor-core products read them K-major), transposed for fp32 (the
// SIMT products read one column per thread, coalesced).
extern "C" int bigdl_gru_bwd(const void* wg, const void* wc, const void* ys,
                             const void* zr, const void* cand, const void* dy,
                             void* dzg, void* dzc, void* dwg, void* dwc, int n,
                             int t, int h, int is_bf16, void* stream) {
  if (bad_shape(1, n, t, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)gru_bwd_typed<__nv_bfloat16>(wg, wc, ys, zr, cand, dy, dzg,
                                             dzc, dwg, dwc, n, t, h, s);
  return (int)gru_bwd_typed<float>(wg, wc, ys, zr, cand, dy, dzg, dzc, dwg,
                                   dwc, n, t, h, s);
}

extern "C" const char* bigdl_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
