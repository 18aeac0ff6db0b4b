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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
//   * gru_bwd_kernel<T>             <- _gru_bwd_kernel (K11).
//
// Layout: zg, zr, dzg (N, T, 2H), gates z then r; zc, cand, ys, dy, dzc
// (N, T, H); wg (H, 2H) and wc (H, H) row-major, the backward takes
// their transposes wgt (2H, H) and wct (H, H); dwg (tiles, H, 2H) and
// dwc (tiles, H, H) fp32, one slice per batch tile.
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
// steps, each now two dependent products — r must be complete before
// (r h) . W_c reads it — so a step has two more CTA barriers than the
// LSTM's. The design is the LSTM kernels' (one CTA of kThreads owns
// kBlockN batch rows for the whole sequence, carries in shared memory,
// no grid-wide barrier, dW per tile from the stored dzg / dzc after the
// sweep, no atomics, every sum in a fixed order, both weights read from
// L2 every step), with one change: a product has 2H or H columns, fewer
// than the threads at H <= 256, so its K terms are split over up to 4
// thread groups and the partial sums added in a fixed order
// (rows_times_w).

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
  const T* wgt;
  const T* wct;
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

// A tile's dW (H, C) = sum over (t, row) of op[t, row]^T . dz[t, row],
// read back from the dz (row stride C) this block stored; op is h_prev
// (dW_g) or, with RH, r * h_prev rounded to T (dW_c), both zero at t = 0.
// The operand is staged in (kDwRows, kDwK) blocks in `hs`.
template <typename T, bool RH>
__device__ void gru_tile_dw(float* dw, const T* dz, int C, const T* ys,
                            const T* zr, int n0, int nr, int nt, int H,
                            float* hs) {
  const int m_total = nt * nr;
  for (int j0 = 0; j0 < C; j0 += kThreads) {
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
            if (t > 0) {
              const size_t rt = (size_t)(n0 + r) * nt + t;
              const float hp = to_f32(ys[(rt - 1) * H + k]);
              v = RH ? round_to<T>(to_f32(zr[rt * 2 * H + H + k]) * hp) : hp;
            }
          }
          hs[i] = v;
        }
        __syncthreads();
        if (j < C) {
          const int mend = min(kDwRows, m_total - m0);
          for (int mm = 0; mm < mend; ++mm) {
            const int m = m0 + mm;
            const int t = m / nr, r = m - t * nr;
            const float d = to_f32(dz[((size_t)(n0 + r) * nt + t) * C + j]);
            fma_rows<kDwK>(acc, hs + mm * kDwK, d);
          }
        }
      }
      if (j < C) {
        for (int kk = 0; kk < kDwK && k0 + kk < H; ++kk)
          dw[(size_t)(k0 + kk) * C + j] = acc[kk];
      }
    }
  }
}

// Backward: the reversed sweep. Shared memory: dhs (BN, H) the dh carry,
// dhp (BN, H) dh_prev before dzr . W_g^T is added, dzp (BN, H) dz_pre,
// drh (BN, H) dcand_pre . W_c^T, dcn (H, BN) dcand_pre rounded to T, dzrn
// (2H, BN) dzr rounded to T, hs the staged dW operand, red the split
// sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(GruBwdArgs<T> a) {
  constexpr int BN = kBlockN;
  const int H = a.h, H2 = 2 * a.h, nt = a.t;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  extern __shared__ __align__(16) float smem[];
  float* dhs = smem;
  float* dhp = dhs + BN * H;
  float* dzp = dhp + BN * H;
  float* drh = dzp + BN * H;
  float* dcn = drh + BN * H;
  float* dzrn = dcn + H * BN;
  float* hs = dzrn + H2 * BN;
  float* red = hs + kDwRows * kDwK;
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    dhs[i] = 0.f;
    dhp[i] = 0.f;
    dcn[i] = 0.f;
  }
  for (int i = threadIdx.x; i < H2 * BN; i += kThreads) dzrn[i] = 0.f;
  __syncthreads();
  for (int s = 0; s < nt; ++s) {
    const int t = nt - 1 - s;
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float z = to_f32(a.zr[row * H2 + u]);
      const float c = to_f32(a.cand[row * H + u]);
      const float hp = t > 0 ? to_f32(a.ys[(row - 1) * H + u]) : 0.f;
      const float dh = to_f32(a.dy[row * H + u]) + dhs[r * H + u];
      const float dz = dh * (c - hp);
      const float dcp = dh * z * (1.f - c * c);
      a.dzc[row * H + u] = from_f32<T>(dcp);
      dcn[u * BN + r] = round_to<T>(dcp);
      dhp[r * H + u] = dh * (1.f - z);
      dzp[r * H + u] = dz * z * (1.f - z);
    }
    __syncthreads();
    rows_times_w<T>(drh, nullptr, dcn, a.wct, H, H, red);
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float rg = to_f32(a.zr[row * H2 + H + u]);
      const float hp = t > 0 ? to_f32(a.ys[(row - 1) * H + u]) : 0.f;
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
    __syncthreads();
    rows_times_w<T>(dhs, dhp, dzrn, a.wgt, H2, H, red);
  }
  // this tile's dW_g and dW_c from the dzg / dzc it stored (visible to
  // the block after the barrier)
  gru_tile_dw<T, false>(a.dwg + (size_t)blockIdx.x * H * H2, a.dzg, H2,
                        a.ys, a.zr, n0, nr, nt, H, hs);
  gru_tile_dw<T, true>(a.dwc + (size_t)blockIdx.x * H * H, a.dzc, H, a.ys,
                       a.zr, n0, nr, nt, H, hs);
}

size_t gru_fwd_smem(int h) {
  return ((size_t)6 * kBlockN * h + kThreads * kBlockN) * sizeof(float);
}

size_t gru_bwd_smem(int h) {
  return ((size_t)7 * kBlockN * h + kDwRows * kDwK + kThreads * kBlockN) *
         sizeof(float);
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

template <typename T>
cudaError_t launch_gru_bwd(GruBwdArgs<T> a, cudaStream_t s) {
  const size_t smem = gru_bwd_smem(a.h);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  gru_bwd_kernel<T><<<(a.n + kBlockN - 1) / kBlockN, kThreads, smem, s>>>(a);
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
cudaError_t gru_bwd_typed(const void* wgt, const void* wct, const void* ys,
                          const void* zr, const void* cand, const void* dy,
                          void* dzg, void* dzc, void* dwg, void* dwc, int n,
                          int t, int h, cudaStream_t s) {
  const GruBwdArgs<T> a{
      static_cast<const T*>(wgt), static_cast<const T*>(wct),
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

// The GRU backward over one direction: dzg, dzc, and each batch tile's
// fp32 dW_g / dW_c in dwg (tiles, H, 2H) / dwc (tiles, H, H) — the
// caller sums the tiles. wgt, wct are W_g and W_c transposed.
extern "C" int bigdl_gru_bwd(const void* wgt, const void* wct, const void* ys,
                             const void* zr, const void* cand, const void* dy,
                             void* dzg, void* dzc, void* dwg, void* dwc, int n,
                             int t, int h, int is_bf16, void* stream) {
  if (bad_shape(1, n, t, h)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)gru_bwd_typed<__nv_bfloat16>(wgt, wct, ys, zr, cand, dy, dzg,
                                             dzc, dwg, dwc, n, t, h, s);
  return (int)gru_bwd_typed<float>(wgt, wct, ys, zr, cand, dy, dzg, dzc, dwg,
                                   dwc, n, t, h, s);
}

extern "C" const char* bigdl_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
