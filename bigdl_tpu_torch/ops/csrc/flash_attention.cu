// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels of bigdl_tpu/ops/flash_attention.py:
//   * fa_fwd_kernel   <- _fa_kernel (K2, launched by _flash_fwd_pallas);
//   * fa_dkdv_kernel + fa_dq_kernel <- _fa_bwd_fused_kernel (K3, via
//     _flash_bwd_pallas_fused) AND the pair _fa_bwd_dkv_kernel /
//     _fa_bwd_dq_kernel (K4/K5, via _flash_bwd_pallas_split).
// The JAX package picks the fused or the split backward by a TPU-VMEM
// bound on the full-sequence dq scratch. Here nothing persists across
// CTAs, so one design serves both routes: a dk/dv kernel over
// (kv-tile, bh) that sweeps the q-tiles, and a dq kernel over
// (q-tile, bh) that sweeps the kv-tiles. Both recompute p from the saved
// log-sum-exp; neither uses atomics, so two runs give the same bits.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), all contiguous, fp32 or
// bf16 (one dtype for all); out and dq/dk/dv in that dtype; lse and
// delta (BH, Sq) fp32. D is 32, 64 or 128; Sq and Sk are any positive
// lengths (tiles past the end are zero-filled and masked).
//
// Numeric conventions (those of the Pallas kernels and of the port's
// plain versions in bigdl_tpu_torch/ops/flash_attention.py):
//   * scores s = (q . k) * sm_scale in fp32; bottom-right causal
//     alignment, key j visible to query i iff j <= i + (Sk - Sq);
//     masked scores are the finite -1e30 and masked probabilities are
//     exactly 0, so a fully masked row emits zeros and lse -1e30;
//   * forward: online softmax in fp32 (running max, running sum,
//     accumulator); p is rounded to v's dtype before the P.V product;
//     lse is the natural-log LSE;
//   * backward: do arrives pre-scaled by sm_scale and rounded to the
//     input dtype, delta = sum(do * o) * sm_scale (computed by the
//     wrapper, as _bwd_prep does), p = exp(s - lse),
//     ds = p * (dp - delta) — already carrying sm_scale — rounded to the
//     operand dtype at its dots, and dv divided by sm_scale at the end.
//     sm_scale == 0 takes the Pallas kernel's degenerate branch: do is
//     not scaled and ds is exactly 0.
//
// What bounds it on the card: at the training shape (BH = 64, S = 2048,
// D = 64, causal) the work is 34 GFLOP forward and 86 GFLOP backward,
// against 67-135 MB forward and 135-269 MB backward (bf16-fp32) of inputs
// and outputs: far above the card's flop/byte balance, so operations
// bound it. The bf16 bound is the tensor-core rate; this first design
// runs every product on the fp32 SIMT cores instead, so it sits well
// above that bound.
//
// Design, simple and right first (tensor cores through mma/wgmma and
// TMA loads are later work):
// * tiles of 64 query rows x 64 keys, 256 threads as a 16 x 16 grid;
//   each thread owns a 4 x 4 block of the score tile (rows ty*4+i,
//   columns tx+16j) and a 4 x D/16 block of the output or gradient tile
//   (columns tx+16jj). The 16 threads of a tile row are one half-warp,
//   so row max and row sum are xor shuffles inside it;
// * operands are staged in shared memory as fp32 with a padded row
//   stride (D + 1), so the column-strided reads of the score loop hit
//   32 distinct banks; tiles above 48 KB opt in with
//   cudaFuncSetAttribute;
// * the causal loop bounds skip tiles entirely above the diagonal and
//   interior tiles skip the mask, as _fa_kernel does;
// * every sum runs in a fixed order: bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = 65;        // padded row stride of a 64-wide tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Reductions over the 16 lanes of a half-warp (one tile row). The xor
// butterfly leaves the same bits in every lane.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Stage 64 rows [row0, row0 + 64) of a (rows, D) matrix into shared
// memory as fp32 with row stride D + 1; rows past `nrows` are zero.
// With kScale, each element becomes round_to<T>(x * scale) — the
// pre-scaled do of the backward.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int nrows, float scale) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < nrows) {
      x = to_f32(src[(size_t)gr * D + c]);
      if (kScale) x = round_to<T>(x * scale);
    }
    dst[r * (D + 1) + c] = x;
  }
}

// Number of kv tiles a q tile starting at q_start can see.
__device__ __forceinline__ int kv_tiles(int q_start, int seq_q, int seq_k,
                                        int causal) {
  int n = (seq_k + kBK - 1) / kBK;
  if (causal) {
    const int last_col = q_start + kBQ - 1 + (seq_k - seq_q);
    n = last_col < 0 ? 0 : min(n, last_col / kBK + 1);
  }
  return n;
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int seq_q, int seq_k, float sm_scale,
              int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* ks = qs + kBQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* ps = vs + kBK * LD;    // [kBQ][kLP] probabilities of the tile

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * kBQ;
  const int off = seq_k - seq_q;
  const T* kb = k + (size_t)bh * seq_k * D;
  const T* vb = v + (size_t)bh * seq_k * D;

  load_tile<T, D, false>(qs, q + (size_t)bh * seq_q * D, q_start, seq_q,
                         1.f);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the previous tile's reads of ks/vs/ps are done
    load_tile<T, D, false>(ks, kb, k_start, seq_k, 1.f);
    load_tile<T, D, false>(vs, vb, k_start, seq_k, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // a tile inside the key range and (causal) wholly below the
    // diagonal needs no mask
    const bool full = k_start + kBK <= seq_k &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
      bool vis[4];
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        vis[j] = full || (col < seq_k && (!causal || col <= row + off));
        s[i][j] = vis[j] ? s[i][j] * sm_scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = row_max(mc);
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - mn) : 0.f;
        ls += p;
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = round_to<T>(p);
      }
      ls = row_sum(ls);
      l[i] = alpha * l[i] + ls;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4], vr[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * kLP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vr[jj] = vs[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(pr[i], vr[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= seq_q) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((size_t)bh * seq_q + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      orow[tx + 16 * jj] = from_f32<T>(acc[i][jj] / safe);
    if (tx == 0)
      lse[(size_t)bh * seq_q + row] =
          l[i] == 0.f ? kNegInf : m[i] + logf(safe);
  }
}

// ------------------------------------------------------------ backward
// dk/dv of one kv tile, sweeping the q tiles that can see it. The thread
// owns kv rows ty*4+i of the transposed score tile and q columns tx+16j.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int seq_q, int seq_k, float sm_scale,
               float do_scale, float dv_scale, int ds_zero, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBK][LD]
  float* vs = ks + kBK * LD;     // [kBK][LD]
  float* qs = vs + kBK * LD;     // [kBQ][LD]
  float* dos = qs + kBQ * LD;    // [kBQ][LD] pre-scaled do
  float* pts = dos + kBQ * LD;   // [kBK][kLP] p^T, rounded
  float* dsts = pts + kBK * kLP; // [kBK][kLP] ds^T, rounded
  float* lses = dsts + kBK * kLP;  // [kBQ]
  float* dels = lses + kBQ;        // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k_start = blockIdx.x * kBK;
  const int off = seq_k - seq_q;
  const T* qb = q + (size_t)bh * seq_q * D;
  const T* dob = dout + (size_t)bh * seq_q * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;

  load_tile<T, D, false>(ks, k + (size_t)bh * seq_k * D, k_start, seq_k,
                         1.f);
  load_tile<T, D, false>(vs, v + (size_t)bh * seq_k * D, k_start, seq_k,
                         1.f);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adk[i][jj] = adv[i][jj] = 0.f;

  // the first q tile holding a row that sees column k_start
  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n_q = (seq_q + kBQ - 1) / kBQ;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q_start = qt * kBQ;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D, false>(qs, qb, q_start, seq_q, 1.f);
    load_tile<T, D, true>(dos, dob, q_start, seq_q, do_scale);
    if (threadIdx.x < kBQ) {
      const int r = q_start + threadIdx.x;
      lses[threadIdx.x] = r < seq_q ? lb[r] : 0.f;
      dels[threadIdx.x] = r < seq_q ? db[r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kr[4], vr[4], qr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kr[i] = ks[(ty * 4 + i) * LD + d];
        vr[i] = vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qr[j] = qs[(tx + 16 * j) * LD + d];
        dr[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], dr[j], dp[i][j]);
        }
    }

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int row = q_start + qc;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lses[qc]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dels[qc]);
        pts[(ty * 4 + i) * kLP + qc] = round_to<T>(p);
        dsts[(ty * 4 + i) * kLP + qc] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int qq = 0; qq < kBQ; ++qq) {
      float pr[4], sr[4], dor[DJ], qr[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = pts[(ty * 4 + i) * kLP + qq];
        sr[i] = dsts[(ty * 4 + i) * kLP + qq];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dor[jj] = dos[qq * LD + tx + 16 * jj];
        qr[jj] = qs[qq * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          adv[i][jj] = fmaf(pr[i], dor[jj], adv[i][jj]);
          adk[i][jj] = fmaf(sr[i], qr[jj], adk[i][jj]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_start + ty * 4 + i;
    if (row >= seq_k) continue;
    T* dkr = dk + ((size_t)bh * seq_k + row) * D;
    T* dvr = dv + ((size_t)bh * seq_k + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dkr[tx + 16 * jj] = from_f32<T>(adk[i][jj]);
      dvr[tx + 16 * jj] = from_f32<T>(adv[i][jj] * dv_scale);
    }
  }
}

// dq of one q tile, sweeping the kv tiles it can see. The thread owns
// q rows ty*4+i of the score tile and kv columns tx+16j.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int seq_q, int seq_k, float sm_scale,
             float do_scale, int ds_zero, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* dos = qs + kBQ * LD;   // [kBQ][LD] pre-scaled do
  float* ks = dos + kBQ * LD;   // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* dss = vs + kBK * LD;   // [kBQ][kLP] ds, rounded

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * kBQ;
  const int off = seq_k - seq_q;
  const T* kb = k + (size_t)bh * seq_k * D;
  const T* vb = v + (size_t)bh * seq_k * D;

  load_tile<T, D, false>(qs, q + (size_t)bh * seq_q * D, q_start, seq_q,
                         1.f);
  load_tile<T, D, true>(dos, dout + (size_t)bh * seq_q * D, q_start, seq_q,
                        do_scale);
  float lr[4], dl[4], adq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    lr[i] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    dl[i] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adq[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D, false>(ks, kb, k_start, seq_k, 1.f);
    load_tile<T, D, false>(vs, vb, k_start, seq_k, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], dr[4], kr[4], vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = qs[(ty * 4 + i) * LD + d];
        dr[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kr[j] = ks[(tx + 16 * j) * LD + d];
        vr[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vr[j], dp[i][j]);
        }
    }

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lr[i]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dl[i]);
        dss[(ty * 4 + i) * kLP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float sr[4], kr[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = dss[(ty * 4 + i) * kLP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kr[jj] = ks[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          adq[i][jj] = fmaf(sr[i], kr[jj], adq[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= seq_q) continue;
    T* dqr = dq + ((size_t)bh * seq_q + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dqr[tx + 16 * jj] = from_f32<T>(adq[i][jj]);
  }
}

// ------------------------------------------------------------- launches
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + kBQ * kLP);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * kBK + 2 * kBQ) * (D + 1) +
                          2 * kBK * kLP + 2 * kBQ);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * (D + 1) + kBQ * kLP);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int seq_q, int seq_k,
                       float sm_scale, int causal, cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<T, D>;
  const size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq_q + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), seq_q, seq_k, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int BH, int seq_q,
                       int seq_k, float sm_scale, float do_scale,
                       float dv_scale, int ds_zero, int causal,
                       cudaStream_t stream) {
  auto dkdv = fa_dkdv_kernel<T, D>;
  size_t smem = dkdv_smem<D>();
  cudaError_t e = allow_smem(dkdv, smem);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3((seq_k + kBK - 1) / kBK, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), seq_q, seq_k, sm_scale,
      do_scale, dv_scale, ds_zero, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dqk = fa_dq_kernel<T, D>;
  smem = dq_smem<D>();
  e = allow_smem(dqk, smem);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((seq_q + kBQ - 1) / kBQ, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), seq_q, seq_k, sm_scale, do_scale, ds_zero,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int BH, int seq_q, int seq_k, int D) {
  return BH < 1 || BH > 65535 || seq_q < 1 || seq_k < 1 ||
         (D != 32 && D != 64 && D != 128);
}

}  // namespace

// C entry points, bound with ctypes by bigdl_tpu_torch/ops/flash_attention.py,
// whose wrappers check devices, dtypes, contiguity and shapes first. Each
// returns the cudaError_t of its launches (0 on success); the kernels run
// on `stream` and nothing here synchronises.

// (out, lse) of the forward: one launch.
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int seq_q,
                               int seq_k, int D, float sm_scale, int causal,
                               int is_bf16, void* stream) {
  if (bad_shape(BH, seq_q, seq_k, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BIGDL_FA_FWD(T, DD) \
  return (int)launch_fwd<T, DD>(q, k, v, out, lse, BH, seq_q, seq_k, \
                                sm_scale, causal, s)
  if (is_bf16) {
    if (D == 32) BIGDL_FA_FWD(__nv_bfloat16, 32);
    if (D == 64) BIGDL_FA_FWD(__nv_bfloat16, 64);
    BIGDL_FA_FWD(__nv_bfloat16, 128);
  }
  if (D == 32) BIGDL_FA_FWD(float, 32);
  if (D == 64) BIGDL_FA_FWD(float, 64);
  BIGDL_FA_FWD(float, 128);
#undef BIGDL_FA_FWD
}

// (dq, dk, dv) of the backward: two launches, dk/dv then dq. `delta` is
// sum(do * o) * sm_scale per query row; do_scale is sm_scale (1 when
// sm_scale == 0), dv_scale 1 / sm_scale (1 when sm_scale == 0), and
// ds_zero is set when sm_scale == 0.
extern "C" int bigdl_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int BH, int seq_q, int seq_k, int D,
                               float sm_scale, float do_scale,
                               float dv_scale, int ds_zero, int causal,
                               int is_bf16, void* stream) {
  if (bad_shape(BH, seq_q, seq_k, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BIGDL_FA_BWD(T, DD)                                                 \
  return (int)launch_bwd<T, DD>(q, k, v, dout, lse, delta, dq, dk, dv, BH, \
                                seq_q, seq_k, sm_scale, do_scale, dv_scale, \
                                ds_zero, causal, s)
  if (is_bf16) {
    if (D == 32) BIGDL_FA_BWD(__nv_bfloat16, 32);
    if (D == 64) BIGDL_FA_BWD(__nv_bfloat16, 64);
    BIGDL_FA_BWD(__nv_bfloat16, 128);
  }
  if (D == 32) BIGDL_FA_BWD(float, 32);
  if (D == 64) BIGDL_FA_BWD(float, 64);
  BIGDL_FA_BWD(float, 128);
#undef BIGDL_FA_BWD
}

// Human-readable text for a cudaError_t an entry point returned.
extern "C" const char* bigdl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
