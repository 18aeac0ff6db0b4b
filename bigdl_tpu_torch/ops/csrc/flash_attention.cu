// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels of bigdl_tpu/ops/flash_attention.py:
//   * forward  <- _fa_kernel (K2, launched by _flash_fwd_pallas);
//   * dk/dv + dq <- _fa_bwd_fused_kernel (K3, via _flash_bwd_pallas_fused)
//     AND the pair _fa_bwd_dkv_kernel / _fa_bwd_dq_kernel (K4/K5, via
//     _flash_bwd_pallas_split).
// The JAX package picks the fused or the split backward by a TPU-VMEM
// bound on the full-sequence dq scratch. Here nothing persists across
// CTAs, so one design serves both routes: a dk/dv kernel over
// (kv-tile, bh) that sweeps the q-tiles, and a dq kernel over
// (q-tile, bh) that sweeps the kv-tiles. Both recompute p from the saved
// log-sum-exp; neither uses atomics, so two runs give the same bits.
//
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), all contiguous, fp32 or
// bf16 (one dtype for all; bf16 rows 16-byte aligned); out and dq/dk/dv
// in that dtype; lse and delta (BH, Sq) fp32. D is 32, 64, 128 or 256,
// or a multiple of 128 above 256 (the column-split kernels, "D > 256"
// below; their forward writes D / 128 lse rows); Sq and Sk are any
// positive lengths (tiles past the end are zero-filled and masked).
//
// Numeric conventions (those of the Pallas kernels and of the port's
// plain versions in bigdl_tpu_torch/ops/flash_attention.py):
//   * scores s = (q . k) * sm_scale in fp32; bottom-right causal
//     alignment, key j visible to query i iff j <= i + (Sk - Sq);
//     masked scores are the finite -1e30 and masked probabilities are
//     exactly 0, so a fully masked row emits zeros and lse -1e30;
//   * forward: online softmax in fp32 over tiles of 64 keys (running
//     max, running sum, accumulator); p = exp(s - running max) is
//     rounded to v's dtype before the P.V product; lse is the
//     natural-log LSE;
//   * exponentials: expf in the fp32 kernels; exp2f of scores scaled by
//     sm_scale * log2(e) in the bf16 kernels (the same p to within
//     exp2f's 2 ulps, far below a bf16 ulp);
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
// bound it — the tensor cores' rate in bf16, the SIMT cores' in fp32.
// The trainer's LM at two heads (BH = 16, S = 2048, D = 256) does the
// same work.
//
// Two designs, one a dtype:
// * bf16 runs its products on the tensor cores (wgmma, sm90.cuh). A
//   warpgroup (128 threads) owns 64 rows of each product; K/V (forward,
//   dq) or Q/dO/lse/delta (dk/dv) tiles stream through a 2-stage ring
//   of cp.async copies, tile t + 1 in flight while tile t computes;
//   operands sit in shared memory in the swizzled layout wgmma reads.
//   S = Q.K^T (and dP, S^T, dP^T) take both operands from shared
//   memory; the fp32 accumulator stays in registers, where the mask and
//   the softmax run (a row lives in the 4 threads of a quad: two xor
//   shuffles reduce it), and p or ds, rounded to bf16, feeds the next
//   product straight from registers as its A operand, the other operand
//   read MN-major (transposed) from the same shared tile. The forward's
//   CTA holds kFwdWarpgroups warpgroups (64 query rows each) over one
//   K/V ring; forward and dq walk their q tiles heaviest first under the
//   causal mask. The backward waits for S alone and takes p while dP is
//   still on the tensor cores; dk/dv also accumulates dV while it takes
//   ds. dk/dv gives each warpgroup one 64-column slice of dK and dV, so
//   at D = 128 two warpgroups share the 64 keys and each recomputes S^T
//   and dP^T (two fewer accumulators of 64 floats a thread: no
//   spills). D = 256 keeps the tiles and gives a thread at most 255
//   registers: the forward's CTA as at D = 128 (O alone is 128
//   registers); dk/dv two warpgroups of two slices each, taking p and ds
//   before it issues dV and dK; dq two warpgroups of 128 columns each,
//   both computing S and dP.
// * fp32 stays on the SIMT cores (tensor cores would round its operands
//   to TF32): tiles of 64 query rows x 64 keys, 256 threads as a 16 x 16
//   grid; each thread owns a 4 x 4 block of the score tile (rows
//   ty*4+i, columns tx+16j) and a 4 x D/16 block of the output or
//   gradient tile (columns tx+16jj); row max and row sum are xor
//   shuffles inside a half-warp; operands staged as fp32 with a padded
//   row stride (D + 1), loaded synchronously. At D = 256 the backward
//   kernels' own tiles (keys of dk/dv, queries of dq) are 32 rows, 2 a
//   thread, so that their staging fits the 227 KB of shared memory.
// Both skip the tiles wholly above the causal diagonal, mask only the
// tiles that need it, and sum in a fixed order: bitwise reproducible.
//
// Above D = 256 (the wrapper pads D to a multiple of 128) a thread cannot
// hold a 64-row accumulator of D columns beside S: a CTA owns a 128-column
// slice of the output instead (grid.z), and computes S (and dP) over the
// full D in 128-column chunks streamed through shared memory. The work of
// S and dP is done once a slice, so at D = 512 the forward's S costs 4x
// and the backward's S and dP 4x what one CTA a tile would pay; at the
// 43M LM's one-head shape (BH = 8, S = 2048, D = 512) that keeps it well
// above the card's flop/byte balance, bound by operations. See "D > 256"
// below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // fp32 kernels: 16 x 16
constexpr int kLP = 65;        // padded row stride of a 64-wide tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWGThreads = 128;   // a warpgroup
constexpr int kFwdWarpgroups = 2;  // the bf16 forward's CTA
constexpr int kFwdRows = 64 * kFwdWarpgroups;

// ================================================================ fp32
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

// Stage kRows rows [row0, row0 + kRows) of a (rows, D) matrix into
// shared memory as fp32 with row stride D + 1; rows past `nrows` are
// zero. With kScale, each element becomes x * scale — the pre-scaled do
// of the backward.
// load_block: the same for a D-column block of a matrix of row stride
// `ld` (src at the block's first column).
template <int D, bool kScale, int kRows = 64>
__device__ __forceinline__ void load_block(float* dst, const float* src,
                                           int ld, int row0, int nrows,
                                           float scale) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < nrows) {
      x = src[(size_t)gr * ld + c];
      if (kScale) x *= scale;
    }
    dst[r * (D + 1) + c] = x;
  }
}

template <int D, bool kScale, int kRows = 64>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0,
                                          int nrows, float scale) {
  load_block<D, kScale, kRows>(dst, src, D, row0, nrows, scale);
}

// Rows a thread owns in the backward kernels' own tile (keys of dk/dv,
// queries of dq), which is 16 of them tall: 4 up to D = 128, 2 at
// D = 256, where two 64-row tiles of fp32 operands and two 64-row
// staging tiles of K, V, Q and dO would not fit in the 227 KB of shared
// memory a block may hold.
template <int D>
constexpr __host__ __device__ int simt_rows() {
  return D == 256 ? 2 : 4;
}

// Number of kv tiles a q tile starting at q_start can see.
__device__ __forceinline__ int kv_tiles(int q_start, int rows, int seq_q,
                                        int seq_k, int causal) {
  int n = (seq_k + kBK - 1) / kBK;
  if (causal) {
    const int last_col = q_start + rows - 1 + (seq_k - seq_q);
    n = last_col < 0 ? 0 : min(n, last_col / kBK + 1);
  }
  return n;
}

// ------------------------------------------------------------- forward
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
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
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;

  load_tile<D, false>(qs, q + (size_t)bh * seq_q * D, q_start, seq_q,
                         1.f);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, kBQ, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the previous tile's reads of ks/vs/ps are done
    load_tile<D, false>(ks, kb, k_start, seq_k, 1.f);
    load_tile<D, false>(vs, vb, k_start, seq_k, 1.f);
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
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = p;
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
    float* orow = out + ((size_t)bh * seq_q + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      orow[tx + 16 * jj] = acc[i][jj] / safe;
    if (tx == 0)
      lse[(size_t)bh * seq_q + row] =
          l[i] == 0.f ? kNegInf : m[i] + logf(safe);
  }
}

// ------------------------------------------------------------ backward
// dk/dv of one kv tile of BK = 16 R keys, sweeping the q tiles that can
// see it. The thread owns kv rows ty*R+i of the transposed score tile
// and q columns tx+16j.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int seq_q, int seq_k, float sm_scale,
               float do_scale, float dv_scale, int ds_zero, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int R = simt_rows<D>();
  constexpr int BK = 16 * R;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* qs = vs + BK * LD;      // [kBQ][LD]
  float* dos = qs + kBQ * LD;    // [kBQ][LD] pre-scaled do
  float* pts = dos + kBQ * LD;   // [BK][kLP] p^T
  float* dsts = pts + BK * kLP;  // [BK][kLP] ds^T
  float* lses = dsts + BK * kLP;  // [kBQ]
  float* dels = lses + kBQ;       // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k_start = blockIdx.x * BK;
  const int off = seq_k - seq_q;
  const float* qb = q + (size_t)bh * seq_q * D;
  const float* dob = dout + (size_t)bh * seq_q * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;

  load_tile<D, false, BK>(ks, k + (size_t)bh * seq_k * D, k_start, seq_k,
                          1.f);
  load_tile<D, false, BK>(vs, v + (size_t)bh * seq_k * D, k_start, seq_k,
                          1.f);

  float adk[R][DJ], adv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adk[i][jj] = adv[i][jj] = 0.f;

  // the first q tile holding a row that sees column k_start
  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n_q = (seq_q + kBQ - 1) / kBQ;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q_start = qt * kBQ;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D, false>(qs, qb, q_start, seq_q, 1.f);
    load_tile<D, true>(dos, dob, q_start, seq_q, do_scale);
    if (threadIdx.x < kBQ) {
      const int r = q_start + threadIdx.x;
      lses[threadIdx.x] = r < seq_q ? lb[r] : 0.f;
      dels[threadIdx.x] = r < seq_q ? db[r] : 0.f;
    }
    __syncthreads();

    float s[R][4], dp[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kr[R], vr[R], qr[4], dr[4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kr[i] = ks[(ty * R + i) * LD + d];
        vr[i] = vs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qr[j] = qs[(tx + 16 * j) * LD + d];
        dr[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], dr[j], dp[i][j]);
        }
    }

    const bool full = k_start + BK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + BK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = k_start + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int row = q_start + qc;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lses[qc]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dels[qc]);
        pts[(ty * R + i) * kLP + qc] = p;
        dsts[(ty * R + i) * kLP + qc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int qq = 0; qq < kBQ; ++qq) {
      float pr[R], sr[R], dor[DJ], qr[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = pts[(ty * R + i) * kLP + qq];
        sr[i] = dsts[(ty * R + i) * kLP + qq];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dor[jj] = dos[qq * LD + tx + 16 * jj];
        qr[jj] = qs[qq * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          adv[i][jj] = fmaf(pr[i], dor[jj], adv[i][jj]);
          adk[i][jj] = fmaf(sr[i], qr[jj], adk[i][jj]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k_start + ty * R + i;
    if (row >= seq_k) continue;
    float* dkr = dk + ((size_t)bh * seq_k + row) * D;
    float* dvr = dv + ((size_t)bh * seq_k + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dkr[tx + 16 * jj] = adk[i][jj];
      dvr[tx + 16 * jj] = adv[i][jj] * dv_scale;
    }
  }
}

// dq of one q tile of BQ = 16 R rows, sweeping the kv tiles it can see.
// The thread owns q rows ty*R+i of the score tile and kv columns
// tx+16j.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int seq_q, int seq_k, float sm_scale,
             float do_scale, int ds_zero, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int R = simt_rows<D>();
  constexpr int BQ = 16 * R;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD] pre-scaled do
  float* ks = dos + BQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;    // [kBK][LD]
  float* dss = vs + kBK * LD;   // [BQ][kLP] ds

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q_start = blockIdx.x * BQ;
  const int off = seq_k - seq_q;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;

  load_tile<D, false, BQ>(qs, q + (size_t)bh * seq_q * D, q_start, seq_q,
                          1.f);
  load_tile<D, true, BQ>(dos, dout + (size_t)bh * seq_q * D, q_start,
                         seq_q, do_scale);
  float lr[R], dl[R], adq[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_start + ty * R + i;
    lr[i] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    dl[i] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adq[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, BQ, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D, false>(ks, kb, k_start, seq_k, 1.f);
    load_tile<D, false>(vs, vb, k_start, seq_k, 1.f);
    __syncthreads();

    float s[R][4], dp[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[R], dr[R], kr[4], vr[4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qr[i] = qs[(ty * R + i) * LD + d];
        dr[i] = dos[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kr[j] = ks[(tx + 16 * j) * LD + d];
        vr[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vr[j], dp[i][j]);
        }
    }

    const bool full = k_start + kBK <= seq_k && q_start + BQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q_start + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lr[i]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dl[i]);
        dss[(ty * R + i) * kLP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float sr[R], kr[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) sr[i] = dss[(ty * R + i) * kLP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kr[jj] = ks[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          adq[i][jj] = fmaf(sr[i], kr[jj], adq[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_start + ty * R + i;
    if (row >= seq_q) continue;
    float* dqr = dq + ((size_t)bh * seq_q + row) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dqr[tx + 16 * jj] = adq[i][jj];
  }
}

// ------------------------------------------------------ D > 256 (fp32)
// Head dims above 256 (a multiple of kWC, as the wrapper pads them) split
// the output's columns over CTAs: grid.z is the slice, kWC columns of O
// (forward) or of dK and dV, or dQ (backward) each. Every CTA computes S
// (and dP) over the full D, streaming Q, K (V, dO) through shared memory
// in kWC-column chunks, so its registers hold one slice's accumulator
// whatever D is. The forward's slices take the chunks in one order, so
// they compute the same S, m and l bit for bit: every slice writes its
// lse row (lse is (D / kWC, BH, Sq)) and the wrapper returns the first.
// The backward takes chunk `slice` last, and its dV/dK (dQ) products
// read that chunk's Q and dO (K) from where the chunk loop left them.
constexpr int kWC = 128;

__device__ __forceinline__ int wide_chunk(int slice, int i, int nch) {
  return (slice + 1 + i) % nch;  // the backward's order: `slice` last
}

__global__ void __launch_bounds__(kThreads)
fa_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int seq_q, int seq_k, int D,
                   float sm_scale, int causal) {
  constexpr int LD = kWC + 1;
  constexpr int DJ = kWC / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD] a chunk of Q
  float* ks = qs + kBQ * LD;    // [kBK][LD] a chunk of K
  float* vs = ks + kBK * LD;    // [kBK][LD] the slice of V
  float* ps = vs + kBK * LD;    // [kBQ][kLP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int q_start = blockIdx.x * kBQ;
  const int off = seq_k - seq_q;
  const float* qb = q + (size_t)bh * seq_q * D;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D + slice * kWC;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, kBQ, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nch; ++c) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_block<kWC, false>(qs, qb + c * kWC, D, q_start, seq_q, 1.f);
      load_block<kWC, false>(ks, kb + c * kWC, D, k_start, seq_k, 1.f);
      if (c == 0)
        load_block<kWC, false>(vs, vb, D, k_start, seq_k, 1.f);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kWC; ++d) {
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
    }

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
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = p;
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
    float* orow = out + ((size_t)bh * seq_q + row) * D + slice * kWC;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) orow[tx + 16 * jj] = acc[i][jj] / safe;
    if (tx == 0)
      lse[((size_t)slice * gridDim.y + bh) * seq_q + row] =
          l[i] == 0.f ? kNegInf : m[i] + logf(safe);
  }
}

// dk/dv of 64 keys (4 rows a thread), slice `slice` of their columns,
// sweeping the q tiles that can see them.
__global__ void __launch_bounds__(kThreads)
fa_dkdv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int seq_q, int seq_k, int D,
                    float sm_scale, float do_scale, float dv_scale,
                    int ds_zero, int causal) {
  constexpr int LD = kWC + 1;
  constexpr int DJ = kWC / 16;
  constexpr int R = 4;
  constexpr int BK = 16 * R;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][LD] chunks of K, V, Q, pre-scaled dO
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;      // [kBQ][LD]
  float* dos = qs + kBQ * LD;    // [kBQ][LD]
  float* pts = dos + kBQ * LD;   // [BK][kLP] p^T
  float* dsts = pts + BK * kLP;  // [BK][kLP] ds^T
  float* lses = dsts + BK * kLP;  // [kBQ]
  float* dels = lses + kBQ;       // [kBQ]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int k_start = blockIdx.x * BK;
  const int off = seq_k - seq_q;
  const float* qb = q + (size_t)bh * seq_q * D;
  const float* dob = dout + (size_t)bh * seq_q * D;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;

  float adk[R][DJ], adv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adk[i][jj] = adv[i][jj] = 0.f;

  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n_q = (seq_q + kBQ - 1) / kBQ;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q_start = qt * kBQ;
    float s[R][4], dp[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      const int c = wide_chunk(slice, ci, nch) * kWC;
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_block<kWC, false, BK>(ks, kb + c, D, k_start, seq_k, 1.f);
      load_block<kWC, false, BK>(vs, vb + c, D, k_start, seq_k, 1.f);
      load_block<kWC, false>(qs, qb + c, D, q_start, seq_q, 1.f);
      load_block<kWC, true>(dos, dob + c, D, q_start, seq_q, do_scale);
      if (ci == 0 && threadIdx.x < kBQ) {
        const int r = q_start + threadIdx.x;
        lses[threadIdx.x] = r < seq_q ? lb[r] : 0.f;
        dels[threadIdx.x] = r < seq_q ? db[r] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kWC; ++d) {
        float kr[R], vr[R], qr[4], dr[4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kr[i] = ks[(ty * R + i) * LD + d];
          vr[i] = vs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qr[j] = qs[(tx + 16 * j) * LD + d];
          dr[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], dr[j], dp[i][j]);
          }
      }
    }
    // qs and dos now hold chunk `slice`: the columns this CTA owns

    const bool full = k_start + BK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + BK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = k_start + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int row = q_start + qc;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lses[qc]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dels[qc]);
        pts[(ty * R + i) * kLP + qc] = p;
        dsts[(ty * R + i) * kLP + qc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int qq = 0; qq < kBQ; ++qq) {
      float pr[R], sr[R], dor[DJ], qr[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = pts[(ty * R + i) * kLP + qq];
        sr[i] = dsts[(ty * R + i) * kLP + qq];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dor[jj] = dos[qq * LD + tx + 16 * jj];
        qr[jj] = qs[qq * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          adv[i][jj] = fmaf(pr[i], dor[jj], adv[i][jj]);
          adk[i][jj] = fmaf(sr[i], qr[jj], adk[i][jj]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k_start + ty * R + i;
    if (row >= seq_k) continue;
    float* dkr = dk + ((size_t)bh * seq_k + row) * D + slice * kWC;
    float* dvr = dv + ((size_t)bh * seq_k + row) * D + slice * kWC;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dkr[tx + 16 * jj] = adk[i][jj];
      dvr[tx + 16 * jj] = adv[i][jj] * dv_scale;
    }
  }
}

// dq of kWideDqRows query rows (2 a thread: at 4, S, dP and the dQ
// slice spilled), slice `slice` of its columns, sweeping the kv tiles
// they can see.
constexpr int kWideDqRows = 32;

__global__ void __launch_bounds__(kThreads, 1)
fa_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int seq_q, int seq_k, int D, float sm_scale,
                  float do_scale, int ds_zero, int causal) {
  constexpr int LD = kWC + 1;
  constexpr int DJ = kWC / 16;
  constexpr int BQ = kWideDqRows;
  constexpr int R = BQ / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD] chunks of Q, pre-scaled dO, K, V
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;    // [kBK][LD]
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LD;   // [BQ][kLP] ds

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int q_start = blockIdx.x * BQ;
  const int off = seq_k - seq_q;
  const float* qb = q + (size_t)bh * seq_q * D;
  const float* dob = dout + (size_t)bh * seq_q * D;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;

  float lr[R], dl[R], adq[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_start + ty * R + i;
    lr[i] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    dl[i] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) adq[i][jj] = 0.f;
  }

  const int n_kv = kv_tiles(q_start, BQ, seq_q, seq_k, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    float s[R][4], dp[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      const int c = wide_chunk(slice, ci, nch) * kWC;
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_block<kWC, false, BQ>(qs, qb + c, D, q_start, seq_q, 1.f);
      load_block<kWC, true, BQ>(dos, dob + c, D, q_start, seq_q, do_scale);
      load_block<kWC, false>(ks, kb + c, D, k_start, seq_k, 1.f);
      load_block<kWC, false>(vs, vb + c, D, k_start, seq_k, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kWC; ++d) {
        float qr[R], dr[R], kr[4], vr[4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qr[i] = qs[(ty * R + i) * LD + d];
          dr[i] = dos[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kr[j] = ks[(tx + 16 * j) * LD + d];
          vr[j] = vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
            dp[i][j] = fmaf(dr[i], vr[j], dp[i][j]);
          }
      }
    }
    // ks now holds chunk `slice` of K: the columns this CTA owns

    const bool full = k_start + kBK <= seq_k && q_start + BQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q_start + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        const bool vis =
            full || (col < seq_k && row < seq_q &&
                     (!causal || col <= row + off));
        const float p = vis ? expf(s[i][j] * sm_scale - lr[i]) : 0.f;
        const float ds = ds_zero ? 0.f : p * (dp[i][j] - dl[i]);
        dss[(ty * R + i) * kLP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float sr[R], kr[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) sr[i] = dss[(ty * R + i) * kLP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kr[jj] = ks[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          adq[i][jj] = fmaf(sr[i], kr[jj], adq[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q_start + ty * R + i;
    if (row >= seq_q) continue;
    float* dqr = dq + ((size_t)bh * seq_q + row) * D + slice * kWC;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dqr[tx + 16 * jj] = adq[i][jj];
  }
}

// ================================================================ bf16
// Reductions over the 4 lanes of a quad (one accumulator row); the xor
// butterfly leaves the same bits in every lane.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// The bf16 kernels take their exponentials as exp2f of scores in log2
// units: s * (sm_scale * log2 e) - m', with m' the running max (forward)
// or lse * log2 e (backward); the lse they store is back in natural log.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory from its first 1024-byte boundary (the swizzle
// atoms'); the launches ask for 1 KB more than they use
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024u - (sm90::smem_u32(p) & 1023u)) & 1023u);
}

// Accumulator fragment of wgmma m64nN (fp32): register 4j + 2h + e of
// the thread (warp w of its warpgroup, lane 4g + t) is row 16w + g + 8h,
// column 8j + 2t + e. For a 64-wide tile the registers 8kk..8kk+7 are
// the A-operand fragment of k-step kk of the next product, pairwise
// packed to bf16.
__device__ __forceinline__ void to_a_operand(const float (&x)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = sm90::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// every element of a bf16 tile chunk times `scale`, rounded to bf16
__device__ __forceinline__ void scale_chunk(uint4* c, float scale) {
  uint4 w = *c;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    u[i] = sm90::pack_bf16(f.x * scale, f.y * scale);
  }
  *c = w;
}

// Store the thread's two rows (h = 0, 1) of a warpgroup's 64-row fp32
// accumulator (kSubs sub-tiles of kAcc registers, kSubCols columns
// each), divided by (kDiv) or times f[h], as bf16 into row-major `dst`
// of row stride `ld` from row `row0` and column `col0`; rows at or past
// `nrows` are skipped. store_rows: a (rows, D) matrix of Tile<D>
// sub-tiles.
template <int kSubCols, bool kDiv, int kSubs, int kAcc>
__device__ __forceinline__ void store_rows_ld(bf16* dst,
                                              const float (&acc)[kSubs][kAcc],
                                              const float (&f)[2], int row0,
                                              int col0, int nrows, int ld) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= nrows) continue;
    bf16* r = dst + (size_t)row * ld + col0 + 2 * (lane & 3);
#pragma unroll
    for (int s = 0; s < kSubs; ++s)
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(r + s * kSubCols + 8 * j) =
            kDiv ? __floats2bfloat162_rn(acc[s][4 * j + 2 * h] / f[h],
                                         acc[s][4 * j + 2 * h + 1] / f[h])
                 : __floats2bfloat162_rn(acc[s][4 * j + 2 * h] * f[h],
                                         acc[s][4 * j + 2 * h + 1] * f[h]);
  }
}

template <int D, bool kDiv, int kSubs, int kAcc>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[kSubs][kAcc],
                                           const float (&f)[2], int row0,
                                           int col0, int nrows) {
  store_rows_ld<sm90::Tile<D>::kSubCols, kDiv>(dst, acc, f, row0, col0,
                                               nrows, D);
}

// ------------------------------------------------------------- forward
// One kv tile of the online softmax on the warpgroup's score
// accumulator s: scale the scores to log2 units (and with kMask mask
// them), update the running max m (log2 units) and sum l of the thread's
// two rows, rescale o, and leave p = 2^(s - m) in s. Rows are
// wq + 16 warp + g + 8h, columns k_start + 8j + 2tq + e.
template <bool kMask, int kSubs, int kAcc>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&o)[kSubs][kAcc],
    int wq, int k_start, int seq_k, int off, int causal, float scale_log2) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wq + 16 * warp + g + 8 * h;
    float mc = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k_start + 8 * j + 2 * tq + e;
        float& x = s[4 * j + 2 * h + e];
        x = !kMask || (col < seq_k && (!causal || col <= row + off))
                ? x * scale_log2
                : kNegInf;
        mc = fmaxf(mc, x);
      }
    mc = quad_max(mc);
    const float mn = fmaxf(m[h], mc);
    const float alpha = exp2f(m[h] - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k_start + 8 * j + 2 * tq + e;
        float& x = s[4 * j + 2 * h + e];
        x = !kMask || (col < seq_k && (!causal || col <= row + off))
                ? exp2f(x - mn)
                : 0.f;
        ls += x;
      }
    ls = quad_sum(ls);
    l[h] = alpha * l[h] + ls;
    m[h] = mn;
#pragma unroll
    for (int sb = 0; sb < kSubs; ++sb)
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        o[sb][4 * j + 2 * h] *= alpha;
        o[sb][4 * j + 2 * h + 1] *= alpha;
      }
  }
}

// One CTA: kFwdWarpgroups warpgroups, 64 query rows each, over one ring
// of K/V tiles. Shared memory: Q (kFwdRows rows), then 2 stages of
// [K, V].
template <int D>
__global__ void __launch_bounds__(kWGThreads * kFwdWarpgroups)
fa_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int seq_q, int seq_k,
                   float sm_scale, int causal) {
  using L = sm90::Tile<D>;
  constexpr int BQ = kFwdRows;
  constexpr int kCta = kWGThreads * kFwdWarpgroups;
  constexpr int kAcc = L::kSwB / 4;            // fp32 a thread, a sub-tile
  constexpr uint32_t kT = L::bytes(kBK);       // one K or V tile
  extern __shared__ uint8_t smem_bytes[];
  const uint32_t qs = sm90::smem_u32(align_1k(smem_bytes));
  const uint32_t kv0 = qs + L::bytes(BQ);      // stage s: K, then V

  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int tq = tid & 3;
  const int bh = blockIdx.y;
  // the last q tiles see the most keys: they start first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int wq = q_start + 64 * wg;            // the warpgroup's first row
  const int off = seq_k - seq_q;
  const bf16* kb = k + (size_t)bh * seq_k * D;
  const bf16* vb = v + (size_t)bh * seq_k * D;

  const int n_kv = kv_tiles(q_start, BQ, seq_q, seq_k, causal);
  if (n_kv > 0) {
    sm90::load_tile<D>(qs, q + (size_t)bh * seq_q * D, q_start, BQ, seq_q,
                       tid, kCta);
    sm90::load_tile<D>(kv0, kb, 0, kBK, seq_k, tid, kCta);
    sm90::load_tile<D>(kv0 + kT, vb, 0, kBK, seq_k, tid, kCta);
  }
  sm90::cp_async_commit();

  float o[L::kSubs][kAcc];
#pragma unroll
  for (int s = 0; s < L::kSubs; ++s)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[s][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // every warpgroup is done with the stage t+1 refills
    if (t + 1 < n_kv) {
      const uint32_t nxt = kv0 + ((t + 1) & 1) * 2 * kT;
      sm90::load_tile<D>(nxt, kb, k_start + kBK, kBK, seq_k, tid, kCta);
      sm90::load_tile<D>(nxt + kT, vb, k_start + kBK, kBK, seq_k, tid, kCta);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and Q) landed
    sm90::fence_view_async_shared();
    __syncthreads();
    // a tile wholly above this warpgroup's diagonal changes nothing
    if (causal && k_start > wq + 63 + off) continue;

    const uint32_t ks = kv0 + (t & 1) * 2 * kT;
    const uint32_t vs = ks + kT;
    float s[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(s, sm90::desc_k<D>(qs, BQ, 64 * wg, kk),
                         sm90::desc_k<D>(ks, kBK, 0, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // a tile inside the key range and (causal) wholly below the
    // warpgroup's diagonal needs no mask
    const bool full = k_start + kBK <= seq_k &&
                      (!causal || k_start + kBK - 1 <= wq + off);
    if (full)
      online_softmax<false>(s, m, l, o, wq, k_start, seq_k, off, causal,
                            sm_scale * kLog2e);
    else
      online_softmax<true>(s, m, l, o, wq, k_start, seq_k, off, causal,
                           sm_scale * kLog2e);

    uint32_t pa[4][4];
    to_a_operand(s, pa);
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(o[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < L::kSubs; ++sb)
        sm90::wgmma_rs(o[sb], pa[kk], sm90::desc_mn<D>(vs, kBK, sb, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(o[sb]);
  }

  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    safe[h] = l[h] == 0.f ? 1.f : l[h];
    const int row = wq + 16 * warp + g + 8 * h;
    if (tq == 0 && row < seq_q)
      lse[(size_t)bh * seq_q + row] =
          l[h] == 0.f ? kNegInf : m[h] * kLn2 + logf(safe[h]);
  }
  store_rows<D, true>(out + (size_t)bh * seq_q * D, o, safe, wq, 0, seq_q);
}

// ------------------------------------------------------------ backward
// The backward's elementwise steps on a warpgroup's S and dP
// accumulators. *_probs: p = exp(s scale - lse) = 2^(s scale_log2 -
// lse log2 e), masked with kMask, left in s; *_ds: ds = p (dp - delta) (0 when ds_zero), left in dp. row_*:
// rows are queries q0 + 16 warp + g + 8h (the lse and delta of the
// thread's two rows in lr, dl), columns keys k0 + 8j + 2tq + e.
// transposed_*: S^T and dP^T, rows keys, columns queries (their lse and
// delta in shared memory).
template <bool kMask>
__device__ __forceinline__ void row_probs(float (&s)[32],
                                          const float (&lr)[2], int q0,
                                          int k0, int seq_q, int seq_k,
                                          int off, int causal,
                                          float scale_log2) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * tq + e;
        const bool vis = !kMask || (col < seq_k && row < seq_q &&
                                    (!causal || col <= row + off));
        float& x = s[4 * j + 2 * h + e];
        x = vis ? exp2f(x * scale_log2 - lr[h] * kLog2e) : 0.f;
      }
  }
}

__device__ __forceinline__ void row_ds(const float (&p)[32],
                                       float (&dp)[32], const float (&dl)[2],
                                       int ds_zero) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dp[i] = ds_zero ? 0.f : p[i] * (dp[i] - dl[(i >> 1) & 1]);
}

template <bool kMask>
__device__ __forceinline__ void transposed_probs(float (&sT)[32],
                                                 const float* lses, int k0,
                                                 int q0, int seq_q,
                                                 int seq_k, int off,
                                                 int causal,
                                                 float scale_log2) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * tq + e;
        const int row = q0 + qc;
        const bool vis = !kMask || (key < seq_k && row < seq_q &&
                                    (!causal || key <= row + off));
        float& x = sT[4 * j + 2 * h + e];
        x = vis ? exp2f(x * scale_log2 - lses[qc] * kLog2e) : 0.f;
      }
  }
}

__device__ __forceinline__ void transposed_ds(const float (&pT)[32],
                                              float (&dpT)[32],
                                              const float* dels,
                                              int ds_zero) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dpT[i] = ds_zero ? 0.f
                     : pT[i] * (dpT[i] - dels[8 * (i >> 2) + 2 * tq + (i & 1)]);
}

// 64-column sub-tiles of dK and dV a warpgroup of the dk/dv kernel
// accumulates: one up to D = 128 (a warpgroup a sub-tile), two at
// D = 256 (two warpgroups: four, 512 threads, would cap a thread at 128
// registers, below S^T, dP^T and the accumulators together).
template <int D>
constexpr __host__ __device__ int dkdv_wg_subs() {
  return D == 256 ? 2 : 1;
}
template <int D>
constexpr __host__ __device__ int dkdv_threads() {
  return kWGThreads * sm90::Tile<D>::kSubs / dkdv_wg_subs<D>();
}

// Warpgroups of the dq kernel: one up to D = 128; at D = 256 two, each
// computing S and dP in full and accumulating 128 of dQ's columns (one
// warpgroup would hold all 256, 128 registers a thread, beside S and
// dP: 251 registers, against 193 for two).
template <int D>
constexpr __host__ __device__ int dq_wgs() {
  return D == 256 ? 2 : 1;
}

// dk/dv of 64 keys, sweeping the q tiles that can see them. Warpgroup wg
// computes S^T = K.Q^T and dP^T = V.dO^T in full and accumulates its
// dkdv_wg_subs 64-column sub-tiles of dK and dV, from column
// wg * 64 * dkdv_wg_subs: two warpgroups at D = 128, one sub-tile each;
// two at D = 256, two sub-tiles each. Up to D = 128 the dV product is
// issued while dP^T is still computing; at D = 256 (kLate) the
// warpgroup waits for dP^T, takes p and ds, and issues dV and dK
// together, so that p's operand fragments are not live beside S^T,
// dP^T and the 128 accumulator registers (the early schedule spilled
// there). Shared memory: K, V, then 2 stages of [Q, dO] and 2 of [lse,
// delta] (64 floats each).
template <int D>
__global__ void __launch_bounds__(dkdv_threads<D>())
fa_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int seq_q, int seq_k,
                    float sm_scale, float do_scale, float dv_scale,
                    int ds_zero, int causal) {
  using L = sm90::Tile<D>;
  constexpr int kCta = dkdv_threads<D>();
  constexpr int kWS = dkdv_wg_subs<D>();
  constexpr bool kLate = D == 256;
  constexpr int kAcc = L::kSwB / 4;
  constexpr uint32_t kT = L::bytes(64);
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t ks = sm90::smem_u32(base);
  const uint32_t vs = ks + kT;
  const uint32_t st0 = vs + kT;                // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(base + 6 * kT);  // [2][lse, delta][64]

  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int bh = blockIdx.y;
  const int k_start = blockIdx.x * kBK;        // the first tiles see the most rows
  const int off = seq_k - seq_q;
  const bf16* qb = q + (size_t)bh * seq_q * D;
  const bf16* dob = dout + (size_t)bh * seq_q * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;

  // q tile qt into stage st: Q, dO, and the rows' lse and delta
  auto load_q_tile = [&](int qt, int st) {
    const int q_start = qt * kBQ;
    const uint32_t qd = st0 + st * 2 * kT;
    sm90::load_tile<D>(qd, qb, q_start, kBQ, seq_q, tid, kCta);
    sm90::load_tile<D>(qd + kT, dob, q_start, kBQ, seq_q, tid, kCta);
    if (tid < 2 * kBQ) {
      const int r = q_start + (tid & (kBQ - 1));
      const bool valid = r < seq_q;
      sm90::cp_async4(sm90::smem_u32(stats + st * 2 * kBQ + tid),
                      (tid < kBQ ? lb : db) + (valid ? r : 0), valid);
    }
  };

  // the first q tile holding a row that sees key k_start
  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n_q = (seq_q + kBQ - 1) / kBQ;
  if (qt0 < n_q) {
    sm90::load_tile<D>(ks, k + (size_t)bh * seq_k * D, k_start, kBK, seq_k,
                       tid, kCta);
    sm90::load_tile<D>(vs, v + (size_t)bh * seq_k * D, k_start, kBK, seq_k,
                       tid, kCta);
    load_q_tile(qt0, 0);
  }
  sm90::cp_async_commit();

  float adk[kWS][kAcc], adv[kWS][kAcc];
#pragma unroll
  for (int sb = 0; sb < kWS; ++sb)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) adk[sb][i] = adv[sb][i] = 0.f;

  // dV += P^T.dO and dK += dS^T.Q over the warpgroup's sub-tiles, the A
  // operands from registers
  auto issue_dv = [&](uint32_t (&pa)[4][4], uint32_t dosm) {
#pragma unroll
    for (int sb = 0; sb < kWS; ++sb) sm90::fence_regs(adv[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < kWS; ++sb)
        sm90::wgmma_rs(adv[sb], pa[kk],
                       sm90::desc_mn<D>(dosm, kBQ, wg * kWS + sb, kk));
  };
  auto issue_dk = [&](uint32_t (&da)[4][4], uint32_t qsm) {
#pragma unroll
    for (int sb = 0; sb < kWS; ++sb) sm90::fence_regs(adk[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(da[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < kWS; ++sb)
        sm90::wgmma_rs(adk[sb], da[kk],
                       sm90::desc_mn<D>(qsm, kBQ, wg * kWS + sb, kk));
  };

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q_start = qt * kBQ;
    const int st = (qt - qt0) & 1;
    __syncthreads();  // every warpgroup is done with the stage qt+1 refills
    if (qt + 1 < n_q) load_q_tile(qt + 1, st ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile qt (and K, V) landed
    const uint32_t qsm = st0 + st * 2 * kT;
    const uint32_t dosm = qsm + kT;
    // do * do_scale, rounded to bf16, over the chunks this thread copied
    sm90::for_own_chunks<D>(base + (dosm - ks), kBQ, tid, kCta,
                            [&](uint4* c) { scale_chunk(c, do_scale); });
    sm90::fence_view_async_shared();
    __syncthreads();
    const float* lses = stats + st * 2 * kBQ;
    const float* dels = lses + kBQ;

    // S^T and dP^T as two groups: p is taken while dP^T computes, and
    // dV accumulates while ds is taken
    float sT[32], dpT[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(sT, sm90::desc_k<D>(ks, kBK, 0, kk),
                         sm90::desc_k<D>(qsm, kBQ, 0, kk), kk);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(dpT, sm90::desc_k<D>(vs, kBK, 0, kk),
                         sm90::desc_k<D>(dosm, kBQ, 0, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S^T
    sm90::fence_regs(sT);

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (full)
      transposed_probs<false>(sT, lses, k_start, q_start, seq_q, seq_k, off,
                              causal, sm_scale * kLog2e);
    else
      transposed_probs<true>(sT, lses, k_start, q_start, seq_q, seq_k, off,
                             causal, sm_scale * kLog2e);
    uint32_t pa[4][4];
    if (!kLate) {
      to_a_operand(sT, pa);
      issue_dv(pa, dosm);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<kLate ? 0 : 1>();  // dP^T
    sm90::fence_regs(dpT);

    transposed_ds(sT, dpT, dels, ds_zero);
    if (kLate) {
      to_a_operand(sT, pa);
      issue_dv(pa, dosm);
    }
    uint32_t da[4][4];
    to_a_operand(dpT, da);
    issue_dk(da, qsm);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < kWS; ++sb) {
      sm90::fence_regs(adk[sb]);
      sm90::fence_regs(adv[sb]);
    }
  }

  const float one[2] = {1.f, 1.f}, dvs[2] = {dv_scale, dv_scale};
  const size_t o = (size_t)bh * seq_k * D;
  const int col0 = wg * kWS * L::kSubCols;
  store_rows<D, false>(dk + o, adk, one, k_start, col0, seq_k);
  store_rows<D, false>(dv + o, adv, dvs, k_start, col0, seq_k);
}

// dq of 64 query rows, sweeping the kv tiles they can see: S = Q.K^T and
// dP = dO.V^T, ds in registers, dQ += dS.K; with dq_wgs warpgroups each
// computes S and dP in full and accumulates its share of dQ's columns.
// Shared memory: Q, dO, then 2 stages of [K, V].
template <int D>
__global__ void __launch_bounds__(kWGThreads * dq_wgs<D>())
fa_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int seq_q, int seq_k, float sm_scale, float do_scale,
                  int ds_zero, int causal) {
  using L = sm90::Tile<D>;
  constexpr int kCta = kWGThreads * dq_wgs<D>();
  constexpr int kWS = L::kSubs / dq_wgs<D>();  // sub-tiles a warpgroup
  constexpr int kAcc = L::kSwB / 4;
  constexpr uint32_t kT = L::bytes(64);
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t qs = sm90::smem_u32(base);
  const uint32_t dos = qs + kT;
  const uint32_t kv0 = dos + kT;               // stage s: K, then V

  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int bh = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int off = seq_k - seq_q;
  const bf16* kb = k + (size_t)bh * seq_k * D;
  const bf16* vb = v + (size_t)bh * seq_k * D;

  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_start + 16 * warp + g + 8 * h;
    lr[h] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    dl[h] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
  }

  const int n_kv = kv_tiles(q_start, kBQ, seq_q, seq_k, causal);
  if (n_kv > 0) {
    sm90::load_tile<D>(qs, q + (size_t)bh * seq_q * D, q_start, kBQ, seq_q,
                       tid, kCta);
    sm90::load_tile<D>(dos, dout + (size_t)bh * seq_q * D, q_start, kBQ,
                       seq_q, tid, kCta);
    sm90::load_tile<D>(kv0, kb, 0, kBK, seq_k, tid, kCta);
    sm90::load_tile<D>(kv0 + kT, vb, 0, kBK, seq_k, tid, kCta);
  }
  sm90::cp_async_commit();

  float adq[kWS][kAcc];
#pragma unroll
  for (int s = 0; s < kWS; ++s)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) adq[s][i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the stage t+1 refills is no longer read
    if (t + 1 < n_kv) {
      const uint32_t nxt = kv0 + ((t + 1) & 1) * 2 * kT;
      sm90::load_tile<D>(nxt, kb, k_start + kBK, kBK, seq_k, tid, kCta);
      sm90::load_tile<D>(nxt + kT, vb, k_start + kBK, kBK, seq_k, tid,
                         kCta);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and Q, dO) landed
    if (t == 0)  // do * do_scale, rounded to bf16, over this thread's chunks
      sm90::for_own_chunks<D>(base + kT, kBQ, tid, kCta,
                              [&](uint4* c) { scale_chunk(c, do_scale); });
    sm90::fence_view_async_shared();
    __syncthreads();

    const uint32_t ks = kv0 + (t & 1) * 2 * kT;
    const uint32_t vs = ks + kT;
    // S and dP as two groups: p is taken while dP computes
    float s[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(s, sm90::desc_k<D>(qs, kBQ, 0, kk),
                         sm90::desc_k<D>(ks, kBK, 0, kk), kk);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(dp, sm90::desc_k<D>(dos, kBQ, 0, kk),
                         sm90::desc_k<D>(vs, kBK, 0, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S
    sm90::fence_regs(s);

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (full)
      row_probs<false>(s, lr, q_start, k_start, seq_q, seq_k, off, causal,
                       sm_scale * kLog2e);
    else
      row_probs<true>(s, lr, q_start, k_start, seq_q, seq_k, off, causal,
                      sm_scale * kLog2e);
    sm90::wgmma_wait<0>();  // dP
    sm90::fence_regs(dp);
    row_ds(s, dp, dl, ds_zero);
    uint32_t da[4][4];
    to_a_operand(dp, da);
#pragma unroll
    for (int sb = 0; sb < kWS; ++sb) sm90::fence_regs(adq[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(da[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < kWS; ++sb)
        sm90::wgmma_rs(adq[sb], da[kk],
                       sm90::desc_mn<D>(ks, kBK, wg * kWS + sb, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < kWS; ++sb) sm90::fence_regs(adq[sb]);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D, false>(dq + (size_t)bh * seq_q * D, adq, one, q_start,
                       wg * kWS * L::kSubCols, seq_q);
}

// ------------------------------------------------------ D > 256 (bf16)
// The column split of the fp32 wide kernels on the tensor cores. One
// warpgroup a CTA, 64 rows, one kWC-column slice of the output (64
// accumulator registers a thread for O or dQ, 128 for dK and dV: the
// D = 256 dk/dv layout's). A chunk step streams 64-row Tile<kWC> tiles
// of the chunk's columns through a 2-stage cp.async ring and adds their
// product to S (and dP) in registers; after the tile's last chunk the
// softmax (or p and ds) runs as in the D <= 256 kernels, and the slice's
// product reads the slice's V (forward, its own 2-tile ring loaded with
// the tile's first chunk), or chunk `slice`'s Q and dO (dk/dv) or K
// (dq), which the backward takes last. Every wgmma group is waited for
// before the barrier that lets its stage be refilled.
__global__ void __launch_bounds__(kWGThreads)
fa_fwd_bf16_wide_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int seq_q, int seq_k, int D,
                        float sm_scale, int causal) {
  using L = sm90::Tile<kWC>;
  constexpr uint32_t kT = L::bytes(64);        // a 64-row chunk tile
  extern __shared__ uint8_t smem_bytes[];
  const uint32_t st0 = sm90::smem_u32(align_1k(smem_bytes));  // [Q, K] x 2
  const uint32_t v0 = st0 + 4 * kT;                           // [V] x 2

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tq = tid & 3;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int off = seq_k - seq_q;
  const bf16* qb = q + (size_t)bh * seq_q * D;
  const bf16* kb = k + (size_t)bh * seq_k * D;
  const bf16* vb = v + (size_t)bh * seq_k * D + slice * kWC;
  const int n = kv_tiles(q_start, kBQ, seq_q, seq_k, causal) * nch;

  // chunk step u: chunk u % nch of kv tile u / nch, and the tile's V
  // slice with its first chunk
  auto issue = [&](int u) {
    if (u < n) {
      const int t = u / nch;
      const int c = u - t * nch;
      const uint32_t st = st0 + (u & 1) * 2 * kT;
      sm90::load_tile_ld<kWC>(st, qb + c * kWC, D, q_start, kBQ, seq_q, tid,
                              kWGThreads);
      sm90::load_tile_ld<kWC>(st + kT, kb + c * kWC, D, t * kBK, kBK, seq_k,
                              tid, kWGThreads);
      if (c == 0)
        sm90::load_tile_ld<kWC>(v0 + (t & 1) * kT, vb, D, t * kBK, kBK,
                                seq_k, tid, kWGThreads);
    }
    sm90::cp_async_commit();
  };
  issue(0);

  float o[L::kSubs][32];
#pragma unroll
  for (int sb = 0; sb < L::kSubs; ++sb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[sb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32] = {};

  for (int u = 0; u < n; ++u) {
    const int t = u / nch;
    const int c = u - t * nch;
    __syncthreads();  // stage u+1 and tile t+1's V slot are free
    issue(u + 1);
    sm90::cp_async_wait<1>();  // step u landed
    sm90::fence_view_async_shared();
    __syncthreads();
    const uint32_t st = st0 + (u & 1) * 2 * kT;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWC / 16; ++kk)
      sm90::wgmma_ss_n64(s, sm90::desc_k<kWC>(st, kBQ, 0, kk),
                         sm90::desc_k<kWC>(st + kT, kBK, 0, kk),
                         c > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    if (c < nch - 1) continue;

    const int k_start = t * kBK;
    const bool full = k_start + kBK <= seq_k &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (full)
      online_softmax<false>(s, m, l, o, q_start, k_start, seq_k, off, causal,
                            sm_scale * kLog2e);
    else
      online_softmax<true>(s, m, l, o, q_start, k_start, seq_k, off, causal,
                           sm_scale * kLog2e);
    uint32_t pa[4][4];
    to_a_operand(s, pa);
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(o[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
    const uint32_t vs = v0 + (t & 1) * kT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < L::kSubs; ++sb)
        sm90::wgmma_rs(o[sb], pa[kk], sm90::desc_mn<kWC>(vs, kBK, sb, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(o[sb]);
  }

  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    safe[h] = l[h] == 0.f ? 1.f : l[h];
    const int row = q_start + 16 * warp + g + 8 * h;
    if (tq == 0 && row < seq_q)
      lse[((size_t)slice * gridDim.y + bh) * seq_q + row] =
          l[h] == 0.f ? kNegInf : m[h] * kLn2 + logf(safe[h]);
  }
  store_rows_ld<L::kSubCols, true>(out + (size_t)bh * seq_q * D, o, safe,
                                   q_start, slice * kWC, seq_q, D);
}

// dk/dv of 64 keys, slice `slice` of their columns. A chunk step holds
// the chunk's K, V, Q and dO tiles (dO scaled by do_scale in place as it
// lands); S^T and dP^T accumulate over the chunks, p and ds are taken
// after the last (chunk `slice`), then dV and dK issue together, as the
// D = 256 kernel's late schedule does. Shared memory: 2 stages of [K, V,
// Q, dO], then 2 of [lse, delta] (64 floats each).
__global__ void __launch_bounds__(kWGThreads)
fa_dkdv_bf16_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int seq_q, int seq_k, int D, float sm_scale,
                         float do_scale, float dv_scale, int ds_zero,
                         int causal) {
  using L = sm90::Tile<kWC>;
  constexpr uint32_t kT = L::bytes(64);
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t st0 = sm90::smem_u32(base);
  float* stats = reinterpret_cast<float*>(base + 8 * kT);  // [2][lse, delta][64]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int k_start = blockIdx.x * kBK;
  const int off = seq_k - seq_q;
  const bf16* qb = q + (size_t)bh * seq_q * D;
  const bf16* dob = dout + (size_t)bh * seq_q * D;
  const bf16* kb = k + (size_t)bh * seq_k * D;
  const bf16* vb = v + (size_t)bh * seq_k * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;

  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n_q = (seq_q + kBQ - 1) / kBQ;
  const int n = max(n_q - qt0, 0) * nch;

  // chunk step u: chunk wide_chunk(slice, u % nch) of q tile qt0 + u /
  // nch, and the tile's lse and delta with its first chunk
  auto issue = [&](int u) {
    if (u < n) {
      const int qi = u / nch;
      const int ci = u - qi * nch;
      const int c = wide_chunk(slice, ci, nch) * kWC;
      const int q_start = (qt0 + qi) * kBQ;
      const uint32_t st = st0 + (u & 1) * 4 * kT;
      sm90::load_tile_ld<kWC>(st, kb + c, D, k_start, kBK, seq_k, tid,
                              kWGThreads);
      sm90::load_tile_ld<kWC>(st + kT, vb + c, D, k_start, kBK, seq_k, tid,
                              kWGThreads);
      sm90::load_tile_ld<kWC>(st + 2 * kT, qb + c, D, q_start, kBQ, seq_q,
                              tid, kWGThreads);
      sm90::load_tile_ld<kWC>(st + 3 * kT, dob + c, D, q_start, kBQ, seq_q,
                              tid, kWGThreads);
      if (ci == 0) {
        const int r = q_start + (tid & (kBQ - 1));
        const bool valid = r < seq_q;
        sm90::cp_async4(sm90::smem_u32(stats + (qi & 1) * 2 * kBQ + tid),
                        (tid < kBQ ? lb : db) + (valid ? r : 0), valid);
      }
    }
    sm90::cp_async_commit();
  };
  issue(0);

  float adk[L::kSubs][32], adv[L::kSubs][32];
#pragma unroll
  for (int sb = 0; sb < L::kSubs; ++sb)
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[sb][i] = adv[sb][i] = 0.f;
  float sT[32] = {}, dpT[32] = {};

  for (int u = 0; u < n; ++u) {
    const int qi = u / nch;
    const int ci = u - qi * nch;
    __syncthreads();  // stage u+1 is free
    issue(u + 1);
    sm90::cp_async_wait<1>();  // step u landed
    const uint32_t st = st0 + (u & 1) * 4 * kT;
    const uint32_t qsm = st + 2 * kT;
    const uint32_t dosm = st + 3 * kT;
    // do * do_scale, rounded to bf16, over the chunks this thread copied
    sm90::for_own_chunks<kWC>(base + (dosm - st0), kBQ, tid, kWGThreads,
                              [&](uint4* c) { scale_chunk(c, do_scale); });
    sm90::fence_view_async_shared();
    __syncthreads();
    sm90::fence_regs(sT);
    sm90::fence_regs(dpT);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWC / 16; ++kk)
      sm90::wgmma_ss_n64(sT, sm90::desc_k<kWC>(st, kBK, 0, kk),
                         sm90::desc_k<kWC>(qsm, kBQ, 0, kk), ci > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < kWC / 16; ++kk)
      sm90::wgmma_ss_n64(dpT, sm90::desc_k<kWC>(st + kT, kBK, 0, kk),
                         sm90::desc_k<kWC>(dosm, kBQ, 0, kk),
                         ci > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sT);
    sm90::fence_regs(dpT);
    if (ci < nch - 1) continue;

    const int q_start = (qt0 + qi) * kBQ;
    const float* lses = stats + (qi & 1) * 2 * kBQ;
    const float* dels = lses + kBQ;
    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (full)
      transposed_probs<false>(sT, lses, k_start, q_start, seq_q, seq_k, off,
                              causal, sm_scale * kLog2e);
    else
      transposed_probs<true>(sT, lses, k_start, q_start, seq_q, seq_k, off,
                             causal, sm_scale * kLog2e);
    transposed_ds(sT, dpT, dels, ds_zero);
    uint32_t pa[4][4], da[4][4];
    to_a_operand(sT, pa);
    to_a_operand(dpT, da);
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) {
      sm90::fence_regs(adk[sb]);
      sm90::fence_regs(adv[sb]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_regs(pa[kk]);
      sm90::fence_regs(da[kk]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < L::kSubs; ++sb)
        sm90::wgmma_rs(adv[sb], pa[kk], sm90::desc_mn<kWC>(dosm, kBQ, sb, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < L::kSubs; ++sb)
        sm90::wgmma_rs(adk[sb], da[kk], sm90::desc_mn<kWC>(qsm, kBQ, sb, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) {
      sm90::fence_regs(adk[sb]);
      sm90::fence_regs(adv[sb]);
    }
  }

  const float one[2] = {1.f, 1.f}, dvs[2] = {dv_scale, dv_scale};
  const size_t o = (size_t)bh * seq_k * D;
  store_rows_ld<L::kSubCols, false>(dk + o, adk, one, k_start, slice * kWC,
                                    seq_k, D);
  store_rows_ld<L::kSubCols, false>(dv + o, adv, dvs, k_start, slice * kWC,
                                    seq_k, D);
}

// dq of 64 query rows, slice `slice` of its columns: S and dP over the
// chunks of [Q, dO, K, V] (dO scaled as it lands), ds after the last
// (chunk `slice`), then dQ += dS.K from that chunk's K.
__global__ void __launch_bounds__(kWGThreads)
fa_dq_bf16_wide_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int seq_q, int seq_k, int D,
                       float sm_scale, float do_scale, int ds_zero,
                       int causal) {
  using L = sm90::Tile<kWC>;
  constexpr uint32_t kT = L::bytes(64);
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t st0 = sm90::smem_u32(base);  // 2 stages of [Q, dO, K, V]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int bh = blockIdx.y;
  const int slice = blockIdx.z;
  const int nch = D / kWC;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int off = seq_k - seq_q;
  const bf16* qb = q + (size_t)bh * seq_q * D;
  const bf16* dob = dout + (size_t)bh * seq_q * D;
  const bf16* kb = k + (size_t)bh * seq_k * D;
  const bf16* vb = v + (size_t)bh * seq_k * D;

  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_start + 16 * warp + g + 8 * h;
    lr[h] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    dl[h] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
  }
  const int n = kv_tiles(q_start, kBQ, seq_q, seq_k, causal) * nch;

  auto issue = [&](int u) {
    if (u < n) {
      const int t = u / nch;
      const int c = wide_chunk(slice, u - t * nch, nch) * kWC;
      const uint32_t st = st0 + (u & 1) * 4 * kT;
      sm90::load_tile_ld<kWC>(st, qb + c, D, q_start, kBQ, seq_q, tid,
                              kWGThreads);
      sm90::load_tile_ld<kWC>(st + kT, dob + c, D, q_start, kBQ, seq_q, tid,
                              kWGThreads);
      sm90::load_tile_ld<kWC>(st + 2 * kT, kb + c, D, t * kBK, kBK, seq_k,
                              tid, kWGThreads);
      sm90::load_tile_ld<kWC>(st + 3 * kT, vb + c, D, t * kBK, kBK, seq_k,
                              tid, kWGThreads);
    }
    sm90::cp_async_commit();
  };
  issue(0);

  float adq[L::kSubs][32];
#pragma unroll
  for (int sb = 0; sb < L::kSubs; ++sb)
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[sb][i] = 0.f;
  float s[32] = {}, dp[32] = {};

  for (int u = 0; u < n; ++u) {
    const int t = u / nch;
    const int ci = u - t * nch;
    __syncthreads();  // stage u+1 is free
    issue(u + 1);
    sm90::cp_async_wait<1>();  // step u landed
    const uint32_t st = st0 + (u & 1) * 4 * kT;
    sm90::for_own_chunks<kWC>(base + (st - st0) + kT, kBQ, tid, kWGThreads,
                              [&](uint4* c) { scale_chunk(c, do_scale); });
    sm90::fence_view_async_shared();
    __syncthreads();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWC / 16; ++kk)
      sm90::wgmma_ss_n64(s, sm90::desc_k<kWC>(st, kBQ, 0, kk),
                         sm90::desc_k<kWC>(st + 2 * kT, kBK, 0, kk),
                         ci > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < kWC / 16; ++kk)
      sm90::wgmma_ss_n64(dp, sm90::desc_k<kWC>(st + kT, kBQ, 0, kk),
                         sm90::desc_k<kWC>(st + 3 * kT, kBK, 0, kk),
                         ci > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if (ci < nch - 1) continue;

    const int k_start = t * kBK;
    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (full)
      row_probs<false>(s, lr, q_start, k_start, seq_q, seq_k, off, causal,
                       sm_scale * kLog2e);
    else
      row_probs<true>(s, lr, q_start, k_start, seq_q, seq_k, off, causal,
                      sm_scale * kLog2e);
    row_ds(s, dp, dl, ds_zero);
    uint32_t da[4][4];
    to_a_operand(dp, da);
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(adq[sb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(da[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sb = 0; sb < L::kSubs; ++sb)
        sm90::wgmma_rs(adq[sb], da[kk],
                       sm90::desc_mn<kWC>(st + 2 * kT, kBK, sb, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < L::kSubs; ++sb) sm90::fence_regs(adq[sb]);
  }

  const float one[2] = {1.f, 1.f};
  store_rows_ld<L::kSubCols, false>(dq + (size_t)bh * seq_q * D, adq, one,
                                    q_start, slice * kWC, seq_q, D);
}

// ------------------------------------------------------------- launches
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + kBQ * kLP);
}
template <int D>
constexpr size_t dkdv_smem() {
  constexpr int BK = 16 * simt_rows<D>();
  return sizeof(float) * ((size_t)(2 * BK + 2 * kBQ) * (D + 1) +
                          2 * BK * kLP + 2 * kBQ);
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int BQ = 16 * simt_rows<D>();
  return sizeof(float) * ((size_t)(2 * BQ + 2 * kBK) * (D + 1) + BQ * kLP);
}
// bf16: 1 KB of alignment slack, then the tiles (and dk/dv's lse/delta)
template <int D>
constexpr size_t fwd_bf16_smem() {
  return 1024 + (size_t)(kFwdRows + 4 * kBK) * D * 2;
}
template <int D>
constexpr size_t dkdv_bf16_smem() {
  return 1024 + (size_t)6 * 64 * D * 2 + 2 * 2 * kBQ * sizeof(float);
}
template <int D>
constexpr size_t dq_bf16_smem() {
  return 1024 + (size_t)6 * 64 * D * 2;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int BH, int seq_q, int seq_k,
                       float sm_scale, int causal, cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<D>;
  const size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq_q + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), seq_q, seq_k, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int seq_q,
                            int seq_k, float sm_scale, int causal,
                            cudaStream_t stream) {
  auto kernel = fa_fwd_bf16_kernel<D>;
  const size_t smem = fwd_bf16_smem<D>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq_q + kFwdRows - 1) / kFwdRows, BH);
  kernel<<<grid, kWGThreads * kFwdWarpgroups, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), seq_q, seq_k, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int BH, int seq_q,
                       int seq_k, float sm_scale, float do_scale,
                       float dv_scale, int ds_zero, int causal,
                       cudaStream_t stream) {
  auto dkdv = fa_dkdv_kernel<D>;
  size_t smem = dkdv_smem<D>();
  cudaError_t e = allow_smem(dkdv, smem);
  if (e != cudaSuccess) return e;
  constexpr int rows = 16 * simt_rows<D>();  // the kernels' own tiles
  dkdv<<<dim3((seq_k + rows - 1) / rows, BH), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), seq_q, seq_k,
      sm_scale, do_scale, dv_scale, ds_zero, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dqk = fa_dq_kernel<D>;
  smem = dq_smem<D>();
  e = allow_smem(dqk, smem);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((seq_q + rows - 1) / rows, BH), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), seq_q, seq_k, sm_scale, do_scale, ds_zero,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int BH, int seq_q, int seq_k, float sm_scale,
                            float do_scale, float dv_scale, int ds_zero,
                            int causal, cudaStream_t stream) {
  auto dkdv = fa_dkdv_bf16_kernel<D>;
  size_t smem = dkdv_bf16_smem<D>();
  cudaError_t e = allow_smem(dkdv, smem);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3((seq_k + kBK - 1) / kBK, BH), dkdv_threads<D>(), smem,
         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_q, seq_k,
      sm_scale, do_scale, dv_scale, ds_zero, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto dqk = fa_dq_bf16_kernel<D>;
  smem = dq_bf16_smem<D>();
  e = allow_smem(dqk, smem);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((seq_q + kBQ - 1) / kBQ, BH), kWGThreads * dq_wgs<D>(), smem,
        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), seq_q, seq_k, sm_scale, do_scale, ds_zero,
      causal);
  return cudaGetLastError();
}

// D > 256: the column-split kernels, grid.z the D / kWC slices
constexpr size_t fwd_wide_smem() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (kWC + 1) + kBQ * kLP);
}
constexpr size_t dkdv_wide_smem() {
  return sizeof(float) * ((size_t)(2 * 64 + 2 * kBQ) * (kWC + 1) +
                          2 * 64 * kLP + 2 * kBQ);
}
constexpr size_t dq_wide_smem() {
  return sizeof(float) * ((size_t)(2 * kWideDqRows + 2 * kBK) * (kWC + 1) +
                          kWideDqRows * kLP);
}
// bf16: 1 KB of slack, then 64-row Tile<kWC> tiles: 2 stages of [Q, K]
// and 2 V tiles (forward); 2 stages of 4 tiles (backward; dk/dv's lse and
// delta after them)
constexpr size_t fwd_bf16_wide_smem() {
  return 1024 + (size_t)6 * 64 * kWC * 2;
}
constexpr size_t dkdv_bf16_wide_smem() {
  return 1024 + (size_t)8 * 64 * kWC * 2 + 2 * 2 * kBQ * sizeof(float);
}
constexpr size_t dq_bf16_wide_smem() {
  return 1024 + (size_t)8 * 64 * kWC * 2;
}

cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int seq_q,
                            int seq_k, int D, float sm_scale, int causal,
                            int is_bf16, cudaStream_t stream) {
  const dim3 grid((seq_q + kBQ - 1) / kBQ, BH, D / kWC);
  cudaError_t e;
  if (is_bf16) {
    e = allow_smem(fa_fwd_bf16_wide_kernel, fwd_bf16_wide_smem());
    if (e != cudaSuccess) return e;
    fa_fwd_bf16_wide_kernel<<<grid, kWGThreads, fwd_bf16_wide_smem(),
                              stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), seq_q, seq_k, D, sm_scale, causal);
  } else {
    e = allow_smem(fa_fwd_wide_kernel, fwd_wide_smem());
    if (e != cudaSuccess) return e;
    fa_fwd_wide_kernel<<<grid, kThreads, fwd_wide_smem(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), seq_q, seq_k, D, sm_scale, causal);
  }
  return cudaGetLastError();
}

cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int BH, int seq_q, int seq_k, int D,
                            float sm_scale, float do_scale, float dv_scale,
                            int ds_zero, int causal, int is_bf16,
                            cudaStream_t stream) {
  const dim3 gk((seq_k + 63) / 64, BH, D / kWC);
  const dim3 gq((seq_q + 63) / 64, BH, D / kWC);
  cudaError_t e;
  if (is_bf16) {
    e = allow_smem(fa_dkdv_bf16_wide_kernel, dkdv_bf16_wide_smem());
    if (e != cudaSuccess) return e;
    fa_dkdv_bf16_wide_kernel<<<gk, kWGThreads, dkdv_bf16_wide_smem(),
                               stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_q, seq_k, D,
        sm_scale, do_scale, dv_scale, ds_zero, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = allow_smem(fa_dq_bf16_wide_kernel, dq_bf16_wide_smem());
    if (e != cudaSuccess) return e;
    fa_dq_bf16_wide_kernel<<<gq, kWGThreads, dq_bf16_wide_smem(),
                             stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), seq_q, seq_k, D, sm_scale, do_scale,
        ds_zero, causal);
    return cudaGetLastError();
  }
  e = allow_smem(fa_dkdv_wide_kernel, dkdv_wide_smem());
  if (e != cudaSuccess) return e;
  fa_dkdv_wide_kernel<<<gk, kThreads, dkdv_wide_smem(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), seq_q, seq_k, D,
      sm_scale, do_scale, dv_scale, ds_zero, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(fa_dq_wide_kernel, dq_wide_smem());
  if (e != cudaSuccess) return e;
  const dim3 gq32((seq_q + kWideDqRows - 1) / kWideDqRows, BH, D / kWC);
  fa_dq_wide_kernel<<<gq32, kThreads, dq_wide_smem(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), seq_q, seq_k, D, sm_scale, do_scale, ds_zero,
      causal);
  return cudaGetLastError();
}

bool wide(int D) { return D > 256 && D % kWC == 0; }

bool bad_shape(int BH, int seq_q, int seq_k, int D) {
  return BH < 1 || BH > 65535 || seq_q < 1 || seq_k < 1 ||
         (D != 32 && D != 64 && D != 128 && D != 256 && !wide(D)) ||
         D / kWC > 65535;
}

}  // namespace

// C entry points, bound with ctypes by bigdl_tpu_torch/ops/flash_attention.py,
// whose wrappers check devices, dtypes, alignment, contiguity and shapes
// first. Each returns the cudaError_t of its launches (0 on success); the
// kernels run on `stream` and nothing here synchronises. is_bf16 picks
// the tensor-core kernels, else the fp32 SIMT ones.

// (out, lse) of the forward: one launch. Above D = 256 `lse` holds
// D / 128 rows of (BH, Sq), one a column slice, each the same bits.
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int seq_q,
                               int seq_k, int D, float sm_scale, int causal,
                               int is_bf16, void* stream) {
  if (bad_shape(BH, seq_q, seq_k, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(D))
    return (int)launch_fwd_wide(q, k, v, out, lse, BH, seq_q, seq_k, D,
                                sm_scale, causal, is_bf16, s);
#define BIGDL_FA_FWD(F, DD) \
  return (int)F<DD>(q, k, v, out, lse, BH, seq_q, seq_k, sm_scale, causal, s)
  if (is_bf16) {
    if (D == 32) BIGDL_FA_FWD(launch_fwd_bf16, 32);
    if (D == 64) BIGDL_FA_FWD(launch_fwd_bf16, 64);
    if (D == 128) BIGDL_FA_FWD(launch_fwd_bf16, 128);
    BIGDL_FA_FWD(launch_fwd_bf16, 256);
  }
  if (D == 32) BIGDL_FA_FWD(launch_fwd, 32);
  if (D == 64) BIGDL_FA_FWD(launch_fwd, 64);
  if (D == 128) BIGDL_FA_FWD(launch_fwd, 128);
  BIGDL_FA_FWD(launch_fwd, 256);
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
  if (wide(D))
    return (int)launch_bwd_wide(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                seq_q, seq_k, D, sm_scale, do_scale,
                                dv_scale, ds_zero, causal, is_bf16, s);
#define BIGDL_FA_BWD(F, DD)                                               \
  return (int)F<DD>(q, k, v, dout, lse, delta, dq, dk, dv, BH, seq_q,     \
                    seq_k, sm_scale, do_scale, dv_scale, ds_zero, causal, \
                    s)
  if (is_bf16) {
    if (D == 32) BIGDL_FA_BWD(launch_bwd_bf16, 32);
    if (D == 64) BIGDL_FA_BWD(launch_bwd_bf16, 64);
    if (D == 128) BIGDL_FA_BWD(launch_bwd_bf16, 128);
    BIGDL_FA_BWD(launch_bwd_bf16, 256);
  }
  if (D == 32) BIGDL_FA_BWD(launch_bwd, 32);
  if (D == 64) BIGDL_FA_BWD(launch_bwd, 64);
  if (D == 128) BIGDL_FA_BWD(launch_bwd, 128);
  BIGDL_FA_BWD(launch_bwd, 256);
#undef BIGDL_FA_BWD
}

// Human-readable text for a cudaError_t an entry point returned.
extern "C" const char* bigdl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
