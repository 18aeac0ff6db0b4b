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
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), all contiguous and
// starting on 16-byte boundaries, fp32 or bf16 (one dtype for all); out
// and dq/dk/dv in that dtype; lse and delta (BH, Sq) fp32, one row at
// every D. D is 32, 64, 128 or 256, or a multiple of 128 above 256 (in
// bf16 "D > 256" below, up to 4096; fp32 up to kMaxF32Dim); Sq and Sk
// are any positive lengths (tiles past the end are zero-filled and
// masked).
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
//     The fp32 kernels stage do as it is (cp.async copies) and scale the
//     products instead: dp by do_scale, dv by do_scale * dv_scale, the
//     same values to fp32 rounding. sm_scale == 0 takes the Pallas
//     kernel's degenerate branch: do is not scaled and ds is exactly 0.
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
//   to TF32, about three decimal digits against the 2e-5 the fp32
//   kernels are held to): one design for every head dim, register-
//   blocked products (8 x 8 a lane at RM = 8) from row-padded shared
//   memory read as 128-bit vectors, a 2-stage cp.async ring, the CTA's
//   own rows resident, and the score products split over the warps by
//   their D reduction and summed through shared memory once a tile, so
//   no CTA recomputes S for a column slice; see "fp32" below.
// Both skip the tiles wholly above the causal diagonal, mask only the
// tiles that need it, and sum in a fixed order: bitwise reproducible.
//
// Above D = 256 (the wrapper pads D to a multiple of 128) a bf16 thread
// cannot hold a 64-row accumulator of D columns beside S. The forward
// splits O's columns over the warpgroups of a CTA (over a cluster above
// D = 512) and sums their partial S, so S is computed once a tile. The
// backward at D = 384 and 512 splits dK and dV (dQ) over a cluster of two
// CTAs of C = D / 2 columns, which exchange their partial S and dP, so
// they too are computed once a tile pair; above D = 512 a CTA owns a
// 128-column slice of dQ, or of dK and dV (grid.z), and computes S and
// dP over the full D in 128-column chunks streamed through shared
// memory, once a slice. See "D > 256" below.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWGThreads = 128;   // a warpgroup
constexpr int kFwdWarpgroups = 2;  // the bf16 forward's CTA
constexpr int kFwdRows = 64 * kFwdWarpgroups;

// ================================================================ fp32
// One design for every head dim: 256 threads (8 warps) a CTA, one CTA a
// tile of the kernel's own rows (query rows: forward and dq; keys: dk/dv),
// sweeping 64-row tiles of the other operand. Products run on the SIMT
// cores in full fp32 FMAs.
//
// * Register-blocked products. A warp computes a (4 RM) x 64 score tile
//   (`nt_product`) or a (4 RM) x (8 CN) accumulator tile (`nn_product`),
//   its lanes a 4 x 8 grid: a lane owns rows ty + 4 i and columns tx +
//   8 j, or 2 tx + 16 h + {0, 1}. Operands are read as 64-bit pairs along
//   the reduction (and the right operand of nn_product as pairs of
//   columns), a few registers a step, so the compiler keeps the next
//   steps' loads in flight under the current step's FMAs; at RM = 8 a
//   lane does 8 x 8 FMAs for every 16 words it reads. Row strides are
//   4 (mod 32) words past a multiple of 32 (8 for the score tiles), so
//   the lanes of a half-warp read distinct banks, and the rows they share
//   are broadcast.
// * Asynchronous staging. The swept operand streams through a ring of 2
//   or 3 stages of cp.async copies, started NST - 1 steps ahead. The CTA's
//   own rows (Q forward; Q and dO dq; K and V dk/dv) are staged once and
//   stay resident. One barrier a step, plus two where the score tile is
//   summed and the softmax (or p and ds) taken.
// * Scores once a tile at every D. A tile's score products (S, and dP in
//   the backward) reduce over D in chunks of DC columns (the whole row up
//   to D = 64: one chunk holds both operands' tiles); the warps that
//   compute them split each chunk's columns GS ways, and their partial
//   tiles are summed through shared memory in a fixed order (split 0
//   first). The mask and the softmax (or p and ds) run there, and p or ds
//   is written back in place for the second product. That product's
//   accumulator is split over the warps by rows, columns and, where the
//   tile has more warps than accumulator tiles, by its reduction (keys or
//   queries) GK ways, the partial accumulators summed at the end in a
//   fixed order. Nothing is recomputed for a column slice: one CTA a
//   tile, one lse row.
// * The backward kernels give each half of the CTA (4 warps) one of the
//   two score products (S and dP, or their transposes) and, in dk/dv,
//   one of the two accumulators (dV and dK).
// * The forward up to D = 64, where a grid of 128-row tiles fills the
//   card, runs the same products on two sides of the CTA instead, S and
//   P.V of successive tiles at once (fa_fwd_f32_pp_kernel, below the
//   forward): with every warp owning whole rows, the split sums and two
//   CTA-wide barriers a tile go, and the exponentials overlap the FMAs.
// The host picks a Plan for each launch (`fwd_plan`, `dq_plan`,
// `dkdv_plan`) and an instantiation: RM and CN (exact for the head dims
// the repo's models run at and D = 384; a bound, with the columns a lane
// read at run time, for the others), the chunking and the ring's depth
// from what fits in the 227 KB of shared memory a CTA may hold, and the
// tile's rows from the grid (128, 64 or 32 query rows up to D = 256,
// the largest that still gives every SM a CTA). Under the causal mask
// the forward and dq take their heaviest query tiles first (dk/dv's
// order already is). Two runs give the same bits: every sum has one
// order.
constexpr int kThreads = 256;      // the fp32 kernels' CTA
constexpr int kKeys = 64;          // rows a tile of the swept operand
constexpr int kPS = kKeys + 8;     // row stride of score tiles
constexpr int kMaxSplits = 8;      // GS <= 8
constexpr int kMaxF32Dim = 2048;   // the largest head dim of the fp32 kernels
constexpr size_t kMaxSmem = 227 * 1024;

// A launch's layout.
struct Plan {
  int D;      // head dim, a multiple of 32
  int NS;     // row tiles of 4 RM rows in the CTA's own tile
  int GS;     // splits of each reduction chunk of the score products
  int DC;     // columns a reduction chunk
  int NKC;    // reduction chunks a tile: D / DC
  int VK;     // rows of the swept operand a chunk of the second product
  int NVC;    // those chunks a tile (0: read from the reduction chunk)
  int CN;     // accumulator columns a lane (even)
  int NOc;    // accumulator column tiles of 8 CN
  int GK;     // splits of the second product's reduction
  int NST;    // stages of the ring (2 or 3)
  int stage;  // floats a ring stage
};

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

// Rows [row0, row0 + rows), columns [col0, col0 + cols) of a row-major
// matrix of `nrows` rows and row stride `ld`, into dst with row stride
// cols + 4, as 16-byte cp.async copies; rows past nrows are zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int ld, int row0, int rows,
                                           int nrows, int col0, int cols) {
  const int c4n = cols >> 2;
  const int n = rows * c4n;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / c4n;
    const int c4 = idx - r * c4n;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    sm90::cp_async16(sm90::smem_u32(dst + r * (cols + 4) + 4 * c4),
                     src + (size_t)(ok ? gr : 0) * ld + col0 + 4 * c4, ok);
  }
}

// The ring: before step s's work, its stage has landed and every thread
// is done with step s - 1, whose stage step s + NST - 1 then refills.
// Every step commits one group (empty past the last), so waiting until
// NST - 2 groups are in flight always means step s's has landed.
__device__ __forceinline__ void ring_wait(int nst) {
  if (nst == 3)
    sm90::cp_async_wait<1>();
  else
    sm90::cp_async_wait<0>();
  __syncthreads();
}

// acc[i][j] += sum over d < len of A[(ty + 4 i) lda + d] B[(tx + 8 j) ldb
// + d]: a warp's (4 RM) x 64 score tile, operands read along their rows
// as pairs, d ascending; the loop unrolled U times (1 where registers
// are capped at 128 a thread).
template <int RM, int U = 2>
__device__ __forceinline__ void nt_product(float (&acc)[RM][8],
                                           const float* A, int lda,
                                           const float* B, int ldb,
                                           int len) {
  const int lane = threadIdx.x & 31;
  const float* a = A + (lane >> 3) * lda;
  const float* b = B + (lane & 7) * ldb;
#pragma unroll (U)
  for (int d = 0; d < len; d += 2) {
    float2 av[RM], bv[8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float2*>(a + 4 * i * lda + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float2*>(b + 8 * j * ldb + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
      }
  }
}

// acc[i][2 h + e] += sum over k < len of A[(ty + 4 i) lda + k] B[k ldb +
// 2 tx + 16 h + e], for h < CN / 2 (with RT, for 2 h < cn only): a warp's
// (4 RM) x (8 CN) accumulator tile, A read along its rows as pairs, B as
// pairs of columns, k ascending; the loop unrolled U times.
template <int RM, int CN, bool RT, int U = 2>
__device__ __forceinline__ void nn_product(float (&acc)[RM][CN],
                                           const float* A, int lda,
                                           const float* B, int ldb, int len,
                                           int cn) {
  const int lane = threadIdx.x & 31;
  const float* a = A + (lane >> 3) * lda;
  const float* b = B + 2 * (lane & 7);
#pragma unroll (U)
  for (int k = 0; k < len; k += 2) {
    float2 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float2*>(a + 4 * i * lda + k);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* brow = b + (k + e) * ldb;
#pragma unroll
      for (int h = 0; h < CN / 2; ++h) {
        if (RT && 2 * h >= cn) break;
        const float2 bv = *reinterpret_cast<const float2*>(brow + 16 * h);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float ai = e ? av[i].y : av[i].x;
          acc[i][2 * h] = fmaf(ai, bv.x, acc[i][2 * h]);
          acc[i][2 * h + 1] = fmaf(ai, bv.y, acc[i][2 * h + 1]);
        }
      }
    }
  }
}

// A warp's score tile (nt_product's layout) into a tile of row stride kPS.
template <int RM>
__device__ __forceinline__ void store_scores(float* dst,
                                             const float (&acc)[RM][8]) {
  const int lane = threadIdx.x & 31;
  float* d = dst + (lane >> 3) * kPS + (lane & 7);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) d[4 * i * kPS + 8 * j] = acc[i][j];
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The sum of `splits` partial score tiles (`stride` floats apart) at a
// float4 of one row, split 0 first.
__device__ __forceinline__ float4 sum_splits(const float* p, int splits,
                                             int stride) {
  float4 a = *reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int g = 1; g < kMaxSplits; ++g) {
    if (g >= splits) break;
    const float4 b = *reinterpret_cast<const float4*>(p + g * stride);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  return a;
}

template <int RM, int CN>
__device__ __forceinline__ void zero_acc(float (&acc)[RM][CN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
}

// A lane's accumulator rows (nn_product's layout, tile origin `row0`,
// column offset `col0`) into the rows of `dst` (row stride `ld`) below
// `nrows`, each value times `scale`.
template <int RM, int CN, bool RT>
__device__ __forceinline__ void store_acc(float* dst, int ld, int row0,
                                          int col0, int nrows, int cn,
                                          const float (&acc)[RM][CN],
                                          float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + (lane >> 3) + 4 * i;
    if (row >= nrows) continue;
    float* r = dst + (size_t)row * ld + col0 + 2 * (lane & 7);
#pragma unroll
    for (int h = 0; h < CN / 2; ++h) {
      if (RT && 2 * h >= cn) break;
      *reinterpret_cast<float2*>(r + 16 * h) =
          make_float2(acc[i][2 * h] * scale, acc[i][2 * h + 1] * scale);
    }
  }
}

// dst[r][c] = sum over g < splits of red[g][r][c] (row stride ld, `rows`
// rows a split), divided by div[r] when div is given, for the rows below
// nrows - row0; D / 4 float4 a row.
__device__ __forceinline__ void sum_accs(float* dst, const float* red,
                                         const float* div, int splits,
                                         int rows, int ld, int D, int row0,
                                         int nrows) {
  const int d4 = D >> 2;
  for (int idx = threadIdx.x; idx < rows * d4; idx += kThreads) {
    const int r = idx / d4, c4 = idx - r * d4;
    if (row0 + r >= nrows) continue;
    float4 a = *reinterpret_cast<const float4*>(red + r * ld + 4 * c4);
    for (int g = 1; g < splits; ++g) {
      const float4 b = *reinterpret_cast<const float4*>(
          red + ((size_t)g * rows + r) * ld + 4 * c4);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (div) {
      const float l = div[r];
      const float safe = l == 0.f ? 1.f : l;
      a.x /= safe;
      a.y /= safe;
      a.z /= safe;
      a.w /= safe;
    }
    *reinterpret_cast<float4*>(dst + (size_t)(row0 + r) * D + 4 * c4) = a;
  }
}

// ------------------------------------------------------------- forward
// The CTA's BQ = 4 RM NS query rows against 64-key tiles. A tile's steps:
// NKC chunks of K (64 keys x DC columns; the 8 warps as NS row tiles x GS
// column splits of S), then NVC chunks of V (VK keys x D; the warps as NS
// row tiles x NOc column tiles x GK key splits of O). Up to D = 128 one
// step a tile: its stage holds K and V whole. After the last K chunk the
// partial S tiles are summed and the online softmax runs on them, TPR
// threads a row (running max and sum in registers, the row's rescale
// factor through shared memory); p overwrites split 0's tile.
template <int RM, int CN, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int seq_q, int seq_k,
                  float sm_scale, int causal, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, LD = D + 4, NS = p.NS;
  const int BQ = 4 * RM * NS;
  float* alpha_s = smem;              // [128] the tile's rescale, a row
  float* l_s = smem + 128;            // [128] the final row sums
  float* qs = smem + 256;             // [BQ][LD], resident
  float* ring = qs + BQ * LD;         // NST x [p.stage]
  float* part = ring + p.NST * p.stage;  // [GS][BQ][kPS]; p in split 0
  float* red = qs;                    // after the sweep: [GK][BQ][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  // under the causal mask the heaviest tiles (the last rows) go first
  const int q_start =
      (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int off = seq_k - seq_q;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;
  const int rs = warp % NS, gs = warp / NS;  // S: row tile, column split
  const int co = (warp / NS) % p.NOc;        // O: column tile, key split
  const int gk = warp / (NS * p.NOc);
  const int sw = p.DC / p.GS;
  const bool fused = p.NVC == 0;             // K and V whole in a stage
  const int tpr = min(kThreads / BQ, 16), kpt = kKeys / tpr;
  const bool sm_on = tid < BQ * tpr;         // whole warps
  const int sm_row = tid / tpr, sm_seg = tid % tpr;
  float m_run = kNegInf, l_run = 0.f;

  float sacc[RM][8], oacc[RM][CN];
  zero_acc(oacc);
  zero_acc(sacc);

  const int per = fused ? 1 : p.NKC + p.NVC;
  const int n_steps = kv_tiles(q_start, BQ, seq_q, seq_k, causal) * per;
  auto stage_step = [&](int s) {
    if (s < n_steps) {
      const int t = s / per, sub = s - t * per;
      float* dst = ring + (s % p.NST) * p.stage;
      if (fused) {
        stage_rows(dst, kb, D, t * kKeys, kKeys, seq_k, 0, D);
        stage_rows(dst + kKeys * LD, vb, D, t * kKeys, kKeys, seq_k, 0, D);
      } else if (sub < p.NKC) {
        stage_rows(dst, kb, D, t * kKeys, kKeys, seq_k, sub * p.DC, p.DC);
      } else {
        stage_rows(dst, vb, D, t * kKeys + (sub - p.NKC) * p.VK, p.VK,
                   seq_k, 0, D);
      }
    }
    sm90::cp_async_commit();
  };
  if (n_steps > 0)
    stage_rows(qs, q + (size_t)bh * seq_q * D, D, q_start, BQ, seq_q, 0, D);
  for (int s = 0; s < p.NST - 1; ++s) stage_step(s);

  for (int s = 0; s < n_steps; ++s) {
    ring_wait(p.NST);
    stage_step(s + p.NST - 1);
    const float* buf = ring + (s % p.NST) * p.stage;
    const int t = s / per, sub = s - t * per;
    if (sub < p.NKC) {
      if (sub == 0) zero_acc(sacc);
      nt_product<RM>(sacc, qs + rs * 4 * RM * LD + sub * p.DC + gs * sw, LD,
                     buf + gs * sw, p.DC + 4, sw);
      if (sub == p.NKC - 1) {
        store_scores<RM>(part + (gs * BQ + rs * 4 * RM) * kPS, sacc);
        __syncthreads();
        if (sm_on) {
          const int k_start = t * kKeys;
          const int row = q_start + sm_row;
          // a tile inside the key range and (causal) wholly below the
          // diagonal needs no mask
          const bool full = k_start + kKeys <= seq_k &&
                            (!causal || k_start + kKeys - 1 <= q_start + off);
          float* prow = part + sm_row * kPS + sm_seg * kpt;
          float sv[32];
          float mc = kNegInf;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (4 * c >= kpt) break;
            const float4 a = sum_splits(prow + 4 * c, p.GS, BQ * kPS);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k_start + sm_seg * kpt + 4 * c + e;
              const bool vis =
                  full || (col < seq_k && (!causal || col <= row + off));
              sv[4 * c + e] = vis ? comp(a, e) * sm_scale : kNegInf;
              mc = fmaxf(mc, sv[4 * c + e]);
            }
          }
          for (int o = tpr >> 1; o > 0; o >>= 1)
            mc = fmaxf(mc, __shfl_xor_sync(kFullMask, mc, o));
          const float mn = fmaxf(m_run, mc);
          const float alpha = expf(m_run - mn);
          float ls = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (4 * c >= kpt) break;
            float pe[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k_start + sm_seg * kpt + 4 * c + e;
              const bool vis =
                  full || (col < seq_k && (!causal || col <= row + off));
              pe[e] = vis ? expf(sv[4 * c + e] - mn) : 0.f;
              ls += pe[e];
            }
            *reinterpret_cast<float4*>(prow + 4 * c) =
                make_float4(pe[0], pe[1], pe[2], pe[3]);
          }
          for (int o = tpr >> 1; o > 0; o >>= 1)
            ls += __shfl_xor_sync(kFullMask, ls, o);
          l_run = alpha * l_run + ls;
          m_run = mn;
          if (sm_seg == 0) alpha_s[sm_row] = alpha;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = alpha_s[rs * 4 * RM + (lane >> 3) + 4 * i];
#pragma unroll
          for (int j = 0; j < CN; ++j) oacc[i][j] *= a;
        }
        if (fused) {
          const int kl = kKeys / p.GK;
          nn_product<RM, CN, RT>(oacc, part + rs * 4 * RM * kPS + gk * kl,
                                 kPS, buf + (kKeys + gk * kl) * LD +
                                          co * 8 * p.CN,
                                 LD, kl, p.CN);
        }
      }
    } else {
      const int kl = p.VK / p.GK;
      const int kk0 = (sub - p.NKC) * p.VK + gk * kl;
      nn_product<RM, CN, RT>(oacc, part + rs * 4 * RM * kPS + kk0, kPS,
                             buf + gk * kl * LD + co * 8 * p.CN, LD, kl,
                             p.CN);
    }
  }

  if (sm_on && sm_seg == 0) {
    l_s[sm_row] = l_run;
    const int row = q_start + sm_row;
    if (row < seq_q)
      lse[(size_t)bh * seq_q + row] =
          l_run == 0.f ? kNegInf : m_run + logf(l_run);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // l_s written; every read of the ring and tiles done
  float* ob = out + (size_t)bh * seq_q * D;
  if (p.GK == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float l = l_s[rs * 4 * RM + (lane >> 3) + 4 * i];
      const float safe = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < CN; ++j) oacc[i][j] /= safe;
    }
    store_acc<RM, CN, RT>(ob, D, q_start + rs * 4 * RM, co * 8 * p.CN, seq_q,
                          p.CN, oacc, 1.f);
    return;
  }
  // the GK key splits' accumulators, summed split 0 first
  store_acc<RM, CN, RT>(red + (size_t)gk * BQ * LD, LD, rs * 4 * RM,
                        co * 8 * p.CN, BQ, p.CN, oacc, 1.f);
  __syncthreads();
  sum_accs(ob, red, l_s, p.GK, BQ, LD, D, q_start, seq_q);
}

// -------------------------------------------- forward, up to D = 64
// The same products and online softmax, with the CTA's 128 query rows
// split between two groups of 4 warps that work on different tiles at
// once: warps 0-3 (each owning 32 rows) take S of tile t, its mask and
// its row maxima (a row in the 8 lanes of one ty: three xor shuffles),
// while warps 4-7 (the same rows) take tile t - 1: p = expf(s - m) in
// place, the row sums, and P.V. s - m (-1e30 where masked, whose expf is
// exactly 0) and the rows' rescale factors pass through a
// double-buffered tile: named barriers mark a buffer full (S side
// arrives, P.V side waits) and empty again (the reverse), so the two
// sides drift by up to a tile instead of stopping together. The
// exponentials sit on the P.V side because S's side, with them, was the
// slower of the two on the card. Each side streams its own operand (K,
// V) through a 3-stage cp.async ring of its own, two tiles ahead. 8 x 8
// register blocks on both sides; one CTA an SM (215 KB at D = 64).
constexpr int kPPRows = 128;
constexpr int kPPUnroll = 4;  // both sides' product loops (D is fixed here)

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// stage_rows for the 128 threads of one side (`t` this thread's index
// among them), rows of D = COLS columns.
template <int COLS>
__device__ __forceinline__ void stage_rows_part(float* dst, const float* src,
                                                int row0, int rows,
                                                int nrows, int t) {
  constexpr int c4n = COLS / 4;
  for (int idx = t; idx < rows * c4n; idx += 128) {
    const int r = idx / c4n;
    const int c4 = idx % c4n;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    sm90::cp_async16(sm90::smem_u32(dst + r * (COLS + 4) + 4 * c4),
                     src + (size_t)(ok ? gr : 0) * COLS + 4 * c4, ok);
  }
}

// named barriers (0 is __syncthreads'): each side's own, then p buffer b
// full (3 + b) and empty (5 + b), then the rows' final maxima written
constexpr int kBarS = 1, kBarO = 2, kBarFull = 3, kBarEmpty = 5,
              kBarMax = 7;

template <int CN>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_f32_pp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int seq_q, int seq_k,
                     float sm_scale, int causal) {
  constexpr int D = 8 * CN, LD = D + 4, RM = 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [128][LD], resident
  float* kring = qs + kPPRows * LD;          // 3 x [64][LD]
  float* vring = kring + 3 * kKeys * LD;     // 3 x [64][LD]
  float* pbuf = vring + 3 * kKeys * LD;      // 2 x [128][kPS]
  float* abuf = pbuf + 2 * kPPRows * kPS;    // 2 x [128] rescale factors
  float* lmax = abuf + 2 * kPPRows;          // [128] the rows' final max

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int side = warp >> 2, w = warp & 3;  // rows 32 w .. 32 w + 31
  const int st = tid & 127;                  // index within the side
  const int bh = blockIdx.y;
  // under the causal mask the heaviest tiles (the last rows) go first
  const int q_start =
      (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kPPRows;
  const int off = seq_k - seq_q;
  const int n_kv = kv_tiles(q_start, kPPRows, seq_q, seq_k, causal);

  if (side == 0) {  // ---------------------------------- S and the maxima
    const float* kb = k + (size_t)bh * seq_k * D;
    float acc[RM][8], m_run[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) m_run[i] = kNegInf;
    if (n_kv > 0) {
      stage_rows_part<D>(qs, q + (size_t)bh * seq_q * D, q_start, kPPRows,
                         seq_q, st);
      stage_rows_part<D>(kring, kb, 0, kKeys, seq_k, st);
      if (n_kv > 1)
        stage_rows_part<D>(kring + kKeys * LD, kb, kKeys, kKeys, seq_k, st);
    }
    sm90::cp_async_commit();
    for (int t = 0; t < n_kv; ++t) {
      // K(t) came with the first group (t < 2) or with step t - 2's
      if (t == 0)
        sm90::cp_async_wait<0>();
      else
        sm90::cp_async_wait<1>();
      named_sync(kBarS, 128);  // K(t) landed; tile t - 1's reads done
      if (t + 2 < n_kv)
        stage_rows_part<D>(kring + ((t + 2) % 3) * kKeys * LD, kb,
                           (t + 2) * kKeys, kKeys, seq_k, st);
      sm90::cp_async_commit();
      zero_acc(acc);
      nt_product<RM, kPPUnroll>(acc, qs + 32 * w * LD, LD,
                                kring + (t % 3) * kKeys * LD, LD, D);
      const int k_start = t * kKeys;
      const bool full = k_start + kKeys <= seq_k &&
                        (!causal || k_start + kKeys - 1 <= q_start + off);
      float alpha[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = q_start + 32 * w + (lane >> 3) + 4 * i;
        unsigned vis = 0xffu;
        if (!full) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = k_start + (lane & 7) + 8 * j;
            if (col >= seq_k || (causal && col > row + off))
              vis &= ~(1u << j);
          }
        }
        float mc = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = vis >> j & 1 ? acc[i][j] * sm_scale : kNegInf;
          mc = fmaxf(mc, acc[i][j]);
        }
        // a row lives in the 8 lanes of one ty: xor 1, 2, 4
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          mc = fmaxf(mc, __shfl_xor_sync(kFullMask, mc, o));
        const float mn = fmaxf(m_run[i], mc);
        alpha[i] = expf(m_run[i] - mn);
        m_run[i] = mn;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = vis >> j & 1 ? acc[i][j] - mn : kNegInf;
      }
      const int b = t & 1;
      if (t >= 2) named_sync(kBarEmpty + b, kThreads);  // P.V of t - 2 done
      store_scores<RM>(pbuf + (b * kPPRows + 32 * w) * kPS, acc);
      if ((lane & 7) == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
          abuf[b * kPPRows + 32 * w + (lane >> 3) + 4 * i] = alpha[i];
      }
      named_arrive(kBarFull + b, kThreads);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = 32 * w + (lane >> 3) + 4 * i;
      if ((lane & 7) == 0) lmax[r] = m_run[i];  // for the P.V side's lse
    }
    named_arrive(kBarMax, kThreads);
    return;
  }

  // ------------------------------------------------------------- P.V
  const float* vb = v + (size_t)bh * seq_k * D;
  float acc[RM][CN], l_run[RM];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < RM; ++i) l_run[i] = 0.f;
  if (n_kv > 0) stage_rows_part<D>(vring, vb, 0, kKeys, seq_k, st);
  if (n_kv > 1)
    stage_rows_part<D>(vring + kKeys * LD, vb, kKeys, kKeys, seq_k, st);
  sm90::cp_async_commit();
  for (int t = 0; t < n_kv; ++t) {
    if (t == 0)
      sm90::cp_async_wait<0>();
    else
      sm90::cp_async_wait<1>();
    named_sync(kBarO, 128);  // V(t) landed; tile t - 1's reads done
    if (t + 2 < n_kv)
      stage_rows_part<D>(vring + ((t + 2) % 3) * kKeys * LD, vb,
                         (t + 2) * kKeys, kKeys, seq_k, st);
    sm90::cp_async_commit();
    const int b = t & 1;
    named_sync(kBarFull + b, kThreads);  // p of tile t written
    float* pw = pbuf + (b * kPPRows + 32 * w) * kPS;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = abuf[b * kPPRows + 32 * w + (lane >> 3) + 4 * i];
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= a;
      // p = expf(s - m) of this warp's rows, in nt_product's layout
      float* pr = pw + ((lane >> 3) + 4 * i) * kPS + (lane & 7);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pe = expf(pr[8 * j]);
        pr[8 * j] = pe;
        ls += pe;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        ls += __shfl_xor_sync(kFullMask, ls, o);
      l_run[i] = a * l_run[i] + ls;
    }
    __syncwarp();  // the warp's p written before its P.V reads it
    nn_product<RM, CN, false, kPPUnroll>(
        acc, pbuf + (b * kPPRows + 32 * w) * kPS, kPS,
        vring + (t % 3) * kKeys * LD, LD, kKeys, CN);
    if (t + 2 < n_kv) named_arrive(kBarEmpty + b, kThreads);
  }
  named_sync(kBarMax, kThreads);
  const float* mr = lmax + 32 * w;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = (lane >> 3) + 4 * i;
    const float l = l_run[i];
    const float safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] /= safe;
    if ((lane & 7) == 0 && q_start + 32 * w + r < seq_q)
      lse[(size_t)bh * seq_q + q_start + 32 * w + r] =
          l == 0.f ? kNegInf : mr[r] + logf(l);
  }
  store_acc<RM, CN, false>(out + (size_t)bh * seq_q * D, D,
                           q_start + 32 * w, 0, seq_q, CN, acc, 1.f);
}

// ------------------------------------------------------------ backward
// dq: the CTA's BQ = 4 RM NS query rows (Q and dO resident) against
// 64-key tiles. A tile's steps: NKC chunks of K and V side by side (64
// keys x DC columns each; warps 0-3 take S, warps 4-7 dP, each half as NS
// row tiles x GS column splits), then NVC chunks of K (VK keys x D) for
// dQ += dS K (the 8 warps as NS row tiles x NOc column tiles x GK key
// splits). With D <= 64 the one chunk holds K and V whole (DC = D) and dQ
// reads K from it (NVC = 0). ds overwrites split 0 of the S partials.
template <int RM, int CN, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
fa_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int seq_q, int seq_k, float sm_scale, float do_scale,
                 int ds_zero, int causal, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, LD = D + 4, NS = p.NS;
  const int BQ = 4 * RM * NS;
  float* lse_s = smem;                   // [128]
  float* del_s = smem + 128;             // [128]
  float* qs = smem + 256;                // [BQ][LD], resident
  float* dos = qs + BQ * LD;             // [BQ][LD], resident
  float* ring = dos + BQ * LD;           // NST x [p.stage]
  float* part = ring + p.NST * p.stage;  // [2: S, dP][GS][BQ][kPS]
  float* red = qs;                       // after the sweep: [GK][BQ][LD]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  // under the causal mask the heaviest tiles (the last rows) go first
  const int q_start =
      (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int off = seq_k - seq_q;
  const float* kb = k + (size_t)bh * seq_k * D;
  const float* vb = v + (size_t)bh * seq_k * D;
  const int side = warp >> 2, wl = warp & 3;
  const int rs = wl % NS, gs = wl / NS;      // S / dP: row tile, split
  const int ro = warp % NS, co = (warp / NS) % p.NOc;
  const int gk = warp / (NS * p.NOc);        // dQ: row, column tile, split
  const int sw = p.DC / p.GS;
  const int ldc = p.DC + 4;
  const int part_stride = BQ * kPS;

  if (tid < BQ) {
    const int row = q_start + tid;
    lse_s[tid] = row < seq_q ? lse[(size_t)bh * seq_q + row] : 0.f;
    del_s[tid] = row < seq_q ? delta[(size_t)bh * seq_q + row] : 0.f;
  }
  float sacc[RM][8], acc[RM][CN];
  zero_acc(acc);
  zero_acc(sacc);

  const int per = p.NKC + p.NVC;
  const int n_steps = kv_tiles(q_start, BQ, seq_q, seq_k, causal) * per;
  auto stage_step = [&](int s) {
    if (s < n_steps) {
      const int t = s / per, sub = s - t * per;
      float* dst = ring + (s % p.NST) * p.stage;
      if (sub < p.NKC) {
        stage_rows(dst, kb, D, t * kKeys, kKeys, seq_k, sub * p.DC, p.DC);
        stage_rows(dst + kKeys * ldc, vb, D, t * kKeys, kKeys, seq_k,
                   sub * p.DC, p.DC);
      } else {
        stage_rows(dst, kb, D, t * kKeys + (sub - p.NKC) * p.VK, p.VK,
                   seq_k, 0, D);
      }
    }
    sm90::cp_async_commit();
  };
  if (n_steps > 0) {
    stage_rows(qs, q + (size_t)bh * seq_q * D, D, q_start, BQ, seq_q, 0, D);
    stage_rows(dos, dout + (size_t)bh * seq_q * D, D, q_start, BQ, seq_q, 0,
               D);
  }
  for (int s = 0; s < p.NST - 1; ++s) stage_step(s);

  for (int s = 0; s < n_steps; ++s) {
    ring_wait(p.NST);
    stage_step(s + p.NST - 1);
    const float* buf = ring + (s % p.NST) * p.stage;
    const int t = s / per, sub = s - t * per;
    if (sub < p.NKC) {
      if (sub == 0) zero_acc(sacc);
      nt_product<RM>(sacc,
                     (side ? dos : qs) + rs * 4 * RM * LD + sub * p.DC +
                         gs * sw,
                     LD, buf + side * kKeys * ldc + gs * sw, ldc, sw);
      if (sub == p.NKC - 1) {
        store_scores<RM>(
            part + ((side * p.GS + gs) * BQ + rs * 4 * RM) * kPS, sacc);
        __syncthreads();
        const int k_start = t * kKeys;
        const bool full = k_start + kKeys <= seq_k &&
                          q_start + BQ <= seq_q &&
                          (!causal || k_start + kKeys - 1 <= q_start + off);
        for (int idx = tid; idx < BQ * 16; idx += kThreads) {
          const int r = idx >> 4, c = 4 * (idx & 15);
          float* ps = part + r * kPS + c;
          const float4 sv = sum_splits(ps, p.GS, part_stride);
          const float4 dv = sum_splits(ps + p.GS * part_stride, p.GS,
                                       part_stride);
          const int row = q_start + r;
          float de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k_start + c + e;
            const bool vis = full || (col < seq_k && row < seq_q &&
                                      (!causal || col <= row + off));
            const float pe =
                vis ? expf(comp(sv, e) * sm_scale - lse_s[r]) : 0.f;
            de[e] = ds_zero ? 0.f
                            : pe * (comp(dv, e) * do_scale - del_s[r]);
          }
          *reinterpret_cast<float4*>(ps) =
              make_float4(de[0], de[1], de[2], de[3]);
        }
        __syncthreads();
        if (p.NVC == 0) {  // K whole in this chunk
          const int kl = kKeys / p.GK;
          nn_product<RM, CN, RT>(acc, part + ro * 4 * RM * kPS + gk * kl,
                                 kPS, buf + gk * kl * ldc + co * 8 * p.CN,
                                 ldc, kl, p.CN);
        }
      }
    } else {
      const int kl = p.VK / p.GK;
      const int kk0 = (sub - p.NKC) * p.VK + gk * kl;
      nn_product<RM, CN, RT>(acc, part + ro * 4 * RM * kPS + kk0, kPS,
                             buf + gk * kl * LD + co * 8 * p.CN, LD, kl,
                             p.CN);
    }
  }

  float* qb = dq + (size_t)bh * seq_q * D;
  if (p.GK == 1) {
    store_acc<RM, CN, RT>(qb, D, q_start + ro * 4 * RM, co * 8 * p.CN,
                          seq_q, p.CN, acc, 1.f);
    return;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every read of the ring and tiles done
  store_acc<RM, CN, RT>(red + (size_t)gk * BQ * LD, LD, ro * 4 * RM,
                        co * 8 * p.CN, BQ, p.CN, acc, 1.f);
  __syncthreads();
  sum_accs(qb, red, nullptr, p.GK, BQ, LD, D, q_start, seq_q);
}

// dk/dv: the CTA's BK = 4 RM NS keys (K and V resident) against the
// 64-query tiles that can see them. A tile's steps: NKC chunks of Q and
// dO side by side (64 queries x DC columns each; warps 0-3 take S^T = K
// Q^T, warps 4-7 dP^T = V dO^T, each half as NS row tiles x GS column
// splits), then NVC chunks of Q and dO (VK queries x D each) for dV +=
// P^T dO (warps 0-3) and dK += dS^T Q (warps 4-7), each half as NS row
// tiles x NOc column tiles x GK query splits (NS NOc GK = 4; the GK
// partial accumulators summed at the end). With D <= 64 the one chunk
// holds Q and dO whole (NVC = 0). The last chunk's stage also brings the
// q tile's lse and delta. p^T and ds^T overwrite split 0 of their
// halves' partials.
template <int RM, int CN, bool RT>
__global__ void __launch_bounds__(kThreads, 1)
fa_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int seq_q, int seq_k,
                   float sm_scale, float do_scale, float dv_scale,
                   int ds_zero, int causal, Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, LD = D + 4, NS = p.NS;
  const int BK = 4 * RM * NS;
  float* ks = smem;                      // [BK][LD], resident
  float* vs = ks + BK * LD;              // [BK][LD], resident
  float* ring = vs + BK * LD;            // NST x [p.stage]
  float* part = ring + p.NST * p.stage;  // [2: S^T, dP^T][GS][BK][kPS]
  float* red = smem;                     // after the sweep: [2][GK][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k_start = blockIdx.x * BK;
  const int off = seq_k - seq_q;
  const float* qb = q + (size_t)bh * seq_q * D;
  const float* dob = dout + (size_t)bh * seq_q * D;
  const float* lb = lse + (size_t)bh * seq_q;
  const float* db = delta + (size_t)bh * seq_q;
  const int side = warp >> 2, wl = warp & 3;
  const int rs = wl % NS, gs = wl / NS;      // S^T / dP^T: row tile, split
  const int co = (wl / NS) % p.NOc;          // dV / dK: column tile, split
  const int gq = wl / (NS * p.NOc);
  const int sw = p.DC / p.GS;
  const int ldc = p.DC + 4;
  const int part_stride = BK * kPS;
  const int vq = p.NVC ? p.VK : kKeys;       // queries a second-product chunk

  float sacc[RM][8], acc[RM][CN];
  zero_acc(acc);
  zero_acc(sacc);

  // the first q tile holding a row that sees key k_start
  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kKeys;
  const int n_q = (seq_q + kKeys - 1) / kKeys;
  const int per = p.NKC + p.NVC;
  const int n_steps = max(n_q - qt0, 0) * per;
  auto stage_step = [&](int s) {
    if (s < n_steps) {
      const int t = qt0 + s / per, sub = s % per;
      float* dst = ring + (s % p.NST) * p.stage;
      if (sub < p.NKC) {
        stage_rows(dst, qb, D, t * kKeys, kKeys, seq_q, sub * p.DC, p.DC);
        stage_rows(dst + kKeys * ldc, dob, D, t * kKeys, kKeys, seq_q,
                   sub * p.DC, p.DC);
        if (sub == p.NKC - 1 && tid < 2 * kKeys) {
          // the q tile's lse and delta, beside its last chunk
          const int row = t * kKeys + (tid & (kKeys - 1));
          const bool ok = row < seq_q;
          sm90::cp_async4(sm90::smem_u32(dst + 2 * kKeys * ldc + tid),
                          (tid < kKeys ? lb : db) + (ok ? row : 0), ok);
        }
      } else {
        const int row0 = t * kKeys + (sub - p.NKC) * p.VK;
        stage_rows(dst, qb, D, row0, p.VK, seq_q, 0, D);
        stage_rows(dst + p.VK * LD, dob, D, row0, p.VK, seq_q, 0, D);
      }
    }
    sm90::cp_async_commit();
  };
  if (n_steps > 0) {
    stage_rows(ks, k + (size_t)bh * seq_k * D, D, k_start, BK, seq_k, 0, D);
    stage_rows(vs, v + (size_t)bh * seq_k * D, D, k_start, BK, seq_k, 0, D);
  }
  for (int s = 0; s < p.NST - 1; ++s) stage_step(s);

  for (int s = 0; s < n_steps; ++s) {
    ring_wait(p.NST);
    stage_step(s + p.NST - 1);
    const float* buf = ring + (s % p.NST) * p.stage;
    const int t = qt0 + s / per, sub = s % per;
    if (sub < p.NKC) {
      if (sub == 0) zero_acc(sacc);
      nt_product<RM>(sacc,
                     (side ? vs : ks) + rs * 4 * RM * LD + sub * p.DC +
                         gs * sw,
                     LD, buf + side * kKeys * ldc + gs * sw, ldc, sw);
      if (sub == p.NKC - 1) {
        store_scores<RM>(
            part + ((side * p.GS + gs) * BK + rs * 4 * RM) * kPS, sacc);
        __syncthreads();
        const int q_start = t * kKeys;
        const bool full = k_start + BK <= seq_k &&
                          q_start + kKeys <= seq_q &&
                          (!causal || k_start + BK - 1 <= q_start + off);
        const float* stats = buf + 2 * kKeys * ldc;  // lse, then delta
        for (int idx = tid; idx < BK * 16; idx += kThreads) {
          const int r = idx >> 4, c = 4 * (idx & 15);
          float* ps = part + r * kPS + c;
          const float4 sv = sum_splits(ps, p.GS, part_stride);
          const float4 dv4 = sum_splits(ps + p.GS * part_stride, p.GS,
                                        part_stride);
          const int col = k_start + r;
          float pe[4], de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q_start + c + e;
            const bool in = row < seq_q;
            const bool vis = full || (col < seq_k && in &&
                                      (!causal || col <= row + off));
            const float lq = stats[c + e];
            const float dl = stats[kKeys + c + e];
            pe[e] = vis ? expf(comp(sv, e) * sm_scale - lq) : 0.f;
            de[e] = ds_zero ? 0.f : pe[e] * (comp(dv4, e) * do_scale - dl);
          }
          *reinterpret_cast<float4*>(ps) =
              make_float4(pe[0], pe[1], pe[2], pe[3]);
          *reinterpret_cast<float4*>(ps + p.GS * part_stride) =
              make_float4(de[0], de[1], de[2], de[3]);
        }
        __syncthreads();
        if (p.NVC == 0) {  // Q and dO whole in this chunk
          const int ql = kKeys / p.GK;
          nn_product<RM, CN, RT>(
              acc, part + (side * p.GS * BK + rs * 4 * RM) * kPS + gq * ql,
              kPS, buf + (1 - side) * kKeys * ldc + gq * ql * ldc +
                       co * 8 * p.CN,
              ldc, ql, p.CN);
        }
      }
    } else {
      const int ql = vq / p.GK;
      const int qq0 = (sub - p.NKC) * vq + gq * ql;
      nn_product<RM, CN, RT>(
          acc, part + (side * p.GS * BK + rs * 4 * RM) * kPS + qq0, kPS,
          buf + (1 - side) * vq * LD + gq * ql * LD + co * 8 * p.CN, LD, ql,
          p.CN);
    }
  }

  // warps 0-3 hold dV (p^T against dO), warps 4-7 dK (ds^T against Q)
  const float scale = side ? 1.f : dv_scale * do_scale;
  float* dst = (side ? dk : dv) + (size_t)bh * seq_k * D;
  if (p.GK == 1) {
    store_acc<RM, CN, RT>(dst, D, k_start + rs * 4 * RM, co * 8 * p.CN,
                          seq_k, p.CN, acc, scale);
    return;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every read of the ring and tiles done
  store_acc<RM, CN, RT>(red + (size_t)(side * p.GK + gq) * BK * LD, LD,
                        rs * 4 * RM, co * 8 * p.CN, BK, p.CN, acc, scale);
  __syncthreads();
  // each half's query splits, split 0 first
  sum_accs(dv + (size_t)bh * seq_k * D, red, nullptr, p.GK, BK, LD, D,
           k_start, seq_k);
  sum_accs(dk + (size_t)bh * seq_k * D, red + (size_t)p.GK * BK * LD,
           nullptr, p.GK, BK, LD, D, k_start, seq_k);
}

// ------------------------------------------------- the fp32 launches
int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
  }
  return n;
}

// The largest power of two <= 64 (and >= 4) of rows of `width` floats
// that `floats` holds `copies` times.
int chunk_rows(int floats, int width, int copies) {
  int r = 64;
  while (r > 4 && copies * r * (width + 4) > floats) r >>= 1;
  return r;
}

// The chunking of the swept operand: up to D = `whole` one chunk a tile
// holding `copies_k` whole 64-row tiles, else chunks of `dc` columns of
// `copies_k` operands, then chunks of VK rows of `copies` operands; the
// ring's stage is the larger.
void plan_chunks(Plan* p, int whole, int dc, int copies_k, int copies) {
  const int D = p->D;
  if (D <= whole) {
    p->DC = D;
    p->NKC = 1;
    p->VK = kKeys;
    p->NVC = 0;
    p->stage = copies_k * kKeys * (D + 4);
    return;
  }
  p->DC = dc;
  p->NKC = D / dc;
  const int stage_k = copies_k * kKeys * (dc + 4);
  p->VK = chunk_rows(stage_k, D, copies);
  p->NVC = kKeys / p->VK;
  p->stage = std::max(stage_k, copies * p->VK * (D + 4));
}

// Bytes of shared memory, with three stages in the ring where they fit
// beside the rest (`rest` floats), else two; the accumulators' final
// sum (`reduce` floats) reuses the same memory.
size_t plan_ring(Plan* p, size_t rest, size_t reduce) {
  p->NST = 3;
  size_t f = rest + 3 * (size_t)p->stage;
  if (f * sizeof(float) > kMaxSmem) {
    p->NST = 2;
    f = rest + 2 * (size_t)p->stage;
  }
  return std::max(f, reduce) * sizeof(float);
}

// Which instantiation: the exact column count (RT false) at the head dims
// that have one, else the bound for RM, the column count read at run
// time.
enum class Inst { k8x8, k8x4, k8x6, k4x6, k4x8, k4x12, k4x16, k4x16rt,
                  k2x32rt, k1x64rt, kPP8, kPP4 };

// Up to D = 256, the CTA's own rows in NS blocks of 32 (RM = 8): the most
// of 4, 2, 1 whose grid still gives every SM a CTA and whose shared
// memory fits (`fill` lays out the plan for NS and returns its bytes).
template <typename F>
void plan_row_blocks(int BH, int seq, int NOc, Plan* p, size_t* smem,
                     F fill) {
  const int sms = sm_count();
  for (int ns = 4; ns >= 1; ns >>= 1) {
    if (NOc * ns > 8) continue;
    Plan pl = *p;
    pl.NS = ns;
    pl.GK = 8 / (ns * NOc);
    const size_t bytes = fill(&pl);
    if (ns > 1 && ((seq + 32 * ns - 1) / (32 * ns) * BH < sms ||
                   bytes > kMaxSmem))
      continue;
    *p = pl;
    *smem = bytes;
    return;
  }
}

// The forward: up to D = 64, where the grid of 128-row tiles fills the
// card, the two-sided kernel (fa_fwd_f32_pp_kernel); else RM = 8 up to D
// = 512 (128, 64 or 32 query rows up to 256, 32 above), RM = 4 to 1024,
// RM = 2 to 2048. Up to D = 256 the accumulator columns are 64 a warp
// tile (32 at D = 32) and the key splits fill the 8 warps; above it each
// warp owns D / 8 columns. Up to D = 64 a stage holds a tile's K and V
// whole.
Inst fwd_plan(int D, int BH, int seq_q, Plan* p, size_t* smem) {
  auto fill = [D](Plan* pl, int rm) {
    const int bq = 4 * rm * pl->NS;
    pl->GS = 8 / pl->NS;
    plan_chunks(pl, 64, 128, 1, 1);
    if (pl->NVC == 0) pl->stage = 2 * kKeys * (D + 4);
    return plan_ring(
        pl, 256 + (size_t)bq * (D + 4) + (size_t)pl->GS * bq * kPS,
        pl->GK > 1 ? 256 + (size_t)pl->GK * bq * (D + 4) : 0);
  };
  *p = Plan{};
  p->D = D;
  if (D <= 256) {
    p->CN = D < 64 ? D / 8 : 8;
    p->NOc = D / (8 * p->CN);
    if (D <= 64 && (seq_q + kPPRows - 1) / kPPRows * BH >= sm_count()) {
      // S and P.V on two sides of the CTA, 128 rows a CTA
      p->NS = 4;
      *smem = sizeof(float) *
              ((size_t)kPPRows * (D + 4) + 6 * (size_t)kKeys * (D + 4) +
               2 * (size_t)kPPRows * kPS + 3 * (size_t)kPPRows);
      return D < 64 ? Inst::kPP4 : Inst::kPP8;
    }
    plan_row_blocks(BH, seq_q, p->NOc, p, smem,
                    [&](Plan* pl) { return fill(pl, 8); });
    return D < 64 ? Inst::k8x4 : Inst::k8x8;
  }
  const int rm = D <= 512 ? 8 : D <= 1024 ? 4 : 2;
  p->NS = 1;
  p->CN = D / 64;
  p->NOc = 8;
  p->GK = 1;
  *smem = fill(p, rm);
  return D == 384 ? Inst::k8x6 : D == 512 ? Inst::k8x8
       : rm == 4 ? Inst::k4x16rt : Inst::k2x32rt;
}

// dq: RM = 8 up to D = 256 (128, 64 or 32 query rows), RM = 4 to 512 (16
// rows), RM = 2 to 2048 (8 rows): Q and dO stay resident. Up to D = 64 a
// stage holds a tile's K and V whole.
Inst dq_plan(int D, int BH, int seq_q, Plan* p, size_t* smem) {
  auto fill = [D](Plan* pl, int rm) {
    const int bq = 4 * rm * pl->NS;
    pl->GS = 4 / pl->NS;
    const size_t rest = 256 + 2 * (size_t)bq * (D + 4) +
                        2 * (size_t)pl->GS * bq * kPS;
    const size_t reduce =
        pl->GK > 1 ? 256 + (size_t)pl->GK * bq * (D + 4) : 0;
    // 128-column chunks (fewer, longer steps) where they fit
    plan_chunks(pl, 64, 128, 2, 1);
    const size_t bytes = plan_ring(pl, rest, reduce);
    if (bytes <= kMaxSmem) return bytes;
    plan_chunks(pl, 64, 64, 2, 1);
    return plan_ring(pl, rest, reduce);
  };
  *p = Plan{};
  p->D = D;
  if (D <= 256) {
    p->CN = D < 64 ? D / 8 : 8;
    p->NOc = D / (8 * p->CN);
    plan_row_blocks(BH, seq_q, p->NOc, p, smem,
                    [&](Plan* pl) { return fill(pl, 8); });
    return D < 64 ? Inst::k8x4 : Inst::k8x8;
  }
  const int rm = D <= 512 ? 4 : 2;
  const Inst inst =
      D == 384 ? Inst::k4x6 : D == 512 ? Inst::k4x8 : Inst::k2x32rt;
  p->NS = 1;
  p->CN = D / 64;
  p->NOc = 8;
  p->GK = 1;
  *smem = fill(p, rm);
  return inst;
}

// dk/dv: RM = 8 up to D = 256 (128 keys up to D = 64, 64 to 128, 32 to
// 256, fewer where the grid would not give every SM a CTA), RM = 4 to
// 512 (16 keys), 2 to 1024, 1 to 2048: K and V stay resident, and each
// half's accumulator (dV or dK) is 4 tiles (row tiles x column tiles x
// query splits). Up to D = 64 a stage holds a q tile's Q and dO whole.
Inst dkdv_plan(int D, int BH, int seq_k, Plan* p, size_t* smem) {
  const int sms = sm_count();
  Plan pl{};
  pl.D = D;
  int rm = 8;
  Inst inst;
  if (D <= 256) {
    pl.CN = D < 64 ? D / 8 : 8;
    pl.NS = D <= 64 ? 4 : D <= 128 ? 2 : 1;
    while (pl.NS > 1 && (seq_k + 32 * pl.NS - 1) / (32 * pl.NS) * BH < sms)
      pl.NS >>= 1;
    inst = D < 64 ? Inst::k8x4 : Inst::k8x8;
  } else {
    rm = D <= 512 ? 4 : D <= 1024 ? 2 : 1;
    pl.NS = 1;
    pl.CN = D / 32;
    inst = D == 384 ? Inst::k4x12 : D == 512 ? Inst::k4x16
         : rm == 2 ? Inst::k2x32rt : Inst::k1x64rt;
  }
  pl.NOc = D / (8 * pl.CN);
  pl.GK = 4 / (pl.NS * pl.NOc);
  const int bk = 4 * rm * pl.NS;
  pl.GS = 4 / pl.NS;
  const size_t rest =
      2 * (size_t)bk * (D + 4) + 2 * (size_t)pl.GS * bk * kPS;
  const size_t reduce = pl.GK > 1 ? 2 * (size_t)pl.GK * bk * (D + 4) : 0;
  // 128-column chunks (fewer, longer steps) where they fit; a stage
  // also holds its q tile's lse and delta past the last chunk's tiles
  plan_chunks(&pl, 64, 128, 2, 2);
  pl.stage = std::max(pl.stage, 2 * kKeys * (pl.DC + 4) + 2 * kKeys);
  *smem = plan_ring(&pl, rest, reduce);
  if (*smem > kMaxSmem) {
    plan_chunks(&pl, 64, 64, 2, 2);
    pl.stage = std::max(pl.stage, 2 * kKeys * (pl.DC + 4) + 2 * kKeys);
    *smem = plan_ring(&pl, rest, reduce);
  }
  *p = pl;
  return inst;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only by asking); more than a CTA may hold is refused.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct F32Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *out, *lse_out, *dq, *dk, *dv;
  int BH, seq_q, seq_k;
  float sm_scale, do_scale, dv_scale;
  int ds_zero, causal;
};

template <int RM, int CN, bool RT>
cudaError_t fwd_f32(const F32Args& a, const Plan& p, size_t smem,
                    cudaStream_t stream) {
  auto kern = fa_fwd_f32_kernel<RM, CN, RT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int bq = 4 * RM * p.NS;
  kern<<<dim3((a.seq_q + bq - 1) / bq, a.BH), kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.out, a.lse_out, a.seq_q, a.seq_k, a.sm_scale,
      a.causal, p);
  return cudaGetLastError();
}

template <int CN>
cudaError_t fwd_f32_pp(const F32Args& a, size_t smem, cudaStream_t stream) {
  auto kern = fa_fwd_f32_pp_kernel<CN>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((a.seq_q + kPPRows - 1) / kPPRows, a.BH), kThreads, smem,
         stream>>>(a.q, a.k, a.v, a.out, a.lse_out, a.seq_q, a.seq_k,
                   a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <int RM, int CN, bool RT>
cudaError_t dq_f32(const F32Args& a, const Plan& p, size_t smem,
                   cudaStream_t stream) {
  auto kern = fa_dq_f32_kernel<RM, CN, RT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int bq = 4 * RM * p.NS;
  kern<<<dim3((a.seq_q + bq - 1) / bq, a.BH), kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.seq_q, a.seq_k,
      a.sm_scale, a.do_scale, a.ds_zero, a.causal, p);
  return cudaGetLastError();
}

template <int RM, int CN, bool RT>
cudaError_t dkdv_f32(const F32Args& a, const Plan& p, size_t smem,
                     cudaStream_t stream) {
  auto kern = fa_dkdv_f32_kernel<RM, CN, RT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int bk = 4 * RM * p.NS;
  kern<<<dim3((a.seq_k + bk - 1) / bk, a.BH), kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.seq_q, a.seq_k,
      a.sm_scale, a.do_scale, a.dv_scale, a.ds_zero, a.causal, p);
  return cudaGetLastError();
}

cudaError_t launch_fwd_f32(const F32Args& a, int D, cudaStream_t stream) {
  if (D > kMaxF32Dim) return cudaErrorInvalidValue;
  Plan p;
  size_t smem;
  switch (fwd_plan(D, a.BH, a.seq_q, &p, &smem)) {
    case Inst::k8x8: return fwd_f32<8, 8, false>(a, p, smem, stream);
    case Inst::k8x4: return fwd_f32<8, 4, false>(a, p, smem, stream);
    case Inst::k8x6: return fwd_f32<8, 6, false>(a, p, smem, stream);
    case Inst::k4x16rt: return fwd_f32<4, 16, true>(a, p, smem, stream);
    case Inst::k2x32rt: return fwd_f32<2, 32, true>(a, p, smem, stream);
    case Inst::kPP8: return fwd_f32_pp<8>(a, smem, stream);
    case Inst::kPP4: return fwd_f32_pp<4>(a, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd_f32(const F32Args& a, int D, cudaStream_t stream) {
  if (D > kMaxF32Dim) return cudaErrorInvalidValue;
  Plan p;
  size_t smem;
  cudaError_t e;
  switch (dkdv_plan(D, a.BH, a.seq_k, &p, &smem)) {
    case Inst::k8x8: e = dkdv_f32<8, 8, false>(a, p, smem, stream); break;
    case Inst::k8x4: e = dkdv_f32<8, 4, false>(a, p, smem, stream); break;
    case Inst::k4x12: e = dkdv_f32<4, 12, false>(a, p, smem, stream); break;
    case Inst::k4x16: e = dkdv_f32<4, 16, false>(a, p, smem, stream); break;
    case Inst::k2x32rt: e = dkdv_f32<2, 32, true>(a, p, smem, stream); break;
    case Inst::k1x64rt: e = dkdv_f32<1, 64, true>(a, p, smem, stream); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  switch (dq_plan(D, a.BH, a.seq_q, &p, &smem)) {
    case Inst::k8x8: return dq_f32<8, 8, false>(a, p, smem, stream);
    case Inst::k8x4: return dq_f32<8, 4, false>(a, p, smem, stream);
    case Inst::k4x6: return dq_f32<4, 6, false>(a, p, smem, stream);
    case Inst::k4x8: return dq_f32<4, 8, false>(a, p, smem, stream);
    case Inst::k2x32rt: return dq_f32<2, 32, true>(a, p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ bf16 column slices
// Head dims above 256 (a multiple of kWC, as the wrapper pads them) split
// the bf16 backward's columns over CTAs: above D = 512 grid.z is the
// slice, kWC columns of dK and dV, or dQ, each (at 384 and 512 a cluster
// of two CTAs of D / 2); the forward splits O's 64-column sub-tiles over
// warpgroups; see "D > 256" in the bf16 kernels below.
constexpr int kWC = 128;

__device__ __forceinline__ int wide_chunk(int slice, int i, int nch) {
  return (slice + 1 + i) % nch;  // the backward's order: `slice` last
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
template <bool kMask, int kSubs, int kAcc, bool kSkipUnit = false>
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
    // with kSkipUnit a warp whose rows all keep their max skips the
    // rescale (a factor of exactly 1 changes no bits)
    if (kSkipUnit && !__any_sync(kFullMask, alpha != 1.f)) continue;
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
// The forward: S once a (q tile, kv tile) over the whole D. The D / 64
// column sub-tiles of a 64-row q tile split over the NW warpgroups of a
// CTA, SUBS of Q (resident, loaded once), K, V and O a warpgroup (O is
// 32 x SUBS registers a thread). Each warpgroup adds the wgmma products
// of its sub-tiles into its partial S (64 x 64 fp32); the partials are
// summed in a fixed order, so every row's S, m, l and p (rounded to
// bf16 as in the D <= 256 kernels) have the same bits wherever they are
// taken; P.V runs into each warpgroup's own sub-tiles of O as one
// m64n192 or m64n256 wgmma a k-step. The layouts (WideFwd, mirrored by
// ops/flash_attention.py wide_fwd_plan):
//   * D = 384: one CTA of 2 warpgroups x 3 sub-tiles, K double-buffered,
//     and S of tile t + 1 issued behind P.V of tile t (both in flight on
//     the tensor cores while the warpgroup waits once; issuing it before
//     the softmax instead measured no faster): 225 KB;
//   * D = 512: one CTA of 2 warpgroups x 4 sub-tiles (no registers for a
//     second S): 225 KB;
//   * above, up to D = 4096, a thread-block cluster of D / 256 CTAs
//     (rounded up; above 8 a non-portable cluster of up to 16) of one
//     warpgroup x 4 sub-tiles, the partials, double-buffered by tile
//     parity, summed in rank order through distributed shared memory
//     after one cluster barrier a tile: 129 KB. Distributed shared memory
//     moves ~20 bytes a clock a CTA, so this layout is kept to head dims
//     no model here reaches; at D = 384 and 512 a cluster of 3 or 4 such
//     CTAs took 150 and 700 us where one CTA takes ~80 and ~180.
// In a CTA of two warpgroups the rows' softmax splits between them: warp
// w of warpgroup 0 and warp w of warpgroup 1 hold the same 16 rows'
// partials; the one whose rows it is (warps 0-1 of warpgroup 0, 2-3 of
// warpgroup 1) adds the other's partial after a CTA barrier, takes m, l
// and p, and hands p (the P.V operand) and the rescale factors back
// through shared memory and a two-warp named barrier. A warp whose rows
// all keep their max skips O's rescale. Each element of Q, K and V is
// read by one CTA a q tile. Q, K and V arrive by TMA (tensor maps of
// (BH, S, D), 64 x 64 boxes in the 128-byte swizzle wgmma reads, rows
// past S zero-filled), awaited on mbarriers: K for tile t + KBUF as soon
// as every warpgroup's S of tile t is done, V for tile t + 1 at the start
// of tile t + 1, each landing under the other's work, issued by a warp
// that takes no softmax. One lse row.
// A named barrier of two warps (64 threads): one arrives, releasing its
// shared-memory writes, the other waits for it.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

template <int NW, int SUBS, int KBUF>
struct WideFwd {
  static_assert(SUBS == 3 || SUBS == 4, "P.V is one m64n192 or n256 wgmma");
  static constexpr int kThreads = kWGThreads * NW;
  static constexpr int kSubs = NW * SUBS;          // sub-tiles a CTA
  static constexpr uint32_t kSub = sm90::Tile<64>::bytes(64);  // 8 KB
  static constexpr uint32_t kOperand = kSubs * kSub;
  static constexpr uint32_t kSx = 64 * 64 * sizeof(float);  // a partial S
  static constexpr bool kOverlap = KBUF == 2;
  // one warpgroup a CTA: the sub-tiles split over a cluster (D > 512)
  static constexpr bool kCluster = NW == 1;
  // 1 KB of slack, Q, V, K (KBUF buffers), the partials (twice over in a
  // cluster), then the mbarriers (V's, K's)
  static constexpr size_t kSmem = 1024 + (size_t)(2 + KBUF) * kOperand +
                                  (size_t)(kCluster ? 2 : 1) * NW * kSx +
                                  8 * (KBUF + 1);
};

template <int NW, int SUBS, int KBUF>
__global__ void __launch_bounds__(kWGThreads * NW, 1)
fa_fwd_bf16_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        int seq_q, int seq_k, int D, float sm_scale,
                        int causal) {
  using P = WideFwd<NW, SUBS, KBUF>;
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t qs = sm90::smem_u32(base);  // the CTA's Q sub-tiles
  const uint32_t vs = qs + P::kOperand;
  const uint32_t ks = vs + P::kOperand;      // KBUF buffers
  float* sx = reinterpret_cast<float*>(base + (2 + KBUF) * P::kOperand);

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const uint32_t bar_v = sm90::smem_u32(sx + (P::kCluster ? 2 : 1) * NW * 4096);
  const uint32_t bar_k = bar_v + 8;  // KBUF of them
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;
  const int wt = tid % kWGThreads;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int tq = tid & 3;
  const int bh = blockIdx.y;
  const int nsub = D / 64;
  const int cta0 = rank * P::kSubs;  // the CTA's first sub-tile
  const int w0 = wg * SUBS;          // the warpgroup's first, in the CTA
  const int valid = min(P::kSubs, nsub - cta0);  // the CTA's sub-tiles
  const uint32_t op_bytes = valid * P::kSub;
  // the last q tiles see the most keys: they start first
  const int n_qt = gridDim.x / ranks;
  const int q_start = (n_qt - 1 - (int)blockIdx.x / ranks) * kBQ;
  const int off = seq_k - seq_q;
  const int n = kv_tiles(q_start, kBQ, seq_q, seq_k, causal);

  // the CTA's sub-tiles of rows [row0, row0 + 64) of an operand, one
  // 64 x 64 box each, issued by one warp: lane 0 expects the bytes (with
  // `extra` more), then lane i issues sub-tile i's box
  const int lane = tid & 31;
  auto load = [&](uint32_t dst, const CUtensorMap& map, int row0,
                  uint32_t bar, uint32_t extra) {
    if (lane == 0) sm90::mbarrier_arrive_expect_tx(bar, op_bytes + extra);
    __syncwarp();
    if (lane < valid)
      sm90::tma_load_3d(dst + lane * P::kSub, &map, bar, (cta0 + lane) * 64,
                        row0, bh);
  };
  auto load_k = [&](int t) {
    load(ks + (t % KBUF) * P::kOperand, map_k, t * kBK,
         bar_k + 8 * (t % KBUF), 0);
  };
  if (tid == 0) {
    for (int i = 0; i <= KBUF; ++i) sm90::mbarrier_init(bar_v + 8 * i, 1);
    sm90::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid < 32 && n > 0) {
    load(vs, map_v, 0, bar_v, 0);
    // Q joins K_0's phase (one arrival: the barriers count one)
    load(ks, map_k, 0, bar_k, op_bytes);
    if (lane < valid)
      sm90::tma_load_3d(qs + lane * P::kSub, &map_q, bar_k,
                        (cta0 + lane) * 64, q_start, bh);
    for (int t = 1; t < KBUF && t < n; ++t) load_k(t);
  }

  float o[SUBS][32];
#pragma unroll
  for (int j = 0; j < SUBS; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32] = {};

  // this warpgroup's partial S of tile t over its sub-tiles (its first is
  // never idle), issued (the caller commits and waits)
  auto issue_s = [&](float(&acc)[32], int t) {
    sm90::mbarrier_wait(bar_k + 8 * (t % KBUF), (t / KBUF) & 1);
    const uint32_t kt = ks + (t % KBUF) * P::kOperand;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < SUBS; ++j) {
      if (cta0 + w0 + j >= nsub) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss_n64(
            acc, sm90::desc_k<64>(qs + (w0 + j) * P::kSub, kBQ, 0, kk),
            sm90::desc_k<64>(kt + (w0 + j) * P::kSub, kBK, 0, kk),
            j > 0 || kk > 0);
    }
    sm90::wgmma_commit();
  };
  if (n > 0) {
    issue_s(s, 0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
  }

  for (int t = 0; t < n; ++t) {
    if (t > 0) {
      __syncthreads();  // every P.V of tile t-1 is done: V's buffer free
      if (tid >= 64 && tid < 96) load(vs, map_v, t * kBK, bar_v, 0);
      if (!P::kOverlap) {
        issue_s(s, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
      }
    }

    const int k_start = t * kBK;
    const bool full = k_start + kBK <= seq_k &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    uint32_t pa[4][4];
    if constexpr (P::kCluster) {
      // every rank's partial, summed in rank order after a cluster
      // barrier, then every warp the softmax of its rows
      const int par = (t & 1) * NW;
      float4* mine = reinterpret_cast<float4*>(sx + par * 4096) + wt;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mine[j * kWGThreads] =
            make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      sm90::cluster_arrive();
      sm90::cluster_wait();
      // every S of tile t is done: K_{t+KBUF} into its buffer
      if (tid < 32 && t + KBUF < n) load_k(t + KBUF);
      for (int r = 0; r < ranks; ++r) {
        const float4* part = cluster.map_shared_rank(mine, r);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = part[(4 * h + j) * kWGThreads];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* d = &s[4 * (4 * h + j)];
            d[0] = r == 0 ? x[j].x : d[0] + x[j].x;
            d[1] = r == 0 ? x[j].y : d[1] + x[j].y;
            d[2] = r == 0 ? x[j].z : d[2] + x[j].z;
            d[3] = r == 0 ? x[j].w : d[3] + x[j].w;
          }
        }
      }
      if (full)
        online_softmax<false, SUBS, 32, true>(
            s, m, l, o, q_start, k_start, seq_k, off, causal,
            sm_scale * kLog2e);
      else
        online_softmax<true, SUBS, 32, true>(
            s, m, l, o, q_start, k_start, seq_k, off, causal,
            sm_scale * kLog2e);
      to_a_operand(s, pa);
    } else {
      // Two warps hold each 16 rows' partials, warp `warp` of either
      // warpgroup: warpgroup 0's takes the softmax of rows 0-31, warpgroup
      // 1's of rows 32-63. The other adds nothing: it writes its partial
      // to its slot, and after the barrier its partner adds it (s + it is
      // the sum in warpgroup order: IEEE addition commutes), takes m, l
      // and p, rescales its own O, and writes p (as the P.V operand) and
      // the rescale factors back into that slot for it.
      const bool soft = (warp >> 1) == wg;
      uint4* own = reinterpret_cast<uint4*>(sx + wg * 4096) + wt;
      uint4* other = reinterpret_cast<uint4*>(sx + (wg ^ 1) * 4096) + wt;
      if (!soft)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          reinterpret_cast<float4*>(own)[j * kWGThreads] = make_float4(
              s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      __syncthreads();  // the partials are there; every S of tile t done
      // K_{t+KBUF} into its buffer, from a warp that takes no softmax
      if (tid >= 64 && tid < 96 && t + KBUF < n) load_k(t + KBUF);
      if (soft) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = reinterpret_cast<const float4*>(
              other)[j * kWGThreads];
          s[4 * j] += x.x;
          s[4 * j + 1] += x.y;
          s[4 * j + 2] += x.z;
          s[4 * j + 3] += x.w;
        }
        const float m0[2] = {m[0], m[1]};
        if (full)
          online_softmax<false, SUBS, 32, true>(
              s, m, l, o, q_start, k_start, seq_k, off, causal,
              sm_scale * kLog2e);
        else
          online_softmax<true, SUBS, 32, true>(
              s, m, l, o, q_start, k_start, seq_k, off, causal,
              sm_scale * kLog2e);
        to_a_operand(s, pa);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          other[kk * kWGThreads] =
              make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
        // the factor online_softmax rescaled by, recomputed bit for bit
        other[4 * kWGThreads] = make_uint4(
            __float_as_uint(exp2f(m0[0] - m[0])),
            __float_as_uint(exp2f(m0[1] - m[1])), 0u, 0u);
        pair_arrive(1 + warp);
      } else {
        pair_sync(1 + warp);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint4 x = own[kk * kWGThreads];
          pa[kk][0] = x.x;
          pa[kk][1] = x.y;
          pa[kk][2] = x.z;
          pa[kk][3] = x.w;
        }
        const uint4 f = own[4 * kWGThreads];
        const float alpha[2] = {__uint_as_float(f.x), __uint_as_float(f.y)};
        if (__any_sync(kFullMask, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
          for (int j = 0; j < SUBS; ++j)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[j][i] *= alpha[(i >> 1) & 1];
      }
    }

    sm90::mbarrier_wait(bar_v, t & 1);  // V_t landed
#pragma unroll
    for (int j = 0; j < SUBS; ++j) sm90::fence_regs(o[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
    // one wgmma a k-step over the warpgroup's SUBS sub-tiles of V (an
    // MN-major operand of SUBS x 64 columns, sub-tiles kSub apart: the
    // descriptor's leading byte offset); columns of a rank's idle sub-
    // tiles are computed and never stored
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sm90::desc_mn<64>(vs + w0 * P::kSub, kBK, 0, kk);
      if constexpr (SUBS == 3)
        sm90::wgmma_rs_n192(*reinterpret_cast<float(*)[96]>(o), pa[kk], dv);
      else
        sm90::wgmma_rs_n256(*reinterpret_cast<float(*)[128]>(o), pa[kk], dv);
    }
    sm90::wgmma_commit();
    if (P::kOverlap && t + 1 < n) {
      // S of tile t + 1 behind P.V of tile t
      issue_s(s, t + 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
    } else {
      sm90::wgmma_wait<0>();
    }
#pragma unroll
    for (int j = 0; j < SUBS; ++j) sm90::fence_regs(o[j]);
  }
  // no rank leaves while another reads its partials
  if constexpr (P::kCluster) {
    sm90::cluster_arrive();
    sm90::cluster_wait();
  }

  // the warp that took the softmax of these rows writes their lse; in a
  // CTA of two warpgroups it hands l to its partner first
  bool soft = rank == 0;
  if constexpr (!P::kCluster) {
    soft = (warp >> 1) == wg;
    __syncthreads();
    if (soft)
      reinterpret_cast<float2*>(sx + (wg ^ 1) * 4096)[wt] =
          make_float2(l[0], l[1]);
    __syncthreads();
    if (!soft) {
      const float2 x = reinterpret_cast<const float2*>(sx + wg * 4096)[wt];
      l[0] = x.x;
      l[1] = x.y;
    }
  }
  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    safe[h] = l[h] == 0.f ? 1.f : l[h];
    const int row = q_start + 16 * warp + g + 8 * h;
    if (soft && tq == 0 && row < seq_q)
      lse[(size_t)bh * seq_q + row] =
          l[h] == 0.f ? kNegInf : m[h] * kLn2 + logf(safe[h]);
  }
#pragma unroll
  for (int j = 0; j < SUBS; ++j)
    if (cta0 + w0 + j < nsub)
      store_rows_ld<64, true>(
          out + (size_t)bh * seq_q * D,
          *reinterpret_cast<const float(*)[1][32]>(o[j]), safe, q_start,
          (cta0 + w0 + j) * 64, seq_q, D);
}

// The backward above D = 512 (no model here runs there; at 384 and 512
// the clusters below): a column split on the tensor cores. One
// warpgroup a CTA, 64 rows, one kWC-column slice (64
// accumulator registers a thread for dQ, 128 for dK and dV: the D = 256
// dk/dv layout's). A chunk step streams 64-row Tile<kWC> tiles of the
// chunk's columns through a 2-stage cp.async ring and adds their product
// to S and dP in registers; after the tile's last chunk p and ds are
// taken as in the D <= 256 kernels, and the slice's product reads chunk
// `slice`'s Q and dO (dk/dv) or K (dq), which the backward takes last.
// Every wgmma group is waited for before the barrier that lets its
// stage be refilled. Both read the forward's one lse row.

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

// The backward at D = 384 and 512: S and dP once a tile pair. A cluster
// of two CTAs a tile (64 keys in dk/dv, 64 query rows in dq), rank r
// owning columns [r C, (r + 1) C) of dK and dV, or of dQ (C = D / 2: 192
// or 256), and reading only those columns of every operand. A CTA holds
// its own operands (K and V, or Q and dO) resident and streams the swept
// ones (Q and dO, or K and V) through 2 stages, all by TMA (64 x 64
// boxes, 128-byte swizzle) on mbarriers. dO is scaled by do_scale once
// as it lands: in dk/dv, with the tile's lse and delta staged beside it,
// under the dV and dK products of the tile before. Its two warpgroups
// split the products, not the columns: warpgroup 0 computes the CTA's
// partial S^T (S in dq) over its C columns, warpgroup 1 the partial dP^T
// (dP). Each pushes its fp32 partial (16 KB) into the partner CTA's
// buffer with st.async, which completes on the partner's mbarrier by
// byte count (no cluster barrier a tile), and adds the partner's partial
// to its own in rank order (rank 0's, then rank 1's): both ranks hold
// the same bits of S and dP, so of p and ds. Warpgroup 0 takes p, writes
// it (fp32) over the partner's partial S it has read, and in dk/dv
// accumulates dV += P^T.dO over the C columns (one m64n192 / m64n256
// wgmma a k-step); warpgroup 1 takes ds from that p and accumulates dK
// += dS^T.Q (dq: dQ += dS.K). Once warpgroup 1 has read both buffers it
// signals the partner (a remote arrive on its mbarrier) that the next
// partials may come. In dk/dv each warpgroup does two 64 x 64 x C
// products a tile; in dq warpgroup 1 does two and warpgroup 0 one.
// Distributed shared memory moved ~20 bytes a clock a CTA in the
// forward's probes: the 32 KB a CTA sends a tile pair is the price of
// computing S and dP once instead of D / 128 times. Shared memory: 1 KB
// of slack, the two resident operands, 2 stages of the two swept ones,
// the partner's two partials, dk/dv's 2 stages of [lse, delta], the
// mbarriers (2 stages, 2 partials, the partner's release): 231,464
// bytes at D = 512 (WideBwd), mirrored by ops/flash_attention.py
// wide_bwd_plan.
template <int C>
struct WideBwd {
  static_assert(C == 192 || C == 256, "one m64n192 or n256 wgmma");
  static constexpr int kSubs = C / 64;                          // 3 or 4
  static constexpr uint32_t kSub = sm90::Tile<64>::bytes(64);   // 8 KB
  static constexpr uint32_t kOperand = kSubs * kSub;  // 64 rows, C columns
  static constexpr uint32_t kX = 64 * 64 * sizeof(float);  // a partial
  static constexpr int kThreads = 2 * kWGThreads;
  static constexpr uint32_t kStats = 2 * 2 * 64 * sizeof(float);
  static constexpr int kBars = 5;
  static constexpr size_t kSmem =
      1024 + 6 * (size_t)kOperand + 2 * kX + kStats + 8 * kBars;
};

constexpr int kBarP = 1;    // p written (warpgroup 0 arrives, 1 waits)
constexpr int kBarWG1 = 2;  // warpgroup 1 has read both partials

// acc (64 x C fp32, C / 64 sub-tiles) += a . b, one wgmma a k-step: a
// 64 x 16 bf16 from registers, b the C columns of a 64-row MN-major tile
template <int C>
__device__ __forceinline__ void wgmma_rs_wide(float (&acc)[C / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (C == 192)
    sm90::wgmma_rs_n192(acc, a, db);
  else
    sm90::wgmma_rs_n256(acc, a, db);
}

// acc += A (64 x 64 bf16 from registers: p^T, ds^T or ds) . the C
// columns of the 64-row tile at `b`, issued and committed
template <int C>
__device__ __forceinline__ void issue_rs_wide(float (&acc)[C / 2],
                                              uint32_t (&a)[4][4],
                                              uint32_t b) {
  sm90::fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(a[kk]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_wide<C>(acc, a[kk], sm90::desc_mn<C>(b, 64, 0, kk));
  sm90::wgmma_commit();
}

// x (64 x 64 fp32) = the partial product of two 64-row tiles over their
// C columns (both K-major), issued and committed
template <int C>
__device__ __forceinline__ void issue_ss_wide(float (&x)[32], uint32_t a,
                                              uint32_t b) {
  sm90::fence_regs(x);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    sm90::wgmma_ss_n64(x, sm90::desc_k<C>(a, 64, 0, kk),
                       sm90::desc_k<C>(b, 64, 0, kk), kk);
  sm90::wgmma_commit();
}

// The exchange of a warpgroup's partial x (the thread's 32 values of
// it), in two halves around other work. push_partial: once the partner
// has released its buffer (`free_bar`; nothing to wait for before the
// first tile), push x into it (`peer_buf`, completing on the partner's
// mbarrier `peer_bar`). add_partial: wait for the partner's partial in
// this CTA's `buf` (mbarrier `bar`) and add it to x in rank order. Slot
// j * 128 + wt (a float4) holds registers 4j..4j+3 of thread wt of the
// warpgroup.
__device__ __forceinline__ void push_partial(const float (&x)[32],
                                             uint32_t peer_buf,
                                             uint32_t peer_bar,
                                             uint32_t free_bar, int tile) {
  const int wt = threadIdx.x % kWGThreads;
  if (tile > 0) sm90::mbarrier_wait_cluster(free_bar, (tile - 1) & 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sm90::st_async_v4(peer_buf + (uint32_t)(j * kWGThreads + wt) * 16,
                      x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3],
                      peer_bar);
}

__device__ __forceinline__ void add_partial(float (&x)[32], const float* buf,
                                            uint32_t bar, int tile,
                                            int rank) {
  const int wt = threadIdx.x % kWGThreads;
  sm90::mbarrier_wait_cluster(bar, tile & 1);
  const float4* other = reinterpret_cast<const float4*>(buf) + wt;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 y = other[j * kWGThreads];
    const float o[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[4 * j + c] = rank == 0 ? x[4 * j + c] + o[c] : o[c] + x[4 * j + c];
  }
}

// x (the summed p, fp32) into this thread's slots of `buf`
__device__ __forceinline__ void put_slots(float* buf, const float (&x)[32]) {
  float4* dst = reinterpret_cast<float4*>(buf) + threadIdx.x % kWGThreads;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j * kWGThreads] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

// ds = p (dp - stat) in x (0 when ds_zero), p from this thread's slots of
// `buf`; stat(i) is the delta of register i's query
template <typename F>
__device__ __forceinline__ void ds_from_slots(float (&x)[32],
                                              const float* buf, int ds_zero,
                                              F stat) {
  const float4* src =
      reinterpret_cast<const float4*>(buf) + threadIdx.x % kWGThreads;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 y = src[j * kWGThreads];
    const float p[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * j + c;
      x[i] = ds_zero ? 0.f : p[c] * (x[i] - stat(i));
    }
  }
}

// every 16-byte chunk of a tile of `bytes` at `tile` times `scale`,
// rounded to bf16, split over the CTA's threads (one chunk in flight a
// thread: it runs beside the dk/dv kernel's 128 accumulator registers)
__device__ __forceinline__ void scale_tile(uint8_t* tile, uint32_t bytes,
                                           float scale) {
  uint4* c = reinterpret_cast<uint4*>(tile);
#pragma unroll 1
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    scale_chunk(c + i, scale);
}

// dk/dv of 64 keys, cluster rank r's C columns (see above). Shared
// memory: K, V, 2 stages of [Q, dO], the partner's S^T (then p^T) and
// dP^T, 2 stages of [lse, delta] (64 floats each), the mbarriers [full
// 0, full 1, S^T, dP^T, free].
template <int C>
__global__ void __launch_bounds__(WideBwd<C>::kThreads, 1)
fa_dkdv_bf16_cluster_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int seq_q, int seq_k, float sm_scale,
                            float do_scale, float dv_scale, int ds_zero,
                            int causal) {
  using P = WideBwd<C>;
  constexpr int D = 2 * C;
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t ks = sm90::smem_u32(base);
  const uint32_t vs = ks + P::kOperand;
  const uint32_t st0 = vs + P::kOperand;   // stage s: Q, then dO
  float* xs = reinterpret_cast<float*>(base + 6 * P::kOperand);
  float* xp = xs + 64 * 64;
  float* stats = xp + 64 * 64;             // [2][lse, delta][64]
  const uint32_t bar_full = sm90::smem_u32(stats + 4 * kBQ);  // 2 stages
  const uint32_t bar_x = bar_full + 16;                    // S^T, dP^T
  const uint32_t bar_free = bar_full + 32;

  const int rank = (int)blockIdx.x & 1;    // cluster (2, 1, 1)
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;         // 0: S^T, p, dV; 1: dP^T, ds, dK
  const int lane = tid & 31;
  const int tq = tid & 3;
  const int bh = blockIdx.y;
  const int k_start = ((int)blockIdx.x >> 1) * kBK;  // heaviest first
  const int off = seq_k - seq_q;
  const int col0 = rank * C;
  const int need = causal ? k_start - off : 0;
  const int qt0 = max(need, 0) / kBQ;
  const int n = max((seq_q + kBQ - 1) / kBQ - qt0, 0);

  // q tile qt0 + i (and with the first, K and V) into stage i & 1, one
  // box a lane of warp 0 an operand
  auto load = [&](int i) {
    const uint32_t st = st0 + (i & 1) * 2 * P::kOperand;
    const uint32_t bar = bar_full + 8 * (i & 1);
    const int q_start = (qt0 + i) * kBQ;
    if (lane == 0)
      sm90::mbarrier_arrive_expect_tx(bar, (i == 0 ? 4 : 2) * P::kOperand);
    __syncwarp();
    if (lane < P::kSubs) {
      const int c = col0 + lane * 64;
      const uint32_t o = lane * P::kSub;
      if (i == 0) {
        sm90::tma_load_3d(ks + o, &map_k, bar, c, k_start, bh);
        sm90::tma_load_3d(vs + o, &map_v, bar, c, k_start, bh);
      }
      sm90::tma_load_3d(st + o, &map_q, bar, c, q_start, bh);
      sm90::tma_load_3d(st + P::kOperand + o, &map_do, bar, c, q_start, bh);
    }
  };
  if (tid == 0) {
    for (int b = 0; b < P::kBars; ++b) sm90::mbarrier_init(bar_full + 8 * b, 1);
    sm90::fence_mbarrier_init();
  }
  // both CTAs' mbarriers are there before either signals the other
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (tid < 32 && n > 0) {
    load(0);
    if (n > 1) load(1);
  }
  // q tile qt0 + i's lse and delta into stats, and its dO times
  // do_scale, rounded to bf16, once it lands (the first tile here, each
  // next one under the dV and dK products of the tile before)
  auto prepare = [&](int i) {
    if (tid < 2 * kBQ) {
      const int r = (qt0 + i) * kBQ + (tid & (kBQ - 1));
      stats[(i & 1) * 2 * kBQ + tid] =
          r < seq_q ? (tid < kBQ ? lse : delta)[(size_t)bh * seq_q + r]
                    : 0.f;
    }
    sm90::mbarrier_wait(bar_full + 8 * (i & 1), (i >> 1) & 1);
    scale_tile(base + (st0 - ks) + (i & 1) * 2 * P::kOperand + P::kOperand,
               P::kOperand, do_scale);
    sm90::fence_view_async_shared();
  };
  if (n > 0) prepare(0);
  __syncthreads();

  float* buf = wg == 0 ? xs : xp;          // where the partner's partial lands
  const uint32_t my_bar = bar_x + 8 * wg;

  float acc[C / 2];                        // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int q_start = (qt0 + i) * kBQ;
    const uint32_t qsm = st0 + (i & 1) * 2 * P::kOperand;
    const uint32_t dosm = qsm + P::kOperand;
    const float* lses = stats + (i & 1) * 2 * kBQ;
    const float* dels = lses + kBQ;
    // arm this tile's phase of the partner's partial
    if (tid % kWGThreads == 0) sm90::mbarrier_arrive_expect_tx(my_bar, P::kX);
    sm90::mbarrier_wait(bar_full + 8 * (i & 1), (i >> 1) & 1);

    float x[32];
    // S^T = K.Q^T (warpgroup 0), dP^T = V.dO^T (1)
    issue_ss_wide<C>(x, wg == 0 ? ks : vs, wg == 0 ? qsm : dosm);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(x);
    // the partner's addresses are mapped where they are used: held
    // through the tile they cost dk/dv at D = 512 a spilled register
    push_partial(x, sm90::mapa(sm90::smem_u32(buf), rank ^ 1),
                 sm90::mapa(my_bar, rank ^ 1), bar_free, i);
    add_partial(x, buf, my_bar, i, rank);

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    uint32_t a[4][4];
    if (wg == 0) {
      if (full)
        transposed_probs<false>(x, lses, k_start, q_start, seq_q, seq_k,
                                off, causal, sm_scale * kLog2e);
      else
        transposed_probs<true>(x, lses, k_start, q_start, seq_q, seq_k,
                               off, causal, sm_scale * kLog2e);
      put_slots(xs, x);                    // p^T over the partner's S^T
      named_arrive(kBarP, P::kThreads);
      to_a_operand(x, a);
      issue_rs_wide<C>(acc, a, dosm);      // dV += P^T.dO
    } else {
      named_sync(kBarP, P::kThreads);
      ds_from_slots(x, xs, ds_zero, [&](int r) {
        return dels[8 * (r >> 2) + 2 * tq + (r & 1)];
      });
      named_sync(kBarWG1, kWGThreads);     // both partials read
      if (tid == kWGThreads && i + 1 < n)
        sm90::mbarrier_arrive_cluster(sm90::mapa(bar_free, rank ^ 1));
      to_a_operand(x, a);
      issue_rs_wide<C>(acc, a, qsm);       // dK += dS^T.Q
    }
    if (i + 1 < n) prepare(i + 1);         // under dV and dK
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncthreads();  // stage i & 1 is free; the next tile's dO scaled
    if (tid < 32 && i + 2 < n) load(i + 2);
  }

  const float f[2] = {wg == 0 ? dv_scale : 1.f, wg == 0 ? dv_scale : 1.f};
  store_rows_ld<64, false>((wg == 0 ? dv : dk) + (size_t)bh * seq_k * D,
                           *reinterpret_cast<const float(*)[C / 64][32]>(acc),
                           f, k_start, col0, seq_k, D);
  // no CTA leaves while its partner may still write to it
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

// dq of 64 query rows, cluster rank r's C columns (see above), the
// heaviest q tiles first: warpgroup 0 takes S and p, warpgroup 1 dP, ds
// and dQ += dS.K and refills the stage dQ has read. Nothing but the
// exchange ties the two warpgroups, so warpgroup 0's S of tile t + 1 and
// its exchange run under warpgroup 1's ds and dQ of tile t (it cannot
// run further ahead: the partner's next partial S lands only once
// warpgroup 1 has read p). Shared memory: Q, dO, 2 stages of [K, V], the
// partner's S (then p) and dP, the mbarriers as in dk/dv.
template <int C>
__global__ void __launch_bounds__(WideBwd<C>::kThreads, 1)
fa_dq_bf16_cluster_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int seq_q, int seq_k,
                          float sm_scale, float do_scale, int ds_zero,
                          int causal) {
  using P = WideBwd<C>;
  constexpr int D = 2 * C;
  extern __shared__ uint8_t smem_bytes[];
  uint8_t* base = align_1k(smem_bytes);
  const uint32_t qs = sm90::smem_u32(base);
  const uint32_t dos = qs + P::kOperand;
  const uint32_t st0 = dos + P::kOperand;  // stage s: K, then V
  float* xs = reinterpret_cast<float*>(base + 6 * P::kOperand);
  float* xp = xs + 64 * 64;
  const uint32_t bar_full = sm90::smem_u32(xp + 64 * 64);
  const uint32_t bar_x = bar_full + 16;
  const uint32_t bar_free = bar_full + 32;

  const int rank = (int)blockIdx.x & 1;
  const int tid = threadIdx.x;
  const int wg = tid / kWGThreads;         // 0: S, p; 1: dP, ds, dQ
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const int bh = blockIdx.y;
  const int n_qt = (int)gridDim.x >> 1;
  const int q_start = (n_qt - 1 - ((int)blockIdx.x >> 1)) * kBQ;
  const int off = seq_k - seq_q;
  const int col0 = rank * C;
  const int n = kv_tiles(q_start, kBQ, seq_q, seq_k, causal);

  // kv tile t (and with the first, Q and dO) into stage t & 1
  auto load = [&](int t) {
    const uint32_t st = st0 + (t & 1) * 2 * P::kOperand;
    const uint32_t bar = bar_full + 8 * (t & 1);
    if (lane == 0)
      sm90::mbarrier_arrive_expect_tx(bar, (t == 0 ? 4 : 2) * P::kOperand);
    __syncwarp();
    if (lane < P::kSubs) {
      const int c = col0 + lane * 64;
      const uint32_t o = lane * P::kSub;
      if (t == 0) {
        sm90::tma_load_3d(qs + o, &map_q, bar, c, q_start, bh);
        sm90::tma_load_3d(dos + o, &map_do, bar, c, q_start, bh);
      }
      sm90::tma_load_3d(st + o, &map_k, bar, c, t * kBK, bh);
      sm90::tma_load_3d(st + P::kOperand + o, &map_v, bar, c, t * kBK, bh);
    }
  };
  if (tid == 0) {
    for (int b = 0; b < P::kBars; ++b) sm90::mbarrier_init(bar_full + 8 * b, 1);
    sm90::fence_mbarrier_init();
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (tid < 32 && n > 0) {
    load(0);
    if (n > 1) load(1);
  }
  if (n > 0) {                             // dO * do_scale, once
    sm90::mbarrier_wait(bar_full, 0);
    scale_tile(base + P::kOperand, P::kOperand, do_scale);
    sm90::fence_view_async_shared();
  }
  __syncthreads();

  // lse (warpgroup 0) or delta (1) of the thread's two rows
  float stat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_start + 16 * warp + g + 8 * h;
    stat[h] = row < seq_q ? (wg == 0 ? lse : delta)[(size_t)bh * seq_q + row]
                          : 0.f;
  }
  float* buf = wg == 0 ? xs : xp;
  const uint32_t my_bar = bar_x + 8 * wg;

  float acc[C / 2];                        // dQ (warpgroup 1)
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int k_start = t * kBK;
    const uint32_t kst = st0 + (t & 1) * 2 * P::kOperand;
    if (tid % kWGThreads == 0) sm90::mbarrier_arrive_expect_tx(my_bar, P::kX);
    sm90::mbarrier_wait(bar_full + 8 * (t & 1), (t >> 1) & 1);

    float x[32];
    // S = Q.K^T (warpgroup 0), dP = dO.V^T (1)
    issue_ss_wide<C>(x, wg == 0 ? qs : dos, kst + wg * P::kOperand);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(x);
    push_partial(x, sm90::mapa(sm90::smem_u32(buf), rank ^ 1),
                 sm90::mapa(my_bar, rank ^ 1), bar_free, t);
    add_partial(x, buf, my_bar, t, rank);

    const bool full = k_start + kBK <= seq_k && q_start + kBQ <= seq_q &&
                      (!causal || k_start + kBK - 1 <= q_start + off);
    if (wg == 0) {
      if (full)
        row_probs<false>(x, stat, q_start, k_start, seq_q, seq_k, off,
                         causal, sm_scale * kLog2e);
      else
        row_probs<true>(x, stat, q_start, k_start, seq_q, seq_k, off,
                        causal, sm_scale * kLog2e);
      put_slots(xs, x);                    // p over the partner's S
      named_arrive(kBarP, P::kThreads);
    } else {
      named_sync(kBarP, P::kThreads);
      ds_from_slots(x, xs, ds_zero, [&](int r) { return stat[(r >> 1) & 1]; });
      named_sync(kBarWG1, kWGThreads);     // both partials read
      if (tid == kWGThreads && t + 1 < n)
        sm90::mbarrier_arrive_cluster(sm90::mapa(bar_free, rank ^ 1));
      uint32_t a[4][4];
      to_a_operand(x, a);
      issue_rs_wide<C>(acc, a, kst);       // dQ += dS.K
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      // stage t & 1 is free (warpgroup 0's S of tile t is long done)
      if (tid < kWGThreads + 32 && t + 2 < n) load(t + 2);
    }
  }

  if (wg == 1) {
    const float one[2] = {1.f, 1.f};
    store_rows_ld<64, false>(
        dq + (size_t)bh * seq_q * D,
        *reinterpret_cast<const float(*)[C / 64][32]>(acc), one, q_start,
        col0, seq_q, D);
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

// ------------------------------------------------------------- launches
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

// bf16: 1 KB of slack, then 64-row Tile<kWC> tiles: 2 stages of 4 tiles
// (backward; dk/dv's lse and delta after them)
constexpr size_t dkdv_bf16_wide_smem() {
  return 1024 + (size_t)8 * 64 * kWC * 2 + 2 * 2 * kBQ * sizeof(float);
}
constexpr size_t dq_bf16_wide_smem() {
  return 1024 + (size_t)8 * 64 * kWC * 2;
}

// The forward's layouts above D = 256 (WideFwd): D = 384 and 512 one CTA
// of 2 warpgroups; up to 64 sub-tiles (D = 4096) a cluster of sub-tiles
// / 4 (rounded up) CTAs of one warpgroup, non-portable above 8.
constexpr int kWideFwdMaxSubs = 64;

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (BH, rows, D) bf16 operand: 64 x 64 boxes (64
// columns: one 128-byte swizzle row), rows past `rows` zero-filled.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int BH, int rows,
                     int D) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int NW, int SUBS, int KBUF>
cudaError_t launch_fwd_wide_plan(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int seq_q,
                                 int seq_k, int D, float sm_scale,
                                 int causal, cudaStream_t stream) {
  using P = WideFwd<NW, SUBS, KBUF>;
  auto kernel = fa_fwd_bf16_wide_kernel<NW, SUBS, KBUF>;
  const int ranks = (D / 64 + P::kSubs - 1) / P::kSubs;
  const size_t smem = P::kSmem;
  if ((ranks > 1) != P::kCluster) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = tile_map(&tq, q, BH, seq_q, D);
  if (e == cudaSuccess) e = tile_map(&tk, k, BH, seq_k, D);
  if (e == cudaSuccess) e = tile_map(&tv, v, BH, seq_k, D);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  if (ranks > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((seq_q + kBQ - 1) / kBQ * ranks),
                     (unsigned)BH);
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, static_cast<bf16*>(out),
                         static_cast<float*>(lse), seq_q, seq_k, D, sm_scale,
                         causal);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// bf16 above D = 256: S once a tile over the whole D, one lse row
cudaError_t launch_fwd_wide_bf16(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int seq_q,
                                 int seq_k, int D, float sm_scale, int causal,
                                 cudaStream_t stream) {
  const int nsub = D / 64;
  if (nsub > kWideFwdMaxSubs) return cudaErrorInvalidValue;
  if (nsub == 6)
    return launch_fwd_wide_plan<2, 3, 2>(q, k, v, out, lse, BH, seq_q, seq_k,
                                         D, sm_scale, causal, stream);
  if (nsub == 8)
    return launch_fwd_wide_plan<2, 4, 1>(q, k, v, out, lse, BH, seq_q, seq_k,
                                         D, sm_scale, causal, stream);
  return launch_fwd_wide_plan<1, 4, 1>(q, k, v, out, lse, BH, seq_q, seq_k, D,
                                       sm_scale, causal, stream);
}

// The backward at D = 2 C (384 or 512): dk/dv, then dq, each a grid of
// clusters of 2 CTAs, one cluster a 64-row tile
template <int C>
cudaError_t launch_bwd_cluster(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int BH, int seq_q, int seq_k,
                               float sm_scale, float do_scale,
                               float dv_scale, int ds_zero, int causal,
                               cudaStream_t stream) {
  using P = WideBwd<C>;
  constexpr int D = 2 * C;
  auto dkdv = fa_dkdv_bf16_cluster_kernel<C>;
  auto dqk = fa_dq_bf16_cluster_kernel<C>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = tile_map(&tq, q, BH, seq_q, D);
  if (e == cudaSuccess) e = tile_map(&tk, k, BH, seq_k, D);
  if (e == cudaSuccess) e = tile_map(&tv, v, BH, seq_k, D);
  if (e == cudaSuccess) e = tile_map(&tdo, dout, BH, seq_q, D);
  if (e == cudaSuccess) e = allow_smem(dkdv, P::kSmem);
  if (e == cudaSuccess) e = allow_smem(dqk, P::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((unsigned)((seq_k + kBK - 1) / kBK * 2), (unsigned)BH);
  e = cudaLaunchKernelEx(&cfg, dkdv, tq, tk, tv, tdo,
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                         seq_q, seq_k, sm_scale, do_scale, dv_scale, ds_zero,
                         causal);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)((seq_q + kBQ - 1) / kBQ * 2), (unsigned)BH);
  e = cudaLaunchKernelEx(&cfg, dqk, tq, tk, tv, tdo,
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<bf16*>(dq), seq_q, seq_k, sm_scale,
                         do_scale, ds_zero, causal);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// bf16 above D = 256 (wide_bwd_plan): at D = 384 and 512 the clusters,
// S and dP once a tile pair; above, one CTA a kWC-column slice
cudaError_t launch_bwd_wide_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, int BH, int seq_q, int seq_k,
                                 int D, float sm_scale, float do_scale,
                                 float dv_scale, int ds_zero, int causal,
                                 cudaStream_t stream) {
  if (D == 384)
    return launch_bwd_cluster<192>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                   seq_q, seq_k, sm_scale, do_scale,
                                   dv_scale, ds_zero, causal, stream);
  if (D == 512)
    return launch_bwd_cluster<256>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                   seq_q, seq_k, sm_scale, do_scale,
                                   dv_scale, ds_zero, causal, stream);
  const dim3 gk((seq_k + 63) / 64, BH, D / kWC);
  const dim3 gq((seq_q + 63) / 64, BH, D / kWC);
  cudaError_t e =
      allow_smem(fa_dkdv_bf16_wide_kernel, dkdv_bf16_wide_smem());
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
  fa_dq_bf16_wide_kernel<<<gq, kWGThreads, dq_bf16_wide_smem(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), seq_q, seq_k, D, sm_scale, do_scale, ds_zero,
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
// the tensor-core kernels, else the fp32 SIMT ones, which take every
// head dim the wrapper pads to up to kMaxF32Dim with one design (no
// earlier fp32 kernel is kept at any head dim).

// (out, lse) of the forward: one launch, one lse row of (BH, Sq) at
// every D (bf16 up to D = 4096, fp32 up to kMaxF32Dim).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int seq_q,
                               int seq_k, int D, float sm_scale, int causal,
                               int is_bf16, void* stream) {
  if (bad_shape(BH, seq_q, seq_k, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    F32Args a{};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.out = static_cast<float*>(out);
    a.lse_out = static_cast<float*>(lse);
    a.BH = BH;
    a.seq_q = seq_q;
    a.seq_k = seq_k;
    a.sm_scale = sm_scale;
    a.causal = causal;
    return (int)launch_fwd_f32(a, D, s);
  }
  if (wide(D))
    return (int)launch_fwd_wide_bf16(q, k, v, out, lse, BH, seq_q, seq_k, D,
                                     sm_scale, causal, s);
#define BIGDL_FA_FWD(DD)                                                   \
  return (int)launch_fwd_bf16<DD>(q, k, v, out, lse, BH, seq_q, seq_k,     \
                                  sm_scale, causal, s)
  if (D == 32) BIGDL_FA_FWD(32);
  if (D == 64) BIGDL_FA_FWD(64);
  if (D == 128) BIGDL_FA_FWD(128);
  BIGDL_FA_FWD(256);
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
  if (!is_bf16) {
    F32Args a{};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.dout = static_cast<const float*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.dq = static_cast<float*>(dq);
    a.dk = static_cast<float*>(dk);
    a.dv = static_cast<float*>(dv);
    a.BH = BH;
    a.seq_q = seq_q;
    a.seq_k = seq_k;
    a.sm_scale = sm_scale;
    a.do_scale = do_scale;
    a.dv_scale = dv_scale;
    a.ds_zero = ds_zero;
    a.causal = causal;
    return (int)launch_bwd_f32(a, D, s);
  }
  if (wide(D))
    return (int)launch_bwd_wide_bf16(q, k, v, dout, lse, delta, dq, dk, dv,
                                     BH, seq_q, seq_k, D, sm_scale, do_scale,
                                     dv_scale, ds_zero, causal, s);
#define BIGDL_FA_BWD(DD)                                                     \
  return (int)launch_bwd_bf16<DD>(q, k, v, dout, lse, delta, dq, dk, dv, BH, \
                                  seq_q, seq_k, sm_scale, do_scale, dv_scale, \
                                  ds_zero, causal, s)
  if (D == 32) BIGDL_FA_BWD(32);
  if (D == 64) BIGDL_FA_BWD(64);
  if (D == 128) BIGDL_FA_BWD(128);
  BIGDL_FA_BWD(256);
#undef BIGDL_FA_BWD
}

// Human-readable text for a cudaError_t an entry point returned.
extern "C" const char* bigdl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
