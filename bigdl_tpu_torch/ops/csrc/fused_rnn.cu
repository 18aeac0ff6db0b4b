// Persistent LSTM and GRU scans, forward and backward, for Hopper (sm_90a).
// The GRU kernels (K10/K11) follow the LSTM ones; their own note is at
// the GRU section below.
//
// Replaces the Pallas kernels of bigdl_tpu/ops/fused_rnn.py:
//   * lstm_fwd_mma_kernel<kMT, SAVE> (bf16) / lstm_fwd_simt_kernel<kWS,
//     SAVE> (fp32), SAVE=true <- _lstm_fwd_kernel (K6) and
//     _bilstm_fwd_kernel (K8); SAVE=false <- _lstm_fwd_infer_kernel and
//     _bilstm_fwd_infer_kernel (the no-residual variants);
//   * lstm_bwd_mma_kernel<kMT> (bf16) / lstm_bwd_simt_kernel<float>
//     (fp32), then rnn_dw_kernel<T>  <- _lstm_bwd_kernel (K7) and
//     _bilstm_bwd_kernel (K9).
// The step bodies are those of _lstm_fwd_dir / _lstm_bwd_dir /
// _lstm_gate_math. One launch runs one or two directions: the grid is
// (batch tiles, directions), and a direction with `reverse` set walks
// time from T-1 down to 0 while reading and writing the true-time slots,
// as the TPU kernels' mirrored index maps do. Nothing is flipped.
//
// Layout (the public (N, T, .) layout, no transposes): zx, gates, dzx
// (N, T, 4H); ys, c, dy (N, T, H); w (H, 4H) row-major, gates in the
// order i, f, g, o (the fp32 backward takes its transpose, (4H, H)); dw
// (H, 4H) fp32, summed over the batch. zx, w and every sequence share
// one dtype T (fp32 or bf16).
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
// rates both are a few to ~30 us of work. The real limit is the
// recurrence: T dependent steps, each a small (BN, H) x (H, 4H) product,
// so a step's latency, not the card's rate, sets the time.
// * The forward keeps a batch tile of kBlockN = 4 rows of one direction
//   for the whole sequence (tiles of 8 and 16 rows were slower: fewer
//   CTAs for the same per-step latency; PERF.md); rows never mix, so no
//   grid-wide barrier is needed. bf16: the step product h . W on the
//   tensor cores (mma.sync) with W in registers, each warp's four M tiles
//   the four gates of its units, so the gate math runs as the product's
//   epilogue with the c carry in registers; zx two steps ahead by a
//   per-thread cp.async plan; ys, c and the gates out in 16-byte pieces;
//   one barrier a step. fp32: SIMT, the tile's units split over a
//   cluster of 4 CTAs, each keeping its units' columns of W in shared
//   memory (out of the per-step L2 stream), a thread summing one unit's
//   four gates for the tile's rows over a quarter of K, the quarters
//   added across lanes in a fixed order, h sent into every peer's h tile
//   by st.async and awaited on an mbarrier (no cluster barrier a step).
// * The backward keeps the batch tile and takes the recipe of the GRU
//   backward (below): the bf16 step product on the tensor cores with W
//   in registers, each thread owning its (row, unit) pairs' dc carry and
//   running the gate-derivative chain as the product's epilogue,
//   residuals prefetched two steps ahead by a per-thread cp.async plan,
//   one barrier a step; fp32 keeps SIMT products with the same staging.
//   dW is a second kernel after the sweep: one GEMM over all (t, row)
//   pairs of a direction, reading the stored dzx and ys.
// * Every sum runs in a fixed order and dW has no atomics: two runs give
//   the same bits. Rows past N are masked, never read or written.

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

// sigmoid with a fast reciprocal (__fdividef: 2 ulps, no slow path to
// branch to; 0 where 1 + e^-x overflows): lets an epilogue's entries
// interleave. For the bf16 sweeps, whose results are rounded to bf16.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + expf(-x));
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
  const T* w;  // bf16: W (H, 4H) as stored; fp32: transposed, (4H, H)
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


// ------------------------------------------------------------ helpers
// Staging, tensor-core and copy-out pieces shared by the sweeps below.

constexpr int kMmaWarps = 8;  // warps of an mma.sync sweep (one K part)
constexpr int kMmaThreads = 32 * kMmaWarps;

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// elements a staged row of H takes: H rounded up to whole 16-byte pieces
template <typename T>
__host__ __device__ __forceinline__ int stage_row(int h) {
  constexpr int e = 16 / (int)sizeof(T);
  return (h + e - 1) / e * e;
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

// A step's staged copies, planned once per thread, for sweeps whose
// staged rows are whole numbers of 16-byte pieces: thread tid of nthr
// copies pieces tid, tid + nthr, ... (at most kMaxC) of a stage, and a
// step's copy is one cp.async a piece, from the piece's source advanced
// by t rows. `piece(c, src, rb, dst, prev)` describes piece c: its source
// at t = 0, the bytes a row of its tensor, its byte offset in a stage,
// and whether it is a neighbouring step's row (h_prev, c_prev), copied
// only where that step exists (zeros else).
template <int kMaxC>
struct CopyPlan {
  const char* src[kMaxC];
  int rb[kMaxC];
  uint32_t dst[kMaxC];
  unsigned prev = 0;  // bit k: piece k is a neighbouring step's row
  int n = 0;

  template <typename Piece>
  __device__ __forceinline__ void init(int total, int tid, int nthr,
                                       Piece piece) {
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) {
      const int c = tid + k * nthr;
      src[k] = nullptr;
      rb[k] = 0;
      dst[k] = 0;
      if (c >= total) continue;
      n = k + 1;
      bool pv = false;
      piece(c, src[k], rb[k], dst[k], pv);
      if (pv) prev |= 1u << k;
    }
  }

  // step t's pieces into the stage at shared address st; commits a group
  __device__ __forceinline__ void issue(uint32_t st, int t,
                                        bool prev_live) const {
#pragma unroll
    for (int k = 0; k < kMaxC; ++k)
      if (k < n) {
        const bool live = !(prev >> k & 1) || prev_live;
        sm90::cp_async16(st + dst[k],
                         src[k] + (live ? (ptrdiff_t)t * rb[k] : 0), live);
      }
    sm90::cp_async_commit();
  }
};

// 16-byte copies of a step's rows from a shared bf16 tile to a sequence
// (N, T, C), C % 8 == 0: thread tid of nthr copies pieces tid, tid +
// nthr, ... (at most kMaxC) of the tile's nr rows; piece e of row r sits
// at element off(r, e) of the tile.
template <int kMaxC>
struct OutPlan {
  int s[kMaxC];     // element offset in the tile (-1: none)
  uint4* g[kMaxC];  // the piece at t = 0
  int step = 0;     // pieces a time step

  template <typename Off>
  __device__ __forceinline__ void init(void* seq, int C, int nt, int n0,
                                       int nr, int tid, int nthr, Off off) {
    const int pr = C / 8;
    step = pr;
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) {
      const int c = tid + k * nthr, r = c / pr, e = c - r * pr;
      const bool on = c < nr * pr;
      s[k] = on ? off(r, e) : -1;
      g[k] = reinterpret_cast<uint4*>(seq) +
             (on ? (size_t)(n0 + r) * nt * pr + e : 0);
    }
  }

  __device__ __forceinline__ void copy(const unsigned short* tile,
                                       int t) const {
#pragma unroll
    for (int k = 0; k < kMaxC; ++k)
      if (s[k] >= 0)
        g[k][(size_t)t * step] =
            *reinterpret_cast<const uint4*>(tile + s[k]);
  }
};

// Element copies of a step's rows from a shared bf16 tile to a sequence
// (N, T, C), for rows that are not whole 16-byte pieces: element e of row
// r < nr sits at element off(r, e) of the tile.
template <typename Off>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* seq,
                                          const unsigned short* tile, int C,
                                          int nt, int n0, int nr, int t,
                                          int tid, int nthr, Off off) {
  for (int i = tid; i < nr * C; i += nthr) {
    const int r = i / C, e = i - r * C;
    seq[((size_t)(n0 + r) * nt + t) * C + e] =
        __ushort_as_bfloat16(tile[off(r, e)]);
  }
}

// rows of an mma.sync B tile in shared memory: the N = 8 of m16n8k16.
// Rows kBlockN .. 7 are never read (the products take them from 16 zero
// bytes); epilogue lanes that own no pair store there, so a step has no
// branch on ownership.
constexpr int kTileRows = 8;

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// The padded unit count of an mma.sync sweep: 128 where W stays resident
// in registers (H <= 128, fixed k-steps), else H rounded up to 16.
__host__ __device__ __forceinline__ int mma_hp(int h) {
  return h <= 16 * kMmaWarps ? 16 * kMmaWarps : (h + 15) / 16 * 16;
}

// An A fragment of mma.sync m16n8k16 (rows m0 .. m0 + 15, columns kb ..
// kb + 15), at(m, k) giving the bf16 bits of A's element (m, k).
template <typename At>
__device__ __forceinline__ void load_frag(uint32_t (&f)[4], int m0, int kb,
                                          At at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + 8 * (i & 1), k = kb + 2 * q + 8 * (i >> 1);
    f[i] = (uint32_t)at(m, k) | (uint32_t)at(m, k + 1) << 16;
  }
}

// This lane's ldmatrix address into a B tile of bf16 rows (the batch
// rows, K contiguous, `ld` elements a row), and the bytes it advances a
// pair of k-steps: matrix m = lane / 8 of a pair is k-step m / 2, columns
// 8 (m % 2) .. + 7, row lane % 8 — rows past the tile's kBlockN read the
// 16 zero bytes at `zero` and do not advance.
__device__ __forceinline__ uint2 b_lane(const unsigned short* tile, int ld,
                                        const void* zero) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, ri = lane & 7;
  if (ri >= kBlockN) return make_uint2(sm90::smem_u32(zero), 0u);
  return make_uint2(
      sm90::smem_u32(tile + ri * ld + 16 * (mi >> 1) + 8 * (mi & 1)), 64u);
}

// acc[n] = A_n . B for NT (1, 2 or 4) row tiles that share one B (K =
// 16 KS): A_n's fragments w[n] held in registers, B fragments read with
// ldmatrix from b = b_lane(...) (x: address, y: bytes a pair of k-steps).
// Four accumulator chains in all: k-step ks of tile n goes to chain ks %
// (4 / NT) of the tile's; a tile's chains are added in a fixed order.
template <int NT, int KS>
__device__ __forceinline__ void mma_res(float (&acc)[NT][4],
                                        const uint32_t (&w)[NT][KS][4],
                                        uint2 b) {
  constexpr int CH = 4 / NT;
  float c[NT][CH][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[n][x][j] = 0.f;
#pragma unroll
  for (int pk = 0; pk < KS / 2; ++pk) {
    uint32_t r4[4];
    sm90::ldmatrix_x4(r4, b.x + b.y * pk);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sm90::mma_bf16_16816(c[n][(2 * pk) % CH], w[n][2 * pk], r4[0], r4[1]);
      sm90::mma_bf16_16816(c[n][(2 * pk + 1) % CH], w[n][2 * pk + 1], r4[2],
                           r4[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[n][j] = CH == 4   ? (c[n][0][j] + c[n][1][j]) +
                                  (c[n][2 % CH][j] + c[n][3 % CH][j])
                  : CH == 2 ? c[n][0][j] + c[n][1 % CH][j]
                            : c[n][0][j];
}

// acc = A . B over ks_n k-steps with A's fragments streamed from device
// memory by load(f, ks) (the next k-step's loaded while the current one
// multiplies) and B read as 32-bit words from this lane's row `pb` of a
// shared B tile (null: a zero row past the tile's); k-step ks goes to
// accumulator chain ks % 8, the chains added in a fixed order (short
// chains: the tensor cores' fp32 accumulation truncates, and the long K
// of the H > 128 sweeps carried that into the gradients).
template <typename Load>
__device__ __forceinline__ void mma_stream(float (&acc)[4], int ks_n,
                                           const unsigned short* pb,
                                           Load load) {
  float c[8][4];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[x][j] = 0.f;
  auto bfrag = [&](int ks, uint32_t& b0, uint32_t& b1) {
    b0 = pb ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks) : 0u;
    b1 = pb ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks + 8) : 0u;
  };
  uint32_t fa[4], fb[4];
  load(fa, 0);
  for (int ks = 0; ks < ks_n; ks += 2) {
    uint32_t b0, b1;
    if (ks + 1 < ks_n) load(fb, ks + 1);
    bfrag(ks, b0, b1);
    sm90::mma_bf16_16816(c[ks & 7], fa, b0, b1);
    if (ks + 1 < ks_n) {
      if (ks + 2 < ks_n) load(fa, ks + 2);
      bfrag(ks + 1, b0, b1);
      sm90::mma_bf16_16816(c[(ks + 1) & 7], fb, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[j] = ((c[0][j] + c[1][j]) + (c[2][j] + c[3][j])) +
             ((c[4][j] + c[5][j]) + (c[6][j] + c[7][j]));
}

// ------------------------------------------------------- LSTM forward
// the row of the resident bf16 forward's staged W (4 x 128 units, padded
// so ldmatrix's 8 rows fall in distinct banks)
constexpr int kFwdWLd = 4 * 128 + 8;

// A bf16 forward step's inputs staged in shared memory: zx (4H) of the
// tile's kBlockN rows, each gate's H-run padded to lr = stage_row<T>(H)
// elements, so gate k of unit u of row r sits at (4 r + k) lr + u.
template <typename T>
__host__ __device__ __forceinline__ int lstm_fwd_stage_elems(int h) {
  return kBlockN * 4 * stage_row<T>(h);
}

// step t's zx rows n0 .. n0 + nr - 1 into `st` by plain loads and stores
// (rows that are not whole 16-byte pieces); commits an empty cp.async
// group. Out of line, so the sweep stays small.
template <typename T>
__device__ __noinline__ void lstm_fwd_stage(T* st, const FwdDir<T>& d,
                                            int H, int nt, int n0, int nr,
                                            int t, int tid, int nthr) {
  const int lr = stage_row<T>(H);
  for (int i = tid; i < nr * 4 * H; i += nthr) {
    const int r = i / (4 * H), e = i - r * 4 * H, k = e / H;
    st[(4 * r + k) * lr + e - k * H] =
        d.zx[((size_t)(n0 + r) * nt + t) * 4 * H + e];
  }
  sm90::cp_async_commit();
}

// the per-thread cp.async plan of lstm_fwd_stage's copies (H * sizeof(T)
// a multiple of 16, so lr == H and a row's zx is one contiguous run)
template <typename T, int kMaxC>
__device__ __forceinline__ void lstm_fwd_plan(CopyPlan<kMaxC>& plan,
                                              const FwdDir<T>& d, int H,
                                              int nt, int n0, int nr,
                                              int tid, int nthr) {
  const int pr = 4 * H * (int)sizeof(T) / 16;  // pieces a row of zx
  plan.init(nr * pr, tid, nthr,
            [&](int c, const char*& src, int& rb, uint32_t& dst, bool&) {
              const int r = c / pr;
              src = reinterpret_cast<const char*>(
                        d.zx + (size_t)(n0 + r) * nt * 4 * H) +
                    16 * (c - r * pr);
              rb = 4 * H * (int)sizeof(T);
              dst = 16 * (uint32_t)c;
            });
}

// step t's ys, c and the gates (save) from their tiles by element (rows
// that are not whole 16-byte pieces): unit u of row r at r ld + u of the
// h and c tiles, gate k of it at r ldg + k hp + u of the gate tile. Out
// of line, so the sweep stays small.
__device__ __noinline__ void lstm_fwd_copy_rows(
    const FwdDir<__nv_bfloat16>& d, const unsigned short* ho,
    const unsigned short* co, const unsigned short* go, int H, int hp,
    int nt, int n0, int nr, int t, bool save) {
  const int ld = hp + 8, ldg = 4 * hp + 8;
  auto row = [&](int r, int e) { return r * ld + e; };
  copy_rows(d.ys, ho, H, nt, n0, nr, t, threadIdx.x, kMmaThreads, row);
  if (save) {
    copy_rows(d.c, co, H, nt, n0, nr, t, threadIdx.x, kMmaThreads, row);
    copy_rows(d.g, go, 4 * H, nt, n0, nr, t, threadIdx.x, kMmaThreads,
              [&](int r, int e) { return r * ldg + e / H * hp + e % H; });
  }
}

// Forward, bf16, on the tensor cores. The step product z^T (4H, BN) =
// W^T (4H, H) . h^T (H, BN) is mma.sync m16n8k16 with M = the 4H gate
// columns, N = 8 batch rows (the tile's 4 rows and 4 zero rows), K = H,
// A = W read transposed (A[m][k] = W[k][m], zero past H), B = h rounded
// to bf16 in a double-buffered shared tile, so a step has one barrier.
// Warp w owns units 16 w .. 16 w + 15 (and 16 (w + 8 i) when streamed);
// its four M tiles are gates i, f, g, o of those units, so a lane's four
// accumulators hold all four pre-activations of units u, u + 8 of rows
// 2q, 2q + 1: the gate math is the product's epilogue, with the c carry
// in fp32 registers. Rows 4..7 (q >= 2) are B's zero rows, so those
// lanes take over unit u + 8 from lane q - 2 (one shuffle a gate and
// row) and every lane runs two real entries. kMT = 1 (H <= 128): A's
// fragments (4 tiles x 8 k-steps, 128 registers a thread) are loaded
// once, at kernel start, by ldmatrix.trans from a zero-padded copy of W
// staged in shared memory (gathering them from device memory left the
// prologue spilling); kMT = 4 (H <= 512): each warp takes unit groups
// warp, warp + 8, ... and streams their fragments from L2 (mma_stream, 8
// chains). zx is copied two steps ahead by a per-thread cp.async plan;
// ys leaves from the next h tile (which holds exactly its bf16 values),
// c and the gates (SAVE) from double-buffered out tiles, as 16-byte
// pieces when H % 8 == 0 and by element otherwise. Entries of units past
// the padded hp store into the tiles' unread rows 4..7, so the epilogue
// has no branch on ownership. Shared memory: 16 zero bytes, two h tiles
// and two c tiles (kTileRows, hp + 8), two gate tiles (kTileRows, 4 hp +
// 8, gate k of unit u at k hp + u), as bf16 bits; three zx stages; W's
// staging copy (kMT = 1).
template <int kMT, bool SAVE>
__global__ void __launch_bounds__(kMmaThreads, 1)
    lstm_fwd_mma_kernel(FwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int BN = kBlockN;
  constexpr bool kRes = kMT == 1;  // W resident: hp = 128, 8 k-steps
  const FwdDir<T> d = blockIdx.y == 1 ? a.d[1] : a.d[0];
  const int H = a.h, nt = a.t, lr = stage_row<T>(a.h);
  const int hp = mma_hp(H), ld = hp + 8, ldg = 4 * hp + 8;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int se = lstm_fwd_stage_elems<T>(H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* zero16 = reinterpret_cast<uint4*>(smem_raw);  // rows 4..7 of B
  unsigned short* hop = reinterpret_cast<unsigned short*>(zero16 + 1);
  unsigned short* cto = hop + 2 * kTileRows * ld;
  unsigned short* gto = cto + 2 * kTileRows * ld;
  T* stages = reinterpret_cast<T*>(gto + 2 * kTileRows * ldg);
  // resident W's staging copy (kRes): W zero-padded to (128, 4 x 128),
  // rows kFwdWLd elements apart
  unsigned short* wst = reinterpret_cast<unsigned short*>(stages + 3 * se);
  const unsigned short* w = reinterpret_cast<const unsigned short*>(d.w);
  // A of gate tile k: row m is unit m, column j is W's row j
  auto at_w = [&](int k, int m, int j) -> unsigned short {
    return m < H && j < H ? w[(size_t)j * 4 * H + k * H + m] : 0;
  };
  for (int i = threadIdx.x; i < 2 * kTileRows * ld; i += kMmaThreads)
    hop[i] = 0;
  if (threadIdx.x == 0) *zero16 = make_uint4(0, 0, 0, 0);
  const bool planned = H % 8 == 0;
  CopyPlan<kRes ? 1 : 4> plan;
  if (planned) lstm_fwd_plan(plan, d, H, nt, n0, nr, threadIdx.x, kMmaThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  auto time_of = [&](int s) { return d.reverse ? nt - 1 - s : s; };
  // sweep step s's zx into stage s % 3 (an empty group past the sweep)
  auto stage = [&](int s) {
    if (s >= nt) {
      sm90::cp_async_commit();
      return;
    }
    const int t = time_of(s);
    if (planned)
      plan.issue(st0 + (s % 3) * sb, t, true);
    else
      lstm_fwd_stage(stages + (s % 3) * se, d, H, nt, n0, nr, t, threadIdx.x,
                     kMmaThreads);
  };
  stage(0);
  stage(1);

  // resident W: the warp's 4 gate tiles, from the zero-padded staging copy
  // by ldmatrix.trans: matrix mi of lane l is W rows 16 ks + 8 (mi / 2) +
  // l % 8, units 16 warp + 8 (mi % 2) .. + 7 of the gate
  uint32_t wf[4][kRes ? 8 : 1][4];
  if constexpr (kRes) {
    const int cols = 4 * 128 / 8;  // 8-element pieces a staged row
    for (int i = threadIdx.x; i < 128 * cols; i += kMmaThreads) {
      const int j = i / cols, c = i - j * cols, k = c >> 4, u = 8 * (c & 15);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < H && u + 8 <= H && H % 8 == 0) {
        v = *reinterpret_cast<const uint4*>(w + (size_t)j * 4 * H + k * H +
                                            u);
      } else if (j < H) {
        unsigned short e[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          e[x] = u + x < H ? w[(size_t)j * 4 * H + k * H + u + x] : 0;
        v = *reinterpret_cast<const uint4*>(e);
      }
      *reinterpret_cast<uint4*>(wst + j * kFwdWLd + 8 * c) = v;
    }
    __syncthreads();
    const uint32_t wa = sm90::smem_u32(
        wst + ((lane & 7) + 8 * (lane >> 4)) * kFwdWLd + 16 * warp +
        8 * ((lane >> 3) & 1));
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        sm90::ldmatrix_x4_trans(wf[k][ks],
                                wa + 2 * (16 * ks * kFwdWLd + 128 * k));
  }
  // ys, c and the gates out of their tiles: in 16-byte pieces (piece e of
  // a gate row is gate e / (H / 8), units 8 (e % (H / 8)) ..) when H % 8
  // == 0, else by element
  OutPlan<1> out_ys, out_c;
  OutPlan<kRes ? 1 : 4> out_g;
  if (planned) {
    auto row = [&](int r, int e) { return r * ld + 8 * e; };
    out_ys.init(d.ys, H, nt, n0, nr, threadIdx.x, kMmaThreads, row);
    if (SAVE) {
      out_c.init(d.c, H, nt, n0, nr, threadIdx.x, kMmaThreads, row);
      out_g.init(d.g, 4 * H, nt, n0, nr, threadIdx.x, kMmaThreads,
                 [&](int r, int e) {
                   const int k = e / (H / 8);
                   return r * ldg + k * hp + 8 * (e - k * (H / 8));
                 });
    }
  }
  // step s's outputs, at time t: h in h tile (s + 1) % 2, c and the gates
  // in out tiles s % 2
  auto copy_out = [&](int s, int t) {
    const unsigned short* ho = hop + ((s + 1) & 1) * kTileRows * ld;
    const unsigned short* co = cto + (s & 1) * kTileRows * ld;
    const unsigned short* go = gto + (s & 1) * kTileRows * ldg;
    if (planned) {
      out_ys.copy(ho, t);
      if (SAVE) {
        out_c.copy(co, t);
        out_g.copy(go, t);
      }
    } else {
      lstm_fwd_copy_rows(d, ho, co, go, H, hp, nt, n0, nr, t, SAVE);
    }
  };

  // A lane's accumulators hold units u, u + 8 (u = 16 (warp + 8 i) + g)
  // of rows 2q, 2q + 1; rows 4..7 (q >= 2) are the zero rows of B. So
  // lanes q >= 2 take over unit u + 8 from lane q - 2 (a shuffle a gate
  // and row) and every lane runs two real entries: entry e of unit group
  // i is unit uo(i) = u + 8 (q >> 1) of row 2 (q & 1) + e. An entry
  // computes from in-range inputs (unit min(uo, H - 1)) and stores
  // without a branch: in place for a padded unit (< hp) — rows past nr
  // and units past H only feed product columns and W rows that nothing
  // reads — and into the tiles' unread rows 4..7 otherwise.
  auto uo = [&](int i) {
    return 16 * (warp + kMmaWarps * i) + g + 8 * (q >> 1);
  };
  auto dst = [&](int i, int e, int ldt) {
    const int u = uo(i);
    return (u < hp ? 2 * (q & 1) + e : 4 + 2 * (q & 1) + e) * ldt +
           (u < hp ? u : g);
  };
  float acc[kMT][4][4], cc[kMT][2];
  uint32_t xif[kMT][2], xgo[kMT][2];  // staged zx, two bf16 a register
#pragma unroll (kMT == 1 ? 2 : 1)
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) cc[i][e] = 0.f;
  auto load_in = [&](int s) {
    const unsigned short* st =
        reinterpret_cast<const unsigned short*>(stages + (s % 3) * se);
    auto two = [](unsigned short lo, unsigned short hi) {
      return (uint32_t)lo | (uint32_t)hi << 16;
    };
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned short* x =
            st + 4 * (2 * (q & 1) + e) * lr + min(uo(i), H - 1);
        xif[i][e] = two(x[0], x[lr]);
        xgo[i][e] = two(x[2 * lr], x[3 * lr]);
      }
  };
  auto lo = [](uint32_t x) { return __uint_as_float(x << 16); };
  auto hi = [](uint32_t x) { return __uint_as_float(x & 0xffff0000u); };
  // acc = the h tile o's h . W for this thread's entries, all four gates
  // (resident: one accumulator chain a gate tile, its 8 k-steps in order)
  auto product = [&](const unsigned short* o) {
    if constexpr (kRes) {
      mma_res<4, 8>(acc[0], wf, b_lane(o, ld, zero16));
    } else {
      const unsigned short* pb = g < BN ? o + g * ld + 2 * q : nullptr;
#pragma unroll 1
      for (int i = 0; i < kMT; ++i) {
        const int u0 = 16 * (warp + kMmaWarps * i);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
          if (u0 < hp)
            mma_stream(c4, hp / 16, pb, [&](uint32_t(&f)[4], int ks) {
              load_frag(f, u0, 16 * ks,
                        [&](int m, int j) { return at_w(k, m, j); });
            });
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][k][j] = c4[j];
        }
      }
    }
  };
  // sweep step s from acc and the staged zx: the entries' gates, c carry
  // and h into h tile (s + 1) % 2 and out tiles s % 2
  auto epilogue = [&](int s) {
    unsigned short* ho = hop + ((s + 1) & 1) * kTileRows * ld;
    unsigned short* co = cto + (s & 1) * kTileRows * ld;
    unsigned short* go = gto + (s & 1) * kTileRows * ldg;
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i) {
      float z[4][2];  // this lane's entries' pre-activations, gate k
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mine = acc[i][k][e], other = acc[i][k][2 + e];
          const float got =
              __shfl_xor_sync(0xffffffffu, q < 2 ? other : mine, 2);
          z[k][e] = q < 2 ? mine : got;
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gi = sigmoid_fast(lo(xif[i][e]) + z[0][e]);
        const float gf = sigmoid_fast(hi(xif[i][e]) + z[1][e]);
        const float gg = tanhf(lo(xgo[i][e]) + z[2][e]);
        const float gout = sigmoid_fast(hi(xgo[i][e]) + z[3][e]);
        const float c = gf * cc[i][e] + gi * gg;
        cc[i][e] = c;
        ho[dst(i, e, ld)] = bf16_bits(gout * tanhf(c));
        if (SAVE) {
          co[dst(i, e, ld)] = bf16_bits(c);
          unsigned short* p = go + dst(i, e, ldg);
          p[0] = bf16_bits(gi);
          p[hp] = bf16_bits(gf);
          p[2 * hp] = bf16_bits(gg);
          p[3 * hp] = bf16_bits(gout);
        }
      }
    }
  };

  // zx is read after the product, where the registers of its accumulator
  // chains are free (W takes 128 a thread)
  sm90::cp_async_wait<1>();
  __syncthreads();  // step 0's stage and the zeroed h tiles
  for (int s = 0; s < nt; ++s) {
    product(hop + (s & 1) * kTileRows * ld);
    load_in(s);
    epilogue(s);
    stage(s + 2);              // zx of step s + 2
    sm90::cp_async_wait<1>();  // zx of step s + 1
    __syncthreads();           // step s's h, c and gates in their tiles
    copy_out(s, time_of(s));
  }
}

// The fp32 forward splits a tile's units over a cluster of kFwdCluster
// CTAs; each CTA runs 4 threads a unit (the 4 K parts of its products).
constexpr int kFwdCluster = 4;

__host__ __device__ __forceinline__ int round4(int x) {
  return (x + 3) / 4 * 4;
}
// units a CTA of the fp32 forward owns, and its threads
__host__ __device__ __forceinline__ int fwd_units(int h) {
  return (h + kFwdCluster - 1) / kFwdCluster;
}
__host__ __device__ __forceinline__ int fwd_threads(int h) {
  return (4 * fwd_units(h) + 31) / 32 * 32;
}

// step t's zx of the CTA's units u0 .. u0 + us - 1 (rows n0 .. n0 + nr -
// 1) into `st` by plain loads and stores, gate k of unit u0 + v of row r
// at (4 r + k) lus + v; commits an empty cp.async group. Out of line.
__device__ __noinline__ void lstm_fwd_slice_stage(float* st,
                                                  const FwdDir<float>& d,
                                                  int H, int nt, int n0,
                                                  int nr, int u0, int us,
                                                  int t, int tid, int nthr) {
  const int lus = round4(us);
  for (int i = tid; i < nr * 4 * us; i += nthr) {
    const int rk = i / us, v = i - rk * us, r = rk / 4, k = rk - 4 * r;
    if (u0 + v < H)
      st[rk * lus + v] =
          d.zx[((size_t)(n0 + r) * nt + t) * 4 * H + k * H + u0 + v];
  }
  sm90::cp_async_commit();
}

// Forward, fp32: SIMT products, a tile's units split over a cluster of
// kFwdCluster CTAs. CTA rank r owns units r us .. (r + 1) us - 1 (us =
// fwd_units(H)) and, when kWS, keeps their columns of W in shared memory
// (ws (hq, us) as float4s: the 4 gates of a unit at W's row k), else
// reads them from L2 (H too large for the slice to fit). Quarter-warp p
// of warp w owns units 8 w .. 8 w + 7 of the slice for K part p: a
// thread sums the product terms k = 4 i + p of its unit's four gates for
// the tile's 4 rows (16 fp32 chains), the 4 parts are added by a
// reduce-scatter over the unit's 4 lanes (a fixed order that depends on H
// alone, so the bits do not depend on the cluster or where W lives), and
// part p is left with row p's four pre-activations: the gate math is
// register-local, the c carry of (row p, unit) in a register. The thread
// writes h (fp32) into every cluster CTA's next h tile with st.async,
// which completes 4 bytes on that CTA's mbarrier of the tile; a CTA
// starts a step once its mbarrier has all 16 H bytes of the last step's
// h, so the step needs no cluster barrier (a peer cannot refill a tile
// before this CTA's h of the step that reads it). ys, c and the gates are
// stored from registers; zx is copied two steps ahead (a per-thread
// cp.async plan when the slice's runs are 16-byte pieces) and published
// by the step's CTA barrier. Shared memory: two h tiles (hq, BN),
// hq = H rounded up to 4 (rows past H zero), three zx stages (BN, 4,
// round4(us)), then ws; the two mbarriers are static.
template <bool kWS, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_simt_kernel(FwdArgs<float> a) {
  constexpr int BN = kBlockN;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const FwdDir<float> d = blockIdx.y == 1 ? a.d[1] : a.d[0];
  const int H = a.h, H4 = 4 * a.h, nt = a.t, hq = round4(a.h);
  const int us = fwd_units(H), lus = round4(us), u0 = rank * us;
  const int n0 = (blockIdx.x / kFwdCluster) * BN;
  const int nr = min(BN, a.n - n0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  // lane v of quarter-warp p of warp w: unit 8 w + v, K part p (a
  // quarter-warp's W reads are 8 neighbouring units, one 128-byte row)
  const int p = (tid >> 3) & 3, uv = (tid & 7) + 8 * (tid >> 5);
  const int ul = min(uv, us - 1), u = u0 + ul;
  const bool own = uv < us && u < H;  // stores for (row p, u)
  const int uw = min(u, H - 1);
  const int se = BN * 4 * lus;
  extern __shared__ __align__(16) float smem[];
  float* hop = smem;
  float* stages = hop + 2 * hq * BN;
  float4* ws = reinterpret_cast<float4*>(stages + 3 * se);
  for (int i = tid; i < 2 * hq * BN; i += nthr) hop[i] = 0.f;
  // mbar[b]: the h of a step landing in h tile b, 16 H bytes from the
  // cluster's st.async stores; armed (one arrival and the bytes) before
  // each use by thread 0
  __shared__ __align__(8) unsigned long long mbar[2];
  const uint32_t mb0 = sm90::smem_u32(&mbar[0]);
  if (tid == 0) {
    sm90::mbarrier_init(mb0, 1);
    sm90::mbarrier_init(mb0 + 8, 1);
    sm90::fence_mbarrier_init();
    sm90::mbarrier_arrive_expect_tx(mb0, 16 * H);
    sm90::mbarrier_arrive_expect_tx(mb0 + 8, 16 * H);
  }
  if constexpr (kWS) {
    for (int i = tid; i < hq * us; i += nthr) {
      const int k = i / us, uu = u0 + i - k * us;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < H && uu < H) {
        const float* wr = d.w + (size_t)k * H4 + uu;
        x = make_float4(wr[0], wr[H], wr[2 * H], wr[3 * H]);
      }
      ws[i] = x;
    }
  }
  // zx of the slice: in 16-byte pieces when every run is whole pieces
  // (then us == H / 4 and u0 is a multiple of 4)
  const bool planned = H % 4 == 0 && us % 4 == 0;
  CopyPlan<1> plan;
  if (planned) {
    const int pr = us / 4;  // pieces a (row, gate) run
    plan.init(nr * 4 * pr, tid, nthr,
              [&](int c, const char*& src, int& rb, uint32_t& dst, bool&) {
                const int rk = c / pr, r = rk / 4, k = rk - 4 * r;
                src = reinterpret_cast<const char*>(
                          d.zx + (size_t)(n0 + r) * nt * H4 + k * H + u0) +
                      16 * (c - rk * pr);
                rb = H4 * (int)sizeof(float);
                dst = (uint32_t)(rk * lus) * sizeof(float) +
                      16 * (c - rk * pr);
              });
  }
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(float);
  auto time_of = [&](int s) { return d.reverse ? nt - 1 - s : s; };
  auto stage = [&](int s) {
    if (s >= nt) {
      sm90::cp_async_commit();
      return;
    }
    const int t = time_of(s);
    if (planned)
      plan.issue(st0 + (s % 3) * sb, t, true);
    else
      lstm_fwd_slice_stage(stages + (s % 3) * se, d, H, nt, n0, nr, u0, us,
                           t, tid, nthr);
  };
  stage(0);
  stage(1);
  sm90::cp_async_wait<1>();
  cluster.sync();  // every CTA's h tiles zeroed, ws and step 0's stage in

  float cv = 0.f;
  for (int s = 0; s < nt; ++s) {
    const int t = time_of(s);
    const float* hb = hop + (s & 1) * hq * BN;
    if (s > 0) {  // h of step s - 1 landed in tile s % 2; re-arm it
      sm90::mbarrier_wait(mb0 + 8 * (s & 1), ((s - 1) >> 1) & 1);
      if (tid == 0) sm90::mbarrier_arrive_expect_tx(mb0 + 8 * (s & 1), 16 * H);
    }
    float acc[4][BN];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < BN; ++r) acc[k][r] = 0.f;
#pragma unroll 4
    for (int k = p; k < hq; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hb + k * BN);
      float4 wv;
      if constexpr (kWS) {
        wv = ws[k * us + ul];
      } else {
        const float* wr = d.w + (size_t)min(k, H - 1) * H4 + uw;
        const bool live = k < H;
        wv = make_float4(live ? wr[0] : 0.f, live ? wr[H] : 0.f,
                         live ? wr[2 * H] : 0.f, live ? wr[3 * H] : 0.f);
      }
      const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
      const float hr[BN] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
        for (int r = 0; r < BN; ++r) acc[k4][r] += wk[k4] * hr[r];
    }
    // reduce-scatter over the unit's 4 lanes (v, 8 + v, 16 + v, 24 + v):
    // parts p and p ^ 2 swap the halves of the rows, then p and p ^ 1
    // the rows of the kept half; part p ends with row p's sums
    float z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float h2[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float keep = p & 2 ? acc[k][2 + x] : acc[k][x];
        const float send = p & 2 ? acc[k][x] : acc[k][2 + x];
        h2[x] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
      const float keep = p & 1 ? h2[1] : h2[0];
      const float send = p & 1 ? h2[0] : h2[1];
      z[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    const float* x = stages + (s % 3) * se + 4 * p * lus + ul;
    const float gi = sigmoid(x[0] + z[0]);
    const float gf = sigmoid(x[lus] + z[1]);
    const float gg = tanhf(x[2 * lus] + z[2]);
    const float go = sigmoid(x[3 * lus] + z[3]);
    cv = gf * cv + gi * gg;
    const float h = go * tanhf(cv);
    if (own && s + 1 < nt) {
      const uint32_t hn =
          sm90::smem_u32(hop + ((s + 1) & 1) * hq * BN + u * BN + p);
      const uint32_t bn = mb0 + 8 * ((s + 1) & 1);
#pragma unroll
      for (int r = 0; r < kFwdCluster; ++r)
        sm90::st_async(sm90::mapa(hn, r), h, sm90::mapa(bn, r));
    }
    if (own) {
      if (p < nr) {
        const size_t row = (size_t)(n0 + p) * nt + t;
        d.ys[row * H + u] = h;
        if (SAVE) {
          d.c[row * H + u] = cv;
          float* gr = d.g + row * H4 + u;
          gr[0] = gi;
          gr[H] = gf;
          gr[2 * H] = gg;
          gr[3 * H] = go;
        }
      }
    }
    stage(s + 2);              // zx of step s + 2, the slice's
    sm90::cp_async_wait<1>();  // zx of step s + 1, the slice's
    __syncthreads();           // ... for every thread; stage s % 3 free
  }
  cluster.sync();  // no CTA leaves while a peer may still signal it
}

// Groups the K terms of a SIMT product split over (fixed order).
__host__ __device__ __forceinline__ int dh_parts(int h) {
  return h <= kThreads / 4 ? 4 : (h <= kThreads / 2 ? 2 : 1);
}

// ------------------------------------------------------- LSTM backward
// A step's residuals staged in shared memory: rows g (4H), then c,
// c_prev and dy (H each) of the tile's kBlockN rows; each H-run padded
// to lr = stage_row<T>(H) elements, so gate k of unit u of row r sits at
// r * 4 lr + k lr + u, c at (4 BN + r) lr + u, c_prev at (5 BN + r) lr +
// u, dy at (6 BN + r) lr + u.
template <typename T>
__host__ __device__ __forceinline__ int lstm_stage_elems(int h) {
  return kBlockN * 7 * stage_row<T>(h);
}

// step t's residuals of rows n0 .. n0 + nr - 1 into `st` by plain loads
// and stores (rows that are not whole 16-byte pieces), c_prev zero where
// the direction has no previous step; commits an empty cp.async group so
// the callers' waits count alike. Out of line, so the sweeps stay small.
template <typename T>
__device__ __noinline__ void lstm_stage(T* st, const BwdDir<T>& d, int H,
                                        int nt, int n0, int nr, int t,
                                        int tid, int nthr) {
  const int lr = stage_row<T>(H), prev = d.reverse ? t + 1 : t - 1;
  const bool live = prev >= 0 && prev < nt;
  for (int i = tid; i < nr * 7 * H; i += nthr) {
    const int r = i / (7 * H), e = i - r * 7 * H;
    const size_t row = (size_t)(n0 + r) * nt + t;
    if (e < 4 * H) {
      const int k = e / H;
      st[r * 4 * lr + k * lr + e - k * H] = d.g[row * 4 * H + e];
    } else {
      const int w = (e - 4 * H) / H, u = e - 4 * H - w * H;
      const T v = w == 0   ? d.c[row * H + u]
                  : w == 2 ? d.dy[row * H + u]
                  : live   ? d.c[(row + prev - t) * H + u]
                           : from_f32<T>(0.f);
      st[((4 + w) * kBlockN + r) * lr + u] = v;
    }
  }
  sm90::cp_async_commit();
}

// the per-thread cp.async plan of lstm_stage's copies (H * sizeof(T) a
// multiple of 16, so lr == H)
template <typename T, int kMaxC>
__device__ __forceinline__ void lstm_bwd_plan(CopyPlan<kMaxC>& plan,
                                              const BwdDir<T>& d, int H,
                                              int nt, int n0, int nr,
                                              int tid, int nthr) {
  const int pr = H * (int)sizeof(T) / 16;  // pieces a row of H
  const ptrdiff_t shift = d.reverse ? H : -H;
  plan.init(nr * 7 * pr, tid, nthr,
            [&](int c, const char*& src, int& rb, uint32_t& dst, bool& pv) {
              const int r = c / (7 * pr), rest = c - r * 7 * pr;
              const size_t row0 = (size_t)(n0 + r) * nt;
              const T* base;
              int piece, elems;
              uint32_t off;
              if (rest < 4 * pr) {
                base = d.g + row0 * 4 * H;
                piece = rest;
                elems = 4 * H;
                off = r * 4 * H;
              } else {
                const int w = (rest - 4 * pr) / pr;
                piece = rest - 4 * pr - w * pr;
                base = w == 2 ? d.dy + row0 * H
                              : d.c + (ptrdiff_t)(row0 * H) +
                                    (w == 1 ? shift : 0);
                elems = H;
                off = ((4 + w) * kBlockN + r) * H;
                pv = w == 1;
              }
              src = reinterpret_cast<const char*>(base) + 16 * piece;
              rb = elems * (int)sizeof(T);
              dst = off * (uint32_t)sizeof(T) + 16 * piece;
            });
}

// Backward sweep, fp32: SIMT products (dz . W^T over W^T, one column a
// thread, the 4H terms split into dh_parts(H) ranges whose partial sums
// the next step's epilogue adds in order). Shared memory: dzs (4H, BN)
// dz, dcs (BN, H) the dc carry, red (parts, BN, H) the partial sums of
// dh, then two residual stages (step s + 1's copied while step s runs).
// Two barriers a step. dW follows as a separate GEMM (rnn_dw_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_simt_kernel(BwdArgs<T> a) {
  constexpr int BN = kBlockN;
  const BwdDir<T> d = blockIdx.y == 1 ? a.d[1] : a.d[0];
  const int H = a.h, H4 = 4 * a.h, nt = a.t, lr = stage_row<T>(a.h);
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int parts = dh_parts(H), se = lstm_stage_elems<T>(H);
  extern __shared__ __align__(16) float smem[];
  float* dzs = smem;
  float* dcs = dzs + H4 * BN;
  float* red = dcs + BN * H;
  T* stages = reinterpret_cast<T*>(red + parts * BN * H);
  for (int i = threadIdx.x; i < BN * H; i += kThreads) dcs[i] = 0.f;
  const bool planned = H * (int)sizeof(T) % 16 == 0;
  CopyPlan<7> plan;
  if (planned) lstm_bwd_plan(plan, d, H, nt, n0, nr, threadIdx.x, kThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  // forward direction: t = T-1-s, previous step t-1; reverse direction:
  // its time runs T-1 -> 0, so t = s, previous step t+1
  auto time_of = [&](int s) { return d.reverse ? s : nt - 1 - s; };
  auto stage = [&](int s) {
    if (s >= nt) {
      sm90::cp_async_commit();
      return;
    }
    const int t = time_of(s);
    if (planned)
      plan.issue(st0 + (s & 1) * sb, t, d.reverse ? t < nt - 1 : t > 0);
    else
      lstm_stage(stages + (s & 1) * se, d, H, nt, n0, nr, t, threadIdx.x,
                 kThreads);
  };
  stage(0);
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < nt; ++s) {
    const int t = time_of(s);
    const T* st = stages + (s & 1) * se;
    stage(s + 1);
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const T* gr = st + r * 4 * lr + u;
      const float gi = to_f32(gr[0]), gf = to_f32(gr[lr]);
      const float gg = to_f32(gr[2 * lr]), go = to_f32(gr[3 * lr]);
      const float c = to_f32(st[(4 * BN + r) * lr + u]);
      const float cp = to_f32(st[(5 * BN + r) * lr + u]);
      float carry = 0.f;
      if (s > 0) {
        carry = red[r * H + u];
        for (int q = 1; q < parts; ++q) carry += red[(q * BN + r) * H + u];
      }
      const float dh = to_f32(st[(6 * BN + r) * lr + u]) + carry;
      const float tc = tanhf(c);
      const float do_pre = dh * tc * go * (1.f - go);
      const float dc = dcs[r * H + u] + dh * go * (1.f - tc * tc);
      const float di_pre = dc * gg * gi * (1.f - gi);
      const float df_pre = dc * cp * gf * (1.f - gf);
      const float dg_pre = dc * gi * (1.f - gg * gg);
      T* dz = d.dzx + ((size_t)(n0 + r) * nt + t) * H4;
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
    sm90::cp_async_wait<0>();  // step s + 1's stage, published below
    __syncthreads();
    if (s + 1 < nt) {
      // dh carry = dz . W^T: column k of W^T per thread, the 4H terms
      // split into `parts` contiguous ranges
      const int per = kThreads / parts;
      const int part = threadIdx.x / per;
      const int span = H4 / parts;
      for (int k = threadIdx.x % per; k < H; k += per) {
        float acc[BN];
#pragma unroll
        for (int r = 0; r < BN; ++r) acc[r] = 0.f;
        const T* wcol = d.w + k;
#pragma unroll 4
        for (int j = part * span; j < (part + 1) * span; ++j)
          fma_rows<BN>(acc, dzs + j * BN, to_f32(wcol[(size_t)j * H]));
#pragma unroll
        for (int r = 0; r < BN; ++r) red[(part * BN + r) * H + k] = acc[r];
      }
      __syncthreads();
    }
  }
}

// Backward sweep, bf16, on the tensor cores. The step product dh^T (H,
// BN) = W (H, 4H) . dz^T (4H, BN) is mma.sync m16n8k16 with M = the H
// output units (16-unit tiles), N = 8 batch rows (the tile's 4 rows and
// 4 zero rows), K = 4H over [i | f | g | o] gate blocks each padded to
// hp = mma_hp(H) units (zero columns), A = W as stored (row-major, so
// K-major), B = dz rounded to bf16 in shared memory. A thread's
// accumulator holds units (u, u + 8) of rows (2q, 2q + 1): lanes with q <
// 2 own those 4 (row, unit) pairs for the whole sweep, keep their dc
// carry in registers and run the gate-derivative chain as the product's
// epilogue, writing the pair's four dz to the next B tile. The B tile is
// double-buffered, so a step has one barrier; dzx leaves the B tile
// (which holds exactly its bf16 values) as 16-byte pieces when H % 8 ==
// 0. kMT = 1 (H <= 128): W (64 K elements) stays in registers for the
// whole sweep, warp w holding the 32 k-steps of unit tile w (128
// registers a thread; PERF.md: the layouts measured). kMT = 4 (H <=
// 512): each warp takes unit tiles w, w + 8, ... and streams their
// fragments from L2. Shared memory: 16 zero bytes, two B tiles
// (kTileRows, 4 hp + 8) as bf16 bits (rows padded against bank
// conflicts), three residual stages (step s + 2's copied while step s
// runs).
template <int kMT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    lstm_bwd_mma_kernel(BwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int BN = kBlockN;
  constexpr bool kRes = kMT == 1;  // W resident: hp = 128, 32 k-steps
  const BwdDir<T> d = blockIdx.y == 1 ? a.d[1] : a.d[0];
  const int H = a.h, H4 = 4 * a.h, nt = a.t, lr = stage_row<T>(a.h);
  const int hp = mma_hp(H), ld = 4 * hp + 8;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int se = lstm_stage_elems<T>(H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* zero16 = reinterpret_cast<uint4*>(smem_raw);  // rows 4..7 of B
  unsigned short* op = reinterpret_cast<unsigned short*>(zero16 + 1);
  T* stages = reinterpret_cast<T*>(op + 2 * kTileRows * ld);
  const unsigned short* w = reinterpret_cast<const unsigned short*>(d.w);
  // A = W at padded column k (gate k / hp, unit k % hp)
  auto at_w = [&](int u, int k) -> unsigned short {
    const int gt = k / hp, v = k - gt * hp;
    return u < H && v < H ? w[(size_t)u * H4 + gt * H + v] : 0;
  };
  for (int i = threadIdx.x; i < 2 * kTileRows * ld; i += kMmaThreads)
    op[i] = 0;
  if (threadIdx.x == 0) *zero16 = make_uint4(0, 0, 0, 0);
  const bool planned = H % 8 == 0;
  CopyPlan<kRes ? 2 : 7> plan;
  if (planned) lstm_bwd_plan(plan, d, H, nt, n0, nr, threadIdx.x, kMmaThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  auto time_of = [&](int s) { return d.reverse ? s : nt - 1 - s; };
  // sweep step s's residuals into stage s % 3 (an empty group past the
  // sweep)
  auto stage = [&](int s) {
    if (s >= nt) {
      sm90::cp_async_commit();
      return;
    }
    const int t = time_of(s);
    if (planned)
      plan.issue(st0 + (s % 3) * sb, t, d.reverse ? t < nt - 1 : t > 0);
    else
      lstm_stage(stages + (s % 3) * se, d, H, nt, n0, nr, t, threadIdx.x,
                 kMmaThreads);
  };
  stage(0);
  stage(1);

  uint32_t wf[1][kRes ? 32 : 1][4];  // resident W: unit tile warp
  if constexpr (kRes) {
#pragma unroll
    for (int ks = 0; ks < 32; ++ks)
      load_frag(wf[0][ks], 16 * warp, 16 * ks, at_w);
  }
  // dzx from the B tile: in 16-byte pieces (piece e of a row is gate e /
  // (H / 8), units 8 (e % (H / 8)) ..) when H % 8 == 0, else by element
  OutPlan<kRes ? 1 : 4> out;
  if (planned)
    out.init(d.dzx, H4, nt, n0, nr, threadIdx.x, kMmaThreads,
             [&](int r, int e) {
               const int k = e / (H / 8);
               return r * ld + k * hp + 8 * (e - k * (H / 8));
             });
  auto copy_out = [&](const unsigned short* o, int t) {
    if (planned)
      out.copy(o, t);
    else
      copy_rows(d.dzx, o, H4, nt, n0, nr, t, threadIdx.x, kMmaThreads,
                [&](int r, int e) { return r * ld + e / H * hp + e % H; });
  };

  // The per-tile loops (i) run as straight-line code when W is resident
  // (one tile, whose entries then stay in registers) and as a loop when W
  // is streamed (the per-tile state in local memory, as in K11).
  // Entry j of unit tile i is unit 16 (warp + 8 i) + g + 8 (j >> 1) of row
  // 2 q + (j & 1). The epilogue runs for every entry, reading in-range
  // copies (row rc(j) = row mod 4, unit uc(i, j) capped at H - 1), and
  // stores without a branch: an entry of a real row (< 4) and padded unit
  // (< hp) stores in place — rows past nr and units past H only feed
  // product columns and W columns that nothing reads — and every other
  // entry stores into the tile's unread rows 4..7 (dst_row, dst_unit).
  auto rc = [&](int j) { return (2 * q + (j & 1)) & 3; };
  auto uc = [&](int i, int j) {
    return min(16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1), H - 1);
  };
  auto dst = [&](int i, int j) {
    const int u = 16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1);
    const bool real = q < 2 && u < hp;
    return (real ? 2 * q + (j & 1) : 4 + 2 * (q & 1) + (j & 1)) * ld +
           (real ? u : g);
  };
  float acc[kMT][4], dc[kMT][4];
  // an entry's staged inputs, two bf16 a register: (i, f), (g, o) gates,
  // (c, c_prev); dy as fp32
  uint32_t vif[kMT][4], vgo[kMT][4], vcc[kMT][4];
  float vy[kMT][4];
#pragma unroll (kMT == 1 ? 2 : 1)
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = dc[i][j] = 0.f;
  auto load_res = [&](int s) {
    const unsigned short* st =
        reinterpret_cast<const unsigned short*>(stages + (s % 3) * se);
    auto two = [](unsigned short lo, unsigned short hi) {
      return (uint32_t)lo | (uint32_t)hi << 16;
    };
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rc(j), u = uc(i, j);
        const unsigned short* gr = st + r * 4 * lr + u;
        vif[i][j] = two(gr[0], gr[lr]);
        vgo[i][j] = two(gr[2 * lr], gr[3 * lr]);
        vcc[i][j] = two(st[(4 * BN + r) * lr + u], st[(5 * BN + r) * lr + u]);
        vy[i][j] = __uint_as_float((uint32_t)st[(6 * BN + r) * lr + u] << 16);
      }
  };
  auto lo = [](uint32_t x) { return __uint_as_float(x << 16); };
  auto hi = [](uint32_t x) { return __uint_as_float(x & 0xffff0000u); };
  // sweep step s from the dh carry in acc: the entries' dz into the B
  // tile o
  auto epilogue = [&](unsigned short* o) {
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gi = lo(vif[i][j]), gf = hi(vif[i][j]);
        const float gg = lo(vgo[i][j]), go = hi(vgo[i][j]);
        const float dh = vy[i][j] + acc[i][j];
        const float tc = tanhf(lo(vcc[i][j]));
        const float do_pre = dh * tc * go * (1.f - go);
        const float dcv = dc[i][j] + dh * go * (1.f - tc * tc);
        const float di_pre = dcv * gg * gi * (1.f - gi);
        const float df_pre = dcv * hi(vcc[i][j]) * gf * (1.f - gf);
        const float dg_pre = dcv * gi * (1.f - gg * gg);
        dc[i][j] = dcv * gf;
        unsigned short* p = o + dst(i, j);
        p[0] = bf16_bits(di_pre);
        p[hp] = bf16_bits(df_pre);
        p[2 * hp] = bf16_bits(dg_pre);
        p[3 * hp] = bf16_bits(do_pre);
      }
  };
  // acc = the B tile o's dz . W^T for this thread's entries
  auto product = [&](const unsigned short* o) {
    if constexpr (kRes) {
      mma_res<1, 32>(acc, wf, b_lane(o, ld, zero16));
    } else {
      const unsigned short* pb = g < BN ? o + g * ld + 2 * q : nullptr;
#pragma unroll (kMT == 1 ? 2 : 1)
      for (int i = 0; i < kMT; ++i) {
        const int u0 = 16 * (warp + kMmaWarps * i);
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        if (u0 < hp)
          mma_stream(c4, hp / 4, pb, [&](uint32_t(&f)[4], int ks) {
            load_frag(f, u0, 16 * ks, at_w);
          });
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = c4[j];
      }
    }
  };

  // the residuals are read after the product, where the registers of its
  // accumulator chains are free (W takes 128 a thread)
  sm90::cp_async_wait<1>();
  __syncthreads();  // step 0's stage and the zeroed tiles
  for (int s = 0; s < nt; ++s) {
    unsigned short* o = op + (s & 1) * kTileRows * ld;
    load_res(s);
    epilogue(o);
    stage(s + 2);
    sm90::cp_async_wait<1>();  // step s + 1's stage
    __syncthreads();           // o holds step s's dz; the stage landed
    copy_out(o, time_of(s));
    if (s + 1 < nt) product(o);
  }
}

size_t lstm_fwd_mma_smem(int h) {
  const int hp = mma_hp(h);
  const bool resident = h <= 16 * kMmaWarps;
  return 16 + ((size_t)2 * kTileRows * (2 * (hp + 8) + 4 * hp + 8) +
               3 * (size_t)lstm_fwd_stage_elems<__nv_bfloat16>(h) +
               (resident ? (size_t)128 * kFwdWLd : 0)) *
                  sizeof(__nv_bfloat16);
}

// the fp32 forward's shared memory, with (ws) or without W's slice
size_t lstm_fwd_simt_smem(int h, bool ws) {
  const int hq = round4(h), us = fwd_units(h);
  return ((size_t)2 * hq * kBlockN + 3 * (size_t)kBlockN * 4 * round4(us)) *
             sizeof(float) +
         (ws ? (size_t)hq * us * sizeof(float4) : 0);
}

// The forward over ndir directions: bf16 on the tensor cores (W resident
// in registers when H rounded up to 16 is at most 128, streamed from L2
// above), fp32 SIMT over a cluster of kFwdCluster CTAs a tile (W's slice
// in shared memory where it fits).
template <bool SAVE>
cudaError_t launch_fwd(const FwdArgs<__nv_bfloat16>& a, int ndir,
                       cudaStream_t s) {
  const dim3 grid((a.n + kBlockN - 1) / kBlockN, ndir);
  const size_t smem = lstm_fwd_mma_smem(a.h);
  cudaError_t e;
  if (a.h <= 16 * kMmaWarps) {
    if ((e = set_smem(lstm_fwd_mma_kernel<1, SAVE>, smem)) != cudaSuccess)
      return e;
    lstm_fwd_mma_kernel<1, SAVE><<<grid, kMmaThreads, smem, s>>>(a);
  } else {
    if ((e = set_smem(lstm_fwd_mma_kernel<4, SAVE>, smem)) != cudaSuccess)
      return e;
    lstm_fwd_mma_kernel<4, SAVE><<<grid, kMmaThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool SAVE>
cudaError_t launch_fwd(const FwdArgs<float>& a, int ndir, cudaStream_t s) {
  const bool ws = lstm_fwd_simt_smem(a.h, true) <= (size_t)kMaxSmem;
  const size_t smem = lstm_fwd_simt_smem(a.h, ws);
  auto kernel =
      ws ? lstm_fwd_simt_kernel<true, SAVE> : lstm_fwd_simt_kernel<false, SAVE>;
  cudaError_t e;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)((a.n + kBlockN - 1) / kBlockN * kFwdCluster),
                     (unsigned)ndir);
  cfg.blockDim = dim3((unsigned)fwd_threads(a.h));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFwdCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return e;
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
  return save ? launch_fwd<true>(a, ndir, s) : launch_fwd<false>(a, ndir, s);
}

// ------------------------------------------------------------------ GRU
// Persistent GRU scan, one direction a launch (BiRecurrent runs one
// launch per direction on time-flipped input, as the JAX package does):
//   * gru_fwd_mma_kernel<kMT, SAVE> (bf16) / gru_fwd_simt_kernel<float,
//     SAVE> (fp32), SAVE=true  <- _gru_fwd_kernel (K10), SAVE=false <-
//     _gru_fwd_infer_kernel;
//   * gru_bwd_mma_kernel<kMT> (bf16) / gru_bwd_simt_kernel<float> (fp32),
//     then rnn_dw_kernel<T>     <- _gru_bwd_kernel (K11).
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
// (r h) . W_c reads it. Every kernel keeps the batch tile (kBlockN rows a
// CTA, no grid-wide barrier) and the no-atomics, fixed-order rule. The
// bf16 kernels put the step products on the tensor cores with W held in
// registers, each thread owning its (row, unit) pairs' carries, and take
// each step's loads off its critical path (inputs or residuals staged
// ahead with cp.async); the fp32 kernels keep SIMT products
// (rows_times_w: one column per thread, the K terms split over up to 4
// thread groups and the partial sums added in a fixed order) with the
// same staging. The backward computes dW after the sweep as one GEMM over
// all (t, row) pairs.

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

// A forward step's inputs staged in shared memory: rows zg (2H: z then
// r) and zc (H) of the tile's kBlockN rows, each H-run padded to lr =
// stage_row<T>(H) elements: z of unit u of row r at r * 2 lr + u, r at r
// * 2 lr + lr + u, zc at (2 BN + r) lr + u.
template <typename T>
__host__ __device__ __forceinline__ int gru_fwd_stage_elems(int h) {
  return kBlockN * 3 * stage_row<T>(h);
}

// step t's inputs into `st` by plain loads and stores (rows that are not
// whole 16-byte pieces); commits an empty cp.async group. Out of line.
template <typename T>
__device__ __noinline__ void gru_fwd_stage(T* st, const GruFwdArgs<T>& a,
                                           int n0, int nr, int t, int tid,
                                           int nthr) {
  const int H = a.h, lr = stage_row<T>(a.h);
  for (int i = tid; i < nr * 3 * H; i += nthr) {
    const int r = i / (3 * H), e = i - r * 3 * H;
    const size_t row = (size_t)(n0 + r) * a.t + t;
    if (e < 2 * H)
      st[r * 2 * lr + (e < H ? e : lr + e - H)] = a.zg[row * 2 * H + e];
    else
      st[(2 * kBlockN + r) * lr + e - 2 * H] = a.zc[row * H + e - 2 * H];
  }
  sm90::cp_async_commit();
}

// the per-thread cp.async plan of gru_fwd_stage's copies (lr == H)
template <typename T, int kMaxC>
__device__ __forceinline__ void gru_fwd_plan(CopyPlan<kMaxC>& plan,
                                             const GruFwdArgs<T>& a, int n0,
                                             int nr, int tid, int nthr) {
  const int H = a.h, pr = a.h * (int)sizeof(T) / 16;
  plan.init(nr * 3 * pr, tid, nthr,
            [&](int c, const char*& src, int& rb, uint32_t& dst, bool&) {
              const int r = c / (3 * pr), rest = c - r * 3 * pr;
              const size_t row0 = (size_t)(n0 + r) * a.t;
              const bool gates = rest < 2 * pr;
              const int piece = gates ? rest : rest - 2 * pr;
              src = reinterpret_cast<const char*>(
                        gates ? a.zg + row0 * 2 * H : a.zc + row0 * H) +
                    16 * piece;
              rb = (gates ? 2 * H : H) * (int)sizeof(T);
              dst = (gates ? r * 2 * H : (2 * kBlockN + r) * H) *
                        (uint32_t)sizeof(T) +
                    16 * piece;
            });
}

// Forward, fp32: SIMT products (rows_times_w: W_g, W_c from L2). Shared
// memory: hs (BN, H) the h carry, hop (H, BN) h, zrs (BN, 2H) h . W_g
// and then the activated z, r; rhop (H, BN) r * h, cs (BN, H) (r h) .
// W_c; red the split sums; then two input stages (step t + 1's copied
// while step t runs), so zg and zc are off the steps' critical path.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
    gru_fwd_simt_kernel(GruFwdArgs<T> a) {
  constexpr int BN = kBlockN;
  const int H = a.h, H2 = 2 * a.h, nt = a.t, lr = stage_row<T>(a.h);
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int se = gru_fwd_stage_elems<T>(H);
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* hop = hs + BN * H;
  float* zrs = hop + H * BN;
  float* rhop = zrs + BN * H2;
  float* cs = rhop + H * BN;
  float* red = cs + BN * H;
  T* stages = reinterpret_cast<T*>(red + kThreads * BN);
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    hs[i] = 0.f;
    hop[i] = 0.f;
    rhop[i] = 0.f;
  }
  const bool planned = H * (int)sizeof(T) % 16 == 0;
  CopyPlan<3> plan;
  if (planned) gru_fwd_plan(plan, a, n0, nr, threadIdx.x, kThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  auto stage = [&](int t) {
    if (t >= nt)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t & 1) * sb, t, true);
    else
      gru_fwd_stage(stages + (t & 1) * se, a, n0, nr, t, threadIdx.x,
                    kThreads);
  };
  stage(0);
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const T* st = stages + (t & 1) * se;
    stage(t + 1);
    rows_times_w<T>(zrs, nullptr, hop, a.wg, H, H2, red);
    // z and r, and the second product's operand r * h
    for (int p = threadIdx.x; p < nr * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const size_t row = (size_t)(n0 + r) * nt + t;
      const float z = sigmoid(to_f32(st[r * 2 * lr + u]) + zrs[r * H2 + u]);
      const float rg =
          sigmoid(to_f32(st[r * 2 * lr + lr + u]) + zrs[r * H2 + H + u]);
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
      const float cand =
          tanhf(to_f32(st[(2 * BN + r) * lr + u]) + cs[r * H + u]);
      const float z = zrs[r * H2 + u];
      const float h = (1.f - z) * hs[r * H + u] + z * cand;
      hs[r * H + u] = h;
      hop[u * BN + r] = round_to<T>(h);
      a.ys[row * H + u] = from_f32<T>(h);
      if (SAVE) a.cand[row * H + u] = from_f32<T>(cand);
    }
    sm90::cp_async_wait<0>();  // step t + 1's stage, published below
    __syncthreads();
  }
}

// Forward, bf16, on the tensor cores. Two dependent products a step, both
// mma.sync m16n8k16 with N = 8 batch rows (the tile's 4 and 4 zero rows)
// and B the h or r * h operand rounded to bf16 in shared memory:
//   1. zr^T (2H, BN) = W_g^T . h^T, K = H. W_g's columns are taken so that
//      16-row tile p holds z (rows 0-7) and r (rows 8-15) of units 8p ..
//      8p + 7: a lane's (u, u + 8) accumulator then holds z_u and r_u of
//      its rows (2q, 2q + 1), and r h is formed in registers;
//   2. cand^T (H, BN) = W_c^T . (r h)^T, K = H: one warp owns product 1's
//      tiles 2j, 2j + 1 and product 2's tile j (units 16j .. 16j + 15),
//      so the update h = (1 - z) h + z cand is register-local.
// Lanes with q < 2 own their (row, unit) pairs' h carry (fp32) for the
// whole sweep. A fragments are W_g / W_c read transposed (A[m][k] =
// W[k][m]) once, at kernel start, when the units padded to hp = mma_hp(H)
// are 128 (kMT = 1: W_g 64 and W_c 32 registers a thread); above, each
// warp takes unit groups j = warp, warp + 8, ... (kMT = 4) and streams
// the fragments from L2. Units past H (the padding) are zero rows and
// columns. Two barriers a step; zg and zc copied two steps ahead by a
// per-thread cp.async plan; ys (from the h operand tile, which holds
// exactly its bf16 values), and zr and cand when SAVE (from out tiles),
// leave as 16-byte pieces when H % 8 == 0. Shared memory: 16 zero bytes,
// op1 / op2 (kTileRows, hp + 8) the h / r h operands as bf16 bits, zro
// (kTileRows, 2H) and cno (kTileRows, H) the stored zr and cand, three
// input stages.
template <int kMT, bool SAVE>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gru_fwd_mma_kernel(GruFwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int BN = kBlockN;
  constexpr bool kRes = kMT == 1;
  const int H = a.h, H2 = 2 * a.h, nt = a.t, lr = stage_row<T>(a.h);
  const int hp = mma_hp(H), ld = hp + 8;
  const int n0 = blockIdx.x * BN;
  const int nr = min(BN, a.n - n0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int se = gru_fwd_stage_elems<T>(H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* zero16 = reinterpret_cast<uint4*>(smem_raw);  // rows 4..7 of B
  unsigned short* op1 = reinterpret_cast<unsigned short*>(zero16 + 1);
  unsigned short* op2 = op1 + kTileRows * ld;
  unsigned short* zro = op2 + kTileRows * ld;
  unsigned short* cno = zro + kTileRows * H2;
  T* stages = reinterpret_cast<T*>(cno + kTileRows * H);
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(a.wg);
  const unsigned short* wc = reinterpret_cast<const unsigned short*>(a.wc);
  // A of product 1: row m of tile m / 16 is gate (m / 8) % 2 of unit 8
  // (m / 16) + m % 8
  auto at_g = [&](int m, int k) -> unsigned short {
    const int u = 8 * (m >> 4) + (m & 7);
    return u < H && k < H ? wg[(size_t)k * H2 + ((m >> 3) & 1) * H + u] : 0;
  };
  auto at_c = [&](int m, int k) -> unsigned short {
    return m < H && k < H ? wc[(size_t)k * H + m] : 0;
  };
  for (int i = threadIdx.x; i < 2 * kTileRows * ld; i += kMmaThreads)
    op1[i] = 0;
  if (threadIdx.x == 0) *zero16 = make_uint4(0, 0, 0, 0);
  const bool planned = H % 8 == 0;
  CopyPlan<kRes ? 1 : 3> plan;
  if (planned) gru_fwd_plan(plan, a, n0, nr, threadIdx.x, kMmaThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  auto stage = [&](int t) {
    if (t >= nt)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t % 3) * sb, t, true);
    else
      gru_fwd_stage(stages + (t % 3) * se, a, n0, nr, t, threadIdx.x,
                    kMmaThreads);
  };
  stage(0);
  stage(1);

  uint32_t fg[2][kRes ? 8 : 1][4], fc[1][kRes ? 8 : 1][4];  // resident W
  if constexpr (kRes) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      load_frag(fg[0][ks], 32 * warp, 16 * ks, at_g);
      load_frag(fg[1][ks], 32 * warp + 16, 16 * ks, at_g);
      load_frag(fc[0][ks], 16 * warp, 16 * ks, at_c);
    }
  }
  // ys from op1, zr and cand from zro / cno: in 16-byte pieces when H %
  // 8 == 0, else by element
  OutPlan<1> out_ys, out_cand;
  OutPlan<kRes ? 1 : 2> out_zr;
  if (planned) {
    out_ys.init(a.ys, H, nt, n0, nr, threadIdx.x, kMmaThreads,
                [&](int r, int e) { return r * ld + 8 * e; });
    if (SAVE) {
      out_zr.init(a.zr, H2, nt, n0, nr, threadIdx.x, kMmaThreads,
                  [&](int r, int e) { return r * H2 + 8 * e; });
      out_cand.init(a.cand, H, nt, n0, nr, threadIdx.x, kMmaThreads,
                    [&](int r, int e) { return r * H + 8 * e; });
    }
  }
  auto copy_out = [&](const auto& plan, const unsigned short* tile, T* seq,
                      int C, int ldt, int t) {
    if (planned)
      plan.copy(tile, t);
    else
      copy_rows(seq, tile, C, nt, n0, nr, t, threadIdx.x, kMmaThreads,
                [&](int r, int e) { return r * ldt + e; });
  };

  // The per-tile loops (i) run as straight-line code when W is resident
  // (one tile, whose entries then stay in registers) and as a loop when W
  // is streamed (the per-tile state in local memory, as in K11).
  // Entry j of unit group i is unit 16 (warp + 8 i) + g + 8 (j >> 1) of
  // row 2 q + (j & 1); every entry computes from in-range copies (row
  // rc(j), unit uc(i, j)) and stores without a branch, as the LSTM
  // sweep's: at its place in a real row (< 4) where its unit is < lim
  // (hp for the operand tiles, whose padded units meet zero W rows; H for
  // zro / cno), else in the tiles' unread rows 4..7.
  auto rc = [&](int j) { return (2 * q + (j & 1)) & 3; };
  auto uc = [&](int i, int j) {
    return min(16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1), H - 1);
  };
  auto dst = [&](int i, int j, int lim, int ldt) {
    const int u = 16 * (warp + kMmaWarps * i) + g + 8 * (j >> 1);
    const bool real = q < 2 && u < lim;
    return (real ? 2 * q + (j & 1) : 4 + 2 * (q & 1) + (j & 1)) * ldt +
           (real ? u : 0);
  };
  float h[kMT][4], z[kMT][4], acc1[kMT][2][4], acc2[kMT][4];
  float xz[kMT][4], xr[kMT][4], xc[kMT][4];  // staged inputs
#pragma unroll (kMT == 1 ? 2 : 1)
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
  auto load_in = [&](int t) {
    const T* st = stages + (t % 3) * se;
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rc(j), u = uc(i, j);
        xz[i][j] = to_f32(st[r * 2 * lr + u]);
        xr[i][j] = to_f32(st[r * 2 * lr + lr + u]);
        xc[i][j] = to_f32(st[(2 * BN + r) * lr + u]);
      }
  };
  const unsigned short* pb1 = g < BN ? op1 + g * ld + 2 * q : nullptr;
  const unsigned short* pb2 = g < BN ? op2 + g * ld + 2 * q : nullptr;
  auto product1 = [&]() {
    if constexpr (kRes) {
      mma_res<2, 8>(acc1[0], fg, b_lane(op1, ld, zero16));
    } else {
#pragma unroll (kMT == 1 ? 2 : 1)
      for (int i = 0; i < kMT; ++i) {
        const int p0 = 2 * (warp + kMmaWarps * i);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
          if (8 * (p0 + x) < hp)
            mma_stream(c4, hp / 16, pb1, [&](uint32_t(&f)[4], int ks) {
              load_frag(f, 16 * (p0 + x), 16 * ks, at_g);
            });
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[i][x][j] = c4[j];
        }
      }
    }
  };
  auto product2 = [&]() {
    if constexpr (kRes) {
      float c[1][4];
      mma_res<1, 8>(c, fc, b_lane(op2, ld, zero16));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[0][j] = c[0][j];
    } else {
#pragma unroll (kMT == 1 ? 2 : 1)
      for (int i = 0; i < kMT; ++i) {
        const int u0 = 16 * (warp + kMmaWarps * i);
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        if (u0 < hp)
          mma_stream(c4, hp / 16, pb2, [&](uint32_t(&f)[4], int ks) {
            load_frag(f, u0, 16 * ks, at_c);
          });
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = c4[j];
      }
    }
  };

  sm90::cp_async_wait<1>();
  __syncthreads();  // step 0's stage and the zeroed tiles
  load_in(0);
  for (int t = 0; t < nt; ++t) {
    product1();
    // z and r, and the second product's operand r * h
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float zv = sigmoid_fast(xz[i][j] + acc1[i][j >> 1][j & 1]);
        const float rg =
            sigmoid_fast(xr[i][j] + acc1[i][j >> 1][2 + (j & 1)]);
        z[i][j] = zv;
        op2[dst(i, j, hp, ld)] = bf16_bits(rg * h[i][j]);
        if (SAVE) {
          unsigned short* o = zro + dst(i, j, H, H2);
          o[0] = bf16_bits(zv);
          o[H] = bf16_bits(rg);
        }
      }
    __syncthreads();  // op2 holds r h; zro step t's zr
    if (SAVE) copy_out(out_zr, zro, a.zr, H2, H2, t);
    product2();
    // candidate, carry and stores
#pragma unroll (kMT == 1 ? 2 : 1)
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cand = tanhf(xc[i][j] + acc2[i][j]);
        const float zv = z[i][j];
        const float hv = (1.f - zv) * h[i][j] + zv * cand;
        h[i][j] = hv;
        op1[dst(i, j, hp, ld)] = bf16_bits(hv);
        if (SAVE) cno[dst(i, j, H, H)] = bf16_bits(cand);
      }
    stage(t + 2);
    sm90::cp_async_wait<1>();  // step t + 1's stage
    __syncthreads();           // op1 holds h; cno step t's cand
    copy_out(out_ys, op1, a.ys, H, ld, t);
    if (SAVE) copy_out(out_cand, cno, a.cand, H, H, t);
    if (t + 1 < nt) load_in(t + 1);
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

// The same copies as gru_stage, planned once per thread (H * sizeof(T) %
// 16 == 0): a step's copy is one cp.async a piece; h_prev (ys at t - 1)
// is not copied at t = 0. Otherwise the sweeps call gru_stage.
template <typename T, int kMaxC>
__device__ __forceinline__ void gru_bwd_plan(CopyPlan<kMaxC>& plan,
                                             const GruBwdArgs<T>& a, int n0,
                                             int nr, int tid, int nthr) {
  const int H = a.h, hs = gru_row(a.h);
  const int pr = H * (int)sizeof(T) / 16;  // pieces a row of H
  plan.init(nr * 5 * pr, tid, nthr,  // zr rows count twice
            [&](int c, const char*& src, int& rb, uint32_t& dst, bool& pv) {
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
              src = reinterpret_cast<const char*>(base) + 16 * piece;
              rb = elems * (int)sizeof(T);
              dst = off * (uint32_t)sizeof(T) + 16 * piece;
              pv = which == 2;
            });
}

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
  CopyPlan<5> plan;
  if (planned) gru_bwd_plan(plan, a, n0, nr, threadIdx.x, kThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = gru_stage_elems(H) * (uint32_t)sizeof(T);
  auto stage = [&](int t) {
    if (t < 0)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t & 1) * sb, t, t > 0);
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
template <int kMT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gru_bwd_mma_kernel(GruBwdArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int BN = kBlockN;
  constexpr bool kRes = kMT == 1;  // W resident: hp = 128, fixed k-steps
  const int H = a.h, H2 = 2 * a.h, nt = a.t, hs = gru_row(a.h);
  const int hp = mma_hp(H);
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
  // A = W_c / W_g as stored at padded column k; W_g's K runs over [z
  // units | r units], each half padded to hp
  auto at_c = [&](int u, int k) -> unsigned short {
    return u < H && k < H ? wc[(size_t)u * H + k] : 0;
  };
  auto at_g = [&](int u, int k) -> unsigned short {
    const int v = k < hp ? k : k - hp;
    return u < H && v < H ? wg[(size_t)u * H2 + (k < hp ? 0 : H) + v] : 0;
  };
  for (int i = threadIdx.x; i < BN * (ld1 + ld2); i += kMmaThreads)
    op1[i] = 0;
  if (threadIdx.x == 0) *zero16 = make_uint4(0, 0, 0, 0);
  const bool planned = H * (int)sizeof(T) % 16 == 0;
  CopyPlan<kRes ? 2 : 5> plan;
  if (planned) gru_bwd_plan(plan, a, n0, nr, threadIdx.x, kMmaThreads);
  const uint32_t st0 = sm90::smem_u32(stages);
  const uint32_t sb = se * (uint32_t)sizeof(T);
  // step t's residuals into stage t % 3 (t >= 0; an empty group else)
  auto stage = [&](int t) {
    if (t < 0)
      sm90::cp_async_commit();
    else if (planned)
      plan.issue(st0 + (t % 3) * sb, t, t > 0);
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
      load_frag(fc[ks], 16 * warp, 16 * ks, at_c);
#pragma unroll
    for (int ks = 0; ks < 16; ++ks)
      load_frag(fg[ks], 16 * warp, 16 * ks, at_g);
  }

  // acc[i] = W rows of tile warp + 8 i times the operand op (ld): with W
  // resident, all 8 (W_c) or 16 (W_g) k-steps, every B fragment loaded
  // first, the k-steps in 4 accumulator chains (k-step ks in chain
  // ks % 4); streamed, hp / 16 or 2 hp / 16 k-steps through mma_stream.
  // The chains are added in a fixed order.
  auto product = [&](float (&acc)[kMT][4], const unsigned short* op, int ld,
                     auto gates) {
    constexpr bool kG = decltype(gates)::value;
#pragma unroll 1
    for (int i = 0; i < kMT; ++i) {
      const int u0 = 16 * (warp + kMmaWarps * i);
      if constexpr (kRes) {
        float c[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[x][j] = 0.f;
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
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = (c[0][j] + c[1][j]) + (c[2][j] + c[3][j]);
      } else {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        if (u0 < hp)
          mma_stream(c4, (kG ? 2 * hp : hp) / 16,
                     g < BN ? op + g * ld + 2 * q : nullptr,
                     [&](uint32_t(&f)[4], int ks) {
                       if constexpr (kG)
                         load_frag(f, u0, 16 * ks, at_g);
                       else
                         load_frag(f, u0, 16 * ks, at_c);
                     });
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = c4[j];
      }
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

// ----------------------------------------------------------------- dW
// dW after a sweep, one GEMM over all N * T (t, row) pairs m of each job:
//   dW (H, C) = sum_m op[m]^T . dz[m],
// op[m] = hs at the pair's neighbouring step t + shift (shift -1: h_prev
// of a forward sweep, zero at t = 0; +1: of a reverse one, zero at t = T
// - 1), times r[m] and rounded to T when the job has r. The LSTM
// backward's jobs are its directions (dW = sum h_prev^T . dzx); the GRU
// backward's are dW_g (h_prev, dzg) and dW_c (r h_prev, dzc): the
// operands and rounding points of the Pallas kernels' dW tails. A CTA
// owns a 64 x 64 tile of one dW and a contiguous range of pairs; the
// `splits` CTAs of a tile form a cluster, and after a cluster barrier
// rank r sums slice r of the tile over every rank's partial in rank
// order (distributed shared memory) and writes it: no atomics, no
// scratch in device memory. Pairs stream through a kDwStages ring of
// kDwPairs pairs (op, r, dz tiles; r * op formed in place by the thread
// that copied them). bf16: mma.sync m16n8k16 (A = the operand tile, B =
// dz, both read with ldmatrix.trans), each of 4 warps 16 units x 64
// columns; fp32: SIMT, a thread 8 units x 4 columns.
constexpr int kDwTile = 64;
constexpr int kDwPairs = 64;
constexpr int kDwStages = 3;
constexpr int kDwThreads = 128;
constexpr int kDwMaxSplits = 16;  // a non-portable cluster size

template <typename T>
struct DwJob {
  const T* hs;  // (N, T, H)
  const T* rs;  // r: element (m, k) at rs[m * rld + k], or null
  const T* dz;  // (N, T, C)
  float* dw;    // (H, C)
  int c, shift, rld;
};

template <typename T>
struct DwArgs {
  DwJob<T> job[2];
  int njobs, n, t, h;
};

template <typename T>
struct DwGeo {
  static constexpr int kEPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int kCPR = kDwTile / kEPC;       // chunks a tile row
  static constexpr int kLd = kDwTile + kEPC;        // padded row
  static constexpr int kTile = kDwPairs * kLd;
  static constexpr int kStage = 3 * kTile;  // op (then r op), r, dz
};

__host__ __device__ __forceinline__ int dw_tiles(int h, int c) {
  return ((h + kDwTile - 1) / kDwTile) * ((c + kDwTile - 1) / kDwTile);
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    rnn_dw_kernel(DwArgs<T> a, int splits, int span) {
  using G = DwGeo<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int H = a.h, nt = a.t, M = a.n * a.t;
  const int tiles_k = (H + kDwTile - 1) / kDwTile;
  int tile = blockIdx.x / splits;
  const bool second = tile >= dw_tiles(H, a.job[0].c);
  const DwJob<T> jb = second ? a.job[1] : a.job[0];
  if (second) tile -= dw_tiles(H, a.job[0].c);
  const int k0 = (tile % tiles_k) * kDwTile;
  const int j0 = (tile / tiles_k) * kDwTile;
  const int C = jb.c;
  const bool rh = jb.rs != nullptr;
  const int edge = jb.shift < 0 ? 0 : nt - 1;  // the step without a neighbour
  const int m0 = rank * span, m1 = min(m0 + span, M);
  const int nst = (m1 - m0 + kDwPairs - 1) / kDwPairs;
  const bool vec = H % G::kEPC == 0;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(ring + kDwStages * G::kStage);

  // copy stage s (pairs m0 + s * kDwPairs ...); out-of-range pairs,
  // units and columns, and op at the edge step, are zeros
  auto issue = [&](int s) {
    if (s < nst) {
      T* st = ring + (s % kDwStages) * G::kStage;
      for (int i = tid; i < kDwPairs * G::kCPR; i += kDwThreads) {
        const int p = i / G::kCPR, c = i % G::kCPR;
        const int m = m0 + s * kDwPairs + p;
        const int k = k0 + c * G::kEPC, j = j0 + c * G::kEPC;
        const int o = p * G::kLd + c * G::kEPC;
        const bool live = m < m1 && m % nt != edge;
        if (vec) {
          sm90::cp_async16(
              sm90::smem_u32(st + o),
              jb.hs + (live && k < H ? (size_t)(m + jb.shift) * H + k : 0),
              live && k < H);
          if (rh)
            sm90::cp_async16(
                sm90::smem_u32(st + G::kTile + o),
                jb.rs + (live && k < H ? (size_t)m * jb.rld + k : 0),
                live && k < H);
          const bool dv = m < m1 && j + G::kEPC <= C;
          sm90::cp_async16(sm90::smem_u32(st + 2 * G::kTile + o),
                           jb.dz + (dv ? (size_t)m * C + j : 0), dv);
        } else {
#pragma unroll
          for (int e = 0; e < G::kEPC; ++e) {
            float h = 0.f;
            if (live && k + e < H) {
              h = to_f32(jb.hs[(size_t)(m + jb.shift) * H + k + e]);
              if (rh)
                h = round_to<T>(to_f32(jb.rs[(size_t)m * jb.rld + k + e]) *
                                h);
            }
            st[o + e] = from_f32<T>(h);
            st[2 * G::kTile + o + e] =
                m < m1 && j + e < C ? jb.dz[(size_t)m * C + j + e]
                                    : from_f32<T>(0.f);
          }
        }
      }
    }
    sm90::cp_async_commit();
  };
  // r * op, rounded to T, over the op chunks this thread copied
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
  float* dw = jb.dw;
  for (int e = rank * kDwThreads + tid; e < kDwTile * kDwTile;
       e += splits * kDwThreads) {
    float v = 0.f;
    for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(part, r)[e];
    const int k = k0 + e / kDwTile, j = j0 + e % kDwTile;
    if (k < H && j < C) dw[(size_t)k * C + j] = v;
  }
  cluster.sync();  // no rank leaves while others read its partial
}

size_t gru_fwd_simt_smem(int h) {
  return ((size_t)6 * kBlockN * h + kThreads * kBlockN) * sizeof(float) +
         2 * (size_t)gru_fwd_stage_elems<float>(h) * sizeof(float);
}

size_t gru_fwd_mma_smem(int h) {
  return 16 + ((size_t)2 * kTileRows * (mma_hp(h) + 8) + 3 * kTileRows * h +
               3 * (size_t)gru_fwd_stage_elems<__nv_bfloat16>(h)) *
                  sizeof(__nv_bfloat16);
}

size_t gru_bwd_simt_smem(int h) {
  return ((size_t)7 * kBlockN * h + kThreads * kBlockN +
          2 * (size_t)gru_stage_elems(h)) *
         sizeof(float);
}

size_t gru_bwd_mma_smem(int h) {
  const int hp = mma_hp(h);
  return 16 + ((size_t)kBlockN * (3 * hp + 16) +
               3 * (size_t)gru_stage_elems(h)) *
                  sizeof(__nv_bfloat16);
}

size_t lstm_bwd_simt_smem(int h) {
  return ((size_t)4 * h * kBlockN + kBlockN * h +
          (size_t)dh_parts(h) * kBlockN * h +
          2 * (size_t)lstm_stage_elems<float>(h)) *
         sizeof(float);
}

size_t lstm_bwd_mma_smem(int h) {
  return 16 + (size_t)2 * kTileRows * (4 * mma_hp(h) + 8) * 2 +
         3 * (size_t)lstm_stage_elems<__nv_bfloat16>(h) * 2;
}

template <typename T>
size_t dw_smem() {
  return sizeof(T) * kDwStages * DwGeo<T>::kStage +
         sizeof(float) * kDwTile * kDwTile;
}

// Whether a cluster of kDwMaxSplits dW CTAs fits on this card: the
// largest `splits` a dW launch may take (kDwMaxSplits, else the portable
// 8), or a negative CUDA error.
template <typename T>
int dw_max_splits() {
  cudaError_t e;
  if ((e = set_smem(rnn_dw_kernel<T>, dw_smem<T>())) != cudaSuccess ||
      (e = cudaFuncSetAttribute(
           rnn_dw_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
           1)) != cudaSuccess)
    return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(kDwMaxSplits);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = dw_smem<T>();
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kDwMaxSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const bool ok = cudaOccupancyMaxActiveClusters(&n, rnn_dw_kernel<T>,
                                                 &cfg) == cudaSuccess;
  cudaGetLastError();  // a refused query leaves no error behind
  return ok && n >= 1 ? kDwMaxSplits : 8;
}

// How a dW launch splits each job's N * T pairs: `splits` CTAs a tile
// (one cluster), rank r taking pairs [r span, (r + 1) span). The caller
// plans it (ops/fused_rnn.py dw_split_plan) from the pair count and
// dw_max_splits alone.
struct DwSplit {
  int splits, span;
};

// The dW GEMM of a's jobs on stream s, split as sp says.
template <typename T>
cudaError_t launch_dw(const DwArgs<T>& a, DwSplit sp, cudaStream_t s) {
  const long long m = (long long)a.n * a.t;
  if (sp.splits < 1 || sp.splits > kDwMaxSplits || sp.span < 1 ||
      sp.span % kDwPairs || (long long)(sp.splits - 1) * sp.span >= m ||
      (long long)sp.splits * sp.span < m)
    return cudaErrorInvalidValue;
  const size_t smem = dw_smem<T>();
  cudaError_t e;
  if ((e = set_smem(rnn_dw_kernel<T>, smem)) != cudaSuccess) return e;
  if (sp.splits > 8 &&
      (e = cudaFuncSetAttribute(
           rnn_dw_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
           1)) != cudaSuccess)
    return e;
  int tiles = 0;
  for (int j = 0; j < a.njobs; ++j) tiles += dw_tiles(a.h, a.job[j].c);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(sp.splits * tiles));
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)sp.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, rnn_dw_kernel<T>, a, sp.splits,
                              sp.span)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

// The LSTM backward over ndir directions: the sweep (fp32: SIMT; bf16:
// mma.sync, W resident in registers when H rounded up to 16 is at most
// 128, streamed from L2 above), then one dW GEMM over both directions,
// on one stream.
template <typename T>
cudaError_t launch_lstm_bwd(const BwdArgs<T>& a, int ndir, DwSplit sp,
                            cudaStream_t s) {
  const dim3 grid((a.n + kBlockN - 1) / kBlockN, ndir);
  cudaError_t e;
  if constexpr (sizeof(T) == 4) {
    const size_t smem = lstm_bwd_simt_smem(a.h);
    if ((e = set_smem(lstm_bwd_simt_kernel<T>, smem)) != cudaSuccess)
      return e;
    lstm_bwd_simt_kernel<T><<<grid, kThreads, smem, s>>>(a);
  } else if (a.h <= 16 * kMmaWarps) {
    const size_t smem = lstm_bwd_mma_smem(a.h);
    if ((e = set_smem(lstm_bwd_mma_kernel<1>, smem)) != cudaSuccess)
      return e;
    lstm_bwd_mma_kernel<1><<<grid, kMmaThreads, smem, s>>>(a);
  } else {
    const size_t smem = lstm_bwd_mma_smem(a.h);
    if ((e = set_smem(lstm_bwd_mma_kernel<4>, smem)) != cudaSuccess)
      return e;
    lstm_bwd_mma_kernel<4><<<grid, kMmaThreads, smem, s>>>(a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  DwArgs<T> dw;
  for (int i = 0; i < 2; ++i) {
    const BwdDir<T>& d = a.d[i];
    dw.job[i] = DwJob<T>{d.ys, nullptr, d.dzx, d.dw, 4 * a.h,
                         d.reverse ? 1 : -1, 0};
  }
  dw.njobs = ndir;
  dw.n = a.n;
  dw.t = a.t;
  dw.h = a.h;
  return launch_dw(dw, sp, s);
}

template <typename T, bool SAVE>
cudaError_t launch_gru_fwd(GruFwdArgs<T> a, cudaStream_t s) {
  const int tiles = (a.n + kBlockN - 1) / kBlockN;
  cudaError_t e;
  if constexpr (sizeof(T) == 4) {
    const size_t smem = gru_fwd_simt_smem(a.h);
    if ((e = set_smem(gru_fwd_simt_kernel<T, SAVE>, smem)) != cudaSuccess)
      return e;
    gru_fwd_simt_kernel<T, SAVE><<<tiles, kThreads, smem, s>>>(a);
  } else {
    const size_t smem = gru_fwd_mma_smem(a.h);
    if (a.h <= 16 * kMmaWarps) {
      if ((e = set_smem(gru_fwd_mma_kernel<1, SAVE>, smem)) != cudaSuccess)
        return e;
      gru_fwd_mma_kernel<1, SAVE><<<tiles, kMmaThreads, smem, s>>>(a);
    } else {
      if ((e = set_smem(gru_fwd_mma_kernel<4, SAVE>, smem)) != cudaSuccess)
        return e;
      gru_fwd_mma_kernel<4, SAVE><<<tiles, kMmaThreads, smem, s>>>(a);
    }
  }
  return cudaGetLastError();
}

// The GRU backward: the sweep (fp32: SIMT; bf16: mma.sync, W resident in
// registers when H rounded up to 16 is at most 128, streamed from L2
// above), then the dW GEMM, on one stream.
template <typename T>
cudaError_t launch_gru_bwd(GruBwdArgs<T> a, DwSplit sp, cudaStream_t s) {
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
  DwArgs<T> dw;
  dw.job[0] = DwJob<T>{a.ys, nullptr, a.dzg, a.dwg, 2 * a.h, -1, 0};
  dw.job[1] = DwJob<T>{a.ys, a.zr + a.h, a.dzc, a.dwc, a.h, -1, 2 * a.h};
  dw.njobs = 2;
  dw.n = a.n;
  dw.t = a.t;
  dw.h = a.h;
  return launch_dw(dw, sp, s);
}

template <typename T>
cudaError_t bwd_typed(const void* const* w, const void* const* ys,
                      const void* const* c, const void* const* g,
                      const void* const* dy, void* const* dzx,
                      void* const* dw, const int* rev, int ndir, int n,
                      int t, int h, DwSplit sp, cudaStream_t s) {
  BwdArgs<T> a;
  for (int i = 0; i < 2; ++i) {
    const int k = i < ndir ? i : 0;
    a.d[i] = BwdDir<T>{static_cast<const T*>(w[k]),
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
  return launch_lstm_bwd<T>(a, ndir, sp, s);
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
                          int t, int h, DwSplit sp, cudaStream_t s) {
  const GruBwdArgs<T> a{
      static_cast<const T*>(wg),  static_cast<const T*>(wc),
      static_cast<const T*>(ys),  static_cast<const T*>(zr),
      static_cast<const T*>(cand), static_cast<const T*>(dy),
      static_cast<T*>(dzg),       static_cast<T*>(dzc),
      static_cast<float*>(dwg),   static_cast<float*>(dwc),
      n, t, h};
  return launch_gru_bwd<T>(a, sp, s);
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

// The backward over one or two directions: dzx, and each direction's
// fp32 dW (H, 4H), summed, in dw; two launches (the sweep over both
// directions, then the dW GEMM) on `stream`. w: W as stored for bf16 (the
// tensor-core products read it K-major), transposed for fp32 (the SIMT
// products read one column per thread). dw_splits, dw_span: the dW
// GEMM's split of the N * T pairs (DwSplit).
extern "C" int bigdl_lstm_bwd(const void* w0, const void* w1,
                              const void* ys0, const void* ys1,
                              const void* c0, const void* c1,
                              const void* g0, const void* g1,
                              const void* dy0, const void* dy1, void* dzx0,
                              void* dzx1, void* dw0, void* dw1, int rev0,
                              int rev1, int ndir, int n, int t, int h,
                              int dw_splits, int dw_span, int is_bf16,
                              void* stream) {
  if (bad_shape(ndir, n, t, h)) return (int)cudaErrorInvalidValue;
  const void* w[2] = {w0, w1};
  const void* ys[2] = {ys0, ys1};
  const void* c[2] = {c0, c1};
  const void* g[2] = {g0, g1};
  const void* dy[2] = {dy0, dy1};
  void* dzx[2] = {dzx0, dzx1};
  void* dw[2] = {dw0, dw1};
  const int rev[2] = {rev0, rev1};
  const DwSplit sp{dw_splits, dw_span};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)bwd_typed<__nv_bfloat16>(w, ys, c, g, dy, dzx, dw, rev,
                                         ndir, n, t, h, sp, s);
  return (int)bwd_typed<float>(w, ys, c, g, dy, dzx, dw, rev, ndir, n, t, h,
                               sp, s);
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
// SIMT products read one column per thread, coalesced). dw_splits,
// dw_span: the dW GEMM's split of the N * T pairs (DwSplit).
extern "C" int bigdl_gru_bwd(const void* wg, const void* wc, const void* ys,
                             const void* zr, const void* cand, const void* dy,
                             void* dzg, void* dzc, void* dwg, void* dwc, int n,
                             int t, int h, int dw_splits, int dw_span,
                             int is_bf16, void* stream) {
  if (bad_shape(1, n, t, h)) return (int)cudaErrorInvalidValue;
  const DwSplit sp{dw_splits, dw_span};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)gru_bwd_typed<__nv_bfloat16>(wg, wc, ys, zr, cand, dy, dzg,
                                             dzc, dwg, dwc, n, t, h, sp, s);
  return (int)gru_bwd_typed<float>(wg, wc, ys, zr, cand, dy, dzg, dzc, dwg,
                                   dwc, n, t, h, sp, s);
}

// The largest dW split this card takes (dw_max_splits), or a negative
// CUDA error.
extern "C" int bigdl_dw_max_splits(int is_bf16) {
  return is_bf16 ? dw_max_splits<__nv_bfloat16>() : dw_max_splits<float>();
}

extern "C" const char* bigdl_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
