// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel bigdl_tpu/ops/paged_decode.py::_pd_kernel
// (launched by _paged_decode_pallas). For each row b and head h:
//
//   out[b,h] = softmax_j(mask_j(q . k_j * sm_scale)) . v
//
// over the full table extent S = nb * bs of row b's blocks, key j living
// in pool block table[b, j / bs] at offset j % bs. Keys with j > pos[b]
// are masked AFTER the dot and their value rows contribute exactly 0 —
// the conventions of the plain version (ops/kv_cache.py
// paged_attention). The kernel reads only keys j <= pos[b]: it never
// touches the scratch block, a page past the clock, or a poisoned former
// occupant's rows past the clock inside the last page (those rows are
// zero-filled in shared memory, never read).
//
// Inputs: q (B, H, 1, d) fp32; k/v pools (N, H, bs, d) fp32 or bf16,
// loaded to fp32; table (B, nb) int32 and pos (B,) int32 on the device;
// out (B, H, 1, d) fp32. Table entries must lie in [0, N): the engine's
// block allocator guarantees it, and the kernel does not check.
//
// Head dims: the kernel is instantiated at tiers D (8, 16, the
// multiples of 32 to 256, then 384, 512, 768 and 1024) and takes any
// head dim d <= D at run time, the pools read where they lie, at their
// own row stride d: nothing is padded or copied on a step. Shared memory
// and registers are laid out at D; columns past d are zeros (zero-filled
// copies, a zero q), which add exact zeros to every dot and weighted
// row, and only d columns are written. When a row of d elements is whole
// 16-byte chunks (and the pools start on 16 bytes), K and V rows stream
// as 16-byte cp.async copies, chunks past d zero-filled; otherwise (a
// bf16 row of d = 20 is 40 bytes, so every other row starts 8 bytes off
// a 16-byte boundary) each element is copied on its own, with plain
// loads and shared-memory stores. Above the largest tier the row-split
// kernel of "D > 1024" below (a cluster split like the tiers', each row
// over a whole CTA) takes the head dims up to 8192 (fp32) or 16384
// (bf16).
//
// What bounds it: HBM bytes. Each (b, h) reads its visible K and V rows
// once and does 4 flops per element read, far below the card's
// flop/byte balance. At the 43M serving shape (B=8, H=8, D=64, S=592)
// the visible rows of a wave's clocks are ~10 MB a launch in fp32, ~3 us
// at 3.35 TB/s, and the decode path makes 8 launches a step. At that
// size the time is latency: few dependent rounds of loads, not bytes.
//
// Design:
// * S is split over a thread-block cluster: each (b, h) gets `splits`
//   CTAs (<= 8, the portable cluster size), CTA `rank` taking the
//   contiguous keys [rank * span, (rank + 1) * span). The plan
//   (ops/paged_decode.py split_plan) depends on the table extent only,
//   never on B or the clocks, so a row's bits do not depend on its
//   co-batch. At the serving shape: 8 CTAs of 80 keys, 512 CTAs in all;
// * a CTA stages its slice of the table row in shared memory (loaded
//   beside its clock and q), then streams its visible keys through a kStages ring of (kSK keys of K,
//   kSK of V) with 16-byte cp.async copies, copying only rows j <= pos;
// * keys are read from shared memory as 16-byte vectors by groups of kG
//   threads (several keys per warp per instruction); each group keeps an
//   online softmax (running max m, sum l and weighted V row) over its
//   keys, one pass over K and V, no score array;
// * the groups combine in index order inside the CTA, then rank 0 reads
//   every rank's (m, l, acc[D]) through distributed shared memory after
//   a cluster barrier (all ranks' loads issued together), combines them
//   in rank order and writes out. A CTA with no
//   visible key contributes m = -inf, l = 0 and nothing else. One launch
//   a call, no atomics, no global scratch: bitwise reproducible.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;  // portable cluster size

// How a key row of D elements of T is read: kC 16-byte chunks a row
// (1 for a bf16 row of D = 8), kG threads a key (the largest power of two
// <= 32 dividing kC: 1 or 2 threads a key at D = 8 and 16), kCPT
// chunks a thread; kP groups a CTA, each taking kKPG keys a stage of kSK
// keys. Mirrored by ops/paged_decode.py `_stage_keys`.
template <typename T, int D>
struct Geo {
  static constexpr int kC = D * (int)sizeof(T) / 16;
  static constexpr int kG = kC % 32 == 0 ? 32
                            : kC % 16 == 0 ? 16
                            : kC % 8 == 0  ? 8
                            : kC % 4 == 0  ? 4
                            : kC % 2 == 0  ? 2
                                           : 1;
  static constexpr int kCPT = kC / kG;
  static constexpr int kEPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int kE = kCPT * kEPC;             // elements a thread
  static constexpr int kP = kThreads / kG;
  static constexpr int kKPG = kCPT <= 2 ? 2 : 1;
  static constexpr int kSK = kP * kKPG;
  static constexpr int kStageElems = 2 * kSK * D;  // K then V
  static_assert(kC >= 1 && kC % kG == 0, "a key row is whole 16-byte chunks");
  // after the sweep the ring holds the group partials (m, l, acc[D])
  static_assert((2 + D) * kP * sizeof(float) <=
                    kStages * kStageElems * sizeof(T),
                "the ring holds the group partials");
};

// 16 bytes of T as fp32
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// T's bits, for the element-wise copy
template <int N>
struct Bits;
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};

// Shared memory: res (D + 4 floats: m, l, then acc[D] from float 4 on)
// this CTA's result, read by rank 0; ring (kStages stages of kSK K rows
// then kSK V rows of T), reused after the sweep for the group partials;
// tab (pages) the CTA's slice of the table row. `hd` is the head dim
// (<= D), `vec` whether its rows stream as 16-byte chunks.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int H, int nb, int bs, int splits, int span,
                    float sm_scale, int hd, int vec) {
  using G = Geo<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* res = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + (D + 4) * sizeof(float));
  int* tab = reinterpret_cast<int*>(ring + kStages * G::kStageElems);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / splits;
  const int b = bh / H;
  const int h = bh - b * H;
  const int seq = nb * bs;
  const int k0 = rank * span;
  const int p0 = k0 / bs;
  // the table slice of the whole range (entries are ints: reading one
  // past the clock reads no page), loaded beside the clock
  const int np = (min(k0 + span, seq) - 1) / bs - p0 + 1;
  for (int i = threadIdx.x; i < np; i += kThreads)
    tab[i] = table[(size_t)b * nb + p0 + i];
  const int n = min(pos[b], seq - 1) + 1;  // visible keys: j <= pos[b]
  const int k1 = min(k0 + span, n);        // this CTA's visible keys
  const int nkeys = max(k1 - k0, 0);
  const int tid = threadIdx.x;
  const int grp = tid / G::kG;
  const int gl = tid % G::kG;
  const int nstage = (nkeys + G::kSK - 1) / G::kSK;
  float qr[G::kE];
  const float* qp = q + (size_t)bh * hd;
#pragma unroll
  for (int c = 0; c < G::kCPT; ++c)
#pragma unroll
    for (int e = 0; e < G::kEPC; ++e) {
      const int col = (gl + c * G::kG) * G::kEPC + e;
      qr[c * G::kEPC + e] = col < hd ? qp[col] : 0.f;
    }
  __syncthreads();  // the table slice is staged

  // copy stage s (keys k0 + s * kSK ...) into ring slot s % kStages;
  // rows past k1 and columns past hd are zeros and nothing is read for
  // them. The element-wise copy lands at once: the barrier that starts
  // the step reading slot s publishes it, as it does the cp.async ones.
  const int hc = hd * (int)sizeof(T) / 16;  // 16-byte chunks a row (vec)
  auto issue = [&](int s) {
    if (s < nstage) {
      T* dst = ring + (s % kStages) * G::kStageElems;
      if (vec) {
        const uint32_t dbase = sm90::smem_u32(dst);
        for (int i = tid; i < 2 * G::kSK * G::kC; i += kThreads) {
          const int kv = i / (G::kSK * G::kC);
          const int row = (i / G::kC) % G::kSK;
          const int c = i % G::kC;
          const int j = k0 + s * G::kSK + row;
          const bool valid = j < k1 && c < hc;
          const T* src = kv ? v_pool : k_pool;
          if (valid)
            src += (((size_t)tab[j / bs - p0] * H + h) * bs + j % bs) * hd +
                   c * G::kEPC;
          sm90::cp_async16(dbase + (uint32_t)i * 16, src, valid);
        }
      } else {
        using B = typename Bits<sizeof(T)>::type;
        B* bits = reinterpret_cast<B*>(dst);
        for (int i = tid; i < 2 * G::kSK * D; i += kThreads) {
          const int kv = i / (G::kSK * D);
          const int row = (i / D) % G::kSK;
          const int e = i % D;
          const int j = k0 + s * G::kSK + row;
          B x = 0;
          if (j < k1 && e < hd)
            x = reinterpret_cast<const B*>(kv ? v_pool : k_pool)
                [(((size_t)tab[j / bs - p0] * H + h) * bs + j % bs) * hd + e];
          bits[i] = x;
        }
      }
    }
    sm90::cp_async_commit();
  };

  float m = -INFINITY, l = 0.f, acc[G::kE];
#pragma unroll
  for (int e = 0; e < G::kE; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nstage; ++s) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed for every thread; slot s-1 free
    issue(s + kStages - 1);
    const T* ks = ring + (s % kStages) * G::kStageElems;
    const T* vs = ks + G::kSK * D;
    float sc[G::kKPG];
    float smax = -INFINITY;
#pragma unroll
    for (int i = 0; i < G::kKPG; ++i) {
      const int r = grp + G::kP * i;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < G::kCPT; ++c) {
        float x[G::kEPC];
        load16(ks + r * D + (gl + c * G::kG) * G::kEPC, x);
#pragma unroll
        for (int e = 0; e < G::kEPC; ++e)
          dot = fmaf(qr[c * G::kEPC + e], x[e], dot);
      }
#pragma unroll
      for (int o = G::kG / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      // masked after the dot, as the plain version masks
      sc[i] = k0 + s * G::kSK + r < k1 ? dot * sm_scale : -INFINITY;
      smax = fmaxf(smax, sc[i]);
    }
    const float mn = fmaxf(m, smax);
    if (mn == -INFINITY) continue;  // no visible key for this group yet
    const float corr = expf(m - mn);
    l *= corr;
#pragma unroll
    for (int e = 0; e < G::kE; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < G::kKPG; ++i) {
      if (sc[i] == -INFINITY) continue;
      const int r = grp + G::kP * i;
      const float p = expf(sc[i] - mn);
      l += p;
#pragma unroll
      for (int c = 0; c < G::kCPT; ++c) {
        float x[G::kEPC];
        load16(vs + r * D + (gl + c * G::kG) * G::kEPC, x);
#pragma unroll
        for (int e = 0; e < G::kEPC; ++e)
          acc[c * G::kEPC + e] = fmaf(p, x[e], acc[c * G::kEPC + e]);
      }
    }
    m = mn;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the group partials

  float* gm = reinterpret_cast<float*>(ring);  // [kP] maxima
  float* gs = gm + G::kP;                      // [kP] sums
  float* ga = gs + G::kP;                      // [kP][D] weighted V rows
  if (gl == 0) {
    gm[grp] = m;
    gs[grp] = l;
  }
#pragma unroll
  for (int c = 0; c < G::kCPT; ++c)
#pragma unroll
    for (int e = 0; e < G::kEPC; ++e)
      ga[grp * D + (gl + c * G::kG) * G::kEPC + e] = acc[c * G::kEPC + e];
  __syncthreads();
  // the groups in index order; a group that saw no key adds nothing
  float cm = -INFINITY;
  for (int g = 0; g < G::kP; ++g) cm = fmaxf(cm, gm[g]);
  float cl = 0.f;
  for (int g = 0; g < G::kP; ++g)
    if (gm[g] != -INFINITY) cl += gs[g] * expf(gm[g] - cm);
  for (int d = tid; d < hd; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < G::kP; ++g)
      if (gm[g] != -INFINITY) a += ga[g * D + d] * expf(gm[g] - cm);
    res[4 + d] = a;
  }
  if (tid == 0) {
    res[0] = cm;
    res[1] = cl;
  }
  cluster.sync();  // every rank's result is written
  if (rank == 0) {
    // every rank's m and l at once (independent loads), then the ranks
    // in order; a rank that saw no key adds nothing
    float rm[kMaxSplits], rl[kMaxSplits], w[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const float* rr = cluster.map_shared_rank(res, r < splits ? r : 0);
      rm[r] = r < splits ? rr[0] : -INFINITY;
      rl[r] = rr[1];
    }
    float fm = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) fm = fmaxf(fm, rm[r]);
    float fl = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      w[r] = rm[r] != -INFINITY ? expf(rm[r] - fm) : 0.f;
      if (rm[r] != -INFINITY) fl += rl[r] * w[r];
    }
    for (int d = tid; d < hd; d += kThreads) {
      float ra[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        ra[r] = cluster.map_shared_rank(res, r < splits ? r : 0)[4 + d];
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (rm[r] != -INFINITY) o += ra[r] * w[r];
      out[(size_t)bh * hd + d] = o / fl;
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its memory
}

template <typename T, int D>
size_t smem_bytes(int bs, int span) {
  using G = Geo<T, D>;
  return sizeof(float) * (D + 4) + sizeof(T) * kStages * G::kStageElems +
         sizeof(int) * ((size_t)(span + bs - 1) / bs + 1);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* pos, void* out, int B,
                   int H, int nb, int bs, int splits, int span,
                   float sm_scale, int hd, int vec, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>(bs, span);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(splits * B * H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<float*>(out), H, nb, bs, splits, span, sm_scale, hd, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(int D, const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* pos, void* out, int B, int H,
                             int nb, int bs, int splits, int span,
                             float sm_scale, int hd, int vec,
                             cudaStream_t stream) {
  switch (D) {
#define BIGDL_PD_CASE(W)                                                   \
  case W:                                                                  \
    return launch<T, W>(q, k_pool, v_pool, table, pos, out, B, H, nb, bs, \
                        splits, span, sm_scale, hd, vec, stream);
    BIGDL_PD_CASE(8)
    BIGDL_PD_CASE(16)
    BIGDL_PD_CASE(32)
    BIGDL_PD_CASE(64)
    BIGDL_PD_CASE(96)
    BIGDL_PD_CASE(128)
    BIGDL_PD_CASE(160)
    BIGDL_PD_CASE(192)
    BIGDL_PD_CASE(224)
    BIGDL_PD_CASE(256)
    BIGDL_PD_CASE(384)
    BIGDL_PD_CASE(512)
    BIGDL_PD_CASE(768)
    BIGDL_PD_CASE(1024)
#undef BIGDL_PD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ D > 1024
// Above the largest tier a key row is 2-32 KB: too wide for the registers
// of a group of threads. The row is split over the whole CTA instead, and
// the keys over a thread-block cluster, as the tiers split them.
//
// * Plan (ops/paged_decode.py wide_plan, from the table extent, the head
//   dim and the pools' dtype alone, never B or the clocks): `splits` <= 8
//   CTAs a (row, head), each at least ~32 KB of K and V rows, rank `rank`
//   taking the keys [rank * span, (rank + 1) * span).
// * A CTA's 256 threads own a row's 16-byte chunks tid, tid + 256, ...
//   (NCH of them: NCH * 256 * 16 bytes hold the row), so q and the
//   weighted V row sit in registers split over the CTA: at most 8 chunks,
//   32 fp32 or 64 bf16 columns, a thread. Up to D = 8192 (fp32) or 16384
//   (bf16); the wrapper refuses wider rows.
// * K and V rows stream through a ring of kWideStages stages of kSK =
//   8 / NCH keys (<= 192 KB), kWideStages - 1 stages in flight ahead of
//   the one being used, rows past the clock never copied. Copy width by
//   row bytes (wide_copy_bytes): whole 16-byte chunks as 16-byte
//   cp.async copies; rows of whole 8-byte pieces (a bf16 row of
//   D = 1100 is 2200 bytes) as 8-byte copies; any other fp32 row as
//   4-byte copies; any other bf16 row element by element (plain loads).
//   Shared rows are padded to 16 bytes, the padding zero-filled.
// * One pass, online softmax: a stage's kSK dots are summed by each
//   thread over its chunks, then over each warp (xor butterfly), then
//   over the 8 warps in order through shared memory, so every thread
//   holds the same scores, running max m and sum l; each thread then
//   rescales and adds p_j v_j to its own columns.
// * The ranks combine through distributed shared memory after a cluster
//   barrier: every rank reads all ranks' (m, l) and combines its own
//   slice of the columns over the ranks in rank order. No atomics, no
//   global scratch; a row's bits do not depend on its co-batch.
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideStages = 3;

// Stage keys a CTA takes at NCH chunks a thread (the ring stays <= 192
// KB: kWideStages x 2 x kSK rows of <= NCH x 4 KB). Mirrored by
// ops/paged_decode.py wide_plan.
template <int NCH>
constexpr __host__ __device__ int wide_stage_keys() {
  return 8 / NCH;
}

template <int W>
__device__ __forceinline__ void cp_async_w(uint32_t dst, const void* src,
                                           bool valid) {
  if constexpr (W == 16)
    sm90::cp_async16(dst, src, valid);
  else if constexpr (W == 8)
    sm90::cp_async8(dst, src, valid);
  else
    sm90::cp_async4(dst, src, valid);
}

// Shared memory: the ring (kWideStages stages of kSK K rows then kSK V
// rows, `rowb` bytes a row), reused after the sweep for this rank's
// result (m, l, then acc from float 4 on), then red (kWideWarps x kSK
// partial dots), then tab (the CTA's slice of the table row). `copy` is
// the copy width in bytes (16, 8, or the element: 4 fp32, 2 bf16).
template <typename T, int NCH>
__global__ void __launch_bounds__(kWideThreads, 1)
paged_decode_wide_kernel(const float* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ table,
                         const int* __restrict__ pos,
                         float* __restrict__ out, int H, int nb, int bs,
                         int splits, int span, float sm_scale, int hd,
                         int copy) {
  constexpr int kEPC = 16 / (int)sizeof(T);  // elements a chunk
  constexpr int kSK = wide_stage_keys<NCH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int gb = hd * (int)sizeof(T);  // bytes a row in the pools
  const int rowb = (gb + 15) / 16 * 16;
  const int nc = rowb / 16;            // chunks a shared row
  const int stage_bytes = 2 * kSK * rowb;
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(ring + kWideStages * stage_bytes);
  int* tab = reinterpret_cast<int*>(red + kWideWarps * kSK);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / splits;
  const int b = bh / H;
  const int h = bh - b * H;
  const int seq = nb * bs;
  const int k0 = rank * span;
  const int p0 = k0 / bs;
  const int np = (min(k0 + span, seq) - 1) / bs - p0 + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < np; i += kWideThreads)
    tab[i] = table[(size_t)b * nb + p0 + i];
  const int n = min(pos[b], seq - 1) + 1;  // visible keys: j <= pos[b]
  const int k1 = min(k0 + span, n);        // this CTA's visible keys
  const int nkeys = max(k1 - k0, 0);
  const int nstage = (nkeys + kSK - 1) / kSK;
  float qr[NCH][kEPC];
  const float* qp = q + (size_t)bh * hd;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int e = 0; e < kEPC; ++e) {
      const int col = (tid + i * kWideThreads) * kEPC + e;
      qr[i][e] = col < hd ? qp[col] : 0.f;
    }
  __syncthreads();  // the table slice is staged

  // element offset of key j's row in a pool
  auto row_of = [&](int j) {
    return (((size_t)tab[j / bs - p0] * H + h) * bs + j % bs) * hd;
  };
  // copy stage s (keys k0 + s * kSK ...) into ring slot s % kWideStages:
  // rows past k1 are not copied (their scores are masked and their V
  // rows never read), the padding past gb bytes is zero-filled. The
  // element-wise copy lands at once; the barrier that starts the step
  // reading slot s publishes it, as it does the cp.async ones.
  auto issue_w = [&](auto width, int s) {
    constexpr int W = decltype(width)::value;
    unsigned char* dst = ring + (s % kWideStages) * stage_bytes;
    const uint32_t dbase = sm90::smem_u32(dst);
    const int pieces = rowb / W;
    for (int i = tid; i < 2 * kSK * pieces; i += kWideThreads) {
      const int kv = i / (kSK * pieces);
      const int row = (i / pieces) % kSK;
      const int pc = i % pieces;
      const int j = k0 + s * kSK + row;
      if (j >= k1) continue;
      const bool valid = pc * W < gb;
      const T* src = (kv ? v_pool : k_pool) + row_of(j);
      cp_async_w<W>(dbase + (uint32_t)((kv * kSK + row) * rowb + pc * W),
                    reinterpret_cast<const unsigned char*>(src) +
                        (valid ? pc * W : 0),
                    valid);
    }
  };
  auto issue = [&](int s) {
    if (s < nstage) {
      if (copy == 16) {
        issue_w(std::integral_constant<int, 16>{}, s);
      } else if (copy == 8) {
        issue_w(std::integral_constant<int, 8>{}, s);
      } else if (sizeof(T) == 4) {
        issue_w(std::integral_constant<int, 4>{}, s);
      } else {
        using B = typename Bits<sizeof(T)>::type;
        B* bits = reinterpret_cast<B*>(ring + (s % kWideStages) *
                                                  stage_bytes);
        const int per = rowb / (int)sizeof(T);
        for (int i = tid; i < 2 * kSK * per; i += kWideThreads) {
          const int kv = i / (kSK * per);
          const int row = (i / per) % kSK;
          const int e = i % per;
          const int j = k0 + s * kSK + row;
          if (j >= k1) continue;
          bits[i] = e < hd ? reinterpret_cast<const B*>(
                                 kv ? v_pool : k_pool)[row_of(j) + e]
                           : (B)0;
        }
      }
    }
    sm90::cp_async_commit();
  };

  float m = -INFINITY, l = 0.f, acc[NCH][kEPC];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int e = 0; e < kEPC; ++e) acc[i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) issue(s);
  for (int s = 0; s < nstage; ++s) {
    sm90::cp_async_wait<kWideStages - 2>();
    __syncthreads();  // stage s landed; every thread is done with s - 1
    issue(s + kWideStages - 1);
    const unsigned char* ks = ring + (s % kWideStages) * stage_bytes;
    const unsigned char* vs = ks + kSK * rowb;
    float part[kSK];
#pragma unroll
    for (int r = 0; r < kSK; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = tid + i * kWideThreads;
        if (c < nc) {
          float x[kEPC];
          load16(reinterpret_cast<const T*>(ks + r * rowb + c * 16), x);
#pragma unroll
          for (int e = 0; e < kEPC; ++e) dot = fmaf(qr[i][e], x[e], dot);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      part[r] = dot;
    }
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < kSK; ++r) red[warp * kSK + r] = part[r];
    __syncthreads();  // every warp's partial dots are in red
    // the warps in order: every thread the same scores
    float sc[kSK];
    float smax = -INFINITY;
#pragma unroll
    for (int r = 0; r < kSK; ++r) {
      float dot = red[r];
#pragma unroll
      for (int w = 1; w < kWideWarps; ++w) dot += red[w * kSK + r];
      // masked after the dot, as the plain version masks
      sc[r] = k0 + s * kSK + r < k1 ? dot * sm_scale : -INFINITY;
      smax = fmaxf(smax, sc[r]);
    }
    const float mn = fmaxf(m, smax);  // finite: the stage's first key
    const float corr = expf(m - mn);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < kEPC; ++e) acc[i][e] *= corr;
#pragma unroll
    for (int r = 0; r < kSK; ++r) {
      if (sc[r] == -INFINITY) continue;  // a row past k1, never copied
      const float p = expf(sc[r] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = tid + i * kWideThreads;
        if (c < nc) {
          float x[kEPC];
          load16(reinterpret_cast<const T*>(vs + r * rowb + c * 16), x);
#pragma unroll
          for (int e = 0; e < kEPC; ++e)
            acc[i][e] = fmaf(p, x[e], acc[i][e]);
        }
      }
    }
    m = mn;
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds this rank's result

  float* res = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = tid + i * kWideThreads;
    if (c < nc)
#pragma unroll
      for (int e = 0; e < kEPC; ++e) res[4 + c * kEPC + e] = acc[i][e];
  }
  if (tid == 0) {
    res[0] = m;
    res[1] = l;
  }
  cluster.sync();  // every rank's result is written
  // every rank's m and l, then this rank's slice of the columns over
  // the ranks in order; a rank that saw no key adds nothing
  float w[kMaxSplits];
  float fm = -INFINITY;
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) {
    w[r] = r < splits ? cluster.map_shared_rank(res, r)[0] : -INFINITY;
    fm = fmaxf(fm, w[r]);
  }
  float fl = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) {
    const float rm = w[r];
    w[r] = rm != -INFINITY ? expf(rm - fm) : 0.f;
    if (rm != -INFINITY) fl += cluster.map_shared_rank(res, r)[1] * w[r];
  }
  const int cs = (hd + splits - 1) / splits;
  const int c1 = min(hd, (rank + 1) * cs);
  for (int d = rank * cs + tid; d < c1; d += kWideThreads) {
    float ra[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      ra[r] = w[r] != 0.f ? cluster.map_shared_rank(res, r)[4 + d] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (w[r] != 0.f) o += ra[r] * w[r];
    out[(size_t)bh * hd + d] = o / fl;
  }
  cluster.sync();  // no rank leaves while another reads its memory
}

template <int NCH>
size_t wide_smem_bytes(int hd, int elem, int bs, int span) {
  const size_t rowb = ((size_t)hd * elem + 15) / 16 * 16;
  return kWideStages * 2 * wide_stage_keys<NCH>() * rowb +
         sizeof(float) * kWideWarps * wide_stage_keys<NCH>() +
         sizeof(int) * ((size_t)(span + bs - 1) / bs + 1);
}

template <typename T, int NCH>
cudaError_t launch_wide(const void* q, const void* k_pool,
                        const void* v_pool, const void* table,
                        const void* pos, void* out, int B, int H, int nb,
                        int bs, int splits, int span, float sm_scale, int hd,
                        int copy, cudaStream_t stream) {
  auto kernel = paged_decode_wide_kernel<T, NCH>;
  const size_t smem = wide_smem_bytes<NCH>(hd, (int)sizeof(T), bs, span);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(splits * B * H));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<float*>(out), H, nb, bs, splits, span, sm_scale, hd, copy);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_for(int nch, const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* pos, void* out, int B, int H, int nb,
                            int bs, int splits, int span, float sm_scale,
                            int hd, int copy, cudaStream_t stream) {
  switch (nch) {
#define BIGDL_PDW_CASE(N)                                                    \
  case N:                                                                    \
    return launch_wide<T, N>(q, k_pool, v_pool, table, pos, out, B, H, nb, \
                             bs, splits, span, sm_scale, hd, copy, stream);
    BIGDL_PDW_CASE(1)
    BIGDL_PDW_CASE(2)
    BIGDL_PDW_CASE(4)
    BIGDL_PDW_CASE(8)
#undef BIGDL_PDW_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by bigdl_tpu_torch/ops/paged_decode.py.
// The wrapper checks device, dtypes, contiguity and the shared-memory
// size, picks the tier D (HEAD_DIMS: the least that holds the head dim
// hd) and whether rows stream as 16-byte chunks (vec), and passes its
// split plan (splits CTAs of span keys a (row, head)), before calling.
// Returns the cudaError_t of the launch (0 on success); the kernel runs
// on `stream` and nothing here synchronises.
extern "C" int bigdl_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* pos, void* out, int B, int H,
                                  int nb, int bs, int D, int hd, int vec,
                                  int splits, int span, float sm_scale,
                                  int pool_is_bf16, void* stream) {
  const int elem = pool_is_bf16 ? 2 : 4;
  if (hd < 1 || hd > D || (vec && hd * elem % 16) || B < 1 || H < 1 ||
      nb < 1 ||
      bs < 1 || splits < 1 || splits > kMaxSplits || span < 1 ||
      (long long)splits * span < (long long)nb * bs ||
      (long long)(splits - 1) * span >= (long long)nb * bs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_is_bf16)
    return (int)launch_for_width<__nv_bfloat16>(D, q, k_pool, v_pool, table,
                                                pos, out, B, H, nb, bs,
                                                splits, span, sm_scale, hd,
                                                vec, s);
  return (int)launch_for_width<float>(D, q, k_pool, v_pool, table, pos, out,
                                      B, H, nb, bs, splits, span, sm_scale,
                                      hd, vec, s);
}

// Human-readable text for a cudaError_t the entry point returned.
extern "C" const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// D > 1024 (any head dim above the tiers up to 8192 fp32 / 16384 bf16):
// one launch of the row-split kernel, by the wrapper's wide_plan (splits
// CTAs of span keys a (row, head), nch 16-byte chunks a thread) and copy
// width (16, 8 or the element size in bytes).
extern "C" int bigdl_paged_decode_wide(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* pos, void* out, int B,
                                       int H, int nb, int bs, int hd,
                                       int splits, int span, int nch,
                                       int copy, float sm_scale,
                                       int pool_is_bf16, void* stream) {
  const int elem = pool_is_bf16 ? 2 : 4;
  const int rowb = (hd * elem + 15) / 16 * 16;
  if (hd < 1 || B < 1 || H < 1 || nb < 1 || bs < 1 || splits < 1 ||
      splits > kMaxSplits || span < 1 ||
      (long long)splits * span < (long long)nb * bs ||
      (long long)(splits - 1) * span >= (long long)nb * bs ||
      (copy != 16 && copy != 8 && copy != elem) || hd * elem % copy ||
      rowb > nch * kWideThreads * 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_is_bf16)
    return (int)launch_wide_for<__nv_bfloat16>(
        nch, q, k_pool, v_pool, table, pos, out, B, H, nb, bs, splits, span,
        sm_scale, hd, copy, s);
  return (int)launch_wide_for<float>(nch, q, k_pool, v_pool, table, pos, out,
                                     B, H, nb, bs, splits, span, sm_scale,
                                     hd, copy, s);
}
