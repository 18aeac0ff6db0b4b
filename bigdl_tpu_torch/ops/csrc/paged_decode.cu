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
// kernel of "D > 1024" below takes any head dim.
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
// Above the largest tier a key row does not fit the registers of a group
// of threads, so the row is split over the whole CTA instead: one CTA a
// (row, head), no cluster. Pass 1: each warp takes keys w, w + 8, ...,
// its lanes stride over the row's columns (coalesced), and writes the
// scaled dot to this (row, head)'s row of `scratch` (S floats); pass 2:
// the max and the sum of exp(s - max) over the CTA, p written back in
// place; pass 3: each thread owns columns tid, tid + 256, ... and sums
// p_j v_j over the visible keys in key order. Keys j > pos are never
// read. Bound by bytes like the tiers; it reads K and V once and each
// score three times from L2.
constexpr int kWideThreads = 256;

__device__ __forceinline__ float block_reduce(float x, float* red, bool max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWideThreads / 32; ++w)
    r = max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
paged_decode_wide_kernel(const float* __restrict__ q,
                         const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ table,
                         const int* __restrict__ pos,
                         float* __restrict__ out,
                         float* __restrict__ scratch, int H, int nb, int bs,
                         int hd, float sm_scale) {
  __shared__ float red[kWideThreads / 32];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int seq = nb * bs;
  const int n = min(pos[b], seq - 1) + 1;  // visible keys: j <= pos[b]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qp = q + (size_t)bh * hd;
  float* sc = scratch + (size_t)bh * seq;
  auto row = [&](const T* pool, int j) {
    return pool + (((size_t)table[(size_t)b * nb + j / bs] * H + h) * bs +
                   j % bs) * hd;
  };

  float m = -INFINITY;
  for (int j = warp; j < n; j += kWideThreads / 32) {
    const T* kr = row(k_pool, j);
    float dot = 0.f;
    for (int d = lane; d < hd; d += 32) dot = fmaf(qp[d], to_f32(kr[d]), dot);
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    dot *= sm_scale;
    if (lane == 0) sc[j] = dot;
    m = fmaxf(m, dot);
  }
  m = block_reduce(m, red, true);  // its barriers publish the scores
  float l = 0.f;
  for (int j = threadIdx.x; j < n; j += kWideThreads) {
    const float p = expf(sc[j] - m);
    sc[j] = p;
    l += p;
  }
  l = block_reduce(l, red, false);
  for (int d = threadIdx.x; d < hd; d += kWideThreads) {
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(sc[j], to_f32(row(v_pool, j)[d]), o);
    out[(size_t)bh * hd + d] = o / l;
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

// D > 1024 (any head dim above the tiers): one launch of the row-split
// kernel, `scratch` a (B * H, nb * bs) fp32 buffer the wrapper allocates.
extern "C" int bigdl_paged_decode_wide(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* pos, void* out,
                                       void* scratch, int B, int H, int nb,
                                       int bs, int hd, float sm_scale,
                                       int pool_is_bf16, void* stream) {
  if (hd < 1 || B < 1 || H < 1 || nb < 1 || bs < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(B * H));
  if (pool_is_bf16)
    paged_decode_wide_kernel<__nv_bfloat16><<<grid, kWideThreads, 0, s>>>(
        static_cast<const float*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(table), static_cast<const int*>(pos),
        static_cast<float*>(out), static_cast<float*>(scratch), H, nb, bs,
        hd, sm_scale);
  else
    paged_decode_wide_kernel<float><<<grid, kWideThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<float*>(out),
        static_cast<float*>(scratch), H, nb, bs, hd, sm_scale);
  return (int)cudaGetLastError();
}
