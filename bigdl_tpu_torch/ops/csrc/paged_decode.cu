// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel bigdl_tpu/ops/paged_decode.py::_pd_kernel
// (launched by _paged_decode_pallas). For each row b and head h:
//
//   out[b,h] = softmax_j(mask_j(q . k_j * sm_scale)) . v
//
// over the full table extent S = nb * bs of row b's blocks, key j living
// in pool block table[b, j / bs] at offset j % bs. Keys with j > pos[b]
// are masked to -1e30 AFTER the dot, and value rows with j > pos[b]
// contribute exactly 0 — the conventions of the plain version
// (ops/kv_cache.py paged_attention). A masked key's probability is
// exp(-1e30 - max) == 0.0f exactly, and its value row is zeroed, so the
// kernel reads only keys j <= pos[b]: it never touches the scratch block
// or a poisoned former occupant's rows beyond the clock.
//
// Inputs: q (B, H, 1, D) fp32; k/v pools (N, H, bs, D) fp32 or bf16,
// loaded to fp32; table (B, nb) int32 and pos (B,) int32 on the device;
// out (B, H, 1, D) fp32. Table entries must lie in [0, N): the engine's
// block allocator guarantees it, and the kernel does not check.
//
// What bounds it: HBM bytes. Each (b, h) reads its visible K and V rows
// once and does 4 flops per element read, far below the card's
// flop/byte balance. At the 43M serving shape (B=8, H=8, D=64, S=592)
// the full table extent is 19.4 MB a launch in fp32 — about 5.8 us at
// 3.35 TB/s (about 2.9 us with bf16 pools) — and the decode path makes
// 8 launches a step, one per layer; rows whose clock is short read less.
//
// Design, simple and right first (speed is later work):
// * one CTA of 16 warps per (b, h); it stages its own table row in
//   shared memory and reads its clock (the TPU kernel's scalar prefetch
//   becomes a plain load), so a key's address costs no global load;
// * pass 1: warps stride over keys, lanes over D (D / 32 elements a
//   lane, coalesced), an xor-shuffle reduction per key, scores to shared
//   memory (S * 4 bytes, 2.4 KB at S = 592). The loop is latency-bound:
//   16 warps keep 16 keys' loads in flight where 4 kept 4 (measured on
//   an H100, 700 W: 144 us a launch with 4 warps and the table read from
//   global memory);
// * the max and the sum are taken in a fixed order (per-thread strided
//   loop, xor butterfly, then warps in index order), then pass 2 takes
//   the weighted sum of V rows j <= pos with the same warp/lane split
//   and adds the 16 warps' partial rows in index order.
// No atomics: the result is bitwise reproducible and a row's bits do not
// depend on B or on the other rows — the port's counterpart of the JAX
// package's co-batch independence. Not done yet: splitting S over more
// CTAs (64 CTAs leave most of the 132 SMs idle) and cp.async/TMA loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// xor butterfly: every lane ends with the same, order-fixed result
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// CTA-wide reduction in a fixed order: inside each warp, then the warps
// in index order. Every thread returns the same value. The barriers also
// publish every shared-memory write made before the call.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // `red` is reused by the next reduction
  return r;
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ pos,
                    float* __restrict__ out,
                    int H, int nb, int bs, float sm_scale) {
  constexpr int D = kPerLane * 32;
  extern __shared__ float smem[];
  float* red = smem;                 // [kWarps] reduction slots
  float* part = red + kWarps;        // [kWarps * D] pass-2 partial rows
  float* prob = part + kWarps * D;   // [S] scores, then exp(score - max)
  int* tab = reinterpret_cast<int*>(prob + nb * bs);  // [nb] table row

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int seq = nb * bs;
  const int n = min(pos[b], seq - 1) + 1;  // visible keys: j <= pos[b]
  for (int i = threadIdx.x; i < nb; i += kThreads)
    tab[i] = table[(size_t)b * nb + i];

  float qr[kPerLane];
  const float* qp = q + (size_t)bh * D;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) qr[i] = qp[lane + 32 * i];
  __syncthreads();  // the table row is staged

  // pass 1: one key per warp at a time, lanes across D
#pragma unroll 4
  for (int j = warp; j < n; j += kWarps) {
    const int blk = tab[j / bs];
    const T* kr = k_pool + (((size_t)blk * H + h) * bs + j % bs) * D;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      acc = fmaf(qr[i], to_f32(kr[lane + 32 * i]), acc);
    acc = warp_sum(acc);
    if (lane == 0) prob[j] = acc * sm_scale;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, prob[j]);
  m = block_reduce<true>(m, red);

  float l = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(prob[j] - m);
    prob[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);

  // pass 2: weighted sum of the visible value rows
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = warp; j < n; j += kWarps) {
    const float w = prob[j] / l;
    const int blk = tab[j / bs];
    const T* vr = v_pool + (((size_t)blk * H + h) * bs + j % bs) * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      acc[i] = fmaf(w, to_f32(vr[lane + 32 * i]), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part[warp * D + lane + 32 * i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = part[d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += part[w * D + d];
    out[(size_t)bh * D + d] = o;
  }
}

template <typename T, int kPerLane>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* pos, void* out, int B,
                   int H, int nb, int bs, float sm_scale,
                   cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, kPerLane>;
  const size_t smem =
      sizeof(float) * ((size_t)kWarps + (size_t)kWarps * kPerLane * 32 +
                       (size_t)nb * bs) +
      sizeof(int) * (size_t)nb;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<float*>(out), H, nb, bs,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(int D, const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* pos, void* out, int B, int H,
                             int nb, int bs, float sm_scale,
                             cudaStream_t stream) {
  switch (D / 32) {
#define BIGDL_PD_CASE(P)                                                    \
  case P:                                                                   \
    return launch<T, P>(q, k_pool, v_pool, table, pos, out, B, H, nb, bs, \
                        sm_scale, stream);
    BIGDL_PD_CASE(1)
    BIGDL_PD_CASE(2)
    BIGDL_PD_CASE(3)
    BIGDL_PD_CASE(4)
    BIGDL_PD_CASE(5)
    BIGDL_PD_CASE(6)
    BIGDL_PD_CASE(7)
    BIGDL_PD_CASE(8)
#undef BIGDL_PD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by bigdl_tpu_torch/ops/paged_decode.py.
// The wrapper checks device, dtypes, contiguity, D % 32 == 0, D <= 256
// and the shared-memory size before calling. Returns the cudaError_t of
// the launch (0 on success); the kernel runs on `stream` and nothing
// here synchronises.
extern "C" int bigdl_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* pos, void* out, int B, int H,
                                  int nb, int bs, int D, float sm_scale,
                                  int pool_is_bf16, void* stream) {
  if (D % 32 != 0 || D < 32 || D > 256 || B < 1 || H < 1 || nb < 1 ||
      bs < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_is_bf16)
    return (int)launch_for_width<__nv_bfloat16>(D, q, k_pool, v_pool, table,
                                                pos, out, B, H, nb, bs,
                                                sm_scale, s);
  return (int)launch_for_width<float>(D, q, k_pool, v_pool, table, pos, out,
                                      B, H, nb, bs, sm_scale, s);
}

// Human-readable text for a cudaError_t the entry point returned.
extern "C" const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
