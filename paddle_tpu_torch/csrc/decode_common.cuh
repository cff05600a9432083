// Device helpers shared by the decode-path kernels (flash_decode.cu,
// fused_decode_layer.cu, fused_layernorm.cu, the three FFN sources): type
// conversions, vector loads, the FFN's activation, reductions, the
// last-block ticket of a cross-block sum, and the streaming prefix
// attention of one decode query -- the counterpart of `_prefix_attn_loop`
// (paddle_tpu/ops/pallas_ops.py), which the TPU's decode and fused-layer
// kernels share the same way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode {

constexpr int VEC = 4;          // elements per vector load
constexpr float NEG = -1e30f;   // the additive mask constant of the JAX code

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ void load4(const float* p, float (&x)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// The FFN's activation in fp32 (`_ffn_act`, pallas_ops.py): 0 gelu (erf),
// 1 gelu (tanh), 2 relu.
__device__ __forceinline__ float activate(float u, int act) {
  if (act == 0) return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
  if (act == 1) {
    const float inner = 0.7978845608028654f * (u + 0.044715f * u * u * u);
    return 0.5f * u * (1.f + tanhf(inner));
  }
  return fmaxf(u, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (is_max) or sum of one float per thread of a THREADS-thread
// block; every thread gets the result.  `red` holds THREADS / 32 floats.
template <int THREADS>
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool is_max) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();   // red is reused by the next reduction
  return r;
}

// Cross-block sums (fused_ffn.cu, fused_ffn_decode.cu, flash_decode.cu):
// after this block's writes, true in the block that is the `count`-th to
// take the ticket, which resets it for the next launch.  Every thread
// calls; `flag` is shared memory.
__device__ __forceinline__ bool last_of(int* ticket, int count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == count - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// Online-softmax attention of one fp32 query `qs` (shared memory, D
// floats) against rows [0, length) of one head of a flat ring: `kb`, `vb`
// point at the head's D values of row 0 and rows are `HD` apart.  Tiles of
// THREADS keys: each thread dots one whole key with q (vector loads, no
// cross-lane reduction per key), a block-wide max and sum update m and l,
// each probability exp(s - m) is rounded to T (as the TPU kernel's
// `seg_dot(p, expand)`) into `ps` (THREADS floats of shared memory), and
// D/4 threads cover one value row while THREADS/(D/4) groups of them split
// the tile's keys.  `mrow`: null or an additive fp32 mask over the rows.
// Returns, in every thread, the running max m and sum l (of the unrounded
// probabilities), and in `acc` this thread's group's partial sum over its
// keys for dims d0 .. d0+3 (d0 = (tid % (D/4)) * 4, group tid / (D/4)).
template <typename T, int D, int THREADS>
__device__ __forceinline__ void prefix_attention(
    const float* qs, const T* __restrict__ kb, const T* __restrict__ vb,
    long long HD, int length, float scale, const float* __restrict__ mrow,
    float* ps, float* red, float& m, float& l, float (&acc)[VEC]) {
  constexpr int TPK = D / VEC;          // threads per value row
  constexpr int G = THREADS / TPK;      // key groups
  const int tid = threadIdx.x;
  const int g = tid / TPK, d0 = (tid % TPK) * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  m = NEG;
  l = 0.f;
  for (int k0 = 0; k0 < length; k0 += THREADS) {
    const int k = k0 + tid;
    float s = NEG;
    if (k < length) {
      const T* kr = kb + (long long)k * HD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += VEC) {
        float x[VEC];
        load4(kr + d, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(x[i], qs[d + i], dot);
      }
      s = dot * scale;
      if (mrow) s += mrow[k];
    }
    const float mnew = fmaxf(m, block_reduce<THREADS>(s, red, true));
    const float alpha = expf(m - mnew);
    const float p = k < length ? expf(s - mnew) : 0.f;
    ps[tid] = round_to<T>(p);
    l = l * alpha + block_reduce<THREADS>(p, red, false);   // orders ps[]
    m = mnew;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
    const int kend = min(THREADS, length - k0);
#pragma unroll 4
    for (int j = g; j < kend; j += G) {
      float x[VEC];
      load4(vb + (long long)(k0 + j) * HD + d0, x);
      const float pj = ps[j];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pj, x[i], acc[i]);
    }
    __syncthreads();   // ps[] is rewritten by the next tile
  }
}

}  // namespace decode
