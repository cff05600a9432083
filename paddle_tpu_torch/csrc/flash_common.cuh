// Device helpers shared by the flash-attention kernels (flash_fwd_causal.cu,
// flash_bwd_causal.cu): type conversions and the packed-segment envelope of
// a tile -- the counterpart of `_seg_kb_bounds`
// (paddle_tpu/ops/pallas_ops.py:122-132), which the TPU's forward and both
// backward kernels share the same way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

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
// x rounded to T and widened back: the cast the TPU kernel makes before a
// product with operands of type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Block-wide min of `lo` and max of `hi`, returned to every thread.  `red`
// is shared scratch of 2 * THREADS / 32 ints; every thread must call.
template <int THREADS>
__device__ __forceinline__ void block_min_max(int& lo, int& hi, int* red) {
  constexpr int WARPS = THREADS / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();   // red may still be read from an earlier call
  if (threadIdx.x % 32 == 0) {
    red[warp] = lo;
    red[WARPS + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[WARPS];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[WARPS + w]);
  }
}

// The segment envelope of a tile: `lo` and `hi` are the least and the
// greatest id of this thread's rows (each thread passes its rows').
// Returns [first, last + 1) of the positions of `ids` ([n] int32) whose id
// lies in [min, max] of the tile's ids; an empty range (first >= last + 1)
// when none does.  Correct for ANY id layout: every position whose id
// equals one of the tile's lies inside the range, and the positions inside
// it with other ids are excluded by the caller's in-tile equality test.
template <int THREADS>
__device__ __forceinline__ int2 seg_envelope(const int* __restrict__ ids,
                                             int n, int lo, int hi,
                                             int* red) {
  block_min_max<THREADS>(lo, hi, red);
  int first = n, last = -1;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int s = ids[p];
    if (s >= lo && s <= hi) {
      first = min(first, p);
      last = p;
    }
  }
  block_min_max<THREADS>(first, last, red);
  return make_int2(first, last + 1);
}

// The same for a thread that holds one row, whose id is `own`.
template <int THREADS>
__device__ __forceinline__ int2 seg_envelope(const int* __restrict__ ids,
                                             int n, int own, int* red) {
  return seg_envelope<THREADS>(ids, n, own, own, red);
}

}  // namespace flash
