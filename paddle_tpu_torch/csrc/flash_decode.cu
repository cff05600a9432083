// Dense KV-cache decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_decode_kernel` (reached via
// `flash_decode_arrays` <- `cached_attention_arrays`): one query per row
// (S_q = 1) against the first `length` rows of flat [B, S_max, H*D] cache
// rings, `length` shared by the batch.
//
// What bounds it on this card: memory.  A step reads K and V of the valid
// prefix once, 2 * B * length * H * D * itemsize bytes, and does 4 FLOPs
// per element read, far below the ridge point.  As in the TPU kernel, only
// ceil(length / 256) key tiles are read, never all S_max rows.
//
// What the design does about it: one 256-thread block per (head, row),
// streaming tiles of 256 keys with an online softmax (fp32 m, l and
// accumulator; `decode::prefix_attention` in decode_common.cuh, shared with
// the fused layer).  Pass 1 of a tile: each thread takes one whole key and
// dots it with q (staged in shared memory) using 16-byte (fp32) or 8-byte
// (bf16) vector loads, so no cross-lane reduction is needed per key; a
// block-wide max and sum update m and l.  Pass 2: D/4 threads cover one
// value row with vector loads and the 256/(D/4) groups of them split the
// tile's keys, each group keeping its own partial accumulator, rescaled by
// the tile's alpha; the groups' partials are added in shared memory at the
// end.  Shared memory holds one tile of probabilities, never a row per
// S_max key, so any S_max works.  At B = 8 and H = 12 the grid is 96 blocks
// on 132 SMs;
// splitting a row's keys across blocks (split-K with a merge of the
// partial softmax states) is later work.
//
// Rounding points: logits are fp32 sums of q_d * k_d (the TPU kernel rounds
// each product to bf16 before its per-head sum, an artefact of its (8, 128)
// tiling that is not copied).  Each probability is rounded to the cache
// type before the value product, as the TPU kernel's `seg_dot(p, expand)`
// does; l sums the unrounded fp32 probabilities.
//
// Layout: q is [B, 1, H, D] with unit stride in D and stride D between
// heads (the batch stride is an argument, so a slice of a fused qkv
// projection needs no copy); the rings are contiguous [B, S_max, H*D] in
// q's type; out is a contiguous [B, 1, H, D] in q's type.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, T* __restrict__ out, int H, int S_max,
    int length, long long qsb, float scale) {
  constexpr int G = THREADS / (D / VEC);   // key groups of the value pass
  __shared__ float qs[D];
  __shared__ float ps[THREADS];
  __shared__ float red[THREADS / 32];
  __shared__ float part[G][D];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long HD = (long long)H * D;
  const T* qp = q + b * qsb + h * D;
  for (int d = tid; d < D; d += THREADS) qs[d] = to_f(qp[d]);
  __syncthreads();
  const long long base = (long long)b * S_max * HD + h * D;
  float m, l, acc[VEC];
  prefix_attention<T, D, THREADS>(qs, kc + base, vc + base, HD, length,
                                  scale, nullptr, ps, red, m, l, acc);
  const int g = tid / (D / VEC), d0 = (tid % (D / VEC)) * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[g][d0 + i] = acc[i];
  __syncthreads();
  const float ls = fmaxf(l, 1e-30f);
  T* op = out + ((long long)b * H + h) * D;
  for (int d = tid; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int x = 0; x < G; ++x) a += part[x][d];
    op[d] = from_f<T>(a / ls);
  }
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, void* out, int B,
            int H, int S_max, int length, long long qsb, float scale,
            cudaStream_t stream) {
  dim3 grid(H, B);
  flash_decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), H, S_max, length, qsb,
      scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size or type the kernel does not take.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            void* out, int B, int H, int D, int S_max,
                            int length, int is_bf16, long long qsb,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && is_bf16)
    launch<__nv_bfloat16, 64>(q, kc, vc, out, B, H, S_max, length, qsb,
                              scale, s);
  else if (D == 64)
    launch<float, 64>(q, kc, vc, out, B, H, S_max, length, qsb, scale, s);
  else if (D == 128 && is_bf16)
    launch<__nv_bfloat16, 128>(q, kc, vc, out, B, H, S_max, length, qsb,
                               scale, s);
  else if (D == 128)
    launch<float, 128>(q, kc, vc, out, B, H, S_max, length, qsb, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
