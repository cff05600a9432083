// Dropout keep masks on JAX's keys: out[i] = jax.random.bernoulli(key, keep,
// shape).ravel()[i] for i < n, bit for bit.
//
// The JAX package draws every dropout mask as `jax.random.bernoulli(
// _rng.next_key(), 1 - p, shape)` (paddle_tpu/nn/functional/__init__.py:903,
// pallas_ops.py:901), which XLA fuses into the surrounding step on the TPU;
// there is no Pallas kernel.  This kernel is that fusion's counterpart: one
// pass that hashes each element's counter and writes its bool, where the
// plain version (paddle_tpu_torch/core/random.py `bernoulli`) runs some 180
// elementwise int64 passes over the shape.
//
// Each element i: the counter words (i >> 32, i & 0xffffffff) hashed by
// threefry2x32 under the key words (k0, k1), 20 rounds in five blocks of
// four with the key schedule injected after each block
// (jax/_src/prng.py `_threefry2x32_lowering`, the partitionable form); the
// bits are the xor of the two hashed words; the top 23 bits as the mantissa
// of a float in [1, 2), minus 1, give the uniform in [0, 1) (exact), kept
// where it is below `keep` (float32), as `uniform(key, shape) < keep`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define ROUND(r)           \
  x0 += x1;                \
  x1 = rotl(x1, r) ^ x0;
#define EVEN ROUND(13) ROUND(15) ROUND(26) ROUND(6)
#define ODD ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  EVEN x0 += k1; x1 += k2 + 1u;
  ODD x0 += k2; x1 += k0 + 2u;
  EVEN x0 += k0; x1 += k1 + 3u;
  ODD x0 += k1; x1 += k2 + 4u;
  EVEN x0 += k2; x1 += k0 + 5u;
#undef EVEN
#undef ODD
#undef ROUND
  return x0 ^ x1;
}

__global__ void threefry_bernoulli_kernel(uint32_t k0, uint32_t k1,
                                          long long n, float keep,
                                          unsigned char* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t bits =
        threefry_bits(k0, k1, (uint32_t)(i >> 32), (uint32_t)i);
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[i] = u < keep ? 1 : 0;
  }
}

}  // namespace

// k0, k1: the key's two words; out: n bytes (a torch.bool tensor).  Returns
// cudaGetLastError() after the launch.
extern "C" int threefry_bernoulli(unsigned int k0, unsigned int k1,
                                  long long n, float keep, void* out,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past 16 an SM
  threefry_bernoulli_kernel<<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, keep, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
