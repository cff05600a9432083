// Row LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ln_fwd_kernel` (reached via
// `_ln_fwd` <- `fused_layernorm_2d` <- `fused_layernorm_arrays`): y, and the
// fp32 mean and reciprocal standard deviation of each row, which the
// backward reads.
//
// What bounds it on this card: memory (read x once, write y once; a few
// FLOPs per element) and, at the decode shape of 8 rows, the launch itself.
//
// What the design does about it: one warp per row, eight rows per block.
// The lanes stride the row, so each pass reads whole 128-byte lines; the
// statistics are two passes as in the TPU kernel (mean, then the mean of
// squared deviations, not E[x^2] - mu^2), reduced with shuffles in fp32, and
// the row stays in L1 between passes.  Any row width works.
//
// Types: x float or bf16; w and b of one type, float or bf16; y in
// promote(x, w, b) (`pallas_ops.py:1455`): bf16 only when all three are.
// Layout: x, y contiguous [n, H]; w, b [H]; mu, rstd contiguous fp32 [n, 1].
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;   // one warp per row

template <typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(THREADS) ln_fwd_kernel(
    const TX* __restrict__ x, const TP* __restrict__ w,
    const TP* __restrict__ b, TO* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ rstd, int n, int H, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= n) return;
  const TX* xr = x + (long long)row * H;
  TO* yr = y + (long long)row * H;
  float s = 0.f;
  for (int i = lane; i < H; i += 32) s += to_f(xr[i]);
  const float m = warp_sum(s) / H;
  float v = 0.f;
  for (int i = lane; i < H; i += 32) {
    const float c = to_f(xr[i]) - m;
    v = fmaf(c, c, v);
  }
  const float r = 1.f / sqrtf(warp_sum(v) / H + eps);
  for (int i = lane; i < H; i += 32)
    yr[i] = from_f<TO>((to_f(xr[i]) - m) * r * to_f(w[i]) + to_f(b[i]));
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

template <typename TX, typename TP, typename TO>
void launch(const void* x, const void* w, const void* b, void* y, void* mu,
            void* rstd, int n, int H, float eps, cudaStream_t stream) {
  ln_fwd_kernel<TX, TP, TO><<<(n + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(w),
      static_cast<const TP*>(b), static_cast<TO*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), n, H, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int fused_layernorm(const void* x, const void* w, const void* b,
                               void* y, void* mu, void* rstd, int n, int H,
                               int x_bf16, int p_bf16, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (x_bf16 && p_bf16)
    launch<bf, bf, bf>(x, w, b, y, mu, rstd, n, H, eps, s);
  else if (x_bf16)
    launch<bf, float, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  else if (p_bf16)
    launch<float, bf, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  else
    launch<float, float, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  return static_cast<int>(cudaGetLastError());
}
