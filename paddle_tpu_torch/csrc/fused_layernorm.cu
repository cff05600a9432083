// Row LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ln_fwd_kernel` (reached via
// `_ln_fwd` <- `fused_layernorm_2d` <- `fused_layernorm_arrays`): y, and the
// fp32 mean and reciprocal standard deviation of each row, which the
// backward reads.
//
// What bounds it on this card: memory (read x once, write y once; a few
// FLOPs per element) and, at the decode shape of 8 rows, the launch and one
// round trip to memory.
//
// What the design does about it: one warp per row, each row read once into
// registers.  A lane issues all its 16-byte loads of the row (NC of them,
// chunks lane, lane + 32, ...) before the first reduction and, at fewer than
// EARLY_ROWS rows where the row is short enough (NC * elements per chunk <=
// 32), the loads of its chunks of w and b too (with many rows w and b are
// read after the statistics, from L1, and the registers go to more rows in
// flight: at most 8 chunks a lane, 64 registers a thread); the mean and then
// the mean of squared deviations (two passes as in the TPU kernel, not
// E[x^2] - mu^2) are computed from the registers and reduced with shuffles
// in fp32, and y is written once.  A row whose start is not on 16 bytes (x's
// row size not a multiple of 16 bytes, or an offset base) reads its first
// elements up to the next 16-byte boundary, and its last elements past the
// last whole chunk, as scalars (lanes 0 .. 6 at most); w, b and y chunks
// that are not on 16 bytes are read and written as scalars.  Rows wider
// than 32 chunks a lane (8192 bf16, 4096 fp32 elements) take
// `ln_fwd_wide_kernel`, which reads the row three times.  A block holds ROWS = 1 row, so a few rows
// spread over as many SMs (4 and 8 rows a block measured no faster at 8,
// 64 or 8192 rows: PERF.md).
//
// Types: x float or bf16; w and b of one type, float or bf16; y in
// promote(x, w, b) (`pallas_ops.py:1455`): bf16 only when all three are.
// Layout: x, y contiguous [n, H]; w, b [H]; mu, rstd contiguous fp32 [n, 1].
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using namespace decode;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 1;           // rows (one warp each) of a block
constexpr int SM_THREADS = 1024;  // threads of an SM at 64 registers each
constexpr int EARLY_MAX = 32;     // elements a lane keeps of w and b each
constexpr int EARLY_ROWS = 1024;  // fewer rows load w and b early

// EARLY: w's and b's chunks are loaded with x's, before the statistics
// (a few rows: they would miss the caches after them); else after them,
// from L1, which leaves registers for more rows in flight.
template <typename TX, typename TP, typename TO, int NC, bool EARLY>
__global__ void __launch_bounds__(
    32 * ROWS, EARLY || NC > 8 ? 1 : SM_THREADS / (32 * ROWS))
    ln_fwd_kernel(const TX* __restrict__ x, const TP* __restrict__ w,
                  const TP* __restrict__ b, TO* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd, int n,
                  int H, float eps) {
  constexpr int V = 16 / sizeof(TX);       // elements of a chunk
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= n) return;
  const TX* xr = x + (long long)row * H;
  TO* yr = y + (long long)row * H;
  // elements before the first 16-byte boundary, whole chunks, the rest
  const int mis = (int)(reinterpret_cast<uintptr_t>(xr) % 16) / sizeof(TX);
  const int head = min(H, mis ? V - mis : 0);
  const int nvec = (H - head) / V;
  const int tail = H - head - nvec * V;
  const int tail0 = head + nvec * V;

  uint4 raw[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int idx = lane + 32 * c;
    raw[c] = idx < nvec
                 ? __ldg(reinterpret_cast<const uint4*>(xr + head) + idx)
                 : make_uint4(0, 0, 0, 0);
  }
  const float hx = lane < head ? to_f(xr[lane]) : 0.f;
  const float tx = lane < tail ? to_f(xr[tail0 + lane]) : 0.f;
  float wv[EARLY ? NC : 1][V], bv[EARLY ? NC : 1][V];
  if constexpr (EARLY) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (lane + 32 * c < nvec) {
        const int i0 = head + (lane + 32 * c) * V;
        load_vals<TP, V>(w + i0, wv[c]);
        load_vals<TP, V>(b + i0, bv[c]);
      }
    }
  }
  const float hw = lane < head ? to_f(w[lane]) : 0.f;
  const float hb = lane < head ? to_f(b[lane]) : 0.f;
  const float tw = lane < tail ? to_f(w[tail0 + lane]) : 0.f;
  const float tb = lane < tail ? to_f(b[tail0 + lane]) : 0.f;

  // the chunk's elements as floats (zeros past the row)
  auto vals = [&](int c, float (&v)[V]) {
    const uint32_t q[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(TX) == 4) {
        v[j] = __uint_as_float(q[j]);
      } else {
        v[2 * j] = __uint_as_float(q[j] << 16);
        v[2 * j + 1] = __uint_as_float(q[j] & 0xffff0000u);
      }
    }
  };

  float s = hx + tx;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float v[V];
    vals(c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
  }
  const float m = warp_sum(s) / H;
  float d2 = 0.f;
  if (lane < head) d2 = (hx - m) * (hx - m);
  if (lane < tail) d2 = fmaf(tx - m, tx - m, d2);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c < nvec) {
      float v[V];
      vals(c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) d2 = fmaf(v[j] - m, v[j] - m, d2);
    }
  }
  const float r = 1.f / sqrtf(warp_sum(d2) / H + eps);

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c < nvec) {
      const int i0 = head + (lane + 32 * c) * V;
      float v[V], cw[V], cb[V];
      vals(c, v);
      if constexpr (EARLY) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          cw[j] = wv[c][j];
          cb[j] = bv[c][j];
        }
      } else {
        load_vals<TP, V>(w + i0, cw);
        load_vals<TP, V>(b + i0, cb);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = (v[j] - m) * r * cw[j] + cb[j];
      store_vals<TO, V>(yr + i0, v);
    }
  }
  if (lane < head) yr[lane] = from_f<TO>((hx - m) * r * hw + hb);
  if (lane < tail) yr[tail0 + lane] = from_f<TO>((tx - m) * r * tw + tb);
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = r;
  }
}

// Rows too wide for the registers: three passes over the row (the second
// and third from L1 / L2).
template <typename TX, typename TP, typename TO>
__global__ void __launch_bounds__(32 * ROWS) ln_fwd_wide_kernel(
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
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* mu, void* rstd, int n, int H, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int nc = (H / V + 31) / 32;   // chunks a lane holds, at most
  const int blocks = (n + ROWS - 1) / ROWS;
  const TX* xp = static_cast<const TX*>(x);
  const TP* wp = static_cast<const TP*>(w);
  const TP* bp = static_cast<const TP*>(b);
  TO* yp = static_cast<TO*>(y);
  float* mp = static_cast<float*>(mu);
  float* rp = static_cast<float*>(rstd);
#define LN_CASE(K)                                                        \
  if (nc <= K) {                                                          \
    if (K * V <= EARLY_MAX && n < EARLY_ROWS)                             \
      ln_fwd_kernel<TX, TP, TO, K, K * V <= EARLY_MAX>                    \
          <<<blocks, 32 * ROWS, 0, stream>>>(xp, wp, bp, yp, mp, rp, n,  \
                                              H, eps);                    \
    else                                                                  \
      ln_fwd_kernel<TX, TP, TO, K, false>                                 \
          <<<blocks, 32 * ROWS, 0, stream>>>(xp, wp, bp, yp, mp, rp, n,  \
                                              H, eps);                    \
    return cudaGetLastError();                                            \
  }
  LN_CASE(1)
  LN_CASE(2)
  LN_CASE(3)
  LN_CASE(4)
  LN_CASE(6)
  LN_CASE(8)
  LN_CASE(12)
  LN_CASE(16)
  LN_CASE(24)
  LN_CASE(32)
#undef LN_CASE
  ln_fwd_wide_kernel<TX, TP, TO><<<blocks, 32 * ROWS, 0, stream>>>(
      xp, wp, bp, yp, mp, rp, n, H, eps);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int fused_layernorm(const void* x, const void* w, const void* b,
                               void* y, void* mu, void* rstd, int n, int H,
                               int x_bf16, int p_bf16, float eps,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && p_bf16)
    err = launch<bf16, bf16, bf16>(x, w, b, y, mu, rstd, n, H, eps, s);
  else if (x_bf16)
    err = launch<bf16, float, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  else if (p_bf16)
    err = launch<float, bf16, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  else
    err = launch<float, float, float>(x, w, b, y, mu, rstd, n, H, eps, s);
  return static_cast<int>(err);
}
