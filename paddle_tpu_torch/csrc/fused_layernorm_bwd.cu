// Row LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ln_bwd_kernel` (reached via
// `_ln_vjp_bwd` <- the custom VJP of `fused_layernorm_2d`): from x, w, the
// forward's fp32 mean and reciprocal standard deviation of each row and dy,
//
//   x^ = (x - mu) rstd,  g = dy w,
//   dx = rstd (g - mean(g) - x^ mean(g x^)),
//   dw = sum over rows of dy x^,  db = sum over rows of dy.
//
// What bounds it on this card: memory (read x and dy once, write dx once; a
// few FLOPs per element).  The column sums are a reduction across rows, so
// across blocks, which the TPU kernel's sequential grid made trivial.
//
// What the design does about it:
// - ln_bwd_kernel: one warp per row, the warps of the grid striding over
//   the rows, up to 16 warps a block and two blocks an SM.  Lanes stride
//   the row four elements at a time (16- or 8-byte loads and stores where H
//   is a multiple of 4 and the rows are aligned, else one), two strides in
//   flight, so each pass reads whole lines with enough loads outstanding to
//   cover the latency; the first pass reduces sum(g) and sum(g x^) with
//   shuffles in fp32, the second writes dx (the row stays in L1 between
//   the passes) and adds dy x^ and dy into the warp's own fp32 row of
//   partial sums in shared memory (each lane owns its columns: no atomics,
//   no conflicts).  At the end the block adds its warps' rows in warp
//   order and writes one partial row of each sum.
// - ln_bwd_sum_kernel: 16 warps per 32 columns add the blocks' partial rows,
//   each warp a fixed stride of them, then one warp adds the 16 in order.
// No float atomics anywhere: the grid depends only on n and H, and every sum
// runs in a fixed order, so a result is the same in every run.
//
// Types: x float or bf16; w float or bf16; dy in promote(x, w, b) (bf16 only
// when x and w are); dx in x's type, dw and db in w's (the forward kernel
// takes w and b of one type).
// Layout: x, dy, dx contiguous [n, H]; w, dw, db [H]; mu, rstd contiguous
// fp32 [n, 1]; part fp32 [2, grid, H] scratch.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int MAX_THREADS = 512;
constexpr int SUM_WARPS = 16;

__device__ __forceinline__ void store4(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// V consecutive elements (V = VEC or 1), global or shared memory
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == VEC) {
    load4(p, v);
  } else {
    v[0] = to_f(*p);
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == VEC) {
    store4(p, v);
  } else {
    *p = from_f<T>(v[0]);
  }
}

template <typename TX, typename TP, typename TD, int V>
__global__ void __launch_bounds__(MAX_THREADS) ln_bwd_kernel(
    const TX* __restrict__ x, const TP* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const TD* __restrict__ dy, TX* __restrict__ dx, float* __restrict__ part,
    int n, int H) {
  extern __shared__ __align__(16) float acc[];   // [warps][2][H]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* aw = acc + (size_t)warp * 2 * H;
  float* ab = aw + H;
  for (int i = lane; i < H; i += 32) {
    aw[i] = 0.f;
    ab[i] = 0.f;
  }
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < n;
       row += stride) {
    const TX* xr = x + row * H;
    const TD* dyr = dy + row * H;
    const float m = mu[row], r = rstd[row];
    float sg = 0.f, sgx = 0.f;
#pragma unroll 2
    for (int i = lane * V; i < H; i += 32 * V) {
      float xv[V], dv[V], wv[V];
      load_v<V>(xr + i, xv);
      load_v<V>(dyr + i, dv);
      load_v<V>(w + i, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - m) * r;
        const float g = dv[j] * wv[j];
        sg += g;
        sgx = fmaf(g, xh, sgx);
      }
    }
    const float m1 = warp_sum(sg) / H;
    const float m2 = warp_sum(sgx) / H;
    TX* dxr = dx + row * H;
#pragma unroll 2
    for (int i = lane * V; i < H; i += 32 * V) {
      float xv[V], dv[V], wv[V], sw[V], sb[V], o[V];
      load_v<V>(xr + i, xv);
      load_v<V>(dyr + i, dv);
      load_v<V>(w + i, wv);
      load_v<V>(aw + i, sw);
      load_v<V>(ab + i, sb);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - m) * r;
        const float g = dv[j] * wv[j];
        o[j] = r * (g - m1 - xh * m2);
        sw[j] = fmaf(dv[j], xh, sw[j]);
        sb[j] += dv[j];
      }
      store_v<V>(dxr + i, o);
      store_v<V>(aw + i, sw);
      store_v<V>(ab + i, sb);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int k = 0; k < warps; ++k) {
      sw += acc[(size_t)k * 2 * H + i];
      sb += acc[(size_t)k * 2 * H + H + i];
    }
    part[(size_t)blockIdx.x * H + i] = sw;
    part[((size_t)gridDim.x + blockIdx.x) * H + i] = sb;
  }
}

// blockIdx.y 0: dw from part[0], 1: db from part[1]
template <typename TP>
__global__ void __launch_bounds__(SUM_WARPS * 32) ln_bwd_sum_kernel(
    const float* __restrict__ part, TP* __restrict__ dw, TP* __restrict__ db,
    int grid, int H) {
  __shared__ float s[SUM_WARPS][33];
  const int lane = threadIdx.x % 32, wy = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const float* p = part + (size_t)blockIdx.y * grid * H;
  float a = 0.f;
  if (col < H)
    for (int b = wy; b < grid; b += SUM_WARPS) a += p[(size_t)b * H + col];
  s[wy][lane] = a;
  __syncthreads();
  if (wy == 0 && col < H) {
    float t = 0.f;
    for (int k = 0; k < SUM_WARPS; ++k) t += s[k][lane];
    (blockIdx.y == 0 ? dw : db)[col] = from_f<TP>(t);
  }
}

template <typename TX, typename TP, typename TD, int V>
cudaError_t launch(const void* x, const void* w, const void* mu,
                   const void* rstd, const void* dy, void* dx, void* dw,
                   void* db, void* part, int n, int H, int grid, int warps,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)warps * H;
  auto kernel = ln_bwd_kernel<TX, TP, TD, V>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(w),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const TD*>(dy), static_cast<TX*>(dx),
      static_cast<float*>(part), n, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 sum_grid((H + 31) / 32, 2);
  ln_bwd_sum_kernel<TP><<<sum_grid, SUM_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TP*>(dw),
      static_cast<TP*>(db), grid, H);
  return cudaGetLastError();
}

template <typename TX, typename TP, typename TD>
cudaError_t launch(bool vec, const void* x, const void* w, const void* mu,
                   const void* rstd, const void* dy, void* dx, void* dw,
                   void* db, void* part, int n, int H, int grid, int warps,
                   cudaStream_t stream) {
  return vec ? launch<TX, TP, TD, VEC>(x, w, mu, rstd, dy, dx, dw, db, part,
                                       n, H, grid, warps, stream)
             : launch<TX, TP, TD, 1>(x, w, mu, rstd, dy, dx, dw, db, part, n,
                                     H, grid, warps, stream);
}

}  // namespace

// `grid` blocks of `warps` warps (1..16); part holds 2 * grid * H floats;
// `vec`: H is a multiple of 4 and x, w, dy, dx are 16-byte aligned.
// Returns the first launch error, or cudaSuccess.
extern "C" int fused_layernorm_bwd(const void* x, const void* w,
                                   const void* mu, const void* rstd,
                                   const void* dy, void* dx, void* dw,
                                   void* db, void* part, int n, int H,
                                   int grid, int warps, int vec, int x_bf16,
                                   int p_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool v = vec != 0;
  cudaError_t err;
  if (x_bf16 && p_bf16)
    err = launch<bf, bf, bf>(v, x, w, mu, rstd, dy, dx, dw, db, part, n, H,
                             grid, warps, s);
  else if (x_bf16)
    err = launch<bf, float, float>(v, x, w, mu, rstd, dy, dx, dw, db, part,
                                   n, H, grid, warps, s);
  else if (p_bf16)
    err = launch<float, bf, float>(v, x, w, mu, rstd, dy, dx, dw, db, part,
                                   n, H, grid, warps, s);
  else
    err = launch<float, float, float>(v, x, w, mu, rstd, dy, dx, dw, db,
                                      part, n, H, grid, warps, s);
  return static_cast<int>(err);
}
