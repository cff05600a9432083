// Fused feed-forward forward, act(x W1 + b1) W2, for Hopper (sm_90a), plain
// C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ffn_fwd_kernel` (reached via
// `fused_ffn_2d` <- `fused_ffn_arrays`) where `ops/fused_mlp.py`
// `ffn_design` picks "cuda_core": fp32 above its decode rows, and widths
// the other two designs do not take.  As there, the [n, I] intermediate
// never reaches device memory.
//
// What bounds it on this card: at the decode shape (n = 8 rows) memory --
// the two weight matrices are streamed once (2 * H * I elements, 9.4 MB in
// bf16 at GPT-2 width) for a few FLOPs per element; at hundreds of rows the
// 4 * n * H * I FLOPs, which this first design does with fp32 FMAs on the
// CUDA cores (no tensor cores).
//
// What the design does about it: one block per (slice of BI intermediate
// columns, tile of 8 rows), so even 8 rows spread over ~200 blocks (the
// wrapper picks BI).  A block stages its rows of x in shared memory (fp32,
// transposed so that one k reads the 8 rows as two 16-byte words), computes
// u = x W1[:, slice] + b1 with threads on consecutive columns (coalesced
// rows of W1) and the rows of W1 split between thread groups, applies the
// activation, rounds h to x's type into shared memory, and multiplies it by
// its BI rows of W2, each thread on columns of W2 with one fp32 sum per row.
// Those fp32 partials [slices, n, H2] go to a scratch buffer and are added
// in a fixed order by a two-level tree of atomic tickets (one per group of
// GS = 16 slices and one per row tile, each reset by the block that takes
// it): the last block of a group to finish adds the group's partials in
// slice order into a group row, and the last group to finish adds the
// group rows in group order into y.  So the result does not depend on the
// order in which blocks ran, and no single block adds all the partials
// (192 of them at the decode shape: done by one block, that sum took most
// of the kernel's time).
//
// Rounding points (`pallas_ops.py:1559-1564`): both products accumulate in
// fp32, b1 is added in fp32, the activation runs in fp32, h is rounded to
// x's type before the second product, y is cast once.
//
// Layout: x contiguous [n, H]; w1 [H, I]; b1 [I]; w2 [I, H2]; y [n, H2];
// all one type: float, `__nv_bfloat16` or `__half`.  act: 0 gelu (erf),
// 1 gelu (tanh), 2 relu.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 256;
constexpr int RT = 8;   // rows per tile
constexpr int GS = 16;  // slices per group of the reduction tree

// acc[r] += w * rows[r] for the RT rows stored at p (16-byte aligned)
__device__ __forceinline__ void fma_rows(float w, const float* p,
                                         float (&acc)[RT]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  acc[0] = fmaf(w, a.x, acc[0]);
  acc[1] = fmaf(w, a.y, acc[1]);
  acc[2] = fmaf(w, a.z, acc[2]);
  acc[3] = fmaf(w, a.w, acc[3]);
  acc[4] = fmaf(w, b.x, acc[4]);
  acc[5] = fmaf(w, b.y, acc[5]);
  acc[6] = fmaf(w, b.z, acc[6]);
  acc[7] = fmaf(w, b.w, acc[7]);
}

// dst[r][c] = sum over s in [s0, s1), in order, of src[s][r0 + r][c], for
// the `rows` rows of the tile; dst is [n, H2] (rows r0 ...) in float or T.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
template <typename T>
__device__ __forceinline__ void store(T* p, float v) { *p = from_f<T>(v); }

template <typename D>
__device__ __forceinline__ void add_rows(const float* src, int s0, int s1,
                                         int n, int r0, int rows, int H2,
                                         D* dst) {
  for (int e = threadIdx.x; e < rows * H2; e += THREADS) {
    const long long off = (long long)(r0 + e / H2) * H2 + e % H2;
    float s = 0.f;
#pragma unroll 8
    for (int sl = s0; sl < s1; ++sl)
      s += __ldcg(src + (long long)sl * n * H2 + off);
    store(dst + off, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_ffn_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ y,
    float* __restrict__ part, int* __restrict__ tickets, int n, int H, int I,
    int H2, int BI, int act) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                 // [H][RT]
  float* hs = xs + H * RT;        // [BI][RT]
  float* red = hs + BI * RT;      // [RT][THREADS]
  __shared__ int is_last;
  const int slice = blockIdx.x, tile = blockIdx.y, slices = gridDim.x;
  const int r0 = tile * RT, i0 = slice * BI, tid = threadIdx.x;
  const int rows = min(RT, n - r0);

  for (int e = tid; e < RT * H; e += THREADS) {
    const int r = e / H, k = e % H;
    xs[k * RT + r] = r < rows ? to_f(x[(long long)(r0 + r) * H + k]) : 0.f;
  }
  __syncthreads();

  // u = x W1[:, slice] + b1, then h = act(u) rounded to T
  const int cw = BI < THREADS ? BI : THREADS;   // columns at once
  const int kg = THREADS / cw;                  // groups splitting the rows
  for (int c0 = 0; c0 < BI; c0 += cw) {
    const int c = tid % cw, grp = tid / cw;
    const T* wc = w1 + i0 + c0 + c;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = grp; k < H; k += kg)
      fma_rows(to_f(wc[(long long)k * I]), xs + k * RT, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r) red[r * THREADS + tid] = acc[r];
    __syncthreads();
    for (int e = tid; e < cw * RT; e += THREADS) {
      const int cc = e % cw, r = e / cw;
      float u = 0.f;
      for (int gq = 0; gq < kg; ++gq) u += red[r * THREADS + gq * cw + cc];
      u += to_f(b1[i0 + c0 + cc]);
      hs[(c0 + cc) * RT + r] = to_f(from_f<T>(activate(u, act)));
    }
    __syncthreads();
  }

  // this slice's fp32 partial of h W2 for every column of W2
  for (int c = tid; c < H2; c += THREADS) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    const T* wc = w2 + (long long)i0 * H2 + c;
#pragma unroll 4
    for (int i = 0; i < BI; ++i)
      fma_rows(to_f(wc[(long long)i * H2]), hs + i * RT, acc);
    for (int r = 0; r < rows; ++r)
      part[((long long)slice * n + r0 + r) * H2 + c] = acc[r];
  }

  // the reduction tree: the last block of this slice's group, then the
  // last group of the row tile
  const int groups = (slices + GS - 1) / GS, grp = slice / GS;
  const int s0 = grp * GS, s1 = min(slices, s0 + GS);
  int* tk = tickets + (long long)tile * (groups + 1);
  float* gpart = part + (long long)slices * n * H2;   // [groups, n, H2]
  if (!last_of(&tk[grp], s1 - s0, &is_last)) return;
  if (groups == 1) {
    add_rows(part, 0, slices, n, r0, rows, H2, y);
    return;
  }
  add_rows(part, s0, s1, n, r0, rows, H2,
           gpart + ((long long)grp * n) * H2);
  if (!last_of(&tk[groups], groups, &is_last)) return;
  add_rows(gpart, 0, groups, n, r0, rows, H2, y);
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, void* y, void* part, void* tickets, int n,
                   int H, int I, int H2, int BI, int act,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)RT * (H + BI + THREADS);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(I / BI, (n + RT - 1) / RT);
  fused_ffn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<T*>(y), static_cast<float*>(part),
      static_cast<int*>(tickets), n, H, I, H2, BI, act);
  return cudaGetLastError();
}

}  // namespace

// dtype: the element type's code (0 fp32, 1 bf16, 2 fp16).  Returns the
// launch's CUDA error (cudaGetLastError()); 1 (cudaErrorInvalidValue) for
// another type code, when BI is not a power of two from 16 to 512 that
// divides I, or for an unknown activation.
extern "C" int fused_ffn(const void* x, const void* w1, const void* b1,
                         const void* w2, void* y, void* part, void* tickets,
                         int n, int H, int I, int H2, int BI, int act,
                         int dtype, void* stream) {
  if (dtype < 0 || dtype > 2 || BI < 16 || BI > 512 || (BI & (BI - 1)) ||
      I % BI || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFN_LAUNCH(T) \
  launch<T>(x, w1, b1, w2, y, part, tickets, n, H, I, H2, BI, act, s)
  const cudaError_t err = dtype == 0   ? FFN_LAUNCH(float)
                          : dtype == 1 ? FFN_LAUNCH(__nv_bfloat16)
                                       : FFN_LAUNCH(__half);
#undef FFN_LAUNCH
  return static_cast<int>(err);
}
