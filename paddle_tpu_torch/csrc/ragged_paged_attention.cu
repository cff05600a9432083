// Fused cache write + ragged paged attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py `_ragged_fused_kernel`
// (reached via `_ragged_kernel_call` <- `ragged_paged_attention_arrays`),
// full-precision pools.  Unlike the TPU kernel, which serves only C == 1,
// this one also serves chunked-prefill continuations (C > 1).
//
// What bounds it on this card: memory.  A decode step reads every live
// row's K and V once (sum_r kv_len_r * H * D * 2 * itemsize bytes) and does
// 4 FLOPs per element read, far below the ridge point; the bound is those
// bytes over 3.35 TB/s.  At serving batch sizes the grid is small (one
// block per row and head), so what limits a simple kernel is memory
// latency: how many independent loads each block keeps in flight.
//
// What the design does about it:
//  1. Write.  A first launch, one block per (row, query position), copies
//     the new token's K and V rows into their pool slots; a slot outside
//     [0, num_blocks * block_size) is a padding entry and is dropped.
//  2. Attend.  A second launch on the same stream (so every write is
//     visible) runs one 256-thread block per (query, head, row).  Pass 1:
//     each thread takes whole keys (k = tid, tid + 256, ...) and dots its
//     key row with q (staged in shared memory) using 16-byte (fp32) or
//     8-byte (bf16) vector loads -- no cross-lane reduction per key.  The
//     scores go to shared memory; a block-wide max and sum give the exact
//     softmax (fp32).  Pass 2: D/4 threads cover one value row with vector
//     loads and the 256/(D/4) groups of them split the keys, so a thread
//     has many independent loads in flight; the groups' partial sums are
//     added in shared memory.
//     Query j of row r attends keys 0 .. min(pos0[r] + j, kv_lens[r] - 1),
//     read through the row's block table, and no table entry past that
//     bound is dereferenced (padding rows carry kv_lens = 0 and sentinel
//     table entries, and produce 0).
//
// Layout: q, k_new, v_new are [B, C, H, D] with unit stride in D and stride
// D between heads (row and position strides are arguments); pools are
// contiguous, 16-byte aligned [num_blocks, block_size, H, D]; out is a
// contiguous [B, C, H, D] in the input type.  Shared memory holds one fp32
// score per key of the table's width (max_blocks * block_size).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;      // elements per vector load

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

// Block-wide max (is_max) or sum of one float per thread; every thread gets
// the result.  `red` holds WARPS floats.
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool is_max) {
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

template <typename T>
__global__ void ragged_write_kernel(const T* __restrict__ knew,
                                    const T* __restrict__ vnew,
                                    T* __restrict__ kpool,
                                    T* __restrict__ vpool,
                                    const int* __restrict__ slots, int C,
                                    int HD, long long num_slots,
                                    long long ksb, long long ksc,
                                    long long vsb, long long vsc) {
  const int r = blockIdx.x / C, j = blockIdx.x % C;
  const long long slot = slots[blockIdx.x];
  if (slot < 0 || slot >= num_slots) return;
  const T* ks = knew + r * ksb + j * ksc;
  const T* vs = vnew + r * vsb + j * vsc;
  for (int e = threadIdx.x; e < HD; e += blockDim.x) {
    kpool[slot * HD + e] = ks[e];
    vpool[slot * HD + e] = vs[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ragged_attend_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ pos0, const int* __restrict__ lens,
    T* __restrict__ out, int C, int H, int nb, int bs, int maxb,
    long long qsb, long long qsc, float scale) {
  constexpr int TPK = D / VEC;          // threads per value row
  constexpr int G = THREADS / TPK;      // key groups in pass 2
  extern __shared__ float s[];          // one score per key
  __shared__ float qs[D];
  __shared__ float red[WARPS];
  __shared__ float part[G][D];
  const int jq = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const long long HD = (long long)H * D;
  T* op = out + (((long long)r * C + jq) * H + h) * D;
  // never read past the row's written keys nor past its table
  const int kv_len = min(max(lens[r], 0), maxb * bs);
  const int bound = max(0, min(pos0[r] + jq + 1, kv_len));   // keys [0, bound)
  if (bound == 0) {
    for (int d = tid; d < D; d += THREADS) op[d] = from_f<T>(0.f);
    return;
  }
  const T* qp = q + r * qsb + jq * qsc + h * D;
  for (int d = tid; d < D; d += THREADS) qs[d] = to_f(qp[d]);
  __syncthreads();
  const int* trow = table + (long long)r * maxb;

  // pass 1: scores and their max
  float mx = -1e30f;
  for (int k = tid; k < bound; k += THREADS) {
    const int blk = min(max(trow[k / bs], 0), nb - 1);
    const T* kr = kpool + ((long long)blk * bs + k % bs) * HD + h * D;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float x[VEC];
      load4(kr + d, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(x[i], qs[d + i], dot);
    }
    dot *= scale;
    s[k] = dot;
    mx = fmaxf(mx, dot);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int k = tid; k < bound; k += THREADS) {
    const float p = expf(s[k] - mx);
    s[k] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);   // also orders the s[] writes

  // pass 2: probabilities times values
  const int g = tid / TPK, d0 = (tid % TPK) * VEC;
  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = g; k < bound; k += G) {
    const int blk = min(max(trow[k / bs], 0), nb - 1);
    float x[VEC];
    load4(vpool + ((long long)blk * bs + k % bs) * HD + h * D + d0, x);
    const float p = s[k];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, x[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[g][d0 + i] = acc[i];
  __syncthreads();
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  for (int d = tid; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int x = 0; x < G; ++x) a += part[x][d];
    op[d] = from_f<T>(a * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* knew, const void* vnew,
                   void* kpool, void* vpool, const int* table,
                   const int* pos0, const int* lens, const int* slots,
                   void* out, int B, int C, int H, int nb, int bs, int maxb,
                   long long qsb, long long qsc, long long ksb,
                   long long ksc, long long vsb, long long vsc, float scale,
                   cudaStream_t stream) {
  ragged_write_kernel<T><<<B * C, 128, 0, stream>>>(
      static_cast<const T*>(knew), static_cast<const T*>(vnew),
      static_cast<T*>(kpool), static_cast<T*>(vpool), slots, C, H * D,
      (long long)nb * bs, ksb, ksc, vsb, vsc);
  const size_t smem = sizeof(float) * (size_t)maxb * bs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_attend_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(C, H, B);
  ragged_attend_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), table, pos0, lens, static_cast<T*>(out),
      C, H, nb, bs, maxb, qsb, qsc, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the two launches (cudaGetLastError());
// 1 (cudaErrorInvalidValue) for a head size or type the kernel does not
// take.
extern "C" int ragged_paged_attention(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, const void* table, const void* pos0, const void* lens,
    const void* slots, void* out, int B, int C, int H, int D, int nb, int bs,
    int maxb, int is_bf16, long long qsb, long long qsc, long long ksb,
    long long ksc, long long vsb, long long vsc, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos0);
  const int* n = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(slots);
  cudaError_t err;
#define RPA_LAUNCH(T, DIM)                                                   \
  err = launch<T, DIM>(q, knew, vnew, kpool, vpool, t, p, n, sl, out, B, C,  \
                       H, nb, bs, maxb, qsb, qsc, ksb, ksc, vsb, vsc, scale, \
                       s)
  if (D == 64 && is_bf16)
    RPA_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    RPA_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    RPA_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    RPA_LAUNCH(float, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef RPA_LAUNCH
  return static_cast<int>(err);
}
