// Fused cache write + ragged paged attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py `_ragged_fused_kernel`
// (reached via `_ragged_kernel_call` <- `ragged_paged_attention_arrays`):
// full-precision pools here, int8 pools in the second entry below.  Unlike
// the TPU kernel, which serves only C == 1, both also serve chunked-prefill
// continuations (C > 1).
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
//
// int8 pools (`ragged_paged_attention_int8`): codes beside fp32 scales
// [num_blocks, H], value = code * scale -- the TPU kernel's `quant` branch
// (`ragged_paged_attention.py:189-245`, `:311-328`), for any C >= 1.
//  1. Write.  One block per (row, logical block the row's positions
//     pos0 .. pos0 + C - 1 touch): a chunk of C = 512 spans up to 33.
//     The block takes the per-head abs-max over ALL of the group's
//     in-pool rows first, grows each head's scale once (new = max(old,
//     amax * (1/127))), rescales the block's old codes once where it grew
//     (round(code * old / new)), then quantizes the new rows
//     (round(x / new)).  A row writes only blocks it owns, so no two
//     blocks touch one pool block; slots outside the pool are dropped and
//     left out of the amax.  Rounding is rintf (half to even, as
//     torch.round and jnp.round) and the division IEEE (no fast math), so
//     the codes and scales are bitwise those of the plain version.  The
//     group's pool block is that of its first in-pool slot; a slot of the
//     group outside that block (not a position's slot) is dropped.  At
//     decode the launch is one block per row and bound by load latency,
//     so the rescale reads 16 codes per load and each thread issues all
//     its loads before its stores.
//  2. Attend.  The fp kernel instantiated for int8 pools: the codes loaded
//     4 at a time (char4) and the scales folded in as the plain version
//     folds them: k_scale times the scaled logit, v_scale times each
//     probability.  Bytes: 1 per code
//     plus 4 per (block, head) scale read -- a quarter of fp32's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[VEC]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
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

// P is the pools' element type: T, or int8_t codes whose per-(block,
// head) fp32 scales kscale / vscale fold in as the plain version folds
// them -- k_scale times the scaled logit, v_scale times each probability.
// For T pools the scales are null and unread.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(THREADS) ragged_attend_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool,
    const P* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ pos0, const int* __restrict__ lens,
    T* __restrict__ out, int C, int H, int nb, int bs, int maxb,
    long long qsb, long long qsc, float scale) {
  constexpr bool QUANT = sizeof(P) == 1;
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

  // pass 1: scores (times k_scale for codes) and their max
  float mx = -1e30f;
  for (int k = tid; k < bound; k += THREADS) {
    const int blk = min(max(trow[k / bs], 0), nb - 1);
    const P* kr = kpool + ((long long)blk * bs + k % bs) * HD + h * D;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float x[VEC];
      load4(kr + d, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot = fmaf(x[i], qs[d + i], dot);
    }
    if constexpr (QUANT)
      dot = dot * scale * kscale[(long long)blk * H + h];
    else
      dot *= scale;
    s[k] = dot;
    mx = fmaxf(mx, dot);
  }
  mx = block_reduce(mx, red, true);
  // probabilities, each stored times its block's v_scale for codes
  float sum = 0.f;
  for (int k = tid; k < bound; k += THREADS) {
    const float p = expf(s[k] - mx);
    if constexpr (QUANT)
      s[k] = p * vscale[(long long)min(max(trow[k / bs], 0), nb - 1) * H + h];
    else
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

// The attend launch, on the stream after the write launch.
template <typename T, typename P, int D>
cudaError_t attend(const void* q, const void* kpool, const void* vpool,
                   const float* kscale, const float* vscale, const int* table,
                   const int* pos0, const int* lens, void* out, int B, int C,
                   int H, int nb, int bs, int maxb, long long qsb,
                   long long qsc, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)maxb * bs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_attend_kernel<T, P, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(C, H, B);
  ragged_attend_kernel<T, P, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kpool),
      static_cast<const P*>(vpool), kscale, vscale, table, pos0, lens,
      static_cast<T*>(out), C, H, nb, bs, maxb, qsb, qsc, scale);
  return cudaGetLastError();
}

// -- int8 pools ---------------------------------------------------------

constexpr float QMAX = 127.f;

__device__ __forceinline__ int8_t quantize(float x) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -QMAX), QMAX));
}

// round(code * f) of the four codes packed in w
__device__ __forceinline__ unsigned rescale4(unsigned w, float f) {
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = static_cast<signed char>((w >> (8 * k)) & 0xffu);
    r |= static_cast<unsigned>(static_cast<unsigned char>(quantize(x * f)))
         << (8 * k);
  }
  return r;
}

// One block per (logical block group i, row r); dynamic shared memory
// holds 6 * H floats: amax, factor and write scale for each of K and V.
template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_write_int8_kernel(
    const T* __restrict__ knew, const T* __restrict__ vnew,
    int8_t* __restrict__ kpool, int8_t* __restrict__ vpool,
    float* __restrict__ kscale, float* __restrict__ vscale,
    const int* __restrict__ pos0, const int* __restrict__ slots, int C,
    int H, int D, int bs, long long num_slots, long long ksb, long long ksc,
    long long vsb, long long vsc, float inv_qmax) {
  extern __shared__ float sh[];
  float* amax = sh;            // [2H]: K heads, then V heads
  float* fac = sh + 2 * H;     // old / new, or 1
  float* wsc = sh + 4 * H;     // new, or 1 where it is 0
  __shared__ long long phys_s;
  const int i = blockIdx.x, r = blockIdx.y;
  const int p0 = max(pos0[r], 0);
  const int lb = p0 / bs + i;
  const int j0 = max(0, lb * bs - p0), j1 = min(C, (lb + 1) * bs - p0);
  if (j0 >= j1) return;
  const int* srow = slots + (long long)r * C;
  if (threadIdx.x == 0) {
    long long ph = -1;
    for (int j = j0; j < j1 && ph < 0; ++j) {
      const long long s = srow[j];
      if (s >= 0 && s < num_slots) ph = s / bs;
    }
    phys_s = ph;
  }
  __syncthreads();
  const long long phys = phys_s;
  if (phys < 0) return;
  const int HD = H * D, nj = j1 - j0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // per-head abs-max of the group's rows, one warp per (K or V, head)
  for (int t = warp; t < 2 * H; t += WARPS) {
    const int h = t % H;
    const T* src = t < H ? knew + r * ksb : vnew + r * vsb;
    const long long sc = t < H ? ksc : vsc;
    float m = 0.f;
#pragma unroll 4
    for (int e = lane; e < nj * D; e += 32) {
      const int j = j0 + e / D;
      const long long s = srow[j];
      if (s >= 0 && s < num_slots && s / bs == phys)
        m = fmaxf(m, fabsf(to_f(src[j * sc + h * D + e % D])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) amax[t] = m;
  }
  __syncthreads();
  // grow the scales: new = max(old, amax / 127), never smaller
  for (int t = threadIdx.x; t < 2 * H; t += THREADS) {
    float* sp = (t < H ? kscale : vscale) + phys * H + t % H;
    const float old = *sp;
    const float nw = fmaxf(old, amax[t] * inv_qmax);
    fac[t] = nw > 0.f ? old / nw : 1.f;
    wsc[t] = nw > 0.f ? nw : 1.f;
    *sp = nw;
  }
  __syncthreads();
  // rescale the block's old codes once where the head's scale grew: 16
  // codes per load (D % 16 == 0, so they share a head), a thread's RESC
  // loads issued before any of its stores
  constexpr int RESC = 8;
  const long long base = phys * bs * HD;
  const int nvec = 2 * bs * HD / 16;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += THREADS * RESC) {
    uint4 c[RESC];
    float f[RESC];
    uint4* ptr[RESC];
#pragma unroll
    for (int u = 0; u < RESC; ++u) {
      const int v = v0 + u * THREADS;
      f[u] = 1.f;
      if (v < nvec) {
        const int kv = v * 16 >= bs * HD;
        const int off = v * 16 - kv * bs * HD;
        f[u] = fac[kv * H + (off % HD) / D];
        ptr[u] = reinterpret_cast<uint4*>((kv ? vpool : kpool) + base + off);
        if (f[u] != 1.f) c[u] = *ptr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < RESC; ++u) {
      if (f[u] == 1.f) continue;
      c[u].x = rescale4(c[u].x, f[u]);
      c[u].y = rescale4(c[u].y, f[u]);
      c[u].z = rescale4(c[u].z, f[u]);
      c[u].w = rescale4(c[u].w, f[u]);
      *ptr[u] = c[u];
    }
  }
  __syncthreads();
  // quantize the new rows against the new scales
  for (int e = threadIdx.x; e < 2 * nj * HD; e += THREADS) {
    const int kv = e >= nj * HD;
    const int off = e - kv * nj * HD;
    const int j = j0 + off / HD, hd = off % HD;
    const long long s = srow[j];
    if (s < 0 || s >= num_slots || s / bs != phys) continue;
    const float x = kv ? to_f(vnew[r * vsb + j * vsc + hd])
                       : to_f(knew[r * ksb + j * ksc + hd]);
    (kv ? vpool : kpool)[s * HD + hd] = quantize(x / wsc[kv * H + hd / D]);
  }
}

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* knew, const void* vnew,
                        void* kpool, void* vpool, void* kscale, void* vscale,
                        const int* table, const int* pos0, const int* lens,
                        const int* slots, void* out, int B, int C, int H,
                        int nb, int bs, int maxb, long long qsb,
                        long long qsc, long long ksb, long long ksc,
                        long long vsb, long long vsc, float scale,
                        float inv_qmax, cudaStream_t stream) {
  const int groups = (C + bs - 2) / bs + 1;   // logical blocks C can span
  ragged_write_int8_kernel<T><<<dim3(groups, B), THREADS,
                                sizeof(float) * 6 * H, stream>>>(
      static_cast<const T*>(knew), static_cast<const T*>(vnew),
      static_cast<int8_t*>(kpool), static_cast<int8_t*>(vpool),
      static_cast<float*>(kscale), static_cast<float*>(vscale), pos0, slots,
      C, H, D, bs, (long long)nb * bs, ksb, ksc, vsb, vsc, inv_qmax);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return attend<T, int8_t, D>(q, kpool, vpool,
                              static_cast<const float*>(kscale),
                              static_cast<const float*>(vscale), table, pos0,
                              lens, out, B, C, H, nb, bs, maxb, qsb, qsc,
                              scale, stream);
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
  return attend<T, T, D>(q, kpool, vpool, nullptr, nullptr, table, pos0,
                         lens, out, B, C, H, nb, bs, maxb, qsb, qsc, scale,
                         stream);
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

// The int8-pool entry: the write launch, then the attend launch.  Returns
// the first CUDA error; 1 (cudaErrorInvalidValue) for a head size or type
// the kernel does not take.
extern "C" int ragged_paged_attention_int8(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, void* kscale, void* vscale, const void* table,
    const void* pos0, const void* lens, const void* slots, void* out, int B,
    int C, int H, int D, int nb, int bs, int maxb, int is_bf16,
    long long qsb, long long qsc, long long ksb, long long ksc,
    long long vsb, long long vsc, float scale, float inv_qmax,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos0);
  const int* n = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(slots);
  cudaError_t err;
#define RPA8_LAUNCH(T, DIM)                                                  \
  err = launch_int8<T, DIM>(q, knew, vnew, kpool, vpool, kscale, vscale, t,  \
                            p, n, sl, out, B, C, H, nb, bs, maxb, qsb, qsc,  \
                            ksb, ksc, vsb, vsc, scale, inv_qmax, s)
  if (D == 64 && is_bf16)
    RPA8_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    RPA8_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    RPA8_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    RPA8_LAUNCH(float, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef RPA8_LAUNCH
  return static_cast<int>(err);
}
