// Flash-attention forward at head_dim 384, 512 and every larger multiple
// of 128, for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_fwd_kernel` (reached via
// `_flash_fwd` <- `flash_attention_arrays`) at the head dims its gate
// admits past 256 (`pallas_ops.py:646`: any multiple of 128), in all its
// branches (causal, the additive mask and kv_lens, segment ids,
// non-causal) and the three types, through one entry, `flash_wide_fwd`.
// `flash_fwd_causal.cu` keeps D = 64, 128 and 256.
//
// What bounds it on this card: per visible (query, key) pair 4 D FLOPs
// over 4 [S, D] slabs of bytes a head, so at D = 512 and S = 2048 some
// S / 2 FLOPs a byte: the arithmetic bounds a fast kernel.  This one is
// the simple design, not the fast one: every type runs on the CUDA cores
// (fp32 FMAs, bound by the 67 TFLOP/s of fp32), as the fp32 kernel at
// D = 256 (`flash_fwd_simt_kernel`) does.
//
// Why not the D <= 256 kernels: they take D as a template parameter and
// hold a query tile's whole output in registers.  At D = 512 that is 256
// fp32 registers a thread in one warpgroup, and a template per head dim
// cannot cover every multiple of 128.  Here D is a runtime argument and a
// grid axis of D / 128 slices gives each block one 128-column slice of
// the output: a block computes the scores S = Q K^T of its query tile over
// the full D (128 columns at a time, Q and K chunks copied into shared
// memory in turn) and O[:, slice] = softmax(S) V[:, slice].  Every block
// holds the registers of a 128-wide output, whatever D is; the price is S
// computed D / 128 times.  S is summed over d in the same order in every
// slice, so every slice's softmax is the same arithmetic, and the block of
// slice 0 writes lse (and with MASKED the pair m, log l).
//
// The block: eight warps per (32-query tile, head, batch and slice).  Per
// key tile of 32 keys: for each 128-column chunk, the Q and K chunks (rows
// padded by 4 floats against bank conflicts) and, with the first chunk,
// the tile's V slice land in shared memory as fp32; each thread sums 2 x 2
// scores over d in order; then the scores are scaled, masked and excluded,
// each warp runs the online softmax of four rows (a key a lane) and adds
// p V to its four rows of O (4 columns a lane).  Shared memory 54,400
// bytes: four blocks an SM.
//
// Rounding follows the TPU kernel: scores, the mask, the statistics and
// the output sum stay fp32 in every type (bf16 and fp16 products are exact
// in fp32); in bf16 and fp16 p is rounded to the input type for the P V
// product at the running max of its key tile (`pallas_ops.py:181`), and l
// sums the unrounded fp32 p (`:180`).  The branches are template flags,
// MASKED, SEGS and CAUSAL, with the tests, statistics and loop bounds of
// `flash_fwd_causal.cu` (its header says what each branch does): the key
// loop stops at the diagonal, kv_lens ends it, a segment tile envelope
// (`flash::seg_envelope`) starts and ends it, the ragged edges are
// masked, so any S works.
//
// Layout: q, k, v are [B, S, H, D] with unit stride in D and stride D
// between heads; batch and sequence strides are arguments (16-byte-aligned
// rows, strides a multiple of 16 bytes).  out is a contiguous [B, Sq, H,
// D] in the input type; lse (and rowmax, logsum) contiguous fp32 [B, H,
// Sq].  Causal alignment is at the end (query i sees keys <= i + Sk - Sq).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 256;    // eight warps
constexpr int DS = 128;         // columns of a slice and of a chunk
constexpr int RS = DS + 4;      // row stride of a Q or K chunk (banks)
constexpr int SMEM = 4 * (BQ * RS + BK * RS + BK * DS + BQ * (BK + 1));

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half(x);
}
// x rounded to T (to nearest even) and widened back
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return widen(narrow<T>(x));
}

// Rows row0 .. row0 + 31 of the 128 columns at g (row stride `stride`
// elements of T, 16-byte-aligned rows) into shared fp32 rows of `ld`
// floats; rows at or past n are zeros.  All THREADS threads call.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int ld,
                                           const T* __restrict__ g,
                                           long long stride, int row0,
                                           int n, int tid) {
  constexpr int EPV = 16 / sizeof(T);   // elements a 16-byte vector
  constexpr int VPR = DS / EPV;         // vectors a row
#pragma unroll
  for (int i = 0; i < 32 * VPR / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / VPR, c = e % VPR;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      u = __ldg(reinterpret_cast<const uint4*>(
                    g + (long long)(row0 + r) * stride) + c);
    const T* x = reinterpret_cast<const T*>(&u);
    float* d = dst + r * ld + c * EPV;
#pragma unroll
    for (int j = 0; j < EPV; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(widen(x[j]), widen(x[j + 1]), widen(x[j + 2]),
                      widen(x[j + 3]));
  }
}

// Four consecutive outputs of type T at p (8- or 16-byte aligned).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  __align__(8) T t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) t[e] = narrow<T>(v[e]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_wide_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ rowmax, float* __restrict__ logsum,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    const int* __restrict__ segs, int H, int Sq, int Sk, int D,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long msb, long long msh,
    long long msq, long long msk, long long ssb, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // Q chunk [BQ][RS]
  float* ks = qs + BQ * RS;           // K chunk [BK][RS]
  float* vs = ks + BK * RS;           // V slice [BK][DS]
  float* ss = vs + BK * DS;           // [BQ][BK + 1]: scores, then p
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  __shared__ int qids[SEGS ? BQ : 1];
  const int chunks = D / DS;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z / chunks;
  const int slice = blockIdx.z % chunks, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen = MASKED && kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  const T* qb = q + b * qsb + h * D;
  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D + slice * DS;
  const float* mb = MASKED && mask ? mask + b * msb + h * msh : nullptr;
  const int* sb = SEGS ? segs + b * ssb : nullptr;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + BQ + offset) : klen;   // exclusive
  if constexpr (SEGS) {
    const int own = sb[min(q0 + tid % BQ, Sq - 1)];
    if (tid < BQ) qids[tid] = own;
    const int2 env = flash::seg_envelope<THREADS>(sb, Sk, own, red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // scores: rows sr, sr + 1 and keys sc, sc + 16 of the tile a thread
  const int sr = 2 * (tid / 16), sc = tid % 16;
  // O and the softmax: warp w holds rows 4w .. 4w + 3, lane l columns
  // 4 l .. 4 l + 3 of the slice
  const int orow = 4 * warp;
  float o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;
  // running max (the same in every lane) and this lane's part of the sum
  // of each row; an excluded key is -inf, and the max starts at -1e30
  // (-inf when MASKED, so that any finite mask value stays exact)
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = MASKED ? -INFINITY : NEG;
    l[r] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    // S = Q K^T over the full D, 128 columns at a time, fp32 products
    // summed over d in order
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();   // the previous chunk (and tile) is no longer read
      load_chunk<T>(qs, RS, qb + c * DS, qss, q0, Sq, tid);
      load_chunk<T>(ks, RS, kb + c * DS, kss, k0, Sk, tid);
      if (c == 0) load_chunk<T>(vs, DS, vb, vss, k0, Sk, tid);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DS; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + sr * RS + d);
        const float4 qc =
            *reinterpret_cast<const float4*>(qs + (sr + 1) * RS + d);
        const float4 ka = *reinterpret_cast<const float4*>(ks + sc * RS + d);
        const float4 kc =
            *reinterpret_cast<const float4*>(ks + (sc + 16) * RS + d);
        const float qv[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                                {qc.x, qc.y, qc.z, qc.w}};
        const float kv[2][4] = {{ka.x, ka.y, ka.z, ka.w},
                                {kc.x, kc.y, kc.z, kc.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              acc[i][j] = fmaf(qv[i][e], kv[j][e], acc[i][j]);
      }
    }
    // scale, mask and exclude
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + sr + i, qc = min(qp, Sq - 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + sc + 16 * j;
        float x = acc[i][j] * scale;
        if constexpr (MASKED) {
          if (mb && kp < Sk) x += mb[(long long)qc * msq + kp * msk];
        }
        bool ok = (!CAUSAL || kp <= qp + offset) && kp < klen;
        if constexpr (SEGS) ok = ok && sb[min(kp, Sk - 1)] == qids[sr + i];
        ss[(sr + i) * (BK + 1) + sc + 16 * j] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax of the warp's four rows, a key a lane; p (rounded to
    // T) over the score it comes from, l summing the unrounded p
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* sp = ss + (orow + r) * (BK + 1) + lane;
      const float x = *sp;
      float mx = x;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      mx = fmaxf(m[r], mx);
      const bool empty = MASKED && mx == -INFINITY;   // no key yet
      alpha[r] = empty ? 1.f : expf(m[r] - mx);
      const float base = empty ? 0.f : mx;
      m[r] = mx;
      const float p = expf(x - base);
      l[r] = l[r] * alpha[r] + p;
      *sp = rounded<T>(p);
    }
    __syncwarp();   // the warp's rows of p

    // O[:, slice] = alpha O + P V[:, slice]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + j * DS +
                                                         4 * lane);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = ss[(orow + r) * (BK + 1) + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][e] = fmaf(pr, vv[e], o[r][e]);
      }
    }
  }

  T* ob = out + ((long long)b * Sq * H + h) * D + slice * DS + 4 * lane;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lt = l[r];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, s);
    const float ls = fmaxf(lt, 1e-30f);
    const int qp = q0 + orow + r;
    if (qp >= Sq) continue;
    const float ov[4] = {o[r][0] / ls, o[r][1] / ls, o[r][2] / ls,
                         o[r][3] / ls};
    store4(ob + (long long)qp * H * D, ov);
    if (slice == 0 && lane == 0) {
      const long long row = ((long long)b * H + h) * Sq + qp;
      lse[row] = m[r] + logf(ls);
      if constexpr (MASKED) {
        rowmax[row] = m[r];
        logsum[row] = logf(ls);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse, *rowmax, *logsum;
  const float* mask;
  const int *kv_lens, *segs;
  int B, H, Sq, Sk, D;
  long long qsb, qss, ksb, kss, vsb, vss, msb, msh, msq, msk, ssb;
  float scale;
  cudaStream_t stream;
};

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch(const Args& a) {
  auto* kernel = flash_wide_fwd_kernel<T, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B * (a.D / DS));
  kernel<<<grid, THREADS, SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
      static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H, a.Sq,
      a.Sk, a.D, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh,
      a.msq, a.msk, a.ssb, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The element type by its code (0 fp32, 1 bf16, 2 fp16); any other code is
// refused.
template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int dtype) {
  switch (dtype) {
    case 0: return launch<float, MASKED, SEGS, CAUSAL>(a);
    case 1: return launch<__nv_bfloat16, MASKED, SEGS, CAUSAL>(a);
    case 2: return launch<__half, MASKED, SEGS, CAUSAL>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of `flash_fwd` (flash_fwd_causal.cu): mask fp32 with
// element strides msb, msh, msq, msk (0 broadcasts), or null; kv_lens int32
// [B], or null; segs int32 [B, S] with batch stride ssb and unit stride in
// S, or null; causal 0 or 1; rowmax and logsum the fp32 [B, H, Sq] outputs
// of m and log l, written with a mask or kv_lens (null otherwise); dtype
// the element type's code (0 fp32, 1 bf16, 2 fp16).  Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for a
// head size that is not a positive multiple of 128 or a type code it does
// not take.
extern "C" int flash_wide_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* rowmax, void* logsum, const void* mask, const void* kv_lens,
    const void* segs, int B, int H, int Sq, int Sk, int D, int dtype,
    int causal, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long msb, long long msh,
    long long msq, long long msk, long long ssb, float scale, void* stream) {
  if (D <= 0 || D % DS != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   k,   v,   out, lse, rowmax, logsum,
               static_cast<const float*>(mask),
               static_cast<const int*>(kv_lens),
               static_cast<const int*>(segs),
               B,   H,   Sq,  Sk,  D,   qsb,    qss,    ksb, kss, vsb, vss,
               msb, msh, msq, msk, ssb, scale,
               static_cast<cudaStream_t>(stream)};
  const bool m = mask || kv_lens, s = segs;
  switch ((m ? 4 : 0) + (s ? 2 : 0) + (causal != 0)) {
    case 0: return dispatch<false, false, false>(a, dtype);
    case 1: return dispatch<false, false, true>(a, dtype);
    case 2: return dispatch<false, true, false>(a, dtype);
    case 3: return dispatch<false, true, true>(a, dtype);
    case 4: return dispatch<true, false, false>(a, dtype);
    case 5: return dispatch<true, false, true>(a, dtype);
    case 6: return dispatch<true, true, false>(a, dtype);
    default: return dispatch<true, true, true>(a, dtype);
  }
}
