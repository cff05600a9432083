// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_fwd_kernel` (reached via
// `_flash_fwd` <- `flash_attention_arrays`), in its causal variant with no
// additive mask, no kv_lens and no segment ids -- the whole-prompt prefill
// of the serving engine.
//
// What bounds it on this card: at GPT-2 widths (D = 64, S <= 1024) one
// layer's causal attention is 2*S^2*H*D FLOPs over 4*S*H*D*itemsize bytes,
// about S/2 FLOPs per byte in fp32 -- above the H100's ridge point for
// S >~ 600, so the tensor cores would bound a fast kernel.  This first
// design computes with fp32 FMAs on the CUDA cores (no mma/wgmma), so it is
// bound by the CUDA cores' fp32 rate; tensor-core tiles are later work.
//
// What the design does about it: one block per (64-query tile, head,
// batch).  Four threads share a query row, each holding D/4 of q and of the
// fp32 accumulator in registers (dims d = sub + 4*i, so the four lanes of a
// row read consecutive shared-memory words).  Key/value tiles of 32 rows
// are staged once per block in shared memory as fp32 and reused by all 64
// rows.  The loop over key tiles stops at the diagonal, the online softmax
// (max m, sum l) stays in fp32, and the ragged tile edge is masked here, so
// any S works (the TPU kernel needed S % 128 == 0).  Masked logits are
// -1e30 as in the reference, and a masked key contributes exactly 0.
//
// Layout: q, k, v are [B, S, H, D] with unit stride in D and stride D
// between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy.  out is a contiguous [B, Sq, H, D] in
// the input type; lse is a contiguous fp32 [B, H, Sq].  Causal alignment is
// at the end (query i sees keys <= i + Sk - Sq), as in the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr float NEG = -1e30f;

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_causal_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int H, int Sq, int Sk, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale) {
  constexpr int DP = D / TPR;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int qpos = tile * BQ + row;
  const int offset = Sk - Sq;
  const int lim = qpos + offset;    // last key this row may attend

  float qr[DP], acc[DP];
  const T* qp = q + b * qsb + (long long)min(qpos, Sq - 1) * qss + h * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = to_f(qp[sub + TPR * i]);
    acc[i] = 0.f;
  }
  float m = NEG, l = 0.f;

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const int kend = min(Sk, tile * BQ + BQ + offset);   // exclusive
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D, kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = to_f(kb[kp * kss + d]);
        vv = to_f(vb[kp * vss + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qr[i], ks[j][sub + TPR * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      s[j] = (kp <= lim && kp < Sk) ? part * scale : NEG;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mnew = fmaxf(m, tmax);
    const float alpha = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      const float p = (kp <= lim && kp < Sk) ? expf(s[j] - mnew) : 0.f;
      psum += p;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(p, vs[j][sub + TPR * i], acc[i]);
    }
    l = l * alpha + psum;
    m = mnew;
  }

  if (qpos < Sq) {
    const float ls = fmaxf(l, 1e-30f);
    T* op = out + (((long long)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[sub + TPR * i] = from_f<T>(acc[i] / ls);
    if (sub == 0) lse[((long long)b * H + h) * Sq + qpos] = m + logf(ls);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int B, int H, int Sq, int Sk, long long qsb, long long qss,
            long long ksb, long long kss, long long vsb, long long vss,
            float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_causal_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Sq, Sk, qsb, qss, ksb, kss, vsb, vss,
      scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size or type the kernel does not take.
extern "C" int flash_fwd_causal(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int H, int Sq,
                                int Sk, int D, int is_bf16, long long qsb,
                                long long qss, long long ksb, long long kss,
                                long long vsb, long long vss, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && is_bf16)
    launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, Sq, Sk, qsb, qss, ksb,
                              kss, vsb, vss, scale, s);
  else if (D == 64)
    launch<float, 64>(q, k, v, out, lse, B, H, Sq, Sk, qsb, qss, ksb, kss,
                      vsb, vss, scale, s);
  else if (D == 128 && is_bf16)
    launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, Sq, Sk, qsb, qss,
                               ksb, kss, vsb, vss, scale, s);
  else if (D == 128)
    launch<float, 128>(q, k, v, out, lse, B, H, Sq, Sk, qsb, qss, ksb, kss,
                       vsb, vss, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
