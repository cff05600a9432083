// Causal flash-attention backward for Hopper (sm_90a), plain C interface:
// two kernels, one for dQ and one for dK/dV, as in the TPU package.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (both launched by `_flash_bwd`, the backward of
// `_flash_attn_core`'s custom_vjp), in their causal variant with no additive
// mask, no kv_lens and no segment ids -- the attention of GPT pretraining.
//
// Both rebuild the probabilities from the forward's logsumexp instead of
// reading a stored [S, S] matrix:
//   p  = exp(q.k * scale - lse)       dp = dO.v
//   ds = p * (dp - delta)             delta = rowsum(dO * out), given
//   dQ = scale * sum_k ds K           dK = scale * sum_q ds Q
//   dV = sum_q p dO
// Rounding points follow the TPU kernels: in bf16, p is rounded to dO's
// type before the dV product and ds to the operand's type before the dK and
// dQ products; everything else accumulates in fp32.
//
// What bounds them on this card: per visible (query, key) pair dQ does
// 6*D FLOPs and dK/dV 8*D, over 5 and 6 [S, D] slabs of bytes per head, so
// at GPT-2 widths (D = 64, S = 1024) both sit far above the ridge point and
// the tensor cores would bound a fast kernel.  This first design computes
// with fp32 FMAs on the CUDA cores (no mma/wgmma), so it is bound by the
// CUDA cores' issue rate -- the FMAs and the shared-memory reads that feed
// them; tensor-core tiles are later work.
//
// What the design does about it: the TPU's sequential grid axis becomes a
// loop inside one block, and the two outputs come from two grids, so no
// block writes what another writes and no atomics are needed.
// - dQ: one block per (64-query tile, head, batch).  Four threads share a
//   query row, each holding D/4 dims of q, dO and the fp32 dq accumulator
//   in registers (dims d = sub + 4*i, so the four lanes of a row read
//   consecutive shared-memory words).  Key/value tiles of 32 rows are
//   staged once per block in shared memory as fp32; the loop runs from key
//   0 up to the diagonal.
// - dK/dV: one block per (64-key tile, head, batch), four threads per key
//   row holding D/4 dims of k, v and the two accumulators.  Query and dO
//   tiles of 32 rows are staged with their lse and delta; the loop starts
//   at the first query tile that can see the key tile (the query at
//   max(k0 - (Sk - Sq), 0)) and runs to the end.
// Both mask the ragged tile edges themselves, so any S works: padding rows
// are staged as zeros and their p is set to 0 before the exp, so an
// undefined lse is never used.
//
// Layout: q, k, v and dO are [B, S, H, D] with unit stride in D and stride
// D between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy.  lse and delta are contiguous fp32
// [B, H, Sq].  dq, dk, dv are contiguous [B, S, H, D] in the input type.
// Causal alignment is at the end (query i sees keys <= i + Sk - Sq).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;              // output rows (queries or keys) per block
constexpr int BT = 32;              // rows per staged shared-memory tile
constexpr int TPR = 4;              // threads per output row
constexpr int THREADS = BR * TPR;   // 256

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
// x rounded to T and widened back: the cast the TPU kernel makes before a
// product with operands of type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Sum over the four lanes of one row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Sq, int Sk, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, float scale) {
  constexpr int DP = D / TPR;
  __shared__ float ks[BT][D];
  __shared__ float vs[BT][D];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int qpos = tile * BR + row;
  const bool live = qpos < Sq;
  const int qc = min(qpos, Sq - 1);
  const int lim = qpos + Sk - Sq;   // last key this row may attend

  float qr[DP], dor[DP], acc[DP];
  const T* qp = q + b * qsb + (long long)qc * qss + h * D;
  const T* dp = dout + b * dsb + (long long)qc * dss + h * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = to_f(qp[sub + TPR * i]);
    dor[i] = to_f(dp[sub + TPR * i]);
    acc[i] = 0.f;
  }
  const long long stat = ((long long)b * H + h) * Sq + qc;
  const float l = lse[stat], dl = delta[stat];

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const int kend = min(Sk, tile * BR + BR + Sk - Sq);   // exclusive
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < BT * D; e += THREADS) {
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

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(qr[i], ks[j][sub + TPR * i], s);
        dpv = fmaf(dor[i], vs[j][sub + TPR * i], dpv);
      }
      s = row_sum(s);
      dpv = row_sum(dpv);
      const int kp = k0 + j;
      const float p = (live && kp <= lim && kp < Sk)
                          ? expf(s * scale - l) : 0.f;
      const float ds = round_to<T>(p * (dpv - dl));
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(ds, ks[j][sub + TPR * i], acc[i]);
    }
  }

  if (live) {
    T* op = dq + (((long long)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[sub + TPR * i] = from_f<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale) {
  constexpr int DP = D / TPR;
  __shared__ float qs[BT][D];
  __shared__ float dos[BT][D];
  __shared__ float ls[BT];
  __shared__ float dls[BT];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int kpos = tile * BR + row;
  const bool live = kpos < Sk;
  const int kc = min(kpos, Sk - 1);
  const int offset = Sk - Sq;

  float kr[DP], vr[DP], dka[DP], dva[DP];
  const T* kp = k + b * ksb + (long long)kc * kss + h * D;
  const T* vp = v + b * vsb + (long long)kc * vss + h * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    kr[i] = to_f(kp[sub + TPR * i]);
    vr[i] = to_f(vp[sub + TPR * i]);
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  const T* qb = q + b * qsb + h * D;
  const T* db = dout + b * dsb + h * D;
  const long long stat0 = ((long long)b * H + h) * Sq;
  // the first query that sees this block's first key, rounded down to a tile
  const int qstart = (max(tile * BR - offset, 0) / BT) * BT;
  for (int q0 = qstart; q0 < Sq; q0 += BT) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < BT * D; e += THREADS) {
      const int i = e / D, d = e % D, qpos = q0 + i;
      float qv = 0.f, dv_ = 0.f;
      if (qpos < Sq) {
        qv = to_f(qb[qpos * qss + d]);
        dv_ = to_f(db[qpos * dss + d]);
      }
      qs[i][d] = qv;
      dos[i][d] = dv_;
    }
    if (tid < BT) {
      const int qpos = q0 + tid;
      ls[tid] = qpos < Sq ? lse[stat0 + qpos] : 0.f;
      dls[tid] = qpos < Sq ? delta[stat0 + qpos] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BT; ++i) {
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(kr[c], qs[i][sub + TPR * c], s);
        dpv = fmaf(vr[c], dos[i][sub + TPR * c], dpv);
      }
      s = row_sum(s);
      dpv = row_sum(dpv);
      const int qpos = q0 + i;
      const float p = (live && qpos < Sq && qpos + offset >= kpos)
                          ? expf(s * scale - ls[i]) : 0.f;
      const float pb = round_to<T>(p);
      const float ds = round_to<T>(p * (dpv - dls[i]));
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dva[c] = fmaf(pb, dos[i][sub + TPR * c], dva[c]);
        dka[c] = fmaf(ds, qs[i][sub + TPR * c], dka[c]);
      }
    }
  }

  if (live) {
    const long long o = (((long long)b * Sk + kpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      dk[o + sub + TPR * c] = from_f<T>(dka[c] * scale);
      dv[o + sub + TPR * c] = from_f<T>(dva[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Sq, Sk;
  long long qsb, qss, ksb, kss, vsb, vss, dsb, dss;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
void launch_dq(const Args& a, void* dq) {
  dim3 grid((a.Sq + BR - 1) / BR, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale);
}

template <typename T, int D>
void launch_dkv(const Args& a, void* dk, void* dv) {
  dim3 grid((a.Sk + BR - 1) / BR, a.H, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Sq, a.Sk, a.qsb,
      a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int H, int Sq,
               int Sk, long long qsb, long long qss, long long ksb,
               long long kss, long long vsb, long long vss, long long dsb,
               long long dss, float scale, void* stream) {
  return Args{q,   k,   v,   dout, lse, delta, B,   H,   Sq,    Sk,
              qsb, qss, ksb, kss,  vsb, vss,   dsb, dss, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Both return cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size the kernels do not take.
extern "C" int flash_bwd_dq_causal(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int H, int Sq, int Sk,
                                   int D, int is_bf16, long long qsb,
                                   long long qss, long long ksb,
                                   long long kss, long long vsb,
                                   long long vss, long long dsb,
                                   long long dss, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss,
                           ksb, kss, vsb, vss, dsb, dss, scale, stream);
  if (D == 64 && is_bf16)
    launch_dq<__nv_bfloat16, 64>(a, dq);
  else if (D == 64)
    launch_dq<float, 64>(a, dq);
  else if (D == 128 && is_bf16)
    launch_dq<__nv_bfloat16, 128>(a, dq);
  else if (D == 128)
    launch_dq<float, 128>(a, dq);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkv_causal(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int Sq,
                                    int Sk, int D, int is_bf16, long long qsb,
                                    long long qss, long long ksb,
                                    long long kss, long long vsb,
                                    long long vss, long long dsb,
                                    long long dss, float scale,
                                    void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss,
                           ksb, kss, vsb, vss, dsb, dss, scale, stream);
  if (D == 64 && is_bf16)
    launch_dkv<__nv_bfloat16, 64>(a, dk, dv);
  else if (D == 64)
    launch_dkv<float, 64>(a, dk, dv);
  else if (D == 128 && is_bf16)
    launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  else if (D == 128)
    launch_dkv<float, 128>(a, dk, dv);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
