// Device helpers shared by the decode-path kernels (flash_decode.cu,
// fused_decode_layer.cu, ragged_paged_attention.cu, fused_layernorm.cu,
// the FFN sources): type conversions, vector loads, the FFN's activation,
// reductions, the last-block ticket of a cross-block sum, and the split-K
// attention of one decode query.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int VEC = 4;          // elements per vector load
constexpr float NEG = -1e30f;   // the additive mask constant of the JAX code

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The two values of a 32-bit word of a 2-byte type T (bf16 or fp16) as
// floats, the low half first; and two floats rounded into one.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
}
template <typename T>
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h2 = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h2);
  } else {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b2);
  }
}
// x rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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
__device__ __forceinline__ void load4(const __half* p, float (&x)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack2<__half>(v.x), b = unpack2<__half>(v.y);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// V consecutive elements of T at p as floats (fused_layernorm.cu,
// fused_layernorm_bwd.cu, ragged_paged_attention.cu): one or two 16-byte loads
// where p is on 16 bytes, else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[V]) {
  constexpr int PER = 16 / sizeof(T);   // elements per 16-byte load
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && V % PER == 0) {
#pragma unroll
    for (int q = 0; q < V / PER; ++q) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 4) {
          v[q * PER + j] = __uint_as_float(w[j]);
        } else {
          const float2 f = unpack2<T>(w[j]);
          v[q * PER + 2 * j] = f.x;
          v[q * PER + 2 * j + 1] = f.y;
        }
      }
    }
  } else if (sizeof(T) == 2 && V == 4 &&
             reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = unpack2<T>(r.x), b = unpack2<T>(r.y);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f(p[j]);
  }
}

// V floats rounded to T and stored at p: 16-byte stores where p is on 16
// bytes, else scalar ones.
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[V]) {
  constexpr int PER = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && V % PER == 0) {
#pragma unroll
    for (int q = 0; q < V / PER; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 4)
          w[j] = __float_as_uint(v[q * PER + j]);
        else
          w[j] = pack2f<T>(v[q * PER + 2 * j], v[q * PER + 2 * j + 1]);
      }
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f<T>(v[j]);
  }
}

// The FFN's activation in fp32 (`_ffn_act`, pallas_ops.py): 0 gelu (erf),
// 1 gelu (tanh), 2 relu.
__device__ __forceinline__ float activate(float u, int act) {
  if (act == 0) return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
  if (act == 1) {
    const float inner = 0.7978845608028654f * (u + 0.044715f * u * u * u);
    return 0.5f * u * (1.f + tanhf(inner));
  }
  return fmaxf(u, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Programmatic dependent launch (fused_ffn_decode.cu,
// ragged_paged_attention.cu): a kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it on the stream runs, once every block of that one has called
// `trigger_dependents` (or exited); `wait_prior_grid` then waits until it
// has finished and its writes are visible.
__device__ __forceinline__ void trigger_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Cross-block sums (fused_ffn.cu, fused_ffn_decode.cu, flash_decode.cu,
// ragged_paged_attention.cu, fused_decode_layer.cu):
// after this block's writes, true in the block that is the `count`-th to
// take the ticket, which resets it for the next launch.  Every thread
// calls; `flag` is shared memory.
__device__ __forceinline__ bool last_of(int* ticket, int count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == count - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// The same for one warp: after the warp's writes, true in every lane of
// the warp that is the `count`-th to take the ticket, which resets it.
__device__ __forceinline__ bool warp_last_of(int* ticket, int count) {
  __threadfence();
  __syncwarp();
  int last = 0;
  if (threadIdx.x % 32 == 0) {
    last = atomicAdd(ticket, 1) == count - 1;
    if (last) *ticket = 0;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return false;
  __threadfence();
  return true;
}

// -- split-K attention of one query -------------------------------------
//
// The key loop of flash_decode.cu, shared with fused_decode_layer.cu (both
// over a dense ring) and ragged_paged_attention.cu (through a block table,
// fp or int8 pools): the counterpart of `_prefix_attn_loop`
// (paddle_tpu/ops/pallas_ops.py), which the TPU's decode kernels share the
// same way.  A block of WARPS warps takes one split -- a run of keys of one
// (query, head) -- and each warp keeps its own online softmax:
//  - LPK = D / VE lanes cover one key row with 16-byte loads (VE = 4 fp32,
//    8 bf16 / fp16 or 16 int8 values a load), so a warp reads KPW = 32 / LPK
//    whole rows per load, and U such loads of K and of V are in flight
//    before any arithmetic;
//  - each lane dots its VE values with q, the LPK lanes of a key add
//    theirs (shuffles inside the group only), the warp's running max m
//    moves once per U loads, and each probability exp(s - m) goes to the
//    value product through the policy's `weight` (rounded to the cache
//    type, or kept in fp32 and times the value scale);
//  - `block_state` merges the warps in warp order, `merge_splits` writes a
//    split's fp32 partial (m, l, acc[D]) and, in the last block of the
//    (query, head) to finish (a self-resetting ticket, `last_of`), merges
//    the partials in split order, so the result does not depend on the
//    order in which blocks ran.
//
// A key policy `Keys` addresses the rows and owns the arithmetic that
// differs between the callers:
//   Row locate(int key)          where key `key` lives (its own type),
//   const void* k(Row), v(Row)   this lane's 16 bytes of its K / V row,
//   float logit(float dot, Row)  the score of q . k (scale, mask, k scale),
//   float weight(float p, Row)   the value product's weight of exp(s - m).

// 16 bytes of a row, kept as loaded until used (4 registers, where widened
// bf16 would take 8), and widened to 4 fp32, 8 bf16 or 16 int8 values
__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void widen(uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(uint4 v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// int8 codes, exactly: 1.5 * 2^23 + c has c in its low mantissa bits
__device__ __forceinline__ void widen(uint4 v, float (&x)[16]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = static_cast<int>(static_cast<signed char>(
        (w[i / 4] >> (8 * (i % 4))) & 0xffu));
    x[i] = __int_as_float(0x4B400000 + c) - 12582912.f;
  }
}

// Values a 16-byte load of pool element type P holds.
template <typename P>
constexpr int VE = 16 / static_cast<int>(sizeof(P));

// A 16-byte load of P widened (`widen` by the number of values, which
// takes 8 values for bf16; fp16 here).
template <typename P>
__device__ __forceinline__ void widen_as(uint4 v, float (&x)[VE<P>]) {
  if constexpr (std::is_same<P, __half>::value) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2<__half>(w[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    widen(v, x);
  }
}

// The keys of one (row, head) of a dense [B, S_max, H*D] ring: rows HD
// apart, p rounded to the cache type T before the value product where the
// TPU kernels round it (`seg_dot(p, expand)` in their `fast` type: bf16
// for a bf16 cache, fp32 otherwise, so an fp16 cache keeps p in fp32,
// `pallas_ops.py:1038`).  MASKABLE: `mrow`, if not null, is an additive
// fp32 mask over the rows.
template <typename T, bool MASKABLE>
struct RingKeys {
  const T* kb;      // K of key 0, at this lane's d0
  const T* vb;
  long long HD;
  float scale;
  const float* mrow;
  using Row = int;      // the key
  __device__ __forceinline__ Row locate(int key) const { return key; }
  __device__ __forceinline__ const T* k(Row r) const {
    return kb + (long long)r * HD;
  }
  __device__ __forceinline__ const T* v(Row r) const {
    return vb + (long long)r * HD;
  }
  __device__ __forceinline__ float logit(float dot, Row r) const {
    float s = dot * scale;
    if (MASKABLE && mrow) s += mrow[r];
    return s;
  }
  __device__ __forceinline__ float weight(float p, Row) const {
    if constexpr (std::is_same<T, __half>::value)
      return p;
    else
      return round_to<T>(p);
  }
};

// One warp's online softmax of q (this lane's VE values `qv`, dims d0 ..
// d0 + VE - 1 with d0 = (lane % LPK) * VE) over keys [first, hi) in runs
// of RUN keys: [first, first + RUN), [first + stride, ...), each cut at
// hi.  Returns the warp's m (the same in every lane), and its l and acc
// summed over the warp's key groups (the same in the LPK lanes of one d0).
// A warp with no key keeps m = NEG, l = 0, acc = 0.
template <typename P, int D, int U, int RUN, class Keys>
__device__ __forceinline__ void warp_attend(const Keys& keys,
                                            const float (&qv)[VE<P>],
                                            int first, int hi, int stride,
                                            float& m, float& l,
                                            float (&acc)[VE<P>]) {
  constexpr int LPK = D / VE<P>;        // lanes per key row
  constexpr int KPW = 32 / LPK;         // key rows per warp load
  const int grp = (threadIdx.x % 32) / LPK;
  m = NEG;
  l = 0.f;
#pragma unroll
  for (int i = 0; i < VE<P>; ++i) acc[i] = 0.f;
  for (int r0 = first; r0 < hi; r0 += stride) {
    const int r1 = min(r0 + RUN, hi);
    for (int k0 = r0; k0 < r1; k0 += U * KPW) {
      uint4 kr[U], vr[U];
      bool ok[U];
      typename Keys::Row row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = k0 + u * KPW + grp;
        ok[u] = key < r1;
        row[u] = keys.locate(ok[u] ? key : r0);
        kr[u] = load16(keys.k(row[u]));
        vr[u] = load16(keys.v(row[u]));
      }
      float s[U], mx = NEG;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kx[VE<P>], dot = 0.f;
        widen_as<P>(kr[u], kx);
#pragma unroll
        for (int i = 0; i < VE<P>; ++i) dot = fmaf(kx[i], qv[i], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u] = ok[u] ? keys.logit(dot, row[u]) : NEG;
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mnew = fmaxf(m, mx);
      const float alpha = expf(m - mnew);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < VE<P>; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[u] - mnew) : 0.f;
        l += p;
        const float pr = keys.weight(p, row[u]);
        float vx[VE<P>];
        widen_as<P>(vr[u], vx);
#pragma unroll
        for (int i = 0; i < VE<P>; ++i) acc[i] = fmaf(pr, vx[i], acc[i]);
      }
      m = mnew;
    }
  }
  // the warp's sums over its key groups
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < VE<P>; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
}

// Shared memory of `block_state` for a block of WARPS warps.
template <int WARPS, int D>
struct SplitSmem {
  float wm[WARPS], wl[WARPS], wacc[WARPS][D];
  int is_last;
};

// The block's (m, l, acc) from its warps' `warp_attend` results, warps in
// order: bm and bl in every thread, ba (dim tid) in threads tid < D.
// Every thread calls; ends with the block's shared memory free again only
// after the caller's next barrier.
template <typename P, int D, int WARPS>
__device__ __forceinline__ void block_state(SplitSmem<WARPS, D>& sh, float m,
                                            float l,
                                            const float (&acc)[VE<P>],
                                            float& bm, float& bl,
                                            float& ba) {
  constexpr int LPK = D / VE<P>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < VE<P>; ++i) sh.wacc[warp][lane * VE<P> + i] = acc[i];
  }
  if (lane == 0) {
    sh.wm[warp] = m;
    sh.wl[warp] = l;
  }
  __syncthreads();
  bm = sh.wm[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) bm = fmaxf(bm, sh.wm[w]);
  bl = 0.f;
  ba = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float f = expf(sh.wm[w] - bm);
    bl += sh.wl[w] * f;
    if (tid < D) ba += sh.wacc[w][tid] * f;
  }
}

// Writes split `split`'s partial: (m, l) to ml[split], acc to pacc[split *
// D ...].  In the last block of the `splits` to finish (ticket), merges
// the partials in split order and returns true, with gm and gl in every
// thread and ga (dim tid) in threads tid < D; false elsewhere.  Every
// thread calls.
template <int D, int WARPS>
__device__ __forceinline__ bool merge_splits(SplitSmem<WARPS, D>& sh,
                                             float2* ml, float* pacc,
                                             int* ticket, int split,
                                             int splits, float bm, float bl,
                                             float ba, float& gm, float& gl,
                                             float& ga) {
  const int tid = threadIdx.x;
  if (tid < D) pacc[(long long)split * D + tid] = ba;
  if (tid == 0) ml[split] = make_float2(bm, bl);
  if (!last_of(ticket, splits, &sh.is_last)) return false;
  // unrolled so that eight splits' loads are in flight at once; the sums
  // still run in split order
  gm = NEG;
#pragma unroll 8
  for (int x = 0; x < splits; ++x) gm = fmaxf(gm, __ldcg(ml + x).x);
  gl = 0.f;
  ga = 0.f;
#pragma unroll 8
  for (int x = 0; x < splits; ++x) {
    const float2 p = __ldcg(ml + x);
    const float f = expf(p.x - gm);
    gl += p.y * f;
    if (tid < D) ga += __ldcg(pacc + (long long)x * D + tid) * f;
  }
  return true;
}

}  // namespace decode
