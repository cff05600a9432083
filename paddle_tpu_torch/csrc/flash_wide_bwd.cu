// Flash-attention backward at head_dim 384, 512 and every larger multiple
// of 128, for Hopper (sm_90a), plain C interface: a dQ kernel and a dK/dV
// kernel, as in the TPU package.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (both launched by `_flash_bwd`, the backward of
// `_flash_attn_core`'s custom_vjp) at the head dims the JAX gate admits
// past 256 (any multiple of 128, `pallas_ops.py:646`), in all their
// branches and the three types, through one entry each, `flash_wide_dq`
// and `flash_wide_dkv`.  `flash_bwd_causal.cu` keeps D = 64, 128 and 256.
//
// Both rebuild the probabilities from the forward's statistics, as
// `flash_bwd_causal.cu` does (its header gives the formulas, the masked
// pair (m, log l), and every branch's tests and loop bounds, which these
// kernels share):
//   p  = exp(q.k * scale - lse)       dp = dO.v
//   ds = p * (dp - delta)             dQ = scale * sum_k ds K
//   dK = scale * sum_q ds Q           dV = sum_q p dO
// Rounding points follow the TPU kernels: in bf16 and fp16, p is rounded
// to dO's type before the dV product and ds to the operand's type before
// the dK and dQ products; the products of 16-bit inputs are exact in fp32
// and every sum is fp32.
//
// What bounds them on this card: per visible (query, key) pair dQ does
// 6 D FLOPs and dK/dV 8 D, so at D = 512 and S = 2048 the arithmetic
// bounds a fast kernel.  These are the simple design, on the CUDA cores in
// every type (fp32 FMAs, bound by the 67 TFLOP/s of fp32), the layout of
// the fp32 kernels at D = 256 (`flash_bwd_dq_simt_kernel`,
// `flash_bwd_dkv_simt_kernel`) with D a runtime argument: a grid axis of
// D / 128 slices gives each block one 128-column slice of its outputs, so
// every block holds the registers of a 128-wide output whatever D is.  A
// block computes S and dP over the full D, 128 columns at a time (the
// chunks of both sides copied into shared memory in turn, rows padded by
// 4 floats against bank conflicts, summed over d in the same order in
// every slice), then only its slice of the output products; S and dP are
// computed D / 128 times, the price of the runtime D.
//
// dQ: `flash_wide_dq_kernel`, eight warps per (32-query tile, head, batch
// and slice).  Per key tile of 32 keys: the Q, dO, K and V chunks in turn
// (and the tile's K slice with the first), each thread's 2 x 2 scores and
// dO.v, then ds for those pairs in shared memory, and each warp's four
// rows of dQ[:, slice] += ds K[:, slice] (4 columns a lane).  88,192
// bytes of shared memory: two blocks an SM.
//
// dK/dV: `flash_wide_dkv_kernel`, eight warps per (32-key tile, head,
// batch and slice), keys as rows.  Per query tile of 32 queries (with
// their lse, delta -- or the masked pair -- and ids): the K, V, Q and dO
// chunks in turn (and the tile's Q and dO slices with the first), each
// thread's 2 x 2 S^T and dP^T, then p and ds in shared memory, and each
// warp's four keys of dV[:, slice] += p^T dO[:, slice] and dK[:, slice]
// += ds^T Q[:, slice].  108,800 bytes of shared memory: two blocks an SM.
//
// Layout: q, k, v and dO are [B, S, H, D] with unit stride in D and stride
// D between heads; batch and sequence strides are arguments (16-byte
// aligned rows, strides a multiple of 16 bytes).  lse, delta (and m) are
// contiguous fp32 [B, H, Sq].  dq, dk, dv are contiguous [B, S, H, D] in
// the input type.  Causal alignment is at the end (query i sees keys <=
// i + Sk - Sq).  A block whose loop range is empty writes zeros.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 32;          // queries per tile (dK/dV) or per block (dQ)
constexpr int BK = 32;          // keys per block (dK/dV) or per tile (dQ)
constexpr int THREADS = 256;    // eight warps
constexpr int DS = 128;         // columns of a slice and of a chunk
constexpr int RS = DS + 4;      // row stride of a chunk tile (banks)
// dQ: Q, dO, K and V chunks, the K slice and ds
constexpr int DQ_SMEM = 4 * (4 * 32 * RS + 32 * DS + 32 * (32 + 1));
// dK/dV: K, V, Q and dO chunks, the Q and dO slices, p and ds
constexpr int DKV_SMEM = 4 * (4 * 32 * RS + 2 * 32 * DS + 2 * 32 * (32 + 1));

// The pointers and strides of the branches (null / 0 when absent).
struct Branches {
  const float* rowmax;   // m [B, H, Sq], with MASKED
  const float* mask;
  const int* kv_lens;
  const int* segs;
  long long msb, msh, msq, msk, ssb;
};

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

// acc[i][j] += sum_d a[ra + i][d] b[rb + 16 j][d] and the same of c and e
// into acc2, for i, j < 2, over the 128 columns of shared [32, RS] chunks,
// fp32 FMAs summed over d in order.
__device__ __forceinline__ void dot2x2(const float* a, const float* b,
                                       const float* c, const float* e,
                                       int ra, int rb, float (&acc)[2][2],
                                       float (&acc2)[2][2]) {
#pragma unroll 2
  for (int d = 0; d < DS; d += 4) {
    float4 x[2], y[2], z[2], w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (ra + i) * RS + d);
      y[i] = *reinterpret_cast<const float4*>(b + (rb + 16 * i) * RS + d);
      z[i] = *reinterpret_cast<const float4*>(c + (ra + i) * RS + d);
      w[i] = *reinterpret_cast<const float4*>(e + (rb + 16 * i) * RS + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        acc2[i][j] = fmaf(z[i].x, w[j].x, acc2[i][j]);
        acc2[i][j] = fmaf(z[i].y, w[j].y, acc2[i][j]);
        acc2[i][j] = fmaf(z[i].z, w[j].z, acc2[i][j]);
        acc2[i][j] = fmaf(z[i].w, w[j].w, acc2[i][j]);
      }
  }
}

// o[r][.] += sum_j w[row0 + r][j] m[j][4 lane .. 4 lane + 3] over the 32
// rows j of a shared [32, DS] slice, for the warp's four rows r; w a
// shared [32, 33] tile.
__device__ __forceinline__ void rows_times(const float* w, const float* m,
                                           int row0, int lane,
                                           float (&o)[4][4]) {
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const float4 m4 = *reinterpret_cast<const float4*>(m + j * DS + 4 * lane);
    const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float pr = w[(row0 + r) * 33 + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] = fmaf(pr, mv[e], o[r][e]);
    }
  }
}

// The warp's four rows of o (times `mul`) to rows row0 .. row0 + 3 of
// [B, n, H, D] at `out` (batch b, head h), columns 4 lane .. + 3 of the
// slice, rows at or past n skipped.
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void put4(T* p, const float (&v)[4]) {
  __align__(8) T t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) t[e] = narrow<T>(v[e]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(t);
}
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&o)[4][4],
                                           float mul, int b, int h, int H,
                                           int n, int D, int slice,
                                           int row0, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    const float v[4] = {o[r][0] * mul, o[r][1] * mul, o[r][2] * mul,
                        o[r][3] * mul};
    put4(out + (((long long)b * n + row) * H + h) * D + slice * DS +
             4 * lane, v);
  }
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_wide_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Sq, int Sk, int D, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long dsb, long long dss, float scale,
    const Branches br) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // Q chunk [BQ][RS]
  float* dos = qs + BQ * RS;          // dO chunk [BQ][RS]
  float* ks = dos + BQ * RS;          // K chunk [BK][RS]
  float* vs = ks + BK * RS;           // V chunk [BK][RS]
  float* ksl = vs + BK * RS;          // K slice [BK][DS]
  float* dss_ = ksl + BK * DS;        // ds [BQ][BK + 1]
  __shared__ float ls[BQ], dls[BQ], mrs[MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? BQ : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int chunks = D / DS;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z / chunks;
  const int slice = blockIdx.z % chunks, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  const T* qb = q + b * qsb + h * D;
  const T* db = dout + b * dsb + h * D;
  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  // the tile's rows' statistics (rows past Sq read row Sq - 1 and are
  // never written)
  if (tid < BQ) {
    const long long stat =
        ((long long)b * H + h) * Sq + min(q0 + tid, Sq - 1);
    ls[tid] = lse[stat];
    dls[tid] = delta[stat];
    if constexpr (MASKED) mrs[tid] = br.rowmax[stat];
  }
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

  // S and dP: rows sr, sr + 1 and keys sc, sc + 16 of the tile a thread;
  // dQ: warp w holds rows 4w .. 4w + 3, lane l columns 4 l .. 4 l + 3
  const int sr = 2 * (tid / 16), sc = tid % 16, orow = 4 * warp;
  float o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    // S = Q K^T and dP = dO V^T over the full D
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float pa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();   // the previous chunk (and tile) is no longer read
      load_chunk<T>(qs, RS, qb + c * DS, qss, q0, Sq, tid);
      load_chunk<T>(dos, RS, db + c * DS, dss, q0, Sq, tid);
      load_chunk<T>(ks, RS, kb + c * DS, kss, k0, Sk, tid);
      load_chunk<T>(vs, RS, vb + c * DS, vss, k0, Sk, tid);
      if (c == 0) load_chunk<T>(ksl, DS, kb + slice * DS, kss, k0, Sk, tid);
      __syncthreads();
      dot2x2(qs, ks, dos, vs, sr, sc, sa, pa);
    }
    // ds = p (dP - delta), rounded to k's type for the dQ product
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sr + i, qp = q0 + row, qc = min(qp, Sq - 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + sc + 16 * j;
        float x = sa[i][j] * scale;
        float p;
        if constexpr (MASKED) {
          if (mb && kp < Sk)
            x += mb[(long long)qc * br.msq + (long long)kp * br.msk];
          p = expf((x - mrs[row]) - ls[row]);
        } else {
          p = expf(x - ls[row]);
        }
        bool ok = (!CAUSAL || kp <= qp + offset) && kp < klen;
        if constexpr (SEGS) ok = ok && sb[min(kp, Sk - 1)] == qids[row];
        p = ok ? p : 0.f;
        dss_[row * (BK + 1) + sc + 16 * j] =
            rounded<T>(p * (pa[i][j] - dls[row]));
      }
    }
    __syncthreads();   // the tile's ds

    // dQ[:, slice] += dS K[:, slice]
    rows_times(dss_, ksl, orow, lane, o);
  }
  store_rows(dq, o, scale, b, h, H, Sq, D, slice, q0 + orow, lane);
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_wide_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk, int D,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                    // K chunk [BK][RS]
  float* vs = ks + BK * RS;           // V chunk [BK][RS]
  float* qs = vs + BK * RS;           // Q chunk [BQ][RS]
  float* dos = qs + BQ * RS;          // dO chunk [BQ][RS]
  float* qsl = dos + BQ * RS;         // Q slice [BQ][DS]
  float* dosl = qsl + BQ * DS;        // dO slice [BQ][DS]
  float* ps = dosl + BQ * DS;         // p [BK][BQ + 1]
  float* dss_ = ps + BK * (BQ + 1);   // ds [BK][BQ + 1]
  __shared__ float ls[BQ], dls[BQ], mrs[MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? BQ : 1], kids[SEGS ? BK : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int chunks = D / DS;
  const int h = blockIdx.y, b = blockIdx.z / chunks;
  const int slice = blockIdx.z % chunks, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  const T* qb = q + b * qsb + h * D;
  const T* db = dout + b * dsb + h * D;
  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const long long stat0 = ((long long)b * H + h) * Sq;
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  // causal: the first query that sees this block's first key, rounded down
  // to a tile; no query when every key lies past kv_len
  int qstart = CAUSAL ? (max(k0 - offset, 0) / BQ) * BQ : 0;
  int qend = MASKED && k0 >= klen ? 0 : Sq;
  if constexpr (SEGS) {
    const int own = sb[min(k0 + tid % BK, Sk - 1)];
    if (tid < BK) kids[tid] = own;
    const int2 env = flash::seg_envelope<THREADS>(sb, Sq, own, red);
    qstart = max(qstart, env.x / BQ * BQ);
    qend = min(qend, env.y);
  }
  const int ntiles = qend > qstart ? (qend - qstart + BQ - 1) / BQ : 0;

  // S^T and dP^T: keys sr, sr + 1 and queries sc, sc + 16 of the tile a
  // thread; dK and dV: warp w holds keys 4w .. 4w + 3, lane l columns
  // 4 l .. 4 l + 3
  const int sr = 2 * (tid / 16), sc = tid % 16, orow = 4 * warp;
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[r][e] = dva[r][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ;
    // S^T = K Q^T and dP^T = V dO^T over the full D
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float pa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();   // the previous chunk (and tile) is no longer read
      load_chunk<T>(ks, RS, kb + c * DS, kss, k0, Sk, tid);
      load_chunk<T>(vs, RS, vb + c * DS, vss, k0, Sk, tid);
      load_chunk<T>(qs, RS, qb + c * DS, qss, q0, Sq, tid);
      load_chunk<T>(dos, RS, db + c * DS, dss, q0, Sq, tid);
      if (c == 0) {
        load_chunk<T>(qsl, DS, qb + slice * DS, qss, q0, Sq, tid);
        load_chunk<T>(dosl, DS, db + slice * DS, dss, q0, Sq, tid);
        if (tid < BQ) {
          const int qp = q0 + tid;
          const bool in = qp < Sq;
          ls[tid] = in ? lse[stat0 + qp] : 0.f;
          dls[tid] = in ? delta[stat0 + qp] : 0.f;
          if constexpr (MASKED) mrs[tid] = in ? br.rowmax[stat0 + qp] : 0.f;
          if constexpr (SEGS) qids[tid] = in ? sb[qp] : 0;
        }
      }
      __syncthreads();
      dot2x2(ks, qs, vs, dos, sr, sc, sa, pa);
    }
    // p^T and ds^T = p (dP - delta); p rounded to dO's type for the dV
    // product, ds to q's for the dK product
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sr + i, kp = k0 + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = sc + 16 * j, qp = q0 + c;
        float x = sa[i][j] * scale;
        float p;
        if constexpr (MASKED) {
          if (mb && qp < Sq && kp < Sk)
            x += mb[(long long)qp * br.msq + (long long)kp * br.msk];
          p = expf((x - mrs[c]) - ls[c]);
        } else {
          p = expf(x - ls[c]);
        }
        bool ok = qp < Sq && (!CAUSAL || qp + offset >= kp);
        if constexpr (MASKED) ok = ok && kp < klen;
        if constexpr (SEGS) ok = ok && qids[c] == kids[row];
        p = ok ? p : 0.f;
        ps[row * (BQ + 1) + c] = rounded<T>(p);
        dss_[row * (BQ + 1) + c] = rounded<T>(p * (pa[i][j] - dls[c]));
      }
    }
    __syncthreads();   // the tile's p and ds

    // dV[:, slice] += P^T dO[:, slice] and dK[:, slice] += dS^T Q[:, slice]
    rows_times(ps, dosl, orow, lane, dva);
    rows_times(dss_, qsl, orow, lane, dka);
  }
  store_rows(dk, dka, scale, b, h, H, Sk, D, slice, k0 + orow, lane);
  store_rows(dv, dva, 1.f, b, h, H, Sk, D, slice, k0 + orow, lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Sq, Sk, D;
  long long qsb, qss, ksb, kss, vsb, vss, dsb, dss;
  float scale;
  cudaStream_t stream;
  Branches br;
};

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch_dq(const Args& a, void* dq) {
  auto* kernel = flash_wide_dq_kernel<T, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B * (a.D / DS));
  kernel<<<grid, THREADS, DQ_SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.H, a.Sq, a.Sk, a.D, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch_dkv(const Args& a, void* dk, void* dv) {
  auto* kernel = flash_wide_dkv_kernel<T, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B * (a.D / DS));
  kernel<<<grid, THREADS, DKV_SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Sq, a.Sk, a.D,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the dQ (dv null) or the dK/dV kernel for a type code (0
// fp32, 1 bf16, 2 fp16); cudaErrorInvalidValue for one it does not take.
template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch(const Args& a, void* dq_or_dk, void* dv) {
  return dv ? launch_dkv<T, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv)
            : launch_dq<T, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
}

template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int dtype, void* dq_or_dk, void* dv) {
  switch (dtype) {
    case 0: return launch<float, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
    case 1:
      return launch<__nv_bfloat16, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
    case 2: return launch<__half, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_branches(const Args& a, int dtype, int causal, void* dq_or_dk,
                      void* dv) {
  if (a.D <= 0 || a.D % DS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool m = a.br.mask || a.br.kv_lens, s = a.br.segs;
  switch ((m ? 4 : 0) + (s ? 2 : 0) + (causal != 0)) {
    case 0: return dispatch<false, false, false>(a, dtype, dq_or_dk, dv);
    case 1: return dispatch<false, false, true>(a, dtype, dq_or_dk, dv);
    case 2: return dispatch<false, true, false>(a, dtype, dq_or_dk, dv);
    case 3: return dispatch<false, true, true>(a, dtype, dq_or_dk, dv);
    case 4: return dispatch<true, false, false>(a, dtype, dq_or_dk, dv);
    case 5: return dispatch<true, false, true>(a, dtype, dq_or_dk, dv);
    case 6: return dispatch<true, true, false>(a, dtype, dq_or_dk, dv);
    default: return dispatch<true, true, true>(a, dtype, dq_or_dk, dv);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* rowmax,
               const void* mask, const void* kv_lens, const void* segs,
               int B, int H, int Sq, int Sk, int D, long long qsb,
               long long qss, long long ksb, long long kss, long long vsb,
               long long vss, long long dsb, long long dss, long long msb,
               long long msh, long long msq, long long msk, long long ssb,
               float scale, void* stream) {
  const Branches br{static_cast<const float*>(rowmax),
                    static_cast<const float*>(mask),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(segs), msb, msh, msq, msk, ssb};
  return Args{q,   k,   v,   dout, lse, delta, B,   H,   Sq,    Sk, D,
              qsb, qss, ksb, kss,  vsb, vss,   dsb, dss, scale,
              static_cast<cudaStream_t>(stream), br};
}

}  // namespace

// The arguments of `flash_bwd_dq` / `flash_bwd_dkv` (flash_bwd_causal.cu):
// mask fp32 with element strides msb, msh, msq, msk (0 broadcasts), or
// null; kv_lens int32 [B], or null; segs int32 [B, S] with batch stride ssb
// and unit stride in S, or null; causal 0 or 1.  With a mask or kv_lens,
// lse holds log l and rowmax the row max m of the masked forward; rowmax
// is ignored otherwise.  dtype: the element type's code (0 fp32, 1 bf16, 2
// fp16).  Both return cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head size that is not a positive multiple
// of 128 or a type code they do not take.
extern "C" int flash_wide_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dq, int B, int H, int Sq,
    int Sk, int D, int dtype, int causal, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, long long dsb,
    long long dss, long long msb, long long msh, long long msq, long long msk,
    long long ssb, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, rowmax, mask, kv_lens,
                           segs, B, H, Sq, Sk, D, qsb, qss, ksb, kss, vsb,
                           vss, dsb, dss, msb, msh, msq, msk, ssb, scale,
                           stream);
  return dispatch_branches(a, dtype, causal, dq, nullptr);
}

extern "C" int flash_wide_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int dtype, int causal, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, long long msb, long long msh, long long msq,
    long long msk, long long ssb, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, rowmax, mask, kv_lens,
                           segs, B, H, Sq, Sk, D, qsb, qss, ksb, kss, vsb,
                           vss, dsb, dss, msb, msh, msq, msk, ssb, scale,
                           stream);
  return dispatch_branches(a, dtype, causal, dk, dv);
}
