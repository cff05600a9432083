// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, one for dQ and one for dK/dV, as in the TPU package.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (both launched by `_flash_bwd`, the backward of
// `_flash_attn_core`'s custom_vjp) in all their branches, through one
// entry each, `flash_bwd_dq` and `flash_bwd_dkv`: causal with no additive
// mask, no kv_lens and no segment ids (unpacked GPT pretraining), the
// additive mask and kv_lens, packed segment ids (packed pretraining) and
// non-causal attention.
//
// Both rebuild the probabilities from the forward's statistics instead of
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
// the tensor cores bound a fast kernel.  The TPU's sequential grid axis
// becomes a loop inside one block, and the two outputs come from two
// grids, so no block writes what another writes and no atomics are needed.
//
// The bf16 kernels run on the tensor cores (`flash_tc.cuh`), one
// warpgroup (128 threads) per block, `wgmma` m64nNk16 bf16 -> fp32, every
// operand in 128-byte-swizzled shared memory filled by 16-byte `cp.async`
// copies (zero-fill past the ragged edge), or repacked in registers from
// an accumulator.  Only the tiles that cross the diagonal, the kv_lens
// edge, a ragged edge or a segment boundary test each (query, key) pair;
// the interior tiles take the same step with no per-pair test.
//
// bf16 dQ: `flash_bwd_dq_tc_kernel`, the forward's layout.  One block per
// (64-query tile, head, batch).  Q and dO of the tile are loaded once, and
// each row's lse and delta (or the masked pair) and segment id sit in
// registers; key tiles of 64 rows (K and V, with the key ids) fill a
// two-stage `cp.async` ring, tile j+1 copied while tile j computes.  Per
// tile: S = Q K^T and dP = dO V^T (m64n64k16, Q and dO as K-major A, K
// and V as K-major B); p and ds = p (dP - delta) on the accumulator
// fragments, each thread's (row, column) pairs from `acc_row` / `acc_col`;
// then dQ += bf16(ds) K, the A operand repacked from the dP accumulator in
// registers and K read MN-major from the same tile (m64nDk16).  dQ
// accumulates in fp32 registers.  A segment tile is tested only when its
// key ids or the query tile's ids are not all one id.  The query tiles run
// longest first.
//
// bf16 dK/dV: `flash_bwd_dkv_tc_kernel`, in the transposed form, keys as
// the M dimension of `wgmma`.  One block per (64-key tile, head, batch).
// K and V are loaded once; query tiles of 64 rows (Q and dO, with their
// lse and delta -- or the masked pair -- and ids) fill the two-stage ring.
// Per tile: S^T = K Q^T and dP^T = V dO^T (K and V as A, Q and dO as
// K-major B); p^T and ds^T = p^T (dP^T - delta) on the fragments, each
// thread's columns indexing the staged statistics; then dV += bf16(p)^T
// dO and dK += bf16(ds)^T Q with the A operands repacked from the
// accumulators and dO and Q read MN-major (m64nDk16).  dK and dV
// accumulate in fp32 registers (D = 128: 255 registers, a few spilled in
// the masked and segment instantiations).
//
// fp32 dQ and dK/dV: the first design, on the CUDA cores (fp32 FMAs; no
// mma/wgmma, since TF32 would break the fp32 limits), bound by the CUDA
// cores' issue rate -- the FMAs and the shared-memory reads that feed them.
// - dQ: one block per (64-query tile, head, batch).  Four threads share a
//   query row, each holding D/4 dims of q, dO and the fp32 dq accumulator
//   in registers (dims d = sub + 4*i, so the four lanes of a row read
//   consecutive shared-memory words).  Key/value tiles of 32 rows are
//   staged once per block in shared memory as fp32; causal, the loop runs
//   from key 0 up to the diagonal.
// - dK/dV: one block per (64-key tile, head, batch), four threads per key
//   row holding D/4 dims of k, v and the two accumulators.  Query and dO
//   tiles of 32 rows are staged with their lse and delta.
// In both dK/dV designs, causal, the loop starts at the first query tile
// that can see the key tile (the query at max(k0 - (Sk - Sq), 0)) and
// runs to the end; in both dQ designs it stops at min(kv_len, the causal
// limit of the tile's last query), rounded up to a key tile.
// All mask the ragged tile edges themselves, so any S works: padding rows
// are staged as zeros and their p is set to 0, so an undefined lse is
// never used.
//
// The branches are template flags of the two kernels, MASKED, SEGS and
// CAUSAL, so that the plain causal instantiations keep their arithmetic:
// - MASKED (`:235-237`, `:243-244`, `:260-261`, `:298-301`, `:307-308`):
//   the fp32 mask is read through the forward's four element strides (0
//   broadcasts: an expanded [B, 1, 1, S] row is never copied), per tile of
//   keys for the dQ rows and per tile of queries for the dK/dV rows, and
//   added to the scaled score; keys at or past kv_len get p = 0, the dQ
//   loop stops at kv_len, and a dK/dV block whose keys all lie past it
//   visits no query (the TPU kernel visits them all with p = 0).  The
//   statistic is the pair (m, log l) of the masked forward, p =
//   exp((s - m) - log l): a row whose every key the mask closes has m ~
//   -1e30, where lse = m + log l has lost log l in fp32, and the pair gives
//   the forward's 1/n there.  The CUDA-core kernels stage the mask per
//   tile in shared memory; the tensor-core ones read each thread's pairs.
// - SEGS (`:245-247`, `:262-266`, `:309-311`, `:326-330`): a pair whose ids
//   differ gets p = 0; the dQ block visits only the key tiles inside its
//   query tile's id envelope, the dK/dV block only the query tiles inside
//   its key tile's (`_seg_kb_bounds`, for any id layout).
// - without CAUSAL (`:258-259`, `:323-324`) there is no diagonal limit.
// A block whose loop range is empty writes its rows as exact zeros.
//
// Layout: q, k, v and dO are [B, S, H, D] with unit stride in D and stride
// D between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy (bf16: 16-byte-aligned rows, strides
// a multiple of 8 elements, for the 16-byte copies).  lse, delta
// (and m) are contiguous fp32 [B, H, Sq].  dq, dk, dv are contiguous
// [B, S, H, D] in the input type.  Causal alignment is at the end (query i
// sees keys <= i + Sk - Sq).
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using flash::from_f;
using flash::round_to;
using flash::to_f;

constexpr int BR = 64;              // output rows (queries or keys) per block
constexpr int BT = 32;              // rows per staged shared-memory tile
constexpr int TPR = 4;              // threads per output row
constexpr int THREADS = BR * TPR;   // 256

// Sum over the four lanes of one row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The pointers and strides of the branches (null / 0 when absent).
struct Branches {
  const float* rowmax;   // m [B, H, Sq], with MASKED
  const float* mask;
  const int* kv_lens;
  const int* segs;
  long long msb, msh, msq, msk, ssb;
};

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Sq, int Sk, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, float scale, const Branches br) {
  constexpr int DP = D / TPR;
  __shared__ float ks[BT][D];
  __shared__ float vs[BT][D];
  __shared__ float ms[MASKED ? BR : 1][BT + 1];   // mask tile, padded
  __shared__ int kid[SEGS ? BT : 1];               // the key tile's ids
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int qpos = tile * BR + row;
  const bool live = qpos < Sq;
  const int qc = min(qpos, Sq - 1);
  const int lim = qpos + Sk - Sq;   // last key this row may attend (causal)
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;

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
  const float mr = MASKED ? br.rowmax[stat] : 0.f;

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, tile * BR + BR + Sk - Sq) : klen;  // excl.
  int qid = 0;
  if constexpr (SEGS) {
    qid = sb[qc];
    const int2 env = flash::seg_envelope<THREADS>(sb, Sk, qid, red);
    kbeg = env.x / BT * BT;
    kend = min(kend, env.y);
  }
  for (int k0 = kbeg; k0 < kend; k0 += BT) {
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
    if constexpr (MASKED) {
      if (mb) {
        for (int e = tid; e < BR * BT; e += THREADS) {
          const int rr = e / BT, j = e % BT, kp = k0 + j;
          const long long qq = min(tile * BR + rr, Sq - 1);
          ms[rr][j] = kp < Sk ? mb[qq * br.msq + kp * br.msk] : 0.f;
        }
      }
    }
    if constexpr (SEGS) {
      if (tid < BT) kid[tid] = k0 + tid < Sk ? sb[k0 + tid] : 0;
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
      bool ok = live && (!CAUSAL || kp <= lim) && kp < klen;
      if constexpr (SEGS) ok = ok && kid[j] == qid;
      float p;
      if constexpr (MASKED) {
        const float sc = mb ? s * scale + ms[row][j] : s * scale;
        p = ok ? expf((sc - mr) - l) : 0.f;
      } else {
        p = ok ? expf(s * scale - l) : 0.f;
      }
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

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  constexpr int DP = D / TPR;
  __shared__ float qs[BT][D];
  __shared__ float dos[BT][D];
  __shared__ float ls[BT];
  __shared__ float dls[BT];
  __shared__ float mrs[MASKED ? BT : 1];
  __shared__ float ms[MASKED ? BT : 1][BR + 1];   // mask tile, padded
  __shared__ int qid[SEGS ? BT : 1];               // the query tile's ids
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int kpos = tile * BR + row;
  const bool live = kpos < Sk;
  const int kc = min(kpos, Sk - 1);
  const int offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;

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
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  // causal: the first query that sees this block's first key, rounded down
  // to a tile
  int qstart = CAUSAL ? (max(tile * BR - offset, 0) / BT) * BT : 0;
  int qend = MASKED && tile * BR >= klen ? 0 : Sq;   // keys past kv_len
  int kid = 0;
  if constexpr (SEGS) {
    kid = sb[kc];
    const int2 env = flash::seg_envelope<THREADS>(sb, Sq, kid, red);
    qstart = max(qstart, env.x / BT * BT);
    qend = min(qend, env.y);
  }
  for (int q0 = qstart; q0 < qend; q0 += BT) {
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
      if constexpr (MASKED) mrs[tid] = qpos < Sq ? br.rowmax[stat0 + qpos] : 0.f;
      if constexpr (SEGS) qid[tid] = qpos < Sq ? sb[qpos] : 0;
    }
    if constexpr (MASKED) {
      if (mb) {
        for (int e = tid; e < BT * BR; e += THREADS) {
          const int i = e / BR, c = e % BR, kk = tile * BR + c;
          const long long qq = min(q0 + i, Sq - 1);
          ms[i][c] = kk < Sk ? mb[qq * br.msq + kk * br.msk] : 0.f;
        }
      }
    }
    __syncthreads();

    // unrolled by 4, the masked loop's three staged statistics and mask
    // entries per query took 239-254 registers at D = 64 (one block per
    // SM) and ran 8-17 % slower than rolled (121-128 registers)
#pragma unroll (MASKED ? 1 : 4)
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
      bool ok = live && qpos < Sq && (!CAUSAL || qpos + offset >= kpos);
      if constexpr (MASKED) ok = ok && kpos < klen;
      if constexpr (SEGS) ok = ok && qid[i] == kid;
      float p;
      if constexpr (MASKED) {
        const float sc = mb ? s * scale + ms[i][row] : s * scale;
        p = ok ? expf((sc - mrs[i]) - ls[i]) : 0.f;
      } else {
        p = ok ? expf(s * scale - ls[i]) : 0.f;
      }
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

// ---------------------------------------------------------------------------
// bf16 dQ and dK/dV: the tensor-core kernels (header comment)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace flash_tc;

constexpr int BKV = 64;         // keys per block (dK/dV) or per tile (dQ)
constexpr int BQ = 64;          // queries per tile (dK/dV) or per block (dQ)
constexpr int THREADS = WG;     // 128

// Both kernels hold two [64, D] tiles once and a two-stage ring of two
// more (dQ: Q and dO, then K and V; dK/dV: K and V, then Q and dO), all
// bf16; 1024 bytes of slack to align the tiles for the swizzle.
template <int D>
constexpr int smem_bytes() {
  return (2 * BKV + 4 * BQ) * D * 2 + 1024;
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int Sq, int Sk, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long dsb, long long dss, float scale,
    const Branches br) {
  constexpr uint32_t TILE = BQ * D * 2;   // bytes of one [64, D] tile
  extern __shared__ uint8_t smem[];
  // the key tile's ids, and the least and greatest of them per warp that
  // loads them (warps 0 and 1), one set per stage
  __shared__ int kids[SEGS ? 2 : 1][SEGS ? BKV : 1];
  __shared__ int kext[SEGS ? 2 : 1][SEGS ? 4 : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q at sq, dO at sdo; stage st holds K at sq + TILE (2 + 2 st), V after
  const uint32_t sq = (smem_addr(smem) + 1023u) & ~1023u, sdo = sq + TILE;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  // this thread's two query rows (accumulator values i with (i/2)%2 = r),
  // their statistics, mask rows and ids (rows past Sq read row Sq - 1 and
  // are never written)
  int qpos[2], qid[2] = {0, 0};
  float ls[2], dls[2], mrs[2] = {0.f, 0.f};
  const float* mrow[2] = {nullptr, nullptr};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + acc_row(2 * r, tid);
    const int qc = min(qpos[r], Sq - 1);
    const long long stat = ((long long)b * H + h) * Sq + qc;
    ls[r] = lse[stat];
    dls[r] = delta[stat];
    if constexpr (MASKED) {
      mrs[r] = br.rowmax[stat];
      if (mb) mrow[r] = mb + (long long)qc * br.msq;
    }
    if constexpr (SEGS) qid[r] = sb[qc];
  }

  const bf16* kb = k + b * ksb + h * D;
  const bf16* vb = v + b * vsb + h * D;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + BQ + offset) : klen;   // exclusive
  int qlo = 0, qhi = 0;   // the query tile's least and greatest id
  if constexpr (SEGS) {
    qlo = min(qid[0], qid[1]);
    qhi = max(qid[0], qid[1]);
    flash::block_min_max<THREADS>(qlo, qhi, red);
    const int2 env = flash::seg_envelope<THREADS>(sb, Sk, qlo, qhi, red);
    kbeg = env.x / BKV * BKV;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BKV - 1) / BKV : 0;

  // issue the copies of key tile `it` into its stage
  auto stage = [&](int it) {
    const int k0 = kbeg + it * BKV, st = it & 1;
    const uint32_t dst = sq + TILE * (2 + 2 * st);
    load_tile<BKV, D, THREADS>(dst, kb, kss, k0, Sk, tid);
    load_tile<BKV, D, THREADS>(dst + TILE, vb, vss, k0, Sk, tid);
    if constexpr (SEGS) {
      if (tid < BKV) {   // warps 0 and 1
        const int id = sb[min(k0 + tid, Sk - 1)];
        kids[st][tid] = id;
        const int lo = __reduce_min_sync(0xffffffffu, id);
        const int hi = __reduce_max_sync(0xffffffffu, id);
        if (tid % 32 == 0) {
          kext[st][2 * (tid / 32)] = lo;
          kext[st][2 * (tid / 32) + 1] = hi;
        }
      }
    }
  };
  load_tile<BQ, D, THREADS>(sq, q + b * qsb + h * D, qss, q0, Sq, tid);
  load_tile<BQ, D, THREADS>(sdo, dout + b * dsb + h * D, dss, q0, Sq, tid);
  if (ntiles > 0) stage(0);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BKV / 2], dp[BKV / 2];   // S and dP: rows queries, columns keys

  // ds = p (dP - delta) (in dp) of key tile k0 in stage st
  auto probs = [&](int k0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2, c = acc_col(i, tid), kp = k0 + c;
      float x = s[i] * scale;
      float p;
      if constexpr (MASKED) {
        if (mb && (!TEST || kp < Sk)) x += mrow[r][(long long)kp * br.msk];
        p = expf((x - mrs[r]) - ls[r]);
      } else {
        p = expf(x - ls[r]);
      }
      if constexpr (TEST) {
        bool ok = (!CAUSAL || kp <= qpos[r] + offset) && kp < klen;
        if constexpr (SEGS) ok = ok && kids[st][c] == qid[r];
        p = ok ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dls[r]);
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BKV, st = it & 1;
    const uint32_t sk = sq + TILE * (2 + 2 * st), sv = sk + TILE;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(s, desc_k<BQ>(sq, kk), desc_k<BKV>(sk, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(dp, desc_k<BQ>(sdo, kk), desc_k<BKV>(sv, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // a segment tile needs no test when its keys and the query tile all
    // carry one id
    bool mixed = false;
    if constexpr (SEGS)
      mixed = qlo != qhi || kext[st][0] != qlo || kext[st][1] != qlo ||
              kext[st][2] != qlo || kext[st][3] != qlo;
    if (mixed || k0 + BKV > klen || (CAUSAL && k0 + BKV - 1 > q0 + offset))
      probs(k0, st, std::true_type{});
    else
      probs(k0, st, std::false_type{});

    // dQ += bf16(ds) K, the A operand from the dP accumulator, K read
    // MN-major from its tile
    uint32_t da[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) pack_a(da[kk], dp, kk);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_rs<D>(acc, da[kk], desc_mn<BKV>(sk, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    bf16* op = dq + (((long long)b * Sq + qpos[r]) * H + h) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      *reinterpret_cast<__nv_bfloat162*>(op + acc_col(i, tid)) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  constexpr uint32_t KT = BKV * D * 2, QT = BQ * D * 2;   // tile bytes
  extern __shared__ uint8_t smem[];
  // the query tile's statistics (and ids), one set per stage
  __shared__ float ls[2][BQ], dls[2][BQ];
  __shared__ float mrs[MASKED ? 2 : 1][MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? 2 : 1][SEGS ? BQ : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // K at sk, V at sv; stage st holds Q at sv + KT + 2 QT st and dO after it
  const uint32_t sk = (smem_addr(smem) + 1023u) & ~1023u, sv = sk + KT;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = kt * BKV, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  // this thread's two key rows (accumulator values i with (i/2)%2 = r)
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + acc_row(2 * r, tid);

  const bf16* qb = q + b * qsb + h * D;
  const bf16* db = dout + b * dsb + h * D;
  const long long stat0 = ((long long)b * H + h) * Sq;
  const float* mb =
      MASKED && br.mask ? br.mask + b * br.msb + h * br.msh : nullptr;
  const int* sb = SEGS ? br.segs + b * br.ssb : nullptr;
  // causal: the first query that sees this block's first key, rounded down
  // to a tile; no query when every key lies past kv_len
  int qstart = CAUSAL ? (max(k0 - offset, 0) / BQ) * BQ : 0;
  int qend = MASKED && k0 >= klen ? 0 : Sq;
  int kid[2] = {0, 0};
  if constexpr (SEGS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) kid[r] = sb[min(kpos[r], Sk - 1)];
    const int2 env = flash::seg_envelope<THREADS>(
        sb, Sq, min(kid[0], kid[1]), max(kid[0], kid[1]), red);
    qstart = max(qstart, env.x / BQ * BQ);
    qend = min(qend, env.y);
  }
  const int ntiles = qend > qstart ? (qend - qstart + BQ - 1) / BQ : 0;

  // issue the copies of query tile `it` into its stage
  auto stage = [&](int it) {
    const int q0 = qstart + it * BQ, st = it & 1;
    const uint32_t dst = sv + KT + 2 * QT * st;
    load_tile<BQ, D, THREADS>(dst, qb, qss, q0, Sq, tid);
    load_tile<BQ, D, THREADS>(dst + QT, db, dss, q0, Sq, tid);
    if (tid < BQ) {
      const int qp = q0 + tid;
      const bool in = qp < Sq;
      ls[st][tid] = in ? lse[stat0 + qp] : 0.f;
      dls[st][tid] = in ? delta[stat0 + qp] : 0.f;
      if constexpr (MASKED) mrs[st][tid] = in ? br.rowmax[stat0 + qp] : 0.f;
      if constexpr (SEGS) qids[st][tid] = in ? sb[qp] : 0;
    }
  };
  load_tile<BKV, D, THREADS>(sk, k + b * ksb + h * D, kss, k0, Sk, tid);
  load_tile<BKV, D, THREADS>(sv, v + b * vsb + h * D, vss, k0, Sk, tid);
  if (ntiles > 0) stage(0);
  cp_async_commit();

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[BQ / 2], dp[BQ / 2];   // S^T and dP^T: rows keys, columns queries

  // p (in s) and ds = p (dP - delta) (in dp) of query tile q0 in stage st
  auto probs = [&](int q0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = (i / 2) % 2, c = acc_col(i, tid), qp = q0 + c;
      float x = s[i] * scale;
      float p;
      if constexpr (MASKED) {
        if (mb && (!TEST || (qp < Sq && kpos[r] < Sk)))
          x += mb[(long long)qp * br.msq + (long long)kpos[r] * br.msk];
        p = expf((x - mrs[st][c]) - ls[st][c]);
      } else {
        p = expf(x - ls[st][c]);
      }
      if constexpr (TEST) {
        bool ok = qp < Sq && (!CAUSAL || qp + offset >= kpos[r]);
        if constexpr (MASKED) ok = ok && kpos[r] < klen;
        if constexpr (SEGS) ok = ok && qids[st][c] == kid[r];
        p = ok ? p : 0.f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - dls[st][c]);
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ, st = it & 1;
    const uint32_t sq = sv + KT + 2 * QT * st, sdo = sq + QT;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(s, desc_k<BKV>(sk, kk), desc_k<BQ>(sq, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64(dp, desc_k<BKV>(sv, kk), desc_k<BQ>(sdo, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    if (SEGS || (MASKED && k0 + BKV > klen) || q0 + BQ > Sq ||
        (CAUSAL && q0 + offset < k0 + BKV - 1))
      probs(q0, st, std::true_type{});
    else
      probs(q0, st, std::false_type{});

    // dV += bf16(p)^T dO and dK += bf16(ds)^T Q, the A operands from the
    // accumulators, dO and Q read MN-major from their tiles
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<D>(dva, pa[kk], desc_mn<BQ>(sdo, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<D>(dka, da[kk], desc_mn<BQ>(sq, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Sk) continue;
    const long long o = (((long long)b * Sk + kpos[r]) * H + h) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      const int c = acc_col(i, tid);
      *reinterpret_cast<__nv_bfloat162*>(dk + o + c) =
          __floats2bfloat162_rn(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + c) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

}  // namespace tc

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Sq, Sk;
  long long qsb, qss, ksb, kss, vsb, vss, dsb, dss;
  float scale;
  cudaStream_t stream;
  Branches br;
};

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dq(const Args& a, void* dq) {
  dim3 grid((a.Sq + BR - 1) / BR, a.H, a.B);
  flash_bwd_dq_kernel<T, D, MASKED, SEGS, CAUSAL>
      <<<grid, THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
          static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(dq), a.H,
          a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb,
          a.dss, a.scale, a.br);
}

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dkv(const Args& a, void* dk, void* dv) {
  dim3 grid((a.Sk + BR - 1) / BR, a.H, a.B);
  flash_bwd_dkv_kernel<T, D, MASKED, SEGS, CAUSAL>
      <<<grid, THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
          static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(dk),
          static_cast<T*>(dv), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
          a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dq_tc(const Args& a, void* dq) {
  using tc::bf16;
  constexpr int smem = tc::smem_bytes<D>();
  auto* kernel = tc::flash_bwd_dq_tc_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + tc::BQ - 1) / tc::BQ, a.H, a.B);
  kernel<<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dq), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dkv_tc(const Args& a, void* dk, void* dv) {
  using tc::bf16;
  constexpr int smem = tc::smem_bytes<D>();
  auto* kernel = tc::flash_bwd_dkv_tc_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sk + tc::BKV - 1) / tc::BKV, a.H, a.B);
  kernel<<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Sq, a.Sk,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

// One launch of the dQ (dv null) or the dK/dV kernel for a head size and
// type; cudaErrorInvalidValue for one the kernels do not take.  bf16 takes
// the tensor-core kernels, fp32 the CUDA-core ones.
template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int D, int is_bf16, void* dq_or_dk, void* dv) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dv && is_bf16) {
    if (D == 64)
      launch_dkv_tc<64, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
    else
      launch_dkv_tc<128, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
  } else if (dv) {
    if (D == 64)
      launch_dkv<float, 64, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
    else
      launch_dkv<float, 128, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
  } else if (is_bf16) {
    if (D == 64)
      launch_dq_tc<64, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
    else
      launch_dq_tc<128, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
  } else {
    if (D == 64)
      launch_dq<float, 64, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
    else
      launch_dq<float, 128, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_branches(const Args& a, int D, int is_bf16, int causal,
                      void* dq_or_dk, void* dv) {
  const bool m = a.br.mask || a.br.kv_lens, s = a.br.segs;
  switch ((m ? 4 : 0) + (s ? 2 : 0) + (causal != 0)) {
    case 0: return dispatch<false, false, false>(a, D, is_bf16, dq_or_dk, dv);
    case 1: return dispatch<false, false, true>(a, D, is_bf16, dq_or_dk, dv);
    case 2: return dispatch<false, true, false>(a, D, is_bf16, dq_or_dk, dv);
    case 3: return dispatch<false, true, true>(a, D, is_bf16, dq_or_dk, dv);
    case 4: return dispatch<true, false, false>(a, D, is_bf16, dq_or_dk, dv);
    case 5: return dispatch<true, false, true>(a, D, is_bf16, dq_or_dk, dv);
    case 6: return dispatch<true, true, false>(a, D, is_bf16, dq_or_dk, dv);
    default: return dispatch<true, true, true>(a, D, is_bf16, dq_or_dk, dv);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int H, int Sq,
               int Sk, long long qsb, long long qss, long long ksb,
               long long kss, long long vsb, long long vss, long long dsb,
               long long dss, float scale, void* stream, Branches br) {
  return Args{q,   k,   v,   dout, lse, delta, B,   H,   Sq,    Sk,
              qsb, qss, ksb, kss,  vsb, vss,   dsb, dss, scale,
              static_cast<cudaStream_t>(stream), br};
}

Branches make_branches(const void* rowmax, const void* mask,
                       const void* kv_lens, const void* segs, long long msb,
                       long long msh, long long msq, long long msk,
                       long long ssb) {
  return Branches{static_cast<const float*>(rowmax),
                  static_cast<const float*>(mask),
                  static_cast<const int*>(kv_lens),
                  static_cast<const int*>(segs), msb, msh, msq, msk, ssb};
}

}  // namespace

// mask: fp32, element strides msb, msh, msq, msk (0 broadcasts), or null;
// kv_lens: int32 [B], or null; segs: int32 [B, S] with batch stride ssb and
// unit stride in S, or null; causal: 0 or 1.  With a mask or kv_lens, lse
// holds log l and rowmax the row max m of the masked forward; rowmax is
// ignored otherwise.  Both return cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head size the kernels do not take.
extern "C" int flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dq, int B, int H, int Sq,
    int Sk, int D, int is_bf16, int causal, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, long long dsb,
    long long dss, long long msb, long long msh, long long msq, long long msk,
    long long ssb, float scale, void* stream) {
  const Args a = make_args(
      q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss, ksb, kss, vsb, vss,
      dsb, dss, scale, stream,
      make_branches(rowmax, mask, kv_lens, segs, msb, msh, msq, msk, ssb));
  return dispatch_branches(a, D, is_bf16, causal, dq, nullptr);
}

extern "C" int flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int is_bf16, int causal, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, long long msb, long long msh, long long msq,
    long long msk, long long ssb, float scale, void* stream) {
  const Args a = make_args(
      q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss, ksb, kss, vsb, vss,
      dsb, dss, scale, stream,
      make_branches(rowmax, mask, kv_lens, segs, msb, msh, msq, msk, ssb));
  return dispatch_branches(a, D, is_bf16, causal, dk, dv);
}
