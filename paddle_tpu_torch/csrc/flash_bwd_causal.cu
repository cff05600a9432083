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
// Rounding points follow the TPU kernels: in bf16 and fp16, p is rounded
// to dO's type before the dV product and ds to the operand's type before
// the dK and dQ products; everything else accumulates in fp32.  In fp16 a
// loss-scaled ds may pass 65504 and round to inf, as in the TPU kernel;
// the gradient is then not finite and the loss scaler skips the step.
//
// What bounds them on this card: per visible (query, key) pair dQ does
// 6*D FLOPs and dK/dV 8*D, over 5 and 6 [S, D] slabs of bytes per head, so
// at GPT-2 widths (D = 64, S = 1024) both sit far above the ridge point and
// the tensor cores bound a fast kernel.  The TPU's sequential grid axis
// becomes a loop inside one block, and the two outputs come from two
// grids, so no block writes what another writes and no atomics are needed.
//
// The bf16 and fp16 kernels (one template, instantiated per 16-bit type T;
// the entries take the type as a code: 0 fp32, 1 bf16, 2 fp16) run on the
// tensor cores (`flash_tc.cuh`), one
// warpgroup (128 threads) per block, `wgmma` m64nNk16 T -> fp32, every
// operand in 128-byte-swizzled shared memory filled by 16-byte `cp.async`
// copies (zero-fill past the ragged edge), or repacked in registers from
// an accumulator.  Only the tiles that cross the diagonal, the kv_lens
// edge, a ragged edge or a segment boundary test each (query, key) pair;
// the interior tiles take the same step with no per-pair test.
//
// bf16 / fp16 dQ: `flash_bwd_dq_tc_kernel`, the forward's layout.  One
// block per (64-query tile, head, batch).  Q and dO of the tile are loaded once, and
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
// bf16 / fp16 dK/dV: `flash_bwd_dkv_tc_kernel`, in the transposed form, keys as
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
// bf16 / fp16 at D = 256 (Gemma 2B's and GPT-J's head size), where one
// warpgroup cannot hold its accumulators.  dQ: the layout above with key
// tiles of 32 (`dq_key_tile`): dQ takes 64 x 256 fp32 a warpgroup, 128
// registers a thread, and S and dP of 32 keys 16 each (m64n32k16
// products); dQ += ds K is an m64n256k16 product.  Q and dO with two
// stages of K and V: (2 * 64 + 4 * 32) * 256 * 2 + 1024 = 132,096 bytes.
// dK/dV (`Dkv`): dK and dV of 64 keys x 256 would take 256 registers a
// thread in one warpgroup, so a block is two warpgroups over the same 64
// keys, each owning 128 of the 256 columns of dK and dV.  Of the three
// ways to split the work -- (a) two warpgroups that compute S^T and dP^T
// once and share them, (b) a grid axis over the halves of D, each block
// computing S^T and dP^T over the full D itself (12 D FLOPs a pair
// against 8 D), (c) one pass for dV and one for dK (10 D) -- this is (a):
// per query tile (32 queries; the ring's two stages of Q and dO), the
// first warpgroup takes S^T = K Q^T and the second dP^T = V dO^T, each an
// m64n32k16 product over the full D, and each hands its accumulator to
// the other through shared memory (16 KB, a value a thread at a time, no
// bank conflict), so both hold S^T and dP^T in their fragments and both
// compute p and ds (the exponentials twice, the products once); then each
// runs dV += p^T dO and dK += ds^T Q over its 128 columns (m64n128k16,
// the A operands from its registers, dO and Q read MN-major from their
// 64-column blocks 2w and 2w + 1).  dK and dV: 128 registers a thread;
// shared memory (2 * 64 + 4 * 32) * 256 * 2 + 16,384 + 1024 = 148,480
// bytes.  At D = 64 and 128 both kernels are the instantiations of before
// (one warpgroup, 64-key and 64-query tiles).
//
// fp32 dK/dV: `flash_bwd_dkv_tc32_kernel`, on the tensor cores in split
// TF32 (`flash_tc.cuh`, last section): each fp32 product is three TF32
// `wgmma` products (m64nNk8) of the operands' hi and lo parts, lo_a hi_b
// + hi_a lo_b + hi_a hi_b, as close to the exact product as an fp32
// product is.  The bf16 kernel's form: keys as M, the same statistics,
// branches and per-pair tests; p and ds stay fp32.  K and V are loaded
// once and split in place into hi and lo tiles (the A operands of S^T =
// K Q^T and dP^T = V dO^T, from shared memory).  TF32 operands are
// K-major only, so Q and dO serve in two layouts: as loaded ([queries,
// D]) for S^T and dP^T, and transposed ([D, queries], the queries of each
// group of 8 permuted to match the A fragments in registers, `tf32_a`)
// for dV += P^T dO and dK += dS^T Q, whose A operands come from the S^T
// and dP^T accumulators.  Per query tile: Q and dO have landed by
// `cp.async` in a raw buffer R; they are split into four tiles X0..X3
// for S^T and dP^T, and the next tile's copy into R starts at once (its
// statistics go to the other of two sets); once S^T and dP^T are done,
// the threads read each value back from X as hi + lo (exact) and
// overwrite X0..X3 with the transposes, split again; dV and then dK
// accumulate in fp32 registers, one product's A fragments live at a time.
// D = 64: two warpgroups a block, each owning 64 keys and sharing the
// 64-query tiles (the staging of Q and dO is done once for 128 keys, and
// eight warps hide each other's latency), 227 KB of shared memory, all
// a block may take.  D = 128: one warpgroup, 32-query tiles, 226 KB.
// Measured at the training shape on the H100 (PERF.md, PR 10): one
// warpgroup with 64-query tiles and a raw copy kept (161 KB) took 0.58
// ms; 32-query tiles with no raw copy, two blocks an SM, 0.48; two
// warpgroups, 0.44; with the prefetch into R and the addresses of the
// tile tasks recomputed in the loop (`fresh_tid`: kept across it they
// spilled 90-180 bytes), 0.42.  dV and dK are summed in one level over
// every query tile: the tensor core's truncated fp32 sums cost them ~0.15
// of the fp32 limit (1e-4 max|ref|) there.
//
// fp32 dQ: `flash_bwd_dq_tc32_kernel`, on the tensor cores in split TF32
// (the products as in the dK/dV above), in the bf16 dQ's form: queries as
// M, the same statistics, branches and per-pair tests; p and ds stay
// fp32.  What bounds it: as the dK/dV, the products at 495 / 3 TFLOP/s
// (three TF32 passes), plus the splits and the transpose on the CUDA
// cores.  Q and dO are loaded once and split in place into hi and lo
// tiles (the A operands of S = Q K^T and dP = dO V^T, from shared
// memory).  Per key tile: K and V land by `cp.async` in their hi tiles;
// the threads write K^T hi and lo ([D, keys], the keys of each group of 8
// permuted to match the dS fragments, `tf32_a`: dQ += dS K needs K with
// the keys as its reduction, and TF32 operands are K-major only), split V
// in place, then K in place; S and dP; once every warpgroup's S and dP are
// done the next tile's copy into the K hi and V hi tiles starts, and runs
// under ds = p (dP - delta) and dQ += dS K, whose A operands come from the
// dP accumulator in registers.  dQ is summed in one level over every key
// tile, as dK and dV are: the tensor core's truncated sums stay a small
// share of the 1e-4 max|ref| limit (emulated at S = 1024: 0.03 at randn
// scale 1, 0.24-0.43 at scale 4, where a per-tile second level buys
// 0.02-0.03 of it; 0.09 with an additive randn*2 mask at S = 896, 0.02
// with two levels: tests/test_torch_port_tf32_dq_ffn.py), and a second
// accumulator would cost D/2 registers.  D = 64: two warpgroups a
// block, each owning 64 queries and sharing 64-key tiles (the splits and
// the transpose are done once for 128 queries); D = 128: one warpgroup,
// 32-key tiles; 225 KB of shared memory either way.  Causal, a warpgroup
// skips the products of a key tile that lies past all of its queries.
// Measured at the training shape on the H100 (PERF.md, PR 11): 0.36 ms,
// against 1.45 for the CUDA-core kernel it replaced.
//
// fp32 at D = 256: `flash_bwd_dq_simt_kernel` and
// `flash_bwd_dkv_simt_kernel`, on the CUDA cores (fp32 FMAs, bound by the
// 67 TFLOP/s of fp32).  Split TF32 does not fit a block there: the sizes
// above (4 KT + 6 QT + 1024) come to ~449 KB at 32-row tiles, and dK and
// dV alone would take 256 registers a thread.  One block of eight warps
// per (32-query tile, head, batch) for dQ, per (32-key tile, head, batch)
// for dK/dV, the forward's CUDA-core layout (`flash_fwd_causal.cu`
// `flash_fwd_simt_kernel`): the block's own rows (Q and dO, or K and V)
// copied into shared memory once, the other side's tiles of 32 rows per
// step (rows padded by 4 floats against bank conflicts; four [32, 260]
// tiles and two [32, 33] ones, 141,568 bytes, one block an SM); each
// thread sums 2 x 2 scores and 2 x 2 dO.v over d in order (`dot2x2`),
// forms p and ds for those pairs (dK/dV keeps p too) in shared memory,
// and each warp then sums its four rows of dQ (or of dK and dV) over the
// tile's 32 rows, 8 columns a lane (`rows_times`).  The same statistics,
// branches, per-pair tests and loop bounds as the kernels above; every
// pair is tested.
// In the dK/dV kernels, causal, the loop starts at the first query tile
// that can see the key tile (the query at max(k0 - (Sk - Sq), 0)) and
// runs to the end; in the dQ kernels it stops at min(kv_len, the causal
// limit of the tile's last query), rounded up to a key tile.
// All mask the ragged tile edges themselves, so any S works: padding rows
// are copied as zeros and their p is set to 0, so an undefined lse is
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
//   the forward's 1/n there.  Each thread reads the mask at its own
//   pairs.
// - SEGS (`:245-247`, `:262-266`, `:309-311`, `:326-330`): a pair whose ids
//   differ gets p = 0; the dQ block visits only the key tiles inside its
//   query tile's id envelope, the dK/dV block only the query tiles inside
//   its key tile's (`_seg_kb_bounds`, for any id layout).
// - without CAUSAL (`:258-259`, `:323-324`) there is no diagonal limit.
// A block whose loop range is empty writes its rows as exact zeros.
//
// Layout: q, k, v and dO are [B, S, H, D] with unit stride in D and stride
// D between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy (16-byte-aligned rows, strides a
// multiple of 16 bytes, for the 16-byte copies).  lse, delta
// (and m) are contiguous fp32 [B, H, Sq].  dq, dk, dv are contiguous
// [B, S, H, D] in the input type.  Causal alignment is at the end (query i
// sees keys <= i + Sk - Sq).
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

// The pointers and strides of the branches (null / 0 when absent).
struct Branches {
  const float* rowmax;   // m [B, H, Sq], with MASKED
  const float* mask;
  const int* kv_lens;
  const int* segs;
  long long msb, msh, msq, msk, ssb;
};

// ---------------------------------------------------------------------------
// bf16 and fp16 dQ and dK/dV: the tensor-core kernels (header comment)
// ---------------------------------------------------------------------------

namespace tc {

using namespace flash_tc;

constexpr int BKV = 64;         // keys per block (dK/dV)
constexpr int BQ = 64;          // queries per block (dQ)
constexpr int THREADS = WG;     // 128 (dQ)

// keys per tile of the dQ kernel: 64, or 32 at D = 256, where dQ alone
// takes 128 registers a thread (S and dP of 32 keys 16 each)
template <int D>
constexpr int dq_key_tile = D == 256 ? 32 : 64;

// dQ holds Q and dO ([64, D]) once and a two-stage ring of K and V ([BK,
// D]), all of the 2-byte type T; 1024 bytes of slack to align the tiles
// for the swizzle.
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BQ + 4 * dq_key_tile<D>) * D * 2 + 1024;
}

// dK/dV per head size: warpgroups a block, each owning DC = D / WGS
// columns of dK and dV (two at D = 256, where dK and dV of 64 keys would
// take 256 registers a thread in one), and queries per tile.  The shared
// memory: K and V ([64, D]) once, a two-stage ring of Q and dO ([BQ, D]),
// all of type T, and at D = 256 the hand-over of S^T and dP^T (fp32, one
// [64, BQ] accumulator a warpgroup); 1024 bytes of slack.
template <int D>
struct Dkv {
  static constexpr int WGS = D == 256 ? 2 : 1;
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int THREADS = WGS * WG;
  static constexpr int DC = D / WGS;
  static constexpr int XCH = WGS > 1 ? WGS * BKV * BQ * 4 : 0;
  static constexpr int SMEM = (2 * BKV + 4 * BQ) * D * 2 + XCH + 1024;
};

// T: __nv_bfloat16 or __half, the inputs' and the outputs' type and the
// operand type of every product (p and ds rounded to T).
template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int Sq, int Sk, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long dsb, long long dss, float scale,
    const Branches br) {
  constexpr int BK = dq_key_tile<D>;
  constexpr uint32_t QT = BQ * D * 2;   // bytes of the [64, D] Q or dO tile
  constexpr uint32_t KT = BK * D * 2;   // ... of one [BK, D] K or V tile
  extern __shared__ uint8_t smem[];
  // the key tile's ids, and the least and greatest of them per warp that
  // loads them (warps 0 .. BK / 32 - 1), one set per stage
  __shared__ int kids[SEGS ? 2 : 1][SEGS ? BK : 1];
  __shared__ int kext[SEGS ? 2 : 1][SEGS ? 2 * BK / 32 : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q at sq, dO at sdo; stage st holds K at sdo + QT + 2 KT st, V after
  const uint32_t sq = (smem_addr(smem) + 1023u) & ~1023u, sdo = sq + QT;
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

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + BQ + offset) : klen;   // exclusive
  int qlo = 0, qhi = 0;   // the query tile's least and greatest id
  if constexpr (SEGS) {
    qlo = min(qid[0], qid[1]);
    qhi = max(qid[0], qid[1]);
    flash::block_min_max<THREADS>(qlo, qhi, red);
    const int2 env = flash::seg_envelope<THREADS>(sb, Sk, qlo, qhi, red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // issue the copies of key tile `it` into its stage
  auto stage = [&](int it) {
    const int k0 = kbeg + it * BK, st = it & 1;
    const uint32_t dst = sdo + QT + 2 * KT * st;
    load_tile<BK, D, THREADS>(dst, kb, kss, k0, Sk, tid);
    load_tile<BK, D, THREADS>(dst + KT, vb, vss, k0, Sk, tid);
    if constexpr (SEGS) {
      if (tid < BK) {   // warps 0 .. BK / 32 - 1
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
  float s[BK / 2], dp[BK / 2];   // S and dP: rows queries, columns keys

  // ds = p (dP - delta) (in dp) of key tile k0 in stage st
  auto probs = [&](int k0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
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
    const int k0 = kbeg + it * BK, st = it & 1;
    const uint32_t sk = sdo + QT + 2 * KT * st, sv = sk + KT;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_nk<BK, T>(s, desc_k<BQ>(sq, kk), desc_k<BK>(sk, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_nk<BK, T>(dp, desc_k<BQ>(sdo, kk), desc_k<BK>(sv, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // a segment tile needs no test when its keys and the query tile all
    // carry one id
    bool mixed = false;
    if constexpr (SEGS) {
      mixed = qlo != qhi;
#pragma unroll
      for (int w = 0; w < 2 * BK / 32; ++w) mixed = mixed || kext[st][w] != qlo;
    }
    if (mixed || k0 + BK > klen || (CAUSAL && k0 + BK - 1 > q0 + offset))
      probs(k0, st, std::true_type{});
    else
      probs(k0, st, std::false_type{});

    // dQ += T(ds) K, the A operand from the dP accumulator, K read
    // MN-major from its tile
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a<T>(da[kk], dp, kk);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<D, T>(acc, da[kk], desc_mn<BK>(sk, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    T* op = dq + (((long long)b * Sq + qpos[r]) * H + h) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)
      store2<T>(op + acc_col(i, tid), acc[i] * scale, acc[i + 1] * scale);
  }
}

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(Dkv<D>::THREADS) flash_bwd_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ, WGS = C::WGS, THREADS = C::THREADS, DC = C::DC;
  constexpr uint32_t KT = BKV * D * 2, QT = BQ * D * 2;   // tile bytes
  extern __shared__ uint8_t smem[];
  // the query tile's statistics (and ids), one set per stage
  __shared__ float ls[2][BQ], dls[2][BQ];
  __shared__ float mrs[MASKED ? 2 : 1][MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? 2 : 1][SEGS ? BQ : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // K at sk, V at sv; stage st holds Q at sv + KT + 2 QT st and dO after
  // it; with two warpgroups the hand-over of S^T and dP^T after the ring
  const uint32_t base = smem_addr(smem);
  const uint32_t sk = (base + 1023u) & ~1023u, sv = sk + KT;
  float* const xch = reinterpret_cast<float*>(smem + (sv + KT + 4 * QT - base));
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = WGS > 1 ? tid / WG : 0, wtid = WGS > 1 ? tid % WG : tid;
  const int k0 = kt * BKV, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  // this thread's two key rows (accumulator values i with (i/2)%2 = r),
  // the same in every warpgroup
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + acc_row(2 * r, wtid);

  const T* qb = q + b * qsb + h * D;
  const T* db = dout + b * dsb + h * D;
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

  // this warpgroup's DC columns of dK and dV
  float dka[DC / 2], dva[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[BQ / 2], dp[BQ / 2];   // S^T and dP^T: rows keys, columns queries

  // p (in s) and ds = p (dP - delta) (in dp) of query tile q0 in stage st
  auto probs = [&](int q0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = (i / 2) % 2, c = acc_col(i, wtid), qp = q0 + c;
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
    if constexpr (WGS == 1) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_nk<BQ, T>(s, desc_k<BKV>(sk, kk), desc_k<BQ>(sq, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_nk<BQ, T>(dp, desc_k<BKV>(sv, kk), desc_k<BQ>(sdo, kk), 1);
      mma_commit();
      mma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    } else {
      // warpgroup 0 takes S^T, warpgroup 1 dP^T, each over the full D;
      // each hands its accumulator to the other through shared memory
      // (value i of thread t at [w][i][t]), so both hold both
      float mine[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) mine[i] = 0.f;
      const uint32_t sa = wg ? sv : sk, sbt = wg ? sdo : sq;
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_nk<BQ, T>(mine, desc_k<BKV>(sa, kk), desc_k<BQ>(sbt, kk), 1);
      mma_commit();
      mma_wait<0>();
      fence_regs(mine);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        xch[(wg * (BQ / 2) + i) * WG + wtid] = mine[i];
      __syncthreads();   // both accumulators are handed over
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const float other = xch[((1 - wg) * (BQ / 2) + i) * WG + wtid];
        s[i] = wg ? other : mine[i];
        dp[i] = wg ? mine[i] : other;
      }
    }

    if (SEGS || (MASKED && k0 + BKV > klen) || q0 + BQ > Sq ||
        (CAUSAL && q0 + offset < k0 + BKV - 1))
      probs(q0, st, std::true_type{});
    else
      probs(q0, st, std::false_type{});

    // dV += T(p)^T dO and dK += T(ds)^T Q over this warpgroup's columns,
    // the A operands from the accumulators, dO and Q read MN-major from
    // their tiles (DC / 64 of their 64-column blocks)
    const uint32_t col = wg * (DC / 64) * (BQ * 128);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pack_a<T>(pa[kk], s, kk);
      pack_a<T>(da[kk], dp, kk);
    }
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<DC, T>(dva, pa[kk], desc_mn<BQ>(sdo + col, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<DC, T>(dka, da[kk], desc_mn<BQ>(sq + col, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Sk) continue;
    const long long o =
        (((long long)b * Sk + kpos[r]) * H + h) * D + wg * DC;
#pragma unroll
    for (int i = 2 * r; i < DC / 2; i += 4) {
      const int c = acc_col(i, wtid);
      store2<T>(dk + o + c, dka[i] * scale, dka[i + 1] * scale);
      store2<T>(dv + o + c, dva[i], dva[i + 1]);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 dK/dV: the split-TF32 tensor-core kernel (header comment)
// ---------------------------------------------------------------------------

namespace tc32 {

using namespace flash_tc;

constexpr int BKV = 64;         // keys per warpgroup

// Per head size: warpgroups per block (each owns 64 keys and shares the
// query tiles) and queries per tile.  The shared memory: K hi, K lo, V
// hi, V lo ([64, D] per warpgroup, loaded once); the next query tile's Q
// and dO as loaded (R); and four tiles X0..X3: Q hi, Q lo, dO hi, dO lo
// ([BQ, D]) for S^T and dP^T, then overwritten by Q^T hi, Q^T lo, dO^T
// hi, dO^T lo ([D, BQ]) for dK and dV.  All fp32, plus 1024 bytes of
// slack to align the tiles for the swizzle, and the statistics of two
// query tiles: D = 64, two warpgroups and 64-query tiles, 227 KB, all a
// block may take (with MASKED and SEGS); D = 128, one warpgroup and
// 32-query tiles, 226 KB.  Registers: 254-255 at D = 64 (up to 64 bytes
// spilled with MASKED), 255 at D = 128 (390-510 bytes spilled: dK and
// dV alone hold 128 a thread there).
template <int D>
struct Cfg {
  static constexpr int WGS = D == 64 ? 2 : 1;
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int THREADS = WGS * WG;
  static constexpr uint32_t KT = BKV * D * 4, QT = BQ * D * 4;
  static constexpr int SMEM = 4 * WGS * KT + 6 * QT + 1024;
};

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(Cfg<D>::THREADS) flash_bwd_dkv_tc32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, WGS = C::WGS, THREADS = C::THREADS;
  constexpr uint32_t KT = C::KT, QT = C::QT;
  constexpr int NT = transpose_tasks<BQ, D, THREADS>;
  extern __shared__ uint8_t smem[];
  // the statistics (and ids) of two query tiles, by tile parity
  __shared__ float ls[2][BQ], dls[2][BQ];
  __shared__ float mrs[MASKED ? 2 : 1][MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? 2 : 1][SEGS ? BQ : 1];
  // K hi of warpgroup w at skh + w KT, its K lo at skl + w KT; V likewise;
  // the next tile's Q at rq and dO at rdo
  const uint32_t base = smem_addr(smem);
  const uint32_t skh = (base + 1023u) & ~1023u;
  const uint32_t skl = skh + WGS * KT, svh = skl + WGS * KT;
  const uint32_t svl = svh + WGS * KT, rq = svl + WGS * KT, rdo = rq + QT;
  const uint32_t x0 = rdo + QT, x1 = x0 + QT, x2 = x1 + QT, x3 = x2 + QT;
  // the id envelope's scratch, in X0 before the loop uses it (all 227 KB
  // are taken)
  int* const red = reinterpret_cast<int*>(smem + (x0 - base));
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int wg = tid / WG, wtid = tid % WG;
  const int k0 = blockIdx.x * WGS * BKV, offset = Sk - Sq;
  const int kw0 = k0 + wg * BKV;   // this warpgroup's first key
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  // this thread's two key rows (accumulator values i with (i/2)%2 = r)
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = kw0 + acc_row(2 * r, wtid);

  const float* qb = q + b * qsb + h * D;
  const float* db = dout + b * dsb + h * D;
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

  // issue the copies of query tile `it` into R, and store its statistics
  auto stage = [&](int it, int tid) {
    const int q0 = qstart + it * BQ, st = it & 1;
    load_tile_f32<BQ, D, THREADS>(rq, qb, qss, q0, Sq, tid);
    load_tile_f32<BQ, D, THREADS>(rdo, db, dss, q0, Sq, tid);
    if (tid < BQ) {
      const int qp = q0 + tid;
      const bool in = qp < Sq;
      ls[st][tid] = in ? lse[stat0 + qp] : 0.f;
      dls[st][tid] = in ? delta[stat0 + qp] : 0.f;
      if constexpr (MASKED) mrs[st][tid] = in ? br.rowmax[stat0 + qp] : 0.f;
      if constexpr (SEGS) qids[st][tid] = in ? sb[qp] : 0;
    }
  };
#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    load_tile_f32<BKV, D, THREADS>(skh + w * KT, k + b * ksb + h * D, kss,
                                   k0 + w * BKV, Sk, tid);
    load_tile_f32<BKV, D, THREADS>(svh + w * KT, v + b * vsb + h * D, vss,
                                   k0 + w * BKV, Sk, tid);
  }
  cp_async_commit();
  if (ntiles > 0) stage(0, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // K and V have landed
  split_tile<WGS * KT, THREADS>(skh, skh, skl, tid);
  split_tile<WGS * KT, THREADS>(svh, svh, svl, tid);
  const uint32_t wkh = skh + wg * KT, wkl = skl + wg * KT;
  const uint32_t wvh = svh + wg * KT, wvl = svl + wg * KT;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[BQ / 2], dp[BQ / 2];   // S^T and dP^T: rows keys, columns queries

  // p (in s) and ds = p (dP - delta) (in dp) of query tile q0, parity st
  auto probs = [&](int q0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = (i / 2) % 2, c = acc_col(i, wtid), qp = q0 + c;
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
    const int tid = fresh_tid();   // tile addresses: recomputed, not kept
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed in R; tile it - 1 is done
    // Q and dO split into X0..X3, K-major as they were loaded
    split_tile<QT, THREADS>(rq, x0, x1, tid);
    split_tile<QT, THREADS>(rdo, x2, x3, tid);
    fence_async_smem();
    __syncthreads();   // the split tiles are visible to wgmma; R is read
    if (it + 1 < ntiles) stage(it + 1, tid);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T, the small terms first
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      mma_tf32_ss<BQ>(s, desc_k<BKV>(wkl, kk), desc_k<BQ>(x0, kk));
      mma_tf32_ss<BQ>(s, desc_k<BKV>(wkh, kk), desc_k<BQ>(x1, kk));
      mma_tf32_ss<BQ>(s, desc_k<BKV>(wkh, kk), desc_k<BQ>(x0, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      mma_tf32_ss<BQ>(dp, desc_k<BKV>(wvl, kk), desc_k<BQ>(x2, kk));
      mma_tf32_ss<BQ>(dp, desc_k<BKV>(wvh, kk), desc_k<BQ>(x3, kk));
      mma_tf32_ss<BQ>(dp, desc_k<BKV>(wvh, kk), desc_k<BQ>(x2, kk));
    }
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // X0..X3 become Q^T and dO^T ([D, BQ], the queries permuted as the A
    // fragments need), each from its hi + lo (exactly the value loaded)
    float t[NT][8];
    transpose_read<BQ, D, THREADS, true>(x0, x1, t, tid);
    __syncthreads();   // every warp's products and reads of Q are done
    transpose_write<BQ, D, THREADS>(t, x0, x1, tid);
    transpose_read<BQ, D, THREADS, true>(x2, x3, t, tid);
    __syncthreads();   // dO is read
    transpose_write<BQ, D, THREADS>(t, x2, x3, tid);

    if (SEGS || (MASKED && kw0 + BKV > klen) || q0 + BQ > Sq ||
        (CAUSAL && q0 + offset < kw0 + BKV - 1))
      probs(q0, st, std::true_type{});
    else
      probs(q0, st, std::false_type{});

    fence_async_smem();
    __syncthreads();   // the transposes are visible to wgmma

    // dV += P^T dO, then dK += dS^T Q, the A operands from the
    // accumulators: one product's fragments live at a time (both at once
    // spilled hundreds of bytes at either D)
    {
      uint32_t ph[BQ / 8][4], pl[BQ / 8][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) tf32_a(ph[kk], pl[kk], s, kk);
      fence_frag(ph);
      fence_frag(pl);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        mma_tf32_rs<D>(dva, pl[kk], desc_k<D>(x2, kk));
        mma_tf32_rs<D>(dva, ph[kk], desc_k<D>(x3, kk));
        mma_tf32_rs<D>(dva, ph[kk], desc_k<D>(x2, kk));
      }
      mma_commit();
      mma_wait<0>();
      fence_regs(dva);
      fence_frag(ph);
      fence_frag(pl);
    }
    {
      uint32_t dh[BQ / 8][4], dl[BQ / 8][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) tf32_a(dh[kk], dl[kk], dp, kk);
      fence_frag(dh);
      fence_frag(dl);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        mma_tf32_rs<D>(dka, dl[kk], desc_k<D>(x0, kk));
        mma_tf32_rs<D>(dka, dh[kk], desc_k<D>(x1, kk));
        mma_tf32_rs<D>(dka, dh[kk], desc_k<D>(x0, kk));
      }
      mma_commit();
      mma_wait<0>();
      fence_regs(dka);
      fence_frag(dh);
      fence_frag(dl);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Sk) continue;
    const long long o = (((long long)b * Sk + kpos[r]) * H + h) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      const int c = acc_col(i, wtid);
      *reinterpret_cast<float2*>(dk + o + c) =
          make_float2(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<float2*>(dv + o + c) = make_float2(dva[i], dva[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 dQ: the split-TF32 tensor-core kernel (header comment)
// ---------------------------------------------------------------------------

// Per head size: warpgroups per block (each owns 64 queries and shares the
// key tiles) and keys per tile.  The shared memory: Q hi, Q lo, dO hi, dO
// lo ([64, D] per warpgroup, split in place once loaded); then per key
// tile K hi, K lo, V hi, V lo ([BK, D]; K and V land raw in their hi
// tiles and are split in place) and K^T hi, K^T lo ([D, BK], the keys of
// each group of 8 permuted as the dS fragments need).  All fp32, plus 1024
// bytes of slack to align the tiles for the swizzle: 225 KB at either
// head size, one block an SM.
template <int D>
struct DqCfg {
  static constexpr int WGS = D == 64 ? 2 : 1;
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr int THREADS = WGS * WG;
  static constexpr uint32_t QT = 64 * D * 4, KT = BK * D * 4;
  static constexpr int SMEM = 4 * WGS * QT + 6 * KT + 1024;
};

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(DqCfg<D>::THREADS) flash_bwd_dq_tc32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Sq, int Sk, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long dsb, long long dss, float scale,
    const Branches br) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK, WGS = C::WGS, THREADS = C::THREADS;
  constexpr uint32_t QT = C::QT, KT = C::KT;
  extern __shared__ uint8_t smem[];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q hi of warpgroup w at sqh + w QT, its Q lo at sql + w QT; dO
  // likewise; the key tile's K hi, K lo, V hi, V lo, K^T hi, K^T lo
  const uint32_t sqh = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sql = sqh + WGS * QT, sdh = sql + WGS * QT;
  const uint32_t sdl = sdh + WGS * QT, skh = sdl + WGS * QT;
  const uint32_t skl = skh + KT, svh = skl + KT, svl = svh + KT;
  const uint32_t sth = svl + KT, stl = sth + KT;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int wg = tid / WG, wtid = tid % WG;
  const int q0 = tile * 64 * WGS, offset = Sk - Sq;
  const int qw0 = q0 + 64 * wg;   // this warpgroup's first query
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
    qpos[r] = qw0 + acc_row(2 * r, wtid);
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

  const float* kb = k + b * ksb + h * D;
  const float* vb = v + b * vsb + h * D;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + 64 * WGS + offset) : klen;   // excl.
  if constexpr (SEGS) {
    const int2 env = flash::seg_envelope<THREADS>(
        sb, Sk, min(qid[0], qid[1]), max(qid[0], qid[1]), red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // key tile `it` as loaded, into the K hi and V hi tiles
  auto stage = [&](int it, int tid) {
    const int k0 = kbeg + it * BK;
    load_tile_f32<BK, D, THREADS>(skh, kb, kss, k0, Sk, tid);
    load_tile_f32<BK, D, THREADS>(svh, vb, vss, k0, Sk, tid);
  };
#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    load_tile_f32<64, D, THREADS>(sqh + w * QT, q + b * qsb + h * D, qss,
                                  q0 + 64 * w, Sq, tid);
    load_tile_f32<64, D, THREADS>(sdh + w * QT, dout + b * dsb + h * D, dss,
                                  q0 + 64 * w, Sq, tid);
  }
  cp_async_commit();
  if (ntiles > 0) stage(0, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // Q and dO have landed
  split_tile<WGS * QT, THREADS>(sqh, sqh, sql, tid);
  split_tile<WGS * QT, THREADS>(sdh, sdh, sdl, tid);
  const uint32_t wqh = sqh + wg * QT, wql = sql + wg * QT;
  const uint32_t wdh = sdh + wg * QT, wdl = sdl + wg * QT;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2], dp[BK / 2];   // S and dP: rows queries, columns keys

  // ds = p (dP - delta) (in dp) of key tile k0
  auto probs = [&](int k0, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2, kp = k0 + acc_col(i, wtid);
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
        if constexpr (SEGS) ok = ok && sb[min(kp, Sk - 1)] == qid[r];
        p = ok ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dls[r]);
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    const int tid = fresh_tid();   // tile addresses: recomputed, not kept
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed; tile it - 1 is done
    // K as K^T hi and lo, V split in place; then K split in place
    transpose_split<BK, D, THREADS>(skh, sth, stl, tid);
    split_tile<KT, THREADS>(svh, svh, svl, tid);
    __syncthreads();   // K has been read
    split_tile<KT, THREADS>(skh, skh, skl, tid);
    fence_async_smem();
    __syncthreads();   // the split tiles are visible to wgmma

    // a warpgroup whose queries all precede the tile's first key skips it
    const bool live = !CAUSAL || k0 <= qw0 + 63 + offset;
    if (live) {
      // S = Q K^T and dP = dO V^T, the small terms first
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        mma_tf32_ss<BK>(s, desc_k<64>(wql, kk), desc_k<BK>(skh, kk));
        mma_tf32_ss<BK>(s, desc_k<64>(wqh, kk), desc_k<BK>(skl, kk));
        mma_tf32_ss<BK>(s, desc_k<64>(wqh, kk), desc_k<BK>(skh, kk));
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        mma_tf32_ss<BK>(dp, desc_k<64>(wdl, kk), desc_k<BK>(svh, kk));
        mma_tf32_ss<BK>(dp, desc_k<64>(wdh, kk), desc_k<BK>(svl, kk));
        mma_tf32_ss<BK>(dp, desc_k<64>(wdh, kk), desc_k<BK>(svh, kk));
      }
      mma_commit();
      mma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    }
    __syncthreads();   // every warpgroup's S and dP are done: K, V are free
    if (it + 1 < ntiles) stage(it + 1, tid);
    cp_async_commit();
    if (!live) continue;

    if (SEGS || k0 + BK > klen || (CAUSAL && k0 + BK - 1 > qw0 + offset))
      probs(k0, std::true_type{});
    else
      probs(k0, std::false_type{});

    // dQ += dS K: dS_lo K^T_hi + dS_hi K^T_lo + dS_hi K^T_hi, the A
    // operands from the dP accumulator, summed into dQ in one level (the
    // tensor core's truncated sums cost it a small share of the limit:
    // tests/test_torch_port_tf32.py)
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) tf32_a(ah[kk], al[kk], dp, kk);
    fence_frag(ah);
    fence_frag(al);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      mma_tf32_rs<D>(acc, al[kk], desc_k<D>(sth, kk));
      mma_tf32_rs<D>(acc, ah[kk], desc_k<D>(stl, kk));
      mma_tf32_rs<D>(acc, ah[kk], desc_k<D>(sth, kk));
    }
    mma_commit();
    mma_wait<0>();
    fence_regs(acc);
    fence_frag(ah);
    fence_frag(al);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    float* op = dq + (((long long)b * Sq + qpos[r]) * H + h) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)
      *reinterpret_cast<float2*>(op + acc_col(i, wtid)) =
          make_float2(acc[i] * scale, acc[i + 1] * scale);
  }
}

}  // namespace tc32

// ---------------------------------------------------------------------------
// fp32 at D = 256: the CUDA-core kernels (header comment)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 32;          // queries per tile (dK/dV) or per block (dQ)
constexpr int BK = 32;          // keys per block (dK/dV) or per tile (dQ)
constexpr int THREADS = 256;    // eight warps
constexpr int PAD = 4;          // floats after each row (banks)

// Four [32, D] fp32 tiles (rows padded by PAD floats) and two [32, 33]
// tiles of p or ds: 141.5 KB at D = 256, one block an SM.
template <int D>
struct Cfg {
  static constexpr int RS = D + PAD;                 // row stride
  static constexpr int CPL = D / 128;                // float4s a lane
  static constexpr int SMEM = 4 * (4 * 32 * RS + 2 * 32 * (32 + 1));
};

// Copy rows row0 .. row0 + ROWS - 1 of an [n, D] fp32 matrix (row stride
// `stride` elements, 16-byte aligned rows) into shared rows of `ld`
// floats; rows at or past n are zeros.  All THREADS threads call.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ g,
                                          long long stride, int row0, int n,
                                          int tid) {
  constexpr int CPR = D / 4;   // float4s a row
  static_assert(ROWS * CPR % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CPR, c = e % CPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      x = __ldg(reinterpret_cast<const float4*>(
          g + (long long)(row0 + r) * stride + 4 * c));
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
  }
}

// acc[i][j] (+)= sum_d a[ra + i][d] b[rb + 16 j][d] and the same of c and
// e into acc2, for i, j < 2: two 2 x 2 blocks of products of rows of
// shared [32, RS] tiles, fp32 FMAs summed over d in order.
template <int D, int RS>
__device__ __forceinline__ void dot2x2(const float* a, const float* b,
                                       const float* c, const float* e,
                                       int ra, int rb, float (&acc)[2][2],
                                       float (&acc2)[2][2]) {
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
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

// o[r][.] += sum_j w[row0 + r][j] m[j][cols of this lane] over the 32 rows
// j of a shared [32, RS] tile, for the warp's four rows r: lane l holds
// columns 4 (l + 32 c) .. + 3 (c < CPL); w a shared [32, 33] tile.
template <int D, int RS>
__device__ __forceinline__ void rows_times(const float* w, const float* m,
                                           int row0, int lane,
                                           float (&o)[4][4 * (D / 128)]) {
  constexpr int CPL = D / 128;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    float pr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) pr[r] = w[(row0 + r) * 33 + j];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float4 m4 =
          *reinterpret_cast<const float4*>(m + j * RS + 4 * (lane + 32 * c));
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[r][4 * c + e] = fmaf(pr[r], mv[e], o[r][4 * c + e]);
    }
  }
}

// The warp's four rows of o (times `mul`) to rows row0 .. row0 + 3 of
// [B, n, H, D] at `out` (batch b, head h), rows at or past n skipped.
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&o)[4][4 * (D / 128)],
                                           float mul, int b, int h, int H,
                                           int n, int row0, int lane) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    float* op = out + (((long long)b * n + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 128; ++c)
      *reinterpret_cast<float4*>(op + 4 * (lane + 32 * c)) =
          make_float4(o[r][4 * c] * mul, o[r][4 * c + 1] * mul,
                      o[r][4 * c + 2] * mul, o[r][4 * c + 3] * mul);
  }
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Sq, int Sk, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long dsb, long long dss, float scale,
    const Branches br) {
  constexpr int RS = Cfg<D>::RS, CPL = Cfg<D>::CPL;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // Q [BQ][RS]
  float* dos = qs + BQ * RS;          // dO [BQ][RS]
  float* ks = dos + BQ * RS;          // K [BK][RS]
  float* vs = ks + BK * RS;           // V [BK][RS]
  float* dss_ = vs + BK * RS;         // ds [BQ][BK + 1]
  __shared__ float ls[BQ], dls[BQ], mrs[MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? BQ : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  const float* kb = k + b * ksb + h * D;
  const float* vb = v + b * vsb + h * D;
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
  load_rows<BQ, D>(qs, RS, q + b * qsb + h * D, qss, q0, Sq, tid);
  load_rows<BQ, D>(dos, RS, dout + b * dsb + h * D, dss, q0, Sq, tid);

  // S and dP: rows sr, sr + 1 and keys sc, sc + 16 of the tile a thread;
  // dQ: warp w holds rows 4w .. 4w + 3, lane l columns 4 (l + 32 c) ..
  const int sr = 2 * (tid / 16), sc = tid % 16, orow = 4 * warp;
  float o[4][4 * CPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * CPL; ++i) o[r][i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    __syncthreads();   // the previous tile is no longer read
    load_rows<BK, D>(ks, RS, kb, kss, k0, Sk, tid);
    load_rows<BK, D>(vs, RS, vb, vss, k0, Sk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float pa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    dot2x2<D, RS>(qs, ks, dos, vs, sr, sc, sa, pa);
    // ds = p (dP - delta)
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
        dss_[row * (BK + 1) + sc + 16 * j] = p * (pa[i][j] - dls[row]);
      }
    }
    __syncthreads();   // the tile's ds

    // dQ += dS K
    rows_times<D, RS>(dss_, ks, orow, lane, o);
  }
  store_rows<D>(dq, o, scale, b, h, H, Sq, q0 + orow, lane);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss,
    float scale, const Branches br) {
  constexpr int RS = Cfg<D>::RS, CPL = Cfg<D>::CPL;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                    // K [BK][RS]
  float* vs = ks + BK * RS;           // V [BK][RS]
  float* qs = vs + BK * RS;           // Q [BQ][RS]
  float* dos = qs + BQ * RS;          // dO [BQ][RS]
  float* ps = dos + BQ * RS;          // p [BK][BQ + 1]
  float* dss_ = ps + BK * (BQ + 1);   // ds [BK][BQ + 1]
  __shared__ float ls[BQ], dls[BQ], mrs[MASKED ? BQ : 1];
  __shared__ int qids[SEGS ? BQ : 1], kids[SEGS ? BK : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, offset = Sk - Sq;
  const int klen =
      MASKED && br.kv_lens ? min(max(br.kv_lens[b], 0), Sk) : Sk;
  const float* qb = q + b * qsb + h * D;
  const float* db = dout + b * dsb + h * D;
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
  load_rows<BK, D>(ks, RS, k + b * ksb + h * D, kss, k0, Sk, tid);
  load_rows<BK, D>(vs, RS, v + b * vsb + h * D, vss, k0, Sk, tid);

  // S^T and dP^T: keys sr, sr + 1 and queries sc, sc + 16 of the tile a
  // thread; dK and dV: warp w holds keys 4w .. 4w + 3, lane l columns
  // 4 (l + 32 c) ..
  const int sr = 2 * (tid / 16), sc = tid % 16, orow = 4 * warp;
  float dka[4][4 * CPL], dva[4][4 * CPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * CPL; ++i) dka[r][i] = dva[r][i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQ;
    __syncthreads();   // the previous tile is no longer read
    load_rows<BQ, D>(qs, RS, qb, qss, q0, Sq, tid);
    load_rows<BQ, D>(dos, RS, db, dss, q0, Sq, tid);
    if (tid < BQ) {
      const int qp = q0 + tid;
      const bool in = qp < Sq;
      ls[tid] = in ? lse[stat0 + qp] : 0.f;
      dls[tid] = in ? delta[stat0 + qp] : 0.f;
      if constexpr (MASKED) mrs[tid] = in ? br.rowmax[stat0 + qp] : 0.f;
      if constexpr (SEGS) qids[tid] = in ? sb[qp] : 0;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T
    float sa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float pa[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    dot2x2<D, RS>(ks, qs, vs, dos, sr, sc, sa, pa);
    // p^T and ds^T = p (dP - delta)
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
        ps[row * (BQ + 1) + c] = p;
        dss_[row * (BQ + 1) + c] = p * (pa[i][j] - dls[c]);
      }
    }
    __syncthreads();   // the tile's p and ds

    // dV += P^T dO and dK += dS^T Q
    rows_times<D, RS>(ps, dos, orow, lane, dva);
    rows_times<D, RS>(dss_, qs, orow, lane, dka);
  }
  store_rows<D>(dk, dka, scale, b, h, H, Sk, k0 + orow, lane);
  store_rows<D>(dv, dva, 1.f, b, h, H, Sk, k0 + orow, lane);
}

}  // namespace simt

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Sq, Sk;
  long long qsb, qss, ksb, kss, vsb, vss, dsb, dss;
  float scale;
  cudaStream_t stream;
  Branches br;
};

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dq_tc(const Args& a, void* dq) {
  constexpr int smem = tc::dq_smem_bytes<D>();
  auto* kernel = tc::flash_bwd_dq_tc_kernel<T, D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + tc::BQ - 1) / tc::BQ, a.H, a.B);
  kernel<<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dkv_tc(const Args& a, void* dk, void* dv) {
  using C = tc::Dkv<D>;
  auto* kernel = tc::flash_bwd_dkv_tc_kernel<T, D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sk + tc::BKV - 1) / tc::BKV, a.H, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Sq, a.Sk,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dkv_tc32(const Args& a, void* dk, void* dv) {
  constexpr int smem = tc32::Cfg<D>::SMEM;
  auto* kernel = tc32::flash_bwd_dkv_tc32_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  using C = tc32::Cfg<D>;
  const int keys = C::WGS * tc32::BKV;   // per block
  dim3 grid((a.Sk + keys - 1) / keys, a.H, a.B);
  kernel<<<grid, C::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Sq, a.Sk,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dq_tc32(const Args& a, void* dq) {
  using C = tc32::DqCfg<D>;
  auto* kernel = tc32::flash_bwd_dq_tc32_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  const int rows = 64 * C::WGS;   // queries per block
  dim3 grid((a.Sq + rows - 1) / rows, a.H, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dkv_simt(const Args& a, void* dk, void* dv) {
  constexpr int smem = simt::Cfg<D>::SMEM;
  auto* kernel = simt::flash_bwd_dkv_simt_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sk + simt::BK - 1) / simt::BK, a.H, a.B);
  kernel<<<grid, simt::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Sq, a.Sk,
      a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_dq_simt(const Args& a, void* dq) {
  constexpr int smem = simt::Cfg<D>::SMEM;
  auto* kernel = simt::flash_bwd_dq_simt_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + simt::BQ - 1) / simt::BQ, a.H, a.B);
  kernel<<<grid, simt::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.H, a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss,
      a.vsb, a.vss, a.dsb, a.dss, a.scale, a.br);
}

// One launch of the dQ (dv null) or the dK/dV kernel for a head size and
// type code (0 fp32, 1 bf16, 2 fp16); cudaErrorInvalidValue for one the
// kernels do not take.  bf16 and fp16 take the 16-bit tensor-core kernels,
// fp32 the split-TF32 ones (D = 64, 128) or the CUDA-core ones (D = 256).
template <int D, bool MASKED, bool SEGS, bool CAUSAL>
int dispatch_type(const Args& a, int dtype, void* dq_or_dk, void* dv) {
  switch (dtype) {
    case 0:
      if constexpr (D == 256) {
        if (dv)
          launch_dkv_simt<D, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
        else
          launch_dq_simt<D, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
      } else {
        if (dv)
          launch_dkv_tc32<D, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
        else
          launch_dq_tc32<D, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
      }
      break;
    case 1:
      if (dv)
        launch_dkv_tc<__nv_bfloat16, D, MASKED, SEGS, CAUSAL>(a, dq_or_dk,
                                                               dv);
      else
        launch_dq_tc<__nv_bfloat16, D, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
      break;
    case 2:
      if (dv)
        launch_dkv_tc<__half, D, MASKED, SEGS, CAUSAL>(a, dq_or_dk, dv);
      else
        launch_dq_tc<__half, D, MASKED, SEGS, CAUSAL>(a, dq_or_dk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int D, int dtype, void* dq_or_dk, void* dv) {
  if (D == 64)
    return dispatch_type<64, MASKED, SEGS, CAUSAL>(a, dtype, dq_or_dk, dv);
  if (D == 128)
    return dispatch_type<128, MASKED, SEGS, CAUSAL>(a, dtype, dq_or_dk, dv);
  if (D == 256)
    return dispatch_type<256, MASKED, SEGS, CAUSAL>(a, dtype, dq_or_dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_branches(const Args& a, int D, int dtype, int causal,
                      void* dq_or_dk, void* dv) {
  const bool m = a.br.mask || a.br.kv_lens, s = a.br.segs;
  switch ((m ? 4 : 0) + (s ? 2 : 0) + (causal != 0)) {
    case 0: return dispatch<false, false, false>(a, D, dtype, dq_or_dk, dv);
    case 1: return dispatch<false, false, true>(a, D, dtype, dq_or_dk, dv);
    case 2: return dispatch<false, true, false>(a, D, dtype, dq_or_dk, dv);
    case 3: return dispatch<false, true, true>(a, D, dtype, dq_or_dk, dv);
    case 4: return dispatch<true, false, false>(a, D, dtype, dq_or_dk, dv);
    case 5: return dispatch<true, false, true>(a, D, dtype, dq_or_dk, dv);
    case 6: return dispatch<true, true, false>(a, D, dtype, dq_or_dk, dv);
    default: return dispatch<true, true, true>(a, D, dtype, dq_or_dk, dv);
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
// ignored otherwise.  dtype: the element type's code (0 fp32, 1 bf16, 2
// fp16).  Both return cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head size or type code the kernels do not
// take.
extern "C" int flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dq, int B, int H, int Sq,
    int Sk, int D, int dtype, int causal, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, long long dsb,
    long long dss, long long msb, long long msh, long long msq, long long msk,
    long long ssb, float scale, void* stream) {
  const Args a = make_args(
      q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss, ksb, kss, vsb, vss,
      dsb, dss, scale, stream,
      make_branches(rowmax, mask, kv_lens, segs, msb, msh, msq, msk, ssb));
  return dispatch_branches(a, D, dtype, causal, dq, nullptr);
}

extern "C" int flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int dtype, int causal, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, long long msb, long long msh, long long msq,
    long long msk, long long ssb, float scale, void* stream) {
  const Args a = make_args(
      q, k, v, dout, lse, delta, B, H, Sq, Sk, qsb, qss, ksb, kss, vsb, vss,
      dsb, dss, scale, stream,
      make_branches(rowmax, mask, kv_lens, segs, msb, msh, msq, msk, ssb));
  return dispatch_branches(a, D, dtype, causal, dk, dv);
}
