// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_fwd_kernel` (reached via
// `_flash_fwd` <- `flash_attention_arrays`) in all its branches, through
// one entry, `flash_fwd`: causal with no additive mask, no kv_lens and no
// segment ids (the whole-prompt prefill of the serving engine, and unpacked
// training), the additive mask and kv_lens (the padded-prompt prefill of
// `generate`), packed segment ids (packed pretraining) and non-causal
// attention.
//
// What bounds it on this card: at GPT-2 widths (D = 64, S <= 1024) one
// layer's causal attention is 2*S^2*H*D FLOPs over 4*S*H*D*itemsize bytes,
// about S/2 FLOPs per byte in fp32 and S FLOPs per byte in bf16 / fp16 --
// above the H100's ridge point, so the tensor cores bound a fast kernel:
// bf16 and fp16 at 989 TFLOP/s, fp32 at 495 / 3 (split TF32, below).
//
// Three designs behind the one entry (the type is a code: 0 fp32, 1 bf16,
// 2 fp16; the third, fp32 at D = 256, below):
//
// bf16 and fp16: `flash_fwd_tc_kernel<T>`, on the tensor cores
// (`flash_tc.cuh`), one instantiation per 16-bit type T.  One block per
// (64-query tile, head, batch) is one warpgroup of 128 threads.  Both
// products are `wgmma` m64nNk16 T -> fp32 (`.bf16.bf16` or `.f16.f16`, the
// same shapes and layouts): S = Q K^T with Q and K
// read from 128-byte-swizzled shared memory (K stored [keys, D], K-major as
// the B operand), and O += P V with P from registers -- the S accumulator
// rounded to T and repacked in place as the A operand -- and V read
// MN-major from the same swizzled layout.  Key/value tiles of 64 rows fill
// a two-stage ring by `cp.async` (zero-fill past the ragged edge): tile j+1
// is copied while tile j computes.  The online softmax runs on the
// accumulator fragments (each thread holds two rows, 16 columns of each;
// the row max and sum reduce over the four threads of a row).  p is
// rounded to T for the PV product at the running max of its key tile, as
// the TPU kernel rounds it to v's type (`pallas_ops.py:181`), and l sums the
// unrounded fp32 p (`:180`).  Only the tiles that cross the diagonal, the
// kv_lens edge or a segment (every tile with SEGS) test each (row, key)
// pair; the interior tiles below the diagonal go through the same step
// with no per-element test.  The query tiles run longest first.
//
// fp32: `flash_fwd_tc32_kernel`, on the tensor cores in split TF32
// (`flash_tc.cuh`, last section): each fp32 product is three TF32 `wgmma`
// products (m64nNk8, fp32 accumulators) of the operands' hi and lo parts,
// lo_a hi_b + hi_a lo_b + hi_a hi_b, hi = cvt.rna.tf32(x), lo = x - hi, as
// close to the exact product as an fp32 product is (one TF32 pass of the
// raw operands would keep ~3 digits and miss the fp32 limits).  The same
// block shape as the 16-bit kernel: one warpgroup per (64-query tile,
// head, batch), the
// same online softmax, masking and branches, the query tiles longest
// first; p stays fp32 (split like any operand).  What differs:
// - TF32 operands are K-major only (no transpose bit), so V, the B
//   operand of P V, is written transposed by the threads, V^T [D, keys],
//   split as it is written; the keys of each group of 8 are permuted
//   there to match the A fragment the S accumulator gives in registers
//   (`tf32_a`: P needs no shuffle).  K is split in place once its tile has
//   landed, hi where it was loaded and lo over V's raw tile (already
//   transposed), so a stage holds K and V once, not four tiles.
// - D = 64: Q's hi and lo A fragments sit in registers (64 of them;
//   S = Q K^T is RS), key tiles of 64 keys, two `cp.async` stages, 97 KB
//   of shared memory: two blocks an SM.  D = 128: the O accumulator alone
//   takes 64 registers, so Q's hi and lo are tiles in shared memory (SS),
//   key tiles of 32 keys (K and V hi, lo for 64 keys would not fit two
//   stages), two stages, 161 KB: one block an SM.
// Per key tile: wait for its copy, start the next tile's copy, transpose
// and split V, split K (a barrier between: K's lo overwrites V), S (3 x
// D/8 `wgmma`s), the softmax, then P V (3 x BK/8), in two levels: the
// tensor core truncates its fp32 sums (toward zero), and 3 BK/8 of those
// a key tile into O for every tile of a 900-key row biased O by ~2e-5 of
// its size, past the fp32 limit (2e-5 against the plain version, which
// stays); so P V is summed per key tile in a fresh accumulator and added
// to O on the CUDA cores (round to nearest).  Its A fragments are made
// four k-steps at a time, so that the second accumulator fits: 252-255
// registers at D = 64 (16-32 bytes spilled with MASKED and SEGS both),
// 252-254 at D = 128.  S needs no second level: it is summed afresh for
// every tile.
//
// D = 256 (Gemma 2B's and GPT-J's head size): bf16 and fp16 take the
// tensor-core kernel with key tiles of 32 keys, its S = Q K^T an m64n32k16
// `wgmma` and its P V an m64n256k16 one: O holds 64 x 256 fp32 a
// warpgroup, 128 registers a thread, and with S and P of 64 keys (32 and
// 16 more) the kernel spilled 28-100 bytes at 255 registers; of 32 keys
// they take half.  Q and two stages of K and V take (64 + 4 * 32) * 256 *
// 2 + 1024 = 99,328 bytes of shared memory.  fp32 does not fit the
// split-TF32 design there: O and its per-tile sum (the two levels above)
// would take 256 registers, and Q's hi and lo with two stages of K and V
// 321 KB of shared memory.  It takes `flash_fwd_simt_kernel`, on the CUDA
// cores (fp32 FMAs, bound by the 67 TFLOP/s of fp32): one block of eight
// warps per (32-query tile, head, batch), Q in shared memory, K and V tiles
// of 32 keys copied in per tile (rows padded by 4 floats against bank
// conflicts, 104 KB: two blocks an SM); each thread sums 2 x 2 scores over
// d in order, each warp runs the online softmax of four rows, a key a lane
// (p written over its score), and holds those rows of O, 8 columns a lane.
// The same masking, branches, statistics and longest-first order as the
// tensor-core kernels.
//
// In all three the loop over key tiles stops at the diagonal, the online
// softmax (max m, sum l) stays in fp32, and the ragged tile edge is
// masked here, so any S works (the TPU kernel needed S % 128 == 0).
// Masked logits are -1e30 as in the reference, and a masked key
// contributes exactly 0.  Scores, the mask and the softmax statistics stay
// fp32 in every type (the TPU kernel adds the mask as fp32, whatever its
// type: `pallas_ops.py:162-165`), so -1e30 needs no clamp in fp16 either.
//
// Layout: q, k, v are [B, S, H, D] with unit stride in D and stride D
// between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy (16-byte-aligned rows, strides a
// multiple of 16 bytes, for the 16-byte copies).  out is a contiguous
// [B, Sq, H, D] in the input type; lse is a contiguous fp32 [B, H, Sq].
// Causal alignment is at the end (query i sees keys <= i + Sk - Sq), as in
// the TPU kernel.
//
// The branches are template flags of each kernel, MASKED, SEGS and CAUSAL,
// so that the plain causal instantiation keeps its arithmetic.
// MASKED adds the TPU kernel's additive mask and kv_lens branches
// (`pallas_ops.py:162-173`, `:192-194`).  The fp32 mask is read through four
// element strides (batch, head, query, key; a stride of 0 broadcasts, so
// a [B, 1, 1, S] key-validity row expanded to [B, 1, S, S] costs no
// copy), read for each thread's pairs, and added to the scaled score.  With kv_lens the
// key loop stops at the tile that holds key len - 1 and keys at or past
// len are excluded.  Key tiles
// are never skipped for a mask of -1e30: a left-pad query whose every key
// is masked gets the uniform softmax over the keys causal and kv_lens
// allow (-1e30 + s is -1e30 in fp32), as the plain version does.  Keys
// that causal or kv_lens exclude carry exactly no weight (-inf, and p = 0);
// the running max starts at -inf so that any finite mask value is exact.
// MASKED also writes each row's max m and log l: lse = m + log l rounds
// log l away where m is ~-1e30 (a row whose every key the mask closes), and
// the backward needs the pair to rebuild p = 1/n there.
//
// SEGS (`:174-176`, `:195-201`): the [B, S] int32 ids, shared by queries and
// keys (self-attention), are read through their batch stride, each
// thread's columns, and a pair whose ids differ is excluded as a
// causal-excluded key is (p = 0).  Key tiles outside the query tile's
// id envelope -- the first to the last key whose id lies in [min, max] of
// the tile's query ids, `_seg_kb_bounds` -- are not visited, so a packed
// row costs the attention of its documents, not of the whole row; the
// envelope holds for any id layout, sorted or not.  Without CAUSAL there is
// no diagonal limit (the loop runs to kv_len or Sk), and Sq != Sk is allowed
// when there are no segments.
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16 and fp16: the tensor-core kernel (header comment)
// ---------------------------------------------------------------------------

namespace tc {

using namespace flash_tc;

constexpr int BQ = 64;          // query rows per block: one warpgroup
constexpr int THREADS = WG;     // 128
// keys per tile: 64, or 32 at D = 256, where O alone takes 128 registers a
// thread and S and P of 64 keys left the kernel 28-100 bytes of spills
template <int D>
constexpr int key_tile = D == 256 ? 32 : 64;

// Q [64, D], then two stages of K and V, each [BK, D], of a 2-byte type;
// 1024 bytes of slack to align the tiles for the swizzle.
template <int D>
constexpr int smem_bytes() {
  return (BQ + 4 * key_tile<D>) * D * 2 + 1024;
}

// T: __nv_bfloat16 or __half, the inputs' and the output's type and the
// operand type of both products (P rounded to T).
template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ rowmax,
    float* __restrict__ logsum, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, const int* __restrict__ segs, int H,
    int Sq, int Sk, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long msb,
    long long msh, long long msq, long long msk, long long ssb,
    float scale) {
  constexpr int BK = key_tile<D>;
  constexpr uint32_t QTILE = BQ * D * 2;  // bytes of the [64, D] Q tile
  constexpr uint32_t TILE = BK * D * 2;   // ... of one [BK, D] K or V tile
  extern __shared__ uint8_t smem[];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q at sq; stage st holds K at sq + QTILE + 2 TILE st and V after it
  const uint32_t sq = (smem_addr(smem) + 1023u) & ~1023u;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen = MASKED && kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  // this thread's two query rows (accumulator values i with (i/2)%2 = r)
  int qpos[2], lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + acc_row(2 * r, tid);
    lim[r] = qpos[r] + offset;   // last key the row may attend (causal)
  }

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const float* mb = MASKED && mask ? mask + b * msb + h * msh : nullptr;
  const int* sb = SEGS ? segs + b * ssb : nullptr;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + BQ + offset) : klen;   // exclusive
  int qid[2] = {0, 0};
  if constexpr (SEGS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) qid[r] = sb[min(qpos[r], Sq - 1)];
    const int2 env = flash::seg_envelope<THREADS>(
        sb, Sk, min(qid[0], qid[1]), max(qid[0], qid[1]), red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  load_tile<BQ, D, THREADS>(sq, q + b * qsb + h * D, qss, q0, Sq, tid);
  if (ntiles > 0) {
    load_tile<BK, D, THREADS>(sq + QTILE, kb, kss, kbeg, Sk, tid);
    load_tile<BK, D, THREADS>(sq + QTILE + TILE, vb, vss, kbeg, Sk, tid);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max and (this thread's part of the) sum of each row; an
  // excluded key is -inf, and the max starts at -1e30 (-inf when MASKED,
  // so that any finite mask value stays exact)
  float m[2] = {MASKED ? -INFINITY : NEG, MASKED ? -INFINITY : NEG};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];

  // scale, mask and (TEST) exclude the scores of key tile k0 in s
  auto score = [&](int k0, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2, kp = k0 + acc_col(i, tid);
      float x = s[i] * scale;
      if constexpr (MASKED) {
        if (mb && (!TEST || kp < Sk))
          x += mb[(long long)min(qpos[r], Sq - 1) * msq + kp * msk];
      }
      if constexpr (TEST) {
        bool ok = (!CAUSAL || kp <= lim[r]) && kp < klen;
        if constexpr (SEGS) ok = ok && sb[min(kp, Sk - 1)] == qid[r];
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    const uint32_t sk = sq + QTILE + 2 * TILE * (it & 1), sv = sk + TILE;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) {
      const uint32_t nk = sq + QTILE + 2 * TILE * ((it + 1) & 1);
      load_tile<BK, D, THREADS>(nk, kb, kss, k0 + BK, Sk, tid);
      load_tile<BK, D, THREADS>(nk + TILE, vb, vss, k0 + BK, Sk, tid);
    }
    cp_async_commit();

    // S = Q K^T
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_nk<BK, T>(s, desc_k<BQ>(sq, kk), desc_k<BK>(sk, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);

    if (SEGS || k0 + BK > klen || (CAUSAL && k0 + BK - 1 > q0 + offset))
      score(k0, std::true_type{});
    else
      score(k0, std::false_type{});

    // online softmax on the fragments
    float mx[2] = {m[0], m[1]}, base[2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const bool empty = MASKED && mx[r] == -INFINITY;   // no key yet
      const float alpha = empty ? 1.f : expf(m[r] - mx[r]);
      base[r] = empty ? 0.f : mx[r];
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        o[i] *= alpha;
        o[i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = expf(s[i] - base[(i / 2) % 2]);
      l[(i / 2) % 2] += s[i];
    }
    // O += P V, P rounded to T as the A operand
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<D, T>(o, pa[kk], desc_mn<BK>(sv, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  T* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= Sq) continue;
    T* op = ob + (long long)qpos[r] * H * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)
      store2<T>(op + acc_col(i, tid), o[i] / ls, o[i + 1] / ls);
    if (tid % 4 == 0) {
      const long long row = ((long long)b * H + h) * Sq + qpos[r];
      lse[row] = m[r] + logf(ls);
      if constexpr (MASKED) {
        rowmax[row] = m[r];
        logsum[row] = logf(ls);
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: the split-TF32 tensor-core kernel (header comment)
// ---------------------------------------------------------------------------

namespace tc32 {

using namespace flash_tc;

constexpr int BQ = 64;          // query rows per block: one warpgroup
constexpr int THREADS = WG;     // 128
constexpr int PCH = 4;          // k-steps of P V per set of A fragments

// Per head size: keys per tile, and whether Q's A fragments sit in
// registers (D = 64) or Q's hi and lo tiles in shared memory (D = 128,
// where the O accumulator alone takes 64 registers).  The shared memory:
// Q hi and lo (D = 128), two stages of K and V as loaded, then V^T hi and
// lo, all fp32, plus 1024 bytes of slack to align the tiles for the
// swizzle: 97 KB at D = 64 (two blocks an SM), 161 KB at D = 128.
template <int D>
struct Cfg {
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr bool QREG = D == 64;
  static constexpr uint32_t KT = BK * D * 4;   // one [BK, D] or [D, BK] tile
  static constexpr uint32_t QT = QREG ? 0 : BQ * D * 4;
  static constexpr int SMEM = 2 * QT + 6 * KT + 1024;
};

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ rowmax,
    float* __restrict__ logsum, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, const int* __restrict__ segs, int H,
    int Sq, int Sk, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long msb,
    long long msh, long long msq, long long msk, long long ssb,
    float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr uint32_t KT = C::KT, QT = C::QT;
  extern __shared__ uint8_t smem[];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q hi at sqh, lo at sqh + QT; stage st holds K at sk0 + 2 KT st and V
  // after it (once split: K hi in K's place, K lo in V's); V^T hi at svh,
  // lo at svl
  const uint32_t sqh = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sk0 = sqh + 2 * QT, svh = sk0 + 4 * KT, svl = svh + KT;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen = MASKED && kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  // this thread's two query rows (accumulator values i with (i/2)%2 = r)
  int qpos[2], lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + acc_row(2 * r, tid);
    lim[r] = qpos[r] + offset;   // last key the row may attend (causal)
  }

  const float* qb = q + b * qsb + h * D;
  const float* kb = k + b * ksb + h * D;
  const float* vb = v + b * vsb + h * D;
  const float* mb = MASKED && mask ? mask + b * msb + h * msh : nullptr;
  const int* sb = SEGS ? segs + b * ssb : nullptr;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, q0 + BQ + offset) : klen;   // exclusive
  int qid[2] = {0, 0};
  if constexpr (SEGS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) qid[r] = sb[min(qpos[r], Sq - 1)];
    const int2 env = flash::seg_envelope<THREADS>(
        sb, Sk, min(qid[0], qid[1]), max(qid[0], qid[1]), red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // Q: hi and lo A fragments of its 8-wide column slices (D = 64; rows
  // past Sq are zeros), or its tile, split in place below
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = qpos[j & 1], col = 8 * kk + tid % 4 + 4 * (j >> 1);
        const float x = row < Sq ? qb[(long long)row * qss + col] : 0.f;
        const float hi = tf32_rna(x);
        qh[kk][j] = __float_as_uint(hi);
        ql[kk][j] = __float_as_uint(x - hi);
      }
    }
  } else {
    load_tile_f32<BQ, D, THREADS>(sqh, qb, qss, q0, Sq, tid);
  }
  cp_async_commit();
  if (ntiles > 0) {
    load_tile_f32<BK, D, THREADS>(sk0, kb, kss, kbeg, Sk, tid);
    load_tile_f32<BK, D, THREADS>(sk0 + KT, vb, vss, kbeg, Sk, tid);
  }
  cp_async_commit();
  if constexpr (!C::QREG) {
    cp_async_wait<1>();
    __syncthreads();   // Q has landed
    split_tile<QT, THREADS>(sqh, sqh, sqh + QT, tid);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max and (this thread's part of the) sum of each row; an
  // excluded key is -inf, and the max starts at -1e30 (-inf when MASKED,
  // so that any finite mask value stays exact)
  float m[2] = {MASKED ? -INFINITY : NEG, MASKED ? -INFINITY : NEG};
  float l[2] = {0.f, 0.f};
  float s[BK / 2];

  // scale, mask and (TEST) exclude the scores of key tile k0 in s
  auto score = [&](int k0, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2, kp = k0 + acc_col(i, tid);
      float x = s[i] * scale;
      if constexpr (MASKED) {
        if (mb && (!TEST || kp < Sk))
          x += mb[(long long)min(qpos[r], Sq - 1) * msq + kp * msk];
      }
      if constexpr (TEST) {
        bool ok = (!CAUSAL || kp <= lim[r]) && kp < klen;
        if constexpr (SEGS) ok = ok && sb[min(kp, Sk - 1)] == qid[r];
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    const uint32_t sk = sk0 + 2 * KT * (it & 1), sv = sk + KT;
    cp_async_wait<0>();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) {
      const uint32_t nk = sk0 + 2 * KT * ((it + 1) & 1);
      load_tile_f32<BK, D, THREADS>(nk, kb, kss, k0 + BK, Sk, tid);
      load_tile_f32<BK, D, THREADS>(nk + KT, vb, vss, k0 + BK, Sk, tid);
    }
    cp_async_commit();
    // V as V^T hi and lo; then K split in place, its lo over V
    transpose_split<BK, D, THREADS>(sv, svh, svl, tid);
    __syncthreads();   // V has been read
    split_tile<KT, THREADS>(sk, sk, sv, tid);
    fence_async_smem();
    __syncthreads();   // the split tiles are visible to wgmma

    // S = Q K^T: Q_lo K_hi + Q_hi K_lo + Q_hi K_hi
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if constexpr (C::QREG) {
        mma_tf32_rs<BK>(s, ql[kk], desc_k<BK>(sk, kk));
        mma_tf32_rs<BK>(s, qh[kk], desc_k<BK>(sv, kk));
        mma_tf32_rs<BK>(s, qh[kk], desc_k<BK>(sk, kk));
      } else {
        mma_tf32_ss<BK>(s, desc_k<BQ>(sqh + QT, kk), desc_k<BK>(sk, kk));
        mma_tf32_ss<BK>(s, desc_k<BQ>(sqh, kk), desc_k<BK>(sv, kk));
        mma_tf32_ss<BK>(s, desc_k<BQ>(sqh, kk), desc_k<BK>(sk, kk));
      }
    }
    mma_commit();
    mma_wait<0>();
    fence_regs(s);

    if (SEGS || k0 + BK > klen || (CAUSAL && k0 + BK - 1 > q0 + offset))
      score(k0, std::true_type{});
    else
      score(k0, std::false_type{});

    // online softmax on the fragments
    float mx[2] = {m[0], m[1]}, base[2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const bool empty = MASKED && mx[r] == -INFINITY;   // no key yet
      const float alpha = empty ? 1.f : expf(m[r] - mx[r]);
      base[r] = empty ? 0.f : mx[r];
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        o[i] *= alpha;
        o[i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = expf(s[i] - base[(i / 2) % 2]);
      l[(i / 2) % 2] += s[i];
    }
    // O += P V: P_lo V_hi + P_hi V_lo + P_hi V_hi, P from registers, summed
    // per key tile in pv and added to O in fp32 (two-level: header), the
    // A fragments made and used PCH k-steps at a time
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; k8 += PCH) {
      uint32_t ph[PCH][4], pl[PCH][4];
#pragma unroll
      for (int j = 0; j < PCH; ++j) tf32_a(ph[j], pl[j], s, k8 + j);
      fence_frag(ph);
      fence_frag(pl);
      mma_fence();
#pragma unroll
      for (int j = 0; j < PCH; ++j) {
        mma_tf32_rs<D>(pv, pl[j], desc_k<D>(svh, k8 + j));
        mma_tf32_rs<D>(pv, ph[j], desc_k<D>(svl, k8 + j));
        mma_tf32_rs<D>(pv, ph[j], desc_k<D>(svh, k8 + j));
      }
      mma_commit();
      mma_wait<0>();
      fence_regs(pv);
      fence_frag(ph);
      fence_frag(pl);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
  }
  cp_async_wait<0>();

  float* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= Sq) continue;
    float* op = ob + (long long)qpos[r] * H * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4)
      *reinterpret_cast<float2*>(op + acc_col(i, tid)) =
          make_float2(o[i] / ls, o[i + 1] / ls);
    if (tid % 4 == 0) {
      const long long row = ((long long)b * H + h) * Sq + qpos[r];
      lse[row] = m[r] + logf(ls);
      if constexpr (MASKED) {
        rowmax[row] = m[r];
        logsum[row] = logf(ls);
      }
    }
  }
}

}  // namespace tc32

// ---------------------------------------------------------------------------
// fp32 at D = 256: the CUDA-core kernel (header comment)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 256;    // eight warps
constexpr int PAD = 4;          // floats after each Q and K row (banks)

template <int D>
struct Cfg {
  static constexpr int QS = D + PAD;                 // Q, K row strides
  static constexpr int CPL = D / 128;                // float4s of O a lane
  static constexpr int SMEM =
      4 * (BQ * QS + BK * QS + BK * D + BQ * (BK + 1));
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

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ rowmax,
    float* __restrict__ logsum, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, const int* __restrict__ segs, int H,
    int Sq, int Sk, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long msb,
    long long msh, long long msq, long long msk, long long ssb,
    float scale) {
  using C = Cfg<D>;
  constexpr int QS = C::QS, CPL = C::CPL;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // [BQ][QS]
  float* ks = qs + BQ * QS;           // [BK][QS]
  float* vs = ks + BK * QS;           // [BK][D]
  float* ss = vs + BK * D;            // [BQ][BK + 1]: scores, then p
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  __shared__ int qids[SEGS ? BQ : 1];
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen = MASKED && kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;
  const float* kb = k + b * ksb + h * D;
  const float* vb = v + b * vsb + h * D;
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
  load_rows<BQ, D>(qs, QS, q + b * qsb + h * D, qss, q0, Sq, tid);

  // scores: rows sr, sr + 1 and keys sc, sc + 16 of the tile a thread
  const int sr = 2 * (tid / 16), sc = tid % 16;
  // O and the softmax: warp w holds rows 4w .. 4w + 3, lane l columns
  // 4 (l + 32 j) .. + 3 of each (j < CPL)
  const int orow = 4 * warp;
  float o[4][4 * CPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * CPL; ++i) o[r][i] = 0.f;
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
    __syncthreads();   // the previous tile is no longer read (Q written)
    load_rows<BK, D>(ks, QS, kb, kss, k0, Sk, tid);
    load_rows<BK, D>(vs, D, vb, vss, k0, Sk, tid);
    __syncthreads();

    // S = Q K^T, fp32 products summed over d in order
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + sr * QS + d);
      const float4 qb =
          *reinterpret_cast<const float4*>(qs + (sr + 1) * QS + d);
      const float4 ka = *reinterpret_cast<const float4*>(ks + sc * QS + d);
      const float4 kc =
          *reinterpret_cast<const float4*>(ks + (sc + 16) * QS + d);
      const float qv[2][4] = {{qa.x, qa.y, qa.z, qa.w},
                              {qb.x, qb.y, qb.z, qb.w}};
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

    // online softmax of the warp's four rows, a key a lane; p over the
    // score it comes from (each lane its own key)
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
      *sp = p;
    }
    __syncwarp();   // the warp's rows of p

    // O = alpha O + P V
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4 * CPL; ++i) o[r][i] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = ss[(orow + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            vs + j * D + 4 * (lane + 32 * c));
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[r][4 * c + e] = fmaf(pr[r], vv[e], o[r][4 * c + e]);
      }
    }
  }

  float* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lt = l[r];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, s);
    const float ls = fmaxf(lt, 1e-30f);
    const int qp = q0 + orow + r;
    if (qp >= Sq) continue;
    float* op = ob + (long long)qp * H * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      *reinterpret_cast<float4*>(op + 4 * (lane + 32 * c)) =
          make_float4(o[r][4 * c] / ls, o[r][4 * c + 1] / ls,
                      o[r][4 * c + 2] / ls, o[r][4 * c + 3] / ls);
    if (lane == 0) {
      const long long row = ((long long)b * H + h) * Sq + qp;
      lse[row] = m[r] + logf(ls);
      if constexpr (MASKED) {
        rowmax[row] = m[r];
        logsum[row] = logf(ls);
      }
    }
  }
}

}  // namespace simt

struct Args {
  const void *q, *k, *v;
  void *out, *lse, *rowmax, *logsum;
  const float* mask;
  const int *kv_lens, *segs;
  int B, H, Sq, Sk;
  long long qsb, qss, ksb, kss, vsb, vss, msb, msh, msq, msk, ssb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_tc(const Args& a) {
  constexpr int smem = tc::smem_bytes<D>();
  auto* kernel = tc::flash_fwd_tc_kernel<T, D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + tc::BQ - 1) / tc::BQ, a.H, a.B);
  kernel<<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
      static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H, a.Sq,
      a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh, a.msq,
      a.msk, a.ssb, a.scale);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_tc32(const Args& a) {
  constexpr int smem = tc32::Cfg<D>::SMEM;
  auto* kernel = tc32::flash_fwd_tc32_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + tc32::BQ - 1) / tc32::BQ, a.H, a.B);
  kernel<<<grid, tc32::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
      static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H, a.Sq,
      a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh, a.msq,
      a.msk, a.ssb, a.scale);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_simt(const Args& a) {
  constexpr int smem = simt::Cfg<D>::SMEM;
  auto* kernel = simt::flash_fwd_simt_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + simt::BQ - 1) / simt::BQ, a.H, a.B);
  kernel<<<grid, simt::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
      static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H, a.Sq,
      a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh, a.msq,
      a.msk, a.ssb, a.scale);
}

// The element type by its code (0 fp32, 1 bf16, 2 fp16): bf16 and fp16
// take the 16-bit tensor-core kernel, fp32 the split-TF32 one (D = 64,
// 128) or the CUDA-core one (D = 256); any other code or head size is
// refused.
template <int D, bool MASKED, bool SEGS, bool CAUSAL>
int dispatch_type(const Args& a, int dtype) {
  switch (dtype) {
    case 0:
      if constexpr (D == 256)
        launch_simt<D, MASKED, SEGS, CAUSAL>(a);
      else
        launch_tc32<D, MASKED, SEGS, CAUSAL>(a);
      break;
    case 1: launch_tc<__nv_bfloat16, D, MASKED, SEGS, CAUSAL>(a); break;
    case 2: launch_tc<__half, D, MASKED, SEGS, CAUSAL>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int D, int dtype) {
  if (D == 64) return dispatch_type<64, MASKED, SEGS, CAUSAL>(a, dtype);
  if (D == 128) return dispatch_type<128, MASKED, SEGS, CAUSAL>(a, dtype);
  if (D == 256) return dispatch_type<256, MASKED, SEGS, CAUSAL>(a, dtype);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mask: fp32, element strides msb, msh, msq, msk (0 broadcasts), or null;
// kv_lens: int32 [B], or null; segs: int32 [B, S] with batch stride ssb and
// unit stride in S, or null; causal: 0 or 1.  rowmax and logsum: fp32
// [B, H, Sq] outputs of m and log l, written with a mask or kv_lens (null
// otherwise).  dtype: the element type's code (0 fp32, 1 bf16, 2 fp16).
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size (64, 128 and 256 are taken) or type code the kernel does
// not take.
extern "C" int flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* rowmax, void* logsum, const void* mask, const void* kv_lens,
    const void* segs, int B, int H, int Sq, int Sk, int D, int dtype,
    int causal, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long msb, long long msh,
    long long msq, long long msk, long long ssb, float scale, void* stream) {
  const Args a{q,   k,   v,   out, lse, rowmax, logsum,
               static_cast<const float*>(mask),
               static_cast<const int*>(kv_lens),
               static_cast<const int*>(segs),
               B,   H,   Sq,  Sk,  qsb, qss,    ksb,    kss, vsb, vss,
               msb, msh, msq, msk, ssb, scale,
               static_cast<cudaStream_t>(stream)};
  const bool m = mask || kv_lens, s = segs;
  switch ((m ? 4 : 0) + (s ? 2 : 0) + (causal != 0)) {
    case 0: return dispatch<false, false, false>(a, D, dtype);
    case 1: return dispatch<false, false, true>(a, D, dtype);
    case 2: return dispatch<false, true, false>(a, D, dtype);
    case 3: return dispatch<false, true, true>(a, D, dtype);
    case 4: return dispatch<true, false, false>(a, D, dtype);
    case 5: return dispatch<true, false, true>(a, D, dtype);
    case 6: return dispatch<true, true, false>(a, D, dtype);
    default: return dispatch<true, true, true>(a, D, dtype);
  }
}
