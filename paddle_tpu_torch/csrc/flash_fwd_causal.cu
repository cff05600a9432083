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
// about S/2 FLOPs per byte in fp32 and S FLOPs per byte in bf16 -- above
// the H100's ridge point, so the tensor cores bound a fast kernel.
//
// Two designs behind the one entry:
//
// bf16: `flash_fwd_tc_kernel`, on the tensor cores (`flash_tc.cuh`).  One
// block per (64-query tile, head, batch) is one warpgroup of 128 threads.
// Both products are `wgmma` m64nNk16 bf16 -> fp32: S = Q K^T with Q and K
// read from 128-byte-swizzled shared memory (K stored [keys, D], K-major as
// the B operand), and O += P V with P from registers -- the S accumulator
// rounded to bf16 and repacked in place as the A operand -- and V read
// MN-major from the same swizzled layout.  Key/value tiles of 64 rows fill
// a two-stage ring by `cp.async` (zero-fill past the ragged edge): tile j+1
// is copied while tile j computes.  The online softmax runs on the
// accumulator fragments (each thread holds two rows, 16 columns of each;
// the row max and sum reduce over the four threads of a row).  p is
// rounded to bf16 for the PV product at the running max of its key tile,
// as the TPU kernel rounds it (`pallas_ops.py:181`), and l sums the
// unrounded fp32 p (`:180`).  Only the tiles that cross the diagonal, the
// kv_lens edge or a segment (every tile with SEGS) test each (row, key)
// pair; the interior tiles below the diagonal go through the same step
// with no per-element test.  The query tiles run longest first.
//
// fp32: `flash_fwd_causal_kernel`, the first design, on the CUDA cores
// (fp32 FMAs; TF32 tensor cores would break the fp32 limits).  Bound by
// the CUDA cores' fp32 rate and the shared-memory reads that feed the
// FMAs.  One block per (64-query tile, head, batch).  Four threads share a
// query row, each holding D/4 of q and of the fp32 accumulator in
// registers (dims d = sub + 4*i, so the four lanes of a row read
// consecutive shared-memory words).  Key/value tiles of 32 rows are staged
// once per block in shared memory as fp32 and reused by all 64 rows.
//
// In both the loop over key tiles stops at the diagonal, the online
// softmax (max m, sum l) stays in fp32, and the ragged tile edge is
// masked here, so any S works (the TPU kernel needed S % 128 == 0).
// Masked logits are -1e30 as in the reference, and a masked key
// contributes exactly 0.
//
// Layout: q, k, v are [B, S, H, D] with unit stride in D and stride D
// between heads; batch and sequence strides are arguments, so slices of a
// fused qkv projection need no copy (bf16: 16-byte-aligned rows, strides
// a multiple of 8 elements, for the 16-byte copies).  out is a contiguous
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
// copy), staged per tile in shared memory (fp32; the bf16 kernel reads
// each thread's pairs), and added to the scaled score.  With kv_lens the
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
// keys (self-attention), are read through their batch stride; the key
// tile's ids are staged beside K/V (fp32; the bf16 kernel reads each
// thread's columns) and a pair whose ids differ is excluded as a
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

using flash::from_f;
using flash::to_f;

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr float NEG = -1e30f;

// MASKED adds the additive mask and kv_lens branches, SEGS the segment ids;
// CAUSAL limits each row to the keys up to its diagonal.  With MASKED and
// SEGS false and CAUSAL true the arithmetic is that of the causal-only
// kernel, unchanged.
template <typename T, int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_causal_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ rowmax, float* __restrict__ logsum,
    const float* __restrict__ mask, const int* __restrict__ kv_lens,
    const int* __restrict__ segs, int H, int Sq, int Sk, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb,
    long long vss, long long msb, long long msh, long long msq,
    long long msk, long long ssb, float scale) {
  constexpr int DP = D / TPR;
  // the logit of an excluded key: -1e30 as in the reference; -inf when
  // masked, so that any finite mask value (-1e30 too) stays exact
  const float none = MASKED ? -INFINITY : NEG;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ms[MASKED ? BQ : 1][BK + 1];   // mask tile, padded
  __shared__ int kid[SEGS ? BK : 1];               // the key tile's ids
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int qpos = tile * BQ + row;
  const int offset = Sk - Sq;
  const int lim = qpos + offset;    // last key this row may attend (causal)
  const int klen =
      MASKED && kv_lens ? min(max(kv_lens[b], 0), Sk) : Sk;

  float qr[DP], acc[DP];
  const T* qp = q + b * qsb + (long long)min(qpos, Sq - 1) * qss + h * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = to_f(qp[sub + TPR * i]);
    acc[i] = 0.f;
  }
  float m = none, l = 0.f;

  const T* kb = k + b * ksb + h * D;
  const T* vb = v + b * vsb + h * D;
  const float* mb = MASKED && mask ? mask + b * msb + h * msh : nullptr;
  const int* sb = SEGS ? segs + b * ssb : nullptr;
  int kbeg = 0;
  int kend = CAUSAL ? min(klen, tile * BQ + BQ + offset) : klen;  // excl.
  int qid = 0;
  if constexpr (SEGS) {
    qid = sb[min(qpos, Sq - 1)];
    const int2 env = flash::seg_envelope<THREADS>(sb, Sk, qid, red);
    kbeg = env.x / BK * BK;
    kend = min(kend, env.y);
  }
  // whether this row attends key kp of the staged tile (its j-th)
  auto allowed = [&](int kp, int j) {
    bool ok = (!CAUSAL || kp <= lim) && kp < klen;
    if constexpr (SEGS) ok = ok && kid[j] == qid;
    return ok;
  };
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
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
    if constexpr (MASKED) {
      if (mb) {
        for (int e = tid; e < BQ * BK; e += THREADS) {
          const int rr = e / BK, j = e % BK, kp = k0 + j;
          const long long qq = min(tile * BQ + rr, Sq - 1);
          ms[rr][j] = kp < Sk ? mb[qq * msq + kp * msk] : 0.f;
        }
      }
    }
    if constexpr (SEGS) {
      if (tid < BK) kid[tid] = k0 + tid < Sk ? sb[k0 + tid] : 0;
    }
    __syncthreads();

    float s[BK];
    float tmax = none;
    // bit j: this row attends the tile's j-th key.  Testing once and
    // keeping the bits holds the masked and segment instantiations to the
    // causal kernel's registers (<= 128 at D = 64, two blocks per SM);
    // re-testing in the loop below took 173-194.
    unsigned okbits = 0u;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qr[i], ks[j][sub + TPR * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      float sc = part * scale;
      if constexpr (MASKED) {
        if (mb) sc += ms[row][j];
      }
      const bool ok = allowed(kp, j);
      okbits |= (ok ? 1u : 0u) << j;
      s[j] = ok ? sc : none;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mnew = fmaxf(m, tmax);
    const float alpha =
        MASKED && mnew == -INFINITY ? 1.f : expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = (okbits >> j) & 1u ? expf(s[j] - mnew) : 0.f;
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
    if (sub == 0) {
      const long long r = ((long long)b * H + h) * Sq + qpos;
      lse[r] = m + logf(ls);
      if constexpr (MASKED) {
        rowmax[r] = m;
        logsum[r] = logf(ls);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (header comment)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace flash_tc;

constexpr int BQ = 64;          // query rows per block: one warpgroup
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = WG;     // 128

// Q, then two stages of K and V, each [64, D] bf16; 1024 bytes of slack to
// align the tiles for the swizzle.
template <int D>
constexpr int smem_bytes() {
  return 5 * BK * D * 2 + 1024;
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ rowmax,
    float* __restrict__ logsum, const float* __restrict__ mask,
    const int* __restrict__ kv_lens, const int* __restrict__ segs, int H,
    int Sq, int Sk, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long msb,
    long long msh, long long msq, long long msk, long long ssb,
    float scale) {
  constexpr uint32_t TILE = BK * D * 2;   // bytes of one [64, D] tile
  extern __shared__ uint8_t smem[];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q at sq; stage st holds K at sq + TILE (1 + 2 st) and V after it
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

  const bf16* kb = k + b * ksb + h * D;
  const bf16* vb = v + b * vsb + h * D;
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
    load_tile<BK, D, THREADS>(sq + TILE, kb, kss, kbeg, Sk, tid);
    load_tile<BK, D, THREADS>(sq + 2 * TILE, vb, vss, kbeg, Sk, tid);
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
    const uint32_t sk = sq + TILE * (1 + 2 * (it & 1)), sv = sk + TILE;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) {
      const uint32_t nk = sq + TILE * (1 + 2 * ((it + 1) & 1));
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
      mma_ss_n64(s, desc_k<BQ>(sq, kk), desc_k<BK>(sk, kk), 1);
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
    // O += P V, P rounded to bf16 as the A operand
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], s, kk);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<D>(o, pa[kk], desc_mn<BK>(sv, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();

  bf16* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= Sq) continue;
    bf16* op = ob + (long long)qpos[r] * H * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      *reinterpret_cast<__nv_bfloat162*>(op + acc_col(i, tid)) =
          __floats2bfloat162_rn(o[i] / ls, o[i + 1] / ls);
    }
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
void launch(const Args& a) {
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_causal_kernel<T, D, MASKED, SEGS, CAUSAL>
      <<<grid, THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.out),
          static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
          static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H,
          a.Sq, a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh,
          a.msq, a.msk, a.ssb, a.scale);
}

template <int D, bool MASKED, bool SEGS, bool CAUSAL>
void launch_tc(const Args& a) {
  using tc::bf16;
  constexpr int smem = tc::smem_bytes<D>();
  auto* kernel = tc::flash_fwd_tc_kernel<D, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + tc::BQ - 1) / tc::BQ, a.H, a.B);
  kernel<<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.rowmax),
      static_cast<float*>(a.logsum), a.mask, a.kv_lens, a.segs, a.H, a.Sq,
      a.Sk, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.msb, a.msh, a.msq,
      a.msk, a.ssb, a.scale);
}

// bf16 takes the tensor-core kernel, fp32 the CUDA-core one.
template <bool MASKED, bool SEGS, bool CAUSAL>
int dispatch(const Args& a, int D, int is_bf16) {
  if (D == 64 && is_bf16)
    launch_tc<64, MASKED, SEGS, CAUSAL>(a);
  else if (D == 64)
    launch<float, 64, MASKED, SEGS, CAUSAL>(a);
  else if (D == 128 && is_bf16)
    launch_tc<128, MASKED, SEGS, CAUSAL>(a);
  else if (D == 128)
    launch<float, 128, MASKED, SEGS, CAUSAL>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mask: fp32, element strides msb, msh, msq, msk (0 broadcasts), or null;
// kv_lens: int32 [B], or null; segs: int32 [B, S] with batch stride ssb and
// unit stride in S, or null; causal: 0 or 1.  rowmax and logsum: fp32
// [B, H, Sq] outputs of m and log l, written with a mask or kv_lens (null
// otherwise).  Returns cudaGetLastError() after the launch; 1
// (cudaErrorInvalidValue) for a head size or type the kernel does not take.
extern "C" int flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* rowmax, void* logsum, const void* mask, const void* kv_lens,
    const void* segs, int B, int H, int Sq, int Sk, int D, int is_bf16,
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
    case 0: return dispatch<false, false, false>(a, D, is_bf16);
    case 1: return dispatch<false, false, true>(a, D, is_bf16);
    case 2: return dispatch<false, true, false>(a, D, is_bf16);
    case 3: return dispatch<false, true, true>(a, D, is_bf16);
    case 4: return dispatch<true, false, false>(a, D, is_bf16);
    case 5: return dispatch<true, false, true>(a, D, is_bf16);
    case 6: return dispatch<true, true, false>(a, D, is_bf16);
    default: return dispatch<true, true, true>(a, D, is_bf16);
  }
}
