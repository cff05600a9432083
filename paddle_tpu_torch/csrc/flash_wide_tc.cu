// Flash-attention forward and dK/dV at head_dim 384, 512 and every larger
// multiple of 128 up to 1024, in bfloat16 and float16, on Hopper's tensor
// cores (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_flash_fwd_kernel` (reached via
// `_flash_fwd` <- `flash_attention_arrays`) and `_flash_bwd_dkv_kernel`
// (via `_flash_bwd`) at the head dims JAX's gate admits past 256
// (`pallas_ops.py:646`: any multiple of 128), in all their branches
// (causal, the additive mask and kv_lens, segment ids, non-causal),
// through one entry each, `flash_wide_tc_fwd` and `flash_wide_tc_dkv`.
// `flash_wide_fwd.cu` and `flash_wide_bwd.cu` keep fp32 at every such D,
// 16-bit past 1024, and the dQ kernel in every type.
//
// What bounds them on this card: per visible (query, key) pair the
// forward does 4 D FLOPs and dK/dV 8 D over 4 and 6 [S, D] slabs of bytes
// a head, ~S / 2 FLOPs a byte at D = 512 and S = 2048: the tensor cores
// (989 TFLOP/s in bf16 and fp16) bound both.
//
// The design: the head dim is spread over a thread block cluster.  A block
// is one warpgroup (128 threads) that owns 128 columns of Q, K, V, dO and
// of the outputs; a cluster of G = D / 128 blocks (3 at D = 384, 4 at
// 512, 8 at 1024) covers one query tile (forward) or key tile (dK/dV) over
// the full D.  Per tile of the loop each block computes its part of the
// scores over its own 128 columns with `wgmma` (m64nNk16, fp32
// accumulators; `flash_tc.cuh`): S (forward), S^T and dP^T (dK/dV).  The
// parts are summed across the cluster through distributed shared memory
// (`ld.shared::cluster`) in two steps, each after a cluster barrier: each
// block writes its part to its exchange buffer; each block sums, for the
// 1 / G of the values it owns, the G parts in rank order 0, 1, ..., G - 1
// and writes the sums over its own part (`reduce_own`); each block reads
// every sum from the block that owns it (`gather`).  Every block of the
// cluster thus holds the same scores, bit for bit, computed once per
// (query tile, key tile): a block's products cover its own columns only.
// Each block then runs the softmax (the exponentials G times over, on the
// accumulator fragments) and its own products of the second kind over its
// 128 columns, P V_w (forward), p^T dO_w and ds^T Q_w (dK/dV), with P and
// ds repacked from the accumulators as the A operand, as the D <= 256
// kernels do.  Two exchange buffers serve the tiles in turns, so the
// barrier after a tile's sums also tells that every block has read the
// buffer two tiles back: two barriers a tile.
//
// The exchange, not the products, bounds both kernels on the H100:
// `scripts/flash_wide_tc_variants.py` times them without it and without
// its reads of other blocks' shared memory (PERF.md keeps the numbers).
// Hence the two steps above, which read 2 (G - 1) / G of a part from
// other blocks where every block summing all G parts would read G - 1,
// and the two buffers, which save a barrier a tile.
//
// Why a cluster and not warpgroups of one block: O of a 64-row tile over
// D columns is 64 D fp32, 256 registers a thread of one warpgroup at
// D = 512 and the whole register file of an SM (65,536) at D = 1024, so
// no block can hold it; spread over G blocks on G SMs each holds 64 x 128.
// The largest D is 1024: G = 8 is the portable cluster size.  Past it the
// wrapper routes by shape to the CUDA-core kernels.
//
// Registers (per thread, 128 threads a block): forward, O_w 64 x 128 fp32
// = 64, S of a 64-key tile 32, its P fragments 16; dK/dV, dK_w and dV_w
// 64 each, S^T and dP^T of a 32-query tile 16 each, their fragments 8
// each.  Shared memory: forward, Q_w [64, 128] 16 KB, two cp.async stages
// of K_w and V_w [64, 128] 64 KB, two exchange buffers (64 x 64 fp32) 32
// KB, 1 KB of slack for the swizzle's alignment: 115,712 bytes, one block
// an SM; dK/dV, K_w and V_w [64, 128] 32 KB, two stages of Q_w and dO_w
// [32, 128] 32 KB, two exchange buffers (S^T and dP^T, 2 x 64 x 32 fp32)
// 32 KB and the slack: 99,328 bytes, two blocks an SM (64-query tiles,
// one block an SM, are slower: the variants script times both).  Neither
// depends on D.
//
// Rounding follows the TPU kernels: scores, the mask, the statistics and
// every sum stay fp32.  Forward: p is rounded to T for the P V product at
// the running max of its key tile of 64 (`pallas_ops.py:181`), and l sums
// the unrounded p (`:180`).  dK/dV: p rounded to dO's type before dV and
// ds = p (dP - delta) to the operand's type before dK (`:313-316`); dK is
// scaled at the end.  The branches are template flags, MASKED, SEGS and
// CAUSAL, with the tests, statistics and loop bounds of
// `flash_fwd_causal.cu` and `flash_bwd_causal.cu` (their headers say what
// each branch does): the forward's key loop stops at the diagonal, kv_lens
// ends it, the segment envelope (`flash::seg_envelope`) starts and ends
// it; the dK/dV loop starts at the first query tile that sees the key tile
// and visits only the query tiles of the envelope; the ragged edges are
// masked, so any S works; the tiles run longest first.  Every block of a
// cluster computes the same bounds, so all take part in the same barriers.
// lse (and with MASKED the pair m, log l) is written once per row, by the
// block of rank 0.
//
// Layout: q, k, v, dO are [B, S, H, D] with unit stride in D and stride D
// between heads; batch and sequence strides are arguments (16-byte-aligned
// rows, strides a multiple of 16 bytes).  out, dk and dv are contiguous
// [B, S, H, D] in the input type; lse, delta (and m, log l) contiguous fp32
// [B, H, Sq].  Causal alignment is at the end (query i sees keys <= i + Sk
// - Sq).
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr float NEG = -1e30f;
constexpr int DC = 128;          // columns a block owns
constexpr int THREADS = WG;      // one warpgroup a block
constexpr int MAX_CLUSTER = 8;   // the portable cluster size: D <= 1024
constexpr int BQ = 64;           // forward: query rows a cluster
constexpr int BK = 64;           // forward: keys a tile
constexpr int BKV = 64;          // dK/dV: keys a cluster
constexpr int BQT = 32;          // dK/dV: queries a tile

// [64, 128], [BK, 128] and [BQT, 128] tiles of a 2-byte type, in bytes
constexpr uint32_t TILE64 = 64 * DC * 2;
constexpr uint32_t TILEK = BK * DC * 2;
constexpr uint32_t TILEQ = BQT * DC * 2;
// an exchange buffer (two a kernel, used by turns): S of BK keys (BK / 2
// fp32 values a thread); S^T and dP^T of BQT queries (BQT values)
constexpr uint32_t FWD_XCH = BK / 2 * WG * 4;
constexpr uint32_t DKV_XCH = BQT * WG * 4;
constexpr int FWD_SMEM = TILE64 + 4 * TILEK + 2 * FWD_XCH + 1024;
constexpr int DKV_SMEM = 2 * TILE64 + 4 * TILEQ + 2 * DKV_XCH + 1024;

// ---------------------------------------------------------------------------
// clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// The address in block `rank`'s shared memory of what lies at `addr` in
// this block's.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(addr), "r"(rank));
  return d;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
// Every thread of every block of the cluster calls both, in turns:
// arrive (release), then wait (acquire) for every thread's arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// This thread's N accumulator values to the exchange at `xch` + 16 WG
// `at` (in 16-byte chunks: value i of thread t in chunk (at + i / 4) WG
// + t, so a warp's 16-byte stores and loads are contiguous).
template <int N>
__device__ __forceinline__ void put_part(uint32_t xch, int at,
                                         const float (&d)[N], int tid) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    sts128(xch + ((at + j) * WG + tid) * 16,
           make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]));
}

// The exchange holds NC chunks a thread; block g owns chunks [g NC / G,
// (g + 1) NC / G).  Each block sums, in rank order, the G blocks' parts of
// the chunks it owns and writes the sums over its own parts (no other block
// reads those chunks of its exchange until the next barrier).
template <int NC>
__device__ __forceinline__ void reduce_own(uint32_t xch, int G, int rank,
                                           int tid) {
  const int c1 = (rank + 1) * NC / G;
  for (int c = rank * NC / G; c < c1; ++c) {
    const uint32_t off = (c * WG + tid) * 16;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < G; ++g) {
      const float4 x = g == rank ? lds128(xch + off)
                                 : ld_cluster(cluster_map(xch, g) + off);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    sts128(xch + off, sum);
  }
}

// d = the sums of chunks at .. at + N / 4 - 1, each read from the block
// that owns it (`reduce_own`).
template <int N, int NC>
__device__ __forceinline__ void gather(float (&d)[N], uint32_t xch, int at,
                                       int G, int rank, int tid) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = at + j, owner = (c * G + G - 1) / NC;
    const uint32_t off = (c * WG + tid) * 16;
    const float4 x = owner == rank ? lds128(xch + off)
                                   : ld_cluster(cluster_map(xch, owner) + off);
    d[4 * j] = x.x;
    d[4 * j + 1] = x.y;
    d[4 * j + 2] = x.z;
    d[4 * j + 3] = x.w;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdParams {
  const void *q, *k, *v;
  void* out;
  float *lse, *rowmax, *logsum;
  const float* mask;
  const int *kv_lens, *segs;
  int H, Sq, Sk, D;
  long long qsb, qss, ksb, kss, vsb, vss, msb, msh, msq, msk, ssb;
  float scale;
};

// T: __nv_bfloat16 or __half, the inputs' and the output's type and the
// operand type of both products (P rounded to T).
template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_wide_tc_fwd_kernel(const FwdParams p) {
  extern __shared__ uint8_t smem[];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // Q at sq; stage st holds K at sq + TILE64 + 2 TILEK st and V after it;
  // the exchange after the ring
  const uint32_t sq = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t xch = sq + TILE64 + 4 * TILEK;
  const int G = p.D / DC, rank = cluster_rank();
  const int tile = gridDim.x / G - 1 - blockIdx.x / G;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int Sq = p.Sq, Sk = p.Sk;
  const int q0 = tile * BQ, offset = Sk - Sq;
  const int klen =
      MASKED && p.kv_lens ? min(max(p.kv_lens[b], 0), Sk) : Sk;
  // this thread's two query rows (accumulator values i with (i/2)%2 = r)
  int qpos[2], lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + acc_row(2 * r, tid);
    lim[r] = qpos[r] + offset;   // last key the row may attend (causal)
  }
  // this block's 128 columns of the head
  const long long col = (long long)h * p.D + rank * DC;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + col;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + col;
  const float* mb = MASKED && p.mask ? p.mask + b * p.msb + h * p.msh
                                     : nullptr;
  const int* sb = SEGS ? p.segs + b * p.ssb : nullptr;
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
  load_tile<BQ, DC, THREADS>(sq, static_cast<const T*>(p.q) + b * p.qsb + col,
                             p.qss, q0, Sq, tid);
  if (ntiles > 0) {
    load_tile<BK, DC, THREADS>(sq + TILE64, kb, p.kss, kbeg, Sk, tid);
    load_tile<BK, DC, THREADS>(sq + TILE64 + TILEK, vb, p.vss, kbeg, Sk,
                               tid);
  }
  cp_async_commit();

  float o[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
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
      float x = s[i] * p.scale;
      if constexpr (MASKED) {
        if (mb && (!TEST || kp < Sk))
          x += mb[(long long)min(qpos[r], Sq - 1) * p.msq + kp * p.msk];
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
    const uint32_t sk = sq + TILE64 + 2 * TILEK * (it & 1), sv = sk + TILEK;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) {
      const uint32_t nk = sq + TILE64 + 2 * TILEK * ((it + 1) & 1);
      load_tile<BK, DC, THREADS>(nk, kb, p.kss, k0 + BK, Sk, tid);
      load_tile<BK, DC, THREADS>(nk + TILEK, vb, p.vss, k0 + BK, Sk, tid);
    }
    cp_async_commit();

    // this block's part of S = Q K^T, over its 128 columns
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk)
      mma_ss_nk<BK, T>(s, desc_k<BQ>(sq, kk), desc_k<BK>(sk, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    // S: the cluster's parts, summed in rank order
    const uint32_t xb = xch + FWD_XCH * (it & 1);   // this tile's buffer
    put_part(xb, 0, s, tid);
    cluster_arrive();
    cluster_wait();               // every block's part has landed
    reduce_own<BK / 8>(xb, G, rank, tid);
    cluster_arrive();
    cluster_wait();               // every block's sums have landed
    gather<BK / 2, BK / 8>(s, xb, 0, G, rank, tid);

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
      for (int i = 2 * r; i < DC / 2; i += 4) {
        o[i] *= alpha;
        o[i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = expf(s[i] - base[(i / 2) % 2]);
      l[(i / 2) % 2] += s[i];
    }
    // O_w += P V_w, P rounded to T as the A operand
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs<DC, T>(o, pa[kk], desc_mn<BK>(sv, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();
  if (ntiles > 0) {   // no block still reads this one's exchange
    cluster_arrive();
    cluster_wait();
  }

  T* ob = static_cast<T*>(p.out) + ((long long)b * Sq * p.H) * p.D + col;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qpos[r] >= Sq) continue;
    T* op = ob + (long long)qpos[r] * p.H * p.D;
#pragma unroll
    for (int i = 2 * r; i < DC / 2; i += 4)
      store2<T>(op + acc_col(i, tid), o[i] / ls, o[i + 1] / ls);
    if (rank == 0 && tid % 4 == 0) {
      const long long row = ((long long)b * p.H + h) * Sq + qpos[r];
      p.lse[row] = m[r] + logf(ls);
      if constexpr (MASKED) {
        p.rowmax[row] = m[r];
        p.logsum[row] = logf(ls);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

struct DkvParams {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *rowmax, *mask;
  const int *kv_lens, *segs;
  void *dk, *dv;
  int H, Sq, Sk, D;
  long long qsb, qss, ksb, kss, vsb, vss, dsb, dss, msb, msh, msq, msk, ssb;
  float scale;
};

// T: the inputs' and the outputs' type and the operand type of every
// product (p and ds rounded to T).  Keys are the M dimension of `wgmma`.
template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
    flash_wide_tc_dkv_kernel(const DkvParams p) {
  extern __shared__ uint8_t smem[];
  // the query tile's statistics (and ids), one set per stage
  __shared__ float ls[2][BQT], dls[2][BQT];
  __shared__ float mrs[MASKED ? 2 : 1][MASKED ? BQT : 1];
  __shared__ int qids[SEGS ? 2 : 1][SEGS ? BQT : 1];
  __shared__ int red[SEGS ? 2 * THREADS / 32 : 1];
  // K_w at sk, V_w at sv; stage st holds Q_w at sv + TILE64 + 2 TILEQ st
  // and dO_w after it; the exchange after the ring
  const uint32_t sk = (smem_addr(smem) + 1023u) & ~1023u, sv = sk + TILE64;
  const uint32_t xch = sv + TILE64 + 4 * TILEQ;
  const int G = p.D / DC, rank = cluster_rank();
  const int kt = gridDim.x / G - 1 - blockIdx.x / G;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int Sq = p.Sq, Sk = p.Sk;
  const int k0 = kt * BKV, offset = Sk - Sq;
  const int klen =
      MASKED && p.kv_lens ? min(max(p.kv_lens[b], 0), Sk) : Sk;
  // this thread's two key rows (accumulator values i with (i/2)%2 = r)
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + acc_row(2 * r, tid);

  const long long col = (long long)h * p.D + rank * DC;
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + col;
  const T* db = static_cast<const T*>(p.dout) + b * p.dsb + col;
  const long long stat0 = ((long long)b * p.H + h) * Sq;
  const float* mb = MASKED && p.mask ? p.mask + b * p.msb + h * p.msh
                                     : nullptr;
  const int* sb = SEGS ? p.segs + b * p.ssb : nullptr;
  // causal: the first query that sees this tile's first key, rounded down
  // to a tile; no query when every key lies past kv_len
  int qstart = CAUSAL ? (max(k0 - offset, 0) / BQT) * BQT : 0;
  int qend = MASKED && k0 >= klen ? 0 : Sq;
  int kid[2] = {0, 0};
  if constexpr (SEGS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) kid[r] = sb[min(kpos[r], Sk - 1)];
    const int2 env = flash::seg_envelope<THREADS>(
        sb, Sq, min(kid[0], kid[1]), max(kid[0], kid[1]), red);
    qstart = max(qstart, env.x / BQT * BQT);
    qend = min(qend, env.y);
  }
  const int ntiles = qend > qstart ? (qend - qstart + BQT - 1) / BQT : 0;

  // issue the copies of query tile `it` into its stage
  auto stage = [&](int it) {
    const int q0 = qstart + it * BQT, st = it & 1;
    const uint32_t dst = sv + TILE64 + 2 * TILEQ * st;
    load_tile<BQT, DC, THREADS>(dst, qb, p.qss, q0, Sq, tid);
    load_tile<BQT, DC, THREADS>(dst + TILEQ, db, p.dss, q0, Sq, tid);
    if (tid < BQT) {
      const int qp = q0 + tid;
      const bool in = qp < Sq;
      ls[st][tid] = in ? p.lse[stat0 + qp] : 0.f;
      dls[st][tid] = in ? p.delta[stat0 + qp] : 0.f;
      if constexpr (MASKED) mrs[st][tid] = in ? p.rowmax[stat0 + qp] : 0.f;
      if constexpr (SEGS) qids[st][tid] = in ? sb[qp] : 0;
    }
  };
  load_tile<BKV, DC, THREADS>(sk, static_cast<const T*>(p.k) + b * p.ksb + col,
                              p.kss, k0, Sk, tid);
  load_tile<BKV, DC, THREADS>(sv, static_cast<const T*>(p.v) + b * p.vsb + col,
                              p.vss, k0, Sk, tid);
  if (ntiles > 0) stage(0);
  cp_async_commit();

  // this block's 128 columns of dK and dV
  float dka[DC / 2], dva[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[BQT / 2], dp[BQT / 2];   // S^T and dP^T: rows keys, columns queries

  // p (in s) and ds = p (dP - delta) (in dp) of query tile q0 in stage st
  auto probs = [&](int q0, int st, auto test) {
    constexpr bool TEST = decltype(test)::value;
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) {
      const int r = (i / 2) % 2, c = acc_col(i, tid), qp = q0 + c;
      float x = s[i] * p.scale;
      float pr;
      if constexpr (MASKED) {
        if (mb && (!TEST || (qp < Sq && kpos[r] < Sk)))
          x += mb[(long long)qp * p.msq + (long long)kpos[r] * p.msk];
        pr = expf((x - mrs[st][c]) - ls[st][c]);
      } else {
        pr = expf(x - ls[st][c]);
      }
      if constexpr (TEST) {
        bool ok = qp < Sq && (!CAUSAL || qp + offset >= kpos[r]);
        if constexpr (MASKED) ok = ok && kpos[r] < klen;
        if constexpr (SEGS) ok = ok && qids[st][c] == kid[r];
        pr = ok ? pr : 0.f;
      }
      s[i] = pr;
      dp[i] = pr * (dp[i] - dls[st][c]);
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BQT, st = it & 1;
    const uint32_t sq = sv + TILE64 + 2 * TILEQ * st, sdo = sq + TILEQ;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < ntiles) stage(it + 1);
    cp_async_commit();

    // this block's parts of S^T = K Q^T and dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) s[i] = dp[i] = 0.f;
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk)
      mma_ss_nk<BQT, T>(s, desc_k<BKV>(sk, kk), desc_k<BQT>(sq, kk), 1);
#pragma unroll
    for (int kk = 0; kk < DC / 16; ++kk)
      mma_ss_nk<BQT, T>(dp, desc_k<BKV>(sv, kk), desc_k<BQT>(sdo, kk), 1);
    mma_commit();
    mma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // the cluster's parts, summed in rank order
    const uint32_t xb = xch + DKV_XCH * (it & 1);   // this tile's buffer
    put_part(xb, 0, s, tid);
    put_part(xb, BQT / 8, dp, tid);
    cluster_arrive();
    cluster_wait();               // every block's part has landed
    reduce_own<BQT / 4>(xb, G, rank, tid);
    cluster_arrive();
    cluster_wait();               // every block's sums have landed
    gather<BQT / 2, BQT / 4>(s, xb, 0, G, rank, tid);
    gather<BQT / 2, BQT / 4>(dp, xb, BQT / 8, G, rank, tid);

    if (SEGS || (MASKED && k0 + BKV > klen) || q0 + BQT > Sq ||
        (CAUSAL && q0 + offset < k0 + BKV - 1))
      probs(q0, st, std::true_type{});
    else
      probs(q0, st, std::false_type{});

    // dV_w += T(p)^T dO_w and dK_w += T(ds)^T Q_w, the A operands from the
    // accumulators, dO_w and Q_w read MN-major
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      pack_a<T>(pa[kk], s, kk);
      pack_a<T>(da[kk], dp, kk);
    }
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      mma_rs<DC, T>(dva, pa[kk], desc_mn<BQT>(sdo, kk));
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      mma_rs<DC, T>(dka, da[kk], desc_mn<BQT>(sq, kk));
    mma_commit();
    mma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();
  if (ntiles > 0) {   // no block still reads this one's exchange
    cluster_arrive();
    cluster_wait();
  }

  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Sk) continue;
    const long long o = ((long long)b * Sk + kpos[r]) * p.H * p.D + col;
#pragma unroll
    for (int i = 2 * r; i < DC / 2; i += 4) {
      const int c = acc_col(i, tid);
      store2<T>(dk + o + c, dka[i] * p.scale, dka[i + 1] * p.scale);
      store2<T>(dv + o + c, dva[i], dva[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// One launch of `kernel` over `grid`, clusters of G blocks along x.
template <typename P>
int launch_cluster(void (*kernel)(P), const P& params, dim3 grid, int smem,
                   int G, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, params);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  auto* kernel = flash_wide_tc_fwd_kernel<T, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  (void)attr;   // a refusal shows as the launch's error
  const int G = p.D / DC;
  return launch_cluster(kernel, p, dim3((p.Sq + BQ - 1) / BQ * G, p.H, B),
                        FWD_SMEM, G, stream);
}

template <typename T, bool MASKED, bool SEGS, bool CAUSAL>
int launch_dkv(const DkvParams& p, int B, cudaStream_t stream) {
  auto* kernel = flash_wide_tc_dkv_kernel<T, MASKED, SEGS, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  (void)attr;   // a refusal shows as the launch's error
  const int G = p.D / DC;
  return launch_cluster(kernel, p, dim3((p.Sk + BKV - 1) / BKV * G, p.H, B),
                        DKV_SMEM, G, stream);
}

// The instantiation for a type code (1 bf16, 2 fp16) and the branches;
// cudaErrorInvalidValue for another code or a head size that is not a
// multiple of 128 in [128, 1024].
template <bool MASKED, bool SEGS, bool CAUSAL, typename P>
int by_type(const P& p, int B, int dtype, cudaStream_t stream) {
  constexpr bool FWD = std::is_same<P, FwdParams>::value;
  switch (dtype) {
    case 1:
      if constexpr (FWD)
        return launch_fwd<__nv_bfloat16, MASKED, SEGS, CAUSAL>(p, B, stream);
      else
        return launch_dkv<__nv_bfloat16, MASKED, SEGS, CAUSAL>(p, B, stream);
    case 2:
      if constexpr (FWD)
        return launch_fwd<__half, MASKED, SEGS, CAUSAL>(p, B, stream);
      else
        return launch_dkv<__half, MASKED, SEGS, CAUSAL>(p, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename P>
int dispatch(const P& p, int B, int dtype, int causal, bool masked,
             bool segs, cudaStream_t stream) {
  if (p.D <= 0 || p.D % DC != 0 || p.D / DC > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((masked ? 4 : 0) + (segs ? 2 : 0) + (causal != 0)) {
    case 0: return by_type<false, false, false>(p, B, dtype, stream);
    case 1: return by_type<false, false, true>(p, B, dtype, stream);
    case 2: return by_type<false, true, false>(p, B, dtype, stream);
    case 3: return by_type<false, true, true>(p, B, dtype, stream);
    case 4: return by_type<true, false, false>(p, B, dtype, stream);
    case 5: return by_type<true, false, true>(p, B, dtype, stream);
    case 6: return by_type<true, true, false>(p, B, dtype, stream);
    default: return by_type<true, true, true>(p, B, dtype, stream);
  }
}

}  // namespace

// The arguments of `flash_wide_fwd` (flash_wide_fwd.cu) and of
// `flash_wide_dkv` (flash_wide_bwd.cu), in the same order: mask fp32 with
// element strides msb, msh, msq, msk (0 broadcasts), or null; kv_lens
// int32 [B], or null; segs int32 [B, S] with batch stride ssb and unit
// stride in S, or null; causal 0 or 1.  The forward writes rowmax and
// logsum (m and log l) with a mask or kv_lens (null otherwise); with a mask
// or kv_lens, dK/dV reads lse as log l and rowmax as m.  dtype: the
// element type's code, 1 bf16 or 2 fp16.  Both return the launch's error
// (cudaLaunchKernelEx, then cudaGetLastError()); 1 (cudaErrorInvalidValue)
// for a type code they do not take or a head size that is not a multiple
// of 128 in [128, 1024].
extern "C" int flash_wide_tc_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* rowmax, void* logsum, const void* mask, const void* kv_lens,
    const void* segs, int B, int H, int Sq, int Sk, int D, int dtype,
    int causal, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long msb, long long msh,
    long long msq, long long msk, long long ssb, float scale, void* stream) {
  const FwdParams p{q,   k,   v,   out, static_cast<float*>(lse),
                    static_cast<float*>(rowmax),
                    static_cast<float*>(logsum),
                    static_cast<const float*>(mask),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(segs),
                    H,   Sq,  Sk,  D,   qsb, qss, ksb, kss, vsb, vss,
                    msb, msh, msq, msk, ssb, scale};
  return dispatch(p, B, dtype, causal, mask || kv_lens, segs != nullptr,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int flash_wide_tc_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* rowmax, const void* mask,
    const void* kv_lens, const void* segs, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int dtype, int causal, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb, long long vss,
    long long dsb, long long dss, long long msb, long long msh, long long msq,
    long long msk, long long ssb, float scale, void* stream) {
  const DkvParams p{q,   k,   v,   dout,
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<const float*>(rowmax),
                    static_cast<const float*>(mask),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(segs),
                    dk,  dv,  H,   Sq,  Sk,  D,   qsb, qss, ksb, kss, vsb,
                    vss, dsb, dss, msb, msh, msq, msk, ssb, scale};
  return dispatch(p, B, dtype, causal, mask || kv_lens, segs != nullptr,
                  static_cast<cudaStream_t>(stream));
}
