// One transformer layer's decode step (S_q = 1) in one launch, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fused_decode_layer_kernel`
// (reached via `fused_decode_layer_arrays`): LN1 -> qkv -> write of the
// new token's K/V at ring row t -> online-softmax attention over the t
// cached keys (plus an optional additive row mask) and the current token
// -> out-proj -> residual.  The TPU kernel exists to cut the launch count
// of a decode step; this one keeps that: one launch per layer per step.
// Like the TPU kernel, which takes t through scalar prefetch (`len_ref`)
// over a grid fixed by the shapes, this one may read t from device memory
// (`tpos`) and work out its split geometry from it: the grid and scratch
// are sized for every t < S_max, so a launch captured in a CUDA graph at
// one step serves the next.
//
// What bounds it on this card: memory.  A step reads the layer's weights
// once (4 * hd^2 elements: 4.7 MB in bf16 at GPT-2 width) and the valid
// K/V prefix once (2 * B * t * hd elements: 25 MB at B = 8, t = 1023), at
// a few FLOPs per element.
//
// What the design does about it: a cooperative launch (all blocks
// co-resident, `cooperative_groups::this_grid().sync()` between the three
// phases, each of which needs all of the previous one), 256 threads a
// block, as many blocks as fit on the card at once (the wrapper's grid).
// Every phase is a grid-stride loop over units of work that each read
// their bytes with 16-byte loads, all issued before any arithmetic:
//  1. qkv.  Every block that has a unit computes LN1 of all B rows while
//     the weights of its first unit are in flight: the statistics a warp
//     a row (fp32, two passes over the row's 16-byte pieces, the second
//     from L1), then xn a thread a column for every row, rounded to the
//     weights' type into shared memory.  A unit is 128 bytes of wqkv's
//     columns (64 bf16 / 32 fp32) by a chunk of 32 L1 of its rows: 8
//     threads a 128-byte row segment, 32 rows at once, L1 loads a thread
//     (216 units at GPT-2 width in either type, where tiles of 32 bytes
//     read 2 bytes a lane made 144).  Each thread keeps an
//     fp32 sum per (batch row, column) of its rows for up to 8 batch rows
//     a pass, the four row groups of a warp add by shuffles and the warps
//     in warp order (one barrier), and the unit writes an fp32 partial per
//     k-chunk.
//  2. Attention, split-K at warp granularity: one task per (split, head,
//     row), one warp each, with as many splits of whole runs of 32 keys
//     as let every task run in one round of the co-resident warps
//     (`fused_split`, computed here from t and the wrapper's cap of splits
//     a (row, head): 11 splits of 96 keys, 1056 tasks at B = 8, t = 1023
//     on an H100's 132 blocks of 8 warps), so that every warp runs its
//     chain of memory round trips on its own (block tasks of 128 keys,
//     each waiting on its barriers, took 30 of the kernel's 50 us at
//     t = 1023, PERF.md).  A warp sums its q from the k-chunk partials in chunk
//     order (+ the fp32 bias) straight into registers, runs the key loop
//     of `decode_common.cuh` (shared with flash_decode and the ragged
//     kernel: 16-byte loads, D / VE lanes a key (the whole warp, and two
//     loads a lane in fp32, at D = 256), a whole run of 32 keys in flight
//     where that is at most 8 loads a lane, an online softmax; the mask
//     added to the scores) and writes its fp32 partial (m, l,
//     acc[D]).  The last warp of the (row, head) to finish (a
//     self-resetting ticket, `warp_last_of`) merges the splits in split
//     order, its loads issued eight chunks and eight splits at a time,
//     adds the current token's term from the fp32 q, k and v (summed as
//     q), writes the output rounded to the weights' type to the scratch,
//     and the new K/V rows (rounded to the cache type) at row t, which no
//     block of this launch reads.  Phase 2 has no block barrier.
//  3. Out-proj as phase 1 over wo (L3 loads a thread), each unit staging
//     its chunk of the attention output; the weights of a block's first
//     unit are loaded before the grid sync that ends phase 2.  The last
//     unit of a column slice to finish (ticket) adds the k-chunk partials
//     in chunk order: y = x + (proj + bo) in fp32, cast to x's type.
// Sums are fp32 and in a fixed order throughout, so a second launch gives
// the first one's bits.  The cooperative launch stays: one launch a layer
// is what the TPU kernel is for, and a step of the host-bound fused mode
// pays for every launch.
//
// Rounding points (the TPU kernel's, `pallas_ops.py:1208-1256`): LN in
// fp32; xn rounded to the weights' type before the qkv product; q, k, v in
// fp32; probabilities rounded to the cache type before the value product,
// each at its warp's running max (then rescaled in fp32); the attention
// output rounded to the weights' type before the out-proj; the residual
// in fp32.  q.k sums in fp32 (the TPU kernel rounds each product to bf16
// first; not copied).
//
// Layout: x, y [B, hd]; wqkv [hd, 3hd]; wo [hd, hd]; biases and LN
// parameters [hd] / [3hd]; rings contiguous [B, S_max, hd]; all one type,
// the weights 16-byte aligned.  mask: null or a contiguous fp32 [B, S_max].
// Scratch (fp32, from the wrapper's per-device buffer): part1
// [hd / (32 L1)][B][3hd], attn [B][hd], part2 ((m, l) [B H][splits], then
// acc [B H][splits][D]), part3 [hd / (32 L3)][B][hd]; tickets: B H + hd /
// (128 bytes of columns) ints, zero before and after every launch.  The
// wrapper's `fused_plan` lays these out for the most splits any t < S_max
// takes and picks L1, L3, the cap of splits and the grid.  t is clamped
// into [1, S_max - 1].
#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;                    // batch rows per pass over a unit
constexpr int SEG = 8;                   // threads per 128-byte row segment
constexpr int GROUPS = THREADS / SEG;    // weight rows loaded at once
constexpr int RUN = 32;                  // keys a warp task walks at once
// loads of K (and V) a lane keeps in flight: a whole run of 32 keys where
// that is at most 8 16-byte loads (bf16 at D = 64; 16 keys in fp32; 8 keys
// at D = 256 in bf16, 4 in fp32, whose rows take two loads a lane)
template <typename T, int D>
constexpr int U = RUN / RowLanes<T, D>::KPW < 8 / RowLanes<T, D>::NV
                      ? RUN / RowLanes<T, D>::KPW
                      : 8 / RowLanes<T, D>::NV;

// columns of a unit (128 bytes of a weight row), loads a thread at most
template <typename T>
constexpr int CW = 128 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int LMAX = 2 * static_cast<int>(sizeof(T));   // 4 bf16, 8 fp32

template <typename T>
struct Args {
  const T* x;
  const T* lnw;
  const T* lnb;
  const T* wqkv;
  const T* bqkv;
  const T* wo;
  const T* bo;
  T* kc;
  T* vc;
  const float* mask;   // null: no mask
  float* part1;        // [chunks1][B][3hd]
  float* attn;         // [B][hd]
  float* part2;        // (m, l) [B H][splits], then acc [B H][splits][D]
  float* part3;        // [chunks3][B][hd]
  int* tickets;        // B H (phase 2), then hd / CW (phase 3)
  T* y;
  const int* tpos;     // null, or t - `t` in device memory
  int B, H, S_max, t;
  int l1, l3;          // loads a thread per unit of phases 1 and 3
  int cap;             // splits a (row, head) at most in phase 2
  float eps, scale;
};

// The weights of one unit into registers: rows k0 + grp + 32 l (l < L) of
// W [K, N], this thread's 16 bytes of columns c0 .. c0 + CW.
template <typename T>
__device__ __forceinline__ void load_unit(const T* __restrict__ W, int N,
                                          int k0, int c0, int L,
                                          uint4 (&wr)[LMAX<T>]) {
  const int seg = threadIdx.x % SEG, grp = threadIdx.x / SEG;
#pragma unroll
  for (int l = 0; l < LMAX<T>; ++l)
    if (l < L)
      wr[l] = __ldg(reinterpret_cast<const uint4*>(
          W + (long long)(k0 + grp + GROUPS * l) * N + c0 + seg * VE<T>));
}

// One unit's fp32 partial sums: part[row * N + c0 + c] = sum over the
// unit's weight rows k of xs(row, k) * W[k][c0 + c], for every batch row.
// xs holds the activations as [row chunk][k][RB] fp32 (rows past B zero)
// with `kstride` k's a chunk; the unit's rows are xk0 + grp + 32 l.
template <typename T>
__device__ __forceinline__ void gemv_unit(const uint4 (&wr)[LMAX<T>], int L,
                                          const float* xs, int kstride,
                                          int xk0, int B, float* red,
                                          float* __restrict__ part, int N,
                                          int c0) {
  constexpr int V = VE<T>, C = CW<T>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int seg = tid % SEG, grp = tid / SEG;
  for (int rc = 0; rc * RB < B; ++rc) {
    float acc[RB][V];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
    const float* xc = xs + (long long)rc * kstride * RB;
#pragma unroll
    for (int l = 0; l < LMAX<T>; ++l) {
      if (l < L) {
        float wv[V];
        widen(wr[l], wv);
        const float* xr = xc + (xk0 + grp + GROUPS * l) * RB;
        const float4 a = *reinterpret_cast<const float4*>(xr);
        const float4 b = *reinterpret_cast<const float4*>(xr + 4);
        const float xv[RB] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[r][j] = fmaf(wv[j], xv[r], acc[r][j]);
      }
    }
    // over the four row groups of a warp (lanes 8 and 16 apart), then over
    // the warps in order
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
      }
    if (lane < SEG) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[(warp * RB + r) * C + seg * V + j] = acc[r][j];
    }
    __syncthreads();
    for (int e = tid; e < RB * C; e += THREADS) {
      const int r = e / C, c = e % C;
      if (rc * RB + r >= B) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * RB + r) * C + c];
      part[(long long)(rc * RB + r) * N + c0 + c] = s;
    }
    __syncthreads();   // red is reused
  }
}

// sum over the k-chunk partials of column `col` of row `row`, in chunk order
__device__ __forceinline__ float chunk_sum(const float* part, int chunks,
                                           int B, int N, int row, int col) {
  const float* p = part + (long long)row * N + col;
  const long long step = (long long)B * N;
  float s = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += 8) {   // 8 loads in flight
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = c0 + c < chunks ? __ldcg(p + (c0 + c) * step) : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) s += v[c];
  }
  return s;
}

// One block an SM: held to 128 registers for two, the kernel spills
// 200-256 bytes and its bf16 layer at t = 1023 took 0.0464 ms against
// 0.0403 on an H100 (PERF.md).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fused_decode_layer_kernel(
    Args<T> a) {
  constexpr int C = CW<T>;
  using L = RowLanes<T, D>;             // lanes and loads of a key row
  extern __shared__ __align__(16) float xs[];   // [ceil(B/RB)][hd][RB]
  __shared__ __align__(16) float red[WARPS * RB * C];
  __shared__ int is_last;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int B = a.B, H = a.H, hd = H * D, S_max = a.S_max;
  const int t = min(max(a.t + (a.tpos ? __ldg(a.tpos) : 0), 1), S_max - 1);
  const int nrows = (B + RB - 1) / RB * RB;
  const int ncol3 = 3 * hd;

  // -- phase 1: LN1 of every row, then the qkv units ----------------------
  const int slices1 = ncol3 / C, chunks1 = hd / (GROUPS * a.l1);
  const int units1 = slices1 * chunks1;
  uint4 wr[LMAX<T>];
  if (blockIdx.x < units1)   // in flight while LN1 runs
    load_unit(a.wqkv, ncol3, blockIdx.x / slices1 * GROUPS * a.l1,
              blockIdx.x % slices1 * C, a.l1, wr);
  // LN1 (a block with no unit of phase 1 skips it: nothing reads its xs).
  // The statistics, a warp a row: the row's 16-byte pieces, four a lane
  // in flight, summed once for the mean and again (from L1) for the
  // variance; kept in `red`, free until the first unit.
  float* stats = red;                            // mu, rstd per row
  const int nvec = hd / VE<T>;
  // the LN weights of this thread's first four columns, in flight with x
  float w[4], bb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = tid + j * THREADS;
    const bool ok = k < hd && blockIdx.x < units1;
    w[j] = ok ? to_f(a.lnw[k]) : 0.f;
    bb[j] = ok ? to_f(a.lnb[k]) : 0.f;
  }
  for (int row = warp; row < B && blockIdx.x < units1; row += WARPS) {
    const uint4* xv =
        reinterpret_cast<const uint4*>(a.x + (long long)row * hd);
    float mu = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      float acc = 0.f;
      for (int v0 = lane; v0 < nvec; v0 += 4 * 32) {
        uint4 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + 32 * j < nvec) r[j] = __ldg(xv + v0 + 32 * j);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (v0 + 32 * j >= nvec) continue;
          float f[VE<T>];
          widen(r[j], f);
#pragma unroll
          for (int i = 0; i < VE<T>; ++i) {
            const float c = f[i] - mu;
            acc = pass ? fmaf(c, c, acc) : acc + f[i];
          }
        }
      }
      const float total = warp_sum(acc);
      if (pass == 0) {
        mu = total / hd;
      } else if (lane == 0) {
        stats[2 * row] = mu;
        stats[2 * row + 1] = 1.f / sqrtf(total / hd + a.eps);
      }
    }
  }
  __syncthreads();
  // ... then xn, a thread a column k for every row: xs(row, k) for the RB
  // rows of a chunk are 8 consecutive floats, written as two float4s
  // (neighbouring threads on neighbouring k: no bank conflict); the LN
  // weights four columns a thread at a time, x from L1
  for (int k0 = tid; k0 < hd && blockIdx.x < units1; k0 += 4 * THREADS) {
    if (k0 != tid) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * THREADS;
        w[j] = k < hd ? to_f(a.lnw[k]) : 0.f;
        bb[j] = k < hd ? to_f(a.lnb[k]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * THREADS;
      if (k >= hd) continue;
      for (int rc = 0; rc * RB < nrows; ++rc) {
        float o[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int row = rc * RB + r;
          o[r] = row < B ? round_to<T>((to_f(a.x[(long long)row * hd + k]) -
                                        stats[2 * row]) *
                                           stats[2 * row + 1] * w[j] +
                                       bb[j])
                         : 0.f;
        }
        float4* dst =
            reinterpret_cast<float4*>(xs + ((long long)rc * hd + k) * RB);
        dst[0] = make_float4(o[0], o[1], o[2], o[3]);
        dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
  }
  __syncthreads();
  for (int u = blockIdx.x; u < units1; u += gridDim.x) {
    const int k0 = u / slices1 * GROUPS * a.l1, c0 = u % slices1 * C;
    if (u != blockIdx.x) load_unit(a.wqkv, ncol3, k0, c0, a.l1, wr);
    gemv_unit<T>(wr, a.l1, xs, hd, k0, B, red,
                 a.part1 + (long long)(u / slices1) * B * ncol3, ncol3, c0);
  }
  grid.sync();

  // -- phase 2: attention per (split, head, row), one warp each, and the
  //    ring write ---------------------------------------------------------
  // the split of `fused_split` (ops/fused_decode.py): at most `cap`
  // splits of whole runs of RUN keys
  const int want = max(1, min((t + RUN - 1) / RUN, a.cap));
  const int span = ((t + want - 1) / want + RUN - 1) / RUN * RUN;
  const int splits = (t + span - 1) / span;      // keys a split: span
  const int bhs = B * H;
  const int d0 = (lane % L::LPK) * VE<T>;
  constexpr int DPL = D / 32;                    // dims a lane merges
  for (int task = blockIdx.x * WARPS + warp; task < bhs * splits;
       task += gridDim.x * WARPS) {
    const int bh = task / splits, split = task % splits;
    const int b = bh / H, h = bh % H;
    // this lane's q, straight into registers (nothing waits on it before
    // the K and V loads are in flight): the k-chunk partials in chunk
    // order, then the bias, as `chunk_sum`
    float qv[L::PER];
#pragma unroll
    for (int i = 0; i < L::PER; ++i) qv[i] = 0.f;
    for (int c = 0; c < chunks1; ++c) {
      const float* p = a.part1 + ((long long)c * B + b) * ncol3 + h * D + d0;
#pragma unroll
      for (int j = 0; j < L::NV; ++j)
#pragma unroll
        for (int i = 0; i < VE<T>; i += 4) {
          const float4 v = __ldcg(
              reinterpret_cast<const float4*>(p + j * L::STEP + i));
          const int x = j * VE<T> + i;
          qv[x] += v.x;
          qv[x + 1] += v.y;
          qv[x + 2] += v.z;
          qv[x + 3] += v.w;
        }
    }
#pragma unroll
    for (int j = 0; j < L::NV; ++j)
#pragma unroll
      for (int i = 0; i < VE<T>; ++i)
        qv[j * VE<T> + i] += to_f(a.bqkv[h * D + d0 + j * L::STEP + i]);
    const long long base = (long long)b * S_max * hd + h * D;
    const RingKeys<T, true> keys{
        a.kc + base + d0, a.vc + base + d0, hd, a.scale,
        a.mask ? a.mask + (long long)b * S_max : nullptr};
    const int lo = split * span;
    float m, l, acc[L::PER];
    warp_attend<T, D, U<T, D>, RUN>(keys, qv, lo, min(lo + span, t),
                                    RUN, m, l, acc);
    // this split's partial; the last warp of the (row, head) to finish
    // merges the splits in split order
    float2* ml = reinterpret_cast<float2*>(a.part2) + (long long)bh * splits;
    float* pacc = a.part2 + 2LL * bhs * splits + (long long)bh * splits * D;
    if (lane < L::LPK) {
#pragma unroll
      for (int j = 0; j < L::NV; ++j)
#pragma unroll
        for (int i = 0; i < VE<T>; ++i)
          pacc[(long long)split * D + d0 + j * L::STEP + i] =
              acc[j * VE<T> + i];
    }
    if (lane == 0) ml[split] = make_float2(m, l);
    if (!warp_last_of(a.tickets + bh, splits)) continue;
    // the merge, its loads in few round trips: q, k and v of the dims this
    // lane merges (the k-chunk partials, four chunks at once, summed in
    // chunk order as `chunk_sum`) beside the splits' (m, l), a lane each;
    // then the splits' acc, eight splits at once, added in split order
    float qd[DPL], kd[DPL], vd[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) qd[i] = kd[i] = vd[i] = 0.f;
    for (int c0 = 0; c0 < chunks1; c0 += 4) {
      float pq[4][DPL], pk[4][DPL], pv[4][DPL];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const bool ok = c0 + c < chunks1;
          const float* p = a.part1 + ((long long)(c0 + c) * B + b) * ncol3 +
                           h * D + lane + 32 * i;
          pq[c][i] = ok ? __ldcg(p) : 0.f;
          pk[c][i] = ok ? __ldcg(p + hd) : 0.f;
          pv[c][i] = ok ? __ldcg(p + 2 * hd) : 0.f;
        }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          if (c0 + c >= chunks1) continue;
          qd[i] += pq[c][i];
          kd[i] += pk[c][i];
          vd[i] += pv[c][i];
        }
    }
    float gm = NEG;
    for (int x0 = 0; x0 < splits; x0 += 32)
      gm = fmaxf(gm, warp_max(x0 + lane < splits ? __ldcg(ml + x0 + lane).x
                                                 : NEG));
    float gl = 0.f, ga[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) ga[i] = 0.f;
    for (int x0 = 0; x0 < splits; x0 += 32) {
      const float2 p =
          x0 + lane < splits ? __ldcg(ml + x0 + lane) : make_float2(NEG, 0.f);
      const float f = expf(p.x - gm);   // this lane's split's weight
      const int n = min(32, splits - x0);
      for (int j0 = 0; j0 < n; j0 += 8) {
        float pa[8][DPL];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            pa[j][i] = j0 + j < n
                           ? __ldcg(pacc + (long long)(x0 + j0 + j) * D +
                                    lane + 32 * i)
                           : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j0 + j >= n) break;
          const float fj = __shfl_sync(0xffffffffu, f, j0 + j);
          gl += __shfl_sync(0xffffffffu, p.y, j0 + j) * fj;
#pragma unroll
          for (int i = 0; i < DPL; ++i) ga[i] += pa[j][i] * fj;
        }
      }
    }
    // the current token's term, from the fp32 q, k, v
    float qk = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = h * D + lane + 32 * i;
      qd[i] += to_f(a.bqkv[d]);
      kd[i] += to_f(a.bqkv[hd + d]);
      vd[i] += to_f(a.bqkv[2 * hd + d]);
      qk = fmaf(qd[i], kd[i], qk);
    }
    const float s_self = warp_sum(qk) * a.scale;
    const float m2 = fmaxf(gm, s_self);
    const float alpha = expf(gm - m2);
    const float p_self = expf(s_self - m2);
    const float ls = fmaxf(alpha * gl + p_self, 1e-30f);
    const float p_r = round_to<T>(p_self);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      const float o = (ga[i] * alpha + p_r * vd[i]) / ls;
      a.attn[(long long)b * hd + h * D + d] = round_to<T>(o);
      const long long w = base + (long long)t * hd + d;
      a.kc[w] = from_f<T>(kd[i]);
      a.vc[w] = from_f<T>(vd[i]);
    }
  }

  // -- phase 3: out-proj, bias, residual -----------------------------------
  const int slices3 = hd / C, rows3 = GROUPS * a.l3, chunks3 = hd / rows3;
  const int units3 = slices3 * chunks3;
  if (blockIdx.x < units3)   // in flight through the grid sync
    load_unit(a.wo, hd, blockIdx.x / slices3 * rows3,
              blockIdx.x % slices3 * C, a.l3, wr);
  grid.sync();
  for (int u = blockIdx.x; u < units3; u += gridDim.x) {
    const int chunk = u / slices3, slice = u % slices3;
    const int k0 = chunk * rows3, c0 = slice * C;
    if (u != blockIdx.x) load_unit(a.wo, hd, k0, c0, a.l3, wr);
    // this unit's rows of the attention output, [row chunk][k][RB]
    for (int e = tid; e < nrows * rows3; e += THREADS) {
      const int row = e / rows3, k = e % rows3;
      xs[((row / RB) * rows3 + k) * RB + row % RB] =
          row < B ? __ldcg(a.attn + (long long)row * hd + k0 + k) : 0.f;
    }
    __syncthreads();
    float* part = a.part3 + (long long)chunk * B * hd;
    gemv_unit<T>(wr, a.l3, xs, rows3, 0, B, red, part, hd, c0);
    if (!last_of(a.tickets + bhs + slice, chunks3, &is_last)) continue;
    for (int e = tid; e < B * C; e += THREADS) {
      const int r = e / C, c = c0 + e % C;
      const float s = chunk_sum(a.part3, chunks3, B, hd, r, c);
      const long long i = (long long)r * hd + c;
      a.y[i] = from_f<T>(to_f(a.x[i]) + (s + to_f(a.bo[c])));
    }
    __syncthreads();   // is_last and xs are reused by the next unit
  }
}

// Co-resident blocks of one kernel at one dynamic shared-memory size, per
// device, queried once: a decode step launches the kernel once per layer.
constexpr int MAX_DEVICES = 64;

template <typename T, int D>
cudaError_t resident_blocks(int dev, size_t smem, int* blocks) {
  static int cached_smem[MAX_DEVICES];   // 0: not queried yet
  static int cached_blocks[MAX_DEVICES];
  if (dev < MAX_DEVICES && cached_smem[dev] == (int)smem + 1) {
    *blocks = cached_blocks[dev];
    return cudaSuccess;
  }
  auto kernel = fused_decode_layer_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < MAX_DEVICES) {
    cached_blocks[dev] = *blocks;
    cached_smem[dev] = (int)smem + 1;
  }
  return cudaSuccess;
}

size_t smem_bytes(int B, int hd) {
  return sizeof(float) * (size_t)((B + RB - 1) / RB) * RB * hd;
}

template <typename T, int D>
cudaError_t blocks_of(int B, int H, int* blocks) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return resident_blocks<T, D>(dev, smem_bytes(B, H * D), blocks);
}

template <typename T, int D>
cudaError_t launch(const Args<T>& args, int grid, cudaStream_t stream) {
  const int hd = args.H * D;
  int resident;
  cudaError_t err = blocks_of<T, D>(args.B, args.H, &resident);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > resident) return cudaErrorInvalidConfiguration;
  const int l1 = args.l1, l3 = args.l3;
  if (l1 < 1 || l1 > LMAX<T> || hd % (GROUPS * l1) || l3 < 1 ||
      l3 > LMAX<T> || hd % (GROUPS * l3) || hd % CW<T> || args.cap < 0)
    return cudaErrorInvalidValue;
  // cooperative: every block co-resident, for the grid syncs; launched
  // through cudaLaunchKernelEx, which a stream capture records as a
  // cooperative kernel node of a CUDA graph
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(args.B, hd);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_decode_layer_kernel<T, D>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The co-resident blocks of the kernel for B rows of H heads of D dims
// (the most a launch's grid may have); a negative CUDA error on failure,
// -1 (cudaErrorInvalidValue) for a head size the kernel does not take (64,
// 128 and 256 are taken).
extern "C" int fused_decode_layer_blocks(int B, int H, int D, int is_bf16) {
  int blocks = 0;
  cudaError_t err;
  if (D == 64 && is_bf16)
    err = blocks_of<__nv_bfloat16, 64>(B, H, &blocks);
  else if (D == 64)
    err = blocks_of<float, 64>(B, H, &blocks);
  else if (D == 128 && is_bf16)
    err = blocks_of<__nv_bfloat16, 128>(B, H, &blocks);
  else if (D == 128)
    err = blocks_of<float, 128>(B, H, &blocks);
  else if (D == 256 && is_bf16)
    err = blocks_of<__nv_bfloat16, 256>(B, H, &blocks);
  else if (D == 256)
    err = blocks_of<float, 256>(B, H, &blocks);
  else
    err = cudaErrorInvalidValue;
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// t is `t` plus, where `tpos` is not null, the int32 at `tpos` in device
// memory.  Returns the launch's CUDA error (cudaLaunchKernelEx, then
// cudaGetLastError()); 1 (cudaErrorInvalidValue) for a head size or type
// the kernel does not take, or loads a thread (l1, l3) that do not divide
// hd into chunks of 32 rows; 9 (cudaErrorInvalidConfiguration) for a grid
// larger than the co-resident blocks.
extern "C" int fused_decode_layer(
    const void* x, const void* lnw, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* kc, void* vc,
    const void* mask, void* part1, void* attn, void* part2, void* part3,
    void* tickets, void* y, const void* tpos, int B, int H, int D,
    int S_max, int t, int is_bf16, int l1, int l3, int cap, int grid,
    float eps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define FDL_LAUNCH(T, DIM)                                                   \
  err = launch<T, DIM>(                                                      \
      Args<T>{static_cast<const T*>(x),      static_cast<const T*>(lnw),     \
              static_cast<const T*>(lnb),    static_cast<const T*>(wqkv),    \
              static_cast<const T*>(bqkv),   static_cast<const T*>(wo),      \
              static_cast<const T*>(bo),     static_cast<T*>(kc),            \
              static_cast<T*>(vc),           static_cast<const float*>(mask), \
              static_cast<float*>(part1),    static_cast<float*>(attn),      \
              static_cast<float*>(part2),    static_cast<float*>(part3),     \
              static_cast<int*>(tickets),    static_cast<T*>(y),             \
              static_cast<const int*>(tpos), B, H, S_max, t, l1, l3, cap,    \
              eps, scale},                                                   \
      grid, s)
  if (D == 64 && is_bf16)
    FDL_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    FDL_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    FDL_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    FDL_LAUNCH(float, 128);
  else if (D == 256 && is_bf16)
    FDL_LAUNCH(__nv_bfloat16, 256);
  else if (D == 256)
    FDL_LAUNCH(float, 256);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FDL_LAUNCH
  return static_cast<int>(err);
}
