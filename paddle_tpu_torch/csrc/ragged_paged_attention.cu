// Fused cache write + ragged paged attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py `_ragged_fused_kernel`
// (reached via `_ragged_kernel_call` <- `ragged_paged_attention_arrays`):
// full-precision pools here, int8 pools in the second entry below.  Unlike
// the TPU kernel, which serves only C == 1, both also serve chunked-prefill
// continuations (C > 1).
//
// What bounds it on this card: memory.  A decode step reads every live
// row's K and V once (sum_r kv_len_r * H * D * 2 * itemsize bytes) and does
// 4 FLOPs per element read, far below the ridge point; the bound is those
// bytes over 3.35 TB/s.  At serving batch sizes one block per (row, head)
// gives 96 blocks, and the longest row's blocks set the step's time, so
// what limits a simple kernel is memory latency: how many independent
// loads are in flight, on how many SMs.
//
// What the design does about it:
//  1. Write.  A first launch, one block per (row, query position), copies
//     the new token's K and V rows into their pool slots; a slot outside
//     [0, num_blocks * block_size) is a padding entry and is dropped.
//  2. Attend, split-K.  A second launch on the same stream (so every
//     write is visible): one block of four warps per (split, head, row
//     and query).  Query j of row r attends keys 0 .. min(pos0[r] + j,
//     kv_lens[r] - 1), read through the row's block table, and no table
//     entry past that bound is dereferenced (padding rows carry kv_lens =
//     0 and sentinel table entries, and produce 0).  The keys go to splits
//     of whole chunks of 128 keys (8 pool blocks of 16; the wrapper's
//     CHUNK), each split one block: the grid has max_splits blocks per
//     (head, row, query), which
//     the wrapper takes from host-known shapes alone (how full B * C * H
//     blocks leave the grid, and the table's width: `ragged_splits`), and
//     each block derives its row's own split count from pos0 and kv_lens
//     on the device -- a row longer than max_splits chunks takes wider
//     chunks, blocks past its last split return at once -- so the launch
//     reads no device value on the host and can be captured.  Inside a
//     block the key loop of `decode_common.cuh` (shared with flash_decode
//     and the fused layer): each warp walks runs of 32 keys through the
//     table with 16-byte loads (4 fp32, 8 bf16 / fp16 or 16 int8 values a
//     lane;
//     D / those lanes a key row, whole 64- to 512-byte rows per warp
//     load; at D = 256 a 2-byte row takes the whole warp and an fp32 row
//     two loads a lane: `RowLanes`), 4 loads of K and of V a lane in
//     flight (two vectors each for an fp32 row of 256), and an online
//     softmax in fp32.  p stays in fp32 in every type (the plain version
//     rounds the normalised p to a bf16 pool's type, the kernel does not:
//     the FWD_COEF limit; fp16 pools are computed in fp32 with p unrounded,
//     as the TPU kernel's `fast` type is fp32 for any pool but bf16,
//     `ragged_paged_attention.py:174-175`).  One split
//     writes out; more write fp32 partials (m, l, acc[D]) that the last
//     block of the (row, query, head) merges in split order (a
//     self-resetting ticket).
//     A chunk of C = 188 or 512 queries fills the card with B * C * H
//     blocks already: max_splits is 1 there, and no scratch is read.
//     The attend is launched as the programmatic dependent of the write,
//     which lets it start at once: its blocks load pos0, kv_lens, q and
//     the split's table entries (into shared memory) before the bound is
//     known.  With fp pools it reads the call's own positions (pos0 ..
//     pos0 + C - 1) from k_new / v_new, the values the write stores, and
//     no pool slot the write touches, so it runs beside the write; with
//     int8 pools it waits for the write before reading (the write may
//     rescale a block's old codes).  The first block waits for the write
//     before it ends, so the stream's next work finds both done.
//
// Layout: q, k_new, v_new are [B, C, H, D] with unit stride in D and stride
// D between heads (row and position strides are arguments); pools are
// contiguous, 16-byte aligned [num_blocks, block_size, H, D]; out is a
// contiguous [B, C, H, D] in the input type.
//
// int8 pools (`ragged_paged_attention_int8`): codes beside fp32 scales
// [num_blocks, H], value = code * scale -- the TPU kernel's `quant` branch
// (`ragged_paged_attention.py:189-245`, `:311-328`), for any C >= 1 and q,
// k_new, v_new in fp32, bf16 or fp16 (read as fp32 for the quantization).
//  1. Write.  One warp per (row, logical block the row's positions
//     pos0 .. pos0 + C - 1 touch, K or V head): a chunk of C = 512 spans
//     up to 33 blocks, so 33 * 2H warps; the decode step 2H a row.  The
//     scale is per (pool block, head), so the heads are independent and
//     a warp needs no barrier: it takes its head's abs-max over ALL of
//     the group's in-pool rows, grows the scale once (new = max(old,
//     amax * (1/127))), rescales the head's old codes in the block once
//     where it grew (round(code * old / new)), then quantizes the new
//     rows (round(x / new)).  A row writes only blocks it owns, so no two
//     warps touch one (block, head); slots outside the pool are dropped
//     and left out of the amax.  Rounding is rintf (half to even, as
//     torch.round and jnp.round) and the division IEEE (no fast math), so
//     the codes and scales are bitwise those of the plain version.  The
//     group's pool block is that of its first in-pool slot; a slot of the
//     group outside that block (not a position's slot) is dropped.  At
//     decode the write is a chain of round trips (slots; rows, scale and
//     old codes together; stores), so the lanes hold the group's slots,
//     the old codes are loaded before the scale is known, and rows and
//     codes move 16 bytes a lane.
//  2. Attend.  The fp kernel instantiated for int8 pools: 16 codes a
//     16-byte load (widened exactly by the float trick of `widen`) and the
//     scales folded in as the plain version folds them: k_scale times the
//     scaled logit, v_scale times each probability.  Bytes: 1 per code
//     plus 4 per (block, head) scale read -- a quarter of fp32's.
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int W_WARPS = 4;              // the int8 write: a warp a head
constexpr int A_THREADS = 128;          // the attend: four warps
constexpr int A_WARPS = A_THREADS / 32;
constexpr int RUN = 32;                 // keys per warp run
constexpr int TBL = 2 * A_THREADS;      // table entries loaded ahead
// loads of K (and V) a lane keeps in flight (8 measured no faster on an
// H100 and took the bf16 kernel from 71 to 147 registers, too many for
// the decode step's 768 blocks to be resident at once; PERF.md)
constexpr int U = 4;

template <typename T>
__global__ void ragged_write_kernel(const T* __restrict__ knew,
                                    const T* __restrict__ vnew,
                                    T* __restrict__ kpool,
                                    T* __restrict__ vpool,
                                    const int* __restrict__ slots, int C,
                                    int HD, long long num_slots,
                                    long long ksb, long long ksc,
                                    long long vsb, long long vsc) {
  trigger_dependents();   // the attend may start (it reads no slot this
                          // launch writes)
  const int r = blockIdx.x / C, j = blockIdx.x % C;
  const long long slot = slots[blockIdx.x];
  if (slot < 0 || slot >= num_slots) return;
  const T* ks = knew + r * ksb + j * ksc;
  const T* vs = vnew + r * vsb + j * vsc;
  for (int e = threadIdx.x; e < HD; e += blockDim.x) {
    kpool[slot * HD + e] = ks[e];
    vpool[slot * HD + e] = vs[e];
  }
}

// The keys of one (row, head) through the row's block table: key k is
// slot k % bs of pool block table[k / bs] (clamped into the pool, as the
// TPU kernel's index map).  P is the pools' element type: T, whose p stays
// in fp32 (no rounding before the value product), or int8_t codes whose
// per-(block, head) fp32 scales fold in as the plain version folds them --
// k_scale times the scaled logit, v_scale times each probability.
template <typename P>
struct PagedKeys {
  static constexpr bool QUANT = sizeof(P) == 1;
  const P* kp;          // the K pool at head h, this lane's d0
  const P* vp;
  const P* kn;          // fp pools: k_new, v_new of the row at head h and
  const P* vn;          // d0, taken for keys pos .. (the call's own
  long long ksc, vsc;   // positions, which the write stores) at these
  int pos;              // position strides; int8 pools: pos past the keys
  const int* trow;      // the row's block table
  const int* tbl;       // its entries first_e .. first_e + n_pre - 1, or
  int first_e, n_pre;   // n_pre 0 (shared memory, loaded ahead)
  const float* ks;      // the scales at head h (stride H a block), or null
  const float* vs;
  int bs, nb, H;
  long long HD;
  float scale;
  struct Row {
    long long off;
    int blk;
  };
  __device__ __forceinline__ Row locate(int key) const {
    if (!QUANT && key >= pos) return {key - pos, -1};
    const int e = key / bs;
    const int raw = static_cast<unsigned>(e - first_e) <
                            static_cast<unsigned>(n_pre)
                        ? tbl[e - first_e]
                        : trow[e];
    const int blk = min(max(raw, 0), nb - 1);
    return {((long long)blk * bs + key % bs) * HD, blk};
  }
  // blk -1: off is the position's index j among the call's new rows
  __device__ __forceinline__ const P* k(Row r) const {
    return r.blk < 0 ? kn + r.off * ksc : kp + r.off;
  }
  __device__ __forceinline__ const P* v(Row r) const {
    return r.blk < 0 ? vn + r.off * vsc : vp + r.off;
  }
  __device__ __forceinline__ float logit(float dot, Row r) const {
    if constexpr (QUANT)
      return dot * scale * ks[(long long)r.blk * H];
    else
      return dot * scale;
  }
  __device__ __forceinline__ float weight(float p, Row r) const {
    if constexpr (QUANT)
      return p * vs[(long long)r.blk * H];
    else
      return p;
  }
};

// One block of four warps per (split, head, row and query).  Query j of
// row r attends keys [0, bound), bound = min(pos0[r] + j + 1, kv_len);
// the row's keys go to splits of `chunk` keys (whole chunks of chunk_keys,
// so that at most max_splits = gridDim.x splits cover the bound), from
// pos0 and kv_lens on the device: blocks past the row's last split do
// nothing, and a bound of 0 (padding rows) writes zeros.  One split
// writes out directly; more merge through part and the tickets.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(A_THREADS) ragged_attend_kernel(
    const T* __restrict__ q, const T* __restrict__ knew,
    const T* __restrict__ vnew, const P* __restrict__ kpool,
    const P* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ pos0, const int* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
    int C, int H, int nb, int bs, int maxb, int chunk_keys, long long qsb,
    long long qsc, long long ksb, long long ksc, long long vsb,
    long long vsc, float scale) {
  using L = RowLanes<P, D>;             // lanes and loads of a key row
  __shared__ SplitSmem<A_WARPS, D> sh;
  __shared__ int tbl[TBL];
  const int split = blockIdx.x, max_splits = gridDim.x;
  const int h = blockIdx.y, rj = blockIdx.z, r = rj / C, jq = rj % C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = (lane % L::LPK) * VE<P>;
  const long long HD = (long long)H * D;
  const long long g = (long long)rj * H + h;       // the (row, query, head)
  T* op = out + g * D;
  const int* trow = table + (long long)r * maxb;
  // issued before the bound is known, none of them depending on it: the
  // row's length and position, q, and the table entries of this split's
  // keys if its chunk is chunk_keys (every split of a decode step, whose
  // grid covers the table's width)
  const int len_r = lens[r], pos_r = pos0[r];
  float qv[L::PER];
  const T* qp = q + r * qsb + jq * qsc + h * D + d0;
#pragma unroll
  for (int j = 0; j < L::NV; ++j)
#pragma unroll
    for (int i = 0; i < VE<P>; ++i)
      qv[j * VE<P> + i] = to_f(qp[j * L::STEP + i]);
  const int first_e = split * chunk_keys / bs;
  const int n_e = min((split * chunk_keys + chunk_keys - 1) / bs, maxb - 1) -
                  first_e + 1;
  const bool ahead = n_e <= TBL;
  for (int e = tid; ahead && e < n_e; e += A_THREADS)
    tbl[e] = trow[first_e + e];
  // never read past the row's written keys nor past its table
  const int kv_len = min(max(len_r, 0), maxb * bs);
  const int bound = max(0, min(pos_r + jq + 1, kv_len));
  const int per = (bound + max_splits - 1) / max_splits;
  const int chunk =
      max(chunk_keys, (per + chunk_keys - 1) / chunk_keys * chunk_keys);
  const int splits = (bound + chunk - 1) / chunk;
  // the first block waits for the write launch before it ends, so that
  // what follows on the stream finds both launches done; with int8 pools
  // every block that reads waits first (the write may rescale a block's
  // old codes)
  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  if (bound == 0 || split >= splits) {
    if (bound == 0 && split == 0)
      for (int d = tid; d < D; d += A_THREADS) op[d] = from_f<T>(0.f);
    if (first) wait_prior_grid();
    return;
  }
  __syncthreads();                      // tbl
  if (PagedKeys<P>::QUANT) wait_prior_grid();
  const PagedKeys<P> keys{kpool + h * D + d0,
                          vpool + h * D + d0,
                          reinterpret_cast<const P*>(knew) + r * ksb + h * D +
                              d0,
                          reinterpret_cast<const P*>(vnew) + r * vsb + h * D +
                              d0,
                          ksc,
                          vsc,
                          PagedKeys<P>::QUANT ? bound : pos_r,
                          trow,
                          tbl,
                          first_e,
                          ahead && chunk == chunk_keys ? n_e : 0,
                          kscale ? kscale + h : nullptr,
                          vscale ? vscale + h : nullptr,
                          bs, nb, H, HD, scale};
  const int lo = split * chunk;
  float m, l, acc[L::PER];
  warp_attend<P, D, U, RUN>(keys, qv, lo + warp * RUN,
                            min(lo + chunk, bound), A_WARPS * RUN, m, l, acc);
  float bm, bl, ba[block_dims<D, A_WARPS>];
  block_state<P, D, A_WARPS>(sh, m, l, acc, bm, bl, ba);
  if (splits == 1) {
    store_dims<T, D, A_WARPS>(op, ba, bl);
    if (first) wait_prior_grid();
    return;
  }
  const long long groups = (long long)gridDim.y * gridDim.z;
  float2* ml = reinterpret_cast<float2*>(part) + g * max_splits;
  float* pacc = part + 2 * groups * max_splits + g * max_splits * D;
  float gm, gl, ga[block_dims<D, A_WARPS>];
  if (merge_splits<D, A_WARPS>(sh, ml, pacc, tickets + g, split, splits, bm,
                               bl, ba, gm, gl, ga))
    store_dims<T, D, A_WARPS>(op, ga, gl);
  if (first) wait_prior_grid();
}

// The attend launch, on the stream after the write launch.
template <typename T, typename P, int D>
cudaError_t attend(const void* q, const void* knew, const void* vnew,
                   const void* kpool, const void* vpool, const float* kscale,
                   const float* vscale, const int* table, const int* pos0,
                   const int* lens, void* out, float* part, int* tickets,
                   int B, int C, int H, int nb, int bs, int maxb,
                   int max_splits, int chunk_keys, long long qsb,
                   long long qsc, long long ksb, long long ksc,
                   long long vsb, long long vsc, float scale,
                   cudaStream_t stream) {
  // a programmatic dependent of the write launch: its blocks start while
  // the write runs and wait for it only before reading the pools
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(max_splits, H, B * C);
  cfg.blockDim = dim3(A_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ragged_attend_kernel<T, P, D>, static_cast<const T*>(q),
      static_cast<const T*>(knew), static_cast<const T*>(vnew),
      static_cast<const P*>(kpool), static_cast<const P*>(vpool), kscale,
      vscale, table, pos0, lens, static_cast<T*>(out), part, tickets, C, H,
      nb, bs, maxb, chunk_keys, qsb, qsc, ksb, ksc, vsb, vsc, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// -- int8 pools ---------------------------------------------------------

constexpr float QMAX = 127.f;

__device__ __forceinline__ int8_t quantize(float x) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -QMAX), QMAX));
}

// round(code * f) of the four codes packed in w
__device__ __forceinline__ unsigned rescale4(unsigned w, float f) {
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = static_cast<signed char>((w >> (8 * k)) & 0xffu);
    r |= static_cast<unsigned>(static_cast<unsigned char>(quantize(x * f)))
         << (8 * k);
  }
  return r;
}

// round(code * f) of the sixteen codes packed in c
__device__ __forceinline__ uint4 rescale16(uint4 c, float f) {
  return make_uint4(rescale4(c.x, f), rescale4(c.y, f), rescale4(c.z, f),
                    rescale4(c.w, f));
}

// One warp per (logical block group i = blockIdx.x, row r = blockIdx.y,
// K or V head u = blockIdx.z * W_WARPS + warp): the group's rows
// j0 .. j1 - 1 of the call are positions of one logical block.  No
// barrier: nothing is shared between the warps of a block.
//  - the slots: lane j holds the slot of row j0 + j (32 rows a window),
//    the group's pool block `base` / bs is that of its first in-pool slot
//    (a ballot), and a row is kept where its slot lies in that block;
//  - the old codes of the head in that block (bs * D codes at stride
//    H * D) are loaded at once, before it is known whether they change;
//  - amax: lane l reads 16 values of a kept row (16-byte loads; D / 16
//    lanes a row, 32 / (D / 16) rows a pass), the warp takes the max;
//  - the scale: new = max(old, amax * inv_qmax), never smaller, stored
//    by lane 0; where it grew the old codes become round(code * old /
//    new), 16 a store;
//  - quantize: round(x / new) of the kept rows, 16 codes a store.
template <typename T, int D>
__global__ void __launch_bounds__(32 * W_WARPS) ragged_write_int8_kernel(
    const T* __restrict__ knew, const T* __restrict__ vnew,
    int8_t* __restrict__ kpool, int8_t* __restrict__ vpool,
    float* __restrict__ kscale, float* __restrict__ vscale,
    const int* __restrict__ pos0, const int* __restrict__ slots, int C,
    int H, int bs, long long num_slots, long long ksb, long long ksc,
    long long vsb, long long vsc, float inv_qmax) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int LPR = D / 16;       // lanes of a row: 16 values each
  constexpr int RPP = 32 / LPR;     // rows a pass
  constexpr int RW = 4;             // old-code words (16 codes) a lane
                                    // loads at once
  trigger_dependents();   // the attend may start (it waits before it
                          // reads the pools)
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.z * W_WARPS + threadIdx.x / 32;
  if (u >= 2 * H) return;
  const int i = blockIdx.x, r = blockIdx.y;
  const int p0 = max(pos0[r], 0);
  const int lb = p0 / bs + i;
  const int j0 = max(0, lb * bs - p0), j1 = min(C, (lb + 1) * bs - p0);
  if (j0 >= j1) return;
  const int nj = j1 - j0;
  const int* srow = slots + (long long)r * C + j0;
  // the slot of row w0 + lane of the group (window w0), or -1
  auto slot_at = [&](int w0) -> long long {
    return w0 + lane < nj ? srow[w0 + lane] : -1;
  };
  const long long s0 = slot_at(0);
  long long first = -1;
  for (int w0 = 0; w0 < nj && first < 0; w0 += 32) {
    const long long sl = w0 ? slot_at(w0) : s0;
    const unsigned in = __ballot_sync(FULL, sl >= 0 && sl < num_slots);
    if (in) first = __shfl_sync(FULL, sl, __ffs(in) - 1);
  }
  if (first < 0) return;
  const long long base = first / bs * bs;   // the block's first slot
  const bool kv = u >= H;
  const int h = kv ? u - H : u;
  const long long HD = (long long)H * D;
  const T* src = (kv ? vnew + r * vsb : knew + r * ksb) + h * D;
  const long long sc = kv ? vsc : ksc;
  int8_t* pool = (kv ? vpool : kpool) + base * HD + h * D;
  float* sp = (kv ? vscale : kscale) + base / bs * H + h;
  const float old = *sp;
  // the head's old codes in the block, word w = (row w / LPR, 16 codes
  // at (w % LPR) * 16)
  const int nw = bs * LPR;
  uint4 c[RW];
  auto word = [&](int w) {
    return reinterpret_cast<uint4*>(pool + (w / LPR) * HD + (w % LPR) * 16);
  };
#pragma unroll
  for (int t = 0; t < RW; ++t)
    if (lane + 32 * t < nw) c[t] = *word(lane + 32 * t);

  const int jr = lane / LPR, e0 = (lane % LPR) * 16;
  // rows of window w0 whose slot lies in the block, a bit each
  auto kept = [&](int w0) {
    const long long sl = w0 ? slot_at(w0) : s0;
    return __ballot_sync(FULL, sl >= base && sl < base + bs);
  };
  float m = 0.f;
  for (int w0 = 0; w0 < nj; w0 += 32) {
    const unsigned keep = kept(w0);
#pragma unroll 2
    for (int jj = jr; jj < 32; jj += RPP) {
      if (!(keep >> jj & 1)) continue;
      float v[16];
      load_vals<T, 16>(src + (j0 + w0 + jj) * sc + e0, v);
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  }
  m = warp_max(m);
  const float nw_scale = fmaxf(old, m * inv_qmax);
  const float fac = nw_scale > 0.f ? old / nw_scale : 1.f;
  const float wsc = nw_scale > 0.f ? nw_scale : 1.f;
  if (lane == 0) *sp = nw_scale;
  if (fac != 1.f) {
    for (int w0 = 0; w0 < nw; w0 += 32 * RW) {
#pragma unroll
      for (int t = 0; t < RW; ++t)
        if (w0 && w0 + lane + 32 * t < nw) c[t] = *word(w0 + lane + 32 * t);
#pragma unroll
      for (int t = 0; t < RW; ++t)
        if (w0 + lane + 32 * t < nw)
          *word(w0 + lane + 32 * t) = rescale16(c[t], fac);
    }
  }
  __syncwarp();   // the rescaled codes before the new rows' codes
  for (int w0 = 0; w0 < nj; w0 += 32) {
    const long long sl = w0 ? slot_at(w0) : s0;
    const unsigned keep = kept(w0);
#pragma unroll 2
    for (int jj = jr; jj < 32; jj += RPP) {
      const long long sj = __shfl_sync(FULL, sl, jj);
      if (!(keep >> jj & 1)) continue;
      float v[16];
      load_vals<T, 16>(src + (j0 + w0 + jj) * sc + e0, v);
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        q[k] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          q[k] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      quantize(v[4 * k + b] / wsc)))
                  << (8 * b);
      }
      *reinterpret_cast<uint4*>(pool + (sj - base) * HD + e0) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

// parts: 1 the write launch, 2 the attend launch, 3 both (the write first).
template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* knew, const void* vnew,
                        void* kpool, void* vpool, void* kscale, void* vscale,
                        const int* table, const int* pos0, const int* lens,
                        const int* slots, void* out, float* part,
                        int* tickets, int B, int C, int H, int nb, int bs,
                        int maxb, int max_splits, int chunk_keys, int parts,
                        long long qsb,
                        long long qsc, long long ksb, long long ksc,
                        long long vsb, long long vsc, float scale,
                        float inv_qmax, cudaStream_t stream) {
  if (parts & 1) {
    const int groups = (C + bs - 2) / bs + 1;   // logical blocks C can span
    const dim3 grid(groups, B, (2 * H + W_WARPS - 1) / W_WARPS);
    ragged_write_int8_kernel<T, D><<<grid, 32 * W_WARPS, 0, stream>>>(
        static_cast<const T*>(knew), static_cast<const T*>(vnew),
        static_cast<int8_t*>(kpool), static_cast<int8_t*>(vpool),
        static_cast<float*>(kscale), static_cast<float*>(vscale), pos0,
        slots, C, H, bs, (long long)nb * bs, ksb, ksc, vsb, vsc, inv_qmax);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !(parts & 2)) return err;
  }
  return attend<T, int8_t, D>(q, knew, vnew, kpool, vpool,
                              static_cast<const float*>(kscale),
                              static_cast<const float*>(vscale), table, pos0,
                              lens, out, part, tickets, B, C, H, nb, bs, maxb,
                              max_splits, chunk_keys, qsb, qsc, ksb, ksc, vsb,
                              vsc, scale, stream);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* knew, const void* vnew,
                   void* kpool, void* vpool, const int* table,
                   const int* pos0, const int* lens, const int* slots,
                   void* out, float* part, int* tickets, int B, int C, int H,
                   int nb, int bs, int maxb, int max_splits, int chunk_keys,
                   int parts, long long qsb, long long qsc, long long ksb,
                   long long ksc, long long vsb, long long vsc, float scale,
                   cudaStream_t stream) {
  if (parts & 1) {
    ragged_write_kernel<T><<<B * C, 128, 0, stream>>>(
        static_cast<const T*>(knew), static_cast<const T*>(vnew),
        static_cast<T*>(kpool), static_cast<T*>(vpool), slots, C, H * D,
        (long long)nb * bs, ksb, ksc, vsb, vsc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !(parts & 2)) return err;
  }
  return attend<T, T, D>(q, knew, vnew, kpool, vpool, nullptr, nullptr,
                         table, pos0, lens, out, part, tickets, B, C, H, nb,
                         bs, maxb, max_splits, chunk_keys, qsb, qsc, ksb, ksc,
                         vsb, vsc, scale, stream);
}

}  // namespace

// The fp-pool entry: the write launch, then the attend launch (parts 3;
// 1 or 2 launch one of them, to time them apart).  max_splits: the grid's
// blocks per (row, query, head); chunk_keys: keys per split at the least
// (128).  part: fp32 scratch of B * C * H * max_splits * (D + 2) floats,
// tickets B * C * H ints, zero before and after every launch (both unread
// with max_splits 1).  dtype: the element type's code of q, k_new, v_new,
// the pools and out (0 fp32, 1 bf16, 2 fp16).  Returns the first CUDA
// error (cudaGetLastError()); 1 (cudaErrorInvalidValue) for a head size
// (64, 128 and 256 are taken) or type code the kernel does not take.
extern "C" int ragged_paged_attention(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, const void* table, const void* pos0, const void* lens,
    const void* slots, void* out, void* part, void* tickets, int B, int C,
    int H, int D, int nb, int bs, int maxb, int dtype, int max_splits,
    int chunk_keys, int parts, long long qsb, long long qsc, long long ksb,
    long long ksc, long long vsb, long long vsc, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos0);
  const int* n = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(slots);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (max_splits < 1 || chunk_keys < 1 || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
#define RPA_LAUNCH(T, DIM)                                                   \
  err = launch<T, DIM>(q, knew, vnew, kpool, vpool, t, p, n, sl, out, pt,    \
                       tk, B, C, H, nb, bs, maxb, max_splits, chunk_keys,    \
                       parts, qsb, qsc, ksb, ksc, vsb, vsc, scale, s)
  if (D != 64 && D != 128 && D != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 3 + (D == 128) + 2 * (D == 256)) {
    case 0: RPA_LAUNCH(float, 64); break;
    case 1: RPA_LAUNCH(float, 128); break;
    case 2: RPA_LAUNCH(float, 256); break;
    case 3: RPA_LAUNCH(__nv_bfloat16, 64); break;
    case 4: RPA_LAUNCH(__nv_bfloat16, 128); break;
    case 5: RPA_LAUNCH(__nv_bfloat16, 256); break;
    case 6: RPA_LAUNCH(__half, 64); break;
    case 7: RPA_LAUNCH(__half, 128); break;
    case 8: RPA_LAUNCH(__half, 256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA_LAUNCH
  return static_cast<int>(err);
}

// The int8-pool entry: the write launch, then the attend launch (parts as
// above).  dtype: the code of q, k_new, v_new and out (0 fp32, 1 bf16, 2
// fp16; the pools are int8).  Returns the first CUDA error; 1
// (cudaErrorInvalidValue) for a head size (64, 128 and 256 are taken) or
// type code the kernel does not take.
extern "C" int ragged_paged_attention_int8(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, void* kscale, void* vscale, const void* table,
    const void* pos0, const void* lens, const void* slots, void* out,
    void* part, void* tickets, int B, int C, int H, int D, int nb, int bs,
    int maxb, int dtype, int max_splits, int chunk_keys, int parts,
    long long qsb, long long qsc, long long ksb, long long ksc,
    long long vsb, long long vsc, float scale, float inv_qmax,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos0);
  const int* n = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(slots);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (max_splits < 1 || chunk_keys < 1 || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
#define RPA8_LAUNCH(T, DIM)                                                  \
  err = launch_int8<T, DIM>(q, knew, vnew, kpool, vpool, kscale, vscale, t,  \
                            p, n, sl, out, pt, tk, B, C, H, nb, bs, maxb,    \
                            max_splits, chunk_keys, parts, qsb, qsc, ksb,    \
                            ksc, vsb, vsc, scale, inv_qmax, s)
  if (D != 64 && D != 128 && D != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 3 + (D == 128) + 2 * (D == 256)) {
    case 0: RPA8_LAUNCH(float, 64); break;
    case 1: RPA8_LAUNCH(float, 128); break;
    case 2: RPA8_LAUNCH(float, 256); break;
    case 3: RPA8_LAUNCH(__nv_bfloat16, 64); break;
    case 4: RPA8_LAUNCH(__nv_bfloat16, 128); break;
    case 5: RPA8_LAUNCH(__nv_bfloat16, 256); break;
    case 6: RPA8_LAUNCH(__half, 64); break;
    case 7: RPA8_LAUNCH(__half, 128); break;
    case 8: RPA8_LAUNCH(__half, 256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RPA8_LAUNCH
  return static_cast<int>(err);
}
