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
//     table with 16-byte loads (4 fp32, 8 bf16 or 16 int8 values a lane;
//     D / those lanes a key row, whole 64- to 512-byte rows per warp
//     load), 4 loads of K and of V a lane in flight, and an online
//     softmax in fp32.  p stays in fp32 (the plain version rounds the
//     normalised p, the kernel does not: the FWD_COEF limit).  One split
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
//     before it ends, so the stream's next work finds both done.  The
//     write kernels below are unchanged but for that one trigger.
//
// Layout: q, k_new, v_new are [B, C, H, D] with unit stride in D and stride
// D between heads (row and position strides are arguments); pools are
// contiguous, 16-byte aligned [num_blocks, block_size, H, D]; out is a
// contiguous [B, C, H, D] in the input type.
//
// int8 pools (`ragged_paged_attention_int8`): codes beside fp32 scales
// [num_blocks, H], value = code * scale -- the TPU kernel's `quant` branch
// (`ragged_paged_attention.py:189-245`, `:311-328`), for any C >= 1.
//  1. Write.  One block per (row, logical block the row's positions
//     pos0 .. pos0 + C - 1 touch): a chunk of C = 512 spans up to 33.
//     The block takes the per-head abs-max over ALL of the group's
//     in-pool rows first, grows each head's scale once (new = max(old,
//     amax * (1/127))), rescales the block's old codes once where it grew
//     (round(code * old / new)), then quantizes the new rows
//     (round(x / new)).  A row writes only blocks it owns, so no two
//     blocks touch one pool block; slots outside the pool are dropped and
//     left out of the amax.  Rounding is rintf (half to even, as
//     torch.round and jnp.round) and the division IEEE (no fast math), so
//     the codes and scales are bitwise those of the plain version.  The
//     group's pool block is that of its first in-pool slot; a slot of the
//     group outside that block (not a position's slot) is dropped.  At
//     decode the launch is one block per row and bound by load latency,
//     so the rescale reads 16 codes per load and each thread issues all
//     its loads before its stores.
//  2. Attend.  The fp kernel instantiated for int8 pools: 16 codes a
//     16-byte load (widened exactly by the float trick of `widen`) and the
//     scales folded in as the plain version folds them: k_scale times the
//     scaled logit, v_scale times each probability.  Bytes: 1 per code
//     plus 4 per (block, head) scale read -- a quarter of fp32's.
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 256;            // the int8 write
constexpr int WARPS = THREADS / 32;
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
  constexpr int LPK = D / VE<P>;        // lanes per key row
  __shared__ SplitSmem<A_WARPS, D> sh;
  __shared__ int tbl[TBL];
  const int split = blockIdx.x, max_splits = gridDim.x;
  const int h = blockIdx.y, rj = blockIdx.z, r = rj / C, jq = rj % C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = (lane % LPK) * VE<P>;
  const long long HD = (long long)H * D;
  const long long g = (long long)rj * H + h;       // the (row, query, head)
  T* op = out + g * D;
  const int* trow = table + (long long)r * maxb;
  // issued before the bound is known, none of them depending on it: the
  // row's length and position, q, and the table entries of this split's
  // keys if its chunk is chunk_keys (every split of a decode step, whose
  // grid covers the table's width)
  const int len_r = lens[r], pos_r = pos0[r];
  float qv[VE<P>];
  const T* qp = q + r * qsb + jq * qsc + h * D + d0;
#pragma unroll
  for (int i = 0; i < VE<P>; ++i) qv[i] = to_f(qp[i]);
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
  float m, l, acc[VE<P>];
  warp_attend<P, D, U, RUN>(keys, qv, lo + warp * RUN,
                            min(lo + chunk, bound), A_WARPS * RUN, m, l, acc);
  float bm, bl, ba;
  block_state<P, D, A_WARPS>(sh, m, l, acc, bm, bl, ba);
  if (splits == 1) {
    if (tid < D) op[tid] = from_f<T>(ba / fmaxf(bl, 1e-30f));
    if (first) wait_prior_grid();
    return;
  }
  const long long groups = (long long)gridDim.y * gridDim.z;
  float2* ml = reinterpret_cast<float2*>(part) + g * max_splits;
  float* pacc = part + 2 * groups * max_splits + g * max_splits * D;
  float gm, gl, ga;
  if (merge_splits<D, A_WARPS>(sh, ml, pacc, tickets + g, split, splits, bm,
                               bl, ba, gm, gl, ga) &&
      tid < D)
    op[tid] = from_f<T>(ga / fmaxf(gl, 1e-30f));
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

// One block per (logical block group i, row r); dynamic shared memory
// holds 6 * H floats: amax, factor and write scale for each of K and V.
template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_write_int8_kernel(
    const T* __restrict__ knew, const T* __restrict__ vnew,
    int8_t* __restrict__ kpool, int8_t* __restrict__ vpool,
    float* __restrict__ kscale, float* __restrict__ vscale,
    const int* __restrict__ pos0, const int* __restrict__ slots, int C,
    int H, int D, int bs, long long num_slots, long long ksb, long long ksc,
    long long vsb, long long vsc, float inv_qmax) {
  extern __shared__ float sh[];
  float* amax = sh;            // [2H]: K heads, then V heads
  float* fac = sh + 2 * H;     // old / new, or 1
  float* wsc = sh + 4 * H;     // new, or 1 where it is 0
  __shared__ long long phys_s;
  trigger_dependents();   // the attend may start (it waits before it
                          // reads the pools)
  const int i = blockIdx.x, r = blockIdx.y;
  const int p0 = max(pos0[r], 0);
  const int lb = p0 / bs + i;
  const int j0 = max(0, lb * bs - p0), j1 = min(C, (lb + 1) * bs - p0);
  if (j0 >= j1) return;
  const int* srow = slots + (long long)r * C;
  if (threadIdx.x == 0) {
    long long ph = -1;
    for (int j = j0; j < j1 && ph < 0; ++j) {
      const long long s = srow[j];
      if (s >= 0 && s < num_slots) ph = s / bs;
    }
    phys_s = ph;
  }
  __syncthreads();
  const long long phys = phys_s;
  if (phys < 0) return;
  const int HD = H * D, nj = j1 - j0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // per-head abs-max of the group's rows, one warp per (K or V, head)
  for (int t = warp; t < 2 * H; t += WARPS) {
    const int h = t % H;
    const T* src = t < H ? knew + r * ksb : vnew + r * vsb;
    const long long sc = t < H ? ksc : vsc;
    float m = 0.f;
#pragma unroll 4
    for (int e = lane; e < nj * D; e += 32) {
      const int j = j0 + e / D;
      const long long s = srow[j];
      if (s >= 0 && s < num_slots && s / bs == phys)
        m = fmaxf(m, fabsf(to_f(src[j * sc + h * D + e % D])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) amax[t] = m;
  }
  __syncthreads();
  // grow the scales: new = max(old, amax / 127), never smaller
  for (int t = threadIdx.x; t < 2 * H; t += THREADS) {
    float* sp = (t < H ? kscale : vscale) + phys * H + t % H;
    const float old = *sp;
    const float nw = fmaxf(old, amax[t] * inv_qmax);
    fac[t] = nw > 0.f ? old / nw : 1.f;
    wsc[t] = nw > 0.f ? nw : 1.f;
    *sp = nw;
  }
  __syncthreads();
  // rescale the block's old codes once where the head's scale grew: 16
  // codes per load (D % 16 == 0, so they share a head), a thread's RESC
  // loads issued before any of its stores
  constexpr int RESC = 8;
  const long long base = phys * bs * HD;
  const int nvec = 2 * bs * HD / 16;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += THREADS * RESC) {
    uint4 c[RESC];
    float f[RESC];
    uint4* ptr[RESC];
#pragma unroll
    for (int u = 0; u < RESC; ++u) {
      const int v = v0 + u * THREADS;
      f[u] = 1.f;
      if (v < nvec) {
        const int kv = v * 16 >= bs * HD;
        const int off = v * 16 - kv * bs * HD;
        f[u] = fac[kv * H + (off % HD) / D];
        ptr[u] = reinterpret_cast<uint4*>((kv ? vpool : kpool) + base + off);
        if (f[u] != 1.f) c[u] = *ptr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < RESC; ++u) {
      if (f[u] == 1.f) continue;
      c[u].x = rescale4(c[u].x, f[u]);
      c[u].y = rescale4(c[u].y, f[u]);
      c[u].z = rescale4(c[u].z, f[u]);
      c[u].w = rescale4(c[u].w, f[u]);
      *ptr[u] = c[u];
    }
  }
  __syncthreads();
  // quantize the new rows against the new scales
  for (int e = threadIdx.x; e < 2 * nj * HD; e += THREADS) {
    const int kv = e >= nj * HD;
    const int off = e - kv * nj * HD;
    const int j = j0 + off / HD, hd = off % HD;
    const long long s = srow[j];
    if (s < 0 || s >= num_slots || s / bs != phys) continue;
    const float x = kv ? to_f(vnew[r * vsb + j * vsc + hd])
                       : to_f(knew[r * ksb + j * ksc + hd]);
    (kv ? vpool : kpool)[s * HD + hd] = quantize(x / wsc[kv * H + hd / D]);
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
    ragged_write_int8_kernel<T><<<dim3(groups, B), THREADS,
                                  sizeof(float) * 6 * H, stream>>>(
        static_cast<const T*>(knew), static_cast<const T*>(vnew),
        static_cast<int8_t*>(kpool), static_cast<int8_t*>(vpool),
        static_cast<float*>(kscale), static_cast<float*>(vscale), pos0,
        slots, C, H, D, bs, (long long)nb * bs, ksb, ksc, vsb, vsc,
        inv_qmax);
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
// with max_splits 1).  Returns
// the first CUDA error (cudaGetLastError()); 1 (cudaErrorInvalidValue) for
// a head size or type the kernel does not take.
extern "C" int ragged_paged_attention(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, const void* table, const void* pos0, const void* lens,
    const void* slots, void* out, void* part, void* tickets, int B, int C,
    int H, int D, int nb, int bs, int maxb, int is_bf16, int max_splits,
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
  if (D == 64 && is_bf16)
    RPA_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    RPA_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    RPA_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    RPA_LAUNCH(float, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef RPA_LAUNCH
  return static_cast<int>(err);
}

// The int8-pool entry: the write launch, then the attend launch (parts as
// above).  Returns the first CUDA error; 1 (cudaErrorInvalidValue) for a
// head size or type the kernel does not take.
extern "C" int ragged_paged_attention_int8(
    const void* q, const void* knew, const void* vnew, void* kpool,
    void* vpool, void* kscale, void* vscale, const void* table,
    const void* pos0, const void* lens, const void* slots, void* out,
    void* part, void* tickets, int B, int C, int H, int D, int nb, int bs,
    int maxb, int is_bf16, int max_splits, int chunk_keys, int parts,
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
  if (D == 64 && is_bf16)
    RPA8_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    RPA8_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    RPA8_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    RPA8_LAUNCH(float, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef RPA8_LAUNCH
  return static_cast<int>(err);
}
