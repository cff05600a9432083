// Row LayerNorm backward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ln_bwd_kernel` (reached via
// `_ln_vjp_bwd` <- the custom VJP of `fused_layernorm_2d`): from x, w, the
// forward's fp32 mean and reciprocal standard deviation of each row and dy,
//
//   x^ = (x - mu) rstd,  g = dy w,
//   dx = rstd (g - mean(g) - x^ mean(g x^)),
//   dw = sum over rows of dy x^,  db = sum over rows of dy.
//
// What bounds it on this card: memory (read x and dy once, write dx once; a
// few FLOPs per element).  The column sums are a reduction across rows, so
// across blocks, which the TPU kernel's sequential grid made trivial.
//
// What the design does about it (`ln_bwd_kernel`, rows of up to 16 warps'
// columns: 8192 with x in bf16, 6144 in fp32; the launch is planned in
// Python, `ops/fused_mlp.py` `ln_bwd_plan`):
// - One launch.  Each block writes one fp32 partial row of dw and db; the
//   last block of each group of K blocks to finish (a self-resetting
//   ticket, `last_of`) adds its group's partials in block order, and the
//   last of those group sums to finish adds them in group order and writes
//   dw and db, 16 bytes a load and 16 loads of a thread in flight.  No
//   float atomics: the grid depends only on n, H and x's type, and every
//   sum runs in a fixed order, so a result is the same in every run.
// - S warps share a row (S from H: a lane holds 8 columns with x in bf16,
//   16 where 16 warps of 8 do not cover the row, and 12 in fp32; NC_MAX
//   bounds it), each a segment of `seg` chunks of 16 bytes of x (8 bf16
//   or 4 fp32 values), lane l the chunks l, l + 32, ... of it; the S
//   warps add their two row sums through shared memory (a named barrier
//   of the group's warps a step).  A block holds G = 16 / S such groups,
//   one block an SM.
// - Each row is read once from DRAM: a lane copies its chunks of x and dy
//   with 16-byte `cp.async` into its slots of a shared-memory ring of
//   NBUF rows, two rows in flight while one is computed (in flight
//   without holding registers: 30 to 96 KB an SM), then reads them into
//   registers (dy in fp32 beside x in bf16 is copied as one contiguous
//   run a warp and read back by the lane that owns each chunk).
// - A lane keeps w and the dw and db partials of its columns in registers
//   for every row it takes; at the end each group writes its partials to
//   shared memory (the ring's space) and the block adds the groups in
//   order, one barrier.
// - Group `gid` of the T = grid * G groups takes rows gid, gid + T, ...
// - A row whose start is not on 16 bytes (x's row not a multiple of 16
//   bytes, or an offset base) reads its first elements up to the next
//   16-byte boundary, and its last past the last whole chunk, as scalars
//   (a head and a tail).  T is a multiple of the period P of the rows'
//   alignment (16 / gcd(H * sizeof(x), 16)), so every row a group takes
//   starts at the same offset and a lane's columns stay fixed.  Chunks of
//   dy, dx and w that are not on 16 bytes are read and written as scalars.
// Wider rows take `ln_bwd_wide_kernel`: one warp a row, the row read
// twice (the second pass from L1), the partial sums in shared memory, and
// the same merge.
//
// Types: x float or bf16; w float or bf16; dy in promote(x, w, b) (bf16 only
// when x and w are); dx in x's type, dw and db in w's (the forward kernel
// takes w and b of one type).
// Layout: x, dy, dx contiguous [n, H]; w, dw, db [H]; mu, rstd contiguous
// fp32 [n, 1]; part fp32 scratch of grid + ceil(grid / K) rows of L =
// 2H rounded up to 4 floats (dw's H, then db's), from a 16-byte boundary;
// tickets ceil(grid / K) + 1 ints, zero before and after every launch.
#include <stdint.h>

#include "decode_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace decode;
using flash_tc::cp_async16;
using flash_tc::cp_async_commit;
using flash_tc::cp_async_wait;
using flash_tc::smem_addr;

constexpr int MAX_THREADS = 512;   // 16 warps: at most 128 registers each
constexpr int NBUF = 3;            // rows of a group's shared-memory ring
// chunks of 16 bytes of x a lane holds at most: 16 bf16 or 12 fp32
// columns, so that w, the dw and db partials and a step's rows fit in 128
// registers
template <typename TX>
constexpr int NC_MAX = sizeof(TX) == 2 ? 2 : 3;

// V consecutive elements of T kept as they are in memory (V * sizeof(T)
// bytes), loaded with 16-byte loads where p is on 16 bytes.
template <typename T, int V>
struct Raw {
  static constexpr int Q = V * sizeof(T) / 16;
  uint4 q[Q];
  __device__ __forceinline__ void load(const T* p) {
    if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
#pragma unroll
      for (int i = 0; i < Q; ++i)
        q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
      return;
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(T) == 4) {
          w[k] = __float_as_uint(to_f(p[4 * i + k]));
        } else {
          const T* e = p + 8 * i + 2 * k;
          w[k] = (__float_as_uint(to_f(e[0])) >> 16) |
                 (__float_as_uint(to_f(e[1])) & 0xffff0000u);
        }
      }
      q[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // element j as a float
  __device__ __forceinline__ float operator[](int j) const {
    constexpr int PER = 16 / sizeof(T);
    const uint4 r = q[j / PER];
    const int k = j % PER;
    if constexpr (sizeof(T) == 4) {
      const uint32_t w = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
      return __uint_as_float(w);
    } else {
      const uint32_t w = k / 2 == 0   ? r.x
                         : k / 2 == 1 ? r.y
                         : k / 2 == 2 ? r.z
                                      : r.w;
      return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
    }
  }
};

// dw[i] (i < H) or db[i - H] of the merged sums
template <typename TP>
__device__ __forceinline__ void put(TP* dw, TP* db, int H, int i, float v) {
  if (i < H)
    dw[i] = from_f<TP>(v);
  else
    db[i - H] = from_f<TP>(v);
}

// dw and db at i .. i + 3 of the merged row (i < L)
template <typename TP>
__device__ __forceinline__ void put4(TP* dw, TP* db, int H, int i,
                                     float4 v) {
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < 2 * H) put(dw, db, H, i + k, e[k]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The S warps of group g meet (named barrier 1 + g; the block's other
// groups go on)
__device__ __forceinline__ void group_sync(int g, int S) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(32 * S) : "memory");
}

// 4 bytes from global to shared memory; zero when !valid (src must still
// be a mapped address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// After this block's partial row (L floats at part + blockIdx.x * L): the
// last block of each group of K blocks adds the group's rows in block
// order; with one group it writes dw and db, else the group's row, and the
// last group to finish adds those in group order and writes dw and db.
// Every thread calls; `flag` is shared memory.
template <typename TP>
__device__ void merge_partials(float* part, int* tickets, TP* dw, TP* db,
                               int H, int L, int K, int* flag) {
  const int grid = gridDim.x, L4 = L / 4;
  const int nq = (grid + K - 1) / K, q = blockIdx.x / K;
  const int b0 = q * K, b1 = min(b0 + K, grid);
  if (!last_of(tickets + q, b1 - b0, flag)) return;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4* q4 = reinterpret_cast<float4*>(part) + (size_t)grid * L4;
  for (int i = threadIdx.x; i < L4; i += blockDim.x) {
    float4 s = __ldcg(p4 + (size_t)b0 * L4 + i);
#pragma unroll 16
    for (int b = b0 + 1; b < b1; ++b)
      s = add4(s, __ldcg(p4 + (size_t)b * L4 + i));
    if (nq == 1)
      put4(dw, db, H, 4 * i, s);
    else
      q4[(size_t)q * L4 + i] = s;
  }
  if (nq == 1 || !last_of(tickets + nq, nq, flag)) return;
  for (int i = threadIdx.x; i < L4; i += blockDim.x) {
    float4 s = __ldcg(q4 + i);
#pragma unroll 16
    for (int k = 1; k < nq; ++k) s = add4(s, __ldcg(q4 + (size_t)k * L4 + i));
    put4(dw, db, H, 4 * i, s);
  }
}

// S warps a row, G = blockDim.x / (32 S) rows a block at a time; a lane
// holds at most NC chunks of V = 16 / sizeof(TX) columns.  Dynamic shared
// memory: the ring, NBUF stages of W 16-byte words a thread ([stage][word]
// [thread], so a warp's accesses are consecutive), then the groups'
// partial rows [G][L] in the same space.
template <typename TX, typename TP, typename TD, int NC>
__global__ void __launch_bounds__(MAX_THREADS, 1) ln_bwd_kernel(
    const TX* __restrict__ x, const TP* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const TD* __restrict__ dy, TX* __restrict__ dx, TP* __restrict__ dw,
    TP* __restrict__ db, float* __restrict__ part, int* __restrict__ tickets,
    int n, int H, int S, int seg, int K) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int DQ = V * sizeof(TD) / 16;   // 16-byte words of dy a chunk
  constexpr int W = NC * (1 + DQ);           // words a lane stages a row
  extern __shared__ __align__(16) uint4 ring[];
  __shared__ float2 stats[NBUF][MAX_THREADS / 32];   // (mu, rstd) a warp
  __shared__ float2 red[2][MAX_THREADS / 32];        // row sums a warp
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int G = nt / (32 * S);
  const int g = warp / S, s = warp % S;
  const long long T = (long long)gridDim.x * G;
  const long long gid = (long long)blockIdx.x * G + g;
  // where this group's rows start against 16 bytes: a head of scalars,
  // whole chunks, a tail of scalars (the same for every row it takes)
  const int mis =
      (int)(reinterpret_cast<uintptr_t>(x + gid * H) % 16) / sizeof(TX);
  const int head = min(H, mis ? V - mis : 0);
  const int nvec = (H - head) / V;
  const int tail = H - head - nvec * V;
  const int tail0 = head + nvec * V;
  // this lane's chunks of the warp's segment, their first columns
  int col[NC];
  bool own[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int k = lane + 32 * c, ch = s * seg + k;
    own[c] = k < seg && ch < nvec;
    col[c] = head + ch * V;
  }
  const bool own_h = s == 0 && lane < head, own_t = s == 0 && lane < tail;

  // copy row `row`'s chunks (and its mean and rstd, by lane 0) into ring
  // stage `st`: zeros past the last row; a dy chunk off 16 bytes goes
  // through registers
  auto stage = [&](long long row, int st) {
    const bool ok = row < n;
    const TX* xp = x + (ok ? row : 0) * H;
    const TD* dp = dy + (ok ? row : 0) * H;
    uint4* slot = ring + (size_t)st * W * nt + tid;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool v = ok && own[c];
      uint4* sx = slot + (size_t)c * (1 + DQ) * nt;
      cp_async16(smem_addr(sx), v ? xp + col[c] : x, v);
      const TD* d = dp + col[c];
      if (!ok || reinterpret_cast<uintptr_t>(d) % 16 == 0) {
        // the warp's DQ * 32 words of dy, one contiguous run: word
        // lane + 32 q is half (lane + 32 q) % DQ of lane (lane + 32 q) /
        // DQ's chunk, so each copy instruction reads 512 bytes in order
#pragma unroll
        for (int q = 0; q < DQ; ++q) {
          const int p = lane + 32 * q, o = p / DQ, k = o + 32 * c;
          const bool vo = ok && k < seg && s * seg + k < nvec;
          cp_async16(smem_addr(sx + (size_t)(1 + p % DQ) * nt + (o - lane)),
                     vo ? d + (o - lane) * V + (p % DQ) * (16 / sizeof(TD))
                        : dy,
                     vo);
        }
      } else {   // off 16 bytes: each lane its own chunk, through registers
        Raw<TD, V> r;
#pragma unroll
        for (int q = 0; q < DQ; ++q) r.q[q] = make_uint4(0, 0, 0, 0);
        if (v) r.load(d);
#pragma unroll
        for (int q = 0; q < DQ; ++q) sx[(size_t)(1 + q) * nt] = r.q[q];
      }
    }
    if (lane == 0) {
      cp_async4(smem_addr(&stats[st][warp].x), ok ? mu + row : mu, ok);
      cp_async4(smem_addr(&stats[st][warp].y), ok ? rstd + row : rstd, ok);
    }
    cp_async_commit();
  };

  // every warp of the block takes the same number of steps (the S warps
  // of a row meet at a barrier in each)
  const long long steps = (n + T - 1) / T;
#pragma unroll
  for (int k = 0; k < NBUF - 1; ++k) stage(gid + k * T, k);

  float wv[NC][V], pw[NC][V], pb[NC][V];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (own[c]) {
      load_vals<TP, V>(w + col[c], wv[c]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) wv[c][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) pw[c][j] = pb[c][j] = 0.f;
  }
  const float hw = own_h ? to_f(w[lane]) : 0.f;
  const float tw = own_t ? to_f(w[tail0 + lane]) : 0.f;
  float hpw = 0.f, hpb = 0.f, tpw = 0.f, tpb = 0.f;

  for (long long it = 0; it < steps; ++it) {
    const long long row = gid + it * T;
    stage(row + (NBUF - 1) * T, (int)((it + NBUF - 1) % NBUF));
    cp_async_wait<NBUF - 1>();   // this step's row has landed
    __syncwarp();                // lane 0's copy of its statistics
    const int st = (int)(it % NBUF);
    const uint4* slot = ring + (size_t)st * W * nt + tid;
    Raw<TX, V> xr[NC];
    Raw<TD, V> dr[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      xr[c].q[0] = slot[(size_t)c * (1 + DQ) * nt];
#pragma unroll
      for (int q = 0; q < DQ; ++q)
        dr[c].q[q] = slot[(size_t)(c * (1 + DQ) + 1 + q) * nt];
    }
    const float m = stats[st][warp].x, rs = stats[st][warp].y;
    __syncwarp();                // read before lane 0 restages it
    const bool ok = row < n;
    const TX* xp = x + row * H;
    const TD* dp = dy + row * H;
    const float hx = ok && own_h ? to_f(xp[lane]) : 0.f;
    const float hd = ok && own_h ? to_f(dp[lane]) : 0.f;
    const float tx = ok && own_t ? to_f(xp[tail0 + lane]) : 0.f;
    const float td = ok && own_t ? to_f(dp[tail0 + lane]) : 0.f;
    // sum(g) and sum(g x^) of the row (a zero dy adds nothing)
    float a = hd * hw, b = a * ((hx - m) * rs);
    const float gt = td * tw;
    a += gt;
    b = fmaf(gt, (tx - m) * rs, b);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gv = dr[c][j] * wv[c][j];
        a += gv;
        b = fmaf(gv, (xr[c][j] - m) * rs, b);
      }
    }
    float sg = warp_sum(a), sgx = warp_sum(b);
    if (S > 1) {   // the S warps of the row, in warp order
      float2* sl = red[it & 1];
      if (lane == 0) sl[warp] = make_float2(sg, sgx);
      group_sync(g, S);
      sg = sgx = 0.f;
      for (int k = 0; k < S; ++k) {
        const float2 v = sl[g * S + k];
        sg += v.x;
        sgx += v.y;
      }
    }
    if (!ok) continue;
    const float m1 = sg / H, m2 = sgx / H;
    TX* dxp = dx + row * H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!own[c]) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float dv = dr[c][j];
        const float xh = (xr[c][j] - m) * rs;
        o[j] = rs * (dv * wv[c][j] - m1 - xh * m2);
        pw[c][j] = fmaf(dv, xh, pw[c][j]);
        pb[c][j] += dv;
      }
      store_vals<TX, V>(dxp + col[c], o);
    }
    if (own_h) {
      const float xh = (hx - m) * rs;
      dxp[lane] = from_f<TX>(rs * (hd * hw - m1 - xh * m2));
      hpw = fmaf(hd, xh, hpw);
      hpb += hd;
    }
    if (own_t) {
      const float xh = (tx - m) * rs;
      dxp[tail0 + lane] = from_f<TX>(rs * (td * tw - m1 - xh * m2));
      tpw = fmaf(td, xh, tpw);
      tpb += td;
    }
  }

  // the block's sum: each group's partial row into shared memory (the
  // ring's space; the S warps of a group hold disjoint columns), then the
  // groups added in order, 4 columns a thread
  cp_async_wait<0>();
  __syncthreads();
  const int L = (2 * H + 3) / 4 * 4;
  float* acc = reinterpret_cast<float*>(ring);
  float* mine = acc + (size_t)g * L;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!own[c]) continue;
    float* ow = mine + col[c];
    float* ob = mine + H + col[c];
    if (head % 4 == 0 && H % 4 == 0) {   // 16-byte stores: 4 lanes a
#pragma unroll                           // wavefront, not 8-way conflicts
      for (int j = 0; j < V; j += 4) {
        *reinterpret_cast<float4*>(ow + j) =
            make_float4(pw[c][j], pw[c][j + 1], pw[c][j + 2], pw[c][j + 3]);
        *reinterpret_cast<float4*>(ob + j) =
            make_float4(pb[c][j], pb[c][j + 1], pb[c][j + 2], pb[c][j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ow[j] = pw[c][j];
        ob[j] = pb[c][j];
      }
    }
  }
  if (own_h) {
    mine[lane] = hpw;
    mine[H + lane] = hpb;
  }
  if (own_t) {
    mine[tail0 + lane] = tpw;
    mine[H + tail0 + lane] = tpb;
  }
  __syncthreads();
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  float4* out4 = reinterpret_cast<float4*>(part) + (size_t)blockIdx.x * L / 4;
  for (int i = tid; i < L / 4; i += nt) {
    float4 v = a4[i];
    for (int k = 1; k < G; ++k) v = add4(v, a4[(size_t)k * L / 4 + i]);
    if (gridDim.x == 1)
      put4(dw, db, H, 4 * i, v);
    else
      out4[i] = v;
  }
  if (gridDim.x == 1) return;
  // the partials are read: the ring's first word becomes the ticket's flag
  merge_partials(part, tickets, dw, db, H, L, K,
                 reinterpret_cast<int*>(ring));
}

// V consecutive elements (V = VEC or 1), global or shared memory
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == VEC) {
    load4(p, v);
  } else {
    v[0] = to_f(*p);
  }
}
__device__ __forceinline__ void store4(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == VEC) {
    store4(p, v);
  } else {
    *p = from_f<T>(v[0]);
  }
}

// Rows wider than the registers hold: one warp per row, the warps of the
// grid striding over the rows; two passes over a row (the second from
// L1), the first reducing sum(g) and sum(g x^), the second writing dx and
// adding dy x^ and dy into the warp's own fp32 row of partial sums in
// shared memory ([warps][2][H]); then the warps' rows in warp order and
// the merge.  Lanes take VEC elements a load where H is a multiple of 4
// and the rows aligned (V = VEC), else one.
template <typename TX, typename TP, typename TD, int V>
__global__ void __launch_bounds__(MAX_THREADS) ln_bwd_wide_kernel(
    const TX* __restrict__ x, const TP* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rstd,
    const TD* __restrict__ dy, TX* __restrict__ dx, TP* __restrict__ dw,
    TP* __restrict__ db, float* __restrict__ part, int* __restrict__ tickets,
    int n, int H, int K) {
  extern __shared__ __align__(16) float acc[];   // [warps][2][H]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* aw = acc + (size_t)warp * 2 * H;
  float* ab = aw + H;
  for (int i = lane; i < H; i += 32) {
    aw[i] = 0.f;
    ab[i] = 0.f;
  }
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < n;
       row += stride) {
    const TX* xr = x + row * H;
    const TD* dyr = dy + row * H;
    const float m = mu[row], r = rstd[row];
    float sg = 0.f, sgx = 0.f;
#pragma unroll 2
    for (int i = lane * V; i < H; i += 32 * V) {
      float xv[V], dv[V], wv[V];
      load_v<V>(xr + i, xv);
      load_v<V>(dyr + i, dv);
      load_v<V>(w + i, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - m) * r;
        const float g = dv[j] * wv[j];
        sg += g;
        sgx = fmaf(g, xh, sgx);
      }
    }
    const float m1 = warp_sum(sg) / H;
    const float m2 = warp_sum(sgx) / H;
    TX* dxr = dx + row * H;
#pragma unroll 2
    for (int i = lane * V; i < H; i += 32 * V) {
      float xv[V], dv[V], wv[V], sw[V], sb[V], o[V];
      load_v<V>(xr + i, xv);
      load_v<V>(dyr + i, dv);
      load_v<V>(w + i, wv);
      load_v<V>(aw + i, sw);
      load_v<V>(ab + i, sb);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - m) * r;
        const float g = dv[j] * wv[j];
        o[j] = r * (g - m1 - xh * m2);
        sw[j] = fmaf(dv[j], xh, sw[j]);
        sb[j] += dv[j];
      }
      store_v<V>(dxr + i, o);
      store_v<V>(aw + i, sw);
      store_v<V>(ab + i, sb);
    }
  }
  __syncthreads();
  const int L = (2 * H + 3) / 4 * 4;
  float* mine = part + (size_t)blockIdx.x * L;
  for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < warps; ++k) t += acc[(size_t)k * 2 * H + i];
    if (gridDim.x == 1)
      put(dw, db, H, i, t);
    else
      mine[i] = t;
  }
  if (gridDim.x == 1) return;
  merge_partials(part, tickets, dw, db, H, L, K,
                 reinterpret_cast<int*>(acc));
}

template <typename K, typename... A>
cudaError_t run(K kernel, int grid, int threads, size_t smem,
                cudaStream_t stream, A... args) {
  // past 48 KB with the kernels' static shared memory (under 1 KB)
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The row design with NC chunks a lane (`nc`), NC <= NC_MAX<TX>.
template <typename TX, typename TP, typename TD, int NC>
cudaError_t rows(int nc, const TX* x, const TP* w, const float* mu,
                 const float* rstd, const TD* dy, TX* dx, TP* dw, TP* db,
                 float* part, int* tickets, int n, int H, int grid, int warps,
                 int S, int seg, int K, cudaStream_t stream) {
  if constexpr (NC > NC_MAX<TX>) {
    return cudaErrorInvalidValue;
  } else {
    if (nc != NC)
      return rows<TX, TP, TD, NC + 1>(nc, x, w, mu, rstd, dy, dx, dw, db,
                                      part, tickets, n, H, grid, warps, S,
                                      seg, K, stream);
    // the ring, or the groups' partial rows after it, if more
    constexpr int V = 16 / sizeof(TX);
    constexpr size_t W = NC * (1 + V * sizeof(TD) / 16);
    const size_t ring = 16 * NBUF * W * 32 * warps;
    const size_t sums = sizeof(float) * (warps / S) * ((2 * H + 3) / 4 * 4);
    return run(ln_bwd_kernel<TX, TP, TD, NC>, grid, 32 * warps,
               ring > sums ? ring : sums, stream, x, w, mu, rstd, dy, dx, dw,
               db, part, tickets, n, H, S, seg, K);
  }
}

template <typename TX, typename TP, typename TD>
cudaError_t launch(const void* x, const void* w, const void* mu,
                   const void* rstd, const void* dy, void* dx, void* dw,
                   void* db, void* part, void* tickets, int n, int H,
                   int grid, int warps, int S, int seg, int K, int wide,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TP* wp = static_cast<const TP*>(w);
  const float* mp = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const TD* dyp = static_cast<const TD*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  TP* dwp = static_cast<TP*>(dw);
  TP* dbp = static_cast<TP*>(db);
  float* pp = static_cast<float*>(part);
  int* tp = static_cast<int*>(tickets);
  if (wide) {
    const size_t smem = sizeof(float) * 2 * (size_t)warps * H;
    // VEC elements a load where every row starts on 16 bytes
    const bool vec =
        H % VEC == 0 &&
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx)) %
                16 ==
            0;
    if (vec)
      return run(ln_bwd_wide_kernel<TX, TP, TD, VEC>, grid, 32 * warps, smem,
                 stream, xp, wp, mp, rp, dyp, dxp, dwp, dbp, pp, tp, n, H, K);
    return run(ln_bwd_wide_kernel<TX, TP, TD, 1>, grid, 32 * warps, smem,
               stream, xp, wp, mp, rp, dyp, dxp, dwp, dbp, pp, tp, n, H, K);
  }
  return rows<TX, TP, TD, 1>((seg + 31) / 32, xp, wp, mp, rp, dyp, dxp, dwp,
                            dbp, pp, tp, n, H, grid, warps, S, seg, K,
                            stream);
}

}  // namespace

// The plan (`ops/fused_mlp.py` `ln_bwd_plan`): `grid` blocks of `warps`
// warps; the row design (wide 0): S warps a row, `seg` chunks a warp, the
// rows' groups a multiple of their alignment period; the wide design
// (wide 1): one warp a row.  Both merge the blocks' partials in groups of
// K.  part holds (grid + ceil(grid / K)) * 2 * H floats, tickets
// ceil(grid / K) + 1 ints, zero.  Returns the first launch error,
// cudaErrorInvalidValue (1) for a plan the kernels do not take, or
// cudaSuccess.
extern "C" int fused_layernorm_bwd(const void* x, const void* w,
                                   const void* mu, const void* rstd,
                                   const void* dy, void* dx, void* dw,
                                   void* db, void* part, void* tickets, int n,
                                   int H, int grid, int warps, int S, int seg,
                                   int K, int wide, int x_bf16, int p_bf16,
                                   void* stream) {
  if (grid < 1 || warps < 1 || warps * 32 > MAX_THREADS || K < 1 ||
      (!wide && (S < 1 || warps % S || seg < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
#define LN_BWD_LAUNCH(TX, TP, TD)                                          \
  err = launch<TX, TP, TD>(x, w, mu, rstd, dy, dx, dw, db, part, tickets, n, \
                           H, grid, warps, S, seg, K, wide, s)
  if (x_bf16 && p_bf16)
    LN_BWD_LAUNCH(bf, bf, bf);
  else if (x_bf16)
    LN_BWD_LAUNCH(bf, float, float);
  else if (p_bf16)
    LN_BWD_LAUNCH(float, bf, float);
  else
    LN_BWD_LAUNCH(float, float, float);
#undef LN_BWD_LAUNCH
  return static_cast<int>(err);
}
