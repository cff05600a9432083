// Fused feed-forward forward, act(x W1 + b1) W2, for a few rows (the decode
// step), bf16, fp16 or fp32, on Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ffn_fwd_kernel` (reached via
// `fused_ffn_2d` <- `fused_ffn_arrays`) at the row counts where
// `ops/fused_mlp.py` `ffn_design` picks "decode".
//
// What bounds it on this card: memory -- the two weight matrices are read
// once (2 H I elements: 9.4 MB in bf16 or fp16 at GPT-2 width, 2.8 us at
// 3.35 TB/s) for 4 n H I FLOPs, a few per weight byte at n = 8.
//
// What the design does about it: two launches of one skinny product, out =
// epilogue(in W) for in [n, K] and W [K, N].  A block owns 128 bytes of W's
// columns (64 bf16 / fp16 or 32 fp32) and a chunk of R = 32 L of its rows:
// each of 256 threads holds L 16-byte loads of W (8 threads per 128-byte
// row segment, 32 rows at once), all issued before anything else, and
// multiplies them with the 8 rows of `in` of its row tile (read with
// 16-byte loads, all at once, and staged in fp32 in shared memory).  The
// sums over the block's
// rows are reduced by shuffles and then across warps in warp order; a block
// writes an fp32 partial [8, 64 or 32] per chunk, and the last block of a
// column slice (a self-resetting ticket, `last_of`) adds the K / R partials
// in chunk order (8 loads in flight) and applies the epilogue -- so a second
// launch gives the first launch's bits.  The partials are K / R fp32 rows
// per output row: at GPT-2 width and 8 rows 0.3 MB per product against 4.7
// MB of its weights.  The first launch (in = x, W = W1) adds b1 in fp32,
// applies the activation in fp32 and rounds h to x's type into a scratch [n,
// I] (48 KB at 8 rows); the second (in = h, W = W2) rounds y once
// (`pallas_ops.py:1559-1564`).  The second launch is a programmatic
// dependent launch: its blocks start while the first runs, issue their W2
// loads, and only then wait (`griddepcontrol.wait`) for h, so both weight
// matrices stream at once.  (Measured slower, PERF.md: the second launch
// queued after the first; one cooperative launch, each block doing a unit
// of each product and waiting on per-slice flags for h.)
//
// Layout: x [n, H], w1 [H, I], b1 [I], w2 [I, H2], y [n, H2], h [n, I];
// one type (float, `__nv_bfloat16` or `__half`), contiguous, 16-byte
// aligned.  act: 0 gelu (erf), 1 gelu (tanh), 2 relu.
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 256;
constexpr int RT = 8;                  // rows per tile
constexpr int SEG = 8;                 // threads per 128-byte row segment
constexpr int GROUPS = THREADS / SEG;  // rows of W loaded at once
constexpr int WARPS = THREADS / 32;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);   // elements per 16-byte load
  static constexpr int CW = SEG * N;         // columns of a block
};

// The Vec<T>::N elements of T in 16 bytes as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r,
                                       float (&v)[Vec<T>::N]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      v[j] = __uint_as_float(w[j]);
    } else {
      const float2 f = unpack2<T>(w[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

// EPI 0: out = round(act(in W + bias)); EPI 1: out = round(in W).
// Grid: (N / CW column slices, K / (32 L) chunks, row tiles).  DEPENDENT:
// launched as the dependent of the previous launch, whose output `in` is.
template <typename T, int L, int EPI, bool DEPENDENT>
__global__ void __launch_bounds__(THREADS) ffn_dec_kernel(
    const T* __restrict__ in, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int n, int K, int N,
    int act) {
  constexpr int V = Vec<T>::N, CW = Vec<T>::CW, R = GROUPS * L;
  __shared__ __align__(16) float xs[R][RT];     // in's rows, transposed
  __shared__ float red[WARPS][RT][CW];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int seg = tid % SEG, grp = tid / SEG;
  const int c0 = blockIdx.x * CW, chunk = blockIdx.y, chunks = gridDim.y;
  const int k0 = chunk * R, r0 = blockIdx.z * RT, rows = min(RT, n - r0);

  if constexpr (!DEPENDENT) trigger_dependents();
  uint4 wr[L];
#pragma unroll
  for (int l = 0; l < L; ++l)
    wr[l] = __ldg(reinterpret_cast<const uint4*>(
        w + (long long)(k0 + grp + GROUPS * l) * N + c0 + seg * V));
  if constexpr (DEPENDENT) wait_prior_grid();
  // the tile's rows of `in`, columns k0 .. k0 + R, with 16-byte loads, all
  // issued at once (through L2: `in` of a dependent launch was written
  // while it started), stored transposed in fp32
  constexpr int XN = RT * R / V;                    // 16-byte pieces
  constexpr int XL = (XN + THREADS - 1) / THREADS;  // of them a thread
  uint4 raw[XL];
#pragma unroll
  for (int q = 0; q < XL; ++q) {
    const int e = tid + q * THREADS, r = e / (R / V), k = e % (R / V) * V;
    raw[q] = e < XN && r < rows
                 ? __ldcg(reinterpret_cast<const uint4*>(
                       in + (long long)(r0 + r) * K + k0 + k))
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int q = 0; q < XL; ++q) {
    const int e = tid + q * THREADS, r = e / (R / V), k = e % (R / V) * V;
    if (e >= XN) continue;
    float v[V];
    unpack<T>(raw[q], v);
#pragma unroll
    for (int j = 0; j < V; ++j) xs[k + j][r] = v[j];
  }
  __syncthreads();

  float acc[RT][V];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float wv[V];
    unpack<T>(wr[l], wv);
    const float4 a = *reinterpret_cast<const float4*>(xs[grp + GROUPS * l]);
    const float4 b =
        *reinterpret_cast<const float4*>(xs[grp + GROUPS * l] + 4);
    const float xr[RT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = fmaf(wv[j], xr[r], acc[r][j]);
  }
  // over the four row groups of a warp (lanes 8 and 16 apart), then over
  // the warps in order
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    }
  if (lane < SEG) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) red[warp][r][seg * V + j] = acc[r][j];
  }
  __syncthreads();

  auto finish = [&](int r, int c, float s) {
    float v = s;
    if constexpr (EPI == 0) v = activate(s + to_f(bias[c0 + c]), act);
    out[(long long)(r0 + r) * N + c0 + c] = from_f<T>(v);
  };
  for (int e = tid; e < rows * CW; e += THREADS) {
    const int r = e / CW, c = e % CW;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += red[wp][r][c];
    if (chunks == 1)
      finish(r, c, s);
    else
      part[((long long)chunk * n + r0 + r) * N + c0 + c] = s;
  }
  if (chunks == 1) return;
  if (!last_of(&tickets[blockIdx.z * gridDim.x + blockIdx.x], chunks,
               &is_last))
    return;
  for (int e = tid; e < rows * CW; e += THREADS) {
    const int r = e / CW, c = e % CW;
    const float* p = part + (long long)(r0 + r) * N + c0 + c;
    const long long step = (long long)n * N;   // between chunks
    float s = 0.f;
    for (int q0 = 0; q0 < chunks; q0 += 8) {   // 8 loads in flight
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = q0 + q < chunks ? __ldcg(p + (q0 + q) * step) : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) s += v[q];
    }
    finish(r, c, s);
  }
}

template <typename T, int EPI, bool DEPENDENT>
cudaError_t skinny(int L, const T* in, const T* w, const T* bias, T* out,
                   float* part, int* tickets, int n, int K, int N, int act,
                   cudaStream_t stream) {
  dim3 grid(N / Vec<T>::CW, K / (GROUPS * L), (n + RT - 1) / RT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = DEPENDENT ? 1 : 0;
  cudaError_t err;
  if (L == 4)
    err = cudaLaunchKernelEx(&cfg, ffn_dec_kernel<T, 4, EPI, DEPENDENT>, in,
                             w, bias, out, part, tickets, n, K, N, act);
  else if (L == 8)
    err = cudaLaunchKernelEx(&cfg, ffn_dec_kernel<T, 8, EPI, DEPENDENT>, in,
                             w, bias, out, part, tickets, n, K, N, act);
  else
    err = cudaLaunchKernelEx(&cfg, ffn_dec_kernel<T, 16, EPI, DEPENDENT>,
                             in, w, bias, out, part, tickets, n, K, N, act);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, void* h, void* y, void* part1,
                   void* part2, int* tickets, int n, int H, int I, int H2,
                   int L1, int L2, int act, cudaStream_t s) {
  const int tiles = (n + RT - 1) / RT;
  cudaError_t err = skinny<T, 0, false>(
      L1, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<T*>(h),
      static_cast<float*>(part1), tickets, n, H, I, act, s);
  if (err != cudaSuccess) return err;
  return skinny<T, 1, true>(
      L2, static_cast<const T*>(h), static_cast<const T*>(w2), nullptr,
      static_cast<T*>(y), static_cast<float*>(part2),
      tickets + tiles * (I / Vec<T>::CW), n, I, H2, act, s);
}

bool chunk_ok(int L, int K) {
  return (L == 4 || L == 8 || L == 16) && K % (GROUPS * L) == 0;
}

}  // namespace

// h = round(act(x w1 + b1)) through the scratch h, then y = round(h w2);
// L1, L2 (4, 8 or 16): the 16-byte loads a thread makes per chunk of each
// product (chunks of 32 L rows of w1, w2).  part1, part2: fp32 scratch of
// (H / (32 L1)) n I and (I / (32 L2)) n H2 floats; tickets: zero, at
// least ceil(n / 8) (I + H2) / (64 bf16 / fp16, 32 fp32) of them; dtype
// the element type's code (0 fp32, 1 bf16, 2 fp16).  The second product
// is launched as the programmatic dependent of the first.  Returns the
// first launch error; 1 (cudaErrorInvalidValue) for another type code, an
// unknown activation, a chunk that does not divide H or I, or an I or H2
// that is not a multiple of 64 (bf16, fp16) or 32 (fp32) columns.
extern "C" int fused_ffn_decode(const void* x, const void* w1, const void* b1,
                                const void* w2, void* h, void* y, void* part1,
                                void* part2, void* tickets, int n, int H,
                                int I, int H2, int L1, int L2, int act,
                                int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int cw = dtype ? Vec<__half>::CW : Vec<float>::CW;
  if (act < 0 || act > 2 || !chunk_ok(L1, H) || !chunk_ok(L2, I) ||
      I % cw || H2 % cw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
#define FFN_DEC_LAUNCH(T) \
  launch<T>(x, w1, b1, w2, h, y, part1, part2, tk, n, H, I, H2, L1, L2, act, s)
  const cudaError_t err = dtype == 0   ? FFN_DEC_LAUNCH(float)
                          : dtype == 1 ? FFN_DEC_LAUNCH(__nv_bfloat16)
                                       : FFN_DEC_LAUNCH(__half);
#undef FFN_DEC_LAUNCH
  return static_cast<int>(err);
}
