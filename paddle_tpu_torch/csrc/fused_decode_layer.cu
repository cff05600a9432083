// One transformer layer's decode step (S_q = 1) in one launch, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_fused_decode_layer_kernel`
// (reached via `fused_decode_layer_arrays`): LN1 -> qkv -> write of the
// new token's K/V at ring row t -> online-softmax attention over the t
// cached keys (plus an optional additive row mask) and the current token
// -> out-proj -> residual.  The TPU kernel exists to cut the launch count
// of a decode step; this one keeps that: one launch per layer per step.
//
// What bounds it on this card: memory.  A step reads the layer's weights
// once (4 * hd^2 elements: 4.7 MB in bf16 at GPT-2 width) and the valid
// K/V prefix once (2 * B * t * hd elements), at a few FLOPs per element.
//
// What the design does about it: a cooperative launch (all blocks
// co-resident, `cooperative_groups::this_grid().sync()` between the three
// phases, each of which needs all of the previous one), 256 threads a
// block, grid = min(co-resident blocks, max(qkv column tiles, B * H)).
//  1. Every block computes LN1 of all B rows (fp32 statistics, two passes)
//     into shared memory, rounded to the weights' type, then takes column
//     tiles of wqkv in a grid-stride loop.  A tile is 32 bytes of columns
//     (8 fp32 / 16 bf16) over all hd rows: the lanes of a warp read 32/cw
//     rows of one tile, one full sector each, and the 8 warps split the
//     rows; each thread keeps one fp32 sum per batch row, so the weights
//     are read once for all rows (up to 8 at a time), and a fixed-order sum
//     over the threads of a column finishes the tile.  q, k and v go to an
//     fp32 scratch with the fp32 bias added.
//  2. One block per (row, head): the streaming online softmax of the
//     decode kernel over the t cached keys (csrc/flash_decode.cu, with the
//     mask added to the scores), then the current token's term from the
//     fp32 k and v, then the output rounded to the weights' type into the
//     scratch.  The same block writes the new K/V rows (rounded to the
//     cache type) at row t, which no block of this launch reads.
//  3. Every block stages the attention output, then column tiles of wo as
//     in phase 1; y = x + (proj + bo) in fp32, cast to x's type.
// Phase 2 has only B * H tasks (96 at GPT-2 decode), so the attention over
// a long prefix runs on fewer SMs than the card has; splitting the keys is
// later work, as for the decode kernel.
//
// Rounding points (the TPU kernel's, `pallas_ops.py:1208-1256`): LN in
// fp32; xn rounded to the weights' type before the qkv product; q, k, v in
// fp32; probabilities rounded to the cache type before the value product;
// the attention output rounded to the weights' type before the out-proj;
// the residual in fp32.  q.k sums in fp32 (the TPU kernel rounds each
// product to bf16 first; not copied).
//
// Layout: x, y [B, hd]; wqkv [hd, 3hd]; wo [hd, hd]; biases and LN
// parameters [hd] / [3hd]; rings contiguous [B, S_max, hd]; all one type.
// mask: null or a contiguous fp32 [B, S_max]; scratch: fp32 [B, 4hd].
#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RB = 8;           // batch rows per pass over a weight tile

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
  float* scratch;      // [B, 4hd]: q | k | v (fp32), then the attention out
  T* y;
  int B, H, S_max, t;
  float eps, scale;
};

// xs layout: row chunk c of RB rows, then k, then the row in the chunk:
// xs[(c * K + k) * RB + r], rows past B zero.
__device__ __forceinline__ float* xs_at(float* xs, int K, int row, int k) {
  return xs + ((long long)(row / RB) * K + k) * RB + row % RB;
}

// One column tile: sums[r][col] = sum_k xs[r][k] * W[k][col] for the CW
// columns from col0 and every row; calls epi(row, col, sum) once each.
template <typename T, typename Epi>
__device__ __forceinline__ void gemv_tile(const T* __restrict__ W, int ncols,
                                          int K, int col0, const float* xs,
                                          int B, float* red, Epi epi) {
  constexpr int CW = 32 / sizeof(T);   // columns: 32 bytes of a row
  constexpr int KR = 32 / CW;          // rows a warp reads at once
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col = col0 + lane % CW;
  const int kk = warp * KR + lane / CW;
  const T* wc = W + col;
  for (int c = 0; c * RB < B; ++c) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    const float* xc = xs + (long long)c * K * RB;
#pragma unroll 4
    for (int k = kk; k < K; k += WARPS * KR) {
      const float w = to_f(wc[(long long)k * ncols]);
      const float4 a = *reinterpret_cast<const float4*>(xc + k * RB);
      const float4 b = *reinterpret_cast<const float4*>(xc + k * RB + 4);
      acc[0] = fmaf(w, a.x, acc[0]);
      acc[1] = fmaf(w, a.y, acc[1]);
      acc[2] = fmaf(w, a.z, acc[2]);
      acc[3] = fmaf(w, a.w, acc[3]);
      acc[4] = fmaf(w, b.x, acc[4]);
      acc[5] = fmaf(w, b.y, acc[5]);
      acc[6] = fmaf(w, b.z, acc[6]);
      acc[7] = fmaf(w, b.w, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) red[r * THREADS + tid] = acc[r];
    __syncthreads();
    if (tid < CW * RB) {
      const int cl = tid % CW, r = tid / CW;
      float s = 0.f;
      for (int j = cl; j < THREADS; j += CW) s += red[r * THREADS + j];
      if (c * RB + r < B) epi(c * RB + r, col0 + cl, s);
    }
    __syncthreads();   // red is reused
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fused_decode_layer_kernel(
    Args<T> a) {
  constexpr int TPK = D / VEC;
  constexpr int G = THREADS / TPK;
  extern __shared__ __align__(16) float xs[];   // [ceil(B/RB)][hd][RB]
  __shared__ __align__(16) float red[RB * THREADS];
  __shared__ float qs[D], kn[D], vn[D];
  __shared__ float ps[THREADS];
  __shared__ float red2[WARPS];
  __shared__ float part[G][D];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int B = a.B, H = a.H, hd = H * D, S_max = a.S_max, t = a.t;
  float* qkv = a.scratch;                      // [B, 3hd]
  float* attn = a.scratch + (long long)B * 3 * hd;   // [B, hd]
  const int nrows = (B + RB - 1) / RB * RB;

  // -- phase 1: LN1 of every row, then the qkv columns ---------------------
  for (int row = warp; row < nrows; row += WARPS) {
    if (row >= B) {
      for (int k = lane; k < hd; k += 32) *xs_at(xs, hd, row, k) = 0.f;
      continue;
    }
    const T* xr = a.x + (long long)row * hd;
    float s = 0.f;
    for (int k = lane; k < hd; k += 32) s += to_f(xr[k]);
    const float mu = warp_sum(s) / hd;
    float v = 0.f;
    for (int k = lane; k < hd; k += 32) {
      const float c = to_f(xr[k]) - mu;
      v = fmaf(c, c, v);
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / hd + a.eps);
    for (int k = lane; k < hd; k += 32)
      *xs_at(xs, hd, row, k) = round_to<T>(
          (to_f(xr[k]) - mu) * rs * to_f(a.lnw[k]) + to_f(a.lnb[k]));
  }
  __syncthreads();
  constexpr int CW = 32 / sizeof(T);
  const int ncol3 = 3 * hd;
  for (int tile = blockIdx.x; tile * CW < ncol3; tile += gridDim.x)
    gemv_tile(a.wqkv, ncol3, hd, tile * CW, xs, B, red,
              [&](int r, int c, float s) {
                qkv[(long long)r * ncol3 + c] = s + to_f(a.bqkv[c]);
              });
  grid.sync();

  // -- phase 2: attention per (row, head), and the ring write --------------
  const int g = tid / TPK, d0 = (tid % TPK) * VEC;
  for (int task = blockIdx.x; task < B * H; task += gridDim.x) {
    const int b = task / H, h = task % H;
    const float* qr = qkv + (long long)b * ncol3 + h * D;
    for (int d = tid; d < D; d += THREADS) {
      qs[d] = __ldcg(qr + d);
      kn[d] = __ldcg(qr + hd + d);
      vn[d] = __ldcg(qr + 2 * hd + d);
    }
    __syncthreads();
    const long long base = (long long)b * S_max * hd + h * D;
    float m, l, acc[VEC];
    prefix_attention<T, D, THREADS>(
        qs, a.kc + base, a.vc + base, hd, t, a.scale,
        a.mask ? a.mask + (long long)b * S_max : nullptr, ps, red2, m, l,
        acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[g][d0 + i] = acc[i];
    // the current token's term, from the fp32 q, k, v
    const float s_self =
        block_reduce<THREADS>(tid < D ? qs[tid] * kn[tid] : 0.f, red2,
                              false) *
        a.scale;   // its barriers also order part[]
    const float m2 = fmaxf(m, s_self);
    const float alpha = expf(m - m2);
    const float p_self = expf(s_self - m2);
    const float ls = fmaxf(alpha * l + p_self, 1e-30f);
    const float p_r = round_to<T>(p_self);
    for (int d = tid; d < D; d += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < G; ++x) s += part[x][d];
      const float o = (s * alpha + p_r * vn[d]) / ls;
      attn[(long long)b * hd + h * D + d] = round_to<T>(o);
      const long long w = base + (long long)t * hd + d;
      a.kc[w] = from_f<T>(kn[d]);
      a.vc[w] = from_f<T>(vn[d]);
    }
    __syncthreads();   // qs, kn, vn, part are reused by the next task
  }
  grid.sync();

  // -- phase 3: out-proj, bias, residual -----------------------------------
  for (int e = tid; e < nrows * hd; e += THREADS) {
    const int row = e / hd, k = e % hd;
    *xs_at(xs, hd, row, k) =
        row < B ? __ldcg(attn + (long long)row * hd + k) : 0.f;
  }
  __syncthreads();
  for (int tile = blockIdx.x; tile * CW < hd; tile += gridDim.x)
    gemv_tile(a.wo, hd, hd, tile * CW, xs, B, red,
              [&](int r, int c, float s) {
                const long long i = (long long)r * hd + c;
                a.y[i] = from_f<T>(to_f(a.x[i]) + (s + to_f(a.bo[c])));
              });
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

template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  auto kernel = fused_decode_layer_kernel<T, D>;
  const int hd = args.H * D;
  const size_t smem =
      sizeof(float) * (size_t)((args.B + RB - 1) / RB) * RB * hd;
  int dev, resident;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = resident_blocks<T, D>(dev, smem, &resident)) != cudaSuccess)
    return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  constexpr int CW = 32 / sizeof(T);
  int want = 3 * hd / CW;
  if (args.B * args.H > want) want = args.B * args.H;
  const int grid = want < resident ? want : resident;
  Args<T> copy = args;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(THREADS), params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, const void* lnw, const void* lnb,
                  const void* wqkv, const void* bqkv, const void* wo,
                  const void* bo, void* kc, void* vc, const void* mask,
                  void* scratch, void* y, int B, int H, int S_max, int t,
                  float eps, float scale) {
  return Args<T>{static_cast<const T*>(x),    static_cast<const T*>(lnw),
                 static_cast<const T*>(lnb),  static_cast<const T*>(wqkv),
                 static_cast<const T*>(bqkv), static_cast<const T*>(wo),
                 static_cast<const T*>(bo),   static_cast<T*>(kc),
                 static_cast<T*>(vc),         static_cast<const float*>(mask),
                 static_cast<float*>(scratch), static_cast<T*>(y),
                 B, H, S_max, t, eps, scale};
}

}  // namespace

// Returns the launch's CUDA error (cudaLaunchCooperativeKernel, then
// cudaGetLastError()); 1 (cudaErrorInvalidValue) for a head size or type
// the kernel does not take.
extern "C" int fused_decode_layer(
    const void* x, const void* lnw, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* kc, void* vc,
    const void* mask, void* scratch, void* y, int B, int H, int D, int S_max,
    int t, int is_bf16, float eps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define FDL_LAUNCH(T, DIM)                                                 \
  err = launch<T, DIM>(make_args<T>(x, lnw, lnb, wqkv, bqkv, wo, bo, kc,   \
                                    vc, mask, scratch, y, B, H, S_max, t,  \
                                    eps, scale),                           \
                       s)
  if (D == 64 && is_bf16)
    FDL_LAUNCH(__nv_bfloat16, 64);
  else if (D == 64)
    FDL_LAUNCH(float, 64);
  else if (D == 128 && is_bf16)
    FDL_LAUNCH(__nv_bfloat16, 128);
  else if (D == 128)
    FDL_LAUNCH(float, 128);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FDL_LAUNCH
  return static_cast<int>(err);
}
