// Fused feed-forward forward, act(x W1 + b1) W2, in float32 on Hopper's
// tensor cores (sm_90a) in split TF32, plain C interface: the fp32 design
// for many rows (training).
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ffn_fwd_kernel` (reached via
// `fused_ffn_2d` <- `fused_ffn_arrays`) for fp32 at the row counts where
// `ops/fused_mlp.py` `ffn_design` picks "tc32".
//
// What bounds it on this card: operations -- 4 n H I FLOPs (77.3 GFLOP at
// 8192 x 768 x 3072), each fp32 product three TF32 products (below), so
// 3 x 77.3 GFLOP at 495 TFLOP/s: 0.468 ms; the bytes (9.4 MB of weights,
// 25 MB of rows, 100 MB of h written and read) take 0.07 ms.
//
// What the design does about it: the fp32 products run on the tensor
// cores as three TF32 `wgmma` products of the operands' hi and lo parts,
// A_lo B_hi + A_hi B_lo + A_hi B_hi, hi = cvt.rna.tf32(x), lo = x - hi
// (`flash_tc.cuh`, last section): as close to the exact product as an
// fp32 product is, where one TF32 pass keeps ~3 digits.  The shape is the
// bf16 design's (`fused_ffn_tc.cu`): two products, each one launch of
// `ffn_tc32_kernel`, through h [n, I] in device memory -- fp32 here, as
// JAX rounds nothing there for fp32 -- the first product's epilogue adding
// b1 and applying the activation in fp32.  What differs:
// - TF32 `wgmma` reads B from shared memory K-major only, and W1 [H, I]
//   and W2 [I, H2] are row-major (MN-major as B).  A first launch of
//   `wt_split_kernel` writes W1^T and W2^T, split into hi and lo, to a
//   scratch once a call (4 x 9.4 MB written at GPT-2 width, ~0.02 ms);
//   the products copy those tiles as they are.  A (x, then h) is copied
//   raw: each thread reads its A fragments (m64k8: rows r, r + 8, columns
//   c, c + 4 of each 8-wide k-step) from the swizzled tile with 4-byte
//   shared loads -- no bank conflict -- and splits them in registers
//   (the register-A form of `wgmma`), so neither x nor h is written twice.
// - The tensor core rounds its fp32 sums toward zero: 3 x 384 truncating
//   sums into one accumulator over I = 3072 bias y by ~3 x 10^-5 of
//   max|y|, three times the fp32 limit of 10^-5; so each 32-deep k-tile's
//   product is summed afresh (12 `wgmma`s) and added to the output
//   accumulator on the CUDA cores (round to nearest): 0.08-0.11 of the
//   limit (both emulated: tests/test_torch_port_tf32_dq_ffn.py).  Two fp32
//   accumulators of BN/2 registers each, so BN is at most 128.
// A block of WGS warpgroups computes a BM = 64 WGS by BN tile, its k-tiles
// (A, B hi and B lo) streamed through a ring of STAGES swizzled tiles by
// 16-byte `cp.async`, STAGES - 1 k-tiles in flight ahead of the one
// multiplied.  Sums run in a fixed order: a second launch gives the first
// launch's bits.  The wrapper picks (WGS, BN) per product from its rows
// and width (`ffn_tc_tiles` over `_TC32_TILES`).
//
// Layout: x [n, H], w1 [H, I], b1 [I], w2 [I, H2], y [n, H2]; the scratch
// h [n, I], w1t [2, I, H] (hi, then lo), w2t [2, H2, I]; all fp32,
// contiguous, 16-byte aligned.  act: 0 gelu (erf), 1 gelu (tanh), 2 relu.
#include "decode_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace flash_tc;

constexpr int BK = 32;                  // depth of a k-tile: 128 bytes
constexpr int RING_BYTES = 200 * 1024;  // shared memory for the ring
constexpr int TT = 32;                  // the transpose's tile

template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = WG * WGS;
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BN * BK * 4;
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE > 6 ? 6 : RING_BYTES / STAGE;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + swizzle slack
};

// wt[0] = hi(w^T), wt[1] = lo(w^T) of the row-major [K, N] fp32 matrix w,
// each [N, K]; blockIdx.z picks one of two matrices.  A 32 x 32 tile a
// block, through shared memory (padded: no bank conflict either way).
__global__ void __launch_bounds__(TT * 8) wt_split_kernel(
    const float* __restrict__ w1, float* __restrict__ w1t, int k1, int n1,
    const float* __restrict__ w2, float* __restrict__ w2t, int k2,
    int n2) {
  __shared__ float t[TT][TT + 1];
  const bool first = blockIdx.z == 0;
  const float* w = first ? w1 : w2;
  float* wt = first ? w1t : w2t;
  const int K = first ? k1 : k2, N = first ? n1 : n2;
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  if (n0 >= N || k0 >= K) return;
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;
#pragma unroll
  for (int r = ty; r < TT; r += 8)
    t[r][tx] = w[(long long)(k0 + r) * N + n0 + tx];
  __syncthreads();
  const long long plane = (long long)N * K;
#pragma unroll
  for (int r = ty; r < TT; r += 8) {
    const float x = t[tx][r], hi = tf32_rna(x);
    const long long o = (long long)(n0 + r) * K + k0 + tx;
    wt[o] = hi;
    wt[plane + o] = x - hi;
  }
}

// C = A B, B given as bt = [hi(B^T); lo(B^T)] ([2, N, K]); EPI 0, 1, 2:
// C = act(A B + bias) with act gelu (erf), gelu (tanh), relu; EPI 3:
// C = A B.
template <int WGS, int BN, int EPI>
__global__ void __launch_bounds__(WG * WGS) ffn_tc32_kernel(
    const float* __restrict__ a, const float* __restrict__ bt,
    const float* __restrict__ bias, float* __restrict__ c, int M, int N,
    int K) {
  using T = Tile<WGS, BN>;
  constexpr int AHEAD = T::STAGES - 1;
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int kt_end = K / BK;
  const float* bhi = bt;
  const float* blo = bt + (long long)N * K;

  // k-tile kt into stage kt % STAGES (one commit group, empty past the end)
  auto load = [&](int kt) {
    if (kt < kt_end) {
      const uint32_t st = ring + (kt % T::STAGES) * T::STAGE;
      load_tile_f32<T::BM, BK, T::THREADS>(st, a + kt * BK, K, m0, M, tid);
      load_tile_f32<BN, BK, T::THREADS>(st + T::A_BYTES, bhi + kt * BK, K,
                                        n0, N, tid);
      load_tile_f32<BN, BK, T::THREADS>(st + T::A_BYTES + T::B_BYTES,
                                        blo + kt * BK, K, n0, N, tid);
    }
    cp_async_commit();
  };

  // this thread's A fragment rows (r0, r0 + 8) in its warpgroup's tile
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < AHEAD; ++kt) load(kt);
  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait<AHEAD - 1>();
    fence_async_smem();
    // k-tile kt has landed everywhere, and every warpgroup is past the
    // products of kt - 1, whose stage the load below refills
    __syncthreads();
    load(kt + AHEAD);
    const uint32_t st = ring + (kt % T::STAGES) * T::STAGE;
    const uint32_t sa = st + wg * 64 * 128;   // this warpgroup's 64 rows
    const uint32_t sbh = st + T::A_BYTES, sbl = sbh + T::B_BYTES;
    // A's hi and lo fragments: value j of k-step kk is row r0 + 8 (j % 2),
    // column 8 kk + t % 4 + 4 (j / 2), i.e. 16-byte chunk 2 kk + j / 2
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * (j % 2), ch = 2 * kk + j / 2;
        const float x =
            lds32(sa + r * 128 + ((ch ^ (r & 7)) << 4) + (t % 4) * 4);
        const float hi = tf32_rna(x);
        ah[kk][j] = __float_as_uint(hi);
        al[kk][j] = __float_as_uint(x - hi);
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
    fence_frag(ah);
    fence_frag(al);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      mma_tf32_rs<BN>(part, al[kk], desc_k<BN>(sbh, kk));
      mma_tf32_rs<BN>(part, ah[kk], desc_k<BN>(sbl, kk));
      mma_tf32_rs<BN>(part, ah[kk], desc_k<BN>(sbh, kk));
    }
    mma_commit();
    mma_wait<0>();
    fence_regs(part);
    fence_frag(ah);
    fence_frag(al);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // epilogue: values i, i + 1 are columns col, col + 1 of one row
  const int r_base = m0 + wg * 64;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = r_base + acc_row(i, t), col = n0 + acc_col(i, t);
    if (r >= M) continue;
    float v0 = acc[i], v1 = acc[i + 1];
    if constexpr (EPI < 3) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      v0 = decode::activate(v0 + bb.x, EPI);
      v1 = decode::activate(v1 + bb.y, EPI);
    }
    *reinterpret_cast<float2*>(c + (long long)r * N + col) =
        make_float2(v0, v1);
  }
}

template <int WGS, int BN, int EPI>
cudaError_t launch(const float* a, const float* bt, const float* bias,
                   float* c, int M, int N, int K, cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  auto* kernel = ffn_tc32_kernel<WGS, BN, EPI>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid(N / BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a, bt, bias, c, M, N, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t product(int wgs, int bn, const float* a, const float* bt,
                    const float* bias, float* c, int M, int N, int K,
                    cudaStream_t s) {
  if (wgs == 1 && bn == 64) return launch<1, 64, EPI>(a, bt, bias, c, M, N, K, s);
  if (wgs == 1 && bn == 128) return launch<1, 128, EPI>(a, bt, bias, c, M, N, K, s);
  if (wgs == 2 && bn == 64) return launch<2, 64, EPI>(a, bt, bias, c, M, N, K, s);
  return launch<2, 128, EPI>(a, bt, bias, c, M, N, K, s);
}

bool tile_ok(int wgs, int bn, int N) {
  return (wgs == 1 || wgs == 2) && (bn == 64 || bn == 128) && N % bn == 0;
}

}  // namespace

// w1t, w2t = the split transposes of w1, w2; h = act(x w1 + b1); then
// y = h w2; (wgs1, bn1) and (wgs2, bn2) the tiles of the two products.
// Returns the first launch error; 1 (cudaErrorInvalidValue) for an unknown
// activation or tile, a tile width that does not divide I or H2, or an H,
// I or H2 that is not a multiple of 32.
extern "C" int fused_ffn_tc32(const void* x, const void* w1, const void* b1,
                              const void* w2, void* h, void* w1t, void* w2t,
                              void* y, int n, int H, int I, int H2, int act,
                              int wgs1, int bn1, int wgs2, int bn2,
                              void* stream) {
  if (act < 0 || act > 2 || H % TT || I % TT || H2 % TT ||
      !tile_ok(wgs1, bn1, I) || !tile_ok(wgs2, bn2, H2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w1s = static_cast<float*>(w1t);
  float* w2s = static_cast<float*>(w2t);
  dim3 grid((I > H2 ? I : H2) / TT, (H > I ? H : I) / TT, 2);
  wt_split_kernel<<<grid, TT * 8, 0, s>>>(static_cast<const float*>(w1),
                                          w1s, H, I,
                                          static_cast<const float*>(w2),
                                          w2s, I, H2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  const float* b1f = static_cast<const float*>(b1);
  float* hf = static_cast<float*>(h);
  if (act == 0)
    err = product<0>(wgs1, bn1, xf, w1s, b1f, hf, n, I, H, s);
  else if (act == 1)
    err = product<1>(wgs1, bn1, xf, w1s, b1f, hf, n, I, H, s);
  else
    err = product<2>(wgs1, bn1, xf, w1s, b1f, hf, n, I, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = product<3>(wgs2, bn2, hf, w2s, nullptr, static_cast<float*>(y), n,
                   H2, I, s);
  return static_cast<int>(err);
}
