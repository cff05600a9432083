// Fused feed-forward forward, act(x W1 + b1) W2, in bf16 on Hopper's tensor
// cores (sm_90a), plain C interface: the design for many rows (training).
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_ffn_fwd_kernel` (reached via
// `fused_ffn_2d` <- `fused_ffn_arrays`) for bf16 at the row counts where
// `ops/fused_mlp.py` `ffn_design` picks "tc".
//
// What bounds it on this card: operations -- 4 n H I FLOPs (77.3 GFLOP at
// 8192 x 768 x 3072, 0.078 ms at the bf16 tensor-core peak) against 9.4 MB
// of weights and 25 MB of rows.
//
// What the design does about it: two `wgmma` products, each one launch of
// `ffn_tc_kernel`.  The TPU kernel keeps h [n, I] in VMEM; here a row tile
// that kept h on chip would also have to keep its 64 x H2 fp32 output
// accumulator in registers (384 a thread of one warpgroup at H2 = 768) or
// merge fp32 partials across blocks, so h goes through device memory in
// bf16 instead (50 MB at 8192 x 3072, written once and read once), which
// is exactly the rounding point of the JAX kernel: the first product's
// epilogue adds b1 in fp32, applies the activation in fp32 and rounds h
// to bf16; the second product's epilogue rounds y once.  Each product is
// C [M, N] = A [M, K] B [K, N], A and B row-major: a block of WGS
// warpgroups (64 rows each) computes a BM = 64 WGS by BN tile, its A and B
// k-tiles (64 deep) streamed by every thread through a ring of STAGES
// swizzled shared-memory tiles with 16-byte `cp.async` (flash_tc.cuh's
// `load_tile`: A K-major, B MN-major), AHEAD = STAGES - 2 tiles in flight
// ahead of the one multiplied, one `wgmma.m64nBNk16` per 16-deep step
// with both operands read from shared memory.  Sums run in fp32 in a
// fixed order: a second launch gives the first launch's bits.  The
// wrapper picks (WGS, BN) per product from M and N (`ffn_tc_tiles`).
//
// Layout: x [n, H], w1 [H, I], b1 [I], w2 [I, H2], y [n, H2], the scratch
// h [n, I]; all bf16, contiguous, 16-byte aligned.  act: 0 gelu (erf),
// 1 gelu (tanh), 2 relu.
#include "decode_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_tc;

constexpr int BK = 64;                  // depth of a k-tile
constexpr int RING_BYTES = 200 * 1024;  // shared memory for the ring

template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = WG * WGS;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + BK * BN * 2;
  static constexpr int STAGES =
      RING_BYTES / STAGE > 6 ? 6 : RING_BYTES / STAGE;
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + swizzle slack
};

// C = A B; EPI 0, 1, 2: C = round(act(A B + bias)) with act gelu (erf),
// gelu (tanh), relu; EPI 3: C = round(A B).
template <int WGS, int BN, int EPI>
__global__ void __launch_bounds__(WG * WGS) ffn_tc_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    const bf16* __restrict__ bias, bf16* __restrict__ c, int M, int N,
    int K) {
  using T = Tile<WGS, BN>;
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int kt_end = K / BK;

  // k-tile kt into stage kt % STAGES (one commit group, empty past the end)
  auto load = [&](int kt) {
    if (kt < kt_end) {
      const uint32_t st = ring + (kt % T::STAGES) * T::STAGE;
      load_tile<T::BM, BK, T::THREADS>(st, a + kt * BK, K, m0, M, tid);
      load_tile<BK, BN, T::THREADS>(st + T::A_BYTES, b + n0, N, kt * BK, K,
                                    tid);
    }
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < T::AHEAD; ++kt) load(kt);
  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait<T::AHEAD - 1>();
    fence_async_smem();
    // k-tile kt has landed everywhere, and every warpgroup is past the
    // products of kt - 2, whose stage the load below refills
    __syncthreads();
    const uint32_t st = ring + (kt % T::STAGES) * T::STAGE;
    const uint32_t sa = st + wg * 64 * 128;   // this warpgroup's 64 rows
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss_t<BN>(acc, desc_k<T::BM>(sa, kk),
                   desc_mn<BK>(st + T::A_BYTES, kk));
    mma_commit();
    load(kt + T::AHEAD);
    mma_wait<1>();   // the products of kt - 1 are done
  }
  mma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();

  // epilogue: values i, i + 1 are columns col, col + 1 of one row
  const int r_base = m0 + wg * 64;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = r_base + acc_row(i, t), col = n0 + acc_col(i, t);
    if (r >= M) continue;
    float v0 = acc[i], v1 = acc[i + 1];
    if constexpr (EPI < 3) {
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bias + col));
      v0 = decode::activate(v0 + bb.x, EPI);
      v1 = decode::activate(v1 + bb.y, EPI);
    }
    *reinterpret_cast<uint32_t*>(c + (long long)r * N + col) =
        pack2(v0, v1);
  }
}

template <int WGS, int BN, int EPI>
cudaError_t launch(const bf16* a, const bf16* b, const bf16* bias, bf16* c,
                   int M, int N, int K, cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  auto* kernel = ffn_tc_kernel<WGS, BN, EPI>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid(N / BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(a, b, bias, c, M, N, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t product(int wgs, int bn, const bf16* a, const bf16* b,
                    const bf16* bias, bf16* c, int M, int N, int K,
                    cudaStream_t s) {
  if (wgs == 1 && bn == 128) return launch<1, 128, EPI>(a, b, bias, c, M, N, K, s);
  if (wgs == 1 && bn == 256) return launch<1, 256, EPI>(a, b, bias, c, M, N, K, s);
  if (wgs == 2 && bn == 128) return launch<2, 128, EPI>(a, b, bias, c, M, N, K, s);
  return launch<2, 256, EPI>(a, b, bias, c, M, N, K, s);
}

bool tile_ok(int wgs, int bn, int N) {
  return (wgs == 1 || wgs == 2) && (bn == 128 || bn == 256) && N % bn == 0;
}

}  // namespace

// h = round(act(x w1 + b1)), then y = round(h w2); (wgs1, bn1) and (wgs2,
// bn2) the tiles of the two products.  Returns the first launch error; 1
// (cudaErrorInvalidValue) for an unknown activation or tile, a tile width
// that does not divide I or H2, or an H or I that is not a multiple of 64.
extern "C" int fused_ffn_tc(const void* x, const void* w1, const void* b1,
                            const void* w2, void* h, void* y, int n, int H,
                            int I, int H2, int act, int wgs1, int bn1,
                            int wgs2, int bn2, void* stream) {
  if (act < 0 || act > 2 || H % BK || I % BK || !tile_ok(wgs1, bn1, I) ||
      !tile_ok(wgs2, bn2, H2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  bf16* hb = static_cast<bf16*>(h);
  cudaError_t err;
  if (act == 0)
    err = product<0>(wgs1, bn1, xb, w1b, b1b, hb, n, I, H, s);
  else if (act == 1)
    err = product<1>(wgs1, bn1, xb, w1b, b1b, hb, n, I, H, s);
  else
    err = product<2>(wgs1, bn1, xb, w1b, b1b, hb, n, I, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = product<3>(wgs2, bn2, hb, static_cast<const bf16*>(w2), nullptr,
                   static_cast<bf16*>(y), n, H2, I, s);
  return static_cast<int>(err);
}
