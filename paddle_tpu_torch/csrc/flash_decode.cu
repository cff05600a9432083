// Dense KV-cache decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/ops/pallas_ops.py `_decode_kernel` (reached via
// `flash_decode_arrays` <- `cached_attention_arrays`): one query per row
// (S_q = 1) against the first `length` rows of flat [B, S_max, H*D] cache
// rings, `length` shared by the batch.
//
// What bounds it on this card: memory.  A step reads K and V of the valid
// prefix once, 2 * B * length * H * D * itemsize bytes, and does 4 FLOPs
// per element read, far below the ridge point.  As in the TPU kernel, only
// the valid prefix is read, never all S_max rows.
//
// What the design does about it: split-K.  The keys of each (row, head)
// are cut into `splits` chunks of CHUNK = 128 keys, one block of four
// warps per (chunk, head, row), so B * H * splits blocks keep every SM
// busy (768 at B = 8, H = 12, length 1024, against 132 SMs; one block per
// (head, row) gave 96).  Inside a block each warp takes a run of 32 keys
// (the key loop and merges of `decode_common.cuh`, shared with the fused
// layer and the ragged kernel).
// LPK = D / VE lanes cover one key row with 16-byte loads (VE = 8 bf16 or
// 4 fp32 values each), so a warp reads 32 / LPK whole rows -- whole
// 128-byte lines -- per load, and U = 4 such loads of K and of V are in
// flight before any arithmetic.  Each lane dots its VE values with q, the
// LPK lanes of a key add theirs (shuffles inside the group only), and
// the warp keeps its own online softmax (fp32 m, l and its lanes' share
// of the accumulator); the four warps merge in shared memory.  One split
// writes out directly.  With more, each block writes its fp32 partial (m,
// l, acc[D]) to a scratch buffer, and the last block of its (row, head) to
// finish -- a self-resetting ticket, as in fused_ffn.cu -- merges the
// partials in split order, so the result does not depend on the order in
// which blocks ran.
//
// Rounding points: logits are fp32 sums of q_d * k_d (the TPU kernel rounds
// each product to bf16 before its per-head sum, an artefact of its (8, 128)
// tiling that is not copied).  Each probability exp(s - m) is rounded to
// the cache type before the value product, as the TPU kernel's
// `seg_dot(p, expand)` does, at its warp's running max m (then rescaled in
// fp32); l sums the unrounded fp32 probabilities; out = acc / max(l,
// 1e-30).
//
// Layout: q is [B, 1, H, D] with unit stride in D and stride D between
// heads (the batch stride is an argument, so a slice of a fused qkv
// projection needs no copy; q is read element by element); the rings are
// contiguous [B, S_max, H*D] in q's type, 16-byte aligned; out is a
// contiguous [B, 1, H, D] in q's type.  part holds B * H * splits * (D +
// 2) floats; tickets B * H ints, zero before and after every launch.
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;              // keys per split
constexpr int RUN = CHUNK / WARPS;      // keys per warp
constexpr int U = 4;                    // loads of K (and V) in flight

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, T* __restrict__ out, float* __restrict__ part,
    int* __restrict__ tickets, int H, int S_max, int length, long long qsb,
    float scale) {
  constexpr int LPK = D / VE<T>;        // lanes per key row
  __shared__ SplitSmem<WARPS, D> sh;
  const int split = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int d0 = (lane % LPK) * VE<T>;
  const long long HD = (long long)H * D;
  const long long bh = (long long)b * H + h;

  float qv[VE<T>];
  const T* qp = q + b * qsb + h * D + d0;
#pragma unroll
  for (int i = 0; i < VE<T>; ++i) qv[i] = to_f(qp[i]);

  const long long base = (long long)b * S_max * HD + h * D + d0;
  const RingKeys<T, false> keys{kc + base, vc + base, HD, scale, nullptr};
  const int lo = split * CHUNK;
  float m, l, acc[VE<T>];
  warp_attend<T, D, U, RUN>(keys, qv, lo + warp * RUN,
                            min(lo + CHUNK, length), CHUNK, m, l, acc);
  float bm, bl, ba;
  block_state<T, D, WARPS>(sh, m, l, acc, bm, bl, ba);
  T* op = out + bh * D;
  if (splits == 1) {
    if (tid < D) op[tid] = from_f<T>(ba / fmaxf(bl, 1e-30f));
    return;
  }

  // this split's partial, then the merge in split order by the last block
  float2* ml = reinterpret_cast<float2*>(part) + bh * splits;   // (m, l)
  float* pacc = part + 2LL * gridDim.y * gridDim.z * splits +
                bh * splits * D;                       // acc[D] per split
  float gm, gl, ga;
  if (!merge_splits<D, WARPS>(sh, ml, pacc, tickets + bh, split, splits, bm,
                              bl, ba, gm, gl, ga) ||
      tid >= D)
    return;
  op[tid] = from_f<T>(ga / fmaxf(gl, 1e-30f));
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, void* out,
            void* part, void* tickets, int B, int H, int S_max, int length,
            long long qsb, float scale, cudaStream_t stream) {
  dim3 grid((length + CHUNK - 1) / CHUNK, H, B);
  flash_decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), H, S_max,
      length, qsb, scale);
}

}  // namespace

// The number of splits (blocks per row and head) of a launch at `length`;
// the wrapper sizes `part` with it.
extern "C" int flash_decode_splits(int length) {
  return (length + CHUNK - 1) / CHUNK;
}

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size or type the kernel does not take.
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            void* out, void* part, void* tickets, int B,
                            int H, int D, int S_max, int length, int is_bf16,
                            long long qsb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && is_bf16)
    launch<__nv_bfloat16, 64>(q, kc, vc, out, part, tickets, B, H, S_max,
                              length, qsb, scale, s);
  else if (D == 64)
    launch<float, 64>(q, kc, vc, out, part, tickets, B, H, S_max, length,
                      qsb, scale, s);
  else if (D == 128 && is_bf16)
    launch<__nv_bfloat16, 128>(q, kc, vc, out, part, tickets, B, H, S_max,
                               length, qsb, scale, s);
  else if (D == 128)
    launch<float, 128>(q, kc, vc, out, part, tickets, B, H, S_max, length,
                       qsb, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
