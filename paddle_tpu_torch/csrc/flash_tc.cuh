// Tensor-core machinery shared by the flash kernels (flash_fwd_causal.cu,
// flash_bwd_causal.cu: bf16 and fp16, and split TF32 for fp32 -- the last
// section) and the FFN's bf16 and fp16 products (fused_ffn_tc.cu):
// Hopper's warpgroup matrix multiply (`wgmma.mma_async`, sm_90a) fed from
// 128-byte-swizzled shared memory, asynchronous 16-byte copies into that
// layout, and the helpers that name the (row, column) of each accumulator
// register.
//
// The 16-bit products take their operand type T (`__nv_bfloat16`, the
// default, or `__half`) as a template parameter: `wgmma`'s f16 form,
// m64nNk16.f32.f16.f16, has the bf16 form's shapes, layouts and swizzle,
// so one tile, descriptor and fragment layout serves both.
//
// Shared-memory tiles.  A tile of ROWS rows of D bf16 (D a multiple of
// 64) is stored as D/64 blocks of [ROWS][64]: each 128-byte row of a block
// holds eight 16-byte chunks, chunk c of row r at r*128 + ((c ^ r%8) * 16)
// -- the 128-byte swizzle (CUTLASS's Swizzle<3,4,3>), so that the eight
// rows of a core matrix sit in eight different bank groups.  Every block
// starts on a 1024-byte boundary, as the swizzle's descriptors require.
// The same tile serves as a K-major operand (its rows are M or N, its
// columns the reduction) and as an MN-major B operand (its rows are the
// reduction, its columns N): the A and B of Q K^T and the B of P V read
// one layout, and so do K Q^T, V dO^T, p^T dO and ds^T Q in the backward.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address >> 4 in
// bits 0-13, the leading byte offset >> 4 in 16-29, the stride byte offset
// >> 4 in 32-45, the swizzle mode in 62-63 (1: 128 bytes).  K-major with
// the 128-byte swizzle: the stride byte offset is the step between groups
// of eight rows (1024 bytes); the leading one is unused (set to 16); the
// k-th 16-wide step of the reduction moves the start address by 32 bytes
// inside a block and to the next block every four steps.  MN-major: the
// leading byte offset is the step between 64-wide blocks of N (ROWS *
// 128 bytes), the stride byte offset the step between groups of eight
// reduction rows (1024); the k-th step moves the start by 16 rows (2048
// bytes).
//
// Accumulators (m64nNk16, fp32): thread t of the warpgroup holds N/2
// values; value i is at row 16 (t/32) + (t%32)/4 + 8 ((i/2)%2) and column
// 8 (i/4) + 2 (t%4) + i%2.  The A operand from registers (m64k16 bf16,
// four 32-bit registers) takes the same rows and columns 2 (t%4) + {0, 1}
// and 8 + 2 (t%4) + {0, 1}: the values 8k .. 8k+7 of a 64 x N accumulator,
// packed in pairs, are exactly the A fragment of its k-th 16-wide column
// slice (`pack_a`), so a product's output feeds the next product with no
// shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_tc {

// true for fp16 operands, false for bf16 (the products' operand type)
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

constexpr int WG = 128;   // threads of a warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; zeros when !valid (src is then
// not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy writes to shared memory (cp.async
// included, once waited for) visible to the async proxy that wgmma reads
// through; a barrier must follow before another thread's wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (0 .. D/8 - 1) of row r in a swizzled
// tile of ROWS rows (header comment).
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows row0 .. row0 + ROWS - 1 of a [n, D] matrix of a 2-byte type
// E (row stride `stride` elements, 16-byte aligned rows) into the swizzled
// tile at `dst`; rows at or past n are zero-filled.  All THREADS threads
// call.
template <int ROWS, int D, int THREADS, typename E>
__device__ __forceinline__ void load_tile(uint32_t dst, const E* g,
                                          long long stride, int row0, int n,
                                          int tid) {
  constexpr int CPR = D / 8;   // chunks per row
  static_assert(sizeof(E) == 2, "a 16-byte chunk holds 8 elements");
  static_assert(ROWS * CPR % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CPR, c = e % CPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + swz<ROWS>(r, c),
               g + (ok ? (long long)(row0 + r) * stride : 0) + c * 8, ok);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_field(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return desc_field(addr) | desc_field(lbo) << 16 | desc_field(sbo) << 32 |
         1ull << 62;
}
// The k-th 16-wide reduction step of a K-major tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int k) {
  return make_desc(tile + (k >> 2) * (ROWS * 128) + (k & 3) * 32, 16, 1024);
}
// The k-th 16-row reduction step of an MN-major tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k) {
  return make_desc(tile + k * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (which it cannot see writing the registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory (K-major); TY the
// operand type's name in the instruction.
#define FLASH_TC_MMA_SS_N64(TY)                                              \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, "                                                \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(accumulate))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_SS_N64("f16");
  else
    FLASH_TC_MMA_SS_N64("bf16");
}
#undef FLASH_TC_MMA_SS_N64

// d (+)= A B, m64n32k16, A and B from shared memory (K-major): S = Q K^T
// of the forward at D = 256, whose key tiles are 32 keys.
#define FLASH_TC_MMA_SS_N32(TY)                                              \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15}, "                                                               \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                        \
      :                                                                      \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                   \
      : "l"(da), "l"(db), "r"(accumulate))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_SS_N32("f16");
  else
    FLASH_TC_MMA_SS_N32("bf16");
}
#undef FLASH_TC_MMA_SS_N32

// d (+)= A B with N = 32 or 64 (the key tiles), both K-major from shared
// memory, operands of type T.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_nk(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64, "a key tile of 32 or 64");
  if constexpr (N == 32)
    mma_ss_n32<T>(d, da, db, accumulate);
  else
    mma_ss_n64<T>(d, da, db, accumulate);
}

// d += A B, m64n64k16, A from registers (four packed pairs of T), B from
// shared memory, MN-major (imm-trans-b = 1).
#define FLASH_TC_MMA_RS_N64(TY)                                              \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, "                                                \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_RS_N64("f16");
  else
    FLASH_TC_MMA_RS_N64("bf16");
}
#undef FLASH_TC_MMA_RS_N64

// d += A B, m64n128k16, A from registers (four packed pairs of T), B from
// shared memory, MN-major (imm-trans-b = 1).
#define FLASH_TC_MMA_RS_N128(TY)                                             \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_RS_N128("f16");
  else
    FLASH_TC_MMA_RS_N128("bf16");
}
#undef FLASH_TC_MMA_RS_N128

// d += A B, m64n256k16, A from registers (four packed pairs of T), B from
// shared memory, MN-major (imm-trans-b = 1): the P V product of the
// forward at D = 256.
#define FLASH_TC_MMA_RS_N256(TY)                                             \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "\
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "\
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "\
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "\
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "\
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "\
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"\
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                  \
      :                                                                      \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                  \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                  \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                  \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                  \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                  \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),              \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),              \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),              \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),              \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),              \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),              \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_RS_N256("f16");
  else
    FLASH_TC_MMA_RS_N256("bf16");
}
#undef FLASH_TC_MMA_RS_N256

// d += A B with N = 64, 128 or 256 (the head sizes), operands of type T.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "a head size of the port");
  if constexpr (N == 64)
    mma_rs_n64<T>(d, a, db);
  else if constexpr (N == 128)
    mma_rs_n128<T>(d, a, db);
  else
    mma_rs_n256<T>(d, a, db);
}

// d (+)= A B, m64n128k16, A and B from shared memory, A K-major, B
// MN-major (imm-trans-b = 1); TY the operand type's name in the
// instruction.
#define FLASH_TC_MMA_SS_T_N128(TY)                                                        \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"    \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                               \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                               \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                               \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                               \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                               \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                               \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                               \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                               \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                               \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                               \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                               \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                               \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                \
      : "l"(da), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_t_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_SS_T_N128("f16");
  else
    FLASH_TC_MMA_SS_T_N128("bf16");
}
#undef FLASH_TC_MMA_SS_T_N128

// d (+)= A B, m64n256k16, A and B from shared memory, A K-major, B
// MN-major (imm-trans-b = 1).
#define FLASH_TC_MMA_SS_T_N256(TY)                                                                      \
  asm volatile(                                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "    \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                                 \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                                 \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                               \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                                             \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                             \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                             \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                             \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                                             \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                                             \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                                             \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                                             \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                                             \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                                             \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                                             \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                                             \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                                             \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                                             \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                                             \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                                             \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                                             \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                                             \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                                             \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                                             \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                                             \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                                             \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                                         \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                                         \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                                         \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                                         \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                                         \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                                         \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                                          \
      : "l"(da), "l"(db), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_t_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  if constexpr (is_f16<T>)
    FLASH_TC_MMA_SS_T_N256("f16");
  else
    FLASH_TC_MMA_SS_T_N256("bf16");
}
#undef FLASH_TC_MMA_SS_T_N256

// d += A B with N = 128 or 256, both operands from shared memory, of type
// T (the FFN's products, fused_ffn_tc.cu).
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_ss_t(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 128)
    mma_ss_t_n128<T>(d, da, db);
  else
    mma_ss_t_n256<T>(d, da, db);
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

// Row (0..63) and column of accumulator value i of thread t (header).
__device__ __forceinline__ int acc_row(int i, int t) {
  return (t / 32) * 16 + (t % 32) / 4 + ((i / 2) % 2) * 8;
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return (i / 4) * 8 + (t % 4) * 2 + (i % 2);
}

// Two floats rounded to T (bf16 or fp16, round to nearest even), lo in the
// low half.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The A fragment (pairs of T) of the k-th 16-wide column slice of a 64 x N
// accumulator.
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int k) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = pack2<T>(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
}

// Two floats rounded to T and stored at p (4-byte aligned): an output pair.
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
}

// Sum of x over the four threads that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// ---------------------------------------------------------------------------
// float32 operands: split TF32 (the float32 flash forward and dK/dV)
// ---------------------------------------------------------------------------
//
// A TF32 `wgmma` (m64nNk8, fp32 accumulators) reads 19 bits of each fp32
// operand (sign, exponent, 10 mantissa bits) and drops the low 13.  An
// fp32 product A B is taken as three of them:
//
//     A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi,   x_hi = rna_tf32(x),
//                                                x_lo = x - x_hi (exact)
//
// (the small terms first).  x_hi has its low 13 bits zero, so the
// hardware reads it as it is; it truncates x_lo to 11 significant bits,
// and A_lo B_lo (~2^-22 of |A||B|) is left out: the sum is as close to
// the exact product as an fp32 product with fp32 sums is
// (tests/test_torch_port_tf32.py), where one pass of raw operands keeps
// ~3 decimal digits.
//
// For .tf32 `wgmma` takes A and B from shared memory only K-major (the
// transpose bits exist for f16 / bf16 alone).  An fp32 tile of ROWS rows of
// D floats uses the same 128-byte-swizzled layout and descriptors as a bf16
// tile of 2D columns: `load_tile_f32`, `desc_k` (a k-step of 8 fp32 is 32
// bytes, as a k-step of 16 bf16 is).  A B operand whose reduction runs
// along the rows of its source (V in P V; dO and Q in P^T dO and dS^T Q)
// is written transposed by the threads (`transpose_split`).
//
// The A fragment from registers (m64k8 tf32, four 32-bit registers) holds
// rows 16 (t/32) + (t%32)/4 + {0, 8} and columns t%4 and t%4 + 4 of each
// 8-wide slice, while an accumulator holds columns 2 (t%4) + {0, 1}: the
// values 4k .. 4k+3 of a 64 x N accumulator, taken in the order 4k, 4k+2,
// 4k+1, 4k+3, are the A fragment of its k-th 8-wide slice with the
// columns of the slice permuted (`tf32_a`).  The B tile matches it: within
// each group of 8 reduction indices, position p holds index 2p (p < 4) or
// 2 (p - 4) + 1, which `transpose_split` writes.  The sum over the
// reduction does not depend on its order beyond fp32 rounding.

// x rounded to TF32, ties away from zero (`cvt.rna.tf32.f32`), as the bits
// of an fp32 value whose low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// threadIdx.x read afresh where it is called, so that the compiler
// recomputes what derives from it inside a loop instead of keeping it in
// registers across the loop (addresses of a tile's tasks: the kernels
// that call this are short of registers).
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// fp32 words of shared memory by their shared-window address.
__device__ __forceinline__ float lds32(uint32_t a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(a) : "memory");
  return x;
}
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}
__device__ __forceinline__ void sts128(uint32_t a, float4 x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// hi and lo of four values: hi = tf32_rna(x), lo = x - hi.
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                   tf32_rna(x.w));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// Copy rows row0 .. row0 + ROWS - 1 of a [n, D] fp32 matrix (row stride
// `stride` elements, 16-byte aligned rows) into the swizzled tile at `dst`
// (the layout of a bf16 tile of 2D columns); rows at or past n are
// zero-filled.  All THREADS threads call.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* g,
                                              long long stride, int row0,
                                              int n, int tid) {
  load_tile<ROWS, 2 * D, THREADS>(
      dst, reinterpret_cast<const __nv_bfloat16*>(g), 2 * stride, row0, n,
      tid);
}

// Split the BYTES-byte fp32 tile at `src` into hi and lo tiles of the
// same layout (any layout: the split is per element; hi may be src).
template <int BYTES, int THREADS>
__device__ __forceinline__ void split_tile(uint32_t src, uint32_t hi,
                                           uint32_t lo, int tid) {
  static_assert(BYTES % (16 * THREADS) == 0, "tile must split evenly");
#pragma unroll 4
  for (int off = 16 * tid; off < BYTES; off += 16 * THREADS) {
    float4 h, l;
    split4(lds128(src + off), h, l);
    sts128(hi + off, h);
    sts128(lo + off, l);
  }
}

// Transposing an [R, C] fp32 tile (swizzled, R rows) into [C, R] hi and lo
// tiles (swizzled, C rows), the R index permuted within each group of 8 as
// the A fragment needs (header), in two halves, so that the transpose may
// overwrite its source between them.  A task is one column c and one
// group of 8 rows: eight 4-byte reads (the 32 lanes of a warp read 32
// columns of one row: no bank conflict), four 16-byte writes (eight lanes
// write one chunk of eight rows: none either).  A thread holds NT tasks.
template <int R, int C, int THREADS>
constexpr int transpose_tasks = C * (R / 8) / THREADS;

// Read this thread's tasks of the tile at `a`, plus the tile at `b` when
// SUM (hi + lo gives back the split value exactly).
template <int R, int C, int THREADS, bool SUM, int NT>
__device__ __forceinline__ void transpose_read(uint32_t a, uint32_t b,
                                               float (&x)[NT][8], int tid) {
  static_assert(C * (R / 8) == NT * THREADS, "tile must split evenly");
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int task = tid + t * THREADS, c = task % C, g = task / C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = swz<R>(8 * g + j, c / 4) + (c % 4) * 4;
      x[t][j] = SUM ? lds32(a + off) + lds32(b + off) : lds32(a + off);
    }
  }
}

// Write this thread's tasks, split, as the transposed hi and lo tiles.
template <int R, int C, int THREADS, int NT>
__device__ __forceinline__ void transpose_write(const float (&x)[NT][8],
                                                uint32_t hi, uint32_t lo,
                                                int tid) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int task = tid + t * THREADS, c = task % C, g = task / C;
    float4 eh, el, oh, ol;
    split4(make_float4(x[t][0], x[t][2], x[t][4], x[t][6]), eh, el);
    split4(make_float4(x[t][1], x[t][3], x[t][5], x[t][7]), oh, ol);
    sts128(hi + swz<C>(c, 2 * g), eh);
    sts128(hi + swz<C>(c, 2 * g + 1), oh);
    sts128(lo + swz<C>(c, 2 * g), el);
    sts128(lo + swz<C>(c, 2 * g + 1), ol);
  }
}

// The [R, C] tile at `raw` as its transposed hi and lo tiles, elsewhere.
template <int R, int C, int THREADS>
__device__ __forceinline__ void transpose_split(uint32_t raw, uint32_t hi,
                                                uint32_t lo, int tid) {
  float x[transpose_tasks<R, C, THREADS>][8];
  transpose_read<R, C, THREADS, false>(raw, raw, x, tid);
  transpose_write<R, C, THREADS>(x, hi, lo, tid);
}

// Keep the compiler from computing A fragments after the products that
// read them have been issued, or reusing their registers before the
// products are done (it cannot see `wgmma` read them asynchronously):
// called before `mma_fence` and after `mma_wait`.
template <int M>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// hi and lo A fragments of the k-th 8-wide column slice of a 64 x N
// accumulator, its columns permuted (header).
template <int N>
__device__ __forceinline__ void tf32_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&d)[N], int k) {
  const float x[4] = {d[4 * k], d[4 * k + 2], d[4 * k + 1], d[4 * k + 3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float h = tf32_rna(x[j]);
    hi[j] = __float_as_uint(h);
    lo[j] = __float_as_uint(x[j] - h);
  }
}

// d += A B, m64n32k8 tf32, A and B from shared memory (K-major).
__device__ __forceinline__ void mma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k8 tf32, A and B from shared memory (K-major).
__device__ __forceinline__ void mma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k8 tf32, A from registers (the tf32 fragment: `tf32_a`),
// B from shared memory (K-major).
__device__ __forceinline__ void mma_tf32_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k8 tf32, A from registers (the tf32 fragment: `tf32_a`),
// B from shared memory (K-major).
__device__ __forceinline__ void mma_tf32_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, both from shared memory, N = 32 or 64.
template <int N>
__device__ __forceinline__ void mma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                            uint64_t db) {
  if constexpr (N == 32)
    mma_tf32_ss_n32(d, da, db);
  else
    mma_tf32_ss_n64(d, da, db);
}

// d += A B, A from registers, N = 64 or 128.
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (N == 64)
    mma_tf32_rs_n64(d, a, db);
  else
    mma_tf32_rs_n128(d, a, db);
}

}  // namespace flash_tc
