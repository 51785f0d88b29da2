// Tensor-core building blocks shared by the hand-written kernels on
// mma.sync (attention.cu's mha_tc_kernel, conv_tile.cuh's bf16 and int8
// products): ldmatrix loads from shared memory into the fragments of
// mma.sync m16n8k16 (bf16) and m16n8k32 (int8), and the two products.
//
// Fragments, per lane l of a warp: A (16 x 16, row major) in four registers,
// as ldmatrix_x4 gives it when lanes 0-15 address rows 0-15 at column 0 and
// lanes 16-31 rows 0-15 at column 8; B (16 x 8, column major) in two, as
// ldmatrix_x4_trans gives it from a row-major k x n tile when lanes 0-7
// address k rows 0-7 and lanes 8-15 k rows 8-15 at column 0, lanes 16-31 the
// same rows at column 8 (registers 0-1: n columns 0-7, 2-3: columns 8-15);
// D (16 x 8, f32): rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1.

#pragma once

#include <stdint.h>

namespace avcer {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b with a 16x16 bf16 (row major), b 16x8 bf16 (column major), d 16x8
// f32. Lane l holds rows l/4 and l/4 + 8 of a and d, columns 2(l%4) and
// 2(l%4) + 1 of each 8-wide part, the lower column in the lower 16 bits.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a 16x32 int8 (row major), b 32x8 int8 (column major), d 16x8
// int32, exact (no saturation: the callers' sums fit in 31 bits). Lane l
// holds in a[0] row l/4, columns 4(l%4) .. 4(l%4) + 3 (the lowest column in
// the lowest byte), a[1] the same of row l/4 + 8, a[2] and a[3] those of
// columns 16 .. 31: as ldmatrix_x4 gives the four 8 x 16-byte matrices
// (rows 0-7, 8-15 at byte 0, then at byte 16) of a k-contiguous tile. b0:
// column l/4, rows 4(l%4) .. + 3; b1 rows 16 + 4(l%4) .. + 3: as ldmatrix
// (not .trans) gives them from b stored n-major (k contiguous). d as
// mma_bf16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace avcer
