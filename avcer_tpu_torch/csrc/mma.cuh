// Tensor-core building blocks shared by the hand-written kernels on
// mma.sync (attention.cu's mha_tc_kernel, conv_tile.cuh's bf16 product):
// ldmatrix loads from shared memory into the fragments of mma.sync
// m16n8k16, and the bf16 x bf16 -> f32 product itself.
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

}  // namespace avcer
