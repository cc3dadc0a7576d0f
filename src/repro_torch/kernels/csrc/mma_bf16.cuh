// bf16 products on Hopper's tensor cores (mma.sync m16n8k16 with f32
// accumulators) and the fragment loads that feed them, shared by
// flash_attention/csrc/flash_attention_bwd.cu and
// flash_attention/csrc/flash_attention_bf16.cu.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "tf32x3.cuh"

// 2^x by the SFU (ex2.approx: about 2^-22 relative; 2^-inf = 0, and
// results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------ bf16 mma fragments ---
// m16n8k16 bf16 (g = lane / 4, t = lane % 4; each register two bf16, the
// lower column in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                a3 (g + 8, 2t+8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):  the layout of the TF32 mma (tf32x3.cuh)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  ldmatrix_x4(r[0], r[1], r[2], r[3], row);
}

// Four 8 x 8 b16 matrices, each transposed on the way: lane l receives
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix i in
// register i -- the B fragment of m16n8k16 from a [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Two floats rounded to bf16 (to nearest), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
