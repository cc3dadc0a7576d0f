// f32-accurate products on Hopper's tensor cores (3xTF32 on mma.sync),
// and the cp.async copies that stage their operands, shared by
// fused_mlp/csrc/fused_mlp.cu and flash_attention/csrc/flash_attention.cu.
//
// The split: x = hi + lo with hi = cvt.rna.tf32.f32(x) (round half away
// from zero to 10 mantissa bits) and lo = cvt.rna.tf32.f32(x - hi).
// x - hi is exact in f32, so hi + lo carries x to about 2^-22 relative.
// A product a * b is then formed as
//
//   lo_a * hi_b + hi_a * lo_b + hi_a * hi_b
//
// (lo_a * lo_b, about 2^-22 of the product, is dropped), each term an
// mma.sync.m16n8k8 TF32 product accumulated in f32, the small terms
// first so that they are not lost against the large one.  The tensor
// cores' f32 accumulation truncates (about half an ulp toward zero per
// mma), which a long sum into one accumulator piles up: fused_mlp.cu
// sums each K-step into a fresh partial and adds the partials rounded to
// nearest.  Three TF32 products cost 3 * 2 * m * n * k operations at 495 TFLOP/s, against
// 2 * m * n * k at the 67 TFLOP/s of f32 on the CUDA cores: 4.5x less
// time at the same accuracy (2e-5 for attention, 1e-4 for the MLP).
//
// Fragment layouts of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>

// x rounded to TF32 (the low 13 bits of the result are zero).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b on one m16n8k8 fragment, TF32 inputs, f32 accumulators.
// Not volatile: the compiler may interleave the mma of independent
// accumulators; those of one accumulator stay in order (they depend on
// each other through d).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b on one m16n8k8 fragment (an accumulator starting at zero).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// B fragments of G neighbouring n8 tiles, split: hi[i] and lo[i] hold
// (b0, b1) of tile i.
template <int G>
struct BFrags {
  uint32_t hi[G][2], lo[G][2];
  __device__ __forceinline__ void split(int i, float b0, float b1) {
    tf32_split(b0, hi[i][0], lo[i][0]);
    tf32_split(b1, hi[i][1], lo[i][1]);
  }
  // tile i already split in shared memory: (b0, b1) at hi[0], hi[step]
  __device__ __forceinline__ void load(int i, const uint32_t* h,
                                       const uint32_t* l, int step) {
    hi[i][0] = h[0];
    hi[i][1] = h[step];
    lo[i][0] = l[0];
    lo[i][1] = l[step];
  }
  // bf16 inputs are exact in TF32: lo stays unused
  __device__ __forceinline__ void exact(int i, float b0, float b1) {
    hi[i][0] = __float_as_uint(b0);
    hi[i][1] = __float_as_uint(b1);
  }
};

// d(i) += a * b_i for the G tiles of `b` in 3xTF32 (a = a_hi + a_lo), or
// in 2xTF32 when the b are exact in TF32 (EXACT_B: their lo is zero).
// Each accumulator takes lo.hi, hi.lo, hi.hi in that order; the loops run
// pass by pass so that consecutive mma never share an accumulator.
template <int G, bool EXACT_B, typename Acc>
__device__ __forceinline__ void mma_3xtf32(Acc&& d, const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const BFrags<G>& b) {
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d(i), a_lo, b.hi[i][0], b.hi[i][1]);
  if constexpr (!EXACT_B) {
#pragma unroll
    for (int i = 0; i < G; ++i) mma_tf32(d(i), a_hi, b.lo[i][0], b.lo[i][1]);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d(i), a_hi, b.hi[i][0], b.hi[i][1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 4 tiles of 32-bit words from shared memory, one per register:
// lanes 8i .. 8i + 7 give the 16-byte aligned rows of tile i, and lane l
// receives word (l / 4, l % 4) of each tile -- the B fragment layout of
// mma.m16n8k8 .tf32 for a [n][k] tile (b0 from k 0-3, b1 from k 4-7).
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, asynchronously (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
