// Loads, stores and cp.async copies shared by the WKV recurrence's
// forward (rwkv6_chunk.cu) and backward (rwkv6_chunk_bwd.cu) kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/tf32x3.cuh"

#define MAX_HEAD_DIM 128

// The head tile (32, 64 or 128 lanes) a head of hd lanes is padded to.
__host__ __device__ constexpr int head_tile(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) {
  *p = __float2bfloat16_rn(0.0f);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// Four consecutive elements from shared memory, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// smem_addr, cp_async16, cp_async_commit and cp_async_wait come from
// tf32x3.cuh (the backward's products use its 3xTF32 mma as well).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Copy `rows` rows of `bytes` bytes each, from src + row * src_stride to
// dst + row * dst_stride (byte strides), with `width`-byte cp.async
// copies (16 or 4; both strides and pointers multiples of it) or, width
// 0, element by element with plain loads and stores.
template <typename Elt>
__device__ __forceinline__ void copy_rows(char* dst, long long dst_stride,
                                          const char* src,
                                          long long src_stride, int rows,
                                          int bytes, int width, int tid,
                                          int nthreads) {
  const int w = width > 0 ? width : (int)sizeof(Elt);
  const int per = bytes / w, total = rows * per;
  for (int idx = tid; idx < total; idx += nthreads) {
    const int row = idx / per, q = idx - row * per;
    char* d = dst + row * dst_stride + q * w;
    const char* s = src + row * src_stride + q * w;
    if (width == 16)
      cp_async16(d, s);
    else if (width == 4)
      cp_async4(d, s);
    else
      *reinterpret_cast<Elt*>(d) = *reinterpret_cast<const Elt*>(s);
  }
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
