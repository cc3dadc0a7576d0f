// RWKV6 (Finch) WKV recurrence on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py::rwkv6_chunk (the
// Pallas TPU kernel, pallas_call at l.47, _kernel at l.21).  For each
// (batch b, head h), over t = 0 .. T-1, with S a [hd, hd] state:
//
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * (k_t[i] * v_t[j]))
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r, k, v, w and o are [B, T, H, hd] (f32 or bf16, o in r's type), u is
// [H, hd] f32, s0 and sT are [B, H, hd, hd] f32.  All arithmetic is f32.
//
// What bounds it on the card: bytes (r, k, v, w read once and o written
// once dominate; 4 hd^2 operations per (b, t, h) at the f32 rate take
// about two thirds of the time the bytes take).  But the recurrence is
// serial in t, so what bounds this simple design is latency: each step
// waits on a chain of hd dependent FMAs.
//
// The design: one block per (b, h), hd threads.  Thread j keeps column j
// of S in registers (hd floats): given r, k, w and u, the columns evolve
// independently, so the state never leaves the SM and no thread waits
// on another within a step.  The TPU kernel held the whole [hd, hd] state
// in VMEM and formed k^T v as a matrix at every step; here nothing of
// the state is in shared memory.  The block stages CHUNK time steps of
// r, k, w (packed with u as one float4 per i, read by every thread as a
// broadcast) and of v in shared memory, with coalesced loads (a head's
// hd elements of one step are contiguous), then walks them.  o is written
// straight out, one coalesced row per step, and sT at the end.
//
// Rounding: k*v, u*(k*v), S + u*k*v, w*S and w*S + k*v are each rounded
// as the plain PyTorch version rounds them (__fmul_rn/__fadd_rn, no
// contraction), so sT equals the plain version bit for bit.  Only o's sum
// over i (ascending here, a cuBLAS batched product there) runs in another
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CHUNK 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename Elt, int HD>
__global__ void __launch_bounds__(HD)
rwkv6_chunk_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                   const Elt* __restrict__ v, const Elt* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   Elt* __restrict__ o, float* __restrict__ sT, int T,
                   int H) {
  __shared__ float4 rkwu[CHUNK][HD];  // (r_i, k_i, w_i, u_i) of each step
  __shared__ float vs[CHUNK][HD];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;

  float S[HD];  // column j of the state
  const float* s0p = s0 + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0p[i * HD + j];
  const float uj = u[h * HD + j];
  const long long step = (long long)H * HD;  // elements between two steps
  const long long base = ((long long)b * T * H + h) * HD + j;

  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    const int n = min(CHUNK, T - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const long long off = base + (long long)(t0 + c) * step;
      rkwu[c][j] = make_float4(to_f32(r[off]), to_f32(k[off]),
                               to_f32(w[off]), uj);
      vs[c][j] = to_f32(v[off]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float4 e = rkwu[c][i];
        const float kv = __fmul_rn(e.y, vj);
        acc = __fmaf_rn(e.x, __fadd_rn(S[i], __fmul_rn(e.w, kv)), acc);
        S[i] = __fadd_rn(__fmul_rn(e.z, S[i]), kv);
      }
      store(o + base + (long long)(t0 + c) * step, acc);
    }
  }
  float* sTp = sT + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sTp[i * HD + j] = S[i];
}

template <typename Elt>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* o, float* sT, int B,
                  int T, int H, int hd, cudaStream_t s) {
  const unsigned grid = (unsigned)((long long)B * H);
#define RWKV6_CASE(HD)                                                     \
  case HD:                                                                 \
    rwkv6_chunk_kernel<Elt, HD><<<grid, HD, 0, s>>>(                       \
        static_cast<const Elt*>(r), static_cast<const Elt*>(k),            \
        static_cast<const Elt*>(v), static_cast<const Elt*>(w), u, s0,     \
        static_cast<Elt*>(o), sT, T, H);                                   \
    break;
  switch (hd) {
    RWKV6_CASE(8)
    RWKV6_CASE(16)
    RWKV6_CASE(32)
    RWKV6_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RWKV6_CASE
  return (int)cudaGetLastError();
}

// 1 for each head size the kernel is compiled for, else 0.
extern "C" int rwkv6_chunk_takes_head_dim(int hd) {
  return hd == 8 || hd == 16 || hd == 32 || hd == 64;
}

// r, k, v, w, o: [B, T, H, hd] device pointers of elem_bytes (4: f32,
// 2: bf16) elements; u [H, hd], s0 and sT [B, H, hd, hd]: f32.  All
// contiguous.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int rwkv6_chunk(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* sT, int B, int T, int H, int hd,
                           int elem_bytes, void* stream) {
  if (B < 1 || H < 1 || T < 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (elem_bytes == 4)
    return launch<float>(r, k, v, w, uf, s0f, o, sTf, B, T, H, hd, s);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(r, k, v, w, uf, s0f, o, sTf, B, T, H, hd,
                                 s);
  return (int)cudaErrorInvalidValue;
}
