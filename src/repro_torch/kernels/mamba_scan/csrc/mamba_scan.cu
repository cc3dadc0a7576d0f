// Mamba selective scan on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes this scan in jnp, in
// its Mamba mixer (src/repro/models/blocks.py:538-588, mamba_seq: an
// inclusive lax.associative_scan over chunks of 64 steps inside a
// lax.scan), and the port's plain version (ref.py) does the same.  Plain
// PyTorch at jamba's width is either a loop of one launch per step or
// the chunked form, which writes [B, 64, di, ds] f32 tensors several
// times a chunk; this kernel reads its inputs once and writes y once.
// For each batch b and channel d, over t = 0 .. S-1, with a state h of
// ds values (all arithmetic f32):
//
//   a[s]  = exp(dt[t][d] * A[d][s])
//   h[s]  = a[s] * h[s] + (dt[t][d] * x[t][d]) * Bm[t][s]
//   y[t][d] = sum_s h[s] * Cm[t][s] + D[d] * x[t][d]
//
// dt and x are [B, S, di] (f32 or bf16), Bm and Cm [B, S, MAX_STATE] of
// the same type (the wrapper pads ds up with zeros), A is [di, ds] f32
// (-exp(A_log)), D [di] f32, h0 and hT [B, di, ds] f32, y [B, S, di]
// f32.  Any S >= 0, any di (the last block's channels are masked), ds
// from 1 to MAX_STATE.
//
// What bounds it on the card: the exponentials.  One per state and step
// (B S di ds of them: 1.07 G at jamba's prefill, B 4, S 2,048, di 8,192,
// ds 16) run on the SFUs at 16 a clock an SM, about 0.26 ms on an H100;
// the bytes (dt and x read once, y written once: about 540 MB in bf16)
// take about 0.16 ms at 3.35 TB/s, and the four f32 operations a state
// and step take half the exponentials' time.  There is no product to
// put on the tensor cores.
//
// The design: one thread owns one channel (b, d) and keeps its ds states
// in registers, so each step is ds independent chains; A * log2(e) is
// kept in registers too, so that each state's decay is one exp2f.  A
// block is CHANNELS threads of one batch row.  The steps are staged into
// shared memory in chunks of STEPS by cp.async, double-buffered, so that
// loading chunk c + 1 overlaps the walk of chunk c: dt and x as
// [STEPS][CHANNELS] tiles (each thread reads its own column), Bm and Cm
// as [STEPS][MAX_STATE] rows that every thread of the block reads (a
// broadcast).  State lanes s >= ds are zero in Bm and Cm and in A, so
// they decay by exp2(0) = 1 from a zero state and add nothing: the step
// has no branch on ds.  y is written once a step, coalesced along d.
//
// Rounding: dt * x is rounded before it scales Bm, as in the reference;
// the state update is one fused multiply-add a * h + b; y's sum over s
// runs in ascending s with fused multiply-adds, then D * x is added.
// The reference's associative scan groups the products of the decays in
// another order, so h and y differ from it by f32 rounding of their
// terms (ops.TOL, held against the sum of the terms' magnitudes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_STATE 16  // the largest ds; smaller ones are zero-padded
#define CHANNELS 128  // threads a block: one channel each
#define STEPS 32      // steps a staged chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// MAX_STATE consecutive elements of a shared-memory row, as f32.
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < MAX_STATE; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + q);
    out[q] = v.x;
    out[q + 1] = v.y;
    out[q + 2] = v.z;
    out[q + 3] = v.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int q = 0; q < MAX_STATE; q += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + q);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      out[q + 2 * e] = f.x;
      out[q + 2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy `rows` rows of `bytes` bytes each, from src + row * src_stride to
// dst + row * dst_stride (byte strides), with `width`-byte cp.async
// copies (16 or 4; strides, pointers and `bytes` multiples of it) or,
// width 0, element by element with plain loads and stores.
template <typename Elt>
__device__ __forceinline__ void copy_rows(char* dst, long long dst_stride,
                                          const char* src,
                                          long long src_stride, int rows,
                                          int bytes, int width, int tid) {
  const int w = width > 0 ? width : (int)sizeof(Elt);
  const int per = bytes / w, total = rows * per;
  for (int idx = tid; idx < total; idx += CHANNELS) {
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

// Elements of one staged buffer: dt and x [STEPS][CHANNELS], Bm and Cm
// [STEPS][MAX_STATE].
constexpr int TILE = STEPS * CHANNELS, ROWS = STEPS * MAX_STATE;
constexpr int BUF = 2 * TILE + 2 * ROWS;

template <typename Elt>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * BUF * sizeof(Elt);
}

// The widest copy (16, 4 or 0: element by element) that a row of `bytes`
// bytes takes when rows of at most `width` bytes would do.
__device__ __forceinline__ int row_width(int width, int bytes) {
  if (width == 16 && bytes % 16 != 0) width = 4;
  if (width == 4 && bytes % 4 != 0) width = 0;
  return width;
}

template <typename Elt>
__global__ void __launch_bounds__(CHANNELS)
mamba_scan_kernel(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                  const Elt* __restrict__ Bm, const Elt* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int S, int di, int ds,
                  int in_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  Elt* const in = reinterpret_cast<Elt*>(smem);  // [2][dt, x, Bm, Cm]

  const int tid = threadIdx.x, b = blockIdx.y;
  const int d0 = blockIdx.x * CHANNELS, d = d0 + tid;
  const int nch = min(CHANNELS, di - d0);
  const bool live = tid < nch;
  const int esz = (int)sizeof(Elt);
  const int tile_width = row_width(in_width, nch * esz);
  const long long row0 = (long long)b * S;  // (b, t = 0)

  // chunk c's steps into buffer c % 2 (channels past di are left
  // unwritten: only threads that store nothing read them)
  auto stage = [&](int c) {
    const int t0 = c * STEPS, n = min(STEPS, S - t0);
    Elt* const buf = in + (c & 1) * BUF;
    const Elt* const tiles[2] = {dt, x};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      copy_rows<Elt>(reinterpret_cast<char*>(buf + a * TILE),
                     CHANNELS * esz,
                     reinterpret_cast<const char*>(
                         tiles[a] + (row0 + t0) * di + d0),
                     (long long)di * esz, n, nch * esz, tile_width, tid);
    const Elt* const rows[2] = {Bm, Cm};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      copy_rows<Elt>(reinterpret_cast<char*>(buf + 2 * TILE + a * ROWS),
                     MAX_STATE * esz,
                     reinterpret_cast<const char*>(rows[a] +
                                                   (row0 + t0) * MAX_STATE),
                     MAX_STATE * esz, n, MAX_STATE * esz, 16, tid);
  };

  const int nc = (S + STEPS - 1) / STEPS;
  if (nc > 0) stage(0);
  cp_async_commit();
  if (nc > 1) stage(1);
  cp_async_commit();

  constexpr float LOG2E = 1.4426950408889634f;
  float h[MAX_STATE], a2[MAX_STATE];
  const long long hd = ((long long)b * di + d) * ds;
#pragma unroll
  for (int s = 0; s < MAX_STATE; ++s) {
    const bool on = live && s < ds;
    a2[s] = on ? A[(long long)d * ds + s] * LOG2E : 0.0f;
    h[s] = on ? h0[hd + s] : 0.0f;
  }
  const float dskip = live ? D[d] : 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * STEPS, n = min(STEPS, S - t0);
    // chunk c has landed (chunk c + 1 may still be in flight)
    cp_async_wait<1>();
    __syncthreads();
    const Elt* const buf = in + (c & 1) * BUF;
    float* const yp = y + (row0 + t0) * di + d;
    for (int cc = 0; cc < n; ++cc) {
      const float dtv = to_f32(buf[cc * CHANNELS + tid]);
      const float xv = to_f32(buf[TILE + cc * CHANNELS + tid]);
      float bs[MAX_STATE], cs[MAX_STATE];
      load_row(buf + 2 * TILE + cc * MAX_STATE, bs);
      load_row(buf + 2 * TILE + ROWS + cc * MAX_STATE, cs);
      const float dx = __fmul_rn(dtv, xv);
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < MAX_STATE; ++s) {
        const float a = exp2f(__fmul_rn(dtv, a2[s]));
        h[s] = __fmaf_rn(a, h[s], __fmul_rn(dx, bs[s]));
        acc = __fmaf_rn(h[s], cs[s], acc);
      }
      if (live) yp[(long long)cc * di] = __fadd_rn(acc, __fmul_rn(dskip, xv));
    }
    __syncthreads();  // every thread is done with buffer c % 2
    if (c + 2 < nc) stage(c + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (live)
#pragma unroll
    for (int s = 0; s < MAX_STATE; ++s)
      if (s < ds) hT[hd + s] = h[s];
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Elt>
static int launch(const void* dt, const void* x, const void* Bm,
                  const void* Cm, const float* A, const float* D,
                  const float* h0, float* y, float* hT, int B, int S, int di,
                  int ds, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elt>();
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<Elt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int esz = (int)sizeof(Elt);
  // the copy width of dt and x: 16 bytes where every row and pointer
  // allows it (the kernel narrows the last block's rows further if they
  // need it); Bm and Cm rows of MAX_STATE elements always take 16
  int in_width = 0;
  if (di * esz % 16 == 0 && aligned(dt, 16) && aligned(x, 16))
    in_width = 16;
  else if (di * esz % 4 == 0 && aligned(dt, 4) && aligned(x, 4))
    in_width = 4;
  const dim3 grid((unsigned)((di + CHANNELS - 1) / CHANNELS), (unsigned)B);
  mamba_scan_kernel<Elt><<<grid, CHANNELS, smem, stream>>>(
      static_cast<const Elt*>(dt), static_cast<const Elt*>(x),
      static_cast<const Elt*>(Bm), static_cast<const Elt*>(Cm), A, D, h0, y,
      hT, S, di, ds, in_width);
  return (int)cudaGetLastError();
}

// The kernel's constants, which the Python wrapper checks against its own.
extern "C" int mamba_scan_max_state() { return MAX_STATE; }
extern "C" int mamba_scan_channels() { return CHANNELS; }
extern "C" int mamba_scan_steps() { return STEPS; }

// dt, x: [B, S, di]; Bm, Cm: [B, S, MAX_STATE], zero past ds, 16-byte
// aligned; device pointers of elem_bytes (4: f32, 2: bf16) elements.
// A [di, ds], D [di], h0 and hT [B, di, ds], y [B, S, di]: f32.  All
// contiguous.  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int mamba_scan(const void* dt, const void* x, const void* Bm,
                          const void* Cm, const void* A, const void* D,
                          const void* h0, void* y, void* hT, int B, int S,
                          int di, int ds, int elem_bytes, void* stream) {
  if (B < 1 || B > 65535 || S < 0 || di < 1 || ds < 1 || ds > MAX_STATE ||
      !aligned(Bm, 16) || !aligned(Cm, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hTf = static_cast<float*>(hT);
  if (elem_bytes == 4)
    return launch<float>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf, B, S, di, ds,
                         s);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf, B, S,
                                 di, ds, s);
  return (int)cudaErrorInvalidValue;
}
