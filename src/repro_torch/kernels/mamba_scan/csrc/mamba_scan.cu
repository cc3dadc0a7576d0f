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
// dt and x are [B, S, di] (f32 or bf16); Bm and Cm [B, S, MAX_STATE] f32
// (the wrapper widens them and pads ds up with zeros); A is [di, ds] f32
// (-exp(A_log)), D [di] f32, h0 and hT [B, di, ds] f32, y [B, S, di]
// f32.  Any S >= 0, any di (the last block's channels are masked), ds
// from 1 to MAX_STATE.
//
// What bounds it on the card: the exponentials and the instructions
// around them.  One exp a state and step (B S di ds of them: 1.07 G at
// jamba's prefill, B 4, S 2,048, di 8,192, ds 16) takes 0.26 ms on the
// SFUs alone (16 a clock an SM on an H100); each also needs two products
// and two fused multiply-adds on the f32 pipe.  The bytes (dt and x read
// once, y written once: about 540 MB in bf16) take about 0.16 ms at
// 3.35 TB/s.  There is no product to put on the tensor cores.
//
// The design:
// - LANES (2) lanes of a warp own one channel (b, d), each lane
//   MAX_STATE / LANES of its states in registers, so a block of CHANNELS
//   channels is CHANNELS * LANES threads.  A * log2(e) is kept in
//   registers too, so each state's decay is one exp2 of dt * A2[s].
// - The decay is one SFU instruction, ex2.approx.ftz.f32 (exp2f wraps it
//   in a range test and two products for results below 2^-126; here such
//   a decay flushes to 0, which changes h by less than 2^-126 |h|).
// - The steps are staged into shared memory in chunks of STEPS by
//   cp.async, double-buffered, so that loading chunk c + 1 overlaps the
//   walk of chunk c: dt and x as [STEPS][CHANNELS] tiles, Bm and Cm as
//   [STEPS][MAX_STATE] f32 rows that every lane reads with 16-byte loads
//   (the wrapper converts each row once, so no lane converts).
// - The walk takes two steps an iteration, so that one step's decays
//   are in flight while the other's fused multiply-adds finish; y's sum over a
//   lane's states runs in two interleaved chains, and the two lanes' sums
//   meet by __shfl_xor_sync.  Lane 0 of a channel writes the first step
//   of a pair and lane 1 the second: a warp's store covers whole 32-byte
//   sectors of y.
// - State slots s >= ds are zero in Bm, Cm and A, so they decay by
//   exp2(0) = 1 exactly from a zero state and add nothing: the step has
//   no branch on ds.
//
// What the card showed (PERF.md §6, row 8): this design runs at about
// 0.56 of the SFU bound.  One, two or four lanes a channel, Bm and Cm
// staged in bf16 (half the loads, a conversion in every lane) and part
// of the decays on the f32 pipe (a Cody-Waite reduction and a degree-6
// polynomial) were each measured slower at jamba's prefill.
//
// Under grad the wrapper passes `hs`, and the kernel also stores each
// channel's state before every KEEP_EVERY-th step, [B, ceil(S /
// KEEP_EVERY), di, MAX_STATE] f32: the states the backward
// (mamba_scan_bwd.cu) starts its chunks from, so that it recomputes no
// boundary state.  A lane stores its SPL states with two 16-byte stores
// at the first step of a chunk; KEEP_EVERY divides STEPS and is even, so
// that step is the first of a pair or an odd last step.  Without `hs`
// (the serving path) the kernel is the instance that stores nothing.
//
// Rounding: dt * x is rounded before it scales Bm, as in the reference;
// the state update is one fused multiply-add a * h + b.  y's sum: in a
// lane, state slot j goes into chain j mod 2 by a fused multiply-add, in
// ascending j; the chains are added 0 + 1; the two lanes' sums by
// __shfl_xor_sync (both lanes of a channel get the same bits); then
// D * x is added.
// The reference's associative scan groups the products of the decays in
// another order, so h and y differ from it by f32 rounding of their
// terms (ops.TOL, held against the sum of the terms' magnitudes).  The
// order is fixed: a relaunch is bit for bit the same.  ex2.approx.ftz
// is within 2 ulp of 2^x where 2^x >= 2^-126 (the PTX manual's bound),
// 0 below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_STATE 16  // the largest ds; smaller ones are zero-padded
#define CHANNELS 128  // channels a block, LANES lanes each
#define STEPS 32      // steps a staged chunk
#define LANES 2       // lanes a channel
#define KEEP_EVERY 16 // steps between the states kept for the backward

constexpr int SPL = MAX_STATE / LANES;  // states a lane
static_assert(LANES == 2 && SPL % 4 == 0,
              "meet() and the stores of a step pair take two lanes a "
              "channel; a lane takes whole 16-byte loads of the rows");
static_assert(STEPS % KEEP_EVERY == 0 && KEEP_EVERY % 2 == 0,
              "a kept state falls on the first step of a pair or on an odd "
              "last step of a staged chunk");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 2^x on the SFU: one MUFU.EX2, results below 2^-126 flushed to 0.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
// width 0, element by element with plain loads and stores; `nt` threads.
template <typename Elt>
__device__ __forceinline__ void copy_rows(char* dst, long long dst_stride,
                                          const char* src,
                                          long long src_stride, int rows,
                                          int bytes, int width, int tid,
                                          int nt) {
  const int w = width > 0 ? width : (int)sizeof(Elt);
  const int per = bytes / w, total = rows * per;
  for (int idx = tid; idx < total; idx += nt) {
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

// Elements of one staged buffer: dt and x [STEPS][CHANNELS] of the
// input's type Elt, then Bm and Cm [STEPS][MAX_STATE] in f32.
constexpr int TILE = STEPS * CHANNELS, ROWS = STEPS * MAX_STATE;

template <typename Elt>
__host__ __device__ constexpr size_t buf_bytes() {
  return (size_t)2 * TILE * sizeof(Elt) + (size_t)2 * ROWS * sizeof(float);
}
template <typename Elt>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * buf_bytes<Elt>();
}

// The widest copy (16, 4 or 0: element by element) that a row of `bytes`
// bytes takes when rows of at most `width` bytes would do.
__device__ __forceinline__ int row_width(int width, int bytes) {
  if (width == 16 && bytes % 16 != 0) width = 4;
  if (width == 4 && bytes % 4 != 0) width = 0;
  return width;
}

// N consecutive f32 values from p (N a multiple of 4, p 16-byte
// aligned), by 16-byte loads.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = v.x, out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
  }
}

// One lane's part of step cc: its SPL states decayed and updated, and its
// share of y's sum (the two lanes' shares not yet met).
template <typename Elt>
__device__ __forceinline__ float lane_step(const Elt* buf, int cc, int ch,
                                           int g, const float* a2, float* h,
                                           float& xv) {
  const float dtv = to_f32(buf[cc * CHANNELS + ch]);
  xv = to_f32(buf[TILE + cc * CHANNELS + ch]);
  const float* rows = reinterpret_cast<const float*>(buf + 2 * TILE);
  float bs[SPL], cs[SPL];
  load_row<SPL>(rows + cc * MAX_STATE + g * SPL, bs);
  load_row<SPL>(rows + ROWS + cc * MAX_STATE + g * SPL, cs);
  const float dx = __fmul_rn(dtv, xv);
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const float a = exp2_sfu(__fmul_rn(dtv, a2[j]));
    h[j] = __fmaf_rn(a, h[j], __fmul_rn(dx, bs[j]));
    acc[j % 2] = __fmaf_rn(h[j], cs[j], acc[j % 2]);
  }
  return __fadd_rn(acc[0], acc[1]);
}

// The two lanes' shares met: both lanes of the channel get the same bits.
__device__ __forceinline__ float meet(float v) {
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

// This lane's SPL states, the state before step t (t a multiple of
// KEEP_EVERY), into hs [B, nk, di, MAX_STATE].
__device__ __forceinline__ void keep_state(float* __restrict__ hs,
                                           const float* h, int b, int t,
                                           int nk, int d, int di, int g) {
  float4* p = reinterpret_cast<float4*>(
      hs + (((long long)b * nk + t / KEEP_EVERY) * di + d) * MAX_STATE +
      g * SPL);
#pragma unroll
  for (int q = 0; q < SPL / 4; ++q)
    p[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
}

template <typename Elt, bool Keep>
__global__ void __launch_bounds__(CHANNELS * LANES)
mamba_scan_kernel(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, float* __restrict__ hs, int S,
                  int di, int ds, int in_width) {
  constexpr int NT = CHANNELS * LANES;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, b = blockIdx.y;
  const int ch = tid / LANES, g = tid % LANES;  // this lane's channel, part
  const int d0 = blockIdx.x * CHANNELS, d = d0 + ch;
  const int nch = min(CHANNELS, di - d0);
  const bool live = ch < nch;
  const int esz = (int)sizeof(Elt), rsz = (int)sizeof(float);
  const int tile_width = row_width(in_width, nch * esz);
  const long long row0 = (long long)b * S;  // (b, t = 0)

  // chunk c's steps into buffer c % 2 (channels past di are left
  // unwritten: only lanes that store nothing read them)
  auto stage = [&](int c) {
    const int t0 = c * STEPS, n = min(STEPS, S - t0);
    char* const buf =
        reinterpret_cast<char*>(smem) + (c & 1) * buf_bytes<Elt>();
    const Elt* const tiles[2] = {dt, x};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      copy_rows<Elt>(buf + a * TILE * esz, CHANNELS * esz,
                     reinterpret_cast<const char*>(
                         tiles[a] + (row0 + t0) * di + d0),
                     (long long)di * esz, n, nch * esz, tile_width, tid, NT);
    const float* const rows[2] = {Bm, Cm};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      copy_rows<float>(buf + 2 * TILE * esz + a * ROWS * rsz,
                       MAX_STATE * rsz,
                       reinterpret_cast<const char*>(
                           rows[a] + (row0 + t0) * MAX_STATE),
                       MAX_STATE * rsz, n, MAX_STATE * rsz, 16, tid, NT);
  };

  const int nc = (S + STEPS - 1) / STEPS;
  const int nk = (S + KEEP_EVERY - 1) / KEEP_EVERY;  // kept states a row
  if (nc > 0) stage(0);
  cp_async_commit();
  if (nc > 1) stage(1);
  cp_async_commit();

  constexpr float LOG2E = 1.4426950408889634f;
  float h[SPL], a2[SPL];
  const long long hd = ((long long)b * di + d) * ds;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = g * SPL + j;
    const bool on = live && s < ds;
    a2[j] = on ? A[(long long)d * ds + s] * LOG2E : 0.0f;
    h[j] = on ? h0[hd + s] : 0.0f;
  }
  const float dskip = live ? D[d] : 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * STEPS, n = min(STEPS, S - t0);
    // chunk c has landed (chunk c + 1 may still be in flight)
    cp_async_wait<1>();
    __syncthreads();
    const Elt* const buf = reinterpret_cast<const Elt*>(
        reinterpret_cast<const char*>(smem) + (c & 1) * buf_bytes<Elt>());
    float* const yp = y + (row0 + t0) * di + d;
    int cc = 0;
    for (; cc + 1 < n; cc += 2) {
      if (Keep && live && cc % KEEP_EVERY == 0)
        keep_state(hs, h, b, t0 + cc, nk, d, di, g);
      float x0, x1;
      const float s0 = lane_step(buf, cc, ch, g, a2, h, x0);
      const float s1 = lane_step(buf, cc + 1, ch, g, a2, h, x1);
      const float y0 = __fadd_rn(meet(s0), __fmul_rn(dskip, x0));
      const float y1 = __fadd_rn(meet(s1), __fmul_rn(dskip, x1));
      if (live && g == 0) yp[(long long)cc * di] = y0;
      if (live && g == LANES - 1) yp[(long long)(cc + 1) * di] = y1;
    }
    if (cc < n) {  // an odd last step
      if (Keep && live && cc % KEEP_EVERY == 0)
        keep_state(hs, h, b, t0 + cc, nk, d, di, g);
      float x0;
      const float s0 = lane_step(buf, cc, ch, g, a2, h, x0);
      const float y0 = __fadd_rn(meet(s0), __fmul_rn(dskip, x0));
      if (live && g == 0) yp[(long long)cc * di] = y0;
    }
    __syncthreads();  // every lane is done with buffer c % 2
    if (c + 2 < nc) stage(c + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (live)
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (g * SPL + j < ds) hT[hd + g * SPL + j] = h[j];
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Elt, bool Keep>
static int launch(const void* dt, const void* x, const void* Bm,
                  const void* Cm, const float* A, const float* D,
                  const float* h0, float* y, float* hT, float* hs, int B,
                  int S, int di, int ds, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elt>();
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<Elt, Keep>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  mamba_scan_kernel<Elt, Keep><<<grid, CHANNELS * LANES, smem, stream>>>(
      static_cast<const Elt*>(dt), static_cast<const Elt*>(x),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), A, D, h0,
      y, hT, hs, S, di, ds, in_width);
  return (int)cudaGetLastError();
}

// The kernel's constants, which the Python wrapper checks against its own.
extern "C" int mamba_scan_max_state() { return MAX_STATE; }
extern "C" int mamba_scan_channels() { return CHANNELS; }
extern "C" int mamba_scan_steps() { return STEPS; }
extern "C" int mamba_scan_lanes() { return LANES; }
extern "C" int mamba_scan_keep_every() { return KEEP_EVERY; }

// dt, x: [B, S, di], device pointers of elem_bytes (4: f32, 2: bf16)
// elements; Bm, Cm: [B, S, MAX_STATE] f32, zero past ds, 16-byte
// aligned.  A [di, ds], D [di], h0 and hT [B, di, ds], y [B, S, di]:
// f32.  hs: null, or [B, ceil(S / KEEP_EVERY), di, MAX_STATE] f32,
// 16-byte aligned, for the states before every KEEP_EVERY-th step (zero
// past ds).  All contiguous.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int mamba_scan(const void* dt, const void* x, const void* Bm,
                          const void* Cm, const void* A, const void* D,
                          const void* h0, void* y, void* hT, void* hs, int B,
                          int S, int di, int ds, int elem_bytes,
                          void* stream) {
  if (B < 1 || B > 65535 || S < 0 || di < 1 || ds < 1 || ds > MAX_STATE ||
      !aligned(Bm, 16) || !aligned(Cm, 16) || !aligned(hs, 16) ||
      (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hTf = static_cast<float*>(hT);
  float* hsf = static_cast<float*>(hs);
  if (elem_bytes == 4)
    return hs ? launch<float, true>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf, hsf,
                                    B, S, di, ds, s)
              : launch<float, false>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf,
                                     hsf, B, S, di, ds, s);
  return hs ? launch<__nv_bfloat16, true>(dt, x, Bm, Cm, Af, Df, h0f, yf, hTf,
                                          hsf, B, S, di, ds, s)
            : launch<__nv_bfloat16, false>(dt, x, Bm, Cm, Af, Df, h0f, yf,
                                           hTf, hsf, B, S, di, ds, s);
}
