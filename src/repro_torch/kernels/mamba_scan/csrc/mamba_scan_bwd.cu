// Backward of the Mamba selective scan on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates the jnp scan of
// its Mamba mixer (src/repro/models/blocks.py:538-588, mamba_seq) with
// jax.value_and_grad, and the port's plain backward (ref.py,
// mamba_scan_bwd_ref) computes the same gradient chunk by chunk.  For
// each batch b, channel d and state s, with a_t = exp(dt_t A), u_t = dt_t
// x_t and h_t = a_t h_{t-1} + u_t Bm_t (all arithmetic f32), given y's
// cotangent dy and the final state's dhT:
//
//   g_t   = dy_t Cm_t + a_{t+1} g_{t+1}        (g_{S-1} = dy Cm + dhT)
//   dh0   = a_0 g_0
//   dCm_t = sum_d dy_t h_t          dBm_t = sum_d u_t g_t
//   du_t  = sum_s g_t Bm_t          dx_t  = dt_t du_t + D dy_t
//   q_t   = (a_t g_t) h_{t-1}       ddt_t = x_t du_t + sum_s q_t A
//   dA    = sum_{b,t} q_t dt_t      dD    = sum_{b,t} dy_t x_t
//
// dt, x, ddt and dx are [B, S, di] (f32 or bf16); dy [B, S, di] f32; Bm
// and Cm [B, S, MAX_STATE] f32, and A [di, MAX_STATE], h0, dhT and dh0
// [B, di, MAX_STATE] f32, all zero past ds (the wrapper pads them; a
// padded state has a = exp2(0) = 1 from zero and stays zero); D [di] f32.
// Any S >= 1, any di, ds from 1 to MAX_STATE.
//
// The design: time is cut into chunks of CHUNK steps, so that only S /
// CHUNK steps are serial, in a small chain kernel.
// 1. mamba_bwd_local, a block per (CHANNELS channels, CHUNKS_A_BLOCK
//    chunks, batch), the chunks in turn: each chunk's state at its end
//    from a zero state, the cotangent it sends to the state before it
//    from a zero cotangent after it (a_t0 g_t0 of a reverse walk), and
//    the chunk's sum of dt.  The chunk's decays stay in registers between
//    the two walks: one exp a state and step.
// 2. mamba_bwd_chain, a thread per (batch, channel, state): the states
//    before each chunk, chained forward from h0 by the chunk's decay
//    exp2(A log2(e) sum dt) (one exp a chunk), and the cotangent entering
//    each chunk's last step, chained backward from dhT; it writes both
//    over pass 1's and gives dh0.  A thread loads CHAIN_AHEAD chunks'
//    values before it walks them.
// 3. mamba_bwd_chunks, a block per (CHANNELS channels, CHUNKS_A_BLOCK
//    chunks, batch), the chunks in turn: a chunk's states recomputed from
//    its boundary state, h_{t-1} kept in registers (CHUNK x 4 a lane),
//    then g walked back from the chunk's incoming cotangent with the
//    decays recomputed (two exps a state and step): dx and ddt of each
//    step, and the block's partial sums of dBm and dCm (over its
//    channels, each step), dA and dD (over its chunks).
// 4. mamba_bwd_sum: every partial summed in ascending order of its part
//    (dBm and dCm over the channel blocks, dA and dD over the batch and
//    the chunk groups).  No atomics: a relaunch gives the same bits.
// So three exps a state and step in all, and no per-step state is
// stored (the scratch holds the boundary states and the partials).
// Passes 1 and 3 stage a chunk's inputs (and pass 3 its boundary state
// and cotangent) into shared memory by cp.async, double-buffered, so that
// the next chunk's copies run under this chunk's walks; a copy past S or
// past di is zero-filled (cp.async's source size 0), so that a padded
// step has a = exp2(0) = 1 and no input, and a padded channel stays 0.
//
// Lanes: LANES (4) lanes of a warp own one channel, each SPL (4) of its
// states, so a warp holds 8 channels and a block CHANNELS (64).  du and
// sum_s q A meet over the channel's 4 lanes by two __shfl_xor_sync (a
// transposed reduction: one value a lane a level); the 8 sums a lane
// holds for dBm and dCm (its 4 states each) meet over the warp's 8
// channels in three levels (4, 2, 1 shuffles), after which each of the
// 32 lanes holds one of the warp's 32 sums; the 8 warps' sums are added
// in warp order through shared memory once a chunk.
//
// Budgets: registers, the recomputed states of a chunk (CHUNK x SPL = 64
// a lane) beside the state, cotangent, decays, A and dA (20) and the
// sums (10), within 128 for two blocks of 256 threads an SM: CHUNK 32
// would not fit.  Shared memory of a block of pass 3 (dynamic): two
// buffers of the chunk's dt and x [CHUNK][CHANNELS] in the input's type,
// dy [CHUNK][CHANNELS] and Bm, Cm [CHUNK][MAX_STATE] in f32 (14,336 bytes
// a buffer in f32, 10,240 in bf16) and of its boundary states and
// cotangents [CHANNELS][MAX_STATE] f32 (8,192), the warps' sums
// [CHUNK][8][32] (16,384) and dx, ddt [CHUNK][CHANNELS] (8,192): 69,632
// bytes in f32, 61,440 in bf16; pass 1 takes the two input buffers.
// Scratch (global, f32): the boundary states and cotangents [B, S/CHUNK,
// di, MAX_STATE] each, the chunks' dt sums [B, S/CHUNK, di], the dBm/dCm
// partials [B, S, di/CHANNELS, 32], the dA and dD partials [B, S/(CHUNK
// CHUNKS_A_BLOCK), di, MAX_STATE] and [.., di].
//
// What bounds it on an H100: the operations.  At jamba's training shape
// (B 2, S 2,048, di 8,192, ds 16) the gradient needs at least one exp a
// state and step (5.4e8 on the SFUs, 16 a clock an SM: 0.128 ms) and
// about 17 f32 operations beside it (0.136 ms at the f32 peak), ahead of
// its bytes (0.121 ms in bf16).  This design does three exps a state and
// step, and its chunk pass takes most of its time (PERF.md §6, row 10).
//
// Rounding: every exp is ex2.approx.ftz of dt * fl(A log2 e) (within 2
// ulp where 2^x >= 2^-126, else 0: a decay that underflows is 0, and as
// nothing is divided by a decay, every path then gives the zeros the
// plain backward gives); the chain's decay exp2(fl(A log2 e) sum dt)
// differs from the product of the step decays by rounding.  Sums run in
// the fixed orders above, which differ from the plain backward's
// (ops.TOL_BWD).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_STATE 16       // the largest ds; smaller ones are zero-padded
#define CHUNK 16           // steps a chunk
#define CHANNELS 64        // channels a block, LANES lanes each
#define LANES 4            // lanes a channel
#define CHUNKS_A_BLOCK 4   // chunks a block of passes 1 and 3 takes
#define CHAIN_AHEAD 8      // chunks the chain loads ahead of its walk

constexpr int SPL = MAX_STATE / LANES;  // states a lane
constexpr int NT = CHANNELS * LANES;    // threads a block
constexpr int WARPS = NT / 32;
constexpr int CPW = 32 / LANES;         // channels a warp
constexpr int RED = 2 * MAX_STATE;      // a step's sums: dBm, then dCm
static_assert(SPL == 4 && CPW == 8 && RED == 32 && NT % 32 == 0,
              "the reductions take 4 states a lane, 8 channels a warp");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename Elt>
__device__ __forceinline__ Elt from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^x on the SFU: one MUFU.EX2, results below 2^-126 flushed to 0.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A 4- or 16-byte cp.async, its destination zero-filled and nothing read
// where `on` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One chunk's inputs, zero past S and past di: Bm, Cm and dy in f32, dt
// and x in the input's type.
template <typename Elt>
struct Stage {
  __align__(16) float bm[CHUNK][MAX_STATE];
  __align__(16) float cm[CHUNK][MAX_STATE];
  __align__(16) float dy[CHUNK][CHANNELS];
  __align__(16) Elt dt[CHUNK][CHANNELS];
  __align__(16) Elt x[CHUNK][CHANNELS];
};

// Start the copies of the chunk from step t0 into `st`.  dt and x go by
// 4-byte copies of 4 / sizeof(Elt) channels where `pairs` says every row
// allows them (always in f32; in bf16 an even di and 4-byte aligned
// pointers), else element by element with plain loads and stores.
template <typename Elt>
__device__ __forceinline__ void stage_chunk(
    Stage<Elt>& st, const Elt* __restrict__ dt, const Elt* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ Bm,
    const float* __restrict__ Cm, long long row0, int t0, int S, int d0,
    int di, bool pairs, int tid) {
  for (int i = tid; i < CHUNK * CHANNELS; i += NT) {
    const int tt = i / CHANNELS, cc = i % CHANNELS;
    const int t = t0 + tt, d = d0 + cc;
    const bool on = t < S && d < di;
    cp_async4(&st.dy[tt][cc], dy + (on ? (row0 + t) * di + d : 0), on);
  }
  constexpr int PER = 4 / sizeof(Elt);  // channels a 4-byte copy
  if (PER == 1 || pairs) {
    for (int i = tid; i < CHUNK * CHANNELS / PER; i += NT) {
      const int tt = i / (CHANNELS / PER), cc = i % (CHANNELS / PER) * PER;
      const int t = t0 + tt, d = d0 + cc;
      const bool on = t < S && d < di;  // pairs: di even, so d + 1 < di
      const long long o = on ? (row0 + t) * di + d : 0;
      cp_async4(&st.dt[tt][cc], dt + o, on);
      cp_async4(&st.x[tt][cc], x + o, on);
    }
  } else {
    const Elt zero = from_f32<Elt>(0.0f);
    for (int i = tid; i < CHUNK * CHANNELS; i += NT) {
      const int tt = i / CHANNELS, cc = i % CHANNELS;
      const int t = t0 + tt, d = d0 + cc;
      const bool on = t < S && d < di;
      const long long o = (row0 + t) * di + d;
      st.dt[tt][cc] = on ? dt[o] : zero;
      st.x[tt][cc] = on ? x[o] : zero;
    }
  }
  for (int i = tid; i < CHUNK * MAX_STATE / 4; i += NT) {
    const int tt = i / (MAX_STATE / 4), q = i % (MAX_STATE / 4) * 4;
    const int t = t0 + tt;
    const bool on = t < S;
    const long long o = on ? (row0 + t) * MAX_STATE + q : 0;
    cp_async16(&st.bm[tt][q], Bm + o, on);
    cp_async16(&st.cm[tt][q], Cm + o, on);
  }
}

// Offset of (b, chunk c, channel d, this lane's first state) in a
// [B, nc, di, MAX_STATE] array.
__device__ __forceinline__ long long bound_at(int b, int c, int d, int grp,
                                              int nc, int di) {
  return (((long long)b * nc + c) * di + d) * MAX_STATE + grp * SPL;
}

// Pass 1: each chunk from a zero state and a zero cotangent.
template <typename Elt>
__global__ void __launch_bounds__(NT, 2)
mamba_bwd_local(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                const float* __restrict__ dy, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ A,
                float* __restrict__ HB, float* __restrict__ GC,
                float* __restrict__ DTS, int S, int di, int nc, bool pairs) {
  __shared__ Stage<Elt> st[2];
  const int tid = threadIdx.x, ch = tid / LANES, grp = tid % LANES;
  const int d0 = blockIdx.x * CHANNELS, d = d0 + ch, b = blockIdx.z;
  const int c0 = blockIdx.y * CHUNKS_A_BLOCK;
  const int n = min(CHUNKS_A_BLOCK, nc - c0);
  const bool live = d < di;
  const long long row0 = (long long)b * S;
  float a2[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j)
    a2[j] = live ? A[(long long)d * MAX_STATE + grp * SPL + j] * LOG2E
                 : 0.0f;
  stage_chunk<Elt>(st[0], dt, x, dy, Bm, Cm, row0, c0 * CHUNK, S, d0, di,
                   pairs, tid);
  cp_async_commit();
  for (int k = 0; k < n; ++k) {
    const int c = c0 + k;
    if (k + 1 < n)
      stage_chunk<Elt>(st[(k + 1) & 1], dt, x, dy, Bm, Cm, row0,
                       (c + 1) * CHUNK, S, d0, di, pairs, tid);
    cp_async_commit();
    cp_async_wait<1>();  // chunk k has landed
    __syncthreads();
    const Stage<Elt>& sk = st[k & 1];
    float h[SPL] = {0.0f, 0.0f, 0.0f, 0.0f}, a[CHUNK][SPL], dts = 0.0f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float dtv = to_f32(sk.dt[t][ch]);
      const float u = __fmul_rn(dtv, to_f32(sk.x[t][ch]));
      float bs[SPL];
      load4(&sk.bm[t][grp * SPL], bs);
      dts = __fadd_rn(dts, dtv);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        a[t][j] = exp2_sfu(__fmul_rn(dtv, a2[j]));
        h[j] = __fmaf_rn(a[t][j], h[j], __fmul_rn(u, bs[j]));
      }
    }
    // gg: a_{t+1} g_{t+1} before step t, a_t g_t after it
    float gg[SPL] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = CHUNK - 1; t >= 0; --t) {
      const float dyv = sk.dy[t][ch];
      float cs[SPL];
      load4(&sk.cm[t][grp * SPL], cs);
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        gg[j] = __fmul_rn(a[t][j], __fmaf_rn(dyv, cs[j], gg[j]));
    }
    if (live) {
      const long long o = bound_at(b, c, d, grp, nc, di);
      store4(HB + o, h);
      store4(GC + o, gg);
      if (grp == 0) DTS[((long long)b * nc + c) * di + d] = dts;
    }
    __syncthreads();  // every lane is done with buffer k % 2
  }
}

// Pass 2: the chains across chunks, in place.  HB[c] becomes the state
// before chunk c and GC[c] the cotangent entering chunk c's last step
// from the steps after it.  A thread loads CHAIN_AHEAD chunks' values
// before it walks them, so that many loads are in flight.
template <bool Back>
__device__ __forceinline__ float chain(float* __restrict__ X,
                                       const float* __restrict__ DTS,
                                       float v, float a2, int b, int d,
                                       int s, int di, int nc) {
  for (int n0 = 0; n0 < nc; n0 += CHAIN_AHEAD) {
    float e[CHAIN_AHEAD], p[CHAIN_AHEAD];
#pragma unroll
    for (int k = 0; k < CHAIN_AHEAD; ++k) {
      const int c = Back ? nc - 1 - (n0 + k) : n0 + k;
      if (n0 + k < nc) {
        const long long bc = (long long)b * nc + c;
        e[k] = X[(bc * di + d) * MAX_STATE + s];
        p[k] = DTS[bc * di + d];
      }
    }
#pragma unroll
    for (int k = 0; k < CHAIN_AHEAD; ++k) {
      const int c = Back ? nc - 1 - (n0 + k) : n0 + k;
      if (n0 + k < nc) {
        X[(((long long)b * nc + c) * di + d) * MAX_STATE + s] = v;
        v = __fmaf_rn(exp2_sfu(__fmul_rn(p[k], a2)), v, e[k]);
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(256)
mamba_bwd_chain(const float* __restrict__ A, const float* __restrict__ h0,
                const float* __restrict__ dhT, float* __restrict__ HB,
                float* __restrict__ GC, const float* __restrict__ DTS,
                float* __restrict__ dh0, int B, int di, int nc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * di * MAX_STATE) return;
  const int s = (int)(i % MAX_STATE);
  const long long bd = i / MAX_STATE;
  const int d = (int)(bd % di), b = (int)(bd / di);
  const float a2 = A[(long long)d * MAX_STATE + s] * LOG2E;
  chain<false>(HB, DTS, h0[i], a2, b, d, s, di, nc);
  dh0[i] = chain<true>(GC, DTS, dhT[i], a2, b, d, s, di, nc);
}

// Pass 3: every chunk from its boundary state and incoming cotangent.
template <typename Elt>
struct ChunkSmem {
  Stage<Elt> st[2];
  __align__(16) float hb[2][CHANNELS][MAX_STATE];  // state before the chunk
  __align__(16) float gc[2][CHANNELS][MAX_STATE];  // cotangent entering it
  float red[CHUNK][WARPS][RED];
  float out_dx[CHUNK][CHANNELS], out_ddt[CHUNK][CHANNELS];
};

template <typename Elt>
__global__ void __launch_bounds__(NT, 2)
mamba_bwd_chunks(const Elt* __restrict__ dt, const Elt* __restrict__ x,
                 const float* __restrict__ dy, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ A,
                 const float* __restrict__ D, const float* __restrict__ HB,
                 const float* __restrict__ GC, Elt* __restrict__ ddt,
                 Elt* __restrict__ dx, float* __restrict__ BC_part,
                 float* __restrict__ A_part, float* __restrict__ D_part,
                 int S, int di, int nc, bool pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<Elt>& sm = *reinterpret_cast<ChunkSmem<Elt>*>(smem_raw);
  const int tid = threadIdx.x, ch = tid / LANES, grp = tid % LANES;
  const int warp = tid / 32, lane = tid % 32, c8 = lane / LANES;
  const int d0 = blockIdx.x * CHANNELS, d = d0 + ch;
  const int cg = blockIdx.y, b = blockIdx.z, ndb = gridDim.x;
  const int ng = gridDim.y, c0 = cg * CHUNKS_A_BLOCK;
  const int n = min(CHUNKS_A_BLOCK, nc - c0);
  const bool live = d < di;
  const long long row0 = (long long)b * S;
  // the slot of the warp's sums this lane ends up holding (see meet8)
  const int slot = (c8 >> 2) * MAX_STATE + grp * SPL + (c8 & 3);

  // chunk c's inputs, boundary state and cotangent into buffer `buf`
  auto stage = [&](int c, int buf) {
    stage_chunk<Elt>(sm.st[buf], dt, x, dy, Bm, Cm, row0, c * CHUNK, S, d0,
                     di, pairs, tid);
    for (int i = tid; i < CHANNELS * MAX_STATE / 4; i += NT) {
      const int cc = i / (MAX_STATE / 4), q = i % (MAX_STATE / 4) * 4;
      const bool on = d0 + cc < di;
      const long long o = on ? bound_at(b, c, d0 + cc, 0, nc, di) + q : 0;
      cp_async16(&sm.hb[buf][cc][q], HB + o, on);
      cp_async16(&sm.gc[buf][cc][q], GC + o, on);
    }
  };

  float a2[SPL], Av[SPL], dA[SPL] = {0.0f, 0.0f, 0.0f, 0.0f}, dD = 0.0f;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    Av[j] = live ? A[(long long)d * MAX_STATE + grp * SPL + j] : 0.0f;
    a2[j] = Av[j] * LOG2E;
  }
  const float dskip = live ? D[d] : 0.0f;

  stage(c0, 0);
  cp_async_commit();
  for (int k = 0; k < n; ++k) {
    const int t0 = (c0 + k) * CHUNK;
    if (k + 1 < n) stage(c0 + k + 1, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk k has landed
    __syncthreads();
    const Stage<Elt>& sk = sm.st[k & 1];
    float h[SPL], gg[SPL];
    load4(&sm.hb[k & 1][ch][grp * SPL], h);
    load4(&sm.gc[k & 1][ch][grp * SPL], gg);

    // the chunk's states: prev[t] = h_{t-1}; h ends as h of its last step
    float prev[CHUNK][SPL];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float dtv = to_f32(sk.dt[t][ch]);
      const float u = __fmul_rn(dtv, to_f32(sk.x[t][ch]));
      float bs[SPL];
      load4(&sk.bm[t][grp * SPL], bs);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        prev[t][j] = h[j];
        const float a = exp2_sfu(__fmul_rn(dtv, a2[j]));
        h[j] = __fmaf_rn(a, h[j], __fmul_rn(u, bs[j]));
      }
    }
    // the walk back: gg holds a_{t+1} g_{t+1}, h holds h_t
#pragma unroll
    for (int t = CHUNK - 1; t >= 0; --t) {
      const float dtv = to_f32(sk.dt[t][ch]), xv = to_f32(sk.x[t][ch]);
      const float dyv = sk.dy[t][ch];
      const float u = __fmul_rn(dtv, xv);
      float bs[SPL], cs[SPL], v[2 * SPL];
      load4(&sk.bm[t][grp * SPL], bs);
      load4(&sk.cm[t][grp * SPL], cs);
      float du = 0.0f, qa = 0.0f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const float g = __fmaf_rn(dyv, cs[j], gg[j]);
        const float a = exp2_sfu(__fmul_rn(dtv, a2[j]));
        gg[j] = __fmul_rn(a, g);  // a_t g_t: the step before takes it
        const float q = __fmul_rn(gg[j], prev[t][j]);
        dA[j] = __fmaf_rn(q, dtv, dA[j]);
        du = __fmaf_rn(g, bs[j], du);
        qa = __fmaf_rn(q, Av[j], qa);
        v[j] = __fmul_rn(u, g);
        v[SPL + j] = __fmul_rn(dyv, h[j]);
        h[j] = prev[t][j];
      }
      dD = __fmaf_rn(dyv, xv, dD);
      // du (lanes 0, 1 of the channel) and qa (lanes 2, 3) over its lanes
      {
        const bool hi = grp & 2;
        float w = __fadd_rn(hi ? qa : du,
                            __shfl_xor_sync(0xffffffffu, hi ? du : qa, 2));
        w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, 1));
        const float other = __shfl_xor_sync(0xffffffffu, w, 2);
        if (grp == 0)
          sm.out_dx[t][ch] = __fmaf_rn(dtv, w, __fmul_rn(dskip, dyv));
        else if (grp == 2)
          sm.out_ddt[t][ch] = __fmaf_rn(xv, other, w);
      }
      // meet8: the 8 sums over the warp's 8 channels (lane bits 4, 3, 2),
      // one of them a lane after it: v[c8] of the original order
      {
        const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float send = h4 ? v[i] : v[4 + i];
          v[i] = __fadd_rn(h4 ? v[4 + i] : v[i],
                           __shfl_xor_sync(0xffffffffu, send, 16));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float send = h3 ? v[i] : v[2 + i];
          v[i] = __fadd_rn(h3 ? v[2 + i] : v[i],
                           __shfl_xor_sync(0xffffffffu, send, 8));
        }
        const float send = h2 ? v[0] : v[1];
        v[0] = __fadd_rn(h2 ? v[1] : v[0],
                         __shfl_xor_sync(0xffffffffu, send, 4));
        sm.red[t][warp][slot] = v[0];
      }
    }
    __syncthreads();  // the walks are done with buffer k % 2 and red
    // the block's sums of the chunk's steps, warps in order
    for (int i = tid; i < CHUNK * RED; i += NT) {
      const int tt = i / RED, r = i % RED, t = t0 + tt;
      if (t >= S) continue;
      float sum = sm.red[tt][0][r];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, sm.red[tt][w][r]);
      BC_part[(((long long)b * S + t) * ndb + blockIdx.x) * RED + r] = sum;
    }
    for (int i = tid; i < CHUNK * CHANNELS; i += NT) {
      const int tt = i / CHANNELS, cc = i % CHANNELS;
      const int t = t0 + tt, dd = d0 + cc;
      if (t < S && dd < di) {
        const long long o = ((long long)b * S + t) * di + dd;
        ddt[o] = from_f32<Elt>(sm.out_ddt[tt][cc]);
        dx[o] = from_f32<Elt>(sm.out_dx[tt][cc]);
      }
    }
  }
  if (live) {
    const long long o = (((long long)b * ng + cg) * di + d) * MAX_STATE +
                        grp * SPL;
    store4(A_part + o, dA);
    if (grp == 0) D_part[((long long)b * ng + cg) * di + d] = dD;
  }
}

// Pass 4: out[o][j] = sum over k < n of in[o][k][j], k ascending.
__global__ void __launch_bounds__(256)
mamba_bwd_sum(const float* __restrict__ in, float* __restrict__ out, int n,
              long long inner, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long o = i / inner, j = i - o * inner;
  const float* p = in + o * n * inner + j;
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s = __fadd_rn(s, p[k * inner]);
  out[i] = s;
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

static int sum_launch(const float* in, float* out, long long outer, int n,
                      long long inner, cudaStream_t stream) {
  const long long total = outer * inner;
  mamba_bwd_sum<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      in, out, n, inner, total);
  return (int)cudaGetLastError();
}

template <typename Elt>
static int launch(const void* dt, const void* x, const float* dy,
                  const float* Bm, const float* Cm, const float* A,
                  const float* D, const float* h0, const float* dhT,
                  void* ddt, void* dx, float* dBC, float* dA, float* dD,
                  float* dh0, float* HB, float* GC, float* DTS,
                  float* BC_part, float* A_part, float* D_part, int B, int S,
                  int di, cudaStream_t stream) {
  const int ndb = (di + CHANNELS - 1) / CHANNELS;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const int ng = (nc + CHUNKS_A_BLOCK - 1) / CHUNKS_A_BLOCK;
  const Elt* dte = static_cast<const Elt*>(dt);
  const Elt* xe = static_cast<const Elt*>(x);
  // dt and x by 4-byte copies: always in f32; in bf16 where every row
  // starts 4-byte aligned
  const bool pairs = sizeof(Elt) == 4 ||
                     (di % 2 == 0 && aligned(dt, 4) && aligned(x, 4));
  const size_t smem = sizeof(ChunkSmem<Elt>);
  int err = (int)cudaFuncSetAttribute(
      mamba_bwd_chunks<Elt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  mamba_bwd_local<Elt><<<dim3(ndb, ng, B), NT, 0, stream>>>(
      dte, xe, dy, Bm, Cm, A, HB, GC, DTS, S, di, nc, pairs);
  if ((err = (int)cudaGetLastError())) return err;
  const long long states = (long long)B * di * MAX_STATE;
  mamba_bwd_chain<<<(unsigned)((states + 255) / 256), 256, 0, stream>>>(
      A, h0, dhT, HB, GC, DTS, dh0, B, di, nc);
  if ((err = (int)cudaGetLastError())) return err;
  mamba_bwd_chunks<Elt><<<dim3(ndb, ng, B), NT, smem, stream>>>(
      dte, xe, dy, Bm, Cm, A, D, HB, GC, static_cast<Elt*>(ddt),
      static_cast<Elt*>(dx), BC_part, A_part, D_part, S, di, nc, pairs);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_launch(BC_part, dBC, (long long)B * S, ndb, RED, stream)))
    return err;
  if ((err = sum_launch(A_part, dA, 1, B * ng, (long long)di * MAX_STATE,
                        stream)))
    return err;
  return sum_launch(D_part, dD, 1, B * ng, di, stream);
}

// The kernel's constants, which the Python wrapper checks against its own.
extern "C" int mamba_scan_bwd_max_state() { return MAX_STATE; }
extern "C" int mamba_scan_bwd_chunk() { return CHUNK; }
extern "C" int mamba_scan_bwd_channels() { return CHANNELS; }
extern "C" int mamba_scan_bwd_lanes() { return LANES; }
extern "C" int mamba_scan_bwd_chunks_a_block() { return CHUNKS_A_BLOCK; }
// dynamic shared memory of a block of pass 3, by element bytes
extern "C" int mamba_scan_bwd_smem(int elem_bytes) {
  return elem_bytes == 4 ? (int)sizeof(ChunkSmem<float>)
                         : (int)sizeof(ChunkSmem<__nv_bfloat16>);
}

// dt, x, ddt, dx: [B, S, di] of elem_bytes (4: f32, 2: bf16); dy [B, S,
// di], Bm, Cm [B, S, MAX_STATE], A [di, MAX_STATE], D, dD [di], h0, dhT,
// dh0 [B, di, MAX_STATE], dBC [B, S, 2, MAX_STATE] (dBm, then dCm), dA
// [di, MAX_STATE]: f32, 16-byte aligned, zero past ds.  Scratch (f32): HB
// and GC [B, nc, di, MAX_STATE], DTS [B, nc, di], BC_part [B, S, ndb,
// 2 MAX_STATE], A_part [B, ng, di, MAX_STATE], D_part [B, ng, di], with
// nc = ceil(S / CHUNK), ng = ceil(nc / CHUNKS_A_BLOCK) and ndb =
// ceil(di / CHANNELS).  All contiguous.  Returns a cudaError_t (0 on
// success); the launches are asynchronous on `stream`.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* dy,
                              const void* Bm, const void* Cm, const void* A,
                              const void* D, const void* h0, const void* dhT,
                              void* ddt, void* dx, void* dBC, void* dA,
                              void* dD, void* dh0, void* HB, void* GC,
                              void* DTS, void* BC_part, void* A_part,
                              void* D_part, int B, int S, int di,
                              int elem_bytes, void* stream) {
  const int nc = (S + CHUNK - 1) / CHUNK;
  const int ng = (nc + CHUNKS_A_BLOCK - 1) / CHUNKS_A_BLOCK;
  const void* vec[] = {Bm, Cm, A, h0, dhT, dBC, dA, dh0,
                       HB, GC, A_part};
  for (const void* p : vec)
    if (!aligned(p, 16)) return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || S < 1 || ng > 65535 || di < 1 ||
      (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (elem_bytes == 4)
    return launch<float>(dt, x, f(dy), f(Bm), f(Cm), f(A), f(D), f(h0),
                         f(dhT), ddt, dx, w(dBC), w(dA), w(dD), w(dh0), w(HB),
                         w(GC), w(DTS), w(BC_part), w(A_part), w(D_part), B, S,
                         di, s);
  return launch<__nv_bfloat16>(dt, x, f(dy), f(Bm), f(Cm), f(A), f(D), f(h0),
                               f(dhT), ddt, dx, w(dBC), w(dA), w(dD), w(dh0),
                               w(HB), w(GC), w(DTS), w(BC_part), w(A_part),
                               w(D_part), B, S, di, s);
}
