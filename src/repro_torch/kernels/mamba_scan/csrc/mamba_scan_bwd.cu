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
// and Cm [B, S, MAX_STATE] f32, and A [di, MAX_STATE], dhT and dh0 [B,
// di, MAX_STATE] f32, all zero past ds (the wrapper pads them; a padded
// state has a = exp2(0) = 1 from zero and stays zero); D [di] f32.  HS
// [B, ceil(S / CHUNK), di, MAX_STATE] f32 is the forward's residual: the
// state before every chunk of CHUNK steps, which mamba_scan.cu stores
// under grad (its KEEP_EVERY is this CHUNK).  Any S >= 1, any di, ds from
// 1 to MAX_STATE.
//
// The design: one reverse walk.  mamba_bwd_walk, a block per (CHANNELS
// channels, batch), walks the chunks from the last to the first, the
// cotangent carried from chunk to chunk in registers (from dhT; it ends
// as dh0).  For each chunk: its state before it is read from HS (a chunk
// ahead, into registers), its states recomputed in registers (h_{t-1}
// kept, CHUNK x 4 a lane), then g walked back with the decays computed
// again, each step's sums taken one shuffle level deep and left in shared
// memory; then the chunk's sums: dx and ddt of each step and the block's
// partial sums of dBm and dCm (over its channels, each step); over its
// chunks, of dA and dD.  A second kernel, mamba_bwd_sum, adds the
// partials in ascending order of their part (dBm and dCm over the channel
// blocks, dA and dD over the batch).  So two exps a state and step, no
// boundary state computed here and no scratch but the partials; no
// atomics: a relaunch gives the same bits.  A chunk's inputs are staged
// into shared memory by cp.async, double-buffered, so that the chunk
// before it is copied under this chunk's walks; a copy past S or past di
// is zero-filled (cp.async's source size 0), so that a padded step has a
// = exp2(0) = 1 and no input, and a padded channel stays 0.
//
// Lanes: LANES (4) lanes of a warp own one channel, each SPL (4) of its
// states, so a warp holds 8 channels and a block CHANNELS (64).  In the
// walk no chain of shuffles follows a step: du and sum_s q A meet over
// two of the channel's lanes by one __shfl_xor_sync (a transposed level:
// lanes 0, 1 keep du's halves, 2, 3 qa's), and the 8 sums a lane holds
// for dBm and dCm (its 4 states each) over channels c and c + 4 of its
// warp by one level of 4 (lanes with bit 4 clear keep dBm's, the others
// dCm's); both go to shared memory.  After the chunk's walk a thread
// adds, for two of the chunk's (step, state) sums, the 32 channel pairs
// in order, and for four (step, channel)s the halves of du and qa, and
// writes dx and ddt.  The walk's steps, free of branches and of
// dependent shuffles, schedule as one unrolled block.
//
// Fill: B x ceil(di / CHANNELS) blocks of 256 threads, two an SM: 256 at
// jamba's training shape (B 2, di 8,192) for the card's 264 slots; at B 1
// half of them, one an SM (the lower fill is taken: splitting time would
// need a walk of every chunk's cotangent before the chain of them).
//
// Budgets: registers, the recomputed states of a chunk (CHUNK x SPL = 64
// a lane) beside the state, the next boundary state, cotangent, A, its
// log2e multiple and dA (24) and the sums, within 128 for two blocks of
// 256 threads an SM.  Shared memory (dynamic): two stages of the chunk's
// dt and x [CHUNK][CHANNELS] in the input's type, dy [CHUNK][CHANNELS]
// and Bm, Cm [CHUNK][MAX_STATE] in f32 (14,336 bytes a stage in f32,
// 10,240 in bf16), the pairs' sums [CHUNK][CHANNELS / 2][32] (65,536) and
// du, qa halves [CHUNK][CHANNELS][4] (16,384): 110,592 bytes in f32,
// 102,400 in bf16, two blocks in an SM's 228 KB.  Scratch (global, f32):
// the dBm/dCm partials [B, S, di/CHANNELS, 32], the dA and dD partials
// [B, di, MAX_STATE] and [B, di].
//
// What bounds it on an H100: the operations.  At jamba's training shape
// (B 2, S 2,048, di 8,192, ds 16) the gradient needs at least one exp a
// state and step (5.4e8 on the SFUs, 16 a clock an SM: 0.128 ms) and
// about 17 f32 operations beside it (0.136 ms at the f32 peak), ahead of
// its bytes (0.121 ms in bf16).  This design does two exps a state and
// step, and the instructions around them (PERF.md §6, row 10).
//
// Rounding: every exp is ex2.approx.ftz of dt * fl(A log2 e) (within 2
// ulp where 2^x >= 2^-126, else 0: a decay that underflows is 0, and as
// nothing is divided by a decay, every path then gives the zeros the
// plain backward gives).  The states are the forward kernel's sequential
// chain, as the forward computed them.  Sums run in the fixed orders
// above, which differ from the plain backward's (ops.TOL_BWD).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_STATE 16       // the largest ds; smaller ones are zero-padded
#define CHUNK 16           // steps a chunk
#define CHANNELS 64        // channels a block, LANES lanes each
#define LANES 4            // lanes a channel

constexpr int SPL = MAX_STATE / LANES;  // states a lane
constexpr int NT = CHANNELS * LANES;    // threads a block
constexpr int WARPS = NT / 32;
constexpr int CPW = 32 / LANES;         // channels a warp
constexpr int RED = 2 * MAX_STATE;      // a step's sums: dBm, then dCm
constexpr int PAIRS = CHANNELS / 2;     // channel pairs a block
static_assert(SPL == 4 && CPW == 8 && RED == 32 && NT % CHANNELS == 0,
              "the reductions take 4 states a lane, 8 channels a warp, "
              "and a thread one channel in the chunk's sums");
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

// Start the copies of a [CHUNK][CHANNELS] tile from step t0 into `dst`
// by W-byte cp.async copies of W / sizeof(T) channels (every row of di
// channels a whole number of them; zero past S and past di).
template <int W, typename T>
__device__ __forceinline__ void copy_tile(T (&dst)[CHUNK][CHANNELS],
                                          const T* __restrict__ src,
                                          long long row0, int t0, int S,
                                          int d0, int di, int tid) {
  constexpr int PER = W / sizeof(T);  // channels a copy
  for (int i = tid; i < CHUNK * CHANNELS / PER; i += NT) {
    const int tt = i / (CHANNELS / PER), cc = i % (CHANNELS / PER) * PER;
    const int t = t0 + tt, d = d0 + cc;
    const bool on = t < S && d < di;
    const long long o = on ? (row0 + t) * di + d : 0;
    if (W == 16)
      cp_async16(&dst[tt][cc], src + o, on);
    else
      cp_async4(&dst[tt][cc], src + o, on);
  }
}

// Start the copies of the chunk from step t0 into `st`.  dt, x and dy go
// by 16-byte copies where `width` is 16 (every row and pointer allows
// them); else dy by 4-byte copies, and dt and x by 4-byte copies of 4 /
// sizeof(Elt) channels where `width` is 4 (always in f32; in bf16 an even
// di and 4-byte aligned pointers), or element by element with plain loads
// and stores (0).
template <typename Elt>
__device__ __forceinline__ void stage_chunk(
    Stage<Elt>& st, const Elt* __restrict__ dt, const Elt* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ Bm,
    const float* __restrict__ Cm, long long row0, int t0, int S, int d0,
    int di, int width, int tid) {
  if (width == 16) {
    copy_tile<16>(st.dy, dy, row0, t0, S, d0, di, tid);
    copy_tile<16>(st.dt, dt, row0, t0, S, d0, di, tid);
    copy_tile<16>(st.x, x, row0, t0, S, d0, di, tid);
  } else {
    copy_tile<4>(st.dy, dy, row0, t0, S, d0, di, tid);
    if (width == 4) {
      copy_tile<4>(st.dt, dt, row0, t0, S, d0, di, tid);
      copy_tile<4>(st.x, x, row0, t0, S, d0, di, tid);
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

template <typename Elt>
struct WalkSmem {
  Stage<Elt> st[2];
  // a step's dBm, dCm over each channel pair (c, c + 4 of a warp)
  __align__(16) float red[CHUNK][PAIRS][RED];
  // a step's du (lanes 0, 1 of a channel) and qa (2, 3) over two lanes
  __align__(16) float dq[CHUNK][CHANNELS][LANES];
};

template <typename Elt>
__global__ void __launch_bounds__(NT, 2)
mamba_bwd_walk(const Elt* __restrict__ dt, const Elt* __restrict__ x,
               const float* __restrict__ dy, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ A,
               const float* __restrict__ D, const float* __restrict__ HS,
               const float* __restrict__ dhT, Elt* __restrict__ ddt,
               Elt* __restrict__ dx, float* __restrict__ dh0,
               float* __restrict__ BC_part, float* __restrict__ A_part,
               float* __restrict__ D_part, int S, int di, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkSmem<Elt>& sm = *reinterpret_cast<WalkSmem<Elt>*>(smem_raw);
  const int tid = threadIdx.x, ch = tid / LANES, grp = tid % LANES;
  const int warp = tid / 32, lane = tid % 32, c8 = lane / LANES;
  const int d0 = blockIdx.x * CHANNELS, d = d0 + ch;
  const int b = blockIdx.y, ndb = gridDim.x;
  const int nc = (S + CHUNK - 1) / CHUNK;
  const bool live = d < di;
  const long long row0 = (long long)b * S;
  // this lane's row of red: its channel pair, and dBm's half (lane bit 4
  // clear) or dCm's
  const bool h4 = lane & 16;
  float* const red_row = &sm.red[0][warp * (CPW / 2) + (c8 & 3)][0] +
                         (h4 ? MAX_STATE : 0) + grp * SPL;
  // (b, d, this lane's first state) in a [B, di, MAX_STATE] array, and in
  // HS at chunk c: hs_at + c * di * MAX_STATE
  const long long hd = ((long long)b * di + d) * MAX_STATE + grp * SPL;
  const float* const hs_at =
      HS + ((long long)b * nc * di + d) * MAX_STATE + grp * SPL;
  // the channel this thread finishes in the chunk's sums (NT % CHANNELS
  // is 0: the same one each time)
  const int cc_sum = tid % CHANNELS;
  const float dskip_sum = d0 + cc_sum < di ? D[d0 + cc_sum] : 0.0f;

  // walk k takes chunk nc - 1 - k, staged into buffer k % 2
  auto stage = [&](int k) {
    stage_chunk<Elt>(sm.st[k & 1], dt, x, dy, Bm, Cm, row0,
                     (nc - 1 - k) * CHUNK, S, d0, di, width, tid);
  };
  stage(0);
  cp_async_commit();

  float a2[SPL], Av[SPL], dA[SPL] = {0.0f, 0.0f, 0.0f, 0.0f}, dD = 0.0f;
  float gg[SPL] = {0.0f, 0.0f, 0.0f, 0.0f};  // a_{t+1} g_{t+1}; dhT first
  float hn[SPL] = {0.0f, 0.0f, 0.0f, 0.0f};  // the next chunk's boundary
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    Av[j] = live ? A[(long long)d * MAX_STATE + grp * SPL + j] : 0.0f;
    a2[j] = Av[j] * LOG2E;
  }
  if (live) {
    load4(dhT + hd, gg);
    load4(hs_at + (long long)(nc - 1) * di * MAX_STATE, hn);
  }

  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k, t0 = c * CHUNK;
    cp_async_wait<0>();  // chunk k has landed
    __syncthreads();     // and every thread is done with chunk k - 1's sums
    // chunk k + 1 into the buffer chunk k - 1's sums read last
    if (k + 1 < nc) stage(k + 1);
    cp_async_commit();
    const Stage<Elt>& sk = sm.st[k & 1];
    float h[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) h[j] = hn[j];
    if (live && c > 0) load4(hs_at + (long long)(c - 1) * di * MAX_STATE, hn);

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
    // the walk back: gg holds a_{t+1} g_{t+1}, h holds h_t.  Each step's
    // sums go one shuffle level deep and then to shared memory, so that
    // no chain of shuffles holds up the next step; the chunk's sums finish
    // them below
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
      // du over lanes 0 and 2 (1 and 3) of the channel in lanes 0 (1), qa
      // over lanes 2 and 0 (3 and 1) in lanes 2 (3)
      {
        const bool hi = grp & 2;
        sm.dq[t][ch][grp] = __fadd_rn(
            hi ? qa : du, __shfl_xor_sync(0xffffffffu, hi ? du : qa, 2));
      }
      // dBm's (lane bit 4 clear) or dCm's 4 sums over channels c8 and
      // c8 ^ 4
      {
        float w[SPL];
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
          const float send = h4 ? v[i] : v[SPL + i];
          w[i] = __fadd_rn(h4 ? v[SPL + i] : v[i],
                           __shfl_xor_sync(0xffffffffu, send, 16));
        }
        store4(red_row + t * PAIRS * RED, w);
      }
    }
    __syncthreads();  // the walks are done: red and dq are whole
    // dBm, dCm: the block's sums of the chunk's steps, pairs in order
    for (int i = tid; i < CHUNK * RED; i += NT) {
      const int tt = i / RED, r = i % RED, t = t0 + tt;
      float sum = sm.red[tt][0][r];
#pragma unroll 8
      for (int p = 1; p < PAIRS; ++p) sum = __fadd_rn(sum, sm.red[tt][p][r]);
      if (t < S)
        BC_part[(((long long)b * S + t) * ndb + blockIdx.x) * RED + r] = sum;
    }
    // du and qa over the channel's lanes, then dx and ddt
    for (int i = tid; i < CHUNK * CHANNELS; i += NT) {
      const int tt = i / CHANNELS, t = t0 + tt, dd = d0 + cc_sum;
      const float4 q4 = *reinterpret_cast<const float4*>(sm.dq[tt][cc_sum]);
      const float du = __fadd_rn(q4.x, q4.y), qa = __fadd_rn(q4.z, q4.w);
      if (t < S && dd < di) {
        const long long o = ((long long)b * S + t) * di + dd;
        const float dyv = sk.dy[tt][cc_sum];
        ddt[o] = from_f32<Elt>(__fmaf_rn(to_f32(sk.x[tt][cc_sum]), du, qa));
        dx[o] = from_f32<Elt>(__fmaf_rn(to_f32(sk.dt[tt][cc_sum]), du,
                                        __fmul_rn(dskip_sum, dyv)));
      }
    }
  }
  if (live) {
    store4(dh0 + hd, gg);  // a_0 g_0
    store4(A_part + hd, dA);
    if (grp == 0) D_part[(long long)b * di + d] = dD;
  }
}

// out[o][j] = sum over k < n of in[o][k][j], k ascending.
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
                  const float* D, const float* HS, const float* dhT,
                  void* ddt, void* dx, float* dBC, float* dA, float* dD,
                  float* dh0, float* BC_part, float* A_part, float* D_part,
                  int B, int S, int di, cudaStream_t stream) {
  const int ndb = (di + CHANNELS - 1) / CHANNELS;
  // dt, x and dy by 16-byte copies where every row starts 16-byte
  // aligned; else dt and x by 4-byte copies, always in f32, in bf16 where
  // every row starts 4-byte aligned; else element by element
  const int width =
      di % (16 / (int)sizeof(Elt)) == 0 && aligned(dt, 16) &&
              aligned(x, 16) && aligned(dy, 16)
          ? 16
      : sizeof(Elt) == 4 || (di % 2 == 0 && aligned(dt, 4) && aligned(x, 4))
          ? 4
          : 0;
  const size_t smem = sizeof(WalkSmem<Elt>);
  int err = (int)cudaFuncSetAttribute(
      mamba_bwd_walk<Elt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  mamba_bwd_walk<Elt><<<dim3(ndb, B), NT, smem, stream>>>(
      static_cast<const Elt*>(dt), static_cast<const Elt*>(x), dy, Bm, Cm, A,
      D, HS, dhT, static_cast<Elt*>(ddt), static_cast<Elt*>(dx), dh0, BC_part,
      A_part, D_part, S, di, width);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_launch(BC_part, dBC, (long long)B * S, ndb, RED, stream)))
    return err;
  if ((err = sum_launch(A_part, dA, 1, B, (long long)di * MAX_STATE,
                        stream)))
    return err;
  return sum_launch(D_part, dD, 1, B, di, stream);
}

// The kernel's constants, which the Python wrapper checks against its own.
extern "C" int mamba_scan_bwd_max_state() { return MAX_STATE; }
extern "C" int mamba_scan_bwd_chunk() { return CHUNK; }
extern "C" int mamba_scan_bwd_channels() { return CHANNELS; }
extern "C" int mamba_scan_bwd_lanes() { return LANES; }
// dynamic shared memory of a block of the walk, by element bytes
extern "C" int mamba_scan_bwd_smem(int elem_bytes) {
  return elem_bytes == 4 ? (int)sizeof(WalkSmem<float>)
                         : (int)sizeof(WalkSmem<__nv_bfloat16>);
}

// dt, x, ddt, dx: [B, S, di] of elem_bytes (4: f32, 2: bf16); dy [B, S,
// di], Bm, Cm [B, S, MAX_STATE], A [di, MAX_STATE], D, dD [di], HS [B,
// ceil(S / CHUNK), di, MAX_STATE], dhT, dh0 [B, di, MAX_STATE], dBC [B, S,
// 2, MAX_STATE] (dBm, then dCm), dA [di, MAX_STATE]: f32, 16-byte aligned,
// zero past ds.  Scratch (f32): BC_part [B, S, ceil(di / CHANNELS), 2
// MAX_STATE], A_part [B, di, MAX_STATE], D_part [B, di].  All contiguous.
// Returns a cudaError_t (0 on success); the launches are asynchronous on
// `stream`.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* dy,
                              const void* Bm, const void* Cm, const void* A,
                              const void* D, const void* HS, const void* dhT,
                              void* ddt, void* dx, void* dBC, void* dA,
                              void* dD, void* dh0, void* BC_part,
                              void* A_part, void* D_part, int B, int S,
                              int di, int elem_bytes, void* stream) {
  const void* vec[] = {Bm, Cm, A, HS, dhT, dBC, dA, dh0, A_part};
  for (const void* p : vec)
    if (!aligned(p, 16)) return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || S < 1 || di < 1 ||
      (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (elem_bytes == 4)
    return launch<float>(dt, x, f(dy), f(Bm), f(Cm), f(A), f(D), f(HS),
                         f(dhT), ddt, dx, w(dBC), w(dA), w(dD), w(dh0),
                         w(BC_part), w(A_part), w(D_part), B, S, di, s);
  return launch<__nv_bfloat16>(dt, x, f(dy), f(Bm), f(Cm), f(A), f(D), f(HS),
                               f(dhT), ddt, dx, w(dBC), w(dA), w(dD), w(dh0),
                               w(BC_part), w(A_part), w(D_part), B, S, di, s);
}
