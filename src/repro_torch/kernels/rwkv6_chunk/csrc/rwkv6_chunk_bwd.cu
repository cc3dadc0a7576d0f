// The RWKV6 WKV recurrence's backward on Hopper (sm_90a), in chunks.
//
// Replaces no Pallas kernel: the reference trains by differentiating the
// chunked associative scan of src/repro/models/blocks.py:457-479 with XLA.
// It is the gradient of rwkv6_chunk.cu's recurrence, per (batch b, head h):
//
//   o_t[j] = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j]
//
// Given do (o's cotangent) and dsT (the final state's; null is zeros), with
// G_t the cotangent of S_t (G_{T-1} = dsT, G_{t-1} = w_t G_t + r_t^T do_t):
//
//   dr_t[i] = sum_j do_t[j] S_{t-1}[i][j] + u[i] k_t[i] (do_t . v_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + r_t[i] u[i] (do_t . v_t)
//   dv_t[j] = sum_i k_t[i] (G_t[i][j] + u[i] r_t[i] do_t[j])
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[h][i] = sum_b sum_t r_t[i] k_t[i] (do_t . v_t),   ds0 = G_{-1}
//
// r, k, v, w, do and the outputs dr, dk, dv, dw are [B, T, H, hd] (f32 or
// bf16); u and du [H, hd], s0, dsT and ds0 [B, H, hd, hd], all f32.  All
// arithmetic is f32, the sums that give dw in f64.  Any hd from 1 to
// MAX_HEAD_DIM.
//
// What bounds it on the card: about 14 hd^2 f32 operations per (b, t, h)
// (operations; the bytes of r, k, v, w, do read once and dr, dk, dv, dw
// written once take less).  But a walk over t is serial: one (b, h) walked
// over 2,048 steps takes about 0.42 ms on its SM whatever the grid, 3.7x
// the whole backward's bound.  So the design cuts t into chunks of C steps
// (c covers t0 .. t1) and keeps only T / C steps serial.
//
// Notation: A(a..b)[i] = prod_{a <= tau <= b} w_tau[i] (1 when empty).
// Decays are always products of w, never quotients of cumulative
// products: every factor is at most 1, so nothing overflows for any w > 0,
// and a decay that underflows is one whose term is negligible.
//
// Pass 1 (rwkv6_bwd_state_kernel): the chunks' boundary states, serial
// over chunks only.  S_c is the state before chunk c (S_0 = s0) and G^_c
// the cotangent of the state after chunk c's last step (G^_{nc-1} = dsT):
//
//   S_{c+1}   = diag(A(t0..t1)) S_c   + sum_{s in c} (k_s * A(s+1..t1)) v_s^T
//   G^_{c-1}  = diag(A(t0..t1)) G^_c  + sum_{s in c} (r_s * A(t0..s-1)) do_s^T
//
// and ds0 = G^_{-1}.  A block per state of one (b, h), 2 B H blocks: each
// chunk is a [HT x C] by [C x HT] product with the state kept in the
// compute warps' accumulators; warps of their own stage the inputs
// through a ring of cp.async buffers two chunks ahead.  The boundary
// states go to scratch, [B H][nc][HT][HT].
//
// Pass 2 (rwkv6_bwd_chunk_kernel): every chunk at once, a block per
// (b, h, c), from S_c, G^_c and the chunk's inputs in shared memory
// (padded steps of a ragged last chunk: w = 1, the others 0; nothing is
// written for them).  With D[t][s] = do_t . v_s:
//
//   dr'_t = A(t0..t-1) * (S_c do_t) + sum_{s<t} A(s+1..t-1) * k_s D[t][s]
//   dk'_t = A(t+1..t1) * (G^_c v_t) + sum_{s>t} A(t+1..s-1) * r_s D[s][t]
//
// Each is a Horner sum over s started from its product with the state:
// acc = acc * w_s + k_s D[t][s] for s = t0 .. t-1 (dr'), and the mirror
// from t1 down (dk'), so the decays stay products of w; a thread's 2 x 4
// tile of (t, i) takes both, so every thread walks as many steps.  dv is
//
//   dv_t = (G^_c)^T (k_t * A(t+1..t1)) + sum_{s>=t} M[t][s] do_s,
//   M[t][s] = sum_i k_t[i] A(t+1..s-1)[i] r_s[i] (s > t),
//   M[t][t] = sum_i r_t[i] u[i] k_t[i]
//
// with M's columns walked by (s, 4 lanes of i) threads (q = r_s, then q *=
// w_t going down in t), a thread taking two columns, and summed across
// lanes by a butterfly of shuffles.  Sub-chunks of 16 steps (below, at
// the kernel) take the cross terms of the Horner sums and of M to the
// tensor cores and leave walks of at most 15 steps.  dw uses w_t dw_t =
// a_t - k_t dk'_t with a_t[i] = sum_j G_t[i][j] S_t[i][j] and a_{t-1} =
// a_t + r_t dr'_t - k_t dk'_t, walked back over the chunk only, from
//
//   a_{t1}[i] = A(t0..t1)[i] sum_j G^_c[i][j] S_c[i][j]
//             + sum_{s in c} k_s[i] A(s+1..t1)[i] (G^_c v_s)[i]
//
// (S_{c+1} written out through pass 1's recurrence), in f64, so no state is
// divided by w (it needs w > 0).  The chunk's steps are walked in parts of
// 8 by (i, part) threads, each part's a starting from the later parts'
// sums.  The block adds the u terms to dr and dk and writes its part of du.
// dr' and dk' stay in shared memory.  C 32 at hd 64: two blocks an SM, so
// that one stages while the other computes.
//
// The products (pass 1's, D, S_c do_t, G^_c v_t, dv's two and the
// sub-chunks' cross terms) run on the tensor cores in 3xTF32 (tf32x3.cuh's
// mma, a split by truncation), f32-accurate, each k-step of 8 in a fresh
// partial: in f32 on the CUDA cores they left the SMs waiting on shared
// memory (a 4 x 4 tile of FMAs reads half a byte a FLOP).  The Horner sums
// and M's walks are f32 on the CUDA cores.
//
// Pass 3 (rwkv6_bwd_du_kernel): du, the parts added over b and chunks in a
// fixed order.  No atomics: the results are deterministic.

#include "wkv_io.cuh"

// Per head tile: C, the steps of a chunk.  A chunk block has C HT / 8
// threads, a 2 x 4 tile of the chunk's [C][HT] outputs each; C <= HT, so
// dr' fits the state's buffer once S_c is done with.
template <int HT> struct BwdTile;
template <> struct BwdTile<32> { static constexpr int C = 16; };
template <> struct BwdTile<64> { static constexpr int C = 32; };
template <> struct BwdTile<128> { static constexpr int C = 16; };

constexpr int DU_GROUPS = 8;  // threads of a lane of du

template <int HT>
constexpr int kChunkThreads = BwdTile<HT>::C * HT / 8;

// Pass 1's dynamic shared memory: a ring of STAGES buffers of X (k or r)
// and W [C][HT] and Y (v or do) [C][HT + 8]; the decayed X [C][HT + 8];
// the chunk's decay [HT]; the parts' decays (at most HT / 16 parts)
// [HT / 16][HT].  Rows of HT + 8 floats keep the mma fragments' loads
// free of bank conflicts.
constexpr int STAGES = 3;
template <int HT>
__host__ __device__ constexpr size_t state_smem_bytes() {
  constexpr int C = BwdTile<HT>::C;
  return sizeof(float) * ((size_t)STAGES * C * (3 * HT + 8) +
                          C * (HT + 8) + HT + (HT / 16) * HT);
}

// Pass 2's dynamic shared memory: r, k, v, w, do and k * A(t+1..t1)
// [C][HT + 4]; S_c and G^_c [HT][HT + 4]; D, then M, [C][C + 4]; do_t .
// v_t [C]; A(t0..t1) [HT]; the sub-chunks' decays [C / 16][HT]; the parts'
// decays and du [C / 8][HT]; then in f64 the parts' sums of G^ S and of
// r dr' - k dk' [C / 8][HT] and the sub-chunks' sums of k dk'_inter
// [C / 16][HT].
template <int HT>
__host__ __device__ constexpr size_t chunk_smem_bytes() {
  constexpr int C = BwdTile<HT>::C, P = HT + 4, PARTS = C / 8;
  return sizeof(float) * ((size_t)6 * C * P + 2 * HT * P + C * (C + 4) + C +
                          HT + (C / 16) * HT + 2 * PARTS * HT) +
         sizeof(double) * ((size_t)2 * PARTS * HT + (C / 16) * HT);
}

// Rows [0, rows) of an input [., T, H, hd] from src (at (b, t0, h, lane0)),
// `step` elements apart, into dst[row * ld + l], l in [0, lanes), as f32:
// 0 past hd (lane0 + l >= hd) and `pad` in every lane of the rows past the
// n that exist.  vec: hd is a multiple of 4 and the pointers are aligned
// (f32: 16-byte cp.async copies; bf16: 8-byte loads).  lanes and lane0
// are multiples of 4.
template <typename Elt>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const Elt* src,
                                          long long step, int rows, int n,
                                          int lanes, int lane0, int hd,
                                          float pad, bool vec, int tid,
                                          int nt) {
  const int quads = lanes / 4;
  for (int idx = tid; idx < rows * quads; idx += nt) {
    const int row = idx / quads, l = (idx - row * quads) * 4;
    float* d = dst + row * ld + l;
    if (row >= n) {
      *reinterpret_cast<float4*>(d) = make_float4(pad, pad, pad, pad);
      continue;
    }
    const Elt* s = src + row * step + l;
    if (vec && lane0 + l < hd) {
      if constexpr (sizeof(Elt) == 4) {
        cp_async16(d, s);
      } else {
        *reinterpret_cast<float4*>(d) = load4(s);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = lane0 + l + e < hd ? to_f32(s[e]) : 0.0f;
    }
  }
}

// Per lane l < nl of W [C][ld] (C steps), threads (l, part) with `parts`
// parts of C / parts steps: part_products writes each part's product of W
// to seg [parts][nl]; then, after a barrier, decay_walk writes X times the
// exclusive products of W over the earlier (PREFIX) or later steps of the
// chunk to out[s][l] (running products of w, never a quotient), and the
// chunk's whole product to tot[l].
template <int C, int PARTS>
__device__ __forceinline__ void part_products(const float* W, int ld,
                                              int nl, float* seg, int l,
                                              int part) {
  constexpr int LEN = C / PARTS;
  float p = 1.0f;
#pragma unroll
  for (int s = part * LEN; s < part * LEN + LEN; ++s)
    p = __fmul_rn(p, W[s * ld + l]);
  seg[part * nl + l] = p;
}

template <bool PREFIX, int C, int PARTS>
__device__ __forceinline__ void decay_walk(const float* W, const float* X,
                                           int ld, float* out, int out_ld,
                                           int nl, const float* seg,
                                           float* tot, int l, int part) {
  constexpr int LEN = C / PARTS;
  const int first = part * LEN;
  float run = 1.0f;
  if (PREFIX) {
    for (int p = 0; p < part; ++p) run = __fmul_rn(run, seg[p * nl + l]);
#pragma unroll
    for (int s = first; s < first + LEN; ++s) {
      out[s * out_ld + l] = __fmul_rn(X[s * ld + l], run);
      run = __fmul_rn(run, W[s * ld + l]);
    }
    if (part == PARTS - 1) tot[l] = run;
  } else {
    for (int p = PARTS - 1; p > part; --p)
      run = __fmul_rn(run, seg[p * nl + l]);
#pragma unroll
    for (int s = first + LEN - 1; s >= first; --s) {
      out[s * out_ld + l] = __fmul_rn(X[s * ld + l], run);
      run = __fmul_rn(run, W[s * ld + l]);
    }
    if (part == 0) tot[l] = run;
  }
}

// x = hi + lo, both TF32 (low 13 bits zero), by truncation: hi keeps x's
// top 19 bits and lo = x - hi (exact) is truncated in turn, so hi + lo
// carries x to 2^-20 relative (cvt.rna's split, tf32x3.cuh, to 2^-22, in
// more instructions).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// acc += A B over k in [k_begin, k_end) for one warp's MT x NT tiles of
// m16n8 (rows m, columns n from the operands' origin), in 3xTF32
// (lo.hi, hi.lo, hi.hi; tf32x3.cuh's mma): element (m, k) of A lies at
// A[m * am + k * ak] and (k, n) of B at B[k * bk + n * bn], in shared
// memory.  Each k-step of 8 is summed into a fresh partial that is added
// to acc rounded to nearest (the tensor cores' accumulation truncates).
// Accumulator (mt, nt, r) is row mt 16 + g + 8 (r / 2), column nt 8 + 2 t
// + r % 2, with g = lane / 4, t = lane % 4.
template <int MT, int NT>
__device__ __forceinline__ void mma_acc(float (&acc)[MT][NT][4],
                                        const float* A, int am, int ak,
                                        const float* B, int bk, int bn,
                                        int k_begin, int k_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = mt * 16 + g + (r & 1) * 8, k = k0 + t + (r >> 1) * 4;
        split_trunc(A[m * am + k * ak], ah[mt][r], al[mt][r]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_trunc(B[(k0 + t) * bk + n * bn], bh0, bl0);
      split_trunc(B[(k0 + t + 4) * bk + n * bn], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float d[4];
        mma_tf32_zero(d, al[mt], bh0, bh1);
        mma_tf32(d, ah[mt], bl0, bl1);
        mma_tf32(d, ah[mt], bh0, bh1);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mt][nt][r] = __fadd_rn(acc[mt][nt][r], d[r]);
      }
    }
  }
}

// Row and column, from its tile's origin, of accumulator (nt, r) of a
// 16 x (8 NT) warp tile (mma_acc with MT 1).
__device__ __forceinline__ int frag_row(int r) {
  return ((threadIdx.x & 31) >> 2) + (r >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int r) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (r & 1);
}

// Pass 1's warps: a compute warp keeps SMT 16 x 32 tiles of the state
// (SMT 2 at head tile 128), and as many warps stage the chunks.
template <int HT> struct StateWarps {
  static constexpr int SMT = HT == 128 ? 2 : 1;
  static constexpr int COMPUTE = 32 * (HT / 16) * (HT / 32) / SMT;  // threads
  static constexpr int THREADS = 2 * COMPUTE;
};

// A barrier of the compute threads only (named barrier 1).
template <int N>
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// Pass 1: block (which, b * H + h).  which 0 walks S forward from s0 and
// writes S_0 .. S_{nc-1}; which 1 walks G^ backward from dsT and writes
// G^_{nc-1} .. G^_0 and ds0.  Each compute warp keeps its tiles of the
// state in mma accumulators.  The other warps stage the chunks' inputs
// through a ring of STAGES buffers, two chunks ahead, while the compute
// warps work: all the SMs' copies of a chunk together run at about the
// memory's rate, and asking for them waits that long, which stays off
// the compute warps.  One barrier of the whole block an iteration (chunk
// it has landed and chunk it - 1's slot is free), two of the compute
// warps.  Scratch: [B H][nc][HT][HT].
template <typename Elt, int HT>
__global__ void __launch_bounds__(StateWarps<HT>::THREADS)
rwkv6_bwd_state_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                       const Elt* __restrict__ v, const Elt* __restrict__ w,
                       const float* __restrict__ s0,
                       const Elt* __restrict__ dO,
                       const float* __restrict__ dsT, float* __restrict__ Sst,
                       float* __restrict__ Gst, float* __restrict__ ds0,
                       int T, int H, int hd, int nc, int vec) {
  constexpr int C = BwdTile<HT>::C, LD = HT + 8;
  constexpr int SMT = StateWarps<HT>::SMT, NTC = StateWarps<HT>::COMPUTE;
  constexpr int PARTS = NTC / HT;  // threads of a lane in the decay walks
  constexpr int BUF = C * (3 * HT + 8);
  static_assert(C % PARTS == 0, "parts of equal length");
  extern __shared__ __align__(16) unsigned char smem[];
  float* const buf = reinterpret_cast<float*>(smem);  // [STAGES][X, W, Y]
  float* const XH = buf + STAGES * BUF;                // [C][LD]
  float* const tot = XH + C * LD;                      // [HT]
  float* const seg = tot + HT;                         // [PARTS][HT]

  const int which = blockIdx.x % 2, bh = blockIdx.x / 2;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, warp = tid / 32;
  const bool stager = tid >= NTC;
  // a compute warp's tiles: rows m0 + 16 mt, columns n0 .. n0 + 31
  const int m0 = 16 * SMT * (warp / (HT / 32)), n0 = 32 * (warp % (HT / 32));
  const int dl = tid % HT, dpart = tid / HT;
  const long long step = (long long)H * hd;
  const long long head = ((long long)b * T * H + h) * hd;  // (b, 0, h, 0)
  const Elt* const X = which == 0 ? k : r;
  const Elt* const Y = which == 0 ? v : dO;
  const float* const x0 = which == 0 ? s0 : dsT;
  float* const out = which == 0 ? Sst : Gst;
  // S walks c = 0 .. nc - 2, G^ walks c = nc - 1 .. 0
  const int niter = which == 0 ? nc - 1 : nc;
  auto chunk_of = [&](int it) { return which == 0 ? it : nc - 1 - it; };

  if (stager) {
    auto stage = [&](int it) {
      if (it < niter) {
        const int c = chunk_of(it), t0 = c * C, n = min(C, T - t0);
        float* const bb = buf + (it % STAGES) * BUF;
        const long long at = head + (long long)t0 * step;
        const int lane = tid - NTC;
        stage_f32<Elt>(bb, HT, X + at, step, C, n, HT, 0, hd, 0.0f, vec,
                       lane, NTC);
        stage_f32<Elt>(bb + C * HT, HT, w + at, step, C, n, HT, 0, hd, 1.0f,
                       vec, lane, NTC);
        stage_f32<Elt>(bb + 2 * C * HT, LD, Y + at, step, C, n, HT, 0, hd,
                       0.0f, vec, lane, NTC);
      }
      cp_async_commit();
    };
    stage(0);
    stage(1);
    cp_async_wait<1>();  // chunk 0 has landed
    for (int it = 0; it < niter; ++it) {
      __syncthreads();  // chunk it is in; chunk it - 1's slot is free
      stage(it + 2);
      cp_async_wait<1>();  // chunk it + 1 has landed
    }
    return;
  }

  float st[SMT][4][4] = {};
#pragma unroll
  for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = m0 + 16 * mt + frag_row(q), j = n0 + frag_col(nt, q);
        if (x0 != nullptr && i < hd && j < hd)
          st[mt][nt][q] = x0[((long long)bh * hd + i) * hd + j];
      }
  // the state after chunk c (S: before chunk c + 1) to scratch
  auto put = [&](int c) {
    float* const dst = out + ((long long)bh * nc + c) * HT * HT;
#pragma unroll
    for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; q += 2)
          *reinterpret_cast<float2*>(
              dst + (m0 + 16 * mt + frag_row(q)) * HT + n0 +
              frag_col(nt, q)) = make_float2(st[mt][nt][q],
                                             st[mt][nt][q + 1]);
  };

  if (nc > 0) put(which == 0 ? 0 : nc - 1);
  for (int it = 0; it < niter; ++it) {
    __syncthreads();  // chunk it has landed
    const float* const bX = buf + (it % STAGES) * BUF;
    const float* const bW = bX + C * HT;
    const float* const bY = bW + C * HT;
    // X * A(s+1..t1) (S) or X * A(t0..s-1) (G^), and A(t0..t1)
    part_products<C, PARTS>(bW, HT, HT, seg, dl, dpart);
    compute_sync<NTC>();
    if (which == 0)
      decay_walk<false, C, PARTS>(bW, bX, HT, XH, LD, HT, seg, tot, dl,
                                  dpart);
    else
      decay_walk<true, C, PARTS>(bW, bX, HT, XH, LD, HT, seg, tot, dl,
                                 dpart);
    compute_sync<NTC>();
    // the state's tiles += XH^T Y: A (m = i, k = s) = XH[s][i]
    float acc[SMT][4][4] = {};
    mma_acc<SMT, 4>(acc, XH + m0, 1, LD, bY + n0, LD, 1, 0, C);
#pragma unroll
    for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[mt][nt][q] = __fmaf_rn(tot[m0 + 16 * mt + frag_row(q)],
                                    st[mt][nt][q], acc[mt][nt][q]);
    const int c = chunk_of(it);
    if (which == 0)
      put(c + 1);
    else if (c > 0)
      put(c - 1);
  }
  if (which == 1) {  // ds0 = G^_{-1}
#pragma unroll
    for (int mt = 0; mt < SMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = m0 + 16 * mt + frag_row(q), j = n0 + frag_col(nt, q);
          if (i < hd && j < hd)
            ds0[((long long)bh * hd + i) * hd + j] = st[mt][nt][q];
        }
  }
}

// Pass 2: block c + nc (b H + h).  Phases, separated by block barriers:
//   0  stage the chunk's do and v, then r, k, w, S_c and G^_c;
//   1  D = do v^T (mma) while the rest lands;
//   2  the parts' sums of G^ S (f64) and decays; X = S_c do_t and Y =
//      G^_c v_t (mma); then k * A(t+1..t1), A(t0..t1), the sub-chunks'
//      decays, KL and RF (below), and X and Y to shared memory in S_c's and
//      v's buffers;
//   2b sum k * A(t+1..t1) * Y (f64); each sub-chunk's Horner start, the
//      earlier sub-chunk's terms through its boundary (mma);
//   3  D's diagonal; the Horner sums of dr' and dk' within each sub-chunk
//      by 2 x 4 tiles, back in place;
//   4  M: its block across the sub-chunks (mma), its walks within them;
//   5  dv (mma, stored); the parts walked back from their ends: their sums
//      of r dr' - k dk' and a relative to their ends (f64), dr and dk
//      (stored) and du's parts;
//   6  a at each part's end, then dw (stored); du's part of the block.
// The products run on warp tiles of 16 x 16.
//
// Sub-chunks: C 32 is cut into two of 16 steps, and a term from s in the
// first to t in the second factors through their boundary: A(s+1..t-1) =
// A(s+1..15) A(16..t-1), both products of w.  With KL_s = k_s A(s+1..15)
// and RF_s = r_s A(16..s-1), the dr' of t >= 16 is the Horner sum over
// 16 .. t-1 started from A(0..15) X_t + sum_{s<16} D[t][s] KL_s, the dk'
// of t < 16 the one over 15 .. t+1 started from A(16..31) Y_t +
// sum_{s>=16} D[s][t] RF_s, and M[t][s] = KL_t . RF_s across the two: the
// cross terms become small products on the tensor cores, and the walks
// left on the CUDA cores are at most 15 steps long.
template <typename Elt, int HT>
__global__ void __launch_bounds__(kChunkThreads<HT>)
rwkv6_bwd_chunk_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                       const Elt* __restrict__ v, const Elt* __restrict__ w,
                       const float* __restrict__ u,
                       const Elt* __restrict__ dO,
                       const float* __restrict__ Sst,
                       const float* __restrict__ Gst, Elt* __restrict__ dr,
                       Elt* __restrict__ dk, Elt* __restrict__ dv,
                       Elt* __restrict__ dw, float* __restrict__ du_part,
                       int T, int H, int hd, int nc, int vec) {
  constexpr int C = BwdTile<HT>::C, P = HT + 4, DP = C + 4;
  constexpr int NT = kChunkThreads<HT>, TN = HT / 4, PARTS = C / 8;
  constexpr int NWARPS = NT / 32, NSUB = C / 16;
  constexpr int ISETS = HT / 4;  // lanes of i a row of M is summed over
  static_assert(C % 16 == 0 && (NSUB == 1 || (NSUB == 2 && C + 32 <= HT)),
                "X, then KL and RF, fit S_c's buffer");
  static_assert(NT == 8 * NSUB * ISETS && NT == PARTS * HT, "thread roles");
  static_assert(NWARPS == (C / 16) * (HT / 16), "a 16 x 16 tile a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  float* const R = reinterpret_cast<float*>(smem);
  float* const K = R + C * P;
  float* const V = K + C * P;   // v; Y, then dk', from phase 2
  float* const W = V + C * P;
  float* const DO = W + C * P;
  float* const KT = DO + C * P;  // k * A(t+1..t1)
  float* const SS = KT + C * P;  // S_c; X, then dr', and KL, RF from phase 2
  float* const GG = SS + HT * P;
  float* const DM = GG + HT * P;  // D, then M
  float* const dots = DM + C * DP;
  float* const tot = dots + C;
  float* const asub = tot + HT;   // [NSUB][HT] the sub-chunks' decays
  float* const seg = asub + NSUB * HT;  // [PARTS][HT]
  float* const du_p = seg + PARTS * HT;
  double* const gs_part = reinterpret_cast<double*>(du_p + PARTS * HT);
  double* const psum = gs_part + PARTS * HT;
  double* const kd_part = psum + PARTS * HT;  // [C / 16][HT]

  const int tid = threadIdx.x;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * C, n = min(C, T - t0);
  const long long step = (long long)H * hd;
  const long long at = ((long long)b * T * H + h) * hd + (long long)t0 * step;
  const int tm = tid / TN, tn = tid - tm * TN;     // 2 x 4 tile: rows, lanes
  const int li = tid % HT, part = tid / HT;        // (i, part) roles
  const int warp = tid / 32;
  // the warp's 16 x 16 tile of a [C][HT] product
  const int m0 = 16 * (warp / (HT / 16)), n0 = 16 * (warp % (HT / 16));

  // phase 0: do and v (D's operands) in a first group, the rest after it
  stage_f32<Elt>(DO, P, dO + at, step, C, n, HT, 0, hd, 0.0f, vec, tid, NT);
  stage_f32<Elt>(V, P, v + at, step, C, n, HT, 0, hd, 0.0f, vec, tid, NT);
  cp_async_commit();
  stage_f32<Elt>(R, P, r + at, step, C, n, HT, 0, hd, 0.0f, vec, tid, NT);
  stage_f32<Elt>(K, P, k + at, step, C, n, HT, 0, hd, 0.0f, vec, tid, NT);
  stage_f32<Elt>(W, P, w + at, step, C, n, HT, 0, hd, 1.0f, vec, tid, NT);
  {
    const float* const s_src = Sst + ((long long)bh * nc + c) * HT * HT;
    const float* const g_src = Gst + ((long long)bh * nc + c) * HT * HT;
    for (int idx = tid; idx < HT * HT / 4; idx += NT) {
      const int row = idx / (HT / 4), l = (idx - row * (HT / 4)) * 4;
      cp_async16(SS + row * P + l, s_src + row * HT + l);
      cp_async16(GG + row * P + l, g_src + row * HT + l);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // phase 1: D[t][s] = do_t . v_s: A (t, j) = do, B (j, s) = v[s][j]
  for (int tile = warp; tile < (C / 16) * (C / 16); tile += NWARPS) {
    const int d0 = 16 * (tile / (C / 16)), e0 = 16 * (tile % (C / 16));
    float acc[1][2][4] = {};
    mma_acc<1, 2>(acc, DO + d0 * P, P, 1, V + e0 * P, 1, P, 0, HT);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        DM[(d0 + frag_row(q)) * DP + e0 + frag_col(nt, q)] = acc[0][nt][q];
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 2
  {
    double g = 0.0;
    constexpr int len = HT / PARTS;
    for (int j = part * len; j < (part + 1) * len; j += 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(GG + li * P + j);
      const float4 s4 = *reinterpret_cast<const float4*>(SS + li * P + j);
      g += (double)g4.x * (double)s4.x;
      g += (double)g4.y * (double)s4.y;
      g += (double)g4.z * (double)s4.z;
      g += (double)g4.w * (double)s4.w;
    }
    gs_part[part * HT + li] = g;
  }
  part_products<C, PARTS>(W, P, HT, seg, li, part);
  // X[t][i] = do_t . S_c[i], Y[t][i] = v_t . G^_c[i]: B (j, i) = S[i][j]
  {
    float xf[1][2][4] = {}, yf[1][2][4] = {};
    mma_acc<1, 2>(xf, DO + m0 * P, P, 1, SS + n0 * P, 1, P, 0, HT);
    mma_acc<1, 2>(yf, V + m0 * P, P, 1, GG + n0 * P, 1, P, 0, HT);
    __syncthreads();  // every warp is done with S_c and v; seg is ready
    decay_walk<false, C, PARTS>(W, K, P, KT, P, HT, seg, tot, li, part);
    if constexpr (NSUB == 2) {
      // KL_s = k_s A(s+1..15) (parts 0, 1) and RF_s = r_s A(16..s-1)
      // (parts 2, 3), both into row C + s of S_c's buffer; the decays
      constexpr int LEN = C / PARTS;
      float run = part == 0 ? seg[HT + li] : part == 3 ? seg[2 * HT + li]
                                                       : 1.0f;
      if (part < 2) {
#pragma unroll
        for (int e = LEN - 1; e >= 0; --e) {
          const int o = (part * LEN + e) * P + li;
          SS[C * P + o] = __fmul_rn(K[o], run);
          run = __fmul_rn(run, W[o]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < LEN; ++e) {
          const int o = (part * LEN + e) * P + li;
          SS[C * P + o] = __fmul_rn(R[o], run);
          run = __fmul_rn(run, W[o]);
        }
      }
      if (part == 0 || part == 2)
        asub[(part / 2) * HT + li] =
            __fmul_rn(seg[part * HT + li], seg[(part + 1) * HT + li]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int o = (m0 + frag_row(q)) * P + n0 + frag_col(nt, q);
        *reinterpret_cast<float2*>(SS + o) =
            make_float2(xf[0][nt][q], xf[0][nt][q + 1]);
        *reinterpret_cast<float2*>(V + o) =
            make_float2(yf[0][nt][q], yf[0][nt][q + 1]);
      }
  }
  __syncthreads();

  // phase 2b, on the warp's tile: kd (its rows' sum of k A(t+1..t1) Y, per
  // column, over the 8 lanes of a column), then the Horner starts
  {
    const int g = (tid & 31) >> 2;
    double kdc[2][2] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (m0 + frag_row(q)) * P + n0 + frag_col(nt, q);
        kdc[nt][q & 1] += (double)KT[o] * (double)V[o];
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          kdc[nt][x] += __shfl_xor_sync(0xffffffffu, kdc[nt][x], off);
        if (g == 0)
          kd_part[(m0 / 16) * HT + n0 + frag_col(nt, x)] = kdc[nt][x];
      }
    if constexpr (NSUB == 2) {
      float acc[1][2][4] = {};
      const float* const KL = SS + C * P;
      const float* const RF = SS + (C + 16) * P;
      float* const Z = m0 == 0 ? V : SS;  // dk' of t < 16, dr' of t >= 16
      if (m0 == 0)  // A (t, s') = D[16 + s'][t], B (s', i) = RF[s'][i]
        mma_acc<1, 2>(acc, DM + 16 * DP, 1, DP, RF + n0, P, 1, 0, 16);
      else  // A (t', s) = D[16 + t'][s], B (s, i) = KL[s][i]
        mma_acc<1, 2>(acc, DM + 16 * DP, DP, 1, KL + n0, P, 1, 0, 16);
      const float* const a_of = asub + (m0 == 0 ? HT : 0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = n0 + frag_col(nt, q);
          const int o = (m0 + frag_row(q)) * P + i;
          Z[o] = __fmaf_rn(a_of[i], Z[o], acc[0][nt][q]);
        }
    }
  }
  __syncthreads();

  // phase 3: the tile of rows t = 2 tm + a, lanes 4 tn + q
  float xa[2][4], ya[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float4 x4 = *reinterpret_cast<const float4*>(SS + (2 * tm + a) * P +
                                                       4 * tn);
    const float4 y4 = *reinterpret_cast<const float4*>(V + (2 * tm + a) * P +
                                                       4 * tn);
    xa[a][0] = x4.x; xa[a][1] = x4.y; xa[a][2] = x4.z; xa[a][3] = x4.w;
    ya[a][0] = y4.x; ya[a][1] = y4.y; ya[a][2] = y4.z; ya[a][3] = y4.w;
  }
  if (tid < C) dots[tid] = DM[tid * DP + tid];
  // dr': acc = acc w_s + k_s D[t][s], s = 0 .. t - 1
  auto dr_step = [&](int s, int lo) {
    const float4 w4 = *reinterpret_cast<const float4*>(W + s * P + 4 * tn);
    const float4 k4 = *reinterpret_cast<const float4*>(K + s * P + 4 * tn);
    const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
    const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a < lo) continue;
      const float d = DM[(2 * tm + a) * DP + s];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xa[a][q] = __fmaf_rn(xa[a][q], wq[q], __fmul_rn(kq[q], d));
    }
  };
  // dk': acc = acc w_s + r_s D[s][t], s = t1 .. t + 1
  auto dk_step = [&](int s, int hi) {
    const float4 w4 = *reinterpret_cast<const float4*>(W + s * P + 4 * tn);
    const float4 r4 = *reinterpret_cast<const float4*>(R + s * P + 4 * tn);
    const float2 dd = *reinterpret_cast<const float2*>(DM + s * DP + 2 * tm);
    const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
    const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
    const float da[2] = {dd.x, dd.y};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a >= hi) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ya[a][q] = __fmaf_rn(ya[a][q], wq[q], __fmul_rn(rq[q], da[a]));
    }
  };
  {
    const int b0 = 2 * tm / 16 * 16;  // the sub-chunk of the tile's rows
#pragma unroll 2
    for (int s = b0; s < 2 * tm; ++s) dr_step(s, 0);
    dr_step(2 * tm, 1);
#pragma unroll 2
    for (int s = b0 + 15; s >= 2 * tm + 2; --s) dk_step(s, 2);
    dk_step(2 * tm + 1, 1);
  }
  __syncthreads();

  // phase 4: dr' into S_c's buffer, dk' into v's; M into D's
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    *reinterpret_cast<float4*>(SS + (2 * tm + a) * P + 4 * tn) =
        make_float4(xa[a][0], xa[a][1], xa[a][2], xa[a][3]);
    *reinterpret_cast<float4*>(V + (2 * tm + a) * P + 4 * tn) =
        make_float4(ya[a][0], ya[a][1], ya[a][2], ya[a][3]);
  }
  {
    // thread (pidx, iset): columns s = pidx and C - 1 - pidx of M, lanes
    // 4 iset .. 4 iset + 3 of i
    const int iset = tid % ISETS, pidx = tid / ISETS, i0 = 4 * iset;
    float uu[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      uu[e] = i0 + e < hd ? u[h * hd + i0 + e] : 0.0f;
    auto row4 = [&](const float* base, float (&out)[4]) {
      const float4 x4 = *reinterpret_cast<const float4*>(base + i0);
      out[0] = x4.x; out[1] = x4.y; out[2] = x4.z; out[3] = x4.w;
    };
    // a lane's partials summed across the ISETS lanes of its group by a
    // butterfly that leaves value `iset` in lane iset
    auto butterfly = [&](float (&m)[ISETS]) {
#pragma unroll
      for (int half = ISETS / 2; half >= 1; half /= 2) {
        const bool up = (iset & half) != 0;
#pragma unroll
        for (int e = 0; e < half; ++e) {
          const float send = up ? m[e] : m[e + half];
          const float keep = up ? m[e + half] : m[e];
          m[e] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, half));
        }
      }
    };
    // columns sa and sb of sub-chunk p, walked within it
    const int p = pidx / 8, qq = pidx % 8;
    const int sa = 16 * p + qq, sb = 16 * p + 15 - qq;
    // the diagonal r u k and the zeros below it
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int s = side == 0 ? sa : sb;
      float rr[4], kk[4];
      row4(R + s * P, rr);
      row4(K + s * P, kk);
      float ruk = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ruk = __fmaf_rn(__fmul_rn(rr[e], uu[e]), kk[e], ruk);
#pragma unroll
      for (int m = 1; m < ISETS; m *= 2)
        ruk = __fadd_rn(ruk, __shfl_xor_sync(0xffffffffu, ruk, m));
      if (iset == 0) DM[s * DP + s] = ruk;
      for (int t = s + 1 + iset; t < C; t += ISETS) DM[t * DP + s] = 0.0f;
    }
    // M[t][s] for t < s in the sub-chunk: s = sa for the first qq steps,
    // then s = sb (15 steps in all), in batches of ISETS steps
    auto step_of = [&](int it, int& ss, int& tt) {
      ss = it < qq ? sa : sb;
      tt = it < qq ? sa - 1 - it : sb - 1 - (it - qq);
    };
    float q[4];
    row4(R + sa * P, q);
    for (int base = 0; base < 15; base += ISETS) {
      float m[ISETS];
#pragma unroll
      for (int e = 0; e < ISETS; ++e) {
        const int it = base + e;
        m[e] = 0.0f;
        if (it < 15) {
          if (it == qq) row4(R + sb * P, q);
          int ss, tt;
          step_of(it, ss, tt);
          float kk[4], ww[4];
          row4(K + tt * P, kk);
          row4(W + tt * P, ww);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            m[e] = __fmaf_rn(kk[x], q[x], m[e]);
            q[x] = __fmul_rn(q[x], ww[x]);
          }
        }
      }
      butterfly(m);
      if (base + iset < 15) {
        int ss, tt;
        step_of(base + iset, ss, tt);
        DM[tt * DP + ss] = m[0];
      }
    }
  }
  if constexpr (NSUB == 2) {
    // across the sub-chunks: M[t][16 + s'] = KL_t . RF_s', an 8-column
    // half a warp (warps 0 and 1)
    if (warp < 2) {
      float acc[1][1][4] = {};
      mma_acc<1, 1>(acc, SS + C * P, P, 1, SS + (C + 16 + 8 * warp) * P, 1,
                    P, 0, HT);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        DM[frag_row(q) * DP + 16 + 8 * warp + frag_col(0, q)] = acc[0][0][q];
    }
  }
  __syncthreads();

  // phase 5: dv[t][j] = sum_i kA[t][i] G^[i][j] + sum_{s >= t} M[t][s]
  // do_s[j] (M is zero below its diagonal)
  {
    float acc[1][2][4] = {};
    mma_acc<1, 2>(acc, KT + m0 * P, P, 1, GG + n0, P, 1, 0, HT);
    mma_acc<1, 2>(acc, DM + m0 * DP, DP, 1, DO + n0, P, 1, m0, C);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tt = m0 + frag_row(q), j = n0 + frag_col(nt, q);
        if (tt < n && j < hd) store(dv + at + tt * step + j, acc[0][nt][q]);
      }
  }
  // this part's steps walked back from its end with a relative to a
  // there (x_s = a_rel - k_s dk'_s, kept for phase 6), the u terms of dr
  // and dk (stored), this part's share of du and its sum of r dr' - k dk'
  double x[8];
  {
    const float ui = li < hd ? u[h * hd + li] : 0.0f;
    double a_rel = 0.0;
    float du_acc = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = 8 * part + 7 - e, o = s * P + li;
      const float rr = R[o], kk = K[o], drv = SS[o], dkv = V[o], dt = dots[s];
      const double kdv = (double)kk * (double)dkv;
      x[e] = a_rel - kdv;
      a_rel += (double)rr * (double)drv - kdv;
      if (s < n && li < hd) {
        const long long idx = at + s * step + li;
        store(dr + idx, __fmaf_rn(__fmul_rn(ui, kk), dt, drv));
        store(dk + idx, __fmaf_rn(__fmul_rn(ui, rr), dt, dkv));
      }
      du_acc = __fmaf_rn(__fmul_rn(rr, kk), dt, du_acc);
    }
    psum[part * HT + li] = a_rel;
    du_p[part * HT + li] = du_acc;
  }
  __syncthreads();

  // phase 6: a at this part's end, from a_{t1} and the later parts; dw
  {
    double g = 0.0, kd = 0.0;
    for (int p = 0; p < PARTS; ++p) g += gs_part[p * HT + li];
    for (int m = 0; m < C / 16; ++m) kd += kd_part[m * HT + li];
    double a = (double)tot[li] * g + kd;
    for (int p = PARTS - 1; p > part; --p) a += psum[p * HT + li];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int s = 8 * part + 7 - e;
      if (s < n && li < hd)
        store(dw + at + s * step + li, (float)(a + x[e]) / W[s * P + li]);
    }
  }
  if (tid < hd) {
    float sum = du_p[tid];
    for (int p = 1; p < PARTS; ++p) sum = __fadd_rn(sum, du_p[p * HT + tid]);
    du_part[((long long)bh * nc + c) * hd + tid] = sum;
  }
}

// du[h][i], block h: thread (i, g) adds the parts [B][H][nc][hd] of the
// chunks c = g mod DU_GROUPS over b, then c, in ascending order; thread
// (i, 0) adds the groups' sums in ascending g.
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int H,
                                    int nc, int hd) {
  __shared__ float sums[DU_GROUPS][MAX_HEAD_DIM];
  const int h = blockIdx.x, i = threadIdx.x % hd, g = threadIdx.x / hd;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* const p = du_part + ((long long)b * H + h) * nc * hd + i;
#pragma unroll 4
    for (int c = g; c < nc; c += DU_GROUPS)
      sum = __fadd_rn(sum, p[(long long)c * hd]);
  }
  sums[g][i] = sum;
  __syncthreads();
  if (g == 0) {
    for (int gg = 1; gg < DU_GROUPS; ++gg) sum = __fadd_rn(sum, sums[gg][i]);
    du[h * hd + i] = sum;
  }
}

template <typename Elt, int HT>
static cudaError_t launch_tile(const Elt* r, const Elt* k, const Elt* v,
                               const Elt* w, const float* u, const float* s0,
                               const Elt* dO, const float* dsT, Elt* dr,
                               Elt* dk, Elt* dv, Elt* dw, float* du,
                               float* ds0, float* Sst, float* Gst,
                               float* du_part, int B, int T, int H, int hd,
                               cudaStream_t s) {
  constexpr int C = BwdTile<HT>::C;
  const int nc = (T + C - 1) / C;
  const int el = (int)sizeof(Elt), width = el == 4 ? 16 : 8;
  const int vec = hd % 4 == 0 && aligned(r, width) && aligned(k, width) &&
                  aligned(v, width) && aligned(w, width) &&
                  aligned(dO, width);
  const size_t smem1 = state_smem_bytes<HT>(), smem2 = chunk_smem_bytes<HT>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_state_kernel<Elt, HT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel<Elt, HT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  rwkv6_bwd_state_kernel<Elt, HT>
      <<<(unsigned)((long long)2 * B * H), StateWarps<HT>::THREADS, smem1,
         s>>>(
          r, k, v, w, s0, dO, dsT, Sst, Gst, ds0, T, H, hd, nc, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nc > 0) {
    rwkv6_bwd_chunk_kernel<Elt, HT>
        <<<(unsigned)((long long)nc * B * H), kChunkThreads<HT>, smem2,
           s>>>(r, k, v, w, u, dO, Sst, Gst, dr, dk, dv, dw, du_part, T, H,
                hd, nc, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rwkv6_bwd_du_kernel<<<(unsigned)H, hd * DU_GROUPS, 0, s>>>(du_part, du, B,
                                                            H, nc, hd);
  return cudaGetLastError();
}

template <typename Elt>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, const void* dO,
                  const float* dsT, void* dr, void* dk, void* dv, void* dw,
                  float* du, float* ds0, float* Sst, float* Gst,
                  float* du_part, int B, int T, int H, int hd,
                  cudaStream_t s) {
  const Elt *rr = static_cast<const Elt*>(r), *kk = static_cast<const Elt*>(k),
            *vv = static_cast<const Elt*>(v), *ww = static_cast<const Elt*>(w),
            *oo = static_cast<const Elt*>(dO);
  Elt *a = static_cast<Elt*>(dr), *bb = static_cast<Elt*>(dk),
      *c = static_cast<Elt*>(dv), *d = static_cast<Elt*>(dw);
  switch (head_tile(hd)) {
    case 32:
      return (int)launch_tile<Elt, 32>(rr, kk, vv, ww, u, s0, oo, dsT, a, bb,
                                       c, d, du, ds0, Sst, Gst, du_part, B, T,
                                       H, hd, s);
    case 64:
      return (int)launch_tile<Elt, 64>(rr, kk, vv, ww, u, s0, oo, dsT, a, bb,
                                       c, d, du, ds0, Sst, Gst, du_part, B, T,
                                       H, hd, s);
    default:
      return (int)launch_tile<Elt, 128>(rr, kk, vv, ww, u, s0, oo, dsT, a,
                                        bb, c, d, du, ds0, Sst, Gst, du_part,
                                        B, T, H, hd, s);
  }
}

// 1 for each head size the kernels take (1 .. MAX_HEAD_DIM), else 0.
extern "C" int rwkv6_chunk_bwd_takes_head_dim(int hd) {
  return hd >= 1 && hd <= MAX_HEAD_DIM;
}

// Threads of a chunk block (pass 2) at head size hd.
extern "C" int rwkv6_chunk_bwd_threads(int hd) {
  switch (head_tile(hd)) {
    case 32: return kChunkThreads<32>;
    case 64: return kChunkThreads<64>;
    default: return kChunkThreads<128>;
  }
}

// Steps of a chunk at head size hd.
extern "C" int rwkv6_chunk_bwd_chunk(int hd) {
  switch (head_tile(hd)) {
    case 32: return BwdTile<32>::C;
    case 64: return BwdTile<64>::C;
    default: return BwdTile<128>::C;
  }
}

// r, k, v, w, do, dr, dk, dv, dw: [B, T, H, hd] device pointers of
// elem_bytes (4: f32, 2: bf16) elements; u, du [H, hd], s0, dsT (null:
// zeros) and ds0 [B, H, hd, hd]: f32.  Scratch, f32: Sst and Gst [B, H,
// nc, HT, HT] (the boundary states, HT the head tile), du_part [B, H, nc,
// hd], nc = ceil(T / C).  All contiguous.  Returns a cudaError_t (0 on
// success); the launches are asynchronous on `stream`.
extern "C" int rwkv6_chunk_bwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dO, const void* dsT, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* ds0, void* Sst, void* Gst,
                               void* du_part, int B, int T, int H, int hd,
                               int elem_bytes, void* stream) {
  if (B < 1 || H < 1 || T < 0 || !rwkv6_chunk_bwd_takes_head_dim(hd) ||
      (long long)2 * B * H > 2147483647LL ||
      (long long)((T + 15) / 16) * B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsTf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* Sf = static_cast<float*>(Sst);
  float* Gf = static_cast<float*>(Gst);
  float* partf = static_cast<float*>(du_part);
  if (elem_bytes == 4)
    return launch<float>(r, k, v, w, uf, s0f, dO, dsTf, dr, dk, dv, dw, duf,
                         ds0f, Sf, Gf, partf, B, T, H, hd, s);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(r, k, v, w, uf, s0f, dO, dsTf, dr, dk, dv,
                                 dw, duf, ds0f, Sf, Gf, partf, B, T, H, hd,
                                 s);
  return (int)cudaErrorInvalidValue;
}
