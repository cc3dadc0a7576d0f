// The RWKV6 WKV recurrence's backward on Hopper (sm_90a).
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
// bf16); u and du [H, hd], s0, sT, dsT and ds0 [B, H, hd, hd], all f32.
// All arithmetic is f32; the suffix sums of dw in f64.  Any hd from 1 to
// MAX_HEAD_DIM.
//
// What bounds it on the card: bytes (r, k, v, w, do read once, dr, dk, dv,
// dw written once), and about 10 hd^2 operations per (b, t, h) take about
// as long at the f32 rate.  But, as in the forward, every walk is serial
// in t, so a block per (b, h) is bound by issue on its SM.
//
// The design: three walks over t, each the forward's block shape (thread
// (g, j) keeps column j of a [HT][HT] state over the R rows of group g in
// registers, each group's partial of the output goes to shared memory and
// the block adds them in ascending g once per chunk; the inputs of CHUNK
// steps staged by cp.async, double-buffered).  A walk sums over the rows of
// its state, so each quantity is walked in the layout that makes its sum
// run over rows:
//
//   role 0, forward in t, X = S^T from s0:  dr'_t (dr without its u term)
//   role 1, backward in t, X = G^T from dsT: dk'_t (dk without its u term)
//   role 2, backward in t, X = G from dsT:   dv_t, and ds0 = G_{-1}
//
// Roles 0 and 1 decay the state's columns (X[i][j] = w[j] X[i][j] + ...),
// role 2 its rows, as the forward does.  The three walks do not depend on
// each other and share one grid of 3 B H blocks.
//
// dw needs S_{t-1} and G_t at the same step, while S runs forward and G
// backward; S_{t-1} is not recovered by dividing by w (w reaches down to
// exp(-e) in the model, and T divisions lose the state).  Since
// w_t dw_t = a_t - k_t dk'_t with a_t[i] = sum_j G_t[i][j] S_t[i][j], and
// a_{t-1} = a_t - k_t dk'_t + r_t dr'_t, the finishing kernel walks t
// backward per (b, h, i) from a_{T-1} = sum_j dsT[i][j] sT[i][j]:
//
//   dw_t = (a_t - k_t dk'_t) / w_t,   a_{t-1} = a_t + r_t dr'_t - k_t dk'_t
//
// with a in f64, so the sum's own rounding is negligible beside that of
// dr' and dk'.  It needs w > 0.  The walk is cut into segments of SEGMENT
// steps, a block each (B H ceil(T / SEGMENT) blocks, enough to keep the
// loads in flight): a first kernel sums r dr' - k dk' over each segment,
// and the finishing kernel starts each segment's a from a_{T-1} and the
// later segments' sums.  It also adds the u terms (do_t . v_t once a
// step) to dr and dk and writes each segment's part of du; a last kernel
// adds the parts in order.  No atomics: the results are deterministic.

#include "wkv_io.cuh"

// Per head tile: row groups G (threads HT * G), steps per chunk, and the
// blocks an SM should hold (two where the registers and shared memory
// allow, so that the three walks of the training shape run in one wave).
template <int HT> struct BwdTile;
template <> struct BwdTile<32> {
  static constexpr int G = 4, CHUNK = 32, MIN_BLOCKS = 2;
};
template <> struct BwdTile<64> {
  static constexpr int G = 8, CHUNK = 16, MIN_BLOCKS = 2;
};
template <> struct BwdTile<128> {
  static constexpr int G = 4, CHUNK = 16, MIN_BLOCKS = 1;
};

constexpr int ROLES = 3;             // dr', dk', dv
constexpr int FINISH_THREADS = 128;  // a head's rows (hd <= 128), a thread each
constexpr int SEGMENT = 128;         // steps of the finishing kernels' blocks

// Dynamic shared memory of a walk's block: two input buffers of its four
// arrays [CHUNK][HT], u [HT] f32, two partial buffers [CHUNK][G][HT] f32
// (which also stage a state, [hd][hd] f32, at the start and the end).
template <typename Elt, int HT>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (size_t)2 * 4 * BwdTile<HT>::CHUNK * HT * sizeof(Elt) +
         (size_t)HT * sizeof(float) +
         (size_t)2 * BwdTile<HT>::CHUNK * BwdTile<HT>::G * HT * sizeof(float);
}

// One walk over the T steps of (b, h).  Staged per step: A (buffer row 0),
// Bv (1), W (2) and C (3).  COL false (the forward's recurrence):
//   out[j] = sum_i a[i] (X[i][j] + u[i] b[i] c[j]),  X[i][j] = w[i] X + b[i] c[j]
// COL true (no u):
//   out[j] = sum_i a[i] X[i][j],                    X[i][j] = w[j] X + c[i] b[j]
// REV walks t = T-1 .. 0.  x0 (null: zeros) is the initial state as it lies
// in memory, read transposed when COL; xT (null: not kept) receives the
// final state (COL false only).
template <typename Elt, typename Out, int HT, bool COL, bool REV>
__device__ __forceinline__ void walk(
    const Elt* __restrict__ A, const Elt* __restrict__ Bv,
    const Elt* __restrict__ W, const Elt* __restrict__ C,
    const float* __restrict__ u, const float* __restrict__ x0,
    Out* __restrict__ out, float* __restrict__ xT, int T, int H, int hd,
    int b, int h, int in_width, int state_width, unsigned char* smem) {
  constexpr int G = BwdTile<HT>::G, CHUNK = BwdTile<HT>::CHUNK;
  constexpr int R = HT / G, NT = HT * G;
  constexpr int BUF = 4 * CHUNK * HT;  // elements of one input buffer
  static_assert(R % 4 == 0, "rows of a group are read four at a time");
  static_assert(2 * CHUNK * G >= HT, "a state fits the partial buffers");
  Elt* const in = reinterpret_cast<Elt*>(smem);  // [2][A,B,W,C][CHUNK][HT]
  float* const us = reinterpret_cast<float*>(in + 2 * BUF);  // [HT]
  float* const part = us + HT;        // [2][CHUNK][G][HT]
  float* const sbuf = part;           // a state [hd][hd], at both ends

  const int tid = threadIdx.x, g = tid / HT, j = tid - g * HT;
  const long long step = (long long)H * hd;               // between steps
  const long long base = ((long long)b * T * H + h) * hd;  // (b, 0, h, 0)
  const long long bh = (long long)b * H + h;
  const int nc = (T + CHUNK - 1) / CHUNK;
  const int row_bytes = hd * (int)sizeof(Elt);
  // the time of the s-th step walked
  auto at = [&](int s) -> long long {
    return REV ? (long long)(T - 1 - s) : (long long)s;
  };

  for (int idx = tid; idx < 2 * BUF; idx += NT)
    if (idx % HT >= hd) zero(in + idx);
  if (tid < HT) {
    float uv = 0.0f;
    if constexpr (!COL) uv = tid < hd ? u[h * hd + tid] : 0.0f;
    us[tid] = uv;
  }

  // chunk c's steps (in walking order) into buffer c % 2
  auto stage = [&](int c) {
    const int first = c * CHUNK, n = min(CHUNK, T - first);
    Elt* const dst = in + (c & 1) * BUF;
    const Elt* const srcs[4] = {A, Bv, W, C};
    const long long stride = (REV ? -step : step) * (long long)sizeof(Elt);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      copy_rows<Elt>(reinterpret_cast<char*>(dst + a * CHUNK * HT),
                     HT * sizeof(Elt),
                     reinterpret_cast<const char*>(srcs[a] + base +
                                                   at(first) * step),
                     stride, n, row_bytes, in_width, tid, NT);
  };

  // group 0: the initial state and chunk 0; group 1: chunk 1
  if (x0 != nullptr)
    copy_rows<float>(reinterpret_cast<char*>(sbuf), 0,
                     reinterpret_cast<const char*>(x0 + bh * hd * hd), 0, 1,
                     hd * hd * 4, state_width, tid, NT);
  if (nc > 0) stage(0);
  cp_async_commit();
  if (nc > 1) stage(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float X[R], uu[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = g * R + q;
    float x = 0.0f;
    if (x0 != nullptr && i < hd && j < hd)
      x = COL ? sbuf[j * hd + i] : sbuf[i * hd + j];
    X[q] = x;
    uu[q] = us[i];
  }
  __syncthreads();  // the state is read before walk 0 writes partials

  for (int c = 0; c < nc; ++c) {
    const int first = c * CHUNK, n = min(CHUNK, T - first);
    const Elt* const ib = in + (c & 1) * BUF;
    float* const pb = part + (c & 1) * CHUNK * G * HT;
    for (int cc = 0; cc < n; ++cc) {
      const Elt* const as = ib + cc * HT + g * R;
      float p = 0.0f;
      if constexpr (COL) {
        const Elt* const cs = as + 3 * CHUNK * HT;
        const float bj = to_f32(ib[CHUNK * HT + cc * HT + j]);
        const float wj = to_f32(ib[2 * CHUNK * HT + cc * HT + j]);
#pragma unroll
        for (int q = 0; q < R; q += 4) {
          const float4 a4 = load4(as + q), c4 = load4(cs + q);
          const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
          const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p = __fmaf_rn(aq[e], X[q + e], p);
            X[q + e] = __fmaf_rn(wj, X[q + e], __fmul_rn(cq[e], bj));
          }
        }
      } else {
        const Elt* const bs = as + CHUNK * HT;
        const Elt* const ws = as + 2 * CHUNK * HT;
        const float cj = to_f32(ib[3 * CHUNK * HT + cc * HT + j]);
#pragma unroll
        for (int q = 0; q < R; q += 4) {
          const float4 a4 = load4(as + q), b4 = load4(bs + q),
                       w4 = load4(ws + q);
          const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
          const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kv = __fmul_rn(bq[e], cj);
            p = __fmaf_rn(aq[e], __fmaf_rn(uu[q + e], kv, X[q + e]), p);
            X[q + e] = __fmaf_rn(wq[e], X[q + e], kv);
          }
        }
      }
      pb[(cc * G + g) * HT + j] = p;
    }
    // chunk c + 1 has landed and every thread is done with buffer c % 2
    cp_async_wait<0>();
    __syncthreads();
    if (c + 2 < nc) stage(c + 2);
    cp_async_commit();
    // the output of chunk c: the groups' partials in ascending g
    for (int idx = tid; idx < n * HT; idx += NT) {
      const int cc = idx / HT, jj = idx - cc * HT;
      if (jj < hd) {
        const float* pp = pb + cc * G * HT + jj;
        float s = pp[0];
#pragma unroll
        for (int gg = 1; gg < G; ++gg) s = __fadd_rn(s, pp[gg * HT]);
        store(out + base + at(first + cc) * step + jj, s);
      }
    }
  }

  if constexpr (!COL) {
    if (xT == nullptr) return;
    __syncthreads();  // the last chunk's partials are read
    if (j < hd)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = g * R + q;
        if (i < hd) sbuf[i * hd + j] = X[q];
      }
    __syncthreads();
    float* const dst = xT + bh * hd * hd;
    if (state_width == 16) {
      for (int idx = tid; idx < hd * hd / 4; idx += NT)
        reinterpret_cast<float4*>(dst)[idx] =
            reinterpret_cast<const float4*>(sbuf)[idx];
    } else {
      for (int idx = tid; idx < hd * hd; idx += NT) dst[idx] = sbuf[idx];
    }
  }
}

// The three walks: block role * B * H + (b * H + h).
template <typename Elt, int HT>
__global__ void __launch_bounds__(HT * BwdTile<HT>::G,
                                  BwdTile<HT>::MIN_BLOCKS)
rwkv6_bwd_walk_kernel(const Elt* r, const Elt* k, const Elt* v,
                      const Elt* w, const float* u, const float* s0,
                      const Elt* dO, const float* dsT, float* drp, float* dkp,
                      Elt* dv, float* ds0, int B, int T, int H, int hd,
                      int in_width, int state_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbh = B * H;
  const int role = blockIdx.x / nbh, bh = blockIdx.x - role * nbh;
  const int b = bh / H, h = bh - b * H;
  if (role == 0)  // dr': S^T forward from s0
    walk<Elt, float, HT, true, false>(dO, k, w, v, nullptr, s0, drp, nullptr,
                                      T, H, hd, b, h, in_width, state_width,
                                      smem);
  else if (role == 1)  // dk': G^T backward from dsT
    walk<Elt, float, HT, true, true>(v, r, w, dO, nullptr, dsT, dkp, nullptr,
                                     T, H, hd, b, h, in_width, state_width,
                                     smem);
  else  // dv and ds0: G backward from dsT
    walk<Elt, Elt, HT, false, true>(k, r, w, dO, u, dsT, dv, ds0, T, H, hd, b,
                                    h, in_width, state_width, smem);
}

// Per (b, h, segment, i): the sum over the segment's steps of
// r_t dr'_t - k_t dk'_t, in f64 (the products are exact there).
template <typename Elt>
__global__ void __launch_bounds__(FINISH_THREADS)
rwkv6_bwd_segment_kernel(const Elt* __restrict__ r,
                         const Elt* __restrict__ k,
                         const float* __restrict__ drp,
                         const float* __restrict__ dkp,
                         double* __restrict__ seg_sum, int T, int H, int hd) {
  const int i = threadIdx.x, bh = blockIdx.x, seg = blockIdx.y;
  if (i >= hd) return;
  const int b = bh / H, h = bh - b * H;
  const long long step = (long long)H * hd;
  const long long base = ((long long)b * T * H + h) * hd + i;
  const int t0 = seg * SEGMENT, t1 = min(T, t0 + SEGMENT);
  double sum = 0.0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const long long idx = base + (long long)t * step;
    sum += (double)to_f32(r[idx]) * (double)drp[idx] -
           (double)to_f32(k[idx]) * (double)dkp[idx];
  }
  seg_sum[((long long)bh * gridDim.y + seg) * hd + i] = sum;
}

// One block per (b, h, segment), thread i a row: a_t from a_{T-1} and the
// later segments' sums (in descending order), then the segment's steps
// walked backward: dw, the u terms of dr and dk, and this (b, h,
// segment)'s part of du.  First the block forms do_t . v_t of the
// segment's steps, a thread a step, over j in ascending order.
template <typename Elt>
__global__ void __launch_bounds__(FINISH_THREADS)
rwkv6_bwd_finish_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                        const Elt* __restrict__ v, const Elt* __restrict__ w,
                        const Elt* __restrict__ dO,
                        const float* __restrict__ u,
                        const float* __restrict__ sT,
                        const float* __restrict__ dsT,
                        const float* __restrict__ drp,
                        const float* __restrict__ dkp,
                        const double* __restrict__ seg_sum,
                        Elt* __restrict__ dr, Elt* __restrict__ dk,
                        Elt* __restrict__ dw, float* __restrict__ du_part,
                        int T, int H, int hd) {
  __shared__ float dots[SEGMENT];
  const int tid = threadIdx.x, bh = blockIdx.x, seg = blockIdx.y;
  const int nseg = gridDim.y;
  const int b = bh / H, h = bh - b * H;
  const long long step = (long long)H * hd;
  const long long base = ((long long)b * T * H + h) * hd;
  const int t0 = seg * SEGMENT, n = min(SEGMENT, T - t0);
  for (int s = tid; s < n; s += FINISH_THREADS) {
    const long long off = base + (long long)(t0 + s) * step;
    float d = 0.0f;
#pragma unroll 8
    for (int jj = 0; jj < hd; ++jj)
      d = __fmaf_rn(to_f32(dO[off + jj]), to_f32(v[off + jj]), d);
    dots[s] = d;
  }
  __syncthreads();
  const int i = tid;
  if (i >= hd) return;
  const float ui = u[h * hd + i];
  double a = 0.0;
  if (dsT != nullptr) {
    const float* gp = dsT + (long long)bh * hd * hd + (long long)i * hd;
    const float* sp = sT + (long long)bh * hd * hd + (long long)i * hd;
    for (int jj = 0; jj < hd; ++jj) a += (double)gp[jj] * (double)sp[jj];
  }
  for (int sg = nseg - 1; sg > seg; --sg)
    a += seg_sum[((long long)bh * nseg + sg) * hd + i];
  float du_acc = 0.0f;
#pragma unroll 4
  for (int s = n - 1; s >= 0; --s) {
    const long long idx = base + (long long)(t0 + s) * step + i;
    const float rr = to_f32(r[idx]), kk = to_f32(k[idx]),
                ww = to_f32(w[idx]);
    const float drv = drp[idx], dkv = dkp[idx], dt = dots[s];
    const double kd = (double)kk * (double)dkv;
    store(dw + idx, (float)(a - kd) / ww);
    a += (double)rr * (double)drv - kd;
    store(dr + idx, __fmaf_rn(__fmul_rn(ui, kk), dt, drv));
    store(dk + idx, __fmaf_rn(__fmul_rn(ui, rr), dt, dkv));
    du_acc = __fmaf_rn(__fmul_rn(rr, kk), dt, du_acc);
  }
  du_part[((long long)bh * nseg + seg) * hd + i] = du_acc;
}

// du[h][i]: the parts [B][H][nseg][hd] added over b, then segments, in
// ascending order.
__global__ void rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                    float* __restrict__ du, int B, int H,
                                    int nseg, int hd) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * hd) return;
  const int h = idx / hd, i = idx - h * hd;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b)
    for (int sg = 0; sg < nseg; ++sg)
      sum = __fadd_rn(
          sum, du_part[(((long long)b * H + h) * nseg + sg) * hd + i]);
  du[idx] = sum;
}

template <typename Elt, int HT>
static cudaError_t launch_tile(const Elt* r, const Elt* k, const Elt* v,
                               const Elt* w, const float* u, const float* s0,
                               const float* sT, const Elt* dO,
                               const float* dsT, Elt* dr, Elt* dk, Elt* dv,
                               Elt* dw, float* du, float* ds0, float* drp,
                               float* dkp, double* seg_sum, float* du_part,
                               int B, int T, int H, int hd, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<Elt, HT>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_walk_kernel<Elt, HT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_bytes = hd * (int)sizeof(Elt);
  auto fits = [&](int width) {
    return row_bytes % width == 0 && aligned(r, width) && aligned(k, width) &&
           aligned(v, width) && aligned(w, width) && aligned(dO, width);
  };
  const int in_width = fits(16) ? 16 : fits(4) ? 4 : 0;
  const int state_width = (hd * hd) % 4 == 0 && aligned(s0, 16) &&
                                  aligned(dsT, 16) && aligned(ds0, 16)
                              ? 16
                              : 4;
  rwkv6_bwd_walk_kernel<Elt, HT>
      <<<(unsigned)((long long)ROLES * B * H), HT * BwdTile<HT>::G, smem,
         s>>>(r, k, v, w, u, s0, dO, dsT, drp, dkp, dv, ds0, B, T, H, hd,
              in_width, state_width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nseg = (T + SEGMENT - 1) / SEGMENT;
  if (nseg > 0) {
    const dim3 grid((unsigned)((long long)B * H), (unsigned)nseg);
    rwkv6_bwd_segment_kernel<Elt><<<grid, FINISH_THREADS, 0, s>>>(
        r, k, drp, dkp, seg_sum, T, H, hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rwkv6_bwd_finish_kernel<Elt><<<grid, FINISH_THREADS, 0, s>>>(
        r, k, v, w, dO, u, sT, dsT, drp, dkp, seg_sum, dr, dk, dw, du_part, T,
        H, hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = H * hd;
  rwkv6_bwd_du_kernel<<<(unsigned)((n + FINISH_THREADS - 1) / FINISH_THREADS),
                        FINISH_THREADS, 0, s>>>(du_part, du, B, H, nseg, hd);
  return cudaGetLastError();
}

template <typename Elt>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, const float* sT,
                  const void* dO, const float* dsT, void* dr, void* dk,
                  void* dv, void* dw, float* du, float* ds0, float* drp,
                  float* dkp, double* seg_sum, float* du_part, int B, int T,
                  int H, int hd, cudaStream_t s) {
  const Elt *rr = static_cast<const Elt*>(r), *kk = static_cast<const Elt*>(k),
            *vv = static_cast<const Elt*>(v), *ww = static_cast<const Elt*>(w),
            *oo = static_cast<const Elt*>(dO);
  Elt *a = static_cast<Elt*>(dr), *bb = static_cast<Elt*>(dk),
      *c = static_cast<Elt*>(dv), *d = static_cast<Elt*>(dw);
  switch (head_tile(hd)) {
    case 32:
      return (int)launch_tile<Elt, 32>(rr, kk, vv, ww, u, s0, sT, oo, dsT, a,
                                       bb, c, d, du, ds0, drp, dkp, seg_sum,
                                       du_part, B, T, H, hd, s);
    case 64:
      return (int)launch_tile<Elt, 64>(rr, kk, vv, ww, u, s0, sT, oo, dsT, a,
                                       bb, c, d, du, ds0, drp, dkp, seg_sum,
                                       du_part, B, T, H, hd, s);
    default:
      return (int)launch_tile<Elt, 128>(rr, kk, vv, ww, u, s0, sT, oo, dsT,
                                        a, bb, c, d, du, ds0, drp, dkp,
                                        seg_sum, du_part, B, T, H, hd, s);
  }
}

// 1 for each head size the kernels take (1 .. MAX_HEAD_DIM), else 0.
extern "C" int rwkv6_chunk_bwd_takes_head_dim(int hd) {
  return hd >= 1 && hd <= MAX_HEAD_DIM;
}

// Threads of a walk's block at head size hd.
extern "C" int rwkv6_chunk_bwd_threads(int hd) {
  switch (head_tile(hd)) {
    case 32: return 32 * BwdTile<32>::G;
    case 64: return 64 * BwdTile<64>::G;
    default: return 128 * BwdTile<128>::G;
  }
}

// Steps a walk stages at a time at head size hd.
extern "C" int rwkv6_chunk_bwd_chunk(int hd) {
  switch (head_tile(hd)) {
    case 32: return BwdTile<32>::CHUNK;
    case 64: return BwdTile<64>::CHUNK;
    default: return BwdTile<128>::CHUNK;
  }
}

// Steps of a segment of the finishing kernels (the scratch's middle axis
// is ceil(T / SEGMENT)).
extern "C" int rwkv6_chunk_bwd_segment() { return SEGMENT; }

// r, k, v, w, do, dr, dk, dv, dw: [B, T, H, hd] device pointers of
// elem_bytes (4: f32, 2: bf16) elements; u, du [H, hd], s0, sT, dsT (null:
// zeros) and ds0 [B, H, hd, hd]: f32.  Scratch: drp, dkp [B, T, H, hd] f32,
// seg_sum [B, H, nseg, hd] f64 and du_part [B, H, nseg, hd] f32, nseg =
// ceil(T / SEGMENT).  All contiguous.  Returns a cudaError_t (0 on
// success); the launches are asynchronous on `stream`.
extern "C" int rwkv6_chunk_bwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* sT, const void* dO,
                               const void* dsT, void* dr, void* dk, void* dv,
                               void* dw, void* du, void* ds0, void* drp,
                               void* dkp, void* seg_sum, void* du_part, int B,
                               int T, int H, int hd, int elem_bytes,
                               void* stream) {
  if (B < 1 || H < 1 || T < 0 || !rwkv6_chunk_bwd_takes_head_dim(hd) ||
      (long long)ROLES * B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* sTf = static_cast<const float*>(sT);
  const float* dsTf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* drpf = static_cast<float*>(drp);
  float* dkpf = static_cast<float*>(dkp);
  double* segf = static_cast<double*>(seg_sum);
  float* partf = static_cast<float*>(du_part);
  if (elem_bytes == 4)
    return launch<float>(r, k, v, w, uf, s0f, sTf, dO, dsTf, dr, dk, dv, dw,
                         duf, ds0f, drpf, dkpf, segf, partf, B, T, H, hd, s);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(r, k, v, w, uf, s0f, sTf, dO, dsTf, dr, dk,
                                 dv, dw, duf, ds0f, drpf, dkpf, segf, partf, B,
                                 T, H, hd, s);
  return (int)cudaErrorInvalidValue;
}
