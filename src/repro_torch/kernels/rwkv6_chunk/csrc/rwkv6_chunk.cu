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
// Any hd from 1 to MAX_HEAD_DIM.
//
// What bounds it on the card: bytes (r, k, v, w read once and o written
// once dominate; 4 hd^2 operations per (b, t, h) at the f32 rate take
// about two thirds of the time the bytes take).  But the recurrence is
// serial in t, so what bounds a kernel of one block per (b, h) is issue:
// about 5 f32 operations per state element and step, on the SM that holds
// the state.
//
// The design: one block per (b, h).  The hd columns j are padded to a
// head tile HT (32, 64 or 128) and the HT rows i are split into G row
// groups of R = HT / G rows; thread (g, j) keeps S[i][j] for the R rows i
// of group g in registers.  Given r, k, w and u, every state element
// evolves on its own, so no thread waits on another within a step.  At
// hd 64 that is 512 threads (16 warps, all four schedulers busy) with
// chains of 8 rows where the first port had 64 threads with chains of 64.
// o_t[j] is a sum over all rows, so each group writes its partial (over
// its rows, ascending i) to shared memory, and once per chunk of CHUNK
// steps the block adds the partials of every step in ascending g and
// writes o: one block barrier per chunk, none per step.  The summation
// order depends only on hd, so o is deterministic.
//
// Staging: r, k, w and v of CHUNK steps are copied into shared memory by
// cp.async, double-buffered, so that loading chunk c + 1 overlaps the walk
// of chunk c (16-byte copies when a head's row is a multiple of 16 bytes
// and the pointers are aligned; 4-byte copies or plain loads otherwise).
// The state comes in and goes out through shared memory with the same
// copies, coalesced; the initial state's copy shares the first chunk's
// group, so a single step (decode, T = 1) waits for one round trip.
// Padding lanes (j >= hd) of r, k, w, v and u are zeros: padded rows add
// exact zeros to o and keep a zero state, padded columns are never
// stored.
//
// Rounding: k*v, w*S and w*S + k*v are each rounded as the plain PyTorch
// version rounds them (__fmul_rn/__fadd_rn, no contraction), so sT equals
// the plain version bit for bit.  o's terms r_i * (S + u_i*k_i*v_j) are
// formed with two fused multiply-adds and summed in the order above; o
// differs from the plain version (a cuBLAS batched product) by the
// rounding of a dot product.

#include "wkv_io.cuh"

// Per head tile: row groups G (threads HT * G), steps per chunk, and
// steps a thread's loop takes at a time (2 where the registers allow).
template <int HT> struct Tile;
template <> struct Tile<32> {
  static constexpr int G = 4, CHUNK = 32, UNROLL = 2;
};
template <> struct Tile<64> {
  static constexpr int G = 8, CHUNK = 32, UNROLL = 2;
};
template <> struct Tile<128> {
  static constexpr int G = 4, CHUNK = 16, UNROLL = 1;
};

// Dynamic shared memory of one block: two input buffers of r, k, w, v
// [CHUNK][HT] each, u [HT] f32, two partial buffers [CHUNK][G][HT] f32
// (which also stage the state, [hd][hd] f32, at the start and the end).
template <typename Elt, int HT>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * 4 * Tile<HT>::CHUNK * HT * sizeof(Elt) +
         (size_t)HT * sizeof(float) +
         (size_t)2 * Tile<HT>::CHUNK * Tile<HT>::G * HT * sizeof(float);
}

template <typename Elt, int HT>
__global__ void __launch_bounds__(HT * Tile<HT>::G, 1)
rwkv6_chunk_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
                   const Elt* __restrict__ v, const Elt* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   Elt* __restrict__ o, float* __restrict__ sT, int T, int H,
                   int hd, int in_width, int state_width) {
  constexpr int G = Tile<HT>::G, CHUNK = Tile<HT>::CHUNK;
  constexpr int UNROLL = Tile<HT>::UNROLL;
  constexpr int R = HT / G, NT = HT * G;
  constexpr int BUF = 4 * CHUNK * HT;  // elements of one input buffer
  static_assert(R % 4 == 0, "rows of a group are read four at a time");
  static_assert(2 * CHUNK * G >= HT, "the state fits the partial buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  Elt* const in = reinterpret_cast<Elt*>(smem);  // [2][r, k, w, v][CHUNK][HT]
  float* const us = reinterpret_cast<float*>(in + 2 * BUF);  // [HT]
  float* const part = us + HT;        // [2][CHUNK][G][HT]
  float* const sbuf = part;           // the state [hd][hd], at both ends

  const int tid = threadIdx.x, g = tid / HT, j = tid - g * HT;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const long long step = (long long)H * hd;               // between steps
  const long long base = ((long long)b * T * H + h) * hd;  // (b, 0, h, 0)
  const int nc = (T + CHUNK - 1) / CHUNK;
  const int row_bytes = hd * (int)sizeof(Elt);

  // padding lanes stay zero in both buffers (the copies write j < hd)
  for (int idx = tid; idx < 2 * BUF; idx += NT)
    if (idx % HT >= hd) zero(in + idx);
  if (tid < HT) us[tid] = tid < hd ? u[h * hd + tid] : 0.0f;

  // chunk c's steps into buffer c % 2: four arrays of n rows each
  auto stage = [&](int c) {
    const int t0 = c * CHUNK, n = min(CHUNK, T - t0);
    Elt* const dst = in + (c & 1) * BUF;
    const Elt* const srcs[4] = {r, k, w, v};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      copy_rows<Elt>(reinterpret_cast<char*>(dst + a * CHUNK * HT),
                     HT * sizeof(Elt),
                     reinterpret_cast<const char*>(srcs[a] + base +
                                                   (long long)t0 * step),
                     step * sizeof(Elt), n, row_bytes, in_width, tid, NT);
  };

  // group 0: the initial state and chunk 0; group 1: chunk 1
  copy_rows<float>(reinterpret_cast<char*>(sbuf), 0,
                   reinterpret_cast<const char*>(s0 + (long long)bh * hd * hd),
                   0, 1, hd * hd * 4, state_width, tid, NT);
  if (nc > 0) stage(0);
  cp_async_commit();
  if (nc > 1) stage(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float S[R], uu[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = g * R + q;
    S[q] = i < hd && j < hd ? sbuf[i * hd + j] : 0.0f;
    uu[q] = us[i];
  }
  __syncthreads();  // the state is read before walk 0 writes partials

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CHUNK, n = min(CHUNK, T - t0);
    const Elt* const ib = in + (c & 1) * BUF;
    float* const pb = part + (c & 1) * CHUNK * G * HT;
#pragma unroll UNROLL
    for (int cc = 0; cc < n; ++cc) {
      const Elt* const rs = ib + cc * HT + g * R;
      const Elt* const ks = rs + CHUNK * HT;
      const Elt* const ws = ks + CHUNK * HT;
      const float vj = to_f32(ib[3 * CHUNK * HT + cc * HT + j]);
      float p = 0.0f;
#pragma unroll
      for (int q = 0; q < R; q += 4) {
        const float4 r4 = load4(rs + q), k4 = load4(ks + q),
                     w4 = load4(ws + q);
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kq[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = __fmul_rn(kq[e], vj);
          p = __fmaf_rn(rq[e], __fmaf_rn(uu[q + e], kv, S[q + e]), p);
          S[q + e] = __fadd_rn(__fmul_rn(wq[e], S[q + e]), kv);
        }
      }
      pb[(cc * G + g) * HT + j] = p;
    }
    // chunk c + 1 has landed (the only copies in flight) and every
    // thread is done with buffer c % 2 and with chunk c's partials
    cp_async_wait<0>();
    __syncthreads();
    if (c + 2 < nc) stage(c + 2);
    cp_async_commit();
    // o of chunk c: the groups' partials in ascending g
    for (int idx = tid; idx < n * HT; idx += NT) {
      const int cc = idx / HT, jj = idx - cc * HT;
      if (jj < hd) {
        const float* pp = pb + cc * G * HT + jj;
        float s = pp[0];
#pragma unroll
        for (int gg = 1; gg < G; ++gg) s = __fadd_rn(s, pp[gg * HT]);
        store(o + base + (long long)(t0 + cc) * step + jj, s);
      }
    }
  }

  __syncthreads();  // the last chunk's partials are read
  if (j < hd)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = g * R + q;
      if (i < hd) sbuf[i * hd + j] = S[q];
    }
  __syncthreads();
  float* const sTp = sT + (long long)bh * hd * hd;
  if (state_width == 16) {
    for (int idx = tid; idx < hd * hd / 4; idx += NT)
      reinterpret_cast<float4*>(sTp)[idx] =
          reinterpret_cast<const float4*>(sbuf)[idx];
  } else {
    for (int idx = tid; idx < hd * hd; idx += NT) sTp[idx] = sbuf[idx];
  }
}

template <typename Elt, int HT>
static cudaError_t launch_tile(const Elt* r, const Elt* k, const Elt* v,
                               const Elt* w, const float* u, const float* s0,
                               Elt* o, float* sT, int B, int T, int H,
                               int hd, cudaStream_t s) {
  const size_t smem = smem_bytes<Elt, HT>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<Elt, HT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the copy width: 16 bytes where every row and pointer allows it
  const int row_bytes = hd * (int)sizeof(Elt);
  auto fits = [&](int width) {
    return row_bytes % width == 0 && aligned(r, width) && aligned(k, width) &&
           aligned(v, width) && aligned(w, width);
  };
  const int in_width = fits(16) ? 16 : fits(4) ? 4 : 0;
  const int state_width =
      (hd * hd) % 4 == 0 && aligned(s0, 16) && aligned(sT, 16) ? 16 : 4;
  rwkv6_chunk_kernel<Elt, HT><<<(unsigned)((long long)B * H),
                                HT * Tile<HT>::G, smem, s>>>(
      r, k, v, w, u, s0, o, sT, T, H, hd, in_width, state_width);
  return cudaGetLastError();
}

template <typename Elt>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* o, float* sT, int B,
                  int T, int H, int hd, cudaStream_t s) {
  const Elt *rr = static_cast<const Elt*>(r), *kk = static_cast<const Elt*>(k),
            *vv = static_cast<const Elt*>(v), *ww = static_cast<const Elt*>(w);
  Elt* oo = static_cast<Elt*>(o);
  switch (head_tile(hd)) {
    case 32:
      return (int)launch_tile<Elt, 32>(rr, kk, vv, ww, u, s0, oo, sT, B, T,
                                       H, hd, s);
    case 64:
      return (int)launch_tile<Elt, 64>(rr, kk, vv, ww, u, s0, oo, sT, B, T,
                                       H, hd, s);
    default:
      return (int)launch_tile<Elt, 128>(rr, kk, vv, ww, u, s0, oo, sT, B, T,
                                        H, hd, s);
  }
}

// 1 for each head size the kernel takes (1 .. MAX_HEAD_DIM), else 0.
extern "C" int rwkv6_chunk_takes_head_dim(int hd) {
  return hd >= 1 && hd <= MAX_HEAD_DIM;
}

// Threads of the block that walks one (b, h) at head size hd.
extern "C" int rwkv6_chunk_threads(int hd) {
  switch (head_tile(hd)) {
    case 32: return 32 * Tile<32>::G;
    case 64: return 64 * Tile<64>::G;
    default: return 128 * Tile<128>::G;
  }
}

// r, k, v, w, o: [B, T, H, hd] device pointers of elem_bytes (4: f32,
// 2: bf16) elements; u [H, hd], s0 and sT [B, H, hd, hd]: f32.  All
// contiguous.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int rwkv6_chunk(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* sT, int B, int T, int H, int hd,
                           int elem_bytes, void* stream) {
  if (B < 1 || H < 1 || T < 0 || !rwkv6_chunk_takes_head_dim(hd) ||
      (long long)B * H > 2147483647LL)
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
