// Flash attention (online softmax, GQA, causal on absolute positions) on
// Hopper (sm_90a), f32-accurate products on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (the Pallas TPU kernel, pallas_call at l.73, _kernel at
// l.23).  For q, k [B, Sq or Skv, H or KV, hd] and v [B, Skv, KV, hdv]
// (f32 or bf16, H % KV == 0, q head h reading kv head h / (H / KV); hdv
// = hd as in the TPU kernel, or narrower, as MLA's 192-wide q.k head over
// its 128-wide v head) it computes, in f32,
//
//   s[i, c] = (q[i] * scale) . k[c]          scale = 1 / sqrt(hd)
//   s[i, c] = -1e30 unless c < kv_valid and (not causal or
//             c <= i + q_offset)
//   o[i]    = sum_c softmax(s[i])[c] v[c]
//
// with the softmax formed online over chunks of block_kv keys: running
// max m, denominator l and accumulator acc, acc / max(l, 1e-30) at the
// end, as the TPU kernel does.
//
// What bounds it on the card: the two products, 4 * hd operations per
// visible (query, key) pair.  On the CUDA cores in f32 (67 TFLOP/s) the
// llama3.2-3b prefill cannot go under 1.54 ms; this kernel runs them on
// the tensor cores in 3xTF32 (../../csrc/tf32x3.cuh: three TF32 mma per
// product, f32 accuracy), whose floor is 3x the operations at 495 TFLOP/s,
// 0.63 ms there.  A decode window is bound by bytes.
//
// What the design does about it (FlashAttention-2 on mma.sync):
// - A block owns block_q (64 or 128) query rows of one (b, h): one warp
//   per 16 rows, so warps never share a row and the softmax needs no
//   block barrier.  The pre-scaled q tile sits in shared memory; each
//   warp splits its A fragments once per k-step of a chunk and reuses
//   them over the chunk's block_kv / 8 key tiles.
// - K/V chunks stream through a ring of two shared-memory stages filled
//   with 16-byte cp.async, so chunk j + 1 is in flight while chunk j
//   computes.  Rows are padded (f32: hd + 4 words; bf16: hd + 8 halves) so
//   that the fragment loads of a warp hit 32 distinct banks.  Past a
//   q.k tile of 128 (160, 192, 256), V has a head tile of its own (128)
//   and a width of its own, hdv: the accumulator, the V chunks and P @ V
//   take hdv's width, not hd's (padding V to MLA's 192 would cost 32 more
//   accumulator registers a thread and half again the V bytes and P @ V
//   products).  Up to 128, V is as wide as q and K, as in the TPU kernel
//   (the wrapper pads a narrower V), and their copies stay one loop.  f32
//   q.k tiles past 128 keep one raw stage, not two: the split buffer
//   already frees the stage as soon as a chunk is split, and two would
//   not fit beside the wider q tile.  Once an f32 chunk has landed, the
//   whole block splits it into TF32 hi and lo once, into a shared buffer
//   (every warp reads all of K and V, so splitting per warp would do the
//   same work 8 times); K's fragments then come four at a time by ldmatrix.  bf16 K/V are
//   staged as their raw bytes and widened when a fragment is loaded; a
//   bf16 value is exact in TF32, so its lo part is zero and the K and V
//   products take two mma, not three.
// - S = Q K^T accumulates in C fragments; the online softmax runs on them
//   (a thread holds 2 rows; row max and sum over the 4 lanes of a quad by
//   __shfl_xor_sync).  P never leaves registers: the P @ V product sums
//   over the chunk's keys in a permuted order, A column t of a k-step
//   standing for key 2t and column t + 4 for key 2t + 1, which is exactly
//   where S's C fragment holds them (c0, c1; c2, c3).  V's B fragments are
//   read with the same permutation (rows 2t and 2t + 1 of the stage).
// - Query blocks run longest first (the last causal block walks every
//   key), so the short ones fill the tail of the grid.
//
// Masking: keys past Skv are never visited, so a row that sees no key at
// all (kv_valid = 0, or every key in its causal future) averages V over
// the Skv real keys, as the reference's oracle does; inside a chunk a
// key past the visited range scores -inf (p = 0) and a masked key -1e30.
// Keys masked for every row of the block are skipped at the end of the
// range only when every row of the block sees at least one key, and a
// warp skips the chunks past the causal horizon of its own 16 rows on
// the same condition: each skipped score would have contributed
// exp(-1e30 - m) = 0 with a correction of 1, so skipping changes no bit.
// Only chunks that cross a mask boundary pay for the mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "../../csrc/tf32x3.cuh"

#define MAX_WARPS 8
#define STAGES 2
#define NEG_BIG (-1e30f)
#define NEG_INF (__int_as_float(0xff800000))  // -inf: p = exp(-inf) = 0
#define LOG2E 1.4426950408889634f  // p = exp(x) as exp2(x log2 e)

struct Problem {
  int B, Sq, Skv, H, KV, hd, hdv;
  int causal, q_offset, kv_valid;
  int vec;  // K/V rows are whole, aligned 16-byte chunks: cp.async them
  float scale;
};

// Row strides, in elements, of the q tile (f32) and of a K/V stage.
__host__ __device__ constexpr int q_stride(int hdt) { return hdt + 4; }
__host__ __device__ constexpr int kv_stride(int hdt, bool bf16) {
  return bf16 ? hdt + 8 : hdt + 4;
}

// hd padded to the head tile the kernel is built for: 32, 64, 96 or 128,
// then 160, 192 or 256 (q.k only).
__host__ __device__ constexpr int head_tile(int hd) {
  return hd <= 128 ? (hd + 31) / 32 * 32 : hd <= 160 ? 160
         : hd <= 192 ? 192 : 256;
}

// V's head tile beside q.k tile hdt: the same up to 128, then 128.
__host__ __device__ constexpr int v_tile(int hdt) {
  return hdt < 128 ? hdt : 128;
}

// K/V stages in flight: two, one for f32 q.k tiles past 128.
__host__ __device__ constexpr int stages(int hdt, bool bf16) {
  return bf16 || hdt <= 128 ? STAGES : 1;
}

// Dynamic shared memory of one block: the f32 q tile, stages x {K, V}
// chunks as they arrive, and for f32 inputs one chunk split into TF32
// {K hi, K lo, V hi, V lo}; flash_attention.py's smem_bytes computes the
// same.
__host__ __device__ constexpr size_t smem_size(int bq, int bkv, int hd,
                                               bool bf16) {
  return sizeof(float) * (size_t)bq * q_stride(head_tile(hd)) +
         (size_t)bkv *
             (kv_stride(head_tile(hd), bf16) +
              kv_stride(v_tile(head_tile(hd)), bf16)) *
             (bf16 ? 2 * stages(head_tile(hd), bf16)
                   : 4 * (stages(head_tile(hd), bf16) + 2));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// HDT: the q.k head tile; BKV: keys per chunk; T: float or
// __nv_bfloat16.  V's head tile is v_tile(HDT).
template <int HDT, int BKV, typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Problem p) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int HDVT = v_tile(HDT), ST = stages(HDT, BF16);
  // past 128, V has a tile of its own and a width of its own (hdv); up to
  // 128 it is as wide as q and K (the wrapper pads a narrower V)
  constexpr bool NARROW_V = HDT > 128;
  constexpr int QS = q_stride(HDT), KS = kv_stride(HDT, BF16);
  constexpr int VS = kv_stride(HDVT, BF16);
  constexpr int NT = BKV / 8;  // key tiles of a chunk
  constexpr int DT = HDT / 8;  // q.k head-dim tiles
  constexpr int DV = HDVT / 8;  // v head-dim tiles
  // tiles whose B fragments are split together and whose mma interleave
  constexpr int GN = NT < 4 ? NT : 4, GD = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int BQ = nwarps * 16;
  constexpr int KVSTAGE = BKV * (KS + VS);  // elements of a K/V stage
  float* const Qs = reinterpret_cast<float*>(smem_raw);        // [BQ, QS]
  T* const KVs = reinterpret_cast<T*>(Qs + (size_t)BQ * QS);   // stages
  // f32: the current chunk split once for all warps, K [BKV, KS] and V
  // [BKV, VS]
  uint32_t* const Khi =
      reinterpret_cast<uint32_t*>(KVs + (size_t)ST * KVSTAGE);
  uint32_t* const Klo = Khi + BKV * KS;
  uint32_t* const Vhi = Klo + BKV * KS;
  uint32_t* const Vlo = Vhi + BKV * VS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const int hd = p.hd, hdv = NARROW_V ? p.hdv : p.hd;

  // the keys this block visits: all Skv unless every row sees a key
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_end = p.Skv;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + q0 >= 0)) {
    kv_end = min(kv_end, p.kv_valid);
    if (p.causal) kv_end = min(kv_end, p.q_offset + q_last + 1);
  }
  const int n_chunks = (kv_end + BKV - 1) / BKV;

  // stale or never-written stage rows must be finite (p = 0 times them),
  // and the head-dim padding zero: clear the stages once
  {
    const int n16 = (int)(ST * KVSTAGE * sizeof(T) / 16);
    float4* z = reinterpret_cast<float4*>(KVs);
    for (int i = tid; i < n16; i += nthreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // elements between keys of K and of V
  const size_t key_stride = (size_t)p.KV * hd, vkey_stride = (size_t)p.KV * hdv;
  const T* const kbase = k + ((size_t)b * p.Skv * p.KV + g) * hd;
  const T* const vbase = v + ((size_t)b * p.Skv * p.KV + g) * hdv;
  auto load_chunk = [&](int kv0, int stage) {
    const int nc = min(BKV, kv_end - kv0);
    T* const Kd = KVs + (size_t)stage * KVSTAGE;
    T* const Vd = Kd + (size_t)BKV * KS;
    const T* const ks = kbase + (size_t)kv0 * key_stride;
    const T* const vs = vbase + (size_t)kv0 * vkey_stride;
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    if constexpr (!NARROW_V) {  // K and V rows of one width
      if (p.vec) {
        const int cpr = hd / EPC;
        for (int i = tid; i < nc * cpr; i += nthreads) {
          const int c = i / cpr, j = (i - c * cpr) * EPC;
          cp_async16(Kd + c * KS + j, ks + c * key_stride + j);
          cp_async16(Vd + c * VS + j, vs + c * vkey_stride + j);
        }
      } else {  // rows not in whole 16-byte chunks (odd hd): plain copies
        for (int i = tid; i < nc * hd; i += nthreads) {
          const int c = i / hd, d = i - c * hd;
          Kd[c * KS + d] = ks[c * key_stride + d];
          Vd[c * VS + d] = vs[c * vkey_stride + d];
        }
      }
    } else {
      const bool vec = p.vec;
      const int cpr = vec ? hd / EPC : hd, vcpr = vec ? hdv / EPC : hdv;
      for (int i = tid; i < nc * cpr; i += nthreads) {
        const int c = i / cpr, j = i - c * cpr;
        if (vec)
          cp_async16(Kd + c * KS + j * EPC, ks + c * key_stride + j * EPC);
        else
          Kd[c * KS + j] = ks[c * key_stride + j];
      }
      for (int i = tid; i < nc * vcpr; i += nthreads) {
        const int c = i / vcpr, j = i - c * vcpr;
        if (vec)
          cp_async16(Vd + c * VS + j * EPC, vs + c * vkey_stride + j * EPC);
        else
          Vd[c * VS + j] = vs[c * vkey_stride + j];
      }
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  // the pre-scaled q tile, zero past Sq and past hd
  for (int idx = tid; idx < BQ * HDT; idx += nthreads) {
    const int r = idx / HDT, d = idx - r * HDT;
    const int qi = q0 + r;
    Qs[r * QS + d] =
        qi < p.Sq && d < hd
            ? to_f32(q[(((size_t)b * p.Sq + qi) * p.H + h) * hd + d]) *
                  p.scale
            : 0.0f;
  }

  // this warp's rows and the keys it must visit
  const int wq0 = q0 + warp * 16;
  const bool live = wq0 < p.Sq;
  int w_end = kv_end;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + wq0 >= 0)) {
    w_end = min(w_end, p.kv_valid);
    if (p.causal) w_end = min(w_end, p.q_offset + min(wq0 + 15, p.Sq - 1) + 1);
  }

  float acc[DV][4];
#pragma unroll
  for (int dt = 0; dt < DV; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
  const float* const Qw = Qs + (size_t)warp * 16 * QS;

  for (int j = 0; j < n_chunks; ++j) {
    const int kv0 = j * BKV;
    const T* const Ks = KVs + (size_t)(j % ST) * KVSTAGE;
    const T* const Vs = Ks + (size_t)BKV * KS;
    cp_async_wait<0>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
    if constexpr (!BF16) {
      // split chunk j into TF32 hi and lo once, for all warps (four
      // floats at a time; stale rows past the chunk are finite)
      auto split4 = [](const float* src, uint32_t* hi, uint32_t* lo) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        uint4 h, l;
        tf32_split(f.x, h.x, l.x);
        tf32_split(f.y, h.y, l.y);
        tf32_split(f.z, h.z, l.z);
        tf32_split(f.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi) = h;
        *reinterpret_cast<uint4*>(lo) = l;
      };
      if constexpr (HDVT == HDT) {
        for (int i = tid; i < BKV * HDT / 4; i += nthreads) {
          const int r = i / (HDT / 4), c = (i - r * (HDT / 4)) * 4;
          const int at = r * KS + c;
          split4(Ks + at, Khi + at, Klo + at);
          split4(Vs + at, Vhi + at, Vlo + at);
        }
      } else {
        for (int i = tid; i < BKV * HDT / 4; i += nthreads) {
          const int r = i / (HDT / 4), c = (i - r * (HDT / 4)) * 4;
          split4(Ks + r * KS + c, Khi + r * KS + c, Klo + r * KS + c);
        }
        for (int i = tid; i < BKV * HDVT / 4; i += nthreads) {
          const int r = i / (HDVT / 4), c = (i - r * (HDVT / 4)) * 4;
          split4(Vs + r * VS + c, Vhi + r * VS + c, Vlo + r * VS + c);
        }
      }
    }
    // one stage: every thread has read the raw chunk before it refills
    // (and the split chunk is visible)
    if constexpr (ST == 1) __syncthreads();
    // chunk j + 1 into the stage chunk j - 1 left
    if (j + 1 < n_chunks) load_chunk(kv0 + BKV, (j + 1) % ST);
    if constexpr (!BF16 && ST > 1) __syncthreads();  // the split is visible

    if (live && kv0 < w_end) {

      // S = Q K^T for this warp's 16 rows and the chunk's BKV keys
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        uint32_t a_hi[4], a_lo[4];
        const float* qa = Qw + gid * QS + kt * 8 + tig;
        tf32_split(qa[0], a_hi[0], a_lo[0]);
        tf32_split(qa[8 * QS], a_hi[1], a_lo[1]);
        tf32_split(qa[4], a_hi[2], a_lo[2]);
        tf32_split(qa[8 * QS + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += GN) {
          BFrags<GN> bf;
#pragma unroll
          for (int i = 0; i < GN; i += 2) {
            if constexpr (BF16) {
#pragma unroll
              for (int u = i; u < i + 2; ++u) {
                const int at = ((n0 + u) * 8 + gid) * KS + kt * 8 + tig;
                bf.exact(u, to_f32(Ks[at]), to_f32(Ks[at + 4]));
              }
            } else {
              // key tiles i and i + 1, k 0-3 and 4-7: one ldmatrix each
              // for hi and lo (lane: tile i + lane / 16, row lane % 8)
              const int at = ((n0 + i + (lane >> 4)) * 8 + (lane & 7)) * KS +
                             kt * 8 + ((lane >> 1) & 4);
              ldmatrix_x4(bf.hi[i][0], bf.hi[i][1], bf.hi[i + 1][0],
                          bf.hi[i + 1][1], Khi + at);
              ldmatrix_x4(bf.lo[i][0], bf.lo[i][1], bf.lo[i + 1][0],
                          bf.lo[i + 1][1], Klo + at);
            }
          }
          mma_3xtf32<GN, BF16>(
              [&](int i) -> float (&)[4] { return s[n0 + i]; }, a_hi, a_lo,
              bf);
        }
      }

      // masks, only where the chunk crosses a boundary for these rows
      const bool clean = kv0 + BKV <= kv_end && kv0 + BKV <= p.kv_valid &&
                         (!p.causal || kv0 + BKV - 1 <= p.q_offset + wq0);
      if (!clean) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = kv0 + nt * 8 + 2 * tig + (e & 1);
            const int qpos = wq0 + gid + (e >> 1) * 8 + p.q_offset;
            const bool seen = c < p.kv_valid && (!p.causal || c <= qpos);
            s[nt][e] = c >= kv_end ? NEG_INF : seen ? s[nt][e] : NEG_BIG;
          }
      }

      // online softmax: rows gid (e = 0, 1) and gid + 8 (e = 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f((s[nt][e] - m[e >> 1]) * LOG2E);
          sum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int dt = 0; dt < DV; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];

      // acc += P V, keys of k-step kt in the order 2t, 2t + 1 (see top)
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        uint32_t p_hi[4], p_lo[4];
        tf32_split(s[kt][0], p_hi[0], p_lo[0]);
        tf32_split(s[kt][2], p_hi[1], p_lo[1]);
        tf32_split(s[kt][1], p_hi[2], p_lo[2]);
        tf32_split(s[kt][3], p_hi[3], p_lo[3]);
        const int vat = (kt * 8 + 2 * tig) * VS + gid;
#pragma unroll
        for (int d0 = 0; d0 < DV; d0 += GD) {
          BFrags<GD> bf;
#pragma unroll
          for (int i = 0; i < GD; ++i) {
            const int at = vat + (d0 + i) * 8;
            if constexpr (BF16)
              bf.exact(i, to_f32(Vs[at]), to_f32(Vs[at + VS]));
            else
              bf.load(i, Vhi + at, Vlo + at, VS);
          }
          mma_3xtf32<GD, BF16>(
              [&](int i) -> float (&)[4] { return acc[d0 + i]; }, p_hi,
              p_lo, bf);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + gid + 8 * r;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* const orow = o + (((size_t)b * p.Sq + qi) * p.H + h) * hdv;
#pragma unroll
    for (int dt = 0; dt < DV; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * tig + e;
        if (d >= hdv) continue;
        const float val = acc[dt][2 * r + e] / den;
        if constexpr (BF16)
          orow[d] = __float2bfloat16_rn(val);
        else
          orow[d] = val;
      }
  }
}

// Shared memory a block may use on Hopper (227 KB).
#define SMEM_PER_BLOCK 232448

template <int HDT, int BKV, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, const Problem& p, int block_q,
                          cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // tiles that fit at no block_q are not built
  if constexpr (smem_size(64, BKV, HDT, BF16) > SMEM_PER_BLOCK) {
    return cudaErrorInvalidValue;
  } else {
  const size_t smem = smem_size(block_q, BKV, p.hd, BF16);
  if (smem > SMEM_PER_BLOCK) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HDT, BKV, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + block_q - 1) / block_q), (unsigned)p.H,
                  (unsigned)p.B);
  flash_attention_kernel<HDT, BKV, T><<<grid, block_q * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
  }
}

template <int HDT, typename T>
static cudaError_t launch_kv(int block_q, int block_kv, const void* q,
                             const void* k, const void* v, void* o,
                             const Problem& p, cudaStream_t s) {
  switch (block_kv) {
    case 32: return launch<HDT, 32, T>(q, k, v, o, p, block_q, s);
    case 64: return launch<HDT, 64, T>(q, k, v, o, p, block_q, s);
    case 128: return launch<HDT, 128, T>(q, k, v, o, p, block_q, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t launch_hd(int block_q, int block_kv, const void* q,
                             const void* k, const void* v, void* o,
                             const Problem& p, cudaStream_t s) {
  switch (head_tile(p.hd)) {
    case 32: return launch_kv<32, T>(block_q, block_kv, q, k, v, o, p, s);
    case 64: return launch_kv<64, T>(block_q, block_kv, q, k, v, o, p, s);
    case 96: return launch_kv<96, T>(block_q, block_kv, q, k, v, o, p, s);
    case 128: return launch_kv<128, T>(block_q, block_kv, q, k, v, o, p, s);
    case 160: return launch_kv<160, T>(block_q, block_kv, q, k, v, o, p, s);
    case 192: return launch_kv<192, T>(block_q, block_kv, q, k, v, o, p, s);
    case 256: return launch_kv<256, T>(block_q, block_kv, q, k, v, o, p, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" size_t flash_attention_smem_bytes(int block_q, int block_kv,
                                             int hd, int bf16) {
  return smem_size(block_q, block_kv, hd, bf16 != 0);
}

// q [B, Sq, H, hd], k [B, Skv, KV, hd], v [B, Skv, KV, hdv] and o [B, Sq,
// H, hdv] are contiguous device pointers of f32 (bf16 = 0) or bf16 (bf16
// = 1); hd is 1 to 256; hdv is hd, or, past a q.k tile of 128, 1 to 128
// (the wrapper pads a narrower V up to a tile of 128).  kv_valid is already clamped to [0, Skv].
// block_q is 64 or 128 (4 or 8 warps), block_kv 32, 64 or 128.  Returns
// a cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int KV, int hd, int hdv, int causal,
                               int q_offset, int kv_valid, int bf16,
                               float scale, int block_q, int block_kv,
                               void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > 256 || hdv < 1 || hdv > hd ||
      (hdv != hd && head_tile(hd) <= 128) || hdv > v_tile(head_tile(hd)) ||
      (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.hdv = hdv;
  p.causal = causal; p.q_offset = q_offset; p.kv_valid = kv_valid;
  p.scale = scale;
  const int elem = bf16 ? 2 : 4;
  p.vec = (hd * elem) % 16 == 0 && (hdv * elem) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(block_q, block_kv, q, k, v, o, p, s);
  return (int)launch_hd<float>(block_q, block_kv, q, k, v, o, p, s);
}
