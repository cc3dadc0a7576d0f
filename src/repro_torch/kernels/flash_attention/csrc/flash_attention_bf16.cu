// Flash attention in bf16 (online softmax, GQA, causal on absolute
// positions) on Hopper (sm_90a), both products on the bf16 tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (the Pallas TPU kernel, pallas_call at l.73, _kernel at
// l.23) for bf16 inputs; f32 inputs go to csrc/flash_attention.cu.  For q,
// k [B, Sq or Skv, H or KV, hd] and v [B, Skv, KV, hdv] in bf16 (H % KV
// == 0, q head h reading kv head h / (H / KV); hdv = hd, or narrower, as
// MLA's 192-wide q.k head over its 128-wide v head) it computes, in f32,
//
//   s[i, c] = (q[i] . k[c]) * scale          scale = 1 / sqrt(hd)
//   s[i, c] = -1e30 unless c < kv_valid and (not causal or
//             c <= i + q_offset)
//   o[i]    = sum_c softmax(s[i])[c] v[c]    rounded to bf16 once
//
// with the softmax formed online: running max m, denominator l and
// accumulator acc in f32, acc / max(l, 1e-30) at the end, as the TPU
// kernel does.  The scale is applied to the f32 scores, as the oracle
// divides them (folded with log2 e into the exponent of exp2).
//
// What bounds it on the card.  A prefill: the operations, 2 (hd + hdv)
// per visible (query, key) pair; at the llama3.2-3b prefill (B 4 x 2,048,
// 24 heads of 128, causal) 0.104 ms at the bf16 peak (989 TFLOP/s).  This
// design does q.k once and P.V twice (below): 1.5x those, 0.156 ms.  A
// decode step (at most DECODE_ROWS rows a kv head): the bytes, K and V of
// the visited keys read once, 0.010 ms at the llama3.2-3b step (2,049
// keys, 3.35 TB/s).
//
// What the design does about it.
// - Products: mma.sync m16n8k16 bf16 with f32 accumulators.  q and k are
//   exact in bf16, so S = q.K^T is one product.  P is not: one bf16
//   rounding of p (2^-9 relative) summed over 2,048 keys misses the bf16
//   output tolerance (rtol 2^-7, atol 2e-5) by 34x at the llama3.2-3b
//   prefill, where outputs near zero are sums of cancelling terms.  So p
//   is split in registers into bf16 hi = bf16(p) and lo = bf16(p - hi)
//   (2^-17 of p together) and P.V runs as two products against the same V
//   fragments.  l sums the f32 p.  tests/test_torch_flash_attention.py
//   emulates both ways of forming P.
// - Prefill kernel (more than DECODE_ROWS rows a kv head): FlashAttention-
//   2.  A block owns block_q (64 or 128) query rows of one (b, h), one
//   warp per 16 rows, so warps never share a row and the softmax needs no
//   block barrier.  The block's q rows pass through shared memory once:
//   each warp reads its A fragments by ldmatrix into registers and keeps
//   them for the whole key loop (HDT / 4 registers).  K and V stay bf16
//   in a ring of STAGES shared-memory stages of block_kv keys, filled by
//   16-byte cp.async while the previous chunk computes; rows are padded by
//   16 bytes, so the 8 rows of an ldmatrix hit distinct banks.  K's B
//   fragments come by ldmatrix, V's by ldmatrix.trans.  S stays in the
//   accumulators, the online softmax runs on them with quad shuffles, and
//   they become P's A fragments in place (two n8 accumulator tiles are one
//   k16 A fragment).  Query blocks run longest first (the last causal
//   block walks every key), so the short ones fill the tail of the grid.
// - Decode kernel (Sq x H / KV <= DECODE_ROWS: a decode step is Sq 1):
//   split-key and grouped.  A block takes every q head of one kv head, its
//   rows (query position, head) pairs, position-major, padded to one m16
//   tile, so K and V are read once per GQA group, not once per q head.
//   The keys are split across blocks (the wrapper's split_count, from the
//   problem and the SM count: about two blocks an SM), each block's range
//   in chunks of DECODE_BKV keys, and within a chunk each of the block's
//   DECODE_WARPS warps takes 16 keys.  Every warp writes its partial (m,
//   l, acc) to f32 scratch the wrapper allocates, and the combine kernel
//   adds the splits x warps partials of a row in ascending order: no
//   atomics, the same bits from run to run.
// - Widths: q.k head tiles of 32, 64, 96 and 128, then 160, 192 and 256
//   (hd padded with zeros).  V's tile is the q.k tile up to 128 (the
//   wrapper pads a narrower V to hd) and 128 past it, with a width of its
//   own (hdv, MLA's 128 under 192).
//
// Masking: keys past Skv are never read, so a row that sees no key at all
// (kv_valid = 0, or every key in its causal future) averages V over the
// Skv real keys, as the reference's oracle does; a key past the visited
// range scores -inf (p = 0) and a masked key -1e30.  Keys masked for every
// row of a block are skipped only when every row of the block sees at
// least one key, and a prefill warp skips the chunks past the causal
// horizon of its own 16 rows on the same condition: each skipped score
// would have added exp(-1e30 - m) = 0 with a correction of 1.  Only chunks
// that cross a mask boundary pay for the mask.
//
// Registers (nvcc -Xptxas -v, sm_90a): the prefill kernel at 8 warps 240
// at head tile 128 and chunks of 128 keys (one block of 8 warps an SM),
// 254 at 192 / 128; 4-warp blocks are held to 168 (three an SM) where
// prefill_min_blocks estimates they fit, a few spilling up to 64 bytes;
// the q.k tile 256 with chunks of 128 keys spills 28 bytes at 255.  The
// decode kernel 72 to 168 (two blocks of 4 warps an SM), the combine 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/mma_bf16.cuh"
#include "../../csrc/tf32x3.cuh"

typedef __nv_bfloat16 bf16;

#define STAGES 2           // K/V chunks in flight
#define DECODE_ROWS 16     // rows a kv head the decode kernel takes
#define DECODE_WARPS 4     // decode: warps a block, 16 keys each a chunk
#define DECODE_BKV 64      // decode: keys a chunk
#define NEG_BIG (-1e30f)
#define NEG_INF (__int_as_float(0xff800000))  // -inf: p = exp(-inf) = 0
#define MAX_CARDS 64

struct Problem {
  int B, Sq, Skv, H, KV, hd, hdv;
  int causal, q_offset, kv_valid;
  int vec;     // q, K and V rows are whole, aligned 16-byte chunks
  int splits;  // decode: key ranges across blocks
  float sl2;   // scale * log2(e), rounded to f32 by the wrapper
};

// hd padded to the q.k head tile: 32, 64, 96 or 128, then 160, 192, 256.
__host__ __device__ constexpr int head_tile(int hd) {
  return hd <= 128 ? (hd + 31) / 32 * 32 : hd <= 160 ? 160
         : hd <= 192 ? 192 : 256;
}
// V's head tile beside q.k tile hdt: the same up to 128, then 128.
__host__ __device__ constexpr int v_tile(int hdt) {
  return hdt < 128 ? hdt : 128;
}
// Row stride, in halves, of every tile in shared memory: 16 bytes past
// the head tile, so the 8 rows of an ldmatrix fall on distinct banks.
__host__ __device__ constexpr int row_stride(int t) { return t + 8; }
// Halves of one K/V stage of bkv keys.
__host__ __device__ constexpr size_t stage_halves(int bkv, int hdt) {
  return (size_t)bkv * (row_stride(hdt) + row_stride(v_tile(hdt)));
}
// Prefill: the q rows pass through the stages' memory before the first
// chunk is loaded, so a block takes the larger of the two.
__host__ __device__ constexpr size_t prefill_smem(int bq, int bkv, int hd) {
  return 2 * ((size_t)bq * row_stride(head_tile(hd)) >
                      STAGES * stage_halves(bkv, head_tile(hd))
                  ? (size_t)bq * row_stride(head_tile(hd))
                  : STAGES * stage_halves(bkv, head_tile(hd)));
}
// Prefill blocks an SM the register budget asks for: three of 4 warps
// where the accumulators, q's fragments and one chunk's scores (estimated
// at HDT / 4 + HDVT / 2 + BKV / 2 + 40 registers) fit in 168, else
// whatever fits.
__host__ __device__ constexpr int prefill_min_blocks(int hdt, int bkv,
                                                     int warps) {
  return warps == 4 && hdt / 4 + v_tile(hdt) / 2 + bkv / 2 + 40 <= 168 ? 3
                                                                      : 1;
}
// Decode: one m16 tile of q rows, then the stages.
__host__ __device__ constexpr size_t decode_smem(int hd) {
  return 2 * ((size_t)DECODE_ROWS * row_stride(head_tile(hd)) +
              STAGES * stage_halves(DECODE_BKV, head_tile(hd)));
}

// ------------------------------------------------------------ staging ---
// A block's q rows into a [rows][row_stride(HDT)] tile, zero past hd and
// for rows row_ptr gives no pointer.
template <int HDT, typename RowPtr>
__device__ __forceinline__ void stage_q(bf16* Qs, int rows, RowPtr row_ptr,
                                        int hd, bool vec) {
  constexpr int QS = row_stride(HDT);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (vec) {
    for (int i = tid; i < rows * (HDT / 8); i += nthreads) {
      const int r = i / (HDT / 8), c = (i - r * (HDT / 8)) * 8;
      const bf16* const src = row_ptr(r);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (src != nullptr && c < hd)
        val = *reinterpret_cast<const uint4*>(src + c);
      *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
    }
  } else {
    for (int i = tid; i < rows * HDT; i += nthreads) {
      const int r = i / HDT, c = i - r * HDT;
      const bf16* const src = row_ptr(r);
      Qs[r * QS + c] = src != nullptr && c < hd ? src[c]
                                                : __float2bfloat16_rn(0.0f);
    }
  }
}

// Zero `halves` halves of shared memory (a multiple of 8).
__device__ __forceinline__ void zero_smem(bf16* at, size_t halves) {
  uint4* const z = reinterpret_cast<uint4*>(at);
  for (size_t i = threadIdx.x; i < halves / 8; i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// nc keys of K (hd wide) and V (hdv wide) into a stage, K [BKV][KS] then
// V [BKV][VS]: 16-byte cp.async, or plain copies for rows that are not
// whole aligned 16-byte chunks.  One commit group either way.
template <int HDT, int BKV>
__device__ __forceinline__ void load_kv(bf16* Kd, const bf16* ks,
                                        const bf16* vs, int nc,
                                        size_t key_stride, size_t vkey_stride,
                                        int hd, int hdv, bool vec) {
  constexpr int KS = row_stride(HDT), VS = row_stride(v_tile(HDT));
  bf16* const Vd = Kd + BKV * KS;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (vec) {
    const int kc = hd / 8, vc = hdv / 8;
    for (int i = tid; i < nc * kc; i += nthreads) {
      const int c = i / kc, j = (i - c * kc) * 8;
      cp_async16(Kd + c * KS + j, ks + c * key_stride + j);
    }
    for (int i = tid; i < nc * vc; i += nthreads) {
      const int c = i / vc, j = (i - c * vc) * 8;
      cp_async16(Vd + c * VS + j, vs + c * vkey_stride + j);
    }
  } else {
    for (int i = tid; i < nc * hd; i += nthreads) {
      const int c = i / hd, d = i - c * hd;
      Kd[c * KS + d] = ks[c * key_stride + d];
    }
    for (int i = tid; i < nc * hdv; i += nthreads) {
      const int c = i / hdv, d = i - c * hdv;
      Vd[c * VS + d] = vs[c * vkey_stride + d];
    }
  }
  cp_async_commit();
}

// ----------------------------------------------------------- one warp ---
// s = q . K^T for the warp's 16 rows (A fragments qf) and NT n8 tiles of
// keys; kb is this lane's ldmatrix row of the first key tile: rows
// (lane % 8) + 8 (lane / 16), k half (lane / 8) % 2.
template <int KT, int NT, int KS>
__device__ __forceinline__ void scores(float (&s)[NT][4],
                                       const uint32_t (&qf)[KT][4],
                                       const bf16* kb) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, kb + np * 16 * KS + kt * 16);
      mma_bf16(s[2 * np], qf[kt], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kt], b[2], b[3]);
    }
}

// p = x split into bf16 hi + lo, two columns to a register (lo column in
// the low half), as A-fragment words.
__device__ __forceinline__ void split_p(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The online softmax over the masked scores s of this chunk (rows g: e
// 0, 1; g + 8: e 2, 3), then acc += P V with P as bf16 hi + lo; vb is
// this lane's ldmatrix.trans row of the chunk's first key in V: key
// lane % 16, dims half lane / 16.
template <int NT, int DV, int VS>
__device__ __forceinline__ void softmax_pv(float (&s)[NT][4], float (&m)[2],
                                           float (&l)[2],
                                           float (&acc)[DV][4],
                                           const bf16* vb, float sl2) {
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
    corr[r] = exp2_approx((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = exp2_approx((s[nt][e] - m[e >> 1]) * sl2);
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
  // k-step kk: keys 16 kk .. 16 kk + 15, the accumulator tiles 2 kk and
  // 2 kk + 1 (A columns 2t, 2t + 1 and 2t + 8, 2t + 9)
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split_p(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_p(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < DV / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vb + kk * 16 * VS + dp * 16);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
    }
  }
}

// Masks one chunk's scores: key c (columns 2t, 2t + 1 of tile nt past
// kv0) scores -inf from kv_end on and -1e30 where row (e / 2) does not see
// it; qpos[r] is the absolute position of the lane's row g + 8 r.
template <int NT>
__device__ __forceinline__ void mask_chunk(float (&s)[NT][4], int kv0,
                                           int kv_end, const int (&qpos)[2],
                                           const Problem& p, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kv0 + nt * 8 + 2 * tig + (e & 1);
      const bool seen =
          c < p.kv_valid && (!p.causal || c <= qpos[e >> 1]);
      s[nt][e] = c >= kv_end ? NEG_INF : seen ? s[nt][e] : NEG_BIG;
    }
}

// The keys a block visits: all Skv unless every one of its rows (query
// positions first .. last) sees a key.
__device__ __forceinline__ int visited_end(const Problem& p, int first,
                                           int last) {
  int end = p.Skv;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + first >= 0)) {
    end = min(end, p.kv_valid);
    if (p.causal) end = min(end, p.q_offset + last + 1);
  }
  return end;
}

// -------------------------------------------------------------- prefill ---
// HDT: the q.k head tile; BKV: keys a chunk; WARPS: 4 or 8, 16 query rows
// each.  V's tile is v_tile(HDT).
template <int HDT, int BKV, int WARPS>
__global__ void __launch_bounds__(WARPS * 32,
                                  prefill_min_blocks(HDT, BKV, WARPS))
flash_attention_bf16_prefill_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ o, Problem p) {
  constexpr int HDVT = v_tile(HDT);
  // past 128, V has a width of its own (hdv); up to 128 it is as wide as
  // q and K (the wrapper pads a narrower V)
  constexpr bool NARROW_V = HDT > 128;
  constexpr int KS = row_stride(HDT), VS = row_stride(HDVT);
  constexpr int NT = BKV / 8, KT = HDT / 16, DV = HDVT / 8;
  constexpr size_t STAGE = stage_halves(BKV, HDT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int BQ = WARPS * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const int hd = p.hd, hdv = NARROW_V ? p.hdv : p.hd;

  const int kv_end = visited_end(p, q0, min(q0 + BQ, p.Sq) - 1);
  const int n_chunks = (kv_end + BKV - 1) / BKV;

  // the q rows, through the stages' memory, into registers
  const size_t q_row = (size_t)p.H * hd;
  const bf16* const qb = q + ((size_t)b * p.Sq * p.H + h) * hd;
  stage_q<HDT>(smem, BQ, [&](int r) -> const bf16* {
    return q0 + r < p.Sq ? qb + (size_t)(q0 + r) * q_row : nullptr;
  }, hd, p.vec);
  __syncthreads();
  uint32_t qf[KT][4];
  {
    const bf16* const qa =
        smem + (warp * 16 + (lane & 15)) * KS + (lane >> 4) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldsm_x4(qf[kt], qa + kt * 16);
  }
  __syncthreads();
  // stale or never-written stage rows must be finite (p = 0 times them)
  // and the head-dim padding zero
  zero_smem(smem, STAGES * STAGE);
  __syncthreads();

  const size_t key_stride = (size_t)p.KV * hd;
  const size_t vkey_stride = (size_t)p.KV * hdv;
  const bf16* const kbase = k + ((size_t)b * p.Skv * p.KV + g) * hd;
  const bf16* const vbase = v + ((size_t)b * p.Skv * p.KV + g) * hdv;
  auto load_chunk = [&](int kv0, int stage) {
    load_kv<HDT, BKV>(smem + stage * STAGE, kbase + kv0 * key_stride,
                      vbase + kv0 * vkey_stride, min(BKV, kv_end - kv0),
                      key_stride, vkey_stride, hd, hdv, p.vec);
  };
  if (n_chunks > 0) load_chunk(0, 0);

  // this warp's rows and the keys it must visit
  const int wq0 = q0 + warp * 16;
  const bool live = wq0 < p.Sq;
  int w_end = kv_end;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + wq0 >= 0)) {
    w_end = min(w_end, p.kv_valid);
    if (p.causal) w_end = min(w_end, p.q_offset + min(wq0 + 15, p.Sq - 1) + 1);
  }
  const int qpos[2] = {wq0 + gid + p.q_offset, wq0 + gid + 8 + p.q_offset};

  float acc[DV][4];
#pragma unroll
  for (int dt = 0; dt < DV; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_off = (lane & 15) * VS + (lane >> 4) * 8;

  for (int j = 0; j < n_chunks; ++j) {
    const int kv0 = j * BKV;
    const bf16* const Ks = smem + (j % STAGES) * STAGE;
    const bf16* const Vs = Ks + BKV * KS;
    cp_async_wait<0>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
    if (j + 1 < n_chunks) load_chunk(kv0 + BKV, (j + 1) % STAGES);
    if (!live || kv0 >= w_end) continue;

    float s[NT][4];
    scores<KT, NT, KS>(s, qf, Ks + kb_row * KS + kb_col);
    const bool clean = kv0 + BKV <= kv_end && kv0 + BKV <= p.kv_valid &&
                       (!p.causal || kv0 + BKV - 1 <= p.q_offset + wq0);
    if (!clean) mask_chunk<NT>(s, kv0, kv_end, qpos, p, tig);
    softmax_pv<NT, DV, VS>(s, m, l, acc, Vs + vb_off, p.sl2);
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + gid + 8 * r;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* const orow = o + (((size_t)b * p.Sq + qi) * p.H + h) * hdv;
#pragma unroll
    for (int dt = 0; dt < DV; ++dt) {
      const int d = dt * 8 + 2 * tig;
      const float v0 = acc[dt][2 * r] / den, v1 = acc[dt][2 * r + 1] / den;
      if (d + 1 < hdv && (hdv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < hdv) orow[d] = __float2bfloat16_rn(v0);
        if (d + 1 < hdv) orow[d + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// --------------------------------------------------------------- decode ---
// Grid (splits, KV, B), DECODE_WARPS warps.  Writes each warp's partial:
// part_ml[(part * rows + row) * 2 + {0, 1}] = (m, l) in raw-score units
// and part_acc[(part * rows + row) * hdv + d], part = split * DECODE_WARPS
// + warp, row = (b * Sq + i) * H + h over the B * Sq * H output rows.
template <int HDT>
__global__ void __launch_bounds__(DECODE_WARPS * 32)
flash_attention_bf16_decode_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml, Problem p) {
  constexpr int HDVT = v_tile(HDT);
  constexpr bool NARROW_V = HDT > 128;
  constexpr int KS = row_stride(HDT), VS = row_stride(HDVT);
  constexpr int BKV = DECODE_BKV, KT = HDT / 16, DV = HDVT / 8;
  constexpr size_t STAGE = stage_halves(BKV, HDT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const stages = Qs + DECODE_ROWS * KS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV, R = p.Sq * G;
  const int hd = p.hd, hdv = NARROW_V ? p.hdv : p.hd;

  // this split's chunks of the visited keys
  const int kv_end = visited_end(p, 0, p.Sq - 1);
  const int n_total = (kv_end + BKV - 1) / BKV;
  const int per = (n_total + p.splits - 1) / p.splits;
  const int c_begin = min(n_total, split * per);
  const int c_end = min(n_total, c_begin + per);

  // row r is query position r / G of q head g G + r % G
  const size_t q_pos = (size_t)p.H * hd;
  const bf16* const qb = q + ((size_t)b * p.Sq * p.H + (size_t)g * G) * hd;
  stage_q<HDT>(Qs, DECODE_ROWS, [&](int r) -> const bf16* {
    return r < R ? qb + (r / G) * q_pos + (size_t)(r % G) * hd : nullptr;
  }, hd, p.vec);
  zero_smem(stages, STAGES * STAGE);
  __syncthreads();
  uint32_t qf[KT][4];
  {
    const bf16* const qa = Qs + (lane & 15) * KS + (lane >> 4) * 8;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldsm_x4(qf[kt], qa + kt * 16);
  }

  const size_t key_stride = (size_t)p.KV * hd;
  const size_t vkey_stride = (size_t)p.KV * hdv;
  const bf16* const kbase = k + ((size_t)b * p.Skv * p.KV + g) * hd;
  const bf16* const vbase = v + ((size_t)b * p.Skv * p.KV + g) * hdv;
  auto load_chunk = [&](int c, int stage) {
    const int kv0 = c * BKV;
    load_kv<HDT, BKV>(stages + stage * STAGE, kbase + kv0 * key_stride,
                      vbase + kv0 * vkey_stride, min(BKV, kv_end - kv0),
                      key_stride, vkey_stride, hd, hdv, p.vec);
  };
  if (c_begin < c_end) load_chunk(c_begin, 0);

  const int qpos[2] = {gid / G + p.q_offset, (gid + 8) / G + p.q_offset};
  float acc[DV][4];
#pragma unroll
  for (int dt = 0; dt < DV; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
  const int kb_off = (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * KS +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = (warp * 16 + (lane & 15)) * VS + (lane >> 4) * 8;

  for (int c = c_begin; c < c_end; ++c) {
    const int j = c - c_begin;
    const bf16* const Ks = stages + (j % STAGES) * STAGE;
    const bf16* const Vs = Ks + BKV * KS;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with c - 1
    if (c + 1 < c_end) load_chunk(c + 1, (j + 1) % STAGES);
    const int kv0 = c * BKV + warp * 16;  // this warp's 16 keys
    if (kv0 >= kv_end) continue;

    float s[2][4];
    scores<KT, 2, KS>(s, qf, Ks + kb_off);
    const bool clean = kv0 + 16 <= kv_end && kv0 + 16 <= p.kv_valid &&
                       (!p.causal || kv0 + 15 <= p.q_offset);
    if (!clean) mask_chunk<2>(s, kv0, kv_end, qpos, p, tig);
    softmax_pv<2, DV, VS>(s, m, l, acc, Vs + vb_off, p.sl2);
  }

  const size_t rows = (size_t)p.B * p.Sq * p.H;
  const size_t part = (size_t)split * DECODE_WARPS + warp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = gid + 8 * r;
    if (rr >= R) continue;
    const size_t row = ((size_t)b * p.Sq + rr / G) * p.H + g * G + rr % G;
    if (tig == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * (part * rows + row)) =
          make_float2(m[r], l[r]);
    float* const arow = part_acc + (part * rows + row) * hdv;
#pragma unroll
    for (int dt = 0; dt < DV; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * tig + e;
        if (d < hdv) arow[d] = acc[dt][2 * r + e];
      }
  }
}

// The decode kernel's partials of each row added in ascending order:
// o[row, d] = sum_s w_s acc_s[d] / max(sum_s w_s l_s, 1e-30), w_s =
// 2^((m_s - max_s m_s) sl2).  One thread an output element.
__global__ void flash_attention_bf16_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    bf16* __restrict__ o, int rows, int width, int parts, float sl2) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)rows * width) return;
  const size_t row = idx / width;
  float mx = NEG_INF;
  for (int s = 0; s < parts; ++s)
    mx = fmaxf(mx, part_ml[2 * (s * (size_t)rows + row)]);
  float l = 0.0f, a = 0.0f;
  for (int s = 0; s < parts; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(
        part_ml + 2 * (s * (size_t)rows + row));
    const float w = exp2f((ml.x - mx) * sl2);
    l = fmaf(ml.y, w, l);
    a = fmaf(part_acc[s * (size_t)rows * width + idx], w, a);
  }
  o[idx] = __float2bfloat16_rn(a / fmaxf(l, 1e-30f));
}

// ------------------------------------------------------------- launches ---
// Allow an instance the most shared memory any of its launches asks for,
// once a card.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* allowed) {
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card < MAX_CARDS && allowed[card]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && card < MAX_CARDS) allowed[card] = true;
  return err;
}

template <int HDT, int BKV, int WARPS>
static cudaError_t launch_prefill(const void* q, const void* k,
                                  const void* v, void* o, const Problem& p,
                                  cudaStream_t stream) {
  static bool allowed[MAX_CARDS] = {};
  constexpr int BQ = WARPS * 16;
  const size_t smem = prefill_smem(BQ, BKV, HDT);
  cudaError_t err = allow_smem(
      flash_attention_bf16_prefill_kernel<HDT, BKV, WARPS>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H,
                  (unsigned)p.B);
  flash_attention_bf16_prefill_kernel<HDT, BKV, WARPS>
      <<<grid, WARPS * 32, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), p);
  return cudaGetLastError();
}

template <int HDT, int BKV>
static cudaError_t launch_prefill_q(int block_q, const void* q, const void* k,
                                    const void* v, void* o, const Problem& p,
                                    cudaStream_t s) {
  if (block_q == 64) return launch_prefill<HDT, BKV, 4>(q, k, v, o, p, s);
  return launch_prefill<HDT, BKV, 8>(q, k, v, o, p, s);
}

template <int HDT>
static cudaError_t launch_prefill_kv(int block_q, int block_kv, const void* q,
                                     const void* k, const void* v, void* o,
                                     const Problem& p, cudaStream_t s) {
  switch (block_kv) {
    case 32: return launch_prefill_q<HDT, 32>(block_q, q, k, v, o, p, s);
    case 64: return launch_prefill_q<HDT, 64>(block_q, q, k, v, o, p, s);
    case 128: return launch_prefill_q<HDT, 128>(block_q, q, k, v, o, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int HDT>
static cudaError_t launch_decode(const void* q, const void* k, const void* v,
                                 float* part_acc, float* part_ml,
                                 const Problem& p, cudaStream_t stream) {
  static bool allowed[MAX_CARDS] = {};
  cudaError_t err = allow_smem(flash_attention_bf16_decode_kernel<HDT>,
                               decode_smem(HDT), allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.splits, (unsigned)p.KV, (unsigned)p.B);
  flash_attention_bf16_decode_kernel<HDT>
      <<<grid, DECODE_WARPS * 32, decode_smem(HDT), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), part_acc, part_ml, p);
  return cudaGetLastError();
}

// The problem as both kernels take it; false where the shapes are not
// taken: hd 1 to 256, hdv hd or, past a q.k tile of 128, 1 to 128.
static bool make_problem(Problem& p, const void* q, const void* k,
                         const void* v, int B, int Sq, int Skv, int H, int KV,
                         int hd, int hdv, int causal, int q_offset,
                         int kv_valid, float sl2) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > 256 || hdv < 1 || hdv > hd ||
      (hdv != hd && head_tile(hd) <= 128) || hdv > v_tile(head_tile(hd)))
    return false;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.hdv = hdv; p.causal = causal; p.q_offset = q_offset;
  p.kv_valid = kv_valid; p.splits = 1; p.sl2 = sl2;
  p.vec = hd % 8 == 0 && hdv % 8 == 0 &&
          reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return true;
}

extern "C" size_t flash_attention_bf16_smem_bytes(int block_q, int block_kv,
                                                  int hd) {
  return prefill_smem(block_q, block_kv, hd);
}

extern "C" size_t flash_attention_bf16_decode_smem_bytes(int hd) {
  return decode_smem(hd);
}

// The constants the wrapper mirrors: DECODE_ROWS, DECODE_WARPS,
// DECODE_BKV, STAGES.
extern "C" void flash_attention_bf16_layout(int* out) {
  out[0] = DECODE_ROWS;
  out[1] = DECODE_WARPS;
  out[2] = DECODE_BKV;
  out[3] = STAGES;
}

// q [B, Sq, H, hd], k [B, Skv, KV, hd], v [B, Skv, KV, hdv] and o [B, Sq,
// H, hdv] are contiguous bf16 device pointers; hd is 1 to 256; hdv is hd,
// or, past a q.k tile of 128, 1 to 128 (the wrapper pads a narrower V up
// to a tile of 128).  kv_valid is already clamped to [0, Skv]; sl2 is
// scale * log2(e).  block_q is 64 or 128 (4 or 8 warps), block_kv 32, 64
// or 128.  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int flash_attention_bf16_prefill(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int H, int KV, int hd, int hdv, int causal, int q_offset,
    int kv_valid, float sl2, int block_q, int block_kv, void* stream) {
  Problem p;
  if (!make_problem(p, q, k, v, B, Sq, Skv, H, KV, hd, hdv, causal, q_offset,
                    kv_valid, sl2) ||
      (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bq = block_q, bkv = block_kv;
  switch (head_tile(hd)) {
    case 32: return (int)launch_prefill_kv<32>(bq, bkv, q, k, v, o, p, s);
    case 64: return (int)launch_prefill_kv<64>(bq, bkv, q, k, v, o, p, s);
    case 96: return (int)launch_prefill_kv<96>(bq, bkv, q, k, v, o, p, s);
    case 128: return (int)launch_prefill_kv<128>(bq, bkv, q, k, v, o, p, s);
    case 160: return (int)launch_prefill_kv<160>(bq, bkv, q, k, v, o, p, s);
    case 192: return (int)launch_prefill_kv<192>(bq, bkv, q, k, v, o, p, s);
    case 256: return (int)launch_prefill_kv<256>(bq, bkv, q, k, v, o, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decode kernel: the same arguments as the prefill's, with Sq x H / KV
// at most DECODE_ROWS, and `splits` key ranges; part_acc [splits x
// DECODE_WARPS, B Sq H, hdv] and part_ml [splits x DECODE_WARPS, B Sq H,
// 2] are f32 device scratch the combine reads.
extern "C" int flash_attention_bf16_decode(
    const void* q, const void* k, const void* v, float* part_acc,
    float* part_ml, int B, int Sq, int Skv, int H, int KV, int hd, int hdv,
    int causal, int q_offset, int kv_valid, float sl2, int splits,
    void* stream) {
  Problem p;
  if (!make_problem(p, q, k, v, B, Sq, Skv, H, KV, hd, hdv, causal, q_offset,
                    kv_valid, sl2) ||
      Sq * (H / KV) > DECODE_ROWS || splits < 1)
    return (int)cudaErrorInvalidValue;
  p.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_tile(hd)) {
    case 32: return (int)launch_decode<32>(q, k, v, part_acc, part_ml, p, s);
    case 64: return (int)launch_decode<64>(q, k, v, part_acc, part_ml, p, s);
    case 96: return (int)launch_decode<96>(q, k, v, part_acc, part_ml, p, s);
    case 128: return (int)launch_decode<128>(q, k, v, part_acc, part_ml, p, s);
    case 160: return (int)launch_decode<160>(q, k, v, part_acc, part_ml, p, s);
    case 192: return (int)launch_decode<192>(q, k, v, part_acc, part_ml, p, s);
    case 256: return (int)launch_decode<256>(q, k, v, part_acc, part_ml, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// o [rows, width] bf16 from `parts` partials of each row (the decode
// kernel's layout).
extern "C" int flash_attention_bf16_combine(const float* part_acc,
                                            const float* part_ml, void* o,
                                            int rows, int width, int parts,
                                            float sl2, void* stream) {
  if (rows < 1 || width < 1 || parts < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)rows * width;
  flash_attention_bf16_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      part_acc, part_ml, static_cast<bf16*>(o), rows, width, parts, sl2);
  return (int)cudaGetLastError();
}
