// Flash attention over an int8 KV cache on Hopper (sm_90a): the keys split
// across blocks (flash-decoding), one K/V read per GQA group, the int8
// score dot and the p.V product on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/int8.py::flash_attention_int8
// (the Pallas TPU kernel, pallas_call at l.111, _kernel at l.46).  For q
// [B, Sq, H, hd] f32, kq and vq [B, Skv, KV, hd] int8, per-token K scales
// ks [B, Skv, KV, 1] and per-channel V scales vs [B, 1, KV, hd] (f32;
// repro_torch/quant/quantize.py::quantize_kv) it computes, per query row,
//
//   qs     = (absmax(q) > 0 ? absmax(q) : 1) / 127         a true division
//   qq[d]  = round_half_even(q[d] / qs)                     int8
//   s32[c] = sum_d qq[d] * kq[c, d]                         int32, exact
//   s[c]   = ((float)s32[c] * (qs * scale)) * ks[c]         scale = 1/sqrt(hd)
//   s[c]   = -1e30 unless c < kv_valid and (not causal or c <= i + q_offset)
//   o[d]   = vs[d] * sum_c softmax(s)[c] * vq[c, d]         f32
//
// What bounds it on the card: bytes, in the decode regime this variant
// exists for (a short q block against a long cache, K and V as int8).  At
// the llama3.2-3b decode window (B 4, Sq 32, 8,192 keys, 24 heads over 8 kv
// heads, hd 128) the kernel must read 67 MB of K/V; the score dot and the
// two f16 products of p.V take less time on the tensor cores than that.
//
// What the design does about it:
// - The keys are split across blocks.  A block's work is one (q tile,
//   key split, b, kv head g); int8.py's split_count chooses the split count
//   from the problem and the card's SM count, so the grid fills the card
//   even where B * KV * q tiles is a fraction of the SMs.  Each split
//   writes a partial (m, l, acc) per row to an f32 scratch, and a second
//   kernel (combine_kernel) adds the splits in ascending order: an output
//   is the same bit for bit from run to run.  One split writes the output
//   directly.
// - One K/V read per GQA group: a block takes every q head of kv head g, so
//   its rows are (query position, head) pairs, position-major: block_q
//   positions x group heads, in slices of at most 6 tiles of 16 rows (two
//   blocks of 6 warps an SM at 168 registers a thread).  A warp owns one
//   16-row mma tile; tiles past Sq are skipped.  Below 4 tiles, 2 or 4
//   warps share a tile and take turns over its keys (key groups), adding
//   their partials in a fixed order at the end.
// - The score dot is mma.sync m16n8k32 s8 -> s32 (exact): the quantized q
//   rows sit in shared memory once (hd padded to a multiple of 32 with
//   zeros; a warp loads QROWS rows at once, so a block waits for a few
//   round trips to device memory, not one a row); a warp reads its A
//   fragments and K's B fragments by ldmatrix, 32 keys at a time.
// - p.V: the per-channel vs commutes out of the key sum, so the kernel
//   sums p * vq and multiplies by vs once at the end.  vq in [-127, 127] is
//   exact in f16; p * 2^15 is split into f16 hi + lo (no value of p in
//   [2^-18, 1] loses a bit past 2^-22 of itself; smaller ones lose at most
//   2^-40) and two mma.sync m16n8k16 f16 products run on each k-step.  V's
//   B fragments come by ldmatrix.trans straight from the int8 rows (a pair
//   of bytes read as one b16 element) and are widened to f16 with a byte
//   permute and one f16x2 subtraction (0x64XX is 1024 + XX in f16).  The
//   tensor core's f32 accumulation truncates, so each 32 keys' products
//   go into a fresh partial (four mma deep) that is added to the
//   accumulators rounded to nearest.  The accumulators are rescaled only
//   when some row's running max moved.  P is never quantized: p is not a
//   function of the chunking only (the running max is), so quantizing it
//   would make tiles disagree.
// - K, V and the K scales are staged by cp.async into STAGES (2)
//   shared-memory stages, block_kv keys each: chunk j + 1 is in flight
//   while chunk j computes (3 and 4 stages measured no faster).  Rows are
//   padded to hd rounded up to 32, plus 16 bytes, so the 8 rows of an
//   ldmatrix hit distinct banks.  Rows that are not whole 16-byte chunks
//   are copied 4 bytes at a time, or byte by byte when the pointers are
//   not 4-byte aligned.  V stays int8 in shared memory.
//
// Numerics: the quantization and the score dequant are written with
// __fdiv_rn, __float2int_rn (round half to even), __fmul_rn and
// __int2float_rn, so nvcc neither approximates the division nor contracts
// the dequant: the scores equal the plain version's (int8.py::
// flash_attention_int8_ref) bit for bit, and the softmax's sums differ in
// their order only.
//
// Registers: everything the end of the kernel needs is recomputed there
// from the special registers (place_again), so that nothing from its start
// is held across the key loop; at 168 registers no instance spills.
//
// Masking: a row that sees no key at all (kv_valid = 0, or every key in its
// causal future) averages V over the Skv keys, as the plain version does:
// the keys of a block are trimmed to the causal horizon of its last row
// only when every row of the block sees key 0 (kv_valid > 0 and, causal,
// q_offset + first position >= 0), and a warp's on the same condition for
// its 16 rows.  Within a split, a key past the split scores -inf (p = 0)
// and a masked key -1e30.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define MAX_WARPS 6  // 96 rows a block: 168 registers a thread, no spills
#define STAGES 2
#define MAX_BLOCK_KV 256
#define NEG_BIG (-1e30f)
#define NEG_INF (__int_as_float(0xff800000))  // -inf: p = exp(-inf) = 0
#define LOG2E 1.4426950408889634f  // exp(x) as exp2(x log2 e)
#define QMAX 127.0f
#define P_SCALE 32768.0f           // p is split as p * 2^15 = hi + lo
#define P_UNSCALE (1.0f / 32768.0f)
#define QROWS 8                    // q rows a warp loads at once
#define MAX_CARDS 64

struct Problem {
  int B, Sq, Skv, H, KV, hd;
  int causal, q_offset, kv_valid;
  int block_q, bkv, splits, slices, row_tiles;
  int width;  // bytes a K/V copy moves: 16, 4 or 1 (plain loads)
  float scale;
};

// hd padded to the k of the score mma; a K/V/q row's stride in shared
// memory (an odd number of 16-byte units: ldmatrix rows on distinct banks)
__host__ __device__ constexpr int head_pad(int hd) {
  return (hd + 31) / 32 * 32;
}
__host__ __device__ constexpr int row_stride(int hdp) { return hdp + 16; }

// Row stride, in floats, of the partials that warps sharing a row tile
// exchange at the end (acc, then m and l), and how many such rows there
// are at most: (key groups - 1) x row tiles <= 3 x 1 tile of 16 rows.
__host__ __device__ constexpr int xchg_stride(int hdp) { return hdp + 4; }
#define XCHG_ROWS 48

// Dynamic shared memory of one block of `rows` (16 x row tiles) q rows:
// the int8 q rows and their scales, then STAGES x {K rows, V rows, K
// scales} of bkv keys, a region the exchange of partials reuses at the
// end; int8.py's smem_bytes computes the same.
__host__ __device__ inline size_t smem_size(int rows, int bkv, int hd) {
  const size_t rs = row_stride(head_pad(hd));
  const size_t stages = (size_t)STAGES * bkv * (2 * rs + 4);
  const size_t xchg = (size_t)XCHG_ROWS * xchg_stride(head_pad(hd)) * 4;
  return (size_t)rows * (rs + 4) + (stages > xchg ? stages : xchg);
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
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 8 x 16-byte matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives word (l / 4, l % 4) of each (.trans: the 16-bit
// elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4)).
// (Shared-memory addresses are 32-bit: fewer registers than pointers.)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}
// Two matrices, lanes 0-15 giving the addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a) : "memory");
}
__device__ __forceinline__ float2 lds_float2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

// d += a * b, m16n8k32, s8 inputs, s32 accumulators (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k16, f16 inputs, f32 accumulators (FRESH: d = a * b).
template <bool FRESH>
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (FRESH)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {a, b} (a in the low half, the lower k) as f16x2, rounded to nearest.
__device__ __forceinline__ uint32_t pack_f16(float a, float b) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// p_a * 2^15 and p_b * 2^15 (two keys of a row) as f16 hi + lo.
__device__ __forceinline__ void split_p(float pa, float pb, uint32_t& hi,
                                        uint32_t& lo) {
  const float a = pa * P_SCALE, b = pb * P_SCALE;
  hi = pack_f16(a, b);
  const float ha = __half2float(__ushort_as_half((unsigned short)(hi & 0xffffu)));
  const float hb = __half2float(__ushort_as_half((unsigned short)(hi >> 16)));
  lo = pack_f16(a - ha, b - hb);
}

// Four int8 (bytes 0-3 of v) as two f16x2: bytes 0, 2 -> even, 1, 3 -> odd.
// b ^ 0x80 is b + 128 as an unsigned byte; 0x64XX is 1024 + XX in f16, so
// subtracting 1152 leaves b, exactly.
__device__ __forceinline__ void widen_s8(uint32_t v, uint32_t& even,
                                         uint32_t& odd) {
  const uint32_t x = v ^ 0x80808080u;
  uint32_t e, o;
  asm("prmt.b32 %0, %1, %2, 0x4240;\n" : "=r"(e) : "r"(x), "r"(0x64646464u));
  asm("prmt.b32 %0, %1, %2, 0x4341;\n" : "=r"(o) : "r"(x), "r"(0x64646464u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(even) : "r"(e), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(odd) : "r"(o), "r"(0x64806480u));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// `rows` rows of `bytes` bytes from src + row * src_stride to dst + row *
// dst_stride, `width` bytes a copy (16 or 4 by cp.async, 1 by plain loads).
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const signed char* src,
                                          size_t src_stride, int rows,
                                          int bytes, int width, int tid,
                                          int nthreads) {
  const int per = bytes / width, total = rows * per;
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / per, c = (i - r * per) * width;
    unsigned char* d = dst + r * dst_stride + c;
    const signed char* s = src + r * src_stride + c;
    if (width == 16)
      cp_async16(d, s);
    else if (width == 4)
      cp_async4(d, s);
    else
      *d = (unsigned char)*s;
  }
}

// Where a thread's work lies: its block's q tile rows (position-major: row
// R is position q0 + R / group, head g * group + R % group; rows r0 ..
// r0 + nrows - 1 of the tile's rows before Sq are the block's), key split
// and (b, kv head g), and the thread's warp, row tile rt and key group kg.
struct Place {
  int b, g, group, q0, r0, nrows, split, warp, lane, rt, kg;
};

__device__ __forceinline__ Place place_of(const Problem& p, unsigned tid,
                                          unsigned bx, unsigned by,
                                          unsigned bz) {
  Place w;
  const int rows_cap = p.row_tiles * 16;
  const int tile = bx / p.slices;
  w.split = by;
  w.b = bz / p.KV;
  w.g = bz - w.b * p.KV;
  w.group = p.H / p.KV;
  w.q0 = tile * p.block_q;
  w.r0 = (bx - tile * p.slices) * rows_cap;
  w.nrows = min((min(w.q0 + p.block_q, p.Sq) - w.q0) * w.group - w.r0,
                rows_cap);
  w.warp = tid >> 5;
  w.lane = tid & 31;
  w.rt = w.warp % p.row_tiles;
  w.kg = w.warp / p.row_tiles;
  return w;
}

// The special registers read anew (volatile): what is derived from them
// after the key loop is recomputed there, not held in registers across it.
__device__ __forceinline__ Place place_again(const Problem& p) {
  unsigned t, x, y, z;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return place_of(p, t, x, y, z);
}

// After the key loop: key groups 1 .. KG - 1 hand their (m, l, acc) to
// group 0 through shared memory, which adds them in ascending group order;
// then rows gid and gid + 8 of each live row tile give the output (one
// split) or this split's partial (flagged when no key of the split was
// visited: l = 0).  A thread holds columns 16i + 4t .. 16i + 4t + 3 of
// each row.
template <int HDP>
__device__ __forceinline__ void finish(const Problem& p,
                                       float (&acc)[HDP / 8][4],
                                       float (&m)[2], float (&l)[2],
                                       const float* __restrict__ vs,
                                       float* __restrict__ o,
                                       float* __restrict__ part_acc,
                                       float* __restrict__ part_ml,
                                       unsigned char* smem) {
  constexpr int RS = row_stride(HDP);
  constexpr int XS = xchg_stride(HDP);
  constexpr int DN = HDP / 8;
  const Place at = place_again(p);
  const int RT = p.row_tiles, KG = (blockDim.x >> 5) / RT;
  const int rt = at.rt, kg = at.kg, gid = at.lane >> 2, tig = at.lane & 3;
  const int group = at.group, r0 = at.r0, nrows = at.nrows;
  const bool warp_live = 16 * rt < nrows;
  unsigned char* const stages = smem + RT * 16 * (RS + 4);
  if (KG > 1) {
    cp_async_wait<0>();  // only empty groups are left
    __syncthreads();     // every warp is done with the stages
    float* const xchg = reinterpret_cast<float*>(stages);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* const xrow =
          xchg + (((kg - 1) * RT + rt) * 16 + gid + 8 * r) * XS;
      if (kg > 0 && warp_live) {
#pragma unroll
        for (int i = 0; i < DN / 2; ++i)
          *reinterpret_cast<float4*>(xrow + 16 * i + 4 * tig) = make_float4(
              acc[2 * i][2 * r], acc[2 * i + 1][2 * r],
              acc[2 * i][2 * r + 1], acc[2 * i + 1][2 * r + 1]);
        if (tig == 0) {
          xrow[HDP] = m[r];
          xrow[HDP + 1] = l[r];
        }
      }
    }
    __syncthreads();
    if (kg > 0) return;
    if (warp_live) {
      for (int k2 = 1; k2 < KG; ++k2)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* const xrow =
              xchg + (((k2 - 1) * RT + rt) * 16 + gid + 8 * r) * XS;
          const float m2 = xrow[HDP], l2 = xrow[HDP + 1];
          const float mm = fmaxf(m[r], m2);
          const float w1 = exp2f((m[r] - mm) * LOG2E);
          const float w2 = exp2f((m2 - mm) * LOG2E);
          m[r] = mm;
          l[r] = l[r] * w1 + l2 * w2;
#pragma unroll
          for (int i = 0; i < DN / 2; ++i) {
            const float4 a =
                *reinterpret_cast<const float4*>(xrow + 16 * i + 4 * tig);
            acc[2 * i][2 * r] = acc[2 * i][2 * r] * w1 + a.x * w2;
            acc[2 * i + 1][2 * r] = acc[2 * i + 1][2 * r] * w1 + a.y * w2;
            acc[2 * i][2 * r + 1] = acc[2 * i][2 * r + 1] * w1 + a.z * w2;
            acc[2 * i + 1][2 * r + 1] =
                acc[2 * i + 1][2 * r + 1] * w1 + a.w * w2;
          }
        }
    }
  }

  if (!warp_live) return;
  const float* const vsg = vs + ((size_t)at.b * p.KV + at.g) * p.hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = r0 + 16 * rt + gid + 8 * r;
    if (R - r0 >= nrows) continue;
    const size_t row = ((size_t)at.b * p.Sq + at.q0 + R / group) * p.H +
                       at.g * group + R % group;
    if (p.splits > 1) {
      const size_t prow = (size_t)at.split * p.B * p.Sq * p.H + row;
      if (tig == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * prow) =
            make_float2(l[r] > 0.0f ? m[r] : NEG_INF, l[r]);
      if (l[r] == 0.0f) continue;  // nothing to add
      float* const dst = part_acc + prow * p.hd;
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) {
        const int d = 16 * i + 4 * tig;
        if (d < p.hd)
          *reinterpret_cast<float4*>(dst + d) = make_float4(
              acc[2 * i][2 * r], acc[2 * i + 1][2 * r],
              acc[2 * i][2 * r + 1], acc[2 * i + 1][2 * r + 1]);
      }
    } else {
      const float den = fmaxf(l[r], 1e-30f);
      float* const dst = o + row * p.hd;
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) {
        const int d = 16 * i + 4 * tig;
        if (d < p.hd)
          *reinterpret_cast<float4*>(dst + d) = make_float4(
              acc[2 * i][2 * r] * P_UNSCALE * vsg[d] / den,
              acc[2 * i + 1][2 * r] * P_UNSCALE * vsg[d + 1] / den,
              acc[2 * i][2 * r + 1] * P_UNSCALE * vsg[d + 2] / den,
              acc[2 * i + 1][2 * r + 1] * P_UNSCALE * vsg[d + 3] / den);
      }
    }
  }
}

// HDP: hd padded to 32; KT: keys a warp scores at a time (16 or 32).
template <int HDP, int KT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
flash_attention_int8_kernel(const float* __restrict__ q,
                            const signed char* __restrict__ kq,
                            const float* __restrict__ ks,
                            const signed char* __restrict__ vq,
                            const float* __restrict__ vs,
                            float* __restrict__ o,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml, Problem p) {
  constexpr int RS = row_stride(HDP);
  constexpr int DK = HDP / 32;  // k32 steps of the score dot
  constexpr int DN = HDP / 8;   // n8 tiles of the output
  constexpr int NT = KT / 8;    // key tiles a warp scores at a time
  constexpr int KK = KT / 16;   // k16 steps of p.V a sub-chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  // row tiles of 16 rows, and key groups: the warps that share a row
  // tile, each taking every KG-th sub-chunk of KT keys
  const int RT = p.row_tiles, KG = nwarps / RT;
  const int rows_cap = RT * 16;
  signed char* const Qs = reinterpret_cast<signed char*>(smem);
  float* const QSs = reinterpret_cast<float*>(smem + rows_cap * RS);
  unsigned char* const stages = smem + rows_cap * (RS + 4);
  const int stage_bytes = p.bkv * (2 * RS + 4);

  const int tid = threadIdx.x;
  const Place at = place_of(p, tid, blockIdx.x, blockIdx.y, blockIdx.z);
  const int warp = at.warp, lane = at.lane, gid = lane >> 2, tig = lane & 3;
  const int rt = at.rt, kg = at.kg, split = at.split;
  const int b = at.b, g = at.g, group = at.group, q0 = at.q0, r0 = at.r0;
  const int nrows = at.nrows;
  if (nrows <= 0) return;  // the whole block past Sq

  // the keys this block visits (all Skv unless every row sees key 0), and
  // its split of them: `per` keys a split, a multiple of 16
  int kv_end = p.Skv;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + q0 + r0 / group >= 0)) {
    kv_end = min(kv_end, p.kv_valid);
    if (p.causal)
      kv_end = min(kv_end, p.q_offset + q0 + (r0 + nrows - 1) / group + 1);
  }
  const int per = ((kv_end + p.splits - 1) / p.splits + 15) / 16 * 16;
  const int k_begin = split * per;
  const int k_end = min(k_begin + per, kv_end);
  const int n_chunks =
      k_end > k_begin ? (k_end - k_begin + p.bkv - 1) / p.bkv : 0;

  const size_t key_stride = (size_t)p.KV * p.hd;  // bytes between keys
  const size_t kv_base = ((size_t)b * p.Skv * p.KV + g) * p.hd;
  const float* const ks_base = ks + (size_t)b * p.Skv * p.KV + g;
  auto load_chunk = [&](int kv0, int st) {
    const int nc = min(p.bkv, k_end - kv0);
    unsigned char* const Kd = stages + st * stage_bytes;
    unsigned char* const Vd = Kd + p.bkv * RS;
    float* const KSd = reinterpret_cast<float*>(Vd + p.bkv * RS);
    copy_rows(Kd, RS, kq + kv_base + kv0 * key_stride, key_stride, nc, p.hd,
              p.width, tid, nthreads);
    copy_rows(Vd, RS, vq + kv_base + kv0 * key_stride, key_stride, nc, p.hd,
              p.width, tid, nthreads);
    for (int c = tid; c < nc; c += nthreads)
      cp_async4(KSd + c, ks_base + (size_t)(kv0 + c) * p.KV);
    cp_async_commit();
  };
  // the first STAGES - 1 chunks in flight (an empty group where there is
  // no chunk, so that a wait counts groups alike)
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks)
      load_chunk(k_begin + st * p.bkv, st);
    else
      cp_async_commit();
  }

  // quantize the block's q rows, one warp a row, QROWS rows a warp loaded
  // at once; rows past nrows and the columns past hd are zeros
  for (int r1 = warp; r1 < rows_cap; r1 += QROWS * nwarps) {
    float v[QROWS][DK];
#pragma unroll
    for (int u = 0; u < QROWS; ++u) {
      const int r = r1 + u * nwarps, R = r0 + r;
      const float* const qrow =
          q + (((size_t)b * p.Sq + q0 + R / group) * p.H + g * group +
               R % group) * p.hd;
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const int d = lane + 32 * i;
        v[u][i] = r < nrows && d < p.hd ? qrow[d] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < QROWS; ++u) {
      const int r = r1 + u * nwarps;
      float mx = 0.0f;
#pragma unroll
      for (int i = 0; i < DK; ++i) mx = fmaxf(mx, fabsf(v[u][i]));
      mx = warp_max(mx);
      const float qs = __fdiv_rn(mx > 0.0f ? mx : 1.0f, QMAX);
      if (r < rows_cap) {
#pragma unroll
        for (int i = 0; i < DK; ++i)
          Qs[r * RS + lane + 32 * i] =
              (signed char)__float2int_rn(__fdiv_rn(v[u][i], qs));
        if (lane == 0) QSs[r] = __fmul_rn(qs, p.scale);
      }
    }
  }
  __syncthreads();

  // this warp's row tile: the thread's two rows (gid, gid + 8), their
  // positions, and the keys the tile must visit
  const int wr = 16 * rt;
  const bool warp_live = wr < nrows;
  const int Ra = r0 + wr + gid, Rb = Ra + 8;
  const int pos_a = q0 + Ra / group, pos_b = q0 + Rb / group;
  const int wpos0 = q0 + (r0 + wr) / group;
  const int wpos1 = q0 + (r0 + min(wr + 16, nrows) - 1) / group;
  int w_end = k_end;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + wpos0 >= 0)) {
    w_end = min(w_end, p.kv_valid);
    if (p.causal) w_end = min(w_end, p.q_offset + wpos1 + 1);
  }
  const float qs_a = QSs[wr + gid], qs_b = QSs[wr + gid + 8];
  const uint32_t Qw = smem_addr(Qs) + (wr + (lane & 15)) * RS +
                      16 * (lane >> 4);
  const uint32_t stages_at = smem_addr(stages);

  float acc[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_chunks; ++j) {
    const int kv0 = k_begin + j * p.bkv;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
    // chunk j + STAGES - 1 into the stage chunk j - 1 left
    if (j + STAGES - 1 < n_chunks)
      load_chunk(kv0 + (STAGES - 1) * p.bkv, (j + STAGES - 1) % STAGES);
    else
      cp_async_commit();
    if (!warp_live) continue;
    const uint32_t Ks = stages_at + (j % STAGES) * stage_bytes;
    const uint32_t Vs = Ks + p.bkv * RS;
    const uint32_t KSs = Vs + p.bkv * RS;
    const int c_end = min(kv0 + p.bkv, w_end);
    // this key group's sub-chunks: the split's KT-key sub-chunks i with
    // i % KG == kg
    const int i0 = (kv0 - k_begin) / KT;

    for (int sub0 = kv0 + KT * ((kg - i0 % KG + KG) % KG); sub0 < c_end;
         sub0 += KT * KG) {
      const int c0 = sub0 - kv0;  // the sub-chunk's first key in the stage

      // S = Qq Kq^T: int32, exact
      int s32[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s32[n][e] = 0;
#pragma unroll
      for (int kt = 0; kt < DK; ++kt) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qw + 32 * kt);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kb[4];  // key tiles n and n + 1, k 0-15 and 16-31
          ldmatrix_x4(kb, Ks + (c0 + 8 * n + 8 * (lane >> 4) + (lane & 7)) *
                                   RS + 32 * kt + 16 * ((lane >> 3) & 1));
          mma_s8(s32[n], qa, kb[0], kb[1]);
          mma_s8(s32[n + 1], qa, kb[2], kb[3]);
        }
      }

      // the dequant, and the masks where the sub-chunk crosses a boundary
      const bool clean = sub0 + KT <= k_end && sub0 + KT <= p.kv_valid &&
                         (!p.causal || sub0 + KT - 1 <= p.q_offset + wpos0);
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 kss = lds_float2(KSs + 4 * (c0 + 8 * n + 2 * tig));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = __fmul_rn(
              __fmul_rn(__int2float_rn(s32[n][e]), e < 2 ? qs_a : qs_b),
              (e & 1) ? kss.y : kss.x);
          if (!clean) {
            const int c = sub0 + 8 * n + 2 * tig + (e & 1);
            const int qpos = (e < 2 ? pos_a : pos_b) + p.q_offset;
            v = c >= k_end ? NEG_INF
                : c < p.kv_valid && (!p.causal || c <= qpos) ? v
                                                               : NEG_BIG;
          }
          s[n][e] = v;
        }
      }

      // online softmax: rows gid (e = 0, 1) and gid + 8 (e = 2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
      // the running max moves rarely once a row has seen a few chunks: a
      // correction of exactly 1 for every row of the warp changes nothing
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int jn = 0; jn < DN; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][e] *= corr[e >> 1];
      }

      // acc += P Vq.  P's A fragments straight from S's accumulators (key
      // tiles 2kk and 2kk + 1), split into f16 hi + lo; Vq's B fragments by
      // ldmatrix.trans: matrices 0 and 1 keys 0-7 and 8-15 of columns
      // d0 .. d0 + 15; a lane holds keys (2t, 2t + 1) of columns (2g,
      // 2g + 1), so its even bytes are the B fragment of the n-tile of even
      // columns, its odd bytes of the odd one: acc[2i] holds columns
      // 16i + 2n, acc[2i + 1] 16i + 2n + 1.  The
      // sub-chunk's products go into a fresh partial, added rounded to
      // nearest (the tensor core's own accumulation truncates).
      uint32_t ph[KK][4], pl[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        split_p(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
        split_p(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
        split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
      const uint32_t vrow = Vs + (c0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS;
#pragma unroll
      for (int d0 = 0; d0 < HDP; d0 += 16) {
        float d[2][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          uint32_t vb[2], be[2], bo[2];
          ldmatrix_x2_trans(vb, vrow + 16 * kk * RS + d0);
          widen_s8(vb[0], be[0], bo[0]);
          widen_s8(vb[1], be[1], bo[1]);
          if (kk == 0) {
            mma_f16<true>(d[0], pl[kk], be[0], be[1]);
            mma_f16<true>(d[1], pl[kk], bo[0], bo[1]);
          } else {
            mma_f16<false>(d[0], pl[kk], be[0], be[1]);
            mma_f16<false>(d[1], pl[kk], bo[0], bo[1]);
          }
          mma_f16<false>(d[0], ph[kk], be[0], be[1]);
          mma_f16<false>(d[1], ph[kk], bo[0], bo[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[d0 / 8][e] += d[0][e];
          acc[d0 / 8 + 1][e] += d[1][e];
        }
      }
    }
  }

  finish<HDP>(p, acc, m, l, vs, o, part_acc, part_ml, smem);
}

// The splits' partials of each row added in ascending split order, then
// o = vs * acc / max(l, 1e-30); one thread per four columns of a row.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml,
               const float* __restrict__ vs, float* __restrict__ o,
               Problem p) {
  const int hd4 = p.hd / 4;
  const size_t rows = (size_t)p.B * p.Sq * p.H;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * hd4) return;
  const size_t row = idx / hd4;
  const int d = (int)(idx - row * hd4) * 4;
  float mx = NEG_INF;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, part_ml[2 * (s * rows + row)]);
  float l = 0.0f;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < p.splits; ++s) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + 2 * (s * rows + row));
    if (ml.x == NEG_INF) continue;  // the split saw no key of this row
    const float w = exp2f((ml.x - mx) * LOG2E);
    const float4 v = *reinterpret_cast<const float4*>(
        part_acc + (s * rows + row) * p.hd + d);
    l = fmaf(ml.y, w, l);
    a.x = fmaf(v.x, w, a.x);
    a.y = fmaf(v.y, w, a.y);
    a.z = fmaf(v.z, w, a.z);
    a.w = fmaf(v.w, w, a.w);
  }
  const int h = (int)(row % p.H);
  const int b = (int)(row / ((size_t)p.Sq * p.H));
  const float* const vsg = vs + ((size_t)b * p.KV + h / (p.H / p.KV)) * p.hd;
  const float den = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(o + row * p.hd + d) =
      make_float4(a.x * P_UNSCALE * vsg[d] / den,
                  a.y * P_UNSCALE * vsg[d + 1] / den,
                  a.z * P_UNSCALE * vsg[d + 2] / den,
                  a.w * P_UNSCALE * vsg[d + 3] / den);
}

template <int HDP, int KT>
static cudaError_t launch(const float* q, const signed char* kq,
                          const float* ks, const signed char* vq,
                          const float* vs, float* o, float* part_acc,
                          float* part_ml, const Problem& p, int warps,
                          cudaStream_t stream) {
  const size_t smem = smem_size(16 * p.row_tiles, p.bkv, p.hd);
  // the most any block of this instance asks for, allowed once a card
  static bool allowed[MAX_CARDS] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card >= MAX_CARDS || !allowed[card]) {
    err = cudaFuncSetAttribute(
        flash_attention_int8_kernel<HDP, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_size(16 * MAX_WARPS, MAX_BLOCK_KV, HDP));
    if (err != cudaSuccess) return err;
    if (card < MAX_CARDS) allowed[card] = true;
  }
  const dim3 grid((unsigned)((p.Sq + p.block_q - 1) / p.block_q * p.slices),
                  (unsigned)p.splits, (unsigned)(p.B * p.KV));
  flash_attention_int8_kernel<HDP, KT><<<grid, warps * 32, smem, stream>>>(
      q, kq, ks, vq, vs, o, part_acc, part_ml, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t n = (size_t)p.B * p.Sq * p.H * (p.hd / 4);
  combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part_acc, part_ml, vs, o, p);
  return cudaGetLastError();
}

template <int HDP>
static cudaError_t launch_kt(const float* q, const signed char* kq,
                             const float* ks, const signed char* vq,
                             const float* vs, float* o, float* part_acc,
                             float* part_ml, const Problem& p, int warps,
                             cudaStream_t s) {
  // 32 keys at a time (16 in chunks of 16): S, P's fragments and the
  // accumulators fit 128 registers, two blocks of 8 warps an SM
  if (p.bkv == 16)
    return launch<HDP, 16>(q, kq, ks, vq, vs, o, part_acc, part_ml, p, warps,
                           s);
  return launch<HDP, 32>(q, kq, ks, vq, vs, o, part_acc, part_ml, p, warps,
                         s);
}

extern "C" size_t flash_attention_int8_smem_bytes(int rows, int block_kv,
                                                  int hd) {
  return smem_size(rows, block_kv, hd);
}

// q [B, Sq, H, hd] f32, kq and vq [B, Skv, KV, hd] int8, ks [B, Skv, KV, 1]
// f32, vs [B, 1, KV, hd] f32 and o [B, Sq, H, hd] f32 are contiguous device
// pointers; hd % 4 == 0, kv_valid is clamped to [0, Skv].  block_q is
// positions a q tile, block_kv keys a chunk (16, 32, 64, 128 or 256).
// Each q tile's rows (positions x group) are served by `slices` blocks of
// `row_tiles` tiles of 16 rows (slices * row_tiles * 16 rows cover them),
// each block `warps` warps: warps / row_tiles key groups share a tile
// ((key groups - 1) * row_tiles <= 3); the keys are split `splits` ways.  With splits > 1, part_acc [splits, B, Sq, H, hd] and
// part_ml [splits, B, Sq, H, 2] (f32) take the partials and a second
// kernel combines them into o.  Returns a cudaError_t (0 on success); the
// launches are asynchronous on `stream`.
extern "C" int flash_attention_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, void* o, void* part_acc, void* part_ml, int B, int Sq,
    int Skv, int H, int KV, int hd, int causal, int q_offset, int kv_valid,
    float scale, int block_q, int block_kv, int splits, int slices,
    int row_tiles, int warps, void* stream) {
  const int group = KV > 0 ? H / KV : 0;
  const long long tile_rows =
      (long long)(block_q < Sq ? block_q : Sq) * group;
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
      hd > 128 || hd % 4 != 0 || block_q < 1 || block_kv < 16 ||
      block_kv > MAX_BLOCK_KV || (block_kv & (block_kv - 1)) != 0 ||
      kv_valid < 0 || kv_valid > Skv || splits < 1 || slices < 1 ||
      row_tiles < 1 || warps > MAX_WARPS || warps % row_tiles != 0 ||
      (warps / row_tiles - 1) * row_tiles * 16 > XCHG_ROWS ||
      (long long)slices * row_tiles * 16 < tile_rows ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.causal = causal; p.q_offset = q_offset; p.kv_valid = kv_valid;
  p.block_q = block_q; p.bkv = block_kv; p.splits = splits;
  p.slices = slices; p.row_tiles = row_tiles; p.scale = scale;
  const uintptr_t kv_bits = reinterpret_cast<uintptr_t>(kq) |
                            reinterpret_cast<uintptr_t>(vq);
  p.width = hd % 16 == 0 && kv_bits % 16 == 0 ? 16 : kv_bits % 4 == 0 ? 4 : 1;
  const float* qf = static_cast<const float*>(q);
  const signed char* kc = static_cast<const signed char*>(kq);
  const float* ksf = static_cast<const float*>(ks);
  const signed char* vc = static_cast<const signed char*>(vq);
  const float* vsf = static_cast<const float*>(vs);
  float* of = static_cast<float*>(o);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_pad(hd)) {
    case 32: return (int)launch_kt<32>(qf, kc, ksf, vc, vsf, of, pa, pm, p, warps, s);
    case 64: return (int)launch_kt<64>(qf, kc, ksf, vc, vsf, of, pa, pm, p, warps, s);
    case 96: return (int)launch_kt<96>(qf, kc, ksf, vc, vsf, of, pa, pm, p, warps, s);
    default: return (int)launch_kt<128>(qf, kc, ksf, vc, vsf, of, pa, pm, p, warps, s);
  }
}
