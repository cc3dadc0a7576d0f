// The backward of flash attention (GQA, causal on absolute positions,
// kv_valid_len) on Hopper (sm_90a), products on the tensor cores.
//
// Replaces: no Pallas kernel.  The JAX package has no backward kernel
// (src/repro/kernels has no custom_vjp); its training differentiates the
// jnp attention of src/repro/models/attention.py::full_attention with
// XLA's autodiff.  This is the port's counterpart of that gradient for the
// forward kernel csrc/flash_attention.cu.  For q [B, Sq, H, hd], k and v
// [B, Skv, KV, hd], the forward's output o and its cotangent dO (f32 or
// bf16, H % KV == 0, q head h reading kv head h / (H / KV)) it computes,
// every sum in f32,
//
//   s[i, c]  = scale * q[i] . k[c]             scale = 1 / sqrt(hd)
//   P[i, c]  = exp(s[i, c] - lse[i]) where c is seen by i, else 0
//   D[i]     = dO[i] . o[i]
//   dV[c]    = sum_i P[i, c] dO[i]
//   dS[i, c] = P[i, c] (dO[i] . v[c] - D[i])   (0 where c is not seen)
//   dQ[i]    = scale * sum_c dS[i, c] k[c]
//   dK[c]    = scale * sum_i dS[i, c] q[i]
//
// with key c seen by query i when c < kv_valid and (not causal or
// c <= i + q_offset), and dV and dK of kv head g summed over the H / KV q
// heads that read it.  A row that sees no key (kv_valid = 0, or causal
// with i + q_offset < 0) got the mean of V over the Skv keys in the
// forward: its P is 1 / Skv for every key, so it adds dO / Skv to every
// dV row and nothing to dQ or dK, as autograd of the plain version gives.
//
// lse, the log-sum-exp of each row's seen scores, is recomputed here (the
// first pass of the dQ kernel) rather than kept by the forward kernel, so
// the forward and its serving launches stay as they are.
//
// What bounds it on the card: the products.  Five are needed (S, dO V^T,
// P^T dO, dS K, dS^T Q); this design does eight (lse's pass, and S and
// dO V^T again in each kernel), 2 * hd operations per seen (query, key)
// pair each.  At the llama3.2-3b training shape (B 2, S 2,048, 24 q and 8
// kv heads of 128, causal; 1.007e8 seen pairs) five products are 1.29e11
// operations: 0.130 ms at the bf16 tensor-core peak (989 TFLOP/s), and
// as 3xTF32 (three TF32 products each, 495 TFLOP/s) 0.781 ms.  The eight
// this design does are 2.06e11: 0.209 ms in bf16, 1.250 ms in 3xTF32.
//
// What the design does about it (FlashAttention-2's backward on mma.sync,
// no float atomics, deterministic):
// - bf16 inputs: mma.sync m16n8k16 bf16 with f32 accumulators.  Q, K, V
//   and dO sit in shared memory as bf16 (rows padded by 8 halves so that
//   the 8 rows an ldmatrix reads hit distinct banks); fragments come by
//   ldmatrix, and by ldmatrix.trans for the operands read along their
//   rows' other axis.  P and dS are rounded to bf16 (to nearest) only as
//   the A operands of dV += P^T dO, dQ += dS K and dK += dS^T Q; the
//   softmax statistics, D and every accumulator stay f32.
// - f32 inputs: 3xTF32 m16n8k8 (../../csrc/tf32x3.cuh), every operand
//   split into TF32 hi and lo as its fragment is loaded; tiles in shared
//   memory as f32, rows padded by 4 words.
// - Each product is computed in the layout that needs no transpose in
//   shared memory: a warp owns 16 rows of the block's tile (query rows in
//   the dq kernel, keys in the dkdv kernel), and its score tile (S, or
//   S^T = K Q^T in the dkdv kernel) comes out of the accumulators in the
//   A-operand layout of the product that follows (two n8 accumulator
//   tiles are one k16 bf16 A fragment; for TF32, key 2t and 2t + 1 of an
//   n8 tile stand in A columns t and t + 4, and the B fragment is read
//   with the same permutation), so P^T and dS^T never leave registers.
// - Two kernels on the caller's stream.  dq: one block per (query rows,
//   q head, batch) walks the keys twice, first for each row's max and sum
//   (lse, written for the second kernel, with D), then for dS and
//   dQ += dS K.  dkdv: one block per (64 keys, kv head, batch) keeps its K
//   and V tiles and loops over the group's q heads and the query chunks
//   that see its keys, recomputing S^T, P^T and dS^T, with dK and dV in
//   registers.  Every output element is written by one thread, and every
//   sum runs in a fixed order: two runs give the same bits.
// - The streamed tiles (K and V chunks in dq; Q, dO, lse and D chunks in
//   dkdv) go through two shared-memory stages filled by cp.async, chunk
//   j + 1 in flight while chunk j computes.  bf16: 4 warps (64 rows) a
//   block and chunks of 64 rows in both kernels, 103 KB of shared memory,
//   two blocks an SM.  f32 (twice the bytes a row): dq 8 warps (128 rows)
//   and chunks of 32 keys, 199 KB, one block an SM; dkdv 4 warps and
//   chunks of 16 rows, 99 KB, two blocks an SM.  At the training shape
//   the grids are 1,536 (dq) and 512 (dkdv) blocks in bf16, 768 and 512
//   in f32.
// - The blocks launch in order of cost, every head's longest first (the
//   last query rows walk every key; the first keys are seen by every
//   row): the head is the grid's fast index.  With the head slow, the
//   longest blocks of the last heads would start late and run alone at
//   the end of the grid.
// - Accumulation.  The tensor cores' f32 accumulation truncates (about
//   2^-23 of the running sum per mma, toward zero).  f32: dQ, dK and dV
//   take each chunk's contribution in a fresh partial and add it rounded
//   to nearest.  bf16: the mma accumulate into the running sums, which
//   leaves the HDT / 8 tiles of a sum independent and needs no partial
//   registers; at most (Sq / 16) * (H / KV) mma reach one sum, 384 at the
//   training shape, a bias of at most 4.6e-5 of its magnitude, 170 times
//   under TOL_BWD's 2^-7.
// - exp by the SFU (ex2.approx, scores in log2 units); the masks only on
//   the chunks that cross a mask boundary; a warp skips the chunks past
//   its rows' causal horizon, a dkdv block the query chunks that see none
//   of its keys, and a dkdv warp those that see none of its 16 (only when
//   every row sees some key).
//
// Registers (nvcc -Xptxas -v, sm_90a) at head tile 128 / 64: bf16 dq 210
// / 179, dkdv 255 / 240; f32 dq 215 / 255, dkdv 255 / 191.  No spills but
// 4 bytes in the f32 dq kernel at head tile 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "../../csrc/mma_bf16.cuh"
#include "../../csrc/tf32x3.cuh"

#define LOG2E 1.4426950408889634f
#define NEG_INF (__int_as_float(0xff800000))
#define POS_INF (__int_as_float(0x7f800000))

struct BwdProblem {
  int B, Sq, Skv, H, KV, hd;
  int causal, q_offset, kv_valid;
  int vec;  // every row is whole, aligned 16-byte chunks: cp.async them
  float scale;
};

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}
// Warps of a block (each owns 16 rows of the block's tile) and rows of a
// streamed chunk (keys in dq, query rows in dkdv), by kernel and input
// type: bf16 4 warps and 64 rows in both kernels; f32, twice the bytes a
// row, 8 warps and 32 keys in dq, 4 warps and 16 query rows in dkdv.
template <bool DKDV, typename T>
__host__ __device__ constexpr int warps() {
  return is_bf16<T>() || DKDV ? 4 : 8;
}
template <bool DKDV, typename T>
__host__ __device__ constexpr int chunk_rows() {
  return is_bf16<T>() ? 64 : DKDV ? 16 : 32;
}
// Row stride, in elements, of every tile: 16 bytes of padding.
template <typename T>
__host__ __device__ constexpr int row_stride(int hdt) {
  return hdt + 16 / (int)sizeof(T);
}
// Dynamic shared memory of a block.  dq: the Q and dO tiles, two stages
// of {K, V} chunks, D of the tile's rows.  dkdv: the K and V tiles, two
// stages of {Q, dO, lse, D} chunks.
template <int HDT, typename T>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(T) * (size_t)row_stride<T>(HDT) *
             (2 * 16 * warps<false, T>() + 4 * chunk_rows<false, T>()) +
         sizeof(float) * 16 * warps<false, T>();
}
template <int HDT, typename T>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(T) * (size_t)row_stride<T>(HDT) *
             (2 * 16 * warps<true, T>() + 4 * chunk_rows<true, T>()) +
         sizeof(float) * 4 * chunk_rows<true, T>();
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// ----------------------------------------------------------- products ---
// c[n][*] = A . Bm^T for one warp: A the warp's 16 rows and Bm N rows,
// both [rows][HDT] tiles in shared memory (row stride row_stride<T>);
// c[n] is the C fragment of Bm's rows 8n .. 8n + 7.
template <int HDT, int N, typename T>
__device__ __forceinline__ void nt_product(float (&c)[N / 8][4], const T* A,
                                           const T* Bm, int lane) {
  constexpr int LS = row_stride<T>(HDT);
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
  // ldmatrix rows: A's matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); Bm's
  // (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo), (n 8-15, k hi)
  const T* const a_row = A + (lane & 15) * LS;
  const T* const b_row = Bm + ((lane & 7) + ((lane >> 4) << 3)) * LS;
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int kt = 0; kt < HDT / 16; ++kt) {
      uint32_t a[4];
      ldsm_x4(a, a_row + kt * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_row + np * 16 * LS + kt * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < HDT / 8; ++kt) {
      uint32_t a[4], a_hi[4], a_lo[4];
      ldsm_x4(a, a_row + kt * 8 + (lane >> 4) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tf32_split(__uint_as_float(a[i]), a_hi[i], a_lo[i]);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_row + np * 16 * LS + kt * 8 + ((lane >> 3) & 1) * 4);
        BFrags<2> bf;
        bf.split(0, __uint_as_float(b[0]), __uint_as_float(b[1]));
        bf.split(1, __uint_as_float(b[2]), __uint_as_float(b[3]));
        mma_3xtf32<2, false>(
            [&](int i) -> float (&)[4] { return c[2 * np + i]; }, a_hi, a_lo,
            bf);
      }
    }
  }
}

// The A operand of nn_product, made from a [16][N] tile in the
// C-fragment layout nt_product leaves (x[n] holds columns 8n .. 8n + 7),
// so that the tile's floats die before the product.  bf16: the values
// rounded to bf16 (to nearest), two n8 tiles to one k16 fragment.  f32:
// TF32 hi and lo, A column t of a k8 fragment standing for column 2t of
// an n8 tile and column t + 4 for column 2t + 1.
template <int N, typename T>
struct AOperand;
template <int N>
struct AOperand<N, __nv_bfloat16> {
  uint32_t a[N / 16][4];
  __device__ __forceinline__ explicit AOperand(const float (&x)[N / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
      a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
      a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    }
  }
};
template <int N>
struct AOperand<N, float> {
  uint32_t hi[N / 8][4], lo[N / 8][4];
  __device__ __forceinline__ explicit AOperand(const float (&x)[N / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      tf32_split(x[kk][0], hi[kk][0], lo[kk][0]);
      tf32_split(x[kk][2], hi[kk][1], lo[kk][1]);
      tf32_split(x[kk][1], hi[kk][2], lo[kk][2]);
      tf32_split(x[kk][3], hi[kk][3], lo[kk][3]);
    }
  }
};

// acc += X . Bm for one warp: X [16][N] given as its A operand, Bm an
// [N][HDT] tile in shared memory (for TF32, read in X's column order).
// bf16: every mma accumulates into acc, the k-steps outermost, so that
// the HDT / 8 tiles of acc are independent chains.  f32: each n8 tile of
// acc takes the N columns' sum in a fresh partial and adds it rounded to
// nearest (the tensor cores' f32 accumulation truncates).
template <int HDT, int N, typename T>
__device__ __forceinline__ void nn_product(float (&acc)[HDT / 8][4],
                                           const AOperand<N, T>& x,
                                           const T* Bm, int lane) {
  constexpr int LS = row_stride<T>(HDT);
  if constexpr (is_bf16<T>()) {
    // ldmatrix.trans rows: (k 0-7, n lo), (k 8-15, n lo), (k 0-7, n hi),
    // (k 8-15, n hi)
    const T* const b_row = Bm + (lane & 15) * LS + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < HDT / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_row + kk * 16 * LS + dp * 16);
        mma_bf16(acc[2 * dp], x.a[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], x.a[kk], b[2], b[3]);
      }
  } else {
    constexpr int G = 2;  // n8 tiles whose mma interleave
    const int gid = lane >> 2, tig = lane & 3;
    const T* const b_col = Bm + 2 * tig * LS + gid;
#pragma unroll
    for (int n0 = 0; n0 < HDT / 8; n0 += G) {
      float part[G][4] = {};
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        BFrags<G> bf;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const T* const at = b_col + kk * 8 * LS + (n0 + i) * 8;
          bf.split(i, at[0], at[LS]);
        }
        mma_3xtf32<G, false>(
            [&](int i) -> float (&)[4] { return part[i]; }, x.hi[kk],
            x.lo[kk], bf);
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
    }
  }
}

// Rows [r0, r0 + n) of a tensor whose row r starts at base + r * rs into
// rows 0 .. n - 1 of a [rows][HDT] tile (columns < hd; the rest of the
// tile keeps what it holds).  Asynchronous (cp.async, committed by the
// caller) when p.vec, else plain copies.
template <int HDT, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* base, size_t rs,
                                           int r0, int n,
                                           const BwdProblem& p) {
  constexpr int LS = row_stride<T>(HDT);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (p.vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
    const int cpr = p.hd / EPC;
    for (int i = tid; i < n * cpr; i += nthreads) {
      const int r = i / cpr, j = (i - r * cpr) * EPC;
      cp_async16(dst + r * LS + j, base + (size_t)(r0 + r) * rs + j);
    }
  } else {
    for (int i = tid; i < n * p.hd; i += nthreads) {
      const int r = i / p.hd, d = i - r * p.hd;
      dst[r * LS + d] = base[(size_t)(r0 + r) * rs + d];
    }
  }
}

// Zero a block's shared memory: the head-dim padding and the rows past a
// tensor's end stay zero, and stale stage rows are finite.
__device__ __forceinline__ void zero_smem(void* sm, size_t bytes) {
  float4* z = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < (int)(bytes / 16); i += blockDim.x)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dQ, and each row's lse (in log2 units) and D for the dkdv kernel.
template <int HDT, typename T>
__global__ void __launch_bounds__(32 * warps<false, T>(),
                                  warps<false, T>() > 4 ? 1 : 2)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ delta_out,
              BwdProblem p) {
  constexpr int LS = row_stride<T>(HDT), CH = chunk_rows<false, T>();
  constexpr int NT = CH / 8, DT = HDT / 8, TILE = 16 * warps<false, T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Qs = reinterpret_cast<T*>(smem_raw);
  T* const dOs = Qs + TILE * LS;
  T* const KVs = dOs + TILE * LS;  // stage i: K at 2i, V at 2i + 1
  float* const D_s = reinterpret_cast<float*>(KVs + 4 * CH * LS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // blocks launch in order of cost, every head's longest first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int g = h / (p.H / p.KV);
  const size_t qrs = (size_t)p.H * p.hd, krs = (size_t)p.KV * p.hd;
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  const size_t koff = ((size_t)b * p.Skv * p.KV + g) * p.hd;
  const float sl2 = p.scale * LOG2E;  // scores in log2 units

  zero_smem(smem_raw, dq_smem_bytes<HDT, T>());
  __syncthreads();

  // the keys any row of this block sees
  const int n_rows = min(TILE, p.Sq - q0);
  const int q_last = q0 + n_rows - 1;
  int kv_end = min(p.Skv, p.kv_valid);
  if (p.causal) kv_end = min(kv_end, p.q_offset + q_last + 1);
  kv_end = max(kv_end, 0);
  const int n_chunks = (kv_end + CH - 1) / CH;

  stage_rows<HDT>(Qs, q + qoff, qrs, q0, n_rows, p);
  stage_rows<HDT>(dOs, dout + qoff, qrs, q0, n_rows, p);
  cp_async_commit();
  // step s < n_chunks: chunk s of K (pass 1); else chunk s - n_chunks of
  // K and V (pass 2)
  auto load_step = [&](int s) {
    const int pass2 = s >= n_chunks, kv0 = (s - pass2 * n_chunks) * CH;
    const int nk = min(CH, kv_end - kv0);
    T* const Kd = KVs + (size_t)(2 * (s & 1)) * CH * LS;
    stage_rows<HDT>(Kd, k + koff, krs, kv0, nk, p);
    if (pass2) stage_rows<HDT>(Kd + CH * LS, v + koff, krs, kv0, nk, p);
    cp_async_commit();
  };
  if (n_chunks) load_step(0);

  // D of the warp's rows, in a fixed order: two lanes a row, the even
  // and the odd columns
  const int wr0 = warp * 16, wq0 = q0 + wr0;
  {
    const int r = wr0 + (lane >> 1);
    float acc = 0.0f;
    if (r < n_rows) {
      const T* const orow = o + qoff + (size_t)(q0 + r) * qrs;
      const T* const drow = dout + qoff + (size_t)(q0 + r) * qrs;
#pragma unroll 8
      for (int d = lane & 1; d < p.hd; d += 2)
        acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!(lane & 1)) D_s[r] = acc;
  }
  __syncwarp();
  const float Drow[2] = {D_s[wr0 + gid], D_s[wr0 + gid + 8]};

  // the keys this warp's rows see
  const bool live = wq0 < p.Sq;
  int w_end = kv_end;
  if (p.causal)
    w_end = max(0, min(w_end, p.q_offset + min(wq0 + 15, p.Sq - 1) + 1));
  const T* const Qw = Qs + wr0 * LS;
  const T* const dOw = dOs + wr0 * LS;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, lse2[2];
  auto finish_pass1 = [&]() {  // each row's lse, written with its D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = l[r] > 0.0f ? m[r] + log2f(l[r]) : POS_INF;
      const int qi = wq0 + gid + 8 * r;
      if (tig == 0 && qi < p.Sq) {
        const size_t at = ((size_t)b * p.H + h) * p.Sq + qi;
        lse_out[at] = lse2[r];
        delta_out[at] = Drow[r];
      }
    }
  };
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int s = 0; s < 2 * n_chunks; ++s) {
    const int pass2 = s >= n_chunks, kv0 = (s - pass2 * n_chunks) * CH;
    const T* const Ks = KVs + (size_t)(2 * (s & 1)) * CH * LS;
    const T* const Vs = Ks + CH * LS;
    cp_async_wait<0>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + 1 < 2 * n_chunks) load_step(s + 1);
    if (s == n_chunks) finish_pass1();
    if (!live || kv0 >= w_end) continue;

    float sc[NT][4];
    nt_product<HDT, CH>(sc, Qw, Ks, lane);
    // every score of the chunk is seen by every row of the warp, or the
    // masks apply: score (n, e) is key kv0 + 8n + 2t + (e & 1) of row
    // wq0 + g + 8 (e >> 1)
    const bool clean = kv0 + CH <= kv_end &&
                       (!p.causal || kv0 + CH - 1 <= p.q_offset + wq0);
    auto seen = [&](int n, int e) {
      const int c = kv0 + n * 8 + 2 * tig + (e & 1);
      const int qpos = wq0 + gid + 8 * (e >> 1) + p.q_offset;
      return c < kv_end && (!p.causal || c <= qpos);
    };
    if (!pass2) {
      // each row's max m and sum l of exp(s - m) over its seen keys; a
      // row that has seen no key yet keeps m = -inf and l = 0 (the
      // shuffles run on every lane: the rows of a warp may differ)
      if (clean) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] *= sl2;
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = seen(n, e) ? sc[n][e] * sl2 : NEG_INF;
      }
      float cmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cmax[e >> 1] = fmaxf(cmax[e >> 1], sc[n][e]);
      float mn[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
        mn[r] = fmaxf(m[r], cmax[r]);
      }
      // exp2(-inf - -inf) would be NaN: a row with no key yet adds 0
      const float base[2] = {mn[0] == NEG_INF ? 0.0f : mn[0],
                             mn[1] == NEG_INF ? 0.0f : mn[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e >> 1] += exp2_approx(sc[n][e] - base[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * exp2_approx(m[r] - base[r]) + sum[r];
        m[r] = mn[r];
      }
      continue;
    }

    // pass 2: dS = P (dO V^T - D) and dQ += dS K
    float dp[NT][4];
    nt_product<HDT, CH>(dp, dOw, Vs, lane);
    if (clean) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          sc[n][e] = exp2_approx(fmaf(sc[n][e], sl2, -lse2[r])) *
                     (dp[n][e] - Drow[r]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pr = seen(n, e)
                               ? exp2_approx(fmaf(sc[n][e], sl2, -lse2[r]))
                               : 0.0f;
          sc[n][e] = pr * (dp[n][e] - Drow[r]);
        }
    }
    nn_product<HDT, CH>(acc, AOperand<CH, T>(sc), Ks, lane);
  }
  if (!n_chunks) {  // no row of the block sees a key
    finish_pass1();
    cp_async_wait<0>();
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + gid + 8 * r;
    if (qi >= p.Sq) continue;
    T* const row = dq + qoff + (size_t)qi * qrs;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tig + e;
        if (d < p.hd) put(row + d, acc[n][2 * r + e] * p.scale);
      }
  }
}

// dK and dV of 64 keys of one kv head, summed over its q heads.
template <int HDT, typename T>
__global__ void __launch_bounds__(32 * warps<true, T>(),
                                  warps<true, T>() > 4 ? 1 : 2)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_in,
                const float* __restrict__ delta_in, T* __restrict__ dk,
                T* __restrict__ dv, BwdProblem p) {
  constexpr int LS = row_stride<T>(HDT), CH = chunk_rows<true, T>();
  constexpr int NT = CH / 8, DT = HDT / 8, TILE = 16 * warps<true, T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Ks = reinterpret_cast<T*>(smem_raw);
  T* const Vs = Ks + TILE * LS;
  T* const QDs = Vs + TILE * LS;  // stage i: Q at 2i, dO at 2i + 1
  float* const stats = reinterpret_cast<float*>(QDs + 4 * CH * LS);
  // stage i: lse at stats + 2i CH, D at stats + (2i + 1) CH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // blocks launch in order of cost (the first keys see the most rows)
  const int k0 = blockIdx.y * TILE;
  const int g = blockIdx.x % p.KV, b = blockIdx.x / p.KV;
  const int group = p.H / p.KV;
  const size_t qrs = (size_t)p.H * p.hd, krs = (size_t)p.KV * p.hd;
  const size_t koff = ((size_t)b * p.Skv * p.KV + g) * p.hd;
  const float sl2 = p.scale * LOG2E;

  zero_smem(smem_raw, dkdv_smem_bytes<HDT, T>());
  __syncthreads();
  stage_rows<HDT>(Ks, k + koff, krs, k0, min(TILE, p.Skv - k0), p);
  stage_rows<HDT>(Vs, v + koff, krs, k0, min(TILE, p.Skv - k0), p);
  cp_async_commit();

  // the query chunks to visit: every one if some row sees no key (it
  // adds dO / Skv to every key), else those that see a key of this block
  const bool any_dead = p.kv_valid == 0 || (p.causal && p.q_offset < 0);
  int q_lo = 0;
  if (!any_dead) {
    if (k0 >= p.kv_valid)
      q_lo = p.Sq;
    else if (p.causal)
      q_lo = max(0, k0 - p.q_offset);
  }
  q_lo = min(q_lo, p.Sq) / CH * CH;
  const int per_head = (p.Sq - q_lo + CH - 1) / CH;
  const int n_steps = group * per_head;
  const float inv_skv = 1.0f / (float)p.Skv;

  // step s: q head g * group + s / per_head, rows q_lo + (s % per_head) CH
  auto load_step = [&](int s) {
    const int h = g * group + s / per_head;
    const int q0 = q_lo + (s % per_head) * CH, nq = min(CH, p.Sq - q0);
    const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
    T* const Qd = QDs + (size_t)(2 * (s & 1)) * CH * LS;
    stage_rows<HDT>(Qd, q + qoff, qrs, q0, nq, p);
    stage_rows<HDT>(Qd + CH * LS, dout + qoff, qrs, q0, nq, p);
    float* const st = stats + 2 * (s & 1) * CH;
    if (tid < CH) {
      const size_t at = ((size_t)b * p.H + h) * p.Sq + q0 + tid;
      if (tid < nq) {
        cp_async4(st + tid, lse_in + at);
        cp_async4(st + CH + tid, delta_in + at);
      } else {
        st[tid] = POS_INF;
        st[CH + tid] = 0.0f;
      }
    }
    cp_async_commit();
  };
  if (n_steps) load_step(0);

  const int wk0 = k0 + warp * 16;  // this warp's keys
  const T* const Kw = Ks + warp * 16 * LS;
  const T* const Vw = Vs + warp * 16 * LS;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const int q0 = q_lo + (s % per_head) * CH;
    const T* const Qs = QDs + (size_t)(2 * (s & 1)) * CH * LS;
    const T* const dOs = Qs + CH * LS;
    const float* const lse_s = stats + 2 * (s & 1) * CH;
    const float* const D_s = lse_s + CH;
    cp_async_wait<0>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + 1 < n_steps) load_step(s + 1);
    // a chunk that sees none of this warp's keys adds nothing
    if (wk0 >= p.Skv ||
        (!any_dead && (wk0 >= p.kv_valid ||
                       (p.causal && q0 + CH - 1 + p.q_offset < wk0))))
      continue;

    float st[NT][4], dpt[NT][4];  // [key][query]
    nt_product<HDT, CH>(st, Kw, Qs, lane);
    nt_product<HDT, CH>(dpt, Vw, dOs, lane);
    // score (n, e) is query q0 + 8n + 2t + (e & 1) of key wk0 + g +
    // 8 (e >> 1); clean: every row is live and sees every key of the warp
    const bool clean = !any_dead && q0 + CH <= p.Sq &&
                       wk0 + 16 <= p.kv_valid &&
                       (!p.causal || wk0 + 15 <= q0 + p.q_offset);
    if (clean) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 ls =
            *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * tig);
        const float2 dd =
            *reinterpret_cast<const float2*>(D_s + n * 8 + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr =
              exp2_approx(fmaf(st[n][e], sl2, -(e & 1 ? ls.y : ls.x)));
          dpt[n][e] = pr * (dpt[n][e] - (e & 1 ? dd.y : dd.x));
          st[n][e] = pr;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 8 + 2 * tig + (e & 1);  // query in the chunk
          const int c = wk0 + gid + 8 * (e >> 1), qi = q0 + i;
          const int qpos = qi + p.q_offset;
          const bool live = qi < p.Sq;
          const bool dead = p.kv_valid == 0 || (p.causal && qpos < 0);
          const bool seen = live && !dead && c < p.kv_valid &&
                            (!p.causal || c <= qpos);
          const float pr =
              seen           ? exp2_approx(fmaf(st[n][e], sl2, -lse_s[i]))
              : live && dead ? inv_skv
                             : 0.0f;
          dpt[n][e] = seen ? pr * (dpt[n][e] - D_s[i]) : 0.0f;
          st[n][e] = pr;
        }
    }
    const AOperand<CH, T> pa(st), dsa(dpt);
    nn_product<HDT, CH>(dv_acc, pa, dOs, lane);
    nn_product<HDT, CH>(dk_acc, dsa, Qs, lane);
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no step

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = wk0 + gid + 8 * r;
    if (c >= p.Skv) continue;
    T* const krow = dk + koff + (size_t)c * krs;
    T* const vrow = dv + koff + (size_t)c * krs;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * tig + e;
        if (d < p.hd) {
          put(krow + d, dk_acc[n][2 * r + e] * p.scale);
          put(vrow + d, dv_acc[n][2 * r + e]);
        }
      }
  }
}

template <int HDT, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, void* dq,
                          void* dk, void* dv, float* lse, float* delta,
                          const BwdProblem& p, cudaStream_t stream) {
  const size_t dq_smem = dq_smem_bytes<HDT, T>();
  const size_t kv_smem = dkdv_smem_bytes<HDT, T>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<HDT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<HDT, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr int TQ = 16 * warps<false, T>(), TK = 16 * warps<true, T>();
  const dim3 gq((unsigned)(p.H * p.B), (unsigned)((p.Sq + TQ - 1) / TQ));
  bwd_dq_kernel<HDT, T><<<gq, 2 * TQ, dq_smem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse,
      delta, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((unsigned)(p.KV * p.B), (unsigned)((p.Skv + TK - 1) / TK));
  bwd_dkdv_kernel<HDT, T><<<gk, 2 * TK, kv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, float* lse, float* delta,
                             const BwdProblem& p, cudaStream_t s) {
  if (p.hd <= 64)
    return launch<64, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, p, s);
  return launch<128, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, p, s);
}

// Dynamic shared memory of the dq (kernel 0) and dkdv (kernel 1) blocks at
// head dim hd for f32 (bf16 = 0) or bf16 (1) inputs; flash_attention.py's
// bwd_smem_bytes computes the same.
extern "C" size_t flash_attention_bwd_smem_bytes(int hd, int kernel,
                                                 int bf16) {
  using bf = __nv_bfloat16;
  if (hd <= 64) {
    if (bf16)
      return kernel ? dkdv_smem_bytes<64, bf>() : dq_smem_bytes<64, bf>();
    return kernel ? dkdv_smem_bytes<64, float>() : dq_smem_bytes<64, float>();
  }
  if (bf16)
    return kernel ? dkdv_smem_bytes<128, bf>() : dq_smem_bytes<128, bf>();
  return kernel ? dkdv_smem_bytes<128, float>() : dq_smem_bytes<128, float>();
}

// q, o, dout, dq [B, Sq, H, hd] and k, v, dk, dv [B, Skv, KV, hd] are
// contiguous device pointers of f32 (bf16 = 0) or bf16 (bf16 = 1); lse and
// delta are f32 scratch of B * H * Sq.  kv_valid is already clamped to
// [0, Skv].  Returns a cudaError_t (0 on success); both kernels are
// enqueued on `stream`, the dkdv kernel after the dq kernel that writes
// lse and delta.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* lse, float* delta, int B,
                                   int Sq, int Skv, int H, int KV, int hd,
                                   int causal, int q_offset, int kv_valid,
                                   int bf16, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > 128 || kv_valid < 0 || kv_valid > Skv)
    return (int)cudaErrorInvalidValue;
  BwdProblem p;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.causal = causal; p.q_offset = q_offset; p.kv_valid = kv_valid;
  p.scale = scale;
  const int elem = bf16 ? 2 : 4;
  auto aligned = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  p.vec = (hd * elem) % 16 == 0 && aligned(q) && aligned(k) && aligned(v) &&
          aligned(dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                         delta, p, s);
  return (int)launch_hd<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, p,
                               s);
}
