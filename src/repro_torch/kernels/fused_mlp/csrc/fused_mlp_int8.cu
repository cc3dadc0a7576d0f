// int8 fused MLP inference on Hopper (sm_90a), the product on the tensor
// cores (mma.sync m16n8k32 s8 -> s32).
//
// Replaces: src/repro/kernels/fused_mlp/int8.py::fused_mlp_int8 (the Pallas
// TPU kernel, pallas_call at l.108, _kernel at l.50).  Per layer and per
// row it computes
//
//   absmax = max_k |h[k]|
//   hs     = (absmax > 0 ? absmax : 1) / 127          (a true division)
//   hq[k]  = round_half_even(h[k] / hs)                (int8)
//   acc[n] = sum_k hq[k] * wq[k, n]                    (int32, exact)
//   h[n]   = act(((float)acc[n] * hs) * ws[n] + b[n])
//
// with wq [in, out] int8 and ws [out] the per-output-channel weight scales
// quantized once at load (repro_torch/quant/quantize.py).
//
// What carries over from the TPU kernel: activations never go to device
// memory between layers; only the input rows are read from and the last
// layer's rows written to device memory.
//
// Bound on the card: at serving batches the work is 2*B*sum(in*out) int8
// operations, 1,979 TOPS dense on the tensor cores.  What holds a fused
// kernel back first is the weights each SM takes in: every group of rows
// streams the whole packed net (2.2 MB for the widest minibude net,
// L2-resident) through the SM's shared memory, and a row group is capped
// by the registers that hold a layer's outputs until the row's absmax is
// known.
//
// The weight pack (fused_mlp/int8.py's pack_words, done once at load):
// per layer, K zero-padded to a multiple of 32 and N to a multiple of 8,
// int32 words [K/32][N/8][32 lanes][2]: the two B-fragment registers of
// lane (g, t) = (lane / 4, lane % 4) of one k32 x n8 mma tile, word r
// holding wq[32 kt + 16 r + 4 t + 0..3][8 nt + g] (byte b = k offset b).
// So one 8-byte load gives a lane its fragment, a warp's 32 loads of one
// tile are 256 contiguous bytes, and a run of tiles of one k32 step is
// one contiguous block.
//
// The mma path (block_rows BM = 16, 32 or 64 rows):
// - A block keeps its rows' int8 activations hq [BM, stride_q] (rows
//   padded by 16 bytes so the 8 rows of an ldmatrix hit distinct banks)
//   and their scales in shared memory.  Each of its 8 warps owns the n8
//   tiles w, w + 8, ... of a layer's columns for all BM rows, the int32
//   accumulators in registers (at most 128 a thread: layers up to 2,048
//   / 1,024 / 512 wide at 16 / 32 / 64 rows).  A k-step loads the A
//   fragments of the BM / 16 row tiles with ldmatrix and each tile's B
//   fragment with one 8-byte load (straight-line code, loads ahead of
//   the mma), then runs BM / 16 mma per tile.
// - The weights stream through a ring of slabs of SLAB_STEPS k32 steps
//   (as many as fit, up to MAX_STAGES) by the Tensor Memory Accelerator
//   (cp.async.bulk, the bytes counted on the slot's "full" mbarrier),
//   across layer boundaries.  The warp that releases a slab last (a count
//   per slot) asks for the slab that goes into its slot next, so no warp
//   waits for another between k-steps.
// - The epilogue dequantizes the accumulators in registers, applies the
//   bias and activation (the activation a template argument, so the
//   unrolled code stays straight), and quantizes straight from the
//   registers: each row's absmax is reduced over its 4 lanes by shuffles
//   and over the warps by an atomicMax on the float's bits in shared
//   memory (|h| >= 0, so the bits order as the values; max is exact in
//   any order); after one barrier every thread quantizes its outputs
//   into hq, in place.  No f32 activation buffer.
// - No clusters: TMA multicast of each slab to 2 blocks of different
//   rows, and 2 blocks splitting the columns of 64 rows (half the
//   weights an SM takes in per row), ran slower on the H100 than one
//   block of 32 rows: the coupled ring, the cluster barriers and the
//   distributed-shared-memory stores cost more than the L2 reads saved.
//
// The rows path (block_rows 1, 2, 4, 8) keeps the domain of the first
// port: layers of any width whose f32 and int8 rows fit a block (one row
// up to about 46,000 wide), __dp4a on the CUDA cores, one live output
// column per thread per pass, reading the same pack (a column's 8 words
// of a k32 step are 32 contiguous bytes).
//
// Numerics: the quantization and the dequant epilogue follow the plain
// PyTorch version (quant_mlp_ref) op for op: __fdiv_rn for the scale,
// round half to even of the true quotient (see quantize), __fmul_rn and
// __fadd_rn so that nvcc does not contract the epilogue into an FMA.
// Integer accumulation is exact and independent of order, and a row
// never reads another row, so each output row is bit-identical whatever
// the batch size, block_rows or path.

#include <cuda_runtime.h>

#include <cstdint>

#define MAX_LAYERS 16
#define K_PAD 32        // K is zero-padded to a multiple of this (an mma k)
#define N_PAD 8         // N is zero-padded to a multiple of this (an mma n)
#define TABLE_FIELDS 6  // per layer: in, out, act, q_off, s_off, b_off
#define WARPS 8         // mma path: warps a block
#define SLAB_STEPS 2    // mma path: k32 steps a slab of the ring holds
#define MAX_STAGES 6    // mma path: slabs in the ring, as many as fit
#define ACC_REGS 128    // mma path: int32 accumulators a thread holds
#define META_BYTES 2048 // mma path: barriers, counts, scales, maxima, table
#define SMEM_LIMIT 232448  // dynamic shared memory a block can use
#define ROWS_THREADS 256   // rows path: threads a block

struct LayerTable {
  int n_layers;
  int in_w[MAX_LAYERS];
  int out_w[MAX_LAYERS];
  int act[MAX_LAYERS];
  long long q_off[MAX_LAYERS];  // int32 words into qweights
  long long s_off[MAX_LAYERS];  // floats into fparams (ws)
  long long b_off[MAX_LAYERS];  // floats into fparams (b)
};

// act codes: 0 identity, 1 relu, 2 gelu (tanh approximation), 3 tanh,
// 4 silu, 5 sigmoid -- the same table as fused_mlp.py's ACT_CODES, and the
// same function as fused_mlp.cu's: each library is built (and its build
// hashed) from its one source, so the two keep their own copies.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:
      return fmaxf(v, 0.0f);
    case 2: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.0f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    case 3:
      return tanhf(v);
    case 4:
      return v / (1.0f + expf(-v));
    case 5:
      return 1.0f / (1.0f + expf(-v));
    default:
      return v;
  }
}
// The same function with the code fixed at compile time.
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  return activate(v, ACT);
}

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The dequant epilogue of one accumulator, op for op as quant_mlp_ref.
template <typename Act>
__device__ __forceinline__ float dequant(int acc, float hs, float ws,
                                         float bias, Act act) {
  return act(
      __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), hs), ws), bias));
}

// One row's scale from its absmax (a true division).
__device__ __forceinline__ float row_scale(float m) {
  return __fdiv_rn(m > 0.0f ? m : 1.0f, 127.0f);
}

// round_half_even(fl(v / s)), the true division's quotient rounded to an
// integer, from rs = fl(1 / s) (one division a row).  |v| <= 127 s, so
// q = fl(v * rs) is within 1.5 * 2^-23 * 128 < 2^-15 of fl(v / s): where q
// lies more than 2^-14 from every half-integer, fl(v / s) lies on the same
// side of it and both round to the same integer.  Closer than that (about
// one value in 8,000), the division decides.  The rounding adds and
// subtracts 1.5 * 2^23 (exact round-half-even for |q| < 2^22, no
// conversion instruction: those run at a quarter of the f32 rate) and
// reads the integer from the sum's low bits.  A zero v gives 0.
__device__ __forceinline__ signed char quantize(float v, float s, float rs) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000
  const float q = __fmul_rn(v, rs);
  const float t = __fadd_rn(q, kRound);
  int n = __float_as_int(t) - 0x4B400000;  // rint(q)
  if (fabsf(__fsub_rn(q, __fsub_rn(t, kRound))) >= 0.5f - 0x1p-14f)
    n = __float2int_rn(__fdiv_rn(v, s));
  return (signed char)n;
}

// ---------------------------------------------------------- mma path ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// The Tensor Memory Accelerator's one-dimensional copy (cp.async.bulk):
// `bytes` (a multiple of 16, both addresses 16-byte aligned), reported to
// an mbarrier in shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}
// The four 8x8 b16 matrices of an m16 x k32 int8 A fragment: lane l gives
// the address of row l % 16, bytes 16 * (l / 16).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
// The barrier of one block's warps.
__device__ __forceinline__ void warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
}

// n8 tiles a warp owns at most, per m16 row tiles of a block.
__host__ __device__ constexpr int max_tiles(int mt) {
  return ACC_REGS / 4 / mt;
}
// The widest layer output the mma path takes at bm rows.
__host__ __device__ constexpr int mma_max_out(int bm) {
  return WARPS * N_PAD * max_tiles(bm / 16);
}

// Strides and dynamic shared memory of one block; fused_mlp/int8.py's
// smem_bytes computes the same.
__host__ __device__ inline int mma_stride_q(int max_in) {
  return round_up(max_in, K_PAD) + 16;
}
__host__ __device__ inline int slab_bytes(int max_out) {
  return SLAB_STEPS * K_PAD * round_up(max_out, N_PAD);
}
__host__ __device__ inline int wsb_bytes(int max_out) {
  return 2 * round_up(max_out, N_PAD) * (int)sizeof(float);
}
// The ring's slots: as many slabs as fit beside the rest, at least 2 (a
// net that needs 2 and does not fit them is refused), at most MAX_STAGES.
__host__ __device__ inline int mma_stages(int max_in, int max_out, int bm) {
  const long long rest = META_BYTES + wsb_bytes(max_out) +
                         (long long)bm * mma_stride_q(max_in);
  const long long n = (SMEM_LIMIT - rest) / slab_bytes(max_out);
  return n < 2 ? 2 : n > MAX_STAGES ? MAX_STAGES : (int)n;
}
__host__ __device__ inline size_t smem_size(int max_in, int max_out,
                                            int max_width, int bm) {
  if (bm <= 8)
    return (size_t)bm * round_up(max_width, 4) * 4 +
           (size_t)bm * round_up(max_width, K_PAD) +
           (size_t)round_up(bm * 4, 16);
  return META_BYTES + wsb_bytes(max_out) +
         (size_t)mma_stages(max_in, max_out, bm) * slab_bytes(max_out) +
         (size_t)bm * mma_stride_q(max_in);
}

// The mma of one k-step over a warp's tiles j = 0 .. 2P-1 (the tile at
// bst[j * WARPS * 32]): straight-line code, so the B-fragment loads are
// issued ahead of the mma that take them.  An odd tile count takes one
// extra copy of its last tile, into an accumulator that is never stored.
template <int MT, int P, int NTW>
__device__ __forceinline__ void k_tiles(int (&acc)[MT][NTW][4],
                                        const uint32_t (&a)[MT][4],
                                        const uint2* bst, int ntw) {
  uint2 b[2 * P];
#pragma unroll
  for (int j = 0; j < 2 * P; ++j) b[j] = bst[min(j, ntw - 1) * WARPS * 32];
#pragma unroll
  for (int j = 0; j < 2 * P; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][j], a[mt], b[j]);
}
template <int MT, int NTW>
__device__ __forceinline__ void k_step(int (&acc)[MT][NTW][4],
                                       const uint32_t (&a)[MT][4],
                                       const uint2* bst, int ntw) {
  static_assert(NTW % 2 == 0 && NTW <= 32, "tile pairs");
  switch ((ntw + 1) >> 1) {  // tile pairs, uniform per layer and warp
#define K_TILES(P)                                                     \
  case P:                                                              \
    if constexpr (2 * P <= NTW) k_tiles<MT, P, NTW>(acc, a, bst, ntw); \
    break;
    K_TILES(1) K_TILES(2) K_TILES(3) K_TILES(4) K_TILES(5) K_TILES(6)
    K_TILES(7) K_TILES(8) K_TILES(9) K_TILES(10) K_TILES(11) K_TILES(12)
    K_TILES(13) K_TILES(14) K_TILES(15) K_TILES(16)
#undef K_TILES
    default:
      break;
  }
}

// The dequant epilogue of a warp's tiles in registers: each int32
// accumulator becomes its f32 output (padding columns 0), and rmax takes
// each row's largest |output|.  Column col0 + WARPS*8*j + e.
template <int ACT, int MT, int NTW>
__device__ __forceinline__ void dequant_tiles(int (&acc)[MT][NTW][4],
                                              float (&rmax)[MT][2],
                                              const float (&hsr)[MT][2],
                                              const float* wsb, int wsb_n,
                                              int col0, int N, int ntw) {
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j < ntw) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + WARPS * N_PAD * j + e;
        const bool live = col < N;
        const float ws = live ? wsb[col] : 0.0f;
        const float bias = live ? wsb[wsb_n + col] : 0.0f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v =
                live ? dequant(acc[mt][j][e + 2 * hh], hsr[mt][hh], ws, bias,
                               [](float u) { return activate<ACT>(u); })
                     : 0.0f;
            acc[mt][j][e + 2 * hh] = __float_as_int(v);
            rmax[mt][hh] = fmaxf(rmax[mt][hh], fabsf(v));
          }
      }
    }
  }
}

// BM = 16 * MT rows a block.
template <int MT>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_mlp_int8_mma_kernel(const float* __restrict__ x,
                          float* __restrict__ out,
                          const int* __restrict__ qweights,
                          const float* __restrict__ fparams, int rows,
                          int stride_q, int slab_b, int stages, int wsb_b,
                          LayerTable table) {
  constexpr int BM = 16 * MT, NTW = max_tiles(MT);
  static_assert(MAX_STAGES * 12 + 3 * BM * 4 + 4 * (MAX_LAYERS + 1) <=
                        META_BYTES / 2 &&
                    sizeof(LayerTable) <= META_BYTES / 2,
                "meta");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  int* const released = reinterpret_cast<int*>(full + MAX_STAGES);
  float* const hs = reinterpret_cast<float*>(released + MAX_STAGES);  // [BM]
  unsigned* const amax = reinterpret_cast<unsigned*>(hs + BM);  // [2][BM]
  int* const slab0 = reinterpret_cast<int*>(amax + 2 * BM);  // per layer
  LayerTable& t = *reinterpret_cast<LayerTable*>(smem + META_BYTES / 2);
  float* const wsb = reinterpret_cast<float*>(smem + META_BYTES);  // ws, b
  const int wsb_n = wsb_b / 8;  // floats of each of the two
  unsigned char* const ring = smem + META_BYTES + wsb_b;  // stages x slab_b
  signed char* const hq =
      reinterpret_cast<signed char*>(ring + (size_t)stages * slab_b);
  const int row0 = (int)blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  if (tid == 0) {
    t = table;
    slab0[0] = 0;
    for (int l = 0; l < table.n_layers; ++l)
      slab0[l + 1] = slab0[l] + (table.in_w[l] + K_PAD * SLAB_STEPS - 1) /
                                    (K_PAD * SLAB_STEPS);
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * BM; i += WARPS * 32) amax[i] = 0u;
  if (tid < MAX_STAGES) released[tid] = 0;
  __syncthreads();  // the table, counts and barriers are ready

  // Slab q (counted over every layer's k-steps in order, SLAB_STEPS a
  // slab) goes into ring slot q % stages: its k32 steps of the pack, one
  // contiguous copy, its bytes counted on the slot's "full" barrier.
  auto issue = [&](int q) {
    int l = 0;
    while (l < t.n_layers && q >= slab0[l + 1]) ++l;
    if (l >= t.n_layers) return;
    const int ks0 = (q - slab0[l]) * SLAB_STEPS;
    const int steps =
        min(SLAB_STEPS, (t.in_w[l] + K_PAD - 1) / K_PAD - ks0);
    const uint32_t run = K_PAD * round_up(t.out_w[l], N_PAD);  // a k-step
    const int stage = q % stages;
    mbar_expect_tx(full + stage, steps * run);
    bulk_copy(ring + (size_t)stage * slab_b,
              reinterpret_cast<const unsigned char*>(qweights + t.q_off[l]) +
                  (size_t)ks0 * run,
              steps * run, full + stage);
  };
  if (tid == 0)
    for (int q = 0; q < stages; ++q) issue(q);

  // layer 0's input rows, quantized from device memory by one warp a row
  {
    const int f0 = t.in_w[0], kp = round_up(f0, K_PAD);
    for (int r = warp; r < BM; r += WARPS) {
      const int row = row0 + r;
      const float* xr = x + (size_t)row * f0;
      float m = 0.0f;
      if (row < rows)
        for (int k = lane; k < f0; k += 32) m = fmaxf(m, fabsf(xr[k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float s = row_scale(m), rs = __frcp_rn(s);
      signed char* qr = hq + r * stride_q;
      for (int k = lane; k < kp; k += 32)
        qr[k] = row < rows && k < f0 ? quantize(xr[k], s, rs)
                                     : (signed char)0;
      if (lane == 0) hs[r] = s;
    }
  }
  warps_sync();

  int seq = 0, stage = 0, round = 0;  // the slab being consumed, its slot
  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.in_w[l], N = t.out_w[l], act = t.act[l];
    const int nt = (N + N_PAD - 1) / N_PAD;
    const int ntw = nt > warp ? (nt - warp + WARPS - 1) / WARPS : 0;
    const bool last = l == t.n_layers - 1;

    // this warp's columns of ws and b into shared memory, in flight
    // during the k-steps (the epilogue reads them)
    const float* const WS = fparams + t.s_off[l];
    const float* const Bv = fparams + t.b_off[l];
    for (int i = lane; i < ntw * 16; i += 32) {
      const int col = (warp + WARPS * (i >> 4)) * N_PAD + (i & 7);
      if (col < N)
        cp_async4(wsb + (i & 8 ? wsb_n : 0) + col, (i & 8 ? Bv : WS) + col);
    }

    int acc[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

    const uint32_t run = K_PAD * round_up(N, N_PAD);  // bytes a k-step
    for (int k0 = 0; k0 < K; k0 += K_PAD * SLAB_STEPS) {
      mbar_wait(full + stage, round & 1);
#pragma unroll
      for (int s = 0; s < SLAB_STEPS; ++s) {
        const int k1 = k0 + s * K_PAD;
        if (s > 0 && k1 >= K) break;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], hq + (mt * 16 + (lane & 15)) * stride_q + k1 +
                                 16 * (lane >> 4));
        const uint2* const bst =
            reinterpret_cast<const uint2*>(ring + (size_t)stage * slab_b +
                                           s * run) +
            lane + warp * 32;
        k_step<MT>(acc, a, bst, ntw);
      }
      // the slab is released once this warp's mma have their operands;
      // the last warp out asks for the slab that goes into its slot (the
      // fences order every warp's reads of the slot before the copy)
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(released + stage, 1) == WARPS - 1) {
          released[stage] = 0;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(seq + stages);
        }
      }
      __syncwarp();
      ++seq;
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }

    // the epilogue in registers: this thread's rows mt*16 + gid + 8*hh,
    // columns (warp + WARPS*j)*8 + 2*tig + e
    cp_async_wait_all();
    __syncwarp();
    float hsr[MT][2], rmax[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        hsr[mt][hh] = hs[mt * 16 + gid + 8 * hh];
        rmax[mt][hh] = 0.0f;
      }
    switch (act) {
#define DEQUANT(A)                                                         \
  case A:                                                                  \
    dequant_tiles<A>(acc, rmax, hsr, wsb, wsb_n, warp * N_PAD + 2 * tig,   \
                     N, ntw);                                              \
    break;
      DEQUANT(0) DEQUANT(1) DEQUANT(2) DEQUANT(3) DEQUANT(4) DEQUANT(5)
#undef DEQUANT
    }

    if (last) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < ntw)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = (warp + WARPS * j) * N_PAD + 2 * tig + (e & 1);
              const int row = row0 + mt * 16 + gid + 8 * (e >> 1);
              if (row < rows && col < N)
                out[(size_t)row * N + col] = __int_as_float(acc[mt][j][e]);
            }
      break;
    }

    // each row's absmax: its 4 lanes, then every warp through shared
    // memory (non-negative floats order as their bits)
    unsigned* const am = amax + (l & 1) * BM;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float m = rmax[mt][hh];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (tig == 0 && ntw > 0)
          atomicMax(am + mt * 16 + gid + 8 * hh, __float_as_uint(m));
      }
    warps_sync();  // every warp has read hq and posted its maxima

    float s[MT][2], rs[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[mt][hh] = row_scale(__uint_as_float(am[mt * 16 + gid + 8 * hh]));
        rs[mt][hh] = __frcp_rn(s[mt][hh]);
      }
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if (j < ntw)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = (warp + WARPS * j) * N_PAD + 2 * tig;
            const int r = mt * 16 + gid + 8 * hh;
            const unsigned q0 = (unsigned char)quantize(
                __int_as_float(acc[mt][j][2 * hh]), s[mt][hh], rs[mt][hh]);
            const unsigned q1 = (unsigned char)quantize(
                __int_as_float(acc[mt][j][2 * hh + 1]), s[mt][hh],
                rs[mt][hh]);
            *reinterpret_cast<unsigned short*>(hq + r * stride_q + col) =
                (unsigned short)(q0 | (q1 << 8));
          }
    if (warp == 0 && tig == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) hs[mt * 16 + gid + 8 * hh] = s[mt][hh];
    // the other maxima buffer, for the next layer (last read a layer ago)
    for (int i = tid; i < BM; i += WARPS * 32)
      amax[((l + 1) & 1) * BM + i] = 0u;
    warps_sync();  // hq and hs hold the next layer's input
  }
}

// ---------------------------------------------------------- rows path ---

// R = 1, 2, 4 or 8 rows a block: the f32 rows [R, stride_f], their int8
// copy [R, stride_q] and the R row scales in shared memory; a layer first
// quantizes the f32 rows (one warp per row, a warp-shuffle absmax), then
// overwrites them with its outputs, one live column per thread per pass.
template <int R>
__global__ void __launch_bounds__(ROWS_THREADS)
fused_mlp_int8_rows_kernel(const float* __restrict__ x,
                           float* __restrict__ out,
                           const int* __restrict__ qweights,
                           const float* __restrict__ fparams, int rows,
                           int stride_f, int stride_q, LayerTable t) {
  constexpr int RW = ROWS_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const h = reinterpret_cast<float*>(smem);  // [R, stride_f]
  signed char* const hq =
      reinterpret_cast<signed char*>(smem + (size_t)R * stride_f * 4);
  float* const hs = reinterpret_cast<float*>(
      smem + (size_t)R * stride_f * 4 + (size_t)R * stride_q);  // [R]
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // input rows into the f32 buffer; rows past the end are zeros
  const int f0 = t.in_w[0];
  for (int i = tid; i < R * f0; i += ROWS_THREADS) {
    const int r = i / f0, c = i - r * f0;
    const int row = row0 + r;
    h[r * stride_f + c] = row < rows ? x[(size_t)row * f0 + c] : 0.0f;
  }
  __syncthreads();

  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.in_w[l], N = t.out_w[l], act = t.act[l];
    const int KP = round_up(K, K_PAD);
    const bool last = l == t.n_layers - 1;

    // 1. per-row dynamic quantization: f32 rows -> int8 rows + scales
    for (int r = warp; r < R; r += RW) {
      const float* hr = h + r * stride_f;
      float m = 0.0f;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(hr[k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float s = row_scale(m), rs = __frcp_rn(s);
      signed char* qr = hq + r * stride_q;
      for (int k = lane; k < KP; k += 32)
        qr[k] = k < K ? quantize(hr[k], s, rs) : (signed char)0;
      if (lane == 0) hs[r] = s;
    }
    __syncthreads();

    // 2. int8 x int8 -> int32 dot and the dequant epilogue.  Column n's
    //    words of slab kt are 32 contiguous bytes of the pack: word
    //    2*t + r holds k = 32 kt + 4 t + 16 r + 0..3
    const int4* __restrict__ Wq =
        reinterpret_cast<const int4*>(qweights + t.q_off[l]);
    const float* __restrict__ WS = fparams + t.s_off[l];
    const float* __restrict__ B = fparams + t.b_off[l];
    const size_t slab = (size_t)((N + N_PAD - 1) / N_PAD) * 16;  // int4s
    for (int n = tid; n < N; n += ROWS_THREADS) {
      const int4* wc = Wq + (n >> 3) * 16 + (n & 7) * 2;
      int acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
      for (int kt = 0; kt < KP / K_PAD; ++kt) {
        const int4 w0 = __ldg(wc + kt * slab), w1 = __ldg(wc + kt * slab + 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int4* a = reinterpret_cast<const int4*>(hq + r * stride_q +
                                                        K_PAD * kt);
          const int4 a0 = a[0], a1 = a[1];
          int v = acc[r];
          v = __dp4a(a0.x, w0.x, v);
          v = __dp4a(a1.x, w0.y, v);
          v = __dp4a(a0.y, w0.z, v);
          v = __dp4a(a1.y, w0.w, v);
          v = __dp4a(a0.z, w1.x, v);
          v = __dp4a(a1.z, w1.y, v);
          v = __dp4a(a0.w, w1.z, v);
          v = __dp4a(a1.w, w1.w, v);
          acc[r] = v;
        }
      }
      const float ws = __ldg(WS + n);
      const float bias = __ldg(B + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = dequant(acc[r], hs[r], ws, bias,
                                [act](float u) { return activate(u, act); });
        if (last) {
          const int row = row0 + r;
          if (row < rows) out[(size_t)row * N + n] = v;
        } else {
          h[r * stride_f + n] = v;
        }
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------- launch -----

template <int R>
static cudaError_t launch_rows(const float* x, float* out, const int* qw,
                               const float* fp, int rows, int max_width,
                               const LayerTable& t, cudaStream_t stream) {
  const size_t smem = smem_size(0, 0, max_width, R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_rows_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((rows + R - 1) / R);
  fused_mlp_int8_rows_kernel<R><<<grid, ROWS_THREADS, smem, stream>>>(
      x, out, qw, fp, rows, round_up(max_width, 4),
      round_up(max_width, K_PAD), t);
  return cudaGetLastError();
}

template <int MT>
static cudaError_t launch_mma(const float* x, float* out, const int* qw,
                              const float* fp, int rows, int max_in,
                              int max_out, const LayerTable& t,
                              cudaStream_t stream) {
  const int bm = 16 * MT;
  const size_t smem = smem_size(max_in, max_out, 0, bm);
  if (max_out > mma_max_out(bm) || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_mma_kernel<MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((rows + bm - 1) / bm);
  fused_mlp_int8_mma_kernel<MT><<<grid, WARPS * 32, smem, stream>>>(
      x, out, qw, fp, rows, mma_stride_q(max_in), slab_bytes(max_out),
      mma_stages(max_in, max_out, bm), wsb_bytes(max_out), t);
  return cudaGetLastError();
}

extern "C" int fused_mlp_int8_max_layers() { return MAX_LAYERS; }

extern "C" int fused_mlp_int8_k_pad() { return K_PAD; }

// Dynamic shared memory of one block, and the widest layer output of the
// mma path (0 for the rows path: any width).
extern "C" size_t fused_mlp_int8_smem_bytes(int max_in, int max_out,
                                            int max_width, int block_rows) {
  return smem_size(max_in, max_out, max_width, block_rows);
}
extern "C" int fused_mlp_int8_max_out(int block_rows) {
  return block_rows <= 8 ? 0 : mma_max_out(block_rows);
}

// x [rows, in_w[0]] f32, out [rows, out_w[n_layers-1]] f32, qweights (int32
// words, the pack above; 16-byte aligned) and fparams (f32 ws and b) are
// device pointers; table holds TABLE_FIELDS int64 per layer.  block_rows
// 1, 2, 4 or 8 take the rows path, 16, 32 or 64 the mma path.  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int fused_mlp_int8(const void* x, void* out, const void* qweights,
                              const void* fparams, int rows,
                              const long long* table, int n_layers,
                              int block_rows, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qweights) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  LayerTable t;
  t.n_layers = n_layers;
  int max_in = 0, max_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* e = table + (size_t)l * TABLE_FIELDS;
    t.in_w[l] = (int)e[0];
    t.out_w[l] = (int)e[1];
    t.act[l] = (int)e[2];
    t.q_off[l] = e[3];
    t.s_off[l] = e[4];
    t.b_off[l] = e[5];
    if (t.in_w[l] < 1 || t.out_w[l] < 1) return (int)cudaErrorInvalidValue;
    if (t.in_w[l] > max_in) max_in = t.in_w[l];
    if (t.out_w[l] > max_out) max_out = t.out_w[l];
  }
  const int max_width = max_in > max_out ? max_in : max_out;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* qw = static_cast<const int*>(qweights);
  const float* fp = static_cast<const float*>(fparams);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block_rows) {
    case 1: err = launch_rows<1>(xf, of, qw, fp, rows, max_width, t, s); break;
    case 2: err = launch_rows<2>(xf, of, qw, fp, rows, max_width, t, s); break;
    case 4: err = launch_rows<4>(xf, of, qw, fp, rows, max_width, t, s); break;
    case 8: err = launch_rows<8>(xf, of, qw, fp, rows, max_width, t, s); break;
    case 16:
      err = launch_mma<1>(xf, of, qw, fp, rows, max_in, max_out, t, s);
      break;
    case 32:
      err = launch_mma<2>(xf, of, qw, fp, rows, max_in, max_out, t, s);
      break;
    case 64:
      err = launch_mma<4>(xf, of, qw, fp, rows, max_in, max_out, t, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
