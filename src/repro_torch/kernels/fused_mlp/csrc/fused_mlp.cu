// Fused MLP inference on Hopper (sm_90a), f32-accurate products on the
// tensor cores.
//
// Replaces: src/repro/kernels/fused_mlp/fused_mlp.py::fused_mlp (the Pallas
// TPU kernel, pallas_call at l.87, _kernel at l.33).  It computes
// h = act_l(h @ W_l + b_l) chained over every layer of a dense surrogate.
//
// What carries over from the TPU kernel: intermediate activations never go
// to device memory.  Each block owns BM rows (16 or 32) and keeps their
// activations in one [BM, hs] f32 buffer in shared memory; only the input
// rows are read from and the last layer's rows written to device memory.
// What does not carry over: the TPU premise that the whole net sits in
// VMEM.  Weights stay in device memory (L2-resident: a minibude net is
// 8.35 MB against a 50 MB L2) and stream through shared memory.
//
// Bound on the card: at serving batches the work is 2 * B * sum(in * out)
// operations.  On the CUDA cores in f32 (67 TFLOP/s) the widest minibude
// net at 65,536 rows cannot go under 4.08 ms; this kernel runs the
// products on the tensor cores in 3xTF32 (../../csrc/tf32x3.cuh: three
// TF32 mma per product, f32 accuracy), whose floor is 3x the operations
// at 495 TFLOP/s, 1.66 ms there.  The other limit is L2: every block
// reads the whole net once, 8.79 MB in the kernel layout per BM rows.
//
// What the design does about it (block_rows 16 and 32, layers up to
// 1,024 wide; block_rows 1-8 take any width, see the end):
// - Per layer, each of the 8 warps owns the n8 output tiles w,
//   w + 8, ... of the layer's live columns (no idle column slots; at most
//   16 tiles, so layers up to 1,024 wide) for all BM rows, their
//   accumulators in registers.  A K-step takes the A fragments
//   (activations, split into TF32 hi and lo once) from the activation
//   buffer and the B fragments (weights, split once per tile and shared
//   by the BM / 16 row tiles) from a ring of three K-tiles of 8 weight
//   rows.  Each K-step's three products of a tile go into a partial
//   that is then added to the accumulator (see mma_tiles: the tensor
//   cores' accumulation truncates), 8 partials in flight.
// - The ring is kept full through the Tensor Memory Accelerator, across
//   layer boundaries: once all 8 mma warps have released a stage on its
//   "empty" mbarrier, one thread (of a ninth warp, or thread 0: see
//   producer_warp) asks for the next tile in one contiguous copy
//   (cp.async.bulk, completion counted on the stage's "full" mbarrier).
//   For that the packer lays each layer's weights out for the kernel
//   (w_off in the table): [K rounded up to 8, N rounded up to 32 + 8]
//   with zeros past K and N, every row 32-byte aligned; the padding of 8
//   words puts a warp's fragment loads on 32 distinct banks.  So no warp spends instructions on addresses, copies
//   or masks, and no block barrier stops the warps between K-steps: each
//   waits only for its data, and the mma pipes do not drain (two
//   barriers a layer, around the epilogue).
// - With the accumulators in registers the layer's output goes back into
//   the same activation buffer (rows padded by 4 words) after a barrier
//   (no ping-pong pair), so BM reaches 32 within 227 KB: each weight tile
//   that leaves L2 feeds 32 rows, 18.0 GB of L2 reads per 65,536-row call
//   of the minibude net (36.0 GB at 16 rows).
// - A batch of few row blocks would leave most SMs idle (256 rows are 16
//   blocks of 16), so the launcher picks the largest cluster of C = 8, 4
//   or 2 blocks whose clusters all fit on the card at once: the C blocks
//   of a cluster share BM rows, each computes a C-th of every layer's
//   columns from its share of the weights (one copy per weight row) and
//   stores them into all C activation buffers (distributed shared
//   memory).  Two mbarriers, used in turn, that every warp of the
//   cluster arrives on order the layers.  C = 1 once the row blocks fill
//   the card.
// - K (the first layer's 6) pads to the k-step with zeros in both
//   operands; N (the last layer's 1) pads to the n8 tile and the padding
//   columns are written as zeros.
// - block_rows 1, 2, 4 and 8 keep the domain of the f32 kernel this one
//   replaced: layers of any width whose two [block_rows, widest] buffers
//   fit a block (one row up to 29,056 wide).  Those R rows are the first
//   of each m16 fragment (the other rows are zeros in registers); the
//   activations go back and forth between two buffers, each layer's
//   columns in passes of up to 1,024 (the register accumulators), and
//   the B fragments come straight from L2, unmasked thanks to the
//   layout's zero padding: at the widest no shared memory is left for a
//   ring beside the two buffers.  The same products in the same order
//   as above, so the rows' bits do not depend on the path.
//
// Numerics: each output starts from 0.0f and takes, K-step by K-step in
// ascending k, the f32 partial of that step's three 3xTF32 mma (see
// mma_tiles), added rounded to nearest; then the bias is added and the
// activation applied.  K is never split and a row's arithmetic does not depend on the
// other rows of its block (an mma's outputs are per row and column), so a
// row's output is bit-identical whatever the batch size or the block_rows
// the wrapper picks.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/tf32x3.cuh"

#define MAX_LAYERS 16
#define WARPS 8                       // warps that run the mma
#define KT 8                          // weight rows per K-tile: one k-step
#define STAGES 3                      // K-tiles in the ring
#define MAX_WIDTH 1024                // widest layer output
#define MAX_NTW (MAX_WIDTH / 8 / WARPS)  // n8 tiles a warp owns at most
#define META_BYTES 1024               // the stages' mbarriers, the table
#define TABLE_FIELDS 5  // per layer: in, out, act, w_off, b_off

struct LayerTable {
  int n_layers;
  int in_w[MAX_LAYERS];
  int out_w[MAX_LAYERS];
  int act[MAX_LAYERS];
  long long w_off[MAX_LAYERS];  // [K rounded to 8, w_stride(N)], padded
  long long b_off[MAX_LAYERS];
};
static_assert(sizeof(LayerTable) + 16 * STAGES + 16 <= META_BYTES, "meta");

// The barrier of the 8 mma warps (a producer warp never joins it).
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
}

// Who asks the TMA for the weights: a ninth warp of its own, so that no
// mma warp ever waits for the others; or thread 0 of the 8 warps, which
// waits for every warp to release a tile before refilling its stage.  A
// ninth warp caps the registers at 168 a thread (three warps then share
// one scheduler's 16K), which 32 single-block rows exceed (they spill
// and run slower): those take thread 0.  At 16 rows and in clusters the
// ninth warp is ahead.
template <int BM, int C>
__host__ __device__ constexpr bool producer_warp() {
  return !(BM == 32 && C == 1);
}
template <int BM, int C>
__host__ __device__ constexpr int threads() {
  return (WARPS + producer_warp<BM, C>()) * 32;
}

// act codes: 0 identity, 1 relu, 2 gelu (tanh approximation), 3 tanh,
// 4 silu, 5 sigmoid -- the same table as fused_mlp.py's ACT_CODES.
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

// The Tensor Memory Accelerator's one-dimensional copy (cp.async.bulk):
// one thread asks for `bytes` (a multiple of 16, both addresses 16-byte
// aligned) and the copy reports them to an mbarrier in shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
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
// The same barrier in CTA `rank` of the cluster, arrived on with release
// at cluster scope; and a wait that acquires at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// v into the same float of CTA `rank`'s shared memory.
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(remote), "f"(v) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Row strides (floats) of the activation buffer and of a weight stage
// (and of a layer's weights in device memory), and the dynamic shared
// memory of one block; fused_mlp.py's smem_bytes computes the same.
// block_rows up to 8 take two buffers with rows of the widest layer
// rounded up to the k-step.
__host__ __device__ inline int act_stride(int max_width) {
  return (max_width + 31) / 32 * 32 + 4;
}
__host__ __device__ inline int rows_stride(int max_width) {
  return (max_width + 7) / 8 * 8;
}
__host__ __device__ inline int w_stride(int n) {
  return (n + 31) / 32 * 32 + 8;
}
__host__ __device__ inline size_t smem_size(int max_width, int max_out,
                                            int bm) {
  if (bm <= 8) return sizeof(float) * 2 * (size_t)bm * rows_stride(max_width);
  return sizeof(float) * ((size_t)bm * act_stride(max_width) +
                          (size_t)STAGES * KT * w_stride(max_out)) +
         META_BYTES;
}

// This warp's n8 tiles J0 .. J0 + NB - 1 of one K-step: their weights
// split into TF32 hi and lo.  A tile past the warp's last (j >= ntw)
// repeats the last one, into an accumulator that is never stored.
template <int J0, int NB>
__device__ __forceinline__ void load_tiles(BFrags<8>& bf, const float* wb0,
                                           const float* wb1, int ntw,
                                           int warp) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int n0 = (warp + WARPS * min(J0 + i, ntw - 1)) * 8;
    bf.split(i, wb0[n0], wb1[n0]);
  }
}

// The 3xTF32 products of tiles J0 .. J0 + NB - 1 for the MT row tiles,
// added to their accumulators.  The tensor cores' f32 accumulation
// truncates (it aligns the terms to the largest, keeps 3 bits past f32's
// 24 and rounds the sum toward zero: chip_smoke.py's numerics probe), so
// an accumulator that took every mma of a long sum would drift toward
// zero by about half an ulp per mma (7e-4 of the value at K 29,056).  So
// each tile's three products of this K-step go into a partial that
// starts at zero (lo.hi, hi.lo, hi.hi, in that order), and the partial is
// added to the accumulator on the CUDA cores, rounded to nearest: the
// truncation then acts on the K-step's small partial only.  The mma run
// pass by pass over G tiles x MT row tiles at a time, so that
// consecutive mma never share a partial (an mma.sync takes tens of
// cycles to come back), with G x MT <= 8 partials in registers.
template <int MT, int J0, int NB>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][MAX_NTW][4],
                                          const uint32_t (&a_hi)[MT][4],
                                          const uint32_t (&a_lo)[MT][4],
                                          const BFrags<8>& bf) {
  constexpr int G = 8 / MT;
#pragma unroll
  for (int g0 = 0; g0 < NB; g0 += G) {
    float part[G][MT][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (g0 + i < NB)
          mma_tf32_zero(part[i][mt], a_lo[mt], bf.hi[g0 + i][0],
                        bf.hi[g0 + i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (g0 + i < NB)
          mma_tf32(part[i][mt], a_hi[mt], bf.lo[g0 + i][0],
                   bf.lo[g0 + i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (g0 + i < NB)
          mma_tf32(part[i][mt], a_hi[mt], bf.hi[g0 + i][0],
                   bf.hi[g0 + i][1]);
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g0 + i < NB) acc[mt][J0 + g0 + i][e] += part[i][mt][e];
  }
}

// One K-step of a warp's ntw tiles: up to eight at a time, in pairs (an
// odd count recomputes its last tile once); `release()` runs once the
// step's last weights are in registers.
template <int MT, typename Release>
__device__ __forceinline__ void k_step(float (&acc)[MT][MAX_NTW][4],
                                       const uint32_t (&a_hi)[MT][4],
                                       const uint32_t (&a_lo)[MT][4],
                                       const float* wb0, const float* wb1,
                                       int ntw, int warp, Release&& release) {
  BFrags<8> bf;
#define LOAD(J0, NB) load_tiles<J0, NB>(bf, wb0, wb1, ntw, warp)
#define MMA(J0, NB) mma_tiles<MT, J0, NB>(acc, a_hi, a_lo, bf)
  switch ((ntw + 1) >> 1) {  // pairs of tiles, uniform per layer and warp
    case 1: LOAD(0, 2); release(); MMA(0, 2); break;
    case 2: LOAD(0, 4); release(); MMA(0, 4); break;
    case 3: LOAD(0, 6); release(); MMA(0, 6); break;
    case 4: LOAD(0, 8); release(); MMA(0, 8); break;
    case 5: LOAD(0, 8); MMA(0, 8); LOAD(8, 2); release(); MMA(8, 2); break;
    case 6: LOAD(0, 8); MMA(0, 8); LOAD(8, 4); release(); MMA(8, 4); break;
    case 7: LOAD(0, 8); MMA(0, 8); LOAD(8, 6); release(); MMA(8, 6); break;
    case 8: LOAD(0, 8); MMA(0, 8); LOAD(8, 8); release(); MMA(8, 8); break;
    default: release(); break;
  }
#undef LOAD
#undef MMA
}

// The bias and activation of a finished output; padding columns are 0.
__device__ __forceinline__ float epilogue(float acc, const float* bias,
                                          int col, int N, int act) {
  const float bcol = col < N ? __ldg(bias + col) : 0.0f;
  return col < N ? activate(acc + bcol, act) : 0.0f;
}

// The n8 tiles [t0, t0 + ntr) of an N-wide layer that CTA `rank` of a
// cluster of C computes: C contiguous shares.
template <int C>
__device__ __forceinline__ void share(int N, int rank, int& t0, int& ntr) {
  const int nt = (N + 7) >> 3, per = (nt + C - 1) / C;
  t0 = min(nt, rank * per);
  ntr = min(nt, t0 + per) - t0;
}

// BM rows a block; C > 1: a cluster of C blocks shares those rows, each
// computing a C-th of every layer's columns and storing them into all C
// activation buffers (distributed shared memory), so that a small batch
// still spreads over the card.
template <int BM, int C>
__global__ void __launch_bounds__(threads<BM, C>(), 1)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ params, int rows, int hs, int ws,
                 LayerTable table) {
  constexpr int MT = BM / 16;  // m16 row tiles
  extern __shared__ __align__(16) float smem[];
  float* const Hs = smem;                       // [BM, hs] activations
  float* const Ws = smem + (size_t)BM * hs;     // STAGES x [KT, ws]
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(Ws + (size_t)STAGES * KT * ws);
  uint64_t* const empty = full + STAGES;
  uint64_t* const layer_bar = empty + STAGES;  // C > 1: two, in turn
  LayerTable* const t = reinterpret_cast<LayerTable*>(layer_bar + 2);
  const int rank = (int)(blockIdx.x % C), row0 = (int)(blockIdx.x / C) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  if (tid == 0) {
    *t = table;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);       // thread 0's arrival + the bytes
      mbar_init(empty + s, WARPS);  // one arrival per warp
    }
    mbar_init(layer_bar, C * WARPS);  // every warp of the cluster
    mbar_init(layer_bar + 1, C * WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the table and the barriers are ready
  if constexpr (C > 1)  // ... in every block of the cluster
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // The producer walks the weight tiles of every layer in order and asks
  // the TMA for tile `seq` into stage seq % STAGES once every mma warp
  // has released the tile before it there.  With C = 1 a tile is 8 rows
  // of the layer's kernel-layout block, one contiguous copy; with C > 1
  // each row's share of this block's columns.
  int ld_l = 0, ld_k = 0, ld_seq = 0;
  auto issue = [&]() {
    if (ld_l >= t->n_layers) return;
    const int stage = ld_seq % STAGES, wsl = w_stride(t->out_w[ld_l]);
    float* const dst = Ws + (size_t)stage * KT * ws;
    const float* const src = params + t->w_off[ld_l] + (size_t)ld_k * wsl;
    if (ld_seq >= STAGES)
      mbar_wait(empty + stage, (ld_seq / STAGES - 1) & 1);
    if constexpr (C == 1) {
      mbar_expect_tx(full + stage, KT * wsl * sizeof(float));
      bulk_copy(dst, src, KT * wsl * sizeof(float), full + stage);
    } else {
      int t0, ntr;
      share<C>(t->out_w[ld_l], rank, t0, ntr);
      const int wc = 8 * ntr, wsc = w_stride(wc);
      mbar_expect_tx(full + stage, KT * wc * sizeof(float));
      if (wc > 0)
        for (int r = 0; r < KT; ++r)
          bulk_copy(dst + r * wsc, src + (size_t)r * wsl + 8 * t0,
                    wc * sizeof(float), full + stage);
    }
    ld_k += KT;
    if (ld_k >= t->in_w[ld_l]) {
      ld_k = 0;
      ++ld_l;
    }
    ++ld_seq;
  };
  if constexpr (producer_warp<BM, C>()) {
    if (warp == WARPS) {  // the ninth warp: every tile, then done
      if (lane == 0)
        while (ld_l < t->n_layers) issue();
      return;
    }
  } else if (tid == 0) {  // thread 0: the first STAGES tiles, then one a
    for (int s = 0; s < STAGES; ++s) issue();  // K-step (below)
  }

  // input rows into the buffer; rows past the end and the k-step padding
  // columns are zeros
  {
    const int f0 = t->in_w[0], f8 = (f0 + 7) & ~7;
    for (int i = tid; i < BM * f8; i += WARPS * 32) {
      const int r = i / f8, c = i - r * f8;
      const int row = row0 + r;
      Hs[r * hs + c] =
          row < rows && c < f0 ? x[(size_t)row * f0 + c] : 0.0f;
    }
  }
  mma_warps_sync();

  // C > 1: every warp of the cluster meets here, its stores to the other
  // blocks' buffers released before it arrives.  Sync n waits on barrier
  // n % 2: one barrier for all would let a warp that passed sync n in its
  // own block arrive for sync n + 1 in a block where a slow warp has not
  // yet arrived for sync n, completing that phase without it.  With two,
  // a warp arrives for sync n + 2 only after sync n + 1 completed in its
  // block, which needs every warp's arrivals for sync n, in every block,
  // issued before.
  int n_sync = 0;
  auto layer_sync = [&]() {
    if constexpr (C == 1) {
      mma_warps_sync();
    } else {
      uint64_t* const bar = layer_bar + (n_sync & 1);
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      __syncwarp();
      if (lane == 0)
        for (int q = 0; q < C; ++q) mbar_arrive_cluster(bar, q);
      mbar_wait_cluster(bar, (n_sync >> 1) & 1);
      ++n_sync;
    }
  };

  int seq = 0;  // the weight tile being consumed
  for (int l = 0; l < t->n_layers; ++l) {
    const int K = t->in_w[l], N = t->out_w[l], act = t->act[l];
    int t0, ntr;
    share<C>(N, rank, t0, ntr);
    const int ntw = ntr > warp ? (ntr - warp + WARPS - 1) / WARPS : 0;

    float acc[MT][MAX_NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

    const int wsl = C == 1 ? w_stride(N) : w_stride(8 * ntr);
    for (int k0 = 0; k0 < K; k0 += KT, ++seq) {
      const int stage = seq % STAGES;
      mbar_wait(full + stage, (seq / STAGES) & 1);
      // weight rows k0 + tig and k0 + tig + 4 of the stage, column gid
      const float* const wb0 = Ws + (size_t)stage * KT * ws + tig * wsl + gid;
      const float* const wb1 = wb0 + 4 * wsl;

      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ha = Hs + (mt * 16 + gid) * hs + k0 + tig;
        tf32_split(ha[0], a_hi[mt][0], a_lo[mt][0]);
        tf32_split(ha[8 * hs], a_hi[mt][1], a_lo[mt][1]);
        tf32_split(ha[4], a_hi[mt][2], a_lo[mt][2]);
        tf32_split(ha[8 * hs + 4], a_hi[mt][3], a_lo[mt][3]);
      }
      // the stage goes back to the producer once the step's last weights
      // are in registers
      k_step<MT>(acc, a_hi, a_lo, wb0, wb1, ntw, warp, [&]() {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
      });
      if constexpr (!producer_warp<BM, C>()) {
        // the tile that goes where this one was, once every warp is done
        // with it (this warp's mma are already on their way)
        if (tid == 0) issue();
        __syncwarp();
      }
    }
    layer_sync();  // every warp is done reading this layer's input

    const bool last = l == t->n_layers - 1;
    const float* const bias = params + t->b_off[l];
#pragma unroll
    for (int j = 0; j < MAX_NTW; ++j) {
      if (j < ntw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (t0 + warp + WARPS * j) * 8 + 2 * tig + (e & 1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = mt * 16 + gid + (e >> 1) * 8;
            const float v = epilogue(acc[mt][j][e], bias, col, N, act);
            if (last) {
              const int row = row0 + r;
              if (row < rows && col < N) out[(size_t)row * N + col] = v;
            } else if constexpr (C == 1) {
              Hs[r * hs + col] = v;
            } else {
              for (int q = 0; q < C; ++q) st_cluster(Hs + r * hs + col, q, v);
            }
          }
        }
      }
    }
    if (!last) layer_sync();  // the layer's output is the next one's input
  }
}

// R = 1, 2, 4 or 8 rows a block, layers of any width that two [R, hs]
// buffers hold: the rows are fragment rows 0 .. R - 1 (rows 8 - 15 are
// never live), each layer's columns run in passes of up to 8 x MAX_NTW
// n8 tiles, and the weights' B fragments are read from L2.
template <int R>
__global__ void __launch_bounds__(WARPS * 32)
fused_mlp_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ params, int rows, int hs,
                      LayerTable t) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = (int)blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool live = gid < R;  // this lane's fragment row holds a row

  {  // input rows into buffer 0, the k-step padding columns zeros
    const int f0 = t.in_w[0], f8 = (f0 + 7) & ~7;
    for (int i = tid; i < R * f8; i += WARPS * 32) {
      const int r = i / f8, c = i - r * f8;
      const int row = row0 + r;
      smem[r * hs + c] =
          row < rows && c < f0 ? x[(size_t)row * f0 + c] : 0.0f;
    }
  }
  __syncthreads();

  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.in_w[l], N = t.out_w[l], act = t.act[l];
    const int wsl = w_stride(N), nt = (N + 7) >> 3;
    const float* const hin = smem + (l & 1) * R * hs;
    float* const hout = smem + ((l + 1) & 1) * R * hs;
    const float* const w = params + t.w_off[l];
    const float* const bias = params + t.b_off[l];
    const bool last = l == t.n_layers - 1;
    for (int p0 = 0; p0 < nt; p0 += WARPS * MAX_NTW) {  // column passes
      const int ntr = min(nt - p0, WARPS * MAX_NTW);
      const int ntw = ntr > warp ? (ntr - warp + WARPS - 1) / WARPS : 0;
      float acc[1][MAX_NTW][4];
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;

      for (int k0 = 0; k0 < K; k0 += KT) {
        uint32_t a_hi[1][4] = {}, a_lo[1][4] = {};
        if (live) {
          const float* const ha = hin + gid * hs + k0 + tig;
          tf32_split(ha[0], a_hi[0][0], a_lo[0][0]);
          tf32_split(ha[4], a_hi[0][2], a_lo[0][2]);
        }
        // weight rows k0 + tig and k0 + tig + 4, column gid of the pass
        const float* const wb0 = w + (size_t)(k0 + tig) * wsl + 8 * p0 + gid;
        k_step<1>(acc, a_hi, a_lo, wb0, wb0 + 4 * wsl, ntw, warp, []() {});
      }

      if (live) {
        const int row = row0 + gid;
#pragma unroll
        for (int j = 0; j < MAX_NTW; ++j) {
          if (j < ntw) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = (p0 + warp + WARPS * j) * 8 + 2 * tig + e;
              const float v = epilogue(acc[0][j][e], bias, col, N, act);
              if (!last)
                hout[gid * hs + col] = v;
              else if (row < rows && col < N)
                out[(size_t)row * N + col] = v;
            }
          }
        }
      }
    }
    __syncthreads();  // the layer's output is the next one's input
  }
}

template <int R>
static cudaError_t launch_rows(const float* x, float* out,
                               const float* params, int rows, int max_width,
                               const LayerTable& t, cudaStream_t stream) {
  const size_t smem = smem_size(max_width, 0, R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((rows + R - 1) / R);
  fused_mlp_rows_kernel<R><<<grid, WARPS * 32, smem, stream>>>(
      x, out, params, rows, rows_stride(max_width), t);
  return cudaGetLastError();
}

// Launch with clusters of C blocks; with `one_wave`, only if every
// cluster of the grid can be resident at once (else cudaErrorNotReady,
// nothing launched).
template <int BM, int C>
static cudaError_t launch_c(const float* x, float* out, const float* params,
                            int rows, int max_width, int max_out,
                            const LayerTable& t, cudaStream_t stream,
                            bool one_wave) {
  const size_t smem = smem_size(max_width, max_out, BM);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<BM, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int clusters = (rows + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(threads<BM, C>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  if (one_wave) {
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, fused_mlp_kernel<BM, C>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (resident < clusters) return cudaErrorNotReady;
  }
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel<BM, C>, x, out, params,
                           rows, act_stride(max_width), w_stride(max_out), t);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster size: the largest of 8, 4 and 2 whose clusters, one per
// BM rows, are all resident at once, so that a batch of a few row blocks
// still spreads over the card; else 1 (the row blocks fill the card).
// The rows' bits do not depend on C.
template <int BM>
static cudaError_t launch(const float* x, float* out, const float* params,
                          int rows, int max_width, int max_out,
                          const LayerTable& t, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + BM - 1) / BM;
  err = cudaErrorNotReady;
  if (blocks * 8 <= sms)
    err = launch_c<BM, 8>(x, out, params, rows, max_width, max_out, t,
                          stream, true);
  if (err == cudaErrorNotReady && blocks * 4 <= sms)
    err = launch_c<BM, 4>(x, out, params, rows, max_width, max_out, t,
                          stream, true);
  if (err == cudaErrorNotReady && blocks * 2 <= sms)
    err = launch_c<BM, 2>(x, out, params, rows, max_width, max_out, t,
                          stream, true);
  if (err == cudaErrorNotReady)
    err = launch_c<BM, 1>(x, out, params, rows, max_width, max_out, t,
                          stream, false);
  return err;
}

extern "C" int fused_mlp_max_layers() { return MAX_LAYERS; }

extern "C" size_t fused_mlp_smem_bytes(int max_width, int max_out,
                                       int block_rows) {
  return smem_size(max_width, max_out, block_rows);
}

// x [rows, in_w[0]], out [rows, out_w[n_layers-1]] and params are device
// pointers; table holds TABLE_FIELDS int64 per layer.  block_rows is 1, 2,
// 4 or 8 (any width), or 16 or 32 (every layer's output at most
// MAX_WIDTH wide).  Returns a cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int fused_mlp_f32(const void* x, void* out, const void* params,
                             int rows, const long long* table, int n_layers,
                             int block_rows, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || rows < 1)
    return (int)cudaErrorInvalidValue;
  // the TMA copies 16-byte aligned blocks (w_off is a multiple of 8)
  if (reinterpret_cast<uintptr_t>(params) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  LayerTable t;
  t.n_layers = n_layers;
  int max_width = 0, max_out = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* e = table + (size_t)l * TABLE_FIELDS;
    t.in_w[l] = (int)e[0];
    t.out_w[l] = (int)e[1];
    t.act[l] = (int)e[2];
    t.w_off[l] = e[3];
    t.b_off[l] = e[4];
    if (t.in_w[l] < 1 || t.out_w[l] < 1 ||
        (block_rows > 8 && t.out_w[l] > MAX_WIDTH))
      return (int)cudaErrorInvalidValue;
    if (t.in_w[l] > max_width) max_width = t.in_w[l];
    if (t.out_w[l] > max_width) max_width = t.out_w[l];
    if (t.out_w[l] > max_out) max_out = t.out_w[l];
  }
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const float* pf = static_cast<const float*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 1:
      return (int)launch_rows<1>(xf, of, pf, rows, max_width, t, s);
    case 2:
      return (int)launch_rows<2>(xf, of, pf, rows, max_width, t, s);
    case 4:
      return (int)launch_rows<4>(xf, of, pf, rows, max_width, t, s);
    case 8:
      return (int)launch_rows<8>(xf, of, pf, rows, max_width, t, s);
    case 16:
      return (int)launch<16>(xf, of, pf, rows, max_width, max_out, t, s);
    case 32:
      return (int)launch<32>(xf, of, pf, rows, max_width, max_out, t, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
