// Flash attention (online softmax, GQA, causal on absolute positions) on
// Hopper (sm_90a), f32 math on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention (the Pallas TPU kernel, pallas_call at l.73, _kernel at
// l.23).  For q [B, Sq, H, hd] and k, v [B, Skv, KV, hd] (f32 or bf16,
// H % KV == 0, q head h reading kv head h / (H / KV)) it computes, in f32,
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
// What bounds it on the card: f32 operations (4 * hd per visible
// (query, key) pair; 67 TFLOP/s outside the tensor cores) at the shapes
// of a prefill; a decode window is bound by bytes.  What the design does
// about it: a block owns block_q query rows of one (b, h).  Its q tile,
// pre-scaled, stays in shared memory; K and V stream through shared
// memory one block_kv chunk at a time (the TPU kernel kept the whole K/V
// of a head resident, which 227 KB cannot hold at long Skv).  Each of the
// 8 warps owns block_q / 8 rows for the whole chunk: it forms their
// scores four rows at a time in registers (lane c, c + 32, ... of the
// chunk), does the online-softmax update with warp shuffles, writes p to
// shared memory and accumulates p @ V into registers (lane d, d + 32, ...
// of hd).  Rows never cross warps, so one chunk needs two block barriers.
// K rows are padded by one float so the lanes' reads of one k-column fall
// on distinct banks.  Tensor cores (TF32 would break the 2e-5 tolerance;
// bf16 mma for bf16 inputs), TMA and warp specialisation are later work.
//
// Masking: keys past Skv are never visited (bounds, not zero padding), so
// a row that sees no key at all (kv_valid = 0, or every key in its causal
// future) averages V over the Skv real keys, as the reference's oracle
// does.  Keys wholly masked for every row of the block are skipped at the
// end of the range only when every row of the block sees at least one
// key: then the skipped scores would each have contributed exp(-1e30 - m)
// = 0, so skipping changes no bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_BLOCK_KV 256
#define MAX_CJ (MAX_BLOCK_KV / 32)
#define NEG_INF (-1e30f)

struct Problem {
  int B, Sq, Skv, H, KV, hd;
  int causal, q_offset, kv_valid;
  int bkv;
  int bf16;  // q, k, v and o are bf16 (else f32)
  float scale;
};

__device__ __forceinline__ float load_elem(const void* p, size_t i,
                                           int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory of one block, in floats: q tile, K chunk (rows
// padded by one), V chunk, p tile, and m, l, corr per row;
// flash_attention.py's smem_bytes computes the same.
__host__ __device__ __forceinline__ size_t smem_floats(int bq, int bkv,
                                                       int hd) {
  return (size_t)bq * hd + (size_t)bkv * (hd + 1) + (size_t)bkv * hd +
         (size_t)bq * bkv + 3 * (size_t)bq;
}

// RPW query rows per warp (block_q = 8 * RPW); HDC groups of 32 columns of
// hd per lane (hd <= 32 * HDC).
template <int RPW, int HDC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const void* __restrict__ q,
                       const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ o,
                       Problem p) {
  constexpr int BQ = RPW * WARPS;
  constexpr int RG = RPW < 4 ? RPW : 4;  // rows per score group
  extern __shared__ __align__(16) float smem[];
  const int hd = p.hd, bkv = p.bkv;
  float* const Qs = smem;                            // [BQ, hd]
  float* const Ks = Qs + (size_t)BQ * hd;            // [bkv, hd + 1]
  float* const Vs = Ks + (size_t)bkv * (hd + 1);     // [bkv, hd]
  float* const Ps = Vs + (size_t)bkv * hd;           // [BQ, bkv]
  float* const Ms = Ps + (size_t)BQ * bkv;           // [BQ]
  float* const Ls = Ms + BQ;                         // [BQ]
  float* const Cs = Ls + BQ;                         // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int qi = q0 + r;
    Qs[idx] = qi < p.Sq
                  ? load_elem(q, (((size_t)b * p.Sq + qi) * p.H + h) * hd + d,
                              p.bf16) * p.scale
                  : 0.0f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.0f;
  }

  // the keys this block visits: all Skv unless every row sees a key
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_end = p.Skv;
  if (p.kv_valid > 0 && (!p.causal || p.q_offset + q0 >= 0)) {
    kv_end = min(kv_end, p.kv_valid);
    if (p.causal) kv_end = min(kv_end, p.q_offset + q_last + 1);
  }

  float acc[RPW][HDC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int dg = 0; dg < HDC; ++dg) acc[i][dg] = 0.0f;
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += bkv) {
    const int nc = min(bkv, kv_end - kv0);
    const int cj = (nc + 31) / 32;
    for (int idx = tid; idx < nc * hd; idx += THREADS) {
      const int c = idx / hd, d = idx - c * hd;
      const size_t gi = (((size_t)b * p.Skv + kv0 + c) * p.KV + g) * hd + d;
      Ks[c * (hd + 1) + d] = load_elem(k, gi, p.bf16);
      Vs[c * hd + d] = load_elem(v, gi, p.bf16);
    }
    __syncthreads();

    // scores and the online-softmax update of this warp's rows
    int koff[MAX_CJ];
#pragma unroll
    for (int j = 0; j < MAX_CJ; ++j)
      koff[j] = min(lane + 32 * j, nc - 1) * (hd + 1);
    for (int i0 = 0; i0 < RPW; i0 += RG) {
      float s[RG][MAX_CJ];
#pragma unroll
      for (int ii = 0; ii < RG; ++ii)
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j) s[ii][j] = 0.0f;
      for (int kk = 0; kk < hd; ++kk) {
        float kv[MAX_CJ];
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j)
          if (j < cj) kv[j] = Ks[koff[j] + kk];
#pragma unroll
        for (int ii = 0; ii < RG; ++ii) {
          const float qv = Qs[(warp + WARPS * (i0 + ii)) * hd + kk];
#pragma unroll
          for (int j = 0; j < MAX_CJ; ++j)
            if (j < cj) s[ii][j] = fmaf(qv, kv[j], s[ii][j]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < RG; ++ii) {
        const int r = warp + WARPS * (i0 + ii);
        const int qpos = q0 + r + p.q_offset;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j) {
          const int c = lane + 32 * j;
          if (j < cj && c < nc) {
            const int kp = kv0 + c;
            const bool seen = kp < p.kv_valid && (!p.causal || kp <= qpos);
            s[ii][j] = seen ? s[ii][j] : NEG_INF;
            mx = fmaxf(mx, s[ii][j]);
          }
        }
        mx = warp_max(mx);
        const float m_old = Ms[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j) {
          const int c = lane + 32 * j;
          if (j < cj && c < nc) {
            const float e = expf(s[ii][j] - m_new);
            Ps[r * bkv + c] = e;
            sum += e;
          }
        }
        sum = warp_sum(sum);
        const float corr = expf(m_old - m_new);
        __syncwarp();
        if (lane == 0) {
          Ms[r] = m_new;
          Ls[r] = Ls[r] * corr + sum;
          Cs[r] = corr;
        }
      }
    }
    __syncwarp();

    // acc = acc * corr + p @ V for this warp's rows
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float corr = Cs[warp + WARPS * i];
#pragma unroll
      for (int dg = 0; dg < HDC; ++dg) acc[i][dg] *= corr;
    }
    for (int c = 0; c < nc; ++c) {
      float vv[HDC];
#pragma unroll
      for (int dg = 0; dg < HDC; ++dg) {
        const int d = lane + 32 * dg;
        vv[dg] = d < hd ? Vs[c * hd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pv = Ps[(warp + WARPS * i) * bkv + c];
#pragma unroll
        for (int dg = 0; dg < HDC; ++dg)
          acc[i][dg] = fmaf(pv, vv[dg], acc[i][dg]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    const int qi = q0 + r;
    if (qi >= p.Sq) continue;
    const float l = fmaxf(Ls[r], 1e-30f);
#pragma unroll
    for (int dg = 0; dg < HDC; ++dg) {
      const int d = lane + 32 * dg;
      if (d >= hd) continue;
      const float val = acc[i][dg] / l;
      const size_t oi = (((size_t)b * p.Sq + qi) * p.H + h) * hd + d;
      if (p.bf16)
        reinterpret_cast<__nv_bfloat16*>(o)[oi] = __float2bfloat16_rn(val);
      else
        reinterpret_cast<float*>(o)[oi] = val;
    }
  }
}

template <int RPW, int HDC>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, const Problem& p, cudaStream_t stream) {
  const size_t smem = smem_floats(RPW * WARPS, p.bkv, p.hd) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<RPW, HDC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + RPW * WARPS - 1) / (RPW * WARPS)),
                  (unsigned)p.H, (unsigned)p.B);
  flash_attention_kernel<RPW, HDC><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, p);
  return cudaGetLastError();
}

template <int HDC>
static cudaError_t launch_rows(int block_q, const void* q, const void* k,
                               const void* v, void* o, const Problem& p,
                               cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<2, HDC>(q, k, v, o, p, s);
    case 32: return launch<4, HDC>(q, k, v, o, p, s);
    case 64: return launch<8, HDC>(q, k, v, o, p, s);
    case 128: return launch<16, HDC>(q, k, v, o, p, s);
    case 256:
      // 32 rows x 4 column groups would be 128 accumulators a thread
      if constexpr (HDC <= 2) return launch<32, HDC>(q, k, v, o, p, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

extern "C" size_t flash_attention_smem_bytes(int block_q, int block_kv,
                                             int hd) {
  return smem_floats(block_q, block_kv, hd) * sizeof(float);
}

// q [B, Sq, H, hd], k and v [B, Skv, KV, hd] and o [B, Sq, H, hd] are
// contiguous device pointers of f32 (bf16 = 0) or bf16 (bf16 = 1).
// kv_valid is already clamped to [0, Skv].  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int KV, int hd, int causal, int q_offset,
                               int kv_valid, int bf16, float scale,
                               int block_q, int block_kv, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > 128 || block_kv < 1 || block_kv > MAX_BLOCK_KV)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.causal = causal; p.q_offset = q_offset; p.kv_valid = kv_valid;
  p.bkv = block_kv; p.bf16 = bf16; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return (int)launch_rows<1>(block_q, q, k, v, o, p, s);
  if (hd <= 64) return (int)launch_rows<2>(block_q, q, k, v, o, p, s);
  return (int)launch_rows<4>(block_q, q, k, v, o, p, s);
}
