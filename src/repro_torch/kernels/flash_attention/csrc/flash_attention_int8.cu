// Flash attention over an int8 KV cache on Hopper (sm_90a): an int8 score
// dot with __dp4a, f32 softmax and an f32 p @ V.
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
//   s[c]   = -1e30 where causal and c > i + q_offset
//   o      = sum_c softmax(s)[c] * (vq[c] * vs)             f32
//
// the softmax formed online over block_kv chunks, as in flash_attention.cu,
// whose skeleton this is.
//
// What bounds it on the card: bytes, in the decode regime this variant
// exists for (a short q block against a long cache: K and V cross device
// memory as int8, a quarter of f32).  What the design does about it: the
// K chunk is read as int32 words of four int8 values, one __dp4a each;
// V is dequantized once per chunk into shared memory, so it travels as
// int8 and the p @ V runs in f32 without coupling to the chunking.  The
// q rows are quantized once per block, one warp per row with a shuffle
// absmax, into int32 words in shared memory.
//
// Numerics: the quantization and the score dequant are written with
// __fdiv_rn, __float2int_rn (round half to even), __fmul_rn and
// __int2float_rn, so nvcc neither approximates the division nor contracts
// the dequant: the scores equal the plain version's (int8.py::
// flash_attention_int8_ref) bit for bit, and only the softmax's sums
// differ in their order.

#include <cuda_runtime.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_BLOCK_KV 256
#define MAX_CJ (MAX_BLOCK_KV / 32)
#define NEG_INF (-1e30f)
#define QMAX 127.0f

struct Problem {
  int B, Sq, Skv, H, KV, hd;
  int causal, q_offset;
  int bkv;
  float scale;
};

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

// Dynamic shared memory of one block, in 4-byte words: the int8 q rows as
// words and their scales, the K chunk as words (rows padded by one) and
// its token scales, the dequantized V chunk, the p tile and m, l, corr per
// row; int8.py's smem_bytes computes the same.
__host__ __device__ __forceinline__ size_t smem_words(int bq, int bkv,
                                                      int hd) {
  const size_t hd4 = hd / 4;
  return (size_t)bq * hd4 + bq + (size_t)bkv * (hd4 + 1) + bkv +
         (size_t)bkv * hd + (size_t)bq * bkv + 3 * (size_t)bq;
}

template <int RPW, int HDC>
__global__ void __launch_bounds__(THREADS)
flash_attention_int8_kernel(const float* __restrict__ q,
                            const int* __restrict__ kq,
                            const float* __restrict__ ks,
                            const signed char* __restrict__ vq,
                            const float* __restrict__ vs,
                            float* __restrict__ o, Problem p) {
  constexpr int BQ = RPW * WARPS;
  constexpr int RG = RPW < 4 ? RPW : 4;
  extern __shared__ __align__(16) int smem_i[];
  const int hd = p.hd, hd4 = p.hd / 4, bkv = p.bkv;
  int* const Qw = smem_i;                                         // [BQ, hd4]
  float* const QSs = reinterpret_cast<float*>(Qw + (size_t)BQ * hd4);  // [BQ]
  int* const Kw = reinterpret_cast<int*>(QSs + BQ);         // [bkv, hd4 + 1]
  float* const KSs = reinterpret_cast<float*>(Kw + (size_t)bkv * (hd4 + 1));
  float* const Vs = KSs + bkv;                                    // [bkv, hd]
  float* const Ps = Vs + (size_t)bkv * hd;                        // [BQ, bkv]
  float* const Ms = Ps + (size_t)BQ * bkv;
  float* const Ls = Ms + BQ;
  float* const Cs = Ls + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // quantize this warp's q rows: rows past Sq are zeros (scale 1/127)
  signed char* const Qb = reinterpret_cast<signed char*>(Qw);
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    const int qi = q0 + r;
    float qv[HDC];
    float m = 0.0f;
#pragma unroll
    for (int dg = 0; dg < HDC; ++dg) {
      const int d = lane + 32 * dg;
      qv[dg] = (qi < p.Sq && d < hd)
                   ? q[(((size_t)b * p.Sq + qi) * p.H + h) * hd + d]
                   : 0.0f;
      m = fmaxf(m, fabsf(qv[dg]));
    }
    m = warp_max(m);
    const float qs = __fdiv_rn(m > 0.0f ? m : 1.0f, QMAX);
#pragma unroll
    for (int dg = 0; dg < HDC; ++dg) {
      const int d = lane + 32 * dg;
      if (d < hd)
        Qb[(size_t)r * hd + d] =
            (signed char)__float2int_rn(__fdiv_rn(qv[dg], qs));
    }
    if (lane == 0) {
      QSs[r] = __fmul_rn(qs, p.scale);
      Ms[r] = NEG_INF;
      Ls[r] = 0.0f;
    }
  }

  // causal keys past the block's last row are skipped: every row sees key
  // 0 when q_offset + q0 >= 0, so they would each add exp(-1e30 - m) = 0
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_end = p.Skv;
  if (p.causal && p.q_offset + q0 >= 0)
    kv_end = min(kv_end, p.q_offset + q_last + 1);

  float acc[RPW][HDC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int dg = 0; dg < HDC; ++dg) acc[i][dg] = 0.0f;
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += bkv) {
    const int nc = min(bkv, kv_end - kv0);
    const int cj = (nc + 31) / 32;
    for (int idx = tid; idx < nc * hd4; idx += THREADS) {
      const int c = idx / hd4, w = idx - c * hd4;
      Kw[c * (hd4 + 1) + w] =
          kq[(((size_t)b * p.Skv + kv0 + c) * p.KV + g) * hd4 + w];
    }
    for (int c = tid; c < nc; c += THREADS)
      KSs[c] = ks[((size_t)b * p.Skv + kv0 + c) * p.KV + g];
    const float* const vsg = vs + ((size_t)b * p.KV + g) * hd;
    for (int idx = tid; idx < nc * hd; idx += THREADS) {
      const int c = idx / hd, d = idx - c * hd;
      Vs[idx] = __fmul_rn(
          (float)vq[(((size_t)b * p.Skv + kv0 + c) * p.KV + g) * hd + d],
          vsg[d]);
    }
    __syncthreads();

    int koff[MAX_CJ];
#pragma unroll
    for (int j = 0; j < MAX_CJ; ++j)
      koff[j] = min(lane + 32 * j, nc - 1) * (hd4 + 1);
    for (int i0 = 0; i0 < RPW; i0 += RG) {
      int s32[RG][MAX_CJ];
#pragma unroll
      for (int ii = 0; ii < RG; ++ii)
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j) s32[ii][j] = 0;
      for (int w = 0; w < hd4; ++w) {
        int kw[MAX_CJ];
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j)
          if (j < cj) kw[j] = Kw[koff[j] + w];
#pragma unroll
        for (int ii = 0; ii < RG; ++ii) {
          const int qw = Qw[(warp + WARPS * (i0 + ii)) * hd4 + w];
#pragma unroll
          for (int j = 0; j < MAX_CJ; ++j)
            if (j < cj) s32[ii][j] = __dp4a(qw, kw[j], s32[ii][j]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < RG; ++ii) {
        const int r = warp + WARPS * (i0 + ii);
        const int qpos = q0 + r + p.q_offset;
        const float qss = QSs[r];
        float sv[MAX_CJ];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < MAX_CJ; ++j) {
          const int c = lane + 32 * j;
          if (j < cj && c < nc) {
            const int kp = kv0 + c;
            sv[j] = (!p.causal || kp <= qpos)
                        ? __fmul_rn(__fmul_rn(__int2float_rn(s32[ii][j]), qss),
                                    KSs[c])
                        : NEG_INF;
            mx = fmaxf(mx, sv[j]);
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
            const float e = expf(sv[j] - m_new);
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
      if (d < hd)
        o[(((size_t)b * p.Sq + qi) * p.H + h) * hd + d] = acc[i][dg] / l;
    }
  }
}

template <int RPW, int HDC>
static cudaError_t launch(const float* q, const int* kq, const float* ks,
                          const signed char* vq, const float* vs, float* o,
                          const Problem& p, cudaStream_t stream) {
  const size_t smem = smem_words(RPW * WARPS, p.bkv, p.hd) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_int8_kernel<RPW, HDC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + RPW * WARPS - 1) / (RPW * WARPS)),
                  (unsigned)p.H, (unsigned)p.B);
  flash_attention_int8_kernel<RPW, HDC><<<grid, THREADS, smem, stream>>>(
      q, kq, ks, vq, vs, o, p);
  return cudaGetLastError();
}

template <int HDC>
static cudaError_t launch_rows(int block_q, const float* q, const int* kq,
                               const float* ks, const signed char* vq,
                               const float* vs, float* o, const Problem& p,
                               cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<2, HDC>(q, kq, ks, vq, vs, o, p, s);
    case 32: return launch<4, HDC>(q, kq, ks, vq, vs, o, p, s);
    case 64: return launch<8, HDC>(q, kq, ks, vq, vs, o, p, s);
    case 128: return launch<16, HDC>(q, kq, ks, vq, vs, o, p, s);
    case 256:
      // 32 rows x 4 column groups would be 128 accumulators a thread
      if constexpr (HDC <= 2) return launch<32, HDC>(q, kq, ks, vq, vs, o, p, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

extern "C" size_t flash_attention_int8_smem_bytes(int block_q, int block_kv,
                                                  int hd) {
  return smem_words(block_q, block_kv, hd) * 4;
}

// q [B, Sq, H, hd] f32, kq and vq [B, Skv, KV, hd] int8, ks [B, Skv, KV, 1]
// f32, vs [B, 1, KV, hd] f32 and o [B, Sq, H, hd] f32 are contiguous device
// pointers; hd % 4 == 0 and kq is 4-byte aligned.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_int8(const void* q, const void* kq,
                                    const void* ks, const void* vq,
                                    const void* vs, void* o, int B, int Sq,
                                    int Skv, int H, int KV, int hd,
                                    int causal, int q_offset, float scale,
                                    int block_q, int block_kv,
                                    void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 4 ||
      hd > 128 || hd % 4 != 0 || block_kv < 1 || block_kv > MAX_BLOCK_KV)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.hd = hd;
  p.causal = causal; p.q_offset = q_offset; p.bkv = block_kv;
  p.scale = scale;
  const float* qf = static_cast<const float*>(q);
  const int* kw = static_cast<const int*>(kq);
  const float* ksf = static_cast<const float*>(ks);
  const signed char* vqc = static_cast<const signed char*>(vq);
  const float* vsf = static_cast<const float*>(vs);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return (int)launch_rows<1>(block_q, qf, kw, ksf, vqc, vsf, of, p, s);
  if (hd <= 64)
    return (int)launch_rows<2>(block_q, qf, kw, ksf, vqc, vsf, of, p, s);
  return (int)launch_rows<4>(block_q, qf, kw, ksf, vqc, vsf, of, p, s);
}
