// int8 fused MLP inference on Hopper (sm_90a), dp4a on the CUDA cores.
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
// memory between layers.  Each block owns BM rows and keeps, in dynamic
// shared memory, their f32 activations [BM, stride_f], the int8 copy
// [BM, stride_q] and the BM row scales.  A layer first quantizes the f32
// rows into the int8 copy (one warp per row, a warp-shuffle absmax), then
// overwrites the f32 rows with its outputs: the f32 input is dead once
// quantized, so one f32 buffer serves every layer.  Only the input rows
// are read from and the last layer's rows written to device memory.
//
// Weights are packed at load as int32 words of 4 consecutive k of one
// output column, [K_pad / 4, out] row-major per layer, K zero-padded to a
// multiple of K_PAD, so one 32-bit load feeds one __dp4a and a warp's 32
// loads of one word row are coalesced.  The widest minibude net is
// 2.08 MB int8 and stays L2-resident (50 MB).
//
// Bound on the card: at serving batches the work is 2*B*sum(in*out) int8
// operations (1,979 TOPS dense on the tensor cores; this kernel uses the
// CUDA cores' dp4a, a fraction of that), so it is bound by operations.
// The design maps threads to the live output columns (n = tid, tid +
// THREADS, ...), so no thread computes a column that does not exist
// except in a layer's last pass, and every weight word loaded feeds BM
// dp4a (one per row) while every 16-byte load of the int8 rows feeds four.
// Tensor cores (mma.sync / wgmma s8 -> s32), TMA and split-K are later
// work.
//
// Numerics: the quantization and the dequant epilogue are written with
// __fdiv_rn, __float2int_rn (round half to even), __fmul_rn and __fadd_rn
// so that nvcc neither approximates the division nor contracts the
// epilogue into an FMA: the kernel then computes what the plain PyTorch
// version (quant_mlp_ref) computes, op for op.  Integer accumulation is
// exact and independent of order, and a row never reads another row, so
// each output row is bit-identical whatever the batch size or BM.

#include <cuda_runtime.h>

#define MAX_LAYERS 16
#define THREADS 256
#define WARPS (THREADS / 32)
#define K_PAD 16        // K is zero-padded to a multiple of this (int4 loads)
#define TABLE_FIELDS 6  // per layer: in, out, act, q_off, s_off, b_off

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

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
fused_mlp_int8_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int* __restrict__ qweights,
                      const float* __restrict__ fparams, int rows,
                      int stride_f, int stride_q, LayerTable t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const h = reinterpret_cast<float*>(smem);              // [BM, stride_f]
  signed char* const hq =
      reinterpret_cast<signed char*>(smem + (size_t)BM * stride_f * 4);  // [BM, stride_q]
  float* const hs = reinterpret_cast<float*>(
      smem + (size_t)BM * stride_f * 4 + (size_t)BM * stride_q);  // [BM]
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // input rows into the f32 buffer; rows past the end are zeros
  const int f0 = t.in_w[0];
  for (int i = tid; i < BM * f0; i += THREADS) {
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
    for (int r = warp; r < BM; r += WARPS) {
      const float* hr = h + r * stride_f;
      float m = 0.0f;
      for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(hr[k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float s = __fdiv_rn(m > 0.0f ? m : 1.0f, 127.0f);
      signed char* qr = hq + r * stride_q;
      for (int k = lane; k < KP; k += 32)
        qr[k] = k < K ? (signed char)__float2int_rn(__fdiv_rn(hr[k], s))
                      : (signed char)0;
      if (lane == 0) hs[r] = s;
    }
    __syncthreads();

    // 2. int8 x int8 -> int32 dot and the dequant epilogue, one live
    //    output column per thread per pass
    const int* __restrict__ Wq = qweights + t.q_off[l];
    const float* __restrict__ WS = fparams + t.s_off[l];
    const float* __restrict__ B = fparams + t.b_off[l];
    const int KW = KP / 4;  // int32 words per column, a multiple of 4
    for (int n = tid; n < N; n += THREADS) {
      int acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0;
      for (int g = 0; g < KW; g += 4) {
        const int w0 = __ldg(Wq + (size_t)(g + 0) * N + n);
        const int w1 = __ldg(Wq + (size_t)(g + 1) * N + n);
        const int w2 = __ldg(Wq + (size_t)(g + 2) * N + n);
        const int w3 = __ldg(Wq + (size_t)(g + 3) * N + n);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const int4 a =
              *reinterpret_cast<const int4*>(hq + r * stride_q + 4 * g);
          int v = acc[r];
          v = __dp4a(a.x, w0, v);
          v = __dp4a(a.y, w1, v);
          v = __dp4a(a.z, w2, v);
          v = __dp4a(a.w, w3, v);
          acc[r] = v;
        }
      }
      const float ws = __ldg(WS + n);
      const float bias = __ldg(B + n);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float d =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[r]), hs[r]), ws);
        const float v = activate(__fadd_rn(d, bias), act);
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

// Dynamic shared memory of one block; fused_mlp/int8.py's smem_bytes
// computes the same.
static size_t smem_bytes(int bm, int stride_f, int stride_q) {
  return (size_t)bm * stride_f * 4 + (size_t)bm * stride_q +
         (size_t)round_up(bm * 4, 16);
}

template <int BM>
static cudaError_t launch(const float* x, float* out, const int* qw,
                          const float* fp, int rows, int stride_f,
                          int stride_q, const LayerTable& t,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, stride_f, stride_q);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((rows + BM - 1) / BM);
  fused_mlp_int8_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, out, qw, fp, rows, stride_f, stride_q, t);
  return cudaGetLastError();
}

extern "C" int fused_mlp_int8_max_layers() { return MAX_LAYERS; }

extern "C" int fused_mlp_int8_k_pad() { return K_PAD; }

// x [rows, in_w[0]] f32, out [rows, out_w[n_layers-1]] f32, qweights (int32
// words) and fparams (f32 ws and b) are device pointers; table holds
// TABLE_FIELDS int64 per layer.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int fused_mlp_int8(const void* x, void* out, const void* qweights,
                              const void* fparams, int rows,
                              const long long* table, int n_layers,
                              int block_rows, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || rows < 1)
    return (int)cudaErrorInvalidValue;
  LayerTable t;
  t.n_layers = n_layers;
  int width = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* e = table + (size_t)l * TABLE_FIELDS;
    t.in_w[l] = (int)e[0];
    t.out_w[l] = (int)e[1];
    t.act[l] = (int)e[2];
    t.q_off[l] = e[3];
    t.s_off[l] = e[4];
    t.b_off[l] = e[5];
    if (t.in_w[l] > width) width = t.in_w[l];
    if (t.out_w[l] > width) width = t.out_w[l];
  }
  const int stride_f = round_up(width, 4);
  const int stride_q = round_up(width, K_PAD);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int* qw = static_cast<const int*>(qweights);
  const float* fp = static_cast<const float*>(fparams);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block_rows) {
    case 1: err = launch<1>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    case 2: err = launch<2>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    case 4: err = launch<4>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    case 8: err = launch<8>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    case 16: err = launch<16>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    case 32: err = launch<32>(xf, of, qw, fp, rows, stride_f, stride_q, t, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
