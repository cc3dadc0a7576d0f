// Fused MLP inference on Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces: src/repro/kernels/fused_mlp/fused_mlp.py::fused_mlp (the Pallas
// TPU kernel, pallas_call at l.87, _kernel at l.33).  It computes
// h = act_l(h @ W_l + b_l) chained over every layer of a dense surrogate.
//
// What carries over from the TPU kernel: intermediate activations never go
// to device memory.  Each block owns BM rows and keeps their activations in
// two [BM, stride] f32 buffers in dynamic shared memory, ping-ponging
// between them layer by layer; only the input rows are read from and the
// last layer's rows written to device memory.  What does not carry over:
// the TPU premise that the whole net sits in VMEM.  Weights stay in device
// memory (L2-resident: a minibude net is 8.35 MB against a 50 MB L2) and
// each thread streams the W[k, n] column it owns, coalesced over n because
// W is [in, out].
//
// Bound on the card: at serving batches the work is 2*B*sum(in*out) f32
// FLOPs on the CUDA cores (67 TFLOP/s, no tensor cores: f32 parity is what
// the reference computes), so the kernel is compute-bound; at B=65,536 the
// weights and rows are ~10 MB against 274 GFLOP.  The design answers with
// register tiling: every weight loaded feeds BM fused multiply-adds (one
// per row) and every activation loaded from shared memory (as float4 over
// k) feeds COLS fused multiply-adds (one per owned column).
//
// Numerics: each output is sum_k h[k] * W[k, n] accumulated with fmaf in
// ascending k from 0.0f, then the bias is added and the activation applied.
// K is never split and a row's arithmetic does not depend on the other rows
// of its block, so a row's output is bit-identical whatever the batch size
// or the block_rows the wrapper picks.

#include <cuda_runtime.h>

#define MAX_LAYERS 16
#define THREADS 256
#define COLS 4
#define TABLE_FIELDS 5  // per layer: in, out, act, w_off, b_off

struct LayerTable {
  int n_layers;
  int in_w[MAX_LAYERS];
  int out_w[MAX_LAYERS];
  int act[MAX_LAYERS];
  long long w_off[MAX_LAYERS];
  long long b_off[MAX_LAYERS];
};

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

template <int BM>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ params, int rows, int stride,
                 LayerTable t) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + BM * stride;
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;

  // input rows into buffer 0; rows past the end are zeros (never written)
  const int f0 = t.in_w[0];
  for (int i = tid; i < BM * f0; i += THREADS) {
    const int r = i / f0, c = i - r * f0;
    const int row = row0 + r;
    buf0[r * stride + c] = row < rows ? x[(size_t)row * f0 + c] : 0.0f;
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < t.n_layers; ++l) {
    const int K = t.in_w[l], N = t.out_w[l], act = t.act[l];
    const float* __restrict__ W = params + t.w_off[l];
    const float* __restrict__ B = params + t.b_off[l];
    const float* hin = cur ? buf1 : buf0;
    float* hout = cur ? buf0 : buf1;
    const bool last = l == t.n_layers - 1;

    for (int n0 = 0; n0 < N; n0 += THREADS * COLS) {
      int col[COLS];
      bool ok[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        col[j] = n0 + tid + j * THREADS;
        ok[j] = col[j] < N;
      }
      if (!ok[0]) continue;  // ok[j] implies ok[0]: columns are j-major

      float acc[BM][COLS];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[r][j] = 0.0f;

      int k = 0;
      for (; k + 4 <= K; k += 4) {
        float w[4][COLS];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            w[kk][j] = ok[j] ? __ldg(W + (size_t)(k + kk) * N + col[j]) : 0.0f;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float4 h =
              *reinterpret_cast<const float4*>(hin + r * stride + k);
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            float a = acc[r][j];
            a = fmaf(h.x, w[0][j], a);
            a = fmaf(h.y, w[1][j], a);
            a = fmaf(h.z, w[2][j], a);
            a = fmaf(h.w, w[3][j], a);
            acc[r][j] = a;
          }
        }
      }
      for (; k < K; ++k) {
        float w[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          w[j] = ok[j] ? __ldg(W + (size_t)k * N + col[j]) : 0.0f;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float h = hin[r * stride + k];
#pragma unroll
          for (int j = 0; j < COLS; ++j) acc[r][j] = fmaf(h, w[j], acc[r][j]);
        }
      }

#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (!ok[j]) continue;
        const float bias = __ldg(B + col[j]);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float v = activate(acc[r][j] + bias, act);
          if (last) {
            const int row = row0 + r;
            if (row < rows) out[(size_t)row * N + col[j]] = v;
          } else {
            hout[r * stride + col[j]] = v;
          }
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <int BM>
static cudaError_t launch(const float* x, float* out, const float* params,
                          int rows, int stride, const LayerTable& t,
                          cudaStream_t stream) {
  const size_t smem = 2u * BM * (size_t)stride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((rows + BM - 1) / BM);
  fused_mlp_kernel<BM><<<grid, THREADS, smem, stream>>>(x, out, params, rows,
                                                        stride, t);
  return cudaGetLastError();
}

extern "C" int fused_mlp_max_layers() { return MAX_LAYERS; }

// x [rows, in_w[0]], out [rows, out_w[n_layers-1]] and params are device
// pointers; table holds TABLE_FIELDS int64 per layer.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int fused_mlp_f32(const void* x, void* out, const void* params,
                             int rows, const long long* table, int n_layers,
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
    t.w_off[l] = e[3];
    t.b_off[l] = e[4];
    if (t.in_w[l] > width) width = t.in_w[l];
    if (t.out_w[l] > width) width = t.out_w[l];
  }
  const int stride = (width + 3) & ~3;  // float4 rows
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const float* pf = static_cast<const float*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block_rows) {
    case 1: err = launch<1>(xf, of, pf, rows, stride, t, s); break;
    case 2: err = launch<2>(xf, of, pf, rows, stride, t, s); break;
    case 4: err = launch<4>(xf, of, pf, rows, stride, t, s); break;
    case 8: err = launch<8>(xf, of, pf, rows, stride, t, s); break;
    case 16: err = launch<16>(xf, of, pf, rows, stride, t, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
