// Stencil gather (im2col) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stencil_gather/stencil_gather.py::
// stencil_gather (the Pallas TPU kernel, pallas_call at l.53, _kernel at
// l.22).  It computes
//
//   out[i, j, f] = x[o0 + i + dy_f, o1 + j + dx_f]
//
// for an [H, W] source and an [out_h, out_w, F] output, F <= MAX_FEATURES.
//
// What bounds it on the card: bytes.  It does no arithmetic; the least it
// must move is the source read once and the output written once, F times
// the source's size.  What the design does about it: each block owns a
// (block_h, block_w) output tile and walks it row by row, one thread per
// output element in row-major (i, j, f) order, so a warp's stores are 32
// consecutive elements; the loads of neighbouring threads fall on
// neighbouring columns of at most F source rows, and a source element
// read by the F features of nearby points is served from L1/L2.  The
// TPU kernel kept the whole padded source in VMEM; here nothing is staged
// through shared memory but the F source offsets.
//
// Offsets arrive as an argument array (the linear source offset of each
// feature, (o0 + dy_f) * W + (o1 + dx_f), origin folded in), not baked
// into the code per problem.  Elements are copied as 4- or 2-byte
// integers, so f32 and bf16 take the same code and every bit is kept.
// The host wrapper (stencil_gather.py) checks that every read is in
// bounds; the kernel masks only the ragged edge of the output.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_FEATURES 64
#define THREADS 256

struct Offsets {
  int n;
  long long src[MAX_FEATURES];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
stencil_gather_kernel(const T* __restrict__ x, T* __restrict__ out,
                      long long W, int out_h, int out_w, int bh, int bw,
                      Offsets o) {
  __shared__ long long src[MAX_FEATURES];
  const int F = o.n;
  for (int f = threadIdx.x; f < F; f += THREADS) src[f] = o.src[f];
  __syncthreads();

  const int i0 = blockIdx.y * bh, j0 = blockIdx.x * bw;
  const int th = min(bh, out_h - i0), tw = min(bw, out_w - j0);
  const int row_elems = tw * F;
  // element e of a tile row is (column c, feature f) = (e / F, e % F);
  // a thread steps e by THREADS, so (c, f) advances without a division
  const int step_c = THREADS / F, step_f = THREADS - step_c * F;
  const int c0 = threadIdx.x / F, f0 = threadIdx.x - c0 * F;
  for (int r = 0; r < th; ++r) {
    const long long i = i0 + r;
    T* orow = out + (i * out_w + j0) * F;
    const T* xrow = x + i * W + j0;
    int c = c0, f = f0;
    for (int e = threadIdx.x; e < row_elems; e += THREADS) {
      orow[e] = xrow[src[f] + c];
      c += step_c;
      f += step_f;
      if (f >= F) {
        f -= F;
        ++c;
      }
    }
  }
}

extern "C" int stencil_gather_max_features() { return MAX_FEATURES; }

// x [H, W] and out [out_h, out_w, n_features] are device pointers of
// elements of elem_bytes (4 or 2) bytes; src holds n_features int64 linear
// source offsets (host memory).  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int stencil_gather(const void* x, void* out, long long W,
                              int out_h, int out_w, const long long* src,
                              int n_features, int elem_bytes, int block_h,
                              int block_w, void* stream) {
  if (n_features < 1 || n_features > MAX_FEATURES || out_h < 1 ||
      out_w < 1 || block_h < 1 || block_w < 1)
    return (int)cudaErrorInvalidValue;
  const long long gy = ((long long)out_h + block_h - 1) / block_h;
  const long long gx = ((long long)out_w + block_w - 1) / block_w;
  if (gy > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidValue;
  Offsets o;
  o.n = n_features;
  for (int f = 0; f < n_features; ++f) o.src[f] = src[f];
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    stencil_gather_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), W,
        out_h, out_w, block_h, block_w, o);
  } else if (elem_bytes == 2) {
    stencil_gather_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), W,
        out_h, out_w, block_h, block_w, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
