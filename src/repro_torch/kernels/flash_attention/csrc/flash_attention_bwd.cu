// The backward of flash attention (GQA, causal on absolute positions,
// kv_valid_len) on Hopper (sm_90a), products in f32 on the CUDA cores.
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
// dO V^T again in each kernel), 4 * hd operations per seen (query, key)
// pair each.  At the llama3.2-3b training shape (B 2, S 2,048, 24 q and 8
// kv heads of 128, causal) five products are 1.29e11 operations, 1.9 ms
// at the f32 CUDA-core peak (67 TFLOP/s).
//
// What the design does about it (simple, no float atomics, deterministic):
// - Two kernels on the caller's stream.  dq: one block per (64 query rows,
//   q head, batch) walks the keys twice, first for each row's max and sum
//   (lse, written for the second kernel, with D), then for dS and
//   dQ += dS K.  dkdv: one block per (64 keys, kv head, batch) keeps its
//   K and V tiles and loops over the group's q heads and the query chunks
//   that see its keys, recomputing S, P and dS, with dK and dV in
//   registers.  Every output element is written by one thread, and every
//   sum runs in a fixed order: two runs give the same bits.
// - 256 threads a block.  Tiles sit in shared memory in f32 (bf16 inputs
//   widened as they are staged), rows padded by 4 words so that the
//   16-byte loads of a quarter warp hit distinct banks.  Each thread holds
//   a 4 x 4 block of a 64 x 64 score tile (rows ty + 16a, columns
//   tx + 16b: a row's 16 threads are one half warp, which reduces it by
//   shuffles) and a 4 x (hd tile / 16) block of a 64-row output tile.
//   Every product reads its operands four at a time (float4).
// - The dq blocks run longest first (the last causal block walks every
//   key); a dkdv block skips the query chunks that see none of its keys
//   (only when every row sees some key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#define NTHREADS 256
#define TILE 64          // query rows and keys per tile
#define PAD 4            // words of padding per shared-memory row
#define LDT (TILE + PAD) // row stride of a score tile

struct BwdProblem {
  int B, Sq, Skv, H, KV, hd;
  int causal, q_offset, kv_valid;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + 64) of a tensor whose row r starts at base + r * rs
// into an f32 tile [64][HDT + PAD]: zero at rows >= n_rows and at
// columns >= hd.
template <int HDT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          size_t rs, int r0, int n_rows,
                                          int hd) {
  constexpr int LD = HDT + PAD;
  for (int idx = threadIdx.x; idx < TILE * HDT; idx += NTHREADS) {
    const int r = idx / HDT, d = idx - r * HDT;
    const int gr = r0 + r;
    dst[r * LD + d] = gr < n_rows && d < hd
                          ? to_f32(base[(size_t)gr * rs + d])
                          : 0.0f;
  }
}

// c[a][b] += sum_{d < HDT} A[ty + 16a][d] * Bm[tx + 16b][d]; A and Bm
// are [64][HDT + PAD] row-major tiles.
template <int HDT>
__device__ __forceinline__ void mm_nt(const float* A, const float* Bm,
                                      float (&c)[4][4], int ty, int tx) {
  constexpr int LD = HDT + PAD;
#pragma unroll 2
  for (int d = 0; d < HDT; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
      b[i] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
}

// c[a][n][e] += sum_{k < 64} A[ty + 16a][k] * Bm[k][tx * 4 + 64n + e];
// A is a [64][LDT] score tile, Bm a [64][HDT + PAD] tile.
template <int HDT>
__device__ __forceinline__ void mm_nn(const float* A, const float* Bm,
                                      float (&c)[4][HDT / 64][4], int ty,
                                      int tx) {
  constexpr int LD = HDT + PAD, NC = HDT / 64;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n)
        b[n] = *reinterpret_cast<const float4*>(Bm + (k + kk) * LD + tx * 4 +
                                                64 * n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          c[i][n][0] = fmaf(av, b[n].x, c[i][n][0]);
          c[i][n][1] = fmaf(av, b[n].y, c[i][n][1]);
          c[i][n][2] = fmaf(av, b[n].z, c[i][n][2]);
          c[i][n][3] = fmaf(av, b[n].w, c[i][n][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float halfwarp_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float halfwarp_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Whether query position qpos sees key c below the block's key bound
// kv_end (which is at most kv_valid and Skv).
__device__ __forceinline__ bool seen(int c, int kv_end, int qpos,
                                     int causal) {
  return c < kv_end && (!causal || c <= qpos);
}

template <int HDT>
__host__ __device__ constexpr size_t dq_smem_floats() {
  return 4 * TILE * (HDT + PAD) + TILE * LDT + 2 * TILE;
}
template <int HDT>
__host__ __device__ constexpr size_t dkdv_smem_floats() {
  return 4 * TILE * (HDT + PAD) + 2 * TILE * LDT + 2 * TILE;
}

// dQ, and each row's lse and D for the dkdv kernel.
template <int HDT, typename T>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ delta_out,
              BwdProblem p) {
  constexpr int LD = HDT + PAD, NC = HDT / 64;
  extern __shared__ __align__(16) float sm[];
  float* const Qs = sm;
  float* const dOs = Qs + TILE * LD;
  float* const Ks = dOs + TILE * LD;
  float* const Vs = Ks + TILE * LD;
  float* const Ss = Vs + TILE * LD;   // dS, [query][key]
  float* const lse_s = Ss + TILE * LDT;
  float* const D_s = lse_s + TILE;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.KV);
  const size_t qrs = (size_t)p.H * p.hd, krs = (size_t)p.KV * p.hd;
  const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
  const size_t koff = ((size_t)b * p.Skv * p.KV + g) * p.hd;

  load_tile<HDT>(Qs, q + qoff, qrs, q0, p.Sq, p.hd);
  load_tile<HDT>(dOs, dout + qoff, qrs, q0, p.Sq, p.hd);
  load_tile<HDT>(Ks, o + qoff, qrs, q0, p.Sq, p.hd);  // o, for D only
  __syncthreads();
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < TILE; r += NTHREADS / 32) {
      float acc = 0.0f;
      for (int d = lane; d < HDT; d += 32)
        acc = fmaf(dOs[r * LD + d], Ks[r * LD + d], acc);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) D_s[r] = acc;
    }
  }
  __syncthreads();  // D_s is visible; Ks is read no more

  // the keys any row of this block sees
  const int q_last = min(q0 + TILE, p.Sq) - 1;
  int kv_end = min(p.Skv, p.kv_valid);
  if (p.causal) kv_end = min(kv_end, p.q_offset + q_last + 1);
  kv_end = max(kv_end, 0);
  const int n_chunks = (kv_end + TILE - 1) / TILE;

  // pass 1: each row's max m and sum l of exp(s - m) over its seen keys
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
  }
  for (int j = 0; j < n_chunks; ++j) {
    const int kv0 = j * TILE;
    if (j) __syncthreads();  // Ks is free
    load_tile<HDT>(Ks, k + koff, krs, kv0, kv_end, p.hd);
    __syncthreads();
    float s[4][4] = {};
    mm_nt<HDT>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + p.q_offset;
      float cmax = -INFINITY;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = kv0 + tx + 16 * bb;
        s[a][bb] = seen(c, kv_end, qpos, p.causal) ? s[a][bb] * p.scale
                                                   : -INFINITY;
        cmax = fmaxf(cmax, s[a][bb]);
      }
      const float mn = fmaxf(m[a], halfwarp_max(cmax));
      // a row that has seen no key yet keeps m = -inf and l = 0; the
      // shuffles run on every lane (the two rows of a warp may differ)
      const bool any = mn != -INFINITY;
      float sum = 0.0f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        sum += any ? expf(s[a][bb] - mn) : 0.0f;
      sum = halfwarp_sum(sum);
      if (any) {
        l[a] = l[a] * expf(m[a] - mn) + sum;
        m[a] = mn;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, qi = q0 + r;
      const float lse = l[a] > 0.0f ? m[a] + logf(l[a]) : INFINITY;
      lse_s[r] = lse;
      if (qi < p.Sq) {
        const size_t at = ((size_t)b * p.H + h) * p.Sq + qi;
        lse_out[at] = lse;
        delta_out[at] = D_s[r];
      }
    }
  }

  // pass 2: dS = P (dO V^T - D) and dQ += dS K
  float acc[4][NC][4] = {};
  for (int j = 0; j < n_chunks; ++j) {
    const int kv0 = j * TILE;
    __syncthreads();  // Ks, Vs and Ss are free; lse_s is visible
    load_tile<HDT>(Ks, k + koff, krs, kv0, kv_end, p.hd);
    load_tile<HDT>(Vs, v + koff, krs, kv0, kv_end, p.hd);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<HDT>(Qs, Ks, s, ty, tx);
    mm_nt<HDT>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, qpos = q0 + r + p.q_offset;
      const float lse = lse_s[r], D = D_s[r];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int c = kv0 + tx + 16 * bb;
        float ds = 0.0f;
        if (seen(c, kv_end, qpos, p.causal))
          ds = expf(s[a][bb] * p.scale - lse) * (dp[a][bb] - D);
        Ss[r * LDT + tx + 16 * bb] = ds;
      }
    }
    __syncthreads();
    mm_nn<HDT>(Ss, Ks, acc, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= p.Sq) continue;
    T* const row = dq + qoff + (size_t)qi * qrs;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * n + e;
        if (d < p.hd) put(row + d, acc[a][n][e] * p.scale);
      }
  }
}

// dK and dV of 64 keys of one kv head, summed over its q heads.
template <int HDT, typename T>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_in,
                const float* __restrict__ delta_in, T* __restrict__ dk,
                T* __restrict__ dv, BwdProblem p) {
  constexpr int LD = HDT + PAD, NC = HDT / 64;
  extern __shared__ __align__(16) float sm[];
  float* const Ks = sm;
  float* const Vs = Ks + TILE * LD;
  float* const Qs = Vs + TILE * LD;
  float* const dOs = Qs + TILE * LD;
  float* const Pt = dOs + TILE * LD;  // P, [key][query]
  float* const dSt = Pt + TILE * LDT;  // dS, [key][query]
  float* const lse_s = dSt + TILE * LDT;
  float* const D_s = lse_s + TILE;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * TILE;  // the first blocks see the most rows
  const int g = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV;
  const size_t qrs = (size_t)p.H * p.hd, krs = (size_t)p.KV * p.hd;
  const size_t koff = ((size_t)b * p.Skv * p.KV + g) * p.hd;

  load_tile<HDT>(Ks, k + koff, krs, k0, p.Skv, p.hd);
  load_tile<HDT>(Vs, v + koff, krs, k0, p.Skv, p.hd);

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
  q_lo = min(q_lo, p.Sq) / TILE * TILE;
  const float inv_skv = 1.0f / (float)p.Skv;

  float dk_acc[4][NC][4] = {}, dv_acc[4][NC][4] = {};
  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const size_t qoff = ((size_t)b * p.Sq * p.H + h) * p.hd;
    for (int q0 = q_lo; q0 < p.Sq; q0 += TILE) {
      __syncthreads();  // Qs, dOs, Pt, dSt, lse_s and D_s are free
      load_tile<HDT>(Qs, q + qoff, qrs, q0, p.Sq, p.hd);
      load_tile<HDT>(dOs, dout + qoff, qrs, q0, p.Sq, p.hd);
      if (tid < TILE) {
        const int qi = q0 + tid;
        const size_t at = ((size_t)b * p.H + h) * p.Sq + qi;
        lse_s[tid] = qi < p.Sq ? lse_in[at] : INFINITY;
        D_s[tid] = qi < p.Sq ? delta_in[at] : 0.0f;
      }
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      mm_nt<HDT>(Ks, Qs, st, ty, tx);   // [key][query]
      mm_nt<HDT>(Vs, dOs, dpt, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a, c = k0 + r;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = tx + 16 * bb, qi = q0 + i;
          const int qpos = qi + p.q_offset;
          const bool row = qi < p.Sq && c < p.Skv;
          const bool dead = p.kv_valid == 0 || (p.causal && qpos < 0);
          float pr = 0.0f, ds = 0.0f;
          if (row && !dead && seen(c, p.kv_valid, qpos, p.causal)) {
            pr = expf(st[a][bb] * p.scale - lse_s[i]);
            ds = pr * (dpt[a][bb] - D_s[i]);
          } else if (row && dead) {
            pr = inv_skv;
          }
          Pt[r * LDT + i] = pr;
          dSt[r * LDT + i] = ds;
        }
      }
      __syncthreads();
      mm_nn<HDT>(Pt, dOs, dv_acc, ty, tx);
      mm_nn<HDT>(dSt, Qs, dk_acc, ty, tx);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = k0 + ty + 16 * a;
    if (c >= p.Skv) continue;
    T* const krow = dk + koff + (size_t)c * krs;
    T* const vrow = dv + koff + (size_t)c * krs;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * n + e;
        if (d < p.hd) {
          put(krow + d, dk_acc[a][n][e] * p.scale);
          put(vrow + d, dv_acc[a][n][e]);
        }
      }
  }
}

template <int HDT, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, void* dq,
                          void* dk, void* dv, float* lse, float* delta,
                          const BwdProblem& p, cudaStream_t stream) {
  const size_t dq_smem = sizeof(float) * dq_smem_floats<HDT>();
  const size_t kv_smem = sizeof(float) * dkdv_smem_floats<HDT>();
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
  const dim3 gq((unsigned)((p.Sq + TILE - 1) / TILE), (unsigned)p.H,
                (unsigned)p.B);
  bwd_dq_kernel<HDT, T><<<gq, NTHREADS, dq_smem, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse,
      delta, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((unsigned)((p.Skv + TILE - 1) / TILE), (unsigned)p.KV,
                (unsigned)p.B);
  bwd_dkdv_kernel<HDT, T><<<gk, NTHREADS, kv_smem, stream>>>(
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
// head dim hd; flash_attention.py's bwd_smem_bytes computes the same.
extern "C" size_t flash_attention_bwd_smem_bytes(int hd, int kernel) {
  const bool wide = hd > 64;
  const size_t floats =
      kernel == 0 ? (wide ? dq_smem_floats<128>() : dq_smem_floats<64>())
                  : (wide ? dkdv_smem_floats<128>() : dkdv_smem_floats<64>());
  return sizeof(float) * floats;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse,
                                         delta, p, s);
  return (int)launch_hd<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, p,
                               s);
}
