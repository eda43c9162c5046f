// Fused harmonic embedding x Dense, forward and backward, hand-written for
// Hopper.
//
// Forward: replaces the Pallas TPU kernel `_fwd_kernel`
// (motionmixerconv_tpu/ops/pallas_harmonic.py, called from
// make_fused_harmonic_dense._run_fwd). Computes
//   out[r, :] = b + sum_i sin(f_i x[r, :]) Ws_i + cos(f_i x[r, :]) Wc_i
// with f_i = omega0 * 2**i, without ever writing the (R, 2nD) embedding to
// device memory. `doubling` derives harmonic i+1 from harmonic i by the
// normalized angle-doubling step instead of evaluating sin/cos again.
//
// What bounds it on the H100: at the flagship shape (R = 10 B rows, D = 66,
// n = 64, E = 50) the contraction is 2 R 2nD E = 1.08 GFLOP at B = 128 in
// float32 (67 TFLOP/s without tensor cores), against ~2.3 MB of traffic, so
// it is bound by operations. In this simple design the contraction, which
// reads both operands from shared memory for every multiply-add, costs more
// than the trig (doubling, with almost no trig, is only a little faster than
// direct). The arguments reach ~3e17 rad, where sinf/cosf leave their fast
// path for an exact (Payne-Hanek) range reduction. That path is slow but
// right, so it is kept: no --use_fast_math, no __sinf/__cosf, whose results
// at these arguments are meaningless.
//
// Design: a block owns a tile of RT rows and all E outputs of them, in
// registers (each of 256 threads at most kMaxAcc outputs). For each
// harmonic it stages the two (D, E) weight slabs and the tile's (RT, D)
// sin/cos features in shared memory, then contracts them at once. The
// doubling step uses round-to-nearest intrinsics so that no multiply-add is
// contracted: the recurrence doubles any rounding difference per harmonic,
// and this keeps it identical, operation for operation, to the plain torch
// version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 8;

// (sin a, cos a) -> (sin 2a, cos 2a), normalized by s^2 + c^2. Every step
// rounds to nearest with no contraction, as the plain torch version does.
__device__ __forceinline__ void double_angle(float& s, float& c) {
  const float inv =
      __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(s, s), __fmul_rn(c, c)));
  const float s2 = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(s, c)), inv);
  c = __fmul_rn(__fmul_rn(__fsub_rn(c, s), __fadd_rn(c, s)), inv);
  s = s2;
}

__global__ void __launch_bounds__(kThreads)
harmonic_dense_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ wsc,
                          const float* __restrict__ bias,
                          const float* __restrict__ freqs,
                          float* __restrict__ out, int R, int D, int E, int n,
                          int doubling, int RT) {
  extern __shared__ float smem[];
  float* ws = smem;          // (D, E) sin slab of harmonic i
  float* wc = ws + D * E;    // (D, E) cos slab of harmonic i
  float* S = wc + D * E;     // (RT, D) sin features
  float* C = S + RT * D;     // (RT, D) cos features
  float* X = C + RT * D;     // (RT, D) input tile

  const long r0 = (long)blockIdx.x * RT;
  const int rows = (long)R - r0 < RT ? (int)((long)R - r0) : RT;
  for (int i = threadIdx.x; i < RT * D; i += kThreads)
    X[i] = i < rows * D ? x[r0 * D + i] : 0.0f;

  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.0f;

  __syncthreads();
  if (doubling) {
    for (int i = threadIdx.x; i < RT * D; i += kThreads) {
      const float a = __fmul_rn(X[i], freqs[0]);
      S[i] = sinf(a);
      C[i] = cosf(a);
    }
  }

  const long slab = (long)D * E;
  for (int h = 0; h < n; ++h) {
    __syncthreads();  // the previous harmonic's contraction is done
    const float* gs = wsc + (long)h * slab;
    const float* gc = wsc + ((long)n + h) * slab;
    for (long i = threadIdx.x; i < slab; i += kThreads) {
      ws[i] = gs[i];
      wc[i] = gc[i];
    }
    if (!doubling) {
      const float f = freqs[h];
      for (int i = threadIdx.x; i < RT * D; i += kThreads) {
        const float a = __fmul_rn(X[i], f);
        S[i] = sinf(a);
        C[i] = cosf(a);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int o = threadIdx.x + k * kThreads;
      if (o < RT * E) {
        const int r = o / E, e = o - r * E;
        const float* sr = S + r * D;
        const float* cr = C + r * D;
        float a = acc[k];
        for (int dd = 0; dd < D; ++dd)
          a += sr[dd] * ws[dd * E + e] + cr[dd] * wc[dd * E + e];
        acc[k] = a;
      }
    }
    if (doubling && h + 1 < n) {
      __syncthreads();  // every thread has read harmonic h's features
      for (int i = threadIdx.x; i < RT * D; i += kThreads)
        double_angle(S[i], C[i]);
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < RT * E) {
      const int r = o / E, e = o - r * E;
      if (r < rows) out[(r0 + r) * E + e] = acc[k] + bias[e];
    }
  }
}

inline size_t smem_bytes(int D, int E, int RT) {
  return sizeof(float) * (2 * (size_t)D * E + 3 * (size_t)RT * D);
}

// ---------------------------------------------------------------- backward
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (pallas_harmonic.py, called
// from make_fused_harmonic_dense._run_bwd). Given the upstream gradient g
// (R, E) it computes
//   dW[s, i] = sum_r feat_{s,i}(x_r)^T g_r        (s = sin, cos; i < n)
//   db       = sum_r g_r
//   dx_r     = sum_i f_i (c_i * (g_r Ws_i^T) - s_i * (g_r Wc_i^T))
// where (s_i, c_i) are harmonic i's features as the forward computes them:
// direct trig, or the doubling recurrence. For doubling this is the
// analytic gradient evaluated at the recurrence's own (s_i, c_i), as the
// TPU kernel defines it, not autodiff through the recurrence.
//
// What bounds it on the H100: at a training step of batch 50 (R = 500) dW
// and dx are each 2 R 2nD E = 0.42 GFLOP in float32 against ~1.9 MB of
// traffic, so it is bound by operations (~13 us for both at 67 TFLOP/s).
//
// Design. The TPU kernel carries dW across a sequential grid of row tiles;
// blocks on Hopper run in no order, so a float atomicAdd would make dW
// depend on the schedule. Instead one block owns one (harmonic, sin|cos)
// slab of dW, (D, E) outputs in registers, and loops over all R rows in
// tiles of kBwdRows: 2n blocks fill the card's 132 SMs at n = 64, and every
// sum is taken in one fixed order, so two launches give identical bits. A
// further block sums db. dW is written straight into torch's (E, 2nD)
// d-major layout (feature index s*nD + d*n + i). Under doubling each block
// runs the recurrence up to its own harmonic (O(n^2/2) steps in all, cheap
// next to the contraction). dx, a separate row-tiled launch like the
// forward, runs only when the caller asks for it.

constexpr int kBwdRows = 32;
constexpr int kBwdMaxAcc = 16;

// harmonic h's sin (s = 0) or cos (s = 1) feature of one input value
__device__ __forceinline__ float harmonic_feature(float xv, int s, int h,
                                                  const float* freqs,
                                                  int doubling) {
  if (!doubling) {
    const float a = __fmul_rn(xv, freqs[h]);
    return s ? cosf(a) : sinf(a);
  }
  const float a = __fmul_rn(xv, freqs[0]);
  float sn = sinf(a), cs = cosf(a);
  for (int i = 0; i < h; ++i) double_angle(sn, cs);
  return s ? cs : sn;
}

__global__ void __launch_bounds__(kThreads)
harmonic_dense_bwd_dw_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ freqs,
                             float* __restrict__ dw, float* __restrict__ db,
                             int R, int D, int E, int n, int doubling) {
  extern __shared__ float smem[];
  float* F = smem;               // (kBwdRows, D) inputs, then features
  float* G = F + kBwdRows * D;   // (kBwdRows, E) upstream gradient

  if (blockIdx.x == 2 * n) {     // the bias gradient, rows in order
    for (int e = threadIdx.x; e < E; e += kThreads) {
      float a = 0.0f;
      for (long r = 0; r < R; ++r) a += g[r * E + e];
      db[e] = a;
    }
    return;
  }
  const int s = blockIdx.x / n, h = blockIdx.x - s * n;

  float acc[kBwdMaxAcc];
#pragma unroll
  for (int k = 0; k < kBwdMaxAcc; ++k) acc[k] = 0.0f;

  for (long r0 = 0; r0 < R; r0 += kBwdRows) {
    const int rows = (long)R - r0 < kBwdRows ? (int)((long)R - r0) : kBwdRows;
    __syncthreads();  // the previous tile's contraction is done
    for (int i = threadIdx.x; i < rows * D; i += kThreads)
      F[i] = harmonic_feature(x[r0 * D + i], s, h, freqs, doubling);
    for (int i = threadIdx.x; i < rows * E; i += kThreads)
      G[i] = g[r0 * E + i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBwdMaxAcc; ++k) {
      const int o = threadIdx.x + k * kThreads;
      if (o < D * E) {
        const int e = o / D, d = o - e * D;
        float a = acc[k];
        for (int r = 0; r < rows; ++r) a += F[r * D + d] * G[r * E + e];
        acc[k] = a;
      }
    }
  }

  const long nd = (long)n * D;
#pragma unroll
  for (int k = 0; k < kBwdMaxAcc; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < D * E) {
      const int e = o / D, d = o - e * D;
      dw[e * 2 * nd + s * nd + (long)d * n + h] = acc[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
harmonic_dense_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ wsc,
                             const float* __restrict__ freqs,
                             float* __restrict__ dx, int R, int D, int E,
                             int n, int doubling, int RT) {
  extern __shared__ float smem[];
  float* ws = smem;          // (D, E) sin slab of harmonic h
  float* wc = ws + D * E;    // (D, E) cos slab of harmonic h
  float* S = wc + D * E;     // (RT, D) sin features
  float* C = S + RT * D;     // (RT, D) cos features
  float* X = C + RT * D;     // (RT, D) input tile
  float* G = X + RT * D;     // (RT, E) upstream gradient tile

  const long r0 = (long)blockIdx.x * RT;
  const int rows = (long)R - r0 < RT ? (int)((long)R - r0) : RT;
  for (int i = threadIdx.x; i < RT * D; i += kThreads)
    X[i] = i < rows * D ? x[r0 * D + i] : 0.0f;
  for (int i = threadIdx.x; i < RT * E; i += kThreads)
    G[i] = i < rows * E ? g[r0 * E + i] : 0.0f;

  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.0f;

  __syncthreads();
  if (doubling) {
    for (int i = threadIdx.x; i < RT * D; i += kThreads) {
      const float a = __fmul_rn(X[i], freqs[0]);
      S[i] = sinf(a);
      C[i] = cosf(a);
    }
  }

  const long slab = (long)D * E;
  for (int h = 0; h < n; ++h) {
    __syncthreads();  // the previous harmonic's contraction is done
    const float* gs = wsc + (long)h * slab;
    const float* gc = wsc + ((long)n + h) * slab;
    for (long i = threadIdx.x; i < slab; i += kThreads) {
      ws[i] = gs[i];
      wc[i] = gc[i];
    }
    if (!doubling) {
      const float f = freqs[h];
      for (int i = threadIdx.x; i < RT * D; i += kThreads) {
        const float a = __fmul_rn(X[i], f);
        S[i] = sinf(a);
        C[i] = cosf(a);
      }
    }
    __syncthreads();
    const float f = freqs[h];
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int o = threadIdx.x + k * kThreads;
      if (o < RT * D) {
        const int r = o / D, d = o - r * D;
        const float* gr = G + r * E;
        const float* wsd = ws + d * E;
        const float* wcd = wc + d * E;
        float ps = 0.0f, pc = 0.0f;
        for (int e = 0; e < E; ++e) {
          ps += gr[e] * wsd[e];
          pc += gr[e] * wcd[e];
        }
        acc[k] += f * (C[o] * ps - S[o] * pc);
      }
    }
    if (doubling && h + 1 < n) {
      __syncthreads();  // every thread has read harmonic h's features
      for (int i = threadIdx.x; i < RT * D; i += kThreads)
        double_angle(S[i], C[i]);
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < RT * D) {
      const int r = o / D, d = o - r * D;
      if (r < rows) dx[(r0 + r) * D + d] = acc[k];
    }
  }
}

inline size_t bwd_dw_smem_bytes(int D, int E) {
  return sizeof(float) * (size_t)kBwdRows * (D + E);
}

inline size_t bwd_dx_smem_bytes(int D, int E, int RT) {
  return sizeof(float) *
         (2 * (size_t)D * E + 3 * (size_t)RT * D + (size_t)RT * E);
}

}  // namespace

extern "C" {

int mmc_harmonic_max_outputs_per_tile() { return kThreads * kMaxAcc; }

long mmc_harmonic_smem_bytes(int D, int E, int RT) {
  return (long)smem_bytes(D, E, RT);
}

// x (R, D), wsc (2, n, D, E) i-major, bias (E), freqs (n), out (R, E); all
// float32 on the current device. RT rows per block, RT * E <= 256 * 8.
// Returns the cudaError_t of the launch (0 on success).
int mmc_harmonic_dense_fwd(const float* x, const float* wsc, const float* bias,
                           const float* freqs, float* out, int R, int D, int E,
                           int n, int doubling, int RT, void* stream) {
  if (RT * E > kThreads * kMaxAcc) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, E, RT);
  cudaError_t err = cudaFuncSetAttribute(
      harmonic_dense_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + RT - 1) / RT;
  harmonic_dense_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, wsc, bias, freqs, out, R, D, E, n, doubling, RT);
  return (int)cudaGetLastError();
}

int mmc_harmonic_bwd_max_slab_outputs() { return kThreads * kBwdMaxAcc; }

long mmc_harmonic_bwd_smem_bytes(int D, int E, int RT) {
  const size_t a = bwd_dw_smem_bytes(D, E), b = bwd_dx_smem_bytes(D, E, RT);
  return (long)(a > b ? a : b);
}

// x (R, D), g (R, E), wsc (2, n, D, E) i-major, freqs (n); outputs dw
// (E, 2nD) in torch's d-major layout, db (E) and, unless dx is null, dx
// (R, D); all float32 on the current device. D * E <= 256 * 16; the dx
// launch takes RT rows per block, RT * D <= 256 * 8. Returns the
// cudaError_t of the launches (0 on success).
int mmc_harmonic_dense_bwd(const float* x, const float* g, const float* wsc,
                           const float* freqs, float* dw, float* db,
                           float* dx, int R, int D, int E, int n,
                           int doubling, int RT, void* stream) {
  if (D * E > kThreads * kBwdMaxAcc) return (int)cudaErrorInvalidValue;
  if (dx != nullptr && RT * D > kThreads * kMaxAcc)
    return (int)cudaErrorInvalidValue;
  const size_t smem_w = bwd_dw_smem_bytes(D, E);
  cudaError_t err = cudaFuncSetAttribute(
      harmonic_dense_bwd_dw_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_w);
  if (err != cudaSuccess) return (int)err;
  harmonic_dense_bwd_dw_kernel<<<2 * n + 1, kThreads, smem_w,
                                 (cudaStream_t)stream>>>(
      x, g, freqs, dw, db, R, D, E, n, doubling);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return (int)err;
  const size_t smem_x = bwd_dx_smem_bytes(D, E, RT);
  err = cudaFuncSetAttribute(harmonic_dense_bwd_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_x);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + RT - 1) / RT;
  harmonic_dense_bwd_dx_kernel<<<grid, kThreads, smem_x,
                                 (cudaStream_t)stream>>>(
      x, g, wsc, freqs, dx, R, D, E, n, doubling, RT);
  return (int)cudaGetLastError();
}

}  // extern "C"
