// Fused harmonic embedding x Dense, forward only, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
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
      for (int i = threadIdx.x; i < RT * D; i += kThreads) {
        // (sin a, cos a) -> (sin 2a, cos 2a), normalized by s^2 + c^2
        const float s = S[i], c = C[i];
        const float inv =
            __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(s, s), __fmul_rn(c, c)));
        S[i] = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(s, c)), inv);
        C[i] = __fmul_rn(__fmul_rn(__fsub_rn(c, s), __fadd_rn(c, s)), inv);
      }
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

}  // extern "C"
