// The single-channel ConvBlock, forward and backward, hand-written for
// Hopper:
//   z = conv(x) + b     one channel in and out, kh x kw taps, stride 1,
//                       'same' padding (an even kernel's extra pad on the
//                       bottom and right, as torch and flax SAME put it)
//   a = act(z)          mish (the overflow-free softplus) or exact GELU
// on planes x (N, T, E). The backward takes g = dL/da and gives
//   dz = g act'(z),  dx = the transposed taps over dz,
//   dw[p, q] = sum over n, i, j of dz[n, i, j] x[n, i + p - ph, j + q - pw],
//   db = sum of dz.
//
// Replaces no TPU kernel: in the JAX package XLA fused this chain
// (motionmixerconv_tpu/models/mixer_conv.py ConvBlock) and no Pallas
// kernel stood for it. Eager PyTorch runs it as cuDNN's convolution, its
// bias add and eight elementwise kernels of mish forward, and as mish's
// ten, cuDNN's data and weight gradients and a bias reduction backward:
// about 28 kernels a block and a training step, each inside the step's
// CUDA graph (ops/conv_block.py).
//
// What bounds it on the H100. At the flagship's training shape (N 50,
// T 10, E 50, taps (1,3) or (3,1)) a call moves about 0.2 MB forward (x
// in, a out) and 0.3 MB backward (x and g in, dx out), 0.06-0.09 us at
// 3.35 TB/s, and does under 1 M operations: both are far below a launch's
// own few microseconds, so launch latency and the chain of dependent
// steps inside one block bound it. The design therefore does each
// direction in one launch, and in as few dependent steps as it can.
//
// Design. A block of kThreads threads owns one plane (one sample): it
// copies the plane into shared memory with its zero halo, so every tap
// reads shared memory and no thread tests an edge. The forward writes
// act(z) and saves nothing: the backward recomputes z from the taps, which
// is cheaper than a round trip through device memory. The backward keeps
// dz in a second padded plane, so dx reads its transposed taps from shared
// memory too; each block sums dz x (each tap's window of x) and dz over
// its plane, chunks of kTapChunk sums in registers and a warp's sums in
// shared memory, and writes its partial sums. The last block to finish
// (a thread fence and an integer count in the call's own counter) adds
// every block's partials in a fixed order and resets the count. No float
// atomics: two launches give identical bits. The counter belongs to the
// call (the wrapper allocates it and the forward of the same call zeroes
// it), so concurrent calls on two streams share nothing, and a captured
// CUDA graph replays both kernels as they are.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

constexpr int kThreads = 256;  // threads of either kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kTapChunk = 8;   // the backward's sums a thread holds at once

// launches of the forward (0) and backward (1) kernels since the library
// was loaded, counted on the device by each launch's first thread: replays
// of a captured CUDA graph run no wrapper, so only the device sees them
__device__ unsigned long long launch_count[2];

__device__ __forceinline__ void count_launch(int kernel) {
  if (threadIdx.x == 0 && blockIdx.x == 0)
    atomicAdd(&launch_count[kernel], 1ULL);
}

// d act(z) / dz; softplus' derivative is the logistic sigmoid, taken in
// the form that does not overflow
__device__ __forceinline__ float activation_grad(float z, int act) {
  if (act == 1) {
    const float e = expf(-fabsf(z));
    const float t = tanhf(log1pf(e) + fmaxf(z, 0.0f));
    const float sig = (z >= 0.0f ? 1.0f : e) / (1.0f + e);
    return t + z * (1.0f - t * t) * sig;
  }
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752440f));
  return cdf + z * (expf(-0.5f * z * z) * 0.39894228040143267794f);
}

// dst (rows, ld) = src (T, E) placed at row r0, column c0, zero elsewhere
__device__ __forceinline__ void load_padded(float* dst,
                                            const float* __restrict__ src,
                                            int T, int E, int rows, int ld,
                                            int r0, int c0) {
  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
    const int r = i / ld - r0, c = i % ld - c0;
    dst[i] = (r >= 0 && r < T && c >= 0 && c < E) ? __ldg(src + r * E + c)
                                                  : 0.0f;
  }
}

// z at (i, j) from the padded plane xs: the taps in row-major order, each
// a fused multiply-add, then the bias
__device__ __forceinline__ float conv_at(const float* xs, const float* ws,
                                         float bias, int i, int j, int kh,
                                         int kw, int ld) {
  float acc = 0.0f;
  for (int p = 0; p < kh; ++p)
    for (int q = 0; q < kw; ++q)
      acc = fmaf(ws[p * kw + q], xs[(i + p) * ld + j + q], acc);
  return acc + bias;
}

// shared memory: the taps, then the padded plane(s), then (backward) a
// warp's sums of each of the taps + 1 values
inline size_t smem_bytes(int T, int E, int kh, int kw, bool backward) {
  const size_t taps = (size_t)kh * kw;
  const size_t plane = (size_t)(T + kh - 1) * (E + kw - 1);
  return sizeof(float) *
         (backward ? taps + 2 * plane + kWarps * (taps + 1) : taps + plane);
}

__global__ void __launch_bounds__(kThreads)
    conv_block_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ out,
                          int* counter, int T, int E, int kh, int kw,
                          int act) {
  extern __shared__ float smem[];
  count_launch(0);
  if (counter != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *counter = 0;  // this call's backward counts its blocks from 0
  const int taps = kh * kw, ld = E + kw - 1, rows = T + kh - 1;
  const long plane = (long)T * E, n = blockIdx.x;
  float* ws = smem;
  float* xs = ws + taps;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) ws[t] = w[t];
  load_padded(xs, x + n * plane, T, E, rows, ld, (kh - 1) / 2, (kw - 1) / 2);
  __syncthreads();
  const float bias = b[0];
  for (int i = threadIdx.x; i < plane; i += blockDim.x)
    out[n * plane + i] = mmc::activation(
        conv_at(xs, ws, bias, i / E, i % E, kh, kw, ld), act);
}

__global__ void __launch_bounds__(kThreads)
    conv_block_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ dx,
                          float* __restrict__ dw, float* __restrict__ db,
                          float* part, int* counter, int T, int E, int kh,
                          int kw, int act) {
  extern __shared__ float smem[];
  __shared__ bool last;
  count_launch(1);
  const int taps = kh * kw, nv = taps + 1, ld = E + kw - 1, rows = T + kh - 1;
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;  // x's top and left pad
  const int qh = kh - 1 - ph, qw = kw - 1 - pw;    // dz's top and left pad
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long plane = (long)T * E, n = blockIdx.x;
  float* ws = smem;
  float* xs = ws + taps;        // x, padded as the forward pads it
  float* ds = xs + rows * ld;   // dz, padded for the transposed taps
  float* red = ds + rows * ld;  // (kWarps, nv): each warp's sums

  for (int t = threadIdx.x; t < taps; t += blockDim.x) ws[t] = w[t];
  load_padded(xs, x + n * plane, T, E, rows, ld, ph, pw);
  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x) {
    const int r = i / ld - qh, c = i % ld - qw;
    if (r < 0 || r >= T || c < 0 || c >= E) ds[i] = 0.0f;
  }
  __syncthreads();
  const float bias = b[0];
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int r = i / E, c = i % E;
    const float z = conv_at(xs, ws, bias, r, c, kh, kw, ld);
    ds[(r + qh) * ld + c + qw] = g[n * plane + i] * activation_grad(z, act);
  }
  __syncthreads();

  // dx: tap (p, q) of output (i, j) read x at (i + p - ph, j + q - pw), so
  // input (r, c) gathers dz at (r - p + ph, c - q + pw)
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int r = i / E, c = i % E;
    float acc = 0.0f;
    for (int p = 0; p < kh; ++p)
      for (int q = 0; q < kw; ++q)
        acc = fmaf(ws[p * kw + q],
                   ds[(r + kh - 1 - p) * ld + c + kw - 1 - q], acc);
    dx[n * plane + i] = acc;
  }

  // this plane's sums: value v < taps is dz against tap v's window of x,
  // value taps is dz alone (the bias)
  for (int v0 = 0; v0 < nv; v0 += kTapChunk) {
    float acc[kTapChunk];
    int off[kTapChunk];
#pragma unroll
    for (int k = 0; k < kTapChunk; ++k) {
      acc[k] = 0.0f;
      const int v = v0 + k;
      off[k] = v < taps ? (v / kw) * ld + v % kw : 0;
    }
    for (int i = threadIdx.x; i < plane; i += blockDim.x) {
      const int r = i / E, c = i % E;
      const float d = ds[(r + qh) * ld + c + qw];
      const float* xr = xs + r * ld + c;
#pragma unroll
      for (int k = 0; k < kTapChunk; ++k) {
        const int v = v0 + k;
        if (v < taps)
          acc[k] = fmaf(d, xr[off[k]], acc[k]);
        else if (v == taps)
          acc[k] += d;
      }
    }
#pragma unroll
    for (int k = 0; k < kTapChunk; ++k) {
      const float s = mmc::warp_sum(acc[k]);
      if (lane == 0 && v0 + k < nv) red[warp * nv + v0 + k] = s;
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[k * nv + v];
    part[n * nv + v] = s;
  }

  // the last block to finish adds every block's partials, in block order
  // within each lane and in the warp sum's order across lanes
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int v = warp; v < nv; v += kWarps) {
    float s = 0.0f;
    for (int k = lane; k < (int)gridDim.x; k += 32)
      s += __ldcg(part + (long)k * nv + v);
    s = mmc::warp_sum(s);
    if (lane == 0) {
      if (v < taps)
        dw[v] = s;
      else
        db[0] = s;
    }
  }
  if (threadIdx.x == 0) *counter = 0;  // a second backward of the call
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int N, int T, int E, int kh, int kw, int act) {
  return N < 1 || T < 1 || E < 1 || kh < 1 || kw < 1 || (act != 0 && act != 1);
}

// what an entry returns where a block's planes exceed the shared memory a
// block of the current device may have (ops/conv_block.py PLANE_TOO_LARGE)
constexpr int kPlaneTooLarge = -1;

bool too_large(size_t smem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;  // the launch reports the error
  return smem > (size_t)limit;
}

}  // namespace

extern "C" {

// the current device's launch counts of the forward and backward kernels
// into out[0], out[1] (synchronous, on the legacy default stream). Returns
// the cudaError_t (0 on success).
int mmc_conv_block_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, launch_count, sizeof(launch_count));
}

// x (N, T, E), w (kh, kw), b (1), out (N, T, E); all float32 on the
// current device; act 0 = exact GELU, 1 = mish. `counter` (one int of the
// call's own, or null where no backward follows) is set to 0 for the
// backward. Returns the cudaError_t of the launch (0 on success), or
// kPlaneTooLarge.
int mmc_conv_block_fwd(const float* x, const float* w, const float* b,
                       float* out, int* counter, int N, int T, int E, int kh,
                       int kw, int act, void* stream) {
  if (bad_shape(N, T, E, kh, kw, act)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, E, kh, kw, false);
  if (too_large(smem)) return kPlaneTooLarge;
  cudaError_t err = allow_smem(conv_block_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  conv_block_fwd_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, b, out, counter, T, E, kh, kw, act);
  return (int)cudaGetLastError();
}

// x and g (N, T, E), w (kh, kw), b (1); outputs dx (N, T, E), dw (kh, kw)
// and db (1); part holds N x (kh kw + 1) floats of scratch; counter is the
// int the same call's forward zeroed. All float32 (counter int32) on the
// current device. Returns the cudaError_t of the launch (0 on success), or
// kPlaneTooLarge.
int mmc_conv_block_bwd(const float* x, const float* g, const float* w,
                       const float* b, float* dx, float* dw, float* db,
                       float* part, int* counter, int N, int T, int E, int kh,
                       int kw, int act, void* stream) {
  if (bad_shape(N, T, E, kh, kw, act) || part == nullptr ||
      counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, E, kh, kw, true);
  if (too_large(smem)) return kPlaneTooLarge;
  cudaError_t err = allow_smem(conv_block_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  conv_block_bwd_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      x, g, w, b, dx, dw, db, part, counter, T, E, kh, kw, act);
  return (int)cudaGetLastError();
}

}  // extern "C"
