// Device helpers shared by the fused kernels (conv_mixer_fused.cu,
// conv_mixer_mc.cu, mlp_mixer_fused.cu): warp reductions, the activations
// with the reference's numerics (precise erff/expf/log1pf/tanhf, no fast
// math), the row-wise LayerNorm, and a block-wide asynchronous copy from
// device memory into shared memory. Counterparts of `_act` and `_erf` in
// motionmixerconv_tpu/ops/pallas_mixer.py; CUDA has a precise erff, so the
// Pallas polynomial stand-in is not needed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmc {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// act: 0 = exact GELU, 1 = mish with the overflow-free softplus
__device__ __forceinline__ float activation(float x, int act) {
  if (act == 1) {
    float sp = log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
    return x * tanhf(sp);
  }
  return gelu_exact(x);
}

// out[r * out_stride + e] = LN(in[r, :])[e] * g[e] + b[e] over E (eps
// 1e-5) for rows 0..rows-1, in dense (rows, E); one warp per row. No
// barrier.
__device__ inline void layer_norm_rows(const float* in, float* out,
                                       const float* g, const float* b,
                                       int rows, int E, int out_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const float* row = in + (long)r * E;
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) s += row[e];
    const float mu = warp_sum(s) / E;
    float v = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float dv = row[e] - mu;
      v += dv * dv;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / E + 1e-5f);
    for (int e = lane; e < E; e += 32)
      out[(long)r * out_stride + e] = (row[e] - mu) * inv * g[e] + b[e];
  }
}

// dst[r * dld + j] = src[r * sld + j] for r < rows, j < cols: shared
// memory from device memory, by the whole block with cp.async (4 bytes a
// copy), every copy in flight at once; complete after copy_async_wait() and
// a barrier.
__device__ inline void copy_rows_async(float* dst, int dld,
                                       const float* __restrict__ src, long sld,
                                       int rows, int cols) {
  auto copy = [](float* to, const float* from) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(to)),
                 "l"(from)
                 : "memory");
  };
  if (rows == 1) {  // the whole block along the one row
    for (int j = threadIdx.x; j < cols; j += blockDim.x) copy(dst + j, src + j);
    return;
  }
  // a warp a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += blockDim.x >> 5)
    for (int j = lane; j < cols; j += 32)
      copy(dst + (long)r * dld + j, src + r * sld + j);
}

// this thread's cp.async copies are done
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace mmc
