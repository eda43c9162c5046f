// Adam's update (coupled L2) of every parameter tensor of a training step,
// hand-written for Hopper, in one launch:
//   t   = step + 1                       (each tensor's own float32 count)
//   g'  = g + wd p                        (when wd != 0)
//   m   = lerp(m, g', 1 - b1)             (torch's two-sided formula)
//   v   = v b2, then v + (1 - b2) g' g'
//   s   = lr / (b1^t - 1)                 (negative), as 1 / ((b1^t - 1) / lr)
//   d   = (sqrt(v) / sqrt(1 - b2^t) + eps) / s
//   p   = p + m / d
// with every float32 operation, in its order and rounding, that PyTorch's
// capturable multi-tensor Adam (torch/optim/adam.py _multi_tensor_adam,
// capturable branch) performs: each of its steps is a kernel of its own
// there, so each product and sum is rounded where it is rounded here; the
// fused multiply-adds are those its kernels' `a + alpha * b` compile to,
// written out (fmaf), and every other operation is pinned against
// contraction (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn). lr is read
// from a device scalar, so a captured CUDA graph follows the schedule.
//
// Replaces no TPU kernel: in the JAX package optax's Adam was XLA's to
// fuse (motionmixerconv_tpu/train/optim.py). On the card torch's
// capturable Adam makes about 2N + 21 launches a step for N tensors:
// ~20 multi-tensor ones and, for the two divisions of full tensors by 0-dim
// bias-correction tensors, one broadcast kernel a tensor each, since
// _foreach_div_ has no multi-tensor route for a list of 0-dim divisors.
//
// What bounds it on the H100. A step moves 28 bytes an element (p, m, v
// read and written, g read): 5.2 MB at the AMASS MotionMixer's 184,467
// parameters, 1.5 us at 3.35 TB/s, and a few operations an element.
// Launch latency bounds it, so the design is one launch a step.
//
// Design. The wrapper passes a descriptor of every tensor (its param, grad,
// moments, step and size) by value as the kernel's argument, as PyTorch's
// multi-tensor apply does, so a captured graph bakes the step's own
// addresses; more tensors than kMaxTensors take more launches, one after
// another on the stream. The grid is the tensors' chunks of kChunk
// elements laid end to end; a block finds its tensor in the prefix of
// chunk starts (a binary search of the argument) and walks its chunk in
// 16-byte accesses where all four of its tensors are 16-byte aligned,
// element by element otherwise and in the ragged tail. Every block works
// out its tensor's bias corrections from t = step + 1 alone. A step count
// may be written only after every block of its tensor has read it, so the
// last block to finish (a thread fence and an integer count in the
// caller's own counter, as csrc/conv_block.cu sums its partials) adds 1 to
// every tensor's step and returns the count to 0: concurrent optimizers
// share no scratch, and a graph replays the launch as it is.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kVec = 4;        // floats in one 16-byte access
constexpr int kChunk = 2 * kThreads * kVec;  // elements a block updates
constexpr int kMaxTensors = 128;  // tensors one launch's argument describes
                                  // (6.7 KB: kernel arguments above 4 KB
                                  // need CUDA 12.1 and Volta or later)

struct Tensors {
  float* param[kMaxTensors];
  const float* grad[kMaxTensors];
  float* exp_avg[kMaxTensors];
  float* exp_avg_sq[kMaxTensors];
  float* step[kMaxTensors];
  long long numel[kMaxTensors];
  int chunk_start[kMaxTensors + 1];  // tensor i holds chunks
                                     // [chunk_start[i], chunk_start[i + 1])
  int n;
};

// the hyper-parameters as float32, each rounded from the double that
// torch's Python arithmetic hands its kernels (1 - b1 and 1 - b2 included)
struct Coefficients {
  float beta1, beta2, lerp_weight, sq_weight, eps, weight_decay;
  bool lerp_small;  // |1 - b1| < 0.5: torch's lerp takes its first form
};

// launches of the kernel since the library was loaded, counted on the
// device by each launch's first thread: replays of a captured CUDA graph
// run no wrapper, so only the device sees them
__device__ unsigned long long launch_count;

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coefficients& c,
                                       float step_size, float bc2_sqrt) {
  if (c.weight_decay != 0.0f) g = fmaf(c.weight_decay, p, g);
  const float diff = __fsub_rn(g, m);
  m = c.lerp_small ? fmaf(c.lerp_weight, diff, m)
                   : fmaf(-diff, __fsub_rn(1.0f, c.lerp_weight), g);
  v = __fmul_rn(v, c.beta2);
  v = fmaf(c.sq_weight, __fmul_rn(g, g), v);
  float d = __fsqrt_rn(v);
  d = __fdiv_rn(d, bc2_sqrt);
  d = __fadd_rn(d, c.eps);
  d = __fdiv_rn(d, step_size);
  p = __fadd_rn(p, __fdiv_rn(m, d));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, const Coefficients& c,
                                        float s, float b) {
  update(p.x, g.x, m.x, v.x, c, s, b);
  update(p.y, g.y, m.y, v.y, c, s, b);
  update(p.z, g.z, m.z, v.z, c, s, b);
  update(p.w, g.w, m.w, v.w, c, s, b);
}

// the tensor that holds chunk b: the last i whose chunks start at or
// before b (a tensor of no chunks shares its start with the next one)
__device__ __forceinline__ int tensor_of(const Tensors& t, int b) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Tensors t,
                const float* __restrict__ lr, const Coefficients c,
                int* counter) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&launch_count, 1ULL);
  const int b = blockIdx.x;
  if (b < t.chunk_start[t.n]) {
    const int i = tensor_of(t, b);
    float* __restrict__ p = t.param[i];
    const float* __restrict__ g = t.grad[i];
    float* __restrict__ m = t.exp_avg[i];
    float* __restrict__ v = t.exp_avg_sq[i];
    // the bias corrections as the capturable branch forms them: b1^t - 1,
    // divided by lr, its reciprocal; sqrt(-(b2^t - 1))
    const float step = __fadd_rn(*t.step[i], 1.0f);
    const float bc1 = __fdiv_rn(__fsub_rn(powf(c.beta1, step), 1.0f), *lr);
    const float step_size = __fdiv_rn(1.0f, bc1);
    const float bc2_sqrt =
        __fsqrt_rn(-__fsub_rn(powf(c.beta2, step), 1.0f));
    const long long begin = (long long)(b - t.chunk_start[i]) * kChunk;
    const long long end =
        begin + kChunk < t.numel[i] ? begin + kChunk : t.numel[i];
    long long e = begin + threadIdx.x;
    if ((((uintptr_t)p | (uintptr_t)g | (uintptr_t)m | (uintptr_t)v) &
         (sizeof(float4) - 1)) == 0) {
      const long long vec_end = begin + (end - begin) / kVec * kVec;
#pragma unroll
      for (int k = 0; k < kChunk / (kThreads * kVec); ++k) {
        const long long at =
            begin + (long long)(k * kThreads + threadIdx.x) * kVec;
        if (at < vec_end) {
          float4 pp = *reinterpret_cast<const float4*>(p + at);
          const float4 gg = __ldg(reinterpret_cast<const float4*>(g + at));
          float4 mm = *reinterpret_cast<const float4*>(m + at);
          float4 vv = *reinterpret_cast<const float4*>(v + at);
          update4(pp, gg, mm, vv, c, step_size, bc2_sqrt);
          *reinterpret_cast<float4*>(p + at) = pp;
          *reinterpret_cast<float4*>(m + at) = mm;
          *reinterpret_cast<float4*>(v + at) = vv;
        }
      }
      e = vec_end + threadIdx.x;  // the ragged tail, under kVec elements
    }
    for (; e < end; e += kThreads) {
      float pe = p[e], me = m[e], ve = v[e];
      update(pe, __ldg(g + e), me, ve, c, step_size, bc2_sqrt);
      p[e] = pe;
      m[e] = me;
      v[e] = ve;
    }
  }
  // every block has read its step; the last to get here advances them all
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int i = threadIdx.x; i < t.n; i += kThreads)
      *t.step[i] = __fadd_rn(*t.step[i], 1.0f);
    if (threadIdx.x == 0) *counter = 0;
  }
}

}  // namespace

extern "C" {

// the most tensors one launch takes; the wrapper launches again for more
int mmc_adam_max_tensors(void) { return kMaxTensors; }

// the current device's launch count of the kernel into out[0] (synchronous,
// on the legacy default stream). Returns the cudaError_t (0 on success).
int mmc_adam_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, launch_count, sizeof(launch_count));
}

// One Adam step of n (1..kMaxTensors) tensors: params[i], grads[i],
// exp_avgs[i] and exp_avg_sqs[i] of numels[i] float32 elements each, and
// steps[i] one float32; lr one float32; all on the current device. The
// hyper-parameters are the doubles torch's optimizer holds. counter is one
// int of the caller's own, 0 before the launch and 0 again after it.
// Returns the cudaError_t of the launch (0 on success).
int mmc_adam(float* const* params, const float* const* grads,
             float* const* exp_avgs, float* const* exp_avg_sqs,
             float* const* steps, const long long* numels, int n,
             const float* lr, double beta1, double beta2, double eps,
             double weight_decay, int* counter, void* stream) {
  if (n < 1 || n > kMaxTensors || lr == nullptr || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  Tensors t = {};
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    if (numels[i] < 0) return (int)cudaErrorInvalidValue;
    t.param[i] = params[i];
    t.grad[i] = grads[i];
    t.exp_avg[i] = exp_avgs[i];
    t.exp_avg_sq[i] = exp_avg_sqs[i];
    t.step[i] = steps[i];
    t.numel[i] = numels[i];
    t.chunk_start[i] = (int)chunks;
    chunks += (numels[i] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  t.chunk_start[n] = (int)chunks;
  t.n = n;
  const float lerp_weight = (float)(1.0 - beta1);
  const Coefficients c = {(float)beta1,  (float)beta2,
                          lerp_weight,   (float)(1.0 - beta2),
                          (float)eps,    (float)weight_decay,
                          fabsf(lerp_weight) < 0.5f};
  // a launch of only empty tensors still advances their steps
  const int grid = chunks > 0 ? (int)chunks : 1;
  adam_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, lr, c, counter);
  return (int)cudaGetLastError();
}

}  // extern "C"
