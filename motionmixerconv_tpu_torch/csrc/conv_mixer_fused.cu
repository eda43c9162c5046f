// Fused single-channel ConvMixer core (inference), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_conv_mixer_kernel`
// (motionmixerconv_tpu/ops/pallas_conv_mixer.py, called from
// FusedConvMixer._run). Computes, after the PoseEncoder, for every sample:
//   num_blocks x [ LN(E) -> 'same' (kh,kw) stencil -> act -> BN affine
//                  -> SE gate -> residual, twice (or the 'once' identity
//                  branch + shared SE) ]
//   -> LN(E) -> T->P time matmul -> scalar channel projection -> exact GELU
//   -> fc_out (E -> D).
//
// What bounds it on the H100: at the flagship shape (T=10, E=50, P=25,
// D=66, 4 blocks) a sample is ~0.3 MFLOP over 2 KB in and 6.6 KB out, so
// neither the 3.35 TB/s memory nor the 67 TFLOP/s f32 rate is close; the
// chain of ~40 dependent steps per sample (each ending in a block barrier),
// run by one block of 8 warps per SM with little to hide latency behind,
// sets the time, which is therefore flat in the batch up to one block per SM.
//
// Design: one thread block per sample. The sample's (T, E) activation, two
// scratch planes and every packed weight (about 19 KB at the flagship shape)
// sit in shared memory, so device memory is touched once per input and
// weight element and once per output element. LayerNorm and the SE squeeze
// use one warp per time row with shuffle reductions; the stencil, the
// decoder's matmuls and the gate are one thread per output element.
//
// Packed weight layout (floats; must match ops/conv_mixer.py `_layout`):
//   per block (stride block_stride): ln1_g[E] ln1_b[E] ln2_g[E] ln2_b[E]
//     taps1[kh1*kw1] taps2[kh2*kw2]
//     scal[6] = {conv1 bias, bn1 scale, bn1 shift, conv2 bias, bn2 scale, bn2 shift}
//     se_w1[T*H] (t*H + j), se_w2[H*T] (j*T + t)
//   then: g_ln[E] b_ln[E] w_time[T*P] (t*P + p) b_time[P] proj[2]
//         w_out[E*D] (e*D + o) b_out[D]

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

using mmc::activation;
using mmc::gelu_exact;
using mmc::layer_norm_rows;
using mmc::warp_max;
using mmc::warp_sum;

struct Dims {
  int T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act;
};

__host__ __device__ inline long block_stride(const Dims& d) {
  return 4L * d.E + d.kh1 * d.kw1 + d.kh2 * d.kw2 + 6 + 2L * d.T * d.H;
}

__host__ __device__ inline long weights_numel(const Dims& d) {
  return d.nb * block_stride(d) + 2L * d.E + (long)d.T * d.P + d.P + 2 +
         (long)d.E * d.D + d.D;
}

__host__ inline size_t smem_bytes(const Dims& d) {
  long hid = d.H > 0 ? d.H : 1;
  return sizeof(float) * (size_t)(weights_numel(d) + 3L * d.T * d.E +
                                  2L * d.T + hid + (long)d.P * d.E);
}

constexpr int kThreads = 256;

// 'same' (kh over T, kw over E) stencil with torch's padding (left pad
// floor((k-1)/2), the extra pad on the right); taps outside the plane
// contribute zero. Then bias, activation and the inference BN affine.
__device__ void conv_same_act_bn(const float* in, float* out,
                                 const float* taps, int kh, int kw,
                                 float bias, float bn_s, float bn_t, int T,
                                 int E, int act) {
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  for (int idx = threadIdx.x; idx < T * E; idx += kThreads) {
    const int t = idx / E, e = idx - t * E;
    float acc = 0.0f;
    for (int dt = 0; dt < kh; ++dt) {
      const int tt = t + dt - ph;
      if (tt < 0 || tt >= T) continue;
      for (int de = 0; de < kw; ++de) {
        const int ee = e + de - pw;
        if (ee < 0 || ee >= E) continue;
        acc += taps[dt * kw + de] * in[tt * E + ee];
      }
    }
    out[idx] = activation(acc + bias, act) * bn_s + bn_t;
  }
}

// c[t, :] *= sigmoid(W2^T relu(W1^T squeeze(c)))[t]; squeeze is the mean
// over the true E or the max over it. Ends with a barrier.
__device__ void se_gate(float* c, const float* w1, const float* w2, float* sq,
                        float* gate, float* hid, int T, int E, int H,
                        int use_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += kThreads / 32) {
    const float* r = c + t * E;
    if (use_max) {
      float m = -INFINITY;
      for (int e = lane; e < E; e += 32) m = fmaxf(m, r[e]);
      m = warp_max(m);
      if (lane == 0) sq[t] = m;
    } else {
      float s = 0.0f;
      for (int e = lane; e < E; e += 32) s += r[e];
      s = warp_sum(s);
      if (lane == 0) sq[t] = s / E;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float h = 0.0f;
    for (int t = 0; t < T; ++t) h += sq[t] * w1[t * H + j];
    hid[j] = fmaxf(h, 0.0f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += kThreads) {
    float z = 0.0f;
    for (int j = 0; j < H; ++j) z += hid[j] * w2[j * T + t];
    gate[t] = 1.0f / (1.0f + expf(-z));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * E; idx += kThreads) c[idx] *= gate[idx / E];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
conv_mixer_fused_kernel(const float* __restrict__ yin,
                        const float* __restrict__ w,
                        float* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const int T = d.T, E = d.E, P = d.P, D = d.D, H = d.H;
  const long nw = weights_numel(d);
  float* sw = smem;
  float* y = sw + nw;        // residual stream (T, E)
  float* z = y + T * E;      // LN output (T, E)
  float* c = z + T * E;      // branch output (T, E)
  float* sq = c + T * E;     // SE squeeze (T)
  float* gate = sq + T;      // SE gate (T)
  float* hid = gate + T;     // SE hidden (max(H, 1))
  float* dec = hid + (H > 0 ? H : 1);  // decoder plane (P, E)

  const long b = blockIdx.x;
  for (long i = threadIdx.x; i < nw; i += kThreads) sw[i] = w[i];
  for (int i = threadIdx.x; i < T * E; i += kThreads) y[i] = yin[b * T * E + i];
  __syncthreads();

  const long bs = block_stride(d);
  for (int blk = 0; blk < d.nb; ++blk) {
    const float* bw = sw + blk * bs;
    const float* ln1_g = bw;
    const float* ln1_b = ln1_g + E;
    const float* ln2_g = ln1_b + E;
    const float* ln2_b = ln2_g + E;
    const float* taps1 = ln2_b + E;
    const float* taps2 = taps1 + d.kh1 * d.kw1;
    const float* scal = taps2 + d.kh2 * d.kw2;
    const float* se_w1 = scal + 6;
    const float* se_w2 = se_w1 + T * H;

    layer_norm_rows(y, z, ln1_g, ln1_b, T, E, E);
    __syncthreads();
    conv_same_act_bn(z, c, taps1, d.kh1, d.kw1, scal[0], scal[1], scal[2], T,
                     E, d.act);
    __syncthreads();
    if (d.use_se) se_gate(c, se_w1, se_w2, sq, gate, hid, T, E, H, d.use_max);
    for (int i = threadIdx.x; i < T * E; i += kThreads) y[i] += c[i];
    __syncthreads();

    if (d.twice) {
      layer_norm_rows(y, z, ln2_g, ln2_b, T, E, E);
      __syncthreads();
      conv_same_act_bn(z, c, taps2, d.kh2, d.kw2, scal[3], scal[4], scal[5],
                       T, E, d.act);
    } else {
      // 'once': LN2/conv2 are identity, the shared SE still applies
      for (int i = threadIdx.x; i < T * E; i += kThreads) c[i] = y[i];
    }
    __syncthreads();
    if (d.use_se) se_gate(c, se_w1, se_w2, sq, gate, hid, T, E, H, d.use_max);
    for (int i = threadIdx.x; i < T * E; i += kThreads) y[i] += c[i];
    __syncthreads();
  }

  const float* g_ln = sw + d.nb * bs;
  const float* b_ln = g_ln + E;
  const float* w_time = b_ln + E;
  const float* b_time = w_time + T * P;
  const float* proj = b_time + P;
  const float* w_out = proj + 2;
  const float* b_out = w_out + E * D;

  layer_norm_rows(y, z, g_ln, b_ln, T, E, E);
  __syncthreads();
  // time upsample T -> P, scalar channel projection, exact GELU (the
  // decoder's activation is GELU whatever the blocks use)
  for (int idx = threadIdx.x; idx < P * E; idx += kThreads) {
    const int p = idx / E, e = idx - p * E;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) acc += z[t * E + e] * w_time[t * P + p];
    dec[idx] = gelu_exact((acc + b_time[p]) * proj[0] + proj[1]);
  }
  __syncthreads();
  float* ob = out + b * P * D;
  for (int idx = threadIdx.x; idx < P * D; idx += kThreads) {
    const int p = idx / D, o = idx - p * D;
    const float* dr = dec + p * E;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e) acc += dr[e] * w_out[e * D + o];
    ob[idx] = acc + b_out[o];
  }
}

}  // namespace

extern "C" {

long mmc_conv_mixer_weights_numel(int T, int E, int P, int D, int H, int nb,
                                  int kh1, int kw1, int kh2, int kw2) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return weights_numel(d);
}

long mmc_conv_mixer_smem_bytes(int T, int E, int P, int D, int H, int nb,
                               int kh1, int kw1, int kh2, int kw2) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return (long)smem_bytes(d);
}

// y (B, T, E), w packed weights, out (B, P, D); all float32 on the current
// device. Returns the cudaError_t of the launch (0 on success).
int mmc_conv_mixer_fused(const float* y, const float* w, float* out, int B,
                         int T, int E, int P, int D, int H, int nb, int kh1,
                         int kw1, int kh2, int kw2, int twice, int use_se,
                         int use_max, int act, void* stream) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act};
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      conv_mixer_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_mixer_fused_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(y, w,
                                                                       out, d);
  return (int)cudaGetLastError();
}

const char* mmc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
