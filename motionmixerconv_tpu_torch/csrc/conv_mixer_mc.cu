// Fused multi-channel ConvMixer core (inference), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_conv_mixer_mc_kernel`
// (motionmixerconv_tpu/ops/pallas_conv_mixer.py, called from
// FusedConvMixerMC._run). Computes, after the PoseEncoder, for every sample
// with activations (C, T, E) (conv_nChan, in_nTP, dimPosEmb):
//   num_blocks x [ LN(E) per (c, t) row -> C x C 'same' (kh, kw) Conv2d over
//                  (T, E) + bias -> act -> per-channel BN affine -> shared SE
//                  gate over T (squeeze: mean or max over (C, E)) -> residual,
//                  twice (or the 'once' identity branch + shared SE) ]
//   -> LN(E) -> T->P time projection per channel (+ bias) -> C->1 channel
//   projection (+ bias) -> exact GELU -> fc_out (E -> D).
//
// What bounds it on the H100: the convolutions. Each output element needs
// C multiply-adds per tap inside the plane; at the autoregressive shape
// (C=8, T=10, E=192, (5,5) kernels, 4 blocks, twice; 44 of 50 row taps and
// 954 of 960 column taps in plane) that is ~43 MFLOP per sample against
// ~61 KB in and 1.3 KB out, so it is bound by the f32 rate (67 TFLOP/s), not
// by memory. The TPU kernel turns each conv into kw MXU matmuls against
// (R, R) block-Toeplitz matrices (128 KB per conv at that shape, for 1,600
// real weights); here the conv is a direct stencil over the real weights.
//
// Design: one thread block of 512 threads per sample. The residual stream
// y (C, T, E), the LN output z and the branch output c sit in shared memory
// (3 x 60 KB at the autoregressive shape); z carries a zero halo of the
// convs' E padding on each row, so no column tap is ever clipped. Each
// block's weights (~16 KB there) are staged into shared memory as the block
// starts. The convs are bound by shared-memory wavefronts: a tap's 8 output
// channels' weights are two broadcast float4 loads, as dear as 8 scalar
// loads. So a warp owns a tile of 2 rows x 64 columns x 8 output channels
// and a lane its 2 x 2 positions (columns e and e + 32, neighbouring lanes
// on neighbouring columns): per tap it loads the weights once and 4
// activations, then does 32 FMAs from registers. Row taps outside the plane
// are skipped per row (the same for the whole warp). The decoder reads its
// weights (fc_out ~50 KB) through the read-only cache. Device memory is
// touched once per input, weight and output element.
//
// Packed weight layout (floats; must match ops/conv_mixer_mc.py `layout`),
// with cp = C rounded up to a multiple of 8:
//   per block (stride block_stride): ln1_g[E] ln1_b[E] ln2_g[E] ln2_b[E]
//     w1[C][kh1][kw1][cp] w2[C][kh2][kw2][cp]   (input channel major, output
//                                                channel fastest, zero padded)
//     scal[6][cp] = {conv1 bias, bn1 scale, bn1 shift, conv2 bias, bn2 scale,
//                    bn2 shift}
//     se_w1[T*H] (t*H + j), se_w2[H*T] (j*T + t)
//   then: g_ln[E] b_ln[E] w_time[T*P] (t*P + p) b_time[P] w_chan[C]
//         b_proj[1] w_out[E*D] (e*D + o) b_out[D]

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

using mmc::activation;
using mmc::gelu_exact;
using mmc::layer_norm_rows;
using mmc::warp_max;
using mmc::warp_sum;

constexpr int kThreads = 512;
constexpr int kCoTile = 8;  // output channels per lane and conv task
constexpr int kRows = 2;    // rows per lane and conv task
constexpr int kCols = 2;    // columns per lane and conv task, 32 apart

struct Dims {
  int C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act;
};

__host__ __device__ inline int padded_channels(int C) {
  return (C + kCoTile - 1) / kCoTile * kCoTile;
}

__host__ __device__ inline long block_stride(const Dims& d) {
  const long cp = padded_channels(d.C);
  return 4L * d.E + (long)d.C * d.kh1 * d.kw1 * cp +
         (long)d.C * d.kh2 * d.kw2 * cp + 6 * cp + 2L * d.T * d.H;
}

__host__ __device__ inline long weights_numel(const Dims& d) {
  return d.nb * block_stride(d) + 2L * d.E + (long)d.T * d.P + d.P + d.C + 1 +
         (long)d.E * d.D + d.D;
}

// the staged block weights, rounded up to a float4 boundary
__host__ __device__ inline long staged_floats(const Dims& d) {
  return (block_stride(d) + 3) / 4 * 4;
}

__host__ __device__ inline long plane_floats(const Dims& d) {
  return (long)d.C * d.T * d.E;
}

// the zero halo of the LN output's rows: the convs' largest left and right
// 'same' padding over E
__host__ __device__ inline int halo_left(const Dims& d) {
  return max((d.kw1 - 1) / 2, (d.kw2 - 1) / 2);
}

__host__ __device__ inline int z_stride(const Dims& d) {
  const int right = max(d.kw1 - 1 - (d.kw1 - 1) / 2, d.kw2 - 1 - (d.kw2 - 1) / 2);
  return d.E + halo_left(d) + right;
}

__host__ inline size_t smem_bytes(const Dims& d) {
  const long plane = plane_floats(d), dec = (long)d.P * d.E;
  return sizeof(float) * (size_t)(staged_floats(d) + plane +
                                  (long)d.C * d.T * z_stride(d) +
                                  (plane > dec ? plane : dec) + 2L * d.T +
                                  (d.H > 0 ? d.H : 1));
}

// out[co, t, e] = act(bias[co] + sum_{ci, dt, de} w[ci][dt][de][co] *
//                 in[ci, t + dt - ph, e + de - pw]) * bn_s[co] + bn_t[co],
// with torch's 'same' padding (left pad floor((k-1)/2), the extra pad on the
// right); taps outside the plane contribute zero. ``z`` is the input plane
// with rows of stride ``zs`` whose column e sits at e + ``pl``, zero outside
// [0, E). No barrier.
__device__ void conv_mc(const float* __restrict__ z, int zs, int pl,
                        float* __restrict__ out, const float* __restrict__ w,
                        const float* bias, const float* bn_s,
                        const float* bn_t, int C, int T, int E, int kh,
                        int kw, int act) {
  const int cp = padded_channels(C);
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int col_tiles = (E + 32 * kCols - 1) / (32 * kCols);
  const int row_tiles = (T + kRows - 1) / kRows;
  const int n_tasks = cp / kCoTile * row_tiles * col_tiles;
  for (int task = warp; task < n_tasks; task += n_warps) {
    const int co0 = task / (row_tiles * col_tiles) * kCoTile;
    const int t0 = task / col_tiles % row_tiles * kRows;
    const int e0 = task % col_tiles * 32 * kCols + lane;
    // a lane past the last column reads a valid one and stores nothing
    int col[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      col[j] = min(e0 + 32 * j, E - 1) + pl - pw;
    float acc[kRows][kCols][kCoTile];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int k = 0; k < kCoTile; ++k) acc[i][j][k] = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      for (int dt = 0; dt < kh; ++dt) {
        // this tap's input row for each of the task's output rows; a row
        // outside the plane reads row 0 and adds nothing
        bool ok[kRows];
        const float* zr[kRows];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = t0 + i + dt - ph;
          ok[i] = r >= 0 && r < T;
          zr[i] = z + (ci * T + (ok[i] ? r : 0)) * zs;
          any = any || ok[i];
        }
        if (!any) continue;
        const float* wr = w + ((ci * kh + dt) * kw) * cp + co0;
        for (int de = 0; de < kw; ++de) {
          const float4 wa = *reinterpret_cast<const float4*>(wr + de * cp);
          const float4 wb = *reinterpret_cast<const float4*>(wr + de * cp + 4);
          const float wk[kCoTile] = {wa.x, wa.y, wa.z, wa.w,
                                     wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              const float v = ok[i] ? zr[i][col[j] + de] : 0.0f;
#pragma unroll
              for (int k = 0; k < kCoTile; ++k)
                acc[i][j][k] = fmaf(v, wk[k], acc[i][j][k]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int k = 0; k < kCoTile; ++k) {
          const int co = co0 + k, t = t0 + i, e = e0 + 32 * j;
          if (co < C && t < T && e < E)
            out[(co * T + t) * E + e] =
                activation(acc[i][j][k] + bias[co], act) * bn_s[co] + bn_t[co];
        }
  }
}

// gate[t] = sigmoid(W2^T relu(W1^T squeeze(c)))[t], the squeeze being the
// mean over (C, E) or the max over it. Ends with a barrier.
__device__ void se_gate_mc(const float* c, const float* w1, const float* w2,
                           float* sq, float* gate, float* hid, int C, int T,
                           int E, int H, int use_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int CE = C * E;
  for (int t = warp; t < T; t += n_warps) {
    if (use_max) {
      float m = -INFINITY;
      for (int i = lane; i < CE; i += 32) {
        const int ci = i / E, e = i - ci * E;
        m = fmaxf(m, c[(ci * T + t) * E + e]);
      }
      m = warp_max(m);
      if (lane == 0) sq[t] = m;
    } else {
      float s = 0.0f;
      for (int i = lane; i < CE; i += 32) {
        const int ci = i / E, e = i - ci * E;
        s += c[(ci * T + t) * E + e];
      }
      s = warp_sum(s);
      if (lane == 0) sq[t] = s / CE;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float h = 0.0f;
    for (int t = 0; t < T; ++t) h += sq[t] * w1[t * H + j];
    hid[j] = fmaxf(h, 0.0f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float z = 0.0f;
    for (int j = 0; j < H; ++j) z += hid[j] * w2[j * T + t];
    gate[t] = 1.0f / (1.0f + expf(-z));
  }
  __syncthreads();
}

// y += c (times the SE gate of c when SE is on). Ends with a barrier.
__device__ void residual(float* y, const float* c, const float* se_w1,
                         const float* se_w2, float* sq, float* gate,
                         float* hid, const Dims& d) {
  const int n = d.C * d.T * d.E;
  if (d.use_se) {
    se_gate_mc(c, se_w1, se_w2, sq, gate, hid, d.C, d.T, d.E, d.H, d.use_max);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      y[i] += c[i] * gate[(i / d.E) % d.T];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] += c[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
conv_mixer_mc_kernel(const float* __restrict__ yin,
                     const float* __restrict__ w, float* __restrict__ out,
                     Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int C = d.C, T = d.T, E = d.E, P = d.P, D = d.D;
  const int rows = C * T;
  const long plane = plane_floats(d);
  const long bs = block_stride(d);
  const int cp = padded_channels(C);
  const int zs = z_stride(d), pl = halo_left(d);
  float* sw = smem;                   // this block's weights
  float* y = sw + staged_floats(d);   // residual stream (C, T, E)
  float* z = y + plane;               // LN output (C, T, zs), zero halo
  float* c = z + (long)rows * zs;     // branch output (C, T, E); decoder (P, E)
  float* sq = c + (plane > (long)P * E ? plane : (long)P * E);  // SE squeeze (T)
  float* gate = sq + T;               // SE gate (T)
  float* hid = gate + T;              // SE hidden (max(H, 1))

  const long b = blockIdx.x;
  for (long i = threadIdx.x; i < plane; i += kThreads) y[i] = yin[b * plane + i];
  for (long i = threadIdx.x; i < (long)rows * zs; i += kThreads) z[i] = 0.0f;

  for (int blk = 0; blk < d.nb; ++blk) {
    __syncthreads();  // the previous block's readers of sw are done
    const float* gw = w + blk * bs;
    for (long i = threadIdx.x; i < bs; i += kThreads) sw[i] = gw[i];
    __syncthreads();
    const float* ln1_g = sw;
    const float* ln1_b = ln1_g + E;
    const float* ln2_g = ln1_b + E;
    const float* ln2_b = ln2_g + E;
    const float* w1 = ln2_b + E;
    const float* w2 = w1 + C * d.kh1 * d.kw1 * cp;
    const float* scal = w2 + C * d.kh2 * d.kw2 * cp;
    const float* se_w1 = scal + 6 * cp;
    const float* se_w2 = se_w1 + T * d.H;

    layer_norm_rows(y, z + pl, ln1_g, ln1_b, rows, E, zs);
    __syncthreads();
    conv_mc(z, zs, pl, c, w1, scal, scal + cp, scal + 2 * cp, C, T, E, d.kh1,
            d.kw1, d.act);
    __syncthreads();
    residual(y, c, se_w1, se_w2, sq, gate, hid, d);

    if (d.twice) {
      layer_norm_rows(y, z + pl, ln2_g, ln2_b, rows, E, zs);
      __syncthreads();
      conv_mc(z, zs, pl, c, w2, scal + 3 * cp, scal + 4 * cp, scal + 5 * cp, C,
              T, E, d.kh2, d.kw2, d.act);
    } else {
      // 'once': LN2/conv2 are identity, the shared SE still applies
      for (long i = threadIdx.x; i < plane; i += kThreads) c[i] = y[i];
    }
    __syncthreads();
    residual(y, c, se_w1, se_w2, sq, gate, hid, d);
  }

  const float* g_ln = w + d.nb * bs;
  const float* b_ln = g_ln + E;
  const float* w_time = b_ln + E;
  const float* b_time = w_time + T * P;
  const float* w_chan = b_time + P;
  const float* b_proj = w_chan + C;
  const float* w_out = b_proj + 1;
  const float* b_out = w_out + E * D;

  layer_norm_rows(y, z + pl, g_ln, b_ln, rows, E, zs);
  __syncthreads();
  // per channel: time projection T -> P plus its bias; then the channel
  // projection C -> 1 plus its bias and exact GELU (the decoder's
  // activation is GELU whatever the blocks use)
  for (int idx = threadIdx.x; idx < P * E; idx += kThreads) {
    const int p = idx / E, e = idx - p * E;
    float acc = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      float s = 0.0f;
      for (int t = 0; t < T; ++t)
        s += z[(ci * T + t) * zs + pl + e] * __ldg(w_time + t * P + p);
      acc += __ldg(w_chan + ci) * (s + __ldg(b_time + p));
    }
    c[idx] = gelu_exact(acc + __ldg(b_proj));
  }
  __syncthreads();
  float* ob = out + b * P * D;
  for (int idx = threadIdx.x; idx < P * D; idx += kThreads) {
    const int p = idx / D, o = idx - p * D;
    const float* dr = c + p * E;
    float acc = 0.0f;
    for (int e = 0; e < E; ++e) acc += dr[e] * __ldg(w_out + e * D + o);
    ob[idx] = acc + __ldg(b_out + o);
  }
}

}  // namespace

extern "C" {

long mmc_conv_mixer_mc_weights_numel(int C, int T, int E, int P, int D, int H,
                                     int nb, int kh1, int kw1, int kh2,
                                     int kw2) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return weights_numel(d);
}

long mmc_conv_mixer_mc_smem_bytes(int C, int T, int E, int P, int D, int H,
                                  int nb, int kh1, int kw1, int kh2, int kw2) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return (long)smem_bytes(d);
}

// y (B, C, T, E), w packed weights, out (B, P, D); all float32 on the
// current device. Returns the cudaError_t of the launch (0 on success).
int mmc_conv_mixer_mc(const float* y, const float* w, float* out, int B, int C,
                      int T, int E, int P, int D, int H, int nb, int kh1,
                      int kw1, int kh2, int kw2, int twice, int use_se,
                      int use_max, int act, void* stream) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act};
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      conv_mixer_mc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_mixer_mc_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(y, w, out,
                                                                    d);
  return (int)cudaGetLastError();
}

}  // extern "C"
