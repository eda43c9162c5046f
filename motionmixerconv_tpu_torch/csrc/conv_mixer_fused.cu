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
// neither the 3.35 TB/s memory nor the 67 TFLOP/s f32 rate is close. A
// sample is a chain of dependent steps (LayerNorm, stencil, SE, residual,
// per branch), so its time is the length of that chain: how many
// synchronisations it passes and how many dependent instructions a warp
// issues between them.
//
// Design: one block a sample, of W warps (the wrapper's `b2_plan` picks W
// = min(T, 16)). Warp i owns the time rows t = i, i + W, ... of the
// sample's planes and, in the decoder, the rows p = i, i + W, ... of the
// (P, E) plane, so LayerNorm, the stencil's row, the activation, the SE
// squeeze (fused into the stencil pass, reduced by shuffles), the gate and
// the residual of a row are one warp's work, ordered by __syncwarp. The
// warps meet at a block barrier only where a row needs another warp's
// rows:
//   - after a LayerNorm whose stencil spans rows (kh > 1);
//   - after a stencil, when SE needs every row's squeeze (or, without SE,
//     before the next LayerNorm overwrites rows a neighbour still reads);
//   - before the decoder's time matmul, which reads every row.
// The SE MLP is tiny (T -> T/r -> T) and every warp computes what its rows
// need. At the flagship shape (kh 1 then 3, SE, 'twice') a sample passes 13
// of these barriers and one after the weight load, where the kernel before
// it passed ~59. The block loads the packed weights (about 19 KB at the
// flagship shape) and the sample's input into shared memory with
// cp.async. Shared-memory loads: the stencil reads a tap and an activation
// per multiply-add (2 a multiply-add; 3 taps an output at the flagship's
// (1,3) and (3,1)); fc_out, the largest contraction, takes up to 4 rows x
// 4 columns a lane (3 x 3 at the flagship: 6 loads per 9 multiply-adds).
// LayerNorm takes its mean and variance in one pass of sums shifted by the
// row's first value. No float atomics: repeats are bit-identical.
//
// Shared memory (floats): the packed weights; z (T, E), the LayerNorm
// output; y (T, E), the residual stream, then c (T, E), the branch output,
// whose space the decoder's (P, E) plane takes over (max(2 T E, P E)); the
// SE squeeze, double-buffered (2 T). This is less than the planes of the
// kernel before it, so every shape it took still fits.
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

// a sample's shared floats: z (T, E); y (T, E) then c (T, E), later the
// decoder's (P, E) plane; the SE squeeze, double-buffered (2 T)
__host__ __device__ inline long sample_floats(const Dims& d) {
  const long te = (long)d.T * d.E, pe = (long)d.P * d.E;
  return te + (2 * te > pe ? 2 * te : pe) + 2L * d.T;
}

__host__ inline size_t smem_bytes(const Dims& d) {
  return sizeof(float) * (size_t)(weights_numel(d) + sample_floats(d));
}

constexpr int kMaxWarps = 16;

// The block's warps: warp wi of W owns the rows wi, wi + W, ...
struct Group {
  int wi, W, lane;
  __device__ __forceinline__ void sync() const {
    if (W == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

// z[t, :] = LN(y[t, :]) g + b over E (eps 1e-5) for this warp's rows. One
// pass of sums shifted by the row's first element x0 (both reduced by one
// interleaved round of shuffles): with u = x - x0, mean - x0 = S1 / E and
// var = S2 / E - (S1 / E)^2, which loses no more than ~(E + 1) ulps of var
// to cancellation since x0 lies in the row (var >= (x0 - mean)^2 / E);
// the output is (u - S1 / E) / sd, so a large common offset is never
// rounded into the mean.
__device__ __forceinline__ void layer_norm_rows(const Group& g, const float* y, float* z,
                                const float* gam, const float* bet,
                                const Dims& d) {
  const int E = d.E;
  const float inv_e = 1.0f / E;
  for (int t = g.wi; t < d.T; t += g.W) {
    const float* row = y + t * E;
    const float x0 = row[0];
    float s = 0.0f, q = 0.0f;
#pragma unroll 4
    for (int e = g.lane; e < E; e += 32) {
      const float u = row[e] - x0;
      s += u;
      q = fmaf(u, u, q);
    }
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    const float m = s * inv_e;  // mean - x0
    const float inv = 1.0f / sqrtf(fmaxf(q * inv_e - m * m, 0.0f) + 1e-5f);
    for (int e = g.lane; e < E; e += 32)
      z[t * E + e] = ((row[e] - x0) - m) * inv * gam[e] + bet[e];
  }
}

// sq[t] = mean or max of v over a row, from each lane's partial
__device__ __forceinline__ void squeeze_out(const Group& g, float part,
                                            float* sq, int t, const Dims& d) {
  part = d.use_max ? warp_max(part) : warp_sum(part) / d.E;
  if (g.lane == 0) sq[t] = part;
}

// the stencil at (t, e) with torch's padding (left pad floor((k-1)/2), the
// extra pad on the right; taps outside the plane add nothing)
__device__ __forceinline__ float stencil(const float* z, const float* taps,
                                         int kh, int kw, int t, int e,
                                         const Dims& d) {
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int dt0 = max(0, ph - t), dt1 = min(kh, d.T + ph - t);
  const int de0 = max(0, pw - e), de1 = min(kw, d.E + pw - e);
  float acc = 0.0f;
  for (int dt = dt0; dt < dt1; ++dt) {
    const float* zr = z + (t + dt - ph) * d.E + e - pw;
    const float* tr = taps + dt * kw;
    for (int de = de0; de < de1; ++de) acc = fmaf(tr[de], zr[de], acc);
  }
  return acc;
}

// For this warp's rows: c[t, e] = act(stencil(z)[t, e] + bias) * bn_s +
// bn_t; with SE, the row's squeeze into sq[t]. A lane takes its columns
// two at a time (e and e + 32), so the two activations' dependent chains
// overlap; a second column past E repeats the first and is dropped.
__device__ __forceinline__ void conv_rows(const Group& g, const float* z, float* c,
                          float* sq, const float* taps, int kh, int kw,
                          const float* sc, const Dims& d) {
  const int T = d.T, E = d.E;
  for (int t = g.wi; t < T; t += g.W) {
    float part = d.use_max ? -INFINITY : 0.0f;
    for (int e = g.lane; e < E; e += 64) {
      const bool two = e + 32 < E;
      const float a0 = stencil(z, taps, kh, kw, t, e, d);
      const float a1 = stencil(z, taps, kh, kw, t, two ? e + 32 : e, d);
      const float v0 = activation(a0 + sc[0], d.act) * sc[1] + sc[2];
      const float v1 = activation(a1 + sc[0], d.act) * sc[1] + sc[2];
      c[t * E + e] = v0;
      part = d.use_max ? fmaxf(part, v0) : part + v0;
      if (two) {
        c[t * E + e + 32] = v1;
        part = d.use_max ? fmaxf(part, v1) : part + v1;
      }
    }
    if (d.use_se) squeeze_out(g, part, sq, t, d);
  }
}

// the SE squeeze of this warp's rows of v (the 'once' branch's identity)
__device__ __forceinline__ void squeeze_rows(const Group& g, const float* v, float* sq,
                             const Dims& d) {
  for (int t = g.wi; t < d.T; t += g.W) {
    float part = d.use_max ? -INFINITY : 0.0f;
    for (int e = g.lane; e < d.E; e += 32)
      part = d.use_max ? fmaxf(part, v[t * d.E + e]) : part + v[t * d.E + e];
    squeeze_out(g, part, sq, t, d);
  }
}

// For this warp's rows: y[t, :] += c[t, :] * gate[t], gate =
// sigmoid(W2^T relu(W1^T sq)) from every row's squeeze (without SE: y +=
// c). c may be y.
__device__ __forceinline__ void gated_residual(const Group& g, float* y, const float* c,
                               const float* sq, const float* w1,
                               const float* w2, const Dims& d) {
  const int T = d.T, E = d.E, H = d.H;
  for (int t = g.wi; t < T; t += g.W) {
    float gate = 1.0f;
    if (d.use_se) {
      float zt = 0.0f;
      for (int j = g.lane; j < H; j += 32) {
        float h = 0.0f;
#pragma unroll 4
        for (int u = 0; u < T; ++u) h = fmaf(sq[u], w1[u * H + j], h);
        zt = fmaf(fmaxf(h, 0.0f), w2[j * T + t], zt);
      }
      gate = 1.0f / (1.0f + expf(-warp_sum(zt)));
    }
    for (int e = g.lane; e < E; e += 32) {
      const float v = c[t * E + e];
      y[t * E + e] += d.use_se ? __fmul_rn(v, gate) : v;
    }
  }
}

// out rows p0, p0 + W, ... (NR of them) x columns o0 + lane + 32 i (i < NO)
// of dec @ w_out + b_out, summed over e in order
template <int NR, int NO>
__device__ __forceinline__ void fc_out_tile(const Group& g, const float* dec, const float* w_out,
                            const float* b_out, float* ob, int p0, int o0,
                            const Dims& d) {
  const int E = d.E, D = d.D, P = d.P;
  const float* dr[NR];
  int oc[NO];
#pragma unroll
  for (int r = 0; r < NR; ++r) dr[r] = dec + min(p0 + r * g.W, P - 1) * E;
#pragma unroll
  for (int i = 0; i < NO; ++i) oc[i] = min(o0 + g.lane + 32 * i, D - 1);
  float acc[NR][NO];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[r][i] = 0.0f;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    float wv[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) wv[i] = w_out[e * D + oc[i]];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float a = dr[r][e];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[r][i] = fmaf(a, wv[i], acc[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int p = p0 + r * g.W;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = o0 + g.lane + 32 * i;
      if (p < P && o < D) ob[p * D + o] = acc[r][i] + b_out[o];
    }
  }
}

template <int NR>
__device__ __forceinline__ void fc_out_rows(const Group& g, const float* dec,
                            const float* w_out, const float* b_out, float* ob,
                            int p0, const Dims& d) {
  for (int o0 = 0; o0 < d.D; o0 += 128) {
    switch (min(4, (d.D - o0 + 31) / 32)) {
      case 1: fc_out_tile<NR, 1>(g, dec, w_out, b_out, ob, p0, o0, d); break;
      case 2: fc_out_tile<NR, 2>(g, dec, w_out, b_out, ob, p0, o0, d); break;
      case 3: fc_out_tile<NR, 3>(g, dec, w_out, b_out, ob, p0, o0, d); break;
      default: fc_out_tile<NR, 4>(g, dec, w_out, b_out, ob, p0, o0, d);
    }
  }
}

// One block a sample of W = blockDim.x / 32 warps.
__global__ void __launch_bounds__(32 * kMaxWarps)
conv_mixer_fused_kernel(const float* __restrict__ yin,
                        const float* __restrict__ w,
                        float* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const int T = d.T, E = d.E, P = d.P, W = (int)(blockDim.x >> 5);
  const long nw = weights_numel(d), fs = sample_floats(d);
  const long te = (long)T * E;
  float* sw = smem;
  float* z = sw + nw;
  float* y = z + te;
  mmc::copy_rows_async(sw, 0, w, 0, 1, (int)nw);
  mmc::copy_rows_async(y, 0, yin + blockIdx.x * te, 0, 1, (int)te);
  mmc::copy_async_wait();
  __syncthreads();

  const Group g{(int)(threadIdx.x >> 5), W, (int)(threadIdx.x & 31)};
  float* c = y + te;
  float* sq = z + fs - 2 * T;
  int sqi = 0;  // the squeeze buffer the next SE writes

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
    const float* se_w2 = se_w1 + T * d.H;

    __syncwarp();  // this warp's stencil reads of z are done
    layer_norm_rows(g, y, z, ln1_g, ln1_b, d);
    if (d.kh1 > 1) g.sync(); else __syncwarp();
    float* sqb = sq + sqi * T;
    sqi ^= 1;
    conv_rows(g, z, c, sqb, taps1, d.kh1, d.kw1, scal, d);
    // every squeeze is in; no neighbour still reads z
    if (d.use_se || d.kh1 > 1) g.sync();
    gated_residual(g, y, c, sqb, se_w1, se_w2, d);

    if (d.twice) {
      __syncwarp();
      layer_norm_rows(g, y, z, ln2_g, ln2_b, d);
      if (d.kh2 > 1) g.sync(); else __syncwarp();
      sqb = sq + sqi * T;
      sqi ^= 1;
      conv_rows(g, z, c, sqb, taps2, d.kh2, d.kw2, scal + 3, d);
      if (d.use_se || d.kh2 > 1) g.sync();
      gated_residual(g, y, c, sqb, se_w1, se_w2, d);
    } else {
      // 'once': LN2/conv2 are identity, the shared SE still applies
      sqb = sq + sqi * T;
      sqi ^= 1;
      if (d.use_se) {
        squeeze_rows(g, y, sqb, d);
        g.sync();
      }
      gated_residual(g, y, y, sqb, se_w1, se_w2, d);
    }
  }

  const float* g_ln = sw + d.nb * bs;
  const float* b_ln = g_ln + E;
  const float* w_time = b_ln + E;
  const float* b_time = w_time + T * P;
  const float* proj = b_time + P;
  const float* w_out = proj + 2;
  const float* b_out = w_out + E * d.D;

  __syncwarp();
  layer_norm_rows(g, y, z, g_ln, b_ln, d);
  g.sync();  // every row of z is in; y and c are free for the (P, E) plane
  // time upsample T -> P, scalar channel projection, exact GELU (the
  // decoder's activation is GELU whatever the blocks use), this warp's rows
  // (two columns a lane at a time, as in conv_rows)
  float* dec = y;
  for (int p = g.wi; p < P; p += W)
    for (int e = g.lane; e < E; e += 64) {
      const bool two = e + 32 < E;
      const int e1 = two ? e + 32 : e;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        const float wt = w_time[t * P + p];
        a0 = fmaf(z[t * E + e], wt, a0);
        a1 = fmaf(z[t * E + e1], wt, a1);
      }
      const float v0 = gelu_exact((a0 + b_time[p]) * proj[0] + proj[1]);
      const float v1 = gelu_exact((a1 + b_time[p]) * proj[0] + proj[1]);
      dec[p * E + e] = v0;
      if (two) dec[p * E + e + 32] = v1;
    }
  __syncwarp();
  float* ob = out + (long)blockIdx.x * P * d.D;
  for (int p0 = g.wi; p0 < P; p0 += 4 * W) {
    switch (min(4, (P - p0 + W - 1) / W)) {
      case 1: fc_out_rows<1>(g, dec, w_out, b_out, ob, p0, d); break;
      case 2: fc_out_rows<2>(g, dec, w_out, b_out, ob, p0, d); break;
      case 3: fc_out_rows<3>(g, dec, w_out, b_out, ob, p0, d); break;
      default: fc_out_rows<4>(g, dec, w_out, b_out, ob, p0, d);
    }
  }
}

}  // namespace

extern "C" {

long mmc_conv_mixer_weights_numel(int T, int E, int P, int D, int H, int nb,
                                  int kh1, int kw1, int kh2, int kw2) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return weights_numel(d);
}

// dynamic shared memory of a block (one sample)
long mmc_conv_mixer_smem_bytes(int T, int E, int P, int D, int H, int nb,
                               int kh1, int kw1, int kh2, int kw2) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return (long)smem_bytes(d);
}

// the dynamic shared memory one block may opt in to on the current card
// (-1: the query failed)
int mmc_conv_mixer_card_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// blocks of `threads` threads and `smem` bytes that fit one SM at once
// (0: such a block cannot run; -1: the query failed)
int mmc_conv_mixer_resident_blocks(int threads, long smem) {
  int blocks = 0;
  if (cudaFuncSetAttribute(conv_mixer_fused_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, conv_mixer_fused_kernel, threads, (size_t)smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// y (B, T, E), w packed weights, out (B, P, D); all float32 on the current
// device; warps a sample from the wrapper's plan. Returns the cudaError_t
// of the launch (0 on success).
int mmc_conv_mixer_fused(const float* y, const float* w, float* out, int B,
                         int T, int E, int P, int D, int H, int nb, int kh1,
                         int kw1, int kh2, int kw2, int twice, int use_se,
                         int use_max, int act, int warps, void* stream) {
  Dims d{T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act};
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      conv_mixer_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_mixer_fused_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      y, w, out, d);
  return (int)cudaGetLastError();
}

const char* mmc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
