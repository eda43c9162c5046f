// The multi-channel ConvBlock, forward and backward, hand-written for
// Hopper:
//   z = conv(x) + b     C channels in and out, C x C x kh x kw taps, stride
//                       1, odd kh and kw, 'same' padding
//   a = act(z)          mish (the overflow-free softplus) or exact GELU
// on (N, C, T, E). The backward takes g = dL/da and the act'(z) its
// forward wrote:
//   dz = g act'(z),
//   dx[ci, t, e] = sum over co, p, q of w[co, ci, kh-1-p, kw-1-q]
//                  dz[co, t + p - ph, e + q - pw]
//                  (the forward's stencil over dz, taps flipped and
//                  channels transposed: odd kernels pad symmetrically),
//   dw[co, ci, p, q] = sum over n, t, e of dz[n, co, t, e]
//                      x[n, ci, t + p - ph, e + q - pw],
//   db[co] = sum over n, t, e of dz[n, co, t, e].
//
// Replaces no TPU kernel: in the JAX package XLA fused this chain
// (motionmixerconv_tpu/models/mixer_conv.py ConvBlock) and no Pallas
// kernel stood for it. Eager PyTorch runs it as cuDNN's convolution (an
// implicit GEMM whose tile is 8 output channels wide, or FFTs for 5x5),
// its bias, mish's elementwise chain, and backward cuDNN's data and weight
// gradients, a bias reduction and mish's gradient chain
// (ops/conv_block_mc.py).
//
// What bounds it on the H100: the float32 rate. At the autoregressive
// training shape (N 50, C 8, T 10, E 192, (5,5)) a forward is 768,000
// outputs x 200 multiply-adds, 307 MFLOP, 4.6 us at 67 TFLOP/s, against
// 3.1 MB an activation tensor (about 1 us at 3.35 TB/s); the backward
// does twice the forward's multiply-adds (dx and dw). Everything stays
// float32 with fused multiply-adds: no TF32, no bf16.
//
// Design. A block owns one sample's band of BT rows and slice of BE
// columns (ops/conv_block_mc.py plan). It stages its tile of all C input
// channels with the taps' halo, zero outside the plane, and the
// C x C x kh x kw taps in shared memory, each thread's loads in flight
// together, so no thread tests an edge afterwards. A stencil task owns kCB
// consecutive columns of one row for kCO output channels (C padded to a
// multiple): for each input channel and row tap it loads its kCB + kw - 1
// inputs once and slides across the column taps in registers, a tap's
// kCO weights one broadcast vector load; kCB is odd, so neighbouring
// lanes' runs fall on different banks. kCO is 4 and not 8: the cell's
// small batch leaves too few tasks for the latency of the shared-memory
// loads at 8 (measured on the H100: 28 against 34-40 us a forward at the
// autoregressive shape, 58 against 72-104 a backward). The forward adds
// the bias and writes a = act(z) and, where autograd will need it,
// act'(z), which shares act's transcendental terms: the backward then
// needs neither z nor a transcendental of its own, and nothing is
// recomputed.
//
// The backward is two launches. The first stages x's, g's and act'(z)'s
// tiles, makes dz = g act'(z) in place of g (zero outside the plane) and,
// for the weight gradient, dz's interior with channels fastest, then runs
// the stencil over dz with the flipped, transposed taps into dx, and the
// block's partial sums of dw and db: a task owns one (input channel, row
// tap, run of column taps, kCO output channels) and a subset of the
// band's rows, slides its column taps over x in registers and reads dz's
// kCO channels as broadcast vector loads; the subsets' sums are added
// into shared memory in subset order, one barrier each, and the block
// writes them out. The second launch adds the blocks' partials in block
// order in float64, a warp a stride of the blocks and then the warps in
// order, and rounds once. No float atomics: two launches give identical
// bits, and a captured CUDA graph replays both as the eager call runs
// them.

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

constexpr int kCB = 3;          // a stencil task's columns
constexpr int kCO = 4;          // a stencil or dw task's output channels
constexpr int kFwdThreads = 640;  // the most threads of a forward block
constexpr int kBwdThreads = 512;  // the most threads of a backward block
constexpr int kChunk = 8;       // a dw task's column taps where kw is not
                                // compiled for (fixed_width)
constexpr int kFoldWarps = 8;   // warps of a fold block
constexpr int kBatch = 4;       // loads a thread starts before it stores

// launches of the forward (0) and backward (1, its first kernel) since the
// library was loaded, counted on the device by each launch's first thread:
// replays of a captured CUDA graph run no wrapper, so only the device sees
// them
__device__ unsigned long long launch_count[2];

__device__ __forceinline__ void count_launch(int kernel) {
  if (threadIdx.x == 0 && blockIdx.x == 0)
    atomicAdd(&launch_count[kernel], 1ULL);
}

// a = act(z) as mmc::activation computes it and d = act'(z), sharing
// their transcendental terms; softplus' derivative is the logistic
// sigmoid, taken in the form that does not overflow
__device__ __forceinline__ void activation_and_grad(float z, int act,
                                                    float& a, float& d) {
  if (act == 1) {
    const float e = expf(-fabsf(z));
    const float t = tanhf(log1pf(e) + fmaxf(z, 0.0f));
    a = z * t;
    const float sig = (z >= 0.0f ? 1.0f : e) / (1.0f + e);
    d = t + z * (1.0f - t * t) * sig;
    return;
  }
  const float erf1 = 1.0f + erff(z * 0.70710678118654752440f);
  a = 0.5f * z * erf1;
  d = 0.5f * erf1 + z * (expf(-0.5f * z * z) * 0.39894228040143267794f);
}

// column tap counts the kernels are compiled for; another kw slides a
// runtime window (the stencil) or takes chunks of kChunk taps (dw)
__host__ __device__ inline bool fixed_width(int kw) {
  return kw == 1 || kw == 5 || kw == 9;
}

// the column taps a dw task's chunks span
__host__ __device__ inline int tap_span(int kw) {
  return fixed_width(kw) ? kw : (kw + kChunk - 1) / kChunk * kChunk;
}

// A call's plane, taps and tiles (ops/conv_block_mc.py plan).
struct Geom {
  int C, T, E, kh, kw;
  int cp;              // C rounded up to kCO
  int BT, BE;          // a block's rows and columns of the plane
  int R, LD;           // a staged tile's rows and (odd) row stride
  int nbands, nslices;
  int S;               // backward: the row subsets of a dw task
};

Geom make_geom(int C, int T, int E, int kh, int kw, int BT, int BE, int S) {
  Geom g;
  g.C = C, g.T = T, g.E = E, g.kh = kh, g.kw = kw;
  g.cp = (C + kCO - 1) / kCO * kCO;
  g.BT = BT, g.BE = BE;
  g.R = BT + kh - 1;
  g.LD = (BE + tap_span(kw) - 1) | 1;
  g.nbands = (T + BT - 1) / BT;
  g.nslices = (E + BE - 1) / BE;
  g.S = S;
  return g;
}

__host__ __device__ inline long weight_floats(const Geom& g) {
  return (long)g.C * g.kh * g.kw * g.cp;
}
__host__ __device__ inline long tile_floats(const Geom& g) {
  return (long)g.C * g.R * g.LD;
}
__host__ __device__ inline long dzt_floats(const Geom& g) {
  return (long)g.BT * g.BE * g.cp;
}
__host__ __device__ inline long weight_values(const Geom& g) {
  return (long)g.C * g.C * g.kh * g.kw;
}
// a block's partial sums: dw, then db
__host__ __device__ inline long n_values(const Geom& g) {
  return weight_values(g) + g.C;
}
// dw tasks, (row tap, input channel, chunk of column taps, output
// channels) with the row tap fastest, then one bias task a tile of output
// channels
__host__ __device__ inline int weight_tasks(const Geom& g) {
  const int QC = fixed_width(g.kw) ? g.kw : kChunk;
  return g.kh * g.C * ((g.kw + QC - 1) / QC) * (g.cp / kCO);
}
__host__ __device__ inline int sum_tasks(const Geom& g) {
  return weight_tasks(g) + g.cp / kCO;
}

// shared memory: the taps, then forward x's tile; backward dz's interior
// with channels fastest, x's tile, dz's tile, and act'(z)'s tile, where
// the block's sums go once dz is made
size_t smem_bytes(const Geom& g, bool backward) {
  const long f = weight_floats(g) + tile_floats(g);
  return sizeof(float) *
         (size_t)(backward ? f + dzt_floats(g) + tile_floats(g) +
                                 max(tile_floats(g), n_values(g))
                           : f);
}

// this block's sample and the first row and column of its tile
__device__ __forceinline__ void block_origin(const Geom& g, int& n, int& t0,
                                             int& e0) {
  const int b = blockIdx.x;
  e0 = b % g.nslices * g.BE;
  t0 = b / g.nslices % g.nbands * g.BT;
  n = b / (g.nslices * g.nbands);
}

// A tap's kCO output channels, one 16-byte aligned vector load.
__device__ __forceinline__ void load_taps(const float* p, float (&wk)[kCO]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  wk[0] = a.x, wk[1] = a.y, wk[2] = a.z, wk[3] = a.w;
}

// ws[((ci kh + p) kw + q) cp + co]: the tap of input channel ci into output
// channel co at (p, q): w[co, ci, p, q]; ``flipped`` (the backward's dx,
// whose input channel is the forward's output) w[ci, co, kh-1-p, kw-1-q];
// 0 for a padded output channel. Each thread starts kBatch loads before
// it stores them.
__device__ void stage_taps(float* ws, const float* __restrict__ w,
                           const Geom& g, bool flipped) {
  const int taps = g.kh * g.kw, n = (int)weight_floats(g);
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x;
      const int co = i % g.cp, r = i / g.cp;
      const int tap = r % taps, ci = r / taps;
      const long at = flipped ? ((long)ci * g.C + co) * taps + taps - 1 - tap
                              : ((long)co * g.C + ci) * taps + tap;
      v[k] = i < n && co < g.C ? __ldg(w + at) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k * blockDim.x < n) ws[i0 + k * blockDim.x] = v[k];
  }
}

// dst (C, R, LD): each channel's rows from t0 - ph and columns from e0 - pw
// of the sample's planes src (C, T, E), 0 outside them. A warp takes rows,
// kBatch at a time, a lane a column of each: all its loads in flight
// before it stores them.
__device__ void stage_tile(float* dst, const float* __restrict__ src,
                           const Geom& g, int t0, int e0) {
  const int ph = (g.kh - 1) / 2, pw = (g.kw - 1) / 2, rows = g.C * g.R;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int col = lane; col - lane < g.LD; col += 32) {
    const int e = e0 - pw + col;
    const bool col_in = col < g.LD, e_in = e >= 0 && e < g.E;
    for (int row0 = threadIdx.x >> 5; row0 < rows; row0 += kBatch * warps) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int row = row0 + k * warps;
        const int c = row / g.R, t = t0 - ph + row % g.R;
        v[k] = row < rows && col_in && e_in && t >= 0 && t < g.T
                   ? __ldg(src + ((long)c * g.T + t) * g.E + e)
                   : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int row = row0 + k * warps;
        if (row < rows && col_in) dst[(long)row * g.LD + col] = v[k];
      }
    }
  }
}

// ds (C, R, LD) holds g's tile and ss act'(z)'s, as stage_tile lays them
// out: ds becomes dz = g act'(z) (0 outside the plane), and dzt (BT, BE,
// cp) its interior with channels fastest, 0 for the padded channels; a
// warp a row
__device__ void make_dz(float* ds, const float* ss, float* dzt,
                        const Geom& g) {
  const int ph = (g.kh - 1) / 2, pw = (g.kw - 1) / 2;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < g.C * g.R;
       row += blockDim.x >> 5) {
    const int c = row / g.R, ti = row % g.R - ph;
    float* d = ds + (long)row * g.LD;
    const float* sr = ss + (long)row * g.LD;
    float* dt = ti >= 0 && ti < g.BT ? dzt + (long)ti * g.BE * g.cp + c
                                     : nullptr;
    for (int col = lane; col < g.LD; col += 32) {
      const float v = d[col] * sr[col];
      d[col] = v;
      const int ei = col - pw;
      if (dt != nullptr && ei >= 0 && ei < g.BE) dt[(long)ei * g.cp] = v;
    }
  }
  const int pad = g.cp - g.C;
  for (int i = threadIdx.x; i < g.BT * g.BE * pad; i += blockDim.x)
    dzt[i / pad * g.cp + g.C + i % pad] = 0.0f;
}

// One stencil task: acc[j][k] = sum over the input channels ci and taps
// (p, q) of in[ci, t + p, c0 + j + q] ws[ci, p, q, co0 + k], in the
// tile's coordinates. KW > 0 is kw known at compile time (the window
// loaded whole); KW == 0 slides a kCB-wide window across a runtime kw.
template <int KW>
__device__ __forceinline__ void stencil(const float* __restrict__ in,
                                        const float* __restrict__ ws,
                                        const Geom& g, int t, int c0, int co0,
                                        float (&acc)[kCB][kCO]) {
#pragma unroll
  for (int j = 0; j < kCB; ++j)
#pragma unroll
    for (int k = 0; k < kCO; ++k) acc[j][k] = 0.0f;
  for (int ci = 0; ci < g.C; ++ci) {
    for (int p = 0; p < g.kh; ++p) {
      const float* row = in + ((long)ci * g.R + t + p) * g.LD + c0;
      const float* wr = ws + ((long)ci * g.kh + p) * g.kw * g.cp + co0;
      if constexpr (KW > 0) {
        float v[kCB + KW - 1];
#pragma unroll
        for (int j = 0; j < kCB + KW - 1; ++j) v[j] = row[j];
#pragma unroll
        for (int q = 0; q < KW; ++q) {
          float wk[kCO];
          load_taps(wr + q * g.cp, wk);
#pragma unroll
          for (int j = 0; j < kCB; ++j)
#pragma unroll
            for (int k = 0; k < kCO; ++k)
              acc[j][k] = fmaf(v[j + q], wk[k], acc[j][k]);
        }
      } else {
        float v[kCB];
#pragma unroll
        for (int j = 0; j + 1 < kCB; ++j) v[j + 1] = row[j];
        for (int q = 0; q < g.kw; ++q) {
#pragma unroll
          for (int j = 0; j + 1 < kCB; ++j) v[j] = v[j + 1];
          v[kCB - 1] = row[kCB - 1 + q];
          float wk[kCO];
          load_taps(wr + q * g.cp, wk);
#pragma unroll
          for (int j = 0; j < kCB; ++j)
#pragma unroll
            for (int k = 0; k < kCO; ++k)
              acc[j][k] = fmaf(v[j], wk[k], acc[j][k]);
        }
      }
    }
  }
}

// The stencil over the staged tile ``in`` for every task of the block,
// each result passed to out(channel, index into (N, C, T, E), value).
template <int KW, typename Out>
__device__ __forceinline__ void stencil_tasks(const float* in,
                                              const float* ws, const Geom& g,
                                              int n, int t0, int e0,
                                              Out out) {
  const int runs = g.BE / kCB;
  const int tasks = g.cp / kCO * g.BT * runs;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int run = task % runs, t = task / runs % g.BT;
    const int co0 = task / (runs * g.BT) * kCO;
    float acc[kCB][kCO];
    stencil<KW>(in, ws, g, t, run * kCB, co0, acc);
    if (t0 + t >= g.T) continue;
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
      const int co = co0 + k;
      if (co >= g.C) continue;
      const long base = (((long)n * g.C + co) * g.T + t0 + t) * g.E;
#pragma unroll
      for (int j = 0; j < kCB; ++j) {
        const int e = e0 + run * kCB + j;
        if (e < g.E) out(co, base + e, acc[j][k]);
      }
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(kFwdThreads)
    conv_block_mc_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ b,
                             float* __restrict__ a, float* __restrict__ da,
                             const Geom g, int act) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + weight_floats(g);
  count_launch(0);
  int n, t0, e0;
  block_origin(g, n, t0, e0);
  stage_taps(ws, w, g, false);
  stage_tile(xs, x + (long)n * g.C * g.T * g.E, g, t0, e0);
  __syncthreads();
  stencil_tasks<KW>(xs, ws, g, n, t0, e0, [&](int co, long at, float acc) {
                          const float z = acc + __ldg(b + co);
                          if (da == nullptr) {
                            a[at] = mmc::activation(z, act);
                          } else {
                            float av, dv;
                            activation_and_grad(z, act, av, dv);
                            a[at] = av;
                            da[at] = dv;
                          }
                        });
}

// One dw or db task's sums over the rows s, s + S, ... < rows of the
// band: a dw task (task < weight_tasks) acc[j][k] = sum of dz[co0 + k]
// against x[ci] shifted by taps (p, q0 + j); a bias task acc[0][k] = sum
// of dz[co0 + k].
template <int QC>
__device__ __forceinline__ void sum_task(const float* __restrict__ xs,
                                         const float* __restrict__ dzt,
                                         const Geom& g, int task, int s,
                                         int rows, float (&acc)[QC][kCO]) {
#pragma unroll
  for (int j = 0; j < QC; ++j)
#pragma unroll
    for (int k = 0; k < kCO; ++k) acc[j][k] = 0.0f;
  const int nw = weight_tasks(g);
  if (task >= nw) {
    const int co0 = (task - nw) * kCO;
    for (int t = s; t < rows; t += g.S) {
      const float* dr = dzt + (long)t * g.BE * g.cp + co0;
      for (int e = 0; e < g.BE; ++e) {
        float d[kCO];
        load_taps(dr + (long)e * g.cp, d);
#pragma unroll
        for (int k = 0; k < kCO; ++k) acc[0][k] += d[k];
      }
    }
    return;
  }
  const int nqc = (g.kw + QC - 1) / QC;
  const int p = task % g.kh, ci = task / g.kh % g.C;
  const int q0 = task / (g.kh * g.C) % nqc * QC;
  const int co0 = task / (g.kh * g.C * nqc) * kCO;
  for (int t = s; t < rows; t += g.S) {
    const float* xr = xs + ((long)ci * g.R + t + p) * g.LD + q0;
    const float* dr = dzt + (long)t * g.BE * g.cp + co0;
    float v[QC];
#pragma unroll
    for (int j = 0; j + 1 < QC; ++j) v[j + 1] = xr[j];
    for (int e = 0; e < g.BE; ++e) {
#pragma unroll
      for (int j = 0; j + 1 < QC; ++j) v[j] = v[j + 1];
      v[QC - 1] = xr[e + QC - 1];
      float d[kCO];
      load_taps(dr + (long)e * g.cp, d);
#pragma unroll
      for (int j = 0; j < QC; ++j)
#pragma unroll
        for (int k = 0; k < kCO; ++k) acc[j][k] = fmaf(d[k], v[j], acc[j][k]);
    }
  }
}

// A task's sums into the block's red (dw in torch's (co, ci, p, q) order,
// then db), added to what is there or, for the first subset, stored.
template <int QC>
__device__ __forceinline__ void store_sums(float* red, const Geom& g,
                                           int task, bool add,
                                           const float (&acc)[QC][kCO]) {
  const int nw = weight_tasks(g);
  if (task >= nw) {
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
      const int co = (task - nw) * kCO + k;
      if (co < g.C) {
        float* r = red + weight_values(g) + co;
        *r = add ? *r + acc[0][k] : acc[0][k];
      }
    }
    return;
  }
  const int nqc = (g.kw + QC - 1) / QC;
  const int p = task % g.kh, ci = task / g.kh % g.C;
  const int q0 = task / (g.kh * g.C) % nqc * QC;
  const int co0 = task / (g.kh * g.C * nqc) * kCO;
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
    const int co = co0 + k;
    if (co >= g.C) continue;
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      const int q = q0 + j;
      if (q >= g.kw) continue;
      float* r = red + (((long)co * g.C + ci) * g.kh + p) * g.kw + q;
      *r = add ? *r + acc[j][k] : acc[j][k];
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(kBwdThreads)
    conv_block_mc_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ da,
                             const float* __restrict__ gr,
                             const float* __restrict__ w,
                             float* __restrict__ dx, float* __restrict__ part,
                             const Geom g) {
  constexpr int QC = KW > 0 ? KW : kChunk;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* dzt = ws + weight_floats(g);  // 16-byte aligned: cp % 4 == 0
  float* xs = dzt + dzt_floats(g);
  float* ds = xs + tile_floats(g);
  float* ss = ds + tile_floats(g);  // act'(z)'s tile, then the block's sums
  float* red = ss;
  count_launch(1);
  int n, t0, e0;
  block_origin(g, n, t0, e0);
  const long sample = (long)n * g.C * g.T * g.E;
  stage_taps(ws, w, g, true);
  stage_tile(xs, x + sample, g, t0, e0);
  stage_tile(ds, gr + sample, g, t0, e0);
  stage_tile(ss, da + sample, g, t0, e0);
  __syncthreads();
  make_dz(ds, ss, dzt, g);
  __syncthreads();

  stencil_tasks<KW>(ds, ws, g, n, t0, e0,
                    [&](int, long at, float acc) { dx[at] = acc; });

  // dw and db: with S subsets each task's subsets add into red in subset
  // order, a barrier each; with one, each thread takes tasks in turn
  const int tasks = sum_tasks(g), rows = min(g.BT, g.T - t0);
  float acc[QC][kCO];
  if (g.S == 1) {
    for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
      sum_task<QC>(xs, dzt, g, task, 0, rows, acc);
      store_sums<QC>(red, g, task, false, acc);
    }
    __syncthreads();
  } else {
    const int task = threadIdx.x % tasks, s = threadIdx.x / tasks;
    if (s < g.S) sum_task<QC>(xs, dzt, g, task, s, rows, acc);
    for (int ss = 0; ss < g.S; ++ss) {
      if (s == ss) store_sums<QC>(red, g, task, ss > 0, acc);
      __syncthreads();
    }
  }
  const long nv = n_values(g);
  for (long v = threadIdx.x; v < nv; v += blockDim.x)
    part[(long)blockIdx.x * nv + v] = red[v];
}

// dw and db from the P blocks' partials part (P, nv): value v's partials
// summed in float64, warp r of the block taking blocks r, r + kFoldWarps,
// ..., then the warps' sums in warp order, rounded once.
__global__ void __launch_bounds__(32 * kFoldWarps)
    conv_block_mc_fold_kernel(const float* __restrict__ part, int P, long nv,
                              long nw, float* __restrict__ dw,
                              float* __restrict__ db) {
  __shared__ double sums[kFoldWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long v = (long)blockIdx.x * 32 + lane;
  double s = 0.0;
  if (v < nv)
    for (int b = warp; b < P; b += kFoldWarps)
      s += (double)__ldg(part + (long)b * nv + v);
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || v >= nv) return;
  double t = 0.0;
#pragma unroll
  for (int k = 0; k < kFoldWarps; ++k) t += sums[k][lane];
  if (v < nw)
    dw[v] = (float)t;
  else
    db[v - nw] = (float)t;
}

using FwdKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, const Geom, int);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, const Geom);

FwdKernel fwd_kernel(int kw) {
  switch (kw) {
    case 1: return conv_block_mc_fwd_kernel<1>;
    case 5: return conv_block_mc_fwd_kernel<5>;
    case 9: return conv_block_mc_fwd_kernel<9>;
    default: return conv_block_mc_fwd_kernel<0>;
  }
}

BwdKernel bwd_kernel(int kw) {
  switch (kw) {
    case 1: return conv_block_mc_bwd_kernel<1>;
    case 5: return conv_block_mc_bwd_kernel<5>;
    case 9: return conv_block_mc_bwd_kernel<9>;
    default: return conv_block_mc_bwd_kernel<0>;
  }
}

// what an entry returns where the plan's tiles exceed the shared memory a
// block of the current device may have (ops/conv_block_mc.py
// TILES_TOO_LARGE)
constexpr int kTilesTooLarge = -1;

bool too_large(size_t smem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;  // the launch reports the error
  return smem > (size_t)limit;
}

bool bad_args(int N, int C, int T, int E, int kh, int kw, int BT, int BE,
              int threads, int max_threads) {
  return N < 1 || C < 1 || T < 1 || E < 1 || kh < 1 || kw < 1 ||
         kh % 2 == 0 || kw % 2 == 0 || BT < 1 || BT > T || BE < kCB ||
         BE % kCB != 0 || threads < 32 || threads > max_threads ||
         threads % 32 != 0;
}

// run ``kernel`` with the dynamic shared memory it asks for
template <typename K, typename... Args>
int launch(K kernel, int blocks, int threads, size_t smem, void* stream,
           Args... args) {
  if (too_large(smem)) return kTilesTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the current device's launch counts of the forward and backward kernels
// into out[0], out[1] (synchronous, on the legacy default stream). Returns
// the cudaError_t (0 on success).
int mmc_conv_block_mc_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, launch_count, sizeof(launch_count));
}

// the dynamic shared memory of a forward (backward 0) or backward block
// of the plan's tiles (BT, BE)
long mmc_conv_block_mc_smem_bytes(int C, int T, int E, int kh, int kw, int BT,
                                  int BE, int backward) {
  return (long)smem_bytes(make_geom(C, T, E, kh, kw, BT, BE, 1), backward);
}

// x (N, C, T, E), w (C, C, kh, kw), b (C); out a = act(conv(x) + b)
// (N, C, T, E) and, where da is not null, da = act'(conv(x) + b); all
// float32 on the current device; act 0 = exact GELU, 1 = mish; (BT, BE,
// threads) the plan's forward tiles. Returns the cudaError_t of the launch
// (0 on success), or kTilesTooLarge.
int mmc_conv_block_mc_fwd(const float* x, const float* w, const float* b,
                          float* a, float* da, int N, int C, int T, int E,
                          int kh, int kw, int BT, int BE, int threads, int act,
                          void* stream) {
  if (bad_args(N, C, T, E, kh, kw, BT, BE, threads, kFwdThreads) ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(C, T, E, kh, kw, BT, BE, 1);
  const FwdKernel k = fwd_kernel(kw);
  return launch(k, N * g.nbands * g.nslices, threads, smem_bytes(g, false),
                stream, x, w, b, a, da, g, act);
}

// x, da (the forward's act'(conv(x) + b)) and g (N, C, T, E), w (C, C, kh,
// kw); outputs dx (N, C, T, E), dw (C, C, kh, kw) and db (C); part holds
// N x nbands x nslices x (C C kh kw + C) floats of scratch, for the
// backward's tiles (BT, BE, threads, S), S the row subsets of a dw task
// (sum_tasks x S threads at most, or 1). All float32 on the current device.
// Returns the first failing launch's cudaError_t (0 on success), or
// kTilesTooLarge.
int mmc_conv_block_mc_bwd(const float* x, const float* da, const float* g,
                          const float* w, float* dx, float* dw, float* db,
                          float* part, int N, int C, int T, int E, int kh,
                          int kw, int BT, int BE, int threads, int S,
                          void* stream) {
  if (bad_args(N, C, T, E, kh, kw, BT, BE, threads, kBwdThreads) ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geom geom = make_geom(C, T, E, kh, kw, BT, BE, S);
  if (S < 1 || S > BT || (S > 1 && (long)sum_tasks(geom) * S > threads))
    return (int)cudaErrorInvalidValue;
  const BwdKernel k = bwd_kernel(kw);
  const int blocks = N * geom.nbands * geom.nslices;
  int err = launch(k, blocks, threads, smem_bytes(geom, true), stream, x, da,
                   g, w, dx, part, geom);
  if (err != 0) return err;
  const long nv = n_values(geom);
  conv_block_mc_fold_kernel<<<(int)((nv + 31) / 32), 32 * kFoldWarps, 0,
                              (cudaStream_t)stream>>>(
      part, blocks, nv, weight_values(geom), dw, db);
  return (int)cudaGetLastError();
}

}  // extern "C"
