// Fused multi-channel ConvMixer core (inference), hand-written for Hopper as
// a thread-block-cluster kernel.
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
// (C=8, T=10, E=192, (5,5) kernels, 4 blocks, twice) that is ~43 MFLOP per
// sample against ~61 KB in and 1.3 KB out, so it is bound by the f32 rate
// (67 TFLOP/s), not by memory. The TPU kernel turns each conv into kw MXU
// matmuls against block-Toeplitz matrices; here the conv is a direct
// stencil over the real weights.
//
// Design: one cluster of K blocks (1, 2, 4, 8 or 16; chosen by the wrapper's
// `mc_plan`) per sample. Block r of the cluster owns a contiguous slice of
// the E columns (the first E % K slices one column wider) for all (c, t)
// rows of the residual stream y, the LN output z and the branch output c,
// so a sample's latency chain and each block's shared memory shrink by K,
// which also lets a shape whose planes outgrow one SM run. Every slice is at
// least the convs' widest 'same' pad, so the halo columns of z come only
// from the two neighbours: after a branch's LayerNorm each block writes its
// edge columns straight into its neighbours' halos (DSMEM), and one cluster
// barrier later the conv reads a zero-padded slice; the halos at the
// plane's edges stay zero, with torch's extra pad on the right. The
// LayerNorm's per-row sums (two passes: mean, then squared deviations), the
// SE squeeze over (C, E) per t and the decoder's fc_out contraction over E
// are each summed per block and then combined across the cluster in rank
// order 0..K-1 (no float atomics), so repeats are bit-identical; the time
// and channel projections are per column and stay local.
//
// The stencil is register-blocked: a thread owns RB rows x CB consecutive
// columns x CO output channels (the plan's tile: 1 x 3 x 8 where a block has
// enough columns, else 1 x 1 x 2 for more threads). For each (input
// channel, row tap) it loads its CB + kw - 1 activations of each row once
// and slides across the kw column taps in registers; a tap's CO weights
// are broadcast vector loads shared by all RB x CB positions. With CB odd,
// neighbouring lanes' runs fall on different banks. Each block stages its
// mixer block's weights (~16 KB at the autoregressive shape) into shared
// memory with cp.async as the block starts; the decoder reads its weights
// through the read-only cache. When the cluster is one block, the barriers
// are the block's own and each LayerNorm row keeps its statistics in
// registers. The kernel ends with a cluster barrier, so no block exits
// while a neighbour reads its shared memory.
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

#include "cluster.cuh"
#include "device_math.cuh"

namespace {

using mmc::activation;
using mmc::cluster_rank;
using mmc::cluster_sync;
using mmc::gelu_exact;
using mmc::max_width;
using mmc::peer;
using mmc::rank_max;
using mmc::rank_sum;
using mmc::slice_start;
using mmc::slice_width;
using mmc::warp_max;
using mmc::warp_sum;

constexpr int kMaxThreads = 640;
constexpr int kCoTile = 8;  // output channels are padded to a multiple
constexpr int kMaxCB = 3;   // widest column run of a tile
// the stencil tiles, rows x columns x output channels per thread
// (ops/conv_mixer_mc.py TILES)
constexpr int kTiles = 2;
constexpr int kTileRows[kTiles] = {1, 1};
constexpr int kTileCols[kTiles] = {1, 3};
constexpr int kTileCo[kTiles] = {2, 8};

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

// the convs' largest left and right 'same' padding over E (torch: the extra
// pad of an even kernel on the right)
__host__ __device__ inline int halo_left(const Dims& d) {
  return max((d.kw1 - 1) / 2, (d.kw2 - 1) / 2);
}

__host__ __device__ inline int halo_right(const Dims& d) {
  return max(d.kw1 - 1 - (d.kw1 - 1) / 2, d.kw2 - 1 - (d.kw2 - 1) / 2);
}

// row stride of a block's LN output: its widest slice, both halos and the
// columns a tile's last run reads past the slice
__host__ __device__ inline int z_stride(const Dims& d, int K) {
  return max_width(d.E, K) + halo_left(d) + halo_right(d) + kMaxCB - 1;
}

// A block's shared memory, in floats, in the order the kernel lays it out.
struct Smem {
  long staged, y, z, c, rows, t, hid, pout;
  __host__ __device__ Smem(const Dims& d, int K) {
    const long ws = max_width(d.E, K), R = (long)d.C * d.T;
    staged = staged_floats(d);
    y = R * ws;
    z = R * z_stride(d, K);
    c = (R > d.P ? R : (long)d.P) * ws;
    rows = 4 * R;                // LN partial sums, squares, mean, 1/std
    t = 3L * d.T;                // SE partials, squeeze, gate
    hid = d.H > 0 ? d.H : 1;     // SE hidden
    pout = (long)d.P * d.D;      // fc_out partials
  }
  __host__ __device__ long total() const {
    return staged + y + z + c + rows + t + hid + pout;
  }
};

__host__ inline size_t smem_bytes(const Dims& d, int K) {
  return sizeof(float) * (size_t)Smem(d, K).total();
}

// A tap's CO output-channel weights, co0.. co0+CO-1 (16-byte aligned for
// CO = 8 or 4, 8-byte for 2).
template <int CO>
__device__ __forceinline__ void load_taps(const float* p, float (&wk)[CO]) {
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int k = 0; k < CO; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k);
      wk[k] = a.x, wk[k + 1] = a.y, wk[k + 2] = a.z, wk[k + 3] = a.w;
    }
  } else if constexpr (CO == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    wk[0] = a.x, wk[1] = a.y;
  } else {
    wk[0] = p[0];
  }
}

// One thread's tile: output rows t0..t0+RB-1, columns e0..e0+CB-1 of the
// slice, channels co0..co0+CO-1. KW > 0 is the column taps known at
// compile time (the window is loaded whole); KW == 0 slides a CB-wide
// window across a runtime kw.
template <int RB, int CB, int CO, int KW>
__device__ __forceinline__ void conv_tile(
    const float* __restrict__ z, int zs, int zoff, const float* __restrict__ w,
    int C, int T, int kh, int kw, int t0, int co0,
    float (&acc)[RB][CB][CO]) {
  const int cp = padded_channels(C);
  const int ph = (kh - 1) / 2;
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < CB; ++j)
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[i][j][k] = 0.0f;
  for (int ci = 0; ci < C; ++ci) {
    for (int dt = 0; dt < kh; ++dt) {
      // this tap's input row for each of the tile's output rows; a row
      // outside the plane (or past T) reads row 0 and adds zeros
      bool ok[RB];
      const float* zr[RB];
      bool any = false;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = t0 + i + dt - ph;
        ok[i] = r >= 0 && r < T && t0 + i < T;
        zr[i] = z + (ci * T + (ok[i] ? r : 0)) * zs + zoff;
        any = any || ok[i];
      }
      if (!any) continue;
      const float* wr = w + (ci * kh + dt) * kw * cp + co0;
      if constexpr (KW > 0) {
        float v[RB][CB + KW - 1];
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < CB + KW - 1; ++j)
            v[i][j] = ok[i] ? zr[i][j] : 0.0f;
#pragma unroll
        for (int de = 0; de < KW; ++de) {
          float wk[CO];
          load_taps<CO>(wr + de * cp, wk);
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int j = 0; j < CB; ++j)
#pragma unroll
              for (int k = 0; k < CO; ++k)
                acc[i][j][k] = fmaf(v[i][j + de], wk[k], acc[i][j][k]);
        }
      } else {
        float v[RB][CB];
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j + 1 < CB; ++j)
            v[i][j + 1] = ok[i] ? zr[i][j] : 0.0f;
        for (int de = 0; de < kw; ++de) {
          float wk[CO];
          load_taps<CO>(wr + de * cp, wk);
#pragma unroll
          for (int i = 0; i < RB; ++i) {
#pragma unroll
            for (int j = 0; j + 1 < CB; ++j) v[i][j] = v[i][j + 1];
            v[i][CB - 1] = ok[i] ? zr[i][CB - 1 + de] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int j = 0; j < CB; ++j)
#pragma unroll
              for (int k = 0; k < CO; ++k)
                acc[i][j][k] = fmaf(v[i][j], wk[k], acc[i][j][k]);
        }
      }
    }
  }
}

// out[co, t, e] = act(bias[co] + sum_{ci, dt, de} w[ci][dt][de][co] *
//                 in[ci, t + dt - ph, e + de - pw]) * bn_s[co] + bn_t[co]
// for the slice's ``width`` columns, with torch's 'same' padding; ``z`` is
// the input slice with rows of stride ``zs`` whose column e sits at e + hl,
// halos included. ``out`` has rows of stride ``ows``. No barrier.
template <int RB, int CB, int CO, int KW>
__device__ __forceinline__ void conv_slice(
    const float* __restrict__ z, int zs, int hl, float* __restrict__ out,
    int ows, const float* __restrict__ w, const float* bias, const float* bn_s,
    const float* bn_t, int C, int T, int width, int kh, int kw, int act) {
  const int cp = padded_channels(C);
  const int pw = (kw - 1) / 2;
  const int runs = (width + CB - 1) / CB;
  const int row_tiles = (T + RB - 1) / RB;
  const int n_tasks = cp / CO * row_tiles * runs;
  for (int task = threadIdx.x; task < n_tasks; task += blockDim.x) {
    const int e0 = task % runs * CB;
    const int t0 = task / runs % row_tiles * RB;
    const int co0 = task / (runs * row_tiles) * CO;
    float acc[RB][CB][CO];
    conv_tile<RB, CB, CO, KW>(z, zs, hl - pw + e0, w, C, T, kh, kw, t0, co0,
                              acc);
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j)
#pragma unroll
        for (int k = 0; k < CO; ++k) {
          const int co = co0 + k, t = t0 + i, e = e0 + j;
          if (co < C && t < T && e < width)
            out[(co * T + t) * ows + e] =
                activation(acc[i][j][k] + bias[co], act) * bn_s[co] + bn_t[co];
        }
  }
}

template <int RB, int CB, int CO>
__device__ __forceinline__ void conv_kw(const float* z, int zs, int hl,
                                        float* out, int ows, const float* w,
                                        const float* bias, const float* bn_s,
                                        const float* bn_t, int C, int T,
                                        int width, int kh, int kw, int act) {
#define MMC_CONV(KW)                                                   \
  conv_slice<RB, CB, CO, KW>(z, zs, hl, out, ows, w, bias, bn_s, bn_t, \
                             C, T, width, kh, kw, act)
  switch (kw) {
    case 5: MMC_CONV(5); break;
    case 9: MMC_CONV(9); break;
    default: MMC_CONV(0); break;
  }
#undef MMC_CONV
}

__device__ __forceinline__ void conv(int tile, const float* z, int zs, int hl,
                                     float* out, int ows, const float* w,
                                     const float* bias, const float* bn_s,
                                     const float* bn_t, int C, int T,
                                     int width, int kh, int kw, int act) {
#define MMC_TILE(i)                                                          \
  conv_kw<kTileRows[i], kTileCols[i], kTileCo[i]>(z, zs, hl, out, ows, w,    \
                                                  bias, bn_s, bn_t, C, T,    \
                                                  width, kh, kw, act)
  if (tile == 0)
    MMC_TILE(0);
  else
    MMC_TILE(1);
#undef MMC_TILE
}

// The per-block views of the kernel's shared memory and its place in the
// cluster.
struct Block {
  int K, rank, width, e0, ws, zs, hl;
  float *sw, *y, *z, *c, *psum, *psq, *mean, *rstd, *pse, *sq, *gate, *hid,
      *pout;
};

// Every block of the cluster meets (only this block's threads when the
// cluster is one block).
__device__ __forceinline__ void sync_all(const Block& s) {
  if (s.K > 1)
    cluster_sync();
  else
    __syncthreads();
}

// The lanes that share a row of ``width`` columns: a power of two, at most
// a warp, at most the width.
__device__ __forceinline__ int row_lanes(int width) {
  int g = 32;
  while (g > 1 && g > width) g >>= 1;
  return g;
}

enum RowOp { kSum = 0, kSqDev = 1, kMax = 2 };

// part[r] = the sum (kSum), the sum of squared deviations from mean[r]
// (kSqDev) or the max (kMax) of row r's ``width`` columns of src (rows R,
// stride ws): a group of row_lanes(width) lanes per row, lane-strided, then
// a butterfly in the group. No barrier.
template <int kOp>
__device__ __forceinline__ void row_partials(const float* src, int ws,
                                             int width, int R,
                                             const float* mean, float* part) {
  const int g = row_lanes(width);
  const int groups = blockDim.x / g, gid = threadIdx.x / g,
            sub = threadIdx.x % g;
  for (int r0 = 0; r0 < R; r0 += groups) {
    const int r = r0 + gid;
    float v = kOp == kMax ? -INFINITY : 0.0f;
    if (r < R) {
      const float* row = src + r * ws;
      const float mu = kOp == kSqDev ? mean[r] : 0.0f;
      for (int e = sub; e < width; e += g) {
        if constexpr (kOp == kSum) v += row[e];
        if constexpr (kOp == kSqDev) {
          const float dv = row[e] - mu;
          v += dv * dv;
        }
        if constexpr (kOp == kMax) v = fmaxf(v, row[e]);
      }
    }
    for (int o = g / 2; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = kOp == kMax ? fmaxf(v, u) : v + u;
    }
    if (sub == 0 && r < R) part[r] = v;
  }
}

// LN(E) of every row of y over the whole cluster's columns, two passes
// (mean, then squared deviations) with the partial sums combined in rank
// order, into this block's z; with ``halos``, each block also writes its
// edge columns into its neighbours' z halos, and a cluster barrier makes
// them visible. Ends with a barrier.
__device__ __forceinline__ void layer_norm(const Block& s, const Dims& d,
                                           const float* g, const float* b,
                                           bool halos) {
  const int R = d.C * d.T, E = d.E;
  if (s.K == 1) {
    // one block holds the rows: each group of lanes keeps its row's
    // statistics in registers, with no partial sums and no barrier
    const int gl = row_lanes(s.width);
    const int groups = blockDim.x / gl, gid = threadIdx.x / gl,
              sub = threadIdx.x % gl;
    for (int r0 = 0; r0 < R; r0 += groups) {
      const int r = min(r0 + gid, R - 1);
      const float* row = s.y + r * s.ws;
      float sum = 0.0f;
      for (int e = sub; e < s.width; e += gl) sum += row[e];
      for (int o = gl / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / E;
      float sq = 0.0f;
      for (int e = sub; e < s.width; e += gl) {
        const float dv = row[e] - mu;
        sq += dv * dv;
      }
      for (int o = gl / 2; o > 0; o >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = 1.0f / sqrtf(sq / E + 1e-5f);
      if (r0 + gid < R)
        for (int e = sub; e < s.width; e += gl)
          s.z[r * s.zs + s.hl + e] = (row[e] - mu) * inv * g[s.e0 + e] +
                                     b[s.e0 + e];
    }
    __syncthreads();
    return;
  }
  row_partials<kSum>(s.y, s.ws, s.width, R, nullptr, s.psum);
  sync_all(s);
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    s.mean[r] = rank_sum(s.psum, r, s.K) / E;
  __syncthreads();
  row_partials<kSqDev>(s.y, s.ws, s.width, R, s.mean, s.psq);
  sync_all(s);
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    s.rstd[r] = 1.0f / sqrtf(rank_sum(s.psq, r, s.K) / E + 1e-5f);
  __syncthreads();
  const int hr = halo_right(d);
  const int w_left = s.rank > 0 ? slice_width(E, s.K, s.rank - 1) : 0;
  float* left = (halos && s.rank > 0) ? peer(s.z, s.rank - 1) : nullptr;
  float* right = (halos && s.rank + 1 < s.K) ? peer(s.z, s.rank + 1) : nullptr;
  const int gl = row_lanes(s.width);
  const int groups = blockDim.x / gl, gid = threadIdx.x / gl,
            sub = threadIdx.x % gl;
  for (int r = gid; r < R; r += groups) {
    const float mu = s.mean[r], inv = s.rstd[r];
    for (int e = sub; e < s.width; e += gl) {
      const float v = (s.y[r * s.ws + e] - mu) * inv * g[s.e0 + e] + b[s.e0 + e];
      s.z[r * s.zs + s.hl + e] = v;
      // the left neighbour's right halo, the right neighbour's left halo
      if (left != nullptr && e < hr) left[r * s.zs + s.hl + w_left + e] = v;
      if (right != nullptr && e >= s.width - s.hl)
        right[r * s.zs + e - (s.width - s.hl)] = v;
    }
  }
  if (halos)
    sync_all(s);
  else
    __syncthreads();
}

// y += src * gate (the SE gate of src over the whole cluster) or y += src
// without SE, on this block's columns. The squeeze: per-row sums (or
// maxima) of this block's columns, then per t over the channels in order,
// then over the cluster in rank order. Ends with a barrier of this block
// only: the other blocks may still be reading its SE partials, so a second
// call with no cluster barrier since the first must be preceded by one.
__device__ __forceinline__ void gated_residual(const Block& s, const Dims& d,
                                               const float* src,
                                               const float* se_w1,
                                               const float* se_w2) {
  const int T = d.T, R = d.C * d.T, H = d.H;
  if (d.use_se) {
    // s.mean is free between LayerNorms: the rows' partials
    if (d.use_max)
      row_partials<kMax>(src, s.ws, s.width, R, nullptr, s.mean);
    else
      row_partials<kSum>(src, s.ws, s.width, R, nullptr, s.mean);
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float v = d.use_max ? -INFINITY : 0.0f;
      for (int ci = 0; ci < d.C; ++ci)
        v = d.use_max ? fmaxf(v, s.mean[ci * T + t]) : v + s.mean[ci * T + t];
      s.pse[t] = v;
    }
    sync_all(s);
    if (T <= 32) {
      // one warp: lane t combines the squeeze, the hidden units are warp
      // sums over t, lane t's gate sums them over j
      if (threadIdx.x < 32) {
        const int t = threadIdx.x;
        float sqv = 0.0f, z = 0.0f;
        if (t < T)
          sqv = d.use_max ? rank_max(s.pse, t, s.K)
                          : rank_sum(s.pse, t, s.K) / (d.C * d.E);
        for (int j = 0; j < H; ++j) {
          const float h = fmaxf(warp_sum(t < T ? sqv * se_w1[t * H + j] : 0.0f),
                                0.0f);
          if (t < T) z += h * se_w2[j * T + t];
        }
        if (t < T) s.gate[t] = 1.0f / (1.0f + expf(-z));
      }
      __syncthreads();
    } else {
      for (int t = threadIdx.x; t < T; t += blockDim.x)
        s.sq[t] = d.use_max ? rank_max(s.pse, t, s.K)
                            : rank_sum(s.pse, t, s.K) / (d.C * d.E);
      __syncthreads();
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float h = 0.0f;
        for (int t = 0; t < T; ++t) h += s.sq[t] * se_w1[t * H + j];
        s.hid[j] = fmaxf(h, 0.0f);
      }
      __syncthreads();
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        float z = 0.0f;
        for (int j = 0; j < H; ++j) z += s.hid[j] * se_w2[j * T + t];
        s.gate[t] = 1.0f / (1.0f + expf(-z));
      }
      __syncthreads();
    }
  }
  const int gl = row_lanes(s.width);
  const int groups = blockDim.x / gl, gid = threadIdx.x / gl,
            sub = threadIdx.x % gl;
  for (int r = gid; r < R; r += groups) {
    const float gr = d.use_se ? s.gate[r % T] : 1.0f;
    for (int e = sub; e < s.width; e += gl) {
      const float v = src[r * s.ws + e];
      s.y[r * s.ws + e] += d.use_se ? v * gr : v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
conv_mixer_mc_kernel(const float* __restrict__ yin,
                     const float* __restrict__ w, float* __restrict__ out,
                     Dims d, int K, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int C = d.C, T = d.T, E = d.E, P = d.P, D = d.D;
  const int R = C * T;
  const long bs = block_stride(d);
  const int cp = padded_channels(C);
  const Smem lay(d, K);
  Block s;
  s.K = K;
  s.rank = cluster_rank();
  s.width = slice_width(E, K, s.rank);
  s.e0 = slice_start(E, K, s.rank);
  s.ws = max_width(E, K);
  s.zs = z_stride(d, K);
  s.hl = halo_left(d);
  s.sw = smem;                 // this mixer block's weights
  s.y = s.sw + lay.staged;     // residual stream (C, T, ws)
  s.z = s.y + lay.y;           // LN output (C, T, zs), halos
  s.c = s.z + lay.z;           // branch output (C, T, ws); decoder (P, ws)
  s.psum = s.c + lay.c;
  s.psq = s.psum + R;
  s.mean = s.psq + R;
  s.rstd = s.mean + R;
  s.pse = s.rstd + R;
  s.sq = s.pse + T;
  s.gate = s.sq + T;
  s.hid = s.gate + T;
  s.pout = s.hid + lay.hid;

  const long b = blockIdx.x / K;
  mmc::copy_rows_async(s.y, s.ws, yin + b * R * E + s.e0, E, R, s.width);
  // (the first staging below waits for these copies too)
  // zero halos: the plane's edges and past the slice stay zero
  for (long i = threadIdx.x; i < lay.z; i += blockDim.x) s.z[i] = 0.0f;

  for (int blk = 0; blk < d.nb; ++blk) {
    __syncthreads();  // the previous block's readers of sw are done
    mmc::copy_rows_async(s.sw, 0, w + blk * bs, 0, 1, (int)bs);
    mmc::copy_async_wait();
    __syncthreads();
    const float* ln1_g = s.sw;
    const float* ln1_b = ln1_g + E;
    const float* ln2_g = ln1_b + E;
    const float* ln2_b = ln2_g + E;
    const float* w1 = ln2_b + E;
    const float* w2 = w1 + C * d.kh1 * d.kw1 * cp;
    const float* scal = w2 + C * d.kh2 * d.kw2 * cp;
    const float* se_w1 = scal + 6 * cp;
    const float* se_w2 = se_w1 + T * d.H;

    layer_norm(s, d, ln1_g, ln1_b, true);
    conv(tile, s.z, s.zs, s.hl, s.c, s.ws, w1, scal, scal + cp, scal + 2 * cp,
         C, T, s.width, d.kh1, d.kw1, d.act);
    __syncthreads();
    gated_residual(s, d, s.c, se_w1, se_w2);

    if (d.twice) {
      layer_norm(s, d, ln2_g, ln2_b, true);
      conv(tile, s.z, s.zs, s.hl, s.c, s.ws, w2, scal + 3 * cp, scal + 4 * cp,
           scal + 5 * cp, C, T, s.width, d.kh2, d.kw2, d.act);
      __syncthreads();
      gated_residual(s, d, s.c, se_w1, se_w2);
    } else {
      // 'once': LN2/conv2 are identity, the shared SE still applies (once
      // every block has read the SE partials of the gate above)
      if (K > 1 && d.use_se) cluster_sync();
      gated_residual(s, d, s.y, se_w1, se_w2);
    }
  }

  const float* g_ln = w + d.nb * bs;
  const float* b_ln = g_ln + E;
  const float* w_time = b_ln + E;
  const float* b_time = w_time + T * P;
  const float* w_chan = b_time + P;
  const float* b_proj = w_chan + C;
  const float* w_out = b_proj + 1;
  const float* b_out = w_out + E * D;

  layer_norm(s, d, g_ln, b_ln, false);
  // per column: time projection T -> P plus its bias; then the channel
  // projection C -> 1 plus its bias and exact GELU (the decoder's
  // activation is GELU whatever the blocks use)
  for (int idx = threadIdx.x; idx < P * s.width; idx += blockDim.x) {
    const int p = idx / s.width, e = idx - p * s.width;
    float acc = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      float sum = 0.0f;
#pragma unroll 5
      for (int t = 0; t < T; ++t)
        sum += s.z[(ci * T + t) * s.zs + s.hl + e] * __ldg(w_time + t * P + p);
      acc += __ldg(w_chan + ci) * (sum + __ldg(b_time + p));
    }
    s.c[p * s.ws + e] = gelu_exact(acc + __ldg(b_proj));
  }
  __syncthreads();
  // fc_out over this block's columns, then the cluster's partials in rank
  // order; each block writes every K-th output
  const float* wo = w_out + (long)s.e0 * D;
  for (int idx = threadIdx.x; idx < P * D; idx += blockDim.x) {
    const int p = idx / D, o = idx - p * D;
    const float* dr = s.c + p * s.ws;
    float acc = 0.0f;
#pragma unroll 8
    for (int e = 0; e < s.width; ++e) acc += dr[e] * __ldg(wo + e * D + o);
    s.pout[idx] = acc;
  }
  sync_all(s);
  float* ob = out + b * P * D;
  for (int idx = s.rank + K * threadIdx.x; idx < P * D; idx += K * blockDim.x)
    ob[idx] = rank_sum(s.pout, idx, K) + __ldg(b_out + idx % D);
  sync_all(s);  // no block leaves while a neighbour reads its partials
}

}  // namespace

extern "C" {

long mmc_conv_mixer_mc_weights_numel(int C, int T, int E, int P, int D, int H,
                                     int nb, int kh1, int kw1, int kh2,
                                     int kw2) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return weights_numel(d);
}

// dynamic shared memory of one block of a K-block cluster
long mmc_conv_mixer_mc_smem_bytes(int C, int T, int E, int P, int D, int H,
                                  int nb, int kh1, int kw1, int kh2, int kw2,
                                  int K) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, 0, 0, 0, 0};
  return (long)smem_bytes(d, K);
}

// clusters of K blocks of ``threads`` threads and ``smem`` bytes of dynamic
// shared memory that fit the card at once (cudaOccupancyMaxActiveClusters);
// negative: minus the CUDA error
int mmc_conv_mixer_mc_max_clusters(int K, int threads, int smem) {
  int n = 0;
  const cudaError_t err =
      mmc::cluster_capacity(conv_mixer_mc_kernel, K, threads, smem, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// y (B, C, T, E), w packed weights, out (B, P, D); all float32 on the
// current device; one cluster of K blocks of ``threads`` threads per sample,
// stencil tile ``tile``. Returns the cudaError_t of the launch (0 on
// success).
int mmc_conv_mixer_mc(const float* y, const float* w, float* out, int B, int C,
                      int T, int E, int P, int D, int H, int nb, int kh1,
                      int kw1, int kh2, int kw2, int twice, int use_se,
                      int use_max, int act, int K, int threads, int tile,
                      void* stream) {
  Dims d{C, T, E, P, D, H, nb, kh1, kw1, kh2, kw2, twice, use_se, use_max, act};
  if (K < 1 || K > mmc::kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || tile < 0 || tile >= kTiles ||
      (K > 1 &&
       slice_width(E, K, K - 1) < max(max(halo_left(d), halo_right(d)), 1)))
    return (int)cudaErrorInvalidValue;
  return (int)mmc::launch_cluster(conv_mixer_mc_kernel, B, K, threads,
                                  smem_bytes(d, K), (cudaStream_t)stream, y, w,
                                  out, d, K, tile);
}

}  // extern "C"
