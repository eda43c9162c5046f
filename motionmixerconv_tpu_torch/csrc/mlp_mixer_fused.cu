// Fused MlpMixer forward (inference), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_mixer_kernel`
// (motionmixerconv_tpu/ops/pallas_mixer.py, called from FusedMlpMixer._run).
// Computes, for every sample x (T, D) (seq_len, input_size):
//   pose embed (T, D) @ (D, H) + b
//   num_blocks x [ token mixing: LN(H) per row -> over the transposed (H, T)
//                  tile fc1 (T -> tok) + b -> act -> fc2 (tok -> T), the two
//                  BatchNorms and fc2's bias folded as A[h] * (.) + P[t, h]
//                  -> shared SE gate over T -> residual
//                  (token_only: the reference's x + 2 * z, then next block);
//                  channel mixing: LN(H) -> fc1 (H -> ch) + b -> act -> fc2
//                  (ch -> H) folded as A[t] * (.) + P[t, h] -> SE ->
//                  residual (channel_only opens with x + se(x)) ]
//   -> LN(H) -> time upsample over the transposed tile (T -> P) + b
//   -> fc_out (H -> NC) + b.
// LayerNorm and the SE squeeze divide by the true widths; GELU uses erff.
//
// What bounds it on the H100: f32 multiply-adds. At the AMASS default
// (T 10, D 54, H 128, tok 20, ch 128, P 25, NC 54, 5 blocks) a sample needs
// ~4.34 MFLOP (the channel MLPs 3.28 of it) against 216 B in, 5.4 KB out and
// ~0.79 MB of packed weights shared by every sample; at B = 128 that is
// ~8.3 us of FMAs at 67 TFLOP/s and ~0.5 us of memory. Tensor cores are not
// used: TF32 keeps about three digits and the JAX kernel runs at
// Precision.HIGHEST. The TPU kernel pads every width to 128 lanes and holds
// all weights (16 MB of VMEM budget) next to a 32-sample tile; here the
// weights (~0.79 MB) exceed one block's 227 KB of shared memory, so they are
// read where they lie, through L1/L2, by every block.
//
// Design: one block of 512 threads per sample, so a batch of up to ~132
// samples spreads over the SMs; a block alone on its SM is bound by latency
// (barriers, weight stagings, shared-memory loads), so it brings as many
// warps as the registers allow. The sample's residual stream y (T, H), the
// LN/branch plane z (T, H), one hidden buffer and the SE vectors sit in
// shared memory (~23 KB at the AMASS shape); when they outgrow it (the
// wrapper decides, see Placement) the same code runs on a per-sample slice
// of a device scratch buffer (the kernel is instantiated for each
// placement, so the compiler sees shared-memory pointers where they are;
// __syncthreads orders global memory within the block too). Offsets within
// a sample and a matrix are 32-bit.
// Before each matmul the block copies its weight matrix (up to 64 KB at
// widths of 128) into a shared buffer with 16-byte loads, many in flight
// per thread, so the inner loop never waits on L2; a matrix larger than
// the buffer is read in place. Each matmul gives a thread one output column and
// a tile of up to 8 rows, sized to the rows it owns: per k it reads the
// weight W[k][j] (neighbouring lanes on neighbouring columns) and the
// activations a[r][k] by broadcast. Device memory is read once per input
// and written once per output element; every block reads the weights from
// L2.
//
// Packed weight layout (floats; must match ops/mlp_mixer.py `layout`):
//   w_embed[D*H] (d*H + h) b_embed[H]
//   per block: [token part] ln1_g[H] ln1_b[H] tok_w1[T*tok] (t*tok + k)
//                tok_b1[tok] tok_w2[tok*T] (k*T + t) tok_A[H] tok_P[T*H]
//              se_w1[T*S] (t*S + j) se_w2[S*T] (j*T + t)
//              [channel part] ln2_g[H] ln2_b[H] ch_w1[H*ch] (h*ch + c)
//                ch_b1[ch] ch_w2[ch*H] (c*H + h) ch_A[T] ch_P[T*H]
//     (the token part only when block_type != channel_only, the channel
//      part only when block_type != token_only; S = 0 without SE)
//   g_ln[H] b_ln[H] w_time[T*P] (t*P + p) b_time[P] w_out[H*NC] (h*NC + c)
//   b_out[NC]

#include <cuda_runtime.h>
#include <math.h>

#include "device_math.cuh"

namespace {

using mmc::activation;
using mmc::layer_norm_rows;
using mmc::warp_max;
using mmc::warp_sum;

constexpr int kThreads = 512;
constexpr int kRowTile = 8;  // rows a thread accumulates per pass

enum BlockType { kNormal = 0, kChannelOnly = 1, kTokenOnly = 2 };
enum Epilogue { kBias = 0, kBiasAct = 1, kFold = 2 };

struct Dims {
  int T, D, H, P, NC, tok, ch, S, nb, block_type, use_se, use_max, act;
};

// Where a block's memory goes, decided by the wrapper (ops/mlp_mixer.py
// MlpMixerSpec, the one owner of the placement): act_floats, a sample's
// working set; in_scratch, the activations live in the device scratch
// buffer (act_floats per sample) instead of shared memory; wbuf_offset,
// the 16-byte-aligned float offset of the weight buffer in shared memory;
// wbuf_floats, its size (0: every matrix is read in place).
struct Placement {
  int act_floats, in_scratch, wbuf_offset, wbuf_floats;
};

__device__ inline bool has_tok(const Dims& d) {
  return d.block_type != kChannelOnly;
}

__device__ inline bool has_ch(const Dims& d) {
  return d.block_type != kTokenOnly;
}

__device__ inline long block_floats(const Dims& d) {
  const long T = d.T, H = d.H;
  long n = 2 * T * d.S;
  if (has_tok(d)) n += 2 * H + T * d.tok + d.tok + (long)d.tok * T + H + T * H;
  if (has_ch(d)) n += 2 * H + H * d.ch + d.ch + (long)d.ch * H + T + T * H;
  return n;
}

// W (n floats) copied into the 16-byte-aligned shared buffer wbuf at W's
// own 16-byte phase, so the body moves as float4 with every thread's loads
// in flight together (kStaged: the buffer holds the largest matrix plus 3
// floats); W itself without a buffer. Both paths leave every thread past a
// barrier.
template <bool kStaged>
__device__ const float* stage(const float* __restrict__ W, long n,
                              float* wbuf) {
  __syncthreads();  // earlier readers of wbuf are done
  if (!kStaged) return W;
  const int phase = (int)(((size_t)W >> 2) & 3);
  float* dst = wbuf + phase;
  const long to_aligned = (4 - phase) & 3;
  const long head = to_aligned < n ? to_aligned : n;
  const long nv = (n - head) / 4;
  const float4* src4 = reinterpret_cast<const float4*>(W + head);
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (long i = threadIdx.x; i < head; i += kThreads) dst[i] = __ldg(W + i);
#pragma unroll 8
  for (long v = threadIdx.x; v < nv; v += kThreads) dst4[v] = __ldg(src4 + v);
  for (long i = head + 4 * nv + threadIdx.x; i < n; i += kThreads)
    dst[i] = __ldg(W + i);
  __syncthreads();
  return dst;
}

// One thread's tile: rows r0, r0 + rstep, ... (RB of them) of column j,
// over k < K; then the epilogue and the store.
template <int RB>
__device__ void matmul_tile(const float* a, int r0, int rows_step, int ars,
                            int aks, int K, const float* W, int N, int j,
                            float* out, int ors, int ocs, int epi,
                            const float* __restrict__ bias, int act,
                            const float* __restrict__ A,
                            const float* __restrict__ Pl) {
  float acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = 0.0f;
  const float* ar = a + r0 * ars;
  const int rstep = rows_step * ars;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float w = W[k * N + j];
    const float* ak = ar + k * aks;
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = fmaf(ak[i * rstep], w, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = r0 + rows_step * i;
    const int o = r * ors + j * ocs;
    float v = acc[i];
    if (epi == kFold) {
      v = __fadd_rn(__fmul_rn(v, __ldg(A + r)), __ldg(Pl + o));
    } else {
      v += __ldg(bias + j);
      if (epi == kBiasAct) v = activation(v, act);
    }
    out[o] = v;
  }
}

// out[r * ors + j * ocs] = epi(sum_k a[r * ars + k * aks] * W[k * N + j])
// for r < R, j < N, where epi adds bias[j] (kBias), then applies the
// activation (kBiasAct), or is the BatchNorm fold A[r] * v + Pl[out offset]
// (kFold). W is staged into wbuf (kStaged); bias, A and Pl are packed
// weights (read-only); a and out are the block's activations. Threads take
// one column each and row tiles. Ends with a barrier.
template <bool kStaged>
__device__ void matmul(const float* a, int ars, int aks, int R, int K,
                       const float* __restrict__ W_global, int N, float* out,
                       int ors, int ocs, int epi,
                       const float* __restrict__ bias, int act,
                       const float* __restrict__ A,
                       const float* __restrict__ Pl, float* wbuf) {
  const float* W = stage<kStaged>(W_global, (long)K * N, wbuf);
  int groups, g, j0, jstep;
  if (N >= kThreads) {
    groups = 1, g = 0, j0 = threadIdx.x, jstep = kThreads;
  } else {
    groups = kThreads / N, g = threadIdx.x / N;
    j0 = threadIdx.x - g * N, jstep = N;
  }
  if (g < groups) {
    for (int j = j0; j < N; j += jstep) {
      for (int r0 = g; r0 < R; r0 += groups * kRowTile) {
        const int left = (R - 1 - r0) / groups + 1;  // rows of this thread
        const int rb = left < kRowTile ? left : kRowTile;
#define MMC_TILE(n)                                                        \
  case n:                                                                  \
    matmul_tile<n>(a, r0, groups, ars, aks, K, W, N, j, out, ors, ocs, epi, \
                   bias, act, A, Pl);                                      \
    break;
        switch (rb) {
          MMC_TILE(1) MMC_TILE(2) MMC_TILE(3) MMC_TILE(4)
          MMC_TILE(5) MMC_TILE(6) MMC_TILE(7) MMC_TILE(8)
        }
#undef MMC_TILE
      }
    }
  }
  __syncthreads();
}

// gate[t] = sigmoid(W2^T relu(W1^T squeeze(src)))[t], the squeeze being the
// mean or the max of row t of src (T, H). Ends with a barrier.
__device__ void se_gate(const float* src, const float* __restrict__ w1,
                        const float* __restrict__ w2, float* sq, float* gate,
                        float* hid, const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int T = d.T, H = d.H, S = d.S;
  for (int t = warp; t < T; t += n_warps) {
    const float* row = src + (long)t * H;
    if (d.use_max) {
      float m = -INFINITY;
      for (int h = lane; h < H; h += 32) m = fmaxf(m, row[h]);
      m = warp_max(m);
      if (lane == 0) sq[t] = m;
    } else {
      float s = 0.0f;
      for (int h = lane; h < H; h += 32) s += row[h];
      s = warp_sum(s);
      if (lane == 0) sq[t] = s / H;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    float h = 0.0f;
    for (int t = 0; t < T; ++t) h = fmaf(sq[t], __ldg(w1 + (long)t * S + j), h);
    hid[j] = fmaxf(h, 0.0f);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float z = 0.0f;
    for (int j = 0; j < S; ++j)
      z = fmaf(hid[j], __ldg(w2 + (long)j * T + t), z);
    gate[t] = 1.0f / (1.0f + expf(-z));
  }
  __syncthreads();
}

// y += z (gated by SE of z when SE is on), `times` times (the token-only
// block's double residual adds the same z twice). Ends with a barrier.
__device__ void residual(float* y, const float* z, int times,
                         const float* se_w1, const float* se_w2, float* sq,
                         float* gate, float* hid, const Dims& d) {
  const long n = (long)d.T * d.H;
  if (d.use_se) se_gate(z, se_w1, se_w2, sq, gate, hid, d);
  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = d.use_se ? __fmul_rn(z[i], gate[i / d.H]) : z[i];
    float acc = __fadd_rn(y[i], v);
    if (times == 2) acc = __fadd_rn(acc, v);
    y[i] = acc;
  }
  __syncthreads();
}

// kScratch: the activations live in scratch (pl.in_scratch); kStaged: the
// weight buffer exists (pl.wbuf_floats > 0) and holds every matrix in turn.
// A sample's working set: the SE squeeze and gate (T each) and hidden
// (max(S, 1)), the residual stream y and the LN/branch plane z (T, H each),
// then the hidden buffer (the MLP hiddens; the upsampled (P, H)).
template <bool kScratch, bool kStaged>
__global__ void __launch_bounds__(kThreads)
mlp_mixer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, float* scratch, Dims d,
                 Placement pl) {
  extern __shared__ __align__(16) float smem[];
  const int T = d.T, D = d.D, H = d.H, P = d.P, NC = d.NC;
  const long b = blockIdx.x;
  float* sq = kScratch ? scratch + b * pl.act_floats : smem;
  float* gate = sq + T;
  float* hid = gate + T;
  float* y = hid + (d.S > 0 ? d.S : 1);
  float* z = y + (long)T * H;
  float* buf = z + (long)T * H;
  float* wbuf = smem + pl.wbuf_offset;

  // pose embed: (T, D) @ (D, H) + b, straight from the input
  matmul<kStaged>(x + b * T * D, D, 1, T, D, w, H, y, H, 1, kBias,
                  w + (long)D * H, 0, nullptr, nullptr, wbuf);

  const float* wb = w + (long)D * H + H;
  const long bs = block_floats(d);
  for (int blk = 0; blk < d.nb; ++blk) {
    const float* p = wb + blk * bs;
    const float *ln1_g = nullptr, *ln1_b = nullptr, *tok_w1 = nullptr,
                *tok_b1 = nullptr, *tok_w2 = nullptr, *tok_A = nullptr,
                *tok_P = nullptr;
    if (has_tok(d)) {
      ln1_g = p;
      ln1_b = ln1_g + H;
      tok_w1 = ln1_b + H;
      tok_b1 = tok_w1 + (long)T * d.tok;
      tok_w2 = tok_b1 + d.tok;
      tok_A = tok_w2 + (long)d.tok * T;
      tok_P = tok_A + H;
      p = tok_P + (long)T * H;
    }
    const float* se_w1 = p;
    const float* se_w2 = se_w1 + (long)T * d.S;
    p = se_w2 + (long)d.S * T;
    const float *ln2_g = p, *ln2_b = p + H, *ch_w1 = ln2_b + H;
    const float* ch_b1 = ch_w1 + (long)H * d.ch;
    const float* ch_w2 = ch_b1 + d.ch;
    const float* ch_A = ch_w2 + (long)d.ch * H;
    const float* ch_P = ch_A + T;

    if (has_tok(d)) {
      layer_norm_rows(y, z, ln1_g, ln1_b, T, H, H);
      // (the matmul's staging barrier orders the LN before its reads)
      // over the transposed tile: row h of z^T is column h of z
      matmul<kStaged>(z, 1, H, H, T, tok_w1, d.tok, buf, d.tok, 1, kBiasAct,
                      tok_b1, d.act, nullptr, nullptr, wbuf);
      // fc2 back to T, written transposed into z as (T, H)
      matmul<kStaged>(buf, d.tok, 1, H, d.tok, tok_w2, T, z, 1, H, kFold,
                      nullptr, 0, tok_A, tok_P, wbuf);
      residual(y, z, d.block_type == kTokenOnly ? 2 : 1, se_w1, se_w2, sq,
               gate, hid, d);
      if (d.block_type == kTokenOnly) continue;
    } else {
      // the channel-only block's leading x + se(x) (x + x without SE)
      residual(y, y, 1, se_w1, se_w2, sq, gate, hid, d);
    }
    layer_norm_rows(y, z, ln2_g, ln2_b, T, H, H);
    matmul<kStaged>(z, H, 1, T, H, ch_w1, d.ch, buf, d.ch, 1, kBiasAct, ch_b1,
                    d.act, nullptr, nullptr, wbuf);
    matmul<kStaged>(buf, d.ch, 1, T, d.ch, ch_w2, H, z, H, 1, kFold, nullptr,
                    0, ch_A, ch_P, wbuf);
    residual(y, z, 1, se_w1, se_w2, sq, gate, hid, d);
  }

  const float* g_ln = wb + d.nb * bs;
  const float* b_ln = g_ln + H;
  const float* w_time = b_ln + H;
  const float* b_time = w_time + (long)T * P;
  const float* w_out = b_time + P;
  const float* b_out = w_out + (long)H * NC;
  layer_norm_rows(y, z, g_ln, b_ln, T, H, H);
  // time upsample over the transposed tile: (H, T) @ (T, P) + b, stored
  // as (P, H)
  matmul<kStaged>(z, 1, H, H, T, w_time, P, buf, 1, H, kBias, b_time, 0,
                  nullptr, nullptr, wbuf);
  matmul<kStaged>(buf, H, 1, P, H, w_out, NC, out + b * P * NC, NC, 1, kBias,
                  b_out, 0, nullptr, nullptr, wbuf);
}

}  // namespace

extern "C" {

// x (B, T, D), w packed weights, out (B, P, NC); all float32 on the current
// device. scratch: B * act_floats floats of device memory for the
// activations when in_scratch, else unused (may be nullptr). Returns the
// cudaError_t of the launch (0 on success).
int mmc_mlp_mixer(const float* x, const float* w, float* out, float* scratch,
                  int B, int T, int D, int H, int P, int NC, int tok, int ch,
                  int S, int nb, int block_type, int use_se, int use_max,
                  int act, int act_floats, int in_scratch, int wbuf_offset,
                  int wbuf_floats, void* stream) {
  const Dims d{T, D, H, P, NC, tok, ch, S, nb, block_type, use_se, use_max,
               act};
  const Placement pl{act_floats, in_scratch, wbuf_offset, wbuf_floats};
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)wbuf_offset + wbuf_floats);
  void (*kernel)(const float*, const float*, float*, float*, Dims,
                 Placement) =
      in_scratch ? (wbuf_floats ? mlp_mixer_kernel<true, true>
                                : mlp_mixer_kernel<true, false>)
                 : (wbuf_floats ? mlp_mixer_kernel<false, true>
                                : mlp_mixer_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(x, w, out, scratch, d,
                                                       pl);
  return (int)cudaGetLastError();
}

}  // extern "C"
