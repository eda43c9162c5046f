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
// What bounds it on the H100: a sample is a chain of dependent steps. At
// the AMASS default (T 10, D 54, H 128, tok 20, ch 128, P 25, NC 54, 5
// blocks) a sample needs ~4.34 MFLOP (the channel MLPs 3.28 of it) against
// 216 B in, 5.4 KB out and ~0.79 MB of packed weights shared by every
// sample; at B = 128 that is ~8.3 us of FMAs at 67 TFLOP/s. One block a
// sample keeps a sample's steps on one SM, so the time is that chain: the
// tile loops' shared loads and multiply-adds, the passes that finish each
// matmul's outputs, the residual passes and the barriers between them.
// Tensor cores are not used: TF32 keeps about three digits and the JAX
// kernel runs at Precision.HIGHEST.
//
// Design: one block of 512 threads a sample.
// - Matmuls are register-tiled: a thread owns RT rows x 4 columns (the
//   columns nt apart, nt = ceil(N / 4), so a warp's weight loads fall on
//   consecutive words and its activation loads are broadcasts); per k it
//   makes one load per row and one per column for 4 RT multiply-adds.
//   Where R x N gives too few tiles for the block (the channel MLP at
//   T = 10: 1,280 outputs) the K range is split over ks thread groups. The
//   tiles store raw sums; one pass after a barrier adds a tile's K slices
//   in slice order (repeats are bit-identical, no float atomics) and
//   applies the epilogue (bias, activation, or the BatchNorm fold). The
//   host picks (RT, ks) per matmul (`pick`) for the shortest chain a
//   thread runs: the channel MLPs at the AMASS shape take 5 x 4 tiles in 8
//   K slices, 9 shared loads for 20 multiply-adds (0.45 a multiply-add,
//   against ~1.3 in the kernel before).
// - Weights move by TMA: a 1-D bulk copy (cp.async.bulk, completing on an
//   mbarrier) of each weight matrix into one of two shared buffers starts
//   as soon as the matmul that last used that buffer has ended, issued by
//   the block's last thread (its warp is the one most often idle next), so
//   the next matrix lands while the current one is in use; a matmul waits
//   on its buffer's mbarrier, not at a block barrier. The packed buffer
//   holds every piece at a 16-byte boundary for that. Where two buffers do
//   not fit beside the activations one is used (the copy then overlaps
//   only the steps between matmuls); where none fits the matrices are read
//   in place (the wrapper decides: Placement).
// - The pass that finishes each fc2 also takes the SE squeezes of its (T,
//   H) output, a warp a row; the SE gate, the residual add and the next
//   LayerNorm (one pass of sums shifted by the row's first value) are then
//   one pass, a warp a row.
// Barriers per normal block at the AMASS shape: 10 (two per matmul: after
// its tiles and after its pass; one per residual pass), against 20 in the
// kernel before (its weight stagings, matmuls, SE gates and residuals);
// 58 per sample against ~109. The sample's residual stream y and LN/branch
// plane z (T, H), one hidden buffer, the split-K partials and the SE
// squeeze sit in shared memory (~72 KB at the AMASS shape) or, when they
// outgrow it, in a per-sample slice of a device scratch buffer (the kernel
// is instantiated for each placement; __syncthreads orders global memory
// within the block too). Offsets within a sample and a matrix are 32-bit.
//
// Packed weight layout (floats; must match ops/mlp_mixer.py `layout`;
// every piece padded to a multiple of 4 floats):
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
#include <stdint.h>

#include "device_math.cuh"

namespace {

using mmc::activation;
using mmc::warp_max;
using mmc::warp_sum;

constexpr int kThreads = 512;
constexpr int kMaxRowTile = 5;

enum BlockType { kNormal = 0, kChannelOnly = 1, kTokenOnly = 2 };
enum EpiKind { kBias = 0, kBiasAct = 1, kFold = 2 };

struct Dims {
  int T, D, H, P, NC, tok, ch, S, nb, block_type, use_se, use_max, act;
};

// Where a block's memory goes, decided by the wrapper (ops/mlp_mixer.py
// MlpMixerSpec, the one owner of the placement): act_floats, a sample's
// working set; in_scratch, the activations live in the device scratch
// buffer (act_floats per sample) instead of shared memory; part_floats,
// the split-K partials' share of the working set; nbuf, the shared weight
// buffers (2: the next matrix is copied while the current one is used; 1;
// 0: every matrix is read in place); wbuf_floats, a buffer's size.
struct Placement {
  int act_floats, in_scratch, part_floats, nbuf, wbuf_floats;
};

// A matmul's launch within the block: rt rows a thread, K split ks ways.
struct MM {
  int rt, ks;
};
// embed, token fc1, token fc2, channel fc1, channel fc2, time upsample,
// fc_out
struct Plan {
  MM embed, tok1, tok2, ch1, ch2, time, out;
};

__host__ __device__ inline long pad4(long n) { return (n + 3) & ~3L; }

__host__ __device__ inline bool has_tok(const Dims& d) {
  return d.block_type != kChannelOnly;
}

__host__ __device__ inline bool has_ch(const Dims& d) {
  return d.block_type != kTokenOnly;
}

__host__ __device__ inline long tok_floats(const Dims& d) {
  const long T = d.T, H = d.H;
  return 2 * pad4(H) + pad4(T * d.tok) + pad4(d.tok) + pad4((long)d.tok * T) +
         pad4(H) + pad4(T * H);
}

__host__ __device__ inline long ch_floats(const Dims& d) {
  const long T = d.T, H = d.H;
  return 2 * pad4(H) + pad4(H * d.ch) + pad4(d.ch) + pad4((long)d.ch * H) +
         pad4(T) + pad4(T * H);
}

__host__ __device__ inline long block_floats(const Dims& d) {
  return (has_tok(d) ? tok_floats(d) : 0) + 2 * pad4((long)d.T * d.S) +
         (has_ch(d) ? ch_floats(d) : 0);
}

// The pieces of block blk (pointers into the packed weights w)
struct BlockW {
  const float *ln1_g, *ln1_b, *tok_w1, *tok_b1, *tok_w2, *tok_A, *tok_P;
  const float *se_w1, *se_w2;
  const float *ln2_g, *ln2_b, *ch_w1, *ch_b1, *ch_w2, *ch_A, *ch_P;
};

__device__ __forceinline__ BlockW block_weights(const Dims& d, const float* w, int blk) {
  const long T = d.T, H = d.H;
  const float* p = w + pad4((long)d.D * H) + pad4(H) + blk * block_floats(d);
  BlockW b{};
  if (has_tok(d)) {
    b.ln1_g = p;
    b.ln1_b = b.ln1_g + pad4(H);
    b.tok_w1 = b.ln1_b + pad4(H);
    b.tok_b1 = b.tok_w1 + pad4(T * d.tok);
    b.tok_w2 = b.tok_b1 + pad4(d.tok);
    b.tok_A = b.tok_w2 + pad4((long)d.tok * T);
    b.tok_P = b.tok_A + pad4(H);
    p = b.tok_P + pad4(T * H);
  }
  b.se_w1 = p;
  b.se_w2 = b.se_w1 + pad4(T * d.S);
  p = b.se_w2 + pad4(T * d.S);
  if (has_ch(d)) {
    b.ln2_g = p;
    b.ln2_b = b.ln2_g + pad4(H);
    b.ch_w1 = b.ln2_b + pad4(H);
    b.ch_b1 = b.ch_w1 + pad4(H * d.ch);
    b.ch_w2 = b.ch_b1 + pad4(d.ch);
    b.ch_A = b.ch_w2 + pad4((long)d.ch * H);
    b.ch_P = b.ch_A + pad4(T);
  }
  return b;
}

__device__ __forceinline__ const float* head_weights(const Dims& d, const float* w) {
  return w + pad4((long)d.D * d.H) + pad4(d.H) + d.nb * block_floats(d);
}

// Weight matrix m of the kernel's order (embed; per block tok_w1, tok_w2,
// ch_w1, ch_w2 as the block type has them; w_time; w_out) and its padded
// size in floats; nullptr past the last.
__device__ __forceinline__ const float* matrix(const Dims& d, const float* w,
                                              int m, long* n) {
  const long T = d.T, H = d.H;
  auto give = [n](const float* p, long size) {
    *n = pad4(size);
    return p;
  };
  if (m == 0) return give(w, (long)d.D * H);
  --m;
  const int per = 2 * (has_tok(d) + has_ch(d));
  if (m < d.nb * per) {
    const BlockW b = block_weights(d, w, m / per);
    int k = m % per;
    if (has_tok(d)) {
      if (k == 0) return give(b.tok_w1, T * d.tok);
      if (k == 1) return give(b.tok_w2, (long)d.tok * T);
      k -= 2;
    }
    return k == 0 ? give(b.ch_w1, H * d.ch) : give(b.ch_w2, (long)d.ch * H);
  }
  m -= d.nb * per;
  const float* w_time = head_weights(d, w) + 2 * pad4(H);
  if (m == 0) return give(w_time, T * d.P);
  if (m == 1) return give(w_time + pad4(T * d.P) + pad4(d.P), H * d.NC);
  return nullptr;
}

// ---- TMA bulk copies into shared memory, completing on mbarriers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one thread: copy n floats (a multiple of 4, 16-byte aligned at both
// ends) from src to dst; bar completes its phase when they have landed
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          long n, uint64_t* bar) {
  const unsigned bytes = (unsigned)(4 * n);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The weight matrices in kernel order, through nbuf shared buffers (or in
// place when nbuf is 0). Matrix m uses buffer m % nbuf; its copy starts
// when matrix m - nbuf's matmul has ended.
template <bool kInPlace>
struct Weights {
  const float* w;
  float* wbuf;
  uint64_t* bars;
  int nbuf, wbuf_floats, m;

  __device__ __forceinline__ void issue(const Dims& d, int k) {
    long n;
    const float* src = matrix(d, w, k, &n);
    if (src != nullptr)
      bulk_load(wbuf + (long)(k % nbuf) * wbuf_floats, src, n, bars + k % nbuf);
  }
  // thread 0 starts the first copies (after the mbarriers' init barrier)
  __device__ __forceinline__ void start(const Dims& d) {
    if (!kInPlace && threadIdx.x == 0)
      for (int k = 0; k < nbuf; ++k) issue(d, k);
  }
  // the next matrix, landed; W_global where it is read in place
  __device__ __forceinline__ const float* acquire(const float* W_global) {
    if (kInPlace) return W_global;
    mbar_wait(bars + m % nbuf, (unsigned)((m / nbuf) & 1));
    return wbuf + (long)(m % nbuf) * wbuf_floats;
  }
  // after the matmul's closing barrier: its buffer takes matrix m + nbuf.
  // The block's last thread starts the copy: its warp is the one most
  // often idle in the step that follows (a small matmul's spare threads,
  // the rows past T of a residual pass), so the issue stays off the chain.
  __device__ __forceinline__ void release(const Dims& d) {
    if (!kInPlace && threadIdx.x == kThreads - 1) issue(d, m + nbuf);
    ++m;
  }
};

struct Epi {
  int kind;
  const float* bias;  // kBias, kBiasAct: per column
  int act;
  const float* A;     // kFold: per row
  const float* Pl;    // kFold: per output offset
};

__device__ __forceinline__ float epilogue(float v, int r, int j, int o,
                                          const Epi& e) {
  if (e.kind == kFold)
    return __fadd_rn(__fmul_rn(v, __ldg(e.A + r)), __ldg(e.Pl + o));
  v += __ldg(e.bias + j);
  return e.kind == kBiasAct ? activation(v, e.act) : v;
}

// The value of output (r, j) at offset o: the raw sum (in out when K is
// not split, else the slices in part, added in slice order), then the
// epilogue
__device__ __forceinline__ float finish(const float* out, const float* part,
                                        int ks, int rn, int idx, int r, int j,
                                        int o, const Epi& epi) {
  float v;
  if (ks == 1) {
    v = out[o];
  } else {
    v = part[idx];
    for (int s = 1; s < ks; ++s) v += part[s * rn + idx];
  }
  return epilogue(v, r, j, o, epi);
}

// The raw sums sum_k a[r * ars + k * aks] * W[k * N + j] for r < R, j < N:
// RT rows x 4 columns (nt apart) a tile, K in ks slices; stored into
// out[r * ors + j * ocs] when K is not split, else slice by slice into
// part, for `finish_pass` (so the unrolled tile code carries no
// epilogue). Ends with a barrier.
template <int RT>
__device__ __forceinline__ void mm_tiles(const float* a, int ars, int aks,
                                         int R, int K, const float* W, int N,
                                         int ks, float* out, int ors, int ocs,
                                         float* part) {
  const int nt = (N + 3) >> 2, rg = (R + RT - 1) / RT;
  const int tiles = rg * nt, kl = (K + ks - 1) / ks;
  for (int task = threadIdx.x; task < tiles * ks; task += kThreads) {
    const int s = task / tiles, tile = task - s * tiles;
    const int g = tile / nt, j = tile - g * nt;
    const int r0 = g * RT, k0 = s * kl, k1 = min(K, k0 + kl);
    int ro[RT], jc[4];
#pragma unroll
    for (int i = 0; i < RT; ++i) ro[i] = min(r0 + i, R - 1) * ars;
#pragma unroll
    for (int c = 0; c < 4; ++c) jc[c] = min(j + c * nt, N - 1);
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float* wk = W + k * N;
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = wk[jc[c]];
      const float* ak = a + k * aks;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float av = ak[ro[i]];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av, wv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + i, jj = j + c * nt;
        if (r >= R || jj >= N) continue;
        if (ks == 1)
          out[r * ors + jj * ocs] = acc[i][c];
        else
          part[(s * R + r) * N + jj] = acc[i][c];
      }
  }
  __syncthreads();
}

// The pass after a matmul's tiles: every output's slices added and its
// epilogue applied. With sq, out is the (T, H) plane the SE squeezes next
// (matmul rows are its rows when ocs == 1, else its columns): a warp takes
// a row of it and leaves the row's squeeze (mean or max over H) in sq[t].
// Ends with a barrier.
__device__ __forceinline__ void finish_pass(float* out, int ors, int ocs,
                                            const float* part, int ks, int R,
                                            int N, const Epi& epi, float* sq,
                                            const Dims& d) {
  const int rn = R * N;
  if (sq != nullptr) {
    const int lane = threadIdx.x & 31, H = d.H;
    for (int t = threadIdx.x >> 5; t < d.T; t += kThreads >> 5) {
      float red = d.use_max ? -INFINITY : 0.0f;
      for (int h = lane; h < H; h += 32) {
        const int r = ocs == 1 ? t : h, jj = ocs == 1 ? h : t;
        const int o = t * H + h;
        const float v = finish(out, part, ks, rn, r * N + jj, r, jj, o, epi);
        out[o] = v;
        red = d.use_max ? fmaxf(red, v) : red + v;
      }
      red = d.use_max ? warp_max(red) : warp_sum(red) / H;
      if (lane == 0) sq[t] = red;
    }
  } else {
    for (int idx = threadIdx.x; idx < rn; idx += kThreads) {
      const int r = idx / N, jj = idx - r * N, o = r * ors + jj * ocs;
      out[o] = finish(out, part, ks, rn, idx, r, jj, o, epi);
    }
  }
  __syncthreads();
}

// One matmul of the kernel's order: its weights acquired from `wts`, its
// tiles run as `mm`, the pass that finishes its outputs (and, with sq,
// takes the SE squeezes of its (T, H) output), its buffer released after
// the closing barrier.
template <bool kInPlace>
__device__ __forceinline__ void matmul(Weights<kInPlace>& wts, const Dims& d, MM mm, const float* a,
                       int ars, int aks, int R, int K,
                       const float* __restrict__ W_global, int N, float* out,
                       int ors, int ocs, const Epi& epi, float* part,
                       float* sq = nullptr) {
  const float* W = wts.acquire(W_global);
#define MMC_TILES(n)                                                 \
  case n:                                                            \
    mm_tiles<n>(a, ars, aks, R, K, W, N, mm.ks, out, ors, ocs, part); \
    break;
  switch (mm.rt) {
    MMC_TILES(1) MMC_TILES(2) MMC_TILES(3) MMC_TILES(4) MMC_TILES(5)
  }
#undef MMC_TILES
  finish_pass(out, ors, ocs, part, mm.ks, R, N, epi, sq, d);
  wts.release(d);
}

// z[t, :] = LN(y[t, :]) g + b over H (eps 1e-5; mean, then squared
// deviations), a warp a row; ends with a barrier
__device__ __forceinline__ void ln_rows(const float* y, float* z, const float* __restrict__ g,
                        const float* __restrict__ b, const Dims& d) {
  mmc::layer_norm_rows(y, z, g, b, d.T, d.H, d.H);
  __syncthreads();
}

// y += src * gate (`times` times: the token-only block adds it twice),
// gate[t] = sigmoid(W2^T relu(W1^T squeeze(src)))[t] with SE (1 without),
// the squeeze being the mean or max of row t of src (T, H), already in sq
// when `squeezed` (the matmul that wrote src took them); then, with ln_g,
// z = LN(y) g + b. A warp a row; src may be y, or z when the LayerNorm
// overwrites it (each row stays with its warp). One barrier after the
// squeezes (when they are taken here), one at the end.
__device__ __forceinline__ void residual_ln(float* y, const float* src, int times,
                            const float* __restrict__ se_w1,
                            const float* __restrict__ se_w2, float* sq,
                            bool squeezed,
                            const float* __restrict__ ln_g,
                            const float* __restrict__ ln_b, float* z,
                            const Dims& d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = kThreads >> 5;
  const int T = d.T, H = d.H, S = d.S;
  if (d.use_se && !squeezed) {
    for (int t = warp; t < T; t += n_warps) {
      const float* row = src + t * H;
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
  }
  for (int t = warp; t < T; t += n_warps) {
    float gate = 1.0f;
    if (d.use_se) {
      float zt = 0.0f;
      for (int j = lane; j < S; j += 32) {
        float h = 0.0f;
#pragma unroll 4
        for (int u = 0; u < T; ++u) h = fmaf(sq[u], __ldg(se_w1 + u * S + j), h);
        zt = fmaf(fmaxf(h, 0.0f), __ldg(se_w2 + j * T + t), zt);
      }
      gate = 1.0f / (1.0f + expf(-warp_sum(zt)));
    }
    float* yr = y + t * H;
    const float* sr = src + t * H;
    auto updated = [&](int h) {
      const float v = d.use_se ? __fmul_rn(sr[h], gate) : sr[h];
      const float acc = __fadd_rn(yr[h], v);
      return times == 2 ? __fadd_rn(acc, v) : acc;
    };
    // the LayerNorm's sums shifted by the row's first new value x0, one
    // pass (as in conv_mixer_fused.cu): mean - x0 = S1 / H, var = S2 / H -
    // (S1 / H)^2, within ~(H + 1) ulps since x0 lies in the row
    const float x0 = updated(0);
    __syncwarp();  // every lane has read y[t, 0] before lane 0 updates it
    float s = 0.0f, q = 0.0f;
    for (int h = lane; h < H; h += 32) {
      const float acc = updated(h);
      yr[h] = acc;
      const float u = acc - x0;
      s += u;
      q = fmaf(u, u, q);
    }
    if (ln_g == nullptr) continue;
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    const float m = s / H;
    const float inv = 1.0f / sqrtf(fmaxf(q / H - m * m, 0.0f) + 1e-5f);
    for (int h = lane; h < H; h += 32)
      z[t * H + h] = ((yr[h] - x0) - m) * inv * __ldg(ln_g + h) + __ldg(ln_b + h);
  }
  __syncthreads();
}

// kScratch: the activations live in scratch (pl.in_scratch); kInPlace: no
// weight buffer (pl.nbuf == 0). The kernel is instantiated for each
// placement, so the compiler sees shared-memory pointers where they are.
// Shared memory: two mbarriers, then (unless in scratch) a sample's working
// set -- the SE squeeze (T), the residual stream y and the LN/branch plane
// z (T, H each), the hidden buffer (the MLP hiddens; the upsampled (P,
// H)), the split-K partials -- then the weight buffers; every piece
// 16-byte aligned.
template <bool kScratch, bool kInPlace>
__global__ void __launch_bounds__(kThreads)
mlp_mixer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, float* scratch, Dims d,
                 Placement pl, Plan plan) {
  extern __shared__ __align__(16) float smem[];
  const int T = d.T, D = d.D, H = d.H, P = d.P, NC = d.NC;
  const long b = blockIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* act = kScratch ? scratch + b * pl.act_floats : smem + 4;
  float* sq = act;
  float* y = sq + pad4(T);
  float* z = y + pad4((long)T * H);
  float* buf = z + pad4((long)T * H);
  float* part = act + pl.act_floats - pl.part_floats;
  Weights<kInPlace> wts{w, smem + 4 + (kScratch ? 0 : pl.act_floats), bars,
                        pl.nbuf, pl.wbuf_floats, 0};
  if (!kInPlace && threadIdx.x == 0) {
    for (int k = 0; k < pl.nbuf; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  wts.start(d);

  // pose embed: (T, D) @ (D, H) + b, straight from the input
  const float* b_embed = w + pad4((long)D * H);
  matmul(wts, d, plan.embed, x + b * T * D, D, 1, T, D, w, H, y, H, 1,
         Epi{kBias, b_embed, 0, nullptr, nullptr}, part);

  const float* hw = head_weights(d, w);
  const float* g_ln = hw;
  const float* b_ln = g_ln + pad4(H);
  const float* w_time = b_ln + pad4(H);
  const float* b_time = w_time + pad4((long)T * P);
  const float* w_out = b_time + pad4(P);
  const float* b_out = w_out + pad4((long)H * NC);

  bool z_is_ln = false;  // z holds the LayerNorm the next step needs
  // the fc2 matmuls leave the SE squeezes of their (T, H) output in sq
  float* sq_mm = d.use_se ? sq : nullptr;
  for (int blk = 0; blk < d.nb; ++blk) {
    // the block's pieces, recomputed where used (not held in registers)
    auto bw = [&]() { return block_weights(d, w, blk); };
    const bool last = blk + 1 == d.nb;
    // the LayerNorm after this block: the next block's LN1, the final LN,
    // or none (a channel-only block opens with its residual)
    const bool next_ln = last || has_tok(d);
    auto next_g = [&]() {
      return last ? g_ln : next_ln ? block_weights(d, w, blk + 1).ln1_g : nullptr;
    };
    auto next_b = [&]() {
      return last ? b_ln : next_ln ? block_weights(d, w, blk + 1).ln1_b : nullptr;
    };
    if (has_tok(d)) {
      if (!z_is_ln) ln_rows(y, z, bw().ln1_g, bw().ln1_b, d);
      // over the transposed tile: row h of z^T is column h of z
      matmul(wts, d, plan.tok1, z, 1, H, H, T, bw().tok_w1, d.tok, buf, d.tok,
             1, Epi{kBiasAct, bw().tok_b1, d.act, nullptr, nullptr}, part);
      // fc2 back to T, written transposed into z as (T, H)
      matmul(wts, d, plan.tok2, buf, d.tok, 1, H, d.tok, bw().tok_w2, T, z, 1,
             H, Epi{kFold, nullptr, 0, bw().tok_A, bw().tok_P}, part, sq_mm);
      if (d.block_type == kTokenOnly) {
        residual_ln(y, z, 2, bw().se_w1, bw().se_w2, sq, true, next_g(),
                    next_b(), z, d);
        z_is_ln = true;
        continue;
      }
      residual_ln(y, z, 1, bw().se_w1, bw().se_w2, sq, true, bw().ln2_g,
                  bw().ln2_b, z, d);
    } else {
      // the channel-only block's leading x + se(x) (x + x without SE)
      residual_ln(y, y, 1, bw().se_w1, bw().se_w2, sq, false, bw().ln2_g,
                  bw().ln2_b, z, d);
    }
    matmul(wts, d, plan.ch1, z, H, 1, T, H, bw().ch_w1, d.ch, buf, d.ch, 1,
           Epi{kBiasAct, bw().ch_b1, d.act, nullptr, nullptr}, part);
    matmul(wts, d, plan.ch2, buf, d.ch, 1, T, d.ch, bw().ch_w2, H, z, H, 1,
           Epi{kFold, nullptr, 0, bw().ch_A, bw().ch_P}, part, sq_mm);
    residual_ln(y, z, 1, bw().se_w1, bw().se_w2, sq, true, next_g(), next_b(),
                z, d);
    z_is_ln = next_ln;
  }
  if (!z_is_ln) ln_rows(y, z, g_ln, b_ln, d);

  // time upsample over the transposed tile: (H, T) @ (T, P) + b, stored
  // as (P, H)
  matmul(wts, d, plan.time, z, 1, H, H, T, w_time, P, buf, 1, H,
         Epi{kBias, b_time, 0, nullptr, nullptr}, part);
  matmul(wts, d, plan.out, buf, H, 1, P, H, w_out, NC, out + b * P * NC, NC,
         1, Epi{kBias, b_out, 0, nullptr, nullptr}, part);
}

// The (rt, ks) with the shortest per-thread chain for an R x K x N matmul
// on kThreads threads: a thread's multiply-adds and shared loads over its
// K slice (its tiles, when there are more than threads), plus, when K is
// split, the reduction and its barrier. A slice keeps at least 4 of K, and
// the partials fit part_floats.
MM pick(int R, int K, int N, int part_floats) {
  const int nt = (N + 3) / 4;
  MM best{1, 1};
  long best_cost = -1;
  for (int rt = 1; rt <= kMaxRowTile; ++rt) {
    const long tiles = (long)((R + rt - 1) / rt) * nt;
    for (int ks = 1; ks <= 16; ks *= 2) {
      if (ks > 1 && (K < 4 * ks || (long)ks * R * N > part_floats ||
                     tiles * ks > kThreads))
        continue;
      const long waves = (tiles * ks + kThreads - 1) / kThreads;
      const long kl = (K + ks - 1) / ks;
      long cost = waves * kl * (4 * rt + 2 * (4 + rt));
      if (ks > 1)
        cost += 2 * ks * (((long)R * N + kThreads - 1) / kThreads) + 200;
      if (best_cost < 0 || cost < best_cost) best_cost = cost, best = MM{rt, ks};
    }
  }
  return best;
}

}  // namespace

extern "C" {

// x (B, T, D), w packed weights (16-byte aligned), out (B, P, NC); all
// float32 on the current device. scratch: B * act_floats floats of device
// memory for the activations when in_scratch, else unused (may be
// nullptr). Returns the cudaError_t of the launch (0 on success).
int mmc_mlp_mixer(const float* x, const float* w, float* out, float* scratch,
                  int B, int T, int D, int H, int P, int NC, int tok, int ch,
                  int S, int nb, int block_type, int use_se, int use_max,
                  int act, int act_floats, int in_scratch, int part_floats,
                  int nbuf, int wbuf_floats, void* stream) {
  const Dims d{T, D, H, P, NC, tok, ch, S, nb, block_type, use_se, use_max,
               act};
  const Placement pl{act_floats, in_scratch, part_floats, nbuf, wbuf_floats};
  if ((in_scratch && scratch == nullptr) || nbuf < 0 || nbuf > 2 ||
      ((size_t)w & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Plan plan{pick(T, D, H, part_floats),     pick(H, T, tok, part_floats),
                  pick(H, tok, T, part_floats),   pick(T, H, ch, part_floats),
                  pick(T, ch, H, part_floats),    pick(H, T, P, part_floats),
                  pick(P, H, NC, part_floats)};
  const size_t smem =
      sizeof(float) * (4 + (in_scratch ? 0 : (size_t)act_floats) +
                       (size_t)nbuf * wbuf_floats);
  void (*kernel)(const float*, const float*, float*, float*, Dims, Placement,
                 Plan) =
      in_scratch ? (nbuf ? mlp_mixer_kernel<true, false>
                         : mlp_mixer_kernel<true, true>)
                 : (nbuf ? mlp_mixer_kernel<false, false>
                         : mlp_mixer_kernel<false, true>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(x, w, out, scratch, d,
                                                       pl, plan);
  return (int)cudaGetLastError();
}

}  // extern "C"
