// Fused harmonic embedding x Dense, forward and backward, hand-written for
// Hopper.
//
// Forward: replaces the Pallas TPU kernel `_fwd_kernel`
// (motionmixerconv_tpu/ops/pallas_harmonic.py, called from
// make_fused_harmonic_dense._run_fwd). Computes
//   out[r, :] = b + sum_i sin(f_i x[r, :]) Ws_i + cos(f_i x[r, :]) Wc_i
// with f_i = omega0 * 2**i, without ever writing the (R, 2nD) embedding to
// device memory. `doubling` derives harmonic i+1 from harmonic i by the
// normalized angle-doubling step instead of evaluating sin/cos again.
//
// Backward: replaces `_bwd_kernel` (same file, called from
// make_fused_harmonic_dense._run_bwd). Given the upstream gradient g (R, E)
//   dW[s, i] = sum_r feat_{s,i}(x_r)^T g_r        (s = sin, cos; i < n)
//   db       = sum_r g_r
//   dx_r     = sum_i f_i (c_i * (g_r Ws_i^T) - s_i * (g_r Wc_i^T))
// where (s_i, c_i) are harmonic i's features as the forward computes them:
// direct trig, or the doubling recurrence. For doubling this is the
// analytic gradient at the recurrence's own (s_i, c_i), as the TPU kernel
// defines it, not autodiff through the recurrence.
//
// What bounds them on the H100. At the flagship shape (D = 66, n = 64,
// E = 50) the forward and dW each take 2 R 2nD E flops of contraction and
// R D n sin/cos pairs (3 operations a pair, the argument's product
// included, as chip_smoke.py's b1_work counts them): at R = 500 (a
// training step of batch 50) 0.429 G operations, 6.4 us at 67 TFLOP/s of
// float32 outside the tensor cores, against ~1.9 MB of traffic; at
// R = 2560 (the 256-row bulk forward) 2.20 G operations, 33 us. dx doubles
// the contraction. So all are bound by operations. A sin/cos pair costs
// far more than 3 instructions: the arguments reach ~4e18 rad, and above
// ~1e5 rad (from harmonic ~20 on at input_scale 1e-3) sinf/cosf leave their
// fast path for an exact (Payne-Hanek) range reduction, a chain of table
// loads and 64-bit products. That path is slow but right, so it is kept:
// no --use_fast_math, no __sinf/__cosf, whose results at these arguments
// are meaningless; sincosf pays the reduction once for both features.
// Three TF32 products on the tensor cores (3xTF32 through mma.sync)
// measure slower than the register-tiled FMAs below at these shapes, and
// less accurate (PERF.md).
//
// Design, forward. A block owns a tile of 32 rows x up to 64 output columns
// for one group of harmonics; the grid is (row tiles, column tiles,
// groups), with the group size picked by the wrapper (ops/harmonic.py
// fwd_plan) so that the blocks fill the card's SMs in whole waves, two
// blocks to an SM (at R = 500: 16 row tiles x 16 groups of 4 harmonics).
// Each harmonic's two (D, E) weight slabs are copied into shared memory
// with cp.async, double-buffered with the features, so the copy and the
// trig of harmonic h+1 run while harmonic h is contracted; one barrier per
// harmonic. Of the 256 threads, one half contracts the sin rows and the
// other the cos rows, each thread a 4 x 4 register tile of (rows,
// columns), one float4 of features and one of weights per 16 multiply-adds,
// the next step's operands loaded before this step's products. The halves'
// sums, and the groups' partial sums in a second launch, are added in
// double precision in a fixed order and rounded once, then the bias: no
// float atomics, so two launches give identical bits. Under doubling each
// group first runs the recurrence up to its own first harmonic, then
// doubles the previous harmonic's features in shared memory.
//
// Design, backward. dW: a block owns one harmonic (its sin and its cos
// slab, so each value's reduction is paid once) x one chunk of rows x up
// to E columns; each thread owns a 4 x 4 register tile of (features,
// columns). It walks its chunk in tiles of 32 rows: the tile's features
// and upstream gradient (cp.async) go to shared memory double-buffered,
// one barrier per tile. The wrapper picks the chunks so that n x chunks
// blocks fill the SMs (at R = 500: 64 x 4 = 256 blocks). A second launch
// sums each dW element over the chunks in a fixed order and writes it into
// torch's (E, 2nD) d-major layout (feature index s*nD + d*n + i) through a
// transpose in shared memory; further blocks of that launch sum db, 32
// columns each, 32 threads a column, in a fixed order. dx, asked only when
// the input needs a gradient, has the forward's structure: blocks of 16
// rows x a group of harmonics, the same double-buffered weight slabs, each
// thread 4 rows of one input, the groups' partial sums added by the same
// second launch. The doubling step uses round-to-nearest intrinsics so
// that no multiply-add is contracted: the recurrence doubles any rounding
// difference per harmonic, and this keeps it identical, operation for
// operation, to the plain torch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFwdRows = 32;       // rows per forward block
constexpr int kFwdMaxCols = 64;    // output columns per forward block
constexpr int kFwdThreads = 256;   // two halves: the sin and the cos rows
constexpr int kHalf = kFwdThreads / 2;
constexpr int kDwRows = 32;        // rows per dW tile
constexpr int kMaxThreads = 1024;
constexpr int kFinishThreads = 1024;
constexpr int kDbCols = 32;        // db columns per finishing block
constexpr int kDxRows = 16;        // rows per dx block, 4 per thread

// launches of the forward (0) and dW (1) kernels since the library was
// loaded, counted on the device by each launch's first thread: replays of a
// captured CUDA graph run no wrapper, so only the device sees them
__device__ unsigned long long launch_count[2];

__device__ __forceinline__ void count_launch(int kernel) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(&launch_count[kernel], 1ULL);
}

// (sin a, cos a) -> (sin 2a, cos 2a), normalized by s^2 + c^2. Every step
// rounds to nearest with no contraction, as the plain torch version does.
__device__ __forceinline__ void double_angle(float& s, float& c) {
  const float inv =
      __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(s, s), __fmul_rn(c, c)));
  const float s2 = __fmul_rn(__fmul_rn(2.0f, __fmul_rn(s, c)), inv);
  c = __fmul_rn(__fmul_rn(__fsub_rn(c, s), __fadd_rn(c, s)), inv);
  s = s2;
}

// the (sin, cos) features of one input value. Direct: sincosf(f x), one
// range reduction for both. Doubling (f = f_0): sinf and cosf of f_0 x, as
// the plain version evaluates them (the recurrence doubles any difference
// in the last bit), then `steps` doubling steps to harmonic `steps`.
__device__ __forceinline__ void feature_pair(float xv, float f, int doubling,
                                             int steps, float& s, float& c) {
  const float a = __fmul_rn(xv, f);
  if (!doubling) {
    sincosf(a, &s, &c);
    return;
  }
  s = sinf(a);
  c = cosf(a);
  for (int i = 0; i < steps; ++i) double_angle(s, c);
}

// ---------------------------------------------------------- async copies

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `rows` rows of `cols` floats, src rows `src_ld` apart, to dst rows
// `dst_ld` apart, by cp.async: one full warp per row; 8-byte copies where
// every row start is 8-byte aligned on both sides.
__device__ __forceinline__ void stage_rows(float* dst, int dst_ld,
                                           const float* src, long src_ld,
                                           int rows, int cols) {
  const bool pairs = dst_ld % 2 == 0 && src_ld % 2 == 0 &&
                     (reinterpret_cast<size_t>(dst) & 7) == 0 &&
                     (reinterpret_cast<size_t>(src) & 7) == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const float* s = src + r * src_ld;
    float* d = dst + r * dst_ld;
    if (pairs) {
      for (int c = 2 * lane; c < cols; c += 64) {
        if (c + 1 < cols) cp_async8(d + c, s + c);
        else cp_async4(d + c, s + c);
      }
    } else {
      for (int c = lane; c < cols; c += 32) cp_async4(d + c, s + c);
    }
  }
}

// harmonic h's sin and cos slabs, columns [c0, c0 + cols), as 2D rows of
// ld floats (the sin slab's D rows first)
__device__ __forceinline__ void stage_weights(float* dst, int ld,
                                              const float* wsc, int h, int n,
                                              int D, int E, int c0, int cols) {
  const long slab = (long)D * E;
  stage_rows(dst, ld, wsc + (long)h * slab + c0, E, D, cols);
  stage_rows(dst + D * ld, ld, wsc + ((long)n + h) * slab + c0, E, D, cols);
}

// acc[i][j] += a[i] w[j]
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float4 a,
                                         const float4 w) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], w.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], w.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], w.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], w.w, acc[i][3]);
  }
}

// acc += sum over k in [k0, k1) of A4[k * lda + ia] (x) B4[k * ldb + ib],
// 4 x 4 outer products of float4s in order of k; the next step's operands
// are loaded before this step's multiply-adds
__device__ __forceinline__ void contract(float (&acc)[4][4], const float4* A4,
                                         int lda, int ia, const float4* B4,
                                         int ldb, int ib, int k0, int k1) {
  if (k0 >= k1) return;
  float4 a = A4[k0 * lda + ia], b = B4[k0 * ldb + ib];
#pragma unroll 4
  for (int k = k0 + 1; k < k1; ++k) {
    const float4 an = A4[k * lda + ia], bn = B4[k * ldb + ib];
    fma_tile(acc, a, b);
    a = an;
    b = bn;
  }
  fma_tile(acc, a, b);
}

// ----------------------------------------------------------------- forward

// harmonic h's features of m input values X into Fb: m sines, then m
// cosines. Under doubling a harmonic after the group's first (h0) doubles
// the previous one's features, Fprev.
__device__ __forceinline__ void harmonic_features(float* Fb, const float* Fprev,
                                                  const float* X, int m, int h,
                                                  int h0, const float* freqs,
                                                  int doubling) {
  if (doubling && h > h0) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      float s = Fprev[i], c = Fprev[m + i];
      double_angle(s, c);
      Fb[i] = s;
      Fb[m + i] = c;
    }
    return;
  }
  const float f = freqs[doubling ? 0 : h];
  const int steps = doubling ? h : 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    float s, c;
    feature_pair(X[i], f, doubling, steps, s, c);
    Fb[i] = s;
    Fb[m + i] = c;
  }
}

// grid (row tiles, column tiles, harmonic groups of hg); cols a multiple of
// 4, at most kFwdMaxCols; kFwdThreads threads: the first half contracts the
// sin rows of each harmonic, the second the cos rows, and the halves' sums
// are added at the end. Writes out + bias when there is one group, else the
// group's partial sum to part[group] (R, E).
__global__ void __launch_bounds__(kFwdThreads)
harmonic_dense_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ wsc,
                          const float* __restrict__ bias,
                          const float* __restrict__ freqs,
                          float* __restrict__ dst, int R, int D, int E, int n,
                          int doubling, int hg, int cols) {
  count_launch(0);
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // (D, kFwdRows) inputs
  const int kk = 2 * D;
  float* F = X + D * kFwdRows;                 // 2 x (2D, kFwdRows)
  float* W = F + 2 * kk * kFwdRows;            // 2 x (2D, cols)
  const int fsz = kk * kFwdRows, wsz = kk * cols;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long r0 = (long)blockIdx.x * kFwdRows;
  const int rows = (long)R - r0 < kFwdRows ? (int)((long)R - r0) : kFwdRows;
  const int c0 = blockIdx.y * cols;
  const int ncols = E - c0 < cols ? E - c0 : cols;
  const int h0 = blockIdx.z * hg;
  const int h1 = h0 + hg < n ? h0 + hg : n;
  const int cgs = cols / 4;
  const int half = tid / kHalf, lt = tid - half * kHalf;
  const int rg = lt / cgs, cg = lt - rg * cgs;
  const bool owner = rg < kFwdRows / 4;

  stage_weights(W, cols, wsc, h0, n, D, E, c0, ncols);
  cp_async_commit();
  for (int i = tid; i < kFwdRows * D; i += nt) {
    const int r = i / D, d = i - r * D;
    X[d * kFwdRows + r] = r < rows ? x[(r0 + r) * D + d] : 0.0f;
  }
  if (ncols < cols)  // the padding columns are read, never stored
    for (int i = tid; i < 2 * kk; i += nt)
      for (int c = ncols; c < cols; ++c) W[i * cols + c] = 0.0f;
  __syncthreads();
  harmonic_features(F, nullptr, X, D * kFwdRows, h0, h0, freqs, doubling);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int h = h0; h < h1; ++h) {
    const int b = (h - h0) & 1;
    cp_async_wait_all();
    __syncthreads();  // harmonic h's features and weights are in place;
                      // harmonic h-1's buffers are free
    if (h + 1 < h1) {
      stage_weights(W + (b ^ 1) * wsz, cols, wsc, h + 1, n, D, E, c0, ncols);
      cp_async_commit();
      harmonic_features(F + (b ^ 1) * fsz, F + b * fsz, X, D * kFwdRows,
                        h + 1, h0, freqs, doubling);
    }
    if (owner)
      contract(acc, reinterpret_cast<const float4*>(F + b * fsz),
               kFwdRows / 4, rg, reinterpret_cast<const float4*>(W + b * wsz),
               cgs, cg, half * D, half * D + D);
  }

  // the cos half's sums, through shared memory, onto the sin half's, added
  // in double precision and rounded once
  float* S = reinterpret_cast<float*>(smem4);  // (16, kHalf)
  __syncthreads();
  if (half == 1 && owner)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(4 * i + j) * kHalf + lt] = acc[i][j];
  __syncthreads();
  if (half == 1 || !owner) return;
  const bool last = gridDim.z == 1;
  float* out = dst + (last ? 0 : (long)blockIdx.z * R * E);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * cg + j;
      const float a = (float)((double)acc[i][j] +
                              (double)S[(4 * i + j) * kHalf + lt]);
      if (c < ncols)
        out[(r0 + r) * E + c0 + c] = last ? a + bias[c0 + c] : a;
    }
  }
}

// out = the groups' partial sums, added in group order in double precision,
// + bias (none when bias is null), rounded once; part holds `groups` arrays
// of `len` floats, rows of `E`
__global__ void harmonic_dense_sum_kernel(const float* __restrict__ part,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, long len,
                                          int E, int groups) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (long)gridDim.x * blockDim.x) {
    double a = part[i];
    for (int g = 1; g < groups; ++g) a += part[g * len + i];
    out[i] = (float)(bias != nullptr ? a + bias[i % E] : a);
  }
}

inline size_t fwd_smem_bytes(int D, int cols) {
  const size_t f = (size_t)D * kFwdRows + 4 * (size_t)D * kFwdRows +
                   4 * (size_t)D * cols;
  return sizeof(float) * (f > 16 * kHalf ? f : 16 * kHalf);
}

// ---------------------------------------------------------------- backward

// grid (n harmonics, row chunks of `chunk_rows`, column tiles of `cols`);
// cols a multiple of 4; blockDim.x >= ceil(2D / 4) * (cols / 4), a
// multiple of 32. Writes the chunk's partial dW of harmonic h to
// part[chunk][h] (2D, E), sin rows then cos rows.
__global__ void __launch_bounds__(kMaxThreads)
harmonic_dense_bwd_dw_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ freqs,
                             float* __restrict__ part, int R, int D, int E,
                             int n, int doubling, int chunk_rows, int cols) {
  count_launch(1);
  extern __shared__ float4 smem4[];
  const int kk = 2 * D;
  const int kgs = (kk + 3) / 4, kp = 4 * kgs;  // features padded to float4s
  float* F = reinterpret_cast<float*>(smem4);  // 2 x (kDwRows, kp)
  float* G = F + 2 * kDwRows * kp;             // 2 x (kDwRows, cols)
  const int fsz = kDwRows * kp, gsz = kDwRows * cols;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int h = blockIdx.x;
  const long rbeg = (long)blockIdx.y * chunk_rows;
  const long rend = rbeg + chunk_rows < R ? rbeg + chunk_rows : R;
  const int c0 = blockIdx.z * cols;
  const int ncols = E - c0 < cols ? E - c0 : cols;
  const int cgs = cols / 4;
  const int kg = tid / cgs, cg = tid - kg * cgs;
  const bool owner = kg < kgs;
  const int tiles = (int)((rend - rbeg + kDwRows - 1) / kDwRows);
  const float f = freqs[doubling ? 0 : h];
  const int steps = doubling ? h : 0;

  // the padding, read by the contraction and never stored, is zero
  for (int i = tid; i < 2 * kDwRows; i += nt) {
    for (int k = kk; k < kp; ++k) F[i * kp + k] = 0.0f;
    for (int c = ncols; c < cols; ++c) G[i * cols + c] = 0.0f;
  }

  // tile t's upstream gradient (cp.async) and features into buffer b
  auto load_tile = [&](int t, int b) {
    const long t0 = rbeg + (long)t * kDwRows;
    const int trows = rend - t0 < kDwRows ? (int)(rend - t0) : kDwRows;
    stage_rows(G + b * gsz, cols, g + t0 * E + c0, E, trows, ncols);
    cp_async_commit();
    float* Fb = F + b * fsz;
    const int sr = nt / D, sd = nt - sr * D;
    int r = tid / D, d = tid - r * D;
    while (r < trows) {
      float s, c;
      feature_pair(x[(t0 + r) * D + d], f, doubling, steps, s, c);
      Fb[r * kp + d] = s;
      Fb[r * kp + D + d] = c;
      d += sd;
      r += sr;
      if (d >= D) {
        d -= D;
        ++r;
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (tiles > 0) load_tile(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int b = t & 1;
    const long t0 = rbeg + (long)t * kDwRows;
    const int trows = rend - t0 < kDwRows ? (int)(rend - t0) : kDwRows;
    cp_async_wait_all();
    __syncthreads();  // tile t is in place; tile t-1's buffers are free
    if (t + 1 < tiles) load_tile(t + 1, b ^ 1);
    if (owner)
      contract(acc, reinterpret_cast<const float4*>(F + b * fsz), kgs, kg,
               reinterpret_cast<const float4*>(G + b * gsz), cgs, cg, 0,
               trows);
  }

  if (!owner) return;
  float* out = part + ((long)blockIdx.y * n + h) * kk * E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * kg + i;
    if (k >= kk) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * cg + j;
      if (c < ncols) out[(long)k * E + c0 + c] = acc[i][j];
    }
  }
}

// Blocks 0..2D-1: dW of feature row k = s*D + d for every harmonic, summed
// over the chunks in order and written into torch's (E, 2nD) layout.
// Blocks 2D..: db, kDbCols columns each, every column summed by
// kFinishThreads / kDbCols threads over rows r = p mod that, then over p
// in order.
__global__ void __launch_bounds__(kFinishThreads)
harmonic_dense_bwd_finish_kernel(const float* __restrict__ part,
                                 const float* __restrict__ g,
                                 float* __restrict__ dw,
                                 float* __restrict__ db, int R, int D, int E,
                                 int n, int chunks) {
  extern __shared__ float4 smem4[];
  float* T = reinterpret_cast<float*>(smem4);
  const int kk = 2 * D, tid = threadIdx.x;
  if ((int)blockIdx.x < kk) {
    const int k = blockIdx.x, s = k >= D, d = k - s * D;
    const long stride = (long)n * kk * E;  // one chunk's partial dW
    for (int i = tid; i < n * E; i += kFinishThreads) {
      const int h = i / E, e = i - h * E;
      const float* p = part + ((long)h * kk + k) * E + e;
      float a = p[0];
      for (int c = 1; c < chunks; ++c) a += p[c * stride];
      T[e * (n + 1) + h] = a;
    }
    __syncthreads();
    const long nd = (long)n * D;
    for (int i = tid; i < n * E; i += kFinishThreads) {
      const int e = i / n, h = i - e * n;
      dw[e * 2 * nd + s * nd + (long)d * n + h] = T[e * (n + 1) + h];
    }
    return;
  }
  const int lc = tid % kDbCols, p = tid / kDbCols;
  const int e = ((int)blockIdx.x - kk) * kDbCols + lc;
  float a = 0.0f;
  if (e < E)
    for (long r = p; r < R; r += kFinishThreads / kDbCols) a += g[r * E + e];
  T[p * kDbCols + lc] = a;
  __syncthreads();
  if (tid < kDbCols && e < E) {
    float t = 0.0f;
    for (int q = 0; q < kFinishThreads / kDbCols; ++q) t += T[q * kDbCols + tid];
    db[e] = t;
  }
}

// grid (row tiles of kDxRows, harmonic groups of hg), like the forward;
// blockDim.x >= 4 D, a multiple of 32. Thread (rg, d) owns dx of input d in
// rows 4 rg .. 4 rg + 3 of the tile and reads one float4 of the upstream
// gradient and one weight of each slab per 8 multiply-adds. The weight
// slabs (rows ld floats apart, ld odd so that a warp's rows fall in
// distinct banks) and the features are double-buffered in shared memory,
// one barrier per harmonic. Writes dx when there is one group, else the
// group's partial sum to part[group] (R, D).
__global__ void __launch_bounds__(kMaxThreads)
harmonic_dense_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ wsc,
                             const float* __restrict__ freqs,
                             float* __restrict__ dst, int R, int D, int E,
                             int n, int doubling, int hg, int ld) {
  extern __shared__ float4 smem4[];
  const int kk = 2 * D, wsz = kk * ld, m = kDxRows * D;
  float* G = reinterpret_cast<float*>(smem4);  // (E, kDxRows) gradient^T
  float* X = G + E * kDxRows;                  // (kDxRows, D) inputs
  float* F = X + m;                            // 2 x (2, kDxRows, D)
  float* W = F + 4 * m;                        // 2 x (2D, ld) weights

  const int tid = threadIdx.x, nt = blockDim.x;
  const long r0 = (long)blockIdx.x * kDxRows;
  const int rows = (long)R - r0 < kDxRows ? (int)((long)R - r0) : kDxRows;
  const int h0 = blockIdx.y * hg;
  const int h1 = h0 + hg < n ? h0 + hg : n;
  const int rg = tid / D, d = tid - rg * D;
  const bool owner = rg < kDxRows / 4;

  stage_weights(W, ld, wsc, h0, n, D, E, 0, E);
  cp_async_commit();
  for (int i = tid; i < m; i += nt) X[i] = i < rows * D ? x[r0 * D + i] : 0.0f;
  for (int i = tid; i < kDxRows * E; i += nt) {
    const int r = i / E, e = i - r * E;
    G[e * kDxRows + r] = r < rows ? g[(r0 + r) * E + e] : 0.0f;
  }
  __syncthreads();
  harmonic_features(F, nullptr, X, m, h0, h0, freqs, doubling);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float4* G4 = reinterpret_cast<const float4*>(G);
  for (int h = h0; h < h1; ++h) {
    const int b = (h - h0) & 1;
    cp_async_wait_all();
    __syncthreads();  // harmonic h's slabs and features are in place; h-1's
                      // buffers are free
    if (h + 1 < h1) {
      stage_weights(W + (b ^ 1) * wsz, ld, wsc, h + 1, n, D, E, 0, E);
      cp_async_commit();
      harmonic_features(F + (b ^ 1) * 2 * m, F + b * 2 * m, X, m, h + 1, h0,
                        freqs, doubling);
    }
    if (owner) {
      const float* ws = W + b * wsz + d * ld;
      const float* wc = ws + D * ld;
      float ps[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int e = 0; e < E; ++e) {
        const float4 gv = G4[e * (kDxRows / 4) + rg];
        const float a = ws[e], c = wc[e];
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ps[i] = fmaf(gr[i], a, ps[i]);
          pc[i] = fmaf(gr[i], c, pc[i]);
        }
      }
      const float* S = F + b * 2 * m;
      const float* C = S + m;
      const float f = freqs[h];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = (4 * rg + i) * D + d;
        acc[i] += f * (C[o] * ps[i] - S[o] * pc[i]);
      }
    }
  }

  if (!owner) return;
  float* out = dst + (gridDim.y == 1 ? 0 : (long)blockIdx.y * R * D);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * rg + i < rows) out[(r0 + 4 * rg + i) * D + d] = acc[i];
}

inline size_t dw_smem_bytes(int D, int cols) {
  const size_t kp = 4 * (size_t)((2 * D + 3) / 4);
  return sizeof(float) * 2 * kDwRows * (kp + (size_t)cols);
}

inline size_t finish_smem_bytes(int E, int n) {
  const size_t t = (size_t)E * (n + 1);
  return sizeof(float) * (t > kFinishThreads ? t : kFinishThreads);
}

inline size_t dx_smem_bytes(int D, int E, int ld) {
  return sizeof(float) * ((size_t)E * kDxRows + 5 * (size_t)kDxRows * D +
                          4 * (size_t)D * ld);
}

// let `kernel` take `bytes` of dynamic shared memory, and prefer the SM's
// largest shared-memory carveout, so that as many blocks fit an SM as the
// wrapper's plan counts on
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// blocks of `threads` threads and `smem` bytes that fit one SM at once
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int blocks = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

int mmc_harmonic_fwd_rows() { return kFwdRows; }
int mmc_harmonic_fwd_max_cols() { return kFwdMaxCols; }
int mmc_harmonic_dw_rows() { return kDwRows; }
int mmc_harmonic_dx_rows() { return kDxRows; }

long mmc_harmonic_fwd_smem_bytes(int D, int cols) {
  return (long)fwd_smem_bytes(D, cols);
}

long mmc_harmonic_dw_smem_bytes(int D, int cols) {
  return (long)dw_smem_bytes(D, cols);
}

long mmc_harmonic_finish_smem_bytes(int E, int n) {
  return (long)finish_smem_bytes(E, n);
}

long mmc_harmonic_dx_smem_bytes(int D, int E, int ld) {
  return (long)dx_smem_bytes(D, E, ld);
}

// the current device's launch counts of the forward and dW kernels into
// out[0], out[1] (synchronous, on the legacy default stream). Returns the
// cudaError_t (0 on success).
int mmc_harmonic_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, launch_count, sizeof(launch_count));
}

// blocks of the forward (kernel 0) or dW (kernel 1) kernel that fit one SM
// at `threads` threads and `smem` bytes, by the runtime's occupancy
// calculator; -1 on error
int mmc_harmonic_resident_blocks(int kernel, int threads, long smem) {
  return kernel == 0
             ? resident_blocks(harmonic_dense_fwd_kernel, threads, smem)
             : resident_blocks(harmonic_dense_bwd_dw_kernel, threads, smem);
}

// x (R, D), wsc (2, n, D, E) i-major, bias (E), freqs (n), out (R, E); all
// float32 on the current device. The plan (ops/harmonic.py fwd_plan): hg
// harmonics per group, `cols` output columns per block (a multiple of 4, at
// most kFwdMaxCols), `threads` (kFwdThreads) per block. With more than one group, part
// holds (groups, R, E) floats of scratch. Returns the cudaError_t of the
// launches (0 on success).
int mmc_harmonic_dense_fwd(const float* x, const float* wsc, const float* bias,
                           const float* freqs, float* out, float* part, int R,
                           int D, int E, int n, int doubling, int hg, int cols,
                           int threads, void* stream) {
  if (R < 1 || hg < 1 || cols < 4 || cols % 4 || cols > kFwdMaxCols ||
      threads != kFwdThreads)
    return (int)cudaErrorInvalidValue;
  const int groups = (n + hg - 1) / hg;
  if (groups > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(D, cols);
  cudaError_t err = allow_smem(harmonic_dense_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kFwdRows - 1) / kFwdRows, (E + cols - 1) / cols,
                  groups);
  harmonic_dense_fwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, wsc, bias, freqs, groups > 1 ? part : out, R, D, E, n, doubling, hg,
      cols);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const long re = (long)R * E;
  const long blocks = (re + 255) / 256;
  harmonic_dense_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                              (cudaStream_t)stream>>>(part, bias, out, re, E,
                                                      groups);
  return (int)cudaGetLastError();
}

// x (R, D), g (R, E), wsc (2, n, D, E) i-major, freqs (n); outputs dw
// (E, 2nD) in torch's d-major layout, db (E) and, unless dx is null, dx
// (R, D); all float32 on the current device. The plan (ops/harmonic.py
// bwd_plan): row chunks of chunk_rows (a multiple of kDwRows), `cols`
// columns per dW block (a multiple of 4), `threads` per dW block; dx in
// groups of dx_hg harmonics, dx_threads per block, weight rows ld >= E
// floats apart; part holds the larger of (chunks, n, 2D, E) and, with more
// than one dx group, (groups, R, D) floats of scratch. Returns the
// cudaError_t of the launches (0 on success).
int mmc_harmonic_dense_bwd(const float* x, const float* g, const float* wsc,
                           const float* freqs, float* dw, float* db,
                           float* dx, float* part, int R, int D, int E, int n,
                           int doubling, int chunk_rows, int cols, int threads,
                           int dx_hg, int dx_threads, int ld, void* stream) {
  const int kgs = (2 * D + 3) / 4;
  if (R < 1 || chunk_rows < 1 || chunk_rows % kDwRows || cols < 4 ||
      cols % 4 || threads % 32 || threads > kMaxThreads ||
      threads < kgs * (cols / 4) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dx != nullptr && (dx_hg < 1 || dx_threads % 32 ||
                        dx_threads > kMaxThreads || dx_threads < 4 * D ||
                        ld < E))
    return (int)cudaErrorInvalidValue;
  const size_t smem_w = dw_smem_bytes(D, cols);
  cudaError_t err = allow_smem(harmonic_dense_bwd_dw_kernel, smem_w);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (R + chunk_rows - 1) / chunk_rows;
  const dim3 grid(n, chunks, (E + cols - 1) / cols);
  harmonic_dense_bwd_dw_kernel<<<grid, threads, smem_w,
                                 (cudaStream_t)stream>>>(
      x, g, freqs, part, R, D, E, n, doubling, chunk_rows, cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_f = finish_smem_bytes(E, n);
  err = allow_smem(harmonic_dense_bwd_finish_kernel, smem_f);
  if (err != cudaSuccess) return (int)err;
  harmonic_dense_bwd_finish_kernel<<<2 * D + (E + kDbCols - 1) / kDbCols,
                                     kFinishThreads, smem_f,
                                     (cudaStream_t)stream>>>(
      part, g, dw, db, R, D, E, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return (int)err;
  // dx reuses the scratch once the finishing launch has read it
  const size_t smem_x = dx_smem_bytes(D, E, ld);
  err = allow_smem(harmonic_dense_bwd_dx_kernel, smem_x);
  if (err != cudaSuccess) return (int)err;
  const int groups = (n + dx_hg - 1) / dx_hg;
  const dim3 grid_x((R + kDxRows - 1) / kDxRows, groups);
  harmonic_dense_bwd_dx_kernel<<<grid_x, dx_threads, smem_x,
                                 (cudaStream_t)stream>>>(
      x, g, wsc, freqs, groups > 1 ? part : dx, R, D, E, n, doubling, dx_hg,
      ld);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  const long rd = (long)R * D;
  const long blocks = (rd + 255) / 256;
  harmonic_dense_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                              (cudaStream_t)stream>>>(part, nullptr, dx, rd,
                                                      D, groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
