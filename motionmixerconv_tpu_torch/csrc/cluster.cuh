// Thread-block-cluster helpers (Hopper, sm_90a), used by conv_mixer_mc.cu:
// the split of a width over a cluster's blocks, the cluster barrier,
// reading and writing a peer block's shared memory (distributed shared
// memory, DSMEM), partial sums combined in a fixed rank order, and the
// cluster launch with its occupancy check.
//
// A kernel that uses them is launched with `launch_cluster`, so that every
// block of a cluster sits on a neighbouring SM and `peer` may map its shared
// memory; it ends with `cluster_sync()`, so that no block exits while a
// neighbour still reads its shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

namespace mmc {

namespace cg = cooperative_groups;

// Slice r of K of n columns (or rows): contiguous, the first n % K slices
// one wider.
__host__ __device__ inline int slice_start(int n, int K, int r) {
  return r * (n / K) + (r < n % K ? r : n % K);
}

__host__ __device__ inline int slice_width(int n, int K, int r) {
  return n / K + (r < n % K ? 1 : 0);
}

__host__ __device__ inline int max_width(int n, int K) {
  return (n + K - 1) / K;
}

// Every thread of every block of the cluster meets here. The barrier
// releases and acquires at cluster scope, so the shared (and global) memory
// writes made before it are visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

// ``p``, an address in this block's shared memory, in block ``rank``'s.
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}

constexpr int kMaxCluster = 16;

// sum over the ranks 0..K-1 (K <= 16), in that order, of part[i] in each
// block; every remote load is issued before the first add
__device__ __forceinline__ float rank_sum(float* part, int i, int K) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) v[q] = q < K ? peer(part, q)[i] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < K) s += v[q];
  return s;
}

// max over the ranks 0..K-1 (K <= 16) of part[i] in each block
__device__ __forceinline__ float rank_max(float* part, int i, int K) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < K ? peer(part, q)[i] : -INFINITY;
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) m = fmaxf(m, v[q]);
  return m;
}

// The dynamic shared memory a kernel is allowed (one H100 block's most).
constexpr int kMaxDynamicSmem = 232448;

// Clusters of K blocks of ``threads`` threads and ``smem`` bytes of dynamic
// shared memory that fit the card at once (cudaOccupancyMaxActiveClusters;
// 0: the cluster cannot be scheduled). The first query for a kernel on a
// device also allows it the most dynamic shared memory and, for clusters
// above 8 blocks, the non-portable cluster size; each answer is kept, so a
// launch pays for the query once per configuration.
template <typename Kernel>
inline cudaError_t cluster_capacity(Kernel kernel, int K, int threads,
                                    size_t smem, int* n_clusters) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, size_t>, int> known;
  *n_clusters = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple((const void*)kernel, dev, K, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *n_clusters = it->second;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err != cudaSuccess) return err;
  if (K > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(n_clusters, (void*)kernel, &cfg);
  if (err == cudaSuccess) known[key] = *n_clusters;
  return err;
}

// Launch ``kernel`` as ``clusters`` clusters of K blocks of ``threads``
// threads on ``stream``. A cluster that cannot be scheduled (no cluster of
// this size and shared memory fits the card) returns
// cudaErrorLaunchOutOfResources without launching; nothing falls back to a
// smaller cluster.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int clusters,
                                  int K, int threads, size_t smem,
                                  cudaStream_t stream, Args... args) {
  int fit = 0;
  cudaError_t err = cluster_capacity(kernel, K, threads, smem, &fit);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace mmc
