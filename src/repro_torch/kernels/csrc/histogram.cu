// Destination-load histogram for Hopper (sm_90a):
// counts[e] = #{i : ids[i] == e}, exact, as float32.
//
// Replaces the Pallas kernel src/repro/kernels/histogram/kernel.py
// (_hist_kernel / load_histogram).  That kernel accumulates into one output
// block across grid steps, which is right only where grid steps run in
// order.  Blocks on this card run concurrently, so the bins are merged in
// one of two ways, both in ONE launch with no scratch in device memory:
//
//  * one block (small N, the decode shapes): integer bins in shared memory,
//    then the block writes the float32 counts itself;
//  * one thread-block cluster of up to 16 blocks (larger N): each block
//    counts its share of the ids into its own shared-memory bins; after a
//    cluster barrier, block r sums bins [r*E/C, (r+1)*E/C) of every block
//    of the cluster through distributed shared memory and writes those
//    counts as float32.  A second cluster barrier keeps every block alive
//    until no other block reads its bins.
//
// Integer adds are exact and commute, so the counts are the same whatever
// order the atomics land in.  The wrapper picks the shape
// (histogram/kernel.py's launch_shape) and passes it here.  On the card a
// cluster's launch and its two barriers cost microseconds more than one
// block, so one block takes every N up to tens of thousands; a cluster of 16
// (not the portable 8) keeps a count of millions of ids within 2x of a grid
// that spreads them over every SM.
//
// Bound: bytes (4 bytes read per id, one add each), and at the MoE layer's
// sizes (N = tokens * k, 64 to 65,536) the launch itself costs more than the
// traffic.  The design therefore removes launches: a merge through global
// atomics would need a memset of an int32 scratch, the counting kernel and a
// conversion kernel — three graph nodes a call.  Ids are read as 16-byte
// vectors (a scalar head up to the 16-byte grid, a scalar tail), ids outside
// [0, E) are ignored, and any N >= 0 is taken (N = 0 writes E zeros).
// E * 4 bytes of bins must fit the default 48 KB of shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDest = 12288;         // 48 KB of int32 bins
constexpr int kMaxCluster = 16;         // MAX_CLUSTER in histogram/kernel.py
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void count(int* bins, int e, int E) {
  if (static_cast<unsigned>(e) < static_cast<unsigned>(E)) atomicAdd(&bins[e], 1);
}

// Counts this thread's share of ids into `bins`.  Thread g of G in all
// (over the cluster) takes vectors g, g + G, ... of the aligned body, and
// one scalar of the head and one of the tail where g is small enough.
__device__ __forceinline__ void count_share(const int* __restrict__ ids, int64_t n,
                                            int* bins, int E, int64_t g, int64_t G) {
  const int64_t head_raw = ((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) & 15) / 4;
  const int64_t head = head_raw < n ? head_raw : n;
  const int64_t nvec = (n - head) / 4;
  const int64_t tail = head + nvec * 4;
  const int4* body = reinterpret_cast<const int4*>(ids + head);
#pragma unroll 4
  for (int64_t i = g; i < nvec; i += G) {
    const int4 q = __ldg(body + i);
    count(bins, q.x, E);
    count(bins, q.y, E);
    count(bins, q.z, E);
    count(bins, q.w, E);
  }
  if (g < head) count(bins, __ldg(ids + g), E);
  if (g < n - tail) count(bins, __ldg(ids + tail + g), E);
}

__global__ void __launch_bounds__(kMaxThreads)
histogram_block_kernel(const int* __restrict__ ids, float* __restrict__ out, int64_t n,
                       int E) {
  extern __shared__ int bins[];
  for (int e = threadIdx.x; e < E; e += blockDim.x) bins[e] = 0;
  __syncthreads();
  count_share(ids, n, bins, E, threadIdx.x, blockDim.x);
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) out[e] = static_cast<float>(bins[e]);
}

__global__ void __launch_bounds__(kMaxThreads)
histogram_cluster_kernel(const int* __restrict__ ids, float* __restrict__ out, int64_t n,
                         int E) {
  extern __shared__ int bins[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  for (int e = threadIdx.x; e < E; e += blockDim.x) bins[e] = 0;
  __syncthreads();
  count_share(ids, n, bins, E, static_cast<int64_t>(rank) * blockDim.x + threadIdx.x,
              static_cast<int64_t>(blocks) * blockDim.x);
  cluster.sync();   // every block's bins are complete and visible
  const int lo = static_cast<int>(static_cast<int64_t>(E) * rank / blocks);
  const int hi = static_cast<int>(static_cast<int64_t>(E) * (rank + 1) / blocks);
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    // All remote reads issued before the first add: one round trip.
    int part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < blocks ? cluster.map_shared_rank(bins, q)[e] : 0;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) sum += part[q];
    out[e] = static_cast<float>(sum);
  }
  cluster.sync();   // no block leaves while another still reads its bins
}

}  // namespace

// ids: (n,) int32.  out: (E,) float32.  cluster_blocks, threads: the launch
// shape from histogram/kernel.py's launch_shape (1 = a single block).
extern "C" int dyskew_load_histogram(const void* ids, void* out, long long n, int E,
                                     int cluster_blocks, int threads, void* stream) {
  if (E < 1 || E > kMaxDest || n < 0) return cudaErrorInvalidValue;
  if (cluster_blocks < 1 || cluster_blocks > kMaxCluster) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(ids);
  float* counts = static_cast<float*>(out);
  const size_t smem = sizeof(int) * static_cast<size_t>(E);
  if (cluster_blocks == 1) {
    histogram_block_kernel<<<1, threads, smem, s>>>(in, counts, n, E);
    return cudaGetLastError();
  }
  if (cluster_blocks > 8) {
    // Clusters above the portable 8 blocks must be allowed explicitly.
    const cudaError_t err = cudaFuncSetAttribute(
        histogram_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster_blocks));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster_blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, histogram_cluster_kernel, in, counts,
                         static_cast<int64_t>(n), E);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
