// Destination-load histogram for Hopper (sm_90a):
// counts[e] = #{i : ids[i] == e}, exact, as float32.
//
// Replaces the Pallas kernel src/repro/kernels/histogram/kernel.py
// (_hist_kernel / load_histogram).  That kernel accumulates into one output
// block across grid steps, which is right only where grid steps run in
// order.  Blocks on this card run concurrently, so each block counts into
// its own integer bins in shared memory and merges them into a zeroed int32
// array in device memory with atomicAdd; a second, E-thread kernel converts
// to float32.  Integer adds are exact and commute, so the result is the
// same whatever order the blocks finish in.
//
// Bound: bytes (4 bytes read per id, one add each).  At the sizes the MoE
// layer gives it (N = tokens * k, tens of thousands) the launch itself costs
// more than the traffic; the design keeps global atomics to E per block and
// spreads N over enough blocks to fill the card.  Ids outside [0, E) are
// ignored, and N need not divide the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIdsPerThread = 8;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ ids, int* __restrict__ counts, int64_t n,
                 int E) {
  extern __shared__ int bins[];
  for (int e = threadIdx.x; e < E; e += kThreads) bins[e] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int e = ids[i];
    if (e >= 0 && e < E) atomicAdd(&bins[e], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int c = bins[e];
    if (c != 0) atomicAdd(&counts[e], c);
  }
}

__global__ void counts_to_float_kernel(const int* __restrict__ counts,
                                       float* __restrict__ out, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E) out[e] = static_cast<float>(counts[e]);
}

}  // namespace

// ids: (n,) int32.  scratch: (E,) int32, contents ignored.  out: (E,) float32.
// E * 4 bytes of shared memory must fit the default 48 KB (E <= 12288).
extern "C" int dyskew_load_histogram(const void* ids, void* scratch, void* out,
                                     long long n, int E, void* stream) {
  if (E < 1 || E > 12288 || n < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * E, s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    const int64_t per_block = static_cast<int64_t>(kThreads) * kIdsPerThread;
    int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > 1056) blocks = 1056;  // 8 blocks on each of 132 SMs
    histogram_kernel<<<static_cast<unsigned>(blocks), kThreads, sizeof(int) * E, s>>>(
        static_cast<const int*>(ids), counts, n, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  counts_to_float_kernel<<<(E + 255) / 256, 256, 0, s>>>(
      counts, static_cast<float*>(out), E);
  return cudaGetLastError();
}
