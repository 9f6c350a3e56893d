// Fused router gating for Hopper (sm_90a): float32 stable softmax over E,
// k rounds of argmax-and-mask (ties to the lower index), weights
// renormalised by the sum of the k picks floored at 1e-9.
//
// Replaces the Pallas kernel src/repro/kernels/topk_gating/kernel.py
// (_gating_kernel / topk_gating), which keeps a (block_t, E) tile in fast
// memory and requires T to be a multiple of the tile.
//
// Bound: bytes.  Per row the kernel reads E logits and writes 2k values; the
// arithmetic is E exps and k*E compares, two orders of magnitude under the
// float32 rate at the memory rate.  Design: one warp per row, the row held in
// registers (lane l owns experts l, l+32, ...: coalesced loads, VPL values a
// lane), max / sum / argmax by warp shuffles, so the (T, E) probabilities
// never reach device memory.  The tail of T is masked by a row guard; rows
// are independent, so there is no cross-block traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VPL = values per lane; handles E <= 32 * VPL.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
topk_gating_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                   int* __restrict__ idx_out, int num_rows, int E, int k) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= num_rows) return;  // whole warp leaves together

  const T* src = logits + static_cast<int64_t>(row) * E;
  float p[VPL];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int e = lane + i * kWarp;
    p[i] = e < E ? to_float(src[e]) : -INFINITY;
    m = fmaxf(m, p[i]);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int e = lane + i * kWarp;
    p[i] = e < E ? expf(p[i] - m) : 0.f;
    sum += p[i];
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int e = lane + i * kWarp;
    // Padding lanes get -2: below the -1 that marks a pick, never chosen
    // while a real expert is left (k <= E is checked by the caller).
    p[i] = e < E ? p[i] / sum : -2.f;
  }

  // Round j: every lane learns (value, index) of the row's maximum; lane j
  // keeps it, so after k rounds lanes 0..k-1 hold the picks in order.
  float my_w = 0.f;
  int my_idx = 0;
  float tot = 0.f;
  for (int j = 0; j < k; ++j) {
    float best = p[0];
    int best_e = lane;
#pragma unroll
    for (int i = 1; i < VPL; ++i) {
      if (p[i] > best) {  // strict: the lower index wins a tie within a lane
        best = p[i];
        best_e = lane + i * kWarp;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oe = __shfl_xor_sync(kFull, best_e, off);
      if (ov > best || (ov == best && oe < best_e)) {
        best = ov;
        best_e = oe;
      }
    }
    tot += best;
    if (lane == j) {
      my_w = best;
      my_idx = best_e;
    }
    if ((best_e % kWarp) == lane) {
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (i == best_e / kWarp) p[i] = -1.f;
    }
  }

  if (lane < k) {
    const int64_t o = static_cast<int64_t>(row) * k + lane;
    w_out[o] = my_w / fmaxf(tot, 1e-9f);
    idx_out[o] = my_idx;
  }
}

template <typename T>
cudaError_t launch(const void* logits, float* w, int* idx, int num_rows, int E,
                   int k, cudaStream_t stream) {
  if (num_rows == 0) return cudaSuccess;
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* in = static_cast<const T*>(logits);
#define DYSKEW_GATING_CASE(V)                                                   \
  if (E <= kWarp * V) {                                                         \
    topk_gating_kernel<T, V><<<grid, block, 0, stream>>>(in, w, idx, num_rows, \
                                                         E, k);                 \
    return cudaGetLastError();                                                  \
  }
  DYSKEW_GATING_CASE(1)
  DYSKEW_GATING_CASE(2)
  DYSKEW_GATING_CASE(4)
  DYSKEW_GATING_CASE(8)
  DYSKEW_GATING_CASE(16)
#undef DYSKEW_GATING_CASE
  return cudaErrorInvalidValue;  // E > 512
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Requires 1 <= k <= min(E, 32), E <= 512.
extern "C" int dyskew_topk_gating(const void* logits, void* w, void* idx,
                                  int num_rows, int E, int k, int dtype,
                                  void* stream) {
  if (k < 1 || k > kWarp || k > E || E < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wp = static_cast<float*>(w);
  int* ip = static_cast<int*>(idx);
  if (dtype == 0) return launch<float>(logits, wp, ip, num_rows, E, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(logits, wp, ip, num_rows, E, k, s);
  return cudaErrorInvalidValue;
}
