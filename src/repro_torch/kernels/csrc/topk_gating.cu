// Fused router gating for Hopper (sm_90a): float32 softmax over E, k picks
// in descending order of probability (ties to the lower index), weights
// renormalised by the sum of the k picks floored at 1e-9.
//
// Replaces the Pallas kernel src/repro/kernels/topk_gating/kernel.py
// (_gating_kernel / topk_gating), which keeps a (block_t, E) tile in fast
// memory and requires T to be a multiple of the tile.
//
// Bound: bytes.  Per row the kernel reads E logits and writes 2k words; the
// arithmetic is E exps and k*E compares, far under the float32 rate.  At the
// MoE layer's shapes (E 32 bf16, k 8, T 8 to 8192) the bytes are at most a
// megabyte, so the time is the launch plus the chain of dependent steps in a
// row, and the design shortens that chain.  Two paths; the wrapper picks one
// (topk_gating/kernel.py's launch_shape) and this file checks the choice:
//
//  * group path (a row of G*16 bytes, G a power of two <= 32, a 16-byte
//    aligned base, k in {1, 2, 4, 8}): G lanes hold one row, each with ONE
//    16-byte load of V = 16/size contiguous experts, so a warp holds
//    R = 32/G whole rows (8 at E 32 bf16) and reads 512 contiguous bytes.
//    Max and sum take log2 G xor shuffles inside the group (offsets below G,
//    so rows never mix).  Picks: a key is the probability's bits above
//    ~index (probabilities are >= +0, so their bits order as the floats do,
//    and an equal probability goes to the lower index, the rule of the
//    reference's stable sort).  Each lane sorts its V keys once (a bitonic
//    network in registers); then each of the k rounds (k a template
//    parameter, so the rounds unroll) is log2 G shuffles of the lanes'
//    heads, and the owner of the winning head pops it, taking 0 (below
//    every live key) at its end.  So a round's chain is the shuffles alone,
//    with no scan over the lane's values.  Every lane of the group ends
//    with all k picks, and the group writes the row's k weights and k ids
//    as 16-byte stores (8- or 4-byte at k 2 or 1), spread over its lanes.
//  * warp path (everything else: E up to 512, k up to 32, any alignment):
//    one warp per row, lane l owns experts l, l+32, ..., and k rounds of a
//    lane scan and a 5-step shuffle argmax.
//
// Both select on the normalised probability p = expf(x - max) / sum, as the
// reference does: the map from logits to p is monotone but not strictly so
// after rounding, and a tie that rounding creates must go to the lower
// index.  So expf (not __expf) and a true division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxExperts = 512;          // MAX_EXPERTS in topk_gating/kernel.py
constexpr int kMaxK = 32;                 // MAX_K
constexpr int kVectorBytes = 16;          // VECTOR_BYTES
constexpr int kMaxGroupK = 8;             // max(GROUP_KS)
constexpr int kPathWarp = 0;              // PATH_WARP
constexpr int kPathGroup = 1;             // PATH_GROUP
constexpr int kWarpsPerBlock = 8;         // warp path
constexpr int kGroupWarpsPerBlock = 4;    // group path: 256 blocks at T 8192, E 32 bf16
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------- group path

template <typename T>
struct Vec;  // V experts in one 16-byte load, unpacked exactly to float32

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4 q, float (&x)[V]) {
    x[0] = __uint_as_float(q.x);
    x[1] = __uint_as_float(q.y);
    x[2] = __uint_as_float(q.z);
    x[3] = __uint_as_float(q.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void unpack(const uint4 q, float (&x)[V]) {
    const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: expert 2i in the low half
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ unsigned long long make_key(float p, int e) {
  return (static_cast<unsigned long long>(__float_as_uint(p)) << 32) |
         static_cast<unsigned>(~e);
}

// Bitonic network: V (a power of two) keys in descending order, all
// indices known at compile time, so the keys stay in registers.
template <int V>
__device__ __forceinline__ void sort_descending(unsigned long long (&key)[V]) {
#pragma unroll
  for (int size = 2; size <= V; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = key[i], b = key[j];
          const bool swap = ((i & size) == 0) ? a < b : a > b;
          key[i] = swap ? b : a;
          key[j] = swap ? a : b;
        }
      }
    }
  }
}

// G lanes a row, K picks.  E == G * V exactly (checked by the entry point).
template <typename T, int G, int K>
__global__ void __launch_bounds__(kWarp* kGroupWarpsPerBlock)
topk_gating_group_kernel(const T* __restrict__ logits, unsigned* __restrict__ out,
                         int num_rows) {
  constexpr int V = Vec<T>::V;
  constexpr int E = G * V;
  constexpr int R = kWarp / G;
  const int lane = threadIdx.x % kWarp;
  const int warp_row = (blockIdx.x * kGroupWarpsPerBlock + threadIdx.x / kWarp) * R;
  if (warp_row >= num_rows) return;  // whole warp leaves together
  const int g = lane % G;            // this lane's part of its row
  const int row = warp_row + lane / G;
  const bool active = row < num_rows;  // the last warp may be part-filled

  float x[V];
  const uint4 q = active ? __ldcs(reinterpret_cast<const uint4*>(logits + static_cast<int64_t>(row) * E) + g)
                         : make_uint4(0u, 0u, 0u, 0u);
  Vec<T>::unpack(q, x);

  float m = x[0];
#pragma unroll
  for (int i = 1; i < V; ++i) m = fmaxf(m, x[i]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    x[i] = expf(x[i] - m);
    sum += x[i];
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);

  unsigned long long key[V];
#pragma unroll
  for (int i = 0; i < V; ++i) key[i] = make_key(x[i] / sum, g * V + i);
  sort_descending(key);

  unsigned words[2 * K];  // the row's output: K weights' bits, then K ids
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    // The row's largest key is the largest of the group's heads.
    unsigned long long best = key[0];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, off);
      best = other > best ? other : best;
    }
    const float p = __uint_as_float(static_cast<unsigned>(best >> 32));
    tot += p;
    words[j] = __float_as_uint(p);
    words[K + j] = ~static_cast<unsigned>(best);
    // Keys are unique (the index is in them): only the owner's head
    // matches, and the owner pops it.
    const bool mine = key[0] == best;
#pragma unroll
    for (int i = 0; i + 1 < V; ++i) key[i] = mine ? key[i + 1] : key[i];
    key[V - 1] = mine ? 0ull : key[V - 1];
  }
  const float denom = fmaxf(tot, 1e-9f);
#pragma unroll
  for (int j = 0; j < K; ++j) words[j] = __float_as_uint(__uint_as_float(words[j]) / denom);

  if (!active) return;
  // C-word stores: 2K/C chunks, chunk c by lane c % G of the group.  The
  // weights start at out, the ids at out + num_rows * K; both offsets are
  // multiples of C words (the entry point checks the base pointer).
  constexpr int C = K >= 4 ? 4 : K;
  constexpr int kPer = K / C;  // chunks per array
  unsigned* const w_row = out + static_cast<int64_t>(row) * K;
  unsigned* const i_row = w_row + static_cast<int64_t>(num_rows) * K;
#pragma unroll
  for (int c = 0; c < 2 * kPer; ++c) {
    if (c % G != g) continue;
    unsigned* dst = (c < kPer ? w_row : i_row) + (c % kPer) * C;
    if constexpr (C == 4) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[c * C], words[c * C + 1], words[c * C + 2], words[c * C + 3]);
    } else if constexpr (C == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(words[c * C], words[c * C + 1]);
    } else {
      *dst = words[c];
    }
  }
}

template <typename T, int G, int K>
cudaError_t launch_group(const void* logits, unsigned* out, int num_rows, cudaStream_t s) {
  constexpr int rows_per_block = kGroupWarpsPerBlock * (kWarp / G);
  const dim3 grid((num_rows + rows_per_block - 1) / rows_per_block);
  topk_gating_group_kernel<T, G, K><<<grid, kWarp * kGroupWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(logits), out, num_rows);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_group_k(const void* logits, unsigned* out, int num_rows, int k,
                           cudaStream_t s) {
  switch (k) {
    case 1: return launch_group<T, G, 1>(logits, out, num_rows, s);
    case 2: return launch_group<T, G, 2>(logits, out, num_rows, s);
    case 4: return launch_group<T, G, 4>(logits, out, num_rows, s);
    case kMaxGroupK: return launch_group<T, G, kMaxGroupK>(logits, out, num_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_group_path(const void* logits, unsigned* out, int num_rows, int E, int k,
                              int lanes, cudaStream_t s) {
  if (E * static_cast<int>(sizeof(T)) != lanes * kVectorBytes) return cudaErrorInvalidValue;
  // The ids start num_rows * k words after the weights: both arrays must
  // be aligned to the store width (4 words at k >= 4).
  const int store_bytes = 4 * (k >= 4 ? 4 : k);
  const uintptr_t ids = reinterpret_cast<uintptr_t>(out + static_cast<int64_t>(num_rows) * k);
  if ((reinterpret_cast<uintptr_t>(logits) % kVectorBytes) != 0 ||
      (reinterpret_cast<uintptr_t>(out) % store_bytes) != 0 || ids % store_bytes != 0)
    return cudaErrorMisalignedAddress;
  switch (lanes) {
    case 1: return launch_group_k<T, 1>(logits, out, num_rows, k, s);
    case 2: return launch_group_k<T, 2>(logits, out, num_rows, k, s);
    case 4: return launch_group_k<T, 4>(logits, out, num_rows, k, s);
    case 8: return launch_group_k<T, 8>(logits, out, num_rows, k, s);
    case 16: return launch_group_k<T, 16>(logits, out, num_rows, k, s);
    case kWarp: return launch_group_k<T, kWarp>(logits, out, num_rows, k, s);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------- warp path

// VPL = values per lane; handles E <= 32 * VPL.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
topk_gating_warp_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
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
cudaError_t launch_warp_path(const void* logits, unsigned* out, int num_rows, int E, int k,
                             cudaStream_t stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* in = static_cast<const T*>(logits);
  float* w = reinterpret_cast<float*>(out);
  int* idx = reinterpret_cast<int*>(out + static_cast<int64_t>(num_rows) * k);
#define DYSKEW_GATING_CASE(V)                                                      \
  if (E <= kWarp * V) {                                                            \
    topk_gating_warp_kernel<T, V><<<grid, block, 0, stream>>>(in, w, idx, num_rows, \
                                                              E, k);               \
    return cudaGetLastError();                                                     \
  }
  DYSKEW_GATING_CASE(1)
  DYSKEW_GATING_CASE(2)
  DYSKEW_GATING_CASE(4)
  DYSKEW_GATING_CASE(8)
  DYSKEW_GATING_CASE(16)
#undef DYSKEW_GATING_CASE
  return cudaErrorInvalidValue;  // E > 512
}

template <typename T>
cudaError_t launch(const void* logits, unsigned* out, int num_rows, int E, int k, int path,
                   int lanes, cudaStream_t s) {
  if (path == kPathGroup) return launch_group_path<T>(logits, out, num_rows, E, k, lanes, s);
  if (path == kPathWarp) return launch_warp_path<T>(logits, out, num_rows, E, k, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// logits: (num_rows, E), dtype 0 = float32, 1 = bfloat16.  out: (2,
// num_rows, k) int32, the weights' float32 bits in out[0], the ids in
// out[1].  path, lanes: from topk_gating/kernel.py's launch_shape.
// Requires 1 <= k <= min(E, 32), E <= 512.
extern "C" int dyskew_topk_gating(const void* logits, void* out, int num_rows, int E, int k,
                                  int dtype, int path, int lanes, void* stream) {
  if (k < 1 || k > kMaxK || k > E || E < 1 || E > kMaxExperts || num_rows < 0)
    return cudaErrorInvalidValue;
  if (num_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  if (dtype == 0) return launch<float>(logits, o, num_rows, E, k, path, lanes, s);
  if (dtype == 1) return launch<__nv_bfloat16>(logits, o, num_rows, E, k, path, lanes, s);
  return cudaErrorInvalidValue;
}
