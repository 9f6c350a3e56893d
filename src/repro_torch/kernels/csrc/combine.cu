// The MoE combine for Hopper (sm_90a), forward and backward:
//
//   forward   y[t]        = sum_j w[t,j] * y_flat[slot[t,j]]   over the kept picks j
//   backward  d_y_flat[s] = w[t,j] * dy[t]   where pick (t, j) owns slot s, else 0
//             d_w[t,j]    = <dy[t], y_flat[slot[t,j]]>           (0 for a dropped pick)
//
// Replaces no Pallas kernel: repro combines with XLA's gathers
// (src/repro/models/layers/moe.py, moe_apply), and the port did the same
// with eight gathers, multiplies and adds a layer.  Their backward was
// PyTorch's index_put(accumulate=True), which sorts the indices and walks
// each run of equal indices serially; every dropped pick was clamped onto
// the last slot, so under skewed routing one run was thousands of rows of
// exact zeros long, and that walk took about 40 % of a training step.  Here
// a dropped pick (slot == S) is never read and never written.
//
// Bound: bytes.  A kept pick owns its slot alone (the routing plan gives
// each slot at most one pick), so the backward is a plain store a row, with
// no atomics and no sort, and the same bits from run to run.
//
//  * Forward: a warp takes one piece of one token's row (32 lanes x U
//    16-byte vectors) and walks the picks in order j = 0..k-1, G rows loaded
//    before they are added, summing w * value in float32 with the multiply
//    and the add rounded one by one (no FMA): in float32 that is the plain
//    loop's arithmetic, bit for bit, and in bfloat16 the sum is rounded once.
//    y is written once, with streaming stores.  The wrapper picks U from T
//    and the row's size (combine/kernel.py::launch_shape): whole 2 KB
//    pieces for many tokens, narrower ones where few tokens would leave SMs
//    idle (a decode step's 64).
//  * Backward: a warp takes one token.  Piece by piece it loads dy's piece
//    once, and for each kept pick loads the row's piece, stores w * dy into
//    the pick's slot and sums the piece's part of the dot product; a
//    butterfly of shuffles adds the lanes (every lane gets the same bits),
//    and lane j keeps pick j's running sum over the pieces.  Warps past the
//    last token write zeros into the slots no pick owns (the wrapper's
//    ownership bytes), so every row of d_y_flat is written once, in this
//    one launch.
//
// The vector paths need the row size to be a multiple of 16 bytes and the
// row bases 16-byte aligned; anything else takes the scalar paths (an
// element a lane, same order of arithmetic).  k <= 32: lane j holds pick
// j's slot and weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;  // kept equal to WARPS_PER_BLOCK in combine/kernel.py
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxTopK = 32;       // MAX_TOP_K there: a lane a pick
constexpr int kZeroRows = 16;      // ZERO_ROWS in combine/kernel_bwd.py: unowned slots a zeroing warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// A "vector" of an element type: 16 bytes on the vector path, one element on
// the scalar path, held raw until it is used and converted exactly.
template <typename T, bool kVec> struct Io;

template <> struct Io<float, true> {
  static constexpr int kPer = 4;
  using Raw = uint4;
  __device__ static Raw load(const float* row, int64_t i) {
    return load_nc(reinterpret_cast<const uint4*>(row) + i);
  }
  __device__ static void unpack(const Raw& r, float (&f)[kPer]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* row, int64_t i, const float (&f)[kPer]) {
    store_stream(reinterpret_cast<uint4*>(row) + i,
                 make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                            __float_as_uint(f[2]), __float_as_uint(f[3])));
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <> struct Io<__nv_bfloat16, true> {
  static constexpr int kPer = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* row, int64_t i) {
    return load_nc(reinterpret_cast<const uint4*>(row) + i);
  }
  __device__ static void unpack(const Raw& r, float (&f)[kPer]) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x); f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z); f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
  }
  __device__ static void store(__nv_bfloat16* row, int64_t i, const float (&f)[kPer]) {
    store_stream(reinterpret_cast<uint4*>(row) + i,
                 make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                            bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7])));
  }
};

template <> struct Io<float, false> {
  static constexpr int kPer = 1;
  using Raw = float;
  __device__ static Raw load(const float* row, int64_t i) { return row[i]; }
  __device__ static void unpack(const Raw& r, float (&f)[kPer]) { f[0] = r; }
  __device__ static void store(float* row, int64_t i, const float (&f)[kPer]) { row[i] = f[0]; }
};

template <> struct Io<__nv_bfloat16, false> {
  static constexpr int kPer = 1;
  using Raw = unsigned short;   // the raw bits, converted exactly
  __device__ static Raw load(const __nv_bfloat16* row, int64_t i) {
    return __bfloat16_as_ushort(row[i]);
  }
  __device__ static void unpack(const Raw& r, float (&f)[kPer]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  __device__ static void store(__nv_bfloat16* row, int64_t i, const float (&f)[kPer]) {
    row[i] = __float2bfloat16_rn(f[0]);
  }
};

__device__ __forceinline__ bool kept(int slot, int64_t S) {
  return slot >= 0 && static_cast<int64_t>(slot) < S;
}

// U vectors a lane per piece, G picks' rows loaded before they are added.
template <typename T, bool kVec, int U, int G>
__global__ void __launch_bounds__(kThreads)
moe_combine_fwd_kernel(const T* __restrict__ y_flat, const int* __restrict__ slot,
                       const float* __restrict__ w, T* __restrict__ y, int64_t num_tokens,
                       int64_t S, int64_t vecs, int d, int k, int pieces) {
  using IO = Io<T, kVec>;
  constexpr int kPer = IO::kPer;
  const int lane = threadIdx.x % kWarp;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (item >= num_tokens * pieces) return;
  const int64_t t = item / pieces;
  const int64_t first = static_cast<int64_t>(item % pieces) * (kWarp * U) + lane;
  const int my_slot = lane < k ? slot[t * k + lane] : -1;
  const float my_w = lane < k ? w[t * k + lane] : 0.0f;

  float acc[U][kPer];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[u][e] = 0.0f;

  for (int j0 = 0; j0 < k; j0 += G) {
    typename IO::Raw raw[G][U];
    bool on[G];
    float wj[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + g;
      const int s = __shfl_sync(kFull, my_slot, j % kWarp);
      wj[g] = __shfl_sync(kFull, my_w, j % kWarp);
      on[g] = j < k && kept(s, S);   // the same on every lane
      if (on[g]) {
        const T* row = y_flat + static_cast<int64_t>(s) * d;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t i = first + u * kWarp;
          if (i < vecs) raw[g][u] = IO::load(row, i);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!on[g]) continue;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (first + u * kWarp >= vecs) continue;
        float f[kPer];
        IO::unpack(raw[g][u], f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[u][e] = __fadd_rn(acc[u][e], __fmul_rn(wj[g], f[e]));
      }
    }
  }
  T* out = y + t * d;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = first + u * kWarp;
    if (i < vecs) IO::store(out, i, acc[u]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m /= 2) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <typename T, bool kVec, int U>
__global__ void __launch_bounds__(kThreads)
moe_combine_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y_flat,
                       const int* __restrict__ slot, const float* __restrict__ w,
                       const uint8_t* __restrict__ owned, T* __restrict__ d_y_flat,
                       float* __restrict__ d_w, int64_t num_tokens, int64_t S, int64_t vecs,
                       int d, int k, int pieces) {
  using IO = Io<T, kVec>;
  constexpr int kPer = IO::kPer;
  const int lane = threadIdx.x % kWarp;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;

  if (item >= num_tokens) {
    // The slots no pick owns: zeros, a warp a run of kZeroRows slots.
    const int64_t lo = (item - num_tokens) * kZeroRows;
    float zero[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) zero[e] = 0.0f;
    for (int64_t s = lo; s < lo + kZeroRows && s < S; ++s) {
      if (owned[s]) continue;
      T* row = d_y_flat + s * d;
      for (int64_t i = lane; i < vecs; i += kWarp) IO::store(row, i, zero);
    }
    return;
  }

  const int64_t t = item;
  const int my_slot = lane < k ? slot[t * k + lane] : -1;
  const float my_w = lane < k ? w[t * k + lane] : 0.0f;
  float my_dw = 0.0f;   // lane j: pick j's dot product, piece by piece
  const T* g_row = dy + t * d;
  for (int p = 0; p < pieces; ++p) {
    const int64_t first = static_cast<int64_t>(p) * (kWarp * U) + lane;
    float g[U][kPer];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = first + u * kWarp;
      if (i < vecs) {
        IO::unpack(IO::load(g_row, i), g[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e) g[u][e] = 0.0f;
      }
    }
    for (int j = 0; j < k; ++j) {
      const int s = __shfl_sync(kFull, my_slot, j);
      const float wj = __shfl_sync(kFull, my_w, j);
      if (!kept(s, S)) continue;   // the same on every lane
      const T* row = y_flat + static_cast<int64_t>(s) * d;
      T* dst = d_y_flat + static_cast<int64_t>(s) * d;
      typename IO::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t i = first + u * kWarp;
        if (i < vecs) raw[u] = IO::load(row, i);
      }
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t i = first + u * kWarp;
        if (i >= vecs) continue;
        float f[kPer], scaled[kPer];
        IO::unpack(raw[u], f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          part = __fmaf_rn(g[u][e], f[e], part);
          scaled[e] = __fmul_rn(wj, g[u][e]);
        }
        IO::store(dst, i, scaled);
      }
      const float total = warp_sum(part);
      if (lane == j) my_dw = __fadd_rn(my_dw, total);
    }
  }
  if (lane < k) d_w[t * k + lane] = kept(my_slot, S) ? my_dw : 0.0f;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool kVec, int U, int G>
void launch_fwd(const void* y_flat, const void* slot, const void* w, void* y, int64_t T_,
                int64_t S, int64_t vecs, int d, int k, cudaStream_t st) {
  const int pieces = static_cast<int>((vecs + kWarp * U - 1) / (kWarp * U));
  const int64_t items = T_ * pieces;
  const dim3 grid(static_cast<unsigned>((items + kWarpsPerBlock - 1) / kWarpsPerBlock));
  moe_combine_fwd_kernel<T, kVec, U, G><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(y_flat), static_cast<const int*>(slot),
      static_cast<const float*>(w), static_cast<T*>(y), T_, S, vecs, d, k, pieces);
}

template <typename T>
void dispatch_fwd(const void* y_flat, const void* slot, const void* w, void* y, int64_t T_,
                  int64_t S, int d, int k, int vecs_per_lane, cudaStream_t st) {
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  if (aligned16(y_flat) && aligned16(y) && row_bytes % 16 == 0) {
    const int64_t vecs = row_bytes / 16;
    if (vecs_per_lane >= 4) {
      launch_fwd<T, true, 4, 2>(y_flat, slot, w, y, T_, S, vecs, d, k, st);
    } else if (vecs_per_lane == 2) {
      launch_fwd<T, true, 2, 4>(y_flat, slot, w, y, T_, S, vecs, d, k, st);
    } else {
      launch_fwd<T, true, 1, 8>(y_flat, slot, w, y, T_, S, vecs, d, k, st);
    }
  } else {
    launch_fwd<T, false, 1, 8>(y_flat, slot, w, y, T_, S, d, d, k, st);
  }
}

template <typename T, bool kVec, int U>
void launch_bwd(const void* dy, const void* y_flat, const void* slot, const void* w,
                const void* owned, void* d_y_flat, void* d_w, int64_t T_, int64_t S,
                int64_t vecs, int d, int k, cudaStream_t st) {
  const int pieces = static_cast<int>((vecs + kWarp * U - 1) / (kWarp * U));
  const int64_t items = T_ + (S + kZeroRows - 1) / kZeroRows;
  const dim3 grid(static_cast<unsigned>((items + kWarpsPerBlock - 1) / kWarpsPerBlock));
  moe_combine_bwd_kernel<T, kVec, U><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y_flat), static_cast<const int*>(slot),
      static_cast<const float*>(w), static_cast<const uint8_t*>(owned), static_cast<T*>(d_y_flat),
      static_cast<float*>(d_w), T_, S, vecs, d, k, pieces);
}

template <typename T>
void dispatch_bwd(const void* dy, const void* y_flat, const void* slot, const void* w,
                  const void* owned, void* d_y_flat, void* d_w, int64_t T_, int64_t S, int d,
                  int k, cudaStream_t st) {
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  if (aligned16(dy) && aligned16(y_flat) && aligned16(d_y_flat) && row_bytes % 16 == 0) {
    launch_bwd<T, true, 4>(dy, y_flat, slot, w, owned, d_y_flat, d_w, T_, S, row_bytes / 16, d,
                           k, st);
  } else {
    launch_bwd<T, false, 1>(dy, y_flat, slot, w, owned, d_y_flat, d_w, T_, S, d, d, k, st);
  }
}

bool bad_shape(long long T, long long S, int d, int k) {
  return T < 0 || S < 0 || d < 1 || k < 1 || k > kMaxTopK || S > 2147483647LL;
}

}  // namespace

// y_flat: (S, d) float32 or bfloat16 (bf16 != 0).  slot: (T, k) int32, a
// slot in [0, S) or S for a dropped pick.  w: (T, k) float32.  y: (T, d) in
// y_flat's type.  vecs_per_lane: 1, 2 or 4, from combine/kernel.py's
// launch_shape.
extern "C" int dyskew_moe_combine(const void* y_flat, const void* slot, const void* w, void* y,
                                  long long T, long long S, int d, int k, int bf16,
                                  int vecs_per_lane, void* stream) {
  if (bad_shape(T, S, d, k) || vecs_per_lane < 1) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dispatch_fwd<__nv_bfloat16>(y_flat, slot, w, y, T, S, d, k, vecs_per_lane, st);
  } else {
    dispatch_fwd<float>(y_flat, slot, w, y, T, S, d, k, vecs_per_lane, st);
  }
  return cudaGetLastError();
}

// dy: (T, d) and y_flat: (S, d), both float32 or both bfloat16.  slot, w as
// above.  owned: (S,) bytes, non-zero where a kept pick owns the slot.
// d_y_flat: (S, d) in y_flat's type; d_w: (T, k) float32.
extern "C" int dyskew_moe_combine_bwd(const void* dy, const void* y_flat, const void* slot,
                                      const void* w, const void* owned, void* d_y_flat,
                                      void* d_w, long long T, long long S, int d, int k,
                                      int bf16, void* stream) {
  if (bad_shape(T, S, d, k)) return cudaErrorInvalidValue;
  if (T == 0 && S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    dispatch_bwd<__nv_bfloat16>(dy, y_flat, slot, w, owned, d_y_flat, d_w, T, S, d, k, st);
  } else {
    dispatch_bwd<float>(dy, y_flat, slot, w, owned, d_y_flat, d_w, T, S, d, k, st);
  }
  return cudaGetLastError();
}
