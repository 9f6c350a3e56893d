// Routing-plan gather for Hopper (sm_90a): out[s] = x[src[s]] if valid[s]
// else 0 — the data movement that builds the (E, C_buf, d) expert buffer.
//
// Replaces the Pallas kernel src/repro/kernels/dispatch/kernel.py
// (_dispatch_kernel / dispatch_gather), which parks a full (T, block_d)
// stripe of x in fast memory and copies one row per loop step.  Neither the
// stripe nor the sequential loop has a place here: rows are gathered
// straight from device memory.
//
// Bound: bytes, and nothing else — no arithmetic at all.  Design: one warp
// per output row, eight rows per block; a lane moves 16 bytes at a time
// (uint4), neighbouring lanes on neighbouring addresses, so a warp step is
// one 512-byte coalesced transaction each way.  The row index and the valid
// flag are read once per row.  An invalid row stores zeros WITHOUT reading
// x, which saves the read traffic of every empty slot.  That differs from
// x[src] * 0 only in the sign of zero and where x holds non-finite values
// (0 * inf is nan there, 0 here): compare by value, not by bits.
//
// Rows are moved as raw bytes, so one kernel serves every element type.  The
// vector path needs the row size to be a multiple of 16 bytes and both base
// pointers 16-byte aligned; anything else takes the byte-wise path.  S and T
// are arbitrary.  A src outside [0, T) on a valid row is clamped into range
// so that a bad plan cannot read outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ int64_t clamp_row(int r, int64_t T) {
  if (r < 0) return 0;
  if (r >= T) return T - 1;
  return r;
}

__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
dispatch_vec_kernel(const uint4* __restrict__ x, const int* __restrict__ src,
                    const uint8_t* __restrict__ valid, uint4* __restrict__ out,
                    int64_t S, int64_t T, int vec_per_row) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (s >= S) return;
  uint4* dst = out + s * vec_per_row;
  if (valid[s]) {
    const uint4* row = x + clamp_row(src[s], T) * vec_per_row;
#pragma unroll 4
    for (int i = lane; i < vec_per_row; i += kWarp) dst[i] = __ldg(row + i);
  } else {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = lane; i < vec_per_row; i += kWarp) dst[i] = zero;
  }
}

__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
dispatch_bytes_kernel(const uint8_t* __restrict__ x, const int* __restrict__ src,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ out,
                      int64_t S, int64_t T, int64_t row_bytes) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (s >= S) return;
  uint8_t* dst = out + s * row_bytes;
  if (valid[s]) {
    const uint8_t* row = x + clamp_row(src[s], T) * row_bytes;
    for (int64_t i = lane; i < row_bytes; i += kWarp) dst[i] = row[i];
  } else {
    for (int64_t i = lane; i < row_bytes; i += kWarp) dst[i] = 0;
  }
}

}  // namespace

// x: (T, row_bytes) raw rows.  src: (S,) int32.  valid: (S,) bytes, non-zero
// = filled.  out: (S, row_bytes).
extern "C" int dyskew_dispatch_gather(const void* x, const void* src,
                                      const void* valid, void* out, long long S,
                                      long long T, long long row_bytes,
                                      void* stream) {
  if (S < 0 || T < 1 || row_bytes < 1) return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const int64_t blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarp * kRowsPerBlock);
  const int* sp = static_cast<const int*>(src);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (row_bytes % 16 == 0) && (row_bytes / 16 <= 2147483647LL);
  if (aligned) {
    dispatch_vec_kernel<<<grid, block, 0, st>>>(
        static_cast<const uint4*>(x), sp, vp, static_cast<uint4*>(out), S, T,
        static_cast<int>(row_bytes / 16));
  } else {
    dispatch_bytes_kernel<<<grid, block, 0, st>>>(
        static_cast<const uint8_t*>(x), sp, vp, static_cast<uint8_t*>(out), S, T,
        row_bytes);
  }
  return cudaGetLastError();
}
