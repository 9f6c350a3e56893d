// Routing-plan gather for Hopper (sm_90a): out[s] = x[src[s]] if valid[s]
// else 0 — the data movement that builds the (E, C_buf, d) expert buffer.
//
// Replaces the Pallas kernel src/repro/kernels/dispatch/kernel.py
// (_dispatch_kernel / dispatch_gather), which parks a full (T, block_d)
// stripe of x in fast memory and copies one row per loop step.  Neither the
// stripe nor the sequential loop has a place here: rows are gathered
// straight from device memory, and the card's 50 MB L2 plays the stripe.
//
// Bound: bytes, and nothing else — no arithmetic at all.  The slots are
// expert-major, so with top-k routing each row of x is read about k times,
// with a few experts' worth of buffer stores (tens of MB at the served
// shape) in between.  Timed controls on the card showed that these re-reads,
// not the stores, set the time of a one-warp-per-row gather: with every
// source mapped into a few rows of x (re-reads surely in L2) it ran within
// 3 % of its stores alone.  Three parts of the design answer that:
//
//  * L2 policy.  The buffer is stored with streaming, evict-first stores
//    (st.global.cs), so its stores pass through L2 without pushing out the
//    rows of x that are read again; the rows are loaded with an evict_last
//    L2 cache hint (createpolicy + ld.global.nc.L2::cache_hint).  On the
//    card the streaming stores carry the gain; the load hint adds little.
//    No stream attribute is set: the stream is the caller's.
//  * A persistent grid.  A few blocks per SM (the wrapper sizes the grid);
//    each warp walks rows s, s + W, s + 2W, ... (W warps in all), so no
//    block is launched and retired per eight rows.
//  * No dependent-read chain.  A warp holds the next row's valid flag and
//    source index before it needs them (loaded one row ahead), and issues
//    the next piece's row loads before it stores the current piece: a row
//    is cut into pieces of 32 lanes x kUnroll 16-byte vectors, and the
//    warp's sequence of pieces runs through two register buffers in turn.
//
// An empty slot stores zeros WITHOUT reading x, which saves the read
// traffic of every empty slot.  That differs from x[src] * 0 only in the
// sign of zero and where x holds non-finite values (0 * inf is nan there, 0
// here): compare by value, not by bits.
//
// Rows are moved as raw bytes, so one kernel serves every element type.  The
// vector path needs the row size to be a multiple of 16 bytes and both base
// pointers 16-byte aligned; anything else takes the byte-wise path (off the
// served path: plain loads and stores, warp per row, same grid).  S and T
// are arbitrary.  A src outside [0, T) on a valid row is clamped into range
// so that a bad plan cannot read outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;       // kept equal to WARPS_PER_BLOCK in dispatch/kernel.py
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMinBlocksPerSm = 4;      // BLOCKS_PER_SM there: 64 registers a thread
constexpr int kUnroll = 4;              // 16-byte vectors a lane moves per piece
constexpr int kPiece = kWarp * kUnroll; // vectors per piece: 2 KB

__device__ __forceinline__ int64_t clamp_row(int r, int64_t T) {
  if (r < 0) return 0;
  if (r >= T) return T - 1;
  return r;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// A warp's place in its walk: piece p of row s (flag v, source row r), and
// the flag and source of its next row, loaded one row ahead.
struct Cursor {
  int64_t s, r, s_next, r_next;
  bool v, v_next;
  int p;
};

__device__ __forceinline__ void load_meta(const int* __restrict__ src,
                                          const uint8_t* __restrict__ valid, int64_t s,
                                          int64_t T, bool& v, int64_t& r) {
  v = valid[s] != 0;
  r = clamp_row(src[s], T);
}

// Moves the cursor to the next piece; false past the warp's last one.
__device__ __forceinline__ bool advance(Cursor& c, const int* __restrict__ src,
                                        const uint8_t* __restrict__ valid, int64_t S,
                                        int64_t T, int64_t W, int pieces) {
  if (++c.p < pieces) return true;
  if (c.s_next >= S) return false;
  c.s = c.s_next; c.v = c.v_next; c.r = c.r_next; c.p = 0;
  c.s_next = c.s + W;
  if (c.s_next < S) load_meta(src, valid, c.s_next, T, c.v_next, c.r_next);
  return true;
}

__device__ __forceinline__ void load_piece(uint4 (&buf)[kUnroll], const uint4* __restrict__ x,
                                           const Cursor& c, int vec_per_row, int lane,
                                           uint64_t keep) {
  if (!c.v) return;   // an empty slot never reads x
  const uint4* row = x + c.r * vec_per_row;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = c.p * kPiece + u * kWarp + lane;
    if (i < vec_per_row) buf[u] = load_keep(row + i, keep);
  }
}

__device__ __forceinline__ void store_piece(uint4* __restrict__ out, int64_t s, bool v, int p,
                                            const uint4 (&buf)[kUnroll], int vec_per_row,
                                            int lane) {
  uint4* dst = out + s * vec_per_row;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = p * kPiece + u * kWarp + lane;
    if (i < vec_per_row) store_stream(dst + i, v ? buf[u] : zero);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
dispatch_gather_kernel(const uint4* __restrict__ x, const int* __restrict__ src,
                       const uint8_t* __restrict__ valid, uint4* __restrict__ out,
                       int64_t S, int64_t T, int vec_per_row) {
  const int lane = threadIdx.x % kWarp;
  const int64_t W = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  Cursor c;
  c.s = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (c.s >= S) return;
  const int pieces = (vec_per_row + kPiece - 1) / kPiece;
  const uint64_t keep = evict_last_policy();
  load_meta(src, valid, c.s, T, c.v, c.r);
  c.p = 0;
  c.s_next = c.s + W;
  c.v_next = false;
  c.r_next = 0;
  if (c.s_next < S) load_meta(src, valid, c.s_next, T, c.v_next, c.r_next);

  // Two register buffers in turn, so that the next piece's loads go out
  // before this piece's stores and no register copy waits on a load.
  uint4 a[kUnroll], b[kUnroll];
  load_piece(a, x, c, vec_per_row, lane, keep);
  while (true) {
    int64_t s = c.s;
    bool v = c.v;
    int p = c.p;
    bool more = advance(c, src, valid, S, T, W, pieces);
    if (more) load_piece(b, x, c, vec_per_row, lane, keep);
    store_piece(out, s, v, p, a, vec_per_row, lane);
    if (!more) break;
    s = c.s; v = c.v; p = c.p;
    more = advance(c, src, valid, S, T, W, pieces);
    if (more) load_piece(a, x, c, vec_per_row, lane, keep);
    store_piece(out, s, v, p, b, vec_per_row, lane);
    if (!more) break;
  }
}

__global__ void __launch_bounds__(kThreads)
dispatch_bytes_kernel(const uint8_t* __restrict__ x, const int* __restrict__ src,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ out,
                      int64_t S, int64_t T, int64_t row_bytes) {
  const int lane = threadIdx.x % kWarp;
  const int64_t W = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
       s < S; s += W) {
    uint8_t* dst = out + s * row_bytes;
    if (valid[s]) {
      const uint8_t* row = x + clamp_row(src[s], T) * row_bytes;
      for (int64_t i = lane; i < row_bytes; i += kWarp) dst[i] = row[i];
    } else {
      for (int64_t i = lane; i < row_bytes; i += kWarp) dst[i] = 0;
    }
  }
}

}  // namespace

// x: (T, row_bytes) raw rows.  src: (S,) int32.  valid: (S,) bytes, non-zero
// = filled.  out: (S, row_bytes).  blocks: the persistent grid, from
// dispatch/kernel.py's launch_blocks.
extern "C" int dyskew_dispatch_gather(const void* x, const void* src,
                                      const void* valid, void* out, long long S,
                                      long long T, long long row_bytes,
                                      int blocks, void* stream) {
  if (S < 0 || T < 1 || row_bytes < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kThreads);
  const int* sp = static_cast<const int*>(src);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                       (row_bytes % 16 == 0) && (row_bytes / 16 <= 2147483647LL - kPiece);
  if (aligned) {
    dispatch_gather_kernel<<<grid, block, 0, st>>>(
        static_cast<const uint4*>(x), sp, vp, static_cast<uint4*>(out), S, T,
        static_cast<int>(row_bytes / 16));
  } else {
    dispatch_bytes_kernel<<<grid, block, 0, st>>>(
        static_cast<const uint8_t*>(x), sp, vp, static_cast<uint8_t*>(out), S, T,
        row_bytes);
  }
  return cudaGetLastError();
}
