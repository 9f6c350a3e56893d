// Mamba-2 inter-chunk state scan for Hopper (sm_90a): the exclusive prefix
//
//     out[0] = 0,   out[c + 1] = decay[c, h] * out[c] + states[c]
//
// over chunks c, independently for every (h, p, n), i.e. the state entering
// each chunk of the chunked SSD algorithm.  states (C, H, P, N) float32 or
// bfloat16, decay (C, H) float32, out (C, H, P, N) float32.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_scan_kernel / ssd_state_scan), which parks a (C, BH, BP, N) stripe
// of the contributions in VMEM and walks C with a fori_loop.  That design
// rests on a TPU's large VMEM and its in-order grid; here nothing carries
// over between blocks, so the walk over C is a loop inside each thread and
// nothing is staged but the decays.
//
// Bound: bytes.  The prefix is exclusive, so states[C-1] and decay[C-1]
// reach no output and are never read: C-1 planes are read once and C planes
// written once, with two floating-point operations per element read (C = 9,
// B*H = 512, P = 64, N = 128 float32 moves 285 MB for 0.067 GFLOP).
// Design: a block serves one h; a thread owns four consecutive elements of
// the (P*N) plane of that h and keeps their running state in registers, so
// a load or store is 16 bytes per thread (8 for bfloat16 input) and
// neighbouring threads touch neighbouring addresses.  The thread walks C,
// issuing the load of states[c + 1] before it stores out[c] and updates, so
// a chunk costs no full load latency; with about a million independent
// threads at the served shape the card has enough loads in flight to run at
// its memory rate.  The block's decays decay[c, h] are staged in shared
// memory, 256 chunks at a time.  Any C, H, P, N: a plane whose size is no
// multiple of four, or a base pointer off the vector grid, takes the scalar
// kernel (one element per thread); the ragged end of a plane is masked.
//
// Rounding: the update is __fmul_rn then __fadd_rn, never contracted into an
// fma, so the result equals the plain version (h * d, rounded, then + s,
// rounded) bit for bit, and chip_smoke.py compares the two with torch.equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDecayTile = kThreads;

template <typename T>
struct Load;

template <>
struct Load<float> {
  static __device__ __forceinline__ float one(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float4 four(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

// bfloat16 as its raw 16 bits: the float32 with the same upper half.
template <>
struct Load<uint16_t> {
  static __device__ __forceinline__ float one(const uint16_t* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
  }
  static __device__ __forceinline__ float4 four(const uint16_t* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

__device__ __forceinline__ float step(float h, float d, float s) {
  return __fadd_rn(__fmul_rn(h, d), s);
}

// Stages decay[c0 .. c0 + n - 1, h]; n may be 0 (the tile holds only the
// last chunk, whose decay is not used).
__device__ __forceinline__ void stage_decays(float* sdecay, const float* decay,
                                             int64_t c0, int64_t n, int64_t H, int64_t h) {
  __syncthreads();  // the previous tile is no longer read
  if (threadIdx.x < n) sdecay[threadIdx.x] = __ldg(decay + (c0 + threadIdx.x) * H + h);
  __syncthreads();
}

// Four elements per thread.  plane = H * PN elements per chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_vec_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                    float4* __restrict__ out, int64_t C, int64_t H, int64_t PN,
                    int64_t blocks_per_h) {
  __shared__ float sdecay[kDecayTile];
  const int64_t h = blockIdx.x / blocks_per_h;
  const int64_t j = ((blockIdx.x % blocks_per_h) * kThreads + threadIdx.x) * 4;
  const bool active = j < PN;
  const int64_t plane = H * PN;
  const int64_t base = h * PN + j;
  const int64_t last = C - 1;  // states[last] and decay[last, h] reach no output
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur = acc;
  if (active && last > 0) cur = Load<T>::four(states + base);
  for (int64_t c0 = 0; c0 < C; c0 += kDecayTile) {
    const int64_t n = C - c0 < kDecayTile ? C - c0 : kDecayTile;
    stage_decays(sdecay, decay, c0, last - c0 < n ? last - c0 : n, H, h);
    if (!active) continue;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t c = c0 + i;
      float4 nxt = cur;
      if (c + 1 < last) nxt = Load<T>::four(states + (c + 1) * plane + base);
      out[(c * plane + base) / 4] = acc;
      if (c == last) break;
      const float d = sdecay[i];
      acc.x = step(acc.x, d, cur.x);
      acc.y = step(acc.y, d, cur.y);
      acc.z = step(acc.z, d, cur.z);
      acc.w = step(acc.w, d, cur.w);
      cur = nxt;
    }
  }
}

// One element per thread: any plane size, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_scalar_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                       float* __restrict__ out, int64_t C, int64_t H, int64_t PN,
                       int64_t blocks_per_h) {
  __shared__ float sdecay[kDecayTile];
  const int64_t h = blockIdx.x / blocks_per_h;
  const int64_t j = (blockIdx.x % blocks_per_h) * kThreads + threadIdx.x;
  const bool active = j < PN;
  const int64_t plane = H * PN;
  const int64_t base = h * PN + j;
  const int64_t last = C - 1;  // states[last] and decay[last, h] reach no output
  float acc = 0.f;
  float cur = 0.f;
  if (active && last > 0) cur = Load<T>::one(states + base);
  for (int64_t c0 = 0; c0 < C; c0 += kDecayTile) {
    const int64_t n = C - c0 < kDecayTile ? C - c0 : kDecayTile;
    stage_decays(sdecay, decay, c0, last - c0 < n ? last - c0 : n, H, h);
    if (!active) continue;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t c = c0 + i;
      float nxt = cur;
      if (c + 1 < last) nxt = Load<T>::one(states + (c + 1) * plane + base);
      out[c * plane + base] = acc;
      if (c == last) break;
      acc = step(acc, sdecay[i], cur);
      cur = nxt;
    }
  }
}

template <typename T>
cudaError_t launch(const void* states, const float* decay, void* out, int64_t C,
                   int64_t H, int64_t PN, cudaStream_t st) {
  const bool vec = (PN % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(states) % (4 * sizeof(T)) == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? 4 : 1);
  const int64_t blocks_per_h = (PN + per_block - 1) / per_block;
  const int64_t blocks = H * blocks_per_h;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* s = static_cast<const T*>(states);
  if (vec) {
    ssd_scan_vec_kernel<T><<<grid, kThreads, 0, st>>>(
        s, decay, static_cast<float4*>(out), C, H, PN, blocks_per_h);
  } else {
    ssd_scan_scalar_kernel<T><<<grid, kThreads, 0, st>>>(
        s, decay, static_cast<float*>(out), C, H, PN, blocks_per_h);
  }
  return cudaGetLastError();
}

}  // namespace

// states: (C, H, PN) contiguous, float32 or (states_bf16 != 0) bfloat16.
// decay: (C, H) float32 contiguous.  out: (C, H, PN) float32.
extern "C" int dyskew_ssd_state_scan(const void* states, const void* decay, void* out,
                                     long long C, long long H, long long PN,
                                     int states_bf16, void* stream) {
  if (C < 0 || H < 0 || PN < 0) return cudaErrorInvalidValue;
  if (C == 0 || H == 0 || PN == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(decay);
  if (states_bf16) return launch<uint16_t>(states, d, out, C, H, PN, st);
  return launch<float>(states, d, out, C, H, PN, st);
}
