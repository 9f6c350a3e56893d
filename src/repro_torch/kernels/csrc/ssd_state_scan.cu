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
//
// The backward (dyskew_ssd_state_scan_bwd, below).  repro has no Pallas
// backward: it differentiates the jnp scan of ssd_chunked
// (src/repro/models/layers/mamba2.py:132).  With g the prefix's gradient and
// a the adjoint of the state leaving chunk c,
//
//     a[C-2] = g[C-1],   a[c] = g[c+1] + decay[c+1, h] * a[c+1],
//     d_states[c] = a[c],   d_decay[c, h] = sum over (p, n) of a[c] * out[c]
//
// for c <= C-2; the last chunk's gradients are 0, and so is d_decay[0]
// (out[0] == 0, never read).  Bound: bytes.  g[1..C-1] and out[1..C-2] are
// read and the C planes of d_states written once: (9, 512, 64, 128) float32
// moves 24 planes, 403 MB.  Design: the forward's layout run backwards over
// the chunks (a block serves one h, a thread four consecutive elements of the
// plane with their adjoint in registers, the next chunk's g and out loaded
// before this chunk's store), so d_states costs what the forward's prefix
// costs.  d_decay is a reduction over the whole plane of each (c, h), which
// spans the blocks of that h: each chunk's products are summed in the thread,
// then across the warp by shuffles, then across the warps through shared
// memory, in a fixed order, into one partial a block and chunk; a second
// small kernel sums each (c, h)'s partials in block order.  No atomics: two
// runs give the same bits.  d_states equals the plain version bit for bit
// (the adjoint update is rounded as the forward's, and bfloat16 output is
// rounded to nearest even, as PyTorch casts); d_decay differs from it by the
// order of its sum.

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

// ---------------------------------------------------------------- backward

constexpr int kWarps = kThreads / 32;

// V consecutive float32 values of one thread.
template <int V>
struct Frag {
  float v[V];
};

template <int V>
__device__ __forceinline__ Frag<V> load_f32(const float* p);

template <>
__device__ __forceinline__ Frag<4> load_f32<4>(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}

template <>
__device__ __forceinline__ Frag<1> load_f32<1>(const float* p) {
  return {{__ldg(p)}};
}

// float32 to bfloat16 bits, rounded to nearest even as PyTorch casts.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

template <typename T, int V>
struct Store;

template <>
struct Store<float, 4> {
  static __device__ __forceinline__ void put(float* p, const Frag<4>& f) {
    *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
  }
};

template <>
struct Store<float, 1> {
  static __device__ __forceinline__ void put(float* p, const Frag<1>& f) { *p = f.v[0]; }
};

template <>
struct Store<uint16_t, 4> {
  static __device__ __forceinline__ void put(uint16_t* p, const Frag<4>& f) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(f.v[0]) | (bf16_bits(f.v[1]) << 16),
                                              bf16_bits(f.v[2]) | (bf16_bits(f.v[3]) << 16));
  }
};

template <>
struct Store<uint16_t, 1> {
  static __device__ __forceinline__ void put(uint16_t* p, const Frag<1>& f) {
    *p = static_cast<uint16_t>(bf16_bits(f.v[0]));
  }
};

// V elements per thread; partial[(c * H + h) * blocks_per_h + block] gets the
// block's share of d_decay[c, h] for 1 <= c <= C-2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_kernel(const float* __restrict__ g, const float* __restrict__ out,
                    const float* __restrict__ decay, T* __restrict__ d_states,
                    float* __restrict__ partial, int64_t C, int64_t H, int64_t PN,
                    int64_t blocks_per_h) {
  __shared__ float sdecay[kDecayTile];
  __shared__ float ssum[kDecayTile][kWarps];
  const int64_t h = blockIdx.x / blocks_per_h;
  const int64_t blk = blockIdx.x % blocks_per_h;
  const int64_t j = (blk * kThreads + threadIdx.x) * V;
  const bool active = j < PN;
  const int64_t plane = H * PN;
  const int64_t base = h * PN + j;
  const int64_t last = C - 1;  // the last chunk's state and decay reach no output
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Frag<V> zero = {};
  if (active) Store<T, V>::put(d_states + last * plane + base, zero);
  if (last == 0) return;
  // a: the adjoint of the state leaving chunk c, from a[C-2] = g[C-1] down.
  // gc, oc: g[c] and out[c], which chunk c's step reads (c >= 1).
  Frag<V> a = active ? load_f32<V>(g + last * plane + base) : zero;
  Frag<V> gc = zero, oc = zero;
  if (active && last - 1 >= 1) {
    gc = load_f32<V>(g + (last - 1) * plane + base);
    oc = load_f32<V>(out + (last - 1) * plane + base);
  }
  for (int64_t hi = last - 1; hi >= 0; hi -= kDecayTile) {
    const int64_t lo = hi - kDecayTile + 1 > 0 ? hi - kDecayTile + 1 : 0;
    __syncthreads();  // the previous tile's decays and sums are no longer read
    if (threadIdx.x <= hi - lo) sdecay[threadIdx.x] = __ldg(decay + (lo + threadIdx.x) * H + h);
    __syncthreads();
    for (int64_t c = hi; c >= lo; --c) {
      Frag<V> gn = zero, on = zero;
      if (active && c - 1 >= 1) {
        gn = load_f32<V>(g + (c - 1) * plane + base);
        on = load_f32<V>(out + (c - 1) * plane + base);
      }
      if (active) Store<T, V>::put(d_states + c * plane + base, a);
      if (c == 0) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) s = fmaf(a.v[i], oc.v[i], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) ssum[c - lo][warp] = s;
      const float d = sdecay[c - lo];
#pragma unroll
      for (int i = 0; i < V; ++i) a.v[i] = step(a.v[i], d, gc.v[i]);
      gc = gn;
      oc = on;
    }
    __syncthreads();
    const int64_t c = lo + threadIdx.x;
    if (c >= 1 && c <= hi) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += ssum[threadIdx.x][w];
      partial[(c * H + h) * blocks_per_h + blk] = s;
    }
  }
}

// d_decay[c, h] = the partials of (c, h) summed in block order; 0 for c = 0
// and c = C-1.
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_decay_kernel(const float* __restrict__ partial, float* __restrict__ d_decay,
                          int64_t C, int64_t H, int64_t blocks_per_h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= C * H) return;
  const int64_t c = i / H;
  float s = 0.f;
  if (c >= 1 && c < C - 1) {
    for (int64_t b = 0; b < blocks_per_h; ++b) s += partial[i * blocks_per_h + b];
  }
  d_decay[i] = s;
}

template <typename T>
cudaError_t launch_bwd(const float* g, const float* out, const float* decay, void* d_states,
                       float* d_decay, float* partial, int64_t C, int64_t H, int64_t PN,
                       cudaStream_t st) {
  const bool vec = (PN % 4 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(d_states) % (4 * sizeof(T)) == 0);
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec ? 4 : 1);
  const int64_t blocks_per_h = (PN + per_block - 1) / per_block;
  const int64_t blocks = H * blocks_per_h;
  const int64_t decay_blocks = (C * H + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || decay_blocks > 2147483647LL) return cudaErrorInvalidValue;
  T* ds = static_cast<T*>(d_states);
  if (vec) {
    ssd_scan_bwd_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        g, out, decay, ds, partial, C, H, PN, blocks_per_h);
  } else {
    ssd_scan_bwd_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        g, out, decay, ds, partial, C, H, PN, blocks_per_h);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_decay_kernel<<<static_cast<unsigned>(decay_blocks), kThreads, 0, st>>>(
      partial, d_decay, C, H, blocks_per_h);
  return cudaGetLastError();
}

}  // namespace

// g, out: (C, H, PN) float32 contiguous; decay: (C, H) float32 contiguous.
// d_states: (C, H, PN), float32 or (states_bf16 != 0) bfloat16; d_decay:
// (C, H) float32; partial: scratch of C * H * ceil(PN / 256) float32.
extern "C" int dyskew_ssd_state_scan_bwd(const void* g, const void* out, const void* decay,
                                         void* d_states, void* d_decay, void* partial,
                                         long long C, long long H, long long PN,
                                         int states_bf16, void* stream) {
  if (C < 1 || H < 1 || PN < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* of = static_cast<const float*>(out);
  const float* df = static_cast<const float*>(decay);
  float* dd = static_cast<float*>(d_decay);
  float* pf = static_cast<float*>(partial);
  if (states_bf16) return launch_bwd<uint16_t>(gf, of, df, d_states, dd, pf, C, H, PN, st);
  return launch_bwd<float>(gf, of, df, d_states, dd, pf, C, H, PN, st);
}

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
