// Softmax attention, forward, for Hopper (sm_90a): the attention core of a
// call that needs no gradient, in one launch that never writes a score to
// device memory.
//
//   out[b, i, h] = sum_j p[i, j] v[b, j, h / G],
//   p[i, :]      = softmax_j(scale * <q[b, i, h], k[b, j, h / G]>)  over the kept keys j:
//                  j < kv_len, and j <= q_offset + i where causal.
//
// Replaces no Pallas kernel: repro's chunked attention is XLA's
// (src/repro/models/layers/attention.py), and the port ran it as
// chunked_attention (src/repro_torch/models/layers/attention.py), which
// writes each 512-query chunk's scores to device memory in bf16, again in
// float32, masks, takes the softmax and rounds it back: about 25 GB of
// traffic a layer of granite's 64 x 1,024-token prefill, where q, k, v and
// the output are 403 MB.
//
// Bound: at that shape the causal score and value products are 137.6 GFLOP
// a layer, 0.139 ms at the card's 989 TFLOP/s, against 0.120 ms for the
// bytes: the tensor cores.  The design:
//
//  * One block per (batch, query head, 128-query tile), the tiles with the
//    most keys scheduled first (the causal tile index runs down as the
//    block index runs up), the query heads of one kv head next to each
//    other so that they read its keys while they are in L2.
//  * The block's Q tile is loaded once and held in registers as mma
//    fragments.  Tiles of 64 keys and their values stream through a
//    double-buffered ring in shared memory by cp.async: the next tile's
//    copy runs under this tile's products.  Shared-memory rows are padded
//    by 16 bytes, so ldmatrix reads 8 rows without bank conflicts.
//  * QK^T and PV run on the tensor cores, mma.sync m16n8k16 with float32
//    sums, fed by ldmatrix (V by its transposing form).  Each warp owns 16
//    (head width 128) or 32 (head width 64) query rows; a key fragment
//    feeds every row tile of the warp.
//  * The scores stay float32 in registers, with an online softmax: a
//    running maximum and sum a row, exp2 (ex2.approx) with the scale and
//    log2(e) folded into one multiply-add.  The probabilities are rounded to the working
//    type for the product with v, as the plain path rounds them; the
//    running sum is of the float32 probabilities, and the output is divided
//    by it once, in float32, and rounded once.
//  * Tiles above the causal diagonal are never loaded; a warp whose rows
//    all lie above a tile's first key skips its products.  The diagonal
//    tile and a ragged kv_len or Sq edge are masked in registers; rows and
//    keys past the edge are zero-filled in shared memory, never read.
//
// Head widths 64 and 128 only, bf16 or fp16; the causal flag, q_offset and
// kv_len are run-time arguments.  q, k and v are read through their
// (batch, position, head) strides with the head width contiguous; out is
// (B, Sq, H, hd), contiguous.  No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;  // queries a block (BLOCK_Q in attention/kernel.py)
constexpr int kBlockN = 64;   // keys a tile
constexpr int kPad = 8;       // elements of padding a shared-memory row
constexpr unsigned kFull = 0xffffffffu;

// Row tiles of 16 queries a warp, and warps a block, by head width.
template <int HD> struct Shape;
template <> struct Shape<64> {
  static constexpr int kMTiles = 2;
  static constexpr int kWarps = 4;
};
template <> struct Shape<128> {
  static constexpr int kMTiles = 1;
  static constexpr int kWarps = 8;
};

template <int HD>
constexpr size_t smem_bytes() {
  // Q, then two buffers of K, then two of V.
  return static_cast<size_t>(kBlockM + 4 * kBlockN) * (HD + kPad) * 2;
}

// 2^x by the special-function unit alone (exp2f adds a path for results
// below float32's normal range, which a probability can round to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !pred (no byte read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a * b on the tensor cores (m16n8k16, float32 sums), and two floats
// packed into one register of the element type (the lower column low).
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int B, int Sq, int H, int G, int n_qt, int64_t q_sb,
                     int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh, int q_offset, int kv_len,
                     int causal, float scale_log2) {
  constexpr int kMT = Shape<HD>::kMTiles;
  constexpr int kThreads = Shape<HD>::kWarps * 32;
  constexpr int RS = HD + kPad;      // a shared-memory row, in elements
  constexpr int CPR = HD / 8;        // 16-byte pieces a row
  constexpr int KS = HD / 16;        // k-steps of QK^T
  constexpr int DN = HD / 8;         // n-tiles of 8 output columns
  constexpr int NT = kBlockN / 8;    // n-tiles of 8 keys
  static_assert(Shape<HD>::kWarps * 16 * kMT == kBlockM, "a block's warps cover its queries");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockM * RS;
  T* sV = sK + 2 * kBlockN * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t bh = static_cast<int64_t>(B) * H;
  const int64_t lin = blockIdx.x;
  const int qt = n_qt - 1 - static_cast<int>(lin / bh);
  const int rem = static_cast<int>(lin % bh);
  const int b = rem / H, h = rem % H, kvh = h / G;
  const int q0 = qt * kBlockM;
  const int rows = min(kBlockM, Sq - q0);
  // Keys this tile reads: none past kv_len, none past its last query.
  const int n_kv = causal ? min(kv_len, q_offset + q0 + rows) : kv_len;
  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;

  const T* qb = q + b * q_sb + h * q_sh + static_cast<int64_t>(q0) * q_ss;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBlockM * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < rows;
    cp_async16(smem_u32(sQ + r * RS + c * 8), qb + (ok ? r : 0) * q_ss + c * 8, ok);
  }
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * kBlockN;
    T* dk = sK + buf * kBlockN * RS;
    T* dv = sV + buf * kBlockN * RS;
    for (int i = tid; i < kBlockN * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = k0 + r < n_kv;
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(smem_u32(dk + r * RS + c * 8), kb + row * k_ss + c * 8, ok);
      cp_async16(smem_u32(dv + r * RS + c * 8), vb + row * v_ss + c * 8, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // This thread's rows of a row tile: g and g + 8; its columns of an
  // n-tile: 2t and 2t + 1 (the mma fragments' layout).
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16 * kMT;                     // the warp's first row in the block
  const int first_pos = q_offset + q0 + wr;           // its first row's position
  const int last_pos = first_pos + 16 * kMT - 1;

  uint32_t qf[kMT][KS][4];
  float o[kMT][DN][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[mt][dn][0] = o[mt][dn][1] = o[mt][dn][2] = o[mt][dn][3] = 0.f;
    }
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int row = wr + mt * 16 + (lane & 15);
          const int col = ks * 16 + (lane >> 4) * 8;
          ldsm_x4(smem_u32(sQ + row * RS + col), qf[mt][ks][0], qf[mt][ks][1], qf[mt][ks][2],
                  qf[mt][ks][3]);
        }
      }
    }
    // The next tile's copy runs under this tile's products; its buffer was
    // last read in iteration j - 1, which every thread has left.
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();

    const int k0 = j * kBlockN;
    if (causal && k0 > last_pos) continue;  // every key of the tile lies above the warp's rows
    const T* sk = sK + buf * kBlockN * RS;
    const T* sv = sV + buf * kBlockN * RS;

    float s[kMT][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_u32(sk + key * RS + col), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          Mma<T>::run(s[mt][2 * np], qf[mt][ks], b0, b1);
          Mma<T>::run(s[mt][2 * np + 1], qf[mt][ks], b2, b3);
        }
      }
    }

    const bool masked = k0 + kBlockN > kv_len || (causal && k0 + kBlockN - 1 > first_pos);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (masked) {
        const int pos0 = first_pos + mt * 16 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            const int pos = pos0 + (e >> 1) * 8;
            if (key >= kv_len || (causal && key > pos)) s[mt][nt][e] = -INFINITY;
          }
        }
      }
      // The running maximum over the row (the quad of lanes that share
      // it), the rescale of what came before, the tile's probabilities.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx * scale_log2);
        // A row with no kept key yet keeps everything at 0.
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m[mt][r] - m_use);
        m[mt][r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float p0 = fast_exp2(fmaf(s[mt][nt][2 * r], scale_log2, -m_use));
          const float p1 = fast_exp2(fmaf(s[mt][nt][2 * r + 1], scale_log2, -m_use));
          s[mt][nt][2 * r] = p0;
          s[mt][nt][2 * r + 1] = p1;
          sum += p0 + p1;
        }
        l[mt][r] = l[mt][r] * alpha + sum;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          o[mt][dn][2 * r] *= alpha;
          o[mt][dn][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V: the probabilities' accumulator layout is the A fragment's
    // of the next product, 16 keys (two n-tiles) a k-step.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = Mma<T>::pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = Mma<T>::pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = Mma<T>::pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = Mma<T>::pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = dp * 16 + (lane >> 4) * 8;
        ldsm_x4_t(smem_u32(sv + key * RS + col), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          Mma<T>::run(o[mt][2 * dp], pa[mt], b0, b1);
          Mma<T>::run(o[mt][2 * dp + 1], pa[mt], b2, b3);
        }
      }
    }
  }

  // Each row's sum over its quad, then the output divided once and
  // rounded once; rows past Sq are not written.
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      const int row = wr + mt * 16 + g + r * 8;
      if (row < rows) {
        T* dst = out + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * HD + 2 * t;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          *reinterpret_cast<uint32_t*>(dst + dn * 8) =
              Mma<T>::pack(o[mt][dn][2 * r] * inv, o[mt][dn][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int H, int G,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh, int q_offset,
           int kv_len, int causal, float scale_log2, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = attention_fwd_kernel<T, HD>;
  // Above 48 KB of shared memory only once allowed, once a device.
  static uint64_t allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(allowed >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed |= uint64_t{1} << dev;
  }
  const int n_qt = (Sq + kBlockM - 1) / kBlockM;
  const long long blocks = static_cast<long long>(n_qt) * B * H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), Shape<HD>::kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), B, Sq, H, G, n_qt, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, q_offset, kv_len, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int H, int G,
             int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
             long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
             int q_offset, int kv_len, int causal, float scale_log2, cudaStream_t st) {
  if (hd == 64) {
    return launch<T, 64>(q, k, v, out, B, Sq, H, G, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, q_offset, kv_len, causal, scale_log2, st);
  }
  return launch<T, 128>(q, k, v, out, B, Sq, H, G, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                        v_sh, q_offset, kv_len, causal, scale_log2, st);
}

}  // namespace

// q: (B, Sq, H, hd) and k, v: (B, Skv, H / G, hd), all bf16 or all fp16
// (fp16 != 0), the head width contiguous; each stride in elements, a
// multiple of 8, the bases 16-byte aligned.  Query head h reads kv head
// h / G.  out: (B, Sq, H, hd), contiguous.  hd: 64 or 128.  Keys j <
// kv_len are kept, and where causal those with j <= q_offset + i for query
// i; kv_len >= 1.  scale_log2: the score scale times log2(e).
extern "C" int dyskew_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                    int Sq, int H, int G, int hd, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb, long long k_ss,
                                    long long k_sh, long long v_sb, long long v_ss,
                                    long long v_sh, int q_offset, int kv_len, int causal,
                                    float scale_log2, int fp16, void* stream) {
  if (B < 0 || Sq < 0 || H < 1 || G < 1 || H % G != 0 || (hd != 64 && hd != 128) ||
      q_offset < 0 || kv_len < 1) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp16) {
    return dispatch<__half>(q, k, v, out, B, Sq, H, G, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, q_offset, kv_len, causal, scale_log2, st);
  }
  return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, H, G, hd, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, q_offset, kv_len, causal, scale_log2, st);
}
