// Flash attention backward for Hopper (sm_90a): K5b, the gradient of K5.
//
// repro has no backward kernel: its training differentiates the jnp flash
// path (repro/models/layers.py::flash_attention) with jax.grad.  The port's
// forward is K5 (flash_attention{,_tc}.cu), so its gradient is a kernel
// too, and computes what jax.grad of that path computes: given q, k, v, the
// forward's output o and its per-row logsumexp lse (natural log of the
// scaled scores, written by K5), and the output gradient dO,
//   D  = rowsum(dO * o)                 (per query row, f32)
//   P  = exp(q k^T * scale - lse)       (0 where masked or past Sk)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = dS K * scale,  dK = dS^T q * scale,
// with dK and dV summed over the g query heads of each kv head (GQA), the
// top-left causal mask of K5 (query i sees keys 0..i; training has Sq = Sk,
// where top-left and bottom-right agree, and the wrapper refuses causal
// with Sq != Sk), and P recomputed from the forward's lse, never stored.
//
// Bound on this card: at qwen2.5-3b's training shape (B 8, S 1024, H 16,
// Hkv 2, hd 128, bf16, causal) the five products (q K^T, dO V^T, P^T dO,
// dS^T q, dS K) are 5 * 2 * B H S^2 hd / 2 = 86 GFLOP, 0.087 ms at the tensor
// cores' 989 TFLOP/s, against 50 MB of inputs and outputs (0.015 ms): the
// operations bind.  This first design is the deterministic FA2 backward,
// right before fast, in three launches and with no atomics:
//   * a preprocess writes D, one warp a row of o and dO;
//   * a dK/dV kernel, one block (4 warps) per (batch, kv head, 64 keys):
//     each warp owns 16 key rows and keeps their dK and dV rows in f32
//     registers across the loop over the kv head's g query heads and the
//     query steps of 32 rows that the causal mask lets through; S^T and dP^T
//     are computed with keys as rows, so P^T and dS^T leave the
//     accumulators already in the A-operand layout of the next product;
//   * a dQ kernel, one block per (batch, q head, 64 query rows), 16 rows a
//     warp, looping over the key tiles of 64 the mask lets through, the
//     heaviest query tiles first (as K5).
// Each block writes its rows of dQ, dK or dV once, so the result does not
// depend on the schedule.  bf16 and fp16 at hd 64 and 128 run on the
// tensor cores with mma.sync m16n8k16 and f32 accumulators (as K3's
// tensor-core route): tiles are staged in shared memory as 16-bit values,
// rows padded by 16 bytes so that the fragment loads of a warp fall on 32
// distinct banks, and q and dO also transposed for the products that take
// their rows as the reduction axis.  P and dS enter their products rounded
// to the input type (FA2's recipe; the forward keeps p at f32 precision
// with a split into two 16-bit parts, which would double the backward's
// MMA work).  f32 at hd 64 and 128 runs the same schedule on the CUDA
// cores in f32 (256 threads a block, 4 x 4 outputs a thread), whose 1e-4
// tolerance the tensor cores cannot meet.  Other head dims (112, MLA's
// 192 / 128, 16, 32) have no backward yet; the wrapper refuses them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTcThreads = 128;   // tensor-core kernels: 4 warps, 16 rows each
constexpr int kKeyTile = 64;      // key rows of a dK/dV block
constexpr int kQStep = 32;        // query rows of a dK/dV step (tensor cores)
constexpr int kQTile = 64;        // query rows of a dQ block
constexpr int kKStep = 64;        // key positions of a dQ step
constexpr int kPad = 8;           // 16-byte row padding of the 16-bit tiles
constexpr int kSimtThreads = 256; // the f32 kernels: 16 x 16 threads
constexpr int kSimtTile = 64;     // their key and query tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// ---------------------------------------------------------------------------
// Preprocess: D = rowsum(dO * o), one warp a (batch, position, head) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                 float* __restrict__ delta, int rows, int Sq, int H, int hdv) {
  const int row = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                     // whole warps leave together
  const T* o = out + static_cast<size_t>(row) * hdv;
  const T* d = dout + static_cast<size_t>(row) * hdv;
  float acc = 0.f;
  for (int c = lane; c < hdv; c += 32) acc = fmaf(to_float(o[c]), to_float(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int bq = row / H;                    // b * Sq + position
    const int b = bq / Sq;
    delta[(static_cast<size_t>(b) * H + h) * Sq + (bq - b * Sq)] = acc;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 / fp16)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {   // a in the low half
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d (16 x 8, f32) += a (16 x 16) . b (16 x 8)
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Fragments of mma.m16n8k16 for lane (gr = lane / 4, tq = lane % 4):
//   A (16 x 16): rows gr and gr + 8, columns 2 tq, 2 tq + 1 and those + 8;
//   B (16 x 8):  column gr, rows 2 tq, 2 tq + 1 and those + 8;
//   C (16 x 8):  rows gr (c0, c1) and gr + 8 (c2, c3), columns 2 tq, 2 tq + 1.
// A from a row-major tile (rows r0.., columns c0..); B from a tile whose
// rows are B's columns (n0..) and whose columns are the reduction (k0..).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int ld, int r0, int c0,
                                       int gr, int tq) {
  const T* p = tile + (r0 + gr) * ld + c0 + 2 * tq;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

template <typename T>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const T* tile, int ld, int n0,
                                       int k0, int gr, int tq) {
  const T* p = tile + (n0 + gr) * ld + k0 + 2 * tq;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// C fragments of n-tiles 2 j and 2 j + 1 (16 columns) -> the A operand of
// k-step j of the next product
template <typename T, int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4], int j) {
  a[0] = pack2<T>(c[2 * j][0], c[2 * j][1]);
  a[1] = pack2<T>(c[2 * j][2], c[2 * j][3]);
  a[2] = pack2<T>(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack2<T>(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// rows [p0, p0 + rows) of one head of a (B, S, heads, HD) tensor (row
// stride `stride` elements) -> tile[r * ld + c], and, where `tile_t` is
// given, tile_t[c * ld_t + r]; rows past S are zero.  16-byte loads.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* tile, int ld, T* tile_t, int ld_t, const T* src, int p0,
                                      int rows, int S, size_t stride, int nthreads) {
  constexpr int kVec = 8;                      // 16-bit values in 16 bytes
  for (int e = threadIdx.x; e < rows * (HD / kVec); e += nthreads) {
    const int r = e / (HD / kVec);
    const int c = (e - r * (HD / kVec)) * kVec;
    const int pos = p0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < S) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(pos) * stride + c);
    *reinterpret_cast<uint4*>(tile + r * ld + c) = val;
    if (tile_t != nullptr) {
      const T* vals = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < kVec; ++i) tile_t[(c + i) * ld_t + r] = vals[i];
    }
  }
}

template <int HD>
struct DkDvSmem {
  static constexpr int kLd = HD + kPad;        // row-major tiles
  static constexpr int kLdT = kQStep + kPad;   // transposed q and dO
  static constexpr int kBytes =
      2 * (2 * kKeyTile * kLd + 2 * kQStep * kLd + 2 * HD * kLdT) + 2 * kQStep * 4;
};

template <int HD>
struct DqSmem {
  static constexpr int kLd = HD + kPad;
  static constexpr int kLdT = kKStep + kPad;   // transposed K
  static constexpr int kBytes = 2 * (2 * kQTile * kLd + 2 * kKStep * kLd + HD * kLdT);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                       float scale, int causal) {
  using L = DkDvSmem<HD>;
  constexpr int NT = HD / 8;                   // n-tiles of dK and dV
  constexpr int NQ = kQStep / 8;               // n-tiles of S^T (query columns)
  const int bkh = blockIdx.x;                  // b * Hkv + kv head
  const int b = bkh / Hkv;
  const int kh = bkh - b * Hkv;
  const int g = H / Hkv;
  const int k0 = blockIdx.y * kKeyTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int kr = warp * 16;                    // this warp's key rows in the tile

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* const k_s = reinterpret_cast<T*>(smem_raw);
  T* const v_s = k_s + kKeyTile * L::kLd;
  T* const q_s = v_s + kKeyTile * L::kLd;
  T* const do_s = q_s + kQStep * L::kLd;
  T* const qt_s = do_s + kQStep * L::kLd;
  T* const dot_s = qt_s + HD * L::kLdT;
  float* const lse_s = reinterpret_cast<float*>(dot_s + HD * L::kLdT);
  float* const d_s = lse_s + kQStep;

  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  stage<T, HD>(k_s, L::kLd, nullptr, 0, k + kv_base, k0, kKeyTile, Sk, kv_stride, kTcThreads);
  stage<T, HD>(v_s, L::kLd, nullptr, 0, v + kv_base, k0, kKeyTile, Sk, kv_stride, kTcThreads);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }

  // causal: queries before k0 see none of this tile's keys
  const int q_first = causal ? k0 : 0;
  for (int hi = 0; hi < g; ++hi) {
    const int h = kh * g + hi;
    const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += kQStep) {
      __syncthreads();                         // the last step's reads are done
      stage<T, HD>(q_s, L::kLd, qt_s, L::kLdT, q + q_base, q0, kQStep, Sq, q_stride, kTcThreads);
      stage<T, HD>(do_s, L::kLd, dot_s, L::kLdT, dout + q_base, q0, kQStep, Sq, q_stride,
                   kTcThreads);
      if (threadIdx.x < kQStep) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < Sq ? lse[row_base + qp] : INFINITY;   // P = 0 past Sq
        d_s[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
      }
      __syncthreads();
      if (causal && q0 + kQStep - 1 < k0 + kr) continue;   // all of this warp's keys masked

      // S^T = K q^T: 16 key rows x kQStep queries
      float st[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, k_s, L::kLd, kr, kk * 16, gr, tq);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, q_s, L::kLd, n * 8, kk * 16, gr, tq);
          mma16816<T>(st[n], a, b0, b1);
        }
      }
      // P^T = exp(S^T scale - lse), 0 where masked or past Sk
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + gr + (e >> 1) * 8;
          const int col = n * 8 + 2 * tq + (e & 1);
          const bool keep = key < Sk && !(causal && q0 + col < key);
          st[n][e] = keep ? exp2f((st[n][e] * scale - lse_s[col]) * kLog2e) : 0.f;
        }
      // dV += P^T dO
#pragma unroll
      for (int j = 0; j < kQStep / 16; ++j) {
        uint32_t a[4];
        c_to_a<T>(a, st, j);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, dot_s, L::kLdT, n * 8, j * 16, gr, tq);
          mma16816<T>(dv_acc[n], a, b0, b1);
        }
      }
      // dP^T = V dO^T
      float dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        load_a(a, v_s, L::kLd, kr, kk * 16, gr, tq);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, do_s, L::kLd, n * 8, kk * 16, gr, tq);
          mma16816<T>(dpt[n], a, b0, b1);
        }
      }
      // dS^T = P^T (dP^T - D), into st
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= dpt[n][e] - d_s[n * 8 + 2 * tq + (e & 1)];
      // dK += dS^T q
#pragma unroll
      for (int j = 0; j < kQStep / 16; ++j) {
        uint32_t a[4];
        c_to_a<T>(a, st, j);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, qt_s, L::kLdT, n * 8, j * 16, gr, tq);
          mma16816<T>(dk_acc[n], a, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr + gr + 8 * half;
    if (key >= Sk) continue;
    const size_t at = kv_base + static_cast<size_t>(key) * kv_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2<T>(dk + at + n * 8, dk_acc[n][2 * half] * scale, dk_acc[n][2 * half + 1] * scale);
      store2<T>(dv + at + n * 8, dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                     int Hkv, float scale, int causal) {
  using L = DqSmem<HD>;
  constexpr int NT = HD / 8;                   // n-tiles of dQ
  constexpr int NK = kKStep / 8;               // n-tiles of S (key columns)
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int qt = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kQTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int qr = warp * 16;                    // this warp's query rows in the tile

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* const q_s = reinterpret_cast<T*>(smem_raw);
  T* const do_s = q_s + kQTile * L::kLd;
  T* const k_s = do_s + kQTile * L::kLd;
  T* const v_s = k_s + kKStep * L::kLd;
  T* const kt_s = v_s + kKStep * L::kLd;

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  stage<T, HD>(q_s, L::kLd, nullptr, 0, q + q_base, q0, kQTile, Sq, q_stride, kTcThreads);
  stage<T, HD>(do_s, L::kLd, nullptr, 0, dout + q_base, q0, kQTile, Sq, q_stride, kTcThreads);

  const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + qr + gr + 8 * half;
    lse_r[half] = qp < Sq ? lse[row_base + qp] : INFINITY;
    d_r[half] = qp < Sq ? delta[row_base + qp] : 0.f;
  }
  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  int n_kt = (Sk + kKStep - 1) / kKStep;
  if (causal) n_kt = min(n_kt, (min(q0 + kQTile, Sq) - 1) / kKStep + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKStep;
    __syncthreads();
    stage<T, HD>(k_s, L::kLd, kt_s, L::kLdT, k + kv_base, k0, kKStep, Sk, kv_stride, kTcThreads);
    stage<T, HD>(v_s, L::kLd, nullptr, 0, v + kv_base, k0, kKStep, Sk, kv_stride, kTcThreads);
    __syncthreads();
    if (causal && q0 + qr + 15 < k0) continue;   // all of this warp's rows masked

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], a2[4];
      load_a(a, q_s, L::kLd, qr, kk * 16, gr, tq);
      load_a(a2, do_s, L::kLd, qr, kk * 16, gr, tq);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, k_s, L::kLd, n * 8, kk * 16, gr, tq);
        mma16816<T>(s[n], a, b0, b1);            // S = q K^T
        load_b(b0, b1, v_s, L::kLd, n * 8, kk * 16, gr, tq);
        mma16816<T>(dp[n], a2, b0, b1);          // dP = dO V^T
      }
    }
    // dS = P (dP - D), P = exp(S scale - lse), 0 where masked or past Sk
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int key = k0 + n * 8 + 2 * tq + (e & 1);
        const bool keep = key < Sk && !(causal && q0 + qr + gr + 8 * half < key);
        const float p = keep ? exp2f((s[n][e] * scale - lse_r[half]) * kLog2e) : 0.f;
        s[n][e] = p * (dp[n][e] - d_r[half]);
      }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < kKStep / 16; ++j) {
      uint32_t a[4];
      c_to_a<T>(a, s, j);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, L::kLdT, n * 8, j * 16, gr, tq);
        mma16816<T>(dq_acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + qr + gr + 8 * half;
    if (qp >= Sq) continue;
    const size_t at = q_base + static_cast<size_t>(qp) * q_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2<T>(dq + at + n * 8, dq_acc[n][2 * half] * scale, dq_acc[n][2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// f32 route on the CUDA cores: the same schedule, 64 x 64 tiles, thread
// (ty, tx) of 16 x 16 owning rows ty + 16 i and columns tx + 16 j
// ---------------------------------------------------------------------------

// rows [p0, p0 + rows) of one head of a (B, S, heads, HD) f32 tensor ->
// dst[r * ld + c]; rows past S are zero
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, int p0, int rows,
                                          int S, size_t stride) {
  for (int e = threadIdx.x; e < rows * HD; e += kSimtThreads) {
    const int r = e / HD;
    const int c = e - r * HD;
    const int pos = p0 + r;
    dst[r * ld + c] = pos < S ? src[static_cast<size_t>(pos) * stride + c] : 0.f;
  }
}

template <int HD>
constexpr int simt_dkdv_smem() {                // K, V, q, dO; P^T, dS^T; lse, D
  return 4 * (4 * kSimtTile * (HD + 1) + 2 * kSimtTile * (kSimtTile + 1) + 2 * kSimtTile);
}

template <int HD>
constexpr int simt_dq_smem() {                  // q, dO, K, V; dS; lse, D
  return 4 * (4 * kSimtTile * (HD + 1) + kSimtTile * (kSimtTile + 1) + 2 * kSimtTile);
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    bwd_dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                         int Hkv, float scale, int causal) {
  constexpr int T = kSimtTile;
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  const int bkh = blockIdx.x;
  const int b = bkh / Hkv;
  const int kh = bkh - b * Hkv;
  const int g = H / Hkv;
  const int k0 = blockIdx.y * T;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  extern __shared__ float smem_f[];
  float* const k_s = smem_f;
  float* const v_s = k_s + T * LD;
  float* const q_s = v_s + T * LD;
  float* const do_s = q_s + T * LD;
  float* const pt_s = do_s + T * LD;           // P^T: T keys x (T + 1)
  float* const dst_s = pt_s + T * (T + 1);     // dS^T
  float* const lse_s = dst_s + T * (T + 1);
  float* const d_s = lse_s + T;

  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  stage_f32<HD>(k_s, LD, k + kv_base, k0, T, Sk, kv_stride);
  stage_f32<HD>(v_s, LD, v + kv_base, k0, T, Sk, kv_stride);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int q_first = causal ? k0 : 0;
  for (int hi = 0; hi < g; ++hi) {
    const int h = kh * g + hi;
    const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += T) {
      __syncthreads();
      stage_f32<HD>(q_s, LD, q + q_base, q0, T, Sq, q_stride);
      stage_f32<HD>(do_s, LD, dout + q_base, q0, T, Sq, q_stride);
      if (threadIdx.x < T) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < Sq ? lse[row_base + qp] : INFINITY;
        d_s[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = 0.f;
          dpt[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv_[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv_[i] = k_s[(ty + 16 * i) * LD + d];
          vv[i] = v_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * LD + d];
          dov[j] = do_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv_[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty + 16 * i;
          const int col = tx + 16 * j;
          const bool keep = key < Sk && !(causal && q0 + col < key);
          const float p = keep ? expf(st[i][j] * scale - lse_s[col]) : 0.f;
          pt_s[(ty + 16 * i) * (T + 1) + col] = p;
          dst_s[(ty + 16 * i) * (T + 1) + col] = p * (dpt[i][j] - d_s[col]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < T; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * (T + 1) + r];
          sv[i] = dst_s[(ty + 16 * i) * (T + 1) + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = do_s[r * LD + tx + 16 * j];
          const float qv = q_s[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const size_t at = kv_base + static_cast<size_t>(key) * kv_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[at + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
                       int causal) {
  constexpr int T = kSimtTile;
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int qt = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * T;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  extern __shared__ float smem_f[];
  float* const q_s = smem_f;
  float* const do_s = q_s + T * LD;
  float* const k_s = do_s + T * LD;
  float* const v_s = k_s + T * LD;
  float* const ds_s = v_s + T * LD;            // dS: T queries x (T + 1)
  float* const lse_s = ds_s + T * (T + 1);
  float* const d_s = lse_s + T;

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
  stage_f32<HD>(q_s, LD, q + q_base, q0, T, Sq, q_stride);
  stage_f32<HD>(do_s, LD, dout + q_base, q0, T, Sq, q_stride);
  if (threadIdx.x < T) {
    const int qp = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qp < Sq ? lse[row_base + qp] : INFINITY;
    d_s[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
  }

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  int n_kt = (Sk + T - 1) / T;
  if (causal) n_kt = min(n_kt, (min(q0 + T, Sq) - 1) / T + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    stage_f32<HD>(k_s, LD, k + kv_base, k0, T, Sk, kv_stride);
    stage_f32<HD>(v_s, LD, v + kv_base, k0, T, Sk, kv_stride);
    __syncthreads();
    // S and dP: queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv_[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        dov[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv_[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i;
        const int key = k0 + tx + 16 * j;
        const bool keep = key < Sk && !(causal && q0 + row < key);
        const float p = keep ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        ds_s[row * (T + 1) + tx + 16 * j] = p * (dp[i][j] - d_s[row]);
      }
    __syncthreads();
    // dQ += dS K: queries ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * (T + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv_ = k_s[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(sv[i], kv_, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const size_t at = q_base + static_cast<size_t>(qp) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[at + tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const Args& a, int hd) {
  const int rows = a.B * a.Sq * a.H;
  constexpr int kWarps = 8;
  bwd_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, rows, a.Sq, a.H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T, int HD>
int launch_tc(const Args& a) {
  int err = launch_delta<T>(a, HD);
  if (err) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  constexpr int kDkDv = DkDvSmem<HD>::kBytes;
  if ((err = opt_in(bwd_dkdv_tc_kernel<T, HD>, kDkDv))) return err;
  bwd_dkdv_tc_kernel<T, HD><<<dim3(a.B * a.Hkv, (a.Sk + kKeyTile - 1) / kKeyTile), kTcThreads,
                              kDkDv, a.stream>>>(q, k, v, dout, a.lse, a.delta,
                                                 static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                 a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  constexpr int kDq = DqSmem<HD>::kBytes;
  if ((err = opt_in(bwd_dq_tc_kernel<T, HD>, kDq))) return err;
  bwd_dq_tc_kernel<T, HD><<<dim3(a.B * a.H, (a.Sq + kQTile - 1) / kQTile), kTcThreads, kDq,
                            a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq),
                                        a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_simt(const Args& a) {
  int err = launch_delta<float>(a, HD);
  if (err) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  constexpr int kDkDv = simt_dkdv_smem<HD>();
  if ((err = opt_in(bwd_dkdv_simt_kernel<HD>, kDkDv))) return err;
  bwd_dkdv_simt_kernel<HD><<<dim3(a.B * a.Hkv, (a.Sk + kSimtTile - 1) / kSimtTile),
                             kSimtThreads, kDkDv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq,
      a.Sk, a.H, a.Hkv, a.scale, a.causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  constexpr int kDq = simt_dq_smem<HD>();
  if ((err = opt_in(bwd_dq_simt_kernel<HD>, kDq))) return err;
  bwd_dq_simt_kernel<HD><<<dim3(a.B * a.H, (a.Sq + kSimtTile - 1) / kSimtTile), kSimtThreads,
                           kDq, a.stream>>>(q, k, v, dout, a.lse, a.delta,
                                            static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv,
                                            a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Args& a, int hd, int hdv) {
  return a.B >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 && hd == hdv &&
         (hd == 64 || hd == 128) && (!a.causal || a.Sq == a.Sk) &&
         (a.Sq + kQTile - 1) / kQTile <= 65535 && (a.Sk + kKeyTile - 1) / kKeyTile <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int Sq, int Sk,
               int H, int Hkv, int causal, float scale, void* stream) {
  return Args{q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
              static_cast<float*>(delta), B, Sq, Sk, H, Hkv, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, Hkv, hd), out and dout: (B, Sq, H, hd),
// contiguous, in one type; lse: f32 (B, H, Sq), K5's; dq, dk, dv: like q, k,
// v; delta: f32 (B, H, Sq) scratch.  hd in {64, 128}, causal only with Sq ==
// Sk.  Three launches on `stream`: D, dK/dV, dQ.
// The f32 route on the CUDA cores (dtype 0 only):
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta, int B,
                                          int Sq, int Sk, int H, int Hkv, int hd, int hdv,
                                          int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hkv, causal,
                           scale, stream);
  if (!valid(a, hd, hdv) || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return hd == 64 ? launch_simt<64>(a) : launch_simt<128>(a);
}

// The tensor-core route (dtype 1 = bfloat16, 2 = float16; q, k, v, out,
// dout 16-byte aligned):
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             void* dq, void* dk, void* dv, void* delta, int B,
                                             int Sq, int Sk, int H, int Hkv, int hd, int hdv,
                                             int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hkv, causal,
                           scale, stream);
  if (!valid(a, hd, hdv)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 1:
      return hd == 64 ? launch_tc<__nv_bfloat16, 64>(a) : launch_tc<__nv_bfloat16, 128>(a);
    case 2:
      return hd == 64 ? launch_tc<__half, 64>(a) : launch_tc<__half, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
