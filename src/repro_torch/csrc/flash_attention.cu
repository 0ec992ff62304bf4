// Flash attention (forward) for Hopper (sm_90a): K5.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel): softmax(q k^T / sqrt(dqk)) v per query head, causal
// or not, with GQA (query head h reads kv head h / g) and an online
// softmax over kv tiles in f32.  As in the TPU kernel, q, k and v are
// upcast to f32 and the probabilities p stay in f32 for p . v; masked
// scores are -1e30 with the top-left-aligned causal mask (qpos >= kpos);
// the output is acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: at qwen2.5-3b's whole-prompt admit (B 1, S 1024,
// H 16, Hkv 2, hd 128, bf16, causal) the work is 4.29 GFLOP (4.3 us at
// the tensor cores' 989 TFLOP/s) against 9.4 MB (2.8 us), so operations
// bind.  This kernel runs on the f32 CUDA cores (67 TFLOP/s, so >= 64 us)
// and is K5's route for f32 inputs and for hd in {16, 32}: repro's f32
// tolerance of 2e-5 is beyond TF32 or split-bf16 products.  bf16 and fp16
// at hd 64, 112 and 128, and at MLA's (192, 128), take the tensor-core
// kernel (flash_attention_tc.cu, wgmma with p split into two 16-bit parts).
// The kernel is templated on the q . k width HDQK and the v width HDV,
// equal but for MLA's prefill (q and k at 192, v at 128), so k and v
// rows have strides of their own.  The design:
//   * one block of 256 threads per (query tile of 64 rows, batch x head);
//     the TPU kernel's sequential kv grid axis becomes a loop over kv
//     tiles of 64 positions inside the block;
//   * the q tile, and each K and V tile, sit in shared memory as f32
//     (rows padded by one float, so the 16 key rows a warp reads at once
//     fall on distinct banks); the 64 x 64 score tile lives in registers
//     (4 x 4 per thread) and, as p, in shared memory, never in device
//     memory; m, l and the 64 x HDV accumulator stay in f32 registers;
//   * row max and row sum reduce over the 16 lanes that share a row with
//     __shfl_xor_sync;
//   * causal: kv tiles wholly above the diagonal are skipped, and the
//     blocks of the heaviest query tiles are scheduled first (grid.y is
//     the reversed query-tile index, grid.x the batch x head);
//   * ragged Sq and Sk: rows past Sq are computed and never stored, key
//     positions past Sk score -inf (weight exactly 0), so any length
//     works (the TPU kernel needs Sq, Sk % 128 == 0).
// Shared memory: 4 * (2 * 64 * (HDQK + 1) + 64 * HDV + 64 * 65) bytes, 115.5
// KB at hd = 128 and 144.8 KB at (192, 128), above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key positions per tile
constexpr int kThreads = 256;    // 16 x 16: (ty, tx)
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

constexpr size_t smem_bytes(int hdqk, int hdv) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (hdqk + 1) + static_cast<size_t>(kBK) * (hdqk + 1) +
          static_cast<size_t>(kBK) * hdv + static_cast<size_t>(kBQ) * (kBK + 1));
}

// rows [p0, p0 + rows) of one head of a (B, S, heads, HD) tensor -> dst[r * ld + d]
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int p0,
                                          int rows, int S, size_t pos_stride) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int pos = p0 + r;
    dst[r * ld + d] = pos < S ? to_float(src[static_cast<size_t>(pos) * pos_stride + d]) : 0.f;
  }
}

// NJ = HDV / 16 output columns per thread
template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Sk, int H, int Hkv, float scale, int causal) {
  constexpr int NJ = HDV / 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float smem[];
  float* q_s = smem;                           // kBQ x (HDQK + 1)
  float* k_s = q_s + kBQ * (HDQK + 1);         // kBK x (HDQK + 1)
  float* v_s = k_s + kBK * (HDQK + 1);         // kBK x HDV
  float* p_s = v_s + kBK * HDV;                // kBQ x (kBK + 1)

  const size_t q_stride = static_cast<size_t>(H) * HDQK;
  const size_t k_stride = static_cast<size_t>(Hkv) * HDQK;
  const size_t v_stride = static_cast<size_t>(Hkv) * HDV;
  const size_t o_stride = static_cast<size_t>(H) * HDV;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HDQK;
  const T* kb = k + static_cast<size_t>(b) * Sk * k_stride + static_cast<size_t>(kh) * HDQK;
  const T* vb = v + static_cast<size_t>(b) * Sk * v_stride + static_cast<size_t>(kh) * HDV;
  load_rows<T, HDQK>(q_s, HDQK + 1, qb, q0, kBQ, Sq, q_stride);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Sq) - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                           // previous tile's reads are done
    load_rows<T, HDQK>(k_s, HDQK + 1, kb, k0, kBK, Sk, k_stride);
    load_rows<T, HDV>(v_s, HDV, vb, k0, kBK, Sk, v_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDQK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * (HDQK + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * (HDQK + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sc = s[i][j] * scale;
        if (kpos >= Sk) sc = -INFINITY;
        else if (causal && qpos < kpos) sc = kNeg;
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[kk * HDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * Sq + qpos) * o_stride + static_cast<size_t>(h) * HDV;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int HDQK, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(HDQK, HDV);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HDQK, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_kernel<T, HDQK, HDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
              int H, int Hkv, int hd, int hdv, float scale, int causal, cudaStream_t stream) {
  if (hd == 192 && hdv == 128)  // MLA: q . k over 128 nope + 64 rope columns
    return launch<T, 192, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<T, 16, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
    case 32: return launch<T, 32, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
    case 64: return launch<T, 64, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
    case 112:
      return launch<T, 112, 112>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
    case 128:
      return launch<T, 128, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out alike);
// q: (B, Sq, H, hd), k: (B, Sk, Hkv, hd), v: (B, Sk, Hkv, hdv), out: (B, Sq,
// H, hdv), contiguous; hdv == hd in {16, 32, 64, 112, 128}, or (hd, hdv) =
// (192, 128)
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int Hkv, int hd, int hdv,
                                      int causal, int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal, st);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal,
                                      st);
    case 2:
      return launch_hd<__half>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
