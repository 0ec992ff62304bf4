// Decode attention for Hopper (sm_90a): K3's SIMT route, for f32 and for
// the head layouts the tensor-core route (decode_attention_tc.cu) does not
// take; kernels/decode_attention/kernel.py::route picks before the launch.
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention_pallas:
// attention for one new token per row over a KV cache, the g = H / Hkv
// query heads of a kv head sharing each K/V tile, positions >= length[b]
// masked with NEG = -1e30, an online softmax in f32, and acc / max(l, 1e-30)
// written in q's dtype.  As in the TPU kernel, a row of length 0 masks
// every position, so each gets weight exp(NEG - NEG) = 1 and the output is
// the mean of V over all S positions.
//
// Bound on this card: bytes.  Each step must read the K and V of the valid
// positions once (bf16, 2 x 512 bytes per position at Hkv = 2, hd = 128);
// the arithmetic is ~4 flops per K/V element.  The TPU kernel walks S in
// sequential grid steps on one core; here the work is split three ways
// into independent blocks:
//   * block (split, kv head, row): grid.z = row, grid.y = kv head, and
//     grid.x cuts the row's own valid length into `splits` contiguous
//     ranges, so B * Hkv * splits blocks keep the 132 SMs busy at small
//     batch, and short rows do not pay for the cache's full S;
//   * each block stages a 32-position K tile in shared memory (16-byte
//     loads where the layout allows), computes the g x 32 scores, runs one
//     warp per head for the online softmax, then stages V and updates the
//     f32 accumulator; the 32 positions of a tile map one-to-one to the
//     lanes of the softmax warp;
//   * a second, small kernel merges the splits' (m, l, acc) partials.
// It takes any S: the ragged last tile is masked in the kernel, so no
// S % 256 gate is needed.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;        // positions per tile = lanes per warp
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

// positions [t0, t0 + kTile) of one kv head -> dst[p * (hd + 1) + d] in f32,
// zeros past `end`; the +1 row padding keeps the score loop's lanes (one
// position each) on distinct shared-memory banks
template <typename T>
__device__ void load_tile(float* dst, const T* src, size_t pos_stride, int t0,
                          int end, int hd, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = hd / V;
    for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
      const int p = e / per_row;
      const int c = e - p * per_row;
      const int pos = t0 + p;
      float* o = dst + p * (hd + 1) + c * V;
      if (pos < end) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(pos) * pos_stride + c * V);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = to_float(vals[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * hd; e += kThreads) {
      const int p = e / hd;
      const int d = e - p * hd;
      const int pos = t0 + p;
      dst[p * (hd + 1) + d] =
          pos < end ? to_float(src[static_cast<size_t>(pos) * pos_stride + d]) : 0.f;
    }
  }
}

template <typename T>
__global__ void decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int32_t* __restrict__ length,
                                    float* __restrict__ m_part, float* __restrict__ l_part,
                                    float* __restrict__ acc_part, int S, int H, int Hkv,
                                    int hd, float scale, bool vec) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                          // g * hd
  float* acc_s = q_s + g * hd;                // g * hd
  float* kv_s = acc_s + g * hd;               // kTile * (hd + 1)
  float* p_s = kv_s + kTile * (hd + 1);       // g * kTile
  float* m_s = p_s + g * kTile;               // g
  float* l_s = m_s + g;                       // g
  float* alpha_s = l_s + g;                   // g

  const int len = length[b];
  const bool all_masked = len <= 0;
  const int eff = all_masked ? S : min(len, S);
  // this block's share of the row's own valid range, in whole tiles
  const int per = ((eff + splits - 1) / splits + kTile - 1) / kTile * kTile;
  const int start = split * per;
  const int end = min(start + per, eff);

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * hd;
  for (int e = tid; e < g * hd; e += kThreads) {
    q_s[e] = to_float(qb[e]);
    acc_s[e] = 0.f;
  }
  for (int h = tid; h < g; h += kThreads) {
    m_s[h] = kNeg;
    l_s[h] = 0.f;
  }
  const size_t pos_stride = static_cast<size_t>(Hkv) * hd;
  const size_t row_off = static_cast<size_t>(b) * S * pos_stride + static_cast<size_t>(kh) * hd;
  const T* kb = k + row_off;
  const T* vb = v + row_off;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += kTile) {
    load_tile(kv_s, kb, pos_stride, t0, end, hd, vec);
    __syncthreads();
    for (int e = tid; e < g * kTile; e += kThreads) {
      const int h = e / kTile;
      const int p = e - h * kTile;
      float s;
      if (t0 + p >= end) {
        s = -INFINITY;                       // not this block's position
      } else if (all_masked) {
        s = kNeg;
      } else {
        const float* qh = q_s + h * hd;
        const float* kp = kv_s + p * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qh[d], kp[d], dot);
        s = dot * scale;
      }
      p_s[h * kTile + p] = s;
    }
    __syncthreads();
    for (int h = warp; h < g; h += kThreads / 32) {
      const float s = p_s[h * kTile + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[h * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    load_tile(kv_s, vb, pos_stride, t0, end, hd, vec);
    __syncthreads();
    for (int e = tid; e < g * hd; e += kThreads) {
      const int h = e / hd;
      const int d = e - h * hd;
      const float* ph = p_s + h * kTile;
      float a = acc_s[e] * alpha_s[h];
#pragma unroll 8
      for (int p = 0; p < kTile; ++p) a = fmaf(ph[p], kv_s[p * (hd + 1) + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  const size_t part = (static_cast<size_t>(b) * Hkv + kh) * splits + split;
  for (int e = tid; e < g * hd; e += kThreads) acc_part[part * g * hd + e] = acc_s[e];
  for (int h = tid; h < g; h += kThreads) {
    m_part[part * g + h] = m_s[h];
    l_part[part * g + h] = l_s[h];
  }
}

// one block per (query head, row): merge the splits' partial softmax states
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      T* __restrict__ out, int H, int Hkv, int hd,
                                      int splits) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int kh = hq / g;
  const int h = hq - kh * g;
  const size_t base = (static_cast<size_t>(b) * Hkv + kh) * splits;
  float m_max = kNeg;
  for (int s = 0; s < splits; ++s) m_max = fmaxf(m_max, m_part[(base + s) * g + h]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    l += l_part[(base + s) * g + h] * expf(m_part[(base + s) * g + h] - m_max);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t ps = (base + s) * g + h;
      a += acc_part[ps * hd + d] * expf(m_part[ps] - m_max);
    }
    out[(static_cast<size_t>(b) * H + hq) * hd + d] = from_float<T>(a * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length, void* out,
           void* m_part, void* l_part, void* acc_part, int B, int S, int H, int Hkv,
           int hd, int splits, bool vec, float scale, cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem =
      sizeof(float) * (2 * g * hd + kTile * (hd + 1) + g * kTile + 3 * g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_split_kernel<T><<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(length), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), S, H, Hkv, hd, scale,
      vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = hd < 1024 ? ((hd + 31) / 32) * 32 : 1024;
  decode_combine_kernel<T><<<dim3(H, B), threads, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), H, Hkv, hd, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, caches and out alike)
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* length, void* out, void* m_part,
                                       void* l_part, void* acc_part, int B, int S, int H,
                                       int Hkv, int hd, int splits, int dtype, int vec,
                                       float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, length, out, m_part, l_part, acc_part, B, S, H, Hkv,
                           hd, splits, vec != 0, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, length, out, m_part, l_part, acc_part, B, S,
                                   H, Hkv, hd, splits, vec != 0, scale, st);
    case 2:
      return launch<__half>(q, k, v, length, out, m_part, l_part, acc_part, B, S, H, Hkv,
                            hd, splits, vec != 0, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
