// Decode attention on Hopper's tensor cores (sm_90a): K3's route for bf16
// and fp16 at hd % 16 == 0 (hd <= 128) and g = H / Hkv <= 16.  (f32, and
// any other head layout, take the SIMT kernels of decode_attention.cu.)
//
// Replaces repro/kernels/decode_attention/kernel.py::decode_attention_pallas
// (body _decode_kernel) and computes what decode_attention.cu computes: one
// new token per row attends over its KV cache up to its own length, the g
// query heads of a kv head sharing each K/V tile; positions >= length[b]
// masked with NEG = -1e30; an online softmax in f32; p kept at f32
// precision for p . v; acc / max(l, 1e-30) written in q's dtype.  A row of
// length 0 masks every position, so each weighs exp(NEG - NEG) = 1 and the
// output is the mean of V over all S positions.
//
// Bound on this card: bytes.  A call must read the K and V of the valid
// positions once (512 bytes a position and kv head at hd 128, bf16) and
// does ~6 flops per K/V element.  A grid fixed at ~2 blocks an SM makes the
// tiles each block walks grow with B; a tile loaded through registers into
// f32 shared memory, with nothing in flight behind it, serializes every
// tile; a separate combine kernel costs a second launch a call (PERF.md,
// section 6, measures each on decode_attention.cu).  The design:
//   * the grid grows with the work: block (chunk, kv head, row) owns C
//     positions of the row (C from the wrapper, a multiple of 64), and a
//     block whose chunk starts past the row's length exits at once;
//   * each of a block's 4 warps walks its own 16-position tiles of the
//     chunk (tiles w, w + 4, ...) through a private ring of kStages
//     stages in shared memory, kept in the cache's 16-bit type: cp.async,
//     16 bytes a lane, L2 only (.cg), zero-filled past the chunk's end, so
//     the next tiles are in flight while one is computed.  A warp only
//     waits on its own copies (cp.async.wait_group + __syncwarp): no block
//     barrier in the loop.  Rows are padded by 16 bytes, which keeps the
//     ldmatrix reads of 8 rows on distinct banks at any hd % 16 == 0;
//   * q k^T and p . v on mma.sync m16n8k16 (f32 accumulators).  The g
//     query heads are the 16 rows of the A operand (rows >= g are zero);
//     K comes through ldmatrix, V through ldmatrix.trans.  Products of two
//     16-bit values are exact in f32, so the scores are the TPU kernel's
//     upcast dot up to the order of the sum.  The score accumulator has
//     the register layout of p . v's A operand, so p never passes through
//     shared memory.  p is split into p_hi = T(p) and p_lo = T(p - p_hi),
//     and two MMAs add p_hi v and p_lo v into one accumulator: p keeps
//     about 2^-16 (bf16), as in flash_attention_tc.cu.  l sums the f32 p;
//   * one launch: the 4 warps' (m, l, acc) merge in shared memory; a row
//     with one chunk writes its output there.  Otherwise each block writes
//     its partial to scratch, and the last block of the (row, kv head) to
//     arrive (__threadfence, then atomicAdd on a per-(row, kv head) counter,
//     which that block sets back to 0 for the next call) merges them.
// Scores are kept in log2 units (scaled by log2(e) / sqrt(hd)) and the
// exponentials are exp2f.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;            // positions per warp tile: p . v's k
constexpr int kStages = 3;           // each warp's ring of K/V tiles
constexpr int kPadBytes = 16;        // per shared-memory row
constexpr float kNeg = -1e30f;       // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  static constexpr int kRowBytes = HD * 2 + kPadBytes;
  static constexpr int kTileBytes = kRows * kRowBytes;          // K or V
  static constexpr int kWarpBytes = kStages * 2 * kTileBytes;   // K and V
  static constexpr int kRingBytes = kWarps * kWarpBytes;
  static constexpr int kMergeBytes = kWarps * kRows * HD * 4;
  static constexpr int kSmem = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kChunks16 = HD / 8;                       // 16-byte chunks a row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b on m16n8k16, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two 16-bit values (x in the low half), and
// the part of each that the rounding lost, in the same form
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo);

template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x, float y, uint32_t& hi,
                                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <>
__device__ __forceinline__ void split2<__half>(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const __half2 l = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ length, T* __restrict__ out,
                 float* __restrict__ partials, unsigned* __restrict__ counters, int S,
                 int H, int Hkv, int chunk, float scale_log2) {
  using Sh = Shape<HD>;
  constexpr int NT = HD / 8;       // n-tiles of p . v (8 columns of hd each)
  constexpr int KS = HD / 16;      // k-steps of q k^T
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];
  __shared__ int last_s;

  const int c = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int len = length[b];
  const bool all_masked = len <= 0;
  const int eff = all_masked ? S : min(len, S);
  const int start = c * chunk;
  if (start >= eff) return;                    // past the row's own length
  const int end = min(start + chunk, eff);
  const int n_live = (eff + chunk - 1) / chunk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;                   // accumulator rows gid, gid + 8
  const int t4 = lane & 3;

  // q's rows as the A operand of q k^T, rows >= g zero
  uint32_t qa[KS][4];
  {
    const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * HD;
    const bool r0 = gid < g, r1 = gid + 8 < g;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = kk * 16 + 2 * t4;
      qa[kk][0] = r0 ? *reinterpret_cast<const uint32_t*>(qb + gid * HD + col) : 0u;
      qa[kk][1] = r1 ? *reinterpret_cast<const uint32_t*>(qb + (gid + 8) * HD + col) : 0u;
      qa[kk][2] = r0 ? *reinterpret_cast<const uint32_t*>(qb + gid * HD + col + 8) : 0u;
      qa[kk][3] = r1 ? *reinterpret_cast<const uint32_t*>(qb + (gid + 8) * HD + col + 8) : 0u;
    }
  }

  const size_t pos_stride = static_cast<size_t>(Hkv) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * pos_stride + static_cast<size_t>(kh) * HD;
  const T* vb = v + static_cast<size_t>(b) * S * pos_stride + static_cast<size_t>(kh) * HD;
  const uint32_t ring = smem_u32(smem) + warp * Sh::kWarpBytes;
  // this warp's tiles: positions tile0 + 64 i, i < n_tiles
  const int tile0 = start + warp * kRows;
  const int n_tiles = tile0 < end ? (end - tile0 + kWarps * kRows - 1) / (kWarps * kRows) : 0;

  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int p0 = tile0 + i * kWarps * kRows;
      const uint32_t kdst = ring + (i % kStages) * 2 * Sh::kTileBytes;
      const uint32_t vdst = kdst + Sh::kTileBytes;
#pragma unroll
      for (int it = 0; it < kRows * Sh::kChunks16 / 32; ++it) {   // 2 hd / 32
        const int e = lane + 32 * it;
        const int r = e / Sh::kChunks16;
        const int cc = e - r * Sh::kChunks16;
        const bool valid = p0 + r < end;
        const size_t off = static_cast<size_t>(valid ? p0 + r : p0) * pos_stride + cc * 8;
        const uint32_t so = r * Sh::kRowBytes + cc * 16;
        cp_async16(kdst + so, kb + off, valid);
        cp_async16(vdst + so, vb + off, valid);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m_r[2] = {kNeg, kNeg};                 // rows gid, gid + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};                   // this lane's share of the row sums

  // ldmatrix addresses, relative to a tile: lane -> (matrix mi, row r8)
  const int mi = lane >> 3, r8 = lane & 7;
  const uint32_t k_lane = ((mi >> 1) * 8 + r8) * Sh::kRowBytes + (mi & 1) * 16;
  const uint32_t v_lane = ((mi & 1) * 8 + r8) * Sh::kRowBytes + (mi >> 1) * 16;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t kt = ring + (i % kStages) * 2 * Sh::kTileBytes;
    const uint32_t vt = kt + Sh::kTileBytes;
    const int p0 = tile0 + i * kWarps * kRows;

    // scores of 16 positions: s[j] holds positions 8 j + 2 t4 + {0, 1} of
    // rows gid (s[j][0..1]) and gid + 8 (s[j][2..3])
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, kt + k_lane + kk * 32);
      mma16816<T>(s[0], qa[kk], kf[0], kf[1]);
      mma16816<T>(s[1], qa[kk], kf[2], kf[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + 8 * j + 2 * t4 + (e & 1);
        const float x = pos >= end ? -INFINITY : all_masked ? kNeg : s[j][e] * scale_log2;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // p as the A operand of p . v (k = the tile's 16 positions), hi and lo
    uint32_t ph[4], pl[4];
    split2<T>(s[0][0], s[0][1], ph[0], pl[0]);
    split2<T>(s[0][2], s[0][3], ph[1], pl[1]);
    split2<T>(s[1][0], s[1][1], ph[2], pl[2]);
    split2<T>(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vt + v_lane + nt * 16);
      mma16816<T>(acc[nt], ph, vf[0], vf[1]);
      mma16816<T>(acc[nt], pl, vf[0], vf[1]);
      mma16816<T>(acc[nt + 1], ph, vf[2], vf[3]);
      mma16816<T>(acc[nt + 1], pl, vf[2], vf[3]);
    }
    __syncwarp();                              // the stage may be refilled
  }
  cp_async_wait<0>();

  // the 4 warps' states -> shared memory (the ring is free after the barrier)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();
  float* mb = reinterpret_cast<float*>(smem) + warp * kRows * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r;
    if (row >= g) continue;
    if (t4 == 0) {
      m_s[warp][row] = m_r[r];
      l_s[warp][row] = l_r[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(mb + row * HD + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
  __syncthreads();

  // merge them: each thread owns 4 consecutive columns of one row at a time
  const size_t bk = static_cast<size_t>(b) * Hkv + kh;
  const size_t n_part = static_cast<size_t>(gridDim.z) * Hkv * gridDim.x;
  const size_t part = bk * gridDim.x + c;
  float* acc_part = partials;                                // (parts, g, HD)
  float* m_part = partials + n_part * g * HD;                // (parts, g)
  float* l_part = m_part + n_part * g;
  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g) * HD;
  const float* ms = &m_s[0][0];
  for (int e = tid * 4; e < g * HD; e += kThreads * 4) {
    const int row = e / HD;
    float m_max = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_max = fmaxf(m_max, ms[w * kRows + row]);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(ms[w * kRows + row] - m_max);
      const float4 x = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(smem) + (w * kRows) * HD + e);
      l += l_s[w][row] * wt;
      a.x += x.x * wt;
      a.y += x.y * wt;
      a.z += x.z * wt;
      a.w += x.w * wt;
    }
    if (n_live == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      ob[e] = from_float<T>(a.x * inv);
      ob[e + 1] = from_float<T>(a.y * inv);
      ob[e + 2] = from_float<T>(a.z * inv);
      ob[e + 3] = from_float<T>(a.w * inv);
    } else {
      *reinterpret_cast<float4*>(acc_part + part * g * HD + e) = a;
      if (e % HD == 0) {
        m_part[part * g + row] = m_max;
        l_part[part * g + row] = l;
      }
    }
  }
  if (n_live == 1) return;

  // the last block of this (row, kv head) to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned prev = atomicAdd(counters + bk, 1u);
    last_s = prev == static_cast<unsigned>(n_live - 1);
    if (last_s) counters[bk] = 0u;            // every block has arrived
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t first = bk * gridDim.x;
  for (int e = tid * 4; e < g * HD; e += kThreads * 4) {
    const int row = e / HD;
    float m_max = kNeg;
    for (int cc = 0; cc < n_live; ++cc)
      m_max = fmaxf(m_max, __ldcg(m_part + (first + cc) * g + row));
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cc = 0; cc < n_live; ++cc) {
      const size_t p = first + cc;
      const float wt = exp2f(__ldcg(m_part + p * g + row) - m_max);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(acc_part + p * g * HD + e));
      l += __ldcg(l_part + p * g + row) * wt;
      a.x += x.x * wt;
      a.y += x.y * wt;
      a.z += x.z * wt;
      a.w += x.w * wt;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    ob[e] = from_float<T>(a.x * inv);
    ob[e + 1] = from_float<T>(a.y * inv);
    ob[e + 2] = from_float<T>(a.z * inv);
    ob[e + 3] = from_float<T>(a.w * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* length, void* out,
           void* partials, void* counters, int B, int S, int H, int Hkv, int chunk,
           float scale, cudaStream_t stream) {
  constexpr int smem = Shape<HD>::kSmem;
  static uint64_t configured = 0;     // one attribute call per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !(configured >> device & 1u)) {
    err = cudaFuncSetAttribute(decode_tc_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) configured |= uint64_t{1} << device;
  }
  const int chunks = (S + chunk - 1) / chunk;
  decode_tc_kernel<T, HD><<<dim3(chunks, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(length), static_cast<T*>(out),
      static_cast<float*>(partials), static_cast<unsigned*>(counters), S, H, Hkv, chunk,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* length, void* out,
              void* partials, void* counters, int B, int S, int H, int Hkv, int hd,
              int chunk, float scale, cudaStream_t st) {
#define K3_HD(N)                                                                         \
  case N:                                                                                \
    return launch<T, N>(q, k, v, length, out, partials, counters, B, S, H, Hkv, chunk, \
                        scale, st);
  switch (hd) {
    K3_HD(16)
    K3_HD(32)
    K3_HD(48)
    K3_HD(64)
    K3_HD(80)
    K3_HD(96)
    K3_HD(112)
    K3_HD(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_HD
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (q, caches and out alike).  partials:
// B * Hkv * ceil(S / chunk) * g * (hd + 2) floats; counters: B * Hkv
// unsigned words, 0 before the first call (each call leaves them at 0).
extern "C" int decode_attention_tc_launch(const void* q, const void* k, const void* v,
                                          const void* length, void* out, void* partials,
                                          void* counters, int B, int S, int H, int Hkv,
                                          int hd, int chunk, int dtype, float scale,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || chunk % kRows || H % Hkv || H / Hkv > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, length, out, partials, counters, B, S, H,
                                      Hkv, hd, chunk, scale, st);
    case 2:
      return launch_hd<__half>(q, k, v, length, out, partials, counters, B, S, H, Hkv, hd,
                               chunk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
