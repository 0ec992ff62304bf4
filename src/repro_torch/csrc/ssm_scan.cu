// S6 selective scan for Hopper (sm_90a): K6.
//
// Replaces repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas, the Mamba-1
// hot loop:
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t      (Din x N state)
//     y_t = h_t . C_t + D * x_t
// with x, dt: (Bb, L, Din), B, C: (Bb, L, N), A: (Din, N), D: (Din,),
// h0 and h_last: (Bb, Din, N) f32, y in x's dtype.  As in the TPU kernel
// the state never goes to device memory: only y and h_last are written.
//
// Bound on this card: at the path's shape (Bb 1, L 1024, Din 8192, N 16)
// the bytes that must move (x and y in bf16, dt in f32, ~69 MB) take
// ~20 us at 3.35 TB/s; the 1.34e8 exponentials take ~32 us at the SFU's
// 16 a clock per SM, and the ~7 f32 operations per (position, channel,
// state) ~14 us at 67 TFLOP/s.  So the kernel's floor is the SFU, and the
// design spends one MUFU.EX2 per (position, channel, state) and little
// else:
//   * a thread owns one channel and a segment of kItems consecutive
//     positions of a tile, and loops over the channel's states in the
//     thread: y accumulates in registers with no shuffles, and x, dt and
//     dt * x are read once per (position, channel);
//   * parallelism along L: for each state, each thread folds its segment
//     into the pair (prod of decays, h from 0; the product is one more
//     exponential, of A log2(e) times the segment's sum of dt, so the fold
//     costs no multiply a position for it), and the kSegs segments of
//     a channel, which are lanes of one warp, join by an inclusive scan
//     of the pairs, (a2 a1, a2 b1 + b2), with width-kSegs shuffles.  The
//     first segment starts from the state carried from the previous tile
//     (h0 for the first), so each segment's scanned pair is its end state;
//     the segment before gives each thread its start state, and the last
//     segment's end is the carry into the next tile (h_last after the
//     last).  The thread then walks its kItems positions again from its
//     start state, with the decays it kept in registers, to form y.
//     Positions past L are the identity pair (decay 1, input 0);
//   * the states are taken kStateGroup at a time, each of the three steps
//     (fold, scan, walk) over the whole group, so that their latency chains
//     can overlap in one thread.  One state at a time measured fastest:
//     more spill the 128 registers that two resident blocks leave;
//   * a block owns kChannels consecutive channels of one batch row, so the
//     tiles of x, dt and y are rows of kChannels consecutive values.  The
//     next tile's x, dt, B and C rows are copied into the other half of a
//     double buffer by cp.async while the block computes this one (plain
//     loads where a row is not 16-byte aligned); y goes out through shared
//     memory, row by row.  Each tile's B and C are laid out again by state, so a thread
//     reads its segment's kItems values as float4s; padding after each
//     segment keeps the reads free of bank conflicts;
//   * one exponential per (position, channel, state) on the SFU:
//     2^(dt * A log2(e)) by ex2.approx, with A log2(e) formed once per
//     (channel, state).
// The scan reorders the f32 sums and ex2.approx is not expf, so h differs
// from the plain version's sequential recurrence in the last bits (within
// repro's 1e-4).  It takes any Bb <= 65535, L >= 1, Din >= 1 (the ragged
// last block is masked) and 1 <= N <= 32, with or without h0.
// Measured at the path's shape (chip_kernel_steps.py k6): the maths alone
// (no loads after the first tile) take ~90% of the kernel's time at ~2.6x
// the SFU's floor, and neither the exponentials, the scan nor the h chain
// alone moves it: with two blocks of 256 threads an SM (126 registers a
// thread) the issue slots go unused behind each state's dependent chain.
// The loads and stores alone take ~40%; the double buffer hides most of
// them (one stage is ~3% slower).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 16;                     // positions a thread owns a tile
constexpr int kSegs = 8;                       // segments of a channel: lanes
constexpr int kChannels = 32;                  // channels a block
constexpr int kThreads = kChannels * kSegs;    // 256
constexpr int kTile = kSegs * kItems;          // positions a tile
constexpr int kStateGroup = 1;                 // states interleaved
constexpr int kMinBlocks = 2;                  // resident blocks an SM asked for
constexpr int kStages = 2;                     // tiles in shared memory: 2 overlap
constexpr int kMaxState = 32;
constexpr int kPad = 32 / kSegs;               // y tile: words after a segment
constexpr int kRowPad = 4;                     // B, C tiles: words a segment
constexpr int kTileWords = kTile * kChannels + kSegs * kPad;
constexpr int kRowWords = kTile + kSegs * kRowPad + 4;   // + 4: states apart in banks
constexpr float kLog2e = 1.4426950408889634f;
static_assert(32 % kSegs == 0 && kItems % 4 == 0, "lanes and float4 reads");

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

__device__ __forceinline__ float decay(float x) {   // 2^x: one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the y tile: position t, channel c of the block
__device__ __forceinline__ int tile_at(int t, int c) {
  return t * kChannels + c + (t / kItems) * kPad;
}

// B and C tiles: state n, position t
__device__ __forceinline__ int row_at(int n, int t) {
  return n * kRowWords + t + (t / kItems) * kRowPad;
}

inline int padded_states(int n) {
  return (n + kStateGroup - 1) / kStateGroup * kStateGroup;
}

// A stage of the double buffer holds a tile as it arrives: x and dt rows
// of kChannels values (16 bytes of padding after each segment's kItems
// rows), and the B and C rows (kTile x N, as in device memory).
template <typename T>
struct Stage {
  static constexpr int kXRow = kChannels * sizeof(T);
  static constexpr int kXBytes = kTile * kXRow + kSegs * 16;
  static constexpr int kDtBytes = kTile * kChannels * 4 + kSegs * 16;
  static __host__ __device__ int bytes(int n) {
    return kXBytes + kDtBytes + 2 * kTile * n * static_cast<int>(sizeof(T));
  }
};

__device__ __forceinline__ int raw_at(int t, int row_bytes) {   // bytes
  return t * row_bytes + (t / kItems) * 16;
}

// kStages stages; then f32: B, C tiles by state, A log2(e) and the carried
// state per (state, channel), the y tile
template <typename T>
inline size_t smem_bytes(int n) {
  const int np = padded_states(n);
  return kStages * static_cast<size_t>(Stage<T>::bytes(n)) +
         sizeof(float) * (2 * static_cast<size_t>(np) * kRowWords + 2 * np * kChannels +
                          kTileWords);
}

// 16 bytes from device memory into shared memory, the last 16 - bytes of
// them zero (cp.async.cg: bypasses L1, lands while the block computes)
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ A, const T* __restrict__ D,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_last, int L, int Din, int N, int npad,
                    bool async) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = Stage<T>::bytes(N);
  float* b_s = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* c_s = b_s + npad * kRowWords;
  float* a_s = c_s + npad * kRowWords;     // A log2(e), [npad][kChannels]
  float* h_s = a_s + npad * kChannels;     // carried state, [npad][kChannels]
  float* y_s = h_s + npad * kChannels;     // y tile, as tile_at

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ch = (tid >> 5) * (32 / kSegs) + lane / kSegs;   // channel in block
  const int seg = lane % kSegs;
  const size_t row = static_cast<size_t>(b) * L;
  const int live = min(kChannels, Din - c0);                 // channels here

  for (int e = tid; e < kChannels * npad; e += kThreads) {
    const int cc = e / npad;
    const int n = e - cc * npad;
    const bool ok = n < N && cc < live;
    const size_t at = (static_cast<size_t>(b) * Din + c0 + cc) * N + n;
    a_s[n * kChannels + cc] =
        ok ? __fmul_rn(A[static_cast<size_t>(c0 + cc) * N + n], kLog2e) : 0.f;
    h_s[n * kChannels + cc] = (ok && h0 != nullptr) ? h0[at] : 0.f;
  }
  const float d = ch < live ? to_float(D[c0 + ch]) : 0.f;

  // the tile at t0 into stage st: by cp.async where every row is 16-byte
  // aligned (the launcher checks), else by plain loads; 0 past L and Din
  auto fetch = [&](int t0, int st) {
    unsigned char* xr = smem + st * stage_bytes;
    unsigned char* dr = xr + Stage<T>::kXBytes;
    unsigned char* br = dr + Stage<T>::kDtBytes;
    unsigned char* cr = br + kTile * N * sizeof(T);
    const int rows = min(kTile, L - t0);
    if (async) {
      constexpr int kXChunks = Stage<T>::kXRow / 16;
      for (int e = tid; e < kTile * kXChunks; e += kThreads) {
        const int t = e / kXChunks;
        const int j = e - t * kXChunks;
        const int bytes = t < rows ? max(0, min(16, live * int(sizeof(T)) - 16 * j)) : 0;
        copy16(xr + raw_at(t, Stage<T>::kXRow) + 16 * j,
               bytes ? x + (row + t0 + t) * Din + c0 + j * (16 / sizeof(T)) : x, bytes);
      }
      constexpr int kDtChunks = kChannels * 4 / 16;
      for (int e = tid; e < kTile * kDtChunks; e += kThreads) {
        const int t = e / kDtChunks;
        const int j = e - t * kDtChunks;
        const int bytes = t < rows ? max(0, min(16, live * 4 - 16 * j)) : 0;
        copy16(dr + raw_at(t, kChannels * 4) + 16 * j,
               bytes ? dt + (row + t0 + t) * Din + c0 + 4 * j : dt, bytes);
      }
      const int bc = rows * N * sizeof(T);           // the tile's B (and C) bytes
      for (int e = tid; e < kTile * N * int(sizeof(T)) / 16; e += kThreads) {
        const int bytes = max(0, min(16, bc - 16 * e));
        const size_t at = (row + t0) * N + e * (16 / sizeof(T));
        copy16(br + 16 * e, bytes ? Bm + at : Bm, bytes);
        copy16(cr + 16 * e, bytes ? Cm + at : Cm, bytes);
      }
    } else {
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int t = e / kChannels;
        const int cc = e - t * kChannels;
        const bool ok = t < rows && cc < live;
        const size_t at = (row + t0 + t) * Din + c0 + cc;
        T* xrow = reinterpret_cast<T*>(xr + raw_at(t, Stage<T>::kXRow));
        xrow[cc] = ok ? x[at] : from_float<T>(0.f);
        reinterpret_cast<float*>(dr + raw_at(t, kChannels * 4))[cc] = ok ? dt[at] : 0.f;
      }
      for (int e = tid; e < kTile * N; e += kThreads) {
        const bool ok = e < rows * N;
        reinterpret_cast<T*>(br)[e] = ok ? Bm[(row + t0) * N + e] : from_float<T>(0.f);
        reinterpret_cast<T*>(cr)[e] = ok ? Cm[(row + t0) * N + e] : from_float<T>(0.f);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (kStages == 2) fetch(0, 0);
  for (int t0 = 0, st = 0; t0 < L; t0 += kTile, st = (st + 1) % kStages) {
    if (kStages == 1) {
      fetch(t0, 0);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      if (t0 + kTile < L) fetch(t0 + kTile, st ^ 1);   // lands during this tile
      else asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);      // this tile has landed
    }
    __syncthreads();
    const unsigned char* xr = smem + st * stage_bytes;
    const unsigned char* dr = xr + Stage<T>::kXBytes;
    const T* br = reinterpret_cast<const T*>(dr + Stage<T>::kDtBytes);
    const T* cr = br + kTile * N;
    // B, C by state: lanes over the states of a position (its N values
    // lie together), kMaxState slots a position so the index math is shifts
    for (int e = tid; e < kTile * kMaxState; e += kThreads) {
      const int t = e / kMaxState;
      const int n = e % kMaxState;
      if (n < npad) {
        b_s[row_at(n, t)] = n < N ? to_float(br[t * N + n]) : 0.f;
        c_s[row_at(n, t)] = n < N ? to_float(cr[t * N + n]) : 0.f;
      }
    }
    __syncthreads();

    float dtv[kItems], dtx[kItems], yv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int t = seg * kItems + i;
      const float xv =
          to_float(reinterpret_cast<const T*>(xr + raw_at(t, Stage<T>::kXRow))[ch]);
      dtv[i] = reinterpret_cast<const float*>(dr + raw_at(t, kChannels * 4))[ch];
      dtx[i] = dtv[i] * xv;
      yv[i] = d * xv;
    }
    float dt_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) dt_sum += dtv[i];
    // kStateGroup states at a time, each step of the three below over all
    // of them, so their latency chains overlap
    for (int n0 = 0; n0 < npad; n0 += kStateGroup) {
      float da[kStateGroup][kItems], u[kStateGroup][kItems];
      float P[kStateGroup], H[kStateGroup], carry[kStateGroup];
      // each segment's pair: product of decays, h from 0 (the first
      // segment from the carried state)
#pragma unroll
      for (int g = 0; g < kStateGroup; ++g) {
        const int n = n0 + g;
        const float a2 = a_s[n * kChannels + ch];
        carry[g] = h_s[n * kChannels + ch];
        const float4* bq = reinterpret_cast<const float4*>(b_s + row_at(n, seg * kItems));
        P[g] = decay(a2 * dt_sum);   // the product of the segment's decays
        H[g] = seg == 0 ? carry[g] : 0.f;
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const float4 v = bq[q];
          const float bs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = 4 * q + k;
            da[g][i] = decay(dtv[i] * a2);
            u[g][i] = dtx[i] * bs[k];
            H[g] = fmaf(da[g][i], H[g], u[g][i]);
          }
        }
      }
#pragma unroll
      for (int dd = 1; dd < kSegs; dd <<= 1) {     // inclusive scan of pairs
#pragma unroll
        for (int g = 0; g < kStateGroup; ++g) {
          const float Pp = __shfl_up_sync(0xffffffffu, P[g], dd, kSegs);
          const float Hp = __shfl_up_sync(0xffffffffu, H[g], dd, kSegs);
          if (seg >= dd) {
            H[g] = fmaf(P[g], Hp, H[g]);
            P[g] *= Pp;
          }
        }
      }
      // from the end of the segment before (the carry for the first),
      // walk the segment again for y
#pragma unroll
      for (int g = 0; g < kStateGroup; ++g) {
        const int n = n0 + g;
        float h = __shfl_up_sync(0xffffffffu, H[g], 1, kSegs);
        if (seg == 0) h = carry[g];
        if (seg == kSegs - 1) h_s[n * kChannels + ch] = H[g];   // the next tile's
        const float4* cq = reinterpret_cast<const float4*>(c_s + row_at(n, seg * kItems));
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const float4 v = cq[q];
          const float cs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = 4 * q + k;
            h = fmaf(da[g][i], h, u[g][i]);
            yv[i] = fmaf(cs[k], h, yv[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) y_s[tile_at(seg * kItems + i, ch)] = yv[i];
    __syncthreads();
    const int cc = tid % kChannels;          // y out: a thread a channel
    if (cc < live) {
      T* yt = y + (row + t0) * Din + c0 + cc;
      const int rows = min(kTile, L - t0);
      for (int t = tid / kChannels; t < rows; t += kThreads / kChannels)
        yt[static_cast<size_t>(t) * Din] = from_float<T>(y_s[tile_at(t, cc)]);
    }
  }
  __syncthreads();   // every channel's carry is in h_s
  for (int e = tid; e < kChannels * N; e += kThreads) {
    const int cc = e / N;
    const int n = e - cc * N;
    if (c0 + cc < Din)
      h_last[(static_cast<size_t>(b) * Din + c0 + cc) * N + n] = h_s[n * kChannels + cc];
  }
}

// opt in to more than 48 KB of dynamic shared memory (N > 20) once per type
template <typename T>
cudaError_t prepare(int smem) {
  static int granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) granted = smem;
  return e;
}

template <typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
           const void* D, const void* h0, void* y, void* h_last, int Bb, int L, int Din,
           int N, cudaStream_t stream) {
  if (N < 1 || N > kMaxState || Bb < 1 || Bb > 65535 || L < 1 || Din < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes<T>(N));
  const cudaError_t e = prepare<T>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // cp.async moves 16-byte pieces: every row of x, dt, B and C must start
  // on a 16-byte boundary
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool async = aligned(x) && aligned(dt) && aligned(Bm) && aligned(Cm) &&
                     Din * sizeof(T) % 16 == 0 && Din % 4 == 0 &&
                     static_cast<size_t>(L) * N * sizeof(T) % 16 == 0;
  const dim3 grid((Din + kChannels - 1) / kChannels, Bb);
  ssm_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const T*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last), L,
      Din, N, padded_states(N), async);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, B, C, D and y alike);
// dt, A, h0 and h_last are f32; h0 may be null (a zero state)
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* B, const void* C,
                               const void* A, const void* D, const void* h0, void* y,
                               void* h_last, int Bb, int L, int Din, int N, int dtype,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, B, C, A, D, h0, y, h_last, Bb, L, Din, N, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, B, C, A, D, h0, y, h_last, Bb, L, Din, N, st);
    case 2:
      return launch<__half>(x, dt, B, C, A, D, h0, y, h_last, Bb, L, Din, N, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
