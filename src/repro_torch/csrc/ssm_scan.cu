// S6 selective scan for Hopper (sm_90a): K6.
//
// Replaces repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas, the Mamba-1
// hot loop:
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t      (Din x N state)
//     y_t = h_t . C_t + D * x_t
// with x, dt: (Bb, L, Din), B, C: (Bb, L, N), A: (Din, N), D: (Din,),
// h0 and h_last: (Bb, Din, N) f32, y in x's dtype.  As in the TPU kernel
// the state never goes to device memory: it lives in registers for the
// whole walk over L, and only y and h_last are written.
//
// Bound on this card: at the path's shape (Bb 1, L 1024, Din 8192, N 16)
// the bytes that must move (x and y in bf16, dt in f32, ~69 MB) take
// ~20 us at 3.35 TB/s; the ~7 f32 operations per (position, channel,
// state) take ~14 us at 67 TFLOP/s; the 1.34e8 exponentials alone take
// ~32 us at the SFU's 16 a clock per SM.  So the kernel's work is the
// exponentials, and the design goes for enough threads to keep them
// flowing:
//   * one thread per (channel, state): P = next power of two >= N lanes
//     hold one channel's N states (lanes >= N carry zeros), so Din = 8192,
//     N = 16 gives 131,072 threads instead of 8,192 for one thread per
//     channel.  The P lanes reduce h . C with __shfl_xor_sync;
//   * a block of 256 threads owns 256 / P channels of one batch row and
//     walks L in tiles of kT positions: x and dt of its channels and the
//     B and C rows (shared by all its channels) are staged in shared
//     memory as f32, y is staged there and written back coalesced;
//   * exp(dt * A) does not depend on h, so the compiler can overlap the
//     exponentials of later positions with the h chain of earlier ones.
// Every f32 step is rounded once (__fmul_rn / __fadd_rn, no FMA
// contraction) in the order of the plain version, and expf is the
// precise one, so h agrees with the plain version on the card to the
// last bits; y differs only by the order of the N-term sum.
// It takes any Din (the ragged last block is masked) and any N <= 32.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;   // no opt-in needed below this

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

// smem per block: x, dt, y tiles (kT x cpb) and B, C tiles (kT x N), f32
__host__ __device__ inline size_t smem_floats(int kt, int cpb, int n) {
  return static_cast<size_t>(kt) * (3 * cpb + 2 * n);
}

template <typename T>
__global__ void ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                                const T* __restrict__ Bm, const T* __restrict__ Cm,
                                const float* __restrict__ A, const T* __restrict__ D,
                                const float* __restrict__ h0, T* __restrict__ y,
                                float* __restrict__ h_last, int L, int Din, int N,
                                int P, int kt) {
  const int cpb = kThreads / P;            // channels per block
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * cpb;
  const int tid = threadIdx.x;
  const int c = tid / P;                   // this thread's channel in the block
  const int s = tid - c * P;               // and its state
  const int ch = ch0 + c;
  const bool live = ch < Din && s < N;

  extern __shared__ float smem[];
  float* x_s = smem;                       // kt * cpb
  float* dt_s = x_s + kt * cpb;            // kt * cpb
  float* y_s = dt_s + kt * cpb;            // kt * cpb
  float* b_s = y_s + kt * cpb;             // kt * N
  float* c_s = b_s + kt * N;               // kt * N

  const size_t state = (static_cast<size_t>(b) * Din + ch) * N + s;
  const float a = live ? A[static_cast<size_t>(ch) * N + s] : 0.f;
  const float d = (ch < Din) ? to_float(D[ch]) : 0.f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.f;

  const size_t row = static_cast<size_t>(b) * L;
  for (int t0 = 0; t0 < L; t0 += kt) {
    const int len = min(kt, L - t0);
    for (int e = tid; e < len * cpb; e += kThreads) {
      const int t = e / cpb;
      const int cc = e - t * cpb;
      const size_t at = (row + t0 + t) * Din + ch0 + cc;
      const bool ok = ch0 + cc < Din;
      x_s[e] = ok ? to_float(x[at]) : 0.f;
      dt_s[e] = ok ? dt[at] : 0.f;
    }
    // the tile's B and C rows are contiguous in memory: len * N values
    const size_t bc0 = (row + t0) * N;
    for (int e = tid; e < len * N; e += kThreads) {
      b_s[e] = to_float(Bm[bc0 + e]);
      c_s[e] = to_float(Cm[bc0 + e]);
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float xt = x_s[t * cpb + c];
      const float dtt = dt_s[t * cpb + c];
      const float bt = s < N ? b_s[t * N + s] : 0.f;
      const float ct = s < N ? c_s[t * N + s] : 0.f;
      const float da = expf(__fmul_rn(dtt, a));
      h = __fadd_rn(__fmul_rn(da, h), __fmul_rn(__fmul_rn(dtt, xt), bt));
      float v = __fmul_rn(h, ct);
      for (int off = P >> 1; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (s == 0) y_s[t * cpb + c] = __fadd_rn(v, __fmul_rn(d, xt));
    }
    __syncthreads();
    for (int e = tid; e < len * cpb; e += kThreads) {
      const int t = e / cpb;
      const int cc = e - t * cpb;
      if (ch0 + cc < Din) y[(row + t0 + t) * Din + ch0 + cc] = from_float<T>(y_s[e]);
    }
  }
  if (live) h_last[state] = h;
}

template <typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
           const void* D, const void* h0, void* y, void* h_last, int Bb, int L, int Din,
           int N, cudaStream_t stream) {
  if (N < 1 || N > 32 || Bb < 1 || Bb > 65535 || L < 1 || Din < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < N) P <<= 1;
  const int cpb = kThreads / P;
  int kt = 64;
  while (kt > 1 && smem_floats(kt, cpb, N) * sizeof(float) > kSmemBudget) kt >>= 1;
  const size_t smem = smem_floats(kt, cpb, N) * sizeof(float);
  const dim3 grid((Din + cpb - 1) / cpb, Bb);
  ssm_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const T*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last), L,
      Din, N, P, kt);
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
