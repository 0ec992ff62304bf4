// S6 selective scan backward for Hopper (sm_90a): K6b, the gradient of K6.
//
// repro has no backward kernel: its training differentiates the jnp
// associative scan (repro/models/ssm.py::_scan_chunks_m1) with jax.grad.
// The port's forward is K6 (ssm_scan.cu), so its gradient is a kernel too.
// With a_t = exp(dt_t A) per (channel d, state n), h_{-1} = h0 (0 without
// one), the forward's states h_t and the output gradients dy and dh_last,
// it computes the reverse recurrence
//     g_t = C_t dy_t + a_{t+1} g_{t+1},          g_L = dh_last
// and from it
//     dx_t  = sum_n g_t dt_t B_t + D dy_t        ddt_t = sum_n g_t (x_t B_t + A a_t h_{t-1})
//     dB_t  = sum_d g_t dt_t x_t                 dC_t  = sum_d dy_t h_t
//     dA    = sum_{b,t} g_t dt_t a_t h_{t-1}     dD    = sum_{b,t} dy_t x_t
//     dh0   = a_0 g_0
// (kernels/ssm_scan/ref.py::ssm_scan_bwd_ref is the same recurrence step by
// step).  dx, dB, dC and dD come out in x's dtype, ddt, dA and dh0 in f32.
//
// Bound on this card: at falcon-mamba-7b's training shape (Bb 8, L 1024,
// Din 8192, N 16) the bytes that must move (x, dy and dx in bf16, dt and
// ddt in f32, B, C and their gradients: ~0.94 GB) take ~0.28 ms at
// 3.35 TB/s, and the 1.07e9 exponentials, one a (position, channel,
// state), ~0.29 ms on the SFUs.  The design, the first one that is right:
//   * the layout of K6: a block owns kChannels consecutive channels of one
//     batch row; a thread owns one channel and kItems consecutive positions
//     (a segment) of a kTile-position tile, and loops over the states; the
//     kSegs segments of a channel are lanes of one warp;
//   * pass 1 walks the tiles forward with K6's segment scan (each segment
//     folded to a (product of decays, h from 0) pair, the pairs joined by a
//     width-kSegs __shfl_up_sync scan) and writes each tile's start state
//     to a scratch (Bb, tiles, N, Din) in device memory (67 MB at the shape
//     above: a scratch in device memory takes any L);
//   * pass 2 walks the tiles in reverse.  In each tile it recomputes the
//     states from the tile's start state with the same scan, keeping
//     h_{t-1} and a_t of its kItems positions in registers, then runs the
//     adjoint as a reverse scan: with q_t = a_t g_t (what flows into
//     h_{t-1}), q_t = a_t (C_t dy_t + q_{t+1}), so a segment folds to a
//     (product of decays, q from 0) pair from its own decays alone, the
//     pairs join by a width-kSegs __shfl_down_sync suffix scan, and the q
//     carried into the tile before is the first segment's (dh_last into
//     the last tile; dh0 = q_0 after the first);
//   * dx and ddt accumulate over the states in registers and go out through
//     shared memory; dA and dD accumulate over a thread's positions, join
//     over the segments by shuffles and over the tiles in shared memory,
//     and go to per-row partial sums;
//   * dB and dC are sums over every channel, so they cross blocks.  No
//     atomics: a warp's four channels join by a two-step butterfly of
//     shuffles (each step halves the positions a lane holds, so 6 shuffles
//     cover 8 positions), the 8 warps' sums go to shared memory kRedStates
//     states at a time and are added in warp order into per-block partials
//     (Bb, blocks, L, N) in device memory; a second launch
//     (ssm_bwd_sum_kernel) adds the partials in block order, and the dA
//     and dD partials in batch-row order.  Every sum has one fixed order,
//     so two calls give the same bits;
//   * exponentials: 2^(dt A log2 e) by ex2.approx, as K6, with the segment's
//     product of decays one more exponential of its summed dt; each pass
//     computes a_t once, so the kernel spends two exponentials a (position,
//     channel, state), twice the floor.
// The scan reorders the f32 sums and ex2.approx is not expf, so the results
// differ from the plain version's sequential recurrence in the last bits,
// and dx, dB, dC and dD are rounded once to x's dtype.  It takes any
// Bb <= 65535, L >= 1, Din >= 1 (the ragged last block is masked) and
// 1 <= N <= 32, with or without h0 and dh_last.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;                      // positions a thread owns a tile
constexpr int kSegs = 8;                       // segments of a channel: lanes
constexpr int kChannels = 32;                  // channels a block
constexpr int kThreads = kChannels * kSegs;    // 256
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kSegs * kItems;          // positions a tile
constexpr int kRedStates = 8;                  // states a dB / dC flush
constexpr int kMinBlocks = 2;                  // resident blocks an SM asked for
constexpr int kMaxState = 32;
constexpr int kPad = 32 / kSegs;               // (position, channel) tiles: words after a segment
constexpr int kRowPad = 4;                     // B, C tiles: words a segment
constexpr int kTileWords = kTile * kChannels + kSegs * kPad;
constexpr int kRowWords = kTile + kSegs * kRowPad + 4;   // + 4: states apart in banks
constexpr int kRedPitch = kRedStates + 1;
constexpr int kRedWords = kWarps * kTile * kRedPitch;    // one of dB, dC
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSegs == 8 && kChannels % 4 == 0, "a warp: 4 channels x 8 segments");
static_assert(kItems == 8, "the butterfly halves 8 positions twice");

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

// (position, channel) tiles: position t, channel c of the block
__device__ __forceinline__ int tile_at(int t, int c) {
  return t * kChannels + c + (t / kItems) * kPad;
}

// B and C tiles: state n, position t
__device__ __forceinline__ int row_at(int n, int t) {
  return n * kRowWords + t + (t / kItems) * kRowPad;
}

// the shared memory of a block: x, dt, dy tiles (f32); B, C by state;
// A log2 e, A, the carried state, the carried adjoint and dA per (state,
// channel); dB and dC per (warp, position, state of a flush)
inline size_t smem_bytes(int n) {
  return sizeof(float) * (3 * static_cast<size_t>(kTileWords) + 2 * n * kRowWords +
                          5 * n * kChannels + 2 * kRedWords);
}

// the scratch a call needs, in floats: tile start states (Bb, tiles, N,
// Din), dB and dC partials (Bb, blocks, L, N) each, dA partials (Bb, Din,
// N), dD partials (Bb, Din)
inline long long scratch_floats(int Bb, int L, int Din, int N) {
  const long long tiles = (L + kTile - 1) / kTile;
  const long long blocks = (Din + kChannels - 1) / kChannels;
  return Bb * (tiles * N * Din + 2 * blocks * L * N + static_cast<long long>(Din) * N + Din);
}

// the four channels of a warp (lanes 8 apart) joined: v holds this lane's
// 8 positions; out[j] gets position (lane & 8 ? 4 : 0) + (lane & 16 ? 2 : 0)
// + j of the segment, summed over the four channels
__device__ __forceinline__ void join_channels(const float (&v)[kItems], float (&out)[2],
                                              int lane) {
  const bool hi1 = lane & 8;
  const bool hi2 = lane & 16;
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi1 ? v[j] : v[j + 4];
    const float keep = hi1 ? v[j + 4] : v[j];
    w[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi2 ? w[j] : w[j + 2];
    const float keep = hi2 ? w[j + 2] : w[j];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
}

// a sum over the kSegs lanes of a channel, the same in every lane
__device__ __forceinline__ float sum_segments(float v) {
#pragma unroll
  for (int d = kSegs / 2; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d, kSegs);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ A, const T* __restrict__ D,
                        const float* __restrict__ h0, const T* __restrict__ dy,
                        const float* __restrict__ dh_last, T* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dh0,
                        float* __restrict__ hs, float* __restrict__ part_b,
                        float* __restrict__ part_c, float* __restrict__ part_a,
                        float* __restrict__ part_d, int L, int Din, int N) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                       // as tile_at; then dx on the way out
  float* dt_s = x_s + kTileWords;          // as tile_at; then ddt on the way out
  float* dy_s = dt_s + kTileWords;
  float* b_s = dy_s + kTileWords;          // as row_at
  float* c_s = b_s + N * kRowWords;
  float* a2_s = c_s + N * kRowWords;       // A log2 e, [N][kChannels]
  float* an_s = a2_s + N * kChannels;      // A
  float* h_s = an_s + N * kChannels;       // the carried state
  float* q_s = h_s + N * kChannels;        // the carried adjoint
  float* da_s = q_s + N * kChannels;       // dA over the tiles
  float* red_b = da_s + N * kChannels;     // [warp][position][kRedPitch]
  float* red_c = red_b + kRedWords;

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int c0 = blk * kChannels;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = warp * (32 / kSegs) + lane / kSegs;   // channel in block
  const int seg = lane % kSegs;
  const size_t row = static_cast<size_t>(b) * L;
  const int live = min(kChannels, Din - c0);
  const int tiles = (L + kTile - 1) / kTile;

  for (int e = tid; e < kChannels * N; e += kThreads) {
    const int cc = e / N;
    const int n = e - cc * N;
    const bool ok = cc < live;
    const size_t at = (static_cast<size_t>(b) * Din + c0 + cc) * N + n;
    const float a = ok ? A[static_cast<size_t>(c0 + cc) * N + n] : 0.f;
    a2_s[n * kChannels + cc] = __fmul_rn(a, kLog2e);
    an_s[n * kChannels + cc] = a;
    h_s[n * kChannels + cc] = (ok && h0 != nullptr) ? h0[at] : 0.f;
    q_s[n * kChannels + cc] = (ok && dh_last != nullptr) ? dh_last[at] : 0.f;
    da_s[n * kChannels + cc] = 0.f;
  }
  const float d = ch < live ? to_float(D[c0 + ch]) : 0.f;

  // a (position, channel) tile of a (Bb, L, Din) tensor into f32, 0 past L
  // and Din
  auto load_tile = [&](float* dst, const auto* src, int t0, int rows) {
    for (int e = tid; e < kTile * kChannels; e += kThreads) {
      const int t = e / kChannels;
      const int cc = e - t * kChannels;
      const bool ok = t < rows && cc < live;
      dst[tile_at(t, cc)] = ok ? to_float(src[(row + t0 + t) * Din + c0 + cc]) : 0.f;
    }
  };
  // a tile of a (Bb, L, N) tensor by state, 0 past L
  auto load_rows = [&](float* dst, const T* src, int t0, int rows) {
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int t = e / N;
      const int n = e - t * N;
      dst[row_at(n, t)] = t < rows ? to_float(src[(row + t0) * N + e]) : 0.f;
    }
  };
  // the tile start states of this block's channels: (tiles, N, Din) a row
  auto hs_at = [&](int tile, int n, int cc) {
    return hs + ((static_cast<size_t>(b) * tiles + tile) * N + n) * Din + c0 + cc;
  };

  // -- pass 1: the tiles' start states --------------------------------------
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * kTile;
    const int rows = min(kTile, L - t0);
    __syncthreads();
    for (int e = tid; e < kChannels * N; e += kThreads) {
      const int n = e / kChannels;
      const int cc = e - n * kChannels;
      if (cc < live) *hs_at(tile, n, cc) = h_s[e];
    }
    if (tile == tiles - 1) break;            // the last tile's end is not needed
    load_tile(x_s, x, t0, rows);
    load_tile(dt_s, dt, t0, rows);
    load_rows(b_s, Bm, t0, rows);
    __syncthreads();
    float dtv[kItems], dtx[kItems];
    float dt_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int at = tile_at(seg * kItems + i, ch);
      dtv[i] = dt_s[at];
      dtx[i] = dtv[i] * x_s[at];
      dt_sum += dtv[i];
    }
    for (int n = 0; n < N; ++n) {
      const float a2 = a2_s[n * kChannels + ch];
      const float carry = h_s[n * kChannels + ch];
      const float4* bq = reinterpret_cast<const float4*>(b_s + row_at(n, seg * kItems));
      float P = decay(a2 * dt_sum);
      float H = seg == 0 ? carry : 0.f;
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 v = bq[q];
        const float bs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * q + k;
          H = fmaf(decay(dtv[i] * a2), H, dtx[i] * bs[k]);
        }
      }
#pragma unroll
      for (int dd = 1; dd < kSegs; dd <<= 1) {
        const float Pp = __shfl_up_sync(0xffffffffu, P, dd, kSegs);
        const float Hp = __shfl_up_sync(0xffffffffu, H, dd, kSegs);
        if (seg >= dd) {
          H = fmaf(P, Hp, H);
          P *= Pp;
        }
      }
      __syncwarp();
      if (seg == kSegs - 1) h_s[n * kChannels + ch] = H;
    }
  }

  // -- pass 2: the adjoint, tile by tile in reverse ----------------------------
  float dd_acc = 0.f;                        // dD: dy x over this thread's positions
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile;
    const int rows = min(kTile, L - t0);
    __syncthreads();
    load_tile(x_s, x, t0, rows);
    load_tile(dt_s, dt, t0, rows);
    load_tile(dy_s, dy, t0, rows);
    load_rows(b_s, Bm, t0, rows);
    load_rows(c_s, Cm, t0, rows);
    for (int e = tid; e < kChannels * N; e += kThreads) {
      const int n = e / kChannels;
      const int cc = e - n * kChannels;
      h_s[e] = cc < live ? *hs_at(tile, n, cc) : 0.f;
    }
    __syncthreads();
    float xv[kItems], dtv[kItems], dyv[kItems], dxv[kItems], ddtv[kItems];
    float dt_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int at = tile_at(seg * kItems + i, ch);
      xv[i] = x_s[at];
      dtv[i] = dt_s[at];
      dyv[i] = dy_s[at];
      dt_sum += dtv[i];
      dxv[i] = d * dyv[i];
      ddtv[i] = 0.f;
      dd_acc = fmaf(dyv[i], xv[i], dd_acc);
    }
    for (int n0 = 0; n0 < N; n0 += kRedStates) {
      for (int n = n0; n < min(N, n0 + kRedStates); ++n) {
        const float a2 = a2_s[n * kChannels + ch];
        const float an = an_s[n * kChannels + ch];
        const float carry_h = h_s[n * kChannels + ch];
        const float carry_q = q_s[n * kChannels + ch];
        float bs[kItems], cs[kItems];
#pragma unroll
        for (int q = 0; q < kItems / 4; ++q) {
          const float4 vb = reinterpret_cast<const float4*>(b_s + row_at(n, seg * kItems))[q];
          const float4 vc = reinterpret_cast<const float4*>(c_s + row_at(n, seg * kItems))[q];
          bs[4 * q] = vb.x, bs[4 * q + 1] = vb.y, bs[4 * q + 2] = vb.z, bs[4 * q + 3] = vb.w;
          cs[4 * q] = vc.x, cs[4 * q + 1] = vc.y, cs[4 * q + 2] = vc.z, cs[4 * q + 3] = vc.w;
        }
        // the states again: the segment's pair, the scan, then the walk
        // keeping h_{t-1} and a_t
        float da[kItems], hp[kItems], dc[kItems], db[kItems];
        const float P0 = decay(a2 * dt_sum);
        float P = P0;
        float H = seg == 0 ? carry_h : 0.f;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          da[i] = decay(dtv[i] * a2);
          H = fmaf(da[i], H, dtv[i] * xv[i] * bs[i]);
        }
#pragma unroll
        for (int dd = 1; dd < kSegs; dd <<= 1) {
          const float Pp = __shfl_up_sync(0xffffffffu, P, dd, kSegs);
          const float Hp = __shfl_up_sync(0xffffffffu, H, dd, kSegs);
          if (seg >= dd) {
            H = fmaf(P, Hp, H);
            P *= Pp;
          }
        }
        float h = __shfl_up_sync(0xffffffffu, H, 1, kSegs);
        if (seg == 0) h = carry_h;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          hp[i] = h;
          h = fmaf(da[i], h, dtv[i] * xv[i] * bs[i]);
          dc[i] = dyv[i] * h;
        }
        // the adjoint: q_t = a_t (C_t dy_t + q_{t+1}); the segment's pair
        // (product of decays, q from 0), the last segment's from the carry
        float Q = 0.f;
#pragma unroll
        for (int i = kItems - 1; i >= 0; --i) Q = da[i] * fmaf(cs[i], dyv[i], Q);
        P = P0;
        if (seg == kSegs - 1) Q = fmaf(P, carry_q, Q);
#pragma unroll
        for (int dd = 1; dd < kSegs; dd <<= 1) {
          const float Pn = __shfl_down_sync(0xffffffffu, P, dd, kSegs);
          const float Qn = __shfl_down_sync(0xffffffffu, Q, dd, kSegs);
          if (seg + dd < kSegs) {
            Q = fmaf(P, Qn, Q);
            P *= Pn;
          }
        }
        float q = __shfl_down_sync(0xffffffffu, Q, 1, kSegs);
        if (seg == kSegs - 1) q = carry_q;
        __syncwarp();
        if (seg == 0) q_s[n * kChannels + ch] = Q;   // into the tile before
        float dal = 0.f;
#pragma unroll
        for (int i = kItems - 1; i >= 0; --i) {
          const float g = fmaf(cs[i], dyv[i], q);
          const float gdt = g * dtv[i];
          const float ah = da[i] * hp[i];
          dxv[i] = fmaf(gdt, bs[i], dxv[i]);
          ddtv[i] = fmaf(g, fmaf(xv[i], bs[i], an * ah), ddtv[i]);
          dal = fmaf(gdt, ah, dal);
          db[i] = gdt * xv[i];
          q = da[i] * g;
        }
        dal = sum_segments(dal);
        if (seg == 0) da_s[n * kChannels + ch] += dal;
        float ob[2], oc[2];
        join_channels(db, ob, lane);
        join_channels(dc, oc, lane);
        const int t = seg * kItems + ((lane & 8) ? 4 : 0) + ((lane & 16) ? 2 : 0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red_b[(warp * kTile + t + j) * kRedPitch + n - n0] = ob[j];
          red_c[(warp * kTile + t + j) * kRedPitch + n - n0] = oc[j];
        }
      }
      __syncthreads();
      // the block's dB and dC of these states: the warps' sums in order
      const int ns = min(kRedStates, N - n0);
      for (int e = tid; e < rows * ns; e += kThreads) {
        const int t = e / ns;
        const int nn = e - t * ns;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += red_b[(w * kTile + t) * kRedPitch + nn];
          sc += red_c[(w * kTile + t) * kRedPitch + nn];
        }
        const size_t at = ((static_cast<size_t>(b) * nblk + blk) * L + t0 + t) * N + n0 + nn;
        part_b[at] = sb;
        part_c[at] = sc;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {         // each thread its own slots
      const int at = tile_at(seg * kItems + i, ch);
      x_s[at] = dxv[i];
      dt_s[at] = ddtv[i];
    }
    __syncthreads();
    for (int e = tid; e < rows * kChannels; e += kThreads) {
      const int t = e / kChannels;
      const int cc = e - t * kChannels;
      if (cc < live) {
        const size_t at = (row + t0 + t) * Din + c0 + cc;
        dx[at] = from_float<T>(x_s[tile_at(t, cc)]);
        ddt[at] = dt_s[tile_at(t, cc)];
      }
    }
  }
  dd_acc = sum_segments(dd_acc);
  __syncthreads();
  for (int e = tid; e < kChannels * N; e += kThreads) {
    const int cc = e / N;
    const int n = e - cc * N;
    if (cc < live) {
      const size_t at = (static_cast<size_t>(b) * Din + c0 + cc) * N + n;
      part_a[at] = da_s[n * kChannels + cc];
      if (dh0 != nullptr) dh0[at] = q_s[n * kChannels + cc];
    }
  }
  if (seg == 0 && ch < live) part_d[static_cast<size_t>(b) * Din + c0 + ch] = dd_acc;
}

// one sum across partials: out[o * inner + i] = sum_p part[(o * parts + p)
// * inner + i], in order of p
struct SumJob {
  const float* part;
  void* out;
  long long outer, inner;
  int parts;
  int f32;                                   // out is float, else T
};

struct SumJobs {
  SumJob job[4];
};

template <typename T>
__global__ void __launch_bounds__(256) ssm_bwd_sum_kernel(const __grid_constant__ SumJobs jobs) {
  const SumJob& jb = jobs.job[blockIdx.y];
  const long long total = jb.outer * jb.inner;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = e / jb.inner;
    const long long i = e - o * jb.inner;
    const float* p = jb.part + o * jb.parts * jb.inner + i;
    float s = 0.f;
    for (int k = 0; k < jb.parts; ++k) s += p[static_cast<long long>(k) * jb.inner];
    if (jb.f32)
      static_cast<float*>(jb.out)[e] = s;
    else
      static_cast<T*>(jb.out)[e] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t prepare(int smem) {
  static int granted = 48 * 1024;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) granted = smem;
  return e;
}

template <typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
           const void* D, const void* h0, const void* dy, const void* dh_last, void* dx,
           void* ddt, void* dB, void* dC, void* dA, void* dD, void* dh0, float* scratch,
           long long scratch_len, int Bb, int L, int Din, int N, cudaStream_t stream) {
  if (N < 1 || N > kMaxState || Bb < 1 || Bb > 65535 || L < 1 || Din < 1 ||
      scratch_len < scratch_floats(Bb, L, Din, N) || (dh0 != nullptr && h0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(N));
  cudaError_t e = prepare<T>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (L + kTile - 1) / kTile;
  const int blocks = (Din + kChannels - 1) / kChannels;
  float* hs = scratch;
  float* part_b = hs + Bb * tiles * N * Din;
  float* part_c = part_b + static_cast<long long>(Bb) * blocks * L * N;
  float* part_a = part_c + static_cast<long long>(Bb) * blocks * L * N;
  float* part_d = part_a + static_cast<long long>(Bb) * Din * N;
  ssm_scan_bwd_kernel<T><<<dim3(blocks, Bb), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(A), static_cast<const T*>(D),
      static_cast<const float*>(h0), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dh0), hs, part_b, part_c, part_a, part_d, L, Din, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  SumJobs jobs;
  jobs.job[0] = {part_b, dB, Bb, static_cast<long long>(L) * N, blocks, 0};
  jobs.job[1] = {part_c, dC, Bb, static_cast<long long>(L) * N, blocks, 0};
  jobs.job[2] = {part_a, dA, 1, static_cast<long long>(Din) * N, Bb, 1};
  jobs.job[3] = {part_d, dD, 1, Din, Bb, 0};
  const long long most = std::max(static_cast<long long>(Bb) * L * N,
                                  static_cast<long long>(Din) * N);
  const unsigned grid_x = static_cast<unsigned>(std::min<long long>((most + 255) / 256, 4096));
  ssm_bwd_sum_kernel<T><<<dim3(grid_x, 4), 256, 0, stream>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, B, C, D, dy, and dx,
// dB, dC, dD alike); dt, A, h0, dh_last, and ddt, dA, dh0 are f32; h0,
// dh_last and dh0 may be null (dh0 only with h0); scratch: f32 of
// scratch_len >= scratch_floats(Bb, L, Din, N) floats (else the call is
// refused).  Two launches on `stream`:
// the scan, then the sums across blocks and batch rows.
extern "C" int ssm_scan_bwd_launch(const void* x, const void* dt, const void* B, const void* C,
                                   const void* A, const void* D, const void* h0, const void* dy,
                                   const void* dh_last, void* dx, void* ddt, void* dB, void* dC,
                                   void* dA, void* dD, void* dh0, void* scratch,
                                   long long scratch_len, int Bb, int L, int Din, int N,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, B, C, A, D, h0, dy, dh_last, dx, ddt, dB, dC, dA, dD, dh0, s,
                           scratch_len, Bb, L, Din, N, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, B, C, A, D, h0, dy, dh_last, dx, ddt, dB, dC, dA, dD,
                                   dh0, s, scratch_len, Bb, L, Din, N, st);
    case 2:
      return launch<__half>(x, dt, B, C, A, D, h0, dy, dh_last, dx, ddt, dB, dC, dA, dD, dh0, s,
                            scratch_len, Bb, L, Din, N, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
