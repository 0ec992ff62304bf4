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
// state), ~0.26 ms on the SFUs.  What the kernel issues is the nearer
// limit: ~20 f32 operations a (position, channel, state) beside the
// exponential (below), with the scans' and the channel join's shuffles
// and the loads of B and C besides, ~1 ms at the SMs' issue rate.  The design
// (the second; the first recomputed each tile's start state in a pass of
// its own and took 3.40 ms):
//   * the layout of K6: a block owns kChannels consecutive channels of one
//     batch row; a thread owns one channel and kItems = 16 consecutive
//     positions (a segment) of a kTile-position tile, and loops over the
//     states; the kSegs segments of a channel are lanes of one warp
//     (kSegLane apart; a warp's four channels are neighbouring lanes);
//   * the tiles' start states come from K6's forward, which writes the
//     carry into each of its tiles when asked (hs: (Bb, tiles, N, Din),
//     K6's tile and this one are the same kTile); the tiles are walked in
//     reverse.  In each tile, kGroup states at a time, the segment's
//     decays a_t = 2^(dt A log2 e) are taken once (one ex2.approx a
//     position, and one a half segment for its product of decays, of its
//     summed dt) and kept in registers.  A thread walks its segment as two
//     chains of 8 positions at once (each half folded to a (product of
//     decays, h from 0) pair, the two joined into the segment's), the
//     segments' pairs join by a shuffle scan from the tile's start state,
//     and both halves are walked again from their own start to keep h_t.
//     The adjoint runs as a reverse scan: with q_t = a_t g_t (what flows
//     into h_{t-1}), q_t = a_t (C_t dy_t + q_{t+1}), so each half folds to
//     a (product of decays, q from 0) pair from its own decays, the
//     segments' pairs join by a suffix scan, and the q carried into the
//     tile before is the first segment's (dh_last into the last tile; dh0
//     = q_0 after the first);
//   * dx and ddt take sum_n g B and sum_n A g a h_{t-1}, two sums a
//     position kept in registers over the states, and go out through
//     shared memory; dA and dD accumulate over a thread's positions, join
//     over the segments by shuffles and over the tiles in shared memory,
//     and go to per-row partial sums;
//   * dB and dC are sums over every channel, so they cross blocks.  No
//     atomics: a warp's four channels join by a two-step butterfly of
//     shuffles as the two chains walk back (a lane keeps one half of its
//     segment and sends the other to the lane holding the next channel,
//     which keeps that one, so the first step selects nothing), the 8
//     warps' sums are added in warp order into the block's sums of the
//     tile, each group's behind its own barrier (two buffers of the
//     warps' sums, so one barrier a group); the
//     kCluster blocks of a thread-block cluster (along the channels) then
//     add their block sums in rank order through distributed shared
//     memory, each rank a kTile / kCluster slice of the positions, into one
//     partial per cluster (Bb, clusters, L, N): 34 MB at the shape above
//     instead of 268 MB a block; a second launch (ssm_bwd_sum_kernel) adds
//     the partials in cluster order, and the dA and dD partials in
//     batch-row order.  Every sum has one fixed order, so two calls give
//     the same bits.  The grid is rounded up to whole clusters: a padding
//     block computes nothing and adds its zeros;
//   * the next tile's x, dy (in their own type, 16-byte chunks), dt, B, C
//     and start states are copied by cp.async into the one stage while the
//     block computes this tile (plain loads where a row is not 16-byte
//     aligned): each thread holds its positions' dt, dt x and dy in
//     registers and x in shared memory, and B and C are laid out again by
//     state, so the stage is free as soon as the tile begins;
//   * registers bound it.  A thread keeps ~110 values for its 16 positions
//     (dt, dt x, dy, the two sums, a_t and h_t), and two states at once
//     need ~250: one block of 256 threads an SM, 8 warps (kMinBlocks 1).
//     ptxas -v (sm_90a): 255 registers and 0 bytes spilled in each of the
//     bf16, fp16 and f32 instantiations.  Two blocks an SM cap a thread at
//     128 registers and spill several hundred bytes to local memory, which
//     an SM whose shared memory is the kernel's holds in little L1: ~1.2x
//     slower; one state at a time, four, or 48 channels a block were
//     slower too (chip_kernel_steps.py k6b).
// The scan reorders the f32 sums and ex2.approx is not expf, so the results
// differ from the plain version's sequential recurrence in the last bits,
// and dx, dB, dC and dD are rounded once to x's dtype.  It takes any
// Bb <= 65535, L >= 1, Din >= 1 (the ragged last block is masked) and
// 1 <= N <= 32, with or without dh_last and dh0.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kItems = 16;                     // positions a thread owns a tile
constexpr int kSegs = 8;                       // segments of a channel: lanes
constexpr int kSegLane = 4;                    // lanes between a channel's segments
constexpr int kChLane = 1;                     // lanes between a warp's channels
constexpr int kChannels = 32;                  // channels a block
constexpr int kThreads = kChannels * kSegs;    // 256
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kSegs * kItems;          // positions a tile (K6's kTile)
constexpr int kHalf = kItems / 2;              // positions of each of a thread's two chains
constexpr int kGroup = 2;                      // states a thread takes at once
constexpr int kCluster = 8;                    // blocks a cluster, along the channels
constexpr int kMinBlocks = 1;                  // resident blocks an SM asked for
constexpr int kMaxState = 32;
constexpr int kPad = 32 / kSegs;               // (position, channel) tiles: words after a segment
constexpr int kRowPad = 4;                     // B, C tiles: words a segment
constexpr int kTileWords = kTile * kChannels + kSegs * kPad;
constexpr int kRowWords = kTile + kSegs * kRowPad + 4;   // + 4: states apart in banks
constexpr int kRedRow = kTile + kTile / 32;    // a warp's sums of a state: a word after 32 positions
constexpr int kSlice = kTile / kCluster;       // positions of a tile a rank sums over the cluster
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSegs == 8 && kChannels % 4 == 0 &&
                  ((kSegLane == 1 && kChLane == 8) || (kSegLane == 4 && kChLane == 1)),
              "a warp: 4 channels x 8 segments, one of them the faster in lanes");
static_assert(kItems == 16, "the channel join halves 16 positions twice");

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

// the stage, a tile as it arrives: x and dy rows of kChannels values in
// their own type, dt rows in f32 (16 bytes of padding after each segment's
// kItems rows), the B and C rows (kTile x N, as in device memory), and
// the tile's start states (N x kChannels)
template <typename T>
struct Stage {
  static constexpr int kXRow = kChannels * sizeof(T);
  static constexpr int kXBytes = kTile * kXRow + kSegs * 16;
  static constexpr int kDtBytes = kTile * kChannels * 4 + kSegs * 16;
  static __host__ __device__ int bytes(int n) {
    return 2 * kXBytes + kDtBytes + 2 * kTile * n * static_cast<int>(sizeof(T)) +
           n * kChannels * 4;
  }
};

__device__ __forceinline__ int raw_at(int t, int row_bytes) {   // bytes
  return t * row_bytes + (t / kItems) * 16;
}

__host__ __device__ inline int padded_states(int n) {
  return (n + kGroup - 1) / kGroup * kGroup;
}

// B and C by state; after the states, the ddt tile
__host__ __device__ inline int union_words(int n) {
  const int bc = 2 * padded_states(n) * kRowWords;
  return bc > kTileWords ? bc : kTileWords;
}

// the x (then dx) tile in x's type, in whole 16 bytes
template <typename T>
__host__ __device__ inline int x_words() {
  return (kTileWords * static_cast<int>(sizeof(T)) + 15) / 16 * 4;
}

// the shared memory of a block: the stage; B and C by state (then ddt);
// x (then dx) as tile_at; the warps' dB and dC of two groups of kGroup
// states (a group writes one while the block sums the other); the block's
// dB and dC of the tile, [dB | dC][position][N + 1]; A, the tile's start
// state, the carried adjoint and dA per (state, channel), the states
// padded to whole groups
template <typename T>
inline size_t smem_bytes(int n) {
  return Stage<T>::bytes(n) +
         sizeof(float) * (static_cast<size_t>(union_words(n)) + x_words<T>() +
                          4 * kGroup * kWarps * kRedRow + 2 * kTile * (n + 1) +
                          4 * padded_states(n) * kChannels);
}

inline int clusters_of(int Din) {
  return ((Din + kChannels - 1) / kChannels + kCluster - 1) / kCluster;
}

// the scratch a call needs, in floats: dB and dC partials (Bb, clusters,
// L, N) each, dA partials (Bb, Din, N), dD partials (Bb, Din)
inline long long scratch_floats(int Bb, int L, int Din, int N) {
  return Bb * (2LL * clusters_of(Din) * L * N + static_cast<long long>(Din) * N + Din);
}

// a sum over the kSegs lanes of a channel, the same in every lane
__device__ __forceinline__ float sum_segments(float v) {
#pragma unroll
  for (int d = kSegs / 2; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d * kSegLane);
  return v;
}

// 16 bytes from device memory into shared memory, the last 16 - bytes of
// them zero (cp.async.cg: bypasses L1, lands while the block computes)
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

// the cluster's barrier in two halves: arrive (this block's shared memory
// written), then wait (every block's written)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const float* __restrict__ A, const T* __restrict__ D,
                        const float* __restrict__ hs, const T* __restrict__ dy,
                        const float* __restrict__ dh_last, T* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dh0,
                        float* __restrict__ part_b, float* __restrict__ part_c,
                        float* __restrict__ part_a, float* __restrict__ part_d, int L,
                        int Din, int N, bool async) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const xr = smem;                              // the stage
  unsigned char* const dtr = xr + Stage<T>::kXBytes;
  unsigned char* const dyr = dtr + Stage<T>::kDtBytes;
  unsigned char* const br = dyr + Stage<T>::kXBytes;
  unsigned char* const cr = br + kTile * N * sizeof(T);
  unsigned char* const hr = cr + kTile * N * sizeof(T);
  float* const b_s = reinterpret_cast<float*>(smem + Stage<T>::bytes(N));   // as row_at
  float* const c_s = b_s + padded_states(N) * kRowWords;
  float* const ddt_s = b_s;                                    // as tile_at, after the states
  T* const x_s = reinterpret_cast<T*>(b_s + union_words(N));  // x, then dx, as tile_at
  // [2][kGroup][warp][dB | dC][kRedRow]
  float* const red = b_s + union_words(N) + x_words<T>();
  float* const sums = red + 4 * kGroup * kWarps * kRedRow;     // [dB | dC][t][N + 1]
  const int npad = padded_states(N);
  float* const an_s = sums + 2 * kTile * (N + 1);              // A, [npad][kChannels]
  float* const h_s = an_s + npad * kChannels;                  // the tile's start state
  float* const q_s = h_s + npad * kChannels;                   // the carried adjoint
  float* const da_s = q_s + npad * kChannels;                  // dA over the tiles

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const size_t part_row = static_cast<size_t>(b) * (gridDim.x / kCluster) + blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = warp * (32 / kSegs) + lane / kChLane % 4;   // channel in block
  const int seg = lane / kSegLane % kSegs;
  const size_t row = static_cast<size_t>(b) * L;
  const int live = min(kChannels, Din - c0);           // <= 0: a padding block
  const bool idle = live <= 0;
  const int tiles = (L + kTile - 1) / kTile;
  const int pitch = N + 1;
  // the channel join's halves: a lane keeps the half of its segment at
  // off[0] and sends the half at off[1] to the lane 8 apart (the next
  // channel, which keeps that half), then keeps or sends quarters to the
  // lane 16 apart by hi2
  const bool hi1 = lane & kChLane;
  const bool hi2 = lane & (2 * kChLane);
  const int off[2] = {hi1 ? kHalf : 0, hi1 ? 0 : kHalf};

  for (int e = tid; e < kChannels * npad; e += kThreads) {   // padding states: 0
    const int n = e / kChannels;
    const int cc = e - n * kChannels;
    const bool ok = cc < live && n < N;
    an_s[e] = ok ? A[static_cast<size_t>(c0 + cc) * N + n] : 0.f;
    q_s[e] = (ok && dh_last != nullptr)
                 ? dh_last[(static_cast<size_t>(b) * Din + c0 + cc) * N + n]
                 : 0.f;
    h_s[e] = 0.f;
    da_s[e] = 0.f;
  }
  for (int e = tid; e < 2 * kTile * pitch; e += kThreads) sums[e] = 0.f;
  const float d = ch < live ? to_float(D[c0 + ch]) : 0.f;

  // the tile into the stage: by cp.async where every row is 16-byte
  // aligned (the launcher checks), else by plain loads; 0 past L and Din
  auto fetch = [&](int tile) {
    const int t0 = tile * kTile;
    const int rows = min(kTile, L - t0);
    const float* hsrc = hs + (static_cast<size_t>(b) * tiles + tile) * N * Din + c0;
    if (async) {
      constexpr int kXChunks = Stage<T>::kXRow / 16;
      for (int e = tid; e < kTile * kXChunks; e += kThreads) {
        const int t = e / kXChunks;
        const int j = e - t * kXChunks;
        const int bytes = t < rows ? max(0, min(16, live * int(sizeof(T)) - 16 * j)) : 0;
        const size_t at = (row + t0 + t) * Din + c0 + j * (16 / sizeof(T));
        copy16(xr + raw_at(t, Stage<T>::kXRow) + 16 * j, bytes ? x + at : x, bytes);
        copy16(dyr + raw_at(t, Stage<T>::kXRow) + 16 * j, bytes ? dy + at : dy, bytes);
      }
      constexpr int kDtChunks = kChannels * 4 / 16;
      for (int e = tid; e < kTile * kDtChunks; e += kThreads) {
        const int t = e / kDtChunks;
        const int j = e - t * kDtChunks;
        const int bytes = t < rows ? max(0, min(16, live * 4 - 16 * j)) : 0;
        copy16(dtr + raw_at(t, kChannels * 4) + 16 * j,
               bytes ? dt + (row + t0 + t) * Din + c0 + 4 * j : dt, bytes);
      }
      const int bc = rows * N * sizeof(T);           // the tile's B (and C) bytes
      for (int e = tid; e < kTile * N * int(sizeof(T)) / 16; e += kThreads) {
        const int bytes = max(0, min(16, bc - 16 * e));
        const size_t at = (row + t0) * N + e * (16 / sizeof(T));
        copy16(br + 16 * e, bytes ? Bm + at : Bm, bytes);
        copy16(cr + 16 * e, bytes ? Cm + at : Cm, bytes);
      }
      for (int e = tid; e < N * kDtChunks; e += kThreads) {
        const int n = e / kDtChunks;
        const int j = e - n * kDtChunks;
        const int bytes = max(0, min(16, live * 4 - 16 * j));
        copy16(hr + (n * kChannels + 4 * j) * 4,
               bytes ? hsrc + static_cast<size_t>(n) * Din + 4 * j : hs, bytes);
      }
    } else {
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int t = e / kChannels;
        const int cc = e - t * kChannels;
        const bool ok = t < rows && cc < live;
        const size_t at = (row + t0 + t) * Din + c0 + cc;
        reinterpret_cast<T*>(xr + raw_at(t, Stage<T>::kXRow))[cc] = ok ? x[at] : from_float<T>(0.f);
        reinterpret_cast<T*>(dyr + raw_at(t, Stage<T>::kXRow))[cc] =
            ok ? dy[at] : from_float<T>(0.f);
        reinterpret_cast<float*>(dtr + raw_at(t, kChannels * 4))[cc] = ok ? dt[at] : 0.f;
      }
      for (int e = tid; e < kTile * N; e += kThreads) {
        const bool ok = e < rows * N;
        reinterpret_cast<T*>(br)[e] = ok ? Bm[(row + t0) * N + e] : from_float<T>(0.f);
        reinterpret_cast<T*>(cr)[e] = ok ? Cm[(row + t0) * N + e] : from_float<T>(0.f);
      }
      for (int e = tid; e < N * kChannels; e += kThreads) {
        const int n = e / kChannels;
        const int cc = e - n * kChannels;
        reinterpret_cast<float*>(hr)[e] = cc < live ? hsrc[static_cast<size_t>(n) * Din + cc] : 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float dd_acc = 0.f;                        // dD: dy x over this thread's positions
  bool pending = false;                      // the cluster's reads of `sums` not waited on
  if (!idle) fetch(tiles - 1);
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile;
    const int rows = min(kTile, L - t0);
    if (!idle) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      // out of the stage: dt, dt x and dy of this thread's positions into
      // registers and x into x_s, by chain (chain 0 the half of the segment
      // this lane keeps in the channel join, chain 1 the half it sends);
      // B and C by state; the start states
      float dtv[2][kHalf], dtx[2][kHalf], dyv[2][kHalf], s1[2][kHalf], s2[2][kHalf];
      float dt_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          const int t = seg * kItems + off[c] + k;
          const T xt = reinterpret_cast<const T*>(xr + raw_at(t, Stage<T>::kXRow))[ch];
          const float xv = to_float(xt);
          dtv[c][k] = reinterpret_cast<const float*>(dtr + raw_at(t, kChannels * 4))[ch];
          dyv[c][k] = to_float(reinterpret_cast<const T*>(dyr + raw_at(t, Stage<T>::kXRow))[ch]);
          dtx[c][k] = dtv[c][k] * xv;
          dd_acc = fmaf(dyv[c][k], xv, dd_acc);
          dt_sum[c] += dtv[c][k];
          x_s[tile_at(t, ch)] = xt;
          s1[c][k] = 0.f;                    // sum_n g B
          s2[c][k] = 0.f;                    // sum_n A g a h_{t-1}
        }
      }
      for (int e = tid; e < kTile * kMaxState; e += kThreads) {
        const int t = e / kMaxState;
        const int n = e % kMaxState;
        if (n < npad) {
          b_s[row_at(n, t)] = n < N ? to_float(reinterpret_cast<const T*>(br)[t * N + n]) : 0.f;
          c_s[row_at(n, t)] = n < N ? to_float(reinterpret_cast<const T*>(cr)[t * N + n]) : 0.f;
        }
      }
      for (int e = tid; e < N * kChannels; e += kThreads)
        h_s[e] = reinterpret_cast<const float*>(hr)[e];
      __syncthreads();
      if (tile > 0) fetch(tile - 1);         // lands while this tile computes

      for (int n0 = 0; n0 < npad; n0 += kGroup) {
        // kGroup states at once, each step below over all of them and both
        // chains, so that their latency chains overlap
        float an[kGroup], a2[kGroup], carry_h[kGroup], carry_q[kGroup];
        const float4* bq[kGroup][2];
        const float4* cq[kGroup][2];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int n = n0 + g;
          an[g] = an_s[n * kChannels + ch];
          a2[g] = __fmul_rn(an[g], kLog2e);
          carry_h[g] = h_s[n * kChannels + ch];
          carry_q[g] = q_s[n * kChannels + ch];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            bq[g][c] = reinterpret_cast<const float4*>(b_s + row_at(n, seg * kItems + off[c]));
            cq[g][c] = reinterpret_cast<const float4*>(c_s + row_at(n, seg * kItems + off[c]));
          }
        }
        // four B (or C) values of a chain at this thread's positions (the
        // same four for the warp's four channels: read again at each use,
        // as registers are what bounds the kernel)
        auto quad = [](const float4* const (&src)[kGroup][2], int g, int c, int q4,
                       float (&out)[4]) {
          const float4 v = src[g][c][q4];
          out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
        };
        // the states: a_t once a position, each half's pair, the
        // segment's, the scan from the tile's start state, then both
        // halves walked at once keeping h_t
        float da[kGroup][2][kHalf], hn[kGroup][2][kHalf];
        float Hc[kGroup][2];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) Hc[g][0] = Hc[g][1] = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < kHalf / 4; ++q4) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            float bs[2][4];
#pragma unroll
            for (int c = 0; c < 2; ++c) quad(bq, g, c, q4, bs[c]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int k = 4 * q4 + kk;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                da[g][c][k] = decay(dtv[c][k] * a2[g]);
                Hc[g][c] = fmaf(da[g][c][k], Hc[g][c], dtx[c][k] * bs[c][kk]);
              }
            }
          }
        }
        float P_lo[kGroup], P_hi[kGroup], P[kGroup], H_lo[kGroup], H[kGroup], Pc[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float Pk = decay(a2[g] * dt_sum[0]);   // each half's product of decays
          const float Ps = decay(a2[g] * dt_sum[1]);
          P_lo[g] = hi1 ? Ps : Pk;
          P_hi[g] = hi1 ? Pk : Ps;
          H_lo[g] = hi1 ? Hc[g][1] : Hc[g][0];
          const float H_hi = hi1 ? Hc[g][0] : Hc[g][1];
          P[g] = P_lo[g] * P_hi[g];
          H[g] = fmaf(P_hi[g], H_lo[g], H_hi);
          if (seg == 0) H[g] = fmaf(P[g], carry_h[g], H[g]);
          Pc[g] = P[g];
        }
#pragma unroll
        for (int dd = 1; dd < kSegs; dd <<= 1) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float Pp = __shfl_up_sync(0xffffffffu, Pc[g], dd * kSegLane);
            const float Hp = __shfl_up_sync(0xffffffffu, H[g], dd * kSegLane);
            if (seg >= dd) {
              H[g] = fmaf(Pc[g], Hp, H[g]);
              Pc[g] *= Pp;
            }
          }
        }
        float h0c[kGroup][2], hc[kGroup][2];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float h_start = __shfl_up_sync(0xffffffffu, H[g], kSegLane);
          if (seg == 0) h_start = carry_h[g];
          const float h_mid = fmaf(P_lo[g], h_start, H_lo[g]);
          h0c[g][0] = hc[g][0] = hi1 ? h_mid : h_start;
          h0c[g][1] = hc[g][1] = hi1 ? h_start : h_mid;
        }
#pragma unroll
        for (int q4 = 0; q4 < kHalf / 4; ++q4) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            float bs[2][4];
#pragma unroll
            for (int c = 0; c < 2; ++c) quad(bq, g, c, q4, bs[c]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int k = 4 * q4 + kk;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                hc[g][c] = fmaf(da[g][c][k], hc[g][c], dtx[c][k] * bs[c][kk]);
                hn[g][c][k] = hc[g][c];
              }
            }
          }
        }
        // the adjoint: q_t = a_t (C_t dy_t + q_{t+1}); each half's pair
        // (product of decays, q from 0), the segment's, the last
        // segment's from the carry, the suffix scan
        float Qc[kGroup][2];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) Qc[g][0] = Qc[g][1] = 0.f;
#pragma unroll
        for (int q4 = kHalf / 4 - 1; q4 >= 0; --q4) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            float cs[2][4];
#pragma unroll
            for (int c = 0; c < 2; ++c) quad(cq, g, c, q4, cs[c]);
#pragma unroll
            for (int kk = 3; kk >= 0; --kk) {
              const int k = 4 * q4 + kk;
#pragma unroll
              for (int c = 0; c < 2; ++c)
                Qc[g][c] = da[g][c][k] * fmaf(cs[c][kk], dyv[c][k], Qc[g][c]);
            }
          }
        }
        float Q_hi[kGroup], Q[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float Q_lo = hi1 ? Qc[g][1] : Qc[g][0];
          Q_hi[g] = hi1 ? Qc[g][0] : Qc[g][1];
          Q[g] = fmaf(P_lo[g], Q_hi[g], Q_lo);
          if (seg == kSegs - 1) Q[g] = fmaf(P[g], carry_q[g], Q[g]);
          Pc[g] = P[g];
        }
#pragma unroll
        for (int dd = 1; dd < kSegs; dd <<= 1) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float Pn = __shfl_down_sync(0xffffffffu, Pc[g], dd * kSegLane);
            const float Qn = __shfl_down_sync(0xffffffffu, Q[g], dd * kSegLane);
            if (seg + dd < kSegs) {
              Q[g] = fmaf(Pc[g], Qn, Q[g]);
              Pc[g] *= Pn;
            }
          }
        }
        float qc[kGroup][2];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float q = __shfl_down_sync(0xffffffffu, Q[g], kSegLane);
          if (seg == kSegs - 1) q = carry_q[g];
          const float q_mid = fmaf(P_hi[g], q, Q_hi[g]);   // into the low half
          qc[g][0] = hi1 ? q : q_mid;
          qc[g][1] = hi1 ? q_mid : q;
        }
        __syncwarp();
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (seg == 0) q_s[(n0 + g) * kChannels + ch] = Q[g];   // into the tile before
        // both halves walked back at once: the gradients a position; dB
        // and dC join over the warp's four channels as they come (each
        // lane keeps its chain 0 and sends its chain 1 to the lane 8
        // apart, which holds the other half), then over lanes 16 apart
        float dal[kGroup][2], wb[kGroup][kHalf], wc[kGroup][kHalf];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) dal[g][0] = dal[g][1] = 0.f;
#pragma unroll
        for (int q4 = kHalf / 4 - 1; q4 >= 0; --q4) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            float bs[2][4], cs[2][4];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              quad(bq, g, c, q4, bs[c]);
              quad(cq, g, c, q4, cs[c]);
            }
#pragma unroll
            for (int kk = 3; kk >= 0; --kk) {
              const int k = 4 * q4 + kk;
              float gb[2], gc[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float gr = fmaf(cs[c][kk], dyv[c][k], qc[g][c]);
                qc[g][c] = da[g][c][k] * gr;   // q_t = a_t g_t; a_t g_t h_{t-1}:
                const float w = qc[g][c] * (k > 0 ? hn[g][c][k > 0 ? k - 1 : 0] : h0c[g][c]);
                s1[c][k] = fmaf(gr, bs[c][kk], s1[c][k]);
                s2[c][k] = fmaf(an[g], w, s2[c][k]);
                dal[g][c] = fmaf(dtv[c][k], w, dal[g][c]);
                gb[c] = gr * dtx[c][k];
                gc[c] = dyv[c][k] * hn[g][c][k];
              }
              wb[g][k] = gb[0] + __shfl_xor_sync(0xffffffffu, gb[1], kChLane);
              wc[g][k] = gc[0] + __shfl_xor_sync(0xffffffffu, gc[1], kChLane);
            }
          }
        }
        float* const rg = red + (n0 / kGroup & 1) * kGroup * kWarps * 2 * kRedRow;
        const int t = seg * kItems + off[0] + (hi2 ? kHalf / 2 : 0);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float* rb = rg + (g * kWarps + warp) * 2 * kRedRow;
#pragma unroll
          for (int j = 0; j < kHalf / 2; ++j) {
            const float sb = hi2 ? wb[g][j] : wb[g][j + kHalf / 2];
            const float sc = hi2 ? wc[g][j] : wc[g][j + kHalf / 2];
            rb[t + j + (t >> 5)] =
                (hi2 ? wb[g][j + kHalf / 2] : wb[g][j]) + __shfl_xor_sync(0xffffffffu, sb, 2 * kChLane);
            rb[kRedRow + t + j + (t >> 5)] =
                (hi2 ? wc[g][j + kHalf / 2] : wc[g][j]) + __shfl_xor_sync(0xffffffffu, sc, 2 * kChLane);
          }
          const float dal_n = sum_segments(dal[g][0] + dal[g][1]);
          if (seg == 0) da_s[(n0 + g) * kChannels + ch] += dal_n;
        }
        __syncthreads();
        if (pending) {                       // the cluster has read the last tile's sums
          cluster_wait();
          pending = false;
        }
        // the block's dB and dC of these states: the warps' sums in order
        // (the next group writes the other buffer, and the one after this
        // one, behind the next barrier: one barrier a group)
        for (int e = tid; e < kGroup * 2 * kTile; e += kThreads) {
          const int g = e / (2 * kTile);
          const int val = (e / kTile) & 1;
          const int tt = e % kTile;
          const float* rs = rg + (g * kWarps * 2 + val) * kRedRow;
          if (tt < rows && n0 + g < N) {
            float sm = 0.f;
#pragma unroll
            for (int w2 = 0; w2 < kWarps; ++w2) sm += rs[w2 * 2 * kRedRow + tt + (tt >> 5)];
            sums[(val * kTile + tt) * pitch + n0 + g] = sm;
          }
        }
      }
      // dx (in place of x) and ddt (over B and C: the last state's barrier
      // is behind every read of them) of this thread's positions
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          const int at = tile_at(seg * kItems + off[c] + k, ch);
          const float xv = to_float(x_s[at]);
          ddt_s[at] = fmaf(xv, s1[c][k], s2[c][k]);
          x_s[at] = from_float<T>(fmaf(dtv[c][k], s1[c][k], d * dyv[c][k]));
        }
      }
    }
    if (pending) {                           // a padding block
      cluster_wait();
      pending = false;
    }
    cluster_arrive();                        // this block's sums and out tiles written
    cluster_wait();
    // this rank's slice of the tile: the cluster's blocks' sums in rank order
    for (int e = tid; e < 2 * kSlice * N; e += kThreads) {
      const int val = e / (kSlice * N);
      const int r2 = e - val * kSlice * N;
      const int t = rank * kSlice + r2 / N;
      const int n = r2 % N;
      if (t < rows) {
        const int at = (val * kTile + t) * pitch + n;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(sums, r)[at];
        (val ? part_c : part_b)[(part_row * L + t0 + t) * N + n] = s;
      }
    }
    if (!idle) {
      for (int e = tid; e < rows * kChannels; e += kThreads) {
        const int t = e / kChannels;
        const int cc = e - t * kChannels;
        if (cc < live) {
          const size_t at = (row + t0 + t) * Din + c0 + cc;
          dx[at] = x_s[tile_at(t, cc)];
          ddt[at] = ddt_s[tile_at(t, cc)];
        }
      }
    }
    cluster_arrive();                        // done reading the cluster's sums
    pending = true;
  }
  cluster_wait();                            // no block leaves while its sums are read
  if (idle) return;
  dd_acc = sum_segments(dd_acc);
  for (int e = tid; e < kChannels * N; e += kThreads) {
    const int n = e / kChannels;
    const int cc = e - n * kChannels;
    if (cc < live) {
      const size_t at = (static_cast<size_t>(b) * Din + c0 + cc) * N + n;
      part_a[at] = da_s[e];
      if (dh0 != nullptr) dh0[at] = q_s[e];
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

// the shared memory above 48 KB, and all of the SM's shared memory as
// such, asked for once per type
template <typename T>
cudaError_t prepare(int smem) {
  static int granted = -1;
  if (smem <= granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssm_scan_bwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) granted = smem;
  return e;
}

template <typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
           const void* D, const void* hs, const void* dy, const void* dh_last, void* dx,
           void* ddt, void* dB, void* dC, void* dA, void* dD, void* dh0, float* scratch,
           long long scratch_len, int Bb, int L, int Din, int N, cudaStream_t stream) {
  if (N < 1 || N > kMaxState || Bb < 1 || Bb > 65535 || L < 1 || Din < 1 || hs == nullptr ||
      scratch_len < scratch_floats(Bb, L, Din, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes<T>(N));
  cudaError_t e = prepare<T>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // cp.async moves 16-byte pieces: every row of x, dt, dy, B, C and the
  // start states must start on a 16-byte boundary
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool async = aligned(x) && aligned(dt) && aligned(dy) && aligned(Bm) && aligned(Cm) &&
                     aligned(hs) && Din * sizeof(T) % 16 == 0 && Din % 4 == 0 &&
                     static_cast<size_t>(L) * N * sizeof(T) % 16 == 0;
  const int clusters = clusters_of(Din);
  float* part_b = scratch;
  float* part_c = part_b + static_cast<long long>(Bb) * clusters * L * N;
  float* part_a = part_c + static_cast<long long>(Bb) * clusters * L * N;
  float* part_d = part_a + static_cast<long long>(Bb) * Din * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster, Bb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<T>, static_cast<const T*>(x),
                         static_cast<const float*>(dt), static_cast<const T*>(Bm),
                         static_cast<const T*>(Cm), static_cast<const float*>(A),
                         static_cast<const T*>(D), static_cast<const float*>(hs),
                         static_cast<const T*>(dy), static_cast<const float*>(dh_last),
                         static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(dh0),
                         part_b, part_c, part_a, part_d, L, Din, N, async);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  SumJobs jobs;
  jobs.job[0] = {part_b, dB, Bb, static_cast<long long>(L) * N, clusters, 0};
  jobs.job[1] = {part_c, dC, Bb, static_cast<long long>(L) * N, clusters, 0};
  jobs.job[2] = {part_a, dA, 1, static_cast<long long>(Din) * N, Bb, 1};
  jobs.job[3] = {part_d, dD, 1, Din, Bb, 0};
  const long long most = std::max(static_cast<long long>(Bb) * L * N,
                                  static_cast<long long>(Din) * N);
  const unsigned grid_x = static_cast<unsigned>(std::min<long long>((most + 255) / 256, 4096));
  ssm_bwd_sum_kernel<T><<<dim3(grid_x, 4), 256, 0, stream>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int N, int* out) {
  const int smem = static_cast<int>(smem_bytes<T>(N));
  cudaError_t e = prepare<T>(smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], ssm_scan_bwd_kernel<T>, kThreads,
                                                      smem);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * 1024);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = kCluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&out[1], ssm_scan_bwd_kernel<T>, &cfg);
  }
  if (e == cudaSuccess) {
    out[2] = attr.numRegs;
    out[3] = static_cast<int>(attr.localSizeBytes);
    out[4] = smem;
    out[5] = kThreads;
  }
  return static_cast<int>(e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, B, C, D, dy, and dx,
// dB, dC, dD alike); dt, A, hs, dh_last, and ddt, dA, dh0 are f32; hs:
// K6's tile start states (Bb, ceil(L / kTile), N, Din); dh_last and dh0
// may be null; scratch: f32 of scratch_len >= scratch_floats(Bb, L, Din,
// N) floats (else the call is refused).  Two launches on `stream`: the
// scan (clusters of kCluster blocks), then the sums across clusters and
// batch rows.
extern "C" int ssm_scan_bwd_launch(const void* x, const void* dt, const void* B, const void* C,
                                   const void* A, const void* D, const void* hs, const void* dy,
                                   const void* dh_last, void* dx, void* ddt, void* dB, void* dC,
                                   void* dA, void* dD, void* dh0, void* scratch,
                                   long long scratch_len, int Bb, int L, int Din, int N,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, B, C, A, D, hs, dy, dh_last, dx, ddt, dB, dC, dA, dD, dh0, s,
                           scratch_len, Bb, L, Din, N, st);
    case 1:
      return launch<__nv_bfloat16>(x, dt, B, C, A, D, hs, dy, dh_last, dx, ddt, dB, dC, dA, dD,
                                   dh0, s, scratch_len, Bb, L, Din, N, st);
    case 2:
      return launch<__half>(x, dt, B, C, A, D, hs, dy, dh_last, dx, ddt, dB, dC, dA, dD, dh0, s,
                            scratch_len, Bb, L, Din, N, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the scan kernel's residency at N states: out = (blocks an SM, clusters
// the card holds at once, registers a thread, local-memory bytes a
// thread, dynamic shared memory bytes a block, threads a block)
extern "C" int ssm_scan_bwd_occupancy(int N, int dtype, int* out) {
  if (N < 1 || N > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return occupancy<float>(N, out);
    case 1:
      return occupancy<__nv_bfloat16>(N, out);
    case 2:
      return occupancy<__half>(N, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
