// EDRA dissemination-tree kernel for Hopper (sm_90a): K4.
//
// Replaces repro/kernels/edra_tree/kernel.py::edra_tree_pallas (body
// _edra_tree_kernel).  For each (event, observer) pair it computes what
// repro/kernels/edra_tree/ref.py::tree_math defines: the acknowledge TTL
// (rho(n) at offset 0, else trailing zeros), the hop depth (popcount), the
// tree parent (lowest set bit cleared), the Rule-8 fan-out, and the
// absolute acknowledge time, walking the ancestor chain from the reporter
// (the prefixes of the offset's set bits, high to low).  Each hop waits for
// the sender's next Theta-interval boundary (or, with fill_rate > 0, the
// Eq IV.4 early close when its buffer fills), then pays an exponential
// network delay.  Phases and delays come from lowbias32 hashes, so a pair
// needs no table.  Three variants are template parameters, as tree_math's
// Python branches: unbuffered (theta == 0, 1h-Calot), buffered
// (theta > 0), early close (fill_rate > 0, D1HT in simulate_churn).
//
// Bound on this card: 20 bytes in and 20 out per pair, against ~100
// integer and float32 operations per hop of the early-close walk (three
// extra mixes, a logf, a sqrtf) at ~10 hops a pair at n = 10^6: the
// early-close variant is bound by operations, the unbuffered one by bytes.
// What the design does about the operations:
//   * a thread walks only its offset's set bits, high to low
//     (31 - clz), not every level with a test;
//   * a warp runs as long as its slowest lane, and a pair's hops are its
//     popcount, which varies from pair to pair.  So a block takes a tile of
//     kTile pairs (coalesced loads), counting-sorts it by hops in shared
//     memory, walks the sorted pairs, and writes each result back to its
//     pair's own place in the tile through shared memory, so the stores stay
//     coalesced;
//   * one modulo a pair, not a hop: r = reporter % n once, then the sender
//     (reporter + cur) % n is r + cur, less n where that reaches n.  That
//     equals tree_math's ((reporter + cur) mod 2^32) % n whenever
//     offset < n and reporter + offset < 2^32 (cur <= offset); pairs
//     outside that domain keep the modulo at every hop;
//   * the Rule-8 fan-out in closed form: where offset + 2^l cannot wrap for
//     the levels counted, the levels l < min(ttl, levels) with
//     offset + 2^l < n are the first ceil(log2(n - offset)) of them; other
//     pairs count level by level on the wrapped sums;
//   * the grid is sized from the occupancy API: every resident block
//     strides over the tiles.
//
// The arithmetic is tree_math's to the bit.  uint32_t throughout, so every
// multiply, subtraction, sum and shift wraps mod 2^32.  Every float step is
// one rounded operation in tree_math's order: __fmul_rn/__fadd_rn/__fsub_rn
// keep nvcc from contracting a*b + c into an FMA, logf/sqrtf/ceilf are the
// precise versions (no __logf, no fast math), and the float constants
// arrive rounded to float32 by the host as tree_math rounds them.  Torch's
// CUDA log is the same libdevice logf, so the kernel equals the plain
// version on the card bit for bit, acks included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;            // pairs a block sorts and walks at once
constexpr int kBins = 33;                  // hops: 0..32
constexpr bool kSortTile = true;           // walk the tile in order of hops
constexpr bool kOneModulo = true;          // one modulo a pair where it is exact
constexpr int kGridWaves = 4;              // grid: resident blocks x this (the
//                                            default of the launch's grid_waves)

enum Variant { kUnbuffered = 0, kBuffered = 1, kEarlyClose = 2 };

struct Consts {
  float theta;       // float32(theta)
  float inv_theta;   // float32(1 / theta)
  float e_buf;       // float32(fill_rate * theta)
  float e_cap_m1;    // float32(e_cap - 1)
  float inv_fill;    // float32(1 / fill_rate)
  float delta;       // float32(delta_avg)
  uint32_t phase_key;
  int levels;
};

__device__ __forceinline__ uint32_t mix(uint32_t x) {   // lowbias32
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t h2(uint32_t a, uint32_t b) {
  return mix(a ^ (b * 0x9E3779B9u));
}

__device__ __forceinline__ float u01(uint32_t h) {      // (0, 1), 24 bits
  return __fmul_rn(__fadd_rn(static_cast<float>(h >> 8), 0.5f),
                   5.9604644775390625e-08f);
}

__device__ __forceinline__ uint32_t level_mask(int levels) {
  return levels >= 32 ? 0xFFFFFFFFu : (1u << levels) - 1u;
}

// the ack time of one pair: the walk along its offset's set bits
template <int V>
__device__ __forceinline__ float walk(uint32_t off, uint32_t n, uint32_t rep,
                                      uint32_t key, float t, const Consts& c) {
  uint32_t rem = off & level_mask(c.levels);
  const bool one_mod = kOneModulo && off < n && rep <= 0xFFFFFFFFu - off;
  const uint32_t gap = one_mod ? n - rep % n : 0u;   // n - r, r = rep % n
  uint32_t cur = 0u;
  while (rem) {
    const uint32_t bit = 1u << (31 - __clz(rem));
    rem ^= bit;
    const uint32_t sender = one_mod ? (cur >= gap ? cur - gap : cur + (n - gap))
                                    : (rep + cur) % n;
    const uint32_t nxt = cur | bit;
    const uint32_t h = h2(key, nxt);   // per-(event, edge) stream
    float flush = t;                   // unbuffered: forward at once
    if (V != kUnbuffered) {
      const float ph = __fmul_rn(u01(h2(c.phase_key, sender)), c.theta);
      const float k = ceilf(__fadd_rn(__fmul_rn(__fsub_rn(t, ph), c.inv_theta),
                                      1e-5f));
      flush = __fadd_rn(ph, __fmul_rn(k, c.theta));
      if (V == kEarlyClose) {
        float u = __fsub_rn(1.0f, __fmul_rn(__fsub_rn(flush, t), c.inv_theta));
        u = fminf(fmaxf(u, 0.0f), 1.0f);
        const float mean_b = __fmul_rn(u, c.e_buf);
        const float z = __fmul_rn(
            __fsub_rn(__fadd_rn(__fadd_rn(u01(mix(h ^ 0xB5297A4Du)),
                                          u01(mix(h ^ 0x68E31DA4u))),
                                u01(mix(h ^ 0x1B56C4E9u))),
                      1.5f),
            2.0f);
        const float buffered = __fadd_rn(mean_b, __fmul_rn(sqrtf(mean_b), z));
        const float need = fmaxf(__fsub_rn(c.e_cap_m1, buffered), 0.0f);
        flush = fminf(flush, __fadd_rn(t, __fmul_rn(need, c.inv_fill)));
      }
    }
    const float dly = __fmul_rn(-logf(u01(h)), c.delta);
    t = __fadd_rn(flush, dly);
    cur = nxt;
  }
  return t;
}

// Rule 8 on the wrapped sums: levels l < min(ttl, levels) with
// offset + 2^l < n (mod 2^32)
__device__ __forceinline__ int rule8_sends(uint32_t off, uint32_t n, int tt,
                                           int levels) {
  const int lmax = min(tt, levels);
  if (lmax == 0) return 0;
  if (static_cast<uint64_t>(off) + (1ull << (lmax - 1)) < (1ull << 32))
    return off < n ? min(lmax, 32 - __clz(n - off - 1u)) : 0;
  int sn = 0;
  for (int l = 0; l < lmax; ++l) sn += off + (1u << l) < n;
  return sn;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    edra_tree_kernel(const uint32_t* __restrict__ offset,
                     const uint32_t* __restrict__ n_ring,
                     const uint32_t* __restrict__ reporter,
                     const float* __restrict__ t_detect,
                     const uint32_t* __restrict__ event_key,
                     float* __restrict__ ack, int32_t* __restrict__ ttl,
                     int32_t* __restrict__ depth, uint32_t* __restrict__ parent,
                     int32_t* __restrict__ sends, int64_t p, Consts c) {
  __shared__ uint32_t s_off[kTile], s_n[kTile], s_rep[kTile], s_key[kTile];
  __shared__ float s_t[kTile];
  __shared__ int s_src[kTile];
  __shared__ int s_bin[kBins];
  const int tid = threadIdx.x;
  const uint32_t mask = level_mask(c.levels);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < p;
       base += static_cast<int64_t>(gridDim.x) * kTile) {
    const int64_t i = base + tid;
    const bool live = i < p;
    const uint32_t off = live ? offset[i] : 0u;
    const uint32_t n = live ? n_ring[i] : 1u;
    const uint32_t rep = live ? reporter[i] : 0u;
    const uint32_t key = live ? event_key[i] : 0u;
    const float t0 = live ? t_detect[i] : 0.0f;
    int slot = tid;
    if (kSortTile) {                  // counting sort of the tile by hops
      if (tid < kBins) s_bin[tid] = 0;
      __syncthreads();
      const int hops = __popc(off & mask);
      const int rank = atomicAdd(&s_bin[hops], 1);
      __syncthreads();
      if (tid == 0) {
        int sum = 0;
        for (int b = 0; b < kBins; ++b) {
          const int count = s_bin[b];
          s_bin[b] = sum;
          sum += count;
        }
      }
      __syncthreads();
      slot = s_bin[hops] + rank;
    }
    s_off[slot] = off;
    s_n[slot] = n;
    s_rep[slot] = rep;
    s_key[slot] = key;
    s_t[slot] = t0;
    s_src[slot] = tid;
    __syncthreads();

    const uint32_t w_off = s_off[tid];
    const uint32_t w_n = s_n[tid];
    const int src = s_src[tid];
    uint32_t s = w_n - 1u;               // rho(n) = ceil(log2 n), bit smear
    s |= s >> 1;
    s |= s >> 2;
    s |= s >> 4;
    s |= s >> 8;
    s |= s >> 16;
    const int tt = w_off == 0u ? __popc(s) : __popc((w_off & (0u - w_off)) - 1u);
    const float a = walk<V>(w_off, w_n, s_rep[tid], s_key[tid], s_t[tid], c);
    const int sn = rule8_sends(w_off, w_n, tt, c.levels);
    __syncthreads();                     // every input read: stage the outputs
    s_t[src] = a;
    s_off[src] = static_cast<uint32_t>(tt);
    s_n[src] = static_cast<uint32_t>(__popc(w_off));
    s_rep[src] = w_off & (w_off - 1u);
    s_key[src] = static_cast<uint32_t>(sn);
    __syncthreads();
    if (live) {
      ack[i] = s_t[tid];
      ttl[i] = static_cast<int32_t>(s_off[tid]);
      depth[i] = static_cast<int32_t>(s_n[tid]);
      parent[i] = s_rep[tid];
      sends[i] = static_cast<int32_t>(s_key[tid]);
    }
    __syncthreads();                     // the tile's outputs are read
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

cudaError_t blocks_per_sm(int variant, int* blocks) {
  if (variant == kUnbuffered)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, edra_tree_kernel<kUnbuffered>, kThreads, 0);
  if (variant == kBuffered)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, edra_tree_kernel<kBuffered>, kThreads, 0);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, edra_tree_kernel<kEarlyClose>, kThreads, 0);
}

}  // namespace

extern "C" int edra_tree_launch(const void* offset, const void* n_ring,
                                const void* reporter, const void* t_detect,
                                const void* event_key, void* ack, void* ttl,
                                void* depth, void* parent, void* sends, int64_t p,
                                int levels, int variant, float theta,
                                float inv_theta, float e_buf, float e_cap_m1,
                                float inv_fill, float delta, uint32_t phase_key,
                                int grid_waves, void* stream) {
  if (levels < 1 || levels > 32 || variant < kUnbuffered || variant > kEarlyClose ||
      grid_waves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{theta, inv_theta, e_buf, e_cap_m1, inv_fill, delta, phase_key,
                 levels};
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm(variant, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t blocks = (p + kTile - 1) / kTile;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count();
  if (blocks > resident * grid_waves) blocks = resident * grid_waves;
  auto* o = static_cast<const uint32_t*>(offset);
  auto* nr = static_cast<const uint32_t*>(n_ring);
  auto* r = static_cast<const uint32_t*>(reporter);
  auto* t0 = static_cast<const float*>(t_detect);
  auto* k = static_cast<const uint32_t*>(event_key);
  auto* a = static_cast<float*>(ack);
  auto* tt = static_cast<int32_t*>(ttl);
  auto* d = static_cast<int32_t*>(depth);
  auto* par = static_cast<uint32_t*>(parent);
  auto* sn = static_cast<int32_t*>(sends);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  if (variant == kUnbuffered)
    edra_tree_kernel<kUnbuffered><<<g, kThreads, 0, st>>>(o, nr, r, t0, k, a, tt, d,
                                                          par, sn, p, c);
  else if (variant == kBuffered)
    edra_tree_kernel<kBuffered><<<g, kThreads, 0, st>>>(o, nr, r, t0, k, a, tt, d,
                                                        par, sn, p, c);
  else
    edra_tree_kernel<kEarlyClose><<<g, kThreads, 0, st>>>(o, nr, r, t0, k, a, tt, d,
                                                          par, sn, p, c);
  return static_cast<int>(cudaGetLastError());
}
