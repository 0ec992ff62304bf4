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
// needs no table: no gathers, no shared memory, no communication.
//
// Layout: one thread per pair, a grid-stride loop over P, the level loop
// inside the thread.  The TPU kernel computes every level and selects; here
// a thread skips the levels whose offset bit is clear, which leaves the
// time and the prefix unchanged exactly as tree_math's select does.
// Three variants are template parameters, as tree_math's Python branches:
// unbuffered (theta == 0, 1h-Calot), buffered (theta > 0), early close
// (fill_rate > 0, D1HT in simulate_churn).
//
// Bound on this card: 20 bytes in and 20 out per pair (40 MB per 2^20
// pairs), against ~100 integer and float32 operations per hop of the
// early-close walk (three extra mixes, a logf, a sqrtf and an integer
// modulo per hop) plus ~8 per level for the bit test and the Rule-8 count.
// At n = 10^6 (20 levels, ~10 hops a pair) that is ~1,200 operations per
// pair: the early-close variant is bound by operations, the unbuffered one
// by bytes.  Nothing here tunes for that yet: a simple kernel first.
//
// The arithmetic is tree_math's to the bit.  uint32_t throughout, so every
// multiply, subtraction, sum and shift wraps mod 2^32, including
// (reporter + cur) % n and the Rule-8 test offset + 2^l < n.  Every float
// step is one rounded operation in tree_math's order: __fmul_rn/__fadd_rn/
// __fsub_rn keep nvcc from contracting a*b + c into an FMA, logf/sqrtf/
// ceilf are the precise versions (no __logf, no fast math), and the float
// constants arrive rounded to float32 by the host as tree_math rounds them.
// Torch's CUDA log is the same libdevice logf, so the kernel equals the
// plain version on the card bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

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

template <int V>
__global__ void edra_tree_kernel(const uint32_t* __restrict__ offset,
                                 const uint32_t* __restrict__ n_ring,
                                 const uint32_t* __restrict__ reporter,
                                 const float* __restrict__ t_detect,
                                 const uint32_t* __restrict__ event_key,
                                 float* __restrict__ ack, int32_t* __restrict__ ttl,
                                 int32_t* __restrict__ depth,
                                 uint32_t* __restrict__ parent,
                                 int32_t* __restrict__ sends, int64_t p, Consts c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < p; i += stride) {
    const uint32_t off = offset[i];
    const uint32_t n = n_ring[i];
    const uint32_t rep = reporter[i];
    const uint32_t key = event_key[i];

    uint32_t s = n - 1u;                 // rho(n) = ceil(log2 n), bit smear
    s |= s >> 1;
    s |= s >> 2;
    s |= s >> 4;
    s |= s >> 8;
    s |= s >> 16;
    const int tt = off == 0u ? __popc(s) : __popc((off & (0u - off)) - 1u);

    float t = t_detect[i];
    uint32_t cur = 0u;
    for (int b = c.levels - 1; b >= 0; --b) {
      const uint32_t bit = 1u << b;
      if (!(off & bit)) continue;
      const uint32_t sender = (rep + cur) % n;
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

    int sn = 0;
    for (int l = 0; l < c.levels; ++l)   // Rule 8, on the wrapped sum
      sn += (l < tt) && (off + (1u << l) < n);

    ack[i] = t;
    ttl[i] = tt;
    depth[i] = __popc(off);
    parent[i] = off & (off - 1u);
    sends[i] = sn;
  }
}

}  // namespace

extern "C" int edra_tree_launch(const void* offset, const void* n_ring,
                                const void* reporter, const void* t_detect,
                                const void* event_key, void* ack, void* ttl,
                                void* depth, void* parent, void* sends, int64_t p,
                                int levels, int variant, float theta,
                                float inv_theta, float e_buf, float e_cap_m1,
                                float inv_fill, float delta, uint32_t phase_key,
                                void* stream) {
  if (levels < 1 || levels > 32 || variant < kUnbuffered || variant > kEarlyClose)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{theta, inv_theta, e_buf, e_cap_m1, inv_fill, delta, phase_key,
                 levels};
  int64_t blocks = (p + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
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
