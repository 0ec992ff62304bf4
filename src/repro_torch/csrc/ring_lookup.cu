// Ring lookup kernels for Hopper (sm_90a): K1 (flat), K2 (bucketed) and
// K7 (single-word).
//
// K1 and K2 take 64-bit ring ids as (hi, lo) uint32 word pairs.  PyTorch
// hands the words over as int32 tensors that carry the uint32 bit
// patterns; the kernels read them as uint32_t and compare the recombined
// uint64 values, which is exactly the lexicographic (hi, lo) order of the
// TPU kernels.  K7 reads its single words the same way.
//
// K1 replaces repro/kernels/ring_lookup/kernel.py::ring_lookup64_pallas.
//   The TPU kernel counts table entries < key with an O(n) broadcast
//   compare, a choice for the VPU's lanes.  Here each key runs a lower
//   bound in two levels.  Bound on this card: the keys, the output and the
//   live table are each touched once (bytes, 6 us at Q 2^20, n 10^6); the
//   8 MiB table stays resident in the 50 MB L2, so what a search costs is
//   its L2 round trips: a one-level search over (hi, lo) words in two
//   arrays 4 MB apart touches two 32-byte sectors on each of its ~21
//   probes.  The design cuts those round trips:
//   * a persistent grid (one block of 1024 threads an SM) walks the keys
//     grid-stride; each block reads n, picks the stride s, the least power
//     of two with n <= s * kSample, and loads entries 0, s, 2s, ... < n as
//     packed uint64 into shared memory once (32 KB; s = 256 at n = 10^6).
//     One block an SM measured faster than two: with half the threads in
//     flight, a key's later segment probes more often find the 128-byte
//     lines of its earlier ones still in L1;
//   * a branchless lower bound over that sample, in shared memory, gives
//     c, the count of samples below the key: the answer lies in
//     [(c - 1) s + 1, min(c s, n)] (0 when c = 0);
//   * a branchless lower bound over that segment of < s entries, in
//     global memory (L2), gives the count.  It loads table_hi[mid] first and
//     table_lo[mid] only on a tie of the high words, which random 64-bit
//     ids make rare (keys equal to ids do tie), so a probe touches one
//     sector, and the last three probes share one.  At n = 10^6 this is 12
//     shared-memory probes and 8 L2 probes where the one-level search made
//     21 probes of two sectors each.  At n <= kSample the sample is the
//     whole table and the segment is empty.
//   n is read from device memory, so a lookup never syncs the host on it,
//   and membership churn never changes the launch.  Returns count % n,
//   like the TPU kernel.
//
// K2 replaces repro/kernels/ring_lookup/kernel.py::ring_lookup_bucketed_pallas.
//   The bucket is the top R bits of hi; the owner is row[count], count the
//   live slots of the row below the key (capped at 127: the slack slots
//   carry the bucket's successor).  Bound on this card: bytes -- the keys
//   and owners, and of each touched row its occ and the slots 0..occ[b]
//   the answer depends on, once; the directory is sized to fit
//   L2 (kernels/backend.py::bucket_budget_bytes), so every read of a row is
//   an L2 request, and the requests a key makes, and how many of them wait
//   on one another, are what the kernel pays: a warp a key reading the whole
//   1 KiB row pair (32 sectors) read as long on sorted keys as on random
//   ones (PERF.md, section 6).  One thread a key, 256-thread blocks over Q:
//   * ring ids are uniform hashes, so the count below a key is near
//     frac * occ[b], frac the key's place in its bucket's range.  The
//     thread reads the kWindow slots around that guess, one aligned 32-byte
//     sector of hi words and one of lo words, and counts the live ones
//     below the key in registers;
//   * when the window holds the answer (neither wholly above nor wholly
//     below the key) that is the count, and the owner is in registers: a
//     key costs occ, two sectors and three dependent L2 round trips.
//     Otherwise the branchless lower bound K1 and K7 use finishes the
//     search on the side the window rules out, loading hi[mid] and lo[mid]
//     only where the high words tie.  Uniformity buys speed only: any
//     directory gives the same answer;
//   * a batch of at most kK2WarpKeys keys (a fused decode round has <= 32)
//     is too small to fill the card, so it pays the chain of its slowest
//     key, up to ~8 round trips through a fallback search; there one warp a
//     key reads the whole row pair at once and counts with a ballot, in ~3.
//     The launcher picks by Q before the launch.
// K7 replaces repro/kernels/ring_lookup/kernel.py::ring_lookup_pallas.
//   bisect_left(table, key) % N over a sorted (N,) uint32 table, which may
//   hold duplicates (the count is of strict "less than", so a run of equal
//   words gives its first index).  The TPU kernel pads keys and table to
//   its tiles and runs an O(N) compare-and-count per key on the vector
//   lanes.  Bound on this card: bytes -- keys and output 4 B a key each,
//   the table 4 B a word once.  A 10^6-word table (4 MB) stays in L2, so
//   what a search pays is its L2 requests: the first design (one thread a
//   key, a branchless lower bound over all N words) made ~20 dependent
//   probes a key, the bottom ~10 of them scattered 32-byte sectors for 4
//   useful bytes each.  The design, as K1's but with the words half as
//   wide and 128 KB of shared memory, so the sample is eight times as
//   dense:
//   * a persistent grid, one block of 1024 threads an SM, walks the keys
//     grid-stride.  The stride s = 2^shift is the least power of two with
//     N <= s * kK7Sample (kK7Sample = 2^15 - 1: s = 32 at N = 10^6, 31,250
//     samples).  A first small kernel lays the samples (entries 0, s, 2s,
//     ... < N, then 2^32 - 1, which no key is below) out once a call as a
//     complete binary tree, breadth-first, in a compact scratch (one sector
//     a sample word), and each block copies it into 128 KB of dynamic
//     shared memory (the opt-in above 48 KB).  Gathered in every block
//     instead, at stride s, the fill would cost each block a sector a word;
//   * each key walks the tree down its 15 levels, a load, a compare and
//     two selects a level, keeping the samples either side of it; the
//     path's bits are c, the samples below the key, so the count lies in
//     [(c - 1) s + 1, min(c s, N)] (0 when c = 0), a segment of < s words,
//     at N = 10^6 inside one aligned 128-byte line.  The breadth-first
//     layout keeps a level's nodes contiguous: a sorted array's lower
//     bound, at power-of-two strides, puts all of a level's probes of a
//     warp in one bank (1.9x slower at Q 2^20 on an H100, PERF.md);
//   * the key's place between samples c - 1 and c, both in shared memory,
//     interpolates where the count falls in the segment, and the thread
//     reads the aligned window of kK7Window words (one 32-byte sector,
//     two 16-byte loads where the table is 16-byte aligned, plain loads
//     where not) holding that guess and counts the words below the key in
//     registers.  When the window holds the answer (neither wholly above
//     nor wholly below the key) that is the count: one L2 request a key.
//     Otherwise the aligned window next to it on the side the first rules
//     out, and where that misses too, the branchless lower bound over the
//     rest of that side.  Interpolation buys speed only: any sorted table
//     gives the same answer;
//   * at small Q the fill costs more than it saves (each block reads the
//     whole sample for a few keys), so the wrapper
//     (kernels/ring_lookup/kernel.py::k7_route) calls ring_lookup_launch,
//     the first design, one thread a key and one lower bound over the N
//     words, up to K7_SAMPLE_KEYS keys, and ring_lookup_sampled_launch
//     above; the two routes tie at 65,536 keys on an H100
//     (chip_kernel_steps.py, phase k7).
//   N is a launch argument (the table's length is its shape); any Q and
//   1 <= N < 2^31.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowWidth = 128;   // = RingState._BUCKET_ROW
constexpr int kThreads = 256;
constexpr int kSample = 4096;    // K1's splitter sample: 32 KB of uint64
constexpr int kK1Threads = 1024;
constexpr int kK1BlocksPerSM = 1;
constexpr int kWindow = 8;   // K2's first read: slots a 32-byte sector holds
constexpr int64_t kK2WarpKeys = 4096;   // K2 takes a warp a key up to here
constexpr int kK7Levels = 15;           // K7's sample tree: 15 levels,
constexpr int kK7Sample = 32767;        // (1 << kK7Levels) - 1 nodes, 128 KB
constexpr int kK7Threads = 1024;
constexpr int kK7Window = 8;            // K7's first read: a 32-byte sector
static_assert(kK7Sample == (1 << kK7Levels) - 1, "a complete tree");
static_assert((kK7Sample + 1) % (4 * kK7Threads) == 0, "whole uint4 copies");

__device__ __forceinline__ uint64_t id64(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Branchless lower bound over n >= 1 sorted entries, where below(j) says
// whether entry j is < the key: returns the count of entries < the key
// (the first index of a run of equal entries, i.e. bisect_left).
template <typename Below>
__device__ __forceinline__ int32_t count_below(int32_t n, Below below) {
  int32_t base = 0;
  int32_t len = n;
  while (len > 1) {
    const int32_t half = len >> 1;
    const int32_t mid = base + half;
    base = below(mid) ? mid : base;
    len -= half;
  }
  return base + below(base);
}

__global__ void __launch_bounds__(kK1Threads, kK1BlocksPerSM)
ring_lookup64_kernel(const uint32_t* __restrict__ keys_hi,
                     const uint32_t* __restrict__ keys_lo,
                     const uint32_t* __restrict__ table_hi,
                     const uint32_t* __restrict__ table_lo,
                     const int32_t* __restrict__ n_live,
                     int32_t* __restrict__ out, int64_t q) {
  __shared__ uint64_t sample[kSample];
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int32_t n = *n_live;
  if (n <= 0) {            // RingState raises on an empty table first
    for (int64_t i = first; i < q; i += step) out[i] = 0;
    return;
  }
  int shift = 0;           // s = 2^shift: the least power of two, n <= s * kSample
  while ((static_cast<int64_t>(kSample) << shift) < n) ++shift;
  const int32_t m = ((n - 1) >> shift) + 1;   // entries 0, s, 2s, ... < n
  for (int32_t i = threadIdx.x; i < m; i += blockDim.x)
    sample[i] = id64(table_hi[i << shift], table_lo[i << shift]);
  __syncthreads();
  for (int64_t i = first; i < q; i += step) {
    const uint32_t kh = keys_hi[i];
    const uint32_t kl = keys_lo[i];
    const uint64_t key = id64(kh, kl);
    const int32_t c = count_below(m, [&](int32_t j) { return sample[j] < key; });
    int32_t count = 0;
    if (c > 0) {           // sample c - 1 < key <= sample c (or c == m)
      const int32_t lo = ((c - 1) << shift) + 1;
      const int64_t end = static_cast<int64_t>(c) << shift;
      const int32_t len = static_cast<int32_t>(end < n ? end : n) - lo;
      const uint32_t* seg_hi = table_hi + lo;
      const uint32_t* seg_lo = table_lo + lo;
      count = lo + (len > 0 ? count_below(len, [&](int32_t j) {
                                const uint32_t h = seg_hi[j];
                                return h < kh || (h == kh && seg_lo[j] < kl);
                              })
                            : 0);
    }
    out[i] = count == n ? 0 : count;
  }
}

__global__ void ring_lookup32_kernel(const uint32_t* __restrict__ keys,
                                     const uint32_t* __restrict__ table,
                                     int32_t* __restrict__ out, int64_t q,
                                     int32_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= q) return;
  const uint32_t key = keys[i];
  const int32_t count = count_below(n, [&](int32_t j) { return table[j] < key; });
  out[i] = count == n ? 0 : count;
}

// K7's sample tree, breadth-first (node k's children are 2k and 2k + 1):
// node k at depth d holds the sample of in-order rank r, entry r s of the
// table, or 2^32 - 1 (never below a key) past the m samples; word 0 is a pad
__device__ __forceinline__ uint32_t tree_node(const uint32_t* __restrict__ table,
                                              int32_t k, int32_t m, int shift) {
  if (k == 0) return 0xFFFFFFFFu;
  const int d = 31 - __clz(k);
  const int32_t r = ((((k - (1 << d)) << 1) + 1) << (kK7Levels - 1 - d)) - 1;
  return r < m ? table[static_cast<int64_t>(r) << shift] : 0xFFFFFFFFu;
}

__global__ void ring_lookup32_tree_kernel(const uint32_t* __restrict__ table,
                                          uint32_t* __restrict__ tree, int32_t m,
                                          int shift) {
  const int32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k <= kK7Sample) tree[k] = tree_node(table, k, m, shift);
}

// The words of the aligned window [w0, w0 + kK7Window) below the key, of
// the wn = min(kK7Window, N - w0) it holds.  kVec: the table is 16-byte
// aligned, so a full window is kK7Window / 4 uint4 loads.
template <bool kVec>
__device__ __forceinline__ int32_t window_below(const uint32_t* __restrict__ table,
                                                int32_t wn, uint32_t key, int32_t w0) {
  uint32_t w[kK7Window];
  if (kVec && wn == kK7Window) {
#pragma unroll
    for (int v = 0; v < kK7Window / 4; ++v) {
      const uint4 x = reinterpret_cast<const uint4*>(table + w0)[v];
      w[4 * v] = x.x, w[4 * v + 1] = x.y, w[4 * v + 2] = x.z, w[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kK7Window; ++j) w[j] = j < wn ? table[w0 + j] : 0xFFFFFFFFu;
  }
  int32_t in = 0;
#pragma unroll
  for (int j = 0; j < kK7Window; ++j) in += j < wn && w[j] < key;
  return in;
}

// The count of table words below the key, known to lie in [lo + 1, hi]:
// table[lo] = a < key <= b (b = table[hi] when hi < N, else 2^32 - 1).
template <bool kVec>
__device__ __forceinline__ int32_t segment_count(const uint32_t* __restrict__ table,
                                                 int32_t n, uint32_t key,
                                                 int32_t lo, int32_t hi,
                                                 uint32_t a, uint32_t b) {
  const auto below = [&](int32_t j) { return table[j] < key; };
  const float frac = __fdividef(static_cast<float>(key - a),
                                static_cast<float>(b - a) + 1.0f);
  const int32_t guess = min(lo + static_cast<int32_t>(frac * static_cast<float>(hi - lo)),
                            hi - 1);
  int32_t w0 = guess & ~(kK7Window - 1);         // <= guess < hi <= N
  int32_t wn = min(kK7Window, n - w0);           // words the window holds
  int32_t in = window_below<kVec>(table, wn, key, w0);
  if (in == 0 && w0 > lo + 1) {        // the window starts at or past the key:
    w0 -= kK7Window;                   // the aligned window before it (>= 0:
    wn = kK7Window;                    // w0 > lo + 1 >= 1, a multiple)
    in = window_below<kVec>(table, wn, key, w0);
    if (in == 0 && w0 > lo + 1)
      return lo + 1 + count_below(w0 - lo - 1, [&](int32_t j) { return below(lo + 1 + j); });
  } else if (in == wn && w0 + wn < hi) {   // it ends below the key:
    w0 += kK7Window;                   // the aligned window after it (wn was
    wn = min(kK7Window, n - w0);       // kK7Window, so w0 + wn < hi <= N)
    in = window_below<kVec>(table, wn, key, w0);
    const int32_t past = w0 + wn;
    if (in == wn && past < hi)
      return past + count_below(hi - past, [&](int32_t j) { return below(past + j); });
  }
  return w0 + in;
}

template <bool kVec>
__global__ void __launch_bounds__(kK7Threads, 1)
ring_lookup32_sampled_kernel(const uint32_t* __restrict__ keys,
                             const uint32_t* __restrict__ table,
                             const uint32_t* __restrict__ compact,
                             int32_t* __restrict__ out, int64_t q, int32_t n,
                             int shift) {
  // the sample tree in shared memory, a copy of the compact one (the
  // scratch is 16-byte aligned; all loads issued before the stores)
  extern __shared__ uint4 tree4[];
  const uint32_t* tree = reinterpret_cast<const uint32_t*>(tree4);
  {
    constexpr int kCopies = (kK7Sample + 1) / 4 / kK7Threads;
    const uint4* src = reinterpret_cast<const uint4*>(compact);
    uint4 v[kCopies];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) v[j] = src[threadIdx.x + j * kK7Threads];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) tree4[threadIdx.x + j * kK7Threads] = v[j];
  }
  __syncthreads();
  const auto lookup = [&](uint32_t key) {
    // down the tree: each level a load, a compare, and the samples on
    // either side of the key kept; the path's bits are c, the samples
    // below the key.  A level's nodes are contiguous, so the top levels'
    // loads of a warp fall in distinct banks or on one word
    int32_t k = 1;
    uint32_t a = 0, b = 0xFFFFFFFFu;
#pragma unroll
    for (int d = 0; d < kK7Levels; ++d) {
      const uint32_t v = tree[k];
      const bool lt = v < key;
      a = lt ? v : a;
      b = lt ? b : v;
      k = 2 * k + lt;
    }
    const int32_t c = k - (1 << kK7Levels);
    if (c == 0) return 0;              // sample c - 1 = a < key <= b = sample c
    const int32_t lo = (c - 1) << shift;
    const int64_t end = static_cast<int64_t>(c) << shift;
    const int32_t hi = static_cast<int32_t>(end < n ? end : n);
    const int32_t count = hi - lo > 1 ? segment_count<kVec>(table, n, key, lo, hi, a, b) : hi;
    return count == n ? 0 : count;
  };
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first; i < q; i += step) out[i] = lookup(keys[i]);
}

// opt in to K7's dynamic shared memory (above 48 KB) once per variant and
// device: the attribute applies to the current device only
template <bool kVec>
cudaError_t k7_prepare(int device) {
  static uint64_t granted = 0;
  if (device < 64 && granted >> device & 1u) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(ring_lookup32_sampled_kernel<kVec>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (kK7Sample + 1) * static_cast<int>(sizeof(uint32_t)));
  if (e == cudaSuccess && device < 64) granted |= uint64_t{1} << device;
  return e;
}

// K2 for a few keys: one warp a key reads the whole row pair at once, each
// lane 4 of its 128 slots (four coalesced 128-byte reads a word), and
// __ballot_sync/__popc count the live slots below the key
__global__ void ring_lookup_bucketed_warp_kernel(const uint32_t* __restrict__ keys_hi,
                                                 const uint32_t* __restrict__ keys_lo,
                                                 const uint32_t* __restrict__ bkt_hi,
                                                 const uint32_t* __restrict__ bkt_lo,
                                                 const int32_t* __restrict__ occ,
                                                 uint32_t* __restrict__ out_hi,
                                                 uint32_t* __restrict__ out_lo,
                                                 int64_t q, int bits) {
  const int lane = threadIdx.x & 31;
  // blockDim is a multiple of 32, so i is the same on every lane of a warp
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (i >= q) return;
  const uint32_t qh = keys_hi[i];
  const uint64_t key = id64(qh, keys_lo[i]);
  const uint32_t b = bits > 0 ? (qh >> (32 - bits)) : 0u;
  const uint32_t* row_hi = bkt_hi + static_cast<size_t>(b) * kRowWidth;
  const uint32_t* row_lo = bkt_lo + static_cast<size_t>(b) * kRowWidth;
  const int live = occ[b];
  int count = 0;
#pragma unroll
  for (int k = 0; k < kRowWidth / 32; ++k) {
    const int j = k * 32 + lane;
    const bool lt = j < live && id64(row_hi[j], row_lo[j]) < key;
    count += __popc(__ballot_sync(0xffffffffu, lt));
  }
  count = min(count, kRowWidth - 1);   // occ < 128 keeps a pad slot
  if (lane == 0) {
    out_hi[i] = row_hi[count];
    out_lo[i] = row_lo[count];
  }
}

__global__ void ring_lookup_bucketed_kernel(const uint32_t* __restrict__ keys_hi,
                                            const uint32_t* __restrict__ keys_lo,
                                            const uint32_t* __restrict__ bkt_hi,
                                            const uint32_t* __restrict__ bkt_lo,
                                            const int32_t* __restrict__ occ,
                                            uint32_t* __restrict__ out_hi,
                                            uint32_t* __restrict__ out_lo,
                                            int64_t q, int bits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= q) return;
  const uint32_t kh = keys_hi[i];
  const uint32_t kl = keys_lo[i];
  const uint64_t key = id64(kh, kl);
  const uint32_t b = bits > 0 ? (kh >> (32 - bits)) : 0u;
  const uint32_t* row_hi = bkt_hi + static_cast<size_t>(b) * kRowWidth;
  const uint32_t* row_lo = bkt_lo + static_cast<size_t>(b) * kRowWidth;
  const int32_t live = occ[b];
  // the key's place in its bucket's range as a 32-bit fraction, and the
  // window of kWindow slots (a 32-byte sector of each word) holding
  // frac * live, the count expected below it
  const uint32_t frac = static_cast<uint32_t>((key << bits) >> 32);
  const int32_t guess = static_cast<int32_t>((static_cast<uint64_t>(frac) * live) >> 32);
  const int32_t w0 = guess & ~(kWindow - 1);
  uint32_t wh[kWindow], wl[kWindow];
#pragma unroll
  for (int v = 0; v < kWindow / 4; ++v) {
    const uint4 h = reinterpret_cast<const uint4*>(row_hi + w0)[v];
    const uint4 l = reinterpret_cast<const uint4*>(row_lo + w0)[v];
    wh[4 * v] = h.x, wh[4 * v + 1] = h.y, wh[4 * v + 2] = h.z, wh[4 * v + 3] = h.w;
    wl[4 * v] = l.x, wl[4 * v + 1] = l.y, wl[4 * v + 2] = l.z, wl[4 * v + 3] = l.w;
  }
  int32_t in = 0;                      // live slots of the window below the key
#pragma unroll
  for (int j = 0; j < kWindow; ++j) in += w0 + j < live && id64(wh[j], wl[j]) < key;
  const auto below = [&](int32_t j) {  // the low word only on a tie
    const uint32_t h = row_hi[j];
    return h < kh || (h == kh && row_lo[j] < kl);
  };
  int32_t count = w0 + in;
  if (in == 0 && w0 > 0) {             // the window starts at or past the key
    count = count_below(w0, below);
  } else if (in == kWindow && count < live) {   // it ends below the key
    count += count_below(live - count, [&](int32_t j) { return below(w0 + kWindow + j); });
  }
  count = min(count, kRowWidth - 1);   // occ < 128 keeps a pad slot
  uint32_t oh = 0, ol = 0;
  bool held = false;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    if (count == w0 + j) oh = wh[j], ol = wl[j], held = true;
  }
  if (!held) oh = row_hi[count], ol = row_lo[count];
  out_hi[i] = oh;
  out_lo[i] = ol;
}

}  // namespace

extern "C" int ring_lookup64_launch(const void* keys_hi, const void* keys_lo,
                                    const void* table_hi, const void* table_lo,
                                    const void* n_live, void* out, int64_t q,
                                    void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = std::min<int64_t>((q + kK1Threads - 1) / kK1Threads,
                                           static_cast<int64_t>(sms) * kK1BlocksPerSM);
  ring_lookup64_kernel<<<static_cast<unsigned>(blocks), kK1Threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_hi), static_cast<const uint32_t*>(keys_lo),
      static_cast<const uint32_t*>(table_hi), static_cast<const uint32_t*>(table_lo),
      static_cast<const int32_t*>(n_live), static_cast<int32_t*>(out), q);
  return static_cast<int>(cudaGetLastError());
}

// K7's first design, the route for small Q: a thread a key
extern "C" int ring_lookup_launch(const void* keys, const void* table, void* out,
                                  int64_t q, int n, void* stream) {
  const int64_t blocks = (q + kThreads - 1) / kThreads;
  ring_lookup32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(out), q, n);
  return static_cast<int>(cudaGetLastError());
}

// K7's sampled route: the tree into the (kK7Sample + 1)-word scratch
// `sample`, then the persistent grid
extern "C" int ring_lookup_sampled_launch(const void* keys, const void* table,
                                          void* sample, void* out, int64_t q, int n,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* t = static_cast<const uint32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  int shift = 0;           // s = 2^shift: the least power of two, n <= s * kK7Sample
  while ((static_cast<int64_t>(kK7Sample) << shift) < n) ++shift;
  const int32_t m = ((n - 1) >> shift) + 1;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool vec = reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (err == cudaSuccess) err = vec ? k7_prepare<true>(device) : k7_prepare<false>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* samp = static_cast<uint32_t*>(sample);
  ring_lookup32_tree_kernel<<<(kK7Sample + 256) / 256, 256, 0, st>>>(t, samp, m, shift);
  const int64_t blocks = std::min<int64_t>((q + kK7Threads - 1) / kK7Threads, sms);
  const size_t smem = (kK7Sample + 1) * sizeof(uint32_t);
  if (vec)
    ring_lookup32_sampled_kernel<true><<<static_cast<unsigned>(blocks), kK7Threads, smem, st>>>(
        k, t, samp, o, q, n, shift);
  else
    ring_lookup32_sampled_kernel<false><<<static_cast<unsigned>(blocks), kK7Threads, smem, st>>>(
        k, t, samp, o, q, n, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ring_lookup_bucketed_launch(const void* keys_hi, const void* keys_lo,
                                           const void* bkt_hi, const void* bkt_lo,
                                           const void* occ, void* out_hi, void* out_lo,
                                           int64_t q, int bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kh = static_cast<const uint32_t*>(keys_hi);
  const auto* kl = static_cast<const uint32_t*>(keys_lo);
  const auto* bh = static_cast<const uint32_t*>(bkt_hi);
  const auto* bl = static_cast<const uint32_t*>(bkt_lo);
  const auto* oc = static_cast<const int32_t*>(occ);
  auto* oh = static_cast<uint32_t*>(out_hi);
  auto* ol = static_cast<uint32_t*>(out_lo);
  if (q <= kK2WarpKeys) {
    const int64_t blocks = (q + kThreads / 32 - 1) / (kThreads / 32);
    ring_lookup_bucketed_warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        kh, kl, bh, bl, oc, oh, ol, q, bits);
  } else {
    const int64_t blocks = (q + kThreads - 1) / kThreads;
    ring_lookup_bucketed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        kh, kl, bh, bl, oc, oh, ol, q, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
