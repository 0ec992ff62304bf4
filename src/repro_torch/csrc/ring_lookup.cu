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
//   lanes.  Here, as in K1, one thread per key runs a branchless lower
//   bound over the N words: no padding, any Q and N >= 1, threads past Q
//   return.  N is a launch argument (the table's length is its shape).
//   Bound on this card: bytes — keys and output 4 B a key each, the table
//   4 B a word once; a 10^6-word table (4 MB) stays in L2, so the
//   log2(N) dependent probes per key are L2 hits, hidden by 2^20 keys in
//   flight.

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

extern "C" int ring_lookup_launch(const void* keys, const void* table, void* out,
                                  int64_t q, int n, void* stream) {
  const int64_t blocks = (q + kThreads - 1) / kThreads;
  ring_lookup32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(out), q, n);
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
