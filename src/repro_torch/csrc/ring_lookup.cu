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
//   One warp per key: the bucket is the top R bits of hi; each lane loads 4
//   of the row's 128 slots (lanes on neighbouring addresses, so one row is
//   four coalesced 128-byte reads per word), compares them against the key,
//   and __ballot_sync/__popc give the count of live slots below it.  Lane 0
//   then writes row[count]: the owner id.  Bound on this card: bytes — one
//   1 KiB row pair per key plus the keys and owners; the directory is sized
//   to fit L2 (kernels/backend.py::bucket_budget_bytes), so rows hit L2.
//
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

__global__ void ring_lookup_bucketed_kernel(const uint32_t* __restrict__ keys_hi,
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
  const int64_t warps_per_block = kThreads / 32;
  const int64_t blocks = (q + warps_per_block - 1) / warps_per_block;
  ring_lookup_bucketed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_hi), static_cast<const uint32_t*>(keys_lo),
      static_cast<const uint32_t*>(bkt_hi), static_cast<const uint32_t*>(bkt_lo),
      static_cast<const int32_t*>(occ), static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), q, bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
