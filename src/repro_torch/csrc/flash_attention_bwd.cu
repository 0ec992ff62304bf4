// Flash attention backward for Hopper (sm_90a): K5b, the gradient of K5.
//
// repro has no backward kernel: its training differentiates the jnp flash
// path (repro/models/layers.py::flash_attention) with jax.grad.  The port's
// forward is K5 (flash_attention{,_tc}.cu), so its gradient is a kernel
// too, and computes what jax.grad of that path computes: given q, k, v, the
// forward's output o and its per-row logsumexp lse (natural log of the
// scaled scores, written by K5), and the output gradient dO,
//   D  = rowsum(dO * o)                 (per query row, f32)
//   P  = exp(q k^T * scale - lse)       (0 where masked or past Sk)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = dS K * scale,  dK = dS^T q * scale,
// with dK and dV summed over the g query heads of each kv head (GQA), the
// top-left causal mask of K5 (query i sees keys 0..i; training has Sq = Sk,
// where top-left and bottom-right agree, and the wrapper refuses causal
// with Sq != Sk), and P recomputed from the forward's lse, never stored.
//
// Bound on this card: at qwen2.5-3b's training shape (B 8, S 1024, H 16,
// Hkv 2, hd 128, bf16, causal) the five products (q K^T, dO V^T, P^T dO,
// dS^T q, dS K) are 2 B H pairs (3 dqk + 2 dv) = 86 GFLOP, 0.087 ms at the
// tensor cores' 989 TFLOP/s, against 50 MB of inputs and outputs
// (0.015 ms): the operations bind, and only wgmma reaches that rate.  The
// tensor-core route (bf16, fp16 at (hd, v hd) in {(64, 64), (112, 112),
// (128, 128), (192, 128)}) is built from K5's forward design
// (flash_attention_tc.cu) and stays deterministic: no atomics, each block writes its rows of dQ,
// dK or dV once.  Three launches, seven products (the dQ kernel computes
// q K^T and dO V^T again):
//   * bwd_prep_kernel: D = rowsum(dO * o), a row per 16-byte lane group,
//     and lse * log2 e, both into f32 rows of (B, H, Sq padded to 64) with
//     D = 0 and lse = +inf past Sq (so P = 0 there), which the TMA copies
//     whole;
//   * bwd_dkdv_wgmma_kernel: a block per (batch, kv head, 64 key rows), the
//     heaviest key tiles (the first, under the causal mask) launched first.
//     Its K and V tiles load once by TMA.  Two warpgroups share the block's
//     work: the (query head, query tile) steps the mask lets through, over
//     the kv head's g query heads, alternate between them, and each
//     warpgroup streams its steps' q and dO tiles, with their lse and D
//     rows, through its own TMA ring of three stages (two at hd 128,
//     where three do not fit; one mbarrier a stage; the warpgroup's first
//     thread refills a stage as soon as the products that read it are
//     done, while the next step's first products run).  A warpgroup owns the 64 key rows as wgmma's M: S^T = K q^T
//     and dP^T = V dO^T run with both operands in shared memory (K-major);
//     P^T and dS^T, rounded to the input type (FA2's recipe), stay in the
//     accumulator registers, which already have the layout of wgmma's
//     register A operand, and feed dV += P^T dO and dK += dS^T q, with q
//     and dO read MN-major through the descriptor's transpose bit: no
//     tile is transposed by hand.  At the end the second warpgroup hands
//     its dK and dV sums to the first through shared memory, which adds
//     them in a fixed order and stores.  Splitting a block's steps between
//     two warpgroups halves the longest block's chain of steps (the causal
//     mask gives key tile 0 every query tile), and each warpgroup's
//     elementwise work overlaps the other's products;
//   * bwd_dq_wgmma_kernel: a block (one warpgroup) per (batch, query head,
//     64 query rows), heaviest first as K5; q and dO load once, K and V
//     tiles stream through a TMA ring (three stages, two at hd 128, so that
//     two blocks share an SM); S = q K^T and dP = dO V^T
//     from shared memory, dS from the accumulators as the A operand of
//     dQ += dS K, K read MN-major.
// A step is 64 query rows (dK/dV) or 64 key positions (dQ), 32 at MLA's
// (192, 128): the dK accumulator alone is 64 x 192 f32 (96 registers a
// thread), dV 64 more, so S^T and dP^T at 32 queries keep a thread under
// 255 registers.  TMA fills rows past Sq or Sk with zeros; key positions
// >= Sk are masked to P = 0 before they count, and rows past the end are
// computed and never stored.  The 16-bit tiles are 128-byte-swizzled
// boxes of 64 columns (hopper.cuh), so hd 192 is three boxes and hd 128
// two; every ring's mbarrier expects its own bytes.
//
// f32 at hd 64 and 128 runs FA2's schedule on the CUDA cores in f32 (256
// threads a block, 4 x 4 outputs a thread), whose 1e-4 tolerance the
// tensor cores cannot meet.  hd 112 (zamba2's shared block) runs, as in
// K5's forward, on the 128-wide tiles: the tensor maps carry the true
// inner extent 112, so the TMA fills columns 112-127 of q, K, V and dO
// with zeros, which add 0 to S and dP, make those columns of dq, dk and
// dv zero, and are never stored (the price: 128/112 of the products).
// Other head dims (16, 32; f32 at 112 and at (192, 128)) have no
// backward; the wrapper refuses them.  Unmasked attention takes any Sq
// and Sk (whisper's encoder, 1500 x 1500, and its cross attention, 448
// over 1500): keys >= Sk, whose rows the TMA fills with zeros, get P = 0,
// and queries >= Sq have lse = +inf.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int kKeys = 64;         // key rows of a dK/dV block (a warpgroup's M)
constexpr int kRows = 64;         // query rows of a dQ block
constexpr int kPadTo = 64;        // the lse / D rows' padding of Sq
constexpr int kWg = 128;          // threads of a warpgroup
constexpr int kBox = 64 * kRowBytes;   // one 64-row box
constexpr int kSimtThreads = 256; // the f32 kernels: 16 x 16 threads
constexpr int kSimtTile = 64;     // their key and query tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// ---------------------------------------------------------------------------
// f32 preprocess: D = rowsum(dO * o), one warp a (batch, position, head) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                 float* __restrict__ delta, int rows, int Sq, int H, int hdv) {
  const int row = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                     // whole warps leave together
  const T* o = out + static_cast<size_t>(row) * hdv;
  const T* d = dout + static_cast<size_t>(row) * hdv;
  float acc = 0.f;
  for (int c = lane; c < hdv; c += 32) acc = fmaf(to_float(o[c]), to_float(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int bq = row / H;                    // b * Sq + position
    const int b = bq / Sq;
    delta[(static_cast<size_t>(b) * H + h) * Sq + (bq - b * Sq)] = acc;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16 / fp16): wgmma and TMA
// ---------------------------------------------------------------------------

// D and lse * log2 e into rows of Sq_pad (rows past Sq: D 0, lse +inf).
// kPer = HDV / 8 threads a (batch, position, head) row of hdv <= HDV
// values, 16 bytes each of o and dO (those past hdv add nothing); threads
// past the rows write the padding.
template <typename T, int HDV>
__global__ void __launch_bounds__(256)
    bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, int rows, int pad_rows, int Sq, int Sq_pad, int H,
                    int hdv) {
  constexpr int kPer = HDV / 8;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / kPer;
  const int part = static_cast<int>(t % kPer);
  float acc = 0.f;
  if (row < rows && part * 8 < hdv) {
    const uint4 ov = *reinterpret_cast<const uint4*>(out + row * hdv + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + row * hdv + part * 8);
    const T* o8 = reinterpret_cast<const T*>(&ov);
    const T* d8 = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(to_float(o8[i]), to_float(d8[i]), acc);
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part != 0) return;
  if (row < rows) {
    const int h = static_cast<int>(row % H);
    const long long bq = row / H;                // b * Sq + position
    const int b = static_cast<int>(bq / Sq);
    const int pos = static_cast<int>(bq - static_cast<long long>(b) * Sq);
    const size_t bh = static_cast<size_t>(b) * H + h;
    delta[bh * Sq_pad + pos] = acc;
    lse2[bh * Sq_pad + pos] = lse[bh * Sq + pos] * kLog2e;
  } else if (row < rows + pad_rows) {
    const int npad = Sq_pad - Sq;
    const long long p = row - rows;
    const size_t at = static_cast<size_t>(p / npad) * Sq_pad + Sq + p % npad;
    delta[at] = 0.f;
    lse2[at] = INFINITY;
  }
}

constexpr int kSmemMax = 227 * 1024;   // a block's shared memory (232,448 bytes)
constexpr int kSmemSm = 228 * 1024;    // an SM's, each block also reserving 1 KB

template <int HDQK, int HDV>
struct Bwd {
  // a step: query rows of a dK/dV step, key positions of a dQ step
  static constexpr int kStep = HDQK > 128 ? 32 : 64;
  static constexpr int kQkBoxes = HDQK / kBoxCols;
  static constexpr int kVBoxes = HDV / kBoxCols;
  static constexpr int kTileBytes = (kQkBoxes + kVBoxes) * kBox;     // K + V, or q + dO: 64 rows
  static constexpr int kStepBox = kStep * kRowBytes;                // a box of one step
  static constexpr int kStepBytes = (kQkBoxes + kVBoxes) * kStepBox; // q + dO, or K + V: a step
  static constexpr int kStatBytes = 2 * kStep * 4;                  // a step's lse and D rows
  // ring depths: three stages where shared memory allows it (a dK/dV
  // block alone on its SM; two dQ blocks an SM), else two
  static constexpr int dkdv_smem(int stages) {
    return kTileBytes + 2 * stages * (kStepBytes + kStatBytes) + 1024;
  }
  static constexpr int dq_smem(int stages) { return kTileBytes + stages * kStepBytes + 1024; }
  static constexpr int kDkDvStages = dkdv_smem(3) <= kSmemMax ? 3 : 2;
  static constexpr int kDqStages = 2 * (dq_smem(3) + 1024) <= kSmemSm ? 3 : 2;
  static constexpr int kRing = 2 * kDkDvStages * kStepBytes;        // dK/dV: two warpgroups' rings
  static constexpr int kDkDvSmem = dkdv_smem(kDkDvStages);
  static constexpr int kDqSmem = dq_smem(kDqStages);
  // the second warpgroup's dK and dV sums, handed over in the rings' bytes
  static_assert((kQkBoxes + kVBoxes) * 32 * kWg * 4 <= kRing, "reduction scratch");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Register layout of a 64 x N f32 accumulator d[N / 2] (wgmma m64nN):
// thread t of the warpgroup, warp w = t / 32, lane l, holds rows
// 16 w + l / 4 (i = 0) and 16 w + l / 4 + 8 (i = 1), columns 8 c + 2 (l % 4)
// + e (e = 0, 1) of each 8-column chunk c, at d[4 c + 2 i + e].  The A
// operand of k-step kk (columns 16 kk .. 16 kk + 15) is chunks 2 kk and
// 2 kk + 1, packed in pairs.
template <typename T, int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = 4 * (2 * kk + half) + 2 * i;
        a[kk][2 * half + i] = pack2<T>(d[at], d[at + 1]);
      }
}

template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(2 * kWg, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,    // boxes of a step
                          const __grid_constant__ CUtensorMap kmap,    // boxes of 64 rows
                          const __grid_constant__ CUtensorMap vmap,    // boxes of 64 rows
                          const __grid_constant__ CUtensorMap domap,   // boxes of a step
                          const float* __restrict__ lse2, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                          int Sq_pad, float scale, int causal, int hd, int hdv) {
  using L = Bwd<HDQK, HDV>;
  constexpr int BQ = L::kStep;
  constexpr int NQK = L::kQkBoxes;
  constexpr int NV = L::kVBoxes;
  constexpr int kStages = L::kDkDvStages;
  const int bkh = blockIdx.x;
  const int b = bkh / Hkv;
  const int kh = bkh - b * Hkv;
  const int g = H / Hkv;
  const int k0 = blockIdx.y * kKeys;
  const int wg = threadIdx.x / kWg;
  const int t = threadIdx.x % kWg;
  const int warp = t >> 5;
  const int lane = t & 31;

  extern __shared__ uint8_t smem_raw[];
  // mbarriers: K and V, then each warpgroup's ring stages
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  uint8_t* const k_s = align1024(smem_raw);
  uint8_t* const v_s = k_s + NQK * kBox;
  uint8_t* const ring = k_s + L::kTileBytes;   // [warpgroup][stage]: q boxes, then dO boxes
  float* const stats =                         // [warpgroup][stage]: lse * log2 e, then D
      reinterpret_cast<float*>(ring + L::kRing);
  uint64_t* const full = bars + 1 + wg * kStages;

  // this block's steps: (query head, query tile) over the kv head's g
  // heads and the query tiles at or past the diagonal; warpgroup wg takes
  // steps wg, wg + 2, ...
  const int qt_first = causal ? k0 / BQ : 0;
  const int nq = (Sq + BQ - 1) / BQ - qt_first;
  const int n_mine = (g * nq - wg + 1) / 2;
  auto step_head = [&](int m) { return kh * g + (wg + 2 * m) / nq; };
  auto step_q0 = [&](int m) { return (qt_first + (wg + 2 * m) % nq) * BQ; };
  auto stage_of = [&](int s) { return ring + (wg * kStages + s) * L::kStepBytes; };
  auto stats_of = [&](int s) { return stats + (wg * kStages + s) * 2 * BQ; };

  // step m's q, dO, lse and D into stage m % kStages (the warpgroup's
  // first thread only)
  auto load = [&](int m) {
    const int s = m % kStages;
    const int h = step_head(m);
    const int q0 = step_q0(m);
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq_pad + q0;
    uint8_t* const dst = stage_of(s);
    mbar_expect_tx(&full[s], L::kStepBytes + 2 * BQ * 4);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(dst + bx * L::kStepBox, &qmap, &full[s], bx * kBoxCols, h, q0, b);
#pragma unroll
    for (int bx = 0; bx < NV; ++bx)
      tma_load(dst + (NQK + bx) * L::kStepBox, &domap, &full[s], bx * kBoxCols, h, q0, b);
    bulk_load(stats_of(s), lse2 + row, BQ * 4, &full[s]);
    bulk_load(stats_of(s) + BQ, delta + row, BQ * 4, &full[s]);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], L::kTileBytes);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(k_s + bx * kBox, &kmap, &bars[0], bx * kBoxCols, kh, k0, b);
#pragma unroll
    for (int bx = 0; bx < NV; ++bx)
      tma_load(v_s + bx * kBox, &vmap, &bars[0], bx * kBoxCols, kh, k0, b);
  }
  if (t == 0)
    for (int m = 0; m < kStages && m < n_mine; ++m) load(m);

  const int r0 = warp * 16 + (lane >> 2);   // this thread's key rows: r0, r0 + 8
  const int cq = 2 * (lane & 3);            // its column pair in each chunk
  const float scale2 = scale * kLog2e;
  float dk_acc[NQK][32], dv_acc[NV][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx) dk_acc[bx][i] = 0.f;
#pragma unroll
    for (int bx = 0; bx < NV; ++bx) dv_acc[bx][i] = 0.f;
  }
  // the zeros are defined here, before any wgmma is in flight (else
  // ptxas serializes the products)
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dk_acc[bx]);
#pragma unroll
  for (int bx = 0; bx < NV; ++bx) fence_regs(dv_acc[bx]);
  float st[BQ / 2], dpt[BQ / 2];            // S^T then P^T; dP^T then dS^T
                                            // (each product's first k-step
                                            // writes them: mma_set)
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T as A operands
  const uint32_t k_addr = smem_u32(k_s);
  const uint32_t v_addr = smem_u32(v_s);
  mbar_wait(&bars[0], 0);

  for (int m = 0; m < n_mine; ++m) {
    const int s = m % kStages;
    const int q0 = step_q0(m);
    mbar_wait(&full[s], (m / kStages) & 1);
    const uint32_t q_addr = smem_u32(stage_of(s));
    const uint32_t do_addr = q_addr + NQK * L::kStepBox;
    // S^T = K q^T and dP^T = V dO^T: k-steps of 16 columns, 32 bytes apart
    // in a 128-byte box row
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDQK / 16; ++kk) {
      const uint64_t da = desc_sw128(k_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(q_addr + (kk / 4) * L::kStepBox + (kk % 4) * 32, 16, 1024);
      if (kk == 0) mma_set<T>(st, da, db);
      else mma_ss<T>(st, da, db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk) {
      const uint64_t da = desc_sw128(v_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(do_addr + (kk / 4) * L::kStepBox + (kk % 4) * 32, 16, 1024);
      if (kk == 0) mma_set<T>(dpt, da, db);
      else mma_ss<T>(dpt, da, db, 1);
    }
    wg_commit();
    // the last step's dV and dK are done (groups complete in order): its
    // stage refills while S^T and dP^T run
    wg_wait<1>();
    bar_sync(1 + wg, kWg);
    if (t == 0 && m >= 1 && m - 1 + kStages < n_mine) load(m - 1 + kStages);
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T scale - lse), 0 where masked or past Sk; dS^T =
    // P^T (dP^T - D).  Rows past Sq have lse = +inf, so P^T = 0 there.
    const float* const lse_s = stats_of(s);
    const float* const d_s = lse_s + BQ;
    const bool masked = k0 + kKeys > Sk || (causal && q0 < k0 + kKeys);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 4 * c + 2 * i + e;
          const int col = 8 * c + cq + e;
          float p = exp2f(fmaf(st[at], scale2, -lse_s[col]));
          if (masked) {
            const int key = k0 + r0 + 8 * i;
            if (key >= Sk || (causal && q0 + col < key)) p = 0.f;
          }
          st[at] = p;
          dpt[at] = p * (dpt[at] - d_s[col]);
        }
    to_a<T, BQ>(pa, st);
    to_a<T, BQ>(da, dpt);

    // dV += P^T dO and dK += dS^T q: k-steps of 16 query rows, 2 KB apart,
    // one 64-column box of dO or q (MN-major) at a time
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int bx = 0; bx < NV; ++bx)
        mma_rs<T>(dv_acc[bx], pa[kk],
                  desc_sw128(do_addr + bx * L::kStepBox + kk * 16 * kRowBytes, L::kStepBox, 1024));
#pragma unroll
      for (int bx = 0; bx < NQK; ++bx)
        mma_rs<T>(dk_acc[bx], da[kk],
                  desc_sw128(q_addr + bx * L::kStepBox + kk * 16 * kRowBytes, L::kStepBox, 1024));
    }
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dk_acc[bx]);
#pragma unroll
  for (int bx = 0; bx < NV; ++bx) fence_regs(dv_acc[bx]);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    fence_regs(pa[kk]);
    fence_regs(da[kk]);
  }

  // the second warpgroup's sums join the first's through the rings' bytes,
  // in a fixed order
  __syncthreads();                 // both warpgroups' products are done
  float* const red = reinterpret_cast<float*>(ring);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int bx = 0; bx < NQK; ++bx) red[(bx * 32 + i) * kWg + t] = dk_acc[bx][i];
#pragma unroll
      for (int bx = 0; bx < NV; ++bx) red[((NQK + bx) * 32 + i) * kWg + t] = dv_acc[bx][i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx) dk_acc[bx][i] += red[(bx * 32 + i) * kWg + t];
#pragma unroll
    for (int bx = 0; bx < NV; ++bx) dv_acc[bx][i] += red[((NQK + bx) * 32 + i) * kWg + t];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    if (key >= Sk) continue;
    const size_t row = (static_cast<size_t>(b) * Sk + key) * Hkv + kh;
    T* const dk_row = dk + row * hd;
    T* const dv_row = dv + row * hdv;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int bx = 0; bx < NQK; ++bx)
        if (bx * kBoxCols + 8 * c < hd)   // hd 112 on the 128-wide tiles
          store2<T>(dk_row + bx * kBoxCols + 8 * c + cq, dk_acc[bx][4 * c + 2 * i] * scale,
                    dk_acc[bx][4 * c + 2 * i + 1] * scale);
#pragma unroll
      for (int bx = 0; bx < NV; ++bx)
        if (bx * kBoxCols + 8 * c < hdv)
          store2<T>(dv_row + bx * kBoxCols + 8 * c + cq, dv_acc[bx][4 * c + 2 * i],
                    dv_acc[bx][4 * c + 2 * i + 1]);
    }
  }
}

template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(kWg, 2)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,    // boxes of 64 rows
                        const __grid_constant__ CUtensorMap kmap,    // boxes of a step
                        const __grid_constant__ CUtensorMap vmap,    // boxes of a step
                        const __grid_constant__ CUtensorMap domap,   // boxes of 64 rows
                        const float* __restrict__ lse2, const float* __restrict__ delta,
                        T* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int Sq_pad,
                        float scale, int causal, int hd) {
  using L = Bwd<HDQK, HDV>;
  constexpr int BK = L::kStep;
  constexpr int NQK = L::kQkBoxes;
  constexpr int NV = L::kVBoxes;
  constexpr int kStages = L::kDqStages;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int qt = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  // mbarriers: q and dO, then the K/V stages
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  uint8_t* const q_s = align1024(smem_raw);
  uint8_t* const do_s = q_s + NQK * kBox;
  uint8_t* const ring = q_s + L::kTileBytes;   // [stage]: K boxes, then V boxes
  uint64_t* const full = bars + 1;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, Sq) - 1) / BK + 1);

  auto load = [&](int j) {
    const int s = j % kStages;
    uint8_t* const dst = ring + s * L::kStepBytes;
    mbar_expect_tx(&full[s], L::kStepBytes);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(dst + bx * L::kStepBox, &kmap, &full[s], bx * kBoxCols, kh, j * BK, b);
#pragma unroll
    for (int bx = 0; bx < NV; ++bx)
      tma_load(dst + (NQK + bx) * L::kStepBox, &vmap, &full[s], bx * kBoxCols, kh, j * BK, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], L::kTileBytes);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(q_s + bx * kBox, &qmap, &bars[0], bx * kBoxCols, h, q0, b);
#pragma unroll
    for (int bx = 0; bx < NV; ++bx)
      tma_load(do_s + bx * kBox, &domap, &bars[0], bx * kBoxCols, h, q0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load(j);
  }

  const int r0 = warp * 16 + (lane >> 2);   // this thread's query rows: r0, r0 + 8
  const int cq = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  float lse_r[2], d_r[2];                   // rows past Sq: +inf and 0 (padded)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = static_cast<size_t>(bh) * Sq_pad + q0 + r0 + 8 * i;
    lse_r[i] = lse2[at];
    d_r[i] = delta[at];
  }
  float dq_acc[NQK][32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx) dq_acc[bx][i] = 0.f;
  // the zeros are defined here, before any wgmma is in flight (else
  // ptxas serializes the products)
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dq_acc[bx]);
  float s_[BK / 2], dp[BK / 2];             // S then P; dP then dS
  uint32_t da[BK / 16][4];                  // dS as A operands
  const uint32_t q_addr = smem_u32(q_s);
  const uint32_t do_addr = smem_u32(do_s);
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const int k0 = j * BK;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(ring + s * L::kStepBytes);
    const uint32_t v_addr = k_addr + NQK * L::kStepBox;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDQK / 16; ++kk) {
      const uint64_t da = desc_sw128(q_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(k_addr + (kk / 4) * L::kStepBox + (kk % 4) * 32, 16, 1024);
      if (kk == 0) mma_set<T>(s_, da, db);
      else mma_ss<T>(s_, da, db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk) {
      const uint64_t da = desc_sw128(do_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(v_addr + (kk / 4) * L::kStepBox + (kk % 4) * 32, 16, 1024);
      if (kk == 0) mma_set<T>(dp, da, db);
      else mma_ss<T>(dp, da, db, 1);
    }
    wg_commit();
    // the last step's dQ product is done: its stage refills while S and
    // dP run
    wg_wait<1>();
    __syncthreads();
    if (tid == 0 && j >= 1 && j - 1 + kStages < n_kt) load(j - 1 + kStages);
    wg_wait<0>();
    fence_regs(s_);
    fence_regs(dp);

    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 4 * c + 2 * i + e;
          float p = exp2f(fmaf(s_[at], scale2, -lse_r[i]));
          if (masked) {
            const int key = k0 + 8 * c + cq + e;
            if (key >= Sk || (causal && q0 + r0 + 8 * i < key)) p = 0.f;
          }
          dp[at] = p * (dp[at] - d_r[i]);
        }
    to_a<T, BK>(da, dp);

    // dQ += dS K: k-steps of 16 key rows, one 64-column box of K
    // (MN-major) at a time
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int bx = 0; bx < NQK; ++bx)
        mma_rs<T>(dq_acc[bx], da[kk],
                  desc_sw128(k_addr + bx * L::kStepBox + kk * 16 * kRowBytes, L::kStepBox, 1024));
    wg_commit();
  }
  wg_wait<0>();
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dq_acc[bx]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(da[kk]);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + 8 * i;
    if (qpos >= Sq) continue;
    T* const dq_row = dq + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int bx = 0; bx < NQK; ++bx)
        if (bx * kBoxCols + 8 * c < hd)   // hd 112 on the 128-wide tiles
          store2<T>(dq_row + bx * kBoxCols + 8 * c + cq, dq_acc[bx][4 * c + 2 * i] * scale,
                    dq_acc[bx][4 * c + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// f32 route on the CUDA cores: FA2's schedule, 64 x 64 tiles, thread
// (ty, tx) of 16 x 16 owning rows ty + 16 i and columns tx + 16 j
// ---------------------------------------------------------------------------

// rows [p0, p0 + rows) of one head of a (B, S, heads, HD) f32 tensor ->
// dst[r * ld + c]; rows past S are zero
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, int p0, int rows,
                                          int S, size_t stride) {
  for (int e = threadIdx.x; e < rows * HD; e += kSimtThreads) {
    const int r = e / HD;
    const int c = e - r * HD;
    const int pos = p0 + r;
    dst[r * ld + c] = pos < S ? src[static_cast<size_t>(pos) * stride + c] : 0.f;
  }
}

template <int HD>
constexpr int simt_dkdv_smem() {                // K, V, q, dO; P^T, dS^T; lse, D
  return 4 * (4 * kSimtTile * (HD + 1) + 2 * kSimtTile * (kSimtTile + 1) + 2 * kSimtTile);
}

template <int HD>
constexpr int simt_dq_smem() {                  // q, dO, K, V; dS; lse, D
  return 4 * (4 * kSimtTile * (HD + 1) + kSimtTile * (kSimtTile + 1) + 2 * kSimtTile);
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    bwd_dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                         int Hkv, float scale, int causal) {
  constexpr int T = kSimtTile;
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  const int bkh = blockIdx.x;
  const int b = bkh / Hkv;
  const int kh = bkh - b * Hkv;
  const int g = H / Hkv;
  const int k0 = blockIdx.y * T;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  extern __shared__ float smem_f[];
  float* const k_s = smem_f;
  float* const v_s = k_s + T * LD;
  float* const q_s = v_s + T * LD;
  float* const do_s = q_s + T * LD;
  float* const pt_s = do_s + T * LD;           // P^T: T keys x (T + 1)
  float* const dst_s = pt_s + T * (T + 1);     // dS^T
  float* const lse_s = dst_s + T * (T + 1);
  float* const d_s = lse_s + T;

  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  stage_f32<HD>(k_s, LD, k + kv_base, k0, T, Sk, kv_stride);
  stage_f32<HD>(v_s, LD, v + kv_base, k0, T, Sk, kv_stride);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int q_first = causal ? k0 : 0;
  for (int hi = 0; hi < g; ++hi) {
    const int h = kh * g + hi;
    const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
    for (int q0 = q_first; q0 < Sq; q0 += T) {
      __syncthreads();
      stage_f32<HD>(q_s, LD, q + q_base, q0, T, Sq, q_stride);
      stage_f32<HD>(do_s, LD, dout + q_base, q0, T, Sq, q_stride);
      if (threadIdx.x < T) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < Sq ? lse[row_base + qp] : INFINITY;
        d_s[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = 0.f;
          dpt[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv_[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv_[i] = k_s[(ty + 16 * i) * LD + d];
          vv[i] = v_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * LD + d];
          dov[j] = do_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv_[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + ty + 16 * i;
          const int col = tx + 16 * j;
          const bool keep = key < Sk && !(causal && q0 + col < key);
          const float p = keep ? expf(st[i][j] * scale - lse_s[col]) : 0.f;
          pt_s[(ty + 16 * i) * (T + 1) + col] = p;
          dst_s[(ty + 16 * i) * (T + 1) + col] = p * (dpt[i][j] - d_s[col]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < T; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * (T + 1) + r];
          sv[i] = dst_s[(ty + 16 * i) * (T + 1) + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = do_s[r * LD + tx + 16 * j];
          const float qv = q_s[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const size_t at = kv_base + static_cast<size_t>(key) * kv_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[at + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads)
    bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
                       int causal) {
  constexpr int T = kSimtTile;
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int qt = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * T;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  extern __shared__ float smem_f[];
  float* const q_s = smem_f;
  float* const do_s = q_s + T * LD;
  float* const k_s = do_s + T * LD;
  float* const v_s = k_s + T * LD;
  float* const ds_s = v_s + T * LD;            // dS: T queries x (T + 1)
  float* const lse_s = ds_s + T * (T + 1);
  float* const d_s = lse_s + T;

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(kh) * HD;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * Sq;
  stage_f32<HD>(q_s, LD, q + q_base, q0, T, Sq, q_stride);
  stage_f32<HD>(do_s, LD, dout + q_base, q0, T, Sq, q_stride);
  if (threadIdx.x < T) {
    const int qp = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qp < Sq ? lse[row_base + qp] : INFINITY;
    d_s[threadIdx.x] = qp < Sq ? delta[row_base + qp] : 0.f;
  }

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  int n_kt = (Sk + T - 1) / T;
  if (causal) n_kt = min(n_kt, (min(q0 + T, Sq) - 1) / T + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T;
    __syncthreads();
    stage_f32<HD>(k_s, LD, k + kv_base, k0, T, Sk, kv_stride);
    stage_f32<HD>(v_s, LD, v + kv_base, k0, T, Sk, kv_stride);
    __syncthreads();
    // S and dP: queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv_[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        dov[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv_[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i;
        const int key = k0 + tx + 16 * j;
        const bool keep = key < Sk && !(causal && q0 + row < key);
        const float p = keep ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        ds_s[row * (T + 1) + tx + 16 * j] = p * (dp[i][j] - d_s[row]);
      }
    __syncthreads();
    // dQ += dS K: queries ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * (T + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv_ = k_s[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(sv[i], kv_, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const size_t at = q_base + static_cast<size_t>(qp) * q_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[at + tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename K>
int opt_in(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// HDQK and HDV: the tiles' widths; hd <= HDQK and hdv <= HDV the tensors'
// (hd 112 runs on the 128-wide tiles: the tensor maps' inner extent is
// 112, so the TMA fills columns 112-127 with zeros, which add nothing to
// S or dP, and the kernels store hd or hdv columns)
template <typename T, int HDQK, int HDV>
int launch_tc(const Args& a, int hd, int hdv) {
  using L = Bwd<HDQK, HDV>;
  const int sq_pad = (a.Sq + kPadTo - 1) / kPadTo * kPadTo;
  float* const lse2 = a.delta;
  float* const delta = a.delta + static_cast<size_t>(a.B) * a.H * sq_pad;
  const int rows = a.B * a.Sq * a.H;
  const int pad_rows = a.B * a.H * (sq_pad - a.Sq);
  const long long threads = static_cast<long long>(rows + pad_rows) * (HDV / 8);
  bwd_prep_kernel<T, HDV><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.lse, lse2, delta, rows,
      pad_rows, a.Sq, sq_pad, a.H, hdv);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // boxes of 64 rows (the tiles a block keeps) and of a step (the rings')
  constexpr CUtensorMapDataType type = map_type<T>();
  CUtensorMap q64, qs, k64, ks, v64, vs, do64, dos;
  err = make_map(&q64, type, a.q, hd, a.H, a.Sq, a.B, kRows);
  if (!err) err = make_map(&qs, type, a.q, hd, a.H, a.Sq, a.B, L::kStep);
  if (!err) err = make_map(&k64, type, a.k, hd, a.Hkv, a.Sk, a.B, kKeys);
  if (!err) err = make_map(&ks, type, a.k, hd, a.Hkv, a.Sk, a.B, L::kStep);
  if (!err) err = make_map(&v64, type, a.v, hdv, a.Hkv, a.Sk, a.B, kKeys);
  if (!err) err = make_map(&vs, type, a.v, hdv, a.Hkv, a.Sk, a.B, L::kStep);
  if (!err) err = make_map(&do64, type, a.dout, hdv, a.H, a.Sq, a.B, kRows);
  if (!err) err = make_map(&dos, type, a.dout, hdv, a.H, a.Sq, a.B, L::kStep);
  if (err) return err;

  if ((err = opt_in(bwd_dkdv_wgmma_kernel<T, HDQK, HDV>, L::kDkDvSmem))) return err;
  bwd_dkdv_wgmma_kernel<T, HDQK, HDV>
      <<<dim3(a.B * a.Hkv, (a.Sk + kKeys - 1) / kKeys), 2 * kWg, L::kDkDvSmem, a.stream>>>(
          qs, k64, v64, dos, lse2, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq,
          a.Sk, a.H, a.Hkv, sq_pad, a.scale, a.causal, hd, hdv);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = opt_in(bwd_dq_wgmma_kernel<T, HDQK, HDV>, L::kDqSmem))) return err;
  bwd_dq_wgmma_kernel<T, HDQK, HDV>
      <<<dim3(a.B * a.H, (a.Sq + kRows - 1) / kRows), kWg, L::kDqSmem, a.stream>>>(
          q64, ks, vs, do64, lse2, delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv, sq_pad,
          a.scale, a.causal, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_hd(const Args& a, int hd, int hdv) {
  if (hd == 192 && hdv == 128) return launch_tc<T, 192, 128>(a, hd, hdv);   // MLA
  if ((hd == 128 || hd == 112) && hdv == hd)   // 112: on the 128-wide tiles
    return launch_tc<T, 128, 128>(a, hd, hdv);
  if (hd == 64 && hdv == 64) return launch_tc<T, 64, 64>(a, hd, hdv);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_delta(const Args& a, int hd) {
  const int rows = a.B * a.Sq * a.H;
  constexpr int kWarps = 8;
  bwd_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, rows, a.Sq, a.H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_simt(const Args& a) {
  int err = launch_delta<float>(a, HD);
  if (err) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  constexpr int kDkDv = simt_dkdv_smem<HD>();
  if ((err = opt_in(bwd_dkdv_simt_kernel<HD>, kDkDv))) return err;
  bwd_dkdv_simt_kernel<HD><<<dim3(a.B * a.Hkv, (a.Sk + kSimtTile - 1) / kSimtTile),
                             kSimtThreads, kDkDv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq,
      a.Sk, a.H, a.Hkv, a.scale, a.causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  constexpr int kDq = simt_dq_smem<HD>();
  if ((err = opt_in(bwd_dq_simt_kernel<HD>, kDq))) return err;
  bwd_dq_simt_kernel<HD><<<dim3(a.B * a.H, (a.Sq + kSimtTile - 1) / kSimtTile), kSimtThreads,
                           kDq, a.stream>>>(q, k, v, dout, a.lse, a.delta,
                                            static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.Hkv,
                                            a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the shapes both routes take; the head dims are checked by each route
bool valid(const Args& a) {
  return a.B >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 &&
         (!a.causal || a.Sq == a.Sk) && (a.Sq + kRows - 1) / kRows <= 65535 &&
         (a.Sk + kKeys - 1) / kKeys <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int Sq, int Sk,
               int H, int Hkv, int causal, float scale, void* stream) {
  return Args{q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
              static_cast<float*>(delta), B, Sq, Sk, H, Hkv, scale, causal,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q: (B, Sq, H, hd), k: (B, Sk, Hkv, hd), v: (B, Sk, Hkv, hdv), out and
// dout: (B, Sq, H, hdv), contiguous, in one type; lse: f32 (B, H, Sq),
// K5's; dq, dk, dv: like q, k, v; causal only with Sq == Sk.  Three
// launches on `stream`: D, dK/dV, dQ.
// The f32 route on the CUDA cores (dtype 0; hd == hdv in {64, 128}; delta:
// f32 (B, H, Sq) scratch):
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* delta, int B,
                                          int Sq, int Sk, int H, int Hkv, int hd, int hdv,
                                          int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hkv, causal,
                           scale, stream);
  if (!valid(a) || dtype != 0 || hd != hdv || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return hd == 64 ? launch_simt<64>(a) : launch_simt<128>(a);
}

// The tensor-core route (dtype 1 = bfloat16, 2 = float16; (hd, hdv) in
// {(64, 64), (112, 112), (128, 128), (192, 128)}; q, k, v, out, dout 16-byte aligned;
// delta: f32 scratch of 2 x B x H x Sq rounded up to a multiple of 64):
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             void* dq, void* dk, void* dv, void* delta, int B,
                                             int Sq, int Sk, int H, int Hkv, int hd, int hdv,
                                             int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, out, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, Hkv, causal,
                           scale, stream);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 1:
      return launch_tc_hd<__nv_bfloat16>(a, hd, hdv);
    case 2:
      return launch_tc_hd<__half>(a, hd, hdv);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
