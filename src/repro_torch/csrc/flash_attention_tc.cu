// Flash attention (forward) on Hopper's tensor cores (sm_90a): K5's route
// for bf16 and fp16 inputs at hd in {64, 112, 128}, and at a q.k head dim
// of 192 with a v head dim of 128 (deepseek-v2's MLA prefill: 128 nope +
// 64 rope columns, v 128).  (f32, and hd in {16, 32}, take the f32 SIMT
// kernel of flash_attention.cu.)
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel) and computes what flash_attention.cu computes:
// softmax(q k^T / sqrt(dqk)) v per query head, GQA (query head h reads kv
// head h / g), the top-left-aligned causal mask (qpos >= kpos) with masked
// scores at -1e30, key positions past Sk at -inf, an online softmax in f32,
// p kept at f32 precision for p . v, and acc / max(l, 1e-30) in q's dtype;
// any Sq and Sk >= 1.  Where the caller passes an lse buffer (the training
// forward), each row's natural-log logsumexp of its scaled scores, m +
// log(l), goes there as f32 (B, H, Sq): the scores are in natural units and
// only the exponent folds in log2 e, so no conversion is needed.  The serve
// path passes null.
//
// Bound on this card: at qwen2.5-3b's whole-prompt admit (B 1, S 1024,
// H 16, Hkv 2, hd 128, bf16, causal) the work is 4.29 GFLOP (4.3 us at the
// tensor cores' 989 TFLOP/s) against 9.4 MB (2.8 us): operations bind, and
// only wgmma reaches that rate.  The design:
//   * q k^T on wgmma (m64n64k16, f32 accumulators, A and B from shared
//     memory).  Products of two bf16 (or fp16) values are exact in f32, so
//     this is the TPU kernel's f32 dot up to the order of the sum.
//   * p . v on wgmma with p at f32 precision: p is split into two 16-bit
//     parts, p_hi = T(p) and p_lo = T(p - float(p_hi)), and two wgmmas
//     (A from registers, B the V tile in shared memory, transposed) add
//     p_hi v and p_lo v into one f32 accumulator.  p_hi + p_lo keeps p to
//     about 2^-16 relative (bf16), against 2^-8 for p rounded to bf16; the
//     price is 1.5x the MMA work of plain flash attention.  The score
//     accumulator of q k^T already has the register layout of wgmma's A
//     operand (FlashAttention-3's observation), so p never passes through
//     shared memory.  l sums the f32 p, as the TPU kernel does.
//   * q, K and V tiles arrive by TMA (cp.async.bulk.tensor, 4-D tensor maps
//     over (hd, heads, positions, batch) so a box reads one head's rows at
//     stride heads * hd, 128-byte swizzle: the layout wgmma's descriptors
//     read).  A 128-byte row holds 64 values, so hd 128 takes two boxes a
//     tile.  hd 112 (zamba2's shared block) runs on the hd-128 tiles: the
//     tensor maps carry the true inner extent, 112, so the second box of a
//     row reads columns 64-127 and the TMA fills 112-127 with zeros.  Those
//     columns add 0 to q k^T and make O's columns 112-127 zero, which are
//     never stored.  The price is 128/112 of the MMA work of an exact tile.
//     MLA's (192, 128) takes three boxes a q or K row and two a V row: the
//     kernel is templated on the two widths (HDQK, HDV), q K^T runs
//     HDQK / 16 k-steps, O is HDV wide, and the K and the V ring each
//     count their own bytes on their mbarriers.  K and V go through rings
//     of two stages each, one mbarrier a stage, so a K stage is refilled as soon as its q K^T is done and a V
//     stage as soon as its p . v is: tiles j + 1 and j + 2 load while tile
//     j computes.  q loads once.
//   * inside the warpgroup the tensor cores and the softmax overlap, in
//     FlashAttention-3's order: issue q K^T of tile j + 1, rescale O, issue
//     p . v of tile j, wait for q K^T and do tile j + 1's softmax while
//     p . v runs, wait for p . v, and only then split the new p into the
//     A-operand registers.  No register a wgmma in flight reads or writes
//     is touched, and the wait counts are constants, so ptxas keeps the
//     wgmmas asynchronous.
//   * one warpgroup (128 threads) a block owns 64 query rows; each thread
//     holds rows r and r + 8 of its warp's 16, and row max and row sum
//     reduce over the four lanes that share a row.  A kv tile is 64 wide,
//     so S and p take 32 + 32 registers, and O 64 at a v width of 128
//     (hd 128, and MLA's 192 / 128 alike).
//   * TMA fills rows past Sq or Sk with zeros; a zero K row would score 0,
//     so key positions >= Sk are masked to -inf here, and rows >= Sq are
//     computed and never stored (the output is written from registers).
//     Tiles that need no mask skip the mask arithmetic.
//   * schedule: as in flash_attention.cu, kv tiles wholly above the
//     diagonal are skipped and the heaviest query tiles are launched first
//     (grid.y is the reversed query-tile index).  81 KB of shared memory
//     at hd 128 (105 KB at 192 / 128) lets two blocks share an SM, so the
//     256 blocks of the qwen admit shape all run in one wave, and one
//     block's softmax also overlaps the other's MMAs.  The pairing (i, n - 1 - i) would even out the blocks'
//     work but halve their number: at the admit shape one block an SM,
//     with no second block to overlap.  Heaviest-first keeps one query
//     tile a block and any Sq; it does not even out the SMs' work.
// The tensor maps are built on the host with cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ kernel parameters; those helpers, the barriers and the
// wgmma wrappers live in hopper.cuh, shared with K5b's backward.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64;              // query rows per block (one warpgroup)
constexpr int kBN = 64;              // key positions per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;           // K/V ring depth
constexpr int kBoxBytes = 64 * 128;  // one 64-row box
constexpr float kNeg = -1e30f;       // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

template <int HDQK, int HDV>
struct Layout {
  static constexpr int kQkBoxes = HDQK / kBoxCols;
  static constexpr int kVBoxes = HDV / kBoxCols;
  static constexpr int kQkTile = kQkBoxes * kBoxBytes;         // a q or K tile
  static constexpr int kVTile = kVBoxes * kBoxBytes;           // a V tile
  static constexpr int kSmem =
      kQkTile * (1 + kStages) + kVTile * kStages + 1024;       // + alignment
};

// Register layout of a 64 x 64 f32 accumulator d[32] (and of S): thread t
// of the warpgroup, warp w = t / 32, lane l, holds rows 16 w + l / 4 (i = 0)
// and 16 w + l / 4 + 8 (i = 1), columns 8 c + 2 (l % 4) + e (e = 0, 1) of
// each 8-column chunk c, at d[4 c + 2 i + e].  The A operand of k-step kk
// (columns 16 kk .. 16 kk + 15) is {d[8kk..8kk+1], d[8kk+2..+3],
// d[8kk+4..+5], d[8kk+6..+7]} packed in pairs: chunks 2 kk and 2 kk + 1.
// HDQK and HDV are the widths of the q / K and of the V tiles; hdv <= HDV
// the tensors' v head dim (columns hdv .. HDV - 1 of every tile arrive as
// zeros and are not stored; likewise q and K's columns past their head dim).
template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(kThreads, 2)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, T* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hdv, float scale,
                    int causal) {
  using L = Layout<HDQK, HDV>;
  constexpr int NQK = L::kQkBoxes;
  constexpr int NB = L::kVBoxes;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / Hkv);
  const int qt = causal ? static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  // mbarriers: q, then K stages, then V stages
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  uint8_t* const q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const k_s = q_s + L::kQkTile;               // kStages K tiles
  uint8_t* const v_s = k_s + kStages * L::kQkTile;     // kStages V tiles
  uint64_t* const k_bar = bars + 1;
  uint64_t* const v_bar = bars + 1 + kStages;

  int n_kt = (Sk + kBN - 1) / kBN;
  if (causal) n_kt = min(n_kt, (min(q0 + kBM, Sq) - 1) / kBN + 1);

  // tile j of K (or V) into its stage j % kStages (thread 0 only); each
  // ring's mbarrier expects its own tile's bytes
  auto load_k = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&k_bar[st], L::kQkTile);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(k_s + st * L::kQkTile + bx * kBoxBytes, &kmap, &k_bar[st], bx * kBoxCols, kh,
               j * kBN, b);
  };
  auto load_v = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&v_bar[st], L::kVTile);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
      tma_load(v_s + st * L::kVTile + bx * kBoxBytes, &vmap, &v_bar[st], bx * kBoxCols, kh,
               j * kBN, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], L::kQkTile);
#pragma unroll
    for (int bx = 0; bx < NQK; ++bx)
      tma_load(q_s + bx * kBoxBytes, &qmap, &bars[0], bx * kBoxCols, h, q0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) {
      load_k(j);
      load_v(j);
    }
  }

  const int r0 = warp * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane & 3);            // its column pair in each chunk
  float o[NB][32];
  float s[32];                              // S, then p in f32, of one tile
  uint32_t p[2][kBN / 16][4];               // p_hi and p_lo as A operands
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) o[bx][i] = 0.f;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};                  // this thread's share of the row sums
  float alpha[2] = {1.f, 1.f};              // O's rescale for the tile in hand
  const uint32_t q_addr = smem_u32(q_s);

  // S = q K^T of tile j, issued asynchronously: HDQK / 16 k-steps, 32 bytes
  // apart inside a 128-byte box row.  Past the last tile (j == n_kt) it
  // multiplies whatever the stage holds into an S nobody reads, so that
  // every step commits the same groups and the waits stay constants.
  auto issue_s = [&](int j) {
    if (j < n_kt) mbar_wait(&k_bar[j % kStages], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(k_s + (j % kStages) * L::kQkTile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDQK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      mma_ss<T>(s, desc_sw128(q_addr + off, 16, 1024), desc_sw128(k_addr + off, 16, 1024),
                kk > 0);
    }
    wg_commit();
  };

  // tile j's scores -> p = exp(s - m) in f32, in place; m, l and alpha
  auto softmax = [&](int j) {
    const int k0 = j * kBN;
    const bool ragged = k0 + kBN > Sk;
    const bool diagonal = causal && k0 + kBN - 1 > q0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sc = s[4 * c + 2 * i + e] * scale;
          if (ragged || diagonal) {
            const int kpos = k0 + 8 * c + cq + e;
            if (kpos >= Sk) sc = -INFINITY;
            else if (causal && q0 + r0 + 8 * i < kpos) sc = kNeg;
          }
          s[4 * c + 2 * i + e] = sc;
          mx[i] = fmaxf(mx[i], sc);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f((s[4 * c + 2 * i + e] - m_new) * kLog2e);
          s[4 * c + 2 * i + e] = pe;
          sum += pe;
        }
      }
      l[i] = l[i] * alpha[i] + sum;
    }
  };

  // p (f32, in s) -> p_hi and p_lo, the A operands of k-step kk: the
  // columns 16 kk .. 16 kk + 15 are chunks 2 kk and 2 kk + 1
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = 4 * (2 * kk + half) + 2 * i;
          split2<T>(s[at], s[at + 1], p[0][kk][2 * half + i], p[1][kk][2 * half + i]);
        }
  };

  // O += p_hi V + p_lo V: k-steps of 16 key rows (2 KB apart), one
  // 64-column box of V at a time
  auto issue_pv = [&](int j) {
    mbar_wait(&v_bar[j % kStages], (j / kStages) & 1);
    const uint32_t v_addr = smem_u32(v_s + (j % kStages) * L::kVTile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const uint64_t db = desc_sw128(v_addr + bx * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024);
        mma_rs<T>(o[bx], p[0][kk], db);
        mma_rs<T>(o[bx], p[1][kk], db);
      }
    }
    wg_commit();
  };

  mbar_wait(&bars[0], 0);
  issue_s(0);
  wg_wait<0>();
  fence_regs(s);
  __syncthreads();
  if (tid == 0 && kStages < n_kt) load_k(kStages);
  softmax(0);
  split_p();
  // Tile j: S(j + 1) and p . v of tile j run on the tensor cores while
  // this warpgroup does tile j + 1's softmax (FlashAttention-3's overlap
  // inside one warpgroup).  The p registers are rewritten only once no
  // wgmma is in flight.
  for (int j = 0; j < n_kt; ++j) {
    issue_s(j + 1);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[bx][4 * c + 2 * i] *= alpha[i];
          o[bx][4 * c + 2 * i + 1] *= alpha[i];
        }
    issue_pv(j);
    wg_wait<1>();                 // S(j + 1) is done; its K stage is free
    fence_regs(s);
    __syncthreads();
    if (tid == 0 && j + 1 + kStages < n_kt) load_k(j + 1 + kStages);
    if (j + 1 < n_kt) softmax(j + 1);
    wg_wait<0>();                 // p . v of tile j is done; its V stage is free
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_regs(o[bx]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      fence_regs(p[0][kk]);
      fence_regs(p[1][kk]);
    }
    __syncthreads();
    if (tid == 0 && j + kStages < n_kt) load_v(j + kStages);
    split_p();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t row_stride = static_cast<size_t>(H) * hdv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + 8 * i;
    if (qpos >= Sq) continue;
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Sq + qpos] = m[i] + logf(l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * Sq + qpos) * row_stride +
              static_cast<size_t>(h) * hdv;
#pragma unroll
    for (int bx = 0; bx < NB; ++bx)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (bx * kBoxCols + 8 * c < hdv)   // hdv is a multiple of 8
          store2<T>(orow + bx * kBoxCols + 8 * c + cq, o[bx][4 * c + 2 * i] * inv,
                    o[bx][4 * c + 2 * i + 1] * inv);
  }
}

template <typename T, int HDQK, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int hd, int hdv, float scale, int causal, cudaStream_t stream) {
  constexpr CUtensorMapDataType type = map_type<T>();
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, type, q, hd, H, Sq, B, kBM);
  if (!err) err = make_map(&km, type, k, hd, Hkv, Sk, B, kBN);
  if (!err) err = make_map(&vm, type, v, hdv, Hkv, Sk, B, kBN);
  if (err) return err;
  const int smem = Layout<HDQK, HDV>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<T, HDQK, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_tc_kernel<T, HDQK, HDV><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<T*>(out), lse, Sq, Sk, H, Hkv, hdv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
              int Sk, int H, int Hkv, int hd, int hdv, float scale, int causal,
              cudaStream_t stream) {
  if (hd == 192 && hdv == 128)  // MLA: q . k over 128 nope + 64 rope columns
    return launch<T, 192, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal, stream);
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal, stream);
    case 112:  // on the hd-128 tiles, columns 112-127 zero-filled by the TMA
    case 128:
      return launch<T, 128, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal,
                                 stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (q, k, v and out alike); q: (B, Sq, H,
// hd), k: (B, Sk, Hkv, hd), v: (B, Sk, Hkv, hdv), out: (B, Sq, H, hdv),
// contiguous, 16-byte aligned; (hd, hdv) in {(64, 64), (112, 112), (128,
// 128), (192, 128)}; lse null or f32 (B, H, Sq).  The arguments are
// flash_attention_launch's.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int Sq, int Sk, int H, int Hkv, int hd,
                                         int hdv, int causal, int dtype, float scale,
                                         void* stream) {
  float* const lse_f = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv || (Sq + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, lse_f, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal,
                                      st);
    case 2:
      return launch_hd<__half>(q, k, v, out, lse_f, B, Sq, Sk, H, Hkv, hd, hdv, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
