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
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 64;              // query rows per block (one warpgroup)
constexpr int kBN = 64;              // key positions per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;           // K/V ring depth
constexpr int kBoxCols = 64;         // a 128-byte swizzled row of 16-bit values
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map, coordinates innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight; groups
// complete in the order they were committed.  N is a constant, so ptxas
// can follow the pipeline and keep the wgmmas asynchronous.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// wait: the accumulators are written asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64,
// K-major in shared memory)
#define WGMMA_SS(TY)                                                               \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32 \
               ", %32, %33, p, 1, 1, 0, 0;\n\t}"                                    \
               : WG_OUT32(d)                                                        \
               : "l"(da), "l"(db), "r"(scale_d))

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, MN-major in
// shared memory: the V tile's rows are key positions)
#define WGMMA_RS(TY)                                                                         \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"                             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32           \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"                                \
               : WG_OUT32(d)                                                                  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_SS("bf16");
  } else {
    WGMMA_SS("f16");
  }
}

template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_RS("bf16");
  } else {
    WGMMA_RS("f16");
  }
}

// (a, b) -> the 16-bit pair hi = T(a, b) and lo = T(a - hi, b - hi), as
// wgmma A-operand registers (the lower column in the low half)
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B, S, heads, hd) contiguous 16-bit tensor -> a map of 64 x 64 boxes over
// (hd, heads, S, B), 128-byte swizzle, zeros past every edge (columns past
// hd too: the map's inner extent is hd, the boxes tile the kernel's width).  The strides
// (2 hd bytes and up) are multiples of 16 for hd % 8 == 0.
int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int hd, int heads,
             int seq, int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(seq) * heads * hd * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HDQK, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int hd, int hdv, float scale, int causal, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, type, q, hd, H, Sq, B);
  if (!err) err = make_map(&km, type, k, hd, Hkv, Sk, B);
  if (!err) err = make_map(&vm, type, v, hdv, Hkv, Sk, B);
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
