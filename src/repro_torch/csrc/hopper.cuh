// Hopper (sm_90a) building blocks shared by K5's tensor-core forward
// (flash_attention_tc.cu) and K5b's tensor-core backward
// (flash_attention_bwd.cu): mbarriers, TMA loads (tensor and 1-D bulk),
// wgmma descriptors and products on 128-byte-swizzled tiles, 16-bit
// packing, and the host-side tensor maps.
//
// A tile of 16-bit values is stored as boxes of 64 columns: one
// 128-byte row a position, swizzled in 8-row (1024-byte) groups, the
// layout a TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes and a wgmma
// descriptor with layout type 1 reads.  Read with rows as the product's
// M or N (K-major), a k-step of 16 columns is 32 bytes further along the
// row; read with rows as the reduction axis (MN-major, the descriptor's
// transpose bit), a k-step of 16 rows is 2048 bytes further down.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBoxCols = 64;         // a 128-byte swizzled row of 16-bit values
constexpr int kRowBytes = 128;

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

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a named barrier over `count` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
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

#define WG_D16                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define WG_D32                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WG_SET16(d)                                                                         \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),        \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), \
      "=f"(d[14]), "=f"(d[15])
#define WG_SET32(d)                                                                         \
  WG_SET16(d), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), \
      "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),          \
      "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64,
// K-major in shared memory)
#define WGMMA_SS64(TY)                                                             \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32 \
               ", %32, %33, p, 1, 1, 0, 0;\n\t}"                                    \
               : WG_OUT32(d)                                                        \
               : "l"(da), "l"(db), "r"(scale_d))

// d (64 x 32, f32) (+)= A (64 x 16, K-major) . B (16 x 32, K-major)
#define WGMMA_SS32(TY)                                                             \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"                   \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " WG_D16 \
               ", %16, %17, p, 1, 1, 0, 0;\n\t}"                                    \
               : WG_OUT16(d)                                                        \
               : "l"(da), "l"(db), "r"(scale_d))

// d = A . B, the first k-step of a product whose accumulators only wgmma
// writes: the outputs are write-only ("=f"), so d is not carried over from
// its last use, and no other instruction defines its registers while an
// earlier product is in flight (which makes ptxas serialize the wgmmas)
#define WGMMA_SET64(TY)                                                            \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"                   \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32 \
               ", %32, %33, p, 1, 1, 0, 0;\n\t}"                                    \
               : WG_SET32(d)                                                        \
               : "l"(da), "l"(db), "r"(0))
#define WGMMA_SET32(TY)                                                            \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"                   \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " WG_D16 \
               ", %16, %17, p, 1, 1, 0, 0;\n\t}"                                    \
               : WG_SET16(d)                                                        \
               : "l"(da), "l"(db), "r"(0))

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, MN-major in
// shared memory: the tile's rows are the reduction axis)
#define WGMMA_RS(TY)                                                                         \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"                             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_D32           \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"                                \
               : WG_OUT32(d)                                                                  \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_SS64("bf16");
  } else {
    WGMMA_SS64("f16");
  }
}

template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_SS32("bf16");
  } else {
    WGMMA_SS32("f16");
  }
}

template <typename T>
__device__ __forceinline__ void mma_set(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_SET64("bf16");
  } else {
    WGMMA_SET64("f16");
  }
}

template <typename T>
__device__ __forceinline__ void mma_set(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_SET32("bf16");
  } else {
    WGMMA_SET32("f16");
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

// (a, b) -> T(a), T(b) packed as one wgmma A-operand register (a in the
// low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no -lcuda)
inline EncodeTiled encode_tiled() {
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

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// (B, S, heads, hd) contiguous 16-bit tensor -> a map of 64-column boxes of
// `box_rows` positions over (hd, heads, S, B), 128-byte swizzle, zeros past
// every edge (columns past hd too: the map's inner extent is hd, the boxes
// tile the kernel's width).  The strides (2 hd bytes and up) are multiples
// of 16 for hd % 8 == 0.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int hd,
                    int heads, int seq, int batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(seq) * heads * hd * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
