// Hopper (sm_90a) building blocks shared by flash_fwd_sm90.cu and
// flash_bwd_sm90.cu: mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and the three wgmma shapes the flash kernels use, written as
// inline PTX. Host side: the TMA tensor maps, encoded by
// cuTensorMapEncodeTiled looked up at run time (no -lcuda link).
//
// Tiles. Every tile the kernels stage is 64 rows (sequence positions) of a
// (rows, D) bf16 matrix, loaded by TMA with the hardware swizzle that wgmma
// reads. A tile is cut along D into column blocks ("atoms") as wide as the
// swizzle span: D 32 -> one 64-byte-swizzled block; D 64 -> one
// 128-byte-swizzled block; D 128 -> two 128-byte-swizzled blocks, one after
// the other. Within a block, row r sits at r * span bytes and its 16-byte
// chunks are permuted by the swizzle. Blocks start 1024-byte aligned.
//
// The same tile serves as a K-major operand (the product's K axis is D: Q and
// K in q k^T) and as an MN-major one (the product's K axis is the rows, its N
// axis is D: V in p v, dO in p^T dO, Q in ds^T q, K in ds k), by descriptor.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTileRows = 64;  // rows of every staged tile

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int kAtomCols = D < 64 ? D : 64;      // bf16 per swizzle row
  static constexpr int kSpan = kAtomCols * 2;            // 64 or 128 bytes
  static constexpr int kAtoms = D / kAtomCols;           // 1 or 2
  static constexpr int kAtomBytes = kTileRows * kSpan;   // one column block
  static constexpr int kBytes = kTileRows * D * 2;       // the whole tile
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : 2;  // wgmma B128/B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// rows [row0, row0 + 64) of matrix `bh` of a (bh, t, D) tensor into `dst`;
// rows past t arrive as zeros. Completes Tile<D>::kBytes on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int a = 0; a < Tile<D>::kAtoms; ++a)
    tma_load_3d(dst + a * Tile<D>::kAtomBytes, map, bar,
                a * Tile<D>::kAtomCols, row0, bh);
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: the tile's D axis is the product's K; k-step kk reads
// columns [16 kk, 16 kk + 16) of all 64 rows (8-row groups 8 spans apart).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<D>;
  const uint32_t addr = tile + (16 * kk / L::kAtomCols) * L::kAtomBytes +
                        (16 * kk % L::kAtomCols) * 2;
  return make_desc(addr, 16, 8 * L::kSpan, L::kLayout);
}

// MN-major operand: the tile's rows are the product's K (k-step kk reads
// rows [16 kk, 16 kk + 16)), its D columns of block h the product's N.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int h) {
  using L = Tile<D>;
  const uint32_t addr = tile + h * L::kAtomBytes + 16 * kk * L::kSpan;
  return make_desc(addr, L::kAtomBytes, 8 * L::kSpan, L::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching registers a wgmma still owns: reads after
// the wait depend on this, and the values stay live until it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_D16(i) SM90_D4(i), SM90_D4(i + 4), SM90_D4(i + 8), SM90_D4(i + 12)

// d[32] (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D16(0), SM90_D16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D16(0), SM90_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[16] += A (64 x 16, registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_D16
#undef SM90_D4

// acc[D/2] += A (64 x 16 registers) * rows [16 kk, 16 kk + 16) of an
// MN-major tile, all D columns
template <int D>
__device__ __forceinline__ void mma_rs_tile(float* acc, const uint32_t* a,
                                            uint32_t tile, int kk) {
  if constexpr (D == 32) {
    wgmma_rs_n32(acc, a, desc_mn<D>(tile, kk, 0));
  } else {
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
      wgmma_rs_n64(acc + 32 * h, a, desc_mn<D>(tile, kk, h));
  }
}

// s[32] = rows of tile a (64 x D, K-major) times rows of tile b, transposed
template <int D>
__device__ __forceinline__ void mma_ss_tiles(float* s, uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<D>(a, kk), desc_k<D>(b, kk), kk > 0);
}

// Accumulator layout of m64nN f32 (thread = warp w, lane l of the
// warpgroup): d[i] is row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). The same registers, packed in pairs,
// are the A fragment of the next product: k-step kk of an (64 x 64) score
// tile is d[8 kk .. 8 kk + 7].
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// a[16]: the bf16 A fragments of the 4 k-steps of a (64 x 64) f32 tile
__device__ __forceinline__ void to_a_frags(const float* d, uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a contiguous bf16 (bh, t, D) tensor, in 64-row tiles of
// Tile<D> blocks. 0 on success.
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int t, int bh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorInitializationError);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(t) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<D>::kAtomCols),
                             static_cast<cuuint32_t>(kTileRows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<D>::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
