// Hopper (sm_90a) building blocks of the tensor-core kernels: TMA tensor
// maps and tile loads, mbarriers, wgmma shared-memory descriptors and
// products, and the accumulator-to-operand fragment conversion.
//
// Layout every user of this header shares. A bf16 tile of 64 rows by 64
// columns (128 bytes a row) is one "panel" of 8 KB in shared memory, loaded
// by TMA with the 128-byte swizzle and aligned to 1024 bytes; a tile of
// D = 128 columns is two panels (columns 0-63, then 64-127). Such a panel
// is a wgmma operand in either orientation:
//   * K-major (the reduced dimension runs along the 128-byte row): k-step
//     kk of 16 columns starts 32 * kk bytes into the panel; 8-row groups
//     lie 1024 bytes apart (the descriptor's stride byte offset).
//   * MN-major (the reduced dimension runs down the rows, as V or dO in
//     P . V): k-step kk of 16 rows starts 2048 * kk bytes into the panel;
//     8-row groups again 1024 bytes apart; the 64 columns are one swizzle
//     atom, so the leading byte offset is not used.
// All products are wgmma.m64n64k16 with fp32 accumulators: 64 rows (one
// warpgroup of 128 threads) by 64 columns, 32 floats a thread. Thread t of
// warp w holds rows 16w + t/4 and 16w + t/4 + 8, columns 8j + 2(t%4) + {0,1}
// for j < 8: d[4j + e] (row 16w + t/4) and d[4j + 2 + e] (row +8), e < 2.
// That is also the layout of the A operand from registers, so an
// accumulator rounded to bf16 pairs (to_a_frags) feeds the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTile = 64;                       // rows and columns of a panel
constexpr int kPanelBytes = kTile * kTile * 2;  // one bf16 64 x 64 panel

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the runtime hands out its
// address, so the libraries need no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 (outer, rows, cols) tensor, a box of one
// 64 x 64 panel with the 128-byte swizzle. Rows at or past `rows` read as
// zeros, so a tile at the ragged end of one outer index never reaches the
// next one's rows. False if the driver refuses it (a base address or row
// stride that is not a multiple of 16 bytes, among others).
inline bool panel_map(CUtensorMap* map, const void* base, int outer, int rows,
                      int cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {kTile, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map over a bf16 tensor whose rows hold `dims[0]` values: dims
// {dims[0], dims[1], dims[2], dims[3]}, byte strides `strides` of the outer
// three, a box of {64, box[0], box[1], box[2]} with box[0] * box[1] *
// box[2] = 64 rows, so that one box is one panel, with the 128-byte
// swizzle. Coordinates outside a dimension, negative ones too, read as
// zeros. False if cuTensorMapEncodeTiled refuses it (a base address or
// stride that is not a multiple of 16 bytes, among others).
inline bool box_map_4d(CUtensorMap* map, const void* base,
                       const long long (&dims)[4],
                       const long long (&strides)[3], const int (&box)[3]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      box[0] * box[1] * box[2] != kTile)
    return false;
  const cuuint64_t d[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                           (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t b[4] = {kTile, (cuuint32_t)box[0], (cuuint32_t)box[1],
                           (cuuint32_t)box[2]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), d, st, b, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: shared memory, mbarriers, TMA ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 1024); callers allocate 1024 bytes of slack.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); the
// caller then syncs the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Announces `bytes` of TMA traffic without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete. A watchdog turns a
// wait of more than ~2^35 cycles (~17 s), which only a producer/consumer
// mismatch could cause, into a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// One panel of `map` at (col, row, outer) into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load_panel(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int col,
                                               int row, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(outer)
      : "memory");
}

// One box of the 4-D `map` at (c0, c1, c2, c3) into `dst`; completes on
// `bar`.
__device__ __forceinline__ void tma_load_box_4d(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Asks TMA to bring one box of the 4-D `map` at (c0, c1, c2, c3) into L2,
// so that later ordinary loads of it find it there; nothing waits on it.
__device__ __forceinline__ void tma_prefetch_box_4d(const CUtensorMap* map,
                                                    int c0, int c1, int c2,
                                                    int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, "
      "%4}];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// Synchronises the `threads` threads (a multiple of 32) that reach named
// barrier `id` (1..15; 0 is __syncthreads'), e.g. the consumer warpgroups
// once the producer warp has left.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- device: wgmma ---------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at `p`:
// start address, leading byte offset (16, unused by these layouts), stride
// byte offset 1024 (the next 8-row group), swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A descriptor `bytes` further on (bytes a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the (volatile) wgmma fence, commit and wait statements.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A . B^T over 16 of the reduced dimension: A (64 x 16) and B
// (64 x 16) both K-major in shared memory by default; kTransA / kTransB =
// 1 reads A / B MN-major instead (the 64 rows of M or N along the 128-byte
// row, k-step kk 2048 * kk bytes in). accumulate = 0 overwrites d.
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d += A . B over 16 of the reduced dimension: A (64 x 16 bf16) from
// registers in the accumulator layout (to_a_frags), B (16 x 64) MN-major in
// shared memory (the transpose-B flag).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Makes this thread's ordinary writes to shared memory visible to the async
// proxy (wgmma, TMA); a barrier of the writers then publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator's 64 columns rounded once to bf16, as the A operands of
// four k-steps of 16: a[kk] holds columns 16kk .. 16kk + 15.
__device__ __forceinline__ void to_a_frags(const float (&d)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

}  // namespace hopper
