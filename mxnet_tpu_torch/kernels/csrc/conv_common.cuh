// Tile code shared by the fused convolution kernels for Hopper (sm_90a):
// fused_conv_fwd.cu (B1), fused_conv_wgrad.cu (B2) and fused_conv_dgrad.cu
// (B3). Each is an implicit GEMM on the fp32 CUDA cores with one CTA of 256
// threads per 64 x 64 output tile and K staged through shared memory in
// chunks of 32. The threads form a 16 x 16 grid: thread (ty, tx) owns tile
// rows 4*ty .. 4*ty+3 and columns tx + 16*j (j < 4), so a half warp reads
// the B chunk from distinct banks and the A chunk as a broadcast. The A
// chunk is stored K-major with a padded row of 65 floats.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;    // tile rows per CTA
constexpr int kTileN = 64;    // tile columns per CTA
constexpr int kChunk = 32;    // K per shared-memory stage
constexpr int kThreads = 256;
constexpr int kAStride = kTileM + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round an f32 value to T and back (the compute dtype's rounding)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// BatchNorm-apply (+ ReLU) of one input value, rounded like the plain
// version: a rounded multiply, then a rounded add, then the cast to T
template <typename T>
__device__ __forceinline__ float bn_apply(float v, float scale, float bias,
                                          int relu) {
  v = __fadd_rn(__fmul_rn(v, scale), bias);
  if (relu) v = fmaxf(v, 0.f);
  return round_to(v, (T*)nullptr);
}

// dL/dy rebuilt from the relu-masked partial e and the raw conv output y
// of the BatchNorm after it: k * (e - m0 - xhat * m1), xhat = (y - mu) *
// inv, in f32 with each step rounded as the plain version rounds it, then
// cast to T (the TPU kernel's `_bnbwd_value` and the cast before the dot)
template <typename T>
__device__ __forceinline__ float bn_backward(float e, float y, float k,
                                             float mu, float inv, float m0,
                                             float m1) {
  const float xhat = __fmul_rn(__fsub_rn(y, mu), inv);
  const float v =
      __fmul_rn(k, __fsub_rn(__fsub_rn(e, m0), __fmul_rn(xhat, m1)));
  return round_to(v, (T*)nullptr);
}

// acc[i][j] += sum over the chunk's kc of A[kc][4*ty + i] * B[kc][tx + 16*j]
// with A at as[kc * kAStride + row] and B at bs[kc * kBStride + col]
template <int kBStride>
__device__ __forceinline__ void tile_fma(const float* as, const float* bs,
                                         int ty, int tx, float (&acc)[4][4]) {
#pragma unroll 8
  for (int kc = 0; kc < kChunk; ++kc) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = as[kc * kAStride + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bs[kc * kBStride + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Per-CTA column sums of two per-thread values: the 16 thread rows of each
// tile column added in row order into row `block` of `partial` (rows of
// 2 * cols floats: the first sums, then the second), through `red`, a
// shared buffer of at least 2 * 16 * kTileN floats. Ends the CTA's use of
// `red`; callers synchronise before reusing it.
__device__ __forceinline__ void tile_column_sums(
    float* red, const float (&a)[4], const float (&b)[4], int ty, int tx,
    int tid, float* partial, int block, int c0, int cols) {
  __syncthreads();  // red may alias the A/B chunks
  float* red_a = red;
  float* red_b = red + 16 * kTileN;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_a[ty * kTileN + tx + 16 * j] = a[j];
    red_b[ty * kTileN + tx + 16 * j] = b[j];
  }
  __syncthreads();
  if (tid < kTileN && c0 + tid < cols) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < 16; ++r) {
      sa += red_a[r * kTileN + tid];
      sb += red_b[r * kTileN + tid];
    }
    float* p = partial + (size_t)block * 2 * cols;
    p[c0 + tid] = sa;
    p[cols + c0 + tid] = sb;
  }
}

// out[i] = sum over r < rows of partial[r * len + i], in row order: the
// second pass of every cross-CTA reduction (no atomics, so the same sums
// on every run)
__global__ void sum_rows_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int rows, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float a = 0.f;
  for (int r = 0; r < rows; ++r) a += partial[(size_t)r * len + i];
  out[i] = a;
}

inline cudaError_t sum_rows(const float* partial, float* out, int rows,
                            int len, cudaStream_t stream) {
  const int threads = 256;
  sum_rows_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      partial, out, rows, len);
  return cudaGetLastError();
}

}  // namespace
