// Tile code shared by the fused convolution kernels for Hopper (sm_90a):
// fused_conv_fwd.cu (B1), fused_conv_wgrad.cu (B2) and fused_conv_dgrad.cu
// (B3). First the CUDA-core kernels' (fp32, and bf16 shapes TMA cannot
// load): an implicit GEMM on the fp32 CUDA cores with one CTA of 256
// threads per 64 x 64 output tile and K staged through shared memory in
// chunks of 32. The threads form a 16 x 16 grid: thread (ty, tx) owns tile
// rows 4*ty .. 4*ty+3 and columns tx + 16*j (j < 4), so a half warp reads
// the B chunk from distinct banks and the A chunk as a broadcast. The A
// chunk is stored K-major with a padded row of 65 floats.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

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
// version: a rounded multiply, then a rounded add, then the cast to T. The
// ReLU passes a NaN on, as jnp.maximum does (fmaxf alone would return 0)
template <typename T>
__device__ __forceinline__ float bn_apply(float v, float scale, float bias,
                                          int relu) {
  v = __fadd_rn(__fmul_rn(v, scale), bias);
  if (relu && v == v) v = fmaxf(v, 0.f);
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

// out[i] = sum over r < rows of partial[r * stride + i], in row order.
__global__ void sum_rows_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int rows, int len,
                                long long stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float a = 0.f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) a += partial[(size_t)r * stride + i];
  out[i] = a;
}

constexpr int kGroupRows = 64;  // rows a block of sum_group_kernel adds

// In place: the rows [g * kGroupRows, + kGroupRows) of group g = blockIdx.y
// added in row order into that group's first row, for 32 columns a block.
// Thread (x, y) of the 32 x 8 block adds the rows y, y + 8, ... of its
// column; the 8 sums are then added in y order. No other block reads
// these rows, so the first row can take the result.
__global__ void sum_group_kernel(float* __restrict__ partial, int rows,
                                 int len) {
  __shared__ float part[8][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * kGroupRows;
  const int r1 = min(rows, r0 + kGroupRows);
  float a = 0.f;
  if (i < len)
#pragma unroll 8
    for (int r = r0 + threadIdx.y; r < r1; r += 8)
      a += partial[(size_t)r * len + i];
  part[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && i < len) {
    float t = 0.f;
    for (int y = 0; y < 8; ++y) t += part[y][threadIdx.x];
    partial[(size_t)r0 * len + i] = t;
  }
}

// out[i] = sum over r < rows of partial[r * len + i]: the second pass of
// every cross-CTA reduction (no atomics, and for given rows and len the
// same order of sums on every run). Many rows (a stats row per pixel tile:
// 3136 at ResNet-50's first stage at batch 64) are first added in groups
// of kGroupRows, in place and spread over many blocks, then the group
// sums; one thread a column over every row would leave the card nearly
// idle. `partial` is overwritten.
inline cudaError_t sum_rows(float* partial, float* out, int rows, int len,
                            cudaStream_t stream) {
  int step = 1;
  if (rows > kGroupRows) {
    const dim3 grid((len + 31) / 32, (rows + kGroupRows - 1) / kGroupRows);
    sum_group_kernel<<<grid, dim3(32, 8), 0, stream>>>(partial, rows, len);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    step = kGroupRows;
    rows = (rows + kGroupRows - 1) / kGroupRows;
  }
  const int threads = 256;
  sum_rows_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      partial, out, rows, len, (long long)step * len);
  return cudaGetLastError();
}

// ---- the tensor-core kernels' pixel boxes and tensor maps ----------------
//
// A tile of 64 pixels is one TMA box of bw x bh x bn pixels over an (n, h,
// w) grid (powers of two, product 64), so a shifted tap is the same box at
// other coordinates and TMA zero-fills what lies outside the image.

// The pixel box (bw, bh, bn) whose tiles cover the (n, ho, wo) grid with
// the fewest padded pixels; ties go to the widest box, then the tallest.
inline void pick_box(int n, int ho, int wo, int* bw, int* bh, int* bn) {
  long long best = -1;
  for (int lw = 6; lw >= 0; --lw)
    for (int lh = 6 - lw; lh >= 0; --lh) {
      const int a = 1 << lw, b = 1 << lh, c = 64 >> (lw + lh);
      const long long padded = (long long)((wo + a - 1) / a) * a *
                               ((ho + b - 1) / b) * b * ((n + c - 1) / c) * c;
      if (best < 0 || padded < best) {
        best = padded;
        *bw = a;
        *bh = b;
        *bn = c;
      }
    }
}

// A box grid over (n, h, w): the box and the number of boxes along each
// dimension.
struct BoxGrid {
  int bw, bh, bn, tiles_w, tiles_h, tiles;
};

// False if the tile count overflows an int.
inline bool box_grid(int n, int h, int w, BoxGrid* g) {
  pick_box(n, h, w, &g->bw, &g->bh, &g->bn);
  g->tiles_w = (w + g->bw - 1) / g->bw;
  g->tiles_h = (h + g->bh - 1) / g->bh;
  const long long t =
      (long long)g->tiles_w * g->tiles_h * ((n + g->bn - 1) / g->bn);
  g->tiles = (int)t;
  return t <= 2147483647ll;
}

// A bf16 NHWC tensor (n, h, w, c) read at every `step`-th row and column:
// at step 2 one map per (row, column) parity, map 2 * py + px with the base
// moved by the parity and doubled strides, dims (c, w / 2, h / 2, n); at
// step 1 four copies of the plain map. Each box is one 64-channel panel
// of bw x bh x bn pixels. False if cuTensorMapEncodeTiled refuses a map
// (a base or a row that is not a multiple of 16 bytes).
struct Maps4 {
  CUtensorMap m[4];
};

inline bool strided_maps(Maps4* maps, const void* base, int n, int h, int w,
                         int c, int step, const BoxGrid& g) {
  const long long cc = c, s = step;
  for (int par = 0; par < (step == 2 ? 4 : 1); ++par) {
    const int py = par / 2, px = par % 2;
    const void* b = static_cast<const __nv_bfloat16*>(base) +
                    (py * (long long)w + px) * cc;
    const long long dims[4] = {cc, w / s, h / s, n};
    const long long strides[3] = {s * cc * 2, s * w * cc * 2,
                                  (long long)h * w * cc * 2};
    const int box[3] = {g.bw, g.bh, g.bn};
    if (!hopper::box_map_4d(&maps->m[par], b, dims, strides, box))
      return false;
  }
  for (int par = (step == 2 ? 4 : 1); par < 4; ++par) maps->m[par] = maps->m[0];
  return true;
}

// The coordinate offset and parity map of a pixel offset o at step
// `step`: o = step * off + par.
__device__ __forceinline__ void tap_offset(int o, int step, int* off,
                                           int* par) {
  *par = step == 1 ? 0 : (o & 1);
  *off = step == 1 ? o : (o >> 1);
}

// The rebuilt output gradient of a tensor-core kernel, in place: the
// 128-byte-swizzled 64 x 64 bf16 panel of e at `pe` becomes gv = k * (e -
// m0 - xhat * m1), xhat = (y - mu) * inv, y's panel at `py` (bn_backward's
// arithmetic, rounded to bf16 once). cst[q * cstride + c] holds constant q
// (k, mu, inv, m0, m1) of the panel's column c. Thread t of the 128
// consumers rebuilds the 16-byte chunk t % 8 (columns 8 (t % 8) .. + 7) of
// rows t / 8 + 16 j, j < 4, and writes zeros to row j where bit j of
// `rows` is clear. Each half chunk's loads all precede its stores, so
// their latencies overlap.
__device__ __forceinline__ void rebuild_panel(uint8_t* pe, const uint8_t* py,
                                              const float* cst, int cstride,
                                              int tid, uint32_t rows) {
  const int lc = tid & 7;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 8 * lc + 4 * half;
    float4 f[5];
#pragma unroll
    for (int q = 0; q < 5; ++q)
      f[q] = *reinterpret_cast<const float4*>(cst + q * cstride + c);
    const float kq[4] = {f[0].x, f[0].y, f[0].z, f[0].w};
    const float mu[4] = {f[1].x, f[1].y, f[1].z, f[1].w};
    const float iv[4] = {f[2].x, f[2].y, f[2].z, f[2].w};
    const float m0[4] = {f[3].x, f[3].y, f[3].z, f[3].w};
    const float m1[4] = {f[4].x, f[4].y, f[4].z, f[4].w};
    int off[4];
    uint2 ev[4], yv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid >> 3) + 16 * j;
      off[j] = row * 128 + ((lc ^ (row & 7)) << 4) + 8 * half;
      ev[j] = *reinterpret_cast<const uint2*>(pe + off[j]);
      yv[j] = *reinterpret_cast<const uint2*>(py + off[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&ev[j]);
      const __nv_bfloat16* y8 = reinterpret_cast<const __nv_bfloat16*>(&yv[j]);
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[i] = bn_backward<float>(__bfloat162float(e8[i]),
                                  __bfloat162float(y8[i]), kq[i], mu[i],
                                  iv[i], m0[i], m1[i]);
      uint2 out = make_uint2(0u, 0u);
      if ((rows >> j) & 1u) {
        out.x = hopper::pack_bf16(g[0], g[1]);
        out.y = hopper::pack_bf16(g[2], g[3]);
      }
      *reinterpret_cast<uint2*>(pe + off[j]) = out;
    }
  }
}

}  // namespace
