// Fused NHWC convolution forward for Hopper (sm_90a), plain C interface for
// ctypes: a BatchNorm-apply + ReLU prologue on the input read and an
// optional per-channel [sum, sum of squares] epilogue of the stored output.
//
// Replaces the Pallas TPU kernel `conv_fwd` in
// mxnet_tpu/kernels/fused_block.py (kernel body `kernel`, `pallas_call`
// under the same function). Same function, not a block-by-block copy:
//   h = act(x * scale + bias)   per input channel, f32 math, then cast to
//                               the compute dtype (the TPU's
//                               `_apply_prologue`), never written to memory
//   y = conv(h, w)              k in {1, 3}, pad k/2, stride 1 or 2, f32 sum
//   stats = [sum y, sum y^2]    over the stored (dtype-rounded) y, per Co
// on x (N, H, W, Ci) NHWC and w (k, k, Ci, Co) HWIO. Padding is applied to
// h, not x: a tap outside the image contributes 0, not act(bias) (the TPU
// kernel masks its halo rows and pads W after the prologue).
//
// What bounds it on the H100. At ResNet-50's shapes the work is
// 2 * N*Ho*Wo * k*k*Ci * Co operations against each of x, w, y read or
// written once: e.g. the stage-1 3x3 at batch 64, (64, 56, 56, 64) bf16,
// is 14.8 GFLOP (15.0 us at the 989 TFLOP/s bf16 tensor-core peak) against
// 51.5 MB of x, w and y (15.4 us at 3.35 TB/s), so the bytes bound it, at
// 0.0154 ms. Bytes bound most shapes at 56x56 and 28x28, operations the
// 3x3s and some 1x1s at 14x14 and 7x7; at batch 64 every one of the 22
// bounds lies between 6 and 47 us. This first version runs the products on
// the fp32 CUDA cores (67 TFLOP/s peak), not on the tensor cores, so it
// sits far above that bound; wgmma with TMA-fed tiles is the next step.
//
// Design: an implicit GEMM with M = N*Ho*Wo output pixels, N = Co and
// K = k*k*Ci, in the order (dy, dx, ci) that makes w a row-major (K, Co)
// matrix.
//   * One CTA of 256 threads per (64-pixel, 64-channel) output tile; the
//     grid's x walks pixel tiles, y walks channel tiles. The TPU kernel's
//     (channel-block, batch-block, row-tile) grid, batch fold and
//     dimension semantics are Mosaic blocking and are gone.
//   * K is walked in chunks of 32 staged through shared memory. Each
//     element of the A chunk is gathered from x (consecutive threads read
//     consecutive channels of one pixel), put through the prologue and
//     rounded to the compute dtype as it is stored; taps outside the image
//     are stored as 0. The B chunk is 32 rows of w.
//   * Threads form a 16 x 16 grid: thread (ty, tx) owns pixels 4*ty ..
//     4*ty+3 and channels tx + 16*j (j < 4), so the B reads of a half warp
//     fall in distinct banks and the A reads are broadcasts; the A chunk is
//     stored channel-major with a padded row (65 floats). This tile code,
//     the prologue arithmetic and the reductions are in conv_common.cuh,
//     shared with the backward kernels B2 and B3.
//   * Stats: each CTA sums its tile's rounded outputs per channel in a
//     fixed order and writes one partial row; a second kernel adds the
//     partials of all pixel tiles per channel in tile order. No atomics,
//     so the result is the same on every run.
//   * Ragged pixel and channel tiles are masked (H = 7 in ResNet-50's last
//     stage, 7 * 7 * N pixels).
#include "conv_common.cuh"

namespace {

struct ConvShape {
  int n, h, w, ci, co, k, stride, ho, wo, m, kdim;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y,
                float* __restrict__ partial, ConvShape s, int prologue,
                int relu) {
  __shared__ float as[kChunk * kAStride];  // A chunk, channel-major
  __shared__ float bs[kChunk * kTileN];    // B chunk, row-major
  __shared__ int row_n[kTileM], row_ih[kTileM], row_iw[kTileM];

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int m0 = blockIdx.x * kTileM;
  const int c0 = blockIdx.y * kTileN;
  const int pad = s.k / 2;

  if (tid < kTileM) {
    const int m = m0 + tid;
    if (m < s.m) {
      const int ow = m % s.wo;
      const int t = m / s.wo;
      const int oh = t % s.ho;
      row_n[tid] = t / s.ho;
      row_ih[tid] = oh * s.stride - pad;
      row_iw[tid] = ow * s.stride - pad;
    } else {
      row_n[tid] = -1;  // past the last pixel: contributes nothing
      row_ih[tid] = 0;
      row_iw[tid] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.kdim; k0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done (row_* set)
#pragma unroll
    for (int r = 0; r < kChunk * kTileM / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int kc = e % kChunk;  // consecutive threads: consecutive ci
      const int row = e / kChunk;
      const int kk = k0 + kc;
      float v = 0.f;
      const int n = row_n[row];
      if (kk < s.kdim && n >= 0) {
        const int tap = kk / s.ci;
        const int ci = kk - tap * s.ci;
        const int dy = tap / s.k;
        const int ih = row_ih[row] + dy;
        const int iw = row_iw[row] + (tap - dy * s.k);
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) {
          v = to_float(x[(((size_t)n * s.h + ih) * s.w + iw) * s.ci + ci]);
          if (prologue) v = bn_apply<T>(v, scale[ci], bias[ci], relu);
        }
      }
      as[kc * kAStride + row] = v;
    }
#pragma unroll
    for (int r = 0; r < kChunk * kTileN / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int col = e % kTileN;
      const int kr = e / kTileN;
      const int kk = k0 + kr;
      const int co = c0 + col;
      bs[kr * kTileN + col] =
          kk < s.kdim && co < s.co ? to_float(wt[(size_t)kk * s.co + co])
                                   : 0.f;
    }
    __syncthreads();

    tile_fma<kTileN>(as, bs, ty, tx, acc);
  }

  // store y rounded to T; keep the rounded values for the stats
  float csum[4] = {0.f, 0.f, 0.f, 0.f}, csq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + tx + 16 * j;
      if (co >= s.co) continue;
      const float q = round_to(acc[i][j], (T*)nullptr);
      store(y + (size_t)m * s.co + co, q);
      csum[j] += q;
      csq[j] = fmaf(q, q, csq[j]);
    }
  }
  if (partial == nullptr) return;

  // per-CTA channel sums: the 16 thread rows of a column, in row order
  tile_column_sums(as, csum, csq, ty, tx, tid, partial, blockIdx.x, c0, s.co);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, void* y, void* partial, void* stats,
                   const ConvShape& s, int prologue, int relu,
                   cudaStream_t stream) {
  const dim3 grid((s.m + kTileM - 1) / kTileM, (s.co + kTileN - 1) / kTileN);
  conv_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<float*>(stats ? partial : nullptr), s,
      prologue, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  return sum_rows(static_cast<const float*>(partial),
                  static_cast<float*>(stats), grid.x, 2 * s.co, stream);
}

}  // namespace

// x: (n, h, w, ci) NHWC; w: (k, k, ci, co) HWIO; y: (n, h/stride,
// w/stride, co), all of one dtype (0 = float32, 1 = bfloat16), contiguous.
// scale, bias: (ci,) float32, read when prologue != 0 (relu != 0 adds the
// ReLU). stats: (2, co) float32 or null; when given, partial is float32
// scratch of (ceil(n*ho*wo / fused_conv_fwd_tile_m()), 2, co), and
// partial_rows its first dimension. k is 1 or 3, stride 1 or 2, and
// stride 2 needs even h and w. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_conv_fwd(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, void* partial,
                              int partial_rows, void* stats, int n, int h,
                              int wd, int ci, int co, int k, int stride,
                              int prologue, int relu, int dtype,
                              void* stream) {
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || wd % 2)) ||
      (prologue && (scale == nullptr || bias == nullptr)) ||
      (stats != nullptr && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvShape s;
  s.n = n;
  s.h = h;
  s.w = wd;
  s.ci = ci;
  s.co = co;
  s.k = k;
  s.stride = stride;
  s.ho = h / stride;
  s.wo = wd / stride;
  const long long m = (long long)n * s.ho * s.wo;
  const long long kdim = (long long)k * k * ci;
  if (m > (1ll << 30) || kdim > (1ll << 30) ||
      (m + kTileM - 1) / kTileM > 2147483647ll ||
      (co + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  s.m = (int)m;
  s.kdim = (int)kdim;
  // one partial row per pixel tile: a smaller buffer would be overrun
  if (stats != nullptr && partial_rows != (s.m + kTileM - 1) / kTileM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, scale, bias, y, partial, stats, s, prologue,
                         relu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, bias, y, partial, stats, s,
                                 prologue, relu, st);
  return (int)cudaErrorInvalidValue;
}

// output pixels per CTA: the row count of `partial` is ceil(pixels / this)
extern "C" int fused_conv_fwd_tile_m() { return kTileM; }
