// Weight gradient of the fused NHWC convolution for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `conv_wgrad` in
// mxnet_tpu/kernels/fused_block.py (kernel body `kernel`, `pallas_call`
// under the same function). Same function, not a block-by-block copy:
//   h  = act(x * scale + bias)   the forward's prologue, recomputed on the
//                                read, f32 math, cast to the compute dtype
//   gv = g, or k * (e - m0 - xhat * m1) with xhat = (y - mu) * inv, f32
//                                math, cast to the compute dtype (the
//                                TPU's `_bnbwd_value`: dL/dy rebuilt from
//                                the relu-masked partial e of the next
//                                BatchNorm and its raw input y)
//   dw[dy, dx, ci, co] = sum over output pixels p of
//                        h[p * stride + (dy, dx) - pad, ci] * gv[p, co]
// on x (N, H, W, Ci) NHWC, g / e / y (N, Ho, Wo, Co) and dw (k, k, Ci, Co)
// HWIO in f32. Taps outside the image read 0 after the prologue, never
// act(bias) (the TPU kernel masks its halo rows and pads W after
// `_apply_prologue`).
//
// What bounds it on the H100. The work is 2 * N*Ho*Wo * k*k*Ci * Co
// operations, a forward's, against x and g (or e and y) read once and dw
// written once: at the stage-1 3x3 of ResNet-50 at batch 64, (64, 56, 56,
// 64) bf16, 14.8 GFLOP (15.0 us at the 989 TFLOP/s bf16 tensor-core peak)
// against 51.5 MB with g whole (15.4 us at 3.35 TB/s) or 77 MB with (e, y)
// (23 us). This first version runs the products on the fp32 CUDA cores (67
// TFLOP/s peak), as B1 does, so it sits far above that bound; wgmma with
// TMA-fed tiles is the next step.
//
// Design. The TPU kernel keeps one dw block resident in VMEM and adds to it
// over a sequential (batch, row) grid. Hopper's CTAs run in no order, and
// the reduction is long against a small output (conv1's dw at stage 1 is
// 64 x 64 over 200704 pixels), so the pixel axis is split:
//   * one CTA of 256 threads per (tap, 64-Ci tile, 64-Co tile, pixel
//     chunk); the chunk count is chosen so the grid has at least two waves
//     of 4 CTAs on each of 132 SMs, with at least 256 pixels a chunk;
//   * an implicit GEMM with M = Ci, N = Co and K = the chunk's pixels,
//     walked 32 pixels at a time through shared memory (conv_common.cuh's
//     tile code): each thread gathers 8 x elements (consecutive threads,
//     consecutive channels of one pixel), applies the prologue and rounds
//     them as it stores them, and 8 g elements, rebuilt from (e, y) where
//     asked, rounded likewise;
//   * each CTA writes its f32 partial dw tile; a second kernel adds the
//     partials of all chunks in chunk order (B1's stats scheme: no atomics,
//     the same sums on every run). With one chunk the CTAs write dw itself.
#include "conv_common.cuh"

namespace {

constexpr int kWaveCtas = 4 * 132;       // 4 resident CTAs on each SM
constexpr int kMinChunkPixels = 8 * kChunk;

struct WgradShape {
  int n, h, w, ci, co, k, stride, ho, wo, m, chunk_pixels, ci_tiles;
};

int chunk_pixels_for(long long m, long long tiles) {
  const long long want = (2 * kWaveCtas + tiles - 1) / tiles;
  long long px = (m + want - 1) / want;
  px = (px + kChunk - 1) / kChunk * kChunk;
  return (int)(px < kMinChunkPixels ? kMinChunkPixels : px);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const T* __restrict__ e, const T* __restrict__ yraw,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ consts, float* __restrict__ out,
                  WgradShape s, int prologue, int relu) {
  __shared__ float as[kChunk * kAStride];  // x side, [pixel][ci]
  __shared__ float bs[kChunk * kTileN];    // g side, [pixel][co]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int chunk = blockIdx.x;
  const int tap = blockIdx.y / s.ci_tiles;
  const int ci0 = (blockIdx.y - tap * s.ci_tiles) * kTileM;
  const int co0 = blockIdx.z * kTileN;
  const int pad = s.k / 2;
  const int dy = tap / s.k;
  const int dx = tap - dy * s.k;
  const int p_begin = chunk * s.chunk_pixels;
  const int p_end = min(s.m, p_begin + s.chunk_pixels);

  // each thread loads column `col` (a channel of x and one of g) of the
  // pixels first, first + 4, ..., first + 28 of every 32-pixel stage
  const int col = tid & (kTileN - 1);
  const int first = tid >> 6;
  const int ci = ci0 + col;
  const int co = co0 + col;
  const bool ci_ok = ci < s.ci;
  const bool co_ok = co < s.co;
  float sc = 0.f, bi = 0.f;
  if (prologue && ci_ok) {
    sc = scale[ci];
    bi = bias[ci];
  }
  float bk = 0.f, bmu = 0.f, binv = 0.f, bm0 = 0.f, bm1 = 0.f;
  if (consts != nullptr && co_ok) {
    bk = consts[co];
    bmu = consts[s.co + co];
    binv = consts[2 * s.co + co];
    bm0 = consts[3 * s.co + co];
    bm1 = consts[4 * s.co + co];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kChunk) {
    __syncthreads();  // the previous stage's readers are done
    // the first pixel's (n, oh, ow), then steps of 4 pixels
    int p = p0 + first;
    int ow = p % s.wo;
    int oh = (p / s.wo) % s.ho;
    int n = p / (s.wo * s.ho);
#pragma unroll
    for (int r = 0; r < kChunk / 4; ++r, p += 4) {
      const int kc = first + 4 * r;
      float a = 0.f, b = 0.f;
      if (p < p_end) {
        const int ih = oh * s.stride + dy - pad;
        const int iw = ow * s.stride + dx - pad;
        if (ci_ok && ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) {
          a = to_float(x[(((size_t)n * s.h + ih) * s.w + iw) * s.ci + ci]);
          if (prologue) a = bn_apply<T>(a, sc, bi, relu);
        }
        if (co_ok) {
          const size_t gi = (size_t)p * s.co + co;
          b = consts == nullptr
                  ? to_float(g[gi])
                  : bn_backward<T>(to_float(e[gi]), to_float(yraw[gi]), bk,
                                   bmu, binv, bm0, bm1);
        }
      }
      as[kc * kAStride + col] = a;
      bs[kc * kTileN + col] = b;
      ow += 4;
      while (ow >= s.wo) {
        ow -= s.wo;
        if (++oh == s.ho) {
          oh = 0;
          ++n;
        }
      }
    }
    __syncthreads();
    tile_fma<kTileN>(as, bs, ty, tx, acc);
  }

  float* o = out + (size_t)chunk * s.k * s.k * s.ci * s.co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c_in = ci0 + ty * 4 + i;
    if (c_in >= s.ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c_out = co0 + tx + 16 * j;
      if (c_out < s.co)
        o[((size_t)tap * s.ci + c_in) * s.co + c_out] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* e,
                   const void* yraw, const void* scale, const void* bias,
                   const void* consts, void* dw, void* partial, int chunks,
                   const WgradShape& s, int prologue, int relu,
                   cudaStream_t stream) {
  const dim3 grid(chunks, s.k * s.k * s.ci_tiles,
                  (s.co + kTileN - 1) / kTileN);
  float* out = static_cast<float*>(chunks > 1 ? partial : dw);
  conv_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(e), static_cast<const T*>(yraw),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(consts), out, s, prologue, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return sum_rows(static_cast<const float*>(partial),
                  static_cast<float*>(dw), chunks,
                  s.k * s.k * s.ci * s.co, stream);
}

bool make_shape(int n, int h, int wd, int ci, int co, int k, int stride,
                WgradShape* s) {
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || (stride == 2 && (h % 2 || wd % 2)))
    return false;
  s->n = n;
  s->h = h;
  s->w = wd;
  s->ci = ci;
  s->co = co;
  s->k = k;
  s->stride = stride;
  s->ho = h / stride;
  s->wo = wd / stride;
  const long long m = (long long)n * s->ho * s->wo;
  const long long dw = (long long)k * k * ci * co;
  s->ci_tiles = (ci + kTileM - 1) / kTileM;
  const long long tiles =
      (long long)k * k * s->ci_tiles * ((co + kTileN - 1) / kTileN);
  if (m > (1ll << 30) || dw > (1ll << 30) || tiles > 65535) return false;
  s->m = (int)m;
  s->chunk_pixels = chunk_pixels_for(m, tiles);
  return true;
}

}  // namespace

// The number of pixel chunks conv_wgrad splits these shapes into: the row
// count of its f32 partial scratch (chunks, k, k, ci, co) when above 1.
// Returns 0 for shapes it does not take.
extern "C" int fused_conv_wgrad_chunks(int n, int h, int wd, int ci, int co,
                                       int k, int stride) {
  WgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, &s)) return 0;
  return (s.m + s.chunk_pixels - 1) / s.chunk_pixels;
}

// x: (n, h, w, ci) NHWC; dw: (k, k, ci, co) float32 HWIO, written whole.
// The output gradient is either g (n, h/stride, w/stride, co), with e,
// yraw and consts null, or (e, yraw) of that shape with consts a (5, co)
// float32 array of the BN-backward constants k, mu, inv, m0, m1 (g null).
// x, g, e and yraw share one dtype (0 = float32, 1 = bfloat16) and are
// contiguous. scale, bias: (ci,) float32, read when prologue != 0 (relu !=
// 0 adds the ReLU). partial: float32 scratch of partial_rows x k*k*ci*co,
// where partial_rows must equal fused_conv_wgrad_chunks(...) when that is
// above 1 (null otherwise). k is 1 or 3, stride 1 or 2, and stride 2 needs
// even h and w. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int fused_conv_wgrad(const void* x, const void* g, const void* e,
                                const void* yraw, const void* scale,
                                const void* bias, const void* consts,
                                void* dw, void* partial, int partial_rows,
                                int n, int h, int wd, int ci, int co, int k,
                                int stride, int prologue, int relu, int dtype,
                                void* stream) {
  WgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, &s) || x == nullptr ||
      dw == nullptr || (prologue && (scale == nullptr || bias == nullptr)) ||
      (consts == nullptr ? g == nullptr
                         : (e == nullptr || yraw == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int chunks = (s.m + s.chunk_pixels - 1) / s.chunk_pixels;
  // one partial row per chunk: a smaller buffer would be overrun
  if (chunks > 1 && (partial == nullptr || partial_rows != chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, e, yraw, scale, bias, consts, dw, partial,
                         chunks, s, prologue, relu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, e, yraw, scale, bias, consts, dw,
                                 partial, chunks, s, prologue, relu, st);
  return (int)cudaErrorInvalidValue;
}
