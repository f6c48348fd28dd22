// Data gradient of the fused NHWC convolution for Hopper (sm_90a), with the
// BatchNorm-backward prologue and the mask-and-statistics epilogue; plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `conv_dgrad` in
// mxnet_tpu/kernels/fused_block.py (kernel body `kernel`, `pallas_call`
// under the same function). Same function, not a block-by-block copy:
//   gv = g, or k * (e - m0 - xhat * m1) with xhat = (y - mu) * inv (the
//        TPU's `_bnbwd_value`), f32 math, cast to the compute dtype; a g
//        pixel outside the image is 0 after the reconstruction, never the
//        reconstruction of a 0
//   t[n, i, j, ci] = sum over taps (dy, dx) and co of
//        gv[n, (i + pad - dy) / s, (j + pad - dx) / s, co] * w[dy, dx, ci, co]
//        over the taps whose numerators are multiples of the stride s and
//        land in the image (the transposed convolution, by index
//        arithmetic: no zero-stuffed g, no flipped copy of w)
//   t += g2[n, i / s2, j / s2, :] . w2[0, 0, ci, :] where i and j are
//        multiples of s2 (the optional `extra` term: the downsample
//        shortcut's data gradient joining at act1), in f32 before the mask
//   out = t, or with the mask of the conv input's own BatchNorm
//        e = (gamma * xhat + beta > 0) ? t : 0, xhat = (y_in - mu) * inv,
//        and stats = [sum e, sum e * xhat] per Ci over the f32 e before it
//        is rounded (B1's stats are over its rounded output; these are not)
// on g / e / y (N, H/s, W/s, Co), w (k, k, Ci, Co) HWIO, y_in and out (N, H,
// W, Ci) NHWC.
//
// What bounds it on the H100. The work is a forward's, 2 * N*Ho*Wo * k*k*Ci
// * Co operations (plus 2 * N*H*W/s2^2 * Ci * Co2 for the extra term),
// against the g side, w, y_in and out each moved once: at the stage-1 3x3
// of ResNet-50 at batch 64 (e and y in, bf16), 14.8 GFLOP (15.0 us at the
// 989 TFLOP/s bf16 peak) against 103 MB (31 us at 3.35 TB/s), so bytes
// bound it. This first version runs the products on the fp32 CUDA cores,
// as B1 does, so it sits far above that bound; wgmma with TMA-fed tiles is
// the next step.
//
// Design: B1's implicit GEMM with M = input pixels, N = Ci and K = taps x
// Co, on conv_dgrad's own gather.
//   * One CTA of 256 threads per (64 input pixels, 64 Ci), looping over
//     the taps and over Co in chunks of 32 (conv_common.cuh's tile code).
//   * At stride 2, or with a stride-2 extra term, the input pixels are
//     ordered by parity class (i % 2, j % 2), and a CTA holds pixels of one
//     class only: every tap then feeds all of its pixels or none, so a CTA
//     loops over the 1, 2 or 4 taps its class takes, and only the (even,
//     even) class takes the shortcut's term; no products are done on
//     zeros.
//   * The TPU kernel accumulates the statistics across its sequential
//     (batch, row) grid; here each CTA writes one partial row per Ci and a
//     second kernel adds them in tile order (no atomics).
#include "conv_common.cuh"

namespace {

struct DgradShape {
  int n, h, w, ci, co, k, stride, ho, wo;
  int cs;            // parity-class stride: input pixel (i, j) = (cs * iq
                     // + pi, cs * jq + pj) in class (pi, pj)
  int hq, wq;        // a class's rows and columns: h / cs, w / cs
  int class_pixels;  // pixels of one parity class: n * hq * wq
  int class_tiles;   // pixel tiles per class
  int co2, s2;       // the extra term's g2 channels (0: none) and stride
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ e,
                  const T* __restrict__ yraw,
                  const float* __restrict__ gconsts,
                  const T* __restrict__ wt, const T* __restrict__ g2,
                  const T* __restrict__ w2, const T* __restrict__ yin,
                  const float* __restrict__ mconsts, T* __restrict__ out,
                  float* __restrict__ partial, DgradShape s) {
  __shared__ float as[kChunk * kAStride];      // g side, [co][pixel]
  __shared__ float bs[kChunk * (kTileN + 1)];  // w side, [co][ci]
  __shared__ int row_n[kTileM], row_i[kTileM], row_j[kTileM];
  __shared__ int row_src[kTileM];              // g pixel of this tap, or -1

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int cls = blockIdx.x / s.class_tiles;
  const int pi = cls / s.cs;
  const int pj = cls - pi * s.cs;
  const int m0 = (blockIdx.x - cls * s.class_tiles) * kTileM;
  const int c0 = blockIdx.y * kTileN;
  const int pad = s.k / 2;

  if (tid < kTileM) {
    const int m = m0 + tid;
    if (m < s.class_pixels) {
      row_j[tid] = m % s.wq;
      row_i[tid] = (m / s.wq) % s.hq;
      row_n[tid] = m / (s.wq * s.hq);
    } else {
      row_n[tid] = -1;  // past the class's last pixel
      row_i[tid] = 0;
      row_j[tid] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // A element e of a stage: co k0 + (e & 31) of tile row e >> 5, so
  // consecutive threads read consecutive channels of one g pixel; B element
  // e: co k0 + (e & 31) of channel c0 + (e >> 5), consecutive threads
  // reading consecutive co of one HWIO row of w
  const int taps = s.k * s.k;
  for (int tap = 0; tap <= taps; ++tap) {
    const bool extra = tap == taps;
    int kdim = s.co;
    if (extra) {
      if (s.co2 == 0) break;
      kdim = s.co2;
    }
    const int dy = tap / s.k;
    const int dx = tap - dy * s.k;
    const int ny = pi + pad - dy;
    const int nx = pj + pad - dx;
    // skip a tap (or the extra term) that feeds no pixel of the class:
    // (i + pad - dy) must be a multiple of the stride, i of s2; both hold
    // for all of a class's pixels or for none
    if (extra ? (pi % s.s2 != 0 || pj % s.s2 != 0)
              : (ny % s.stride != 0 || nx % s.stride != 0))
      continue;
    __syncthreads();  // row_src's previous readers are done
    if (tid < kTileM) {
      int src = -1;
      const int n = row_n[tid];
      if (n >= 0 && !extra) {
        const int up = s.cs / s.stride;  // class rows per g row step
        const int r = row_i[tid] * up + ny / s.stride;
        const int c = row_j[tid] * up + nx / s.stride;
        if (r >= 0 && r < s.ho && c >= 0 && c < s.wo)
          src = (n * s.ho + r) * s.wo + c;
      } else if (n >= 0) {
        const int i = row_i[tid] * s.cs + pi;
        const int j = row_j[tid] * s.cs + pj;
        src = (n * (s.h / s.s2) + i / s.s2) * (s.w / s.s2) + j / s.s2;
      }
      row_src[tid] = src;
    }
    for (int k0 = 0; k0 < kdim; k0 += kChunk) {
      __syncthreads();  // the previous stage's readers are done
#pragma unroll
      for (int r = 0; r < kChunk * kTileM / kThreads; ++r) {
        const int el = tid + r * kThreads;
        const int kc = el & (kChunk - 1);
        const int row = el >> 5;
        const int c = k0 + kc;
        const int src = row_src[row];
        float v = 0.f;
        if (src >= 0 && c < kdim) {
          const size_t gi = (size_t)src * kdim + c;
          if (extra) {
            v = to_float(g2[gi]);
          } else if (gconsts == nullptr) {
            v = to_float(g[gi]);
          } else {
            v = bn_backward<T>(to_float(e[gi]), to_float(yraw[gi]),
                               gconsts[c], gconsts[s.co + c],
                               gconsts[2 * s.co + c], gconsts[3 * s.co + c],
                               gconsts[4 * s.co + c]);
          }
        }
        as[kc * kAStride + row] = v;
      }
#pragma unroll
      for (int r = 0; r < kChunk * kTileN / kThreads; ++r) {
        const int el = tid + r * kThreads;
        const int kr = el & (kChunk - 1);
        const int col = el >> 5;
        const int c = k0 + kr;
        const int cc = c0 + col;
        float v = 0.f;
        if (c < kdim && cc < s.ci)
          v = to_float(extra ? w2[(size_t)cc * kdim + c]
                             : wt[((size_t)tap * s.ci + cc) * kdim + c]);
        bs[kr * (kTileN + 1) + col] = v;
      }
      __syncthreads();
      tile_fma<kTileN + 1>(as, bs, ty, tx, acc);
    }
  }

  // epilogue: the input BatchNorm's mask, the store and the stats
  const bool masked = mconsts != nullptr;
  float mg[4], mb[4], mmu[4], minv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = c0 + tx + 16 * j;
    mg[j] = mb[j] = mmu[j] = minv[j] = 0.f;
    if (masked && cc < s.ci) {
      mg[j] = mconsts[cc];
      mb[j] = mconsts[s.ci + cc];
      mmu[j] = mconsts[2 * s.ci + cc];
      minv[j] = mconsts[3 * s.ci + cc];
    }
  }
  float se[4] = {0.f, 0.f, 0.f, 0.f}, sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const int n = row_n[row];
    if (n < 0) continue;
    const int ii = row_i[row] * s.cs + pi;
    const int jj = row_j[row] * s.cs + pj;
    const size_t pix = ((size_t)n * s.h + ii) * s.w + jj;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + tx + 16 * j;
      if (cc >= s.ci) continue;
      const size_t oi = pix * s.ci + cc;
      float v = acc[i][j];
      if (masked) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(yin[oi]), mmu[j]),
                                     minv[j]);
        if (!(__fadd_rn(__fmul_rn(mg[j], xhat), mb[j]) > 0.f)) v = 0.f;
        se[j] += v;
        sx[j] = fmaf(v, xhat, sx[j]);
      }
      store(out + oi, v);
    }
  }
  if (partial == nullptr) return;
  tile_column_sums(as, se, sx, ty, tx, tid, partial, blockIdx.x, c0, s.ci);
}

template <typename T>
cudaError_t launch(const void* g, const void* e, const void* yraw,
                   const void* gconsts, const void* w, const void* g2,
                   const void* w2, const void* yin, const void* mconsts,
                   void* out, void* partial, void* stats,
                   const DgradShape& s, cudaStream_t stream) {
  const int tiles = s.cs * s.cs * s.class_tiles;
  const dim3 grid(tiles, (s.ci + kTileN - 1) / kTileN);
  conv_dgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(e),
      static_cast<const T*>(yraw), static_cast<const float*>(gconsts),
      static_cast<const T*>(w), static_cast<const T*>(g2),
      static_cast<const T*>(w2), static_cast<const T*>(yin),
      static_cast<const float*>(mconsts), static_cast<T*>(out),
      static_cast<float*>(stats ? partial : nullptr), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  return sum_rows(static_cast<const float*>(partial),
                  static_cast<float*>(stats), tiles, 2 * s.ci, stream);
}

bool make_shape(int n, int h, int wd, int ci, int co, int k, int stride,
                int co2, int s2, DgradShape* s) {
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || (stride == 2 && (h % 2 || wd % 2)) ||
      co2 < 0 || (co2 > 0 && ((s2 != 1 && s2 != 2) ||
                              (s2 == 2 && (h % 2 || wd % 2)))))
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
  s->co2 = co2;
  s->s2 = co2 > 0 ? s2 : 1;
  s->cs = stride == 2 || s->s2 == 2 ? 2 : 1;
  s->hq = h / s->cs;
  s->wq = wd / s->cs;
  // pixel indices are ints; element offsets are size_t
  const long long px = (long long)n * s->hq * s->wq;
  if ((long long)n * h * wd > (1ll << 30) || (ci + kTileN - 1) / kTileN > 65535)
    return false;
  s->class_pixels = (int)px;
  s->class_tiles = (int)((px + kTileM - 1) / kTileM);
  return true;
}

}  // namespace

// Pixel tiles of conv_dgrad at these shapes (s2: the extra term's stride,
// 0 without one): the row count of its stats scratch. Returns 0 for shapes
// it does not take.
extern "C" int fused_conv_dgrad_tiles(int n, int h, int wd, int stride,
                                      int s2) {
  DgradShape s;
  if (!make_shape(n, h, wd, 1, 1, 1, stride, s2 > 0 ? 1 : 0, s2, &s))
    return 0;
  return s.cs * s.cs * s.class_tiles;
}

// out: (n, h, w, ci) NHWC, the data gradient of a conv with weights w (k,
// k, ci, co) HWIO and stride `stride` (1 or 2; 2 needs even h and w), pad
// k / 2. Its output gradient is either g (n, h/stride, w/stride, co), with
// e, yraw and gconsts null, or (e, yraw) of that shape with gconsts a (5,
// co) float32 array of the BN-backward constants k, mu, inv, m0, m1.
// Optional extra term (co2 > 0): g2 (n, h/s2, w/s2, co2) and w2 (1, 1, ci,
// co2). Optional mask (mconsts non-null): yin (n, h, w, ci) and mconsts a
// (4, ci) float32 array gamma, beta, mu, inv; then stats, (2, ci) float32,
// receives [sum e, sum e * xhat] and partial is float32 scratch of
// partial_rows == fused_conv_dgrad_tiles(n, h, w, stride, co2 > 0 ? s2 :
// 0) rows of 2 * ci.
// Tensors other than the float32 constants share one dtype (0 = float32, 1
// = bfloat16) and are contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_conv_dgrad(const void* g, const void* e,
                                const void* yraw, const void* gconsts,
                                const void* w, const void* g2,
                                const void* w2, int co2, int s2,
                                const void* yin, const void* mconsts,
                                void* out, void* partial, int partial_rows,
                                void* stats, int n, int h, int wd, int ci,
                                int co, int k, int stride, int dtype,
                                void* stream) {
  DgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, co2, s2, &s) ||
      w == nullptr || out == nullptr ||
      (gconsts == nullptr ? g == nullptr
                          : (e == nullptr || yraw == nullptr)) ||
      (co2 > 0 && (g2 == nullptr || w2 == nullptr)) ||
      (mconsts != nullptr && (yin == nullptr || stats == nullptr)) ||
      (mconsts == nullptr && stats != nullptr))
    return (int)cudaErrorInvalidValue;
  // one partial row per pixel tile: a smaller buffer would be overrun
  if (stats != nullptr &&
      (partial == nullptr ||
       partial_rows != s.cs * s.cs * s.class_tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(g, e, yraw, gconsts, w, g2, w2, yin, mconsts, out,
                         partial, stats, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, e, yraw, gconsts, w, g2, w2, yin,
                                 mconsts, out, partial, stats, s, st);
  return (int)cudaErrorInvalidValue;
}
