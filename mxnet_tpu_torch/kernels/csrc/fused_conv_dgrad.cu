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
// bound it. Only the tensor cores come near it.
//
// Two kernels, chosen in the C entry point by its `kind` (not a fallback):
//   * conv_dgrad_tc_kernel, bfloat16 on the tensor cores: the main path.
//     It needs rows TMA can load: Ci, Co and Co2 multiples of 8.
//   * conv_dgrad_kernel, on the fp32 CUDA cores: float32, whose 1e-4 checks
//     do not admit TF32, and a bf16 shape TMA cannot load, which the wrapper
//     routes here by shape and counts apart.
//
// Both kernels order the input pixels by parity class at stride 2, or with
// a stride-2 extra term: class (pi, pj) holds the pixels (cs * iq + pi, cs
// * jq + pj). Every tap then feeds all of a class's pixels or none, so a
// tile loops over the 1, 2 or 4 taps its class takes, and only the (even,
// even) class takes the shortcut's term; no products are done on zeros.
// The TPU kernel accumulates the statistics across its sequential (batch,
// row) grid; here each tile writes one partial row per Ci and a second
// kernel adds them in tile order (no atomics).
//
// Design of the tensor-core kernel (hopper_mma.cuh has the panel layout).
//   * An implicit GEMM: M = 64 input pixels of one class, a box of bw x bh
//     x bn over the class grid (n, h / cs, w / cs) (B1's pick_box); N = a
//     Ci tile of BN = 64 or 128 (the launch's chan_block, the schedule
//     table's knob; hand default 128 where it divides Ci); K = (tap, 64-Co
//     slice) over the class's taps, then the extra term's 64-Co2 slices
//     where the class takes it.
//     One consumer warpgroup (BN / 64 accumulators of 32 floats a thread)
//     and one producer warp keeping a ring of TMA slots full.
//   * The g side is the A operand, K-major: for a tap, the class box moved
//     by whole g pixels, (pi + pad - dy) / stride, on one 4-D map over g
//     (and one over e and y_raw), or, where a class row steps two g rows
//     (stride 1 with a stride-2 extra term), through four parity maps.
//     Rebuilt, the consumers turn the landed e panel into gv in place (f32
//     with the five per-Co constants, then rounded, 16 bytes a thread at a
//     time) and zero the g pixels outside the image after the rebuild
//     (never the rebuild of TMA's zero fill); a proxy fence and a named
//     barrier put those writes before the product. g whole is used as TMA
//     loads it, so its zero fill is already the right value.
//   * The weights are B, K-major: w[tap] as Ci rows of Co, the 3-D map over
//     (Co, Ci, k*k) that B1 reads MN-major. Every product reads both
//     operands from shared memory (wgmma_ss).
//   * The extra term: g2 and w2 whole, the same product with no rebuild.
//   * While the products of one K slice run, the consumers prepare the
//     next slice in its own slot; a slot is released once its products
//     retired. Two or three CTAs share an SM (DgSmem).
//   * Epilogue: the mask gamma * xhat + beta > 0 on y_in, whose box the
//     producer asked TMA to bring into L2 first; the stats [sum e,
//     sum e * xhat] over the f32 e before it is rounded, summed per column
//     over a thread's rows, across the warp by xor shuffles and over the 4
//     warps in order into one partial row per pixel tile; e rounded once
//     to bf16 and stored from registers to the class's pixels.
//
// Design of the CUDA-core kernel: B1's CUDA-core implicit GEMM with M =
// input pixels, N = Ci and K = taps x Co, on conv_dgrad's own gather. One
// CTA of 256 threads per (64 input pixels of a class, 64 Ci), looping over
// the class's taps and over Co in chunks of 32 (conv_common.cuh's tile
// code).
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
  return sum_rows(static_cast<float*>(partial),
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

// ---- bfloat16: tensor cores ----------------------------------------------

using hopper::kPanelBytes;

// The geometry of the tensor-core kernel: the conv, its parity classes and
// the pixel boxes over a class's grid.
struct DgradTc {
  int n, h, w, ci, co, k, stride, pad, ho, wo;
  int cs, hq, wq, co2, s2;
  int gstep;   // g rows a class row steps: cs / stride
  int g2step;  // g2 rows a class row steps: cs / s2
  BoxGrid g;   // over a class's (n, hq, wq)
  int bn_ci, ci_tiles, cslices, c2slices, tiles;
};

// The Ci block of the tensor-core kernel: chan_block (64 or 128), or, at
// 0, the hand default (128 where it divides Ci, else 64); -1 for any
// other.
int dgrad_chan_block(int ci, int chan_block) {
  if (chan_block == 0) return ci % 128 == 0 ? 128 : 64;
  return chan_block == 64 || chan_block == 128 ? chan_block : -1;
}

bool tc_shape(int n, int h, int wd, int ci, int co, int k, int stride,
              int co2, int s2, int chan_block, DgradTc* t) {
  DgradShape d;
  if (!make_shape(n, h, wd, ci, co, k, stride, co2, s2, &d) || ci % 8 ||
      co % 8 || co2 % 8)
    return false;
  t->n = n;
  t->h = h;
  t->w = wd;
  t->ci = ci;
  t->co = co;
  t->k = k;
  t->stride = stride;
  t->pad = k / 2;
  t->ho = d.ho;
  t->wo = d.wo;
  t->cs = d.cs;
  t->hq = d.hq;
  t->wq = d.wq;
  t->co2 = d.co2;
  t->s2 = d.s2;
  t->gstep = d.cs / stride;
  t->g2step = d.cs / d.s2;
  if (!box_grid(n, d.hq, d.wq, &t->g)) return false;
  t->bn_ci = dgrad_chan_block(ci, chan_block);
  if (t->bn_ci < 0) return false;
  t->ci_tiles = (ci + t->bn_ci - 1) / t->bn_ci;
  t->cslices = (co + 63) / 64;
  t->c2slices = (co2 + 63) / 64;
  const long long tiles = (long long)d.cs * d.cs * t->g.tiles;
  t->tiles = (int)tiles;
  return tiles * t->ci_tiles <= 2147483647ll;
}

// Shared memory, in bytes from a 1024-aligned base: kStages slots of two
// g-side panels (g or e, then y_raw; or g2) and BN / 64 weight panels, the
// stats reduction (4 warps x 2 x BN floats), the mask's 4 x BN constants,
// the mbarriers, then the rebuild's 5 x gcols constants. kCtas CTAs share
// an SM: at BN = 64 three CTAs of two slots each (at most ~62 KB with Co =
// 512), whose warps hide one another's rebuild; at BN = 128, where the
// accumulators allow two, three slots each (~113 KB).
template <int BN>
struct DgSmem {
  static constexpr int NP = BN / 64;
  static constexpr int kCtas = BN == 64 ? 3 : 2;
  static constexpr int kStages = BN == 64 ? 2 : 3;
  static constexpr int kSlot = (2 + NP) * kPanelBytes;
  static constexpr int red = kStages * kSlot;
  static constexpr int mc = red + 4 * 2 * BN * 4;
  static constexpr int bars = mc + 4 * BN * 4;
  static constexpr int gc = bars + 2 * kStages * 8;
  static int alloc(int gcols) { return gc + 5 * gcols * 4 + 1024; }
};

// The g-side box coordinate offset and parity map of a tap whose g row is
// (cs * iq + o) / stride: o / stride when a class row steps one g row,
// else (stride 1, cs 2) 2 * iq + o through the parity maps.
__device__ __forceinline__ void g_offset(int o, int stride, int gstep,
                                         int* off, int* par) {
  if (gstep == 2) {
    tap_offset(o, 2, off, par);
  } else {
    *off = o / stride;  // a multiple of the stride for the class's taps
    *par = 0;
  }
}

template <int BN>
__global__ void __launch_bounds__(128 + 32, DgSmem<BN>::kCtas)
conv_dgrad_tc_kernel(const __grid_constant__ Maps4 gm,
                     const __grid_constant__ Maps4 ym,
                     const __grid_constant__ Maps4 g2m,
                     const __grid_constant__ Maps4 yinm,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tw2,
                     const float* __restrict__ gconsts,
                     const __nv_bfloat16* __restrict__ yin,
                     const float* __restrict__ mconsts,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ partial, DgradTc s) {
  using L = DgSmem<BN>;
  constexpr int NP = L::NP;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::red);
  float* mc = reinterpret_cast<float*>(smem + L::mc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;
  float* gc = reinterpret_cast<float*>(smem + L::gc);
  const bool rebuild = gconsts != nullptr;
  const int gcols = 64 * s.cslices;

  // x: Ci tile fastest, so CTAs that run together share their g boxes
  const int ci_t = blockIdx.x % s.ci_tiles;
  const int tile = blockIdx.x / s.ci_tiles;
  const int cls = tile / s.g.tiles;
  const int box = tile % s.g.tiles;
  const int pi = cls / s.cs, pj = cls % s.cs;
  const int jq0 = box % s.g.tiles_w * s.g.bw;
  const int iq0 = box / s.g.tiles_w % s.g.tiles_h * s.g.bh;
  const int n0 = box / (s.g.tiles_w * s.g.tiles_h) * s.g.bn;
  const int ci0 = ci_t * BN;
  // the class's taps: dy = fy + stride * a for a < ny (likewise dx), those
  // whose (pi + pad - dy) is a multiple of the stride
  const int fy = (pi + s.pad) % s.stride, fx = (pj + s.pad) % s.stride;
  const int ny = fy < s.k ? (s.k - fy + s.stride - 1) / s.stride : 0;
  const int nx = fx < s.k ? (s.k - fx + s.stride - 1) / s.stride : 0;
  const int n_main = ny * nx * s.cslices;
  const bool extra = s.co2 > 0 && pi % s.s2 == 0 && pj % s.s2 == 0;
  const int n_it = n_main + (extra ? s.c2slices : 0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp; one lane issues every load
    // the epilogue reads y_in at the tile's pixels: into L2 while the
    // products run
    if (tid == 128 && mconsts != nullptr)
      for (int p = 0; p < NP; ++p)
        hopper::tma_prefetch_box_4d(&yinm.m[s.cs == 2 ? 2 * pi + pj : 0],
                                    ci0 + 64 * p, jq0, iq0, n0);
    if (tid == 128)
      for (int it = 0; it < n_it; ++it) {
        const int st = it % S;
        if (it >= S) hopper::mbar_wait(&empty[st], (it / S - 1) & 1);
        uint8_t* slot = smem + st * L::kSlot;
        if (it < n_main) {
          const int sl = it % s.cslices, tp = it / s.cslices;
          const int dy = fy + s.stride * (tp / nx);
          const int dx = fx + s.stride * (tp % nx);
          int offy, offx, py, px;
          g_offset(pi + s.pad - dy, s.stride, s.gstep, &offy, &py);
          g_offset(pj + s.pad - dx, s.stride, s.gstep, &offx, &px);
          const int par = 2 * py + px;
          hopper::mbar_arrive_expect_tx(
              &full[st], ((rebuild ? 2 : 1) + NP) * kPanelBytes);
          hopper::tma_load_box_4d(slot, &gm.m[par], &full[st], 64 * sl,
                                  jq0 + offx, iq0 + offy, n0);
          if (rebuild)
            hopper::tma_load_box_4d(slot + kPanelBytes, &ym.m[par],
                                    &full[st], 64 * sl, jq0 + offx,
                                    iq0 + offy, n0);
          for (int p = 0; p < NP; ++p)
            hopper::tma_load_panel(slot + (2 + p) * kPanelBytes, &tw,
                                   &full[st], 64 * sl, ci0 + 64 * p,
                                   dy * s.k + dx);
        } else {
          const int sl = it - n_main;
          const int par = s.g2step == 2 ? 2 * pi + pj : 0;
          hopper::mbar_arrive_expect_tx(&full[st], (1 + NP) * kPanelBytes);
          hopper::tma_load_box_4d(slot, &g2m.m[par], &full[st], 64 * sl, jq0,
                                  iq0, n0);
          for (int p = 0; p < NP; ++p)
            hopper::tma_load_panel(slot + (2 + p) * kPanelBytes, &tw2,
                                   &full[st], 64 * sl, ci0 + 64 * p, 0);
        }
      }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q4 = lane % 4;
  const bool masked = mconsts != nullptr;
  if (masked)
    for (int c = tid; c < 4 * BN; c += 128) {
      const int cc = ci0 + c % BN;
      mc[c] = cc < s.ci ? mconsts[c / BN * s.ci + cc] : 0.f;
    }
  if (rebuild)
    for (int c = tid; c < 5 * gcols; c += 128) {
      const int cc = c % gcols;
      gc[c] = cc < s.co ? gconsts[c / gcols * s.co + cc] : 0.f;
    }
  hopper::named_barrier(1, 128);

  // the thread's two accumulator rows, 16 warp + lane / 4 and + 8, and
  // the four panel rows t / 8 + 16 j that rebuild_panel gives it: their
  // class coordinates and whether the pixel exists
  const int lbw = __ffs(s.g.bw) - 1, lbh = __ffs(s.g.bh) - 1;
  auto decode = [&](int r, int* q, int* j, int* n) {
    *j = jq0 + (r & (s.g.bw - 1));
    *q = iq0 + ((r >> lbw) & (s.g.bh - 1));
    *n = n0 + (r >> (lbw + lbh));
  };
  int rq[2], rj[2], rn[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    decode(16 * warp + lane / 4 + 8 * h, &rq[h], &rj[h], &rn[h]);
    live[h] = rn[h] < s.n && rq[h] < s.hq && rj[h] < s.wq;
  }
  int pq[4], pj_[4], pn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) decode((tid >> 3) + 16 * j, &pq[j], &pj_[j], &pn[j]);

  // Slice `it` has landed; a main slice's rebuilt g side is made in place
  // (g pixels outside the image zeroed after the rebuild, never the
  // rebuild of TMA's zero fill) and published to the tensor cores.
  auto prepare = [&](int it) {
    const int st = it % S;
    hopper::mbar_wait(&full[st], (it / S) & 1);
    if (!rebuild || it >= n_main) return;
    const int sl = it % s.cslices, tp = it / s.cslices;
    const int dy = fy + s.stride * (tp / nx);
    const int dx = fx + s.stride * (tp % nx);
    uint32_t rows = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gy = s.cs * pq[j] + pi + s.pad - dy;
      const int gx = s.cs * pj_[j] + pj + s.pad - dx;
      if (pn[j] < s.n && gy >= 0 && gx >= 0 && gy / s.stride < s.ho &&
          gx / s.stride < s.wo)
        rows |= 1u << j;
    }
    uint8_t* slot = smem + st * L::kSlot;
    rebuild_panel(slot, slot + kPanelBytes, gc + 64 * sl, gcols, tid, rows);
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
  };

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  // t += A . B^T over the slice: A = gv (or g2), 64 pixels x 64 Co, and B =
  // w[tap] (or w2), BN Ci x 64 Co, both K-major. While a slice's products
  // run, the consumers prepare the next slice in its own slot; the slot is
  // released once the products reading it have retired.
  if (n_it > 0) prepare(0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % S;
    const uint8_t* slot = smem + st * L::kSlot;
    const uint64_t a_desc = hopper::desc_sw128(slot);
    const uint64_t b_desc = hopper::desc_sw128(slot + 2 * kPanelBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hopper::fence_acc(acc[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss(acc[p], hopper::desc_add(a_desc, 32 * kk),
                         hopper::desc_add(b_desc, p * kPanelBytes + 32 * kk),
                         1);
    }
    hopper::wgmma_commit();
    if (it + 1 < n_it) prepare(it + 1);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) hopper::fence_acc(acc[p]);
    hopper::mbar_arrive(&empty[st]);
  }

  // the mask, the stats and the store; accumulator entry 4 j + 2 h + e is
  // row h, column 64 p + 8 j + 2 q4 + e of the tile
  size_t pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    pix[h] = (((size_t)rn[h] * s.h + s.cs * rq[h] + pi) * s.w + s.cs * rj[h] +
              pj) * s.ci;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 64 * p + 8 * j + 2 * q4;
      const int c = ci0 + cl;
      float se[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};
      if (c < s.ci) {
        float2 gam = make_float2(0.f, 0.f), bet = gam, mu = gam, inv = gam;
        if (masked) {
          gam = *reinterpret_cast<const float2*>(mc + cl);
          bet = *reinterpret_cast<const float2*>(mc + BN + cl);
          mu = *reinterpret_cast<const float2*>(mc + 2 * BN + cl);
          inv = *reinterpret_cast<const float2*>(mc + 3 * BN + cl);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[h]) continue;
          float v[2] = {acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]};
          if (masked) {
            const __nv_bfloat162 yv =
                *reinterpret_cast<const __nv_bfloat162*>(yin + pix[h] + c);
            const float yy[2] = {__low2float(yv), __high2float(yv)};
            const float g2[2] = {gam.x, gam.y}, b2[2] = {bet.x, bet.y};
            const float m2[2] = {mu.x, mu.y}, i2[2] = {inv.x, inv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xhat = __fmul_rn(__fsub_rn(yy[e], m2[e]), i2[e]);
              if (!(__fadd_rn(__fmul_rn(g2[e], xhat), b2[e]) > 0.f))
                v[e] = 0.f;
              se[e] += v[e];
              sx[e] = fmaf(v[e], xhat, sx[e]);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(out + pix[h] + c) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
      if (!masked) continue;
      // the warp's 8 row pairs of this column pair: xor shuffles give every
      // lane the same sums, in the same order
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          se[e] += __shfl_xor_sync(0xffffffffu, se[e], off);
          sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], off);
        }
      if (lane < 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(warp * 2 + 0) * BN + cl + e] = se[e];
          red[(warp * 2 + 1) * BN + cl + e] = sx[e];
        }
    }
  if (!masked) return;
  hopper::named_barrier(1, 128);
  // one partial row per pixel tile: the 4 warps' sums in warp order
  for (int c = tid; c < BN; c += 128) {
    if (ci0 + c >= s.ci) continue;
    float a = 0.f, b = 0.f;
    for (int w = 0; w < 4; ++w) {
      a += red[(w * 2 + 0) * BN + c];
      b += red[(w * 2 + 1) * BN + c];
    }
    float* row = partial + (size_t)tile * 2 * s.ci;
    row[ci0 + c] = a;
    row[s.ci + ci0 + c] = b;
  }
}

template <int BN>
cudaError_t launch_tc(const void* g, const void* e, const void* yraw,
                      const void* gconsts, const void* w, const void* g2,
                      const void* w2, const void* yin, const void* mconsts,
                      void* out, void* partial, void* stats,
                      const DgradTc& t, cudaStream_t stream) {
  const bool rebuild = gconsts != nullptr;
  Maps4 gm, ym, g2m, yinm;
  if (!strided_maps(&gm, rebuild ? e : g, t.n, t.ho, t.wo, t.co, t.gstep,
                    t.g))
    return cudaErrorInvalidValue;
  // y_in over the input pixels of each class (at cs = 2, one map a parity)
  if (yin == nullptr)
    yinm = gm;
  else if (!strided_maps(&yinm, yin, t.n, t.h, t.w, t.ci, t.cs, t.g))
    return cudaErrorInvalidValue;
  if (!rebuild)
    ym = gm;
  else if (!strided_maps(&ym, yraw, t.n, t.ho, t.wo, t.co, t.gstep, t.g))
    return cudaErrorInvalidValue;
  CUtensorMap tw, tw2;
  if (!hopper::panel_map(&tw, w, t.k * t.k, t.ci, t.co))
    return cudaErrorInvalidValue;
  if (t.co2 == 0) {
    g2m = gm;
    tw2 = tw;
  } else if (!strided_maps(&g2m, g2, t.n, t.h / t.s2, t.w / t.s2, t.co2,
                           t.g2step, t.g) ||
             !hopper::panel_map(&tw2, w2, 1, t.ci, t.co2)) {
    return cudaErrorInvalidValue;
  }
  // out is written as bf16 pairs
  if (reinterpret_cast<uintptr_t>(out) % 16) return cudaErrorInvalidValue;
  const int smem = DgSmem<BN>::alloc(rebuild ? 64 * t.cslices : 0);
  cudaError_t err = cudaFuncSetAttribute(
      conv_dgrad_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  conv_dgrad_tc_kernel<BN><<<t.tiles * t.ci_tiles, 128 + 32, smem, stream>>>(
      gm, ym, g2m, yinm, tw, tw2, static_cast<const float*>(gconsts),
      static_cast<const __nv_bfloat16*>(yin),
      static_cast<const float*>(mconsts), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(stats ? partial : nullptr), t);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  return sum_rows(static_cast<float*>(partial),
                  static_cast<float*>(stats), t.tiles, 2 * t.ci, stream);
}

// The pixel tiles (rows of the stats scratch) of the kernel `kind`
// chooses at chan_block (the CUDA-core kernel's Ci tile is fixed: 0 or
// 64); 0 for shapes it does not take. The count does not depend on the
// channel block.
int tiles_for(int n, int h, int wd, int stride, int s2, int kind,
              int chan_block) {
  const int co2 = s2 > 0 ? 8 : 0;
  if (kind == 2) {
    DgradTc t;
    return tc_shape(n, h, wd, 8, 8, 1, stride, co2, s2, chan_block, &t)
               ? t.tiles
               : 0;
  }
  if (chan_block != 0 && chan_block != 64) return 0;
  DgradShape s;
  if (!make_shape(n, h, wd, 1, 1, 1, stride, co2, s2, &s)) return 0;
  return s.cs * s.cs * s.class_tiles;
}

}  // namespace

// Pixel tiles of conv_dgrad's kernel `kind` at `chan_block` (as in
// fused_conv_dgrad) at these shapes (s2: the extra term's stride, 0 without
// one): the row count of its stats scratch. Returns 0 for shapes it does
// not take.
extern "C" int fused_conv_dgrad_tiles(int n, int h, int wd, int stride,
                                      int s2, int kind, int chan_block) {
  return tiles_for(n, h, wd, stride, s2, kind, chan_block);
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
// 0, kind, chan_block) rows of 2 * ci. chan_block: the Ci a CTA on the
// tensor cores, 64 or 128 (0: the hand default, 128 where it divides Ci);
// the CUDA-core kernel takes 0 or 64.
// Tensors other than the float32 constants share one dtype and are
// contiguous. kind: 0 = float32 on the CUDA cores, 1 = bfloat16 on the CUDA
// cores, 2 = bfloat16 on the tensor cores (ci, co and co2 multiples of 8,
// every bf16 tensor 16-byte aligned). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_conv_dgrad(const void* g, const void* e,
                                const void* yraw, const void* gconsts,
                                const void* w, const void* g2,
                                const void* w2, int co2, int s2,
                                const void* yin, const void* mconsts,
                                void* out, void* partial, int partial_rows,
                                void* stats, int n, int h, int wd, int ci,
                                int co, int k, int stride, int kind,
                                int chan_block, void* stream) {
  DgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, co2, s2, &s) ||
      w == nullptr || out == nullptr ||
      (gconsts == nullptr ? g == nullptr
                          : (e == nullptr || yraw == nullptr)) ||
      (co2 > 0 && (g2 == nullptr || w2 == nullptr)) ||
      (mconsts != nullptr && (yin == nullptr || stats == nullptr)) ||
      (mconsts == nullptr && stats != nullptr) || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  // one partial row per pixel tile: a smaller buffer would be overrun
  const int tiles =
      tiles_for(n, h, wd, stride, co2 > 0 ? s2 : 0, kind, chan_block);
  if (tiles == 0 ||
      (stats != nullptr && (partial == nullptr || partial_rows != tiles)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    DgradTc t;
    if (!tc_shape(n, h, wd, ci, co, k, stride, co2, s2, chan_block, &t))
      return (int)cudaErrorInvalidValue;
    return t.bn_ci == 128
               ? (int)launch_tc<128>(g, e, yraw, gconsts, w, g2, w2, yin,
                                     mconsts, out, partial, stats, t, st)
               : (int)launch_tc<64>(g, e, yraw, gconsts, w, g2, w2, yin,
                                    mconsts, out, partial, stats, t, st);
  }
  if (kind == 0)
    return launch<float>(g, e, yraw, gconsts, w, g2, w2, yin, mconsts, out,
                         partial, stats, s, st);
  return launch<__nv_bfloat16>(g, e, yraw, gconsts, w, g2, w2, yin, mconsts,
                               out, partial, stats, s, st);
}
