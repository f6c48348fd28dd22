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
// (23 us). Only the tensor cores come near it.
//
// Two kernels, chosen in the C entry point by its `kind` (not a fallback):
//   * conv_wgrad_tc_kernel, bfloat16 on the tensor cores: the main path.
//     It needs rows TMA can load, Ci and Co multiples of 8.
//   * conv_wgrad_kernel, on the fp32 CUDA cores: float32, whose 1e-4 checks
//     do not admit TF32, and a bf16 shape TMA cannot load, which the wrapper
//     routes here by shape and counts apart.
//
// Both round h and gv to the compute dtype before the product; a bf16 x
// bf16 product is exact in f32, so the two kernels differ from the plain
// version only in the order of the f32 sums.
//
// Design of the tensor-core kernel (hopper_mma.cuh has the panel layout).
//   * A GEMM per tap: M = Ci (a 64-channel tile, one consumer warpgroup),
//     N = Co (a 64-channel tile), K = output pixels, taken as B1's pixel
//     boxes (bw x bh x bn = 64 pixels, pick_box over (N, Ho, Wo)). One CTA
//     holds the accumulators of one kernel row's k taps (k x 32 floats a
//     thread), so each g panel and its rebuild serves k products.
//   * The x side: the box of a tap is the output box moved by the tap
//     (tap_offset); stride 2 reads through B1's four parity maps. The
//     consumers apply the prologue in f32 to each landed x panel in place,
//     16 bytes (8 channels of one pixel) a thread at a time, and zero the
//     pixels that lie past the output or whose tap lies outside the image:
//     TMA's zero fill alone would leave act(bias) there.
//   * The g side: g whole is used as TMA loads it. Rebuilt, the consumers
//     read the (e, y) panels, rebuild gv in f32, round it and write it back
//     into e's panel in the same swizzle.
//   * The product reads both operands from shared memory (wgmma_ss): A =
//     h^T and B = gv, both MN-major (pixels down the rows). A proxy fence
//     and a named barrier put the consumers' writes before it. A operands
//     from registers would overlap less safely: nothing keeps the compiler
//     from reusing an in-flight product's A registers for the next tap's.
//   * A producer warp keeps a ring of S slots full (mbarriers with the
//     hopper_mma.cuh watchdog). While a box's products run, the consumers
//     prepare the next box in its own slot; a slot is released once the
//     products reading it have retired. Two CTAs share an SM.
//   * Pixel chunks spread across CTAs: enough chunks that the grid covers
//     the 132 SMs twice (the f32 partials under 256 MB). sum_rows adds the
//     partials in chunk order: no atomics, the same sums on every run.
//
// Design of the CUDA-core kernel. The TPU kernel keeps one dw block
// resident in VMEM and adds to it over a sequential (batch, row) grid.
// Hopper's CTAs run in no order, and the reduction is long against a small
// output (conv1's dw at stage 1 is 64 x 64 over 200704 pixels), so the
// pixel axis is split:
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
//     partials of all chunks in chunk order. With one chunk the CTAs write
//     dw itself.
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
  return sum_rows(static_cast<float*>(partial),
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

// ---- bfloat16: tensor cores ----------------------------------------------

using hopper::kPanelBytes;

constexpr int kTcCtasPerSm = 2;  // the three taps' 96 accumulators allow two

// The geometry of the tensor-core kernel: the conv, the output's pixel
// boxes and how they are split into chunks.
struct WgradTc {
  int n, h, w, ci, co, k, stride, pad, ho, wo;
  BoxGrid g;  // over the output (n, ho, wo)
  int ci_tiles, co_tiles, boxes_per_chunk, chunks;
};

bool tc_shape(int n, int h, int wd, int ci, int co, int k, int stride,
              WgradTc* t) {
  t->n = n;
  t->h = h;
  t->w = wd;
  t->ci = ci;
  t->co = co;
  t->k = k;
  t->stride = stride;
  t->pad = k / 2;
  t->ho = h / stride;
  t->wo = wd / stride;
  if (!box_grid(n, t->ho, t->wo, &t->g)) return false;
  t->ci_tiles = (ci + 63) / 64;
  t->co_tiles = (co + 63) / 64;
  const long long ctas = (long long)t->ci_tiles * k * t->co_tiles;
  if (ctas > 2147483647ll) return false;
  // chunks: the grid covers every SM kTcCtasPerSm times, every chunk has
  // a box, and the partials stay under 256 MB. Their traffic (written, then
  // read) is small beside the time a CTA takes for its boxes: 4.7 MB, 1.4
  // us at 3.35 TB/s, for each more chunk of the 14x14 3x3 at 256 channels,
  // where one chunk leaves 48 CTAs for 132 SMs.
  const long long want = (132 * kTcCtasPerSm + ctas - 1) / ctas;
  const long long dw_bytes = 4ll * k * k * ci * co;
  long long c = want < (256ll << 20) / dw_bytes ? want
                                                 : (256ll << 20) / dw_bytes;
  if (c > t->g.tiles) c = t->g.tiles;
  if (c < 1) c = 1;
  t->boxes_per_chunk = (int)((t->g.tiles + c - 1) / c);
  t->chunks = (t->g.tiles + t->boxes_per_chunk - 1) / t->boxes_per_chunk;
  return t->chunks <= 65535;
}

// Shared memory, in bytes from a 1024-aligned base: kStages slots of G
// g-side panels (g, or e then y) and T x panels, then the rebuild's five
// constants for the CTA's 64 Co, then the mbarriers. kStages leaves room
// for kTcCtasPerSm CTAs on an SM.
template <int T, int G>
struct WgSmem {
  static constexpr int kPanels = G + T;
  static constexpr int kStages = T == 1 ? 4 : (G == 1 ? 3 : 2);
  static constexpr int consts = kStages * kPanels * kPanelBytes;
  static constexpr int bars = consts + 5 * 64 * 4;
  static constexpr int alloc = bars + 2 * kStages * 8 + 1024;
};

// The prologue in place on a 128-byte-swizzled x panel (64 pixel rows of
// 64 channels): thread t of the 128 consumers takes the 16-byte chunk t % 8
// (channels 8 (t % 8) .. + 7, whose scale and bias are sc and bi) of rows
// t / 8 + 16 j, j < 4; a row whose bit j of `rows` is clear becomes zeros.
// All four chunks are loaded before any is stored, so their latencies
// overlap; each value is rounded to bf16 once, as bn_apply rounds it.
__device__ __forceinline__ void prologue_panel(uint8_t* px,
                                               const float (&sc)[8],
                                               const float (&bi)[8],
                                               int prologue, int relu,
                                               int tid, uint32_t rows) {
  const int lc = tid & 7;
  uint4* chunk[4];
  uint4 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = (tid >> 3) + 16 * j;
    chunk[j] =
        reinterpret_cast<uint4*>(px + row * 128 + ((lc ^ (row & 7)) << 4));
    v[j] = *chunk[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&v[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 xv = *reinterpret_cast<__nv_bfloat162*>(&w[i]);
      if (!((rows >> j) & 1u))
        w[i] = 0u;
      else if (prologue)
        w[i] = hopper::pack_bf16(
            bn_apply<float>(__low2float(xv), sc[2 * i], bi[2 * i], relu),
            bn_apply<float>(__high2float(xv), sc[2 * i + 1], bi[2 * i + 1],
                            relu));
    }
    *chunk[j] = v[j];
  }
}

template <int T, int G>
__global__ void __launch_bounds__(128 + 32, kTcCtasPerSm)
conv_wgrad_tc_kernel(const __grid_constant__ Maps4 xm,
                     const __grid_constant__ Maps4 gm,
                     const __grid_constant__ Maps4 ym,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ consts,
                     float* __restrict__ out, WgradTc s, int prologue,
                     int relu) {
  using L = WgSmem<T, G>;
  constexpr int S = L::kStages;
  constexpr int kSlot = L::kPanels * kPanelBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* cst = reinterpret_cast<float*>(smem + L::consts);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;

  // x: (Ci tile, kernel row, Co tile), so CTAs that run together share
  // their boxes in L2; y: the pixel chunk
  const int ci_t = blockIdx.x % s.ci_tiles;
  const int dy = blockIdx.x / s.ci_tiles % s.k;
  const int co_t = blockIdx.x / (s.ci_tiles * s.k);
  const int ci0 = 64 * ci_t, co0 = 64 * co_t;
  const int b0 = blockIdx.y * s.boxes_per_chunk;
  const int n_box = min(s.g.tiles - b0, s.boxes_per_chunk);
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
    if (tid == 128) {
      int offy, py;
      tap_offset(dy - s.pad, s.stride, &offy, &py);
      for (int it = 0; it < n_box; ++it) {
        const int st = it % S;
        const int b = b0 + it;
        const int ow0 = b % s.g.tiles_w * s.g.bw;
        const int oh0 = b / s.g.tiles_w % s.g.tiles_h * s.g.bh;
        const int n0 = b / (s.g.tiles_w * s.g.tiles_h) * s.g.bn;
        if (it >= S) hopper::mbar_wait(&empty[st], (it / S - 1) & 1);
        uint8_t* slot = smem + st * kSlot;
        hopper::mbar_arrive_expect_tx(&full[st], kSlot);
        hopper::tma_load_box_4d(slot, &gm.m[0], &full[st], co0, ow0, oh0, n0);
        if (G == 2)
          hopper::tma_load_box_4d(slot + kPanelBytes, &ym.m[0], &full[st],
                                  co0, ow0, oh0, n0);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          int offx, px;
          tap_offset(t - s.pad, s.stride, &offx, &px);
          hopper::tma_load_box_4d(slot + (G + t) * kPanelBytes,
                                  &xm.m[2 * py + px], &full[st], ci0,
                                  ow0 + offx, oh0 + offy, n0);
        }
      }
    }
    return;
  }

  // the scale and bias of this thread's 8 channels (prologue_panel's
  // chunk), and the rebuild's constants of the CTA's 64 Co
  float sc[8], bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = ci0 + 8 * (tid & 7) + i;
    const bool on = prologue && c < s.ci;
    sc[i] = on ? scale[c] : 0.f;
    bi[i] = on ? bias[c] : 0.f;
  }
  if (G == 2) {
    for (int c = tid; c < 5 * 64; c += 128) {
      const int co = co0 + c % 64;
      cst[c] = co < s.co ? consts[c / 64 * s.co + co] : 0.f;
    }
    hopper::named_barrier(1, 128);
  }
  const int lbw = __ffs(s.g.bw) - 1, lbh = __ffs(s.g.bh) - 1;

  // Box `it` has landed: the prologue on its x panels, pixels that do not
  // exist or whose tap lies outside the image zeroed (TMA's zero fill alone
  // would leave act(bias) there), the g panel rebuilt, all published to
  // the tensor cores.
  auto prepare = [&](int it) {
    const int st = it % S;
    uint8_t* slot = smem + st * kSlot;
    hopper::mbar_wait(&full[st], (it / S) & 1);
    const int b = b0 + it;
    const int ow0 = b % s.g.tiles_w * s.g.bw;
    const int oh0 = b / s.g.tiles_w % s.g.tiles_h * s.g.bh;
    const int n0 = b / (s.g.tiles_w * s.g.tiles_h) * s.g.bn;
    // a box whose pixels and taps all lie inside needs no per-row test
    const bool inside =
        n0 + s.g.bn <= s.n && oh0 + s.g.bh <= s.ho && ow0 + s.g.bw <= s.wo &&
        oh0 * s.stride - s.pad + dy >= 0 &&
        (oh0 + s.g.bh - 1) * s.stride - s.pad + dy < s.h &&
        ow0 * s.stride - s.pad >= 0 &&
        (ow0 + s.g.bw - 1) * s.stride - s.pad + s.k - 1 < s.w;
    uint32_t rows[T];
#pragma unroll
    for (int t = 0; t < T; ++t) rows[t] = inside ? 0xFu : 0u;
    if (!inside)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = (tid >> 3) + 16 * j;
        const int ow = ow0 + (r & (s.g.bw - 1));
        const int oh = oh0 + ((r >> lbw) & (s.g.bh - 1));
        const int nn = n0 + (r >> (lbw + lbh));
        const bool row_ok =
            nn < s.n && oh < s.ho && ow < s.wo &&
            (unsigned)(oh * s.stride - s.pad + dy) < (unsigned)s.h;
#pragma unroll
        for (int t = 0; t < T; ++t)
          if (row_ok &&
              (unsigned)(ow * s.stride - s.pad + t) < (unsigned)s.w)
            rows[t] |= 1u << j;
      }
    if (prologue || !inside)
#pragma unroll
      for (int t = 0; t < T; ++t)
        prologue_panel(slot + (G + t) * kPanelBytes, sc, bi, prologue, relu,
                       tid, rows[t]);
    if (G == 2) rebuild_panel(slot, slot + kPanelBytes, cst, 64, tid, 0xFu);
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
  };

  float acc[T][32];
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  // dw[tap] += h^T . gv over the box: A = h^T (Ci x pixels) and B = gv
  // (pixels x Co), both MN-major panels. While a box's products run, the
  // consumers prepare the next box in its own slot; the slot is released
  // once the products reading it have retired.
  if (n_box > 0) prepare(0);
  for (int it = 0; it < n_box; ++it) {
    const int st = it % S;
    const uint8_t* slot = smem + st * kSlot;
    const uint64_t g_desc = hopper::desc_sw128(slot);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const uint64_t x_desc =
          hopper::desc_sw128(slot + (G + t) * kPanelBytes);
      hopper::fence_acc(acc[t]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<1, 1>(acc[t],
                               hopper::desc_add(x_desc, kk * 16 * 128),
                               hopper::desc_add(g_desc, kk * 16 * 128), 1);
    }
    hopper::wgmma_commit();
    if (it + 1 < n_box) prepare(it + 1);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < T; ++t) hopper::fence_acc(acc[t]);
    hopper::mbar_arrive(&empty[st]);
  }

  // accumulator entry 4 j + 2 h + e: Ci row 16 warp + lane / 4 + 8 h, Co
  // column 8 j + 2 (lane % 4) + e of the tile
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* o = out + (size_t)blockIdx.y * s.k * s.k * s.ci * s.co;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int tap = dy * s.k + t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ci0 + 16 * warp + lane / 4 + 8 * h;
      if (c >= s.ci) continue;
      float* row = o + ((size_t)tap * s.ci + c) * s.co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane % 4);
        if (co < s.co)
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int T, int G>
cudaError_t launch_tc(const void* x, const void* g, const void* e,
                      const void* yraw, const void* scale, const void* bias,
                      const void* consts, void* dw, void* partial,
                      const WgradTc& t, int prologue, int relu,
                      cudaStream_t stream) {
  Maps4 xm, gm, ym;
  if (!strided_maps(&xm, x, t.n, t.h, t.w, t.ci, t.stride, t.g) ||
      !strided_maps(&gm, G == 1 ? g : e, t.n, t.ho, t.wo, t.co, 1, t.g))
    return cudaErrorInvalidValue;
  if (G == 1)
    ym = gm;
  else if (!strided_maps(&ym, yraw, t.n, t.ho, t.wo, t.co, 1, t.g))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<T, G>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgrad_tc_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t.ci_tiles * t.k * t.co_tiles, t.chunks);
  float* out = static_cast<float*>(t.chunks > 1 ? partial : dw);
  conv_wgrad_tc_kernel<T, G><<<grid, 128 + 32, smem, stream>>>(
      xm, gm, ym, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(consts), out,
      t, prologue, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || t.chunks == 1) return err;
  return sum_rows(static_cast<float*>(partial),
                  static_cast<float*>(dw), t.chunks,
                  t.k * t.k * t.ci * t.co, stream);
}

// The chunk count of the kernel `kind` chooses; 0 for shapes it does not
// take.
int chunks_for(int n, int h, int wd, int ci, int co, int k, int stride,
               int kind) {
  WgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, &s)) return 0;
  if (kind == 2) {
    WgradTc t;
    if (ci % 8 || co % 8 || !tc_shape(n, h, wd, ci, co, k, stride, &t))
      return 0;
    return t.chunks;
  }
  return (s.m + s.chunk_pixels - 1) / s.chunk_pixels;
}

}  // namespace

// The number of pixel chunks conv_wgrad's kernel `kind` (as in
// fused_conv_wgrad) splits these shapes into: the row count of its f32
// partial scratch (chunks, k, k, ci, co) when above 1. Returns 0 for shapes
// it does not take.
extern "C" int fused_conv_wgrad_chunks(int n, int h, int wd, int ci, int co,
                                       int k, int stride, int kind) {
  return chunks_for(n, h, wd, ci, co, k, stride, kind);
}

// x: (n, h, w, ci) NHWC; dw: (k, k, ci, co) float32 HWIO, written whole.
// The output gradient is either g (n, h/stride, w/stride, co), with e,
// yraw and consts null, or (e, yraw) of that shape with consts a (5, co)
// float32 array of the BN-backward constants k, mu, inv, m0, m1 (g null).
// x, g, e and yraw share one dtype and are contiguous. kind: 0 = float32 on
// the CUDA cores, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (ci and co multiples of 8; x, g, e and yraw 16-byte
// aligned). scale, bias: (ci,) float32, read when prologue != 0 (relu != 0
// adds the ReLU). partial: float32 scratch of partial_rows x k*k*ci*co,
// where partial_rows must equal fused_conv_wgrad_chunks(...) when that is
// above 1 (null otherwise). k is 1 or 3, stride 1 or 2, and stride 2 needs
// even h and w. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int fused_conv_wgrad(const void* x, const void* g, const void* e,
                                const void* yraw, const void* scale,
                                const void* bias, const void* consts,
                                void* dw, void* partial, int partial_rows,
                                int n, int h, int wd, int ci, int co, int k,
                                int stride, int prologue, int relu, int kind,
                                void* stream) {
  WgradShape s;
  if (!make_shape(n, h, wd, ci, co, k, stride, &s) || x == nullptr ||
      dw == nullptr || (prologue && (scale == nullptr || bias == nullptr)) ||
      (consts == nullptr ? g == nullptr
                         : (e == nullptr || yraw == nullptr)) ||
      kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const int chunks = chunks_for(n, h, wd, ci, co, k, stride, kind);
  // one partial row per chunk: a smaller buffer would be overrun
  if (chunks < 1 ||
      (chunks > 1 && (partial == nullptr || partial_rows != chunks)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    WgradTc t;
    tc_shape(n, h, wd, ci, co, k, stride, &t);
    if (k == 1)
      return consts == nullptr
                 ? (int)launch_tc<1, 1>(x, g, e, yraw, scale, bias, consts,
                                        dw, partial, t, prologue, relu, st)
                 : (int)launch_tc<1, 2>(x, g, e, yraw, scale, bias, consts,
                                        dw, partial, t, prologue, relu, st);
    return consts == nullptr
               ? (int)launch_tc<3, 1>(x, g, e, yraw, scale, bias, consts, dw,
                                      partial, t, prologue, relu, st)
               : (int)launch_tc<3, 2>(x, g, e, yraw, scale, bias, consts, dw,
                                      partial, t, prologue, relu, st);
  }
  if (kind == 0)
    return launch<float>(x, g, e, yraw, scale, bias, consts, dw, partial,
                         chunks, s, prologue, relu, st);
  return launch<__nv_bfloat16>(x, g, e, yraw, scale, bias, consts, dw,
                               partial, chunks, s, prologue, relu, st);
}
