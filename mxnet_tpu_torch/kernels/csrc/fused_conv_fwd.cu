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
// bounds lies between 6 and 47 us. Only the tensor cores come near it.
//
// Two kernels, chosen in the C entry point (not a fallback):
//   * conv_fwd_tc_kernel, bfloat16 on the tensor cores: the main path. It
//     needs rows TMA can load, Ci and Co multiples of 8 (16-byte rows).
//   * conv_fwd_kernel, on the fp32 CUDA cores: float32, whose checks (1e-4
//     against full fp32) do not admit the TF32 the tensor cores would give
//     it, and a bf16 shape TMA cannot load, which the wrapper routes here
//     by shape and counts apart.
//
// Design of the tensor-core kernel (hopper_mma.cuh has the panel layout).
//   * An implicit GEMM: M = output pixels, N = Co, K walked as (tap, 64-
//     channel slice). One CTA per (64-pixel tile, BN = 64 or 128 output
//     channels): one consumer warpgroup (wgmma m64n64k16, BN / 64
//     accumulators of 32 floats a thread) and one producer warp that keeps
//     a ring of S slots full with TMA (S = 4 at BN = 64, 3 at BN = 128:
//     82 / 92 KB of shared memory at Ci = 2048, so two CTAs share an SM).
//     BN is the launch's chan_block, the schedule table's knob; its hand
//     default is 128 where 128 divides Co, else 64.
//   * The x operand: a 4-D tiled map over (C, W, H, N), not Hopper's im2col
//     mode. A pixel tile is a box of bw x bh x bn output pixels (bw * bh *
//     bn = 64, the product that pads the output least: 8x8x1 at 56x56,
//     4x4x4 at 28x28, 2x2x16 at 14x14, 1x1x64 at 7x7 for batch 64, so no
//     tile is ragged there), and a tap is the same box moved by (dx - pad,
//     dy - pad). Stride 2 reads x through four such maps, one per (row,
//     column) parity, with doubled strides and the base moved by the
//     parity, so a tap is again a plain box. The tiled mode gives all of
//     this with coordinates alone; im2col's own halo rules and its
//     per-pixel offsets range would be a second layout to get right
//     without a compiler to try it on. TMA zero-fills coordinates outside
//     the image and past Ci.
//   * The w operand: a 3-D map over (Co, Ci, k*k): a slice is a 64 x 64
//     panel, MN-major (transpose-B), the form of V in B5's P . V.
//   * The prologue between the load and the product: each consumer thread
//     reads its A fragments (rows 16w + t/4 and + 8, channels 16kk +
//     2(t%4) and + 8) out of the 128-byte-swizzled panel (16-byte chunk
//     index XOR row % 8), applies scale, bias and ReLU in f32, rounds to
//     bf16 and feeds wgmma_rs from registers. Then it zeroes, by
//     coordinate, a row whose tap lies outside the image: zero-fill alone
//     would leave act(bias) there.
//   * Epilogue: y rounded once to bf16 and stored from the accumulators;
//     the stats of the rounded values, rows outside the output masked,
//     summed per column over a thread's rows, across the warp by xor
//     shuffles and over the 4 warps in order into one partial row per
//     pixel tile; sum_rows adds the partials in tile order. No atomics, so
//     every run gives the same stats.
//
// Design of the CUDA-core kernel: an implicit GEMM with M = N*Ho*Wo output
// pixels, N = Co and K = k*k*Ci, in the order (dy, dx, ci) that makes w a
// row-major (K, Co) matrix.
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
  return sum_rows(static_cast<float*>(partial),
                  static_cast<float*>(stats), grid.x, 2 * s.co, stream);
}

// ---- bfloat16: tensor cores ----------------------------------------------

using hopper::kPanelBytes;

// The geometry of the tensor-core kernel: the conv, the pixel box of a
// tile (bw x bh x bn output pixels) and the tile grid.
struct TcShape {
  int n, h, w, ci, co, k, stride, pad, ho, wo;
  BoxGrid g;  // over the output (n, ho, wo)
  int cslices;
};

// Shared memory, in bytes from a 1024-aligned base: kStages x-panels,
// kStages x NP w-panels, the stats reduction (4 warps x 2 x BN floats),
// the mbarriers, then the prologue's scale and bias (cpad floats each).
template <int BN>
struct TcSmem {
  static constexpr int NP = BN / 64;
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int a = 0;
  static constexpr int b = a + kStages * kPanelBytes;
  static constexpr int red = b + kStages * NP * kPanelBytes;
  static constexpr int bars = red + 4 * 2 * BN * 4;
  static constexpr int pro = bars + 2 * kStages * 8;
  static int alloc(int cpad) { return pro + 2 * cpad * 4 + 1024; }
};

template <int BN>
__global__ void __launch_bounds__(128 + 32)
conv_fwd_tc_kernel(const __grid_constant__ Maps4 xm,
                   const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                   TcShape s, int prologue, int relu) {
  using L = TcSmem<BN>;
  constexpr int NP = L::NP;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;
  float* scale_s = reinterpret_cast<float*>(smem + L::pro);
  float* bias_s = scale_s + s.cslices * 64;

  // the tile's first output pixel; the box runs over (w, h, n)
  const int tile = blockIdx.x;
  const int ow0 = (tile % s.g.tiles_w) * s.g.bw;
  const int oh0 = (tile / s.g.tiles_w % s.g.tiles_h) * s.g.bh;
  const int n0 = tile / (s.g.tiles_w * s.g.tiles_h) * s.g.bn;
  const int co0 = blockIdx.y * BN;
  const int n_it = s.k * s.k * s.cslices;
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
    if (tid == 128)
      for (int it = 0; it < n_it; ++it) {
        const int st = it % S;
        const int tap = it / s.cslices;
        const int c0 = (it % s.cslices) * 64;
        if (it >= S) hopper::mbar_wait(&empty[st], (it / S - 1) & 1);
        int offy, offx, py, px;
        tap_offset(tap / s.k - s.pad, s.stride, &offy, &py);
        tap_offset(tap % s.k - s.pad, s.stride, &offx, &px);
        hopper::mbar_arrive_expect_tx(&full[st], (1 + NP) * kPanelBytes);
        hopper::tma_load_box_4d(smem + L::a + st * kPanelBytes,
                                &xm.m[2 * py + px], &full[st], c0,
                                ow0 + offx, oh0 + offy, n0);
        for (int p = 0; p < NP; ++p)
          hopper::tma_load_panel(smem + L::b + (st * NP + p) * kPanelBytes,
                                 &tw, &full[st], co0 + 64 * p, c0, tap);
      }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q4 = lane % 4;
  // the thread's two tile rows, 16 warp + lane / 4 and + 8: their output
  // pixel, whether it exists, and the input row / column of tap (0, 0)
  int rn[2], roh[2], row_[2], ih0[2], iw0[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    row_[h] = r;
    const int ow = ow0 + r % s.g.bw;
    const int oh = oh0 + r / s.g.bw % s.g.bh;
    rn[h] = n0 + r / (s.g.bw * s.g.bh);
    roh[h] = oh * s.wo + ow;
    live[h] = rn[h] < s.n && oh < s.ho && ow < s.wo;
    ih0[h] = oh * s.stride - s.pad;
    iw0[h] = ow * s.stride - s.pad;
  }
  if (prologue) {
    for (int c = tid; c < s.cslices * 64; c += 128) {
      scale_s[c] = c < s.ci ? scale[c] : 0.f;
      bias_s[c] = c < s.ci ? bias[c] : 0.f;
    }
    hopper::named_barrier(1, 128);
  }

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % S;
    const int tap = it / s.cslices;
    const int c0 = (it % s.cslices) * 64;
    const int dy = tap / s.k, dx = tap % s.k;
    bool inside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      inside[h] = (unsigned)(ih0[h] + dy) < (unsigned)s.h &&
                  (unsigned)(iw0[h] + dx) < (unsigned)s.w;
    hopper::mbar_wait(&full[st], (it / S) & 1);

    // A fragments: fragment r of k-step kk is row r % 2, channels 16 kk +
    // 8 (r / 2) + 2 q4 + {0, 1}, i.e. 16-byte chunk 2 kk + r / 2 at byte
    // 4 q4, the chunk swizzled by the row
    const uint8_t* pa = smem + L::a + st * kPanelBytes;
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rw = row_[r % 2];
        const int chunk = 2 * kk + r / 2;
        uint32_t v = *reinterpret_cast<const uint32_t*>(
            pa + rw * 128 + ((chunk ^ (rw & 7)) << 4) + 4 * q4);
        if (prologue) {
          const int c = c0 + 8 * chunk + 2 * q4;
          const __nv_bfloat162 xv = *reinterpret_cast<__nv_bfloat162*>(&v);
          v = hopper::pack_bf16(
              bn_apply<__nv_bfloat16>(__low2float(xv), scale_s[c], bias_s[c],
                                      relu),
              bn_apply<__nv_bfloat16>(__high2float(xv), scale_s[c + 1],
                                      bias_s[c + 1], relu));
        }
        af[kk][r] = inside[r % 2] ? v : 0u;
      }

    const uint64_t b_desc =
        hopper::desc_sw128(smem + L::b + st * NP * kPanelBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hopper::fence_acc(acc[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs(acc[p], af[kk],
                         hopper::desc_add(b_desc, p * kPanelBytes +
                                                      kk * 16 * 128));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) hopper::fence_acc(acc[p]);
    hopper::mbar_arrive(&empty[st]);
  }

  // y rounded once to bf16; accumulator entry 4 j + 2 h + e is row h,
  // column 64 p + 8 j + 2 q4 + e of the tile
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 64 * p + 8 * j + 2 * q4;
      const int co = co0 + cl;
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 q = __floats2bfloat162_rn(
            acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
        if (!live[h]) continue;
        if (co < s.co)
          *reinterpret_cast<__nv_bfloat162*>(
              y + ((size_t)rn[h] * s.ho * s.wo + roh[h]) * s.co + co) = q;
        const float lo = __low2float(q), hi = __high2float(q);
        sum[0] += lo;
        sum[1] += hi;
        sq[0] = fmaf(lo, lo, sq[0]);
        sq[1] = fmaf(hi, hi, sq[1]);
      }
      if (partial == nullptr) continue;
      // the warp's 8 row pairs of this column pair: xor shuffles give every
      // lane the same sums, in the same order
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
          sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], off);
        }
      if (lane < 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(warp * 2 + 0) * BN + cl + e] = sum[e];
          red[(warp * 2 + 1) * BN + cl + e] = sq[e];
        }
    }
  if (partial == nullptr) return;
  hopper::named_barrier(1, 128);
  // one partial row per pixel tile: the 4 warps' sums in warp order
  for (int c = tid; c < BN; c += 128) {
    if (co0 + c >= s.co) continue;
    float a = 0.f, b = 0.f;
    for (int w = 0; w < 4; ++w) {
      a += red[(w * 2 + 0) * BN + c];
      b += red[(w * 2 + 1) * BN + c];
    }
    float* row = partial + (size_t)tile * 2 * s.co;
    row[co0 + c] = a;
    row[s.co + co0 + c] = b;
  }
}

// The tensor-core geometry of a conv; false if the tile grid overflows.
bool tc_shape(int n, int h, int wd, int ci, int co, int k, int stride,
              TcShape* t) {
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
  t->cslices = (ci + 63) / 64;
  return (co + 63) / 64 <= 65535;
}

template <int BN>
cudaError_t launch_tc(const void* x, const void* w, const void* scale,
                      const void* bias, void* y, void* partial, void* stats,
                      const TcShape& t, int prologue, int relu,
                      cudaStream_t stream) {
  // x through one 4-D map per (row, column) parity of the input (one map
  // copied four times at stride 1): map 2 * ph + pw
  Maps4 xm;
  if (!strided_maps(&xm, x, t.n, t.h, t.w, t.ci, t.stride, t.g))
    return cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!hopper::panel_map(&tw, w, t.k * t.k, t.ci, t.co))
    return cudaErrorInvalidValue;
  const int smem = TcSmem<BN>::alloc(t.cslices * 64);
  cudaError_t err = cudaFuncSetAttribute(
      conv_fwd_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t.g.tiles, (t.co + BN - 1) / BN);
  conv_fwd_tc_kernel<BN><<<grid, 128 + 32, smem, stream>>>(
      xm, tw, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(stats ? partial : nullptr), t, prologue, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  return sum_rows(static_cast<float*>(partial),
                  static_cast<float*>(stats), t.g.tiles, 2 * t.co, stream);
}

// The number of pixel tiles (rows of the stats scratch) of a launch; -1
// for a shape the route does not take.
long long pixel_tiles(int n, int h, int wd, int ci, int co, int k,
                      int stride, int tensor_cores) {
  if (tensor_cores) {
    TcShape t;
    return tc_shape(n, h, wd, ci, co, k, stride, &t) ? t.g.tiles : -1;
  }
  const long long m = (long long)n * (h / stride) * (wd / stride);
  return (m + kTileM - 1) / kTileM;
}

// The channel block a launch runs with: chan_block (64 or 128 on the
// tensor cores; 64 on the CUDA cores, whose tile is fixed), or, at 0, the
// hand default (128 where it divides Co on the tensor cores, else 64);
// -1 for any other.
int chan_block_for(int co, int kind, int chan_block) {
  if (chan_block == 0) return kind == 2 && co % 128 == 0 ? 128 : 64;
  if (chan_block == 64 || (kind == 2 && chan_block == 128)) return chan_block;
  return -1;
}

}  // namespace

// x: (n, h, w, ci) NHWC; w: (k, k, ci, co) HWIO; y: (n, h/stride,
// w/stride, co), all of one dtype, contiguous. kind: 0 = float32 on the
// CUDA cores, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the tensor
// cores (ci and co multiples of 8, x and w 16-byte aligned). scale, bias:
// (ci,) float32, read when prologue != 0 (relu != 0 adds the ReLU). stats:
// (2, co) float32 or null; when given, partial is float32 scratch of
// (fused_conv_fwd_tiles(...), 2, co), and partial_rows its first
// dimension. k is 1 or 3, stride 1 or 2, and stride 2 needs even h and w.
// chan_block: the output channels a CTA (chan_block_for; 0 = the hand
// default). The K order is the same at every chan_block, so y and stats
// are bit for bit the same. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_conv_fwd(const void* x, const void* w, const void* scale,
                              const void* bias, void* y, void* partial,
                              int partial_rows, void* stats, int n, int h,
                              int wd, int ci, int co, int k, int stride,
                              int prologue, int relu, int kind,
                              int chan_block, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 || wd % 2)) ||
      (prologue && (scale == nullptr || bias == nullptr)) ||
      (stats != nullptr && partial == nullptr) || kind < 0 || kind > 2 ||
      (kind == 2 && (ci % 8 || co % 8)))
    return (int)cudaErrorInvalidValue;
  const int bn = chan_block_for(co, kind, chan_block);
  if (bn < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one partial row per pixel tile: a smaller buffer would be overrun
  const long long tiles = pixel_tiles(n, h, wd, ci, co, k, stride, kind == 2);
  if (tiles < 0 || (stats != nullptr && partial_rows != tiles))
    return (int)cudaErrorInvalidValue;
  if (kind == 2) {
    TcShape t;
    tc_shape(n, h, wd, ci, co, k, stride, &t);
    return bn == 128
               ? (int)launch_tc<128>(x, w, scale, bias, y, partial, stats, t,
                                     prologue, relu, st)
               : (int)launch_tc<64>(x, w, scale, bias, y, partial, stats, t,
                                    prologue, relu, st);
  }
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
  if (kind == 0)
    return launch<float>(x, w, scale, bias, y, partial, stats, s, prologue,
                         relu, st);
  return launch<__nv_bfloat16>(x, w, scale, bias, y, partial, stats, s,
                               prologue, relu, st);
}

// The row count of fused_conv_fwd's stats scratch for these arguments (the
// launch's own kind and chan_block): one row per pixel tile; -1 if it
// takes none.
extern "C" long long fused_conv_fwd_tiles(int n, int h, int wd, int ci,
                                          int co, int k, int stride,
                                          int kind, int chan_block) {
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || stride < 1 ||
      chan_block_for(co, kind, chan_block) < 0)
    return -1;
  return pixel_tiles(n, h, wd, ci, co, k, stride, kind == 2);
}
