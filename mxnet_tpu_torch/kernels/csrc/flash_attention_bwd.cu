// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, each replacing one Pallas TPU kernel of
// mxnet_tpu/kernels/flash_attention.py (both launched by `_bwd_call`):
//   B6, flash_bwd_dq_tc_kernel (bf16) and flash_bwd_dq_kernel (fp32),
//   replaces `_bwd_dq_kernel`:
//       dq = scale * sum_c ds[r, c] k[c]
//   B7, flash_bwd_dkv_tc_kernel (bf16) and flash_bwd_dkv_kernel (fp32),
//   replaces `_bwd_dkv_kernel`:
//       dv = sum_r p[r, c] do[r],   dk = scale * sum_r ds[r, c] q[r]
// with, recomputed per tile from the forward's fp32 row logsumexp `lse`
// and delta[r] = rowsum(do[r] * out[r]) (computed by the wrapper, as the
// JAX package computes it outside its kernels):
//   p  = exp(scale * q . k^T - lse),  masked entries 0,
//   ds = p * (do . v^T - delta).
// Same function as the TPU kernels, not a block-by-block copy. Masks are
// those of the forward (flash_attention_fwd.cu): key columns >= kv_len are
// padding, and under `causal` column c is live for row r iff r >= c (both
// from 0). Key rows at or past kv_len get zero gradients. Each output
// element has one writer and there are no atomics, so the result is the
// same on every run.
//
// What bounds them on the H100. With L live scores, B6 does 3 products of
// 2*D operations per live score (q.k, do.v, ds.k): 6*D*L; B7 does 4 (q.k,
// do.v, p^T.do, ds^T.q): 8*D*L. At the training shape (8, 8, 2048, 64)
// bf16 causal, L = 134,283,264: B6 51.6 GFLOP (0.052 ms at the 989
// TFLOP/s bf16 tensor-core peak) against ~85 MB of traffic (0.025 ms at
// 3.35 TB/s); B7 68.7 GFLOP (0.069 ms) against ~102 MB (0.030 ms). So
// operations bound both, and only the tensor cores come near the bound.
//
// The dtype split of both, one kernel each (a dispatch in the C entry
// point, not a fallback): bfloat16, the main path, runs the _tc kernels on
// the tensor cores (wgmma fed by TMA); float32 runs the others on the fp32
// CUDA cores, since the fp32 checks (1e-4 against full fp32) do not admit
// the TF32 the tensor cores would give it. Every kernel puts B*H on the
// grid's x (up to 2^31 - 1) and the query or key blocks on its y.
//
// The tile of the bf16 kernels is a launch parameter, the forward's
// (block_q, block_k) (flash_attention_fwd.cu): one schedule drives all
// three kernels. A kernel's own rows (key rows in B7: block_k; query rows
// in B6: block_q) are 64 RW, RW row groups of 64 that share every streamed
// tile; the streamed axis (query rows in B7, keys in B6) comes in slots of
// NQ or NK sub-tiles of 64, taken one after another. (RW, N) in {1, 2}^2 at
// D = 64 and 128, and (1, 1) at D = 256 (DqSmem / DkvSmem: 192 KB there).
// A CTA has at most two consumer warpgroups (BwdCols): up to D = 128 with
// one row group, one per 64 columns of the gradients; with two row groups,
// one each, keeping all D columns; at D = 256, two, each keeping 128
// columns. Every consumer of a row group computes the whole score tiles.
//
// Design of B7 in bf16 (hopper_mma.cuh has the shared layouts).
//   * One CTA per (b*h, key block): the consumer warpgroups above and one
//     producer warp. The producer loads the block's K and V once (they stay
//     resident) and streams the Q and dO slots, from the first query tile
//     that can see the key block (causal) to the last, through a ring of
//     kStages slots with TMA (3-D tensor maps over (B*H, S, D): rows past S
//     read zeros). Its 32 lanes also copy the slot's lse (times log2 e;
//     +inf past seq_q, so padded query rows get p = 0 without a mask) and
//     delta values into the slot before arriving on its full barrier.
//   * Scores are computed key-major, so the products that reduce over
//     queries take their A operand from registers: S^T = K . Q^T and
//     dP^T = V . dO^T (both operands K-major, D/16 k-steps each), then in
//     fp32 registers P^T = exp(scale * S^T - lse[col]) (the causal mask on
//     the diagonal sub-tile only) and dS^T = P^T * (dP^T - delta[col]). P^T
//     and dS^T are rounded once to bf16 as the A operands of dV += P^T . dO
//     and dK += dS^T . Q, with dO and Q MN-major (transpose-B). A sub-tile
//     whose queries all precede the row group's keys (causal), and a row
//     group wholly past kv_len, are skipped.
//   * dK is multiplied by scale once at the end; dK and dV are rounded once
//     to bf16, and rows >= kv_len are written as zeros.
//
// Design of B6 in bf16, on the same panels (query-major, as the TPU kernel).
//   * One CTA per (b*h, query block): the consumer warpgroups above and one
//     producer warp. The producer loads the block's Q and dO panels once,
//     with its lse (times log2 e; +inf past seq_q, so padded query rows get
//     p = 0 without a mask) and delta values, then streams the K and V
//     slots, up to the causal diagonal and kv_len, through a ring of
//     kStages slots with TMA.
//   * Per 64-key sub-tile: S = Q . K^T and dP = dO . V^T (both operands
//     K-major), then in fp32 registers p = exp2(scale * S - lse) (masks on
//     the causal diagonal sub-tile and the kv_len sub-tile only) and dS =
//     p * (dP - delta). dS is rounded once to bf16 as the A operand of dQ
//     += dS . K, with K MN-major (transpose-B): the form of B5's P . V.
//   * Under `causal` the query blocks are launched heaviest (last) first.
//     dQ is multiplied by scale once at the end and rounded once to bf16.
//
// Design of B6 and B7 in fp32. The TPU's split is kept: B6 has one CTA
// per (b*h, BR-row query block) looping over 64-column K/V tiles (up to the
// causal diagonal and kv_len, like the forward); B7 one CTA per (b*h,
// BR-row key block) looping over 64-row query tiles from the first that
// can see the key block. BR is 64, or 32 at D = 256 (f32_rows; 64 would not
// fit shared memory). Threads form a (BR / 4) x 16 grid: thread (ty, tx)
// owns the CTA's rows 4*ty .. 4*ty+3 (query rows in B6, key rows in B7),
// score columns tx + 16*j (j < 4) and accumulator columns tx + 16*j (j <
// D/16). Both score tiles of a step (q.k and do.v) come out of one loop
// over D. The p / ds tile a row group writes is read back only by the same
// half warp (__syncwarp). Accumulators stay in fp32 registers; the scale
// rides on q as it is loaded, so B6 multiplies dq by scale once at the
// end, as the TPU kernels do. Their tile is fixed (the schedule (64, 64)
// only). Shared memory (fp32): B6 85 / 150 / 202 KB at D = 64 / 128 / 256,
// B7 102 / 167 / 210 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_wide.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

// The fp32 kernels' own rows (query rows in B6, key rows in B7) a CTA: 64,
// or 32 at D = 256, where 64 would not fit shared memory. A CTA has BR * 4
// threads, a (BR / 4) x 16 grid.
template <int D>
constexpr int f32_rows() { return D == 256 ? 32 : 64; }

template <int D, int BR>
constexpr int dq_smem_floats() {
  return 2 * BR * (D + 4) + 2 * kBlockK * (D + 1) + BR * (kBlockK + 1);
}

template <int D, int BR>
constexpr int dkv_smem_floats() {
  return 2 * BR * (D + 4) + 2 * kBlockQ * (D + 1) + 2 * BR * (kBlockQ + 1) +
         2 * kBlockQ;
}

// B6 in fp32: dq for one (b*h, BR-row query block).
template <int D, int BR>
__global__ void __launch_bounds__(BR * 4)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int seq_q, int seq_k, int kv_len, float scale,
                    int causal) {
  constexpr int QS = D + 4;        // row-read tiles: broadcast per half warp
  constexpr int KS = D + 1;        // column-read tiles: distinct banks
  constexpr int PS = kBlockK + 1;
  constexpr int DC = D / 16;
  constexpr int NT = BR * 4;
  extern __shared__ float smem[];
  float* qs = smem;                      // BR x QS, q * scale
  float* dos = qs + BR * QS;             // BR x QS
  float* ks = dos + BR * QS;             // kBlockK x KS
  float* vs = ks + kBlockK * KS;         // kBlockK x KS
  float* dss = vs + kBlockK * KS;        // BR x PS

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BR;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float* qb = q + bh * seq_q * D;
  const float* ob = dout + bh * seq_q * D;
  const float* kb = k + bh * seq_k * D;
  const float* vb = v + bh * seq_k * D;

  for (int i = tid; i < BR * D; i += NT) {
    const int r = i / D, d = i % D;
    const bool live = q0 + r < seq_q;
    const size_t g = (size_t)(q0 + r) * D + d;
    qs[r * QS + d] = live ? qb[g] * scale : 0.f;
    dos[r * QS + d] = live ? ob[g] : 0.f;
  }

  float row_lse[4], row_delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < seq_q ? lse[bh * seq_q + row] : 0.f;
    row_delta[i] = row < seq_q ? delta[bh * seq_q + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kb = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) n_kb = min(n_kb, (q0 + BR + kBlockK - 1) / kBlockK);

  for (int j = 0; j < n_kb; ++j) {
    const int c0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done (and q is in)
    for (int i = tid; i < kBlockK * D; i += NT) {
      const int c = i / D, d = i % D;
      const bool live = c0 + c < seq_k;
      const size_t g = (size_t)(c0 + c) * D + d;
      ks[c * KS + d] = live ? kb[g] : 0.f;
      vs[c * KS + d] = live ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * QS + d];
        ov[i] = dos[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = ks[(tx + 16 * c) * KS + d];
        vv[c] = vs[(tx + 16 * c) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + tx + 16 * c;
        const bool masked = col >= kv_len || (causal && row < col);
        const float p = masked ? 0.f : expf(s[i][c] - row_lse[i]);
        dss[(ty * 4 + i) * PS + tx + 16 * c] = p * (dp[i][c] - row_delta[i]);
      }
    }
    __syncwarp();  // a row's ds entries come from its own half warp

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float kv = ks[c * KS + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(dsv[i], kv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    float* orow = dq + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * scale;
  }
}

// B7 in fp32: dk and dv for one (b*h, BR-row key block).
template <int D, int BR>
__global__ void __launch_bounds__(BR * 4)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int seq_q, int seq_k, int kv_len,
                     float scale, int causal) {
  constexpr int KS = D + 4;        // this block's key rows, read by rows
  constexpr int QS = D + 1;        // query tiles, read by columns
  constexpr int PS = kBlockQ + 1;
  constexpr int DC = D / 16;
  constexpr int NT = BR * 4;
  extern __shared__ float smem[];
  float* ks = smem;                      // BR x KS
  float* vs = ks + BR * KS;              // BR x KS
  float* qs = vs + BR * KS;              // kBlockQ x QS, q * scale
  float* dos = qs + kBlockQ * QS;        // kBlockQ x QS
  float* ps = dos + kBlockQ * QS;        // BR x PS, p^T
  float* dss = ps + BR * PS;             // BR x PS, ds^T
  float* lse_s = dss + BR * PS;          // kBlockQ
  float* delta_s = lse_s + kBlockQ;      // kBlockQ

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BR;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float* qb = q + bh * seq_q * D;
  const float* ob = dout + bh * seq_q * D;
  const float* kb = k + bh * seq_k * D;
  const float* vb = v + bh * seq_k * D;

  for (int i = tid; i < BR * D; i += NT) {
    const int r = i / D, d = i % D;
    const bool live = k0 + r < seq_k;
    const size_t g = (size_t)(k0 + r) * D + d;
    ks[r * KS + d] = live ? kb[g] : 0.f;
    vs[r * KS + d] = live ? vb[g] : 0.f;
  }

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // query blocks before this key block see none of it under `causal`; a
  // key block wholly at or past kv_len is padding and keeps zero gradients
  const int start_qb = causal ? k0 / kBlockQ : 0;
  const int n_qb = k0 < kv_len ? (seq_q + kBlockQ - 1) / kBlockQ : 0;

  for (int jq = start_qb; jq < n_qb; ++jq) {
    const int r0 = jq * kBlockQ;
    __syncthreads();  // the previous tile's readers are done (and k/v are in)
    for (int i = tid; i < kBlockQ * D; i += NT) {
      const int r = i / D, d = i % D;
      const bool live = r0 + r < seq_q;
      const size_t g = (size_t)(r0 + r) * D + d;
      qs[r * QS + d] = live ? qb[g] * scale : 0.f;
      dos[r * QS + d] = live ? ob[g] : 0.f;
    }
    if (tid < kBlockQ) {
      const bool live = r0 + tid < seq_q;
      lse_s[tid] = live ? lse[bh * seq_q + r0 + tid] : 0.f;
      delta_s[tid] = live ? delta[bh * seq_q + r0 + tid] : 0.f;
    }
    __syncthreads();

    // s[i][c] = score of key row ty*4+i against query row tx+16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * KS + d];
        vv[i] = vs[(ty * 4 + i) * KS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = qs[(tx + 16 * c) * QS + d];
        ov[c] = dos[(tx + 16 * c) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + tx + 16 * c;  // query row
      const float l = lse_s[tx + 16 * c];
      const float dl = delta_s[tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;  // key column
        const bool masked =
            col >= kv_len || row >= seq_q || (causal && row < col);
        const float p = masked ? 0.f : expf(s[i][c] - l);
        ps[(ty * 4 + i) * PS + tx + 16 * c] = p;
        dss[(ty * 4 + i) * PS + tx + 16 * c] = p * (dp[i][c] - dl);
      }
    }
    __syncwarp();  // a key row's p / ds entries come from its own half warp

#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty * 4 + i) * PS + r];
        dsv[i] = dss[(ty * 4 + i) * PS + r];
      }
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float ov = dos[r * QS + tx + 16 * dc];
        const float qv = qs[r * QS + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][dc] = fmaf(pv[i], ov, acc_v[i][dc]);
          acc_k[i][dc] = fmaf(dsv[i], qv, acc_k[i][dc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= seq_k) continue;
    float* krow = dk + (bh * seq_k + row) * D;
    float* vrow = dv + (bh * seq_k + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = acc_k[i][c];
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}

// ---- B7 in bfloat16: tensor cores ------------------------------------------

using namespace hopper;

constexpr int kStages = 2;               // Q/dO ring slots (B7), K/V (B6)
constexpr float kLog2e = 1.4426950408889634f;

// The consumer warpgroups of a backward CTA: RW row groups of 64 own rows
// (key rows in B7, query rows in B6) times CW column groups, each keeping
// PC 64-column panels of the gradient(s). At most two consumer
// warpgroups: CW = P (one panel each) up to D = 128 with one row group,
// else one column group per row group; at D = 256, two column groups of
// two panels. Every column group of a row group computes the whole score
// tiles.
template <int D, int RW>
struct BwdCols {
  static constexpr int P = D / 64;
  static constexpr int CW = RW == 1 ? (P < 2 ? P : 2) : 1;
  static constexpr int PC = P / CW;
  static constexpr int NC = 128 * RW * CW;  // consumer threads
};

// Shared memory, in bytes from a 1024-aligned base: RW x P K panels and as
// many V panels (resident), kStages x NQ x P Q panels and as many dO panels
// (NQ 64-row sub-tiles a slot), kStages x 64 NQ lse and delta values, then
// the mbarriers.
template <int D, int RW, int NQ>
struct DkvSmem {
  static constexpr int P = D / 64;
  static constexpr int k = 0;
  static constexpr int v = k + RW * P * kPanelBytes;
  static constexpr int q = v + RW * P * kPanelBytes;
  static constexpr int dout = q + kStages * NQ * P * kPanelBytes;
  static constexpr int lse = dout + kStages * NQ * P * kPanelBytes;
  static constexpr int delta = lse + kStages * 64 * NQ * 4;
  static constexpr int bars = delta + kStages * 64 * NQ * 4;
  static constexpr int alloc = bars + (1 + 2 * kStages) * 8 + 1024;
};

// block_k = 64 RW key rows a CTA, block_q = 64 NQ query rows a slot.
template <int D, int RW, int NQ>
__global__ void __launch_bounds__(BwdCols<D, RW>::NC + 32)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int seq_q, int seq_k,
                        int kv_len, float scale, int causal) {
  using L = DkvSmem<D, RW, NQ>;
  using C = BwdCols<D, RW>;
  constexpr int P = L::P;
  constexpr int PC = C::PC;
  constexpr int NC = C::NC;
  constexpr int BQ = 64 * NQ, BK = 64 * RW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // causal: low key blocks, the longest
                                   // loops, have the low indices
  // query tiles before this key block see none of it under `causal`; a key
  // block wholly at or past kv_len is padding and keeps zero gradients
  const int start = causal ? k0 / BQ : 0;
  const int n_it =
      k0 < kv_len ? max(0, (seq_q + BQ - 1) / BQ - start) : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp
    if (n_it == 0) return;
    const int lane = tid - NC;
    const float* lse_bh = lse + (size_t)bh * seq_q;
    const float* delta_bh = delta + (size_t)bh * seq_q;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * RW * P * kPanelBytes);
      for (int r = 0; r < RW; ++r)
        for (int p = 0; p < P; ++p) {
          tma_load_panel(smem + L::k + (r * P + p) * kPanelBytes, &tk,
                         kv_full, 64 * p, k0 + 64 * r, bh);
          tma_load_panel(smem + L::v + (r * P + p) * kPanelBytes, &tv,
                         kv_full, 64 * p, k0 + 64 * r, bh);
        }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int r0 = (start + it) * BQ;
      if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * NQ * P * kPanelBytes);
        for (int t = 0; t < NQ; ++t)
          for (int p = 0; p < P; ++p) {
            const int off = ((s * NQ + t) * P + p) * kPanelBytes;
            tma_load_panel(smem + L::q + off, &tq, &full[s], 64 * p,
                           r0 + 64 * t, bh);
            tma_load_panel(smem + L::dout + off, &tdo, &full[s], 64 * p,
                           r0 + 64 * t, bh);
          }
      }
      for (int c = lane; c < BQ; c += 32) {
        const int r = r0 + c;
        lse_s[s * BQ + c] = r < seq_q ? lse_bh[r] * kLog2e
                                      : __int_as_float(0x7f800000);
        delta_s[s * BQ + c] = r < seq_q ? delta_bh[r] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int wg = tid / 128;
  const int rw = wg / C::CW;           // the warpgroup's 64 key rows
  const int cw = wg % C::CW;           // and its columns of dK, dV
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kr0 = k0 + 64 * rw;
  const int krow = kr0 + 16 * warp + lane / 4;  // and krow + 8
  const float scale2 = scale * kLog2e;
  const uint64_t k_desc = desc_sw128(smem + L::k + rw * P * kPanelBytes);
  const uint64_t v_desc = desc_sw128(smem + L::v + rw * P * kPanelBytes);
  // a row group wholly at or past kv_len keeps zero gradients
  const bool group_live = kr0 < kv_len;

  float acc_k[PC][32], acc_v[PC][32];
#pragma unroll
  for (int p = 0; p < PC; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[p][i] = acc_v[p][i] = 0.f;

  if (n_it > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int r0 = (start + it) * BQ;
    mbar_wait(&full[s], (it / kStages) & 1);
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      const int qr0 = r0 + 64 * t;
      // (causal) query rows all before the group's keys see none of them
      if (!group_live || (causal && qr0 + 63 < kr0)) continue;
      const int off = (s * NQ + t) * P * kPanelBytes;
      const uint64_t q_desc = desc_sw128(smem + L::q + off);
      const uint64_t do_desc = desc_sw128(smem + L::dout + off);

      // S^T = K . Q^T and dP^T = V . dO^T: key rows by query columns
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
      fence_acc(st);
      fence_acc(dpt);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss(st, desc_add(k_desc, ko), desc_add(q_desc, ko), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss(dpt, desc_add(v_desc, ko), desc_add(do_desc, ko), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);

      // P^T and dS^T in fp32; query column c: 8j + 2(lane%4) + e
      const float* ls = lse_s + s * BQ + 64 * t;
      const float* dl = delta_s + s * BQ + 64 * t;
      const bool diag = causal && qr0 == kr0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2f(st[i] * scale2 - (e ? l2.y : l2.x));
            if (diag && qr0 + c + e < krow + 8 * h) p = 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] - (e ? d2.y : d2.x));
          }
      }
      uint32_t a_p[4][4], a_ds[4][4];
      to_a_frags(st, a_p);
      to_a_frags(dpt, a_ds);

      // dV += P^T . dO and dK += dS^T . Q over this warpgroup's columns
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        fence_acc(acc_v[p]);
        fence_acc(acc_k[p]);
        const uint32_t co = (cw * PC + p) * kPanelBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc_v[p], a_p[kk], desc_add(do_desc, co + kk * 16 * 128));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc_k[p], a_ds[kk], desc_add(q_desc, co + kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        fence_acc(acc_v[p]);
        fence_acc(acc_k[p]);
      }
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = krow + 8 * h;
    if (r >= seq_k) continue;
    // a padded key's p is unbounded (its scores are not in lse): select
    // zeros rather than scale them
    const bool live = r < kv_len;
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      const int c0 = 64 * (cw * PC + p);
      __nv_bfloat16* krow_p = dk + ((size_t)bh * seq_k + r) * D + c0;
      __nv_bfloat16* vrow_p = dv + ((size_t)bh * seq_k + r) * D + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(krow_p + c) =
            __floats2bfloat162_rn(live ? acc_k[p][i] * scale : 0.f,
                                  live ? acc_k[p][i + 1] * scale : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(vrow_p + c) =
            __floats2bfloat162_rn(live ? acc_v[p][i] : 0.f,
                                  live ? acc_v[p][i + 1] : 0.f);
      }
    }
  }
}

template <int D, int RW, int NQ>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int bh,
                          int seq_q, int seq_k, int kv_len, float scale,
                          int causal, cudaStream_t stream) {
  if ((seq_k + 64ll * RW - 1) / (64 * RW) > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!panel_map(&tq, q, bh, seq_q, D) || !panel_map(&tk, k, bh, seq_k, D) ||
      !panel_map(&tv, v, bh, seq_k, D) ||
      !panel_map(&tdo, dout, bh, seq_q, D))
    return cudaErrorInvalidValue;
  constexpr int smem = DkvSmem<D, RW, NQ>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D, RW, NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_k + 64 * RW - 1) / (64 * RW));
  flash_bwd_dkv_tc_kernel<D, RW, NQ>
      <<<grid, BwdCols<D, RW>::NC + 32, smem, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), seq_q, seq_k, kv_len, scale,
          causal);
  return cudaGetLastError();
}

// ---- B6 in bfloat16: tensor cores ----------------------------------------

// Shared memory, in bytes from a 1024-aligned base: RW x P Q panels and as
// many dO panels (resident), kStages x NK x P K panels and as many V panels
// (NK 64-key sub-tiles a slot), the block's 64 RW lse and delta values,
// then the mbarriers.
template <int D, int RW, int NK>
struct DqSmem {
  static constexpr int P = D / 64;
  static constexpr int q = 0;
  static constexpr int dout = q + RW * P * kPanelBytes;
  static constexpr int k = dout + RW * P * kPanelBytes;
  static constexpr int v = k + kStages * NK * P * kPanelBytes;
  static constexpr int lse = v + kStages * NK * P * kPanelBytes;
  static constexpr int delta = lse + 64 * RW * 4;
  static constexpr int bars = delta + 64 * RW * 4;
  static constexpr int alloc = bars + (1 + 2 * kStages) * 8 + 1024;
};

// block_q = 64 RW query rows a CTA, block_k = 64 NK keys a slot.
template <int D, int RW, int NK>
__global__ void __launch_bounds__(BwdCols<D, RW>::NC + 32)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int seq_q, int kv_len,
                       float scale, int causal) {
  using L = DqSmem<D, RW, NK>;
  using C = BwdCols<D, RW>;
  constexpr int P = L::P;
  constexpr int PC = C::PC;
  constexpr int NC = C::NC;
  constexpr int BQ = 64 * RW, BK = 64 * NK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int q0 = qb * BQ;
  int n_kb = (kv_len + BK - 1) / BK;
  if (causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);  // to the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp
    const int lane = tid - NC;
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * RW * P * kPanelBytes);
      for (int r = 0; r < RW; ++r)
        for (int p = 0; p < P; ++p) {
          tma_load_panel(smem + L::q + (r * P + p) * kPanelBytes, &tq, q_full,
                         64 * p, q0 + 64 * r, bh);
          tma_load_panel(smem + L::dout + (r * P + p) * kPanelBytes, &tdo,
                         q_full, 64 * p, q0 + 64 * r, bh);
        }
    }
    const float* lse_bh = lse + (size_t)bh * seq_q;
    const float* delta_bh = delta + (size_t)bh * seq_q;
    for (int c = lane; c < BQ; c += 32) {
      const int r = q0 + c;
      lse_s[c] = r < seq_q ? lse_bh[r] * kLog2e : __int_as_float(0x7f800000);
      delta_s[c] = r < seq_q ? delta_bh[r] : 0.f;
    }
    mbar_arrive(q_full);
    if (lane == 0)
      for (int j = 0; j < n_kb; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * NK * P * kPanelBytes);
        for (int t = 0; t < NK; ++t)
          for (int p = 0; p < P; ++p) {
            const int off = ((s * NK + t) * P + p) * kPanelBytes;
            tma_load_panel(smem + L::k + off, &tk, &full[s], 64 * p,
                           j * BK + 64 * t, bh);
            tma_load_panel(smem + L::v + off, &tv, &full[s], 64 * p,
                           j * BK + 64 * t, bh);
          }
      }
    return;
  }

  const int wg = tid / 128;
  const int rw = wg / C::CW;           // the warpgroup's 64 query rows
  const int cw = wg % C::CW;           // and its columns of dQ
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int rl = 64 * rw + 16 * warp + lane / 4;  // block rows rl, rl + 8
  const int r0 = q0 + 64 * rw;
  const int row = q0 + rl;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  const uint64_t q_desc = desc_sw128(smem + L::q + rw * P * kPanelBytes);
  const uint64_t do_desc = desc_sw128(smem + L::dout + rw * P * kPanelBytes);

  float acc[PC][32];
#pragma unroll
  for (int p = 0; p < PC; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  mbar_wait(q_full, 0);
  const float ls[2] = {lse_s[rl], lse_s[rl + 8]};
  const float dl[2] = {delta_s[rl], delta_s[rl + 8]};
  for (int j = 0; j < n_kb; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      const int c0 = j * BK + 64 * t;
      // a sub-tile wholly past kv_len, or (causal) past the group's last
      // row, adds nothing
      if (c0 >= kv_len || (causal && c0 > r0 + 63)) continue;
      const int off = (s * NK + t) * P * kPanelBytes;
      const uint64_t k_desc = desc_sw128(smem + L::k + off);
      const uint64_t v_desc = desc_sw128(smem + L::v + off);

      // S = Q . K^T and dP = dO . V^T: query rows by key columns
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      fence_acc(sc);
      fence_acc(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss(sc, desc_add(q_desc, ko), desc_add(k_desc, ko), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss(dp, desc_add(do_desc, ko), desc_add(v_desc, ko), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // p and dS in fp32; entry i is row row + 8h, key column
      // c0 + 8(i / 4) + 2(lane % 4) + i % 2
      const bool edge = (causal && c0 + 64 > r0) || c0 + 64 > kv_len;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        float p = exp2f(sc[i] * scale2 - ls[h]);
        if (edge) {
          const int col = c0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (col >= kv_len || (causal && row + 8 * h < col)) p = 0.f;
        }
        sc[i] = p * (dp[i] - dl[h]);
      }
      uint32_t a_ds[4][4];
      to_a_frags(sc, a_ds);

      // dQ += dS . K over this warpgroup's columns
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        fence_acc(acc[p]);
        const uint32_t co = (cw * PC + p) * kPanelBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[p], a_ds[kk], desc_add(k_desc, co + kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PC; ++p) fence_acc(acc[p]);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= seq_q) continue;
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      __nv_bfloat16* orow =
          dq + ((size_t)bh * seq_q + r) * D + 64 * (cw * PC + p);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * (lane % 4);
        const int i = 4 * jj + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[p][i] * scale, acc[p][i + 1] * scale);
      }
    }
  }
}

template <int D, int RW, int NK>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int bh, int seq_q, int seq_k, int kv_len,
                         float scale, int causal, cudaStream_t stream) {
  if ((seq_q + 64ll * RW - 1) / (64 * RW) > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!panel_map(&tq, q, bh, seq_q, D) || !panel_map(&tk, k, bh, seq_k, D) ||
      !panel_map(&tv, v, bh, seq_k, D) ||
      !panel_map(&tdo, dout, bh, seq_q, D))
    return cudaErrorInvalidValue;
  constexpr int smem = DqSmem<D, RW, NK>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D, RW, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + 64 * RW - 1) / (64 * RW));
  flash_bwd_dq_tc_kernel<D, RW, NK>
      <<<grid, BwdCols<D, RW>::NC + 32, smem, stream>>>(
          tq, tk, tv, tdo, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
          seq_q, kv_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq_q, int seq_k, int kv_len,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int BR = f32_rows<D>();
  if ((seq_q + (long long)BR - 1) / BR > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_floats<D, BR>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + BR - 1) / BR);
  flash_bwd_dq_kernel<D, BR><<<grid, BR * 4, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), seq_q, seq_k, kv_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       int kv_len, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int BR = f32_rows<D>();
  if ((seq_k + (long long)BR - 1) / BR > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_floats<D, BR>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_k + BR - 1) / BR);
  flash_bwd_dkv_kernel<D, BR><<<grid, BR * 4, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), seq_q, seq_k, kv_len,
      scale, causal);
  return cudaGetLastError();
}

bool bad_dims(int bh, int seq_q, int seq_k, int kv_len) {
  return bh < 1 || seq_q < 1 || seq_k < 1 || kv_len < 1 || kv_len > seq_k;
}

}  // namespace

// The tensor-core tiles (block_q, block_k) every entry point instantiates:
// (64 or 128, 64 or 128) at d 64 and 128, (64, 64) at d 256 (shared
// memory), FLASH_TC_TILES in flash_attention.py. float32 takes (64, 64).
#define FLASH_TC_TILES(X) \
  X(64, 64, 64)           \
  X(64, 64, 128)          \
  X(64, 128, 64)          \
  X(64, 128, 128)         \
  X(128, 64, 64)          \
  X(128, 64, 128)         \
  X(128, 128, 64)         \
  X(128, 128, 128)        \
  X(256, 64, 64)

// q, dout, dq: (bh, seq_q, d); k, v: (bh, seq_k, d); lse, delta: (bh,
// seq_q) f32. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores;
// q, k, v, dout 16-byte aligned). d: 64, 128 or 256, or above 256 a multiple
// of 128 (the wide route of flash_attention_wide.cuh, both dtypes, tile
// (64, 64) only). 1 <= kv_len <= seq_k.
// (block_q, block_k): the tile, as in flash_attention_fwd. Launches B6 on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int seq_q, int seq_k,
                                      int d, int kv_len, float scale,
                                      int causal, int dtype, int block_q,
                                      int block_k, void* stream) {
  if (bad_dims(bh, seq_q, seq_k, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 256) {  // the wide route (flash_attention_wide.cuh), hand tile only
    if (block_q != kBlockQ || block_k != kBlockK || (dtype != 0 && dtype != 1))
      return (int)cudaErrorInvalidValue;
    return dtype == 0
               ? (int)wide::launch_dq<float>(q, k, v, dout, lse, delta, dq,
                                             bh, seq_q, seq_k, d, kv_len,
                                             scale, causal, s)
               : (int)wide::launch_dq<__nv_bfloat16>(
                     q, k, v, dout, lse, delta, dq, bh, seq_q, seq_k, d,
                     kv_len, scale, causal, s);
  }
  if (dtype == 0) {
    if (block_q != kBlockQ || block_k != kBlockK)
      return (int)cudaErrorInvalidValue;
    switch (d) {
      case 64:
        return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, seq_q,
                                  seq_k, kv_len, scale, causal, s);
      case 128:
        return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, seq_q,
                                   seq_k, kv_len, scale, causal, s);
      case 256:
        return (int)launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, seq_q,
                                   seq_k, kv_len, scale, causal, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define DQ_TC(D_, BQ_, BK_)                                                 \
  if (d == D_ && block_q == BQ_ && block_k == BK_)                          \
    return (int)launch_dq_tc<D_, BQ_ / 64, BK_ / 64>(                       \
        q, k, v, dout, lse, delta, dq, bh, seq_q, seq_k, kv_len, scale,     \
        causal, s);
  FLASH_TC_TILES(DQ_TC)
#undef DQ_TC
  return (int)cudaErrorInvalidValue;
}

// As above, with dk, dv: (bh, seq_k, d). Launches B7: in bfloat16 on the
// tensor cores (q, k, v, dout 16-byte aligned), in float32 on the CUDA
// cores.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int seq_q,
                                       int seq_k, int d, int kv_len,
                                       float scale, int causal, int dtype,
                                       int block_q, int block_k,
                                       void* stream) {
  if (bad_dims(bh, seq_q, seq_k, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 256) {  // the wide route (flash_attention_wide.cuh), hand tile only
    if (block_q != kBlockQ || block_k != kBlockK || (dtype != 0 && dtype != 1))
      return (int)cudaErrorInvalidValue;
    return dtype == 0
               ? (int)wide::launch_dkv<float>(q, k, v, dout, lse, delta, dk,
                                              dv, bh, seq_q, seq_k, d, kv_len,
                                              scale, causal, s)
               : (int)wide::launch_dkv<__nv_bfloat16>(
                     q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, d,
                     kv_len, scale, causal, s);
  }
  if (dtype == 0) {
    if (block_q != kBlockQ || block_k != kBlockK)
      return (int)cudaErrorInvalidValue;
    switch (d) {
      case 64:
        return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   seq_q, seq_k, kv_len, scale, causal, s);
      case 128:
        return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    seq_q, seq_k, kv_len, scale, causal, s);
      case 256:
        return (int)launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    seq_q, seq_k, kv_len, scale, causal, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define DKV_TC(D_, BQ_, BK_)                                                \
  if (d == D_ && block_q == BQ_ && block_k == BK_)                          \
    return (int)launch_dkv_tc<D_, BK_ / 64, BQ_ / 64>(                      \
        q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, kv_len, scale, \
        causal, s);
  FLASH_TC_TILES(DKV_TC)
#undef DKV_TC
  return (int)cudaErrorInvalidValue;
}
