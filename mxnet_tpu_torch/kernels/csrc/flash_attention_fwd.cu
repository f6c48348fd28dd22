// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// mxnet_tpu/kernels/flash_attention.py (launched by `_fwd_call`). Same
// function, not a block-by-block copy:
//   out[r] = softmax(scale * q[r] . k^T, masked) @ v,   lse[r] = logsumexp
// on (B*H, S, D) tensors, with an fp32 online softmax (running max m,
// denominator l, unnormalised accumulator), key columns >= kv_len masked,
// and under `causal` the columns past the query row masked (row >= col,
// rows and columns both counted from 0). Masked scores are -1e30, as in the
// TPU kernel, so a row whose keys are all masked would average v; the
// wrapper requires kv_len >= 1, so column 0 is always live.
//
// What bounds it on the H100. At the training shape (8, 8, 2048, 64) bf16,
// causal, the work is 4 * D * S(S+1)/2 * B*H ~= 34.4 GFLOP (0.035 ms at the
// 989 TFLOP/s bf16 tensor-core peak) against ~17 MB of q/k/v/out/lse
// traffic (~0.005 ms at 3.35 TB/s): operations bound it, and only the
// tensor cores come near that bound.
//
// The dtype split, one kernel each (a dispatch in the C entry point, not a
// fallback):
//   * bfloat16, the main path (training and serving): flash_fwd_tc_kernel,
//     wgmma tensor-core products fed by TMA. P is rounded once to bf16 as
//     the A operand of P . V (the TPU kernel keeps it in fp32).
//   * float32: flash_fwd_f32_kernel, the products on the fp32 CUDA cores.
//     On the tensor cores fp32 would be TF32, which the fp32 checks (1e-4
//     against full fp32) do not admit.
//
// Design of the bf16 kernel (hopper_mma.cuh has the shared layouts).
//   * A CTA is one consumer warpgroup of 128 threads, owning 64 query
//     rows, and one producer warp. The producer loads the CTA's Q panels
//     once and streams 64-key K/V tiles through a ring of kStages slots
//     with TMA, each slot guarded by a full and an empty mbarrier. The
//     tensor maps are 3-D over (B*H, S, D), so a tile past S reads zeros
//     and never the next head's rows.
//   * S = Q . K^T is 4 (D = 64) or 8 (D = 128) wgmma k-steps, both
//     operands K-major; the fp32 accumulator is multiplied by scale (in
//     log2 units, for exp2). The online softmax runs on the accumulator
//     fragments: a row's 64 entries sit in one quad of threads, so its max
//     is two shuffles, and each thread keeps a partial row sum that the
//     quad adds once at the end. Masks are applied only on the causal
//     diagonal tile and the kv_len tile.
//   * O += P . V takes P from registers (the accumulator layout is the A
//     operand layout) and V MN-major from shared memory (transpose-B),
//     one 64-column panel of O at a time.
//   * Under `causal` a CTA stops at its diagonal tile, and query
//     blocks are launched heaviest (last) first, so the long rows do not
//     finish last. The grid's x walks B*H, its y the query blocks.
//   * Epilogue: out = O / l rounded once to bf16 with a row mask for a
//     ragged S, lse = m + log(l) in fp32.
//
// Design of the fp32 kernel: one CTA of 256 threads per (b*h, 64-row
// query block; B*H on the grid's x, as in the bf16 kernel) looping over
// 64-column K/V tiles staged through shared memory in fp32, up to the
// causal diagonal and kv_len. Threads form a
// 16 x 16 grid: thread (ty, tx) owns query rows 4*ty .. 4*ty+3, score
// columns tx + 16*j (j < 4) and output columns tx + 16*j (j < D/16); the 16
// threads sharing a row sit in one half warp (row max and sum are shuffles,
// the P tile needs only __syncwarp). Rows are padded (q: D+4, k: D+1, p:
// 64+1) against bank conflicts; q is scaled as it is loaded, like the TPU
// kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

// ---- float32: CUDA cores -----------------------------------------------

constexpr int kThreads = 256;

template <int D>
constexpr int smem_floats() {
  return kBlockQ * (D + 4) + kBlockK * (D + 1) + kBlockK * D +
         kBlockQ * (kBlockK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int seq_q, int seq_k,
                     int kv_len, float scale, int causal) {
  constexpr int QS = D + 4;        // padded row strides, in floats
  constexpr int KS = D + 1;
  constexpr int PS = kBlockK + 1;
  constexpr int DC = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x QS
  float* ks = qs + kBlockQ * QS;             // kBlockK x KS
  float* vs = ks + kBlockK * KS;             // kBlockK x D
  float* ps = vs + kBlockK * D;              // kBlockQ x PS

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float* qb = q + bh * seq_q * D;
  const float* kb = k + bh * seq_k * D;
  const float* vb = v + bh * seq_k * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * QS + d] = q0 + r < seq_q ? qb[(size_t)(q0 + r) * D + d] * scale
                                    : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kb = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) n_kb = min(n_kb, (q0 + kBlockQ + kBlockK - 1) / kBlockK);

  for (int j = 0; j < n_kb; ++j) {
    const int c0 = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done (and qs is in)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool live = c0 + c < seq_k;
      const size_t g = (size_t)(c0 + c) * D + d;
      ks[c * KS + d] = live ? kb[g] : 0.f;
      vs[c * D + d] = live ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + tx + 16 * c;
        if (col >= kv_len || (causal && row < col)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        ps[(ty * 4 + i) * PS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P entries come from its own half warp

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = vs[c * D + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = out + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0) lse[bh * seq_q + row] = m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int seq_q, int seq_k, int kv_len,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), seq_q, seq_k, kv_len, scale, causal);
  return cudaGetLastError();
}

// ---- bfloat16: tensor cores ------------------------------------------------

using namespace hopper;

constexpr int kStages = 2;               // K/V ring slots
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory, in bytes from a 1024-aligned base: P Q panels, then
// kStages x P K panels and as many V panels, then the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr int P = D / 64;
  static constexpr int q = 0;
  static constexpr int k = q + P * kPanelBytes;
  static constexpr int v = k + kStages * P * kPanelBytes;
  static constexpr int bars = v + kStages * P * kPanelBytes;
  static constexpr int alloc = bars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(128 + 32)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int seq_q, int kv_len, float scale, int causal) {
  using L = FwdSmem<D>;
  constexpr int P = L::P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int q0 = qb * kBlockQ;
  int n_kb = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) n_kb = min(n_kb, qb + 1);       // stop at the diagonal tile
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp; one lane issues every load
    if (tid == 128) {
      mbar_arrive_expect_tx(q_full, P * kPanelBytes);
      for (int p = 0; p < P; ++p)
        tma_load_panel(smem + L::q + p * kPanelBytes, &tq, q_full, 64 * p, q0,
                       bh);
      for (int j = 0; j < n_kb; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * P * kPanelBytes);
        for (int p = 0; p < P; ++p) {
          tma_load_panel(smem + L::k + (s * P + p) * kPanelBytes, &tk,
                         &full[s], 64 * p, j * kBlockK, bh);
          tma_load_panel(smem + L::v + (s * P + p) * kPanelBytes, &tv,
                         &full[s], 64 * p, j * kBlockK, bh);
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = q0 + 16 * warp + lane / 4;  // and row + 8
  const float scale2 = scale * kLog2e;        // scores in log2 units
  const uint64_t q_desc = desc_sw128(smem + L::q);

  float o[P][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kb; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint64_t k_desc = desc_sw128(smem + L::k + s * P * kPanelBytes);
    const uint64_t v_desc = desc_sw128(smem + L::v + s * P * kPanelBytes);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    fence_acc(sc);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss(sc, desc_add(q_desc, off), desc_add(k_desc, off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    const bool edge = (causal && j == qb) || (j + 1) * kBlockK > kv_len;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale2;
      if (edge) {
        const int col = j * kBlockK + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int r = row + 8 * ((i / 2) % 2);
        if (col >= kv_len || (causal && r < col)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = exp2f(sc[i] - m[h]);
      l[h] += sc[i];              // a partial row sum; the quad adds at the end
#pragma unroll
      for (int p = 0; p < P; ++p) o[p][i] *= alpha[h];
    }
    uint32_t a[4][4];
    to_a_frags(sc, a);

    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      fence_acc(o[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[p], a[kk],
                 desc_add(v_desc, p * kPanelBytes + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_acc(o[p]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row + 8 * h;
    if (r >= seq_q) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = out + ((size_t)bh * seq_q + r) * D;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * p + 8 * jj + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            o[p][4 * jj + 2 * h] * inv, o[p][4 * jj + 2 * h + 1] * inv);
      }
    if (lane % 4 == 0)
      lse[(size_t)bh * seq_q + r] = (m[h] + log2f(l_safe)) * kLn2;
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      void* lse, int bh, int seq_q, int seq_k, int kv_len,
                      float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!panel_map(&tq, q, bh, seq_q, D) || !panel_map(&tk, k, bh, seq_k, D) ||
      !panel_map(&tv, v, bh, seq_k, D))
    return cudaErrorInvalidValue;
  constexpr int smem = FwdSmem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + kBlockQ - 1) / kBlockQ);
  flash_fwd_tc_kernel<D><<<grid, 128 + 32, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      seq_q, kv_len, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, seq_q, d); k, v: (bh, seq_k, d); out like q; lse: (bh, seq_q) f32.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k and v
// 16-byte aligned, see hopper::panel_map). d: 64 or 128. 1 <= kv_len <=
// seq_k. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int seq_q, int seq_k, int d,
                                   int kv_len, float scale, int causal,
                                   int dtype, void* stream) {
  // B*H rides the grid's x, the query blocks its y (<= 65535)
  if (bh < 1 || seq_q < 1 || seq_k < 1 || kv_len < 1 || kv_len > seq_k ||
      (seq_q + (long long)kBlockQ - 1) / kBlockQ > 65535 ||
      (d != 64 && d != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d == 64 ? launch_f32<64>(q, k, v, out, lse, bh, seq_q, seq_k,
                                    kv_len, scale, causal, s)
                   : launch_f32<128>(q, k, v, out, lse, bh, seq_q, seq_k,
                                     kv_len, scale, causal, s);
  return d == 64 ? launch_tc<64>(q, k, v, out, lse, bh, seq_q, seq_k, kv_len,
                                 scale, causal, s)
                 : launch_tc<128>(q, k, v, out, lse, bh, seq_q, seq_k, kv_len,
                                  scale, causal, s);
}
