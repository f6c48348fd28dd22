// Flash attention at a head dim above 256: the wide route of B5
// (flash_attention_fwd.cu), B6 and B7 (flash_attention_bwd.cu), dispatched by
// their C entry points for d > 256 (a multiple of 128: the wrapper zero-pads
// D to one, as the JAX package pads D to a multiple of 128 lanes). Same
// functions, masks and bf16 roundings as the narrow kernels of those files.
//
// Why a route of its own. The narrow kernels keep the CTA's Q (or K and V)
// panels resident and stream the other operand whole through a ring of two
// slots; at D 512 one 64-row bf16 panel group is 64 KB, and B6/B7 need two
// resident and two streamed, which no shared-memory budget of 227 KB holds.
//
// Design (a grid axis over column groups of the output). The grid is (B*H,
// 64-row blocks, D / GC column groups): a CTA owns 64 rows and GC columns of
// O (B5), of dQ (B6), or of dK and dV (B7). It recomputes the score tile
// S = Q . K^T (and in B6/B7 dP = dO . V^T) for each streamed 64-row tile by
// looping over D in 64-column chunks staged through shared memory, so the
// scores cost D / GC times what one CTA a row block would pay, and any D
// (a multiple of GC) fits the same 45-145 KB of shared memory. The products
// that feed the CTA's own columns (P . V, dS . K, P^T . dO, dS^T . Q) read
// the group's columns of the streamed operand, transposed as they are
// staged. GC is 128 in B5 and B6 and 64 in B7, which keeps two accumulators.
// Tiles are staged with 16-byte loads when every operand is 16-byte aligned
// (D is a multiple of 128), element by element otherwise; there is no TMA
// and no pipelining: a chunk is loaded, synchronized and multiplied in turn,
// and the CTAs resident on an SM (four, at 128 threads and 46-145 KB) hide
// each other's loads.
//
// A CTA is four warps, each owning 16 of the 64 rows. Every product is a
// warp's 16 x N tile in the m16n8 accumulator layout (a thread holds rows g
// and g + 8, columns 2t and 2t + 1 of each 8-column tile, g = lane / 4,
// t = lane % 4), so the online softmax and the row sums are quad shuffles as
// in the narrow kernels. In bfloat16 the products run on the tensor cores
// as mma.sync m16n8k16 (fp32 accumulators; P and dS rounded once to bf16 as
// operands, as in the wgmma kernels); in float32 the same tiles are fp32
// FMAs on the CUDA cores (the fp32 checks do not admit TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wide {

constexpr int kThreads = 128;          // four warps x 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kFwdGroup = 128;         // columns of O a CTA (B5)
constexpr int kDqGroup = 128;          // of dQ (B6)
constexpr int kDkvGroup = 64;          // of dK and dV (B7)

// Row stride of a shared tile of 64 columns: 72 bf16 (144 bytes: the eight
// rows a quad reads fall in distinct banks) or 68 floats.
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 2 ? 72 : 68;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dst[r][c] = src[r0 + r][c0 + c] for a 64 x 64 tile of a (rows, d) matrix,
// zeros past `rows`; with `vec` (every operand 16-byte aligned, d a multiple
// of 128) in 16-byte loads, else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows, int d, int c0, bool vec) {
  constexpr int S = row_stride<T>();
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER_ROW = 64 / V;
    for (int i = threadIdx.x; i < 64 * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < rows)
        x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c0 +
                                            c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = x;
    }
    return;
  }
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    dst[r * S + c] = r0 + r < rows ? src[(size_t)(r0 + r) * d + c0 + c]
                                   : from_f<T>(0.f);
  }
}

// dst[c][r] = src[r0 + r][c0 + c] for 64 rows and `cols` columns (the
// transpose, `cols` x 64), zeros past `rows`; `vec` as in load_tile.
template <typename T, int COLS>
__device__ __forceinline__ void load_tile_t(T* dst, const T* src, int r0,
                                            int rows, int d, int c0,
                                            bool vec) {
  constexpr int S = row_stride<T>();
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER_ROW = COLS / V;
    for (int i = threadIdx.x; i < 64 * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < rows)
        x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c0 +
                                            c);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(c + j) * S + r] = e[j];
    }
    return;
  }
  for (int i = threadIdx.x; i < 64 * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[c * S + r] = r0 + r < rows ? src[(size_t)(r0 + r) * d + c0 + c]
                                   : from_f<T>(0.f);
  }
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc (a warp's 16 x N tile) += A . Bt^T over 64 k: `a` the warp's first
// row of a 64-column shared tile, `bt` N rows of one (Bt[n][k] = B[k][n]).
template <int N>
__device__ __forceinline__ void warp_mma(float (&acc)[N / 8][4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* bt) {
  constexpr int S = row_stride<__nv_bfloat16>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    const __nv_bfloat16* ar = a + g * S + kk + 2 * t;
    const uint32_t a0 = ld_pair(ar), a1 = ld_pair(ar + 8 * S);
    const uint32_t a2 = ld_pair(ar + 8), a3 = ld_pair(ar + 8 * S + 8);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const __nv_bfloat16* br = bt + (8 * nt + g) * S + kk + 2 * t;
      const uint32_t b0 = ld_pair(br), b1 = ld_pair(br + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]),
            "+f"(acc[nt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

template <int N>
__device__ __forceinline__ void warp_mma(float (&acc)[N / 8][4],
                                         const float* a, const float* bt) {
  constexpr int S = row_stride<float>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    const float a0 = a[g * S + k], a1 = a[(g + 8) * S + k];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float b0 = bt[(8 * nt + 2 * t) * S + k];
      const float b1 = bt[(8 * nt + 2 * t + 1) * S + k];
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The warp's 16 x 64 tile `x` into rows of a shared tile (rounded to T).
template <typename T>
__device__ __forceinline__ void store_frag(T* dst, const float (&x)[8][4]) {
  constexpr int S = row_stride<T>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(g + 8 * (e >> 1)) * S + 8 * nt + 2 * t + (e & 1)] =
          from_f<T>(x[nt][e]);
}

// The warp's 16 x N tile `x` times `mul` into global rows (row0 + the
// fragment's row, from column c0) of a (rows, d) matrix, rows < `rows`.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* dst, const float (&x)[N / 8][4],
                                           int row0, int rows, int d, int c0,
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= rows) continue;
    T* row = dst + (size_t)r * d + c0;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[8 * nt + 2 * t + e] = from_f<T>(x[nt][2 * h + e] * mul[h]);
  }
}

// ---- B5: out = softmax(scale q . k^T, masked) v, lse ---------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int seq_q, int seq_k, int d,
                int kv_len, float scale, int causal, bool vec) {
  constexpr int S = row_stride<T>();
  constexpr int GC = kFwdGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);    // 64 x 64: a D chunk of Q
  T* ks = qs + 64 * S;                       // 64 x 64: that chunk of K
  T* vt = ks + 64 * S;                       // GC x 64: the group's V^T
  T* ps = vt + GC * S;                       // 64 x 64: P

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * 64, cg = blockIdx.z * GC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + bh * seq_q * d;
  const T* kb = k + bh * seq_k * d;
  const T* vb = v + bh * seq_k * d;
  const float scale2 = scale * kLog2e;     // scores in log2 units

  float o[GC / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  int n_kb = (kv_len + 63) / 64;
  if (causal) n_kb = min(n_kb, (q0 + 127) / 64);    // to the diagonal
  for (int j = 0; j < n_kb; ++j) {
    const int c0 = 64 * j;
    float s[8][4];
    zero(s);
    for (int dc = 0; dc < d; dc += 64) {
      __syncthreads();   // the last chunk's (and tile's) readers are done
      load_tile(qs, qb, q0, seq_q, d, dc, vec);
      load_tile(ks, kb, c0, seq_k, d, dc, vec);
      __syncthreads();
      warp_mma<64>(s, qs + 16 * warp * S, ks);
    }
    load_tile_t<T, GC>(vt, vb, c0, seq_k, d, cg, vec);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * nt + 2 * t + (e & 1);
        const int r = q0 + 16 * warp + g + 8 * (e >> 1);
        float x = s[nt][e] * scale2;
        if (col >= kv_len || (causal && r < col)) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[nt][e] = exp2f(s[nt][e] - m[h]);
        l[h] += s[nt][e];     // a partial row sum; the quad adds at the end
      }
#pragma unroll
    for (int nt = 0; nt < GC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    store_frag(ps + 16 * warp * S, s);
    __syncthreads();     // V^T staged by every thread
    warp_mma<GC>(o, ps + 16 * warp * S, vt);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float l_safe = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / l_safe;
    const int r = q0 + 16 * warp + g + 8 * h;
    if (blockIdx.z == 0 && t == 0 && r < seq_q)
      lse[bh * seq_q + r] = (m[h] + log2f(l_safe)) * kLn2;
  }
  store_rows<T, GC>(out + bh * seq_q * d, o, q0 + 16 * warp, seq_q, d, cg,
                    inv);
}

// ---- B6: dq = scale * sum_c ds[r, c] k[c] ----------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int seq_q, int seq_k, int d, int kv_len,
               float scale, int causal, bool vec) {
  constexpr int S = row_stride<T>();
  constexpr int GC = kDqGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);    // D chunks: Q, K, dO, V
  T* ks = qs + 64 * S;
  T* dos = ks + 64 * S;
  T* vs = dos + 64 * S;
  T* kt = vs + 64 * S;                       // GC x 64: the group's K^T
  T* dss = kt + GC * S;                      // 64 x 64: dS

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * 64, cg = blockIdx.z * GC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + bh * seq_q * d;
  const T* kb = k + bh * seq_k * d;
  const T* vb = v + bh * seq_k * d;
  const T* dob = dout + bh * seq_q * d;
  const float scale2 = scale * kLog2e;

  // the rows' lse (log2 units; +inf past seq_q, so p = 0 there) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    lse2[h] = r < seq_q ? lse[bh * seq_q + r] * kLog2e
                        : __int_as_float(0x7f800000);
    dl[h] = r < seq_q ? delta[bh * seq_q + r] : 0.f;
  }

  float acc[GC / 8][4];
  zero(acc);
  int n_kb = (kv_len + 63) / 64;
  if (causal) n_kb = min(n_kb, (q0 + 127) / 64);
  for (int j = 0; j < n_kb; ++j) {
    const int c0 = 64 * j;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int dc = 0; dc < d; dc += 64) {
      __syncthreads();
      load_tile(qs, qb, q0, seq_q, d, dc, vec);
      load_tile(ks, kb, c0, seq_k, d, dc, vec);
      load_tile(dos, dob, q0, seq_q, d, dc, vec);
      load_tile(vs, vb, c0, seq_k, d, dc, vec);
      __syncthreads();
      warp_mma<64>(s, qs + 16 * warp * S, ks);
      warp_mma<64>(dp, dos + 16 * warp * S, vs);
    }
    load_tile_t<T, GC>(kt, kb, c0, seq_k, d, cg, vec);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = c0 + 8 * nt + 2 * t + (e & 1);
        const int r = q0 + 16 * warp + g + 8 * h;
        float p = exp2f(s[nt][e] * scale2 - lse2[h]);
        if (col >= kv_len || (causal && r < col)) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[h]);    // ds
      }
    store_frag(dss + 16 * warp * S, s);
    __syncthreads();
    warp_mma<GC>(acc, dss + 16 * warp * S, kt);
  }
  const float mul[2] = {scale, scale};
  store_rows<T, GC>(dq + bh * seq_q * d, acc, q0 + 16 * warp, seq_q, d, cg,
                    mul);
}

// ---- B7: dv = sum_r p[r, c] do[r], dk = scale * sum_r ds[r, c] q[r] -------
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int seq_q, int seq_k, int d, int kv_len,
                float scale, int causal, bool vec) {
  constexpr int S = row_stride<T>();
  constexpr int GC = kDkvGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);    // D chunks: K, V, Q, dO
  T* vs = ks + 64 * S;
  T* qs = vs + 64 * S;
  T* dos = qs + 64 * S;
  T* qt = dos + 64 * S;                      // GC x 64: the group's Q^T
  T* dot = qt + GC * S;                      // and dO^T
  T* pts = dot + GC * S;                     // 64 x 64: P^T
  T* dsts = pts + 64 * S;                    // and dS^T
  __shared__ float lse_s[64], del_s[64];

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * 64, cg = blockIdx.z * GC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + bh * seq_q * d;
  const T* kb = k + bh * seq_k * d;
  const T* vb = v + bh * seq_k * d;
  const T* dob = dout + bh * seq_q * d;
  const float scale2 = scale * kLog2e;

  float acc_k[GC / 8][4], acc_v[GC / 8][4];
  zero(acc_k);
  zero(acc_v);
  // keys at or past kv_len get zeros: their block adds nothing
  const int r_first = causal ? k0 : 0;      // queries that can see the block
  const int r_end = k0 < kv_len ? seq_q : r_first;
  for (int r0 = r_first; r0 < r_end; r0 += 64) {
    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    for (int dc = 0; dc < d; dc += 64) {
      __syncthreads();
      if (dc == 0 && threadIdx.x < 64) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < seq_q ? lse[bh * seq_q + r] * kLog2e
                                       : __int_as_float(0x7f800000);
        del_s[threadIdx.x] = r < seq_q ? delta[bh * seq_q + r] : 0.f;
      }
      load_tile(ks, kb, k0, seq_k, d, dc, vec);
      load_tile(vs, vb, k0, seq_k, d, dc, vec);
      load_tile(qs, qb, r0, seq_q, d, dc, vec);
      load_tile(dos, dob, r0, seq_q, d, dc, vec);
      __syncthreads();
      warp_mma<64>(st, ks + 16 * warp * S, qs);      // S^T = K . Q^T
      warp_mma<64>(dpt, vs + 16 * warp * S, dos);    // dP^T = V . dO^T
    }
    load_tile_t<T, GC>(qt, qb, r0, seq_q, d, cg, vec);
    load_tile_t<T, GC>(dot, dob, r0, seq_q, d, cg, vec);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * t + (e & 1);      // query, in the tile
        const int kr = k0 + 16 * warp + g + 8 * (e >> 1);
        float p = exp2f(st[nt][e] * scale2 - lse_s[qc]);
        if (kr >= kv_len || (causal && r0 + qc < kr)) p = 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - del_s[qc]);
      }
    store_frag(pts + 16 * warp * S, st);
    store_frag(dsts + 16 * warp * S, dpt);
    __syncthreads();
    warp_mma<GC>(acc_v, pts + 16 * warp * S, dot);    // dV += P^T . dO
    warp_mma<GC>(acc_k, dsts + 16 * warp * S, qt);    // dK += dS^T . Q
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<T, GC>(dv + bh * seq_k * d, acc_v, k0 + 16 * warp, seq_k, d, cg,
                    one);
  store_rows<T, GC>(dk + bh * seq_k * d, acc_k, k0 + 16 * warp, seq_k, d, cg,
                    mul);
}

// Shared bytes of each kernel: 64-row tiles and GC-row transposed tiles.
template <typename T>
constexpr int smem_bytes(int tiles64, int tiles_gc, int gc) {
  return (tiles64 * 64 + tiles_gc * gc) * row_stride<T>() * (int)sizeof(T);
}

template <typename T, typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline bool wide_ok(int d, int seq_rows) {
  return d > 256 && d % 128 == 0 && (seq_rows + 63) / 64 <= 65535 &&
         d / kDkvGroup <= 65535;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int seq_q, int seq_k,
                       int d, int kv_len, float scale, int causal,
                       cudaStream_t stream) {
  if (!wide_ok(d, seq_q)) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<T>(3, 1, kFwdGroup);
  cudaError_t err = prepare<T>(wide_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + 63) / 64, d / kFwdGroup);
  wide_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), seq_q, seq_k, d, kv_len, scale, causal,
      aligned16(q) && aligned16(k) && aligned16(v));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq_q, int seq_k, int d,
                      int kv_len, float scale, int causal,
                      cudaStream_t stream) {
  if (!wide_ok(d, seq_q)) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<T>(5, 1, kDqGroup);
  cudaError_t err = prepare<T>(wide_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + 63) / 64, d / kDqGroup);
  wide_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), seq_q, seq_k, d, kv_len, scale, causal,
      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       int d, int kv_len, float scale, int causal,
                       cudaStream_t stream) {
  if (!wide_ok(d, seq_k)) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<T>(6, 2, kDkvGroup);
  cudaError_t err = prepare<T>(wide_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_k + 63) / 64, d / kDkvGroup);
  wide_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), seq_q, seq_k, d, kv_len,
      scale, causal,
      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout));
  return cudaGetLastError();
}

}  // namespace wide
