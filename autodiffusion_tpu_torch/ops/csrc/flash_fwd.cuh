// Flash-attention forward kernels for Hopper (sm_90a): o = softmax(q k^T /
// sqrt(D)) v by online softmax, plus the per-row float32 logsumexp. Shared
// by flash_fwd.cu, which takes q, k, v as [N, T or S, D] (N = batch * heads),
// and flash_fwd_packed.cu, which takes the token-major [B, T or S, H * D]
// layout the attention projections produce (head h of a token at features
// h * D .. h * D + D). Both are one "rows" layout: (batch, head) pair bh's
// rows start at base + (bh / heads) * len * ld + (bh % heads) * D and lie
// ld elements apart ([N, len, D] is heads = 1, ld = D). lse is [N, T] or
// [B * H, T] float32, the TPU kernels' contract (flash_attention.py:548-552).
//
// bfloat16: the two products on the tensor cores (mma.sync, bf16 operands,
//   float32 accumulators), p rounded to bf16 before P V. A head dim D that
//   is not a multiple of the 16-deep mma step is zero-padded to DP (D = 40
//   to 48) in the q fragments and in the shared K and V tiles; the padding
//   adds zero products to the logits and is never stored.
// float32: float32 FMAs on the CUDA cores (flash_simt.cuh), since the tensor
//   cores would round float32 operands to TF32.
#pragma once

#include "flash_mma.cuh"
#include "flash_simt.cuh"

namespace adt {

// The first row of (batch, head) pair bh in the rows layout above.
template <int D, typename T>
__device__ __forceinline__ T* head_rows(T* base, int bh, int len, int heads, int ld) {
  return base + (size_t)(bh / heads) * len * ld + (size_t)(bh % heads) * D;
}

namespace mma {

// A fragments of rows [r0, r0 + 16) of a [len, D] matrix with rows ld
// elements apart, zero past `len` and in the columns D .. DP. With
// `raw_pad` the padding columns are read from memory instead (the next
// head's features): the sabotaged run of the kernel checks.
template <int D, int DP>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[Geom<DP>::KS][4], const bf16* m, int r0,
                                            int len, int ld, bool raw_pad, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const bf16* row = m + (size_t)(r < len ? r : 0) * ld;
#pragma unroll
    for (int kk = 0; kk < Geom<DP>::KS; ++kk) {
      const int c_lo = kk * 16 + 2 * t, c_hi = c_lo + 8;
      uint32_t lo = 0, hi = 0;
      if (r < len && (c_lo < D || raw_pad)) lo = *reinterpret_cast<const uint32_t*>(row + c_lo);
      if (r < len && (c_hi < D || raw_pad)) hi = *reinterpret_cast<const uint32_t*>(row + c_hi);
      a[kk][h] = lo;
      a[kk][2 + h] = hi;
    }
  }
}

// Rows [r0, r0 + ROWS) of a [len, D] matrix with rows ld elements apart
// into a shared tile of DP-wide padded rows, zero past `len` and in the
// columns D .. DP (unless raw_pad), 16 bytes per load.
template <int D, int DP, int ROWS>
__device__ __forceinline__ void load_tile_rows(bf16* s, const bf16* m, int r0, int len, int ld,
                                               bool raw_pad) {
  constexpr int kChunks = DP / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len && (c * 8 < D || raw_pad))
      v = *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * ld + c * 8);
    *reinterpret_cast<uint4*>(s + r * Geom<DP>::LD + c * 8) = v;
  }
}

// Store the warp's 16 x D accumulator rows (times `mul[h]` for row half h)
// as bfloat16, rows ld elements apart, rows at or past `len` skipped.
template <int D, int DP>
__device__ __forceinline__ void store_rows_ld(bf16* m, const float (&acc)[Geom<DP>::NT][4], int r0,
                                              int len, int ld, const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= len) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(m + (size_t)r * ld + n * 8 + 2 * t) =
          pack(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// The online softmax of one 64-key tile: masks keys at or past s_len,
// scales the logits, updates the row max m and the lane's share of the row
// sum l, turns s into exp(s - m) and rescales acc.
template <int BN, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 8][4], float (&acc)[NT][4],
                                             float (&m)[2], float (&l)[2], int j0, int s_len,
                                             float scale, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = j0 + j * 8 + 2 * t + (e & 1) < s_len;
      s[j][e] = ok ? s[j][e] * scale : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = expf(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      l[e >> 1] += s[j][e];  // this lane's share of the row sum
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
}

}  // namespace mma

template <int D, int DP>
__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_bf16_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                      const mma::bf16* __restrict__ v, mma::bf16* __restrict__ o,
                      float* __restrict__ lse, int t_len, int s_len, int t_blocks, int heads,
                      int ld, float scale, int raw_pad) {
  using namespace mma;
  using G = Geom<DP>;
  constexpr int BN = 64;
  __shared__ __align__(16) bf16 sK[BN * G::LD];
  __shared__ __align__(16) bf16 sV[BN * G::LD];

  const int bh = blockIdx.x / t_blocks;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (blockIdx.x % t_blocks) * kRows + (threadIdx.x >> 5) * 16;
  // the sabotaged run reads the padding from the next head (never past
  // the last head of a row)
  const bool pad = raw_pad && bh % heads + 1 < heads;
  const bf16* kb = head_rows<D>(k, bh, s_len, heads, ld);
  const bf16* vb = head_rows<D>(v, bh, s_len, heads, ld);

  uint32_t qa[G::KS][4];
  load_a_rows<D, DP>(qa, head_rows<D>(q, bh, t_len, heads, ld), r0, t_len, ld, pad, lane);
  float acc[G::NT][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < s_len; j0 += BN) {
    __syncthreads();
    load_tile_rows<D, DP, BN>(sK, kb, j0, s_len, ld, pad);
    load_tile_rows<D, DP, BN>(sV, vb, j0, s_len, ld, pad);
    __syncthreads();

    float s[BN / 8][4];
    zero(s);
    mma_abt<DP, BN>(s, qa, sK, lane);
    softmax_tile<BN, G::NT>(s, acc, m, l, j0, s_len, scale, t);
    mma_px<DP, BN>(acc, s, sV, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / l_safe;
    const int r = r0 + (lane >> 2) + 8 * h;
    if (t == 0 && r < t_len) lse[(size_t)bh * t_len + r] = m[h] + logf(l_safe);
  }
  store_rows_ld<D, DP>(head_rows<D>(o, bh, t_len, heads, ld), acc, r0, t_len, ld, inv, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int t_len, int s_len, int t_blocks, int heads, int ld, float scale) {
  using G = Geometry<D>;
  __shared__ float4 sK[G::BN * G::C4];
  __shared__ float4 sV[G::BN * G::C4];

  const int bh = blockIdx.x / t_blocks;
  const int tb = blockIdx.x % t_blocks;
  const int lane_g = threadIdx.x % G::TPR;
  const int row = tb * G::BM + threadIdx.x / G::TPR;
  const bool row_valid = row < t_len;

  const float* kb = head_rows<D>(k, bh, s_len, heads, ld);
  const float* vb = head_rows<D>(v, bh, s_len, heads, ld);
  const size_t row_off = (size_t)(row_valid ? row : 0) * ld;

  float4 qr[G::NC], acc[G::NC];
  load_row<D>(qr, head_rows<D>(q, bh, t_len, heads, ld) + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) acc[c] = zero4();
  float m = kNegInf, l = 0.f;

  for (int j0 = 0; j0 < s_len; j0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sK, kb, j0, s_len, ld);
    stage_tile<D>(sV, vb, j0, s_len, ld);
    __syncthreads();
    const int n_valid = min(G::BN, s_len - j0);
    for (int jc = 0; jc < n_valid; jc += G::CH) {
      float s[G::CH];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < G::CH; ++jj) {
        float x = row_sum<G::TPR>(lane_dot<D>(qr, sK + (jc + jj) * G::C4, lane_g)) * scale;
        x = (jc + jj < n_valid) ? x : kNegInf;
        s[jj] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < G::CH; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) scale4(alpha, acc[c]);
#pragma unroll
      for (int jj = 0; jj < G::CH; ++jj) lane_axpy<D>(s[jj], sV + (jc + jj) * G::C4, acc, lane_g);
    }
  }

  if (row_valid) {
    const float l_safe = fmaxf(l, 1e-30f);
    store_row<D>(head_rows<D>(o, bh, t_len, heads, ld) + row_off, acc, 1.f / l_safe, lane_g);
    if (lane_g == 0) lse[(size_t)bh * t_len + row] = m + logf(l_safe);
  }
}

}  // namespace adt

// Launch the forward of head dim D (padded to DP on the tensor cores) for
// n (batch, head) pairs in the rows layout (heads, ld); the caller's scope
// holds q, k, v, o, lse, n, t_len, s_len, scale and the stream st.
#define ADT_LAUNCH_FWD_BF16(D, DP, heads, ld, raw_pad)                                       \
  {                                                                                          \
    const int t_blocks = (t_len + adt::mma::kRows - 1) / adt::mma::kRows;                    \
    adt::flash_fwd_bf16_kernel<D, DP><<<n * t_blocks, adt::mma::kThreads, 0, st>>>(          \
        static_cast<const adt::mma::bf16*>(q), static_cast<const adt::mma::bf16*>(k),        \
        static_cast<const adt::mma::bf16*>(v), static_cast<adt::mma::bf16*>(o), lse, t_len,  \
        s_len, t_blocks, heads, ld, scale, raw_pad);                                         \
  }

#define ADT_LAUNCH_FWD_F32(D, heads, ld)                                                     \
  {                                                                                          \
    const int t_blocks = (t_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_fwd_f32_kernel<D><<<n * t_blocks, adt::kThreads, 0, st>>>(                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<float*>(o), lse, t_len, s_len, t_blocks,   \
        heads, ld, scale);                                                                   \
  }

#define ADT_LAUNCH_FWD(D, DP, heads, ld, raw_pad, is_bf16) \
  {                                                        \
    if (is_bf16)                                           \
      ADT_LAUNCH_FWD_BF16(D, DP, heads, ld, raw_pad)       \
    else                                                   \
      ADT_LAUNCH_FWD_F32(D, heads, ld)                     \
  }
