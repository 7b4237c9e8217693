// The float32 flash-attention forward for Hopper (sm_90a): o = softmax(q
// k^T / sqrt(D)) v by online softmax, plus the per-row float32 logsumexp,
// as float32 FMAs on the CUDA cores (flash_simt.cuh), since the tensor
// cores would round float32 operands to TF32. It serves the float32 paths
// of flash_fwd.cu, flash_fwd_packed.cu and flash_fwd_wide.cu (their
// bfloat16 kernels are wgmma kernels fed by TMA, flash_wgmma.cuh).
//
// One "rows" layout: (batch, head) pair bh's rows start at base + (bh /
// heads) * len * ld + (bh % heads) * D and lie ld elements apart ([N, len,
// D] is heads = 1, ld = D; the token-major [B, len, H * D] of the attention
// projections is heads = H, ld = H * D). lse is [N, T] or [B * H, T]
// float32, the TPU kernels' contract (flash_attention.py:548-552).
#pragma once

#include "flash_simt.cuh"

namespace adt {

// The first row of (batch, head) pair bh in the rows layout above.
template <int D, typename T>
__device__ __forceinline__ T* head_rows(T* base, int bh, int len, int heads, int ld) {
  return base + (size_t)(bh / heads) * len * ld + (size_t)(bh % heads) * D;
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

// Launch the float32 forward of head dim D for n (batch, head) pairs in the
// rows layout (heads, ld); the caller's scope holds q, k, v, o, lse, n,
// t_len, s_len, scale and the stream st.
#define ADT_LAUNCH_FWD_F32(D, heads, ld)                                                     \
  {                                                                                          \
    const int t_blocks = (t_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_fwd_f32_kernel<D><<<n * t_blocks, adt::kThreads, 0, st>>>(                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<float*>(o), lse, t_len, s_len, t_blocks,   \
        heads, ld, scale);                                                                   \
  }
