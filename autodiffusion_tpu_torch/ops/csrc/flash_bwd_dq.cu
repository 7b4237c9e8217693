// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_dq_kernel
// (driven by _flash_bwd): the FlashAttention-2 dQ pass. p is re-formed from
// the forward's saved logsumexp, p = exp(q k^T / sqrt(D) - lse), and
//   dq = (p * (dO v^T - delta)) k / sqrt(D),  delta = rowsum(dO * O)
// with delta computed by the caller, as the TPU path does.
//
// Bound on this card: three T x S x D products per head (logits, dP, dQ)
// against 4 T D + 2 T inputs and T D outputs, so bound by operations. A
// block keeps 64 query rows (q, dO and the dq accumulator) resident and
// streams K and V through shared memory; neither p nor dS reaches device
// memory.
//   bfloat16: the three products on the tensor cores (mma.sync); dS is
//     rounded to bf16 before dS K, as the TPU kernel casts it.
//   float32:  float32 FMAs on the CUDA cores, one key at a time.
#include "flash_mma.cuh"
#include "flash_simt.cuh"

namespace adt {

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_bwd_dq_bf16_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                         const mma::bf16* __restrict__ v, const mma::bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         mma::bf16* __restrict__ dq, int t_len, int s_len, int t_blocks,
                         float scale) {
  using namespace mma;
  using G = Geom<D>;
  constexpr int BN = 64;
  __shared__ __align__(16) bf16 sK[BN * G::LD];
  __shared__ __align__(16) bf16 sV[BN * G::LD];

  const int bh = blockIdx.x / t_blocks;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (blockIdx.x % t_blocks) * kRows + (threadIdx.x >> 5) * 16;
  const bf16* kb = k + (size_t)bh * s_len * D;
  const bf16* vb = v + (size_t)bh * s_len * D;

  uint32_t qa[G::KS][4], da[G::KS][4];
  load_a<D>(qa, q + (size_t)bh * t_len * D, r0, t_len, lane);
  load_a<D>(da, dout + (size_t)bh * t_len * D, r0, t_len, lane);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    row_lse[h] = r < t_len ? lse[(size_t)bh * t_len + r] : 0.f;
    row_delta[h] = r < t_len ? delta[(size_t)bh * t_len + r] : 0.f;
  }
  float acc[G::NT][4];
  zero(acc);

  for (int j0 = 0; j0 < s_len; j0 += BN) {
    __syncthreads();
    load_tile<D, BN>(sK, kb, j0, s_len);
    load_tile<D, BN>(sV, vb, j0, s_len);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, BN>(s, qa, sK, lane);
    mma_abt<D, BN>(dp, da, sV, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j0 + j * 8 + 2 * t + (e & 1) < s_len;
        const float p = ok ? expf(s[j][e] * scale - row_lse[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[e >> 1]);   // dS
      }
    mma_px<D, BN>(acc, s, sK, lane);
  }

  const float mul[2] = {scale, scale};
  store_rows<D>(dq + (size_t)bh * t_len * D, acc, r0, t_len, mul, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int t_len, int s_len, int t_blocks, float scale) {
  using G = Geometry<D>;
  __shared__ float4 sK[G::BN * G::C4];
  __shared__ float4 sV[G::BN * G::C4];

  const int bh = blockIdx.x / t_blocks;
  const int tb = blockIdx.x % t_blocks;
  const int lane_g = threadIdx.x % G::TPR;
  const int row = tb * G::BM + threadIdx.x / G::TPR;
  const bool row_valid = row < t_len;

  const float* kb = k + (size_t)bh * s_len * D;
  const float* vb = v + (size_t)bh * s_len * D;
  const size_t row_off = ((size_t)bh * t_len + (row_valid ? row : 0)) * D;
  const size_t stat_off = (size_t)bh * t_len + (row_valid ? row : 0);
  const float row_lse = row_valid ? lse[stat_off] : 0.f;
  const float row_delta = row_valid ? delta[stat_off] : 0.f;

  float4 qr[G::NC], dor[G::NC], acc[G::NC];
  load_row<D>(qr, q + row_off, row_valid, lane_g);
  load_row<D>(dor, dout + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) acc[c] = zero4();

  for (int j0 = 0; j0 < s_len; j0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sK, kb, j0, s_len);
    stage_tile<D>(sV, vb, j0, s_len);
    __syncthreads();
    const int n_valid = min(G::BN, s_len - j0);
#pragma unroll 2
    for (int j = 0; j < n_valid; ++j) {
      float4 kk[G::NC], vv[G::NC];
      load_srow<D>(kk, sK + j * G::C4, lane_g);
      load_srow<D>(vv, sV + j * G::C4, lane_g);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        s = dot4(qr[c], kk[c], s);
        dp = dot4(dor[c], vv[c], dp);
      }
      row_sum2<G::TPR>(s, dp);
      const float ds = expf(s * scale - row_lse) * (dp - row_delta);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) axpy4(ds, kk[c], acc[c]);
    }
  }

  if (row_valid) store_row<D>(dq + row_off, acc, scale, lane_g);
}

}  // namespace adt

#define ADT_LAUNCH_DQ_BF16(D)                                                               \
  {                                                                                         \
    const int t_blocks = (t_len + adt::mma::kRows - 1) / adt::mma::kRows;                   \
    adt::flash_bwd_dq_bf16_kernel<D><<<n * t_blocks, adt::mma::kThreads, 0, st>>>(          \
        static_cast<const adt::mma::bf16*>(q), static_cast<const adt::mma::bf16*>(k),       \
        static_cast<const adt::mma::bf16*>(v), static_cast<const adt::mma::bf16*>(dout),    \
        lse, delta, static_cast<adt::mma::bf16*>(dq), t_len, s_len, t_blocks, scale);       \
  }

#define ADT_LAUNCH_DQ_F32(D)                                                                 \
  {                                                                                          \
    const int t_blocks = (t_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_bwd_dq_f32_kernel<D><<<n * t_blocks, adt::kThreads, 0, st>>>(                \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,           \
        static_cast<float*>(dq), t_len, s_len, t_blocks, scale);                             \
  }

extern "C" int adt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int n,
                                int t_len, int s_len, int head_dim, int is_bf16, float scale,
                                void* stream) {
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DQ_BF16);
  else
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DQ_F32);
  return static_cast<int>(cudaGetLastError());
}
