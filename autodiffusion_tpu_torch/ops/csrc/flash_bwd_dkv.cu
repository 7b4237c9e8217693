// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_dkv_kernel
// (driven by _flash_bwd): the FlashAttention-2 dK/dV pass. For one block of
// keys, p^T = exp(k q^T / sqrt(D) - lse^T) is re-formed tile by tile over the
// queries and
//   dv = p^T dO,   dk = (p^T * (v dO^T - delta^T)) q / sqrt(D)
// with padded queries (and padded keys) masked out.
//
// Bound on this card: four T x S x D products per head (logits, dV, dP, dK)
// against 4 S D + 2 T inputs and 2 S D outputs, so bound by operations. A
// block keeps 64 key rows (k, v and both accumulators) resident and streams
// q, dO, lse and delta through shared memory, so the TPU kernel's sequential
// T loop becomes a loop inside the block and nothing needs a cross-block
// reduction.
//   bfloat16: the four products on the tensor cores (mma.sync); p and dS
//     are rounded to bf16 before p^T dO and dS^T q, as the TPU kernel casts
//     them.
//   float32:  float32 FMAs on the CUDA cores, one query at a time.
#include "flash_mma.cuh"
#include "flash_simt.cuh"

namespace adt {

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_bwd_dkv_bf16_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                          const mma::bf16* __restrict__ v, const mma::bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          mma::bf16* __restrict__ dk, mma::bf16* __restrict__ dv, int t_len,
                          int s_len, int s_blocks, float scale) {
  using namespace mma;
  using G = Geom<D>;
  // query rows per streamed tile: 32 at D = 128 keeps the two D-wide
  // accumulators and the resident k, v fragments within the register file
  constexpr int BQ = D >= 128 ? 32 : 64;
  __shared__ __align__(16) bf16 sQ[BQ * G::LD];
  __shared__ __align__(16) bf16 sO[BQ * G::LD];
  __shared__ float sL[BQ];
  __shared__ float sD[BQ];

  const int bh = blockIdx.x / s_blocks;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (blockIdx.x % s_blocks) * kRows + (threadIdx.x >> 5) * 16;
  const bf16* qb = q + (size_t)bh * t_len * D;
  const bf16* ob = dout + (size_t)bh * t_len * D;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;

  uint32_t ka[G::KS][4], va[G::KS][4];
  load_a<D>(ka, k + (size_t)bh * s_len * D, r0, s_len, lane);
  load_a<D>(va, v + (size_t)bh * s_len * D, r0, s_len, lane);
  float dka[G::NT][4], dva[G::NT][4];
  zero(dka);
  zero(dva);

  for (int i0 = 0; i0 < t_len; i0 += BQ) {
    __syncthreads();
    load_tile<D, BQ>(sQ, qb, i0, t_len);
    load_tile<D, BQ>(sO, ob, i0, t_len);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x;
      const bool ok = i0 + i < t_len;
      sL[i] = ok ? lb[i0 + i] : 0.f;
      sD[i] = ok ? db[i0 + i] : 0.f;
    }
    __syncthreads();

    float p[BQ / 8][4], ds[BQ / 8][4];
    zero(p);
    zero(ds);
    mma_abt<D, BQ>(p, ka, sQ, lane);    // k q^T
    mma_abt<D, BQ>(ds, va, sO, lane);   // v dO^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float prob = i0 + c < t_len ? expf(p[j][e] * scale - sL[c]) : 0.f;
        p[j][e] = prob;
        ds[j][e] = prob * (ds[j][e] - sD[c]);
      }
    mma_px<D, BQ>(dva, p, sO, lane);    // p^T dO
    mma_px<D, BQ>(dka, ds, sQ, lane);   // dS^T q
  }

  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<D>(dk + (size_t)bh * s_len * D, dka, r0, s_len, mul, lane);
  store_rows<D>(dv + (size_t)bh * s_len * D, dva, r0, s_len, one, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
                         int s_blocks, float scale) {
  using G = Geometry<D>;
  __shared__ float4 sQ[G::BN * G::C4];
  __shared__ float4 sO[G::BN * G::C4];
  __shared__ float sL[G::BN];
  __shared__ float sD[G::BN];

  const int bh = blockIdx.x / s_blocks;
  const int sb = blockIdx.x % s_blocks;
  const int lane_g = threadIdx.x % G::TPR;
  const int row = sb * G::BM + threadIdx.x / G::TPR;
  const bool row_valid = row < s_len;

  const float* qb = q + (size_t)bh * t_len * D;
  const float* ob = dout + (size_t)bh * t_len * D;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;
  const size_t row_off = ((size_t)bh * s_len + (row_valid ? row : 0)) * D;

  float4 kr[G::NC], vr[G::NC], dka[G::NC], dva[G::NC];
  load_row<D>(kr, k + row_off, row_valid, lane_g);
  load_row<D>(vr, v + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) {
    dka[c] = zero4();
    dva[c] = zero4();
  }

  for (int i0 = 0; i0 < t_len; i0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sQ, qb, i0, t_len);
    stage_tile<D>(sO, ob, i0, t_len);
    for (int i = threadIdx.x; i < G::BN; i += kThreads) {
      const bool ok = i0 + i < t_len;
      sL[i] = ok ? lb[i0 + i] : 0.f;
      sD[i] = ok ? db[i0 + i] : 0.f;
    }
    __syncthreads();
    const int n_valid = min(G::BN, t_len - i0);
#pragma unroll 2
    for (int i = 0; i < n_valid; ++i) {
      float4 qq[G::NC], oo[G::NC];
      load_srow<D>(qq, sQ + i * G::C4, lane_g);
      load_srow<D>(oo, sO + i * G::C4, lane_g);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        s = dot4(kr[c], qq[c], s);
        dp = dot4(vr[c], oo[c], dp);
      }
      row_sum2<G::TPR>(s, dp);
      const float p = row_valid ? expf(s * scale - sL[i]) : 0.f;
      const float ds = p * (dp - sD[i]);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        axpy4(p, oo[c], dva[c]);
        axpy4(ds, qq[c], dka[c]);
      }
    }
  }

  if (row_valid) {
    store_row<D>(dk + row_off, dka, scale, lane_g);
    store_row<D>(dv + row_off, dva, 1.f, lane_g);
  }
}

}  // namespace adt

#define ADT_LAUNCH_DKV_BF16(D)                                                              \
  {                                                                                         \
    const int s_blocks = (s_len + adt::mma::kRows - 1) / adt::mma::kRows;                   \
    adt::flash_bwd_dkv_bf16_kernel<D><<<n * s_blocks, adt::mma::kThreads, 0, st>>>(         \
        static_cast<const adt::mma::bf16*>(q), static_cast<const adt::mma::bf16*>(k),       \
        static_cast<const adt::mma::bf16*>(v), static_cast<const adt::mma::bf16*>(dout),    \
        lse, delta, static_cast<adt::mma::bf16*>(dk), static_cast<adt::mma::bf16*>(dv),     \
        t_len, s_len, s_blocks, scale);                                                     \
  }

#define ADT_LAUNCH_DKV_F32(D)                                                                \
  {                                                                                          \
    const int s_blocks = (s_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_bwd_dkv_f32_kernel<D><<<n * s_blocks, adt::kThreads, 0, st>>>(               \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,           \
        static_cast<float*>(dk), static_cast<float*>(dv), t_len, s_len, s_blocks, scale);    \
  }

extern "C" int adt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int n, int t_len, int s_len, int head_dim,
                                 int is_bf16, float scale, void* stream) {
  if (n == 0 || s_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DKV_BF16);
  else
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DKV_F32);
  return static_cast<int>(cudaGetLastError());
}
