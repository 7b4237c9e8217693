// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_attn_kernel
// (dispatched by _flash_forward): o = softmax(q k^T / sqrt(D)) v by online
// softmax, plus the per-row float32 logsumexp the backward needs.
//
// Bound on this card: at the ADM-64 shapes (D = 64, T = S = 1024) the work is
// 4 T S D operations per head against (3 + 1) T D elements moved, far above
// the H100's operations-per-byte ridge, so it is bound by operations. The
// [T, S] logits never reach device memory: a block keeps 64 query rows
// resident, streams K and V through shared memory a tile at a time, and
// carries the running max, sum and accumulator in float32.
//   bfloat16: the two products run on the tensor cores (mma.sync, bf16
//     operands, float32 accumulators); p is rounded to bf16 before P V.
//   float32:  float32 FMAs on the CUDA cores (flash_simt.cuh), since the
//     tensor cores would round float32 operands to TF32.
#include "flash_mma.cuh"
#include "flash_simt.cuh"

namespace adt {

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_bf16_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                      const mma::bf16* __restrict__ v, mma::bf16* __restrict__ o,
                      float* __restrict__ lse, int t_len, int s_len, int t_blocks, float scale) {
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

  uint32_t qa[G::KS][4];
  load_a<D>(qa, q + (size_t)bh * t_len * D, r0, t_len, lane);
  float acc[G::NT][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < s_len; j0 += BN) {
    __syncthreads();
    load_tile<D, BN>(sK, kb, j0, s_len);
    load_tile<D, BN>(sV, vb, j0, s_len);
    __syncthreads();

    float s[BN / 8][4];
    zero(s);
    mma_abt<D, BN>(s, qa, sK, lane);
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
        l[e >> 1] += s[j][e];   // this lane's share of the row sum
      }
#pragma unroll
    for (int n = 0; n < G::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_px<D, BN>(acc, s, sV, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / l_safe;
    const int r = r0 + (lane >> 2) + 8 * h;
    if (t == 0 && r < t_len) lse[(size_t)bh * t_len + r] = m[h] + logf(l_safe);
  }
  store_rows<D>(o + (size_t)bh * t_len * D, acc, r0, t_len, inv, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int t_len, int s_len, int t_blocks, float scale) {
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

  float4 qr[G::NC], acc[G::NC];
  load_row<D>(qr, q + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) acc[c] = zero4();
  float m = kNegInf, l = 0.f;

  for (int j0 = 0; j0 < s_len; j0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sK, kb, j0, s_len);
    stage_tile<D>(sV, vb, j0, s_len);
    __syncthreads();
    const int n_valid = min(G::BN, s_len - j0);
    for (int jc = 0; jc < n_valid; jc += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float x = row_sum<G::TPR>(lane_dot<D>(qr, sK + (jc + jj) * G::C4, lane_g)) * scale;
        x = (jc + jj < n_valid) ? x : kNegInf;
        s[jj] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) scale4(alpha, acc[c]);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) lane_axpy<D>(s[jj], sV + (jc + jj) * G::C4, acc, lane_g);
    }
  }

  if (row_valid) {
    const float l_safe = fmaxf(l, 1e-30f);
    store_row<D>(o + row_off, acc, 1.f / l_safe, lane_g);
    if (lane_g == 0) lse[(size_t)bh * t_len + row] = m + logf(l_safe);
  }
}

}  // namespace adt

#define ADT_LAUNCH_FWD_BF16(D)                                                              \
  {                                                                                         \
    const int t_blocks = (t_len + adt::mma::kRows - 1) / adt::mma::kRows;                   \
    adt::flash_fwd_bf16_kernel<D><<<n * t_blocks, adt::mma::kThreads, 0, st>>>(             \
        static_cast<const adt::mma::bf16*>(q), static_cast<const adt::mma::bf16*>(k),       \
        static_cast<const adt::mma::bf16*>(v), static_cast<adt::mma::bf16*>(o), lse, t_len, \
        s_len, t_blocks, scale);                                                            \
  }

#define ADT_LAUNCH_FWD_F32(D)                                                                \
  {                                                                                          \
    const int t_blocks = (t_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_fwd_f32_kernel<D><<<n * t_blocks, adt::kThreads, 0, st>>>(                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<float*>(o), lse, t_len, s_len, t_blocks,   \
        scale);                                                                              \
  }

extern "C" int adt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int n, int t_len, int s_len, int head_dim, int is_bf16,
                             float scale, void* stream) {
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_FWD_BF16);
  else
    ADT_DISPATCH_D(head_dim, ADT_LAUNCH_FWD_F32);
  return static_cast<int>(cudaGetLastError());
}
