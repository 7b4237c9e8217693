// Flash-attention forward at head dim 512 for Hopper (sm_90a), plain C
// interface: the AutoencoderKL mid-block's single head (T = S = 4096 at
// 512 x 512 pixels).
//
// Replaces autodiffusion_tpu/ops/flash_attention.py::_attn_kernel at D = 512
// (the TPU kernel shrinks its blocks there so that q, k, v and the float32
// accumulator fit VMEM). Same o, lse contract as flash_fwd.cu.
//
// Design: the D <= 128 kernel cannot hold D = 512. Its q fragments (32
// k-steps) and a 64 x 512 float32 accumulator overflow the registers, and
// two 64 x 520 bfloat16 tiles exceed 48 KB of static shared memory. So the
// output head dim is split across blocks: block (row tile, slice) keeps the
// 64 query rows of its tile in dynamic shared memory (raised with
// cudaFuncSetAttribute), recomputes the logits over the full 512-deep
// contraction from them and a 64-key K tile, and accumulates one 128-wide
// slice of o from the matching slice of V. The four slices of a row tile
// each compute the same logits, so the logits' operations count four times.
//   bfloat16: mma.sync (bf16 operands, float32 accumulators), the q A
//     fragments read from shared memory with ldmatrix at each k-step;
//   float32: the CUDA-core kernel of flash_fwd.cuh, one warp a row (32
//     lanes x 16 features).
//
// Bound on this card: operations (4 T S D per head against 4 T D elements
// moved: at T = S = 4096 about 2000 operations a byte).
#include "flash_fwd.cuh"

namespace adt {

constexpr int kWideD = 512;
constexpr int kSlice = 128;             // output features a block
constexpr int kWideBN = 64;             // keys a tile
constexpr int kLDQ = kWideD + 8;        // padded shared rows (ldmatrix bank spread)
constexpr int kLDV = mma::Geom<kSlice>::LD;

constexpr size_t kWideSmem =
    (size_t)(mma::kRows * kLDQ + kWideBN * kLDQ + kWideBN * kLDV) * sizeof(mma::bf16);

__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_wide_bf16_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                           const mma::bf16* __restrict__ v, mma::bf16* __restrict__ o,
                           float* __restrict__ lse, int t_len, int s_len, int t_blocks,
                           float scale) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [64][kLDQ]
  bf16* sK = sQ + kRows * kLDQ;              // [kWideBN][kLDQ]
  bf16* sV = sK + kWideBN * kLDQ;            // [kWideBN][kLDV]: this block's slice

  const int bh = blockIdx.x / t_blocks;
  const int tile0 = (blockIdx.x % t_blocks) * kRows;
  const int col0 = blockIdx.y * kSlice;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int r0 = tile0 + warp * 16;
  const bf16* qb = q + (size_t)bh * t_len * kWideD;
  const bf16* kb = k + (size_t)bh * s_len * kWideD;
  const bf16* vb = v + (size_t)bh * s_len * kWideD;
  constexpr int kC = kWideD / 8;  // 16-byte chunks a row

  for (int idx = threadIdx.x; idx < kRows * kC; idx += mma::kThreads) {
    const int r = idx / kC, c = idx % kC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (tile0 + r < t_len)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(tile0 + r) * kWideD + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * kLDQ + c * 8) = val;
  }

  float acc[kSlice / 8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < s_len; j0 += kWideBN) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kWideBN * kC; idx += mma::kThreads) {
      const int r = idx / kC, c = idx % kC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < s_len)
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(j0 + r) * kWideD + c * 8);
      *reinterpret_cast<uint4*>(sK + r * kLDQ + c * 8) = val;
    }
    for (int idx = threadIdx.x; idx < kWideBN * (kSlice / 8); idx += mma::kThreads) {
      const int r = idx / (kSlice / 8), c = idx % (kSlice / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < s_len)
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(j0 + r) * kWideD + col0 + c * 8);
      *reinterpret_cast<uint4*>(sV + r * kLDV + c * 8) = val;
    }
    __syncthreads();

    float s[kWideBN / 8][4];
    zero(s);
#pragma unroll 4
    for (int kk = 0; kk < kWideD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3],
              sQ + (warp * 16 + (lane & 15)) * kLDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kWideBN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLDQ + kk * 16 +
                    ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a, b0, b1);
        mma16816(s[2 * np + 1], a, b2, b3);
      }
    }
    softmax_tile<kWideBN, kSlice / 8>(s, acc, m, l, j0, s_len, scale, t);
    mma_px<kSlice, kWideBN>(acc, s, sV, lane);
  }

  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(quad_sum(l[h]), 1e-30f);
    const float inv = 1.f / l_safe;
    const int r = r0 + g + 8 * h;
    if (r >= t_len) continue;
    if (t == 0 && blockIdx.y == 0) lse[(size_t)bh * t_len + r] = m[h] + logf(l_safe);
    bf16* orow = o + ((size_t)bh * t_len + r) * kWideD + col0;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

}  // namespace adt

// q, o [n, T, 512]; k, v [n, S, 512]; lse [n, T]. -1 for another head dim.
extern "C" int adt_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int n, int t_len, int s_len, int head_dim,
                                  int is_bf16, float scale, void* stream) {
  if (head_dim != adt::kWideD) return -1;
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(adt::flash_fwd_wide_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)adt::kWideSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int t_blocks = (t_len + adt::mma::kRows - 1) / adt::mma::kRows;
    const dim3 grid(n * t_blocks, adt::kWideD / adt::kSlice);
    adt::flash_fwd_wide_bf16_kernel<<<grid, adt::mma::kThreads, adt::kWideSmem, st>>>(
        static_cast<const adt::mma::bf16*>(q), static_cast<const adt::mma::bf16*>(k),
        static_cast<const adt::mma::bf16*>(v), static_cast<adt::mma::bf16*>(o), lse, t_len,
        s_len, t_blocks, scale);
  } else {
    ADT_LAUNCH_FWD_F32(512, 1, 512);
  }
  return static_cast<int>(cudaGetLastError());
}
