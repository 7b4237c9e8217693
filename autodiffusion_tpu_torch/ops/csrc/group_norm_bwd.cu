// Fused GroupNorm (+ FiLM) (+ SiLU) backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/fused_norm.py::_bwd_kernel.
// From x, the output cotangent g and the forward's saved mu, rstd it gives
// dx, dscale, dshift (per sample) and dgamma, dbeta (summed over the batch):
//   xhat = (x - mu) rstd,  z = xhat gamma + beta,  u = z (1 + scale) + shift
//   du = g silu'(u) (or g),  dz = du (1 + scale),  dxhat = dz gamma
//   dshift = sum_hw du,  dscale = sum_hw du z
//   dbeta = sum_{b,hw} dz,  dgamma = sum_{b,hw} dz xhat
//   dx = rstd (dxhat - mean_group(dxhat) - xhat mean_group(dxhat xhat))
//
// Layout NCHW: one block per (sample, group), whose run of (C / G) * HW
// elements is contiguous. Pass 1: one warp per channel sums du, du z and
// du xhat over the channel's HW elements; the per-channel sums give dshift,
// dscale and this sample's share of dbeta, dgamma, and (weighted by
// (1 + scale) gamma) the two group means of pass 2. Pass 2 writes dx.
// The TPU carries dgamma and dbeta across its sequential batch grid; blocks
// here run in no order, so each sample writes its share to [B, C] scratch
// and a second small kernel sums the batch, in a fixed order.
//
// Bound on this card: bytes (x and g read, dx written; the second pass
// reads the run again, from L2 at the ADM shapes).
#include "elementwise.cuh"

namespace adt {

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                      T* __restrict__ dx, float* __restrict__ dscale, float* __restrict__ dshift,
                      float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int c,
                      int hw, int groups, int act_silu) {
  extern __shared__ float red[];  // [2][cpg]: per-channel sums of dxhat, dxhat xhat
  const int bg = blockIdx.x;
  const int b = bg / groups, g = bg % groups;
  const int cpg = c / groups;
  const size_t base = ((size_t)b * c + (size_t)g * cpg) * hw;
  const float mu = mu_in[bg], rstd = rstd_in[bg];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int cc = warp; cc < cpg; cc += kNormWarps) {
    const int ch = g * cpg + cc;
    const size_t bc = (size_t)b * c + ch;
    const float ga = gamma[ch], be = beta[ch];
    const float film = 1.f + (scale ? scale[bc] : 0.f);
    const float sh = shift ? shift[bc] : 0.f;
    const T* xc = x + base + (size_t)cc * hw;
    const T* gc = gy + base + (size_t)cc * hw;
    float s_du = 0.f, s_duz = 0.f, s_duxh = 0.f;
    for (int i = lane; i < hw; i += 32) {
      const float xh = (to_f32(xc[i]) - mu) * rstd;
      const float z = xh * ga + be;
      float du = to_f32(gc[i]);
      if (act_silu) {
        const float u = z * film + sh;
        const float sg = sigmoid(u);
        du *= sg * (1.f + u * (1.f - sg));
      }
      s_du += du;
      s_duz += du * z;
      s_duxh += du * xh;
    }
    s_du = warp_sum(s_du);
    s_duz = warp_sum(s_duz);
    s_duxh = warp_sum(s_duxh);
    if (lane == 0) {
      dshift[bc] = s_du;
      dscale[bc] = s_duz;
      dbeta_part[bc] = film * s_du;
      dgamma_part[bc] = film * s_duxh;
      red[cc] = film * ga * s_du;
      red[cpg + cc] = film * ga * s_duxh;
    }
  }
  __syncthreads();
  float m1 = 0.f, m2 = 0.f;
  for (int cc = 0; cc < cpg; ++cc) {
    m1 += red[cc];
    m2 += red[cpg + cc];
  }
  const float cnt = (float)((size_t)cpg * hw);
  m1 /= cnt;
  m2 /= cnt;

  for (int cc = 0; cc < cpg; ++cc) {
    const int ch = g * cpg + cc;
    const size_t bc = (size_t)b * c + ch;
    const float ga = gamma[ch], be = beta[ch];
    const float film = 1.f + (scale ? scale[bc] : 0.f);
    const float sh = shift ? shift[bc] : 0.f;
    const size_t off = base + (size_t)cc * hw;
    for (int i = threadIdx.x; i < hw; i += kNormThreads) {
      const float xh = (to_f32(x[off + i]) - mu) * rstd;
      float du = to_f32(gy[off + i]);
      if (act_silu) {
        const float u = (xh * ga + be) * film + sh;
        const float sg = sigmoid(u);
        du *= sg * (1.f + u * (1.f - sg));
      }
      const float dxh = du * film * ga;
      dx[off + i] = from_f32<T>(rstd * (dxh - m1 - xh * m2));
    }
  }
}

// dgamma[c] = sum_b part_g[b, c], dbeta likewise, in batch order.
__global__ void group_norm_batch_sum_kernel(const float* __restrict__ part_g,
                                            const float* __restrict__ part_b,
                                            float* __restrict__ dgamma,
                                            float* __restrict__ dbeta, int batch, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float sg = 0.f, sb = 0.f;
  for (int b = 0; b < batch; ++b) {
    sg += part_g[(size_t)b * c + ch];
    sb += part_b[(size_t)b * c + ch];
  }
  dgamma[ch] = sg;
  dbeta[ch] = sb;
}

}  // namespace adt

// x, g, dx [B, C, HW] (float32 or bfloat16); gamma, beta [C] float32; scale,
// shift [B, C] float32 or null; mu, rstd [B, G] float32 from the forward;
// dscale, dshift, dgamma_part, dbeta_part [B, C] float32; dgamma, dbeta [C]
// float32.
extern "C" int adt_group_norm_bwd(const void* x, const void* g, const float* gamma,
                                  const float* beta, const float* scale, const float* shift,
                                  const float* mu, const float* rstd, void* dx, float* dscale,
                                  float* dshift, float* dgamma_part, float* dbeta_part,
                                  float* dgamma, float* dbeta, int b, int c, int hw, int groups,
                                  int act_silu, int is_bf16, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (groups <= 0 || c % groups) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = b * groups;
  const size_t smem = 2 * (size_t)(c / groups) * sizeof(float);
  if (is_bf16)
    adt::group_norm_bwd_kernel<__nv_bfloat16><<<blocks, adt::kNormThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), gamma, beta,
        scale, shift, mu, rstd, static_cast<__nv_bfloat16*>(dx), dscale, dshift, dgamma_part,
        dbeta_part, c, hw, groups, act_silu);
  else
    adt::group_norm_bwd_kernel<float><<<blocks, adt::kNormThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), gamma, beta, scale, shift,
        mu, rstd, static_cast<float*>(dx), dscale, dshift, dgamma_part, dbeta_part, c, hw,
        groups, act_silu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adt::group_norm_batch_sum_kernel<<<(c + 255) / 256, 256, 0, st>>>(dgamma_part, dbeta_part,
                                                                     dgamma, dbeta, b, c);
  return static_cast<int>(cudaGetLastError());
}
