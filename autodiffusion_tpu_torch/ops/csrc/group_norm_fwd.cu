// Fused GroupNorm (+ FiLM) (+ SiLU) forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/fused_norm.py::_fwd_kernel:
//   y = act( ((x - mu) * (rstd * gamma) + beta) * (1 + scale) + shift )
// with mu, rstd per (sample, group) in float32 (var = max(E[x^2] - mu^2, 0),
// rstd = rsqrt(var + eps)), FiLM and SiLU in float32 and one cast to x's
// dtype at the end. mu and rstd are saved for the backward kernel.
//
// Layout: NCHW, so each (sample, group) is one contiguous run of
// (C / G) * HW elements. One block per (sample, group): it sums x and x^2
// over its run, then normalises the run channel by channel (gamma, beta,
// scale and shift are constant along a channel's HW elements).
//
// Bound on this card: bytes. The work is a handful of operations per
// element against one read and one write; the second pass reads the run
// again, from L2 at the ADM shapes (a run is at most 48 KB in bf16 there).
#include "elementwise.cuh"

namespace adt {

constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out, int c, int hw,
                      int groups, float eps, int act_silu) {
  __shared__ float scratch[2 * 32];
  const int bg = blockIdx.x;
  const int b = bg / groups, g = bg % groups;
  const int cpg = c / groups;
  const size_t n = (size_t)cpg * hw;
  const size_t base = ((size_t)b * c + (size_t)g * cpg) * hw;
  const T* xg = x + base;

  float s[2] = {0.f, 0.f};
  for (size_t i = threadIdx.x; i < n; i += kNormThreads) {
    const float v = to_f32(xg[i]);
    s[0] += v;
    s[1] += v * v;
  }
  block_sum<2>(s, scratch);
  const float cnt = (float)n;
  const float mu = s[0] / cnt;
  const float var = fmaxf(s[1] / cnt - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mu_out[bg] = mu;
    rstd_out[bg] = rstd;
  }

  for (int cc = 0; cc < cpg; ++cc) {
    const int ch = g * cpg + cc;
    const float mul = rstd * gamma[ch];
    const float add = beta[ch];
    const float film = 1.f + (scale ? scale[(size_t)b * c + ch] : 0.f);
    const float sh = shift ? shift[(size_t)b * c + ch] : 0.f;
    const T* xc = xg + (size_t)cc * hw;
    T* yc = y + base + (size_t)cc * hw;
    for (int i = threadIdx.x; i < hw; i += kNormThreads) {
      float u = ((to_f32(xc[i]) - mu) * mul + add) * film + sh;
      if (act_silu) u = silu(u);
      yc[i] = from_f32<T>(u);
    }
  }
}

}  // namespace adt

// x, y [B, C, HW] (float32 or bfloat16); gamma, beta [C] float32; scale,
// shift [B, C] float32 or null (no FiLM term); mu, rstd [B, G] float32.
extern "C" int adt_group_norm_fwd(const void* x, const float* gamma, const float* beta,
                                  const float* scale, const float* shift, void* y, float* mu,
                                  float* rstd, int b, int c, int hw, int groups, int act_silu,
                                  int is_bf16, float eps, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (groups <= 0 || c % groups) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = b * groups;
  if (is_bf16)
    adt::group_norm_fwd_kernel<__nv_bfloat16><<<blocks, adt::kNormThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta, scale, shift,
        static_cast<__nv_bfloat16*>(y), mu, rstd, c, hw, groups, eps, act_silu);
  else
    adt::group_norm_fwd_kernel<float><<<blocks, adt::kNormThreads, 0, st>>>(
        static_cast<const float*>(x), gamma, beta, scale, shift, static_cast<float*>(y), mu,
        rstd, c, hw, groups, eps, act_silu);
  return static_cast<int>(cudaGetLastError());
}
