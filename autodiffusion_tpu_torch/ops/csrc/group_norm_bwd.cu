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
// Layout NCHW: one block per (sample, group), whose run of n = (C / G) * HW
// elements is contiguous (and starts off a 16-byte boundary where HW is
// odd: scalar heads and tails, as group_norm_fwd.cu).
//
// Bound on this card: bytes, x and g read once and dx written once (a few
// dozen float32 operations an element, the sigmoid's exponential and
// division the costliest). Two designs, by the run's size (launch()
// picks):
//   * resident: the sums' pass reads the run's x and g once from device
//     memory, 16 bytes at a time, and keeps x and each element's du
//     (float32) in shared memory, so that the dx pass reads them from
//     there and forms no second sigmoid. Every site of the searches is
//     such a run: the ADM-64 classifier's 17 GroupNorms, at most 4 x 4096
//     elements a run (96 KB of x and du in bf16: two blocks an SM).
//   * streamed: a run too long for shared memory reads x and g from
//     device memory twice (the sums, then dx), 16 bytes at a time, and
//     forms du twice.
#include "group_norm.cuh"

namespace adt {
namespace gn {

constexpr int kMaxThreads = 512;
// the most dynamic shared memory a block may take: 227 KB less the
// system's 1 KB
constexpr int kMaxDynamic = 232448 - 1024;

// du (the cotangent through the activation), z and xhat of one element;
// w = (gamma, beta, 1 + scale, shift) of its channel
__device__ __forceinline__ void grad_terms(float xv, float gv, float mu, float rstd,
                                           const float4& w, int act_silu, float& du, float& z,
                                           float& xh) {
  xh = (xv - mu) * rstd;
  z = xh * w.x + w.y;
  du = gv;
  if (act_silu) {
    const float u = z * w.z + w.w;
    const float sg = sigmoid(u);
    du *= sg * (1.f + u * (1.f - sg));
  }
}

// 16 bytes' worth (N elements of T) of float32 du in shared memory
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(p)[k];
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(p)[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
}

// s += (du, du z, du xhat) summed over run elements [lo, hi) by one warp
// from x and g in device memory (aligned alike modulo 16 bytes); where sx
// and du are not null (resident runs), x and each element's du are kept in
// shared memory there (aligned as x modulo 16 bytes of x)
template <typename T>
__device__ __forceinline__ void piece_sums(const T* x, const T* gs, T* sx, float* du, int lo,
                                           int hi, float mu, float rstd, const float4& w,
                                           int act_silu, int lane, float (&s)[3]) {
  constexpr int N = Vec<T>::N;
  auto add = [&](float xv, float gv) {
    float d, z, xh;
    grad_terms(xv, gv, mu, rstd, w, act_silu, d, z, xh);
    s[0] += d;
    s[1] += d * z;
    s[2] += d * xh;
    return d;
  };
  auto one = [&](int i) {
    const T xv = x[i];
    const float d = add(to_f32(xv), to_f32(gs[i]));
    if (du) {
      sx[i] = xv;
      du[i] = d;
    }
  };
  const Split<T> sp(x, lo, hi);
  for (int i = lo + lane; i < sp.head_end; i += 32) one(i);
  for (int i = sp.vec_end + lane; i < hi; i += 32) one(i);
#pragma unroll 2
  for (int i = sp.head_end + lane * N; i < sp.vec_end; i += 32 * N) {
    const uint4 xu = *reinterpret_cast<const uint4*>(x + i);
    const T* xe = reinterpret_cast<const T*>(&xu);
    float gf[N];
    Vec<T>::load(gs + i, gf);
#pragma unroll
    for (int e = 0; e < N; ++e) gf[e] = add(to_f32(xe[e]), gf[e]);
    if (du) {
      *reinterpret_cast<uint4*>(sx + i) = xu;
      store_floats(du + i, gf);
    }
  }
}

// Shared memory ahead of the run: the channel terms (float4 [cpg]), the
// two group sums' per-channel terms [2 cpg] and the pieces' sums
// [3 max(cpg, warps)], in floats, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int head_floats(int cpg, int warps) {
  return (4 * cpg + 2 * cpg + 3 * (cpg > warps ? cpg : warps) + 3) & ~3;
}
// Room for a run of n elements of `size` bytes (x, or du at 4) placed at
// its offset within a 16-byte vector of x (under 8 elements), rounded up
// to 16 bytes.
__host__ __device__ __forceinline__ int run_bytes(int n, int size) {
  return ((n + 8) * size + 15) / 16 * 16;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 2)
    group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                          T* __restrict__ dx, float* __restrict__ dscale,
                          float* __restrict__ dshift, float* __restrict__ dgamma_part,
                          float* __restrict__ dbeta_part, int c, int hw, int groups,
                          int act_silu) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem[];
  const int run = blockIdx.x, b = run / groups, g = run - b * groups;
  const int cpg = c / groups, n = cpg * hw;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = max(1, warps / cpg);  // warps a channel
  const int per_pass = warps / slices;     // channels summed at once
  float4* terms = smem;
  float* red = reinterpret_cast<float*>(terms + cpg);
  float* part = red + 2 * cpg;
  const T* xs = x + (size_t)run * n;
  const T* gs = gy + (size_t)run * n;
  T* dxr = dx + (size_t)run * n;
  T* sx = nullptr;
  float* du = nullptr;
  if constexpr (kResident) {
    // the run of x at sx[0, n) and its du at du[0, n), aligned as xs (and
    // g, dx: the launch takes 16-byte aligned tensors) modulo 16 bytes of
    // x
    const int mis = (int)((reinterpret_cast<uintptr_t>(xs) / sizeof(T)) % N);
    unsigned char* base =
        reinterpret_cast<unsigned char*>(reinterpret_cast<float*>(smem) + head_floats(cpg, warps));
    sx = reinterpret_cast<T*>(base) + mis;
    du = reinterpret_cast<float*>(base + run_bytes(n, sizeof(T))) + mis;
  }
  const float mu = mu_in[run], rstd = rstd_in[run];
  for (int cc = threadIdx.x; cc < cpg; cc += blockDim.x) {
    const int ch = g * cpg + cc;
    const size_t bc = (size_t)b * c + ch;
    terms[cc] = make_float4(gamma[ch], beta[ch], 1.f + (scale ? scale[bc] : 0.f),
                            shift ? shift[bc] : 0.f);
  }
  __syncthreads();

  // the pieces' sums: piece sl of channel cc is elements [sl len, (sl + 1)
  // len) of its HW, len a whole number of vectors
  const int len = ((hw + slices - 1) / slices + N - 1) / N * N;
  for (int c0 = 0; c0 < cpg; c0 += per_pass) {
    const int cc = c0 + warp / slices, sl = warp % slices;
    if (warp < per_pass * slices && cc < cpg) {
      const int lo = cc * hw + min(hw, sl * len), hi = cc * hw + min(hw, sl * len + len);
      float s[3] = {0.f, 0.f, 0.f};
      piece_sums(xs, gs, sx, du, lo, hi, mu, rstd, terms[cc], act_silu, lane, s);
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] = warp_sum(s[k]);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) part[(cc * slices + sl) * 3 + k] = s[k];
    }
  }
  __syncthreads();
  // per channel, its pieces in order; the gradients asked for
  for (int cc = threadIdx.x; cc < cpg; cc += blockDim.x) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int sl = 0; sl < slices; ++sl)
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] += part[(cc * slices + sl) * 3 + k];
    const float4 w = terms[cc];
    const size_t bc = (size_t)b * c + g * cpg + cc;
    if (dshift) {
      dshift[bc] = s[0];
      dscale[bc] = s[1];
    }
    if (dgamma_part) {
      dbeta_part[bc] = w.z * s[0];
      dgamma_part[bc] = w.z * s[2];
    }
    red[cc] = w.z * w.x * s[0];
    red[cpg + cc] = w.z * w.x * s[2];
  }
  __syncthreads();
  float m1 = 0.f, m2 = 0.f;
  for (int cc = 0; cc < cpg; ++cc) {
    m1 += red[cc];
    m2 += red[cpg + cc];
  }
  m1 /= (float)n;
  m2 /= (float)n;
  if constexpr (kResident) xs = sx;

  // dx = rstd (du (1 + scale) gamma - m1 - xhat m2) for v the element's
  // du (resident, from shared memory) or its g (streamed: du formed again)
  auto dx_of = [&](float xv, float v, const float4& w) {
    float d = v, z, xh = (xv - mu) * rstd;
    if constexpr (!kResident) grad_terms(xv, v, mu, rstd, w, act_silu, d, z, xh);
    return rstd * (d * w.z * w.x - m1 - xh * m2);
  };
  auto v_at = [&](int i) {
    if constexpr (kResident)
      return du[i];
    else
      return to_f32(gs[i]);
  };
  const Split<T> sp(dxr, 0, n);
  for (int i = threadIdx.x; i < sp.head_end; i += blockDim.x)
    dxr[i] = from_f32<T>(dx_of(to_f32(xs[i]), v_at(i), terms[i / hw]));
  for (int i = sp.vec_end + threadIdx.x; i < n; i += blockDim.x)
    dxr[i] = from_f32<T>(dx_of(to_f32(xs[i]), v_at(i), terms[i / hw]));
#pragma unroll 2
  for (int i = sp.head_end + threadIdx.x * N; i < sp.vec_end; i += blockDim.x * N) {
    float xf[N], vf[N];
    Vec<T>::load(xs + i, xf);
    if constexpr (kResident)
      load_floats(du + i, vf);
    else
      Vec<T>::load(gs + i, vf);
    int ch = i / hw, next = (ch + 1) * hw;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      while (i + e >= next) {  // a vector may cross channels where hw % N != 0
        ++ch;
        next += hw;
      }
      xf[e] = dx_of(xf[e], vf[e], terms[ch]);
    }
    Vec<T>::store(dxr + i, xf);
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

template <typename T>
int launch(const void* xv, const void* gv, const float* gamma, const float* beta,
           const float* scale, const float* shift, const float* mu, const float* rstd, void* dxv,
           float* dscale, float* dshift, float* dgamma_part, float* dbeta_part, float* dgamma,
           float* dbeta, int b, int c, int hw, int groups, int act_silu, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* gy = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  const int runs = b * groups, cpg = c / groups, n = cpg * hw;
  const int threads = n >= 8192 ? kMaxThreads : n >= 2048 ? 256 : 128;
  const long long resident = 4ll * head_floats(cpg, threads / 32) +
                             run_bytes(n, sizeof(T)) + run_bytes(n, sizeof(float));
  if (resident <= kMaxDynamic) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(group_norm_bwd_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamic);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    group_norm_bwd_kernel<T, true><<<runs, threads, (int)resident, st>>>(
        x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift, dgamma_part, dbeta_part,
        c, hw, groups, act_silu);
  } else {
    const long long head = 4ll * head_floats(cpg, kMaxThreads / 32);
    if (head > kMaxDynamic) return -1;
    static const cudaError_t attr =
        cudaFuncSetAttribute(group_norm_bwd_kernel<T, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamic);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    group_norm_bwd_kernel<T, false><<<runs, kMaxThreads, (int)head, st>>>(
        x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift, dgamma_part, dbeta_part,
        c, hw, groups, act_silu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dgamma) return static_cast<int>(err);
  group_norm_batch_sum_kernel<<<(c + 255) / 256, 256, 0, st>>>(dgamma_part, dbeta_part, dgamma,
                                                                dbeta, b, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn
}  // namespace adt

// x, g, dx [B, C, HW] (float32 or bfloat16, 16-byte aligned); gamma, beta
// [C] float32; scale, shift [B, C] float32 or null (no FiLM term); mu, rstd
// [B, G] float32 from the forward. The gradients asked for, each pair null
// or not: dscale, dshift [B, C] float32; dgamma_part, dbeta_part [B, C]
// and dgamma, dbeta [C] float32 (all four null or none).
extern "C" int adt_group_norm_bwd(const void* x, const void* g, const float* gamma,
                                  const float* beta, const float* scale, const float* shift,
                                  const float* mu, const float* rstd, void* dx, float* dscale,
                                  float* dshift, float* dgamma_part, float* dbeta_part,
                                  float* dgamma, float* dbeta, int b, int c, int hw, int groups,
                                  int act_silu, int is_bf16, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (groups <= 0 || c % groups) return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return -1;
  if (!dscale != !dshift || !dgamma_part != !dbeta_part || !dgamma != !dbeta ||
      !dgamma != !dgamma_part)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return adt::gn::launch<__nv_bfloat16>(x, g, gamma, beta, scale, shift, mu, rstd, dx, dscale,
                                          dshift, dgamma_part, dbeta_part, dgamma, dbeta, b, c,
                                          hw, groups, act_silu, st);
  return adt::gn::launch<float>(x, g, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift,
                                dgamma_part, dbeta_part, dgamma, dbeta, b, c, hw, groups,
                                act_silu, st);
}
