// Fused GroupNorm (+ FiLM) (+ SiLU) forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/fused_norm.py::_fwd_kernel:
//   y = act( ((x - mu) * (rstd * gamma) + beta) * (1 + scale) + shift )
// with mu, rstd per (sample, group) in float32 (sums of x and x^2, var =
// max(E[x^2] - mu^2, 0), rstd = rsqrt(var + eps)), FiLM and SiLU in float32
// and one cast to x's dtype at the end. mu and rstd are saved for the
// backward kernel.
//
// Layout: NCHW, so each (sample, group) is one contiguous run of n =
// (C / G) * HW elements, starting at run * n (not 16-byte aligned where HW
// is odd: each pass takes a scalar head up to the first 16-byte boundary,
// 16-byte vectors, then a scalar tail).
//
// Bound on this card: bytes, one read of x and one write of y. Two designs,
// by the run's size (launch() picks):
//   * resident: one block a run holds it in shared memory, so x is read
//     once: the statistics pass loads it with 16-byte loads, sums x and x^2
//     and keeps it; the normalise pass reads shared memory and writes y
//     with 16-byte stores. Every run that fits (up to 226 KB) is such a
//     run: every ADM-64, SD UNet and VAE 64 x 64 site in bf16.
//   * split: a longer run (the VAE decoder's 512 x 512 slabs: 2 MB in bf16)
//     is cut into slices of about kSliceElems elements, a block each. The
//     first kernel writes each slice's partial sums to a [B * G, splits]
//     buffer, allocated on the stream for the call (scratch_pool);
//     the second reduces a run's partials in a fixed order (the same in
//     every block: deterministic, no float atomics), then normalises its
//     slice, reading x again from device memory (three passes: the run
//     does not fit on chip).
// Only the order of the float32 sums differs from the TPU kernel's.
#include "group_norm.cuh"

#include <mutex>

namespace adt {
namespace gn {

constexpr int kMaxThreads = 512;
// the most dynamic shared memory a resident block may take: 227 KB less
// the kernel's static shared memory (under 1 KB)
constexpr int kMaxDynamic = 232448 - 1024;
// elements of a slice of a run too long to be resident (a block each)
constexpr int kSliceElems = 16384;

// Per channel of the group, in shared memory: (mul, add, film, shift) with
// u = ((x - mu) * mul + add) * film + shift.
__device__ __forceinline__ void channel_terms(float4* terms, const float* gamma,
                                              const float* beta, const float* scale,
                                              const float* shift, int b, int c, int g, int cpg,
                                              float rstd) {
  for (int cc = threadIdx.x; cc < cpg; cc += blockDim.x) {
    const int ch = g * cpg + cc;
    terms[cc] = make_float4(rstd * gamma[ch], beta[ch],
                            1.f + (scale ? scale[(size_t)b * c + ch] : 0.f),
                            shift ? shift[(size_t)b * c + ch] : 0.f);
  }
}

__device__ __forceinline__ float apply(float x, float mu, const float4& w, int act_silu) {
  float u = ((x - mu) * w.x + w.y) * w.z + w.w;
  return act_silu ? silu(u) : u;
}

// y[i] for run elements [lo, hi) read through `src` (device or shared
// memory holding the run's element i at src[i]; src and the run share
// their alignment modulo 16 bytes), written to the run's y.
template <typename T>
__device__ __forceinline__ void normalise(const T* src, T* yr, int lo, int hi, int hw, float mu,
                                          const float4* terms, int act_silu) {
  constexpr int N = Vec<T>::N;
  const Split<T> sp(yr, lo, hi);
  for (int i = lo + threadIdx.x; i < sp.head_end; i += blockDim.x)
    yr[i] = from_f32<T>(apply(to_f32(src[i]), mu, terms[i / hw], act_silu));
  for (int i = sp.vec_end + threadIdx.x; i < hi; i += blockDim.x)
    yr[i] = from_f32<T>(apply(to_f32(src[i]), mu, terms[i / hw], act_silu));
#pragma unroll 2
  for (int i = sp.head_end + threadIdx.x * N; i < sp.vec_end; i += blockDim.x * N) {
    float f[N];
    Vec<T>::load(src + i, f);
    int ch = i / hw, next = (ch + 1) * hw;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      while (i + e >= next) {  // a vector may cross channels where hw % N != 0
        ++ch;
        next += hw;
      }
      f[e] = apply(f[e], mu, terms[ch], act_silu);
    }
    Vec<T>::store(yr + i, f);
  }
}

// mu, rstd from the block's float32 sums (s[0] = sum x, s[1] = sum x^2)
__device__ __forceinline__ void stats(const float (&s)[2], int n, float eps, float& mu,
                                      float& rstd) {
  const float cnt = (float)n;
  mu = s[0] / cnt;
  const float var = fmaxf(s[1] / cnt - mu * mu, 0.f);
  rstd = rsqrtf(var + eps);
}

// One block a (sample, group) run, the run held in shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_fwd_resident_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift, T* __restrict__ y,
                                   float* __restrict__ mu_out, float* __restrict__ rstd_out,
                                   int c, int hw, int groups, float eps, int act_silu) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem[];
  __shared__ float scratch[2 * 32];
  const int run = blockIdx.x, b = run / groups, g = run - b * groups;
  const int cpg = c / groups, n = cpg * hw;
  const T* xr = x + (size_t)run * n;
  // the run at sx[0, n), sx as aligned modulo 16 bytes as xr
  float4* terms = smem;
  T* sx = reinterpret_cast<T*>(smem + cpg) +
          (reinterpret_cast<uintptr_t>(xr) / sizeof(T)) % N;

  float s[2] = {0.f, 0.f};
  const Split<T> sp(xr, 0, n);
  for (int i = threadIdx.x; i < sp.head_end; i += blockDim.x) {
    const T e = xr[i];
    sx[i] = e;
    s[0] += to_f32(e);
    s[1] += to_f32(e) * to_f32(e);
  }
  for (int i = sp.vec_end + threadIdx.x; i < n; i += blockDim.x) {
    const T e = xr[i];
    sx[i] = e;
    s[0] += to_f32(e);
    s[1] += to_f32(e) * to_f32(e);
  }
#pragma unroll 4
  for (int i = sp.head_end + threadIdx.x * N; i < sp.vec_end; i += blockDim.x * N) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
    *reinterpret_cast<uint4*>(sx + i) = u;
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float v = to_f32(e[k]);
      s[0] += v;
      s[1] += v * v;
    }
  }
  block_sum<2>(s, scratch);
  float mu, rstd;
  stats(s, n, eps, mu, rstd);
  if (threadIdx.x == 0) {
    mu_out[run] = mu;
    rstd_out[run] = rstd;
  }
  channel_terms(terms, gamma, beta, scale, shift, b, c, g, cpg, rstd);
  __syncthreads();
  normalise(sx, y + (size_t)run * n, 0, n, hw, mu, terms, act_silu);
}

// Split runs, first kernel: the partial sums of one slice of a run.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_fwd_partial_kernel(const T* __restrict__ x, float2* __restrict__ part, int n,
                                  int splits, int slice) {
  constexpr int N = Vec<T>::N;
  __shared__ float scratch[2 * 32];
  const int run = blockIdx.x / splits, sl = blockIdx.x - run * splits;
  const int lo = min(n, sl * slice), hi = min(n, lo + slice);
  const T* xr = x + (size_t)run * n;
  float s[2] = {0.f, 0.f};
  const Split<T> sp(xr, lo, hi);
  for (int i = lo + threadIdx.x; i < sp.head_end; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    s[0] += v;
    s[1] += v * v;
  }
  for (int i = sp.vec_end + threadIdx.x; i < hi; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    s[0] += v;
    s[1] += v * v;
  }
#pragma unroll 4
  for (int i = sp.head_end + threadIdx.x * N; i < sp.vec_end; i += blockDim.x * N) {
    float f[N];
    Vec<T>::load(xr + i, f);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[0] += f[k];
      s[1] += f[k] * f[k];
    }
  }
  block_sum<2>(s, scratch);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s[0], s[1]);
}

// Split runs, second kernel: the run's statistics from its partials (lane
// l of warp 0 sums partials l, l + 32, ... in order, then the warp's xor
// tree: the same order in every block of the run), then the slice's y.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, const float* __restrict__ scale,
                                const float* __restrict__ shift, const float2* __restrict__ part,
                                T* __restrict__ y, float* __restrict__ mu_out,
                                float* __restrict__ rstd_out, int c, int hw, int groups,
                                int splits, int slice, float eps, int act_silu) {
  extern __shared__ float4 smem[];
  __shared__ float2 run_stats;
  const int run = blockIdx.x / splits, sl = blockIdx.x - run * splits;
  const int b = run / groups, g = run - b * groups;
  const int cpg = c / groups, n = cpg * hw;
  if (threadIdx.x < 32) {
    float s[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < splits; i += 32) {
      const float2 p = part[(size_t)run * splits + i];
      s[0] += p.x;
      s[1] += p.y;
    }
    s[0] = warp_sum(s[0]);
    s[1] = warp_sum(s[1]);
    if (threadIdx.x == 0) {
      float mu, rstd;
      stats(s, n, eps, mu, rstd);
      run_stats = make_float2(mu, rstd);
      if (sl == 0) {
        mu_out[run] = mu;
        rstd_out[run] = rstd;
      }
    }
  }
  __syncthreads();
  const float mu = run_stats.x, rstd = run_stats.y;
  channel_terms(smem, gamma, beta, scale, shift, b, c, g, cpg, rstd);
  __syncthreads();
  const int lo = min(n, sl * slice), hi = min(n, lo + slice);
  normalise(x + (size_t)run * n, y + (size_t)run * n, lo, hi, hw, mu, smem, act_silu);
}

// The memory pool of the split path's partial sums on the current device:
// one of this library's own that keeps what it has reserved. (The
// device's default pool hands its memory back to the system at every
// synchronisation, and taking it again cost a split call more than its
// kernels: PERF.md section 6.)
cudaError_t scratch_pool(cudaMemPool_t* pool) {
  constexpr int kMaxDevices = 64;
  static cudaMemPool_t pools[kMaxDevices] = {};
  static std::mutex guard;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(guard);
  if (!pools[dev]) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t made;
    err = cudaMemPoolCreate(&made, &props);
    if (err != cudaSuccess) return err;
    uint64_t keep = UINT64_MAX;
    err = cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) {
      cudaMemPoolDestroy(made);
      return err;
    }
    pools[dev] = made;
  }
  *pool = pools[dev];
  return cudaSuccess;
}

template <typename T>
int launch(const void* xv, const float* gamma, const float* beta, const float* scale,
           const float* shift, void* yv, float* mu, float* rstd, int b, int c, int hw,
           int groups, int act_silu, float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int runs = b * groups, cpg = c / groups, n = cpg * hw;
  const int terms = cpg * (int)sizeof(float4);
  // the run, 16 bytes for its offset within a vector, the channel terms
  const long long smem = terms + (long long)n * sizeof(T) + 16;
  if (smem <= kMaxDynamic) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        group_norm_fwd_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    group_norm_fwd_resident_kernel<T><<<runs, n >= 8192 ? kMaxThreads : 256, (int)smem, st>>>(
        x, gamma, beta, scale, shift, y, mu, rstd, c, hw, groups, eps, act_silu);
    return static_cast<int>(cudaGetLastError());
  }
  const int splits = (n + kSliceElems - 1) / kSliceElems;
  const int slice = (n + splits - 1) / splits;
  cudaMemPool_t pool;
  cudaError_t err = scratch_pool(&pool);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2* part = nullptr;
  err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&part),
                                (size_t)runs * splits * sizeof(float2), pool, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_fwd_partial_kernel<T><<<runs * splits, kMaxThreads, 0, st>>>(x, part, n, splits,
                                                                         slice);
  group_norm_fwd_apply_kernel<T><<<runs * splits, kMaxThreads, terms, st>>>(
      x, gamma, beta, scale, shift, part, y, mu, rstd, c, hw, groups, splits, slice, eps,
      act_silu);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(part, st);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace gn
}  // namespace adt

// x, y [B, C, HW] (float32 or bfloat16); gamma, beta [C] float32; scale,
// shift [B, C] float32 or null (no FiLM term); mu, rstd [B, G] float32;
// x and y 16-byte aligned.
extern "C" int adt_group_norm_fwd(const void* x, const float* gamma, const float* beta,
                                  const float* scale, const float* shift, void* y, float* mu,
                                  float* rstd, int b, int c, int hw, int groups, int act_silu,
                                  int is_bf16, float eps, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (groups <= 0 || c % groups) return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return adt::gn::launch<__nv_bfloat16>(x, gamma, beta, scale, shift, y, mu, rstd, b, c, hw,
                                          groups, act_silu, eps, st);
  return adt::gn::launch<float>(x, gamma, beta, scale, shift, y, mu, rstd, b, c, hw, groups,
                                act_silu, eps, st);
}
