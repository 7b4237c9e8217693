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
// Two layouts (group_norm.cuh), a template parameter of each kernel; the
// caller says which (ops/fused_norm.py: a channels-last 4-D tensor takes
// NHWC, anything else NCHW).
//
// Bound on this card: bytes, one read of x and one write of y.
//
// NCHW: each (sample, group) is one contiguous run of n = (C / G) * HW
// elements, starting at run * n (not 16-byte aligned where HW is odd: each
// pass takes a scalar head up to the first 16-byte boundary, 16-byte
// vectors, then a scalar tail). Two designs, by the run's size (launch()
// picks):
//   * resident: one block a run holds it in shared memory, so x is read
//     once: the statistics pass loads it with 16-byte loads, sums x and x^2
//     and keeps it; the normalise pass reads shared memory and writes y
//     with 16-byte stores. Every run that fits (up to 226 KB) is such a
//     run: every SD UNet and VAE 64 x 64 site in bf16.
//   * split: a longer run (the VAE decoder's 512 x 512 slabs: 2 MB in bf16)
//     is cut into slices of about kSliceElems elements, a block each. The
//     first kernel writes each slice's partial sums to a [B * G, splits]
//     buffer, allocated on the stream for the call (scratch_pool);
//     the second reduces a run's partials in a fixed order (the same in
//     every block: deterministic, no float atomics), then normalises its
//     slice, reading x again from device memory (three passes: the run
//     does not fit on chip).
//
// NHWC: a (sample, group) is HW chunks of C / G channels, C apart (12
// bytes at ADM-64's 64 x 64 level), so a block takes a sample, a slice of
// its pixels and a tile of whole groups, each thread 16 bytes along C
// (Tile, group_norm.cuh); each thread's vector takes its channels' FiLM and
// affine terms once, folded into y = act((x - mu) a + b). What bounds it
// is the same bytes, but a (sample, tile) is far longer than a run (384 KB
// at ADM-64's top level in tiles 64 bytes wide), so:
//   * resident where a tile at least 64 bytes wide fits one block's 52 KB
//     (four blocks an SM): ADM-64's 16 x 16 and 8 x 8 levels, LSUN-256's
//     16 x 16 and 8 x 8. One read of x, as NCHW's resident path.
//   * split elsewhere: tiles of whole pixel rows where C allows (up to 32
//     vectors: 384 contiguous bytes at ADM-64's top level), slices of 64K
//     elements; the partial kernel writes each slice's group sums to
//     scratch; the apply kernel adds a tile's slices in a fixed order (a
//     warp a group: lane-strided, then the xor tree), then normalises its
//     slice, reading x again: three passes, each a contiguous stream.
//   Measured on an H100 80GB HBM3 (PERF.md section 6) at ADM-64's 64 x 64
//   site, batch 400: this split 0.73 ms; slices held in shared memory by
//   clusters of up to 8 blocks that meet through distributed shared
//   memory (one read of x, strided 96-byte rows) 0.87 ms, 0.82 ms with
//   the cluster's barrier taken out; a persistent queue that reads each
//   slice a second time from the L2 1.25 ms; NCHW's resident kernel 0.55
//   ms. At LSUN-256's sites the split beats NCHW's kernels (0.46 against
//   0.69 ms at 64 x 64, 3.8 against 4.4 ms at 256 x 256).
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

// ---------------------------------------------------------------- NCHW

// One block a (sample, group) run, the run held in shared memory.
template <typename T>
__device__ __forceinline__ void resident_nchw(const T* __restrict__ x, const float* gamma,
                                              const float* beta, const float* scale,
                                              const float* shift, T* __restrict__ y,
                                              float* mu_out, float* rstd_out, int c, int hw,
                                              int groups, float eps, int act_silu) {
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
__device__ __forceinline__ void partial_nchw(const T* __restrict__ x, float2* part, int n,
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
__device__ __forceinline__ void apply_nchw(const T* __restrict__ x, const float* gamma,
                                           const float* beta, const float* scale,
                                           const float* shift, const float2* part,
                                           T* __restrict__ y, float* mu_out, float* rstd_out,
                                           int c, int hw, int groups, int splits, int slice,
                                           float eps, int act_silu) {
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

// ---------------------------------------------------------------- NHWC

// threads of an NHWC block, the shared memory a resident one may hold of
// its slice (four blocks an SM), the elements of a split call's slice
constexpr int kNhwcThreads = 256;
constexpr int kNhwcBudget = 52 * 1024;
constexpr int kNhwcSliceElems = 65536;

// Floats of shared memory ahead of an NHWC block's slice: the warps'
// column partials, the block's channel sums [2 ct], its group partials and
// the groups' (mu, rstd) (float2 [gt] each), rounded up to 16 bytes.
__host__ __device__ __forceinline__ int nhwc_head(int warps, int ct, int gt) {
  return (warps * ct * 2 + 2 * ct + 4 * gt + 3) & ~3;
}

template <typename T>
__device__ __forceinline__ void add_sums(const uint4& u, float (&s)[2][Vec<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) {
    const float v = to_f32(e[k]);
    s[0][k] += v;
    s[1][k] += v * v;
  }
}

// The block's groups' partial sums of x and x^2 over its slice (thread g
// < gt sums its group's channels in order), into gpart; x is also kept at
// sx (the slice, ct elements a pixel) where kKeep. Each thread has four
// loads in flight.
template <typename T, bool kKeep>
__device__ __forceinline__ void nhwc_slice_sums(const T* __restrict__ x, T* sx, int c, int hw,
                                                int cpg, const Tile& tp, const Place& pl,
                                                float* head, float2* gpart) {
  constexpr int V = Vec<T>::N;
  const int cols = tp.cols(V), gt = tp.ct / cpg, warps = blockDim.x >> 5;
  float* chs = head + warps * tp.ct * 2;
  const T* xb = x + (size_t)pl.b * hw * c + pl.t * tp.ct + pl.col * V;
  T* sxc = kKeep ? sx + pl.col * V - (size_t)pl.p0 * tp.ct : nullptr;
  const int step = tp.rows;
  float s[2][V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[0][e] = s[1][e] = 0.f;
  int p = pl.first;
  for (; p + 3 * step < pl.p1; p += 4 * step) {
    uint4 u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = *reinterpret_cast<const uint4*>(xb + (size_t)(p + j * step) * c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kKeep)
        *reinterpret_cast<uint4*>(sxc + (size_t)(p + j * step) * tp.ct) = u[j];
      add_sums<T>(u[j], s);
    }
  }
  for (; p < pl.p1; p += step) {
    const uint4 u = *reinterpret_cast<const uint4*>(xb + (size_t)p * c);
    if constexpr (kKeep) *reinterpret_cast<uint4*>(sxc + (size_t)p * tp.ct) = u;
    add_sums<T>(u, s);
  }
  column_sums<2, V>(s, cols, head, chs);
  for (int g = threadIdx.x; g < gt; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += chs[g * cpg + j];
      q += chs[tp.ct + g * cpg + j];
    }
    gpart[g] = make_float2(a, q);
  }
}

// y of the block's slice, pixel p read at src + p ld (device memory, ld c,
// or the slice in shared memory, ld ct), from the groups' (mu, rstd) in
// gstat: each thread's vector takes its channels' terms once, folded into
// y = act((x - mu) a + b), a = rstd gamma (1 + scale), b = beta (1 +
// scale) + shift.
template <typename T>
__device__ __forceinline__ void nhwc_normalise(const T* src, size_t ld, T* __restrict__ y,
                                               const float* gamma, const float* beta,
                                               const float* scale, const float* shift, int c,
                                               int hw, int cpg, const Tile& tp, const Place& pl,
                                               const float2* gstat, int act_silu) {
  constexpr int V = Vec<T>::N;
  float mu[V], a[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int cht = pl.col * V + e, ch = pl.t * tp.ct + cht;
    const float2 st = gstat[cht / cpg];
    const size_t bc = (size_t)pl.b * c + ch;
    const float film = 1.f + (scale ? scale[bc] : 0.f);
    mu[e] = st.x;
    a[e] = st.y * gamma[ch] * film;
    b[e] = beta[ch] * film + (shift ? shift[bc] : 0.f);
  }
  T* yb = y + (size_t)pl.b * hw * c + pl.t * tp.ct + pl.col * V;
  auto out = [&](int p, const uint4& u) {
    const T* e = reinterpret_cast<const T*>(&u);
    float f[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = (to_f32(e[k]) - mu[k]) * a[k] + b[k];
      f[k] = act_silu ? silu(v) : v;
    }
    Vec<T>::store(yb + (size_t)p * c, f);
  };
  const int step = tp.rows;
  int p = pl.first;
  for (; p + 3 * step < pl.p1; p += 4 * step) {
    uint4 u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = *reinterpret_cast<const uint4*>(src + (size_t)(p + j * step) * ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) out(p + j * step, u[j]);
  }
  for (; p < pl.p1; p += step) out(p, *reinterpret_cast<const uint4*>(src + (size_t)p * ld));
}

// Resident: one block a (sample, tile), the tile held in shared memory
// (read from device memory once).
template <typename T>
__device__ __forceinline__ void resident_nhwc(const T* __restrict__ x, const float* gamma,
                                              const float* beta, const float* scale,
                                              const float* shift, T* __restrict__ y,
                                              float* mu_out, float* rstd_out, int c, int hw,
                                              int groups, float eps, int act_silu,
                                              const Tile& tp) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem[];
  const int cpg = c / groups, gt = tp.ct / cpg, warps = blockDim.x >> 5;
  const Place pl(hw, tp, V);
  float* head = reinterpret_cast<float*>(smem);
  float2* gpart = reinterpret_cast<float2*>(head + warps * tp.ct * 2 + 2 * tp.ct);
  float2* gstat = gpart + gt;
  T* sx = reinterpret_cast<T*>(head + nhwc_head(warps, tp.ct, gt));
  nhwc_slice_sums<T, true>(x, sx, c, hw, cpg, tp, pl, head, gpart);
  __syncthreads();
  for (int g = threadIdx.x; g < gt; g += blockDim.x) {
    const float s[2] = {gpart[g].x, gpart[g].y};
    float mu, rstd;
    stats(s, cpg * hw, eps, mu, rstd);
    gstat[g] = make_float2(mu, rstd);
    const size_t i = (size_t)pl.b * groups + pl.t * gt + g;
    mu_out[i] = mu;
    rstd_out[i] = rstd;
  }
  __syncthreads();
  nhwc_normalise(sx + pl.col * V, tp.ct, y, gamma, beta, scale, shift, c, hw, cpg, tp, pl,
                 gstat, act_silu);
}

// Split, first kernel: a block's group partials to part[block][gt].
template <typename T>
__device__ __forceinline__ void partial_nhwc(const T* __restrict__ x, float2* part, int c, int hw,
                                             int groups, const Tile& tp) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem[];
  const int cpg = c / groups, gt = tp.ct / cpg, warps = blockDim.x >> 5;
  const Place pl(hw, tp, V);
  float* head = reinterpret_cast<float*>(smem);
  float2* gpart = reinterpret_cast<float2*>(head + warps * tp.ct * 2 + 2 * tp.ct);
  nhwc_slice_sums<T, false>(x, nullptr, c, hw, cpg, tp, pl, head, gpart);
  __syncthreads();
  for (int g = threadIdx.x; g < gt; g += blockDim.x) part[(size_t)blockIdx.x * gt + g] = gpart[g];
}

// Split, second kernel: each group's statistics from the tile's k slices'
// partials (a warp a group: lane l adds slices l, l + 32, ... in order,
// then the xor tree; the same order in every block), then the slice's y
// from x in device memory.
template <typename T>
__device__ __forceinline__ void apply_nhwc(const T* __restrict__ x, const float* gamma,
                                           const float* beta, const float* scale,
                                           const float* shift, const float2* part,
                                           T* __restrict__ y, float* mu_out, float* rstd_out,
                                           int c, int hw, int groups, float eps, int act_silu,
                                           const Tile& tp) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem[];
  const int cpg = c / groups, gt = tp.ct / cpg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const Place pl(hw, tp, V);
  float2* gstat = reinterpret_cast<float2*>(smem);
  const float2* tile_part = part + (size_t)(blockIdx.x - pl.s) * gt;
  for (int g = warp; g < gt; g += warps) {
    float s[2] = {0.f, 0.f};
    for (int r = lane; r < tp.k; r += 32) {
      const float2 v = tile_part[(size_t)r * gt + g];
      s[0] += v.x;
      s[1] += v.y;
    }
    s[0] = warp_sum(s[0]);
    s[1] = warp_sum(s[1]);
    if (lane == 0) {
      float mu, rstd;
      stats(s, cpg * hw, eps, mu, rstd);
      gstat[g] = make_float2(mu, rstd);
      if (pl.s == 0) {
        const size_t i = (size_t)pl.b * groups + pl.t * gt + g;
        mu_out[i] = mu;
        rstd_out[i] = rstd;
      }
    }
  }
  __syncthreads();
  nhwc_normalise(x + (size_t)pl.b * hw * c + pl.t * tp.ct + pl.col * V, (size_t)c, y, gamma,
                 beta, scale, shift, c, hw, cpg, tp, pl, gstat, act_silu);
}

// ------------------------------------------------------------- kernels

// NCHW: one block a (sample, group) run, resident. NHWC: one block a
// (sample, tile), resident.
template <typename T, int L>
__global__ void __launch_bounds__(L == kNchw ? kMaxThreads : kNhwcThreads, L == kNchw ? 1 : 4)
    group_norm_fwd_resident_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift, T* __restrict__ y,
                                   float* __restrict__ mu_out, float* __restrict__ rstd_out,
                                   int c, int hw, int groups, float eps, int act_silu,
                                   Tile tile) {
  if constexpr (L == kNchw)
    resident_nchw(x, gamma, beta, scale, shift, y, mu_out, rstd_out, c, hw, groups, eps,
                  act_silu);
  else
    resident_nhwc(x, gamma, beta, scale, shift, y, mu_out, rstd_out, c, hw, groups, eps,
                  act_silu, tile);
}

template <typename T, int L>
__global__ void __launch_bounds__(L == kNchw ? kMaxThreads : kNhwcThreads, L == kNchw ? 1 : 4)
    group_norm_fwd_partial_kernel(const T* __restrict__ x, float2* __restrict__ part, int c,
                                  int hw, int groups, int n, int splits, int slice, Tile tile) {
  if constexpr (L == kNchw)
    partial_nchw(x, part, n, splits, slice);
  else
    partial_nhwc(x, part, c, hw, groups, tile);
}

template <typename T, int L>
__global__ void __launch_bounds__(L == kNchw ? kMaxThreads : kNhwcThreads, L == kNchw ? 1 : 4)
    group_norm_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, const float* __restrict__ scale,
                                const float* __restrict__ shift, const float2* __restrict__ part,
                                T* __restrict__ y, float* __restrict__ mu_out,
                                float* __restrict__ rstd_out, int c, int hw, int groups,
                                int splits, int slice, float eps, int act_silu, Tile tile) {
  if constexpr (L == kNchw)
    apply_nchw(x, gamma, beta, scale, shift, part, y, mu_out, rstd_out, c, hw, groups, splits,
               slice, eps, act_silu);
  else
    apply_nhwc(x, gamma, beta, scale, shift, part, y, mu_out, rstd_out, c, hw, groups, eps,
               act_silu, tile);
}

// The memory pool of the split paths' partial sums on the current device:
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

// count float2 of partial sums from the library's pool, on the stream
cudaError_t scratch(float2** part, size_t count, cudaStream_t st) {
  cudaMemPool_t pool;
  const cudaError_t err = scratch_pool(&pool);
  if (err != cudaSuccess) return err;
  return cudaMallocFromPoolAsync(reinterpret_cast<void**>(part), count * sizeof(float2), pool,
                                 st);
}

template <typename T>
int launch_nchw(const T* x, const float* gamma, const float* beta, const float* scale,
                const float* shift, T* y, float* mu, float* rstd, int b, int c, int hw,
                int groups, int act_silu, float eps, cudaStream_t st) {
  const int runs = b * groups, cpg = c / groups, n = cpg * hw;
  const int terms = cpg * (int)sizeof(float4);
  const Tile none = {};
  // the run, 16 bytes for its offset within a vector, the channel terms
  const long long smem = terms + (long long)n * sizeof(T) + 16;
  if (smem <= kMaxDynamic) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        group_norm_fwd_resident_kernel<T, kNchw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    group_norm_fwd_resident_kernel<T, kNchw>
        <<<runs, n >= 8192 ? kMaxThreads : 256, (int)smem, st>>>(
            x, gamma, beta, scale, shift, y, mu, rstd, c, hw, groups, eps, act_silu, none);
    return static_cast<int>(cudaGetLastError());
  }
  const int splits = (n + kSliceElems - 1) / kSliceElems;
  const int slice = (n + splits - 1) / splits;
  float2* part = nullptr;
  cudaError_t err = scratch(&part, (size_t)runs * splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_fwd_partial_kernel<T, kNchw><<<runs * splits, kMaxThreads, 0, st>>>(
      x, part, c, hw, groups, n, splits, slice, none);
  group_norm_fwd_apply_kernel<T, kNchw><<<runs * splits, kMaxThreads, terms, st>>>(
      x, gamma, beta, scale, shift, part, y, mu, rstd, c, hw, groups, splits, slice, eps,
      act_silu, none);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(part, st);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

template <typename T>
int launch_nhwc(const T* x, const float* gamma, const float* beta, const float* scale,
                const float* shift, T* y, float* mu, float* rstd, int b, int c, int hw,
                int groups, int act_silu, float eps, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int cpg = c / groups;
  Tile tp;
  bool resident;
  if (!plan_tile(c, cpg, hw, sizeof(T), V, kNhwcThreads, sizeof(T), kNhwcBudget, 1,
                 kNhwcSliceElems, tp, resident))
    return -1;
  const int threads = tp.threads(V), warps = threads / 32, gt = tp.ct / cpg;
  const int blocks = b * tp.tiles * tp.k;
  const size_t head = sizeof(float) * nhwc_head(warps, tp.ct, gt);
  if (resident) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        group_norm_fwd_resident_kernel<T, kNhwc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t smem = head + (size_t)hw * tp.ct * sizeof(T);
    group_norm_fwd_resident_kernel<T, kNhwc><<<blocks, threads, smem, st>>>(
        x, gamma, beta, scale, shift, y, mu, rstd, c, hw, groups, eps, act_silu, tp);
    return static_cast<int>(cudaGetLastError());
  }
  float2* part = nullptr;
  cudaError_t err = scratch(&part, (size_t)blocks * gt, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_fwd_partial_kernel<T, kNhwc><<<blocks, threads, head, st>>>(x, part, c, hw, groups,
                                                                         0, 0, 0, tp);
  group_norm_fwd_apply_kernel<T, kNhwc><<<blocks, threads, gt * sizeof(float2), st>>>(
      x, gamma, beta, scale, shift, part, y, mu, rstd, c, hw, groups, 0, 0, eps, act_silu, tp);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(part, st);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace gn
}  // namespace adt

// x, y [B, C, HW] (nhwc 0) or [B, HW, C] (nhwc 1), float32 or bfloat16;
// gamma, beta [C] float32; scale, shift [B, C] float32 or null (no FiLM
// term); mu, rstd [B, G] float32; x and y 16-byte aligned.
extern "C" int adt_group_norm_fwd(const void* x, const float* gamma, const float* beta,
                                  const float* scale, const float* shift, void* y, float* mu,
                                  float* rstd, int b, int c, int hw, int groups, int act_silu,
                                  int is_bf16, int nhwc, float eps, void* stream) {
  using adt::gn::launch_nchw;
  using adt::gn::launch_nhwc;
  using bf16 = __nv_bfloat16;
  if (b == 0 || c == 0) return 0;
  if (groups <= 0 || c % groups) return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    bf16* yb = static_cast<bf16*>(y);
    return nhwc ? launch_nhwc(xb, gamma, beta, scale, shift, yb, mu, rstd, b, c, hw, groups,
                              act_silu, eps, st)
                : launch_nchw(xb, gamma, beta, scale, shift, yb, mu, rstd, b, c, hw, groups,
                              act_silu, eps, st);
  }
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  return nhwc ? launch_nhwc(xf, gamma, beta, scale, shift, yf, mu, rstd, b, c, hw, groups,
                            act_silu, eps, st)
              : launch_nchw(xf, gamma, beta, scale, shift, yf, mu, rstd, b, c, hw, groups,
                            act_silu, eps, st);
}
