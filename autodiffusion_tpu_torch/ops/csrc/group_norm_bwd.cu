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
// Only the gradients asked for are written.
//
// Bound on this card: bytes, x and g read once and dx written once (a few
// dozen float32 operations an element, the sigmoid's exponential and
// division the costliest). Two layouts (group_norm.cuh), a template
// parameter of the kernel; the caller says which (ops/fused_norm.py).
//
// NCHW: one block per (sample, group), whose run of n = (C / G) * HW
// elements is contiguous (and starts off a 16-byte boundary where HW is
// odd: scalar heads and tails, as group_norm_fwd.cu). Two designs, by the
// run's size (launch_nchw() picks):
//   * resident: the sums' pass reads the run's x and g once from device
//     memory, 16 bytes at a time, and keeps x and each element's du
//     (float32) in shared memory, so that the dx pass reads them from
//     there and forms no second sigmoid.
//   * streamed: a run too long for shared memory reads x and g from
//     device memory twice (the sums, then dx), 16 bytes at a time, and
//     forms du twice.
//
// NHWC: a (sample, group) is HW strided chunks of C / G channels (4 to 16
// at the ADM-64 classifier's sites: 8 to 32 bytes), so a block owns a
// sample, a slice of its pixels and a tile of whole groups, each thread
// four channels (8 bytes in bf16: the thread keeps four terms and two
// sums, compensated where streamed, for each channel in registers). dscale
// and dshift are column sums over pixels, which suit this layout: each
// thread sums its channels, column_sums() the block's, and the slices of a
// (sample, tile) are one cluster of up to 8 blocks that add each other's
// channel sums through distributed shared memory, rank by rank (the same
// order in every block: deterministic). Two designs, by the tile's size
// (launch_nhwc() picks):
//   * resident (every classifier site of the guided step): each block
//     keeps its slice's x and g in shared memory (up to 70 KB, three
//     blocks an SM) and forms du again in the dx pass, so x and g are
//     read once.
//   * streamed (longer tiles): each block reads its slice's x and g twice.
// One launch either way (the batch sum of dgamma, dbeta follows where
// they are asked for).
#include "group_norm.cuh"

#include <type_traits>

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
// shared memory there (aligned as x modulo 16 bytes of x). Each lane sums
// its elements (hw / 32 of a channel's piece: 1024 at a 256 x 256 run)
// with Kahan's compensation, so that a long piece's float32 sums stay
// as close to the exact ones as the twin's tree sums are.
template <typename T>
__device__ __forceinline__ void piece_sums(const T* x, const T* gs, T* sx, float* du, int lo,
                                           int hi, float mu, float rstd, const float4& w,
                                           int act_silu, int lane, float (&s)[3]) {
  constexpr int N = Vec<T>::N;
  float comp[3] = {0.f, 0.f, 0.f};
  auto acc = [&](int k, float v) {
    const float y = v - comp[k];
    const float t = s[k] + y;
    comp[k] = (t - s[k]) - y;
    s[k] = t;
  };
  auto add = [&](float xv, float gv) {
    float d, z, xh;
    grad_terms(xv, gv, mu, rstd, w, act_silu, d, z, xh);
    acc(0, d);
    acc(1, d * z);
    acc(2, d * xh);
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

// NCHW: one block a (sample, group) run.
template <typename T, bool kResident>
__device__ __forceinline__ void bwd_nchw(const T* __restrict__ x, const T* __restrict__ gy,
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

// NHWC: threads of a block and the shared memory a resident one may hold
// of its slice's x and g (three blocks an SM). The backward moves four
// elements a thread at a time (8 bytes in bf16), which keeps a thread's
// per-channel terms and sums in registers.
constexpr int kNhwcThreads = 256;
constexpr int kNhwcBudget = 70 * 1024;
// the most blocks a (sample, tile)'s slices take: a cluster of the
// portable size, whose blocks read each other's shared memory
constexpr int kNhwcCluster = 8;
constexpr int kQuad = 4;

// Four consecutive elements of T (8 bytes of bf16, 16 of float32).
template <typename T>
struct Quad {
  using Raw = typename std::conditional<sizeof(T) == 2, uint2, uint4>::type;
  __device__ __forceinline__ static Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void floats(const Raw& u, float (&f)[kQuad]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < kQuad; ++k) f[k] = to_f32(e[k]);
  }
  __device__ __forceinline__ static void store(T* p, const float (&f)[kQuad]) {
    Raw u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < kQuad; ++k) e[k] = from_f32<T>(f[k]);
    *reinterpret_cast<Raw*>(p) = u;
  }
};

// NHWC: shared memory ahead of a block's slice, in floats: the warps'
// column partials [warps ct 2], the block's channel sums and the
// cluster's [2 ct] each, the groups' (m1, m2) [2 gt], rounded up to 16
// bytes.
__host__ __device__ __forceinline__ int nhwc_head(int warps, int ct, int gt) {
  return (warps * ct * 2 + 4 * ct + 2 * gt + 3) & ~3;
}

// NHWC: a block a slice of a (sample, tile), in clusters of tile.k. Each
// thread's four channels take their terms once (xhat = (x - mu) rstd, u =
// xhat a1 + a0 with a1 = gamma (1 + scale), a0 = beta (1 + scale) + shift,
// and dz gamma = du a1) and sum du and du xhat per channel (sum du z =
// gamma sum du xhat + beta sum du); the channel sums meet through
// distributed shared memory, rank by rank (every block forms the same
// totals); rank 0 writes the gradients asked for. Resident slices keep x
// and g in shared memory for the dx pass (which forms du again: 4 bytes an
// element in bf16 rather than 6 with du kept, so a tile 64 bytes wide fits
// a cluster); streamed ones read x and g again.
template <typename T, bool kResident>
__device__ __forceinline__ void bwd_nhwc(const T* __restrict__ x, const T* __restrict__ gy,
                                         const float* gamma, const float* beta,
                                         const float* scale, const float* shift,
                                         const float* mu_in, const float* rstd_in,
                                         T* __restrict__ dx, float* dscale, float* dshift,
                                         float* dgamma_part, float* dbeta_part, int c, int hw,
                                         int groups, int act_silu, const Tile& tp) {
  constexpr int V = kQuad;
  using Q = Quad<T>;
  using Raw = typename Q::Raw;
  namespace cg = cooperative_groups;
  extern __shared__ float4 smem[];
  const int cpg = c / groups, gt = tp.ct / cpg, warps = blockDim.x >> 5, cols = tp.cols(V);
  const Place pl(hw, tp, V);
  float* head = reinterpret_cast<float*>(smem);
  float* chs = head + warps * tp.ct * 2;
  float* tot = chs + 2 * tp.ct;
  float2* gm = reinterpret_cast<float2*>(tot + 2 * tp.ct);
  T* sx = nullptr;
  T* sg = nullptr;
  if constexpr (kResident) {
    sx = reinterpret_cast<T*>(head + nhwc_head(warps, tp.ct, gt));
    sg = sx + (size_t)tp.slice * tp.ct;
  }
  float mu[V], rs[V], a1[V], a0[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int cht = pl.col * V + e, ch = pl.t * tp.ct + cht;
    const size_t bg = (size_t)pl.b * groups + pl.t * gt + cht / cpg, bc = (size_t)pl.b * c + ch;
    const float film = 1.f + (scale ? scale[bc] : 0.f);
    mu[e] = mu_in[bg];
    rs[e] = rstd_in[bg];
    a1[e] = gamma[ch] * film;
    a0[e] = beta[ch] * film + (shift ? shift[bc] : 0.f);
  }
  // du and xhat of the thread's four elements from raw x and g
  auto grads = [&](const Raw& xr, const Raw& gr, float (&du)[V], float (&xh)[V]) {
    float xf[V];
    Q::floats(xr, xf);
    Q::floats(gr, du);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xh[e] = (xf[e] - mu[e]) * rs[e];
      if (act_silu) {
        const float u = xh[e] * a1[e] + a0[e];
        const float sgm = sigmoid(u);
        du[e] *= sgm * (1.f + u * (1.f - sgm));
      }
    }
  };
  const size_t off = (size_t)pl.b * hw * c + pl.t * tp.ct + pl.col * V;
  const T* xb = x + off;
  const T* gb = gy + off;
  const size_t at0 = pl.col * V - (size_t)pl.p0 * tp.ct;  // pixel p of the slice at p ct + at0
  const int step = tp.rows;

  // each thread sums its channels over its pixels: a resident slice gives
  // it a few dozen at most, a streamed one hundreds (SR's 256 x 256
  // sites), where plain float32 sums drift from the twin's, so those take
  // Kahan's compensation, as piece_sums()
  float s[2][V], cmp[2][V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[0][e] = s[1][e] = cmp[0][e] = cmp[1][e] = 0.f;
  auto acc = [&](int k, int e, float v) {
    if constexpr (kResident) {
      s[k][e] += v;
    } else {
      const float y = v - cmp[k][e];
      const float t = s[k][e] + y;
      cmp[k][e] = (t - s[k][e]) - y;
      s[k][e] = t;
    }
  };
  auto sums = [&](int p, const Raw& xr, const Raw& gr) {
    if constexpr (kResident) {
      *reinterpret_cast<Raw*>(sx + (size_t)p * tp.ct + at0) = xr;
      *reinterpret_cast<Raw*>(sg + (size_t)p * tp.ct + at0) = gr;
    }
    float du[V], xh[V];
    grads(xr, gr, du, xh);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc(0, e, du[e]);
      acc(1, e, du[e] * xh[e]);
    }
  };
  int p = pl.first;
  for (; p + step < pl.p1; p += 2 * step) {
    Raw xr[2], gr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      xr[j] = Q::load(xb + (size_t)(p + j * step) * c);
      gr[j] = Q::load(gb + (size_t)(p + j * step) * c);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) sums(p + j * step, xr[j], gr[j]);
  }
  if (p < pl.p1) sums(p, Q::load(xb + (size_t)p * c), Q::load(gb + (size_t)p * c));
  column_sums<2, V>(s, cols, head, chs);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  cluster_wait();
  for (int i = threadIdx.x; i < 2 * tp.ct; i += blockDim.x) {
    float a = 0.f;
    for (int r = 0; r < tp.k; ++r) a += cluster.map_shared_rank(chs, r)[i];
    tot[i] = a;
  }
  // the sums stay until every block has read them: arrive now, wait at
  // the end
  cluster_arrive();
  __syncthreads();
  // the gradients asked for (rank 0), and each group's two means
  for (int cht = threadIdx.x; pl.s == 0 && cht < tp.ct; cht += blockDim.x) {
    const int ch = pl.t * tp.ct + cht;
    const size_t bc = (size_t)pl.b * c + ch;
    const float film = 1.f + (scale ? scale[bc] : 0.f);
    if (dshift) {
      dshift[bc] = tot[cht];
      dscale[bc] = gamma[ch] * tot[tp.ct + cht] + beta[ch] * tot[cht];
    }
    if (dgamma_part) {
      dbeta_part[bc] = film * tot[cht];
      dgamma_part[bc] = film * tot[tp.ct + cht];
    }
  }
  const float n = (float)(cpg * hw);
  for (int g = threadIdx.x; g < gt; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      const int cht = g * cpg + j, ch = pl.t * tp.ct + cht;
      const float fg = (1.f + (scale ? scale[(size_t)pl.b * c + ch] : 0.f)) * gamma[ch];
      m1 += fg * tot[cht];
      m2 += fg * tot[tp.ct + cht];
    }
    gm[g] = make_float2(m1 / n, m2 / n);
  }
  __syncthreads();
  float m1[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float2 v = gm[(pl.col * V + e) / cpg];
    m1[e] = v.x;
    m2[e] = v.y;
  }
  T* dxb = dx + off;
  auto out = [&](int q, const Raw& xr, const Raw& gr) {
    float du[V], xh[V];
    grads(xr, gr, du, xh);
#pragma unroll
    for (int e = 0; e < V; ++e) du[e] = rs[e] * (du[e] * a1[e] - m1[e] - xh[e] * m2[e]);
    Q::store(dxb + (size_t)q * c, du);
  };
  for (p = pl.first; p + step < pl.p1; p += 2 * step) {
    Raw xr[2], gr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = p + j * step;
      if constexpr (kResident) {
        xr[j] = *reinterpret_cast<const Raw*>(sx + (size_t)q * tp.ct + at0);
        gr[j] = *reinterpret_cast<const Raw*>(sg + (size_t)q * tp.ct + at0);
      } else {
        xr[j] = Q::load(xb + (size_t)q * c);
        gr[j] = Q::load(gb + (size_t)q * c);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) out(p + j * step, xr[j], gr[j]);
  }
  if (p < pl.p1) {
    if constexpr (kResident)
      out(p, *reinterpret_cast<const Raw*>(sx + (size_t)p * tp.ct + at0),
          *reinterpret_cast<const Raw*>(sg + (size_t)p * tp.ct + at0));
    else
      out(p, Q::load(xb + (size_t)p * c), Q::load(gb + (size_t)p * c));
  }
  cluster_wait();
}

template <typename T, bool kResident, int L>
__global__ void __launch_bounds__(L == kNchw ? kMaxThreads : kNhwcThreads, L == kNchw ? 2 : 3)
    group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                          T* __restrict__ dx, float* __restrict__ dscale,
                          float* __restrict__ dshift, float* __restrict__ dgamma_part,
                          float* __restrict__ dbeta_part, int c, int hw, int groups,
                          int act_silu, Tile tile) {
  if constexpr (L == kNchw)
    bwd_nchw<T, kResident>(x, gy, gamma, beta, scale, shift, mu_in, rstd_in, dx, dscale,
                           dshift, dgamma_part, dbeta_part, c, hw, groups, act_silu);
  else
    bwd_nhwc<T, kResident>(x, gy, gamma, beta, scale, shift, mu_in, rstd_in, dx, dscale,
                           dshift, dgamma_part, dbeta_part, c, hw, groups, act_silu, tile);
}

// dgamma[c] = sum_b part_g[b, c], dbeta likewise, in batch order (the
// partials are [B, C] in either layout).
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

template <typename T, bool kResident, int L>
cudaError_t allow_dynamic_smem() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(group_norm_bwd_kernel<T, kResident, L>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamic);
  return attr;
}

template <typename T>
cudaError_t launch_nchw(const T* x, const T* gy, const float* gamma, const float* beta,
                        const float* scale, const float* shift, const float* mu,
                        const float* rstd, T* dx, float* dscale, float* dshift,
                        float* dgamma_part, float* dbeta_part, int b, int c, int hw, int groups,
                        int act_silu, cudaStream_t st) {
  const int runs = b * groups, cpg = c / groups, n = cpg * hw;
  const int threads = n >= 8192 ? kMaxThreads : n >= 2048 ? 256 : 128;
  const Tile none = {};
  const long long resident = 4ll * head_floats(cpg, threads / 32) +
                             run_bytes(n, sizeof(T)) + run_bytes(n, sizeof(float));
  if (resident <= kMaxDynamic) {
    const cudaError_t attr = allow_dynamic_smem<T, true, kNchw>();
    if (attr != cudaSuccess) return attr;
    group_norm_bwd_kernel<T, true, kNchw><<<runs, threads, (int)resident, st>>>(
        x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift, dgamma_part, dbeta_part,
        c, hw, groups, act_silu, none);
  } else {
    const long long head = 4ll * head_floats(cpg, kMaxThreads / 32);
    if (head > kMaxDynamic) return cudaErrorInvalidValue;
    const cudaError_t attr = allow_dynamic_smem<T, false, kNchw>();
    if (attr != cudaSuccess) return attr;
    group_norm_bwd_kernel<T, false, kNchw><<<runs, kMaxThreads, (int)head, st>>>(
        x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift, dgamma_part, dbeta_part,
        c, hw, groups, act_silu, none);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nhwc(const T* x, const T* gy, const float* gamma, const float* beta,
                        const float* scale, const float* shift, const float* mu,
                        const float* rstd, T* dx, float* dscale, float* dshift,
                        float* dgamma_part, float* dbeta_part, int b, int c, int hw, int groups,
                        int act_silu, cudaStream_t st) {
  constexpr int V = kQuad;
  const int cpg = c / groups;
  Tile tp;
  bool resident;
  if (!plan_tile(c, cpg, hw, sizeof(T), V, kNhwcThreads, 2 * sizeof(T), kNhwcBudget,
                 kNhwcCluster, 0, tp, resident))
    return cudaErrorInvalidValue;
  const int threads = tp.threads(V), gt = tp.ct / cpg;
  const int blocks = b * tp.tiles * tp.k;
  const size_t head = sizeof(float) * nhwc_head(threads / 32, tp.ct, gt);
  if (resident) {
    const cudaError_t attr = allow_dynamic_smem<T, true, kNhwc>();
    if (attr != cudaSuccess) return attr;
    const size_t smem = head + (size_t)tp.slice * tp.ct * 2 * sizeof(T);
    return launch_clusters(group_norm_bwd_kernel<T, true, kNhwc>, blocks, threads, smem, tp.k,
                           st, x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift,
                           dgamma_part, dbeta_part, c, hw, groups, act_silu, tp);
  }
  const cudaError_t attr = allow_dynamic_smem<T, false, kNhwc>();
  if (attr != cudaSuccess) return attr;
  return launch_clusters(group_norm_bwd_kernel<T, false, kNhwc>, blocks, threads, head, tp.k,
                         st, x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift,
                         dgamma_part, dbeta_part, c, hw, groups, act_silu, tp);
}

template <typename T>
int launch(const void* xv, const void* gv, const float* gamma, const float* beta,
           const float* scale, const float* shift, const float* mu, const float* rstd, void* dxv,
           float* dscale, float* dshift, float* dgamma_part, float* dbeta_part, float* dgamma,
           float* dbeta, int b, int c, int hw, int groups, int act_silu, int nhwc,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* gy = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  cudaError_t err = (nhwc ? launch_nhwc<T> : launch_nchw<T>)(
      x, gy, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift, dgamma_part, dbeta_part,
      b, c, hw, groups, act_silu, st);
  if (err == cudaErrorInvalidValue) return -1;
  if (err != cudaSuccess || !dgamma) return static_cast<int>(err);
  group_norm_batch_sum_kernel<<<(c + 255) / 256, 256, 0, st>>>(dgamma_part, dbeta_part, dgamma,
                                                                dbeta, b, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn
}  // namespace adt

// x, g, dx [B, C, HW] (nhwc 0) or [B, HW, C] (nhwc 1), float32 or
// bfloat16, 16-byte aligned; gamma, beta [C] float32; scale, shift [B, C]
// float32 or null (no FiLM term); mu, rstd [B, G] float32 from the
// forward. The gradients asked for, each pair null or not: dscale, dshift
// [B, C] float32; dgamma_part, dbeta_part [B, C] and dgamma, dbeta [C]
// float32 (all four null or none).
extern "C" int adt_group_norm_bwd(const void* x, const void* g, const float* gamma,
                                  const float* beta, const float* scale, const float* shift,
                                  const float* mu, const float* rstd, void* dx, float* dscale,
                                  float* dshift, float* dgamma_part, float* dbeta_part,
                                  float* dgamma, float* dbeta, int b, int c, int hw, int groups,
                                  int act_silu, int is_bf16, int nhwc, void* stream) {
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
                                          hw, groups, act_silu, nhwc, st);
  return adt::gn::launch<float>(x, g, gamma, beta, scale, shift, mu, rstd, dx, dscale, dshift,
                                dgamma_part, dbeta_part, dgamma, dbeta, b, c, hw, groups,
                                act_silu, nhwc, st);
}
