// 3x3 stride-1 SAME convolution as an implicit GEMM, for Hopper (sm_90a).
// Shared by conv3x3.cu (the plain conv + bias) and conv3x3_fused.cu (the
// norm-act-conv: silu(x a + b) applied to the input as it is loaded, and a
// residual added in the epilogue).
//
// Replaces the TPU kernels autodiffusion_tpu/ops/conv_im2col.py::_conv_kernel
// and ::_fused_conv_kernel. The TPU builds a [tile_h * W, 9 C_in] patch
// matrix in VMEM per row tile and runs one MXU dot against [9 C_in, C_out].
// Here the product is written transposed, out^T = W [C_out, 9 C_in] x
// patches^T [9 C_in, H W], because the port is NCHW: output rows are
// channels and columns pixels, so the epilogue stores neighbouring pixels
// of one channel, NCHW again with no transpose. M = C_out, N = B H W (a
// block's 64 pixels lie in one sample), K = 9 C_in ordered (tap, ci): the
// wrapper hands the weights as [C_out, 3, 3, C_in], so that the 16 (or 32)
// k of one step share one tap. The patch matrix never exists in device
// memory; device memory sees the input, the weights and the output.
//
// bfloat16 runs on the tensor cores (mma.sync.m16n8k16, bfloat16 operands,
// float32 accumulators), in one of two kernels:
//   * staged (C_in % 16 == 0 and W % 8 == 0, which the ADM shapes meet): a
//     block owns a tile of 64 pixels, 4 rows x 16 columns (8 x 8 where
//     W % 16 != 0), and 64, 96 or 128 output channels (4, 6 or 8 warps of
//     16). Per chunk of 16 input channels it stages the tile and its
//     one-pixel halo, 6 x 18 (10 x 10) pixels, once in shared memory,
//     channels innermost (the TPU kernels' NHWC), zero in the padding and,
//     in the fused kernel, through silu(x a + b) in float32;
//     the nine taps are then nine shifted reads of that slab: each lane's
//     ldmatrix row address is its pixel moved by (dh, dw), so the tap's
//     B fragment needs no copy. Each input element is read and transformed
//     once per block instead of once per tap.
//   * generic (any other shape): each k-step gathers its [32, 64] patch
//     slice element by element straight from the input.
// float32 runs on the CUDA cores (4 x 4 outputs per thread, the patch slice
// gathered as in the generic kernel), since the tensor cores would round
// float32 operands to TF32. All add the bias (and the residual) to the
// float32 accumulator and cast once.
//
// Bound on this card at the ADM shapes: operations (2 B H W C_out 9 C_in
// against a few bytes per output). Loads are synchronous and one chunk is
// in flight; wgmma, TMA and a pipeline are later work.
#pragma once

#include "elementwise.cuh"
#include "flash_mma.cuh"

namespace adt {
namespace conv {

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;      // [B, C_in, H, W]
  const void* wt;     // [C_out, 3, 3, C_in] = [C_out, K]
  const float* bias;  // [C_out] or null
  const float* a;     // [B, C_in] or null: the fused input affine
  const float* b;     // [B, C_in] or null
  const void* res;    // [B, C_out, H, W] or null
  void* y;            // [B, C_out, H, W]
  int c_in, h, w, c_out, hw, k, p_tiles;
  int tw;             // staged kernel: tile width (pixels), 64 / tw rows
};

// One element of the patch matrix: row kk = tap * C_in + ci of the K axis
// for the pixel (ph, pw), zero in the SAME padding or past K. In the fused
// kernel the input goes through silu(x a + b) in float32 first (the
// padding stays zero, as in the TPU kernel).
template <typename T, bool FUSED>
__device__ __forceinline__ float patch_value(const T* __restrict__ xb, const float* ab,
                                             const float* bb, const Params& p, int kk, int ph,
                                             int pw, bool pvalid) {
  if (!pvalid || kk >= p.k) return 0.f;
  const int tap = kk / p.c_in;
  const int ci = kk - tap * p.c_in;
  const int dh = tap / 3;
  const int ih = ph + dh - 1, iw = pw + (tap - dh * 3) - 1;
  if ((unsigned)ih >= (unsigned)p.h || (unsigned)iw >= (unsigned)p.w) return 0.f;
  float v = to_f32(xb[((size_t)ci * p.h + ih) * p.w + iw]);
  if (FUSED) v = silu(v * ab[ci] + bb[ci]);
  return v;
}

// ------------------------------------------------------ bfloat16, generic

constexpr int BM = 64;   // output channels per block, 16 per warp
constexpr int BN = 64;   // pixels per block
constexpr int BK = 32;   // K per step
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;  // padded shared rows (ldmatrix bank spread)
constexpr int LDB = BN + 8;

template <bool FUSED, bool RES>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16_kernel(const Params p) {
  using namespace adt::mma;
  __shared__ __align__(16) bf16 sA[BM * LDA];
  __shared__ __align__(16) bf16 sB[BK * LDB];

  const int b = blockIdx.x / p.p_tiles;
  const int p0 = (blockIdx.x % p.p_tiles) * BN;
  const int co0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* xb = static_cast<const bf16*>(p.x) + (size_t)b * p.c_in * p.hw;
  const bf16* wt = static_cast<const bf16*>(p.wt);
  const float* ab = FUSED ? p.a + (size_t)b * p.c_in : nullptr;
  const float* bb = FUSED ? p.b + (size_t)b * p.c_in : nullptr;

  // this thread's pixel column of the B tile
  const int n = threadIdx.x % BN;
  const int pix = p0 + n;
  const bool pvalid = pix < p.hw;
  const int ph = pvalid ? pix / p.w : 0;
  const int pw = pvalid ? pix - ph * p.w : 0;

  float acc[BN / 8][4];
  zero(acc);

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    __syncthreads();
    // A: BM rows x BK weights, 16 bytes per load (K % 8 == 0)
    for (int idx = threadIdx.x; idx < BM * BK / 8; idx += kThreads) {
      const int r = idx / (BK / 8), c8 = idx % (BK / 8);
      const int co = co0 + r, kk = k0 + c8 * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < p.c_out && kk < p.k)
        v = *reinterpret_cast<const uint4*>(wt + (size_t)co * p.k + kk);
      *reinterpret_cast<uint4*>(sA + r * LDA + c8 * 8) = v;
    }
    // B: the patch slice, gathered
    for (int kr = threadIdx.x / BN; kr < BK; kr += kThreads / BN)
      sB[kr * LDB + n] =
          from_f32<bf16>(patch_value<bf16, FUSED>(xb, ab, bb, p, k0 + kr, ph, pw, pvalid));
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3],
              sA + (warp * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, sB + (ks * 16 + (lane & 15)) * LDB + np * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * np], a, b0, b1);
        mma16816(acc[2 * np + 1], a, b2, b3);
      }
    }
  }

  // epilogue: C rows are channels, columns pixels (2 neighbours per lane)
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.hw & 1) == 0;
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int co = co0 + warp * 16 + g + 8 * h2;
    if (co >= p.c_out) continue;
    const float bv = p.bias ? p.bias[co] : 0.f;
    const size_t row = ((size_t)b * p.c_out + co) * p.hw;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int px = p0 + j * 8 + 2 * t;
      float v0 = acc[j][2 * h2] + bv, v1 = acc[j][2 * h2 + 1] + bv;
      if (pairs && px + 1 < p.hw) {
        if (RES) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + row + px);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + row + px) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (px < p.hw) {
          if (RES) v0 += __bfloat162float(res[row + px]);
          y[row + px] = __float2bfloat16_rn(v0);
        }
        if (px + 1 < p.hw) {
          if (RES) v1 += __bfloat162float(res[row + px + 1]);
          y[row + px + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}


// ------------------------------------------------------- bfloat16, staged

constexpr int CI = 16;           // input channels per chunk (one k16 step per tap)
constexpr int SLDA = 9 * CI + 8; // weight row in shared memory: 9 taps x 16 ci, padded
constexpr int SPIX = CI + 8;     // staged pixel: 16 channels, padded to 48 bytes so that
                                 // ldmatrix's eight 16-byte rows fall in distinct banks

// Shared memory of the staged kernel: the weight tile and the input slab.
inline size_t staged_smem(int warps, int tw) {
  return (size_t)(warps * 16 * SLDA + (64 / tw + 2) * (tw + 2) * SPIX) * sizeof(bf16);
}

template <bool FUSED, bool RES, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) conv3x3_staged_kernel(const Params p) {
  using namespace adt::mma;
  constexpr int NT = WARPS * 32;
  constexpr int BMW = WARPS * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [BMW][SLDA]: k = tap * 16 + ci
  bf16* sX = sA + BMW * SLDA;                // [(R + 2)(TW + 2)][SPIX]

  const int tw = p.tw, tr = 64 / tw, sw = tw + 2;
  const int npos = (tr + 2) * sw;
  const int b = blockIdx.x / p.p_tiles;
  const int ti = blockIdx.x % p.p_tiles;
  const int tiles_per_row = p.w / tw;
  const int h0 = (ti / tiles_per_row) * tr, c0 = (ti % tiles_per_row) * tw;
  const int co0 = blockIdx.y * BMW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* xb = static_cast<const bf16*>(p.x) + (size_t)b * p.c_in * p.hw;
  const bf16* wt = static_cast<const bf16*>(p.wt);
  const float* ab = FUSED ? p.a + (size_t)b * p.c_in : nullptr;
  const float* bb = FUSED ? p.b + (size_t)b * p.c_in : nullptr;

  // the slab pixel this thread stages (npos <= 108 <= NT): its offset in
  // a channel plane (-1 in the padding) and in the slab
  const int pos = threadIdx.x;
  const int rr = pos / sw, cc = pos - rr * sw;
  const int ih = h0 - 1 + rr, iw = c0 - 1 + cc;
  const bool staging = pos < npos;
  const int goff = staging && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w
                       ? ih * p.w + iw : -1;
  const int soff = pos * SPIX;
  // this lane's ldmatrix row in the slab for its pixel of each 16-pixel
  // group, at tap (0, 0); tap (dh, dw) adds (dh * sw + dw) * SPIX
  int brow[4];
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    const int n = np * 16 + (lane & 7) + (lane >> 4) * 8;
    const int r = n / tw, c = n - r * tw;
    brow[np] = (r * sw + c) * SPIX + ((lane >> 3) & 1) * 8;
  }

  float acc[8][4];
  zero(acc);
  for (int ci0 = 0; ci0 < p.c_in; ci0 += CI) {
    __syncthreads();
    // weights: BMW rows x 9 taps x 16 channels, two 16-byte loads per tap
    for (int idx = threadIdx.x; idx < BMW * 18; idx += NT) {
      const int r = idx / 18, q = idx - r * 18;
      const int co = co0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < p.c_out)
        v = *reinterpret_cast<const uint4*>(wt + ((size_t)co * 9 + (q >> 1)) * p.c_in + ci0 +
                                            (q & 1) * 8);
      *reinterpret_cast<uint4*>(sA + r * SLDA + q * 8) = v;
    }
    // the input slab, eight channels per 16-byte store
    if (staging) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ci = ci0 + half * 8 + e;
          v[e] = 0.f;
          if (goff >= 0) {
            v[e] = to_f32(xb[(size_t)ci * p.hw + goff]);
            if (FUSED) {  // rounded to bf16 next, so the fast exp and divide do
              const float u = v[e] * ab[ci] + bb[ci];
              v[e] = __fdividef(u, 1.f + __expf(-u));
            }
          }
        }
        const uint4 u = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                                   pack(v[6], v[7]));
        *reinterpret_cast<uint4*>(sX + soff + half * 8) = u;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * sw + tap % 3) * SPIX;
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3], sA + (warp * 16 + (lane & 15)) * SLDA + tap * CI +
                                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, sX + brow[np] + shift);
        mma16816(acc[2 * np], a, b0, b1);
        mma16816(acc[2 * np + 1], a, b2, b3);
      }
    }
  }

  // epilogue: C rows are channels, columns pixels; the two neighbours of
  // a lane lie in one image row (TW % 8 == 0)
  const int g = lane >> 2, t = lane & 3;
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int co = co0 + warp * 16 + g + 8 * h2;
    if (co >= p.c_out) continue;
    const float bv = p.bias ? p.bias[co] : 0.f;
    const size_t row = ((size_t)b * p.c_out + co) * p.hw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j * 8 + 2 * t;
      const int r = n / tw, c = n - r * tw;
      if (h0 + r >= p.h) continue;
      const size_t px = (size_t)(h0 + r) * p.w + c0 + c;
      float v0 = acc[j][2 * h2] + bv, v1 = acc[j][2 * h2 + 1] + bv;
      if (RES) {
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + row + px);
        v0 += __bfloat162float(r2.x);
        v1 += __bfloat162float(r2.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(y + row + px) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The staged kernel's tile width for a W x C_in input, or 0 where it does
// not apply.
inline int staged_tile_width(int c_in, int w) {
  if (c_in % CI) return 0;
  return w % 16 == 0 ? 16 : (w % 8 == 0 ? 8 : 0);
}

template <bool FUSED, bool RES, int WARPS>
inline void launch_staged(Params q, int batch, cudaStream_t st) {
  q.p_tiles = ((q.h + 64 / q.tw - 1) / (64 / q.tw)) * (q.w / q.tw);
  const dim3 grid(batch * q.p_tiles, (q.c_out + WARPS * 16 - 1) / (WARPS * 16));
  conv3x3_staged_kernel<FUSED, RES, WARPS>
      <<<grid, WARPS * 32, staged_smem(WARPS, q.tw), st>>>(q);
}

// ----------------------------------------------------------------- float32

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int FLD = FBM + 4;

template <bool FUSED, bool RES>
__global__ void __launch_bounds__(kFThreads) conv3x3_f32_kernel(const Params p) {
  __shared__ __align__(16) float sA[FBK * FLD];  // weights, transposed: [k][co]
  __shared__ __align__(16) float sB[FBK * FLD];  // patches: [k][pixel]

  const int b = blockIdx.x / p.p_tiles;
  const int p0 = (blockIdx.x % p.p_tiles) * FBN;
  const int co0 = blockIdx.y * FBM;
  const float* xb = static_cast<const float*>(p.x) + (size_t)b * p.c_in * p.hw;
  const float* wt = static_cast<const float*>(p.wt);
  const float* ab = FUSED ? p.a + (size_t)b * p.c_in : nullptr;
  const float* bb = FUSED ? p.b + (size_t)b * p.c_in : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int n = threadIdx.x % FBN;
  const int pix = p0 + n;
  const bool pvalid = pix < p.hw;
  const int ph = pvalid ? pix / p.w : 0;
  const int pw = pvalid ? pix - ph * p.w : 0;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.k; k0 += FBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < FBM * FBK; idx += kFThreads) {
      const int r = idx / FBK, kc = idx % FBK;
      const int co = co0 + r, kk = k0 + kc;
      sA[kc * FLD + r] = (co < p.c_out && kk < p.k) ? wt[(size_t)co * p.k + kk] : 0.f;
    }
    for (int kr = threadIdx.x / FBN; kr < FBK; kr += kFThreads / FBN)
      sB[kr * FLD + n] = patch_value<float, FUSED>(xb, ab, bb, p, k0 + kr, ph, pw, pvalid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(sA + kk * FLD + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(sB + kk * FLD + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  const float* res = static_cast<const float*>(p.res);
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= p.c_out) continue;
    const float bv = p.bias ? p.bias[co] : 0.f;
    const size_t row = ((size_t)b * p.c_out + co) * p.hw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int px = p0 + tx * 4 + j;
      if (px >= p.hw) continue;
      float v = acc[i][j] + bv;
      if (RES) v += res[row + px];
      y[row + px] = v;
    }
  }
}

// Launch the kernel for the dtype and the fused / residual variant.
template <bool FUSED, bool RES>
inline int launch(const Params& p, int batch, int is_bf16, cudaStream_t st) {
  const int tw = staged_tile_width(p.c_in, p.w);
  if (is_bf16 && tw) {
    // 64, 96 or 128 output channels a block: the largest that divides C_out
    Params q = p;
    q.tw = tw;
    if (p.c_out % 128 == 0)
      launch_staged<FUSED, RES, 8>(q, batch, st);
    else if (p.c_out % 96 == 0)
      launch_staged<FUSED, RES, 6>(q, batch, st);
    else
      launch_staged<FUSED, RES, 4>(q, batch, st);
  } else if (is_bf16) {
    const dim3 grid(batch * ((p.hw + BN - 1) / BN), (p.c_out + BM - 1) / BM);
    Params q = p;
    q.p_tiles = (p.hw + BN - 1) / BN;
    conv3x3_bf16_kernel<FUSED, RES><<<grid, kThreads, 0, st>>>(q);
  } else {
    const dim3 grid(batch * ((p.hw + FBN - 1) / FBN), (p.c_out + FBM - 1) / FBM);
    Params q = p;
    q.p_tiles = (p.hw + FBN - 1) / FBN;
    conv3x3_f32_kernel<FUSED, RES><<<grid, kFThreads, 0, st>>>(q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv
}  // namespace adt
