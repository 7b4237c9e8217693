// 3x3 stride-1 SAME convolution as an implicit GEMM, for Hopper (sm_90a).
// Shared by conv3x3.cu (the plain conv + bias) and conv3x3_fused.cu (the
// norm-act-conv: silu(x a + b) applied to the input as it is staged, and a
// residual added in the epilogue).
//
// Replaces the TPU kernels autodiffusion_tpu/ops/conv_im2col.py::_conv_kernel
// and ::_fused_conv_kernel. The TPU builds a [tile_h * W, 9 C_in] patch
// matrix in VMEM per row tile and runs one MXU dot against [9 C_in, C_out].
// Here the product is written transposed, out^T = W [C_out, 9 C_in] x
// patches^T [9 C_in, H W], because the port is NCHW: output rows are
// channels and columns pixels, so the epilogue stores neighbouring pixels
// of one channel, NCHW again with no transpose. K = 9 C_in is ordered
// (chunk of 16 input channels, tap, channel): the wrapper hands the weights
// as [C_out, 3, 3, C_in]. The patch matrix never exists in device memory.
//
// Bound on this card: operations. Every bf16 site of ADM-64, the SD UNet
// and the VAE decoder does 2 B H W C_out 9 C_in operations against a few
// bytes per output (the ADM 1536 -> 768 8x8 conv at batch 32: 44 us of
// tensor-core time, 17 us of bytes). What kept the earlier kernel (one
// 16-channel chunk in flight, synchronous loads, a 64-pixel tile,
// mma.sync) at 2-13 % of that bound was the weight traffic (each 64 pixels
// re-read the block's whole weight slice), loads that nothing overlapped,
// and grids of under two waves with long K at the 8x8 and 16x16 levels.
//
// bfloat16, the implicit-GEMM kernel (C_in % 16 == 0 and W % 8 == 0,
// which every bf16 site of both searches meets). The launch plan (wgmma
// width, tile, stages, splits) is chosen in Python from the shape alone
// (ops/conv_im2col.py::conv_plan, which the CPU tests check) and passed in:
//   * tile: 128 output channels (M; the last tile masked where C_out %
//     128 != 0) by two sub-tiles of pixels (N). A sub-tile is `rows` rows
//     of TW = min(W, 64) columns, read from the slab: the tile's rows plus
//     a one-pixel halo, channels innermost, with a row stride of TW + 2,
//     so that N = 80 or 136 slab pixels starting at the tap's shift
//     (dh (TW + 2) + dw) are exactly the sub-tile's inputs for that tap.
//     The two halo columns of each row are computed and thrown away (20 %
//     extra at W = 8, 3-6 % at W >= 32). Where a whole 8 x 8 image fits a
//     sub-tile, a block takes two images. Each weight byte fetched serves
//     160-272 slab pixels (64 in the earlier kernel).
//   * product: wgmma m64nNk16, A (weights, [k half][tap][co][8]) and B (the
//     slab, [k half][pixel][8]) both K-major in shared memory without a
//     swizzle, so the nine taps are nine descriptors into one slab, 16
//     bytes apart per pixel of shift, and no tap is ever copied.
//   * warp specialisation: two consumer warpgroups (64 output channels
//     each) issue only wgmma and run the epilogue; a producer warpgroup
//     loads and transforms, and gives up registers to them (setmaxnreg).
//     Named barriers hand each slab buffer over and back.
//   * loads: a ring of 2-4 shared-memory stages, each a 16-channel chunk's
//     weight tile (one contiguous bulk copy of the wrapper's tiled weights
//     [C_out / 128][C_in / 16][2][9][128][8]: a TMA box 16 bytes wide moved
//     the same bytes at a fraction of the rate) and its raw NCHW input rows
//     (TMA boxes over [B C_in][H][W], whose zero fill outside the tensor is
//     the SAME padding; a box starts 16-byte aligned), completing on an
//     mbarrier. Chunk k + stages - 1 is in flight while chunk k multiplies.
//   * transform: one pass per element per block turns the raw stage into
//     the channels-innermost slab the wgmma reads (in the fused kernel
//     through silu(x a + b) in float32, rounded to bf16; outside the image
//     zero). The producer transforms chunk k + 1 into the second of two
//     slab buffers while the consumers multiply chunk k.
//   * split K: where the output tiles cannot fill the 132 SMs, blockIdx.z
//     takes a run of whole chunks and writes float32 partial sums to a
//     workspace the wrapper allocates; a second pass adds the splits in a
//     fixed order, the bias and the residual, and casts.
// What bounds it now: shared-memory bandwidth (each wgmma reads its 64 x
// 16 weight slice and the N x 16 slab slice; the two consumers read the
// same slab) and the L2 traffic of the weight tiles, against which the
// producer's transform competes; PERF.md has the per-site shares.
// The earlier gather kernel stays for bf16 shapes the implicit GEMM does
// not take; float32 runs on the CUDA cores (4 x 4 outputs per thread, the
// patch slice gathered), since the tensor cores would round float32
// operands to TF32. All add the bias (and the residual) to the float32
// accumulator and cast once.
#pragma once

#include <cuda.h>

#include "elementwise.cuh"
#include "flash_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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
  float* ws;          // split K: [splits, B, C_out, H, W] float32 partial sums
  int c_in, h, w, c_out, hw, k, p_tiles;
  // implicit-GEMM plan: tile columns and rows of a sub-tile, ring stages,
  // K splits and the chunks each takes, tiles per image row band
  int tw, rows, stages, splits, chunks_per_split, tiles_w;
  // implicit GEMM: batch, and whether a block packs whole images
  int batch, packed;
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


// ------------------------------------------- bfloat16, implicit GEMM (wgmma)

constexpr int CI = 16;            // input channels per chunk: one k16 step per tap
constexpr int NS = 2;             // pixel sub-tiles a block, one wgmma each per tap
constexpr int kBM = 128;          // output channels a block: two consumer warpgroups
constexpr int kSmemMax = 232448;  // 227 KB, the most a block may take

// The block's slab: `raw_rows` rows of TW + 2 pixels, channels innermost.
// Slab row i is input row h0 - 1 + i of sample b0 (one TMA box of
// 2 rows + 2 rows), or, where a block packs two whole images (`packed`, H == rows),
// row i % (H + 2) - 1 of sample b0 + i / (H + 2) (one box of H + 2 rows
// each). Sub-tile s starts at slab row s * sub_rows. Shared memory, in
// bytes (the same formulas as ops/conv_im2col.py::igemm_smem): per stage
// the weight tile [2][9][128][8] (k half, tap, output channel, 8 input
// channels), the raw boxes [boxes][16][box_rows][raw_w] (columns c0 - 8
// .. c0 + TW + 7, since a TMA box starts 16-byte aligned, or 0 .. W - 1
// where the tile is whole rows, whose halo columns are padding) and the
// chunk's a, b ([2][2][16] float32); then two slab buffers [2][npix][8]
// and one mbarrier a stage.
struct Geometry {
  int sw, raw_w, col_off, boxes, box_rows, raw_rows, sub_rows, npix;
  int w_bytes, raw_bytes, stage_bytes, op_bytes;
  __host__ __device__ Geometry(int nt, int tw, int rows, int packed, int w) {
    sw = tw + 2;
    raw_w = tw == w ? tw : tw + 16;
    col_off = tw == w ? -1 : 7;
    boxes = packed ? NS : 1;
    box_rows = packed ? rows + 2 : NS * rows + 2;
    raw_rows = boxes * box_rows;
    sub_rows = packed ? rows + 2 : rows;
    const int need = (NS - 1) * sub_rows * sw + 2 * sw + 2 + nt;
    npix = ((raw_rows * sw > need ? raw_rows * sw : need) + 7) / 8 * 8;
    w_bytes = kBM * 9 * CI * 2;
    raw_bytes = CI * raw_rows * raw_w * 2;
    stage_bytes = w_bytes + raw_bytes + NS * 2 * CI * 4;
    op_bytes = 2 * npix * 8 * 2;
  }
  __host__ __device__ size_t smem(int stages) const {
    return (size_t)stages * (stage_bytes + 8) + 2 * (size_t)op_bytes;
  }
};

// Where a block sits: sample b0 and row h0 (the first slab row's image row
// + 1), column c0, and how many samples there are.
struct Tile {
  int b0, h0, c0, batch;
  // (sample, input row) of slab row i; false where it lies outside
  __device__ __forceinline__ bool slab_row(const Params& p, int i, int& bi, int& ih) const {
    if (p.packed) {
      bi = b0 + i / (p.rows + 2);
      ih = i % (p.rows + 2) - 1;
    } else {
      bi = b0;
      ih = h0 - 1 + i;
    }
    return bi < batch && ih >= 0 && ih < p.h;
  }
};

// Named barriers between the producer warpgroup and the two consumers:
// kFull + i (slab buffer i holds the next chunk), kEmpty + i (the
// consumers are done with the chunk of parity i), kProducer (the
// producer's threads all see a chunk). Barrier 0 is __syncthreads'.
constexpr int kThreadsWS = 3 * 128;
constexpr int kFull = 1, kEmpty = 3, kProducer = 5;

// The copies of chunk `kc` into one stage, completing on `bar`: the weight
// tile, one contiguous bulk copy of the wrapper's tiled weights
// [C_out / 128][C_in / 16][2][9][128][8], and the raw input boxes (TMA over
// the input seen as [B C_in][H][W], everything outside zero: the SAME
// padding).
__device__ __forceinline__ void issue_chunk(const Params& p, const Geometry& g, const Tile& t,
                                            const CUtensorMap* xmap,
                                            unsigned char* stage, uint64_t* bar, int co0, int kc) {
  mbar_expect_tx(bar, g.w_bytes + g.raw_bytes);
  const size_t tile = ((size_t)(co0 / kBM) * (p.c_in / CI) + kc) * (g.w_bytes / 2);
  bulk_load(stage, static_cast<const bf16*>(p.wt) + tile, g.w_bytes, bar);
  const int box = CI * g.box_rows * g.raw_w * 2;
  for (int s = 0; s < g.boxes; ++s)
    tma_load_3d(stage + g.w_bytes + s * box, xmap, g.col_off < 0 ? 0 : t.c0 - 8,
                p.packed ? -1 : t.h0 - 1,
                (t.b0 + s) * p.c_in + kc * CI, bar);
}

// silu(z) = z sigmoid(z) = h (1 + tanh(h)), h = z / 2: one MUFU operation
// (tanh.approx, relative error about 2^-11) where exp and a divide take two;
// the result is rounded to bf16 next.
__device__ __forceinline__ float silu_fast(float z) {
  const float h = 0.5f * z;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// A raw stage into the slab [k half][npix][8]: slab pixel (i, c) is input
// (slab row i, column c0 - 1 + c), zero outside the image; in the fused
// kernel through silu(x a + b) in float32 first. The slab's pixels past its
// rows feed only dropped outputs and are not written. (Units of two pixels
// with paired loads measured slower: their 16-byte stores conflict.)
template <bool FUSED>
__device__ __forceinline__ void transform(const Params& p, const Geometry& g, const Tile& t,
                                          const unsigned char* stage, bf16* op, int lt) {
  const bf16* sR = reinterpret_cast<const bf16*>(stage + g.w_bytes);
  const float* sAB = reinterpret_cast<const float*>(stage + g.w_bytes + g.raw_bytes);
  const int plane = g.box_rows * g.raw_w;
  const float inv_sw = 1.f / g.sw;
  const int used = g.raw_rows * g.sw;
  for (int u = lt; u < 2 * used; u += 128) {
    const int kh = u >= used;
    const int pix = u - kh * used;
    const int i = __float2int_rz((pix + 0.5f) * inv_sw), c = pix - i * g.sw;
    const int iw = t.c0 - 1 + c;
    int bi, ih;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t.slab_row(p, i, bi, ih) && iw >= 0 && iw < p.w) {
      const int bx = p.packed ? bi - t.b0 : 0;
      const bf16* src = sR + ((bx * CI + kh * 8) * g.box_rows + i - bx * g.box_rows) * g.raw_w +
                        c + g.col_off;
      const float* ab = sAB + (bi - t.b0) * 2 * CI + kh * 8;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[e] = __bfloat162float(src[e * plane]);
        if (FUSED) f[e] = silu_fast(f[e] * ab[e] + ab[CI + e]);
      }
      v = make_uint4(adt::mma::pack(f[0], f[1]), adt::mma::pack(f[2], f[3]),
                     adt::mma::pack(f[4], f[5]), adt::mma::pack(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(op + ((size_t)kh * g.npix + pix) * 8) = v;
  }
}

// Warp-specialised: warpgroups 0 and 1 each own 64 output channels of the
// block's 128 and run only wgmma and the epilogue; warpgroup 2 (the
// producer) issues the TMA copies and runs the transform, and hands most
// of its registers to the consumers (setmaxnreg). The producer transforms
// chunk k while the consumers multiply chunk k - 1, and refills a stage
// once the consumers are done with the chunk that held it.
template <bool FUSED, bool RES, int NT>
__global__ void __launch_bounds__(kThreadsWS, 1)
    conv3x3_igemm_kernel(const Params p, const __grid_constant__ CUtensorMap xmap) {
  constexpr int NACC = NT / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g(NT, p.tw, p.rows, p.packed, p.w);
  const int img = blockIdx.x / p.p_tiles, ti = blockIdx.x - img * p.p_tiles;
  Tile t;
  t.batch = p.batch;
  t.b0 = p.packed ? img * NS : img;
  t.h0 = p.packed ? 0 : (ti / p.tiles_w) * NS * p.rows;
  t.c0 = (ti % p.tiles_w) * p.tw;
  const int co0 = blockIdx.y * kBM;
  const int kc0 = blockIdx.z * p.chunks_per_split;
  const int nk = min(p.c_in / CI, kc0 + p.chunks_per_split) - kc0;
  const int S = p.stages;
  const int wgi = threadIdx.x >> 7, lt = threadIdx.x & 127;
  auto stage = [&](int s) { return smem + (size_t)s * g.stage_bytes; };
  auto slab = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (size_t)S * g.stage_bytes + (size_t)i * g.op_bytes);
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)S * g.stage_bytes + 2 * g.op_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (lt == 0)
      for (int s = 0; s < S - 1 && s < nk; ++s)
        issue_chunk(p, g, t, &xmap, stage(s), bars + s, co0, kc0 + s);
    for (int k = 0; k < nk; ++k) {
      unsigned char* st = stage(k % S);
      if (FUSED && lt < NS * 2 * CI) {  // the chunk's a, b of each sample
        const int s = lt / (2 * CI), q = lt - s * 2 * CI;
        const int bi = t.b0 + s;
        reinterpret_cast<float*>(st + g.w_bytes + g.raw_bytes)[lt] =
            bi < t.batch ? (q < CI ? p.a : p.b)[(size_t)bi * p.c_in + (kc0 + k) * CI + (q & 15)]
                         : 0.f;
      }
      mbar_wait(bars + k % S, (k / S) & 1);
      bar_sync(kProducer, 128);
      transform<FUSED>(p, g, t, st, slab(k & 1), lt);
      adt::wg::fence_proxy_async();
      bar_arrive(kFull + (k & 1), kThreadsWS);
      // refill the stage of chunk k - 1 once the consumers are done with it
      if (k >= 1) bar_sync(kEmpty + ((k - 1) & 1), kThreadsWS);
      if (lt == 0 && k + S - 1 < nk)
        issue_chunk(p, g, t, &xmap, stage((k + S - 1) % S), bars + (k + S - 1) % S, co0,
                    kc0 + k + S - 1);
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  float acc[NS][NACC];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[s][i] = 0.f;
  const bool active = co0 + wgi * 64 < p.c_out;
  // A: [k half][tap][128][8], the warpgroup's 64 rows; B: [k half][npix][8]
  const uint32_t a_lbo = 9 * kBM * 16, b_lbo = g.npix * 16;
  for (int k = 0; k < nk; ++k) {
    bar_sync(kFull + (k & 1), kThreadsWS);
    if (active) {
      mbar_wait(bars + k % S, (k / S) & 1);  // the weights' copy, seen by this thread
      const bf16* sa = reinterpret_cast<const bf16*>(stage(k % S)) + wgi * 64 * 8;
      const bf16* sb = slab(k & 1);
#pragma unroll
      for (int s = 0; s < NS; ++s) adt::wg::fence_operands(acc[s]);
      adt::wg::fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t da = adt::wg::desc(sa + tap * kBM * 8, a_lbo, 128);
        const int shift = (tap / 3) * g.sw + tap % 3;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          adt::wg::mma<NT>(acc[s], da,
                           adt::wg::desc(sb + (s * g.sub_rows * g.sw + shift) * 8, b_lbo, 128));
      }
      adt::wg::commit();
      // chunk k - 1's products are done: its stage and slab may be reused
      adt::wg::wait_one();
#pragma unroll
      for (int s = 0; s < NS; ++s) adt::wg::fence_operands(acc[s]);
    }
    if (k >= 1) bar_arrive(kEmpty + ((k - 1) & 1), kThreadsWS);
  }
  adt::wg::wait_all();
#pragma unroll
  for (int s = 0; s < NS; ++s) adt::wg::fence_operands(acc[s]);
  if (!active) return;

  // epilogue: column n of sub-tile s is output row n / sw of the sub-tile,
  // column c0 + n % sw; the two halo columns of each slab row and the
  // columns past the tile are dropped. A lane's two neighbours lie in one
  // image row.
  const int warp = lt >> 5, lane = lt & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const bf16* res = static_cast<const bf16*>(p.res);
  bf16* y = static_cast<bf16*>(p.y);
  const bool split = p.splits > 1;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int co = co0 + wgi * 64 + warp * 16 + gq + 8 * h2;
    if (co >= p.c_out) continue;
    const float bv = (!split && p.bias) ? p.bias[co] : 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int bi = p.packed ? t.b0 + s : t.b0;
      if (bi >= t.batch) continue;
      const int oh0 = p.packed ? 0 : t.h0 + s * p.rows;
      const size_t row = ((size_t)bi * p.c_out + co) * p.hw;
      float* part = split ? p.ws + (size_t)blockIdx.z * t.batch * p.c_out * p.hw + row : nullptr;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int n = j * 8 + 2 * t4;
        const int r = n / g.sw, c = n - r * g.sw;
        const int oh = oh0 + r, ow = t.c0 + c;
        if (c >= p.tw || r >= p.rows || oh >= p.h || ow >= p.w) continue;
        const size_t px = (size_t)oh * p.w + ow;
        float v0 = acc[s][4 * j + 2 * h2] + bv, v1 = acc[s][4 * j + 2 * h2 + 1] + bv;
        if (split) {
          *reinterpret_cast<float2*>(part + px) = make_float2(v0, v1);
          continue;
        }
        if (RES) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + row + px);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + row + px) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Split K's second pass: the partial sums of the splits added in order,
// then the bias and the residual, one cast; four outputs a thread (H W % 8
// == 0).
template <bool RES>
__global__ void __launch_bounds__(256) conv3x3_split_reduce(const Params p, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(p.ws + i);
  for (int k = 1; k < p.splits; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(p.ws + (size_t)k * n + i);
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  const int co = (int)((i / p.hw) % p.c_out);
  const float bv = p.bias ? p.bias[co] : 0.f;
  float v[4] = {s.x + bv, s.y + bv, s.z + bv, s.w + bv};
  if (RES) {
    const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(p.res) + i);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
    v[0] += __bfloat162float(r2[0].x);
    v[1] += __bfloat162float(r2[0].y);
    v[2] += __bfloat162float(r2[1].x);
    v[3] += __bfloat162float(r2[1].y);
  }
  *reinterpret_cast<uint2*>(static_cast<bf16*>(p.y) + i) =
      make_uint2(adt::mma::pack(v[0], v[1]), adt::mma::pack(v[2], v[3]));
}

template <bool FUSED, bool RES, int NT>
inline int launch_igemm(Params q, int batch, cudaStream_t st) {
  const Geometry g(NT, q.tw, q.rows, q.packed, q.w);
  const size_t smem = g.smem(q.stages);
  if (smem > (size_t)kSmemMax) return -1;
  CUtensorMap xmap;
  const cuuint64_t xdims[3] = {(cuuint64_t)q.w, (cuuint64_t)q.h, (cuuint64_t)batch * q.c_in};
  const cuuint64_t xstr[2] = {(cuuint64_t)q.w * 2, (cuuint64_t)q.hw * 2};
  const cuuint32_t xbox[3] = {(cuuint32_t)g.raw_w, (cuuint32_t)g.box_rows, CI};
  if (!make_map(&xmap, q.x, 3, xdims, xstr, xbox)) return -2;
  // once per instantiation: allow dynamic shared memory above 48 KB
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv3x3_igemm_kernel<FUSED, RES, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  q.batch = batch;
  q.tiles_w = (q.w + q.tw - 1) / q.tw;
  q.p_tiles = q.packed ? 1 : ((q.h + NS * q.rows - 1) / (NS * q.rows)) * q.tiles_w;
  const int groups = q.packed ? (batch + NS - 1) / NS : batch;
  const dim3 grid(groups * q.p_tiles, (q.c_out + kBM - 1) / kBM, q.splits);
  conv3x3_igemm_kernel<FUSED, RES, NT><<<grid, kThreadsWS, smem, st>>>(q, xmap);
  if (q.splits > 1) {
    const size_t n = (size_t)batch * q.c_out * q.hw;
    const unsigned blocks = (unsigned)((n / 4 + 255) / 256);
    conv3x3_split_reduce<RES><<<blocks, 256, 0, st>>>(q, n);
  }
  return static_cast<int>(cudaGetLastError());
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

// The launch plan of a bf16 call (ops/conv_im2col.py::conv_plan): nt = 0
// for the gather kernel, else the implicit GEMM's wgmma width (80 or 136),
// a sub-tile's columns and rows, whether a block
// packs whole images, stages (2-4), splits and the chunks each split takes.
struct Plan {
  int nt, tw, rows, packed, stages, splits, chunks_per_split;
};

// Launch the kernel for the dtype, the plan and the fused / residual
// variant. Returns -1 for a plan the kernels do not take.
template <bool FUSED, bool RES>
inline int launch(const Params& p, int batch, int is_bf16, const Plan& plan, cudaStream_t st) {
  if (is_bf16 && plan.nt) {
    const int sw = plan.tw + 2;
    const int chunks = p.c_in / CI;
    if (p.c_in % CI || p.w % 8 || plan.tw % 8 || plan.tw > p.w || plan.rows < 1 ||
        plan.rows * sw > plan.nt || (plan.packed && (plan.rows != p.h || plan.tw != p.w)) ||
        plan.stages < 2 || plan.stages > 4 || plan.splits < 1 ||
        plan.chunks_per_split < 1 || (plan.splits - 1) * plan.chunks_per_split >= chunks ||
        plan.splits * plan.chunks_per_split < chunks || (plan.splits > 1 && !p.ws))
      return -1;
    Params q = p;
    q.tw = plan.tw;
    q.rows = plan.rows;
    q.packed = plan.packed;
    q.stages = plan.stages;
    q.splits = plan.splits;
    q.chunks_per_split = plan.chunks_per_split;
#define ADT_CONV_IGEMM(NT) \
  if (plan.nt == NT) return launch_igemm<FUSED, RES, NT>(q, batch, st);
    ADT_CONV_IGEMM(80)
    ADT_CONV_IGEMM(136)
#undef ADT_CONV_IGEMM
    return -1;
  }
  if (is_bf16) {
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
