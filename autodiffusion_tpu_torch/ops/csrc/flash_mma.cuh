// Tensor-core pieces of the bfloat16 flash-attention kernels (sm_80+ mma.sync,
// built for sm_90a).
//
// Work split: a block of four warps owns 64 rows of the resident operand
// (query rows in the forward and dQ kernels, key rows in the dK/dV kernel),
// 16 per warp, held in registers as mma A fragments for the whole kernel.
// The streamed operand passes through shared memory in tiles of 64 (or 32)
// rows, stored bfloat16 with each row padded by 8 elements so that the
// ldmatrix reads of eight rows fall in distinct banks. Every product is
// mma.sync.m16n8k16 with bfloat16 operands and float32 accumulators: the
// input-dtype dot summed in float32, as in the TPU kernels.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B 16x8:  b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// Two neighbouring C tiles of one row block are, once rounded to bfloat16,
// exactly the A fragment of the next product (p -> P V, dS -> dS K).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace adt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // resident rows per block

template <int D>
struct Geom {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be 16, 32, 64 or 128");
  static constexpr int LD = D + 8;    // padded shared-memory row, elements
  static constexpr int KS = D / 16;   // k-steps over the head dim
  static constexpr int NT = D / 8;    // 8-wide output tiles over the head dim
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// c += a b for one 16x8x16 tile
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// A fragments of rows [r0, r0 + 16) of a [len, D] matrix in device memory,
// zero past `len`. Read once per kernel, so straight from device memory.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Geom<D>::KS][4], const bf16* m, int r0,
                                       int len, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    const bf16* row = m + (size_t)(r < len ? r : 0) * D;
#pragma unroll
    for (int kk = 0; kk < Geom<D>::KS; ++kk) {
      uint32_t lo = 0, hi = 0;
      if (r < len) {
        lo = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 2 * t);
        hi = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8 + 2 * t);
      }
      a[kk][h] = lo;
      a[kk][2 + h] = hi;
    }
  }
}

// Rows [r0, r0 + ROWS) of a [len, D] matrix into a padded shared tile,
// zero past `len`, 16 bytes per load.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* m, int r0, int len) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len) v = *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(s + r * Geom<D>::LD + c * 8) = v;
  }
}

// c[j] += a x^T for the 16 resident rows against the ROWS rows of a shared
// tile x ([ROWS, D], row j of x -> column j of c): the logits q k^T (or
// k q^T, dO v^T, v dO^T).
template <int D, int ROWS>
__device__ __forceinline__ void mma_abt(float (&c)[ROWS / 8][4], const uint32_t (&a)[Geom<D>::KS][4],
                                        const bf16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < Geom<D>::KS; ++kk) {
#pragma unroll
    for (int np = 0; np < ROWS / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * Geom<D>::LD + kk * 16 +
                  ((lane >> 3) & 1) * 8);
      mma16816(c[2 * np], a[kk], b0, b1);
      mma16816(c[2 * np + 1], a[kk], b2, b3);
    }
  }
}

// acc += p x for the probabilities (or dS) p [16, ROWS], given as float32 C
// tiles and rounded to bfloat16 here, against a shared tile x [ROWS, D].
template <int D, int ROWS>
__device__ __forceinline__ void mma_px(float (&acc)[Geom<D>::NT][4], const float (&p)[ROWS / 8][4],
                                       const bf16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    const uint32_t a[4] = {pack(p[2 * kk][0], p[2 * kk][1]), pack(p[2 * kk][2], p[2 * kk][3]),
                           pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < Geom<D>::NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, s + (kk * 16 + (lane & 15)) * Geom<D>::LD + np * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * np], a, b0, b1);
      mma16816(acc[2 * np + 1], a, b2, b3);
    }
  }
}

// Store the warp's 16 x D accumulator rows (times `mul[h]` for row half h)
// as bfloat16, rows at or past `len` skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* m, const float (&acc)[Geom<D>::NT][4], int r0,
                                           int len, const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= len) continue;
#pragma unroll
    for (int n = 0; n < Geom<D>::NT; ++n)
      *reinterpret_cast<uint32_t*>(m + (size_t)r * D + n * 8 + 2 * t) =
          pack(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// Reductions over the four lanes (one quad) that share a C row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace adt

// Dispatch a launcher templated on the head dim. Returns -1 for a head dim
// without an instantiation; the Python wrapper checks first.
#define ADT_DISPATCH_D(head_dim, LAUNCH) \
  do {                                   \
    switch (head_dim) {                  \
      case 16: LAUNCH(16); break;        \
      case 32: LAUNCH(32); break;        \
      case 64: LAUNCH(64); break;        \
      case 128: LAUNCH(128); break;      \
      default: return -1;                \
    }                                    \
  } while (0)
