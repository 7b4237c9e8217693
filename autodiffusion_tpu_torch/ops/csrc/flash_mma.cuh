// mma.sync pieces (sm_80+, built for sm_90a) and the fragment helpers
// (pack, zero, quad_max, quad_sum) the other kernels share: the
// convolution's fallback kernel (conv3x3.cuh) issues m16n8k16 products
// fed by ldmatrix, and the wgmma flash kernels (flash_wgmma.cuh,
// flash_bwd_dkv.cu, flash_bwd_dq.cu) round their accumulators to bf16
// fragments with pack.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B 16x8:  b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// Two neighbouring C tiles of one row block are, once rounded to bfloat16,
// exactly the A fragment of the next product (the same holds of a wgmma
// accumulator's columns: flash_wgmma.cuh's pack_p).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace adt {
namespace mma {

using bf16 = __nv_bfloat16;

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
