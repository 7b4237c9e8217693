// CUDA-core pieces of the float32 flash-attention kernels (forward, dQ,
// dK/dV). The bfloat16 kernels use the tensor cores instead (flash_mma.cuh);
// a float32 product on the tensor cores would round its operands to TF32.
//
// Layout: q, o, do are [N, T, D] and k, v are [N, S, D], contiguous, with
// N = batch * heads. lse and delta are [N, T] float32.
//
// Work split: a block of kThreads threads owns BM rows (query rows in the
// forward and dQ kernels, key rows in the dK/dV kernel). Each row is shared
// by TPR neighbouring lanes of one warp (a power of two), and each lane owns
// NC float4 chunks of the D features, interleaved (lane g of a row owns
// chunks g, g + TPR, g + 2 TPR, ...) so that the lanes of a row read
// contiguous bytes of shared memory at a time. NC is 4 (16 features a lane,
// TPR = D / 16) where that gives a power of two, else 5 (D = 40: TPR 2;
// D = 80: TPR 4). A dot product over D is 4 NC fused multiply-adds per lane
// plus log2(TPR) xor shuffles. The other operand streams through shared
// memory in tiles of at most kTileFloats floats.
//
// Numerics follow the TPU kernels (autodiffusion_tpu/ops/flash_attention.py):
// float32 products summed in float32, the 1/sqrt(D) scale applied to the
// logits after the dot, padded keys masked with -1e30.
#pragma once

#include <cuda_runtime.h>

namespace adt {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;   // one staged tile: at most 16 KB of float32
constexpr int kChunk = 16;          // keys (or queries) per softmax chunk
constexpr float kNegInf = -1e30f;

constexpr bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <int D>
struct Geometry {
  static constexpr int C4 = D / 4;                            // float4 chunks per row
  static constexpr int NC = (C4 % 4 == 0 && is_pow2(C4 / 4)) ? 4 : 5;  // chunks per lane
  static constexpr int TPR = C4 / NC;                         // lanes per row
  static_assert(D % 4 == 0 && C4 % NC == 0 && is_pow2(TPR) && TPR <= 32,
                "no CUDA-core row split for this head dim");
  static constexpr int BM = kThreads / TPR;                   // rows per block
  // rows per staged tile, a multiple of the softmax chunk CH
  static constexpr int CH = kTileFloats / D < kChunk ? kTileFloats / D : kChunk;
  static constexpr int BN = kTileFloats / D / CH * CH;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ void scale4(float a, float4& y) {
  y.x *= a;
  y.y *= a;
  y.z *= a;
  y.w *= a;
}

// Sum over the TPR lanes that share a row (they are neighbours in a warp).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums over the TPR lanes of a row for two values at once.
template <int TPR>
__device__ __forceinline__ void row_sum2(float& x, float& y) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
}

// Stage rows [r0, r0 + BN) of a [rows, D] matrix whose rows lie `ld`
// floats apart into shared memory as float32, zero-filling rows at or past
// `rows`.
template <int D>
__device__ __forceinline__ void stage_tile(float4* dst, const float* src, int r0, int rows,
                                           int ld = D) {
  using G = Geometry<D>;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < G::BN * G::C4; idx += kThreads) {
    const int r = r0 + idx / G::C4;
    const int c = idx % G::C4;
    dst[idx] = r < rows ? *reinterpret_cast<const float4*>(src + (size_t)r * ld + c * 4) : zero4();
  }
}

template <int D>
__device__ __forceinline__ void load_row(float4 (&dst)[Geometry<D>::NC], const float* row_ptr,
                                         bool valid, int lane_g) {
  using G = Geometry<D>;
#pragma unroll
  for (int c = 0; c < G::NC; ++c)
    dst[c] = valid ? *reinterpret_cast<const float4*>(row_ptr + (lane_g + c * G::TPR) * 4) : zero4();
}

template <int D>
__device__ __forceinline__ void store_row(float* row_ptr, const float4 (&src)[Geometry<D>::NC],
                                          float mul, int lane_g) {
  using G = Geometry<D>;
#pragma unroll
  for (int c = 0; c < G::NC; ++c) {
    float4 v = src[c];
    scale4(mul, v);
    *reinterpret_cast<float4*>(row_ptr + (lane_g + c * G::TPR) * 4) = v;
  }
}

// A lane's four float4 chunks of shared-memory row `srow`.
template <int D>
__device__ __forceinline__ void load_srow(float4 (&dst)[Geometry<D>::NC], const float4* srow,
                                          int lane_g) {
  using G = Geometry<D>;
#pragma unroll
  for (int c = 0; c < G::NC; ++c) dst[c] = srow[lane_g + c * G::TPR];
}

// Partial dot of a lane's 16 features with shared-memory row `srow`.
template <int D>
__device__ __forceinline__ float lane_dot(const float4 (&a)[Geometry<D>::NC],
                                          const float4* srow, int lane_g) {
  using G = Geometry<D>;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < G::NC; ++c) acc = dot4(a[c], srow[lane_g + c * G::TPR], acc);
  return acc;
}

template <int D>
__device__ __forceinline__ void lane_axpy(float a, const float4* srow,
                                          float4 (&y)[Geometry<D>::NC], int lane_g) {
  using G = Geometry<D>;
#pragma unroll
  for (int c = 0; c < G::NC; ++c) axpy4(a, srow[lane_g + c * G::TPR], y[c]);
}

}  // namespace adt
