// Element access and reductions shared by the GroupNorm and convolution
// kernels: float32 or bfloat16 storage, float32 arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x * sigmoid(x), and its derivative sigmoid(x) (1 + x (1 - sigmoid(x)))
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of `v[i]` over all threads of the block, returned to every thread.
// `scratch` holds N * 32 floats; the block has at most 1024 threads.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = lane < warps ? scratch[i * 32 + lane] : 0.f;
    v[i] = warp_sum(s);
  }
}

}  // namespace adt
