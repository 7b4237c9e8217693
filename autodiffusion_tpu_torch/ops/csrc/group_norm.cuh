// Pieces shared by the GroupNorm forward (group_norm_fwd.cu) and backward
// (group_norm_bwd.cu): 16-byte access to a (sample, group) run of
// float32 or bfloat16 elements, whose start need not be 16-byte aligned.
#pragma once

#include "elementwise.cuh"

#include <stdint.h>

namespace adt {
namespace gn {

// 16 bytes of T as floats, and back
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float (&f)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
  }
  __device__ __forceinline__ static void store(T* p, const float (&f)[N]) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The split of elements [lo, hi) of an array at p into a scalar head up to
// the first 16-byte boundary, whole 16-byte vectors, and a scalar tail.
template <typename T>
struct Split {
  int head_end, vec_end;  // [lo, head_end) head, [head_end, vec_end) vectors
  __device__ __forceinline__ Split(const T* p, int lo, int hi) {
    constexpr int N = Vec<T>::N;
    const int mis = (int)((reinterpret_cast<uintptr_t>(p + lo) / sizeof(T)) % N);
    head_end = min(hi, lo + (N - mis) % N);
    vec_end = head_end + (hi - head_end) / N * N;
  }
};

}  // namespace gn
}  // namespace adt
