// Pieces shared by the GroupNorm forward (group_norm_fwd.cu) and backward
// (group_norm_bwd.cu): 16-byte access to float32 or bfloat16 elements, and
// the two layouts the kernels read.
//
//   NCHW: x [B, C, HW], each (sample, group) one contiguous run of (C / G)
//     HW elements, whose start need not be 16-byte aligned (Split).
//   NHWC: x [B, HW, C] (a channels-last tensor), each (sample, group) HW
//     chunks of C / G channels, C apart: 6 channels (12 bytes in bf16) at
//     ADM-64's top level, too short for one run a block to coalesce. A
//     block takes one sample, a slice of its pixels and a tile of whole
//     groups and whole 16-byte vectors (Tile, plan_tile); each thread a
//     column of the tile, one vector a pixel, and keeps the sums of each
//     channel of its vector; column_sums() reduces those over the block in
//     a fixed order. The slices of a tile meet in one block, in a thread
//     block cluster (distributed shared memory) or through partial sums in
//     device memory, as each kernel's note says.
#pragma once

#include "elementwise.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace adt {
namespace gn {

enum Layout : int { kNchw = 0, kNhwc = 1 };

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

// ------------------------------------------------------------------ NHWC

// the least elements a block's slice aims at, where the pixels allow
constexpr int kMinSliceElems = 8192;

// How an NHWC call is cut: blocks = B x tiles x k, block (b, t, s) owns
// sample b, channels [t ct, (t + 1) ct) and pixels [s slice, (s + 1)
// slice); thread (row, col) < (rows, ct / V) the vector of channels
// col V.. at pixels row, row + rows, ... of the slice, in whole warps
// (threads past rows x cols only add zeros to the block's sums).
struct Tile {
  int ct, tiles, slice, k, rows;
  __host__ __device__ int cols(int v) const { return ct / v; }
  __host__ __device__ int threads(int v) const { return (rows * cols(v) + 31) / 32 * 32; }
};

inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The least tile width (a multiple of `unit` channels that divides c, at
// most max_ct) of at least `bytes` bytes a pixel and `min_elems` elements
// over hw pixels, else the widest there is (0 if none).
inline int tile_width(int c, int unit, int elem, int bytes, long long min_elems, int hw,
                      int max_ct) {
  int widest = 0;
  for (int ct = unit; ct <= c && ct <= max_ct; ct += unit) {
    if (c % ct) continue;
    widest = ct;
    if (ct * elem >= bytes && (long long)hw * ct >= min_elems) return ct;
  }
  return widest;
}

// The plan of an NHWC call of c channels in groups of cpg at hw pixels,
// elements of `elem` bytes, vectors of v elements, blocks of at most
// `threads` threads (at most 32 columns of vectors), a tile's slices in
// one block (max_cluster 1) or a cluster of up to max_cluster blocks.
// Resident where `resident_bytes` of shared memory an element over a tile
// of at least 64 bytes a pixel (32 in a cluster) fits that many blocks of
// `budget` bytes each; else streamed: tiles of at least 512 bytes a pixel
// (or the widest), slices of `stream_elems` elements (in a cluster, as
// many as it takes to cover the pixels). Returns false where a tile would
// take more than 32 columns (lcm(cpg, v) > 32 v).
inline bool plan_tile(int c, int cpg, int hw, int elem, int v, int threads, int resident_bytes,
                      int budget, int max_cluster, int stream_elems, Tile& p, bool& resident) {
  const int unit = cpg / gcd_int(cpg, v) * v, max_ct = 32 * v;
  if (c % unit || unit > max_ct) return false;
  resident = false;
  for (int bytes = 64; bytes >= (max_cluster > 1 ? 32 : 64); bytes /= 2) {
    const int ct =
        tile_width(c, unit, elem, bytes, bytes == 64 ? kMinSliceElems : 0, hw, max_ct);
    const long long need = (long long)hw * ct * resident_bytes;
    const int k = (int)((need + budget - 1) / budget);
    if (k <= max_cluster) {
      p.ct = ct;
      p.slice = (hw + k - 1) / k;
      resident = true;
      break;
    }
  }
  if (!resident) {
    p.ct = tile_width(c, unit, elem, 512, 0, hw, max_ct);
    int slice = stream_elems / p.ct > 32 ? stream_elems / p.ct : 32;
    if (max_cluster > 1) {
      const int least = (hw + max_cluster - 1) / max_cluster;
      slice = slice > least ? slice : least;
    }
    p.slice = slice < hw ? slice : hw;
  }
  p.tiles = c / p.ct;
  p.k = (hw + p.slice - 1) / p.slice;
  const int rows = threads / (p.ct / v);
  p.rows = rows < p.slice ? rows : p.slice;
  return true;
}

// The cluster's barrier in two halves: arrive (releasing this thread's
// writes to shared memory), then wait (acquiring the others'); every
// thread of every block of the cluster takes both, warp by warp.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A block's place in an NHWC call (blockIdx.x = (b tiles + t) k + s: the
// k slices of a tile are consecutive blocks, one cluster where resident):
// its slice [p0, p1), and the thread's column and first pixel (p1 for a
// thread past the tile's rows).
struct Place {
  int b, t, s, p0, p1, col, first;
  __device__ __forceinline__ Place(int hw, const Tile& tp, int v) {
    s = blockIdx.x % tp.k;
    const int bt = blockIdx.x / tp.k;
    t = bt % tp.tiles;
    b = bt / tp.tiles;
    p0 = s * tp.slice;
    p1 = min(hw, p0 + tp.slice);
    const int cols = tp.cols(v), row = threadIdx.x / cols;
    col = threadIdx.x % cols;
    first = row < tp.rows ? p0 + row : p1;
  }
};

// Sums over the block of each thread's M x V values, per channel of the
// tile (channel col V + e of value s[m][e]), into out[m ct + ch], in a
// fixed order: in each warp lane l < cols adds lanes l + cols, l + 2 cols,
// ... (the lanes of its column), then each channel adds the warps in
// order. `wred` holds warps x cols x M x V floats. Ends with the block
// synchronised.
template <int M, int V>
__device__ __forceinline__ void column_sums(const float (&s)[M][V], int cols, float* wred,
                                            float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float acc = s[m][e];
      for (int o = cols; o < 32; o += cols) {
        const float w = __shfl_sync(0xffffffffu, s[m][e], (lane + o) & 31);
        if (lane + o < 32) acc += w;
      }
      if (lane < cols) wred[((warp * cols + lane) * M + m) * V + e] = acc;
    }
  __syncthreads();
  const int ct = cols * V;
  for (int i = threadIdx.x; i < M * ct; i += blockDim.x) {
    const int m = i / ct, ch = i - m * ct, col = ch / V, e = ch - col * V;
    float acc = 0.f;
    for (int w = 0; w < warps; ++w) {
      const int l = ((col - 32 * w) % cols + cols) % cols;  // warp w's lane of column col
      acc += wred[((w * cols + l) * M + m) * V + e];
    }
    out[i] = acc;
  }
  __syncthreads();
}

// Launch `kernel` as clusters of k consecutive blocks.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                            int k, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace gn
}  // namespace adt
