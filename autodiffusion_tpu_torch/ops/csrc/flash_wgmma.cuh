// Pieces shared by the pipelined flash kernels for Hopper (sm_90a): the
// three forwards, flash_fwd.cu (D <= 128), flash_fwd_packed.cu (D = 40 on
// the token-major layout) and flash_fwd_wide.cu (D = 512), and the two
// backwards, flash_bwd_dq.cu and flash_bwd_dkv.cu: the online softmax of
// one key tile held in a wgmma accumulator, the rounding of probabilities
// (or dS) to the bf16 register A operand of the next product, and the
// shared-memory layout of a head's features with the tensor maps that fill
// it.
//
// The kernels run two warpgroups that issue only wgmma and the softmax,
// and keep their K and V tiles in flight with TMA copies into a ring of
// shared-memory stages, each completing on a `full` mbarrier; a thread of
// the block issues the copies between its own products. There is no
// separate producer. A block of 384 threads leaves each thread at most
// 168 registers, and the wide kernel takes 172 (its m64n256 accumulator
// alone 128). A producer warpgroup that gives its registers to the two
// consumers (setmaxnreg.dec 40 / .inc 232, as conv3x3.cuh does at 72 /
// 216) still compiled to 168 registers with a 64-byte spill and ran
// slower (tools/kernel_ab.py wide_producer); so did a ping-pong of the
// packed kernel's two warpgroups on named barriers, which spilled at 128
// (tools/kernel_ab.py packed_pingpong). At 256 threads ptxas may give a
// thread 255 (the wide kernel, flash_fwd.cu at D = 128), or 128 with two
// blocks an SM (the packed kernel, flash_fwd.cu up to D = 80).
//
// A warpgroup's S tile is the m64nBN wgmma accumulator of its 64 query rows
// (wgmma.cuh: s[4 j + e] is row 16 w + g + 8 (e >> 1), key 8 j + 2 t +
// (e & 1)). The softmax works in base 2 on the raw dot products: with
// c = scale log2(e), p = 2^(s c - m c), one FFMA and one MUFU.EX2
// (ex2.approx) per logit, where the accurate expf is a multi-instruction
// routine; the row max m stays in units of the raw dot, so the lse is
// m scale + ln(l). The scale still multiplies the float32 dot after it is
// summed, as in the TPU kernel.
#pragma once

#include "flash_mma.cuh"
#include "flash_simt.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace adt {
namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 2 * 128;  // two warpgroups
constexpr int kSmemMax = 232448;   // 227 KB, the most a block may take

// 2^x by the special-function unit (relative error about 2^-22; 0 for
// x below -126, which is how the masked logits vanish)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile for the thread's two rows: keys at or
// past `valid` (the last tile's) masked when `mask`, the row max m (raw dot
// units) and the lane's share of the row sum l updated, s turned into
// 2^(s c - m c). The accumulator's factor 2^((m_old - m) c) is returned in
// alpha, for the caller to apply (see rescale) where no wgmma is in flight.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int valid, bool mask, float c,
                                               int t) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) s[i] = kNegInf;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = mma::quad_max(mx[h]);
    mc[h] = mx[h] * c;
    alpha[h] = exp2_approx(fmaf(m[h], c, -mc[h]));
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// o *= alpha of its row, for a wgmma accumulator o.
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The probabilities of k16 step kk (keys 16 kk .. 16 kk + 15), rounded to
// bf16, as the register A fragment of the P V wgmma: the accumulator
// columns of two neighbouring 8-key groups are exactly the m16n8k16 A
// layout of each warp's 16 rows.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&a)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = mma::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// 1 / l of the thread's two rows (the quad's shares summed) and their lse,
// m scale + ln(l), natural log, as the TPU kernel's contract.
__device__ __forceinline__ void finish_rows(const float (&m)[2], const float (&l)[2], float scale,
                                            float (&inv)[2], float (&lse)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(mma::quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / l_safe;
    lse[h] = m[h] * scale + logf(l_safe);
  }
}

// Store columns [0, ncol) of the thread's two rows of a wgmma accumulator
// o (times inv), rows `ld` elements apart, the row at `row0 + 8 h`;
// rows at or past `len` skipped.
template <int NO>
__device__ __forceinline__ void store_o(bf16* base, const float (&o)[NO], int ncol, int row0,
                                        int len, size_t ld, const float (&inv)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= len) continue;
    bf16* orow = base + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      if (j * 8 < ncol)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
            mma::pack(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
  }
}

// A head's D features in shared memory: SW blocks of 64 (128-byte rows,
// 128-byte swizzle, 8-row atoms of 1024 bytes), then CH chunks of 8
// (16-byte rows, no swizzle), each block or chunk [rows][bytes].
template <int D>
struct Cols {
  static_assert(D % 16 == 0 && D <= 128, "head dims 16, 32, 64, 80, 128");
  static constexpr int SW = D / 64;
  static constexpr int CH = (D % 64) / 8;
  static constexpr int bytes(int rows) { return SW * rows * 128 + CH * rows * 16; }
};

// The tensor maps of one heads-first [N][L][D] bf16 tensor: 64-feature
// swizzled boxes and 8-feature chunk boxes of a tile's rows of one head.
struct Maps {
  CUtensorMap sw, ch;
};

// The maps of an [N][L][D] bf16 tensor with boxes of `rows` rows (false if
// cuTensorMapEncodeTiled refuses one).
template <int D>
bool make_maps(Maps* m, const void* base, int n, int len, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)len, (cuuint64_t)n};
  const cuuint64_t str[2] = {(cuuint64_t)D * 2, (cuuint64_t)D * 2 * len};
  const cuuint32_t swbox[3] = {64, (cuuint32_t)rows, 1}, chbox[3] = {8, (cuuint32_t)rows, 1};
  *m = Maps{};
  return (!Cols<D>::SW || make_map(&m->sw, base, 3, dims, str, swbox, CU_TENSOR_MAP_SWIZZLE_128B)) &&
         (!Cols<D>::CH || make_map(&m->ch, base, 3, dims, str, chbox));
}

// The TMA copies of `rows` rows from `row` on of head `bh` of an [N][L][D]
// tensor into a tile in the Cols<D> layout, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst, const Maps& m, int rows, int row,
                                          int bh, uint64_t* bar) {
  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
#pragma unroll
  for (int cb = 0; cb < SW; ++cb) tma_load_3d(dst + cb * rows * 128, &m.sw, 64 * cb, row, bh, bar);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    tma_load_3d(dst + SW * rows * 128 + c * rows * 16, &m.ch, 64 * SW + 8 * c, row, bh, bar);
}

}  // namespace fa
}  // namespace adt
