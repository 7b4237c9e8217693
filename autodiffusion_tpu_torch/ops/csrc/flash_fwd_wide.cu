// Flash-attention forward at head dim 512 for Hopper (sm_90a), plain C
// interface: the AutoencoderKL mid-block's single head (T = S = 4096 at
// 512 x 512 pixels).
//
// Replaces autodiffusion_tpu/ops/flash_attention.py::_attn_kernel at D = 512
// (the TPU kernel shrinks its blocks there so that q, k, v and the float32
// accumulator fit VMEM). Same o, lse contract as flash_fwd.cu.
//
// Bound on this card: operations (4 T S D per head against 4 T D elements
// moved: at T = S = 4096 about 2000 operations a byte).
//
// bfloat16, two warpgroups on wgmma (flash_wgmma.cuh); every logit is
// computed once, for all 512 output columns:
//   * tile: 64 query rows a block (q resident in shared memory, 64 KB),
//     keys in tiles of 32; warpgroup c owns output columns [256 c,
//     256 c + 256): an m64n256 float32 accumulator, 128 registers a thread.
//   * logits: warpgroup c multiplies the half [256 c, 256 c + 256) of the
//     512-deep contraction (16 m64n32k16 steps); the two partial 64 x 32
//     tiles meet in shared memory behind a block barrier, and each
//     warpgroup adds them (x_0 + x_1, the same float32 sum in both), so
//     both hold the same logits and the same probabilities. The exchange
//     buffer alternates with the tile's parity, so one barrier a tile
//     suffices.
//   * P V: P from registers as the A operand; V [32 keys, 256 columns]
//     from shared memory, MN-major.
//   * loads: thread 0's TMA copies of 64-column blocks (128 bytes, the
//     128-byte swizzle the wgmma descriptors name): Q once, K and V
//     through two stages each (32 KB a tile), K and V on mbarriers of
//     their own. The exchange barrier of tile j orders the refills: both
//     warpgroups have then read K(j) and V(j - 1), so K(j + 2) and
//     V(j + 1) go in, one and two tiles ahead of their use.
//   * shared memory: 64 KB Q + 128 KB of stages + 32 KB of exchange.
// float32: the CUDA-core kernel of flash_fwd.cuh, one warp a row (32
// lanes x 16 features).
#include "flash_fwd.cuh"
#include "flash_wgmma.cuh"

namespace adt {
namespace wide {

using fa::bf16;

constexpr int kD = 512;
constexpr int kBM = 64;       // query rows a block
constexpr int kBN = 32;       // keys a tile
constexpr int kStages = 2;
constexpr int kBlockCols = 64;  // columns a TMA copy (128 bytes, the swizzle's row)
constexpr int kQBytes = kBM * kD * 2;
constexpr int kTileBytes = kBN * kD * 2;
constexpr int kXBytes = 2 * 2 * kBM * kBN * 4;  // [tile parity][warpgroup][64 x 32] float32
// Shared memory, in bytes: up to 1 KB to align the swizzled tiles, Q, the
// stages (K then V), the exchange, the mbarriers (q, K full[2], V full[2]).
constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes + kXBytes + (1 + 2 * kStages) * 8;
static_assert(kSmem <= fa::kSmemMax, "the wide kernel's shared memory");

__global__ void __launch_bounds__(fa::kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                          float* __restrict__ lse, int t_len, int s_len, int t_tiles, float scale,
                          float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* sq = smem;  // [8 column blocks][64 rows][128 bytes]
  auto stage_k = [&](int s) { return smem + kQBytes + s * 2 * kTileBytes; };
  auto stage_v = [&](int s) { return smem + kQBytes + s * 2 * kTileBytes + kTileBytes; };
  float* xch = reinterpret_cast<float*>(smem + kQBytes + kStages * 2 * kTileBytes);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + kQBytes + kStages * 2 * kTileBytes + kXBytes);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kStages;

  const int bh = blockIdx.x / t_tiles;
  const int r0 = (blockIdx.x - bh * t_tiles) * kBM;
  const int n_tiles = (s_len + kBN - 1) / kBN;
  const int c = threadIdx.x >> 7, lt = threadIdx.x & 127;

  // the copies of tile j's K (or V) into its stage (thread 0)
  auto issue_k = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(kfull + s, kTileBytes);
    for (int cb = 0; cb < kD / kBlockCols; ++cb)
      tma_load_3d(stage_k(s) + cb * kBN * 128, &kmap, cb * kBlockCols, j * kBN, bh, kfull + s);
  };
  auto issue_v = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(vfull + s, kTileBytes);
    for (int cb = 0; cb < kD / kBlockCols; ++cb)
      tma_load_3d(stage_v(s) + cb * kBN * 128, &vmap, cb * kBlockCols, j * kBN, bh, vfull + s);
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2 * kStages; ++s) mbar_init(kfull + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kQBytes);
    for (int cb = 0; cb < kD / kBlockCols; ++cb)
      tma_load_3d(sq + cb * kBM * 128, &qmap, cb * kBlockCols, r0, bh, qbar);
    issue_k(0);
    if (n_tiles > 1) issue_k(1);
    issue_v(0);
  }

  // warpgroup c: all 64 rows, output columns [256 c, 256 c + 256)
  const int lane = lt & 31, warp = lt >> 5, t = lane & 3;
  float oacc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(kfull + s, (j / kStages) & 1);
    // this warpgroup's half of the contraction: column blocks 4 c .. 4 c +
    // 3, k16 step kk 32 bytes into its block's 128-byte rows
    float sacc[kBN / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int cb = 4 * c + kk / 4, off = (kk % 4) * 32;
      const uint64_t da = wg::desc_sw128(sq + cb * kBM * 128 + off, 0, 1024);
      const uint64_t db = wg::desc_sw128(stage_k(s) + cb * kBN * 128 + off, 0, 1024);
      if (kk == 0)
        wg::mma_first<kBN>(sacc, da, db);
      else
        wg::mma<kBN>(sacc, da, db);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(sacc);

    // the other half's partial logits, through shared memory; both
    // warpgroups hold a thread's elements at the same (warp, lane)
    float* x = xch + (j & 1) * 2 * kBM * kBN;
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) x[(c * (kBN / 2) + e) * 128 + lt] = sacc[e];
    __syncthreads();
    // past the barrier both warpgroups are done with K(j) and V(j - 1):
    // their stages take K(j + 2) and V(j + 1)
    if (threadIdx.x == 0) {
      if (j + 2 < n_tiles) issue_k(j + 2);
      if (j + 1 < n_tiles) issue_v(j + 1);
    }
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const float other = x[((1 - c) * (kBN / 2) + e) * 128 + lt];
      sacc[e] = c == 0 ? sacc[e] + other : other + sacc[e];
    }

    const int valid = s_len - j * kBN;
    float alpha[2];
    fa::online_softmax<kBN>(sacc, m, l, alpha, valid, valid < kBN, scale_log2, t);
    fa::rescale(oacc, alpha);
    uint32_t pa[kBN / 16][4];
    fa::pack_p<kBN>(pa, sacc);

    mbar_wait(vfull + s, (j / kStages) & 1);
    wg::fence_operands(pa);
    wg::fence_operands(oacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      // V MN-major: 64-column blocks kBN * 128 bytes apart (LBO), 8-key
      // atoms 1024 apart (SBO); keys 16 kk on
      wg::mma_rs<256>(oacc, pa[kk],
                      wg::desc_sw128(stage_v(s) + 4 * c * kBN * 128 + kk * 2048, kBN * 128, 1024));
    wg::commit();
    wg::fence_operands(oacc);
    wg::fence_operands(pa);
    wg::wait_all();
    wg::fence_operands(oacc);
  }

  float inv[2], row_lse[2];
  fa::finish_rows(m, l, scale, inv, row_lse);
  const int row0 = r0 + warp * 16 + (lane >> 2);
  if (c == 0 && t == 0)
    for (int hh = 0; hh < 2; ++hh)
      if (row0 + 8 * hh < t_len) lse[(size_t)bh * t_len + row0 + 8 * hh] = row_lse[hh];
  fa::store_o<128>(o + (size_t)bh * t_len * kD + 256 * c, oacc, 256, row0, t_len, kD, inv, t);
}

}  // namespace wide
}  // namespace adt

// q, o [n, T, 512]; k, v [n, S, 512]; lse [n, T]. -1 for another head
// dim.
extern "C" int adt_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int n, int t_len, int s_len, int head_dim,
                                  int is_bf16, float scale, void* stream) {
  if (head_dim != adt::wide::kD) return -1;
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using namespace adt::wide;
    // [n][L][512] bf16; one copy: a 64-column block of 64 (q) or 32 rows
    const cuuint64_t qdims[3] = {kD, (cuuint64_t)t_len, (cuuint64_t)n};
    const cuuint64_t kdims[3] = {kD, (cuuint64_t)s_len, (cuuint64_t)n};
    const cuuint64_t qstr[2] = {kD * 2, (cuuint64_t)kD * 2 * t_len};
    const cuuint64_t kstr[2] = {kD * 2, (cuuint64_t)kD * 2 * s_len};
    const cuuint32_t qbox[3] = {kBlockCols, kBM, 1};
    const cuuint32_t kbox[3] = {kBlockCols, kBN, 1};
    CUtensorMap qmap, kmap, vmap;
    if (!adt::make_map(&qmap, q, 3, qdims, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !adt::make_map(&kmap, k, 3, kdims, kstr, kbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !adt::make_map(&vmap, v, 3, kdims, kstr, kbox, CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
    // once: allow dynamic shared memory above 48 KB
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, adt::fa::kSmemMax);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int t_tiles = (t_len + kBM - 1) / kBM;
    flash_fwd_wide_kernel<<<n * t_tiles, adt::fa::kThreads, kSmem, st>>>(
        qmap, kmap, vmap, static_cast<adt::fa::bf16*>(o), lse, t_len, s_len, t_tiles, scale,
        scale * 1.4426950408889634f);
  } else {
    ADT_LAUNCH_FWD_F32(512, 1, 512);
  }
  return static_cast<int>(cudaGetLastError());
}
