// Small-head-dim flash-attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel
// autodiffusion_tpu/ops/flash_attention.py::_attn_kernel_packed (dispatched
// by _flash_forward_packed): the same o, lse contract as _attn_kernel for
// head dims D <= 64, here D = 40 (the head dims that are multiples of 16
// take flash_fwd.cu on the same layout). On the TPU, packing G = 128 / D
// heads into the 128 lanes of the matrix unit filled the lanes a D = 40
// head leaves idle. On Hopper the 16-deep wgmma step wastes only D = 40's
// padding to 48, so what carries over is the layout: the kernel reads q
// [B, T, H * D] and k, v [B, S, H * D] token-major, as the attention
// projections (to_q, to_k, to_v) produce them, and writes o [B, T, H * D]
// for to_out, so the four head transposes around an unpacked kernel
// disappear. lse is [B * H, T] float32.
//
// Bound on this card: at the Stable Diffusion 64x64 level (D = 40, 8 heads,
// T = S = 4096, batch 16) the matrix products' bound is 0.347 ms, but the
// softmax's 2.15e9 exponentials a launch take about 0.55 ms at the H100's
// ~3.9e12 special-function results a second: the exponential, not the
// tensor cores, sets the floor. Cross-attention over 77 keys is bound by
// bytes.
//
// bfloat16, two warpgroups on wgmma (flash_wgmma.cuh):
//   * tile: 128 query rows of one (batch, head) a block, 64 for each of
//     the two warpgroups, so each head's K and V are read from L2 T / 128
//     times; keys in tiles of 128.
//   * loads: thread 0's TMA copies over the tensor seen as [B][L][H D]
//     (zero outside: ragged T and S need no masking of the loads). One
//     copy moves one 16-byte chunk (8 features) of 128 tokens, so a tile
//     lands as [chunk][token][8], the no-swizzle core-matrix layout the
//     wgmma reads: K-major for Q and K, MN-major for V. Head h's chunks
//     start at chunk h D / 8. K and V stream through a ring of 2-4 stages
//     (ring_stages: as many as there are key tiles, as two blocks an SM
//     allow).
//   * padding: D = 40 is padded to 48. The padding chunk of Q, K and V is
//     zeroed once and no copy writes it, so it adds zero products to the
//     logits and its output columns are never stored. (`raw_pad`, for the
//     kernel checks only, copies one chunk more, the next head's.)
//   * products: S = Q K^T as m64n128k16 over D_pad / 16 steps from shared
//     memory; O += P V as m64nD_padk16 with P from registers.
//   * occupancy: two blocks an SM (128 registers a thread, at most 113 KB
//     of shared memory a block), so four warpgroups interleave their
//     products and exponentials. A warpgroup's own tile is serial
//     (S, softmax, P V): keeping the next tile's S in flight during the
//     softmax (two S accumulators, FlashAttention-3's intra-warpgroup
//     overlap) needs twice the S registers, so one block an SM, and ran
//     slower at every tile size tried (PERF.md §6).
//   * ring: the last of the eight warps to finish a tile (a shared-memory
//     count) refills its stage with the tile `stages` later, so neither
//     warpgroup waits for the other.
//   * softmax: in base 2 on the pre-scaled dot, one FFMA and one MUFU.EX2
//     a logit.
// float32: the CUDA-core kernel of flash_fwd.cuh, one row per lane group.
#include "flash_fwd.cuh"
#include "flash_wgmma.cuh"

namespace adt {
namespace packed {

using fa::bf16;

constexpr int kBM = 128;  // query rows a block
constexpr int kBN = 128;  // keys a tile
constexpr int kBlocksPerSM = 2;  // 128 registers a thread

// Shared memory, in bytes: Q [DP / 8][128][8] bf16, then for each stage K
// and V [DP / 8][128][8] bf16, then the mbarriers (q, full[stages]) and a
// count of the warps done with each stage (8 bytes a stage).
__host__ __device__ constexpr int q_bytes(int dp) { return dp / 8 * kBM * 16; }
__host__ __device__ constexpr int tile_bytes(int dp) { return dp / 8 * kBN * 16; }
__host__ __device__ constexpr int smem_bytes(int dp, int stages) {
  return q_bytes(dp) + stages * 2 * tile_bytes(dp) + (1 + 2 * stages) * 8;
}

// The ring's depth: one stage a key tile, 2 to 4, and no more than let
// kBlocksPerSM blocks share an SM's 228 KB (the system keeps 1 KB of it a
// block).
constexpr int kSmemPerSM = 233472, kSmemReserved = 1024;
constexpr int ring_stages(int dp, int s_len) {
  const int tiles = (s_len + kBN - 1) / kBN;
  int stages = tiles < 2 ? 2 : tiles > 4 ? 4 : tiles;
  while (stages > 2 && kBlocksPerSM * (smem_bytes(dp, stages) + kSmemReserved) > kSmemPerSM)
    --stages;
  return stages;
}

template <int D, int DP>
__global__ void __launch_bounds__(fa::kThreads, kBlocksPerSM)
    flash_fwd_packed_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                            float* __restrict__ lse, int t_len, int s_len, int heads, int t_tiles,
                            int stages, int box_chunks, float scale, float scale_log2) {
  constexpr int QB = q_bytes(DP), TB = tile_bytes(DP);
  extern __shared__ __align__(1024) unsigned char smem[];
  auto stage_k = [&](int s) { return smem + QB + s * 2 * TB; };
  auto stage_v = [&](int s) { return smem + QB + s * 2 * TB + TB; };
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + QB + stages * 2 * TB);
  uint64_t* full = qbar + 1;
  unsigned* done = reinterpret_cast<unsigned*>(full + stages);  // warps done with a stage

  const int bh = blockIdx.x / t_tiles;
  const int b = bh / heads, h = bh - b * heads;
  const int r0 = (blockIdx.x - bh * t_tiles) * kBM;
  const int n_tiles = (s_len + kBN - 1) / kBN;
  const int wgi = threadIdx.x >> 7, lt = threadIdx.x & 127;
  const int c0 = h * (D / 8);  // head h's first 16-byte chunk

  // the copies of key tile j into its stage
  auto issue = [&](int j) {
    const int s = j % stages;
    mbar_expect_tx(full + s, 2 * box_chunks * kBN * 16);
    for (int c = 0; c < box_chunks; ++c) {
      tma_load_3d(stage_k(s) + c * kBN * 16, &kmap, (c0 + c) * 8, j * kBN, b, full + s);
      tma_load_3d(stage_v(s) + c * kBN * 16, &vmap, (c0 + c) * 8, j * kBN, b, full + s);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  if constexpr (DP > D) {
    if (box_chunks * 8 < DP) {
      // the padding chunks of Q and of every stage's K and V: zero, once
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      constexpr int pad = DP / 8 - D / 8;
      for (int i = threadIdx.x; i < pad * kBM; i += fa::kThreads)
        reinterpret_cast<uint4*>(smem + (D / 8) * kBM * 16)[i] = z;
      for (int i = threadIdx.x; i < 2 * stages * pad * kBN; i += fa::kThreads) {
        const int region = i / (pad * kBN), rest = i - region * pad * kBN;
        reinterpret_cast<uint4*>(stage_k(0) + region * TB + (D / 8) * kBN * 16)[rest] = z;
      }
      wg::fence_proxy_async();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, box_chunks * kBM * 16);
    for (int c = 0; c < box_chunks; ++c)
      tma_load_3d(smem + c * kBM * 16, &qmap, (c0 + c) * 8, r0, b, qbar);
    for (int j = 0; j < stages && j < n_tiles; ++j) issue(j);
  }

  // each warpgroup: 64 query rows
  const int lane = lt & 31, warp = lt >> 5, t = lane & 3;
  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const unsigned char* sq = smem + wgi * 64 * 16;

  // Every wgmma batch is fenced on both sides in its operands (else ptxas
  // may move other instructions into it and serialise the pipeline).
  // S = Q K^T of the tile in stage s, issued, not waited; the first k16
  // step writes S without reading it, so S is dead between tiles
  auto qk = [&](auto& acc, int s) {
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wg::desc(sq + kk * 2 * kBM * 16, kBM * 16, 128);
      const uint64_t db = wg::desc(stage_k(s) + kk * 2 * kBN * 16, kBN * 16, 128);
      if (kk == 0)
        wg::mma_first<kBN>(acc, da, db);
      else
        wg::mma<kBN>(acc, da, db);
    }
    wg::commit();
    wg::fence_operands(acc);
  };
  // O += P V of the tile in stage s, issued, not waited
  auto pv = [&](auto& pa, int s) {
    wg::fence_operands(pa);
    wg::fence_operands(oacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      // V MN-major: keys 16 kk on; 8-key groups 128 bytes apart (LBO),
      // 8-feature chunks kBN * 16 apart (SBO)
      wg::mma_rs<DP>(oacc, pa[kk], wg::desc(stage_v(s) + kk * 256, 128, kBN * 16));
    wg::commit();
    wg::fence_operands(oacc);
    wg::fence_operands(pa);
  };
  // Tile j: S = Q K^T, the online softmax, O += P V, each warpgroup on
  // its own; the two warpgroups of a block, and the two blocks an SM
  // holds, interleave on the tensor cores and the special-function units.
  // The last of a block's eight warps done with a tile (a shared-memory
  // count) refills its stage with the tile `stages` later, so neither
  // warpgroup waits for the other.
  float sacc[kBN / 2];
  uint32_t pa[kBN / 16][4];
  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    mbar_wait(full + s, (j / stages) & 1);
    qk(sacc, s);
    wg::wait_all();
    wg::fence_operands(sacc);
    const int valid = s_len - j * kBN;
    float alpha[2];
    fa::online_softmax<kBN>(sacc, m, l, alpha, valid, valid < kBN, scale_log2, t);
    fa::rescale(oacc, alpha);
    fa::pack_p<kBN>(pa, sacc);
    pv(pa, s);
    wg::wait_all();
    wg::fence_operands(oacc);
    wg::fence_operands(pa);
    if (lane == 0) {
      // the stage's count reaches 8 u after its u-th tile
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == 8u * (j / stages) + 7u && j + stages < n_tiles)
        issue(j + stages);
    }
  }

  float inv[2], row_lse[2];
  fa::finish_rows(m, l, scale, inv, row_lse);
  const int row0 = r0 + wgi * 64 + warp * 16 + (lane >> 2);
  if (t == 0)
    for (int hh = 0; hh < 2; ++hh)
      if (row0 + 8 * hh < t_len) lse[(size_t)bh * t_len + row0 + 8 * hh] = row_lse[hh];
  const size_t ld = (size_t)heads * D;
  fa::store_o<DP / 2>(o + (size_t)b * t_len * ld + (size_t)h * D, oacc, D, row0, t_len, ld, inv,
                      t);
}

template <int D, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int heads,
           int t_len, int s_len, int raw_pad, float scale, cudaStream_t st) {
  const int stages = ring_stages(DP, s_len), smem = smem_bytes(DP, stages);
  static_assert(kBlocksPerSM * (smem_bytes(DP, 2) + kSmemReserved) <= kSmemPerSM,
                "two stages must let kBlocksPerSM blocks share an SM");
  const int box_chunks = raw_pad ? DP / 8 : D / 8;
  // [B][L][H D] bf16; one copy: 8 features of a tile's tokens of one sample
  const cuuint64_t row = (cuuint64_t)heads * D;
  const cuuint32_t qbox[3] = {8, kBM, 1}, kbox[3] = {8, kBN, 1};
  const cuuint64_t qdims[3] = {row, (cuuint64_t)t_len, (cuuint64_t)b};
  const cuuint64_t kdims[3] = {row, (cuuint64_t)s_len, (cuuint64_t)b};
  const cuuint64_t qstr[2] = {row * 2, row * 2 * t_len};
  const cuuint64_t kstr[2] = {row * 2, row * 2 * s_len};
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, 3, qdims, qstr, qbox) || !make_map(&kmap, k, 3, kdims, kstr, kbox) ||
      !make_map(&vmap, v, 3, kdims, kstr, kbox))
    return -2;
  // once per instantiation: allow dynamic shared memory above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_packed_kernel<D, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, fa::kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int t_tiles = (t_len + kBM - 1) / kBM;
  flash_fwd_packed_kernel<D, DP><<<b * heads * t_tiles, fa::kThreads, smem, st>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), lse, t_len, s_len, heads, t_tiles, stages,
      box_chunks, scale, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace packed
}  // namespace adt

// q, o [B, T, heads * head_dim]; k, v [B, S, heads * head_dim]; lse [B *
// heads, T]. raw_pad (kernel checks only) copies the padding chunk of a
// head dim that is not a multiple of 16 from memory (the next head's
// features) instead of leaving it zero. -1 for a head dim other than 40.
extern "C" int adt_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int b, int heads, int t_len, int s_len,
                                    int head_dim, int is_bf16, int raw_pad, float scale,
                                    void* stream) {
  if (b == 0 || heads == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != 40) return -1;
  if (is_bf16)
    return adt::packed::launch<40, 48>(q, k, v, o, lse, b, heads, t_len, s_len, raw_pad, scale, st);
  const int n = b * heads;
  const int ld = heads * head_dim;
  ADT_LAUNCH_FWD_F32(40, heads, ld);
  return static_cast<int>(cudaGetLastError());
}
