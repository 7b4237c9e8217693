// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_attn_kernel
// (dispatched by _flash_forward): o = softmax(q k^T / sqrt(D)) v by online
// softmax, plus the per-row float32 logsumexp the backward needs, for
// D in {16, 32, 64, 80, 128} (D = 512 is flash_fwd_wide.cu). It reads the
// "rows" layout of flash_fwd.cuh: q, o [B, T, H * D] and k, v [B, S, H * D],
// head h's D features at h D of each row, so [N, T, D] is heads = 1 and the
// Stable Diffusion projections' token-major [B, T, H * D] is taken as it is,
// without a transpose. lse is [B * H, T] float32.
//
// Bound on this card: operations. At the ADM-64 shapes (D = 64, T = S =
// 1024) and the SD 32x32 level (D = 80, T = S = 1024) the work is 4 T S D
// operations per head against (3 + 1) T D elements moved; the softmax's
// T S exponentials per head come next (at D = 64, 2.0e8 of them at the
// H100's ~3.9e12 a second take as long as the products at the dense bf16
// peak).
//
// bfloat16, two warpgroups on wgmma fed by TMA (flash_wgmma.cuh):
//   * tile: 128 query rows of one (batch, head) a block, 64 for each
//     warpgroup, so each head's K and V are read from L2 T / 128 times;
//     keys in tiles of 128 (D <= 64) or 64 (D >= 80, where the O
//     accumulator takes 40 or 64 registers beside the S tile). Up to 64
//     query rows (the ADM 8x8 level) take a block of one warpgroup and
//     64-key tiles instead, so that half a block does not idle.
//   * loads: TMA copies over the tensor seen as [B][L][H D] (zero outside:
//     ragged T and S need no masking of the loads). Each 64 features of a
//     head are one box of 128-byte rows with the 128-byte swizzle the
//     wgmma descriptors name; the rest (D = 16, 32, and D = 80's last 16)
//     are boxes of 16-byte chunks that land as the no-swizzle core-matrix
//     layout. K and V stream through a ring of two stages (up to four
//     measured no faster: tools/kernel_ab.py fwd_deep_ring), refilled by
//     the last warp done with a stage (a shared-memory count), as
//     flash_fwd_packed.cu does.
//   * products: S = Q K^T from shared memory (m64nBNk16, D / 16 steps);
//     O += P V with P from registers (fa::pack_p), one m64n64 product per
//     64-feature block and one m64n16 / n32 product for the chunks.
//   * softmax: in base 2 on the raw dot, one FFMA and one MUFU.EX2 a logit
//     (fa::online_softmax); the lse stays natural-log (fa::finish_rows).
//   * occupancy: two blocks an SM (128 registers a thread) up to D = 80,
//     one at D = 128; the one-warpgroup block four (two at D = 128).
// float32: the CUDA-core kernel of flash_fwd.cuh, one row per lane group.
#include "flash_fwd.cuh"
#include "flash_wgmma.cuh"

namespace adt {
namespace fwd {

using fa::bf16;

// a head's D features in shared memory (flash_wgmma.cuh)
using fa::Cols;

template <int D, int WG>
struct Cfg {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kWarps = 4 * WG;
  static constexpr int kBM = 64 * WG;                         // query rows a block
  static constexpr int kBN = (WG == 2 && D <= 64) ? 128 : 64;  // keys a tile
  static constexpr int kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2) : (D >= 128 ? 2 : 4);
  static constexpr int kStages = 2;
  static constexpr int kQBytes = Cols<D>::bytes(kBM);
  static constexpr int kTileBytes = Cols<D>::bytes(kBN);
  // dynamic shared memory: up to 1 KB to align the swizzled tiles, Q, K
  // and V of each stage (every tile a multiple of 1 KB), then the
  // mbarriers (q, full[2]) and the stages' counts
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes + 32;
  // kMinBlocks blocks share an SM's 228 KB (the system keeps 1 KB a block)
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "the blocks an SM holds");
};

template <int D, int WG>
__global__ void __launch_bounds__(Cfg<D, WG>::kThreads, Cfg<D, WG>::kMinBlocks)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_sw,
                         const __grid_constant__ CUtensorMap q_ch,
                         const __grid_constant__ CUtensorMap k_sw,
                         const __grid_constant__ CUtensorMap k_ch,
                         const __grid_constant__ CUtensorMap v_sw,
                         const __grid_constant__ CUtensorMap v_ch, bf16* __restrict__ o,
                         float* __restrict__ lse, int t_len, int s_len, int heads, int t_tiles,
                         float scale, float scale_log2) {
  using C = Cfg<D, WG>;
  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  constexpr int kBM = C::kBM, kBN = C::kBN, stages = C::kStages;
  constexpr int QB = C::kQBytes, TB = C::kTileBytes;
  // (aligned here by hand: the declared alignment of dynamic shared
  // memory is not promised)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
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
  const int f0 = h * D;  // head h's first feature in a row

  // the copies of `rows` rows from `row` on of one tensor into a tile
  auto copy = [&](unsigned char* dst, const CUtensorMap* sw, const CUtensorMap* ch, int rows,
                  int row, uint64_t* bar) {
#pragma unroll
    for (int cb = 0; cb < SW; ++cb) tma_load_3d(dst + cb * rows * 128, sw, f0 + 64 * cb, row, b, bar);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load_3d(dst + SW * rows * 128 + c * rows * 16, ch, f0 + 64 * SW + 8 * c, row, b, bar);
  };
  // key tile j into its stage
  auto issue = [&](int j) {
    const int s = j % stages;
    mbar_expect_tx(full + s, 2 * TB);
    copy(stage_k(s), &k_sw, &k_ch, kBN, j * kBN, full + s);
    copy(stage_v(s), &v_sw, &v_ch, kBN, j * kBN, full + s);
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, QB);
    copy(smem, &q_sw, &q_ch, kBM, r0, qbar);
    for (int j = 0; j < stages && j < n_tiles; ++j) issue(j);
  }

  // each warpgroup: 64 query rows, its view of Q 64 rows into each block
  // and chunk
  const int lane = lt & 31, warp = lt >> 5, t = lane & 3;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const unsigned char* sq_sw = smem + wgi * 64 * 128;
  const unsigned char* sq_ch = smem + SW * kBM * 128 + wgi * 64 * 16;

  // Every wgmma batch is fenced on both sides in its operands (else ptxas
  // may move other instructions into it and serialise the pipeline).
  // S = Q K^T of the tile in stage s, issued, not waited: four k16 steps
  // a 64-feature block (32 bytes into its swizzled rows), one a pair of
  // chunks; the first step writes S without reading it
  auto qk = [&](auto& acc, int s) {
    const unsigned char* sk = stage_k(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint64_t da, db;
      if (kk < 4 * SW) {
        const int cb = kk / 4, off = (kk % 4) * 32;
        da = wg::desc_sw128(sq_sw + cb * kBM * 128 + off, 0, 1024);
        db = wg::desc_sw128(sk + cb * kBN * 128 + off, 0, 1024);
      } else {
        const int c = 2 * (kk - 4 * SW);
        da = wg::desc(sq_ch + c * kBM * 16, kBM * 16, 128);
        db = wg::desc(sk + SW * kBN * 128 + c * kBN * 16, kBN * 16, 128);
      }
      if (kk == 0)
        wg::mma_first<kBN>(acc, da, db);
      else
        wg::mma<kBN>(acc, da, db);
    }
    wg::commit();
    wg::fence_operands(acc);
  };
  // O += P V of the tile in stage s, issued, not waited. V MN-major: in a
  // 64-feature block, 8-key atoms 1024 bytes apart (SBO), keys 16 kk on;
  // in the chunks, 8-key groups 128 bytes apart (LBO), chunks kBN * 16
  // apart (SBO)
  auto pv = [&](auto& pa, int s) {
    const unsigned char* sv = stage_v(s);
    wg::fence_operands(pa);
    wg::fence_operands(oacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < SW; ++cb)
        wg::mma_rs<64>(*reinterpret_cast<float(*)[32]>(oacc + 32 * cb), pa[kk],
                       wg::desc_sw128(sv + cb * kBN * 128 + kk * 2048, kBN * 128, 1024));
      if constexpr (CH > 0)
        wg::mma_rs<8 * CH>(*reinterpret_cast<float(*)[4 * CH]>(oacc + 32 * SW), pa[kk],
                           wg::desc(sv + SW * kBN * 128 + kk * 256, 128, kBN * 16));
    }
    wg::commit();
    wg::fence_operands(oacc);
    wg::fence_operands(pa);
  };
  // Tile j: S = Q K^T, the online softmax, O += P V, each warpgroup on its
  // own; the last of the block's warps done with a tile refills its stage
  // with the tile `stages` later.
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
      // the stage's count reaches kWarps u after its u-th tile
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == C::kWarps * (j / stages) + C::kWarps - 1 &&
          j + stages < n_tiles)
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
  fa::store_o<D / 2>(o + (size_t)b * t_len * ld + f0, oacc, D, row0, t_len, ld, inv, t);
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int heads,
           int t_len, int s_len, float scale, cudaStream_t st) {
  using C = Cfg<D, WG>;
  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  // [B][L][H D] bf16; a box: 64 (swizzled) or 8 features of a tile's rows
  // of one sample
  const cuuint64_t row = (cuuint64_t)heads * D;
  const cuuint64_t qdims[3] = {row, (cuuint64_t)t_len, (cuuint64_t)b};
  const cuuint64_t kdims[3] = {row, (cuuint64_t)s_len, (cuuint64_t)b};
  const cuuint64_t qstr[2] = {row * 2, row * 2 * t_len};
  const cuuint64_t kstr[2] = {row * 2, row * 2 * s_len};
  const cuuint32_t q_swbox[3] = {64, C::kBM, 1}, q_chbox[3] = {8, C::kBM, 1};
  const cuuint32_t k_swbox[3] = {64, C::kBN, 1}, k_chbox[3] = {8, C::kBN, 1};
  CUtensorMap qs{}, qc{}, ks{}, kc{}, vs{}, vc{};
  const CUtensorMapSwizzle sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if (SW && (!make_map(&qs, q, 3, qdims, qstr, q_swbox, sw128) ||
             !make_map(&ks, k, 3, kdims, kstr, k_swbox, sw128) ||
             !make_map(&vs, v, 3, kdims, kstr, k_swbox, sw128)))
    return -2;
  if (CH && (!make_map(&qc, q, 3, qdims, qstr, q_chbox) ||
             !make_map(&kc, k, 3, kdims, kstr, k_chbox) ||
             !make_map(&vc, v, 3, kdims, kstr, k_chbox)))
    return -2;
  // once per instantiation: allow dynamic shared memory above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, fa::kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int t_tiles = (t_len + C::kBM - 1) / C::kBM;
  flash_fwd_tma_kernel<D, WG><<<b * heads * t_tiles, C::kThreads, C::kSmem, st>>>(
      qs, qc, ks, kc, vs, vc, static_cast<bf16*>(o), lse, t_len, s_len, heads, t_tiles, scale,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// up to 64 query rows: the one-warpgroup block
template <int D>
int launch_rows(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                int heads, int t_len, int s_len, float scale, cudaStream_t st) {
  return t_len <= 64 ? launch<D, 1>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st)
                     : launch<D, 2>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
}

}  // namespace fwd
}  // namespace adt

// q, o [B, T, heads * head_dim]; k, v [B, S, heads * head_dim]; lse [B *
// heads, T] ([N, T, D] is B = N, heads = 1). -1 for a head dim without an
// instantiation.
extern "C" int adt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int b, int heads, int t_len, int s_len, int head_dim, int is_bf16,
                             float scale, void* stream) {
  if (b == 0 || heads == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using adt::fwd::launch_rows;
    switch (head_dim) {
      case 16: return launch_rows<16>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
      case 32: return launch_rows<32>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
      case 64: return launch_rows<64>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
      case 80: return launch_rows<80>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
      case 128: return launch_rows<128>(q, k, v, o, lse, b, heads, t_len, s_len, scale, st);
      default: return -1;
    }
  }
  const int n = b * heads;
  const int ld = heads * head_dim;
  switch (head_dim) {
    case 16: ADT_LAUNCH_FWD_F32(16, heads, ld); break;
    case 32: ADT_LAUNCH_FWD_F32(32, heads, ld); break;
    case 64: ADT_LAUNCH_FWD_F32(64, heads, ld); break;
    case 80: ADT_LAUNCH_FWD_F32(80, heads, ld); break;
    case 128: ADT_LAUNCH_FWD_F32(128, heads, ld); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
