// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_dkv_kernel
// (driven by _flash_bwd): the FlashAttention-2 dK/dV pass. For one block of
// keys, p^T = exp(k q^T / sqrt(D) - lse^T) is re-formed tile by tile over the
// queries and
//   dv = p^T dO,   dk = (p^T * (v dO^T - delta^T)) q / sqrt(D)
// with padded queries (and padded keys) masked out.
//
// Bound on this card: operations. Four T x S x D products per head (logits,
// dP, dV, dK) against 4 S D + 2 T D elements read and 2 S D written; a
// block keeps its keys (K, V and both accumulators) resident and streams the
// queries, so the TPU kernel's sequential T loop becomes a loop inside the
// block and nothing needs a cross-block reduction.
//
// bfloat16: two warpgroups on wgmma, fed by TMA
//   * tile: 128 key rows of one (batch, head) a block, 64 for each
//     warpgroup (one warpgroup and 64 rows where S <= 64, the ADM 8x8
//     level, and at D = 128, where two compiled to 168 registers with a
//     spill); K and V copied into shared memory once by TMA, laid out as
//     flash_fwd.cu lays a head (each 64 features of a row one
//     128-byte-swizzled box; D = 16 and 32, which have no swizzle atom,
//     16-byte chunks in the no-swizzle core-matrix layout); zero outside,
//     so ragged T and S need no masking of the loads.
//   * ring: Q and dO tiles of BQ query rows (64; 32 at D = 128) and their
//     lse and delta slices stream through three stages, each with a
//     `full` and an `empty` mbarrier. A producer warp beside the
//     warpgroups waits for a stage's `empty` (one arrival a consumer
//     warp), copies lse log2(e) and delta into it with plain loads (T need
//     not be a multiple of four floats, which a TMA row would need) and
//     issues the two tiles' TMA copies; its 32 lanes arrive on `full`.
//   * products, per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T from
//     shared memory (m64nBQk16, K-major); P^T = 2^(S^T c - lse log2(e)),
//     c = scale log2(e), one FFMA and one MUFU.EX2 a logit as in the
//     forwards (flash_wgmma.cuh), where the mma.sync kernel this replaces
//     took the accurate expf; dS^T = P^T (dP^T - delta); dV += P^T dO and
//     dK += dS^T Q with A from registers (the bf16 rounding of P^T and
//     dS^T, as the TPU kernel casts them) and B = dO or Q read MN-major
//     through the transpose bit. dV's product runs while dS is formed; a
//     tile's products drain before its stage goes back (the next tile's S^T
//     and dP^T issued behind its dK product took 17 % more device time, two
//     ring stages 1-4 % more, four no less: tools/kernel_ab.py
//     dkv_issue_ahead, dkv_two_stages, dkv_four_stages).
//   * registers: the dK and dV accumulators (D / 2 floats a thread each)
//     beside S^T and dP^T (BQ / 2 each) and their bf16 fragments: one
//     block an SM.
// float32: float32 FMAs on the CUDA cores, one query at a time.
#include "flash_wgmma.cuh"

namespace adt {

namespace dkv {

using fa::bf16;

constexpr float kLog2e = 1.4426950408889634f;

// a head's D features in shared memory, and the tensor maps (flash_wgmma.cuh)
using fa::Cols;
using fa::make_maps;
using fa::Maps;

template <int D, int WG>
struct Cfg {
  static constexpr int kConsumers = 128 * WG;       // the warpgroups' threads
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kBK = 64 * WG;               // key rows a block
  static constexpr int kBQ = D == 128 ? 32 : 64;    // query rows a tile
  static constexpr int kStages = 3;
  static constexpr int kKVBytes = Cols<D>::bytes(kBK);    // K (or V) of the block
  static constexpr int kTileBytes = Cols<D>::bytes(kBQ);  // a Q (or dO) tile
  // dynamic shared memory: up to 1 KB to align the swizzled tiles, K, V,
  // the stages' Q and dO tiles (every tile a multiple of 1 KB), the
  // stages' [lse log2(e), delta] slices, then the mbarriers (kv, full[],
  // empty[])
  static constexpr int kSmem =
      1024 + 2 * kKVBytes + kStages * 2 * kTileBytes + kStages * 2 * kBQ * 4 + (1 + 2 * kStages) * 8;
  static_assert(kKVBytes % 1024 == 0 && kTileBytes % 1024 == 0, "1 KB tiles");
  static_assert(kSmem <= fa::kSmemMax, "a block's shared memory");
};

template <int D, int WG>
__global__ void __launch_bounds__(Cfg<D, WG>::kThreads, 1)
    flash_bwd_dkv_tma_kernel(const __grid_constant__ Maps q_map, const __grid_constant__ Maps k_map,
                             const __grid_constant__ Maps v_map, const __grid_constant__ Maps o_map,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int s_len,
                             int s_blocks, float scale, float scale_log2) {
  using C = Cfg<D, WG>;
  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  constexpr int BK = C::kBK, BQ = C::kBQ, stages = C::kStages;
  constexpr int KB = C::kKVBytes, TB = C::kTileBytes;
  // (aligned here by hand: the declared alignment of dynamic shared
  // memory is not promised)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sk = smem;
  unsigned char* sv = smem + KB;
  auto stage_q = [&](int s) { return smem + 2 * KB + s * 2 * TB; };
  auto stage_o = [&](int s) { return smem + 2 * KB + s * 2 * TB + TB; };
  // stage s: lse log2(e) at [2 s BQ, 2 s BQ + BQ), delta after it
  float* sl = reinterpret_cast<float*>(smem + 2 * KB + stages * 2 * TB);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sl + stages * 2 * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + stages;

  const int bh = blockIdx.x / s_blocks;
  const int k0 = (blockIdx.x - bh * s_blocks) * BK;
  const int n_tiles = (t_len + BQ - 1) / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, C::kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::kConsumers / 32) {
    // the producer warp: K and V once, then the ring
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * KB);
      fa::load_rows<D>(sk, k_map, BK, k0, bh, kvbar);
      fa::load_rows<D>(sv, v_map, BK, k0, bh, kvbar);
    }
    const float* lb = lse + (size_t)bh * t_len;
    const float* db = delta + (size_t)bh * t_len;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % stages;
      if (j >= stages) mbar_wait(empty + s, (j / stages - 1) & 1);
      float* ls = sl + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const int r = j * BQ + i;
        const bool ok = r < t_len;
        ls[i] = ok ? lb[r] * kLog2e : 0.f;
        ls[BQ + i] = ok ? db[r] : 0.f;
      }
      if (lane == 0) {
        // this arrival and the tiles' bytes; the other lanes' stores are
        // released by their own arrivals
        mbar_expect_tx(full + s, 2 * TB);
        fa::load_rows<D>(stage_q(s), q_map, BQ, j * BQ, bh, full + s);
        fa::load_rows<D>(stage_o(s), o_map, BQ, j * BQ, bh, full + s);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // each warpgroup: 64 key rows, its view of K and V 64 rows into each
  // block and chunk
  const int wgi = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, t = lane & 3;
  const int row0 = k0 + wgi * 64 + w * 16 + (lane >> 2);  // the thread's rows: row0, row0 + 8
  const bool rows_ragged = k0 + BK > s_len;
  const bool row_ok[2] = {row0 < s_len, row0 + 8 < s_len};
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  // Every wgmma batch is fenced on both sides in its operands (else ptxas
  // may move other instructions into it and serialise the pipeline).
  // acc = A B^T for A the warpgroup's 64 rows of K (or V), a, and B the
  // tile's BQ rows of Q (or dO), b, both K-major: four k16 steps a
  // 64-feature block (32 bytes into its swizzled rows), one a pair of
  // chunks; issued and committed, not waited
  auto abt = [&](float(&acc)[BQ / 2], const unsigned char* a, const unsigned char* b) {
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint64_t da, db;
      if (kk < 4 * SW) {
        const int cb = kk / 4, off = (kk % 4) * 32;
        da = wg::desc_sw128(a + cb * BK * 128 + wgi * 64 * 128 + off, 0, 1024);
        db = wg::desc_sw128(b + cb * BQ * 128 + off, 0, 1024);
      } else {
        const int c = 2 * (kk - 4 * SW);
        da = wg::desc(a + SW * BK * 128 + c * BK * 16 + wgi * 64 * 16, BK * 16, 128);
        db = wg::desc(b + SW * BQ * 128 + c * BQ * 16, BQ * 16, 128);
      }
      if (kk == 0)
        wg::mma_first<BQ>(acc, da, db);
      else
        wg::mma<BQ>(acc, da, db);
    }
    wg::commit();
    wg::fence_operands(acc);
  };
  // acc += P x for P [64 keys, BQ queries] as bf16 register fragments and x
  // the tile's [BQ, D] in shared memory, MN-major: in a 64-feature block,
  // 8-query atoms 1024 bytes apart (SBO), queries 16 kk on; in the chunks,
  // 8-query groups 128 bytes apart (LBO), chunks BQ * 16 apart (SBO);
  // issued and committed, not waited
  auto px = [&](float(&acc)[D / 2], uint32_t(&pa)[BQ / 16][4], const unsigned char* x) {
    wg::fence_operands(pa);
    wg::fence_operands(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < SW; ++cb)
        wg::mma_rs<64>(*reinterpret_cast<float(*)[32]>(acc + 32 * cb), pa[kk],
                       wg::desc_sw128(x + cb * BQ * 128 + kk * 2048, BQ * 128, 1024));
      if constexpr (CH > 0)
        wg::mma_rs<8 * CH>(*reinterpret_cast<float(*)[4 * CH]>(acc + 32 * SW), pa[kk],
                           wg::desc(x + SW * BQ * 128 + kk * 256, 128, BQ * 16));
    }
    wg::commit();
    wg::fence_operands(acc);
    wg::fence_operands(pa);
  };

  // Tile j: S^T and dP^T, P^T, dV += P^T dO while dS^T is formed, dK +=
  // dS^T Q; then the stage goes back to the producer (one arrival a warp).
  float sacc[BQ / 2], pacc[BQ / 2];
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const unsigned char* sq = stage_q(s);
    const unsigned char* so = stage_o(s);
    const float* ls = sl + s * 2 * BQ;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sk, sq);  // S^T
    abt(pacc, sv, so);  // dP^T
    wg::wait_one();     // S^T done
    wg::fence_operands(sacc);
    // P^T: the thread's element i is key row row0 + 8 ((i >> 1) & 1), query
    // column 8 (i >> 2) + 2 t + (i & 1) of the tile
    const int valid = t_len - j * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      sacc[i] = fa::exp2_approx(fmaf(sacc[i], scale_log2, -ls[col]));
    }
    if (valid < BQ) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) sacc[i] = 0.f;
    }
    if (rows_ragged) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        if (!row_ok[(i >> 1) & 1]) sacc[i] = 0.f;
    }
    fa::pack_p<BQ>(pa, sacc);
    px(dva, pa, so);  // dV += P^T dO, in flight while dS^T is formed
    wg::wait_one();   // dP^T done
    wg::fence_operands(pacc);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = (i >> 2) * 8 + 2 * t + (i & 1);
      pacc[i] = sacc[i] * (pacc[i] - ls[BQ + col]);
    }
    fa::pack_p<BQ>(dsa, pacc);
    px(dka, dsa, sq);  // dK += dS^T Q
    wg::wait_all();
    wg::fence_operands(dva);
    wg::fence_operands(dka);
    // the stage's tiles and slices are read
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const size_t off = ((size_t)bh * s_len + row0 + 8 * h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(dk + off + jj * 8 + 2 * t) =
          mma::pack(dka[4 * jj + 2 * h] * scale, dka[4 * jj + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + jj * 8 + 2 * t) =
          mma::pack(dva[4 * jj + 2 * h], dva[4 * jj + 2 * h + 1]);
    }
  }
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int n, int t_len, int s_len, float scale,
           cudaStream_t st) {
  using C = Cfg<D, WG>;
  Maps qm, km, vm, om;
  if (!make_maps<D>(&qm, q, n, t_len, C::kBQ) || !make_maps<D>(&om, dout, n, t_len, C::kBQ) ||
      !make_maps<D>(&km, k, n, s_len, C::kBK) || !make_maps<D>(&vm, v, n, s_len, C::kBK))
    return -2;
  // once per instantiation: allow dynamic shared memory above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_tma_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int s_blocks = (s_len + C::kBK - 1) / C::kBK;
  flash_bwd_dkv_tma_kernel<D, WG><<<n * s_blocks, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, om, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, s_len,
      s_blocks, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups (128 key rows) a block, or one (64) where S <= 64 and at
// D = 128, where two compiled to 168 registers with a spill.
template <int D>
int launch_keys(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int n, int t_len, int s_len, float scale,
                cudaStream_t st) {
  if constexpr (D == 128)
    return launch<D, 1>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
  else
    return s_len <= 64
               ? launch<D, 1>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st)
               : launch<D, 2>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
}

}  // namespace dkv

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
                         int s_blocks, float scale) {
  using G = Geometry<D>;
  __shared__ float4 sQ[G::BN * G::C4];
  __shared__ float4 sO[G::BN * G::C4];
  __shared__ float sL[G::BN];
  __shared__ float sD[G::BN];

  const int bh = blockIdx.x / s_blocks;
  const int sb = blockIdx.x % s_blocks;
  const int lane_g = threadIdx.x % G::TPR;
  const int row = sb * G::BM + threadIdx.x / G::TPR;
  const bool row_valid = row < s_len;

  const float* qb = q + (size_t)bh * t_len * D;
  const float* ob = dout + (size_t)bh * t_len * D;
  const float* lb = lse + (size_t)bh * t_len;
  const float* db = delta + (size_t)bh * t_len;
  const size_t row_off = ((size_t)bh * s_len + (row_valid ? row : 0)) * D;

  float4 kr[G::NC], vr[G::NC], dka[G::NC], dva[G::NC];
  load_row<D>(kr, k + row_off, row_valid, lane_g);
  load_row<D>(vr, v + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) {
    dka[c] = zero4();
    dva[c] = zero4();
  }

  for (int i0 = 0; i0 < t_len; i0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sQ, qb, i0, t_len);
    stage_tile<D>(sO, ob, i0, t_len);
    for (int i = threadIdx.x; i < G::BN; i += kThreads) {
      const bool ok = i0 + i < t_len;
      sL[i] = ok ? lb[i0 + i] : 0.f;
      sD[i] = ok ? db[i0 + i] : 0.f;
    }
    __syncthreads();
    const int n_valid = min(G::BN, t_len - i0);
#pragma unroll 2
    for (int i = 0; i < n_valid; ++i) {
      float4 qq[G::NC], oo[G::NC];
      load_srow<D>(qq, sQ + i * G::C4, lane_g);
      load_srow<D>(oo, sO + i * G::C4, lane_g);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        s = dot4(kr[c], qq[c], s);
        dp = dot4(vr[c], oo[c], dp);
      }
      row_sum2<G::TPR>(s, dp);
      const float p = row_valid ? expf(s * scale - sL[i]) : 0.f;
      const float ds = p * (dp - sD[i]);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        axpy4(p, oo[c], dva[c]);
        axpy4(ds, qq[c], dka[c]);
      }
    }
  }

  if (row_valid) {
    store_row<D>(dk + row_off, dka, scale, lane_g);
    store_row<D>(dv + row_off, dva, 1.f, lane_g);
  }
}

}  // namespace adt

#define ADT_LAUNCH_DKV_F32(D)                                                                \
  {                                                                                          \
    const int s_blocks = (s_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_bwd_dkv_f32_kernel<D><<<n * s_blocks, adt::kThreads, 0, st>>>(               \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,           \
        static_cast<float*>(dk), static_cast<float*>(dv), t_len, s_len, s_blocks, scale);    \
  }

// q, dout [N, T, D]; k, v, dk, dv [N, S, D]; lse, delta [N, T] float32;
// the bf16 tensors 16-byte aligned. -1 for a head dim without an
// instantiation.
extern "C" int adt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int n, int t_len, int s_len, int head_dim,
                                 int is_bf16, float scale, void* stream) {
  if (n == 0 || s_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t_len == 0) {  // no query: dk = dv = 0
    const size_t bytes = (size_t)n * s_len * head_dim * (is_bf16 ? 2 : 4);
    cudaMemsetAsync(dk, 0, bytes, st);
    cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    using adt::dkv::launch_keys;
    switch (head_dim) {
      case 16: return launch_keys<16>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
      case 32: return launch_keys<32>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
      case 64: return launch_keys<64>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
      case 128:
        return launch_keys<128>(q, k, v, dout, lse, delta, dk, dv, n, t_len, s_len, scale, st);
      default: return -1;
    }
  }
  ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DKV_F32);
  return static_cast<int>(cudaGetLastError());
}
