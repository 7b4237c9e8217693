// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_dq_kernel
// (driven by _flash_bwd): the FlashAttention-2 dQ pass. p is re-formed from
// the forward's saved logsumexp, p = exp(q k^T / sqrt(D) - lse), and
//   dq = (p * (dO v^T - delta)) k / sqrt(D),  delta = rowsum(dO * O)
// with delta computed by the caller, as the TPU path does.
//
// Bound on this card: operations. Three T x S x D products per head
// (logits, dP, dQ) against 3 T D + 2 S D elements read and T D written;
// the T S exponentials come next. A block keeps its query rows resident
// (Q, dO, the dq accumulator and the rows' lse and delta) and streams K
// and V: the forward with one more product and no online max. Neither p
// nor dS reaches device memory.
//
// bfloat16: two warpgroups on wgmma, fed by TMA
//   * tile: 128 query rows of one (batch, head) a block, 64 for each
//     warpgroup; up to 64 rows (the ADM 8x8 level) take a block of one
//     warpgroup, so that half a block does not idle. Q and dO are copied
//     into shared memory once by TMA, laid out as the forwards lay a head
//     (fa::Cols: each 64 features of a row one 128-byte-swizzled box;
//     D = 16 and 32 16-byte chunks in the no-swizzle core-matrix layout);
//     zero outside, so ragged T and S need no masking of the loads. Each
//     thread reads its two rows' lse log2(e) and delta once into registers
//     (a TMA row would need T a multiple of four floats).
//   * ring: K and V in 64-key tiles through two stages, refilled by the
//     last warp done with a stage (a shared-memory count), as flash_fwd.cu
//     does. A producer warp with three `full` / `empty` stages, as
//     flash_bwd_dkv.cu has, spilled at two blocks an SM (288 threads, 96
//     registers, 416 bytes) and took 2.15x the device time at (T 1024,
//     4 heads, batch 32); at one block an SM 1.25x (tools/kernel_ab.py
//     dq_producer, dq_producer_one_block).
//   * products, per tile and warpgroup: S = Q K^T and dP = dO V^T from
//     shared memory (m64n64k16, K-major), S first; P = 2^(S c - lse
//     log2(e)), c = scale log2(e), one FFMA and one MUFU.EX2 a logit as in
//     the forwards, where the mma.sync kernel this replaces took the
//     accurate expf, formed while dP runs; keys past S zeroed in the last
//     tile; dS = P (dP - delta), rounded to bf16 as the TPU kernel casts
//     it; dQ += dS K with dS as the register A operand (fa::pack_p) and K
//     read MN-major through the transpose bit, as the forwards read V. A
//     tile's products drain before its stage goes back (the next tile's S
//     and dP issued behind its dq product, with three stages, took 1.12x:
//     dq_issue_ahead). dq is multiplied by the scale once and stored in
//     bf16.
//   * registers: the S and dP accumulators (32 floats a thread each), dq
//     (D / 2) and dS's 16 bf16 fragments: 122 registers at D = 64, so two
//     blocks an SM up to D = 64 (one block measured no faster:
//     dq_one_block), one at D = 128 (154 registers); the one-warpgroup
//     block four (two at D = 128). 128-key tiles at one block an SM (186
//     registers) took 1.14x (dq_bn128).
//   This kernel takes about 0.104 ms of device time at (T 1024, 4 heads,
//   batch 32, D 64), 50 % of its 0.0521 ms operation bound. Every ratio
//   here is device time against this kernel in the same call, on an H100
//   80GB HBM3 at 700 W; PERF.md has the numbers.
// float32: float32 FMAs on the CUDA cores, one key at a time.
#include "flash_wgmma.cuh"

namespace adt {

namespace dq {

using fa::bf16;
using fa::Cols;
using fa::Maps;

constexpr float kLog2e = 1.4426950408889634f;

template <int D, int WG>
struct Cfg {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kWarps = 4 * WG;
  static constexpr int kBM = 64 * WG;  // query rows a block
  static constexpr int kBN = 64;       // keys a tile
  static constexpr int kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2) : (D >= 128 ? 2 : 4);
  static constexpr int kStages = 2;
  static constexpr int kQBytes = Cols<D>::bytes(kBM);     // Q (or dO) of the block
  static constexpr int kTileBytes = Cols<D>::bytes(kBN);  // a K (or V) tile
  // dynamic shared memory: up to 1 KB to align the swizzled tiles, Q, dO,
  // K and V of each stage (every tile a multiple of 1 KB), then the
  // mbarriers (q, full[]) and the stages' counts
  static constexpr int kSmem =
      1024 + 2 * kQBytes + kStages * 2 * kTileBytes + (1 + kStages) * 8 + 4 * kStages;
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "1 KB tiles");
  // kMinBlocks blocks share an SM's 228 KB (the system keeps 1 KB a block)
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "the blocks an SM holds");
};

template <int D, int WG>
__global__ void __launch_bounds__(Cfg<D, WG>::kThreads, Cfg<D, WG>::kMinBlocks)
    flash_bwd_dq_tma_kernel(const __grid_constant__ Maps q_map, const __grid_constant__ Maps k_map,
                            const __grid_constant__ Maps v_map, const __grid_constant__ Maps o_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int t_len, int s_len, int t_blocks, float scale,
                            float scale_log2) {
  using C = Cfg<D, WG>;
  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  constexpr int BM = C::kBM, BN = C::kBN, stages = C::kStages;
  constexpr int QB = C::kQBytes, TB = C::kTileBytes;
  // (aligned here by hand: the declared alignment of dynamic shared
  // memory is not promised)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sq = smem;
  unsigned char* so = smem + QB;
  auto stage_k = [&](int s) { return smem + 2 * QB + s * 2 * TB; };
  auto stage_v = [&](int s) { return smem + 2 * QB + s * 2 * TB + TB; };
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + 2 * QB + stages * 2 * TB);
  uint64_t* full = qbar + 1;
  unsigned* done = reinterpret_cast<unsigned*>(full + stages);  // warps done with a stage

  const int bh = blockIdx.x / t_blocks;
  const int r0 = (blockIdx.x - bh * t_blocks) * BM;
  const int n_tiles = (s_len + BN - 1) / BN;

  // key tile j into its stage
  auto issue = [&](int j) {
    const int s = j % stages;
    mbar_expect_tx(full + s, 2 * TB);
    fa::load_rows<D>(stage_k(s), k_map, BN, j * BN, bh, full + s);
    fa::load_rows<D>(stage_v(s), v_map, BN, j * BN, bh, full + s);
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
    mbar_expect_tx(qbar, 2 * QB);
    fa::load_rows<D>(sq, q_map, BM, r0, bh, qbar);
    fa::load_rows<D>(so, o_map, BM, r0, bh, qbar);
    for (int j = 0; j < stages && j < n_tiles; ++j) issue(j);
  }

  // each warpgroup: 64 query rows, its view of Q and dO 64 rows into each
  // block and chunk; the thread's rows row0 and row0 + 8, their lse
  // log2(e) and delta (0 past T: padded rows come in as zeros, so their
  // dS is 0)
  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = r0 + wgi * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const bool ok = r < t_len;
    lse2[h] = ok ? lse[(size_t)bh * t_len + r] * kLog2e : 0.f;
    dlt[h] = ok ? delta[(size_t)bh * t_len + r] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  // Every wgmma batch is fenced on both sides in its operands (else ptxas
  // may move other instructions into it and serialise the pipeline).
  // acc = A B^T for A the warpgroup's 64 rows of Q (or dO), a, and B the
  // tile's 64 keys of K (or V), b, both K-major: four k16 steps a
  // 64-feature block (32 bytes into its swizzled rows), one a pair of
  // chunks; issued and committed, not waited
  auto abt = [&](float(&acc)[BN / 2], const unsigned char* a, const unsigned char* b) {
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint64_t da, db;
      if (kk < 4 * SW) {
        const int cb = kk / 4, off = (kk % 4) * 32;
        da = wg::desc_sw128(a + cb * BM * 128 + wgi * 64 * 128 + off, 0, 1024);
        db = wg::desc_sw128(b + cb * BN * 128 + off, 0, 1024);
      } else {
        const int c = 2 * (kk - 4 * SW);
        da = wg::desc(a + SW * BM * 128 + c * BM * 16 + wgi * 64 * 16, BM * 16, 128);
        db = wg::desc(b + SW * BN * 128 + c * BN * 16, BN * 16, 128);
      }
      if (kk == 0)
        wg::mma_first<BN>(acc, da, db);
      else
        wg::mma<BN>(acc, da, db);
    }
    wg::commit();
    wg::fence_operands(acc);
  };
  // dq += dS K for dS [64 rows, BN keys] as bf16 register fragments and K
  // the tile's [BN, D] in shared memory, MN-major: in a 64-feature block,
  // 8-key atoms 1024 bytes apart (SBO), keys 16 kk on; in the chunks,
  // 8-key groups 128 bytes apart (LBO), chunks BN * 16 apart (SBO);
  // issued and committed, not waited
  auto dsk = [&](uint32_t(&pa)[BN / 16][4], const unsigned char* x) {
    wg::fence_operands(pa);
    wg::fence_operands(dqa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < SW; ++cb)
        wg::mma_rs<64>(*reinterpret_cast<float(*)[32]>(dqa + 32 * cb), pa[kk],
                       wg::desc_sw128(x + cb * BN * 128 + kk * 2048, BN * 128, 1024));
      if constexpr (CH > 0)
        wg::mma_rs<8 * CH>(*reinterpret_cast<float(*)[4 * CH]>(dqa + 32 * SW), pa[kk],
                           wg::desc(x + SW * BN * 128 + kk * 256, 128, BN * 16));
    }
    wg::commit();
    wg::fence_operands(dqa);
    wg::fence_operands(pa);
  };

  // Tile j: S and dP, P while dP runs, dS, dq += dS K; the last of the
  // block's warps done with a tile refills its stage with the tile
  // `stages` later.
  float sacc[BN / 2], pacc[BN / 2];
  uint32_t dsa[BN / 16][4];
  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sq, stage_k(s));  // S
    abt(pacc, so, stage_v(s));  // dP
    wg::wait_one();             // S done
    wg::fence_operands(sacc);
    // P: the thread's element i is row row0 + 8 ((i >> 1) & 1), key
    // 8 (i >> 2) + 2 t + (i & 1) of the tile
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      sacc[i] = fa::exp2_approx(fmaf(sacc[i], scale_log2, -lse2[(i >> 1) & 1]));
    const int valid = s_len - j * BN;
    if (valid < BN) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) sacc[i] = 0.f;
    }
    wg::wait_all();  // dP done
    wg::fence_operands(pacc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) pacc[i] = sacc[i] * (pacc[i] - dlt[(i >> 1) & 1]);
    fa::pack_p<BN>(dsa, pacc);
    dsk(dsa, stage_k(s));
    wg::wait_all();
    wg::fence_operands(dqa);
    wg::fence_operands(dsa);
    if ((threadIdx.x & 31) == 0) {
      // the stage's count reaches kWarps u after its u-th tile
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == C::kWarps * (j / stages) + C::kWarps - 1 &&
          j + stages < n_tiles)
        issue(j + stages);
    }
  }

  const float mul[2] = {scale, scale};
  fa::store_o<D / 2>(dq + (size_t)bh * t_len * D, dqa, D, row0, t_len, D, mul, t);
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int n, int t_len, int s_len, float scale,
           cudaStream_t st) {
  using C = Cfg<D, WG>;
  Maps qm, km, vm, om;
  if (!fa::make_maps<D>(&qm, q, n, t_len, C::kBM) ||
      !fa::make_maps<D>(&om, dout, n, t_len, C::kBM) ||
      !fa::make_maps<D>(&km, k, n, s_len, C::kBN) || !fa::make_maps<D>(&vm, v, n, s_len, C::kBN))
    return -2;
  // once per instantiation: allow dynamic shared memory above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tma_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int t_blocks = (t_len + C::kBM - 1) / C::kBM;
  flash_bwd_dq_tma_kernel<D, WG><<<n * t_blocks, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, om, lse, delta, static_cast<bf16*>(dq), t_len, s_len, t_blocks, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// up to 64 query rows: the one-warpgroup block
template <int D>
int launch_rows(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, int n, int t_len, int s_len, float scale,
                cudaStream_t st) {
  return t_len <= 64 ? launch<D, 1>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st)
                     : launch<D, 2>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st);
}

}  // namespace dq

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int t_len, int s_len, int t_blocks, float scale) {
  using G = Geometry<D>;
  __shared__ float4 sK[G::BN * G::C4];
  __shared__ float4 sV[G::BN * G::C4];

  const int bh = blockIdx.x / t_blocks;
  const int tb = blockIdx.x % t_blocks;
  const int lane_g = threadIdx.x % G::TPR;
  const int row = tb * G::BM + threadIdx.x / G::TPR;
  const bool row_valid = row < t_len;

  const float* kb = k + (size_t)bh * s_len * D;
  const float* vb = v + (size_t)bh * s_len * D;
  const size_t row_off = ((size_t)bh * t_len + (row_valid ? row : 0)) * D;
  const size_t stat_off = (size_t)bh * t_len + (row_valid ? row : 0);
  const float row_lse = row_valid ? lse[stat_off] : 0.f;
  const float row_delta = row_valid ? delta[stat_off] : 0.f;

  float4 qr[G::NC], dor[G::NC], acc[G::NC];
  load_row<D>(qr, q + row_off, row_valid, lane_g);
  load_row<D>(dor, dout + row_off, row_valid, lane_g);
#pragma unroll
  for (int c = 0; c < G::NC; ++c) acc[c] = zero4();

  for (int j0 = 0; j0 < s_len; j0 += G::BN) {
    __syncthreads();
    stage_tile<D>(sK, kb, j0, s_len);
    stage_tile<D>(sV, vb, j0, s_len);
    __syncthreads();
    const int n_valid = min(G::BN, s_len - j0);
#pragma unroll 2
    for (int j = 0; j < n_valid; ++j) {
      float4 kk[G::NC], vv[G::NC];
      load_srow<D>(kk, sK + j * G::C4, lane_g);
      load_srow<D>(vv, sV + j * G::C4, lane_g);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < G::NC; ++c) {
        s = dot4(qr[c], kk[c], s);
        dp = dot4(dor[c], vv[c], dp);
      }
      row_sum2<G::TPR>(s, dp);
      const float ds = expf(s * scale - row_lse) * (dp - row_delta);
#pragma unroll
      for (int c = 0; c < G::NC; ++c) axpy4(ds, kk[c], acc[c]);
    }
  }

  if (row_valid) store_row<D>(dq + row_off, acc, scale, lane_g);
}

}  // namespace adt

#define ADT_LAUNCH_DQ_F32(D)                                                                 \
  {                                                                                          \
    const int t_blocks = (t_len + adt::Geometry<D>::BM - 1) / adt::Geometry<D>::BM;         \
    adt::flash_bwd_dq_f32_kernel<D><<<n * t_blocks, adt::kThreads, 0, st>>>(                \
        static_cast<const float*>(q), static_cast<const float*>(k),                          \
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,           \
        static_cast<float*>(dq), t_len, s_len, t_blocks, scale);                             \
  }

// q, dout, dq [N, T, D]; k, v [N, S, D]; lse, delta [N, T] float32; the
// bf16 tensors 16-byte aligned. -1 for a head dim without an
// instantiation.
extern "C" int adt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int n,
                                int t_len, int s_len, int head_dim, int is_bf16, float scale,
                                void* stream) {
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_len == 0) {  // no key: dq = 0
    cudaMemsetAsync(dq, 0, (size_t)n * t_len * head_dim * (is_bf16 ? 2 : 4), st);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    using adt::dq::launch_rows;
    switch (head_dim) {
      case 16: return launch_rows<16>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st);
      case 32: return launch_rows<32>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st);
      case 64: return launch_rows<64>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st);
      case 128:
        return launch_rows<128>(q, k, v, dout, lse, delta, dq, n, t_len, s_len, scale, st);
      default: return -1;
    }
  }
  ADT_DISPATCH_D(head_dim, ADT_LAUNCH_DQ_F32);
  return static_cast<int>(cudaGetLastError());
}
