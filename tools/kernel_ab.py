#!/usr/bin/env python3
"""A/B of a variant of a pipelined flash kernel (a forward, the dQ or the
dK/dV backward) or of the GroupNorm backward against the tree's kernel, on
one NVIDIA GPU.

    python3 tools/kernel_ab.py VARIANT

VARIANT names an entry of ``VARIANTS`` below: a kernel source stem and
the exact text replacements that turn ``autodiffusion_tpu_torch/ops/csrc``
into the variant. The script applies them to a copy of the sources under
``autodiffusion_tpu_torch/ops/_build/variants/`` (gitignored), builds the
stem there with the package's nvcc flags and prints ptxas's registers and
spills for it. A worker process then checks the variant against the
kernel's plain twin at the ring-edge shapes of tests/test_torch_cuda.py,
within chip_smoke.py's bf16 limit, and workers time the tree's kernel and
the variant at the Stable Diffusion (and ADM) sites (chip_smoke.cuda_ms,
one-call CUDA-event medians; the dQ and dK/dV kernels and the GroupNorm
backward at the ADM-64 classifier's sites, beside SDPA's whole backward
and F.group_norm's backward, with their device times, chip_smoke.device_ms)
in the order tree, variant, variant, tree. Each library runs in its own
process: two libraries holding the same kernels in one process fail their
launches.

The variants kept here are designs that were measured and not adopted;
``PERF.md`` §6 holds their numbers.
"""

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)



def _wgmma_rs(n):
    """wgmma.cuh's register-A m64nNk16 form (d += A B, B MN-major in shared
    memory) at width n, for a variant that needs a width the tree's kernels
    do not instantiate."""
    acc = n // 2
    regs = ", ".join(f"%{i}" for i in range(acc))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(acc))
    return f"""__device__ __forceinline__ void wgmma_rs_n{n}(float (&d)[{acc}], const uint32_t (&a)[4], uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"
      "{regs}"
      "}}, {{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, p, 1, 1, 1;\\n}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}}

"""


# the edits of flash_bwd_dq.cu that give its ring a producer warp (the
# first edit sets the blocks an SM: three stages leave room for three
# one-warpgroup blocks)
_DQ_PRODUCER = [
    ("""  static constexpr int kThreads = 128 * WG;
  static constexpr int kWarps = 4 * WG;
  static constexpr int kBM = 64 * WG;  // query rows a block
  static constexpr int kBN = 64;       // keys a tile
  static constexpr int kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2) : (D >= 128 ? 2 : 4);
  static constexpr int kStages = 2;""",
     """  static constexpr int kThreads = 128 * WG + 32;  // + the producer warp
  static constexpr int kWarps = 4 * WG;
  static constexpr int kBM = 64 * WG;  // query rows a block
  static constexpr int kBN = 64;       // keys a tile
  static constexpr int kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2) : (D >= 128 ? 1 : 3);
  static constexpr int kStages = 3;"""),
    ("(1 + kStages) * 8 + 4 * kStages;", "(1 + 2 * kStages) * 8;"),
    ("unsigned* done = reinterpret_cast<unsigned*>(full + stages);  // warps done with a stage",
     "uint64_t* empty = full + stages;"),
    ("""      mbar_init(full + s, 1);
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
  }""",
     """      mbar_init(full + s, 1);
      mbar_init(empty + s, C::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128 * WG) {
    // the producer warp: Q and dO once, then the ring
    if (threadIdx.x == 128 * WG) {
      mbar_expect_tx(qbar, 2 * QB);
      fa::load_rows<D>(sq, q_map, BM, r0, bh, qbar);
      fa::load_rows<D>(so, o_map, BM, r0, bh, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= stages) mbar_wait(empty + j % stages, (j / stages - 1) & 1);
        issue(j);
      }
    }
    return;
  }"""),
    ("""    if ((threadIdx.x & 31) == 0) {
      // the stage's count reaches kWarps u after its u-th tile
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == C::kWarps * (j / stages) + C::kWarps - 1 &&
          j + stages < n_tiles)
        issue(j + stages);
    }""",
     """    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);"""),
]

# name -> (source stem, {file: [(old, new), ...]}); each old text must
# occur exactly once in the tree's file
VARIANTS = {
    # D = 80 as ten no-swizzle 16-byte chunks (the packed kernel's layout:
    # one TMA box a chunk, one m64n80 P V product) instead of one
    # 128-byte-swizzled 64-feature box and two chunks
    "fwd_d80_chunks": ("flash_fwd", {
        "flash_wgmma.cuh": [(
            """  static constexpr int SW = D / 64;
  static constexpr int CH = (D % 64) / 8;""",
            """  static constexpr int SW = D == 80 ? 0 : D / 64;
  static constexpr int CH = (D - 64 * SW) / 8;""")],
        "wgmma.cuh": [
            ("// d += A B for one m64n256k16 step: A bf16 in registers",
             _wgmma_rs(80)
             + "// d += A B for one m64n256k16 step: A bf16 in registers"),
            ("N == 64 || N == 256,", "N == 64 || N == 80 || N == 256,"),
            ("    wgmma_rs_n64(d, a, db);\n",
             "    wgmma_rs_n64(d, a, db);\n  else if constexpr (N == 80)\n"
             "    wgmma_rs_n80(d, a, db);\n")]}),
    # D = 80 with 128-key tiles (as D <= 64), two blocks an SM (if ptxas
    # fits the S and O accumulators in 128 registers) or one
    "fwd_d80_bn128": ("flash_fwd", {"flash_fwd.cu": [(
        "static constexpr int kBN = (WG == 2 && D <= 64) ? 128 : 64;",
        "static constexpr int kBN = (WG == 2 && D <= 80) ? 128 : 64;")]}),
    # a ring of up to four stages (one a key tile, as many as the blocks
    # an SM allow; the mbarriers in the 1 KB alignment gap where it holds
    # them, so that D = 64 takes three), instead of the tree's two
    "fwd_deep_ring": ("flash_fwd", {"flash_fwd.cu": [
        ("""  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes + 32;
  // kMinBlocks blocks share an SM's 228 KB (the system keeps 1 KB a block)
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "the blocks an SM holds");""",
         """  static constexpr int alloc(int stages) { return 1024 + kQBytes + stages * 2 * kTileBytes; }
  static constexpr bool fits(int stages) { return kMinBlocks * (alloc(stages) + 1024) <= 233472; }
  static constexpr int ring_stages(int s_len) {
    const int tiles = (s_len + kBN - 1) / kBN;
    int stages = tiles < 1 ? 1 : tiles > 4 ? 4 : tiles;
    while (stages > 1 && !fits(stages)) --stages;
    return stages;
  }"""),
        ("""int t_tiles,
                         float scale, float scale_log2) {""",
         """int t_tiles,
                         int stages, float scale, float scale_log2) {"""),
        ("constexpr int kBM = C::kBM, kBN = C::kBN, stages = C::kStages;",
         "constexpr int kBM = C::kBM, kBN = C::kBN;"),
        ("""  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);""",
         """  const uint32_t gap = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + gap;
  unsigned char* meta = gap >= 64 ? smem_raw : smem + QB + stages * 2 * TB;"""),
        ("uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + QB + stages * 2 * TB);",
         "uint64_t* qbar = reinterpret_cast<uint64_t*>(meta);"),
        ("unsigned* done = reinterpret_cast<unsigned*>(full + stages);",
         "unsigned* done = reinterpret_cast<unsigned*>(full + 4);"),
        ("""  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  // [B][L][H D] bf16""",
         """  constexpr int SW = Cols<D>::SW, CH = Cols<D>::CH;
  const int stages = C::ring_stages(s_len);
  // [B][L][H D] bf16"""),
        ("C::kSmem, st>>>(", "C::alloc(stages), st>>>("),
        ("""t_tiles, scale,
      scale * 1.4426950408889634f);""",
         """t_tiles, stages,
      scale, scale * 1.4426950408889634f);""")]}),
    "fwd_d80_bn128_one_block": ("flash_fwd", {"flash_fwd.cu": [
        ("static constexpr int kBN = (WG == 2 && D <= 64) ? 128 : 64;",
         "static constexpr int kBN = (WG == 2 && D <= 80) ? 128 : 64;"),
        ("WG == 2 ? (D >= 128 ? 1 : 2)", "WG == 2 ? (D >= 80 ? 1 : 2)")]}),
    # the two consumer warpgroups of a block take turns on the tensor
    # cores (FlashAttention-3's ping-pong): warpgroup w issues P V of tile
    # j - 1 and S = Q K^T of tile j on named barrier 1 + w, which the
    # other opens once it has issued its own, so that one's softmax runs
    # under the other's products
    "packed_pingpong": ("flash_fwd_packed", {"flash_fwd_packed.cu": [(
        """  for (int j = 0; j < n_tiles; ++j) {
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
  }""",
        """  if (wgi == 1) bar_arrive(1, fa::kThreads);
  for (int j = 0; j <= n_tiles; ++j) {
    if (j < n_tiles) mbar_wait(full + j % stages, (j / stages) & 1);
    bar_sync(1 + wgi, fa::kThreads);
    if (j > 0) pv(pa, (j - 1) % stages);
    if (j < n_tiles) qk(sacc, j % stages);
    if (wgi == 0 || j < n_tiles) bar_arrive(2 - wgi, fa::kThreads);
    wg::wait_all();
    wg::fence_operands(oacc);
    wg::fence_operands(pa);
    wg::fence_operands(sacc);
    if (j > 0 && lane == 0) {
      const int u = j - 1, s = u % stages;
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == 8u * (u / stages) + 7u && u + stages < n_tiles)
        issue(u + stages);
    }
    if (j < n_tiles) {
      const int valid = s_len - j * kBN;
      float alpha[2];
      fa::online_softmax<kBN>(sacc, m, l, alpha, valid, valid < kBN, scale_log2, t);
      fa::rescale(oacc, alpha);
      fa::pack_p<kBN>(pa, sacc);
    }
  }""")]}),
    # a producer warpgroup issues every copy and gives its registers to
    # the two consumers (setmaxnreg.dec 40 / .inc 232 at 384 threads);
    # the consumers release K and V stages on mbarriers of their own and
    # exchange their partial logits behind a 256-thread named barrier
    # the dK/dV kernel issuing the next query tile's S^T and dP^T behind
    # the tile's dK product (and handing the stage back a tile later)
    # instead of draining its products at the end of every tile
    "dkv_issue_ahead": ("flash_bwd_dkv", {"flash_bwd_dkv.cu": [
        ("""  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const unsigned char* sq = stage_q(s);
    const unsigned char* so = stage_o(s);
    const float* ls = sl + s * 2 * BQ;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sk, sq);  // S^T
    abt(pacc, sv, so);  // dP^T
    wg::wait_one();     // S^T done
    wg::fence_operands(sacc);""",
         """  auto issue = [&](int j) {
    const int s = j % stages;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sk, stage_q(s));
    abt(pacc, sv, stage_o(s));
  };
  mbar_wait(kvbar, 0);
  if (n_tiles > 0) issue(0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const unsigned char* sq = stage_q(s);
    const unsigned char* so = stage_o(s);
    const float* ls = sl + s * 2 * BQ;
    wg::wait_one();
    wg::fence_operands(sacc);
    wg::fence_operands(dka);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (j - 1) % stages);
    }"""),
        ("""    px(dka, dsa, sq);  // dK += dS^T Q
    wg::wait_all();
    wg::fence_operands(dva);
    wg::fence_operands(dka);
    // the stage's tiles and slices are read
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }""",
         """    px(dka, dsa, sq);  // dK += dS^T Q
    if (j + 1 < n_tiles) issue(j + 1);
  }
  wg::wait_all();
  wg::fence_operands(dva);
  wg::fence_operands(dka);""")]}),
    # the dK/dV kernel's ring at two and at four stages (the tree: three)
    "dkv_two_stages": ("flash_bwd_dkv", {"flash_bwd_dkv.cu": [(
        "  static constexpr int kStages = 3;", "  static constexpr int kStages = 2;")]}),
    "dkv_four_stages": ("flash_bwd_dkv", {"flash_bwd_dkv.cu": [(
        "  static constexpr int kStages = 3;", "  static constexpr int kStages = 4;")]}),
    # the dQ kernel's ring fed by a producer warp beside the two
    # warpgroups, three stages with `full` and `empty` mbarriers (as
    # flash_bwd_dkv.cu), instead of two stages refilled by the last warp
    # done with one
    "dq_producer": ("flash_bwd_dq", {"flash_bwd_dq.cu": _DQ_PRODUCER}),
    # ... and with one block an SM (about 113 registers a thread for two
    # blocks of 288 threads)
    "dq_producer_one_block": ("flash_bwd_dq", {"flash_bwd_dq.cu": _DQ_PRODUCER[:1] + [(
        "(D >= 128 ? 1 : 2) : (D >= 128 ? 1 : 3)", "1 : (D >= 128 ? 1 : 3)")]
        + _DQ_PRODUCER[1:]}),
    # the dQ kernel's two-warpgroup block at one block an SM (255 registers
    # a thread) instead of two (128)
    "dq_one_block": ("flash_bwd_dq", {"flash_bwd_dq.cu": [(
        "kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2)", "kMinBlocks = WG == 2 ? 1")]}),
    # the dQ kernel issuing the next tile's S and dP behind the tile's dq
    # product (and handing the stage back a tile later, so three stages)
    # instead of draining its products at the end of every tile
    "dq_issue_ahead": ("flash_bwd_dq", {"flash_bwd_dq.cu": [
        ("(D >= 128 ? 2 : 4);\n  static constexpr int kStages = 2;",
         "(D >= 128 ? 1 : 3);\n  static constexpr int kStages = 3;"),
        ("""  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sq, stage_k(s));  // S
    abt(pacc, so, stage_v(s));  // dP
    wg::wait_one();             // S done
    wg::fence_operands(sacc);""",
         """  auto release = [&](int j) {
    const int s = j % stages;
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == C::kWarps * (j / stages) + C::kWarps - 1 &&
          j + stages < n_tiles)
        issue(j + stages);
    }
  };
  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    mbar_wait(full + s, (j / stages) & 1);
    abt(sacc, sq, stage_k(s));  // S
    abt(pacc, so, stage_v(s));  // dP
    wg::wait_one();             // S done, and tile j - 1's dq product
    wg::fence_operands(sacc);
    wg::fence_operands(dqa);
    if (j > 0) release(j - 1);"""),
        ("""    dsk(dsa, stage_k(s));
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
  }""",
         """    dsk(dsa, stage_k(s));
  }
  wg::wait_all();
  wg::fence_operands(dqa);""")]}),
    # the dQ kernel's two-warpgroup block on 128-key tiles (m64n128 logit
    # products, as flash_fwd.cu up to D = 64), one block an SM
    "dq_bn128": ("flash_bwd_dq", {"flash_bwd_dq.cu": [
        ("static constexpr int kBN = 64;       // keys a tile",
         "static constexpr int kBN = WG == 2 && D <= 64 ? 128 : 64;"),
        ("kMinBlocks = WG == 2 ? (D >= 128 ? 1 : 2)", "kMinBlocks = WG == 2 ? 1")]}),
    # the GroupNorm backward's sums pass unrolled four times (more 16-byte
    # loads of x and g in flight a lane) instead of twice
    "gnb_unroll4": ("group_norm_bwd", {"group_norm_bwd.cu": [(
        """#pragma unroll 2
  for (int i = sp.head_end + lane * N; i < sp.vec_end; i += 32 * N) {
    const uint4 xu""",
        """#pragma unroll 4
  for (int i = sp.head_end + lane * N; i < sp.vec_end; i += 32 * N) {
    const uint4 xu""")]}),
    # the GroupNorm backward staging a resident run's x into shared memory
    # with 16-byte cp.async copies, all of it before the sums, instead of
    # keeping what the sums' pass reads through registers
    "gnb_cp_async": ("group_norm_bwd", {"group_norm_bwd.cu": [
        ("// Shared memory ahead of the run: the channel terms",
         """__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int n) {
  constexpr int N = Vec<T>::N;
  const Split<T> sp(src, 0, n);
  for (int i = threadIdx.x; i < sp.head_end; i += blockDim.x) dst[i] = src[i];
  for (int i = sp.vec_end + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  for (int i = sp.head_end + threadIdx.x * N; i < sp.vec_end; i += blockDim.x * N)
    cp_async16(dst + i, src + i);
}

// Shared memory ahead of the run: the channel terms"""),
        ("""    du = reinterpret_cast<float*>(base + run_bytes(n, sizeof(T))) + mis;
  }""",
         """    du = reinterpret_cast<float*>(base + run_bytes(n, sizeof(T))) + mis;
    copy_run(sx, xs, n);
    xs = sx;
  }"""),
        ("""  }
  __syncthreads();

  // the pieces' sums""",
         """  }
  if constexpr (kResident) asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncthreads();

  // the pieces' sums""")]}),
    "wide_producer": ("flash_fwd_wide", {
        "flash_fwd_wide.cu": [
            ("+ kXBytes + (1 + 2 * kStages) * 8;",
             "+ kXBytes + (1 + 4 * kStages) * 8;\n"
             "constexpr int kThreadsWS = 3 * 128;"),
            ("__global__ void __launch_bounds__(fa::kThreads, 1)",
             "__global__ void __launch_bounds__(kThreadsWS, 1)"),
            ("  uint64_t* vfull = kfull + kStages;\n",
             "  uint64_t* vfull = kfull + kStages;\n"
             "  uint64_t* kempty = vfull + kStages;\n"
             "  uint64_t* vempty = kempty + kStages;\n"),
            ("  const int c = threadIdx.x >> 7, lt = threadIdx.x & 127;",
             "  const int wgi = threadIdx.x >> 7, lt = threadIdx.x & 127;"),
            ("    for (int s = 0; s < 2 * kStages; ++s) mbar_init(kfull + s, 1);",
             """    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(kempty + s, 1);
      mbar_init(vempty + s, 8);
    }"""),
            ("""  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kQBytes);
    for (int cb = 0; cb < kD / kBlockCols; ++cb)
      tma_load_3d(sq + cb * kBM * 128, &qmap, cb * kBlockCols, r0, bh, qbar);
    issue_k(0);
    if (n_tiles > 1) issue_k(1);
    issue_v(0);
  }
""",
             """  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");
    if (lt == 0) {
      mbar_expect_tx(qbar, kQBytes);
      for (int cb = 0; cb < kD / kBlockCols; ++cb)
        tma_load_3d(sq + cb * kBM * 128, &qmap, cb * kBlockCols, r0, bh, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, u = j / kStages;
        if (u > 0) mbar_wait(kempty + s, (u - 1) & 1);
        issue_k(j);
        if (u > 0) mbar_wait(vempty + s, (u - 1) & 1);
        issue_v(j);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");
  const int c = wgi - 1;
"""),
            ("""    __syncthreads();
    // past the barrier both warpgroups are done with K(j) and V(j - 1):
    // their stages take K(j + 2) and V(j + 1)
    if (threadIdx.x == 0) {
      if (j + 2 < n_tiles) issue_k(j + 2);
      if (j + 1 < n_tiles) issue_v(j + 1);
    }""",
             """    bar_sync(1, 2 * 128);
    if (c == 0 && lt == 0) mbar_arrive(kempty + s);"""),
            ("""    wg::wait_all();
    wg::fence_operands(oacc);
  }
""",
             """    wg::wait_all();
    wg::fence_operands(oacc);
    if (lane == 0) mbar_arrive(vempty + s);
  }
"""),
            ("<<<n * t_tiles, adt::fa::kThreads, kSmem, st>>>",
             "<<<n * t_tiles, kThreadsWS, kSmem, st>>>"),
        ]}),
}

# (B, heads, D, T, S) checked; the SD sites timed (the UNet's batch 16,
# the decoder's 8), and for flash_fwd two ADM sites ([N, T, 64] as N
# samples of one head)
CHECK = {"flash_fwd": [(2, 8, 80, 300, 77), (2, 8, 80, 1000, 1000),
                       (3, 8, 80, 64, 130), (16, 8, 80, 1024, 1024),
                       (16, 8, 80, 1024, 77)],
         "flash_fwd_packed": [(2, 8, 40, 300, 300), (2, 8, 40, 1000, 1000),
                              (3, 5, 40, 257, 77), (2, 4, 40, 333, 1000),
                              (2, 8, 40, 1000, 77), (16, 8, 40, 4096, 4096),
                              (16, 8, 40, 4096, 77)],
         "flash_fwd_wide": [(2, 1, 512, 700, 650), (2, 1, 512, 64, 130),
                            (1, 1, 512, 4096, 4096), (8, 1, 512, 4096, 4096)]}
# the backward kernels: (N, D, T, S) of [N, T, D] q, dO and [N, S, D] k, v
CHECK["flash_bwd_dkv"] = [(10, 64, 1000, 300), (10, 64, 77, 50),
                          (10, 64, 130, 129), (10, 64, 1000, 64)]
CHECK["flash_bwd_dq"] = [(10, 64, 1000, 300), (10, 64, 77, 50),
                         (10, 64, 130, 129), (10, 64, 40, 300),
                         (10, 64, 300, 50), (10, 128, 200, 129),
                         (10, 32, 130, 300), (10, 16, 40, 77)]
# the classifier's backward sites at batch 32, and the UNet's (1024, 6)
TIME = {"flash_bwd_dkv": [(128, 64, 1024, 1024), (192, 64, 1024, 1024),
                          (192, 64, 256, 256), (256, 64, 64, 64)],
        "flash_fwd": [(192, 1, 64, 1024, 1024), (288, 1, 64, 256, 256),
                      (16, 8, 80, 1024, 1024), (16, 8, 80, 1024, 77)],
        "flash_fwd_packed": [(16, 8, 40, 4096, 4096), (16, 8, 40, 4096, 77)],
        "flash_fwd_wide": [(8, 1, 512, 4096, 4096)]}
TIME["flash_bwd_dq"] = TIME["flash_bwd_dkv"]


def patch(name, out):
    """Copy the kernel sources to ``out``/csrc with the variant's edits."""
    from autodiffusion_tpu_torch.ops import _build

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, os.path.join(out, "csrc"))
    for fname, pairs in VARIANTS[name][1].items():
        path = os.path.join(out, "csrc", fname)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {fname} no longer holds the text "
                                 f"the variant replaces: {old[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)


def build(name):
    """The variant's library, built from a patched copy of the sources."""
    from autodiffusion_tpu_torch.ops import _build

    stem = VARIANTS[name][0]
    out = os.path.join(_build.BUILD_DIR, "variants", name)
    patch(name, out)
    so = os.path.join(out, stem + ".so")
    r = subprocess.run([_build._nvcc(), *_build._flags(), "-o", so,
                        os.path.join(out, "csrc", stem + ".cu")],
                       capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{(r.stdout + r.stderr)[-4000:]}")
    # ptxas: registers and spills of the bf16 kernel (its name ends the
    # "Function properties" line; the float32 kernel is left out)
    name_re = re.compile(r"Function properties for (\S+)")
    kernel = None
    for line in (r.stdout + r.stderr).splitlines():
        m = name_re.search(line)
        if m:
            kernel = m.group(1)
        elif kernel and "f32" not in kernel and (
                "spill" in line or "Used" in line):
            print(f"ptxas {kernel[:60]}: {line.strip()}", flush=True)
    return so


def worker(lib, stem, mode):
    """Check (mode "check") or time (mode "time") one library's kernel;
    prints one JSON line."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from autodiffusion_tpu_torch.ops import _build
    from autodiffusion_tpu_torch.ops.flash_attention import (
        flash_fwd_packed_plain, flash_fwd_plain)

    if lib == "tree":
        fn = getattr(_build.library(stem), _build.SOURCES[stem][0])
    else:
        fn = getattr(ctypes.CDLL(lib), _build.SOURCES[stem][0])
        fn.argtypes, fn.restype = _build.SOURCES[stem][1], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call(q, k, v, heads, d):
        b, t, _ = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(b * heads, t, device="cuda")
        dims = {"flash_fwd_packed": (b, heads, t, k.shape[1], d, 1, 0),
                "flash_fwd": (b, heads, t, k.shape[1], d, 1)}.get(
                    stem, (b, t, k.shape[1], d, 1))
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *dims, 1 / math.sqrt(d), stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return o, lse

    out = {}
    work = {"flash_bwd_dq": dq_worker, "flash_bwd_dkv": dkv_worker,
            "group_norm_bwd": gnb_worker}.get(stem)
    if work:
        print(json.dumps(work(fn, stream, gen, mode)), flush=True)
        return
    for b, heads, d, t, s in (CHECK if mode == "check" else TIME)[stem]:
        q, k, v = (torch.randn(b, n, heads * d, generator=gen,
                               device="cuda").bfloat16() for n in (t, s, s))
        key = f"{b}x{heads}x{d} T{t} S{s}"
        if mode == "check":
            o, lse = call(q, k, v, heads, d)
            if stem != "flash_fwd_wide":
                wo, wl = flash_fwd_packed_plain(q, k, v, heads)
            else:
                wo, wl = flash_fwd_plain(q, k, v)
            _, share = cs.compare(o, wo, "bfloat16")
            lse_err = float((lse - wl).abs().max())
            out[key] = dict(share_of_limit=share, lse_err=lse_err)
            if share > 1 or lse_err > 2e-3:
                raise AssertionError(f"{key}: disagrees with the twin")
        else:
            qh, kh, vh = (z.reshape(b, -1, heads, d).transpose(1, 2)
                          for z in (q, k, v))
            out[key] = dict(
                ms=cs.cuda_ms(lambda: call(q, k, v, heads, d)),
                sdpa_ms=cs.cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh)))
    print(json.dumps(out), flush=True)


def dkv_worker(fn, stream, gen, mode):
    """The dK/dV kernel's check against its twin, or its timing beside
    SDPA's whole backward (dq, dk and dv) on the same [B, H, T, D]."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from autodiffusion_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_plain, flash_fwd_plain)

    out = {}
    for n, d, t, s in (CHECK if mode == "check" else TIME)["flash_bwd_dkv"]:
        q, do = (torch.randn(n, t, d, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(n, s, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = flash_fwd_plain(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), n, t, s, d, 1, 1 / math.sqrt(d), stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        key = f"{n}x{d} T{t} S{s}"
        if mode == "check":
            call()
            wk, wv = flash_bwd_dkv_plain(q, k, v, do, lse, delta)
            share = max(cs.compare(dk, wk, "bfloat16")[1],
                        cs.compare(dv, wv, "bfloat16")[1])
            out[key] = dict(share_of_limit=share, lse_err=0.0)
            if share > 1:
                raise AssertionError(f"{key}: disagrees with the twin")
        else:
            b = n // 8 if n % 8 == 0 else n
            qh, kh, vh, gh = (z.reshape(b, -1, z.shape[1], d).detach()
                              .requires_grad_(z is not do)
                              for z in (q, k, v, do))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            out[key] = dict(ms=cs.cuda_ms(call),
                            device_ms=cs.device_ms(call),
                            sdpa_ms=cs.cuda_ms(lambda: torch.autograd.grad(
                                oh, (qh, kh, vh), gh, retain_graph=True)))
    return out


def dq_worker(fn, stream, gen, mode):
    """The dQ kernel's check against its twin, or its timing beside SDPA's
    whole backward (dq, dk and dv) on the same [B, H, T, D]."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from autodiffusion_tpu_torch.ops.flash_attention import (
        flash_bwd_dq_plain, flash_fwd_plain)

    out = {}
    for n, d, t, s in (CHECK if mode == "check" else TIME)["flash_bwd_dq"]:
        q, do = (torch.randn(n, t, d, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(n, s, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = flash_fwd_plain(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        dq = torch.empty_like(q)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, t, s,
                    d, 1, 1 / math.sqrt(d), stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        key = f"{n}x{d} T{t} S{s}"
        if mode == "check":
            call()
            want = flash_bwd_dq_plain(q, k, v, do, lse, delta)
            share = cs.compare(dq, want, "bfloat16")[1]
            out[key] = dict(share_of_limit=share, lse_err=0.0)
            if share > 1:
                raise AssertionError(f"{key}: disagrees with the twin")
        else:
            b = n // 8 if n % 8 == 0 else n
            qh, kh, vh, gh = (z.reshape(b, -1, z.shape[1], d).detach()
                              .requires_grad_(z is not do)
                              for z in (q, k, v, do))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            out[key] = dict(ms=cs.cuda_ms(call),
                            device_ms=cs.device_ms(call),
                            sdpa_ms=cs.cuda_ms(lambda: torch.autograd.grad(
                                oh, (qh, kh, vh), gh, retain_graph=True)))
    return out


def gnb_worker(fn, stream, gen, mode):
    """The GroupNorm backward in the dx-only form the guided step calls, at
    the ADM-64 classifier's sites (batch 32, bf16): its check against the
    twin, or its timing beside F.group_norm's backward with respect to x."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from autodiffusion_tpu_torch.ops.fused_norm import (
        group_norm_bwd_plain, group_norm_fwd_plain)

    out = {}
    for c, hw, act, film in cs.adm64_sites()["group_norm_bwd"]:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        x = (randn(32, c, hw) * torch.exp(0.5 * randn(c, 1))
             + randn(c, 1)).bfloat16()
        dy = randn(32, c, hw).bfloat16()
        gamma, beta = 1 + 0.2 * randn(c), 0.1 * randn(c)
        sc = sh = None
        if film:
            sc, sh = 0.3 * randn(32, c), 0.3 * randn(32, c)
        silu = act == "silu"
        _, mu, rstd = group_norm_fwd_plain(x, gamma, beta, sc, sh, 32, 1e-5,
                                           silu)
        dx = torch.empty_like(x)

        def ptr(t):
            return None if t is None else t.data_ptr()

        def call():
            rc = fn(x.data_ptr(), dy.data_ptr(), gamma.data_ptr(),
                    beta.data_ptr(), ptr(sc), ptr(sh), mu.data_ptr(),
                    rstd.data_ptr(), dx.data_ptr(), None, None, None, None,
                    None, None, 32, c, hw, 32, int(silu), 1, 0, stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        key = f"C={c} HW={hw} {act}"
        if mode == "check":
            call()
            want = group_norm_bwd_plain(x, dy, gamma, beta, sc, sh, mu, rstd,
                                        32, silu, grad_affine=False,
                                        grad_film=False)[0]
            share = cs.compare(dx, want, "bfloat16")[1]
            out[key] = dict(share_of_limit=share, lse_err=0.0)
            if share > 1:
                raise AssertionError(f"{key}: disagrees with the twin")
        else:
            xg = x.detach().clone().requires_grad_(True)
            yl = F.group_norm(xg, 32, gamma.bfloat16(), beta.bfloat16(), 1e-5)
            out[key] = dict(ms=cs.cuda_ms(call),
                            device_ms=cs.device_ms(call),
                            sdpa_ms=cs.cuda_ms(lambda: torch.autograd.grad(
                                yl, (xg,), dy, retain_graph=True)))
    return out


def run(args):
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", *args], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    if r.returncode:
        raise SystemExit(f"worker {args} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(name):
    import chip_smoke as cs

    print(cs.smi_line(), flush=True)
    stem = VARIANTS[name][0]
    so = build(name)
    for key, row in run([so, stem, "check"]).items():
        print(f"check {key}: {row['share_of_limit']:.3f} of the limit, "
              f"lse {row['lse_err']:.2e}", flush=True)
    for lib, label in (("tree", "tree"), (so, name), (so, name),
                       ("tree", "tree")):
        library = {"flash_bwd_dq": "SDPA backward",
                   "flash_bwd_dkv": "SDPA backward",
                   "group_norm_bwd": "F.group_norm backward"}.get(stem,
                                                                  "SDPA")
        for key, row in run([lib, stem, "time"]).items():
            device = (f" (device {row['device_ms']:.4f} ms)"
                      if "device_ms" in row else "")
            print(f"time {label} {key}: {row['ms']:.4f} ms{device}, "
                  f"{library} {row['sdpa_ms']:.4f} ms", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
    else:
        main(sys.argv[1])
