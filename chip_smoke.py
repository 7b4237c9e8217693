#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel from ``autodiffusion_tpu_torch/ops/
   csrc`` (nvcc, sm_90a, one process per source, in parallel), with each
   kernel's registers and spills as ptxas reports them (the pipelined
   wgmma kernels and the GroupNorm backward must not spill) and their
   exponentials and wgmma instructions in the machine code (cuobjdump;
   both backward kernels must issue wgmma, the dQ kernel no mma.sync, one
   MUFU.EX2 a logit and no accurate expf routine);
2. kernels: the flash-attention forward, dQ and dK/dV kernels against
   their plain PyTorch twins at the ADM-64 attention shapes (batch 32,
   head dim 64, bf16 and fp32, plus a ragged length), alone and chained
   through ``FlashAttentionFunction`` as the sampler runs them, within
   limits that a kernel with one tile dropped (and the backward kernels
   fed lse and delta rolled by 64 rows: the dK/dV kernel every query
   tile's from the tile before, the dQ kernel each warpgroup's rows'
   from the other's) is shown to break; each timed with CUDA events
   beside its twin, its bound on the card and
   ``F.scaled_dot_product_attention``, the backward kernels, SDPA's
   backward and the backward's delta = rowsum(dO O) in PyTorch also by
   their device time (torch.profiler), summed per guided step over the
   classifier's 13 sites;
3. the fused GroupNorm forward and backward, the im2col conv and the fused
   norm-act-conv against their twins at every ADM-64 site the three
   switches (``ADT_FUSED_NORM=1 ADT_IM2COL_CONV=1 ADT_FUSED_CONV=all``)
   route to them (batch 32, bf16 and fp32; the sites are read from the
   models themselves, run on the meta device), the GroupNorm backward in
   two forms, dx alone (as guidance calls it, the classifier frozen) and
   every gradient, each also chained through its ``autograd.Function``
   (one launch a call) and timed by its device time too; a sabotaged run
   of each
   (a conv, in its launch plan's tiling, with one 128-channel tile, one
   halo row or, where K is split, one split left out; a GroupNorm with one
   group's statistics taken from the wrong group) must break the limit;
   each timed beside its twin, its bound and ``F.conv2d`` /
   ``F.group_norm`` (forward, or its autograd backward), the convs with
   their plan and share of the bound, and summed per guided step, SD UNet
   call and decode;
4. parity: two guided DDIM steps and two guided ancestral steps (the same
   x_T and per-step noise) of the full-width ADM-64 UNet and classifier
   (float32, seeded random weights) on the GPU against the same runs on
   the CPU, where every kernel is its plain twin: once with the switches
   off, once with all three on;
5. profile: one guided DDIM-4 run at batch 32 in bf16 under
   ``torch.profiler``: device time by kernel, the flash kernels' share
   (the forward's, the dQ kernel's and the dK/dV kernel's own lines) and
   the device's idle share (``chiprun_out/chip_smoke_profile.txt``);
6. A/B: the same guided DDIM-4 run with the switches off, each alone, the
   fused norm with the fused conv, and all three on, one round (three
   rounds of each are in PERF.md): wall time per step, device-busy time
   per step (profiler), idle share, the GroupNorm forward's and
   backward's kernels, the dK/dV kernel and weight- and input-gradient
   conv time of every run (the guided models frozen, as the search
   freezes them: any weight-gradient kernel fails the phase, and so does
   a GroupNorm backward count other than one kernel a call, 17 a step
   with all three on, or any batch-sum kernel)
   (``chiprun_out/chip_smoke_profile_fused.txt``: the kernels of a run
   with all three on);
7. search: ``adt-torch search`` through its Python entry at full ADM-64
   width (classifier guidance, DDIM-4, chunk 2 x batch 16, 32 samples per
   candidate, population 4, one epoch) with seeded random UNet, classifier
   and Inception weights written as checkpoint files, and reference
   statistics from the port's own Inception features of 64 seeded images;
   run twice, with the switches off (the default path: the flash kernels
   only, none of the new ones) and with all three on (all seven kernels).
   Every FID must be finite and >= 0, and each run's launch counters,
   set to 0 just before it, must show every kernel of its path ran as
   many times as its guided steps need;
8. sample: ``adt-torch sample`` with the same checkpoints (classifier
   guidance, a searched 4-step --use_timestep, 32 samples at batch 16),
   ancestral and then DDIM with a 4-entry --skip_layers: the .npz's
   format, the flash forward's, dQ's and dK/dV's launches per guided step
   (35 / 13 / 13, and no other kernel), images/s;
9. FID commands: ``adt-torch ref-stats`` of 64 seeded images on the GPU,
   then ``adt-torch evaluate`` of the ancestral samples against them (FID,
   IS, precision and recall with --ref_batch) on the GPU and on the CPU,
   TF32 off: every metric in range, the two FIDs within 1e-3 relative;
10. SD kernels: at every attention site of the Stable Diffusion v1 UNet
   and VAE decoder (read from the models on the meta device), the packed
   small-head-dim forward (D = 40, T = 4096, S = 4096 and 77, plus a
   ragged T), the flash forward at D = 80 (T = 1024, S = 1024 and 77) and
   at D = 512, all on the token-major layout the models hand them, against
   their twins at the search's device batch (8, the UNet's doubled by
   guidance to 16), bf16 and fp32, with sabotaged runs (a dropped 64-key
   tile; the heads shifted by one; for the packed kernel the padding lanes
   left unzeroed) that must break the limit; then the GroupNorm forward, im2col
   conv and fused conv at every SD UNet and VAE decoder site the switches
   route to them; all timed beside their twins, bounds (with the share of
   the bound each reaches) and library calls, the D = 40 rows also beside
   the softmax's exponential floor (T S n / 3.9e12 s^-1);
11. SD parity: CLIP on two prompts, two PLMS steps of the UNet with
    classifier-free guidance at batch 1, one VAE decode, and DPM-Solver-2
    over three steps from the same latent, full width, float32, seeded
    random weights, GPU against the CPU twins, switches off and on;
12. SD profile: one PLMS-4 fitness batch in bf16 under torch.profiler,
    switches off and on (``chiprun_out/chip_smoke_profile_sd.txt``,
    ``chip_smoke_profile_sd_fused.txt``), with the packed and D = 80
    forwards' lines of a UNet call, the wide forward's line of the decode
    and the GroupNorm forward's time in each;
13. SD search: ``adt-torch search-sd`` through its Python entry (PLMS-4,
    scale 7.5, 512 x 512, chunk 2 x batch 4, 8 samples per candidate,
    population 4, one epoch) from a seeded random-weight CompVis-layout
    ``.ckpt``, a synthesized byte-level vocabulary and COCO captions file,
    twice (switches off, on), each FID finite and >= 0 and each kernel's
    launches equal to its per-call count from the models times the UNet
    calls and decodes; then ``--sampler dpm_solver`` (five time knots,
    DPM-Solver-2, the smallest population the EA takes) twice, with the
    same launch check.

The last lines of standard output are a ``kernels`` JSON line, the
``nvidia-smi`` name / power-limit line and ``{"ok": true, "device": ...}``.
A fuller record goes to ``chiprun_out/chip_smoke.json``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_work", "chip_smoke")
OUT = os.path.join(ROOT, "chiprun_out")

# (T, heads) of the ADM-64 attention blocks at batch 32 (chunk 2 x batch
# 16), head dim 64: UNet res 32 / 16 / 8, classifier res 32 / 16 / 8; plus
# a ragged length
SHAPES = [(1024, 6), (256, 9), (64, 12), (1024, 4), (256, 6), (64, 8),
          (1000, 6)]
# attention sites per guided DDIM step: (T, heads) -> (UNet blocks,
# classifier blocks); every site runs the forward, classifier sites the
# backward too (guidance differentiates through the classifier)
SITES = {(1024, 6): (7, 0), (256, 9): (7, 0), (64, 12): (8, 0),
         (1024, 4): (0, 4), (256, 6): (0, 4), (64, 8): (0, 5)}
BATCH, HEAD_DIM = 32, 64
# elementwise limits on |kernel - twin| (see ``limit``), as text
LIMIT_TEXT = {"float32": "2e-5 (1 + |twin|)",
              "bfloat16": "2^-6 |twin| + 2^-8 max|twin|"}
# a dropped tile is 64 keys (forward, dQ) or 64 queries (dK/dV)
TILE = 64
# H100 SXM: dense bf16 tensor-core and float32 (non-tensor) peaks, HBM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# special-function (MUFU.EX2) results a second on the H100 (the
# FlashAttention-3 paper's figure): the floor of a softmax at a small head
# dim, where the exponentials outlast the matrix products
EXP_PER_S = 3.9e12
KERNEL_INFO = {
    "flash_fwd": ("autodiffusion_tpu_torch/ops/csrc/flash_fwd.cu",
                  "autodiffusion_tpu/ops/flash_attention.py:80"),
    "flash_bwd_dq": ("autodiffusion_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "autodiffusion_tpu/ops/flash_attention.py:216"),
    "flash_bwd_dkv": ("autodiffusion_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "autodiffusion_tpu/ops/flash_attention.py:256"),
}
KERNEL_INFO.update({
    "group_norm_fwd": ("autodiffusion_tpu_torch/ops/csrc/group_norm_fwd.cu",
                       "autodiffusion_tpu/ops/fused_norm.py:77"),
    "group_norm_bwd": ("autodiffusion_tpu_torch/ops/csrc/group_norm_bwd.cu",
                       "autodiffusion_tpu/ops/fused_norm.py:107"),
    "conv3x3": ("autodiffusion_tpu_torch/ops/csrc/conv3x3.cu",
                "autodiffusion_tpu/ops/conv_im2col.py:259"),
    "conv3x3_fused": ("autodiffusion_tpu_torch/ops/csrc/conv3x3_fused.cu",
                      "autodiffusion_tpu/ops/conv_im2col.py:278"),
})
NEW_KERNELS = ("group_norm_fwd", "group_norm_bwd", "conv3x3",
               "conv3x3_fused")
# launches per guided DDIM step on the default path: 22 UNet + 13
# classifier attention blocks forward, 13 classifier blocks backward
PER_STEP = {"flash_fwd": 35, "flash_bwd_dq": 13, "flash_bwd_dkv": 13,
            "group_norm_fwd": 0, "group_norm_bwd": 0, "conv3x3": 0,
            "conv3x3_fused": 0, "flash_fwd_packed": 0, "flash_fwd_wide": 0}
# the kernels of the ADM-64 path
ADM_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") + NEW_KERNELS
# ... and with the three switches on (tests/test_torch_fused_paths.py
# counts them from the models): GroupNorms not folded into a conv, 29 UNet
# + 17 classifier forward and the classifier's 17 backward; the up/down
# blocks' in-convs, 6 + 3; every other ResBlock conv, 66 + 39
PER_STEP_FUSED = dict(PER_STEP, group_norm_fwd=46, group_norm_bwd=17,
                      conv3x3=9, conv3x3_fused=105)
SWITCHES_OFF = {"ADT_FUSED_NORM": "0", "ADT_IM2COL_CONV": "0",
                "ADT_FUSED_CONV": "0"}
SWITCHES_ON = {"ADT_FUSED_NORM": "1", "ADT_IM2COL_CONV": "1",
               "ADT_FUSED_CONV": "all"}
# the A/B phase's configurations: the switches off, each alone, the fused
# norm with the fused conv, all three
AB_CONFIGS = [
    ("off", SWITCHES_OFF),
    ("fused_norm", dict(SWITCHES_OFF, ADT_FUSED_NORM="1")),
    ("im2col", dict(SWITCHES_OFF, ADT_IM2COL_CONV="1")),
    ("fused_conv", dict(SWITCHES_OFF, ADT_FUSED_CONV="all")),
    ("fused_norm+fused_conv", dict(SWITCHES_OFF, ADT_FUSED_NORM="1",
                                   ADT_FUSED_CONV="all")),
    ("all", SWITCHES_ON),
]
GROUPS = 32
# float32 limit of the GroupNorm backward's per-channel sums (dscale,
# dshift, dgamma, dbeta: float32 sums over up to B x HW = 131072 terms, in
# another order than the twin's), the JAX package's gradient tolerance for
# the TPU kernels (tests/test_fused_norm.py)
SUM_TOL = 2e-4
LIMIT_TEXT["float32 sums"] = "2e-4 (1 + |twin|)"
# float32 convs: two float32 sums of K = 9 C_in products in other orders
# differ by about sqrt(K) roundings, so the limit grows as sqrt(K) past
# ADM-64's largest contraction (9 x 768), where it is the JAX tests' 2e-5;
# the SD UNet's 2560-channel inputs reach K = 23040
CONV_K_REF = 9 * 768
LIMIT_TEXT["float32 conv"] = "2e-5 sqrt(max(1, 9 C_in / 6912)) (1 + |twin|)"


def conv_f32_tol(c_in: int) -> float:
    return 2e-5 * max(1.0, 9 * c_in / CONV_K_REF) ** 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(kernel: str, n: int, t: int, s: int, d: int, dtype: str):
    """(ms, "bytes" | "operations"): the least time for the kernel's work
    on the card, each input read once and each output written once."""
    es = 2 if dtype == "bfloat16" else 4
    if kernel == "flash_fwd":
        flops = 4 * n * t * s * d
        nbytes = (2 * n * t * d + 2 * n * s * d) * es + 4 * n * t
    elif kernel == "flash_bwd_dq":
        flops = 6 * n * t * s * d
        nbytes = (3 * n * t * d + 2 * n * s * d) * es + 8 * n * t
    else:
        flops = 8 * n * t * s * d
        nbytes = (2 * n * t * d + 4 * n * s * d) * es + 8 * n * t
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def switches(env):
    """Set the kernel switches of ``env`` for the block, then restore."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def limit(want, dtype: str, f32_tol: float = 2e-5):
    """Elementwise limit on |kernel - twin| for the twin's output ``want``.

    float32: 2e-5 (1 + |twin|), the JAX tests' tolerance for the TPU
    kernels. bfloat16: 2^-6 |twin| + 2^-8 max|twin|, two to four bf16
    units in the last place of the element plus at most one of the
    tensor's largest: the kernel and its twin may round an output, a p or a
    dS to neighbouring bf16 values, and nothing more. The lse is float32 in
    both dtypes and takes the float32 limit."""
    a = want.float().abs()
    if dtype == "float32":
        return f32_tol * (1 + a)
    return (2 ** -6 * a + 2 ** -8 * a.max()).clamp_min(1e-30)


def compare(got, want, dtype: str, f32_tol: float = 2e-5):
    """(max |got - want|, max over elements of |got - want| / limit)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff / limit(want, dtype,
                                                  f32_tol)).max())


# the pipelined wgmma kernels whose registers ptxas must fit without a
# spill (csrc/flash_wgmma.cuh, csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu),
# and the GroupNorm backward's kernels
PIPELINED = ("flash_fwd_tma_kernel", "flash_fwd_packed_kernel",
             "flash_fwd_wide_kernel", "flash_bwd_dq_tma_kernel",
             "flash_bwd_dkv_tma_kernel")
NO_SPILL = PIPELINED + ("group_norm_bwd_kernel",)


def phase_ptxas():
    """{kernel: registers, spill bytes, MUFU.EX2, FFMA.RM, HGMMA and HMMA
    counts} of the pipelined flash kernels and the GroupNorm backward, as
    ptxas reported them and as cuobjdump reads their machine code; a
    spill, a backward kernel without wgmma (HGMMA), or a dQ kernel with
    mma.sync (HMMA), with a MUFU.EX2 count that is not a multiple of the
    32 logits a thread forms a key tile, or with the accurate expf
    routine (its range reduction rounds with FFMA.RM) fails."""
    from autodiffusion_tpu_torch.ops import _build

    every = _build.ptxas_kernels()
    spilled_any = sorted(f"{stem}: {name}" for (stem, name), (_, st, ld)
                         in every.items() if st or ld)
    log(f"ptxas: {len(every)} kernels, spilled: {spilled_any or 'none'}")
    rows = {name: v for (_, name), v in every.items()
            if any(p in name for p in NO_SPILL)}
    missing = [p for p in NO_SPILL if not any(p in n for n in rows)]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    for name, (regs, st, ld) in sorted(rows.items()):
        log(f"ptxas {name}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    spilled = [n for n, (_, st, ld) in rows.items() if st or ld]
    if spilled:
        raise AssertionError(f"ptxas spilled registers of {spilled}")
    out = {n: dict(registers=r, spill_stores=st, spill_loads=ld)
           for n, (r, st, ld) in rows.items()}
    # the softmax's exponentials in the machine code: one MUFU.EX2 a logit
    # (and two a tile for the rescale), no accurate expf routine (FFMA.RM);
    # the products as wgmma (HGMMA), not mma.sync (HMMA)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for stem in ("flash_fwd", "flash_fwd_packed", "flash_fwd_wide",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        sass = subprocess.run([cuobjdump, "-sass", _build.library(stem)._name],
                              capture_output=True, text=True).stdout
        for fn in sass.split("Function : ")[1:]:
            name = fn.split("\n")[0].strip()
            if name in out:
                counts = {key: fn.count(op) for key, op in (
                    ("mufu_ex2", "MUFU.EX2"), ("ffma_rm", "FFMA.RM"),
                    ("hgmma", "HGMMA"), ("hmma", "HMMA"))}
                out[name].update(counts)
                log(f"SASS {name}: {counts['mufu_ex2']} MUFU.EX2, "
                    f"{counts['ffma_rm']} FFMA.RM, {counts['hgmma']} HGMMA, "
                    f"{counts['hmma']} HMMA")
    for tag in ("flash_bwd_dq_tma_kernel", "flash_bwd_dkv_tma_kernel"):
        names = [n for n in out if tag in n]
        if not names or not all(out[n].get("hgmma") for n in names):
            raise AssertionError(f"{tag} issues no wgmma: "
                                 f"{ {n: out[n] for n in names} }")
    dq = {n: out[n] for n in out if "flash_bwd_dq_tma_kernel" in n}
    bad = {n: c for n, c in dq.items()
           if c["hmma"] or c["ffma_rm"] or not c["mufu_ex2"]
           or c["mufu_ex2"] % 32}
    if bad:
        raise AssertionError(f"the dQ kernel's machine code: mma.sync, the "
                             f"accurate expf or not one MUFU.EX2 a logit: "
                             f"{bad}")
    out["spilled_any"] = spilled_any
    return out


def device_ms(fn, tag: str = "", reps: int = 10, tries: int = 4) -> float:
    """Mean device milliseconds a call of ``fn`` spends in the kernels
    whose name holds ``tag`` (every kernel where ``tag`` is empty), from
    torch.profiler over ``reps`` calls after a warm-up: the kernels' own
    time, without the host path around them. A profile that records no
    such kernel (a profiler run now and then records none of them) is
    taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and tag in e.key)
        if total > 0:
            return total / 1e3 / reps
    raise AssertionError(f"the profiler saw no kernel named {tag!r}")


def phase_kernels():
    """Each kernel against its twin on the same inputs (the backward
    kernels fed the twin's lse and delta), then the chain the main path
    runs: FlashAttentionFunction, whose backward takes the forward kernel's
    own lse and output, against the chain of twins. Where a tile can be
    dropped (T > 64), a kernel run with one 64-wide tile left out must fall
    outside the limit, so the limit is shown to catch such a fault."""
    import torch
    import torch.nn.functional as F
    from autodiffusion_tpu_torch.ops.flash_attention import (
        FlashAttentionFunction, flash_bwd_dkv, flash_bwd_dkv_plain,
        flash_bwd_dq, flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures = [], []
    for t, h in SHAPES:
        n = BATCH * h
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            q, k, v, do = (torch.randn(n, t, HEAD_DIM, device="cuda",
                                       generator=gen).to(dt)
                           for _ in range(4))
            o, lse = flash_fwd(q, k, v)
            o_ref, lse_ref = flash_fwd_plain(q, k, v)
            delta = (do.float() * o_ref.float()).sum(-1)
            dq = flash_bwd_dq(q, k, v, do, lse_ref, delta)
            dq_ref = flash_bwd_dq_plain(q, k, v, do, lse_ref, delta)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse_ref, delta)
            dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta)
            # the chain: the forward kernel's lse and o feed the backward
            leaves = [z.detach().requires_grad_(True) for z in (q, k, v)]
            o_chain = FlashAttentionFunction.apply(*leaves)
            cq, ck, cv = torch.autograd.grad(o_chain, leaves, do)
            torch.cuda.synchronize()
            errs = {"flash_fwd": [compare(o, o_ref, dname),
                                  compare(lse, lse_ref, "float32"),
                                  compare(o_chain.detach(), o_ref, dname)],
                    "flash_bwd_dq": [compare(dq, dq_ref, dname),
                                     compare(cq, dq_ref, dname)],
                    "flash_bwd_dkv": [compare(dk, dk_ref, dname),
                                      compare(dv, dv_ref, dname),
                                      compare(ck, dk_ref, dname),
                                      compare(cv, dv_ref, dname)]}
            del o_chain, leaves, cq, ck, cv
            dropped, ring, rolled_dq = {}, None, None
            if t > TILE:
                ks, vs = k[:, TILE:], v[:, TILE:]
                bad_dk, bad_dv = flash_bwd_dkv(
                    q[:, TILE:], k, v, do[:, TILE:], lse_ref[:, TILE:],
                    delta[:, TILE:])
                faults = {
                    "flash_fwd": [(flash_fwd(q, ks, vs)[0], o_ref)],
                    "flash_bwd_dq": [(flash_bwd_dq(q, ks, vs, do, lse_ref,
                                                   delta), dq_ref)],
                    "flash_bwd_dkv": [(bad_dk, dk_ref), (bad_dv, dv_ref)]}
                for name, pairs in faults.items():
                    dropped[name] = min(compare(got, want, dname)[1]
                                        for got, want in pairs)
                    if dropped[name] <= 1:
                        failures.append((name, t, h, dname,
                                         "one tile dropped passes the "
                                         f"limit ({dropped[name]:.3g})"))
                # lse and delta rolled by 64 rows: the dK/dV ring's fault
                # (every stage's slice from the tile before, with its own q
                # and dO tiles), and the dQ kernel's (each warpgroup's
                # resident row statistics from the other's rows)
                lse_rolled = torch.roll(lse_ref, TILE, 1)
                delta_rolled = torch.roll(delta, TILE, 1)
                ring_dk, ring_dv = flash_bwd_dkv(q, k, v, do, lse_rolled,
                                                 delta_rolled)
                ring = min(compare(ring_dk, dk_ref, dname)[1],
                           compare(ring_dv, dv_ref, dname)[1])
                rolled_dq = compare(flash_bwd_dq(q, k, v, do, lse_rolled,
                                                 delta_rolled),
                                    dq_ref, dname)[1]
                for name, share in (("flash_bwd_dkv", ring),
                                    ("flash_bwd_dq", rolled_dq)):
                    if share <= 1:
                        failures.append((name, t, h, dname,
                                         "lse / delta from rows 64 away "
                                         f"passes the limit ({share:.3g})"))
                del faults, bad_dk, bad_dv, ring_dk, ring_dv
            q4, k4, v4, do4 = (z.view(BATCH, h, t, HEAD_DIM)
                               for z in (q, k, v, do))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4))
            qg, kg, vg = (z.detach().requires_grad_(True)
                          for z in (q4, k4, v4))
            og = F.scaled_dot_product_attention(qg, kg, vg)
            sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do4, retain_graph=True))
            # device time of the backward kernels and of SDPA's backward
            # (all of its kernels), bf16: at the T = 64 sites the one-call
            # time is the wrapper's host path
            dev = {}
            if dt == torch.bfloat16:
                dev = {"flash_bwd_dq": device_ms(lambda: flash_bwd_dq(
                           q, k, v, do, lse, delta), "flash_bwd_dq"),
                       "flash_bwd_dkv": device_ms(lambda: flash_bwd_dkv(
                           q, k, v, do, lse, delta), "flash_bwd_dkv"),
                       "sdpa_bwd": device_ms(lambda: torch.autograd.grad(
                           og, (qg, kg, vg), do4, retain_graph=True)),
                       # FlashAttentionFunction.backward's delta, as it
                       # computes it
                       "delta": device_ms(lambda: (do.float() * o.float())
                                          .sum(-1))}
            timing = {
                "flash_fwd": (cuda_ms(lambda: flash_fwd(q, k, v)),
                              cuda_ms(lambda: flash_fwd_plain(q, k, v)),
                              sdpa_ms),
                "flash_bwd_dq": (
                    cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta)),
                    cuda_ms(lambda: flash_bwd_dq_plain(q, k, v, do, lse,
                                                       delta)),
                    sdpa_bwd_ms),
                "flash_bwd_dkv": (
                    cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta)),
                    cuda_ms(lambda: flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta)),
                    sdpa_bwd_ms),
            }
            del og, qg, kg, vg
            for name, es in errs.items():
                err = max(e for e, _ in es)
                worst = max(w for _, w in es)
                ok = worst <= 1
                ms, plain_ms, lib_ms = timing[name]
                b_ms, b_by = bound(name, n, t, t, HEAD_DIM, dname)
                row = dict(name=name, T=t, S=t, heads=h, batch=BATCH,
                           head_dim=HEAD_DIM, dtype=dname, max_abs_err=err,
                           err_over_limit=worst, limit=LIMIT_TEXT[dname],
                           dropped_tile_over_limit=dropped.get(name),
                           ok=ok, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                           device_ms=dev.get(name))
                if name != "flash_fwd":
                    rolled = ring if name == "flash_bwd_dkv" else rolled_dq
                    row.update(rolled_sabotage_over_limit=rolled,
                               library_device_ms=dev.get("sdpa_bwd"))
                if name == "flash_bwd_dq":
                    row.update(delta_device_ms=dev.get("delta"))
                rows.append(row)
                extra = ""
                if dev.get(name):
                    extra = f" device_ms={dev[name]:.4f}"
                if name != "flash_fwd":
                    extra += (f" (lse / delta rolled by 64 rows: "
                              f"{float('nan') if rolled is None else rolled:.1f})")
                    if dev:
                        extra += f" sdpa_bwd_device_ms={dev['sdpa_bwd']:.4f}"
                if name == "flash_bwd_dq" and dev:
                    extra += f" delta_device_ms={dev['delta']:.4f}"
                log(f"kernel {name:14s} T={t:5d} H={h:2d} {dname:8s} "
                    f"max_abs_err={err:.3e} max err/limit={worst:.3f} "
                    f"(limit {LIMIT_TEXT[dname]}, one tile dropped: "
                    f"{dropped.get(name, float('nan')):.1f}) "
                    f"{'ok' if ok else 'FAIL'}  ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}; "
                    f"{100 * b_ms / ms:.1f}% of it){extra}")
                if not ok:
                    failures.append((name, t, h, dname, err))
    if failures:
        raise AssertionError(f"kernels disagree with their twins: "
                             f"{failures}")
    return rows


def attention_per_step(rows):
    """(kernels, SDPA) device ms of one guided DDIM step's attention at
    batch 32 in bf16, summed over its sites from the per-shape times: the
    forward at every site, the backward at the classifier's; and the
    backward kernels' own share ({kernel: (one-call ms, profiled device
    ms)} summed over the classifier's 13 sites, with the backward's delta
    in PyTorch beside them)."""
    by = {(r["name"], r["T"], r["heads"]): r for r in rows
          if r["dtype"] == "bfloat16"}
    kern = lib = 0.0
    bwd = {"flash_bwd_dq": [0.0, 0.0], "flash_bwd_dkv": [0.0, 0.0],
           "sdpa_bwd": [0.0, 0.0], "delta": [0.0, 0.0]}
    for (t, h), (n_unet, n_cls) in SITES.items():
        fwd = by[("flash_fwd", t, h)]
        dq, dkv = by[("flash_bwd_dq", t, h)], by[("flash_bwd_dkv", t, h)]
        kern += (n_unet + n_cls) * fwd["ms"] + n_cls * (dq["ms"] + dkv["ms"])
        # one SDPA backward computes dq, dk and dv
        lib += (n_unet + n_cls) * fwd["library_ms"] + n_cls * dq["library_ms"]
        for name, r in (("flash_bwd_dq", dq), ("flash_bwd_dkv", dkv)):
            bwd[name][0] += n_cls * r["ms"]
            bwd[name][1] += n_cls * r["device_ms"]
        bwd["sdpa_bwd"][0] += n_cls * dkv["library_ms"]
        bwd["sdpa_bwd"][1] += n_cls * dkv["library_device_ms"]
        bwd["delta"][1] += n_cls * dq["delta_device_ms"]
    log(f"attention per guided DDIM step (batch 32, bf16, 35 forward + 13 "
        f"backward sites): kernels {kern:.4f} ms, SDPA {lib:.4f} ms")
    for name, (ms, dev) in bwd.items():
        one_call = "" if name == "delta" else f"one-call {ms:.4f} ms, "
        log(f"  {name} per guided DDIM step (13 classifier sites): "
            f"{one_call}device {dev:.4f} ms")
    return kern, lib, {k: tuple(v) for k, v in bwd.items()}


def adm64_sites():
    """{kernel: {site: calls per guided DDIM step}} of the four new kernels
    with all three switches on, read from one forward of the full-width
    ADM-64 UNet and classifier on the meta device (shapes only), each
    wrapper replaced by a recorder. GroupNorm sites are (C, HW, act, FiLM),
    conv sites (C_in, C_out, H, W) and fused conv sites (C_in, C_out, H, W,
    residual). Every classifier GroupNorm also runs the backward kernel
    once a step (guidance differentiates through the classifier)."""
    import torch
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.models import nn as port_nn
    from autodiffusion_tpu_torch.models import unet as port_unet

    sites = {k: {} for k in NEW_KERNELS}
    model = ["unet"]

    def add(kernel, key):
        sites[kernel][key] = sites[kernel].get(key, 0) + 1

    def gn(x, gamma, beta, *, scale=None, shift=None, num_groups, eps, act):
        key = (x.shape[1], math.prod(x.shape[2:]), act, scale is not None)
        add("group_norm_fwd", key)
        if model[0] == "classifier":
            add("group_norm_bwd", key)
        return torch.empty_like(x)

    def out(x, w):
        return torch.empty((x.shape[0], w.shape[0], *x.shape[2:]),
                           dtype=x.dtype, device=x.device)

    def conv(x, w, bias=None):
        add("conv3x3", (x.shape[1], w.shape[0], x.shape[2], x.shape[3]))
        return out(x, w)

    def fused(x, a, b, w, bias=None, residual=None):
        add("conv3x3_fused", (x.shape[1], w.shape[0], x.shape[2], x.shape[3],
                              residual is not None))
        return out(x, w)

    saved = {n: getattr(port_nn, n)
             for n in ("fused_group_norm", "conv3x3", "conv3x3_fused")}
    saved_flash = port_unet.flash_attention
    port_nn.fused_group_norm, port_nn.conv3x3 = gn, conv
    port_nn.conv3x3_fused = fused
    port_unet.flash_attention = lambda q, k, v: torch.empty_like(q)
    try:
        with switches(SWITCHES_ON), torch.device("meta"):
            m = create_model(ModelConfig.adm64(), device="meta")
            m(torch.empty(1, 3, 64, 64), torch.zeros(1),
              torch.zeros(1, dtype=torch.long))
            model[0] = "classifier"
            c = create_classifier(ClassifierConfig.adm64(), device="meta")
            c(torch.empty(1, 3, 64, 64), torch.zeros(1))
    finally:
        for n, fn in saved.items():
            setattr(port_nn, n, fn)
        port_unet.flash_attention = saved_flash
    per_step = {k: sum(v.values()) for k, v in sites.items()}
    want = {k: PER_STEP_FUSED[k] for k in NEW_KERNELS}
    if per_step != want:
        raise AssertionError(f"ADM-64 sites per step {per_step} != {want}")
    return sites


def new_kernel_bound(kernel, key, dtype: str, batch: int = BATCH,
                     form: str = "all"):
    """(ms, "bytes" | "operations"): the least time for the kernel's work
    at one site, each input read once and each output written once.
    Convs count 2 B HW C_out 9 C_in operations at the dtype's peak (the
    float32 kernel runs on the CUDA cores); GroupNorm counts its float32
    arithmetic (about 12 operations an element forward, 20 backward) at
    the float32 peak. The backward's ``form`` "dx" writes dx alone, "all"
    also dscale, dshift [B, C] and dgamma, dbeta [C]."""
    es = 2 if dtype == "bfloat16" else 4
    if kernel.startswith("group_norm"):
        c, hw, _, film = key[:4]
        n = batch * c * hw
        small = 2 * c * 4 + 2 * batch * GROUPS * 4 \
            + (2 * batch * c * 4 if film else 0)
        if kernel == "group_norm_fwd":
            flops, nbytes = 12 * n, 2 * n * es + small
        else:
            flops = 20 * n
            nbytes = 3 * n * es + small
            if form == "all":
                nbytes += 2 * batch * c * 4 + 2 * c * 4
        peak = PEAK_FLOPS["float32"]
    else:
        c_in, c_out, h, w = key[:4]
        flops = 2 * batch * h * w * c_out * 9 * c_in
        nbytes = (batch * c_in * h * w + 9 * c_in * c_out
                  + batch * c_out * h * w) * es + c_out * 4
        if kernel == "conv3x3_fused":
            flops += 5 * batch * c_in * h * w
            nbytes += 2 * batch * c_in * 4 \
                + (batch * c_out * h * w * es if key[4] else 0)
        peak = PEAK_FLOPS[dtype]
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _gn_wrong_group(x, gamma, beta, mu, rstd, silu, eps=1e-5):
    """The forward kernel's output with group 0 of every sample normalised
    with group 1's statistics: the kernel run with a per-sample FiLM term
    on group 0's channels that turns (x - mu0) rstd0 into (x - mu1) rstd1
    (z' = k z + m with k = rstd1 / rstd0, m = beta (1 - k) + (mu0 - mu1)
    rstd1 gamma, from the kernel's own mu, rstd)."""
    import torch
    from autodiffusion_tpu_torch.ops.fused_norm import group_norm_fwd

    b, c = x.shape[:2]
    per = c // GROUPS
    k = (rstd[:, 1] / rstd[:, 0])[:, None]                       # [B, 1]
    m = beta[None, :per] * (1 - k) \
        + ((mu[:, 0] - mu[:, 1]) * rstd[:, 1])[:, None] * gamma[None, :per]
    scale = torch.zeros(b, c, device=x.device)
    shift = torch.zeros(b, c, device=x.device)
    scale[:, :per] = k - 1
    shift[:, :per] = m
    return group_norm_fwd(x, gamma, beta, scale, shift, GROUPS, eps,
                          silu)[0]


def _row(rows, failures, name, site, count, dname, errs, sabotage, timing,
         bnd, limit_text, batch=BATCH):
    """Record one kernel row: errs [(max |d|, |d| / limit)], sabotage the
    least |d| / limit of the sabotaged runs (None where none applies),
    timing (ms, plain ms, library ms), bnd (bound ms, bound by)."""
    err = max(e for e, _ in errs)
    worst = max(w for _, w in errs)
    ok = worst <= 1
    ms, plain_ms, lib_ms = timing
    rows.append(dict(name=name, site=site, count=count, batch=batch,
                     dtype=dname, max_abs_err=err, err_over_limit=worst,
                     limit=limit_text, sabotaged_over_limit=sabotage,
                     ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bnd[0], bound_by=bnd[1],
                     bound_share=bnd[0] / ms))
    log(f"kernel {name:14s} {site} x{count} {dname:8s} "
        f"max_abs_err={err:.3e} max err/limit={worst:.3f} (sabotaged: "
        f"{float('nan') if sabotage is None else sabotage:.1f}) "
        f"{'ok' if ok else 'FAIL'}  ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}; "
        f"{100 * bnd[0] / ms:.1f}% of it)")
    if not ok:
        failures.append((name, site, dname, err, worst))
    if sabotage is not None and sabotage <= 1:
        failures.append((name, site, dname, "the sabotaged run passes the "
                         f"limit ({sabotage:.3g})"))


def phase_new_kernels(sites, batch: int = BATCH, reps: int = 10):
    """The GroupNorm and conv kernels against their twins at every site of
    ``sites`` (ADM-64's, or a Stable Diffusion tower's) at ``batch``, in
    both dtypes, with a sabotaged run of each that must break the limit,
    timed beside the twin, the bound and the nearest library call. A
    GroupNorm site key may carry its eps as a fifth entry (1e-5 if not).
    The conv twins' float32 convolutions (and F.conv2d) run with TF32
    off."""
    import torch
    import torch.nn.functional as F
    from autodiffusion_tpu_torch.ops.conv_im2col import (
        BM, CHUNK, conv3x3_fused_kernel, conv3x3_im2col, conv3x3_reference,
        conv_plan, fused_conv_reference)
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.ops.fused_norm import (
        FusedGroupNormFunction, group_norm_bwd, group_norm_bwd_plain,
        group_norm_fwd, group_norm_fwd_plain)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    rows, failures = [], []
    try:
        for key, count in sites["group_norm_fwd"].items():
            c, hw, act, film = key[:4]
            eps = key[4] if len(key) > 4 else 1e-5
            silu = act == "silu"
            for dt in (torch.bfloat16, torch.float32):
                dname = str(dt).split(".")[1]
                # per-channel scales and offsets, so that the groups'
                # statistics differ and a wrong group's show
                x = (randn(batch, c, hw) * torch.exp(0.5 * randn(c, 1))
                     + randn(c, 1)).to(dt)
                gamma, beta = 1 + 0.2 * randn(c), 0.1 * randn(c)
                sc = sh = None
                if film:
                    sc, sh = 0.3 * randn(batch, c), 0.3 * randn(batch, c)
                args = (x, gamma, beta, sc, sh, GROUPS, eps, silu)
                y, mu, rstd = group_norm_fwd(*args)
                y_ref, mu_ref, rstd_ref = group_norm_fwd_plain(*args)
                bad = _gn_wrong_group(x, gamma, beta, mu, rstd, silu, eps)
                torch.cuda.synchronize()
                errs = [compare(y, y_ref, dname),
                        compare(mu, mu_ref, "float32"),
                        compare(rstd, rstd_ref, "float32")]
                sabotage = compare(bad, y_ref, dname)[1]
                gl, bl = gamma.to(dt), beta.to(dt)
                timing = (cuda_ms(lambda: group_norm_fwd(*args)),
                          cuda_ms(lambda: group_norm_fwd_plain(*args)),
                          cuda_ms(lambda: F.group_norm(x, GROUPS, gl, bl,
                                                       eps)))
                _row(rows, failures, "group_norm_fwd",
                     f"C={c} HW={hw} {act}" + (f" eps={eps:g}" if eps != 1e-5
                                               else ""), count, dname, errs,
                     sabotage, timing,
                     new_kernel_bound("group_norm_fwd", key, dname, batch),
                     LIMIT_TEXT[dname], batch)
                if key not in sites["group_norm_bwd"]:
                    continue
                # the backward in two forms: dx alone, as guidance calls it
                # (the classifier frozen), and every gradient; each alone
                # on the twin's mu, rstd and chained through the
                # autograd.Function (the dx form with gamma, beta and the
                # FiLM terms frozen: one launch, no batch sum)
                dy = randn(batch, c, hw).to(dt)
                bargs = (x, dy, gamma, beta, sc, sh, mu_ref, rstd_ref,
                         GROUPS, silu)
                mu_bad, rstd_bad = mu_ref.clone(), rstd_ref.clone()
                mu_bad[:, 0], rstd_bad[:, 0] = mu_ref[:, 1], rstd_ref[:, 1]
                for form in ("dx", "all"):
                    flags = dict(grad_affine=form == "all",
                                 grad_film=form == "all")
                    got = group_norm_bwd(*bargs, **flags)
                    want = group_norm_bwd_plain(*bargs, **flags)
                    leaves = [x.detach().clone().requires_grad_(True)] + [
                        t.detach().clone().requires_grad_(form == "all")
                        for t in (gamma, beta)]
                    reset_launch_counts()
                    out = FusedGroupNormFunction.apply(*leaves, sc, sh,
                                                       GROUPS, 1e-5, silu)
                    chain = torch.autograd.grad(
                        out, leaves if form == "all" else leaves[:1], dy)
                    if LAUNCHES["group_norm_bwd"] != 1:
                        failures.append(("group_norm_bwd", key, dname, form,
                                         "autograd launched the backward "
                                         f"{LAUNCHES['group_norm_bwd']} "
                                         "times"))
                    bad_dx = group_norm_bwd(x, dy, gamma, beta, sc, sh,
                                            mu_bad, rstd_bad, GROUPS, silu,
                                            **flags)[0]
                    torch.cuda.synchronize()
                    errs = [compare(got[0], want[0], dname),
                            compare(chain[0], want[0], dname)]
                    if form == "all":
                        errs += [compare(a, b, "float32", SUM_TOL)
                                 for a, b in zip(got[1:] + chain[1:],
                                                 want[1:] + want[3:])]
                    elif any(a is not None for a in got[1:]):
                        failures.append(("group_norm_bwd", key, dname, form,
                                         "gradients nobody asked for"))
                    sabotage = compare(bad_dx, want[0], dname)[1]
                    xg = x.detach().clone().requires_grad_(True)
                    gg, bg = (t.detach().clone().requires_grad_(form == "all")
                              for t in (gl, bl))
                    yl = F.group_norm(xg, GROUPS, gg, bg, 1e-5)
                    lib_in = (xg, gg, bg) if form == "all" else (xg,)

                    def kern(flags=flags):
                        return group_norm_bwd(*bargs, **flags)

                    def lib(yl=yl, lib_in=lib_in):
                        return torch.autograd.grad(yl, lib_in, dy,
                                                   retain_graph=True)
                    timing = (cuda_ms(kern),
                              cuda_ms(lambda: group_norm_bwd_plain(
                                  *bargs, **flags)),
                              cuda_ms(lib))
                    _row(rows, failures, "group_norm_bwd",
                         f"C={c} HW={hw} {act} {form}",
                         sites["group_norm_bwd"][key], dname, errs, sabotage,
                         timing, new_kernel_bound("group_norm_bwd", key,
                                                  dname, batch, form),
                         f"{LIMIT_TEXT[dname]}; sums "
                         f"{LIMIT_TEXT['float32 sums']}", batch)
                    rows[-1]["form"] = form
                    if dt == torch.bfloat16:
                        rows[-1].update(device_ms=device_ms(
                            kern, "group_norm_bwd"),
                            library_device_ms=device_ms(lib))
                        log(f"  device: kernel {rows[-1]['device_ms']:.4f} "
                            f"ms, F.group_norm backward "
                            f"{rows[-1]['library_device_ms']:.4f} ms")
                    del out, chain, leaves, yl, xg, gg, bg

        for kernel in ("conv3x3", "conv3x3_fused"):
            for key, count in sites[kernel].items():
                c_in, c_out, h, w = key[:4]
                fused = kernel == "conv3x3_fused"
                for dt in (torch.bfloat16, torch.float32):
                    dname = str(dt).split(".")[1]
                    x = randn(batch, c_in, h, w).to(dt)
                    wt = (randn(c_out, c_in, 3, 3) / (9 * c_in) ** 0.5).to(dt)
                    bias = 0.1 * randn(c_out)
                    a, off = 1 + 0.3 * randn(batch, c_in), \
                        0.3 * randn(batch, c_in)
                    res = randn(batch, c_out, h, w).to(dt)
                    if fused:
                        r = res if key[4] else None

                        def kern(xx, ww, rr=r):
                            return conv3x3_fused_kernel(xx, a, off, ww, bias,
                                                        rr)

                        def plain(rr=r):
                            return fused_conv_reference(x, a, off, wt, bias,
                                                        rr)
                        # silu(x a + b) = 0 where x = -b / a: a row of
                        # such values contributes nothing, as if left out
                        zero_row = (-off / a).to(dt)[:, :, None]
                    else:
                        def kern(xx, ww):
                            return conv3x3_im2col(xx, ww, bias)

                        def plain():
                            return conv3x3_reference(x, wt, bias)
                        zero_row = 0.0
                    tol = conv_f32_tol(c_in)
                    y, y_ref = kern(x, wt), plain()
                    errs = [compare(y, y_ref, dname, tol)]
                    if fused:   # the other residual variant too
                        other = None if key[4] else res
                        errs.append(compare(kern(x, wt, other),
                                            plain(other), dname, tol))
                    # sabotage, in the plan's tiling: the last tile of
                    # 128 output channels left out; the halo row above a
                    # block's (or a sub-tile's) first row left out of that
                    # output row; where K is split, the last split's input
                    # channels left out
                    plan = conv_plan(batch, c_in, c_out, h, w, dt)
                    w_bad = wt.clone()
                    w_bad[(c_out - 1) // BM * BM:] = 0
                    faults = [kern(x, w_bad)]
                    if h > 1:
                        band = plan.rows or h // 2
                        row = next((r for r in (2 * band, band)
                                    if 0 < r < h), h // 2)
                        x_bad = x.clone()
                        x_bad[:, :, row - 1] = zero_row
                        bad = y.clone()
                        bad[:, :, row] = kern(x_bad, wt)[:, :, row]
                        faults.append(bad)
                    if plan.splits > 1:
                        w_split = wt.clone()
                        w_split[:, (plan.splits - 1) * plan.chunks_per_split
                                * CHUNK:] = 0
                        faults.append(kern(x, w_split))
                    torch.cuda.synchronize()
                    sabotage = min(compare(f, y_ref, dname, tol)[1]
                                   for f in faults)
                    wl, bl = wt, bias.to(dt)
                    timing = (cuda_ms(lambda: kern(x, wt), reps=reps),
                              cuda_ms(plain, reps=reps),
                              cuda_ms(lambda: F.conv2d(x, wl, bl, padding=1),
                                      reps=reps))
                    site = f"{c_in}->{c_out} {h}x{w}" + (
                        (" +residual" if key[4] else "") if fused else "")
                    _row(rows, failures, kernel, site, count, dname, errs,
                         sabotage, timing, new_kernel_bound(kernel, key,
                                                            dname, batch),
                         LIMIT_TEXT["float32 conv" if dname == "float32"
                                    else dname], batch)
                    r = rows[-1]
                    r.update(plan=plan.text(),
                             bound_share=r["bound_ms"] / r["ms"])
                    log(f"  plan {r['plan']}: {100 * r['bound_share']:.1f}% "
                        f"of the bound, {r['ms'] / r['library_ms']:.2f}x "
                        "F.conv2d")
                    del x, wt, res, y, y_ref, faults
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if failures:
        raise AssertionError(f"new kernels disagree with their twins: "
                             f"{failures}")
    return rows


def new_kernels_per_step(rows, unit="guided DDIM step (batch 32"):
    """{kernel: (kernel ms, library ms, bound ms)} of one guided DDIM step
    at batch 32 (or one SD UNet call or decode: ``unit``) in bf16 with the
    switches on, summed over the sites."""
    out = {}
    for name in NEW_KERNELS:
        # the GroupNorm backward as the guided step calls it: dx alone
        sel = [r for r in rows if r["name"] == name
               and r["dtype"] == "bfloat16" and r.get("form") != "all"]
        if not sel:
            continue
        out[name] = tuple(sum(r["count"] * r[k] for r in sel)
                          for k in ("ms", "library_ms", "bound_ms"))
        log(f"{name} per {unit}, bf16, {sum(r['count'] for r in sel)} "
            f"launches): kernel {out[name][0]:.4f} ms, library "
            f"{out[name][1]:.4f} ms ({out[name][0] / out[name][1]:.2f}x), "
            f"bound {out[name][2]:.4f} ms "
            f"({100 * out[name][2] / out[name][0]:.1f}%)")
    return out


def head_rows(rows):
    """Per kernel, the bf16 row of the site with the most work (largest
    bound; the GroupNorm backward in the dx form the guided step runs):
    the row the ``kernels`` line reports."""
    head = {}
    for r in rows:
        if r["dtype"] != "bfloat16" or r.get("form") == "all":
            continue
        if r["name"] not in head or r["bound_ms"] > head[r["name"]]["bound_ms"]:
            head[r["name"]] = r
    return head


def device_busy(prof, steps: int):
    """(busy ms per step, kernels sorted by device time) of a profile."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy, kernels


def profile_lines(kernels, steps: int, top: int = 25):
    return [f"{e.self_device_time_total / 1e3 / steps:10.3f} ms/step "
            f"{e.count // steps:6d} calls/step  {e.key[:120]}"
            for e in kernels[:top]]


def guided_run(unet_sd, cls_sd):
    """(run, models): one guided DDIM-4 run at batch 32, full width, bf16,
    of seeded random weights, as the profile and A/B phases time it."""
    import torch
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_tables

    m = create_model(ModelConfig.adm64(dropout=0.0), device="cuda")
    m.load_state_dict(unet_sd)
    c = create_classifier(ClassifierConfig.adm64(), device="cuda")
    c.load_state_dict(cls_sd)
    # frozen, as the search's models are: guidance asks for no weight
    # gradient
    m.requires_grad_(False)
    c.requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
    tables = build_tables("ddim4", base_schedule="cosine").to("cuda")
    cond = classifier_cond_fn(c, y, 1.0)

    def run():
        return ddim_sample_loop(lambda x, t, i: m(x, t, y), (32, 3, 64, 64),
                                tables, device="cuda", generator=gen,
                                cond_fn=cond)

    return run, (m, c)


def phase_ab(unet_sd, cls_sd, rounds: int = 1):
    """The guided DDIM-4 run at batch 32 in bf16 under each configuration
    of AB_CONFIGS, ``rounds`` rounds taken in turn (each configuration once
    per round; three rounds of each are in PERF.md): per run, wall ms per
    step (host clock around a synchronised run, unprofiled), device-busy ms
    per step (the next run, profiled) and the idle share 1 - busy / wall.
    Every run's output must be finite."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    run, _ = guided_run(unet_sd, cls_sd)
    runs = {name: [] for name, _ in AB_CONFIGS}
    for rnd in range(rounds):
        for name, env in AB_CONFIGS:
            with switches(env):
                if rnd == 0:
                    run()                         # warm-up
                torch.cuda.synchronize()
                t0 = time.time()
                out = run()
                torch.cuda.synchronize()
                wall = (time.time() - t0) * 1e3 / 4
                if not torch.isfinite(out).all():
                    raise AssertionError(f"A/B {name}: non-finite samples")
                reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                gn_bwd_launches = LAUNCHES["group_norm_bwd"] / 4
                busy, kernels = device_busy(prof, 4)
            # weight- and input-gradient convolutions (cuDNN's wgrad and
            # dgrad kernels): no wgrad where the models are frozen; the
            # fused GroupNorm forward's and backward's kernels, the
            # backward's batch sum (none where the models are frozen) and
            # the dK/dV kernel
            tags = ("wgrad", "dgrad", "group_norm_fwd_", "group_norm_bwd_",
                    "group_norm_batch_sum", "flash_bwd_dkv")
            wgrad, dgrad, gn_fwd, gn_bwd, batch_sum, dkv = (
                sum(e.self_device_time_total for e in kernels
                    if tag in e.key.lower()) / 1e3 / 4 for tag in tags)
            gn_bwd_calls, batch_sums = (
                sum(e.count for e in kernels if tag in e.key) / 4
                for tag in ("group_norm_bwd_kernel", "group_norm_batch_sum"))
            runs[name].append(dict(wall_ms=wall, busy_ms=busy,
                                   idle=1 - busy / wall, wgrad_ms=wgrad,
                                   dgrad_ms=dgrad, gn_fwd_ms=gn_fwd,
                                   gn_bwd_ms=gn_bwd,
                                   gn_bwd_kernels=gn_bwd_calls,
                                   batch_sum_kernels=batch_sums,
                                   dkv_ms=dkv))
            log(f"A/B round {rnd} {name:22s} wall {wall:.2f} ms/step, "
                f"busy {busy:.2f} ms/step, idle {100 * (1 - busy / wall):.1f}%"
                f", wgrad {wgrad:.3f} ms/step, dgrad {dgrad:.3f} ms/step, "
                f"GroupNorm forward {gn_fwd:.3f} ms/step, backward "
                f"{gn_bwd:.3f} ms/step ({gn_bwd_calls:g} kernels, "
                f"{batch_sums:g} batch sums), dK/dV {dkv:.3f} ms/step")
            if wgrad:
                raise AssertionError(f"A/B {name}: {wgrad:.3f} ms/step of "
                                     "weight-gradient kernels under frozen "
                                     "models")
            # one kernel a call of the GroupNorm backward, no batch sum (the
            # classifier frozen: dx alone); with all three switches on, the
            # 17 calls of PER_STEP_FUSED (the fused norm alone also takes
            # the GroupNorms the fused conv folds)
            want = gn_bwd_launches if name != "all" \
                else PER_STEP_FUSED["group_norm_bwd"]
            if gn_bwd_calls != gn_bwd_launches or gn_bwd_calls != want \
                    or batch_sums:
                raise AssertionError(
                    f"A/B {name}: {gn_bwd_calls:g} GroupNorm backward "
                    f"kernels and {batch_sums:g} batch sums a step for "
                    f"{gn_bwd_launches:g} calls (want {want:g} kernels, one "
                    "a call, and no batch sum)")
            if rnd == 0 and name == "all":
                os.makedirs(OUT, exist_ok=True)
                with open(os.path.join(OUT, "chip_smoke_profile_fused.txt"),
                          "w") as f:
                    f.write(f"{smi_line()}\nguided DDIM-4, ADM-64 bf16, "
                            f"batch 32, {' '.join(f'{k}={v}' for k, v in SWITCHES_ON.items())}; "
                            "device time per step by kernel\n"
                            + "\n".join(profile_lines(kernels, 4))
                            + f"\nweight-gradient (wgrad) kernels {wgrad:.3f}"
                            f" ms/step, input-gradient (dgrad) kernels "
                            f"{dgrad:.3f} ms/step\n")
    summary = {}
    for name, rs in runs.items():
        wall = sorted(r["wall_ms"] for r in rs)[len(rs) // 2]
        busy = sorted(r["busy_ms"] for r in rs)[len(rs) // 2]
        summary[name] = dict(wall_ms=wall, busy_ms=busy,
                             idle=1 - busy / wall, runs=rs)
        log(f"A/B {name:22s} median of {len(rs)}: wall {wall:.2f} ms/step, "
            f"busy {busy:.2f} ms/step, idle "
            f"{100 * summary[name]['idle']:.1f}%; images/s through DDIM-4 "
            f"{32 / (4 * wall / 1e3):.2f}")
    return summary


def phase_profile(unet_sd, cls_sd):
    """One guided DDIM-4 run at batch 32, full width, bf16: host-clock time
    per step, then the same run under torch.profiler for device time by
    kernel. Device busy share = summed kernel time / unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run, _ = guided_run(unet_sd, cls_sd)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3 / 4)
    step_ms = sorted(walls)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy_ms, kernels = device_busy(prof, 4)
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key) / 1e3 / 4
    n_kernels = sum(e.count for e in kernels) / 4
    lines = profile_lines(kernels, 4)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"{smi_line()}\nguided DDIM-4, ADM-64 bf16, batch 32; "
                f"device time per step by kernel\n" + "\n".join(lines)
                + "\n")
    log(f"profile: guided DDIM step at batch 32 (bf16): {step_ms:.2f} ms "
        f"wall, device busy {busy_ms:.2f} ms ({100 * busy_ms / step_ms:.1f}%"
        f", idle {100 * (1 - busy_ms / step_ms):.1f}%), flash kernels "
        f"{flash_ms:.2f} ms ({100 * flash_ms / busy_ms:.1f}% of busy), "
        f"{n_kernels:.0f} device kernels, peak memory {peak_gb:.2f} GB")
    for line in lines[:8]:
        log("profile: " + line)
    own = {}
    for label, tag in (("flash_fwd", "flash_fwd_tma_kernel"),
                       ("flash_bwd_dq", "flash_bwd_dq_tma_kernel"),
                       ("flash_bwd_dkv", "flash_bwd_dkv_tma_kernel")):
        sel = [e for e in kernels if tag in e.key]
        if not sel:
            raise AssertionError(f"profile: no {tag} in the step")
        for line in profile_lines(sel, 4):
            log(f"profile ({label}): " + line)
        own[label] = sum(e.self_device_time_total for e in sel) / 1e3 / 4
    return dict(step_ms=step_ms, busy_ms=busy_ms, flash_ms=flash_ms,
                flash_fwd_ms=own["flash_fwd"], dq_ms=own["flash_bwd_dq"],
                dkv_ms=own["flash_bwd_dkv"],
                kernels_per_step=n_kernels, peak_gb=peak_gb, top=lines)


def phase_parity(unet_sd, cls_sd, env, label: str):
    """Two guided DDIM steps and two guided ancestral steps (the same x_T
    and per-step z on both devices) of the full-width models in float32
    under the switches of ``env``: GPU (the kernels) against CPU (their
    plain twins), same weights. Each output within 1e-3 x its scale.
    Returns ({"ddim2": err, "ancestral2": err}, the GPU runs' kernel
    launches)."""
    import torch
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  ddim_sample_loop,
                                                  p_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_tables

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(3)
        x_t = torch.randn(2, 3, 64, 64, generator=gen)
        z = torch.randn(2, 2, 3, 64, 64, generator=gen)
        y = torch.tensor([7, 321])
        tables = build_tables("ddim2", base_schedule="cosine")
        outs = {}
        for dev in ("cpu", "cuda"):
            m = create_model(ModelConfig.adm64(use_bf16=False, dropout=0.0),
                             device=dev)
            m.load_state_dict(unet_sd)
            c = create_classifier(ClassifierConfig.adm64(
                classifier_use_bf16=False), device=dev)
            c.load_state_dict(cls_sd)
            yd = y.to(dev)
            cond = classifier_cond_fn(c, yd, 1.0)
            t0 = time.time()
            reset_launch_counts()
            with switches(env):
                for name, loop, kw in (("ddim2", ddim_sample_loop, {}),
                                       ("ancestral2", p_sample_loop,
                                        {"step_noise": z})):
                    out = loop(lambda x, t, i: m(x, t, yd), (2, 3, 64, 64),
                               tables.to(dev), device=dev, cond_fn=cond,
                               noise=x_t, **kw)
                    outs[(name, dev)] = out.cpu()
            launches = dict(LAUNCHES)
            log(f"parity ({label}) on {dev}: {time.time() - t0:.1f} s")
            del m, c
        errs = {}
        for name in ("ddim2", "ancestral2"):
            got, want = outs[(name, "cuda")], outs[(name, "cpu")]
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite guided {name} output on "
                                     "the GPU")
            errs[name] = float((got - want).abs().max())
            scale = float(want.abs().max())
            log(f"parity ({label}): guided {name}, ADM-64 float32, GPU vs "
                f"CPU max abs err {errs[name]:.3e} (output max {scale:.3f}, "
                f"tol 1e-3 x scale)")
            if not errs[name] <= 1e-3 * max(scale, 1.0):
                raise AssertionError(f"GPU guided {name} ({label}) disagrees "
                                     f"with the CPU twin: {errs[name]}")
        log(f"parity ({label}): GPU launches {launches}")
        return errs, launches
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def search_files(unet_sd, cls_sd):
    """Checkpoint files of the seeded weights and reference statistics
    from the port's own Inception features of 64 seeded images."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception,
                                             synthesize_pt_inception)

    paths = {k: os.path.join(WORK, f) for k, f in (
        ("unet", "unet.pt"), ("cls", "classifier.pt"),
        ("incep", "pt_inception.pth"), ("ref", "ref_stats.npz"))}
    torch.save(unet_sd, paths["unet"])
    torch.save(cls_sd, paths["cls"])
    torch.save(synthesize_pt_inception(2), paths["incep"])
    inception = load_fid_inception(paths["incep"], device="cuda")
    imgs = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (64, 64, 64, 3), dtype=np.uint8))
    FIDStats.from_features(inception_apply(inception, imgs)["pool3"]
                           .double().cpu().numpy()).save(paths["ref"])
    return paths


def phase_search(paths, env, per_step, label: str):
    """``adt-torch search`` under the switches of ``env``, its launch
    counters set to 0 just before and read just after: each must equal
    ``per_step`` times the guided steps run (and a kernel of the path may
    not be missing)."""
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    save_dir = os.path.join(WORK, f"search_{label}")
    argv = ["search", "--device", "cuda",
            "--model_path", paths["unet"], "--classifier_path", paths["cls"],
            "--inception_path", paths["incep"], "--ref_stats", paths["ref"],
            "--save_dir", save_dir, "--time_step", "4", "--use_ddim", "True",
            "--candidate_chunk", "2", "--batch_size", "16",
            "--num_samples", "32", "--population_num", "4",
            "--select_num", "2", "--mutation_num", "2",
            "--crossover_num", "2", "--max_epochs", "1", "--seed", "0"]
    with switches(env):
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"adt-torch search ({label}) returned {rc}")

    with open(os.path.join(save_dir, "ea_state.json")) as f:
        fids = list(json.load(f)["vis_dict"].values())
    if not fids or not all(math.isfinite(x) and x >= 0 for x in fids):
        raise AssertionError(f"invalid FIDs from the search ({label}): "
                             f"{fids}")
    with open(os.path.join(save_dir, "log.txt")) as f:
        phases = [tuple(float(v) for v in m.groups()) for m in re.finditer(
            r"reset_time: ([\d.]+), sample_time: ([\d.]+), "
            r"fid_time: ([\d.]+)", f.read())]
    chunks = len(phases)
    steps = chunks * 2 * 4            # chunks x 2 batches x DDIM-4
    want = {k: v * steps for k, v in per_step.items()}
    log(f"search ({label}): {len(fids)} candidates, FIDs {fids}")
    log(f"search ({label}): {chunks} chunks, {steps} guided DDIM steps at "
        f"batch 32, launches {launches} (expected {want}), wall {wall:.1f} s")
    for name, count in want.items():
        if count and not launches[name]:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"search path ({label})")
    if launches != want:
        raise AssertionError(f"launch counts ({label}) {launches} != {want}")
    imgs_per_chunk = 2 * 16 * 2
    sample_s = [p[1] for p in phases]
    steady = sample_s[1:] or sample_s
    ips = imgs_per_chunk * len(steady) / sum(steady)
    log(f"search ({label}): per-chunk reset/sample/fid seconds: "
        + "; ".join(f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c in phases))
    log(f"search ({label}): images/s through the guided sampler (sample "
        f"phase = guided DDIM-4 + Inception + moments, chunks after the "
        f"first): {ips:.2f}")
    return dict(fids=fids, launches=launches, expected_launches=want,
                chunks=chunks, guided_steps=steps, phases=phases,
                images_per_s=ips, wall_s=wall)


# a searched 4-step schedule (the first four knots of the README's
# published ADM-64 artifact) and one skip list per step for ``sample``
SAMPLE_TIMESTEPS = "[94, 834, 217, 944]"
SAMPLE_SKIPS = "[[0, 3], [], [10, 57], [5]]"


def phase_sample(paths):
    """``adt-torch sample`` at full ADM-64 width (bf16, classifier guidance,
    32 samples at batch 16) twice: ancestral (--use_ddim False) with the
    4-step --use_timestep, then DDIM with a 4-entry --skip_layers. The
    launch counters, set to 0 just before each run and read just after,
    must show the flash forward, dQ and dK/dV each ``PER_STEP`` times a
    guided step (8 steps) and nothing else; the .npz must hold uint8
    [32, 64, 64, 3] images and labels in [0, 1000). Returns {run: dict}."""
    import io

    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    runs = {"ancestral": ["--use_ddim", "False"],
            "ddim_skip": ["--use_ddim", "True", "--skip_layers",
                          SAMPLE_SKIPS]}
    steps = 2 * 4                      # two batches of DDIM-4 / ancestral-4
    want = {k: v * steps for k, v in PER_STEP.items()}
    out = {}
    for label, extra in runs.items():
        npz = os.path.join(WORK, f"samples_{label}.npz")
        argv = ["sample", "--device", "cuda", "--model_path", paths["unet"],
                "--classifier_path", paths["cls"], "--use_timestep",
                SAMPLE_TIMESTEPS, "--num_samples", "32", "--batch_size", "16",
                "--seed", "0", "--out", npz] + extra
        buf = io.StringIO()
        with switches(SWITCHES_OFF), contextlib.redirect_stdout(buf):
            reset_launch_counts()
            t0 = time.time()
            rc = adt_torch(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(LAUNCHES)
        text = buf.getvalue()
        print(text, end="", flush=True)
        if rc != 0:
            raise AssertionError(f"adt-torch sample ({label}) returned {rc}")
        with np.load(npz) as z:
            arr, labels = z["arr_0"], z["arr_1"]
        if arr.dtype != np.uint8 or arr.shape != (32, 64, 64, 3):
            raise AssertionError(f"sample ({label}): {arr.dtype} "
                                 f"{arr.shape}")
        if labels.shape != (32,) or labels.min() < 0 or labels.max() >= 1000:
            raise AssertionError(f"sample ({label}): labels {labels}")
        log(f"sample ({label}): {steps} guided steps at batch 16, launches "
            f"{launches} (expected {want}), wall {wall:.1f} s")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if not launches[name]:
                raise AssertionError(f"kernel {name} never launched by "
                                     f"sample ({label})")
        if launches != want:
            raise AssertionError(f"sample ({label}) launch counts {launches}"
                                 f" != {want}")
        times = [float(v) for v in re.findall(
            r"created \d+ samples \(([\d.]+) s\)", text)]
        ips = 16 / (times[1] - times[0])
        log(f"sample ({label}): images/s through the guided sampler (the "
            f"second batch of 16, 4 guided steps + uint8): {ips:.2f}; "
            f"{32 / wall:.2f} end to end (the command, models built and "
            "loaded)")
        out[label] = dict(npz=npz, launches=launches,
                          expected_launches=want, batch_s=times,
                          images_per_s=ips, wall_s=wall)
    return out


def phase_fid_commands(paths, samples_npz):
    """``adt-torch ref-stats`` of 64 seeded uint8 images on cuda, then
    ``adt-torch evaluate`` of the ancestral samples against those
    statistics with --ref_batch, on cuda and on cpu, TF32 off: FID finite
    and >= 0, IS finite and >= 1, precision and recall in [0, 1], the cuda
    FID within 1e-3 relative of the cpu FID. Returns the metrics and
    seconds."""
    import io

    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch

    refs = os.path.join(WORK, "ref_images.npz")
    np.savez(refs, np.random.RandomState(6).randint(
        0, 256, (64, 64, 64, 3), dtype=np.uint8))
    ref_out = os.path.join(WORK, "ref_cmd.npz")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.time()
        rc = adt_torch(["ref-stats", "--device", "cuda", "--images", refs,
                        "--out", ref_out, "--inception_path", paths["incep"],
                        "--batch_size", "32"])
        ref_s = time.time() - t0
        if rc != 0:
            raise AssertionError(f"adt-torch ref-stats returned {rc}")
        log(f"ref-stats (cuda): 64 images, {ref_s:.2f} s")
        metrics, secs = {}, {"ref_stats": ref_s}
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                rc = adt_torch(["evaluate", "--device", dev, "--sample_batch",
                                samples_npz, "--ref_stats", ref_out,
                                "--ref_batch", refs, "--inception_path",
                                paths["incep"], "--batch_size", "32"])
            secs[f"evaluate_{dev}"] = time.time() - t0
            if rc != 0:
                raise AssertionError(f"adt-torch evaluate ({dev}) returned "
                                     f"{rc}")
            m = json.loads(buf.getvalue().strip().splitlines()[-1])
            log(f"evaluate ({dev}): {m}, {secs[f'evaluate_{dev}']:.2f} s")
            ok = (math.isfinite(m["fid"]) and m["fid"] >= 0
                  and math.isfinite(m["inception_score"])
                  and m["inception_score"] >= 1
                  and 0 <= m["precision"] <= 1 and 0 <= m["recall"] <= 1)
            if not ok:
                raise AssertionError(f"evaluate ({dev}) metrics out of "
                                     f"range: {m}")
            metrics[dev] = m
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    rel = abs(metrics["cuda"]["fid"] - metrics["cpu"]["fid"]) \
        / max(metrics["cpu"]["fid"], 1e-12)
    log(f"evaluate: cuda FID vs cpu FID relative difference {rel:.3e} "
        "(tol 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"evaluate: the cuda FID disagrees with the cpu "
                             f"FID: {metrics}")
    return dict(metrics=metrics, seconds=secs, fid_rel_diff=rel)


# ------------------------------------------------------ Stable Diffusion

# the SD search's device batch: candidate_chunk 2 x batch 4, the UNet's
# doubled for classifier-free guidance ([uncond | cond])
SD_BATCH = 8
SD_UNET_BATCH = 2 * SD_BATCH
SD_KERNELS = ("flash_fwd_packed", "flash_fwd", "flash_fwd_wide",
              "group_norm_fwd", "conv3x3", "conv3x3_fused")
KERNEL_INFO.update({
    "flash_fwd_packed": ("autodiffusion_tpu_torch/ops/csrc/flash_fwd_packed.cu",
                         "autodiffusion_tpu/ops/flash_attention.py:126"),
    "flash_fwd_wide": ("autodiffusion_tpu_torch/ops/csrc/flash_fwd_wide.cu",
                       "autodiffusion_tpu/ops/flash_attention.py:80"),
})


def sd_sites():
    """{"unet" | "decode": {kernel: {site: calls}}} of one SD v1 UNet
    forward and one AutoencoderKL decode at full width, all three switches
    on, read from the models on the meta device (shapes only), each
    wrapper replaced by a recorder. Attention sites are (T, S, heads, D);
    GroupNorm sites (C, HW, act, FiLM, eps); conv sites as adm64_sites()'s.
    The switches-off path runs the attention sites alone."""
    import sys as _sys

    import torch
    from autodiffusion_tpu_torch.models import create_sd_models
    from autodiffusion_tpu_torch.models import nn as port_nn

    fa = _sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    out, cur = {}, {}

    def add(kernel, key):
        cur.setdefault(kernel, {})
        cur[kernel][key] = cur[kernel].get(key, 0) + 1

    def gn(x, gamma, beta, *, scale=None, shift=None, num_groups, eps, act):
        add("group_norm_fwd", (x.shape[1], math.prod(x.shape[2:]), act,
                               scale is not None, eps))
        return torch.empty_like(x)

    def conv_out(x, w):
        return torch.empty((x.shape[0], w.shape[0], *x.shape[2:]),
                           dtype=x.dtype, device=x.device)

    def conv(x, w, bias=None):
        add("conv3x3", (x.shape[1], w.shape[0], x.shape[2], x.shape[3]))
        return conv_out(x, w)

    def fused(x, a, b, w, bias=None, residual=None):
        add("conv3x3_fused", (x.shape[1], w.shape[0], x.shape[2], x.shape[3],
                              residual is not None))
        return conv_out(x, w)

    def packed(q, k, v, heads, **kw):
        add("flash_fwd_packed", (q.shape[1], k.shape[1], heads,
                                 q.shape[2] // heads))
        return torch.empty_like(q), None

    def fwd(q, k, v, heads=1):
        add("flash_fwd_wide" if q.shape[-1] == 512 else "flash_fwd",
            (q.shape[1], k.shape[1], heads, q.shape[2] // heads))
        return torch.empty_like(q), None

    saved = {n: getattr(port_nn, n)
             for n in ("fused_group_norm", "conv3x3", "conv3x3_fused")}
    saved_fa = (fa.flash_fwd_packed, fa.flash_fwd)
    port_nn.fused_group_norm, port_nn.conv3x3 = gn, conv
    port_nn.conv3x3_fused = fused
    fa.flash_fwd_packed, fa.flash_fwd = packed, fwd
    try:
        with switches(SWITCHES_ON), torch.device("meta"):
            unet, vae, _ = create_sd_models(device="meta")
            unet(torch.empty(1, 4, 64, 64), torch.zeros(1),
                 torch.empty(1, 77, 768))
            out["unet"], cur = cur, {}
            vae.decode(torch.empty(1, 4, 64, 64))
            out["decode"] = cur
    finally:
        for n, fn in saved.items():
            setattr(port_nn, n, fn)
        fa.flash_fwd_packed, fa.flash_fwd = saved_fa
    for part in out.values():
        for kernel in SD_KERNELS:
            part.setdefault(kernel, {})
    return out


def per_call(sites, switched_on: bool):
    """{kernel: launches per call} of one tower's sites; with the switches
    off only the attention kernels run."""
    return {k: sum(v.values()) if switched_on or k.startswith("flash")
            else 0 for k, v in sites.items()}


def phase_sd_attention(sites):
    """flash_fwd_packed (D = 40: the SD 64x64 level's self-attention over
    4096 tokens and cross-attention over 77, plus a ragged T), flash_fwd at
    D = 80 (the 32x32 level, self- and cross-attention) and flash_fwd_wide
    at D = 512 (the VAE mid-block), all on the token-major [B, L, H * D]
    layout the models hand them, against their twins at the search's device
    batch (the UNet's doubled by guidance), bf16 and fp32, within the
    kernel limits; runs with one 64-key tile left out, with the heads
    shifted by one (a wrong head offset; where there are several) and for
    the packed kernel with the D = 40 padding read from memory instead of
    zeroed, must break them. Every other head's values are eight times
    larger, so that reading a neighbour shows. Each timed beside its twin,
    its bound and F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from autodiffusion_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_packed, flash_fwd_packed_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = []   # (kernel, T, S, heads, D, batch, calls per UNet call/decode)
    for kernel, part, batch in (("flash_fwd_packed", "unet", SD_UNET_BATCH),
                                ("flash_fwd", "unet", SD_UNET_BATCH),
                                ("flash_fwd_wide", "decode", SD_BATCH)):
        for (t, s_len, heads, d), count in sites[part][kernel].items():
            shapes.append((kernel, t, s_len, heads, d, batch, count))
    # a ragged query length for the packed kernel, self and cross
    shapes += [("flash_fwd_packed", 1000, 1000, 8, 40, SD_UNET_BATCH, 0),
               ("flash_fwd_packed", 1000, 77, 8, 40, SD_UNET_BATCH, 0)]
    rows, failures = [], []
    for kernel, t, s_len, heads, d, batch, count in shapes:
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            scale = torch.tensor([1.0 if h % 2 == 0 else 8.0
                                  for h in range(heads)],
                                 device="cuda").repeat_interleave(d)
            q = torch.randn(batch, t, heads * d, device="cuda",
                            generator=gen).to(dt)
            k = torch.randn(batch, s_len, heads * d, device="cuda",
                            generator=gen).to(dt)
            v = (torch.randn(batch, s_len, heads * d, device="cuda",
                             generator=gen) * scale).to(dt)
            if kernel == "flash_fwd_packed":
                def kern(kk=k, vv=v, **kw):
                    return flash_fwd_packed(q, kk, vv, heads, **kw)
            else:
                # as multihead_attention hands it the projections
                def kern(kk=k, vv=v):
                    return flash_fwd(q, kk, vv, heads=heads)

            def plain():
                return flash_fwd_packed_plain(q, k, v, heads)
            with torch.no_grad():
                o, lse = kern()
                o_ref, lse_ref = plain()
                faults = [kern(k[:, 64:], v[:, 64:])[0]] if s_len > 64 else []
                if heads > 1:
                    faults.append(kern(k.roll(d, 2), v.roll(d, 2))[0])
                if kernel == "flash_fwd_packed":
                    if d % 16 and dt == torch.bfloat16:
                        # (the float32 kernel has no padding to leave)
                        faults.append(kern(_raw_pad=True)[0])
                torch.cuda.synchronize()
                errs = [compare(o, o_ref, dname),
                        compare(lse, lse_ref, "float32")]
                sabotage = min(compare(f, o_ref, dname)[1] for f in faults) \
                    if faults else None
                del faults, o, lse, o_ref, lse_ref
                # [B, H, L, D] views for the library call
                q4, k4, v4 = (z.view(batch, z.shape[1], heads, d)
                              .transpose(1, 2) for z in (q, k, v))
                reps = 5 if t * s_len >= 4096 * 4096 else 10
                timing = (cuda_ms(kern, reps=reps),
                          cuda_ms(plain, reps=reps),
                          cuda_ms(lambda: F.scaled_dot_product_attention(
                              q4, k4, v4), reps=reps))
            n = batch * heads
            bnd = bound("flash_fwd", n, t, s_len, d, dname)
            _row(rows, failures, kernel,
                 f"T={t} S={s_len} H={heads} D={d}", count, dname, errs,
                 sabotage, timing, bnd, LIMIT_TEXT[dname], batch)
            rows[-1].update(T=t, S=s_len, heads=heads, head_dim=d)
            if d == 40:
                # the softmax's exponentials: T S n of them a launch
                floor_ms = t * s_len * n / EXP_PER_S * 1e3
                rows[-1]["exp_floor_ms"] = floor_ms
                log(f"    D = 40: exponential floor {floor_ms:.4f} ms (T S n "
                    f"/ 3.9e12 s^-1) beside the bound {bnd[0]:.4f} ms "
                    f"({bnd[1]}); the kernel at {100 * floor_ms / timing[0]:.1f}"
                    f"% of the floor")
            del q, k, v, q4, k4, v4
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"SD attention kernels disagree with their "
                             f"twins: {failures}")
    return rows


def sd_weights():
    """Seeded random state dicts of the three SD v1 towers at full width
    (float32, built on the CPU)."""
    from autodiffusion_tpu_torch.models import create_sd_models, random_init_

    towers = create_sd_models(use_bf16=False, device="cpu")
    out = {}
    for name, module, seed in zip(("unet", "vae", "clip"), towers,
                                  (10, 11, 12)):
        random_init_(module, seed)
        out[name] = module.state_dict()
        log(f"SD {name}: {sum(p.numel() for p in module.parameters())} "
            "params")
    return out


def sd_towers(weights, use_bf16: bool, device: str):
    """The three towers on ``device`` holding ``weights`` (built on the
    meta device and assigned, so nothing is initialised twice)."""
    import torch
    from autodiffusion_tpu_torch.models import create_sd_models

    with torch.device("meta"):
        towers = create_sd_models(use_bf16, device="meta")
    for module, name in zip(towers, ("unet", "vae", "clip")):
        module.load_state_dict(weights[name], assign=True)
    return tuple(m.to(device) for m in towers)


def phase_sd_parity(weights, envs, dpm_label: str = "switches off"):
    """The SD towers at full width in float32 with seeded random weights,
    GPU (the kernels) against CPU (their twins), under the switches of each
    of ``envs`` ({label: env}): CLIP on two prompts' ids, two PLMS steps of
    the UNet with classifier-free guidance (scale 7.5) at batch 1 (three
    UNet calls at the doubled batch 2), one VAE decode of the result, and,
    under the switches of ``dpm_label`` (the solver's arithmetic is the
    same under either), DPM-Solver-2 from the same latent over three steps
    (three guided UNet calls; the middle step second order, the last first
    order as lower_order_final makes it). Each output within 1e-3 x its
    scale. Returns {label: ({output: max abs error}, GPU launches)}."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.models import SD_SCALE_FACTOR
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.samplers import (DiscreteNoiseSchedule,
                                                  cfg_eps_fn,
                                                  dpm_solver_sample_loop,
                                                  plms_sample_loop)
    from autodiffusion_tpu_torch.schedules import (build_sd_tables,
                                                   make_beta_schedule)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(13)
    ids = torch.randint(0, 49408, (2, 77), generator=gen)
    ids[:, 0], ids[:, 20:] = 49406, 49407
    z_t = torch.randn(1, 4, 64, 64, generator=gen)
    tables = build_sd_tables([301, 801])
    sched = DiscreteNoiseSchedule.from_betas(
        make_beta_schedule("sqrt_linear", 1000))
    times = torch.from_numpy(np.array([1.0, 0.62, 0.3, 1e-3], np.float32))
    outs = {label: {} for label in envs}
    launches = {}
    try:
        for dev in ("cpu", "cuda"):
            unet, vae, clip = sd_towers(weights, False, dev)
            for label, env in envs.items():
                t0 = time.time()
                reset_launch_counts()
                with switches(env), torch.no_grad():
                    ctx = clip(ids.to(dev))
                    guided = cfg_eps_fn(unet, ctx[1:], ctx[0], 7.5)
                    z = plms_sample_loop(guided, (1, 4, 64, 64),
                                         tables.to(dev), device=dev,
                                         noise=z_t)
                    img = vae.decode(z / SD_SCALE_FACTOR)
                    outs[label][dev] = {"clip": ctx.cpu(), "plms2": z.cpu(),
                                        "decode": img.cpu()}
                    if label == dpm_label:
                        outs[label][dev]["dpm_solver2"] = \
                            dpm_solver_sample_loop(
                                guided, (1, 4, 64, 64), sched.to(dev),
                                times.to(dev), device=dev, order=2,
                                noise=z_t).cpu()
                launches[label] = dict(LAUNCHES)
                log(f"SD parity ({label}) on {dev}: {time.time() - t0:.1f} s")
            del unet, vae, clip
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    result = {}
    for label in envs:
        errs = {}
        for name, want in outs[label]["cpu"].items():
            got = outs[label]["cuda"][name]
            if not torch.isfinite(got).all():
                raise AssertionError(f"SD parity ({label}): non-finite "
                                     f"{name} on the GPU")
            errs[name] = float((got - want).abs().max())
            scale = float(want.abs().max())
            log(f"SD parity ({label}): {name} GPU vs CPU max abs err "
                f"{errs[name]:.3e} (output max {scale:.3f}, tol 1e-3 x "
                f"scale)")
            if not errs[name] <= 1e-3 * max(scale, 1.0):
                raise AssertionError(f"SD {name} on the GPU ({label}) "
                                     f"disagrees with the CPU twin: "
                                     f"{errs[name]}")
        log(f"SD parity ({label}): GPU launches {launches[label]}")
        result[label] = (errs, launches[label])
    return result


def phase_sd_profile(weights, label: str = "switches off"):
    """One PLMS-4 fitness batch of the search in bf16 (5 UNet calls at
    batch 16 with guidance, then the VAE decode of 8 latents) under the
    switches in force: host-clock time of an unprofiled run, then each part
    under torch.profiler: device busy and idle per UNet call, the top
    kernels, the attention kernels' and the GroupNorm forward's share, and
    the decode's share of the batch's device time
    (``chiprun_out/chip_smoke_profile_sd.txt``, or ``..._sd_fused.txt``
    with the switches on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from autodiffusion_tpu_torch.models import SD_SCALE_FACTOR
    from autodiffusion_tpu_torch.samplers import cfg_eps_fn, plms_sample_loop
    from autodiffusion_tpu_torch.schedules import build_sd_tables

    unet, vae, _ = sd_towers(weights, True, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    ctx = torch.randn(SD_BATCH, 77, 768, device="cuda", generator=gen)
    tables = build_sd_tables([129, 543, 764, 976]).to("cuda")
    noise = torch.randn(SD_BATCH, 4, 64, 64, device="cuda", generator=gen)

    def sample():
        guided = cfg_eps_fn(unet, ctx, ctx[0] * 0, 7.5)
        return plms_sample_loop(guided, noise.shape, tables, device="cuda",
                                noise=noise)

    def decode(z):
        return vae.decode(z / SD_SCALE_FACTOR)

    with torch.no_grad():
        decode(sample())                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        z = sample()
        torch.cuda.synchronize()
        t1 = time.time()
        img = decode(z)
        torch.cuda.synchronize()
        t2 = time.time()
        if not torch.isfinite(img).all():
            raise AssertionError("SD profile: non-finite decode")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_u:
            sample()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_d:
            decode(z)
            torch.cuda.synchronize()
    calls = 5
    wall_call = (t1 - t0) * 1e3 / calls
    busy_call, k_u = device_busy(prof_u, calls)
    busy_dec, k_d = device_busy(prof_d, 1)
    attn = sum(e.self_device_time_total for e in k_u
               if "flash_fwd" in e.key) / 1e3 / calls
    gn_u, gn_d = (sum(e.self_device_time_total for e in ks
                      if "group_norm_fwd_" in e.key) / 1e3 / n
                  for ks, n in ((k_u, calls), (k_d, 1)))
    lines_u, lines_d = profile_lines(k_u, calls), profile_lines(k_d, 1)
    os.makedirs(OUT, exist_ok=True)
    fname = "chip_smoke_profile_sd" + (
        "_fused" if label != "switches off" else "") + ".txt"
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(f"{smi_line()}\nSD v1 PLMS-4 fitness batch, bf16, {label}, "
                f"UNet at batch {SD_UNET_BATCH} (guidance), decode of "
                f"{SD_BATCH}; device time per UNet call by kernel\n"
                + "\n".join(lines_u)
                + "\n\ndevice time of one VAE decode by kernel\n"
                + "\n".join(lines_d) + "\n")
    batch_busy = calls * busy_call + busy_dec
    res = dict(wall_ms_per_unet_call=wall_call, busy_ms_per_unet_call=busy_call,
               idle_unet=1 - busy_call / wall_call,
               attention_ms_per_unet_call=attn,
               attention_share=attn / busy_call,
               gn_fwd_ms_per_unet_call=gn_u, gn_fwd_ms_per_decode=gn_d,
               decode_wall_ms=(t2 - t1) * 1e3, decode_busy_ms=busy_dec,
               decode_share=busy_dec / batch_busy,
               batch_wall_ms=(t2 - t0) * 1e3, peak_gb=peak_gb,
               top_unet=lines_u[:10], top_decode=lines_d[:10])
    log(f"SD profile ({label}): UNet call at batch {SD_UNET_BATCH} (bf16): "
        f"{wall_call:.2f} ms wall, device busy {busy_call:.2f} ms (idle "
        f"{100 * res['idle_unet']:.1f}%), attention kernels {attn:.2f} ms "
        f"({100 * res['attention_share']:.1f}% of busy); VAE decode of "
        f"{SD_BATCH}: {res['decode_wall_ms']:.2f} ms wall, busy "
        f"{busy_dec:.2f} ms ({100 * res['decode_share']:.1f}% of the batch's "
        f"device time); PLMS-4 batch {res['batch_wall_ms']:.1f} ms wall; "
        f"peak memory {peak_gb:.2f} GB; GroupNorm forward kernels "
        f"{gn_u:.3f} ms a UNet call, {gn_d:.3f} ms a decode")
    for line in lines_u[:6]:
        log("SD profile (UNet): " + line)
    for line in lines_d[:4]:
        log("SD profile (decode): " + line)
    # the three pipelined forwards' own lines
    for part, kernels, steps, name in (("UNet", k_u, calls, "flash_fwd_packed"),
                                       ("UNet", k_u, calls, "flash_fwd_tma"),
                                       ("decode", k_d, 1, "flash_fwd_wide")):
        mine = [e for e in kernels if name + "_kernel" in e.key]
        if not mine:
            raise AssertionError(f"SD profile: no {name} kernel in the {part}")
        for line in profile_lines(mine, steps):
            log(f"SD profile ({part}, {name}): " + line)
        res[f"{name}_ms_per_{part.lower()}"] = sum(
            e.self_device_time_total for e in mine) / 1e3 / steps
    del unet, vae
    return res


def sd_search_files(weights, paths):
    """A CompVis-layout .ckpt of the seeded weights (float16, the
    published layout's three prefixes), a byte-level CLIP vocabulary and
    merges, a COCO-format captions file."""
    import torch
    from autodiffusion_tpu_torch.models.clip_text import _bytes_to_unicode
    from autodiffusion_tpu_torch.models.sd_convert import SD_PREFIXES

    full = {}
    for name, prefix in SD_PREFIXES.items():
        full.update({prefix + k: (v.half() if v.is_floating_point() else v)
                     for k, v in weights[name].items()})
    out = dict(paths, ckpt=os.path.join(WORK, "sd.ckpt"),
               vocab=os.path.join(WORK, "vocab.json"),
               merges=os.path.join(WORK, "merges.txt"),
               captions=os.path.join(WORK, "captions.json"))
    torch.save({"state_dict": full}, out["ckpt"])
    chars = list(_bytes_to_unicode().values())
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("o", "f</w>")]
    tokens = chars + [c + "</w>" for c in chars] + \
        ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
    with open(out["vocab"], "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(out["merges"], "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    words = ["a", "photo", "of", "the", "cat", "dog", "red", "car", "on",
             "street", "in", "snow", "bowl", "fruit", "man", "riding"]
    rng = __import__("random").Random(15)
    caps = [" ".join(rng.choice(words) for _ in range(8)) for _ in range(16)]
    with open(out["captions"], "w") as f:
        json.dump({"images": [{"id": i, "file_name": f"{i}.jpg"}
                              for i in range(16)],
                   "annotations": [{"image_id": i, "caption": c}
                                   for i, c in enumerate(caps)]}, f)
    return out


def phase_sd_search(paths, env, sites, label: str, sampler: str = "plms",
                    population: int = 4):
    """``adt-torch search-sd`` under the switches of ``env`` (``sampler``:
    PLMS-4 or DPM-Solver-2 over five knots; scale 7.5, 512 x 512, chunk 2 x
    batch 4, 8 samples per candidate, ``population`` candidates, one
    epoch), its launch counters set to 0 just before and read just after:
    each must equal the per-call counts derived from the models times the
    UNet calls (5 per dispatch for PLMS-4, 4 for DPM-Solver over 4 steps)
    and the decodes (1)."""
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    on = env is SWITCHES_ON
    save_dir = os.path.join(WORK, f"search_sd_{label}")
    argv = ["search-sd", "--device", "cuda", "--ckpt", paths["ckpt"],
            "--clip_vocab", paths["vocab"], "--clip_merges", paths["merges"],
            "--captions", paths["captions"], "--inception_path",
            paths["incep"], "--ref_stats", paths["ref"], "--save_dir",
            save_dir, "--sampler", sampler, "--scale", "7.5", "--H", "512",
            "--W", "512", "--time_step", "4", "--num_samples", "8",
            "--batch_size", "4", "--candidate_chunk", "2",
            "--population_num", str(population), "--select_num", "2",
            "--mutation_num", str(population // 2), "--crossover_num",
            str(population // 2), "--max_epochs", "1", "--seed", "0",
            "--num_prompts", "16"]
    with switches(env):
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"adt-torch search-sd ({label}) returned {rc}")
    with open(os.path.join(save_dir, "ea_state.json")) as f:
        fids = list(json.load(f)["vis_dict"].values())
    if not fids or not all(math.isfinite(x) and x >= 0 for x in fids):
        raise AssertionError(f"invalid FIDs from search-sd ({label}): {fids}")
    with open(os.path.join(save_dir, "log.txt")) as f:
        phases = [tuple(float(v) for v in m.groups()) for m in re.finditer(
            r"reset_time: ([\d.]+), sample_time: ([\d.]+), "
            r"fid_time: ([\d.]+)", f.read())]
    dispatches = len(phases) * 2          # chunks x (8 samples / batch 4)
    unet_calls = (5 if sampler == "plms" else 4) * dispatches
    decodes = dispatches
    want = {k: 0 for k in LAUNCHES}
    for part, n in (("unet", unet_calls), ("decode", decodes)):
        for k, c in per_call(sites[part], on).items():
            want[k] += c * n
    log(f"search-sd ({label}): {len(fids)} candidates, FIDs {fids}")
    log(f"search-sd ({label}): {len(phases)} chunks, {unet_calls} UNet "
        f"calls at batch {SD_UNET_BATCH}, {decodes} decodes of {SD_BATCH}, "
        f"launches {launches} (expected {want}), wall {wall:.1f} s")
    for name in SD_KERNELS:
        if want[name] and not launches[name]:
            raise AssertionError(f"kernel {name} never launched on the SD "
                                 f"search path ({label})")
    if launches != want:
        raise AssertionError(f"search-sd launch counts ({label}) {launches}"
                             f" != {want}")
    sample_s = [p[1] for p in phases]
    steady = sample_s[1:] or sample_s
    ips = 2 * SD_BATCH * len(steady) / sum(steady)
    log(f"search-sd ({label}): per-chunk reset/sample/fid seconds: "
        + "; ".join(f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c in phases))
    name = "PLMS-4" if sampler == "plms" else "DPM-Solver-2 (4 steps)"
    log(f"search-sd ({label}): images/s through the guided sampler (sample "
        f"phase = {name} + decode + Inception + moments, chunks after the "
        f"first): {ips:.3f}")
    return dict(fids=fids, launches=launches, expected_launches=want,
                chunks=len(phases), unet_calls=unet_calls, decodes=decodes,
                phases=phases, images_per_s=ips, wall_s=wall)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model, random_init_)
    from autodiffusion_tpu_torch.ops import _build

    t_start = time.time()
    marks = []                   # (phase, seconds since the start)

    def mark(name: str) -> None:
        marks.append((name, round(time.time() - t_start, 1)))
        log(f"phase {name} done at {marks[-1][1]} s")

    smi = smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    _build.build_all()
    log(f"kernel build (nvcc sm_90a, parallel): "
        f"{_build.last_build_seconds():.1f} s")
    log(_build.ptxas_report())
    ptxas = phase_ptxas()

    mark("build")
    rows = phase_kernels()
    attn_ms, attn_sdpa_ms, attn_bwd = attention_per_step(rows)
    mark("ADM attention kernels")
    sites = adm64_sites()
    new_rows = phase_new_kernels(sites)
    new_ms = new_kernels_per_step(new_rows)
    mark("ADM GroupNorm and conv kernels")

    os.makedirs(WORK, exist_ok=True)
    try:
        # seeded random weights at full ADM-64 width, built on the CPU
        unet = random_init_(create_model(ModelConfig.adm64(dropout=0.0),
                                         device="cpu"), 0)
        cls = random_init_(create_classifier(ClassifierConfig.adm64(),
                                             device="cpu"), 1)
        unet_sd, cls_sd = unet.state_dict(), cls.state_dict()
        log(f"models: UNet {sum(p.numel() for p in unet.parameters())} "
            f"params ({unet.layer_num} layers), classifier "
            f"{sum(p.numel() for p in cls.parameters())} params")
        del unet, cls
        parity_err, _ = phase_parity(unet_sd, cls_sd, SWITCHES_OFF,
                                     "switches off")
        parity_on_err, parity_on_launches = phase_parity(
            unet_sd, cls_sd, SWITCHES_ON, "switches on")
        mark("ADM parity")
        missing = [k for k in ADM_KERNELS if not parity_on_launches[k]]
        if missing:
            raise AssertionError(f"the switches-on parity run launched no "
                                 f"{missing}")
        with switches(SWITCHES_OFF):
            prof = phase_profile(unet_sd, cls_sd)
        mark("ADM profile")
        ab = phase_ab(unet_sd, cls_sd)
        mark("ADM A/B")
        paths = search_files(unet_sd, cls_sd)
        search = phase_search(paths, SWITCHES_OFF, PER_STEP, "default")
        search_on = phase_search(paths, SWITCHES_ON, PER_STEP_FUSED,
                                 "switches on")
        mark("ADM searches")
        sample = phase_sample(paths)
        mark("sample")
        fid_cmds = phase_fid_commands(paths, sample["ancestral"]["npz"])
        mark("ref-stats and evaluate")
        log(f"ADM phases done at {time.time() - t_start:.1f} s")

        # the Stable Diffusion slice: search-sd's kernels at every SD site,
        # parity of the full-width towers, a profile and two searches
        sd = sd_sites()
        sd_attn_rows = phase_sd_attention(sd)
        mark("SD attention kernels")
        sd_rows, sd_ms = [], {}
        for part, batch in (("unet", SD_UNET_BATCH), ("decode", SD_BATCH)):
            part_rows = phase_new_kernels(
                {k: sd[part].get(k, {}) for k in NEW_KERNELS}, batch, reps=5)
            sd_ms[part] = new_kernels_per_step(
                part_rows, f"SD {part} call (batch {batch}")
            sd_rows += part_rows
        mark("SD GroupNorm and conv kernels")
        weights = sd_weights()
        sd_parity = phase_sd_parity(weights, {"switches off": SWITCHES_OFF,
                                              "switches on": SWITCHES_ON})
        mark("SD parity")
        missing = [k for k in SD_KERNELS
                   if not sd_parity["switches on"][1][k]]
        if missing:
            raise AssertionError(f"the SD switches-on parity run launched no "
                                 f"{missing}")
        with switches(SWITCHES_OFF):
            sd_prof = phase_sd_profile(weights)
        with switches(SWITCHES_ON):
            sd_prof_on = phase_sd_profile(weights, "switches on")
        mark("SD profiles")
        paths = sd_search_files(weights, paths)
        del weights
        sd_search = phase_sd_search(paths, SWITCHES_OFF, sd, "default")
        sd_search_on = phase_sd_search(paths, SWITCHES_ON, sd, "switches on")
        mark("SD PLMS searches")
        # DPM-Solver: the smallest population the EA takes
        sd_dpm = phase_sd_search(paths, SWITCHES_OFF, sd, "dpm_solver",
                                 "dpm_solver", population=2)
        sd_dpm_on = phase_sd_search(paths, SWITCHES_ON, sd,
                                    "dpm_solver switches on", "dpm_solver",
                                    population=2)
        mark("SD DPM-Solver searches")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = {r["name"]: r for r in rows
            if (r["T"], r["heads"], r["dtype"]) == (1024, 6, "bfloat16")}
    head.update(head_rows(new_rows + sd_rows))
    head.update({r["name"]: r for r in sd_attn_rows
                 if r["name"] != "flash_fwd" and r["dtype"] == "bfloat16"
                 and (r["T"], r["S"]) == (4096, 4096)})
    # each kernel's launches on the main paths: the flash kernels on the
    # default searches, the GroupNorm and conv kernels on the searches with
    # the switches on (ADM and SD each)
    launches = {k: search["launches"][k] + sd_search["launches"][k]
                + sd_dpm["launches"][k]
                + sum(r["launches"][k] for r in sample.values())
                for k in KERNEL_INFO}
    for k in NEW_KERNELS:
        launches[k] = (search_on["launches"][k] + sd_search_on["launches"][k]
                       + sd_dpm_on["launches"][k])
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": launches[name],
         "max_abs_err": head[name]["max_abs_err"], "ms": head[name]["ms"],
         "plain_ms": head[name]["plain_ms"],
         "bound_ms": head[name]["bound_ms"],
         "bound_by": head[name]["bound_by"],
         "library_ms": head[name]["library_ms"]}
        for name in KERNEL_INFO]}
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda,
                   "build_s": _build.last_build_seconds(),
                   "kernel_rows": rows, "new_kernel_rows": new_rows,
                   "new_kernel_sites": {k: {str(s): n for s, n in v.items()}
                                        for k, v in sites.items()},
                   "new_kernels_ms_per_step": new_ms,
                   "parity_max_abs_err": parity_err,
                   "parity_switches_on_max_abs_err": parity_on_err,
                   "attention_ms_per_step": attn_ms,
                   "sdpa_attention_ms_per_step": attn_sdpa_ms,
                   "backward_ms_per_step": attn_bwd,
                   "profile": prof, "ab": ab, "search": search,
                   "search_switches_on": search_on, "sample": sample,
                   "fid_commands": fid_cmds,
                   "sd_sites": {part: {k: {str(s): n for s, n in v.items()}
                                       for k, v in d.items()}
                                for part, d in sd.items()},
                   "sd_attention_rows": sd_attn_rows, "sd_kernel_rows": sd_rows,
                   "sd_new_kernels_ms_per_call": sd_ms,
                   "sd_parity": {k: v[0] for k, v in sd_parity.items()},
                   "sd_profile": sd_prof, "sd_profile_switches_on": sd_prof_on,
                   "sd_search": sd_search, "sd_search_switches_on":
                       sd_search_on, "sd_dpm_search": sd_dpm,
                   "sd_dpm_search_switches_on": sd_dpm_on,
                   "phase_marks": marks, "ptxas_pipelined": ptxas,
                   "kernels_line": line,
                   "total_s": time.time() - t_start}, f, indent=1)
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
