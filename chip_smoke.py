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
   their device time (CUDA events around calls queued behind a head
   start: ``device_ms``), summed per guided step over the classifier's 13
   sites;
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
   (float32, seeded random weights) on the GPU, once on the default path
   (the switches unset: the fused GroupNorm) and once with all three on,
   each against one run of the same steps on the CPU, where every kernel
   is its plain twin (the plain chain of the default path);
5. search: ``adt-torch search`` through its Python entry at full ADM-64
   width (classifier guidance, DDIM-4, chunk 2 x batch 16, 32 samples per
   candidate, population 4, one epoch) with seeded random UNet, classifier
   and Inception weights written as checkpoint files, and reference
   statistics from the port's own Inception features of 64 seeded images;
   run twice, on the default path (the flash kernels and the fused
   GroupNorm: every GroupNorm32 of the UNet and the classifier forward,
   the classifier's backward) and with all three on (all seven kernels).
   Every FID must be finite and >= 0, and each run's launch counters,
   set to 0 just before it, must show every kernel of its path ran as
   many times as its guided steps need;
6. sample: ``adt-torch sample`` with the same checkpoints (classifier
   guidance, a searched 4-step --use_timestep, 32 samples at batch 16),
   ancestral and then DDIM with a 4-entry --skip_layers: the .npz's
   format, the flash forward's, dQ's and dK/dV's launches per guided step
   (as the gate routes the step's 35 sites, 13 with a gradient; the
   GroupNorm forward and backward; no other kernel), images/s;
7. FID commands: ``adt-torch ref-stats`` of 64 seeded images on the GPU,
   then ``adt-torch evaluate`` of the ancestral samples against them (FID,
   IS, precision and recall with --ref_batch) on the GPU and on the CPU,
   TF32 off: every metric in range, the two FIDs within 1e-3 relative;
8. SD kernels: at every attention site of the Stable Diffusion v1 UNet
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
9. SD parity: CLIP on two prompts, two PLMS steps of the UNet with
   classifier-free guidance at batch 1 and one VAE decode, full width,
   float32, seeded random weights, on the GPU on the default path and
   with the switches on, each against one run on the CPU twins; on the
   default path also, at 128 x 128, DPM-Solver-2 over three steps,
   txt2img's DDIM-2 with a --prompt_mask and img2img's encode, posterior
   draw, q_sample and DDIM-2;
10. SD search: ``adt-torch search-sd`` through its Python entry (PLMS-4,
    scale 7.5, 512 x 512, chunk 2 x batch 4, 8 samples per candidate,
    population 4, one epoch) from a seeded random-weight CompVis-layout
    ``.ckpt``, a synthesized byte-level vocabulary and COCO captions file,
    twice (default, switches on), each FID finite and >= 0 and each kernel's
    launches equal to its per-call count from the models times the UNet
    calls and decodes; then ``--sampler dpm_solver`` (five time knots,
    DPM-Solver-2, the smallest population the EA takes) twice, with the
    same launch check;
11. train: ``adt-torch train`` through its Python entry at full ADM-64
    width (bf16, dropout 0.1, batch 16 in two microbatches of 8, EMA
    0.9999) from a seeded uint8 ``.npy`` of 256 images with labels over
    1000 classes, 4 steps with a save at step 2, then a
    ``--resume_checkpoint`` of the save directory for 2 more (the resumed
    model and EMA equal to the saved ones, the step counter going on),
    default and switches on: finite losses, the command's step time, peak
    memory, and each kernel's launches a step (the flash kernels as the
    gate routes the 22 sites of a microbatch: on, 22 each; by default
    every GroupNorm32 forward and backward; on,
    one GroupNorm backward a forward and the fused conv at the in-norms
    only, dropout keeping the out-norm out of it);
12. ``adt-torch train-classifier`` at its defaults (width 128, depth 2)
    over a folder of 32 seeded PNGs, batch 16, 3 steps, default and
    switches on: finite losses, launches a step;
13. ``adt-torch nll`` of the trained EMA checkpoint, one batch of 2 over
    the 1000-step bound: bits/dim finite, seconds;
14. ``adt-torch sample`` of the trained EMA checkpoint, 16 images;
15. train parity: two AdamW + EMA steps of the full-width UNet in float32
    (dropout 0, the same weights, batch, t and noise) on the GPU, default
    and switches on, each against one run on the CPU twins: losses,
    gradient norms, the first step's gradients and every parameter and
    EMA value after the steps within 1e-3 of their scale;
16. data parallel: ``adt-torch train`` (3 steps), ``adt-torch sample``
    (16 images, unguided and guided, the default path) and a guided
    fitness chunk at full ADM-64 width under
    ``python -m torch.distributed.run --standalone --nproc_per_node=1``
    (NCCL, the process group up, so every gradient and moment all-reduce
    runs at world size 1) against the same runs in this process: losses
    and FIDs within 1e-3 relative, pixels within one uint8 level, equal
    launches; the NCCL version and the device time of the ADM-64 gradient
    all-reduce of one step (``chiprun_out/chip_smoke_dist.log``: the
    torchrun process's output);
17. generation kernels: the attention and GroupNorm kernels against their
    twins (bf16 and fp32, sabotaged runs) at every new site of the
    generation commands' default path, read from the models on the meta
    device: the LDM UNets' ADM-layout D = 32 attention, cin's token-major
    D = 32 self-attention and its cross-attention over one class token
    (S = 1), the VQ-f4 mid-block's D = 512 at T 4096 and 16384, SD's
    encoder, and every GroupNorm of those models;
18. LDM parity: ldm-sample's two eta-1 DDIM steps and VQ-f4 decode
    (unconditional and on cin's class token) and inpaint's condition, two
    DDIM steps, decode and composite, full width, float32, 32 x 32 latent,
    GPU against the CPU twins, draws injected, within 1e-3 x scale;
19. ``adt-torch txt2img`` at SD v1 width, 512 x 512, four prompts in one
    batch: PLMS over a searched 4-step --timesteps, DPM-Solver over five
    knots, PLMS with a --prompt_mask; ``convert --preset sd`` and the PLMS
    run again from the params directory, which must give the same images;
20. ``adt-torch img2img`` on a synthesized 512 x 512 PNG, strength 0.75;
21. ``adt-torch ldm-sample`` at celebahq-ldm-vq-4's defaults and with
    ``--num_classes 1000`` at cin256-v2's UNet widths, 10 DDIM steps;
22. ``adt-torch inpaint`` at inpainting_big's defaults on a synthesized
    512 x 512 image and mask pair, 10 DDIM steps. Each of 19-22 runs on
    the default path with its launch counters set to 0 just before and
    read just after (each equal to the per-call counts of the models times
    the command's UNet calls, encodes and decodes), its output's format,
    images/s and peak memory;
23. SR kernels: the flash forward, dQ and dK/dV at the SR training
    step's attention sites (head dim 64: T 1024 with 6 heads, T 256 and 64
    with 12, microbatch 2), the GroupNorm forward at every GroupNorm of
    sr-sample's and the SR training step's UNets and the backward at the
    training step's (batch 2), the conv kernels at the switched-on SR
    training step's sites, and the spatial_v2 classifier head's GroupNorm
    at one position (batch 16), bf16 and fp32, with the sabotaged runs,
    whatever the gate routes;
24. SR parity: two DDIM steps of sr-sample's full-width SR UNet (the 256
    model's widths at 128 x 128), float32, seeded weights, x_T injected,
    GPU against the CPU twins, within 1e-3 x scale;
25. ``adt-torch sr-sample`` at its defaults (DDIM over 1000 steps, bf16)
    on two seeded 64 x 64 base samples: the .npz, launches equal to the
    UNet call's per-call counts x 1000, images/s, peak memory;
26. ``adt-torch train --image_size 256 --sr_small_size 64`` (batch 4 in
    two microbatches, 3 steps) over seeded PNGs, low_res derived and from
    --lq_dir, on the default path and with every kernel on: finite
    losses, launches a step, step time, peak memory;
27. ``adt-torch train-classifier --classifier_pool spatial_v2``, 3 steps;
28. ``adt-torch selftest`` with a synthesized pytorch_fid ``.pth``:
    passed true, certified false, seconds;
29. the default path's guided DDIM-4 run (batch 32, bf16, full width)
    twice from one seed: equal bit for bit;
30. the joint timestep + layer-skip search, ``adt-torch search
    --use_dynamic_unet True --time_step 10 --index_step 580 --max_prun
    0.1 --min_prun 0.0`` at full ADM-64 width with classifier guidance,
    at the cut of 5 (the progressive hook keeps every layer in its first
    epochs): the best candidate and its FID, images/s, launches held to
    the guided steps each chunk ran; then the joint fitness on two
    candidates with the same ten timesteps and other skip lists, folded
    in one chunk beside each other and beside themselves: a candidate's
    FID must not depend on the skip lists of the other rows;
31. LSUN-256 kernels and parity: the flash forward at the unconditional
    LSUN-256 UNet's attention sites (ModelConfig.lsun256: 256 channels,
    legacy QKV order, head dim 64; T 1024 with 8 heads, T 256 and 64 with
    16, batch 32) and the GroupNorm forward at its 128 x 128 and 256 x
    256 sites (batch 32) against their twins, with the sabotaged runs; two
    unconditional DDIM steps of the full-width UNet at 128 x 128, float32,
    GPU against the CPU twins, within 1e-3 x scale;
32. the unconditional LSUN-256 search (search_lsun_bedroom.sh):
    ``adt-torch search`` without a classifier on the preset's flags, bf16,
    DDIM-4, the cut of 5, from seeded weights (their parameter count
    printed) and reference statistics of 64 seeded 256 x 256 images; then
    ``adt-torch sample --class_cond False`` over the published 15-step
    bedroom schedule, 16 images at batch 16: the .npz, images/s, peak
    memory and the launches a UNet call.

The flash gate (ops/flash_attention.py ``FLASH_GATE_SDPA``) routes the
default path's attention sites; "switches on" also turns it off
(``ADT_FLASH_GATE=0``: every site with a kernel on it), and every launch
count expected of a run follows the routes of its environment, held with
the gate off to the literal counts of ``FLASH_ANCHORS``. The smoke run
takes no profile: torch.profiler's runs are the measurements below.

Four measurements run alone, not in the smoke run:

    python3 chip_smoke.py --profiles      # device time by kernel, the A/B
    python3 chip_smoke.py --flash-ab      # the flash gate's A/B
    python3 chip_smoke.py --lost-events   # the profiler's lost kernels
    python3 chip_smoke.py --guided-repro  # is the guided step reproducible

``--profiles`` (``phase_profiles``): one guided DDIM-4 run at batch 32 in
bf16 on the default path under ``torch.profiler``: device time by kernel,
the flash kernels' share (the forward's, the dQ kernel's and the dK/dV
kernel's own lines) and the device's idle share
(``chiprun_out/chip_smoke_profile.txt``); the switches' A/B of that run
(off, the default path, each conv switch alone, the fused norm and the
fused conv, every kernel on): wall and device-busy time per step, idle
share, the GroupNorm forward's and backward's kernels, the dK/dV kernel
and weight- and input-gradient conv time of every run (the guided models
frozen, as the search freezes them: any weight-gradient kernel fails it,
and so does a GroupNorm backward count other than one kernel a call, 17 a
step with all three on, or any batch-sum kernel)
(``chip_smoke_profile_fused.txt``: every kernel on); the training step
driven directly on device-resident data with the switches off, on the
default path and on: wall and device-busy ms a step, idle share,
samples/s, peak memory, and the GroupNorm backward in its every-gradient
form (one batch sum a call) (``chip_smoke_profile_train_<arm>.txt``);
one SD PLMS-4 fitness batch under the same three arms
(``chip_smoke_profile_sd*.txt``): the packed and D = 80 forwards' lines
of a UNet call where the gate keeps them, the wide forward's line of the
decode and the GroupNorm forward's time in each. A profile is taken again
when it comes back short of kernels the launch counters saw
(``profiled``).
``--flash-ab`` (``phase_flash_ab``): every attention site on its kernel
against every site on SDPA, two rounds, device time per site shape from
profiler ranges, inside the guided DDIM step, the SD UNet call (which also
times its D = 160 sites on the float32 twin), the ADM-64 training step,
the SR training step and the LSUN-256 UNet call; it prints the sites it
would send to SDPA beside the committed gate (the classifier's gradient
sites stay on the kernels whatever it reads: ``REPRO_KERNEL_SITES`` in
ops/flash_attention.py).
``--lost-events`` (``phase_lost_events``): how often a whole guided run's
profile misses kernels. ``--guided-repro`` (``phase_guided_repro``): the
guided DDIM-4 run three times from one seed under each arm of
``REPRO_ARMS`` (the default path, the classifier's gradient sites on
SDPA, the flash gate, the fused GroupNorm, cuDNN's convs, SDPA's
backends), how far the runs differ and the device-busy time of a run,
then ``train-classifier``'s step on the default path and with those
sites on SDPA. Each writes its record to ``chiprun_out/`` and exits 0
when it ran to its end.

The last lines of standard output are a ``kernels`` JSON line, the
``nvidia-smi`` name / power-limit line and ``{"ok": true, "device": ...}``.
A fuller record goes to ``chiprun_out/chip_smoke.json``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import functools
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
# the kernels of the ADM-64 path
ADM_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") + NEW_KERNELS
# launches of the GroupNorm and conv kernels per guided DDIM step with the
# three switches on (tests/test_torch_fused_paths.py counts them from the
# models): GroupNorms not folded into a conv, 29 UNet + 17 classifier
# forward and the classifier's 17 backward; the up/down blocks' in-convs,
# 6 + 3; every other ResBlock conv, 66 + 39. The flash kernels' launches
# a step follow the gate (per_step)
PER_STEP_NEW_FUSED = {"group_norm_fwd": 46, "group_norm_bwd": 17,
                      "conv3x3": 9, "conv3x3_fused": 105}
# the environment a user runs with: every switch unset, so GroupNorm32
# takes the fused GroupNorm kernels on CUDA tensors, the convs are
# PyTorch's and the attention sites go where the flash gate sends them
DEFAULT = {"ADT_FUSED_NORM": None, "ADT_IM2COL_CONV": None,
           "ADT_FUSED_CONV": None, "ADT_FLASH_GATE": None}
# the A/B's "off" arm: the float32 GroupNorm chain, no conv kernel
ALL_OFF = {"ADT_FUSED_NORM": "0", "ADT_IM2COL_CONV": "0",
           "ADT_FUSED_CONV": "0", "ADT_FLASH_GATE": None}
# the default path's routes forced where the default does not reach them:
# on the meta device (sites are read there) and on CPU tensors
FUSED_NORM_ALONE = dict(ALL_OFF, ADT_FUSED_NORM="1")
# every kernel on: the three switches, and the flash gate off (every
# attention site with a kernel on it)
SWITCHES_ON = {"ADT_FUSED_NORM": "1", "ADT_IM2COL_CONV": "1",
               "ADT_FUSED_CONV": "all", "ADT_FLASH_GATE": "0"}
# the A/B phase's configurations: the switches off, the default (the fused
# norm alone), each conv switch alone, the fused norm with the fused conv,
# and all on (three rounds of each are in PERF.md)
AB_CONFIGS = [
    ("off", ALL_OFF),
    ("fused_norm (default)", DEFAULT),
    ("im2col", dict(ALL_OFF, ADT_IM2COL_CONV="1")),
    ("fused_conv", dict(ALL_OFF, ADT_FUSED_CONV="all")),
    ("fused_norm+fused_conv", dict(ALL_OFF, ADT_FUSED_NORM="1",
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
    """Set the kernel switches of ``env`` for the block (None: unset),
    then restore."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
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


def device_ms(fn, kernel: str = "", reps: int = 10, tries: int = 4) -> float:
    """Mean device milliseconds of one call of ``fn``: ``reps`` calls
    queued back to back behind a head start (a spin kernel that outlasts
    the host's launches) between two CUDA events, so that the time is the
    device's alone (the kernels and the device's own gaps between them),
    without the host path around them. Where ``kernel`` names a launch
    counter, the timed calls must have launched that kernel ``reps``
    times. A run whose launches outlasted the head start is taken again
    with one four times as long, up to ``tries`` times; then it raises.
    (torch.profiler, which timed these rows before, drops whole short
    profiles in a long process: tools/profiler_window_probe.py.)"""
    import torch

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    fn()
    torch.cuda.synchronize()
    spin = 2_000_000                    # clock cycles, about 1 ms
    for _ in range(tries):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        reset_launch_counts()
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if kernel and LAUNCHES[kernel] != reps:
            raise AssertionError(f"device_ms: {reps} calls launched "
                                 f"{LAUNCHES[kernel]} {kernel}")
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        spin *= 4
    raise AssertionError(f"device_ms: the host's launches of {reps} calls "
                         f"({host_ms:.3f} ms) outlasted every head start")


def phase_kernels(shapes=SHAPES, batch: int = BATCH):
    """Each kernel against its twin on the same inputs (the backward
    kernels fed the twin's lse and delta), then the chain the main path
    runs: FlashAttentionFunction, whose backward takes the forward kernel's
    own lse and output, against the chain of twins, at each (T, heads) of
    ``shapes`` (head dim 64) at ``batch``. Where a tile can be
    dropped (T > 64), a kernel run with one 64-wide tile left out must fall
    outside the limit, so the limit is shown to catch such a fault."""
    import torch
    import torch.nn.functional as F
    from autodiffusion_tpu_torch.ops.flash_attention import (
        FlashAttentionFunction, flash_bwd_dkv, flash_bwd_dkv_plain,
        flash_bwd_dq, flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures = [], []
    for t, h in shapes:
        n = batch * h
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
            q4, k4, v4, do4 = (z.view(batch, h, t, HEAD_DIM)
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
                row = dict(name=name, T=t, S=t, heads=h, batch=batch,
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

    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
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
    saved_flash = fa.flash_attention
    port_nn.fused_group_norm, port_nn.conv3x3 = gn, conv
    port_nn.conv3x3_fused = fused
    fa.flash_attention = lambda q, k, v: torch.empty_like(q)
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
        fa.flash_attention = saved_flash
    per_step = {k: sum(v.values()) for k, v in sites.items()}
    want = dict(PER_STEP_NEW_FUSED)
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


def _gn_bwd_sums64(x, dy, gamma, beta, scale, shift, mu, rstd, groups,
                   silu):
    """(dscale, dshift, dgamma, dbeta) of the GroupNorm backward in float64
    from the same inputs (the twin's arithmetic, group_norm_bwd_plain):
    the exact sums both the kernel's and the twin's float32 sums are
    measured against."""
    import torch

    b, c = x.shape[:2]
    per = c // groups
    xc = x.double().reshape(b, c, -1)
    g = dy.double().reshape(b, c, -1)
    mu_c = mu.double().repeat_interleave(per, dim=1)[..., None]
    rstd_c = rstd.double().repeat_interleave(per, dim=1)[..., None]
    film = 1.0 if scale is None else 1.0 + scale.double()[..., None]
    xhat = (xc - mu_c) * rstd_c
    z = xhat * gamma.double()[None, :, None] + beta.double()[None, :, None]
    du = g
    if silu:
        u = z * film + (0.0 if shift is None else shift.double()[..., None])
        sig = torch.sigmoid(u)
        du = g * (sig * (1.0 + u * (1.0 - sig)))
    dz = du * film
    return ((du * z).sum(-1), du.sum(-1), (dz * xhat).sum((0, 2)),
            dz.sum((0, 2)))


def _rel64(got, exact):
    return float(((got.double() - exact).abs()
                  / (1 + exact.abs())).max())


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
    timed beside the twin, the bound and the nearest library call (the
    median of ``reps`` runs, 2 ``reps`` for the GroupNorm forward). A
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
                # per-channel scales and offsets, and per-group scales, so
                # that the groups' statistics differ and a wrong group's
                # show (with per-channel terms alone, 24 channels a group at
                # C = 768 average the groups' spreads to one)
                g_scale = torch.exp(0.5 * randn(GROUPS)).repeat_interleave(
                    c // GROUPS)[:, None]
                x = ((randn(batch, c, hw) * torch.exp(0.5 * randn(c, 1))
                      + randn(c, 1)) * g_scale).to(dt)
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
                timing = (cuda_ms(lambda: group_norm_fwd(*args),
                                  reps=2 * reps),
                          cuda_ms(lambda: group_norm_fwd_plain(*args),
                                  reps=2 * reps),
                          cuda_ms(lambda: F.group_norm(x, GROUPS, gl, bl,
                                                       eps), reps=2 * reps))
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
                        exact = _gn_bwd_sums64(*bargs)
                        log("    sums against float64 (dscale, dshift, "
                            "dgamma, dbeta), max |d| / (1 + |exact|): "
                            "kernel " + " ".join(
                                f"{_rel64(a, e):.2e}"
                                for a, e in zip(got[1:], exact))
                            + ", twin " + " ".join(
                                f"{_rel64(a, e):.2e}"
                                for a, e in zip(want[1:], exact)))
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

    # device events less user annotations (the optimizer's
    # ``Optimizer.step#AdamW.step`` range spans kernels counted already)
    # and less ``profiled``'s pre-roll
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")
               and "spin_kernel" not in e.key]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy, kernels


def profile_lines(kernels, steps: int, top: int = 25):
    return [f"{e.self_device_time_total / 1e3 / steps:10.3f} ms/step "
            f"{e.count // steps:6d} calls/step  {e.key[:120]}"
            for e in kernels[:top]]


def guided_run(unet_sd, cls_sd, steps: int = 4):
    """(run, models): one guided DDIM run of ``steps`` steps (4 unless
    given) at batch 32, full width, bf16, of seeded random weights, as the
    profile and A/B phases time it."""
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
    tables = build_tables(f"ddim{steps}", base_schedule="cosine").to("cuda")
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
                prof, launched, _ = profiled(run)
                gn_bwd_launches = launched["group_norm_bwd"] / 4
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
            # 17 calls of PER_STEP_NEW_FUSED (the fused norm alone also takes
            # the GroupNorms the fused conv folds)
            want = gn_bwd_launches if name != "all" \
                else PER_STEP_NEW_FUSED["group_norm_bwd"]
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


# the pre-roll of a profiled run: this many empty spin kernels launched
# inside the window before the run, four times as many on each retake
PRE_ROLL = 1000


def profiled(fn, tries: int = 3, warm: bool = False):
    """(profile, launches, fn's result) of one run of ``fn`` under
    torch.profiler, the device synchronised at its end, with 20 ms of idle
    host time on either side inside the window; with ``warm``, after a
    warm-up iteration inside the profile whose events are dropped
    (schedule warmup=1: the A/B arms' first calls). In a long process the
    profiler drops the first kernels of a window, more of them the older
    the process (tools/profiler_window_probe.py: a count of launches, not
    a stretch of time), so the run follows a pre-roll of ``PRE_ROLL``
    empty spin kernels, which no measurement reads. A profile missing
    kernels that the launch counters saw (``profile_counts``) is taken
    again with a pre-roll four times as long, up to ``tries`` times; the
    last one is returned whatever it holds. The launch counters count the
    recorded run alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warm else None
    pre_roll = PRE_ROLL
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            if warm:
                fn()
                torch.cuda.synchronize()
                prof.step()
            reset_launch_counts()
            time.sleep(0.02)
            for _ in range(pre_roll):
                torch.cuda._sleep(0)
            out = fn()
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            time.sleep(0.02)
            if warm:
                prof.step()
        counts = profile_counts(prof)
        short = {k: (counts[k], launches.get(k, 0)) for k in counts
                 if counts[k] != launches.get(k, 0)}
        if not short:
            break
        log(f"profile dropped kernels (profiled, launched) {short} after a "
            f"pre-roll of {pre_roll}: taken again")
        pre_roll *= 4
    return prof, launches, out


# the bf16 kernels in a profile, by launch counter: each launch runs one
# of them (a GroupNorm forward either the resident kernel or the split
# one's apply pass, after its partial sums)
PROFILE_TAGS = {"flash_fwd": ("flash_fwd_tma_kernel",),
                "flash_fwd_packed": ("flash_fwd_packed_kernel",),
                "flash_fwd_wide": ("flash_fwd_wide_kernel",),
                "flash_bwd_dq": ("flash_bwd_dq_tma_kernel",),
                "flash_bwd_dkv": ("flash_bwd_dkv_tma_kernel",),
                "group_norm_fwd": ("group_norm_fwd_resident_kernel",
                                   "group_norm_fwd_apply_kernel"),
                "group_norm_bwd": ("group_norm_bwd_kernel",)}


def profile_counts(prof):
    """{launch counter: its kernels in ``prof``} (bf16 runs)."""
    import torch

    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(any(tag in e.name for tag in tags) for e in evs)
            for k, tags in PROFILE_TAGS.items()}


@contextlib.contextmanager
def repro_sites_on_sdpa():
    """The sites the port keeps on the kernels for reproducibility
    (ops/flash_attention.py ``REPRO_KERNEL_SITES``: the classifier's
    gradient sites) added to the flash gate's table for the block: the
    guided step and train-classifier's as the gate routed them when the
    A/B alone decided (SDPA, forward and backward)."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    saved = fa.FLASH_GATE_SDPA
    fa.FLASH_GATE_SDPA = saved | fa.REPRO_KERNEL_SITES
    try:
        yield
    finally:
        fa.FLASH_GATE_SDPA = saved


@contextlib.contextmanager
def cudnn_convs_deterministic():
    """cuDNN's convolutions limited to its deterministic algorithms."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@contextlib.contextmanager
def sdpa_arm(backend: str = "", deterministic: bool = False):
    """SDPA limited to ``backend`` (torch.nn.attention's SDPBackend name,
    "" for PyTorch's own choice), optionally under
    ``torch.use_deterministic_algorithms``."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    old = torch.are_deterministic_algorithms_enabled()
    with contextlib.ExitStack() as stack:
        if backend:
            stack.enter_context(sdpa_kernel(getattr(SDPBackend, backend)))
        if deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(old)


# the arms of phase_guided_repro: (label, kernel switches, a context the
# runs take place in)
REPRO_ARMS = [
    ("default", DEFAULT, contextlib.nullcontext),
    ("classifier sites on SDPA", DEFAULT, repro_sites_on_sdpa),
    ("flash gate off", {"ADT_FLASH_GATE": "0"}, contextlib.nullcontext),
    ("fused norm off", {"ADT_FUSED_NORM": "0"}, contextlib.nullcontext),
    ("gate off + fused norm off", {"ADT_FLASH_GATE": "0",
                                   "ADT_FUSED_NORM": "0"},
     contextlib.nullcontext),
    ("cudnn convs deterministic", DEFAULT, cudnn_convs_deterministic),
    ("sdpa cudnn", DEFAULT, lambda: sdpa_arm("CUDNN_ATTENTION")),
    ("sdpa flash", DEFAULT, lambda: sdpa_arm("FLASH_ATTENTION")),
    ("sdpa flash, deterministic algorithms", DEFAULT,
     lambda: sdpa_arm("FLASH_ATTENTION", True)),
    ("sdpa efficient", DEFAULT, lambda: sdpa_arm("EFFICIENT_ATTENTION")),
    ("deterministic algorithms", DEFAULT, lambda: sdpa_arm("", True)),
]


def phase_guided_repro(unet_sd, cls_sd, repeats: int = 3, arms=REPRO_ARMS,
                       busy: bool = True):
    """Is the guided step reproducible? The guided DDIM-4 run (batch 32,
    full width, bf16, seeded weights) ``repeats`` times from the same seed
    in one process under each arm of ``arms``: the largest difference
    from the first run (float, and in uint8 levels), the share of
    elements that differ, the median wall time of a run and, with
    ``busy``, the device-busy time of one more run (profiled). An arm
    whose runs agree bit for bit is deterministic; the one arm that
    changes one thing against the default names the cause."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_tables
    from autodiffusion_tpu_torch.search import to_uint8

    _, (m, c) = guided_run(unet_sd, cls_sd)
    tables = build_tables("ddim4", base_schedule="cosine").to("cuda")

    def once():
        gen = torch.Generator(device="cuda").manual_seed(5)
        y = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
        out = ddim_sample_loop(lambda x, t, i: m(x, t, y), (32, 3, 64, 64),
                               tables, device="cuda", generator=gen,
                               cond_fn=classifier_cond_fn(c, y, 1.0))
        torch.cuda.synchronize()
        return out

    res = {}
    for label, env, arm in arms:
        with switches(env), arm():
            once()                                  # warm-up
            outs, walls = [], []
            for _ in range(repeats):
                t0 = time.time()
                outs.append(once())
                walls.append(time.time() - t0)
            busy_ms = device_busy(profiled(once)[0], 1)[0] if busy else None
        ref = outs[0]
        diff = max(float((o - ref).abs().max()) for o in outs[1:])
        share = max(float((o != ref).float().mean()) for o in outs[1:])
        u8 = to_uint8(ref).cpu().numpy().astype(np.int16)
        levels = max(int(np.abs(to_uint8(o).cpu().numpy() - u8).max())
                     for o in outs[1:])
        res[label] = dict(max_abs_diff=diff, share_differing=share,
                          uint8_levels=levels,
                          wall_ms=1e3 * sorted(walls)[repeats // 2],
                          busy_ms=busy_ms)
        log(f"guided repro [{label}]: {repeats} runs, max |diff| {diff:.3e}"
            f", {share:.2%} of elements differ, {levels} uint8 level(s), "
            f"{res[label]['wall_ms']:.1f} ms a run (wall)"
            + (f", device busy {busy_ms:.2f} ms a run" if busy else ""))
    return res


def phase_default_repro(unet_sd, cls_sd):
    """The default path's guided DDIM-4 run (batch 32, full width, bf16,
    seeded weights) twice from one seed after a warm-up
    (phase_guided_repro's "default" arm): the two outputs must be equal
    bit for bit."""
    res = phase_guided_repro(unet_sd, cls_sd, repeats=2,
                             arms=REPRO_ARMS[:1], busy=False)["default"]
    if res["max_abs_diff"] != 0 or res["share_differing"] != 0:
        raise AssertionError(f"two default guided DDIM-4 runs from one "
                             f"seed differ: {res}")
    return res


def phase_lost_events(unet_sd, cls_sd, tries: int = 1):
    """The profiler's lost kernels, measured: the guided DDIM-4 run at
    batch 32 (default path) profiled ``tries`` times with a window opened
    on the run itself and ``tries`` times with a
    warm-up iteration and idle time on either side (one try of
    ``profiled``). For each profile, each kernel's profiled count against
    its launch counter, the device events recorded, and where in the run
    they lie (the share of the recorded kernels in each tenth of the span
    from the first to the last: a stretch lost inside or at an end shows
    as a thin tenth). Returns the records; raises nothing (the checks that
    read profiles take a profile again when it drops kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    run, _ = guided_run(unet_sd, cls_sd)
    run()
    torch.cuda.synchronize()
    out = {"bare": [], "warm-up": []}
    for _ in range(tries):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out["bare"].append((prof, dict(LAUNCHES)))
        prof2, launches, _ = profiled(run, tries=1, warm=True)
        out["warm-up"].append((prof2, launches))
    summary = {}
    for how, profs in out.items():
        rows = []
        for prof, launches in profs:
            counts = profile_counts(prof)
            evs = sorted((e.time_range.start for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)
                          and "spin_kernel" not in e.name))
            lo, hi = evs[0], evs[-1]
            tenths = [0] * 10
            for t in evs:
                tenths[min(9, int(10 * (t - lo) / max(hi - lo, 1)))] += 1
            missing = {k: launches.get(k, 0) - counts[k] for k in counts
                       if launches.get(k, 0) != counts[k]}
            rows.append(dict(missing=missing, n_device_events=len(evs),
                             span_ms=(hi - lo) / 1e3, tenths=tenths))
        lost = sum(bool(r["missing"]) for r in rows)
        summary[how] = dict(profiles=rows, profiles_missing_kernels=lost)
        log(f"lost events ({how}): {lost} of {len(rows)} profiles miss "
            "kernels")
        for r in rows:
            log(f"  missing {r['missing'] or 'none'}, {r['n_device_events']} "
                f"device events over {r['span_ms']:.1f} ms, by tenth "
                f"{r['tenths']}")
    return summary


# ------------------------------------------------------------ the flash gate

FLASH_KERNELS = ("flash_fwd", "flash_fwd_packed", "flash_fwd_wide",
                 "flash_bwd_dq", "flash_bwd_dkv")


def attention_sites(run, grad: bool = False):
    """{(T, S, D, heads, gradient wanted): calls} of the attention calls
    ``run`` makes on the meta device (record_sites under the default
    path's routes): the keys of the flash gate. ``grad`` leaves autograd
    on (training; guidance's classifier), else the run is under
    torch.no_grad() as sampling is."""
    routes = {}
    record_sites(run, FUSED_NORM_ALONE, grad=grad, routes=routes)
    return routes


def flash_counts(sites):
    """{flash kernel: launches} of one call of a program with attention
    ``sites``, as attention_route sends them on the card now (the gate
    read from the environment): a kernel site launches its forward (the
    packed kernel at D = 40, the wide one at D = 512) and, where a
    gradient is wanted, dQ and dK/dV."""
    from autodiffusion_tpu_torch.ops.flash_attention import (
        PACKED_HEAD_DIMS, WIDE_HEAD_DIM, attention_route)

    out = dict.fromkeys(FLASH_KERNELS, 0)
    for (t, s, d, heads, grad), n in sites.items():
        if attention_route(t, s, d, heads, grad, "cuda") != "kernel":
            continue
        fwd = ("flash_fwd_packed" if d in PACKED_HEAD_DIMS else
               "flash_fwd_wide" if d == WIDE_HEAD_DIM else "flash_fwd")
        out[fwd] += n
        if grad:
            out["flash_bwd_dq"] += n
            out["flash_bwd_dkv"] += n
    return out


@functools.lru_cache(maxsize=None)
def _sites_of_programs():
    return program_sites()


# the flash launches of one call of each program with every site on its
# kernel (ADT_FLASH_GATE=0, the switches-on runs), fixed by the models'
# widths: a guided DDIM step, the UNet's 22 forward-only sites and the
# classifier's 13 with their backward; a training microbatch of the ADM-64
# UNet and of the SR UNet, 22 sites each with their backward (44 an SR
# step of two microbatches). The counts flash_counts derives from the
# recorded sites and attention_route must meet them.
FLASH_ANCHORS = {
    "guided": {"flash_fwd": 35, "flash_bwd_dq": 13, "flash_bwd_dkv": 13},
    "adm_train": {"flash_fwd": 22, "flash_bwd_dq": 22, "flash_bwd_dkv": 22},
    "sr_train": {"flash_fwd": 22, "flash_bwd_dq": 22, "flash_bwd_dkv": 22},
    "lsun_unet": {"flash_fwd": 16, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
}
# ... and with the committed gate (the default path): the guided step's
# UNet keeps its 15 forward-only sites at T 1024 and 64 on the kernel
# (SDPA at its 7 sites at T 256) and the classifier its 13 sites, forward,
# dQ and dK/dV, for reproducibility (REPRO_KERNEL_SITES)
FLASH_DEFAULT_ANCHORS = {
    "guided": {"flash_fwd": 28, "flash_bwd_dq": 13, "flash_bwd_dkv": 13},
    # the LSUN-256 UNet call: its 5 sites at T 1024 and 6 at T 64 (SDPA
    # at its 5 at T 256)
    "lsun_unet": {"flash_fwd": 11, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
}


def flash_per_call(program: str, env=None):
    """flash_counts of one call of ``program`` (program_sites) under the
    switches of ``env`` (the default path's if None); held to the
    program's FLASH_ANCHORS with the gate off, to its
    FLASH_DEFAULT_ANCHORS with the committed gate."""
    from autodiffusion_tpu_torch.ops.flash_attention import flash_gate_on

    with switches(DEFAULT if env is None else env):
        out = flash_counts(_sites_of_programs()[program])
        anchor = (FLASH_ANCHORS if not flash_gate_on()
                  else FLASH_DEFAULT_ANCHORS).get(program, {})
    wrong = {k: (out[k], n) for k, n in anchor.items() if out[k] != n}
    if wrong:
        raise AssertionError(f"{program}: flash launches a call (derived, "
                             f"literal) {wrong}")
    return out


def per_step(env=None, **new):
    """{kernel: launches} of one guided DDIM step: the flash kernels as
    the gate routes the step's sites under ``env``, the GroupNorm and conv
    kernels as given (0 where not)."""
    out = dict.fromkeys(KERNEL_INFO, 0)
    out.update(flash_per_call("guided", env))
    out.update(new)
    return out


# the SR models of the slice: sr-sample's defaults (the JAX CLI's flags,
# guided-diffusion's 64 -> 256 upsampler widths; "16,8" with 4 heads: head
# dim 192) and adt train --image_size 256 --sr_small_size 64's (train's
# defaults: 3 res blocks, head width 64 at 32, 16 and 8)
SR_LARGE, SR_SMALL = 256, 64
SR_TRAIN_BATCH, SR_TRAIN_MICRO = 4, 2


def sr_config(kind: str, **over):
    from autodiffusion_tpu_torch.models import ModelConfig

    if kind == "sample":
        base = dict(image_size=SR_LARGE, num_channels=192, num_res_blocks=2,
                    learn_sigma=True, noise_schedule="linear",
                    class_cond=True, use_bf16=True)
    else:
        base = dict(image_size=SR_LARGE, num_channels=192, num_res_blocks=3,
                    num_head_channels=64, attention_resolutions="32,16,8",
                    class_cond=True, learn_sigma=True,
                    noise_schedule="cosine", dropout=0.1,
                    resblock_updown=True, use_scale_shift_norm=True,
                    use_new_attention_order=True, use_bf16=True)
    base.update(over)
    return ModelConfig(**base)


def program_sites():
    """{program: attention sites of one of its calls}: the guided DDIM
    step (the UNet without gradient, the classifier with the input's), the
    SD UNet call, the ADM-64 training step (a microbatch), the classifier's
    training step (train-classifier's defaults), the SR training step (a
    microbatch), the sr-sample UNet call and the LSUN-256 UNet call, read
    on the meta device."""
    import torch
    from autodiffusion_tpu_torch.models import (SD_V1_UNET, ClassifierConfig,
                                                ModelConfig, SDUNetModel,
                                                create_classifier,
                                                create_model, create_sr_model)

    with torch.device("meta"):
        unet = create_model(ModelConfig.adm64(), device="meta")
        cls = create_classifier(ClassifierConfig.adm64(), device="meta")
        cls.requires_grad_(False)
        cls_train = create_classifier(ClassifierConfig(), device="meta")
        sd_unet = SDUNetModel(**SD_V1_UNET)
        sr_train = create_sr_model(sr_config("train"), SR_LARGE, SR_SMALL,
                                   device="meta")
        sr_sample = create_sr_model(sr_config("sample"), SR_LARGE, SR_SMALL,
                                    device="meta")
        lsun = create_model(ModelConfig.lsun256(), device="meta")

    def t():
        return torch.zeros(1)

    def y():
        return torch.zeros(1, dtype=torch.long)

    guided = attention_sites(lambda: unet(torch.empty(1, 3, 64, 64), t(),
                                          y()))
    for key, n in attention_sites(lambda: cls(
            torch.empty(1, 3, 64, 64, requires_grad=True), t()),
            grad=True).items():
        guided[key] = guided.get(key, 0) + n
    low = torch.empty(1, 3, SR_SMALL, SR_SMALL)
    big = torch.empty(1, 3, SR_LARGE, SR_LARGE)
    return {
        "guided": guided,
        "sd_unet": attention_sites(lambda: sd_unet(
            torch.empty(1, 4, 64, 64), t(), torch.empty(1, 77, 768))),
        "adm_train": attention_sites(lambda: unet(
            torch.empty(1, 3, 64, 64), t(), y()), grad=True),
        "classifier_train": attention_sites(lambda: cls_train.requires_grad_(
            True)(torch.empty(1, 3, 64, 64), t()), grad=True),
        "sr_train": attention_sites(lambda: sr_train(big, t(), low, y()),
                                    grad=True),
        "sr_sample": attention_sites(lambda: sr_sample(big, t(), low, y())),
        "lsun_unet": attention_sites(lambda: lsun(
            torch.empty(1, 3, LSUN_SIZE, LSUN_SIZE), t())),
    }


class _EverySite:
    """A gate table that holds every site: the A/B's "SDPA" arm."""

    def __contains__(self, key):
        return True


@contextlib.contextmanager
def flash_arm(arm: str):
    """The attention routes of one arm of the flash A/B: "kernels" every
    site with a kernel on it (ADT_FLASH_GATE=0), "sdpa" every site on SDPA,
    "f32_160" the D = 160 sites on the float32 twin (their route before
    this A/B), every other site as the committed gate sends it."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    saved = (fa.FLASH_GATE_SDPA, fa.attention_route)
    real = fa.attention_route

    def f32_160(t, s, d, heads, grad, device):
        return "twin" if d == 160 else real(t, s, d, heads, grad, device)

    env = {"ADT_FLASH_GATE": "0" if arm == "kernels" else None}
    try:
        if arm == "sdpa":
            fa.FLASH_GATE_SDPA = _EverySite()
        elif arm == "f32_160":
            fa.attention_route = f32_160
        with switches(env):
            yield
    finally:
        fa.FLASH_GATE_SDPA, fa.attention_route = saved


@functools.lru_cache(maxsize=None)
def _range_edge():
    """An autograd identity on its tensors whose backward opens
    (``opening``) or closes a profiler range: placed after a site's output
    and before its inputs, it brackets the site's backward kernels."""
    import torch

    class RangeEdge(torch.autograd.Function):
        @staticmethod
        def forward(ctx, ranges, name, opening, *xs):
            ctx.ranges, ctx.name, ctx.opening = ranges, name, opening
            out = tuple(x.view_as(x) for x in xs)
            return out if len(out) > 1 else out[0]

        @staticmethod
        def backward(ctx, *grads):
            if ctx.opening:
                ctx.ranges.append(torch.profiler.record_function(ctx.name))
                ctx.ranges[-1].__enter__()
            elif ctx.ranges:
                ctx.ranges.pop().__exit__(None, None, None)
            return (None, None, None) + grads

    return RangeEdge


def site_profiled(fn, q, k, v, key, route: str):
    """``fn(q, k, v)`` inside a profiler range named ``attention T.. S..
    D.. H.. fwd|grad <route>`` for the site ``key`` (T, S, D, heads,
    gradient wanted), and its backward inside the same name plus
    " backward", so that a profile attributes device time to each site
    shape."""
    import torch

    t, s, d, heads, grad = key
    name = (f"attention T{t} S{s} D{d} H{heads} "
            f"{'grad' if grad else 'fwd'} {route}")
    ranges = []
    if grad:
        q, k, v = _range_edge().apply(ranges, name + " backward", False,
                                      q, k, v)
    with torch.profiler.record_function(name):
        out = fn(q, k, v)
    if grad and out.requires_grad:
        out = _range_edge().apply(ranges, name + " backward", True, out)
    return out


@contextlib.contextmanager
def site_ranges():
    """Every attention site's work (ops/flash_attention ``_attend``, which
    ``routed_attention`` calls for both models' sites) inside its
    ``site_profiled`` ranges."""
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    real = fa._attend

    def ranged(key, route, q, k, v, tokens_first):
        return site_profiled(
            lambda q, k, v: real(key, route, q, k, v, tokens_first),
            q, k, v, key, route)

    fa._attend = ranged
    try:
        yield
    finally:
        fa._attend = real


def site_ms(prof):
    """{(T, S, D, heads, grad): device ms} of a profile's attention ranges
    (``site_ranges``: a site's forward and, where a gradient flows, its
    backward), summed over the site's calls: each
    range's span on the device (the profiler's GPU-side copy of the range,
    from its first kernel to its last) holds the kernels of the call alone
    (one stream), and the site's time is the sum of their durations. (The
    CPU-side range's device time misses the kernels the port launches
    through ctypes: the profiler links a kernel to the innermost operator,
    and a user range is none.)"""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and "spin_kernel" not in e.name)
    starts = [k[0] for k in kern]
    out = {}
    for e in prof.events():
        if e.device_type != cuda or not e.name.startswith("attention T"):
            continue
        m = re.match(r"attention T(\d+) S(\d+) D(\d+) H(\d+) (fwd|grad)",
                     e.name)
        key = (int(m[1]), int(m[2]), int(m[3]), int(m[4]), m[5] == "grad")
        lo = bisect.bisect_left(starts, e.time_range.start)
        ms = 0.0
        for a, b in kern[lo:]:
            if a > e.time_range.end:
                break
            if b <= e.time_range.end:
                ms += (b - a) / 1e3
        out[key] = out.get(key, 0.0) + ms
    return out


def flash_programs(unet_sd, cls_sd):
    """{program: (one run of it on the card, its attention sites' unit)}:
    a guided DDIM-2 run at batch 32 (ADM-64, bf16), an SD v1 UNet call at
    batch 16 (bf16, random weights), an ADM-64 training step of one
    microbatch of 8, an SR training step of one microbatch of 2 (256
    from 64), the commands' microbatches, and an LSUN-256 UNet call at the
    search's batch of 32 (bf16, random weights), each at full width; the
    training steps in train mode with dropout."""
    import torch
    from autodiffusion_tpu_torch.models import (SD_V1_UNET, ModelConfig,
                                                SDUNetModel, create_model,
                                                create_sr_model)
    from autodiffusion_tpu_torch.schedules import build_base_tables
    from autodiffusion_tpu_torch.train import (create_train_state,
                                               make_train_step)

    gen = torch.Generator(device="cuda").manual_seed(21)
    guided, _ = guided_run(unet_sd, cls_sd, steps=2)
    with torch.device("cuda"):
        sd_unet = SDUNetModel(**SD_V1_UNET, dtype=torch.bfloat16).eval()
    sd_unet.requires_grad_(False)
    sd_x = torch.randn(SD_UNET_BATCH, 4, 64, 64, device="cuda",
                       generator=gen)
    sd_t = torch.full((SD_UNET_BATCH,), 500.0, device="cuda")
    sd_ctx = torch.randn(SD_UNET_BATCH, 77, 768, device="cuda", generator=gen)

    def sd_call():
        with torch.no_grad():
            return sd_unet(sd_x, sd_t, sd_ctx)

    lsun = create_model(ModelConfig.lsun256(dropout=0.0), device="cuda")
    lsun.requires_grad_(False)
    lsun_x = torch.randn(LSUN_BATCH, 3, LSUN_SIZE, LSUN_SIZE, device="cuda",
                         generator=gen)
    lsun_t = torch.full((LSUN_BATCH,), 500.0, device="cuda")

    def lsun_call():
        with torch.no_grad():
            return lsun(lsun_x, lsun_t)

    def train_step(model, batch, micro):
        state = create_train_state(model, ema_rates=(0.9999,))
        step = make_train_step(model, class_cond=True, microbatches=micro)
        tables = build_base_tables("cosine").to("cuda")
        n = batch["x"].shape[0]
        t = torch.randint(0, 1000, (n,), device="cuda", generator=gen)
        w = torch.ones(n, device="cuda")
        return lambda: step(state, tables, batch, t, w, gen)[1]["loss"]

    torch.manual_seed(0)
    adm = create_model(ModelConfig.adm64(), device="cuda").train()
    adm_batch = {"x": torch.rand(TRAIN_MICRO, 3, 64, 64, device="cuda",
                                 generator=gen) * 2 - 1,
                 "y": torch.randint(0, 1000, (TRAIN_MICRO,), device="cuda",
                                    generator=gen)}
    sr = create_sr_model(sr_config("train"), SR_LARGE, SR_SMALL,
                         device="cuda").train()
    x = torch.rand(SR_TRAIN_MICRO, 3, SR_LARGE, SR_LARGE, device="cuda",
                   generator=gen) * 2 - 1
    sr_batch = {"x": x, "low_res": torch.nn.functional.avg_pool2d(
        x, SR_LARGE // SR_SMALL),
        "y": torch.randint(0, 1000, (SR_TRAIN_MICRO,), device="cuda",
                           generator=gen)}
    return {"guided": (guided, "guided DDIM-2 run (2 steps)"),
            "sd_unet": (sd_call, "UNet call"),
            "adm_train": (train_step(adm, adm_batch, 1),
                          "training step of one microbatch"),
            "sr_train": (train_step(sr, sr_batch, 1),
                         "training step of one microbatch"),
            "lsun_unet": (lsun_call, "UNet call")}


def phase_flash_ab(unet_sd, cls_sd, sites, rounds: int = 2):
    """The flash gate's A/B (rule 4), inside each program that owns
    attention sites: every site on its kernel ("kernels",
    ADT_FLASH_GATE=0) against every site on SDPA ("sdpa"), and in the SD
    UNet call the D = 160 sites on the float32 twin ("f32_160"), ``rounds``
    rounds with the arms in turn; each run profiled (``profiled``), the
    device time of each site shape read from its profiler ranges (forward
    and backward together). A site goes to SDPA where its SDPA time is
    below the kernel's in every round by more than the spread of the
    rounds (the larger of the two arms' max - min), but for
    REPRO_KERNEL_SITES, which stay on the kernels (their runs repeat
    bit for bit, SDPA's backward's do not). Also each run's device
    busy time and the profiled kernels against the launch counters.
    Returns {program: {...}} and the sites the A/B sends to SDPA."""
    import torch
    import autodiffusion_tpu_torch.ops.flash_attention  # noqa: F401

    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    programs = flash_programs(unet_sd, cls_sd)
    res, gate = {}, set()
    for name, (fn, unit) in programs.items():
        arms = ["kernels", "sdpa"] + (["f32_160"] if name == "sd_unet"
                                      else [])
        per = {arm: [] for arm in arms}
        busy = {arm: [] for arm in arms}
        by_name = {}
        for rnd in range(rounds):
            for arm in (arms if rnd % 2 == 0 else arms[::-1]):
                with flash_arm(arm), site_ranges():
                    prof, launches, out = profiled(fn, warm=True)
                if not torch.isfinite(torch.as_tensor(out)).all():
                    raise AssertionError(f"flash A/B {name} {arm}: "
                                         "non-finite output")
                counts = profile_counts(prof)
                lost = {k: (counts[k], launches[k]) for k in counts
                        if counts[k] != launches.get(k, 0)}
                if lost:
                    raise AssertionError(f"flash A/B {name} {arm}: profiled "
                                         f"kernels != launches {lost}")
                ms = site_ms(prof)
                missing = set(sites[name]) - set(ms)
                if missing or any(v <= 0 for v in ms.values()):
                    raise AssertionError(
                        f"flash A/B {name} {arm}: no device time for sites "
                        f"{sorted(missing)} ({ms})")
                per[arm].append(ms)
                b_ms, kernels = device_busy(prof, 1)
                busy[arm].append(b_ms)
                by_name[arm] = {e.key: e.self_device_time_total / 1e3
                                for e in kernels}
        rows = []
        for key in sorted(sites[name]):
            k_ms = [r[key] for r in per["kernels"]]
            s_ms = [r[key] for r in per["sdpa"]]
            spread = max(max(k_ms) - min(k_ms), max(s_ms) - min(s_ms))
            to_sdpa = all(k - s > spread for k, s in zip(k_ms, s_ms))
            row = dict(site=list(key), calls=sites[name][key],
                       kernel_ms=k_ms, sdpa_ms=s_ms, spread_ms=spread,
                       to_sdpa=to_sdpa)
            if "f32_160" in per and key[2] == 160:
                row["f32_twin_ms"] = [r[key] for r in per["f32_160"]]
            rows.append(row)
            has_kernel = _gate_off_route(key) == "kernel"
            kept = key in fa.REPRO_KERNEL_SITES
            if to_sdpa and has_kernel and not kept:
                gate.add(key)
            twin = ""
            if "f32_twin_ms" in row:
                twin = (", float32 twin "
                        f"{['%.4f' % v for v in row['f32_twin_ms']]} ms")
            route = ("SDPA (no kernel: by shape)" if not has_kernel
                     else "kernel (kept: reproducibility)" if kept
                     else "SDPA" if to_sdpa else "kernel")
            log(f"flash A/B {name} {key}: x{sites[name][key]} kernels "
                f"{['%.4f' % v for v in k_ms]} ms, SDPA "
                f"{['%.4f' % v for v in s_ms]} ms{twin} (spread "
                f"{spread:.4f}) -> {route}")
        # where the arms' device time differs, by kernel (the last round)
        names = set(by_name["kernels"]) | set(by_name["sdpa"])
        diff = sorted(((by_name["sdpa"].get(n, 0.0)
                        - by_name["kernels"].get(n, 0.0), n) for n in names),
                      key=lambda d: -abs(d[0]))[:8]
        res[name] = dict(unit=unit, rows=rows,
                         busy_ms={arm: v for arm, v in busy.items()},
                         sdpa_minus_kernels_ms=[(round(d, 4), n[:100])
                                                for d, n in diff])
        log(f"flash A/B {name}: device busy a {unit}: " + ", ".join(
            f"{arm} {['%.3f' % v for v in b]} ms" for arm, b in busy.items()))
        for d, n in diff:
            log(f"flash A/B {name}: sdpa - kernels {d:+.4f} ms  {n[:110]}")
    del programs
    torch.cuda.empty_cache()
    committed = set(fa.FLASH_GATE_SDPA)
    log(f"flash A/B: the sites it sends to SDPA {sorted(gate)}; the "
        f"committed gate {sorted(committed)} "
        f"({'the same' if gate == committed else 'differs'})")
    return res, sorted(gate)


def _gate_off_route(key):
    from autodiffusion_tpu_torch.ops.flash_attention import attention_route

    with switches({"ADT_FLASH_GATE": "0"}):
        return attention_route(*key, "cuda")


def phase_profile(unet_sd, cls_sd):
    """One guided DDIM-4 run at batch 32, full width, bf16: host-clock time
    per step, then the same run under torch.profiler for device time by
    kernel. Device busy share = summed kernel time / unprofiled wall."""
    import torch

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
    prof = profiled(run)[0]
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
    routed = flash_per_call("guided")
    for label, tag in (("flash_fwd", "flash_fwd_tma_kernel"),
                       ("flash_bwd_dq", "flash_bwd_dq_tma_kernel"),
                       ("flash_bwd_dkv", "flash_bwd_dkv_tma_kernel")):
        sel = [e for e in kernels if tag in e.key]
        if not sel and routed[label]:
            raise AssertionError(f"profile: no {tag} in the step")
        for line in profile_lines(sel, 4):
            log(f"profile ({label}): " + line)
        own[label] = sum(e.self_device_time_total for e in sel) / 1e3 / 4
    return dict(step_ms=step_ms, busy_ms=busy_ms, flash_ms=flash_ms,
                flash_fwd_ms=own["flash_fwd"], dq_ms=own["flash_bwd_dq"],
                dkv_ms=own["flash_bwd_dkv"],
                kernels_per_step=n_kernels, peak_gb=peak_gb, top=lines)


def phase_parity(unet_sd, cls_sd, envs):
    """Two guided DDIM steps and two guided ancestral steps (the same x_T
    and per-step z on both devices) of the full-width models in float32:
    the GPU (the kernels) under the switches of each of ``envs`` ({label:
    env}) against one CPU run on the default path (the plain chain, the
    same function), same weights. Each output within 1e-3 x its scale.
    Returns {label: ({"ddim2": err, "ancestral2": err}, the GPU run's
    kernel launches)}."""
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
        outs, launches = {}, {}
        for dev, label, env in ([("cpu", "cpu", DEFAULT)]
                                + [("cuda", k, v) for k, v in envs.items()]):
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
                    outs[(name, label)] = out.cpu()
            launches[label] = dict(LAUNCHES)
            log(f"parity ({label}) on {dev}: {time.time() - t0:.1f} s")
            del m, c
        result = {}
        for label in envs:
            errs = {}
            for name in ("ddim2", "ancestral2"):
                got, want = outs[(name, label)], outs[(name, "cpu")]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"non-finite guided {name} output "
                                         f"on the GPU ({label})")
                errs[name] = float((got - want).abs().max())
                scale = float(want.abs().max())
                log(f"parity ({label}): guided {name}, ADM-64 float32, GPU "
                    f"vs CPU max abs err {errs[name]:.3e} (output max "
                    f"{scale:.3f}, tol 1e-3 x scale)")
                if not errs[name] <= 1e-3 * max(scale, 1.0):
                    raise AssertionError(f"GPU guided {name} ({label}) "
                                         f"disagrees with the CPU twin: "
                                         f"{errs[name]}")
            log(f"parity ({label}): GPU launches {launches[label]}")
            result[label] = (errs, launches[label])
        return result
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


@contextlib.contextmanager
def chunk_recorder(chunks):
    """Appends (steps a candidate, batches) of every fitness chunk the
    block evaluates to ``chunks`` (``BatchedFIDFitness._eval_chunk``
    wrapped): a chunk samples ``batches`` batches of that many steps."""
    from autodiffusion_tpu_torch.search.fitness import BatchedFIDFitness

    real = BatchedFIDFitness._eval_chunk

    def recorded(self, cands):
        chunks.append((self.group_key_fn(cands[0]),
                       -(-self.num_samples // self.device_batch)))
        return real(self, cands)

    BatchedFIDFitness._eval_chunk = recorded
    try:
        yield
    finally:
        BatchedFIDFitness._eval_chunk = real


# the EA's cut of the smoke run's searches: two candidates a chunk, 16
# samples each a batch (a device batch of 32), 32 samples a candidate,
# population 4, one epoch
SEARCH_CUT = ["--candidate_chunk", "2", "--batch_size", "16",
              "--num_samples", "32", "--population_num", "4",
              "--select_num", "2", "--mutation_num", "2",
              "--crossover_num", "2", "--max_epochs", "1", "--seed", "0"]
# the batches of a chunk under SEARCH_CUT: 32 samples a candidate at 16
SEARCH_BATCHES = 2


def check_fixed_steps(res, steps: int, label: str):
    """A search of a fixed schedule (``--time_step`` steps, no layer
    search) under SEARCH_CUT: every chunk ran ``steps`` steps of
    SEARCH_BATCHES batches, the literal cut, so that the launches run_search
    derives from the fitness's own chunks cannot drift with it."""
    want = [(steps, SEARCH_BATCHES)] * res["chunks"]
    if not res["chunks"] or res["chunk_steps"] != want:
        raise AssertionError(f"search ({label}): chunks of (steps, batches) "
                             f"{res['chunk_steps']}, not {want}")


def run_search(argv, env, per_step, label: str, unit: str):
    """``adt-torch search`` ``argv`` (its --save_dir under WORK) under the
    switches of ``env``, its launch counters set to 0 just before and read
    just after: each must equal ``per_step`` times the sampler steps its
    chunks ran (chunk_recorder: each chunk's steps a candidate times its
    batches; a kernel of the path may not be missing). Every FID finite
    and >= 0; the best candidate and its FID from the command's last
    line; images/s of a chunk's sample phase after the first; peak
    memory."""
    import io

    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    save_dir = os.path.join(WORK, f"search_{label.replace(' ', '_')}")
    argv = ["search", "--device", "cuda", "--save_dir", save_dir] + argv
    chunks, buf = [], io.StringIO()
    with switches(env), chunk_recorder(chunks), \
            contextlib.redirect_stdout(buf):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"adt-torch search ({label}) returned {rc}")
    best = json.loads(text.strip().splitlines()[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with open(os.path.join(save_dir, "ea_state.json")) as f:
        fids = list(json.load(f)["vis_dict"].values())
    if not fids or not all(math.isfinite(x) and x >= 0 for x in fids):
        raise AssertionError(f"invalid FIDs from the search ({label}): "
                             f"{fids}")
    with open(os.path.join(save_dir, "log.txt")) as f:
        phases = [tuple(float(v) for v in m.groups()) for m in re.finditer(
            r"reset_time: ([\d.]+), sample_time: ([\d.]+), "
            r"fid_time: ([\d.]+)", f.read())]
    if len(phases) != len(chunks):
        raise AssertionError(f"search ({label}): {len(phases)} timing "
                             f"lines for {len(chunks)} chunks")
    steps = sum(k * nb for k, nb in chunks)
    want = {k: per_step.get(k, 0) * steps for k in launches}
    log(f"search ({label}): {len(fids)} candidates, FIDs {fids}")
    log(f"search ({label}): best {best['best']} FID {best['fid']}")
    log(f"search ({label}): {len(chunks)} chunks of (steps, batches) "
        f"{chunks}, {steps} {unit}, launches {launches} (expected {want}),"
        f" wall {wall:.1f} s, peak memory {peak_gb:.2f} GB")
    for name, count in want.items():
        if count and not launches[name]:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"search path ({label})")
    if launches != want:
        raise AssertionError(f"launch counts ({label}) {launches} != {want}")
    imgs_per_chunk = 2 * 16 * SEARCH_BATCHES
    sample_s = [p[1] for p in phases]
    steady = sample_s[1:] or sample_s
    ips = imgs_per_chunk * len(steady) / sum(steady)
    log(f"search ({label}): per-chunk reset/sample/fid seconds: "
        + "; ".join(f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c in phases))
    log(f"search ({label}): images/s through the sampler (sample phase = "
        f"the chunk's {unit}, Inception, moments; chunks after the first): "
        f"{ips:.2f}")
    return dict(fids=fids, best=best["best"], best_fid=best["fid"],
                launches=launches, expected_launches=want,
                chunks=len(chunks), chunk_steps=chunks, steps=steps,
                phases=phases, images_per_s=ips, wall_s=wall,
                peak_gb=peak_gb)


def phase_search(paths, env, per_step, label: str):
    """``adt-torch search`` at full ADM-64 width (classifier guidance,
    DDIM-4, SEARCH_CUT) under the switches of ``env``: run_search, its
    launches ``per_step`` times the guided steps run."""
    res = run_search(["--model_path", paths["unet"], "--classifier_path",
                      paths["cls"], "--inception_path", paths["incep"],
                      "--ref_stats", paths["ref"], "--time_step", "4",
                      "--use_ddim", "True"] + SEARCH_CUT,
                     env, per_step, label, "guided DDIM steps at batch 32")
    check_fixed_steps(res, 4, label)
    return dict(res, guided_steps=res["steps"])


# a searched 4-step schedule (the first four knots of the README's
# published ADM-64 artifact) and one skip list per step for ``sample``
SAMPLE_TIMESTEPS = "[94, 834, 217, 944]"
SAMPLE_SKIPS = "[[0, 3], [], [10, 57], [5]]"


def phase_sample(paths, per_step):
    """``adt-torch sample`` at full ADM-64 width (bf16, classifier guidance,
    32 samples at batch 16, the default path) twice: ancestral
    (--use_ddim False) with the 4-step --use_timestep, then DDIM with a
    4-entry --skip_layers. The launch counters, set to 0 just before each
    run and read just after, must show each kernel ``per_step`` times a
    guided step (8 steps: the flash forward, dQ, dK/dV and the GroupNorm
    forward and backward) and nothing else; the .npz must hold uint8
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
    want = {k: v * steps for k, v in per_step.items()}
    out = {}
    for label, extra in runs.items():
        npz = os.path.join(WORK, f"samples_{label}.npz")
        argv = ["sample", "--device", "cuda", "--model_path", paths["unet"],
                "--classifier_path", paths["cls"], "--use_timestep",
                SAMPLE_TIMESTEPS, "--num_samples", "32", "--batch_size", "16",
                "--seed", "0", "--out", npz] + extra
        buf = io.StringIO()
        with switches(DEFAULT), contextlib.redirect_stdout(buf):
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
        for name, count in want.items():
            if count and not launches[name]:
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


def record_sites(run, env, grad: bool = False, routes=None):
    """{kernel: {site: calls}} of the model forwards ``run`` makes on the
    meta device (shapes only) under the switches of ``env``, each kernel
    wrapper replaced by a recorder. Attention sites are (T, S, heads, D,
    lead): ``lead`` the leading dim a call hands the kernel at batch 1
    (1 on the token-major layout, the heads on the ADM blocks' [B H, T,
    D] and the wide kernel's heads-first layout); GroupNorm sites (C, HW,
    act, FiLM, eps); conv sites as adm64_sites()'s. The run is under
    torch.no_grad() (the commands sample) unless ``grad``. ``routes``, a
    dict, receives {(T, S, D, heads, gradient wanted): calls} of the
    attention calls, read where each asks ``attention_route`` for its
    route (the flash gate's keys)."""
    import torch
    from autodiffusion_tpu_torch.models import nn as port_nn

    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    cur = {}

    def add(kernel, key):
        cur.setdefault(kernel, {})
        cur[kernel][key] = cur[kernel].get(key, 0) + 1

    def gn(x, gamma, beta, *, scale=None, shift=None, num_groups, eps, act):
        add("group_norm_fwd", (x.shape[1], math.prod(x.shape[2:]), act,
                               scale is not None, eps))
        return x.clone()       # keeps x's gradient: the sites after it ask

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
                                 q.shape[2] // heads, q.shape[0]))
        return torch.empty_like(q), None

    def fwd(q, k, v, heads=1):
        add("flash_fwd_wide" if q.shape[-1] == 512 else "flash_fwd",
            (q.shape[1], k.shape[1], heads, q.shape[2] // heads,
             q.shape[0]))
        return torch.empty_like(q), None

    def adm_attention(q, k, v):
        # the ADM blocks' flash_attention: FlashAttentionFunction's
        # flash_fwd on [B H, T, D]
        fwd(q, k, v)
        return torch.empty_like(q)

    real_route = fa.attention_route
    seen = {} if routes is None else routes

    def route(t, s_len, d, heads, g, device):
        key = (t, s_len, d, heads, g)
        seen[key] = seen.get(key, 0) + 1
        return real_route(t, s_len, d, heads, g, device)

    saved = {n: getattr(port_nn, n)
             for n in ("fused_group_norm", "conv3x3", "conv3x3_fused")}
    saved_fa = (fa.flash_fwd_packed, fa.flash_fwd, fa.attention_route,
                fa.flash_attention)
    port_nn.fused_group_norm, port_nn.conv3x3 = gn, conv
    port_nn.conv3x3_fused = fused
    fa.flash_fwd_packed, fa.flash_fwd = packed, fwd
    fa.attention_route, fa.flash_attention = route, adm_attention
    try:
        with switches(env), torch.device("meta"), \
                torch.set_grad_enabled(grad):
            run()
    finally:
        for n, fn in saved.items():
            setattr(port_nn, n, fn)
        (fa.flash_fwd_packed, fa.flash_fwd, fa.attention_route,
         fa.flash_attention) = saved_fa
    for kernel in SD_KERNELS:
        cur.setdefault(kernel, {})
    return cur


def sd_sites(env=SWITCHES_ON):
    """{"unet" | "decode" | "encode": {kernel: {site: calls}}} of one SD v1
    UNet forward, one AutoencoderKL decode and one encode of a 512 x 512
    image (img2img's) at full width under the switches of ``env``, read
    from the models on the meta device (record_sites). The default path's
    routes are FUSED_NORM_ALONE's there; with every switch off the
    attention sites run alone."""
    import torch
    from autodiffusion_tpu_torch.models import create_sd_models

    unet, vae, _ = create_sd_models(device="meta")
    return {"unet": record_sites(lambda: unet(
        torch.empty(1, 4, 64, 64), torch.zeros(1), torch.empty(1, 77, 768)),
        env),
        "decode": record_sites(lambda: vae.decode(torch.empty(1, 4, 64, 64)),
                               env),
        "encode": record_sites(lambda: vae.encode(
            torch.empty(1, 3, 512, 512)), env)}


def per_call(sites):
    """{kernel: launches per call} of one tower's sites (recorded under the
    switches of the run they count)."""
    return {k: sum(v.values()) for k, v in sites.items()}


SD_ATTN_PARTS = (("flash_fwd_packed", "unet", SD_UNET_BATCH),
                 ("flash_fwd", "unet", SD_UNET_BATCH),
                 ("flash_fwd_wide", "decode", SD_BATCH))
# a ragged query length for the packed kernel, self and cross
SD_RAGGED = (("flash_fwd_packed", 1000, 1000, 8, 40, SD_UNET_BATCH, 0),
             ("flash_fwd_packed", 1000, 77, 8, 40, SD_UNET_BATCH, 0))


def phase_attention(sites, parts=SD_ATTN_PARTS, extra=SD_RAGGED):
    """The attention kernels at every site of ``parts`` ((kernel, part,
    batch): the SD v1 UNet's packed (D = 40: the 64x64 level's
    self-attention over 4096 tokens and cross-attention over 77) and D = 80
    forwards, the VAE mid-block's D = 512; or the LDM models' sites), on
    the layout the models hand them (token-major [B, L, H * D], or the ADM
    blocks' and the wide kernel's [B H, L, D], a site's ``lead`` times the
    batch), plus ``extra`` shapes (a ragged T), against their twins at the
    commands' device batch (the SD UNet's doubled by guidance), bf16 and
    fp32, within the kernel limits; runs with one 64-key tile left out,
    with the heads shifted by one (a wrong head offset; where there are
    several) and for the packed kernel with the D = 40 padding read from
    memory instead of zeroed, must break them. Every other head's values
    are eight times larger, so that reading a neighbour shows. Each timed
    beside its twin, its bound and F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from autodiffusion_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_packed, flash_fwd_packed_plain)

    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = list(extra)   # (kernel, T, S, heads, D, batch, calls a call)
    for kernel, part, batch in parts:
        for (t, s_len, heads, d, lead), count in sites[part][kernel].items():
            shapes.append((kernel, t, s_len, heads, d, batch * lead, count))
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
        raise AssertionError(f"attention kernels disagree with their "
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


def phase_sd_parity(weights, envs, dpm_label: str = "default"):
    """The SD towers at full width in float32 with seeded random weights,
    the GPU (the kernels) under the switches of each of ``envs`` ({label:
    env}) against one CPU run (their twins) under those of ``dpm_label``:
    CLIP on two prompts' ids, two PLMS steps of the UNet with
    classifier-free guidance (scale 7.5) at batch 1 (three UNet calls at
    the doubled batch 2: ``txt2img``'s and ``search-sd``'s PLMS), one VAE
    decode of the result, and, under the switches of ``dpm_label`` (the
    solvers' arithmetic is the same under either), at 128 x 128 (latent
    16 x 16) DPM-Solver-2 over three steps (three guided UNet calls; the
    middle step second order, the last first order as lower_order_final
    makes it), two DDIM steps of ``txt2img`` with a --prompt_mask of [1, 0]
    and ``img2img``'s path (encode, a posterior draw, q_sample at index
    t_enc = 2 of three, two DDIM steps, decode) with the draws injected.
    Each output within 1e-3 x its scale. Returns {label: ({output: max abs
    error}, GPU launches)}."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import img2img_latents
    from autodiffusion_tpu_torch.models import SD_SCALE_FACTOR
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.samplers import (DiscreteNoiseSchedule,
                                                  ModelVarType, cfg_eps_fn,
                                                  ddim_sample_loop,
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
    # DPM-Solver, txt2img's masked DDIM and img2img at 128 x 128 (the
    # CPU's time)
    z16 = torch.randn(1, 4, 16, 16, generator=gen)
    x128 = torch.rand(1, 3, 128, 128, generator=gen) * 2 - 1
    post, qn = (torch.randn(1, 4, 16, 16, generator=gen) for _ in range(2))
    tables3 = build_sd_tables([1, 334, 667])
    tables = build_sd_tables([301, 801])
    sched = DiscreteNoiseSchedule.from_betas(
        make_beta_schedule("sqrt_linear", 1000))
    times = torch.from_numpy(np.array([1.0, 0.62, 0.3, 1e-3], np.float32))
    outs = {label: {} for label in envs}
    launches = {}
    try:
        for dev, labels in (("cpu", {dpm_label: envs[dpm_label]}),
                            ("cuda", envs)):
            unet, vae, clip = sd_towers(weights, False, dev)
            for label, env in labels.items():
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
                                guided, (1, 4, 16, 16), sched.to(dev),
                                times.to(dev), device=dev, order=2,
                                noise=z16.to(dev)).cpu()
                        masked = cfg_eps_fn(
                            unet, ctx[1:], ctx[0], 7.5,
                            prompt_mask=torch.tensor([1.0, 0.0], device=dev))
                        outs[label][dev]["txt2img_ddim2_mask"] = \
                            ddim_sample_loop(
                                masked, (1, 4, 16, 16), tables.to(dev),
                                device=dev, clip_denoised=False,
                                var_type=ModelVarType.FIXED_SMALL,
                                noise=z16.to(dev)).cpu()
                        z_i = img2img_latents(
                            guided, vae, x128.to(dev), tables3.to(dev), 0.75,
                            1, posterior_noise=post.to(dev),
                            noise=qn.to(dev))
                        outs[label][dev]["img2img2"] = z_i.cpu()
                        outs[label][dev]["img2img_decode"] = vae.decode(
                            z_i / SD_SCALE_FACTOR).cpu()
                if dev == "cuda":
                    launches[label] = dict(LAUNCHES)
                log(f"SD parity ({label}) on {dev}: {time.time() - t0:.1f} s")
            del unet, vae, clip
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    result = {}
    for label in envs:
        errs = {}
        for name, got in outs[label]["cuda"].items():
            want = outs[dpm_label]["cpu"][name]
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


def phase_sd_profile(weights, label: str = "default"):
    """One PLMS-4 fitness batch of the search in bf16 (5 UNet calls at
    batch 16 with guidance, then the VAE decode of 8 latents) under the
    switches in force: host-clock time of an unprofiled run, then each part
    under torch.profiler: device busy and idle per UNet call, the top
    kernels, the attention kernels' and the GroupNorm forward's share, and
    the decode's share of the batch's device time (in the output
    directory: ``chip_smoke_profile_sd.txt`` on the default path,
    ``..._sd_off.txt`` with the switches off, ``..._sd_fused.txt`` with
    them on)."""
    import torch
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
        prof_u = profiled(sample)[0]
        prof_d = profiled(lambda: decode(z))[0]
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
    fname = "chip_smoke_profile_sd" + {
        "default": "", "switches on": "_fused", "switches off": "_off"}.get(
        label, "_" + re.sub(r"\W+", "_", label)) + ".txt"
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
    # the three pipelined forwards' own lines, where the gate (read from
    # the environment) keeps the UNet's sites on them
    routed = flash_counts(_sites_of_programs()["sd_unet"])
    for part, kernels, steps, name in (("UNet", k_u, calls, "flash_fwd_packed"),
                                       ("UNet", k_u, calls, "flash_fwd_tma"),
                                       ("decode", k_d, 1, "flash_fwd_wide")):
        mine = [e for e in kernels if name + "_kernel" in e.key]
        if not mine and (part == "decode" or routed[
                name.replace("_tma", "")]):
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
    each must equal the per-call counts derived from the models (``sites``,
    recorded under the same routes) times the UNet calls (5 per dispatch
    for PLMS-4, 4 for DPM-Solver over 4 steps) and the decodes (1)."""
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

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
        for k, c in per_call(sites[part]).items():
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


# ------------------------------------------------------------ training path

# ``adt-torch train``'s defaults: ADM-64 full width, bf16, dropout 0.1; the
# smoke run's batch of 16 goes in two microbatches of 8
TRAIN_BATCH, TRAIN_MICRO = 16, 8
MICROBATCHES = TRAIN_BATCH // TRAIN_MICRO
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def train_kernels(env, program: str = "adm_train"):
    """The kernels a training step of ``program`` launches on the card
    under the switches of ``env``: the flash forward and backward where
    the gate keeps a site on them, the GroupNorm forward and backward
    unless ADT_FUSED_NORM=0, each conv kernel under its switch."""
    flash = flash_per_call(program, env)
    out = [k for k in TRAIN_KERNELS if flash[k]]
    if env.get("ADT_FUSED_NORM") != "0":
        out += ["group_norm_fwd", "group_norm_bwd"]
    if env.get("ADT_IM2COL_CONV") == "1":
        out.append("conv3x3")
    if env.get("ADT_FUSED_CONV") == "all":
        out.append("conv3x3_fused")
    return tuple(out)


def gn_modules(model) -> int:
    """The GroupNorm32 modules of ``model``: each runs once a forward."""
    from autodiffusion_tpu_torch.models.nn import GroupNorm32

    return sum(isinstance(m, GroupNorm32) for m in model.modules())


def adm_gn_counts():
    """(UNet, classifier) GroupNorm32 counts of ADM-64 (read from the
    models on the meta device)."""
    import torch
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)

    with torch.device("meta"):
        return (gn_modules(create_model(ModelConfig.adm64(), device="meta")),
                gn_modules(create_classifier(ClassifierConfig.adm64(),
                                             device="meta")))


def train_files():
    """A seeded uint8 [256, 64, 64, 3] .npy with labels over 1000 classes
    (``train``'s bulk input) and a folder of 32 PNGs of four classes
    (``train-classifier`` and ``nll`` read image folders), made here."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(7)
    d = os.path.join(WORK, "train_data")
    os.makedirs(os.path.join(d, "pngs"), exist_ok=True)
    npy = os.path.join(d, "imgs.npy")
    np.save(npy, rng.randint(0, 256, (256, 64, 64, 3), dtype=np.uint8))
    np.save(os.path.join(d, "imgs_labels.npy"), rng.randint(0, 1000, 256))
    for i in range(32):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)) \
            .save(os.path.join(d, "pngs", f"n{i % 4:08d}_{i}.png"))
    return dict(npy=npy, pngs=os.path.join(d, "pngs"))


def _progress(save_dir):
    import csv

    with open(os.path.join(save_dir, "progress.csv")) as f:
        return [{k: float(v) if v not in ("", None) else None
                 for k, v in r.items()} for r in csv.DictReader(f)]


def _per_step(launches, steps: int, label: str):
    out = {}
    for k, v in launches.items():
        if v % steps:
            raise AssertionError(f"{label}: {v} {k} launches over {steps} "
                                 "steps")
        out[k] = v // steps
    return out


def _in_norm_sites():
    """ResBlocks of the ADM-64 UNet without resampling: the in-norm sites
    the fused conv takes in training (read from the model on the meta
    device)."""
    import torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.models.unet import ResBlock

    with torch.device("meta"):
        m = create_model(ModelConfig.adm64(), device="meta")
    return sum(isinstance(mod, ResBlock) and not mod.updown
               for mod in m.modules())


def phase_train(files, env, label: str):
    """``adt-torch train`` at ADM-64 full width (bf16, dropout 0.1, batch
    16 in two microbatches, EMA 0.9999) for 4 steps with a save at step 2,
    then ``--resume_checkpoint`` of the save directory for 2 more: the
    launch counters set to 0 just before each run and read just after
    (every step the same launches; the flash kernels as the gate routes
    the 22 sites of a microbatch (switches on: all of them); with
    the switches on the GroupNorm backward once for every GroupNorm
    forward and the fused conv only at the in-norms, the out-norm's
    dropout keeping it out), finite losses, the files, the resumed state
    equal to the saved one and the step counter continuing."""
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.train import (create_train_state,
                                               resume_train_state)

    save_dir = os.path.join(WORK, f"train_{label}")
    base = ["train", "--device", "cuda", "--data_dir", files["npy"],
            "--save_dir", save_dir, "--batch_size", str(TRAIN_BATCH),
            "--microbatch", str(TRAIN_MICRO), "--ema_rate", "0.9999",
            "--save_interval", "2", "--log_interval", "1"]
    runs = {}
    with switches(env):
        for run, extra, steps in (
                ("first", ["--max_steps", "4"], 4),
                ("resumed", ["--max_steps", "6", "--resume_checkpoint",
                             save_dir], 2)):
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.time()
            rc = adt_torch(base + extra)
            torch.cuda.synchronize()
            wall = time.time() - t0
            if rc != 0:
                raise AssertionError(f"adt-torch train ({label}, {run}) "
                                     f"returned {rc}")
            runs[run] = dict(launches=dict(LAUNCHES), wall_s=wall,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                             per_step=_per_step(dict(LAUNCHES), steps,
                                                f"train {label} {run}"))
            if run == "first":
                # the state a resume reads equals what the run saved
                ref = torch.load(os.path.join(save_dir, "model000004.pt"),
                                 map_location="cuda", weights_only=True)
                ema = torch.load(os.path.join(save_dir,
                                              "ema_0.9999_000004.pt"),
                                 map_location="cuda", weights_only=True)
                m = create_model(ModelConfig.adm64(), device="cuda")
                st = create_train_state(m, ema_rates=(0.9999,))
                resume_train_state(st, save_dir)
                if st.step != 4 or st.updates() != 4:
                    raise AssertionError(f"train {label}: resumed at step "
                                         f"{st.step}, {st.updates()} updates")
                for k, v in m.state_dict().items():
                    if not torch.equal(v, ref[k]):
                        raise AssertionError(f"train {label}: resumed {k} "
                                             "differs from the saved one")
                for k, v in st.ema_state_dict(0).items():
                    if not torch.equal(v, ema[k]):
                        raise AssertionError(f"train {label}: resumed EMA "
                                             f"{k} differs")
                del m, st, ref, ema
                torch.cuda.empty_cache()
    rows = _progress(save_dir)
    if [int(r["step"]) for r in rows] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"train {label}: steps {[r['step'] for r in rows]}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train {label}: losses {losses}")
    for name in ("model000006.pt", "ema_0.9999_000006.pt", "opt000006.pt"):
        if not os.path.exists(os.path.join(save_dir, name)):
            raise AssertionError(f"train {label}: no {name}")
    per = runs["first"]["per_step"]
    if per != runs["resumed"]["per_step"]:
        raise AssertionError(f"train {label}: launches a step "
                             f"{per} then {runs['resumed']['per_step']}")
    flash = flash_per_call("adm_train", env)
    on = env is SWITCHES_ON
    routed = train_kernels(env)
    for k in routed:
        if not per[k]:
            raise AssertionError(f"train {label}: {k} never launched")
    for k in TRAIN_KERNELS:
        if per[k] != flash[k] * MICROBATCHES:
            raise AssertionError(f"train {label}: {per[k]} {k} a step, want "
                                 f"{flash[k] * MICROBATCHES}")
    if on:
        fused = _in_norm_sites() * MICROBATCHES
        if per["group_norm_bwd"] != per["group_norm_fwd"] or \
                per["conv3x3_fused"] != fused:
            raise AssertionError(
                f"train {label}: a step ran {per['group_norm_fwd']} GroupNorm "
                f"forwards, {per['group_norm_bwd']} backwards and "
                f"{per['conv3x3_fused']} fused convs (want one backward a "
                f"forward, {fused} fused convs: the in-norms only)")
    elif "group_norm_fwd" in routed:
        # the fused norm alone: every GroupNorm32 of the UNet forward and
        # backward, a microbatch
        want_gn = adm_gn_counts()[0] * MICROBATCHES
        if not per["group_norm_fwd"] == per["group_norm_bwd"] == want_gn:
            raise AssertionError(
                f"train {label}: {per['group_norm_fwd']} GroupNorm forwards "
                f"and {per['group_norm_bwd']} backwards a step, want {want_gn}")
    if any(per[k] for k in NEW_KERNELS if k not in routed):
        raise AssertionError(f"train {label}: kernels off its path ran {per}")
    # the command's own step time (host clock, data and logging included),
    # after the first step of each run
    step_s = sorted(r["step_time"] for r in rows
                    if int(r["step"]) not in (1, 5))
    log(f"train ({label}): losses {[round(v, 4) for v in losses]}, "
        f"command step time after warm-up {1e3 * step_s[len(step_s) // 2]:.1f}"
        f" ms (median of {len(step_s)}), launches a step {per}, peak memory "
        f"{runs['first']['peak_gb']:.2f} GB, wall {runs['first']['wall_s']:.1f}"
        f" + {runs['resumed']['wall_s']:.1f} s (resumed at step 4)")
    return dict(runs=runs, losses=losses, per_step=per,
                command_step_ms=1e3 * step_s[len(step_s) // 2],
                launches={k: runs["first"]["launches"][k]
                          + runs["resumed"]["launches"][k] for k in per},
                save_dir=save_dir)


def phase_train_profile(env, label: str, steps: int = 3):
    """The training step the command runs (make_train_step at ADM-64 full
    width, bf16, dropout 0.1, batch 16 in two microbatches, AdamW + EMA),
    driven directly on device-resident data: host-clock ms a step after
    two warm-up steps, device-busy ms a step under torch.profiler, the idle
    share, peak memory, the kernels' launches a step and the GroupNorm
    backward's form (wherever it runs, every call must launch its batch
    sum: the every-gradient form)."""
    import torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.schedules import build_base_tables
    from autodiffusion_tpu_torch.train import (create_train_state,
                                               make_train_step)

    with switches(env):
        torch.manual_seed(0)
        model = create_model(ModelConfig.adm64(), device="cuda").train()
        state = create_train_state(model, ema_rates=(0.9999,))
        step = make_train_step(model, class_cond=True,
                               microbatches=MICROBATCHES)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tables = build_base_tables("cosine").to("cuda")
        batch = {"x": torch.rand(TRAIN_BATCH, 3, 64, 64, device="cuda",
                                 generator=gen) * 2 - 1,
                 "y": torch.randint(0, 1000, (TRAIN_BATCH,), device="cuda",
                                    generator=gen)}
        t = torch.randint(0, 1000, (TRAIN_BATCH,), device="cuda",
                          generator=gen)
        w = torch.ones(TRAIN_BATCH, device="cuda")

        def one():
            return step(state, tables, batch, t, w, gen)[1]

        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            metrics = one()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / steps
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        def many():
            for _ in range(steps):
                one()

        prof, launched, _ = profiled(many)
        per = _per_step(launched, steps, f"train profile {label}")
    busy, kernels = device_busy(prof, steps)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"train profile {label}: loss {loss}")
    gn_calls, batch_sums = (sum(e.count for e in kernels if tag in e.key)
                            / steps for tag in ("group_norm_bwd_kernel",
                                                "group_norm_batch_sum"))
    if per["group_norm_bwd"] and not (
            gn_calls == batch_sums == per["group_norm_bwd"]):
        raise AssertionError(
            f"train profile {label}: {gn_calls:g} GroupNorm backward kernels"
            f" and {batch_sums:g} batch sums a step for "
            f"{per['group_norm_bwd']} calls (want the every-gradient form: "
            "one batch sum a call)")
    own = {k: sum(e.self_device_time_total for e in kernels if tag in e.key)
           / 1e3 / steps
           for k, tag in (("flash_fwd", "flash_fwd_tma_kernel"),
                          ("flash_bwd_dq", "flash_bwd_dq_tma_kernel"),
                          ("flash_bwd_dkv", "flash_bwd_dkv_tma_kernel"),
                          ("group_norm_fwd", "group_norm_fwd_"),
                          ("group_norm_bwd", "group_norm_bwd_kernel"),
                          ("group_norm_batch_sum", "group_norm_batch_sum"),
                          ("conv3x3", "conv3x3_igemm_kernel<false"),
                          ("conv3x3_fused", "conv3x3_igemm_kernel<true"),
                          ("wgrad", "wgrad"))}
    lines = profile_lines(kernels, steps)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"chip_smoke_profile_train_{label}.txt"),
              "w") as f:
        f.write(f"{smi_line()}\ntraining step, ADM-64 bf16, batch "
                f"{TRAIN_BATCH} in {MICROBATCHES} microbatches, dropout 0.1, "
                f"{label}; device time per step by kernel\n"
                + "\n".join(lines) + "\n")
    log(f"train profile ({label}): {wall:.2f} ms a step wall, busy "
        f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f}%), "
        f"{1e3 * TRAIN_BATCH / wall:.2f} samples/s, peak memory "
        f"{peak_gb:.2f} GB, launches a step {per}, GroupNorm backward "
        f"{gn_calls:g} kernels and {batch_sums:g} batch sums a step, "
        f"own device ms a step {dict((k, round(v, 3)) for k, v in own.items())}")
    for line in lines[:8]:
        log(f"train profile ({label}): " + line)
    del model, state
    torch.cuda.empty_cache()
    return dict(step_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                samples_per_s=1e3 * TRAIN_BATCH / wall, peak_gb=peak_gb,
                launches_per_step=per, gn_bwd_kernels=gn_calls,
                batch_sums=batch_sums, own_ms=own, loss=loss, top=lines)


def phase_train_classifier(files, env, label: str, steps: int = 3,
                           extra=()):
    """``adt-torch train-classifier`` at its defaults (width 128, depth 2,
    attention pool, bf16, batch 4 raised to 16; ``extra`` flags after
    them) for a few steps: finite losses and the kernels' launches a
    step."""
    import json as _json

    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    save_dir = os.path.join(WORK, f"classifier_{label}")
    with switches(env):
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(["train-classifier", "--device", "cuda", "--data_dir",
                        files["pngs"], "--save_dir", save_dir,
                        "--iterations", str(steps), "--batch_size", "16",
                        "--log_interval", "1"] + list(extra))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"train-classifier ({label}) returned {rc}")
    with open(os.path.join(save_dir, "progress.json")) as f:
        rows = [_json.loads(r) for r in f]
    losses = [r["loss"] for r in rows]
    if len(rows) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train-classifier ({label}): {rows}")
    per = _per_step(launches, steps, f"train-classifier {label}")
    for k in train_kernels(env, "classifier_train"):
        if not per[k]:
            raise AssertionError(f"train-classifier ({label}): {k} never "
                                 "launched")
    step_ms = 1e3 * sorted(r["step_time"] for r in rows[1:])[
        (len(rows) - 1) // 2]
    log(f"train-classifier ({label}): losses {[round(v, 4) for v in losses]}"
        f", launches a step {per}, command step time {step_ms:.1f} ms after "
        f"the first, wall {wall:.1f} s")
    return dict(losses=losses, per_step=per, launches=launches,
                command_step_ms=step_ms, wall_s=wall)


def phase_nll(files, ema_path):
    """``adt-torch nll`` of the trained EMA checkpoint over the PNG folder:
    one batch of 2 through the full 1000-step bound, float32."""
    import io

    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch

    buf = io.StringIO()
    t0 = time.time()
    with switches(DEFAULT), contextlib.redirect_stdout(buf):
        rc = adt_torch(["nll", "--device", "cuda", "--model_path", ema_path,
                        "--data_dir", files["pngs"], "--num_samples", "2",
                        "--batch_size", "2"])
    torch.cuda.synchronize()
    secs = time.time() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"adt-torch nll returned {rc}")
    bpd = json.loads(text.strip().splitlines()[-1])["bpd"]
    if not (math.isfinite(bpd) and bpd > 0):
        raise AssertionError(f"nll: bpd {bpd}")
    log(f"nll: {bpd:.4f} bits/dim over 2 images, 1000 steps of the bound, "
        f"{secs:.1f} s (models built and loaded)")
    return dict(bpd=bpd, seconds=secs)


def phase_sample_trained(ema_path):
    """``adt-torch sample`` of the trained EMA checkpoint (DDIM, the
    4-step schedule, 16 samples): the trained weights deploy."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch

    npz = os.path.join(WORK, "samples_trained.npz")
    t0 = time.time()
    with switches(DEFAULT):
        rc = adt_torch(["sample", "--device", "cuda", "--model_path",
                        ema_path, "--use_timestep", SAMPLE_TIMESTEPS,
                        "--num_samples", "16", "--batch_size", "16",
                        "--seed", "1", "--out", npz])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"sample of the trained model returned {rc}")
    with np.load(npz) as z:
        arr = z["arr_0"]
    if arr.dtype != np.uint8 or arr.shape != (16, 64, 64, 3):
        raise AssertionError(f"sample of the trained model: {arr.dtype} "
                             f"{arr.shape}")
    log(f"sample (trained EMA): 16 images {arr.shape}, "
        f"{time.time() - t0:.1f} s")
    return dict(shape=list(arr.shape), seconds=time.time() - t0)


def phase_train_parity(unet_sd, envs, batch: int = 2):
    """Two AdamW + EMA training steps of the full-width ADM-64 UNet in
    float32 (dropout 0; the same weights, batch, t and noise): the GPU (the
    kernels) under the switches of each of ``envs`` ({label: env}) against
    one CPU run on the default path (the plain chain, the same function),
    TF32 off: each step's loss and gradient norm, the first step's
    gradients and every parameter and EMA value after the steps within
    1e-3 of their scale. Returns {label: the comparison}."""
    import torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.schedules import build_base_tables
    from autodiffusion_tpu_torch.train import (create_train_state,
                                               make_train_step)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)
    data = [dict(x=torch.rand(batch, 3, 64, 64, generator=gen) * 2 - 1,
                 y=torch.randint(0, 1000, (batch,), generator=gen),
                 t=torch.randint(0, 1000, (batch,), generator=gen),
                 noise=torch.randn(batch, 3, 64, 64, generator=gen))
            for _ in range(2)]
    res = {}
    try:
        for dev, label, env in ([("cpu", "cpu", DEFAULT)]
                                + [("cuda", k, v) for k, v in envs.items()]):
            t0 = time.time()
            with switches(env):
                m = create_model(ModelConfig.adm64(use_bf16=False,
                                                   dropout=0.0), device=dev)
                m.load_state_dict(unet_sd)
                m.train()
                st = create_train_state(m, lr=1e-4, weight_decay=0.01,
                                        ema_rates=(0.9,))
                step = make_train_step(m, class_cond=True)
                tables = build_base_tables("cosine").to(dev)
                reset_launch_counts()
                metrics, first = [], None
                for d in data:
                    grads, mt = step.grads_and_metrics(
                        st, tables, {"x": d["x"].to(dev), "y": d["y"].to(dev)},
                        d["t"].to(dev), torch.ones(batch, device=dev),
                        noise=d["noise"].to(dev))
                    if first is None:
                        first = [g.cpu() for g in grads]
                    st.apply_gradients(grads)
                    metrics.append({k: float(mt[k]) for k in
                                    ("loss", "grad_norm", "mse", "vb")})
                launches = dict(LAUNCHES)
            res[label] = dict(metrics=metrics, grads=first,
                              params={n: p.detach().cpu()
                                      for n, p in m.named_parameters()},
                              ema={n: e.cpu() for n, e in
                                   st.ema_state_dict(0).items()},
                              launches=launches, names=st.names)
            log(f"train parity ({label}) on {dev}: {time.time() - t0:.1f} s")
            del m, st, grads
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = res["cpu"]
    out = {}
    for label, env in envs.items():
        gpu, errs = res[label], {}
        for i, (g, c) in enumerate(zip(gpu["metrics"], cpu["metrics"])):
            for k in g:
                if not (math.isfinite(g[k]) and abs(g[k] - c[k])
                        <= 1e-3 * max(abs(c[k]), 1.0)):
                    raise AssertionError(f"train parity ({label}) step {i} "
                                         f"{k}: GPU {g[k]} CPU {c[k]}")
        gscale = max(float(g.abs().max()) for g in cpu["grads"])
        errs["grads"] = max(float((a - b).abs().max())
                            for a, b in zip(gpu["grads"], cpu["grads"]))
        if not errs["grads"] <= 1e-3 * gscale:
            worst = max(zip(gpu["grads"], cpu["grads"], cpu["names"]),
                        key=lambda z: float((z[0] - z[1]).abs().max()))[2]
            raise AssertionError(f"train parity ({label}): gradients "
                                 f"{errs['grads']:.3e} apart (scale "
                                 f"{gscale:.3e}, worst {worst})")
        for part in ("params", "ema"):
            errs[part] = 0.0
            for n, c in cpu[part].items():
                e = float((gpu[part][n] - c).abs().max())
                errs[part] = max(errs[part], e)
                if not e <= 1e-3 * max(float(c.abs().max()), 1.0):
                    raise AssertionError(f"train parity ({label}): {part} "
                                         f"{n} {e:.3e} apart")
        missing = [k for k in train_kernels(env) if not gpu["launches"][k]]
        if missing:
            raise AssertionError(f"train parity ({label}): GPU launched no "
                                 f"{missing}")
        log(f"train parity ({label}): ADM-64 float32 batch {batch}, 2 AdamW"
            f" + EMA steps, GPU vs CPU: losses "
            f"{[m['loss'] for m in gpu['metrics']]} vs "
            f"{[m['loss'] for m in cpu['metrics']]}, grad norms "
            f"{[m['grad_norm'] for m in gpu['metrics']]} vs "
            f"{[m['grad_norm'] for m in cpu['metrics']]}, max abs err "
            f"gradients {errs['grads']:.3e} (scale {gscale:.3e}), parameters"
            f" {errs['params']:.3e}, EMA {errs['ema']:.3e} (tol 1e-3 x "
            f"scale); GPU launches {gpu['launches']}")
        out[label] = dict(errs=errs, gpu_metrics=gpu["metrics"],
                          cpu_metrics=cpu["metrics"],
                          launches=gpu["launches"])
    return out


# ------------------------------------------------ the multi-process layer

DIST_TRAIN_STEPS = 3
DIST_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "group_norm_fwd", "group_norm_bwd")
# phase_dist's samples: (name, switches, extra arguments), both on the
# default path, whose guided step repeats bit for bit (the classifier's
# gradient sites on the port's own kernels: phase_default_repro)
DIST_SAMPLES = [
    ("sample", DEFAULT, []),
    ("sample_guided", DEFAULT, ["--classifier_path", "{cls}"]),
]


def dist_runs(paths, files, out_dir: str):
    """The runs ``phase_dist`` compares, in this process: ``adt-torch
    train`` (ADM-64, bf16, batch 16 in two microbatches, 3 steps, no
    checkpoint), ``adt-torch sample`` (ADM-64, ancestral over the searched
    4 steps, 16 images at batch 16) unguided and guided on the default
    path (DIST_SAMPLES) and one guided fitness
    chunk on the default path (two DDIM-4 candidates folded, 16 samples
    each, Inception features) on ``data_sharder(make_mesh())``: this
    process alone without a group, the group's ranks under torchrun. Each
    run's launch counters are set to 0 just before it and read just
    after."""
    import random

    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception)
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.parallel import data_sharder, make_mesh
    from autodiffusion_tpu_torch.search import (TimestepSpace,
                                                make_adm_fitness)

    def counted(fn):
        reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(LAUNCHES), time.time() - t0

    out = {}
    train_log = os.path.join(out_dir, "train")
    argv = ["train", "--device", "cuda", "--data_dir", files["npy"],
            "--batch_size", "16", "--microbatch", "8", "--ema_rate",
            "0.9999", "--max_steps", str(DIST_TRAIN_STEPS),
            "--log_interval", "1"]
    with switches(dict(DEFAULT, ADT_LOGDIR=train_log)):
        rc, launches, wall = counted(lambda: adt_torch(argv))
    out["train"] = dict(rc=rc, launches=launches, wall_s=wall,
                        losses=[r["loss"] for r in _progress(train_log)])

    for name, env, extra in DIST_SAMPLES:
        npz = os.path.join(out_dir, f"{name}.npz")
        argv = ["sample", "--device", "cuda", "--model_path", paths["unet"],
                "--use_timestep", SAMPLE_TIMESTEPS, "--use_ddim", "False",
                "--num_samples", "16", "--batch_size", "16", "--seed", "0",
                "--out", npz] + [paths["cls"] if a == "{cls}" else a
                                 for a in extra]
        with switches(env):
            rc, launches, wall = counted(lambda: adt_torch(argv))
        with np.load(npz) as z:
            labels = z["arr_1"].tolist()
        out[name] = dict(rc=rc, launches=launches, wall_s=wall, npz=npz,
                         labels=labels)

    unet = create_model(ModelConfig.adm64(), device="cuda")
    unet.load_state_dict(torch.load(paths["unet"], map_location="cuda",
                                    weights_only=True))
    clf = create_classifier(ClassifierConfig.adm64(), device="cuda")
    clf.load_state_dict(torch.load(paths["cls"], map_location="cuda",
                                   weights_only=True))
    inception = load_fid_inception(paths["incep"], device="cuda")
    fitness = make_adm_fitness(
        model=unet, image_size=64,
        feature_fn=lambda imgs: inception_apply(inception, imgs),
        ref_stats=FIDStats.load(paths["ref"]), num_samples=16,
        batch_size=16, classifier=clf, candidate_chunk=2, seed=0,
        device="cuda",
        shard_fn=data_sharder(make_mesh()))
    space = TimestepSpace(1000, 4, rng=random.Random(0))
    cands = [space.random() for _ in range(2)]
    with switches(DEFAULT):
        fids, launches, wall = counted(lambda: fitness(cands))
    out["fitness"] = dict(fids=[float(f) for f in fids], launches=launches,
                          wall_s=wall)
    del unet, clf, inception, fitness
    torch.cuda.empty_cache()
    return out


def allreduce_ms(reps: int = 5):
    """Device time (CUDA events) of the ADM-64 training step's gradient
    all-reduce, medians of ``reps``: ``DataSharder.all_reduce_mean_`` of
    the state's flat gradient buffer (``step_ms``: the train step's, in
    place), of one gradient a parameter (``list_ms``: flatten, all-reduce,
    copy back, as the step reduced before its gradients lived in one
    buffer), and the bare ``dist.all_reduce`` of the buffer."""
    import torch
    import torch.distributed as dist
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.parallel import data_sharder, make_mesh
    from autodiffusion_tpu_torch.train import create_train_state

    m = create_model(ModelConfig.adm64(), device="cuda")
    state = create_train_state(m, ema_rates=())
    state.bind_grads()
    flat = state.grad_buffer.fill_(1.0)
    n = flat.numel()
    grads = [torch.ones(p.shape, device="cuda") for p in state.params]
    shard = data_sharder(make_mesh())

    def timed(fn):
        for _ in range(2):
            fn()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[reps // 2]

    step = timed(lambda: shard.all_reduce_mean_([flat]))
    listed = timed(lambda: shard.all_reduce_mean_(grads))
    if not (bool((flat == 1).all())
            and all(bool((g == 1).all()) for g in grads)):
        raise AssertionError("the all-reduce mean at world size 1 changed "
                             "the gradients")
    bare = timed(lambda: dist.all_reduce(flat))
    # the list's flatten (read + write) and copy back (read + write),
    # float32
    bound = 4 * 4 * n / HBM_BYTES_PER_S * 1e3
    del state, m, flat, grads
    torch.cuda.empty_cache()
    return dict(params=n, step_ms=step, list_ms=listed, all_reduce_ms=bare,
                list_copy_bound_ms=bound)


def dist_worker(spec_path: str) -> int:
    """One torchrun rank of ``phase_dist``: the runs of ``dist_runs`` with
    the process group up (the CLI's ``setup_dist`` makes it), then the
    all-reduce timing; the record goes to the spec's directory."""
    import torch
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    res = dist_runs(spec["paths"], spec["files"], spec["out"])
    if not dist.is_initialized():
        raise AssertionError("no process group under torchrun")
    res["group"] = dict(backend=dist.get_backend(),
                        world=dist.get_world_size(), rank=dist.get_rank(),
                        nccl=".".join(map(str, torch.cuda.nccl.version())),
                        device=torch.cuda.current_device())
    res["allreduce"] = allreduce_ms()
    with open(os.path.join(spec["out"], "result.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def phase_dist(paths, files, smi: str):
    """``sample`` (unguided and guided, the default path), ``train`` and a
    guided fitness chunk data parallel under
    ``python -m torch.distributed.run --standalone --nproc_per_node=1``
    (NCCL, the group up at world size 1, so every all-reduce runs), held
    to the same runs without torchrun: losses and FIDs within 1e-3
    relative, sample pixels within one uint8 level, labels equal, and each
    kernel's launches equal (the flash forward, dQ and dK/dV, and the
    GroupNorm forward and backward among them). Prints the NCCL version,
    the ADM-64 gradient all-reduce's device time and the card."""
    import numpy as np
    import torch

    base = os.path.join(WORK, "dist")
    plain_dir, tr_dir = (os.path.join(base, k) for k in ("plain", "torchrun"))
    for d in (plain_dir, tr_dir):
        os.makedirs(d, exist_ok=True)
    plain = dist_runs(paths, files, plain_dir)
    torch.cuda.empty_cache()
    spec = os.path.join(base, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(paths=paths, files=files, out=tr_dir), f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    for k in DEFAULT:
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.join(ROOT, "chip_smoke.py"),
           "--dist-worker", spec]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError("the torchrun run did not end within 400 s")
    wall = time.time() - t0
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke_dist.log"), "w") as f:
        f.write(text)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun returned {proc.returncode}:\n"
                             f"{text[-3000:]}")
    with open(os.path.join(tr_dir, "result.json")) as f:
        tr = json.load(f)

    group = tr["group"]
    if (group["backend"], group["world"], group["rank"]) != ("nccl", 1, 0):
        raise AssertionError(f"torchrun's group: {group}")
    samples = [name for name, _, _ in DIST_SAMPLES]
    names = ["train"] + samples + ["fitness"]
    for name in ["train"] + samples:
        for run in (plain, tr):
            if run[name]["rc"] != 0:
                raise AssertionError(f"{name} returned {run[name]['rc']}")
    lp, lt = plain["train"]["losses"], tr["train"]["losses"]
    if len(lp) != DIST_TRAIN_STEPS or len(lt) != DIST_TRAIN_STEPS or \
            not all(math.isfinite(v) for v in lp + lt):
        raise AssertionError(f"train losses {lp} vs {lt}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lt, lp))
    fp, ft = plain["fitness"]["fids"], tr["fitness"]["fids"]
    if not all(math.isfinite(v) and v >= 0 for v in fp + ft):
        raise AssertionError(f"FIDs {fp} vs {ft}")
    fid_rel = max(abs(a - b) / abs(b) for a, b in zip(ft, fp))
    pix = {}
    for name in samples:
        with np.load(plain[name]["npz"]) as a, \
                np.load(tr[name]["npz"]) as b:
            arr_p, arr_t = a["arr_0"], b["arr_0"]
        if arr_p.shape != (16, 64, 64, 3) or arr_t.shape != arr_p.shape:
            raise AssertionError(f"{name}: {arr_p.shape} vs {arr_t.shape}")
        pix[name] = int(np.abs(arr_p.astype(np.int16) - arr_t).max())
        if plain[name]["labels"] != tr[name]["labels"]:
            raise AssertionError(f"{name} labels differ under torchrun")
    if loss_rel > 1e-3 or fid_rel > 1e-3 or max(pix.values()) > 1:
        raise AssertionError(
            f"torchrun vs one process: losses {lt} vs {lp} ({loss_rel:.2e} "
            f"relative), FIDs {ft} vs {fp} ({fid_rel:.2e}), sample pixels "
            f"{pix} levels apart (limits 1e-3, 1e-3, 1)")
    launched = set()
    for name in names:
        if tr[name]["launches"] != plain[name]["launches"]:
            raise AssertionError(
                f"{name} launches under torchrun {tr[name]['launches']} != "
                f"{plain[name]['launches']} in one process")
        launched |= {k for k, v in tr[name]["launches"].items() if v}
    missing = [k for k in DIST_KERNELS if k not in launched]
    if missing:
        raise AssertionError(f"the torchrun runs launched no {missing}")
    ar = tr["allreduce"]
    log(f"dist: NCCL {group['nccl']}, backend {group['backend']}, world "
        f"{group['world']}, torchrun wall {wall:.1f} s (process start, "
        f"NCCL init, the runs)")
    log(f"dist: ADM-64 gradient all-reduce ({ar['params']} float32 "
        f"parameters) a step: {ar['step_ms']:.3f} ms device time (the "
        f"flat gradient buffer in place, CUDA events); one tensor a "
        f"parameter {ar['list_ms']:.3f} ms (flatten + all-reduce + copy "
        f"back; copy bound {ar['list_copy_bound_ms']:.3f} ms); the bare "
        f"all-reduce {ar['all_reduce_ms']:.3f} ms; on {smi}")
    log(f"dist: torchrun vs one process: train losses {lt} vs {lp} "
        f"({loss_rel:.2e} relative), fitness FIDs {ft} vs {fp} "
        f"({fid_rel:.2e}), sample pixels at most {pix} level(s) apart; "
        f"launches equal ({sorted(launched)}); wall (torchrun / one "
        f"process) " + ", ".join(
            f"{name} {tr[name]['wall_s']:.1f} / {plain[name]['wall_s']:.1f}"
            f" s" for name in names))
    return dict(group=group, allreduce=ar, torchrun_wall_s=wall,
                loss_rel=loss_rel, fid_rel=fid_rel, pixel_levels=pix,
                plain={k: {kk: vv for kk, vv in v.items() if kk != "npz"}
                       for k, v in plain.items()},
                torchrun={k: v for k, v in tr.items() if k in names},
                runs=[tr[k] for k in names])


# ------------------------------------------- SD and LDM generation commands

GEN_PROMPTS = ["a photo of a red car on the street", "a bowl of fruit",
               "a man riding a horse in the snow", "the cat on the sofa"]
# a searched 4-step schedule (phase_sd_profile's) and five DPM-Solver
# knots; --steps of img2img (8) and of the LDM commands (10), cut from the
# CLI's 50 (depth)
TXT2IMG_TIMESTEPS = "[129, 543, 764, 976]"
TXT2IMG_KNOTS = "[1.0, 0.75, 0.5, 0.25, 0.001]"
IMG2IMG_STEPS, LDM_STEPS = 8, 10
LDM_SAMPLES = 4
# the CLI defaults' models: celebahq-ldm-vq-4 (ldm-sample), cin256-v2's
# UNet (ldm-sample --num_classes 1000), inpainting_big (inpaint); each
# with the VQ-f4 first stage (8192 codes of 3 channels)
LDM_MODELS = {
    "ldm": dict(in_channels=3, num_channels=224, channel_mult=(1, 2, 3, 4)),
    "cin": dict(in_channels=3, num_channels=192, channel_mult=(1, 2, 3, 5),
                num_classes=1000, context_dim=512),
    "inpaint": dict(in_channels=7, num_channels=256,
                    channel_mult=(1, 2, 3, 4)),
}
LDM_COMMON = dict(latent_channels=3, num_res_blocks=2, attention_ds=(8, 4, 2),
                  num_head_channels=32)
VQ_F4 = dict(ch=128, ch_mult=(1, 2, 4), num_res_blocks=2, attn_at_ds=(),
             latent_channels=3, embed_dim=3, n_embed=8192)
# the inpainting mask's box: edges off the VQ-f4 grid's multiples of 4
MASK_BOX = (83, 301, 121, 405)


def _ldm_unet(name, device, use_bf16=True):
    from autodiffusion_tpu_torch.models import create_ldm_unet

    kw = dict(LDM_COMMON, **LDM_MODELS[name])
    kw.setdefault("context_dim", 512)
    return create_ldm_unet(latent_channels=kw.pop("latent_channels"),
                           use_bf16=use_bf16, device=device, **kw)


def _vq(device, use_bf16=True):
    from autodiffusion_tpu_torch.models import create_ldm_first_stage

    return create_ldm_first_stage("vq", use_bf16=use_bf16, device=device,
                                  **VQ_F4)


def ldm_weights():
    """Seeded random state dicts of the three LDM UNets, the VQ-f4 first
    stage and cin's class embedding (1001 rows: cin256-v2 keeps an
    unconditional one), float32, built on the CPU."""
    import torch
    from autodiffusion_tpu_torch.models import random_init_

    out = {}
    for seed, name in enumerate(LDM_MODELS):
        with torch.device("cpu"):
            m = random_init_(_ldm_unet(name, "cpu"), 20 + seed)
        out[name] = m.state_dict()
        log(f"LDM {name} UNet: {sum(p.numel() for p in m.parameters())} "
            "params")
    out["vq"] = random_init_(_vq("cpu"), 23).state_dict()
    out["embedding"] = torch.randn(
        1001, 512, generator=torch.Generator().manual_seed(24)) / 512 ** 0.5
    return out


def gen_files(paths, ldm):
    """The generation commands' inputs: a prompts file of four prompts, a
    seeded 512 x 512 PNG for img2img, a 512 x 512 image and mask pair for
    inpaint, and a CompVis-layout LDM checkpoint (float16) for each of the
    three models."""
    import numpy as np
    import torch
    from PIL import Image

    out = dict(paths, prompts=os.path.join(WORK, "prompts.txt"),
               init=os.path.join(WORK, "init.png"),
               image=os.path.join(WORK, "scene.png"),
               mask=os.path.join(WORK, "scene_mask.png"))
    with open(out["prompts"], "w") as f:
        f.write("\n".join(GEN_PROMPTS) + "\n")
    rng = np.random.RandomState(16)
    # smooth colour fields plus noise, so the encoders see structure
    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    for key in ("init", "image"):
        base = np.stack([np.sin(6 * xx + rng.rand() * 6),
                         np.cos(5 * yy + rng.rand() * 6),
                         np.sin(4 * (xx + yy))], -1)
        img = (127.5 * (base + 1) * 0.8 + rng.rand(512, 512, 3) * 50)
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(out[key])
    mask = np.zeros((512, 512), np.uint8)
    r0, r1, c0, c1 = MASK_BOX
    mask[r0:r1, c0:c1] = 255
    Image.fromarray(mask).save(out["mask"])
    half = {k: v.half() for k, v in ldm["vq"].items()}
    for name in LDM_MODELS:
        sd = {f"model.diffusion_model.{k}": v.half()
              for k, v in ldm[name].items()}
        sd.update({f"first_stage_model.{k}": v for k, v in half.items()})
        if name == "cin":
            sd["cond_stage_model.embedding.weight"] = ldm["embedding"].half()
        out[f"{name}_ckpt"] = os.path.join(WORK, f"{name}.ckpt")
        torch.save({"state_dict": sd}, out[f"{name}_ckpt"])
    return out


def ldm_sites(env=FUSED_NORM_ALONE):
    """record_sites of the LDM commands' model calls at the CLI defaults'
    sizes, under the default path's routes: the unconditional and cin
    UNets at a 64 x 64 latent (the cin UNet on one class token of 512),
    the VQ-f4 decode of a 64 x 64 latent (ldm-sample), and for inpaint at
    512 x 512 the VQ-f4 encode, the UNet at the 128 x 128 latent and the
    decode of it."""
    import torch

    with torch.device("meta"):
        unets = {name: _ldm_unet(name, "meta") for name in LDM_MODELS}
        vq = _vq("meta")

    def t():
        return torch.zeros(1)

    return {
        "ldm_unet": record_sites(lambda: unets["ldm"](
            torch.empty(1, 3, 64, 64), t()), env),
        "cin_unet": record_sites(lambda: unets["cin"](
            torch.empty(1, 3, 64, 64), t(), torch.empty(1, 1, 512)), env),
        "ldm_decode": record_sites(lambda: vq.decode(
            torch.empty(1, 3, 64, 64), force_not_quantize=True), env),
        "inpaint_encode": record_sites(lambda: vq.encode(
            torch.empty(1, 3, 512, 512)), env),
        "inpaint_unet": record_sites(lambda: unets["inpaint"](
            torch.empty(1, 7, 128, 128), t()), env),
        "inpaint_decode": record_sites(lambda: vq.decode(
            torch.empty(1, 3, 128, 128), force_not_quantize=True), env),
    }


# (kernel, part, batch) of the new commands' attention sites, at the
# commands' device batches: ldm-sample's 4 samples, img2img's encode of one
# image, inpaint's one pair
GEN_ATTN_PARTS = (
    ("flash_fwd", "ldm_unet", LDM_SAMPLES),
    ("flash_fwd", "cin_unet", LDM_SAMPLES),
    ("flash_fwd_wide", "ldm_decode", LDM_SAMPLES),
    ("flash_fwd", "inpaint_unet", 1),
    ("flash_fwd_wide", "inpaint_encode", 1),
    ("flash_fwd_wide", "inpaint_decode", 1),
    ("flash_fwd_wide", "sd_encode", 1),
)
# ... and of their GroupNorms, merged by batch (a site in several parts is
# checked once)
GEN_GN_PARTS = {LDM_SAMPLES: ("ldm_unet", "cin_unet", "ldm_decode"),
                1: ("inpaint_encode", "inpaint_unet", "inpaint_decode",
                    "sd_encode")}


def phase_gen_kernels(sites):
    """The attention and GroupNorm kernels at every site the generation
    commands' default path gives them that no earlier phase ran: the LDM
    UNets' ADM-layout D = 32 attention (T 1024 / 256 / 64 with 14 / 21 /
    28 heads; inpaint's T 4096 / 1024 / 256 with 16 / 24 / 32), cin's
    token-major D = 32 self-attention and its cross-attention over one
    class token (S = 1), the VQ-f4 mid-block's D = 512 at T 4096 and 16384
    and SD's encoder's; the GroupNorms of the LDM UNets and the VQ-f4
    encoder and decoder (C 128 at 256^2 and 512^2 among them) and of SD's
    encoder. Returns (attention rows, GroupNorm rows)."""
    attn = phase_attention(sites, GEN_ATTN_PARTS, extra=())
    gn_rows = []
    for batch, parts in GEN_GN_PARTS.items():
        merged = {}
        for part in parts:
            for key, n in sites[part]["group_norm_fwd"].items():
                merged[key] = merged.get(key, 0) + n
        gn_rows += phase_new_kernels(
            {"group_norm_fwd": merged, "group_norm_bwd": {}, "conv3x3": {},
             "conv3x3_fused": {}}, batch, reps=3)
    return attn, gn_rows


def _run_command(argv, label: str, want: dict):
    """``adt-torch`` ``argv`` on the default path, its launch counters set
    to 0 just before and read just after (each must equal ``want``, and a
    kernel of ``want`` may not be missing), its standard output echoed and
    returned, with wall seconds and peak memory."""
    import io

    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    buf = io.StringIO()
    with switches(DEFAULT), contextlib.redirect_stdout(buf):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"adt-torch {label} returned {rc}")
    full = {k: want.get(k, 0) for k in launches}
    for name, count in full.items():
        if count and not launches[name]:
            raise AssertionError(f"kernel {name} never launched by {label}")
    if launches != full:
        raise AssertionError(f"{label} launch counts {launches} != {full}")
    return dict(text=text, wall_s=wall, launches=launches,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _expected(sites, calls):
    """{kernel: launches} of ``calls`` ({part: number of calls})."""
    out = {}
    for part, n in calls.items():
        for k, c in per_call(sites[part]).items():
            out[k] = out.get(k, 0) + c * n
    return out


def _images_per_s(text, label):
    """Images a second from the command's "created N samples (t s)" /
    "... (t s)" log lines: the samples of its last line over the seconds
    since its sampling began."""
    found = re.findall(r"created (\d+) samples \(([\d.]+) s\)", text)
    if not found:
        raise AssertionError(f"{label}: no timing line in its output")
    n, secs = found[-1]
    return int(n) / float(secs)


def _per_call_line(sites, parts):
    return "; ".join(f"{part} {dict((k, v) for k, v in per_call(sites[part]).items() if v)}"
                     for part in parts)


def phase_txt2img(paths, sites):
    """``adt-torch txt2img`` at SD v1 width, 512 x 512, four prompts in one
    batch of 4 (the UNet at batch 8 under guidance), bf16: PLMS over the
    searched 4-step --timesteps (5 UNet calls), DPM-Solver over five knots
    (4 calls) and PLMS with a --prompt_mask (5 calls), one decode of 4
    each; then ``convert --preset sd`` of the checkpoint and the PLMS run
    again from the params directory, which must give the same images.
    Each run's launches equal the per-call counts of the models times its
    calls; uint8 [4, 512, 512, 3] images; images/s and peak memory."""
    import numpy as np

    base = ["txt2img", "--device", "cuda", "--clip_vocab", paths["vocab"],
            "--clip_merges", paths["merges"], "--from_file",
            paths["prompts"], "--n_samples", "4", "--seed", "42"]
    runs = {"plms": (["--sampler", "plms", "--timesteps",
                      TXT2IMG_TIMESTEPS], 5),
            "dpm_solver": (["--sampler", "dpm_solver", "--timesteps",
                            TXT2IMG_KNOTS], 4),
            "prompt_mask": (["--sampler", "plms", "--timesteps",
                             TXT2IMG_TIMESTEPS, "--prompt_mask",
                             "[1, 1, 0, 1]"], 5)}
    out = {}
    for label, (extra, calls) in runs.items():
        npz = os.path.join(WORK, f"txt2img_{label}.npz")
        want = _expected(sites, {"unet": calls, "decode": 1})
        r = _run_command(base + ["--ckpt", paths["ckpt"], "--out", npz]
                         + extra, f"txt2img ({label})", want)
        with np.load(npz) as z:
            arr = z["arr_0"]
        if arr.dtype != np.uint8 or arr.shape != (4, 512, 512, 3):
            raise AssertionError(f"txt2img ({label}): {arr.dtype} "
                                 f"{arr.shape}")
        r.update(images_per_s=_images_per_s(r.pop("text"), label), npz=npz,
                 unet_calls=calls)
        log(f"txt2img ({label}): {calls} UNet calls at batch 8 and a decode"
            f" of 4, launches {r['launches']}; a call "
            f"{_per_call_line(sites, ('unet', 'decode'))}; images/s "
            f"{r['images_per_s']:.3f} (sampling + decode), peak memory "
            f"{r['peak_gb']:.2f} GB, wall {r['wall_s']:.1f} s")
        out[label] = r
    params = os.path.join(WORK, "sd_params")
    t0 = time.time()
    _run_command(["convert", "--device", "cuda", "--preset", "sd",
                  "--torch_path", paths["ckpt"], "--out", params],
                 "convert --preset sd", {})
    sizes = {f: os.path.getsize(os.path.join(params, f))
             for f in sorted(os.listdir(params))}
    log(f"convert --preset sd: {sizes} bytes, {time.time() - t0:.1f} s")
    npz = os.path.join(WORK, "txt2img_from_dir.npz")
    r = _run_command(base + ["--ckpt", params, "--out", npz]
                     + runs["plms"][0], "txt2img (params directory)",
                     _expected(sites, {"unet": 5, "decode": 1}))
    with np.load(npz) as a, np.load(out["plms"]["npz"]) as b:
        same = np.array_equal(a["arr_0"], b["arr_0"])
        diff = int(np.abs(a["arr_0"].astype(int)
                          - b["arr_0"].astype(int)).max())
    log(f"txt2img from the params directory: images equal to the "
        f"checkpoint file's: {same} (max |diff| {diff}), wall "
        f"{r['wall_s']:.1f} s")
    if not same:
        raise AssertionError(f"txt2img from {params} differs from the .ckpt "
                             f"run by up to {diff}")
    out["convert"] = dict(sizes=sizes, seconds=time.time() - t0,
                          from_dir_launches=r["launches"])
    return out


def phase_img2img(paths, sites):
    """``adt-torch img2img`` at SD v1 width on the synthesized 512 x 512
    PNG, strength 0.75 of an 8-step schedule (6 DDIM steps: the UNet at
    batch 4 for 2 samples under guidance), bf16: one encode of the image,
    6 UNet calls, one decode of 2."""
    import numpy as np

    npz = os.path.join(WORK, "img2img.npz")
    calls = int(0.75 * IMG2IMG_STEPS)
    r = _run_command(
        ["img2img", "--device", "cuda", "--ckpt", paths["ckpt"],
         "--clip_vocab", paths["vocab"], "--clip_merges", paths["merges"],
         "--init_img", paths["init"], "--prompt", GEN_PROMPTS[0],
         "--strength", "0.75", "--steps", str(IMG2IMG_STEPS), "--out", npz],
        "img2img", _expected(sites, {"encode": 1, "unet": calls,
                                     "decode": 1}))
    with np.load(npz) as z:
        arr = z["arr_0"]
    if arr.dtype != np.uint8 or arr.shape != (2, 512, 512, 3):
        raise AssertionError(f"img2img: {arr.dtype} {arr.shape}")
    r["images_per_s"] = _images_per_s(r.pop("text"), "img2img")
    log(f"img2img: an encode, {calls} UNet calls at batch 4, a decode of 2, "
        f"launches {r['launches']}; a call "
        f"{_per_call_line(sites, ('encode', 'unet', 'decode'))}; images/s "
        f"{r['images_per_s']:.3f}, peak memory {r['peak_gb']:.2f} GB, wall "
        f"{r['wall_s']:.1f} s")
    return r


def phase_ldm_sample(paths, sites):
    """``adt-torch ldm-sample`` at the CLI's defaults (celebahq-ldm-vq-4:
    latent 64 x 64, eta 1, 4 samples) and with --num_classes 1000 at
    cin256-v2's UNet widths (labels drawn), bf16, 10 DDIM steps each: 10
    UNet calls at batch 4 and one VQ-f4 decode of 4; uint8 [4, 256, 256,
    3] images."""
    import numpy as np

    out = {}
    for label, extra, part in (
            ("unconditional", [], "ldm_unet"),
            ("cin", ["--num_classes", "1000", "--num_channels", "192",
                     "--channel_mult", "1,2,3,5"], "cin_unet")):
        npz = os.path.join(WORK, f"ldm_{label}.npz")
        ckpt = paths["cin_ckpt" if label == "cin" else "ldm_ckpt"]
        r = _run_command(["ldm-sample", "--device", "cuda", "--ckpt", ckpt,
                          "--steps", str(LDM_STEPS), "--n_samples",
                          str(LDM_SAMPLES), "--out", npz] + extra,
                         f"ldm-sample ({label})",
                         _expected(sites, {part: LDM_STEPS,
                                           "ldm_decode": 1}))
        with np.load(npz) as z:
            arr = z["arr_0"]
        if arr.dtype != np.uint8 or arr.shape != (LDM_SAMPLES, 256, 256, 3):
            raise AssertionError(f"ldm-sample ({label}): {arr.dtype} "
                                 f"{arr.shape}")
        r["images_per_s"] = _images_per_s(r.pop("text"), label)
        log(f"ldm-sample ({label}): {LDM_STEPS} UNet calls at batch "
            f"{LDM_SAMPLES} and a decode, launches {r['launches']}; a call "
            f"{_per_call_line(sites, (part, 'ldm_decode'))}; images/s "
            f"{r['images_per_s']:.3f}, peak memory {r['peak_gb']:.2f} GB, "
            f"wall {r['wall_s']:.1f} s")
        out[label] = r
    return out


def phase_inpaint(paths, sites):
    """``adt-torch inpaint`` at the CLI's defaults (inpainting_big: UNet 256
    channels on the 2 x 3 + 1 channel input) on the synthesized 512 x 512
    image and mask pair, bf16, 10 DDIM steps: one VQ-f4 encode of the
    masked image, 10 UNet calls at the 128 x 128 latent, one decode; the
    PNG keeps every pixel outside the mask."""
    import numpy as np
    from PIL import Image

    outdir = os.path.join(WORK, "inpaint_out")
    r = _run_command(["inpaint", "--device", "cuda", "--ckpt",
                      paths["inpaint_ckpt"], "--image", paths["image"],
                      "--mask", paths["mask"], "--outdir", outdir,
                      "--steps", str(LDM_STEPS)], "inpaint",
                     _expected(sites, {"inpaint_encode": 1,
                                       "inpaint_unet": LDM_STEPS,
                                       "inpaint_decode": 1}))
    got = np.asarray(Image.open(os.path.join(outdir, "scene.png")))
    src = np.asarray(Image.open(paths["image"]).convert("RGB"))
    keep = np.asarray(Image.open(paths["mask"])) < 128
    if got.shape != (512, 512, 3) or not np.array_equal(got[keep],
                                                        src[keep]):
        raise AssertionError("inpaint: the output differs from the image "
                             "outside the mask")
    r["images_per_s"] = _images_per_s(r.pop("text"), "inpaint")
    log(f"inpaint: an encode, {LDM_STEPS} UNet calls, a decode, launches "
        f"{r['launches']}; a call "
        f"{_per_call_line(sites, ('inpaint_encode', 'inpaint_unet', 'inpaint_decode'))}"
        f"; images/s {r['images_per_s']:.3f}, peak memory "
        f"{r['peak_gb']:.2f} GB, wall {r['wall_s']:.1f} s")
    return r


def phase_ldm_parity(ldm):
    """The LDM commands' paths at full width in float32, seeded random
    weights, GPU (the kernels, default path) against CPU (their twins), at
    a 32 x 32 latent (128 x 128 images), TF32 off: ldm-sample's two DDIM
    steps with eta 1 and the last step's noise (x_T and each z injected)
    and the VQ-f4 decode, unconditional and on cin's class token; inpaint's
    condition (the masked image's VQ encode beside the half-pixel-centre
    mask resize), two DDIM steps of the concat-conditioned UNet and the
    decode. Each output within 1e-3 x its scale. Returns {output: max abs
    error}."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import (inpaint_composite,
                                                  inpaint_condition)
    from autodiffusion_tpu_torch.models import ClassEmbedder
    from autodiffusion_tpu_torch.samplers import (ModelVarType,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_sd_tables

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(17)
    x_t = torch.randn(1, 3, 32, 32, generator=gen)
    step_noise = torch.randn(2, 1, 3, 32, 32, generator=gen)
    tables = build_sd_tables([1, 501], linear_start=0.0015,
                             linear_end=0.0195)
    rng = np.random.RandomState(18)
    img01 = rng.rand(128, 128, 3).astype(np.float32)
    mask01 = np.zeros((128, 128), np.float32)
    mask01[21:75, 30:101] = 1.0
    outs = {}
    try:
        for dev in ("cpu", "cuda"):
            t0 = time.time()
            res = outs[dev] = {}
            with switches(DEFAULT), torch.no_grad():
                vq = _vq(dev, use_bf16=False)
                vq.load_state_dict(ldm["vq"])
                for name in LDM_MODELS:
                    unet = _ldm_unet(name, dev, use_bf16=False)
                    unet.load_state_dict(ldm[name])
                    kw = dict(device=dev, clip_denoised=False,
                              var_type=ModelVarType.FIXED_SMALL)
                    if name == "inpaint":
                        cond = inpaint_condition(vq, img01, mask01, dev)
                        z = ddim_sample_loop(
                            lambda x, t, i: unet(torch.cat([x, cond], 1), t),
                            (1, 3, 32, 32), tables.to(dev),
                            noise=x_t.to(dev), **kw)
                        res["inpaint_condition"] = cond.cpu()
                    else:
                        if name == "cin":
                            emb = ClassEmbedder(512, 1001).to(dev)
                            emb.embedding.weight.copy_(ldm["embedding"])
                            ctx = emb(torch.tensor([7], device=dev))

                            def fn(x, t, i):
                                return unet(x, t, ctx)
                        else:
                            def fn(x, t, i):
                                return unet(x, t)
                        z = ddim_sample_loop(
                            fn, (1, 3, 32, 32), tables.to(dev), eta=1.0,
                            final_step_noise=True, noise=x_t.to(dev),
                            step_noise=step_noise.to(dev), **kw)
                    res[f"{name}_ddim2"] = z.cpu()
                    res[f"{name}_decode"] = vq.decode(z).cpu()
                    del unet
                pred = res["inpaint_decode"][0].numpy()
                res["inpaint_composite"] = torch.from_numpy(
                    inpaint_composite(pred, img01, mask01).astype(np.float32))
            log(f"LDM parity on {dev}: {time.time() - t0:.1f} s")
            del vq
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    errs = {}
    for name, want in outs["cpu"].items():
        got = outs["cuda"][name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"LDM parity: non-finite {name} on the GPU")
        errs[name] = float((got - want).abs().max())
        scale = float(want.abs().max())
        # the composite's uint8 pixels: the decode's rounding may move one
        tol = 1.0 if name == "inpaint_composite" else 1e-3 * max(scale, 1.0)
        log(f"LDM parity: {name} GPU vs CPU max abs err {errs[name]:.3e} "
            f"(output max {scale:.3f}, tol {tol:.3g})")
        if not errs[name] <= tol:
            raise AssertionError(f"LDM {name} on the GPU disagrees with the "
                                 f"CPU twin: {errs[name]}")
    return errs


# ------------------------------------------------------- super-resolution

SR_SAMPLES = 2


def sr_sites(env=FUSED_NORM_ALONE):
    """record_sites of the SR models' calls at full width under the
    switches of ``env``: sr-sample's UNet call ("sample", batch 1 from a
    64 x 64 low-res image) and the SR training step's forward ("train",
    train's defaults, with gradients)."""
    import torch
    from autodiffusion_tpu_torch.models import create_sr_model

    with torch.device("meta"):
        models = {kind: create_sr_model(sr_config(kind), SR_LARGE, SR_SMALL,
                                        device="meta")
                  for kind in ("sample", "train")}
    models["train"].train()

    def call(kind):
        return lambda: models[kind](
            torch.empty(1, 3, SR_LARGE, SR_LARGE), torch.zeros(1),
            torch.empty(1, 3, SR_SMALL, SR_SMALL),
            torch.zeros(1, dtype=torch.long))

    return {"sample": record_sites(call("sample"), env),
            "train": record_sites(call("train"), env, grad=True)}


# the spatial_v2 classifier head's GroupNorm: 2048 channels, one position
SPATIAL_V2_GN = (2048, 1, "silu", False)


def phase_sr_kernels(sites_on, sites_default):
    """The flash and GroupNorm kernels (and, at the switched-on training
    step's sites, the conv kernels) against their twins at every new site
    of the SR models, bf16 and fp32, with the sabotaged runs: the flash
    forward, dQ and dK/dV at the SR training step's attention sites (head
    dim 64: T 1024 with 6 heads, T 256 and 64 with 12) at its microbatch
    of 2, whatever the gate routes; the GroupNorm forward at every
    GroupNorm of sr-sample's and the training step's UNets and its
    backward at the training step's, at batch 2; the spatial_v2 head's
    GroupNorm at one position, forward and backward, at train-classifier's
    batch 16. Returns the rows."""
    with switches({"ADT_FLASH_GATE": "0"}):
        train_attn = _sites_of_programs()["sr_train"]
    shapes = sorted({(t, h) for (t, s_len, d, h, g) in train_attn
                     if d == HEAD_DIM and g}, reverse=True)
    rows = phase_kernels(shapes, SR_TRAIN_MICRO)
    gn = dict(sites_default["sample"]["group_norm_fwd"])
    for key, n in sites_default["train"]["group_norm_fwd"].items():
        gn[key] = gn.get(key, 0) + n
    rows += phase_new_kernels(
        {"group_norm_fwd": gn,
         "group_norm_bwd": dict(sites_default["train"]["group_norm_fwd"]),
         "conv3x3": sites_on["train"].get("conv3x3", {}),
         "conv3x3_fused": sites_on["train"].get("conv3x3_fused", {})},
        SR_TRAIN_MICRO, reps=3)
    rows += phase_new_kernels(
        {"group_norm_fwd": {SPATIAL_V2_GN: 1},
         "group_norm_bwd": {SPATIAL_V2_GN: 1}, "conv3x3": {},
         "conv3x3_fused": {}}, 16, reps=5)
    return rows


def _sr_weights(seed: int = 31):
    """sr-sample's SR UNet at full width with seeded random weights (the
    state dict: guided-diffusion's plain UNet keys)."""
    from autodiffusion_tpu_torch.models import create_sr_model, random_init_

    m = random_init_(create_sr_model(sr_config("sample", use_bf16=False),
                                     SR_LARGE, SR_SMALL, device="cpu"), seed)
    return m.state_dict()


def phase_sr_parity(sr_sd, size: int = 128):
    """Two DDIM steps (eta 0, linear schedule respaced to 2 steps, x_T
    injected) of sr-sample's full-width SR UNet in float32 on the GPU (the
    default path: the fused GroupNorm; SDPA at the head dim 192 that has
    no kernel) against the CPU twins, TF32 off, conditioned on a seeded
    low-res image and a label; at ``size`` (128: the 256 model's widths,
    channel_mult and attention levels, at a quarter of the pixels for the
    CPU), within 1e-3 x the output's scale. Returns (error, scale,
    launches on the GPU)."""
    import torch
    from autodiffusion_tpu_torch.models import create_sr_model
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.samplers import ddim_sample_loop
    from autodiffusion_tpu_torch.schedules import build_tables

    gen = torch.Generator().manual_seed(3)
    x_t = torch.randn(1, 3, size, size, generator=gen)
    low = torch.rand(1, 3, size // 4, size // 4, generator=gen) * 2 - 1
    y = torch.tensor([417])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    try:
        for dev in ("cpu", "cuda"):
            t0 = time.time()
            with switches(DEFAULT):
                m = create_sr_model(sr_config("sample", use_bf16=False),
                                    SR_LARGE, SR_SMALL, device=dev)
                m.load_state_dict(sr_sd)
                m.requires_grad_(False)
                tables = build_tables("ddim2",
                                      base_schedule="linear").to(dev)
                lo, yy = low.to(dev), y.to(dev)
                reset_launch_counts()
                with torch.no_grad():
                    outs[dev] = ddim_sample_loop(
                        lambda x, t, i: m(x, t, lo, yy), x_t.shape, tables,
                        device=dev, noise=x_t.to(dev)).cpu()
                launches = dict(LAUNCHES)
            log(f"SR parity on {dev}: {time.time() - t0:.1f} s")
            del m
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = float(outs["cpu"].abs().max())
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    if not (torch.isfinite(outs["cuda"]).all() and err <= 1e-3 * scale):
        raise AssertionError(f"SR parity: GPU and CPU {err:.3e} apart "
                             f"(scale {scale:.3e})")
    if not launches["group_norm_fwd"] or any(launches[k] for k in
                                             FLASH_KERNELS):
        raise AssertionError(f"SR parity: GPU launches {launches} (want "
                             "the GroupNorm forward, and SDPA at D = 192)")
    log(f"SR parity: DDIM-2 of the 256 model's widths at {size} x {size}, "
        f"float32, GPU vs CPU max |d| {err:.3e} (scale {scale:.3e}, limit "
        f"1e-3 x scale), GPU launches {launches}")
    return dict(err=err, scale=scale, size=size, launches=launches)


def sr_files(sr_sd):
    """sr-sample's inputs (the seeded SR weights as a .pt, two seeded
    64 x 64 base samples with labels) and SR training data: 8 seeded
    256 x 256 PNGs of two classes and their 64 x 64 partners (block
    means) for --lq_dir."""
    import numpy as np
    import torch
    from PIL import Image

    d = os.path.join(WORK, "sr")
    for sub in ("hi", "lq"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    torch.save(sr_sd, os.path.join(d, "sr.pt"))
    rng = np.random.RandomState(17)
    np.savez(os.path.join(d, "base.npz"),
             arr_0=rng.randint(0, 256, (SR_SAMPLES, SR_SMALL, SR_SMALL, 3),
                               dtype=np.uint8),
             arr_1=rng.randint(0, 1000, SR_SAMPLES))
    f = SR_LARGE // SR_SMALL
    for i in range(8):
        low = rng.randint(0, 256, (SR_SMALL, SR_SMALL, 3), dtype=np.uint8)
        hi = np.repeat(np.repeat(low, f, 0), f, 1)
        hi = np.clip(hi.astype(np.int32) + rng.randint(-8, 8, hi.shape),
                     0, 255).astype(np.uint8)
        name = f"c{i % 2}_{i}.png"
        Image.fromarray(hi).save(os.path.join(d, "hi", name))
        Image.fromarray(low).save(os.path.join(d, "lq", name))
    return dict(pt=os.path.join(d, "sr.pt"),
                base=os.path.join(d, "base.npz"),
                hi=os.path.join(d, "hi"), lq=os.path.join(d, "lq"))


def phase_sr_sample(files, sites):
    """``adt-torch sr-sample`` at its defaults (bf16, DDIM over all 1000
    steps of the linear schedule, class-conditional) on two seeded 64 x 64
    base samples at batch 2, the default path: the .npz holds uint8
    [2, 256, 256, 3]; the launch counters, set to 0 just before and read
    just after, equal the UNet call's per-call counts times 1000 (the
    GroupNorm forward; no flash kernel: head dim 192 takes SDPA);
    images/s from the command's own clock, peak memory."""
    import numpy as np

    out = os.path.join(WORK, "sr", "sr_samples.npz")
    want = _expected({"sr": sites["sample"]}, {"sr": 1000})
    res = _run_command(["sr-sample", "--device", "cuda", "--model_path",
                        files["pt"], "--base_samples", files["base"],
                        "--num_samples", str(SR_SAMPLES), "--batch_size",
                        str(SR_SAMPLES), "--out", out], "sr-sample", want)
    with np.load(out) as z:
        if z.files != ["arr_0"]:
            raise AssertionError(f"sr-sample: {z.files}")
        arr = z["arr_0"]
    if arr.dtype != np.uint8 or arr.shape != (SR_SAMPLES, SR_LARGE,
                                              SR_LARGE, 3):
        raise AssertionError(f"sr-sample: {arr.dtype} {arr.shape}")
    n, secs = re.findall(r"super-resolved (\d+)/\d+ \(([\d.]+) s\)",
                         res["text"])[-1]
    ips = int(n) / float(secs)
    log(f"sr-sample: {SR_SAMPLES} images 64 -> 256, DDIM-1000, bf16, "
        f"{ips:.4f} images/s ({float(secs):.1f} s of sampling), peak memory "
        f"{res['peak_gb']:.2f} GB, launches {res['launches']} (= the UNet "
        f"call's {per_call(sites['sample'])} x 1000)")
    return dict(res, images_per_s=ips, sample_s=float(secs))


def phase_sr_train(files, env, label: str, lq: bool, steps: int = 3):
    """``adt-torch train --image_size 256 --sr_small_size 64`` at train's
    defaults (bf16, dropout 0.1, 3 res blocks, head width 64), batch 4 in
    two microbatches, ``steps`` steps over the seeded PNGs, low_res
    derived (area downsampling) or from --lq_dir, no checkpoint written:
    finite losses, the same launches every step (the counters set to 0
    just before and read just after), the flash kernels as the gate routes
    the step's sites, on the default path every GroupNorm32 forward and
    backward, with the switches on one GroupNorm backward a forward and
    the fused conv at the in-norms; the command's step time, peak
    memory."""
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.models import create_sr_model
    from autodiffusion_tpu_torch.models.unet import ResBlock
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    save_dir = os.path.join(WORK, f"sr_train_{label}")
    micro = SR_TRAIN_BATCH // SR_TRAIN_MICRO
    argv = ["train", "--device", "cuda", "--data_dir", files["hi"],
            "--save_dir", save_dir, "--image_size", str(SR_LARGE),
            "--sr_small_size", str(SR_SMALL), "--batch_size",
            str(SR_TRAIN_BATCH), "--microbatch", str(SR_TRAIN_MICRO),
            "--max_steps", str(steps), "--log_interval", "1",
            "--save_interval", "0"] + (["--lq_dir", files["lq"]] if lq
                                       else [])
    with switches(env):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        rc = adt_torch(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"SR train ({label}) returned {rc}")
    rows = _progress(save_dir)
    losses = [r["loss"] for r in rows]
    if len(rows) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"SR train ({label}): {rows}")
    per = _per_step(launches, steps, f"SR train {label}")
    flash = flash_per_call("sr_train", env)
    for k in TRAIN_KERNELS:
        if per[k] != flash[k] * micro:
            raise AssertionError(f"SR train ({label}): {per[k]} {k} a step, "
                                 f"want {flash[k] * micro}")
    for k in train_kernels(env, "sr_train"):
        if not per[k]:
            raise AssertionError(f"SR train ({label}): {k} never launched")
    with torch.device("meta"):
        m = create_sr_model(sr_config("train"), SR_LARGE, SR_SMALL,
                            device="meta")
    if env is SWITCHES_ON:
        in_norms = sum(isinstance(mod, ResBlock) and not mod.updown
                       for mod in m.modules())
        if per["group_norm_bwd"] != per["group_norm_fwd"] or \
                per["conv3x3_fused"] != in_norms * micro:
            raise AssertionError(f"SR train ({label}): launches a step {per}")
    elif per["group_norm_fwd"] != gn_modules(m) * micro or \
            per["group_norm_bwd"] != per["group_norm_fwd"]:
        raise AssertionError(f"SR train ({label}): GroupNorm launches a step "
                             f"{per} (want {gn_modules(m) * micro} each)")
    step_s = sorted(r["step_time"] for r in rows[1:])
    step_ms = 1e3 * step_s[len(step_s) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"SR train ({label}, low_res {'--lq_dir' if lq else 'derived'}): "
        f"losses {[round(v, 4) for v in losses]}, command step time after "
        f"the first {step_ms:.1f} ms, launches a step {per}, peak memory "
        f"{peak:.2f} GB, wall {wall:.1f} s")
    return dict(losses=losses, per_step=per, launches=launches,
                command_step_ms=step_ms, peak_gb=peak, wall_s=wall)


def phase_selftest():
    """``adt-torch selftest`` on the card with a synthesized pytorch_fid
    ``.pth`` (n_fixture 8): every consistency check passes (``passed``
    true) and the digest is not the genuine file's (``certified``
    false); its seconds. It launches none of the port's kernels."""
    import torch
    from autodiffusion_tpu_torch.fid import synthesize_pt_inception

    path = os.path.join(WORK, "pt_inception_selftest.pth")
    torch.save(synthesize_pt_inception(5), path)
    res = _run_command(["selftest", "--device", "cuda", "--inception_path",
                        path, "--n_fixture", "8", "--batch_size", "8"],
                       "selftest", {})
    out = json.loads(res["text"].strip().splitlines()[-1])
    if out["passed"] is not True or out["certified"] is not False:
        raise AssertionError(f"selftest: {out}")
    log(f"selftest: passed {out['passed']}, certified {out['certified']}, "
        f"{res['wall_s']:.1f} s; checks " + json.dumps(
            {k: v for k, v in out["checks"].items()
             if k != "weights_sha256"}))
    return dict(res, result=out)


# ------------------------- the joint search and the unconditional LSUN-256

# search_dynamic_unet_imagenet64_classifier_guidance_progressive.sh's flags:
# a budget of 580 kept layers, ten steps of the ADM-64 UNet's 58; the
# progressive hook keeps the skip range at (0, 0) in the first epochs
JOINT_FLAGS = ["--use_dynamic_unet", "True", "--time_step", "10",
               "--index_step", "580", "--max_prun", "0.1", "--min_prun",
               "0.0"]
JOINT_STEPS = 10
# two joint candidates on the same ten timesteps with other skip lists at
# every step, at most 5 = 0.1 x 58 layers a step (--max_prun 0.1)
JOINT_TIMESTEPS = tuple(range(0, 1000, 100))
JOINT_SKIPS = (
    ((0, 3), (), (10, 57), (5,), (), (20, 21, 22), (), (40,), (), (1,)),
    ((), (7,), (), (30, 31), (12,), (), (50, 51, 52, 53, 54), (), (2,), ()),
)


def phase_joint_search(paths, per_step):
    """Stage 2 of the search, ``adt-torch search --use_dynamic_unet True``
    at full ADM-64 width (classifier guidance, DDIM, JOINT_FLAGS,
    SEARCH_CUT) on the default path: run_search, the launches ``per_step``
    times the guided steps (ten a chunk's batch where its candidates keep
    every layer); the best candidate's timesteps and skip lists. Then the
    joint fitness (``make_adm_fitness(joint=True)``, one batch of 16 a
    candidate) on chunks [A, B] and [B, B] of two candidates with the same
    timesteps and other skip lists (JOINT_SKIPS), each from a fresh
    fitness (the same labels and noise): B's FID must be the same in both
    chunks, bit for bit (its rows took B's keep masks and nothing of A's),
    A's another; the launches ``per_step`` times the 2 x 10 guided
    steps."""
    import torch
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception)
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.search import make_adm_fitness

    res = run_search(["--model_path", paths["unet"], "--classifier_path",
                      paths["cls"], "--inception_path", paths["incep"],
                      "--ref_stats", paths["ref"], "--use_ddim", "True"]
                     + JOINT_FLAGS + SEARCH_CUT, DEFAULT, per_step,
                     "joint", "guided DDIM steps at batch 32")
    ks = [k for k, _ in res["chunk_steps"]]
    if ks[0] != JOINT_STEPS or max(ks) > JOINT_STEPS or any(
            nb != SEARCH_BATCHES for _, nb in res["chunk_steps"]):
        raise AssertionError(f"joint search: chunks of (steps, batches) "
                             f"{res['chunk_steps']} (the budget is "
                             f"{JOINT_STEPS} steps of every layer, "
                             f"{SEARCH_BATCHES} batches a chunk)")

    unet = create_model(ModelConfig.adm64(), device="cuda")
    unet.load_state_dict(torch.load(paths["unet"], map_location="cuda",
                                    weights_only=True))
    clf = create_classifier(ClassifierConfig.adm64(), device="cuda")
    clf.load_state_dict(torch.load(paths["cls"], map_location="cuda",
                                   weights_only=True))
    inception = load_fid_inception(paths["incep"], device="cuda")
    ref = FIDStats.load(paths["ref"])

    def fitness():
        return make_adm_fitness(
            model=unet, image_size=64,
            feature_fn=lambda imgs: inception_apply(inception, imgs),
            ref_stats=ref, num_samples=16, batch_size=16, classifier=clf,
            joint=True, candidate_chunk=2, seed=0, device="cuda")

    a, b = ((JOINT_TIMESTEPS, skips) for skips in JOINT_SKIPS)
    with switches(DEFAULT):
        reset_launch_counts()
        f_ab = fitness()([a, b])
        f_bb = fitness()([b, b])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    want = {k: per_step.get(k, 0) * 2 * JOINT_STEPS for k in launches}
    log(f"joint fitness: chunk [A, B] FIDs {f_ab}, chunk [B, B] {f_bb}; "
        f"launches {launches} (expected {want})")
    if not all(math.isfinite(f) and f >= 0 for f in f_ab + f_bb):
        raise AssertionError(f"joint fitness FIDs {f_ab} {f_bb}")
    if f_ab[1] != f_bb[1] or f_ab[0] == f_ab[1]:
        raise AssertionError(f"joint fitness: B's FID {f_ab[1]} beside A, "
                             f"{f_bb[1]} beside B (must be equal); A's "
                             f"{f_ab[0]} (must differ)")
    if launches != want:
        raise AssertionError(f"joint fitness launches {launches} != {want}")
    del unet, clf, inception
    torch.cuda.empty_cache()
    return dict(res, folded_fids={"AB": f_ab, "BB": f_bb},
                folded_launches=launches)


# LSUN bedroom / cat 256 (search_lsun_bedroom.sh, ModelConfig.lsun256):
# the search's device batch (chunk 2 x batch 16) and the published 15-step
# bedroom schedule (sample_LSUN_bedroom_subnet.sh:8)
LSUN_SIZE, LSUN_BATCH, LSUN_SAMPLES = 256, 32, 16
LSUN_TIMESTEPS = ("[644, 737, 67, 804, 134, 871, 6, 639, 268, 335, 402, "
                  "469, 536, 603, 670]")


def lsun_flags():
    """The model flags of ModelConfig.lsun256 for ``adt-torch``."""
    from autodiffusion_tpu_torch.models import ModelConfig

    cfg = ModelConfig.lsun256()
    flags = ("image_size", "num_channels", "num_res_blocks",
             "num_head_channels", "attention_resolutions", "class_cond",
             "learn_sigma", "noise_schedule", "resblock_updown",
             "use_scale_shift_norm", "use_new_attention_order", "use_bf16")
    out = []
    for name in flags:
        out += [f"--{name}", str(getattr(cfg, name))]
    return out


def lsun_sites(env=FUSED_NORM_ALONE):
    """record_sites of one LSUN-256 UNet call (256 x 256, no class) at
    full width under the switches of ``env``."""
    import torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model

    with torch.device("meta"):
        m = create_model(ModelConfig.lsun256(), device="meta")
    return record_sites(lambda: m(torch.empty(1, 3, LSUN_SIZE, LSUN_SIZE),
                                  torch.zeros(1)), env)


def lsun_files(paths):
    """The LSUN-256 UNet at full width with seeded random weights, as a
    guided-diffusion ``.pt`` (float32), and reference statistics of 64
    seeded 256 x 256 images through the port's Inception (the smoke run's
    synthesized weights, ``paths["incep"]``)."""
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception)
    from autodiffusion_tpu_torch.models import (ModelConfig, create_model,
                                                random_init_)

    t0 = time.time()
    m = random_init_(create_model(ModelConfig.lsun256(dropout=0.0),
                                  device="cuda"), 41)
    n = sum(p.numel() for p in m.parameters())
    out = dict(paths, lsun=os.path.join(WORK, "lsun256.pt"),
               lsun_ref=os.path.join(WORK, "lsun_ref.npz"), lsun_params=n)
    torch.save(m.state_dict(), out["lsun"])
    del m
    inception = load_fid_inception(paths["incep"], device="cuda")
    imgs = torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (64, LSUN_SIZE, LSUN_SIZE, 3), dtype=np.uint8))
    FIDStats.from_features(inception_apply(inception, imgs)["pool3"]
                           .double().cpu().numpy()).save(out["lsun_ref"])
    torch.cuda.empty_cache()
    log(f"LSUN-256 UNet: {n} parameters (ADM reports 552 M for its LSUN "
        f"models), seeded weights and reference statistics in "
        f"{time.time() - t0:.1f} s")
    return out


def phase_lsun_kernels(sites_every, sites_default):
    """The kernels the LSUN-256 path launches against their twins at its
    sites, bf16 and fp32, with the sabotaged runs: the flash forward at
    the UNet's attention sites on the ADM blocks' layout (legacy QKV
    order, head dim 64: T 1024 with 8 heads, T 256 and 64 with 16) at the
    search's device batch of 32, whatever the gate routes; the GroupNorm
    forward at the UNet's GroupNorms at 128 x 128 and 256 x 256 (C 256 at
    256 x 256 among them: a run of 8 x 65536 elements, 1 MB in bf16, too
    long for shared memory), the sites no earlier phase has, at the same
    batch of 32 (the search's; the sample's is 16). Returns the rows."""
    rows = phase_attention({"lsun": sites_every},
                           (("flash_fwd", "lsun", LSUN_BATCH),), extra=())
    rows += phase_new_kernels(
        {"group_norm_fwd": {k: n for k, n in
                            sites_default["group_norm_fwd"].items()
                            if k[1] >= 128 * 128},
         "group_norm_bwd": {}, "conv3x3": {}, "conv3x3_fused": {}},
        LSUN_BATCH, reps=3)
    return rows


def phase_lsun_parity(files, size: int = 128):
    """Two unconditional DDIM steps (eta 0, the linear schedule respaced
    to 2 steps, x_T injected) of the LSUN-256 UNet at full width in
    float32 on the GPU (the default path: the fused GroupNorm, the flash
    forward at the legacy-order attention sites the gate keeps) against
    the CPU twins, TF32 off; at ``size`` (128: the model's widths and
    levels at a quarter of the pixels, for the CPU), within 1e-3 x the
    output's scale."""
    import torch
    from autodiffusion_tpu_torch.models import ModelConfig, create_model
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.samplers import ddim_sample_loop
    from autodiffusion_tpu_torch.schedules import build_tables

    sd = torch.load(files["lsun"], map_location="cpu", weights_only=True)
    x_t = torch.randn(1, 3, size, size,
                      generator=torch.Generator().manual_seed(5))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    outs = {}
    try:
        for dev in ("cpu", "cuda"):
            t0 = time.time()
            with switches(DEFAULT):
                m = create_model(ModelConfig.lsun256(dropout=0.0,
                                                     use_bf16=False),
                                 device=dev)
                m.load_state_dict(sd)
                m.requires_grad_(False)
                tables = build_tables("ddim2",
                                      base_schedule="linear").to(dev)
                reset_launch_counts()
                with torch.no_grad():
                    outs[dev] = ddim_sample_loop(
                        lambda x, t, i: m(x, t), x_t.shape, tables,
                        device=dev, noise=x_t.to(dev)).cpu()
                launches = dict(LAUNCHES)
            log(f"LSUN parity on {dev}: {time.time() - t0:.1f} s")
            del m
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    scale = float(outs["cpu"].abs().max())
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    if not (torch.isfinite(outs["cuda"]).all() and err <= 1e-3 * scale):
        raise AssertionError(f"LSUN parity: GPU and CPU {err:.3e} apart "
                             f"(scale {scale:.3e})")
    if not (launches["group_norm_fwd"] and launches["flash_fwd"]):
        raise AssertionError(f"LSUN parity: GPU launches {launches} (want "
                             "the GroupNorm forward and the flash forward)")
    log(f"LSUN parity: DDIM-2 of the LSUN-256 UNet at {size} x {size}, "
        f"float32, GPU vs CPU max |d| {err:.3e} (scale {scale:.3e}, limit "
        f"1e-3 x scale), GPU launches {launches}")
    return dict(err=err, scale=scale, size=size, launches=launches)


def phase_lsun_search(files, sites):
    """The unconditional search of search_lsun_bedroom.sh: ``adt-torch
    search`` without a classifier on ModelConfig.lsun256's flags (bf16,
    DDIM-4, SEARCH_CUT: a device batch of 32 at 256 x 256) on the default
    path: run_search, the launches a UNet call's (``sites``) times the
    UNet calls (one a step); parameters, images/s, peak memory."""
    per = {k: v for k, v in per_call(sites).items() if v}
    # the recorded sites as the gate routes them, held to the literal
    # FLASH_DEFAULT_ANCHORS
    routed = flash_per_call("lsun_unet")["flash_fwd"]
    if per.get("flash_fwd", 0) != routed:
        raise AssertionError(f"LSUN UNet call: {per} flash forwards "
                             f"recorded, {routed} routed")
    res = run_search(["--model_path", files["lsun"], "--inception_path",
                      files["incep"], "--ref_stats", files["lsun_ref"],
                      "--time_step", "4", "--use_ddim", "True"]
                     + lsun_flags() + SEARCH_CUT, DEFAULT, per, "lsun",
                     f"UNet calls at batch {LSUN_BATCH}")
    check_fixed_steps(res, 4, "lsun")
    log(f"search (lsun): {files['lsun_params']} parameters, launches a UNet "
        f"call {per}, {res['images_per_s']:.2f} images/s, peak memory "
        f"{res['peak_gb']:.2f} GB")
    return dict(res, per_call=per, params=files["lsun_params"])


def phase_lsun_sample(files, sites):
    """``adt-torch sample --class_cond False`` of the LSUN-256 UNet
    (ModelConfig.lsun256's flags, bf16) over the published 15-step bedroom
    schedule, 16 images at batch 16, the default path: the .npz holds
    uint8 [16, 256, 256, 3] and no labels; the launches a UNet call's
    times 15; images/s from the command's own clock (its one batch, the
    first calls at this batch included), peak memory."""
    import numpy as np

    npz = os.path.join(WORK, "lsun_samples.npz")
    want = _expected({"lsun": sites}, {"lsun": 15})
    res = _run_command(["sample", "--device", "cuda", "--model_path",
                        files["lsun"], "--use_timestep", LSUN_TIMESTEPS,
                        "--num_samples", str(LSUN_SAMPLES), "--batch_size",
                        str(LSUN_SAMPLES), "--seed", "0", "--out", npz]
                       + lsun_flags(), "sample (lsun)", want)
    with np.load(npz) as z:
        if z.files != ["arr_0"]:
            raise AssertionError(f"sample (lsun): {z.files}")
        arr = z["arr_0"]
    if arr.dtype != np.uint8 or arr.shape != (LSUN_SAMPLES, LSUN_SIZE,
                                              LSUN_SIZE, 3):
        raise AssertionError(f"sample (lsun): {arr.dtype} {arr.shape}")
    ips = _images_per_s(res["text"], "sample (lsun)")
    log(f"sample (lsun): {LSUN_SAMPLES} images at 256 x 256, 15 DDIM "
        f"steps, bf16, {ips:.2f} images/s, peak memory "
        f"{res['peak_gb']:.2f} GB, launches {res['launches']} (= a UNet "
        f"call's {per_call(sites)} x 15)")
    return dict(res, images_per_s=ips)


def adm_weights():
    """Seeded random weights at full ADM-64 width (UNet, classifier), built
    on the CPU: their state dicts."""
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model, random_init_)

    unet = random_init_(create_model(ModelConfig.adm64(dropout=0.0),
                                     device="cpu"), 0)
    cls = random_init_(create_classifier(ClassifierConfig.adm64(),
                                         device="cpu"), 1)
    log(f"models: UNet {sum(p.numel() for p in unet.parameters())} "
        f"params ({unet.layer_num} layers), classifier "
        f"{sum(p.numel() for p in cls.parameters())} params")
    return unet.state_dict(), cls.state_dict()


def phase_profiles(unet_sd, cls_sd):
    """The profiled runs: the default path's guided DDIM-4 run
    (``phase_profile``), the switches' A/B of that run (``phase_ab``), the
    training step with the switches off, on the default path and on
    (``phase_train_profile``), and the SD PLMS-4 fitness batch under the
    same three (``phase_sd_profile``)."""
    with switches(DEFAULT):
        prof = phase_profile(unet_sd, cls_sd)
    ab = phase_ab(unet_sd, cls_sd)
    arms = (("off", ALL_OFF), ("default", DEFAULT), ("on", SWITCHES_ON))
    train = {label: phase_train_profile(env, label, steps=2)
             for label, env in arms}
    weights = sd_weights()
    sd = {}
    for label, env in (("default", DEFAULT), ("switches off", ALL_OFF),
                       ("switches on", SWITCHES_ON)):
        with switches(env):
            sd[label] = phase_sd_profile(weights, label)
    return dict(profile=prof, ab=ab, train_profile=train, sd_profile=sd)


# the measurements run alone (``python3 chip_smoke.py <flag>``)
MEASUREMENTS = ("--profiles", "--flash-ab", "--lost-events",
                "--guided-repro")


def measure_alone(flag: str, smi: str) -> int:
    """Run one measurement of MEASUREMENTS and write its record to
    ``chiprun_out/chip_smoke_<name>.json``."""
    unet_sd, cls_sd = adm_weights()
    if flag == "--profiles":
        rec = phase_profiles(unet_sd, cls_sd)
    elif flag == "--flash-ab":
        res, gate = phase_flash_ab(unet_sd, cls_sd, _sites_of_programs())
        rec = {"flash_ab": res, "flash_gate_from_ab": gate}
    elif flag == "--guided-repro":
        rec = {"guided_repro": phase_guided_repro(unet_sd, cls_sd)}
        # train-classifier shares the classifier's gradient sites: its step
        # on the default path against those sites on SDPA
        os.makedirs(WORK, exist_ok=True)
        try:
            files = train_files()
            with repro_sites_on_sdpa():
                sdpa = phase_train_classifier(files, DEFAULT,
                                              "classifier sites on SDPA",
                                              steps=6)
            rec["train_classifier"] = {
                "default": phase_train_classifier(files, DEFAULT, "default",
                                                  steps=6),
                "classifier sites on SDPA": sdpa}
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
    else:
        rec = {"lost_events": phase_lost_events(unet_sd, cls_sd, tries=8)}
    os.makedirs(OUT, exist_ok=True)
    name = flag[2:].replace("-", "_")
    with open(os.path.join(OUT, f"chip_smoke_{name}.json"), "w") as f:
        json.dump(dict(rec, card=smi), f, indent=1)
    print(smi)
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    worker = len(argv) == 2 and argv[0] == "--dist-worker"
    if argv and not worker and (len(argv) > 1
                                or argv[0] not in MEASUREMENTS):
        print(f"usage: chip_smoke.py [{' | '.join(MEASUREMENTS)}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if worker:                   # a rank of phase_dist, under torchrun
        return dist_worker(argv[1])
    from autodiffusion_tpu_torch.ops import _build

    t_start = time.time()
    marks = []                   # (phase, seconds since the start)

    def mark(name: str) -> None:
        marks.append((name, round(time.time() - t_start, 1)))
        log(f"phase {name} done at {marks[-1][1]} s")
        # on standard error too, so that its tail shows how far a run got
        print(f"chip_smoke: phase {name} done at {marks[-1][1]} s",
              file=sys.stderr, flush=True)

    smi = smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    _build.build_all()
    log(f"kernel build (nvcc sm_90a, parallel): "
        f"{_build.last_build_seconds():.1f} s")
    log(_build.ptxas_report())
    ptxas = phase_ptxas()
    if argv:
        return measure_alone(argv[0], smi)

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
        unet_sd, cls_sd = adm_weights()
        parity = phase_parity(unet_sd, cls_sd, {"default": DEFAULT,
                                                "switches on": SWITCHES_ON})
        parity_err = parity["default"][0]
        parity_on_err, parity_on_launches = parity["switches on"]
        mark("ADM parity")
        missing = [k for k in ADM_KERNELS if not parity_on_launches[k]]
        if missing:
            raise AssertionError(f"the switches-on parity run launched no "
                                 f"{missing}")
        n_unet_gn, n_cls_gn = adm_gn_counts()
        # the default path's guided step: every GroupNorm32 of the UNet
        # and the classifier forward, the classifier's backward (dx alone)
        per_step_default = per_step(None, group_norm_fwd=n_unet_gn + n_cls_gn,
                                    group_norm_bwd=n_cls_gn)
        paths = search_files(unet_sd, cls_sd)
        search = phase_search(paths, DEFAULT, per_step_default, "default")
        search_on = phase_search(paths, SWITCHES_ON,
                                 per_step(SWITCHES_ON, **PER_STEP_NEW_FUSED),
                                 "switches on")
        mark("ADM searches")
        sample = phase_sample(paths, per_step_default)
        mark("sample")
        fid_cmds = phase_fid_commands(paths, sample["ancestral"]["npz"])
        mark("ref-stats and evaluate")
        log(f"ADM phases done at {time.time() - t_start:.1f} s")

        # the training slice: train (default, switches on),
        # train-classifier, nll and sample of the trained checkpoint,
        # GPU-vs-CPU training parity
        files = train_files()
        train = {label: phase_train(files, env, label)
                 for label, env in (("default", DEFAULT),
                                    ("on", SWITCHES_ON))}
        mark("train")
        train_cls = {label: phase_train_classifier(files, env, label)
                     for label, env in (("default", DEFAULT),
                                        ("on", SWITCHES_ON))}
        mark("train-classifier")
        ema_path = os.path.join(train["default"]["save_dir"],
                                "ema_0.9999_000006.pt")
        nll = phase_nll(files, ema_path)
        mark("nll")
        sample_trained = phase_sample_trained(ema_path)
        mark("sample of the trained checkpoint")
        train_parity = phase_train_parity(unet_sd, {
            "default": DEFAULT, "switches on": SWITCHES_ON})
        mark("train parity")
        dist = phase_dist(paths, files, smi)
        mark("data parallel")

        # the Stable Diffusion slice: search-sd's kernels at every SD site,
        # parity of the full-width towers and the searches; the
        # sites of the default path (the fused GroupNorm alone) and of the
        # switches on, read on the meta device
        sd = sd_sites(SWITCHES_ON)
        sd_default = sd_sites(FUSED_NORM_ALONE)
        sd_attn_rows = phase_attention(sd)
        mark("SD attention kernels")
        sd_rows, sd_ms = [], {}
        for part, batch in (("unet", SD_UNET_BATCH), ("decode", SD_BATCH)):
            # the GroupNorm forward at the default path's sites (every
            # GroupNorm32), the convs at the switched-on ones
            part_rows = phase_new_kernels(
                dict({k: sd[part].get(k, {}) for k in NEW_KERNELS},
                     group_norm_fwd=sd_default[part]["group_norm_fwd"]),
                batch, reps=5)
            sd_ms[part] = new_kernels_per_step(
                part_rows, f"SD {part} call (batch {batch}")
            sd_rows += part_rows
        mark("SD GroupNorm and conv kernels")
        weights = sd_weights()
        sd_parity = phase_sd_parity(weights, {"default": DEFAULT,
                                              "switches on": SWITCHES_ON})
        mark("SD parity")
        default_kernels = {k for part in ("unet", "decode")
                           for k, v in per_call(sd_default[part]).items()
                           if v}
        for label, kernels in (("switches on", SD_KERNELS),
                               ("default", sorted(default_kernels))):
            missing = [k for k in kernels if not sd_parity[label][1][k]]
            if missing:
                raise AssertionError(f"the SD {label} parity run launched "
                                     f"no {missing}")
        paths = sd_search_files(weights, paths)
        del weights
        sd_search = phase_sd_search(paths, DEFAULT, sd_default, "default")
        sd_search_on = phase_sd_search(paths, SWITCHES_ON, sd, "switches on")
        mark("SD PLMS searches")
        # DPM-Solver: the smallest population the EA takes
        sd_dpm = phase_sd_search(paths, DEFAULT, sd_default, "dpm_solver",
                                 "dpm_solver", population=2)
        sd_dpm_on = phase_sd_search(paths, SWITCHES_ON, sd,
                                    "dpm_solver switches on", "dpm_solver",
                                    population=2)
        mark("SD DPM-Solver searches")

        # the generation commands on the default path: txt2img, convert,
        # img2img at SD v1 width; ldm-sample (both kinds) and inpaint at
        # the CLI's LDM widths; their new kernel sites and GPU-vs-CPU
        # parity of the LDM paths (SD's are in the SD parity phase)
        ldm = ldm_weights()
        gen_sites = dict(ldm_sites(), sd_encode=sd_default["encode"],
                         unet=sd_default["unet"], decode=sd_default["decode"],
                         encode=sd_default["encode"])
        # the kernels are held to their twins at every site, whatever the
        # gate routes: the sites read with the gate off
        every = dict(FUSED_NORM_ALONE, ADT_FLASH_GATE="0")
        gen_attn_rows, gen_gn_rows = phase_gen_kernels(dict(
            ldm_sites(every), sd_encode=sd_sites(every)["encode"]))
        mark("generation kernels")
        ldm_parity = phase_ldm_parity(ldm)
        mark("LDM parity")
        paths = gen_files(paths, ldm)
        del ldm
        txt2img = phase_txt2img(paths, gen_sites)
        mark("txt2img and convert")
        img2img = phase_img2img(paths, gen_sites)
        mark("img2img")
        ldm_sample = phase_ldm_sample(paths, gen_sites)
        mark("ldm-sample")
        inpaint = phase_inpaint(paths, gen_sites)
        mark("inpaint")

        # super-resolution, the classifier's spatial_v2 pool and selftest:
        # the SR models' kernel sites, GPU-vs-CPU SR parity, sr-sample and
        # SR training at full width, train-classifier with spatial_v2
        sr_default, sr_on = sr_sites(FUSED_NORM_ALONE), sr_sites(SWITCHES_ON)
        sr_rows = phase_sr_kernels(sr_on, sr_default)
        mark("SR kernels")
        sr_sd = _sr_weights()
        sr_parity = phase_sr_parity(sr_sd)
        mark("SR parity")
        srf = sr_files(sr_sd)
        del sr_sd
        sr_sample = phase_sr_sample(srf, sr_default)
        mark("sr-sample")
        sr_train = {label: phase_sr_train(srf, env, label, lq)
                    for label, env, lq in (("default", DEFAULT, False),
                                           ("default lq_dir", DEFAULT, True),
                                           ("on", SWITCHES_ON, False))}
        mark("SR train")
        cls_v2 = phase_train_classifier(files, DEFAULT, "spatial_v2",
                                        extra=["--classifier_pool",
                                               "spatial_v2"])
        mark("train-classifier spatial_v2")
        selftest = phase_selftest()
        mark("selftest")

        # the last slice: the default guided step reproducible; the joint
        # timestep + layer-skip search; the unconditional LSUN-256 search
        # and sample (its kernels at their sites and GPU-vs-CPU parity
        # first)
        repro = phase_default_repro(unet_sd, cls_sd)
        mark("default guided step reproducible")
        joint = phase_joint_search(paths, per_step_default)
        mark("joint search")
        lsun_default = lsun_sites()
        lsun_rows = phase_lsun_kernels(
            lsun_sites(dict(FUSED_NORM_ALONE, ADT_FLASH_GATE="0")),
            lsun_default)
        mark("LSUN kernels")
        paths = lsun_files(paths)
        lsun_parity = phase_lsun_parity(paths)
        mark("LSUN parity")
        lsun_search = phase_lsun_search(paths, lsun_default)
        mark("LSUN search")
        lsun_sample = phase_lsun_sample(paths, lsun_default)
        mark("LSUN sample")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = {r["name"]: r for r in rows
            if (r["T"], r["heads"], r["dtype"]) == (1024, 6, "bfloat16")}
    head.update(head_rows(new_rows + sd_rows))
    head.update({r["name"]: r for r in sd_attn_rows
                 if r["name"] != "flash_fwd" and r["dtype"] == "bfloat16"
                 and (r["T"], r["S"]) == (4096, 4096)})
    # each kernel's launches on the main paths: the searches, sample, the
    # training commands and the generation commands, on the default path
    # and with the switches on
    runs = ([search, search_on, sd_search, sd_search_on, sd_dpm, sd_dpm_on]
            + list(sample.values()) + list(train.values())
            + list(train_cls.values())
            + [r for k, r in txt2img.items() if k != "convert"]
            + [img2img, inpaint] + list(ldm_sample.values())
            + [sr_sample, cls_v2, selftest] + list(sr_train.values())
            + dist["runs"] + list(dist["plain"].values())
            + [joint, {"launches": joint["folded_launches"]}, lsun_search,
               lsun_sample])
    launches = {k: sum(r["launches"][k] for r in runs) for k in KERNEL_INFO}
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
                   "search": search,
                   "search_switches_on": search_on, "sample": sample,
                   "fid_commands": fid_cmds,
                   "sd_sites": {part: {k: {str(s): n for s, n in v.items()}
                                       for k, v in d.items()}
                                for part, d in sd.items()},
                   "sd_attention_rows": sd_attn_rows, "sd_kernel_rows": sd_rows,
                   "sd_new_kernels_ms_per_call": sd_ms,
                   "sd_parity": {k: v[0] for k, v in sd_parity.items()},
                   "sd_search": sd_search, "sd_search_switches_on":
                       sd_search_on, "sd_dpm_search": sd_dpm,
                   "sd_dpm_search_switches_on": sd_dpm_on,
                   "train": train,
                   "train_classifier": train_cls, "nll": nll,
                   "sample_trained": sample_trained,
                   "train_parity": train_parity,
                   "data_parallel": {k: v for k, v in dist.items()
                                     if k != "runs"},
                   "gen_sites": {part: {k: {str(s): n for s, n in v.items()}
                                        for k, v in d.items()}
                                 for part, d in gen_sites.items()},
                   "gen_attention_rows": gen_attn_rows,
                   "gen_group_norm_rows": gen_gn_rows,
                   "ldm_parity": ldm_parity, "txt2img": txt2img,
                   "img2img": img2img, "ldm_sample": ldm_sample,
                   "inpaint": inpaint,
                   "sr_sites": {kind: {k: {str(s): n for s, n in v.items()}
                                       for k, v in d.items()}
                                for kind, d in sr_default.items()},
                   "sr_kernel_rows": sr_rows, "sr_parity": sr_parity,
                   "sr_sample": {k: v for k, v in sr_sample.items()
                                 if k != "text"},
                   "sr_train": sr_train, "train_classifier_spatial_v2":
                       cls_v2, "selftest": selftest["result"],
                   "selftest_s": selftest["wall_s"],
                   "default_guided_repro": repro,
                   "joint_search": joint,
                   "lsun_sites": {k: {str(s): n for s, n in v.items()}
                                  for k, v in lsun_default.items()},
                   "lsun_kernel_rows": lsun_rows,
                   "lsun_parity": lsun_parity, "lsun_search": lsun_search,
                   "lsun_sample": {k: v for k, v in lsun_sample.items()
                                   if k != "text"},
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
