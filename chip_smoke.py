#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of every CUDA kernel from ``autodiffusion_tpu_torch/ops/
   csrc`` (nvcc, sm_90a);
2. kernels: the flash-attention forward, dQ and dK/dV kernels against
   their plain PyTorch twins at the ADM-64 attention shapes (batch 32,
   head dim 64, bf16 and fp32, plus a ragged length), alone and chained
   through ``FlashAttentionFunction`` as the sampler runs them, within
   limits that a kernel with one tile dropped is shown to break; each
   timed with CUDA events beside its twin, its bound on the card and
   ``F.scaled_dot_product_attention``;
3. parity: two guided DDIM steps of the full-width ADM-64 UNet and
   classifier (float32, seeded random weights) on the GPU against the same
   run on the CPU, where attention is the plain twin;
4. profile: one guided DDIM-4 run at batch 32 in bf16 under
   ``torch.profiler``: device time by kernel, the flash kernels' share and
   the device's idle share (``chiprun_out/chip_smoke_profile.txt``);
5. search: ``adt-torch search`` through its Python entry at full ADM-64
   width (classifier guidance, DDIM-4, chunk 2 x batch 16, 32 samples per
   candidate, population 4, one epoch) with seeded random UNet, classifier
   and Inception weights written as checkpoint files, and reference
   statistics from the port's own Inception features of 64 seeded images.
   Every FID must be finite and >= 0, and the launch counters must show
   each kernel ran, as many times as the guided steps need.

The last lines of standard output are a ``kernels`` JSON line, the
``nvidia-smi`` name / power-limit line and ``{"ok": true, "device": ...}``.
A fuller record goes to ``chiprun_out/chip_smoke.json``. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

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
KERNEL_INFO = {
    "flash_fwd": ("autodiffusion_tpu_torch/ops/csrc/flash_fwd.cu",
                  "autodiffusion_tpu/ops/flash_attention.py:80"),
    "flash_bwd_dq": ("autodiffusion_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "autodiffusion_tpu/ops/flash_attention.py:216"),
    "flash_bwd_dkv": ("autodiffusion_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "autodiffusion_tpu/ops/flash_attention.py:256"),
}
# launches per guided DDIM step: 22 UNet + 13 classifier attention blocks
# forward, 13 classifier blocks backward
PER_STEP = {"flash_fwd": 35, "flash_bwd_dq": 13, "flash_bwd_dkv": 13}


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


def limit(want, dtype: str):
    """Elementwise limit on |kernel - twin| for the twin's output ``want``.

    float32: 2e-5 (1 + |twin|), the JAX tests' tolerance for the TPU
    kernels. bfloat16: 2^-6 |twin| + 2^-8 max|twin|, two to four bf16
    units in the last place of the element plus at most one of the
    tensor's largest: the kernel and its twin may round an output, a p or a
    dS to neighbouring bf16 values, and nothing more. The lse is float32 in
    both dtypes and takes the float32 limit."""
    a = want.float().abs()
    if dtype == "float32":
        return 2e-5 * (1 + a)
    return (2 ** -6 * a + 2 ** -8 * a.max()).clamp_min(1e-30)


def compare(got, want, dtype: str):
    """(max |got - want|, max over elements of |got - want| / limit)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff / limit(want, dtype)).max())


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
            dropped = {}
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
                del faults, bad_dk, bad_dv
            q4, k4, v4, do4 = (z.view(BATCH, h, t, HEAD_DIM)
                               for z in (q, k, v, do))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4))
            qg, kg, vg = (z.detach().requires_grad_(True)
                          for z in (q4, k4, v4))
            og = F.scaled_dot_product_attention(qg, kg, vg)
            sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do4, retain_graph=True))
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
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                rows.append(row)
                log(f"kernel {name:14s} T={t:5d} H={h:2d} {dname:8s} "
                    f"max_abs_err={err:.3e} max err/limit={worst:.3f} "
                    f"(limit {LIMIT_TEXT[dname]}, one tile dropped: "
                    f"{dropped.get(name, float('nan')):.1f}) "
                    f"{'ok' if ok else 'FAIL'}  ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                if not ok:
                    failures.append((name, t, h, dname, err))
    if failures:
        raise AssertionError(f"kernels disagree with their twins: "
                             f"{failures}")
    return rows


def attention_per_step(rows):
    """(kernels, SDPA) device ms of one guided DDIM step's attention at
    batch 32 in bf16, summed over its sites from the per-shape times: the
    forward at every site, the backward at the classifier's."""
    by = {(r["name"], r["T"], r["heads"]): r for r in rows
          if r["dtype"] == "bfloat16"}
    kern = lib = 0.0
    for (t, h), (n_unet, n_cls) in SITES.items():
        fwd = by[("flash_fwd", t, h)]
        dq, dkv = by[("flash_bwd_dq", t, h)], by[("flash_bwd_dkv", t, h)]
        kern += (n_unet + n_cls) * fwd["ms"] + n_cls * (dq["ms"] + dkv["ms"])
        # one SDPA backward computes dq, dk and dv
        lib += (n_unet + n_cls) * fwd["library_ms"] + n_cls * dq["library_ms"]
    log(f"attention per guided DDIM step (batch 32, bf16, 35 forward + 13 "
        f"backward sites): kernels {kern:.4f} ms, SDPA {lib:.4f} ms")
    return kern, lib


def phase_profile(unet_sd, cls_sd):
    """One guided DDIM-4 run at batch 32, full width, bf16: host-clock time
    per step, then the same run under torch.profiler for device time by
    kernel. Device busy share = summed kernel time / unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randint(0, 1000, (32,), generator=gen, device="cuda")
    tables = build_tables("ddim4", base_schedule="cosine").to("cuda")
    cond = classifier_cond_fn(c, y, 1.0)

    def run():
        return ddim_sample_loop(lambda x, t, i: m(x, t, y), (32, 3, 64, 64),
                                tables, device="cuda", generator=gen,
                                cond_fn=cond)

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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 4
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key) / 1e3 / 4
    n_kernels = sum(e.count for e in kernels) / 4
    lines = [f"{e.self_device_time_total / 1e3 / 4:10.3f} ms/step "
             f"{e.count // 4:6d} calls/step  {e.key[:120]}"
             for e in kernels[:25]]
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
    return dict(step_ms=step_ms, busy_ms=busy_ms, flash_ms=flash_ms,
                kernels_per_step=n_kernels, peak_gb=peak_gb, top=lines)


def phase_parity(unet_sd, cls_sd):
    """Two guided DDIM steps of the full-width models in float32: GPU
    (flash kernels) against CPU (plain twin), same weights and noise."""
    import torch
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model)
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.schedules import build_tables

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(3)
        x_t = torch.randn(2, 3, 64, 64, generator=gen)
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
            out = ddim_sample_loop(
                lambda x, t, i: m(x, t, yd), (2, 3, 64, 64), tables.to(dev),
                device=dev, cond_fn=cond, noise=x_t)
            outs[dev] = out.cpu()
            del m, c
        if not torch.isfinite(outs["cuda"]).all():
            raise AssertionError("non-finite guided DDIM output on the GPU")
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        scale = float(outs["cpu"].abs().max())
        log(f"parity: guided DDIM-2, ADM-64 float32, GPU vs CPU max abs "
            f"err {err:.3e} (output max {scale:.3f}, tol 1e-3 x scale)")
        if not err <= 1e-3 * max(scale, 1.0):
            raise AssertionError(f"GPU guided DDIM disagrees with the CPU "
                                 f"twin: {err}")
        return err
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_search(unet_sd, cls_sd):
    import numpy as np
    import torch
    from autodiffusion_tpu_torch.cli.main import main as adt_torch
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception,
                                             synthesize_pt_inception)
    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

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
    del inception

    save_dir = os.path.join(WORK, "search")
    argv = ["search", "--device", "cuda",
            "--model_path", paths["unet"], "--classifier_path", paths["cls"],
            "--inception_path", paths["incep"], "--ref_stats", paths["ref"],
            "--save_dir", save_dir, "--time_step", "4", "--use_ddim", "True",
            "--candidate_chunk", "2", "--batch_size", "16",
            "--num_samples", "32", "--population_num", "4",
            "--select_num", "2", "--mutation_num", "2",
            "--crossover_num", "2", "--max_epochs", "1", "--seed", "0"]
    reset_launch_counts()
    t0 = time.time()
    rc = adt_torch(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"adt-torch search returned {rc}")

    with open(os.path.join(save_dir, "ea_state.json")) as f:
        fids = list(json.load(f)["vis_dict"].values())
    if not fids or not all(math.isfinite(x) and x >= 0 for x in fids):
        raise AssertionError(f"invalid FIDs from the search: {fids}")
    with open(os.path.join(save_dir, "log.txt")) as f:
        phases = [tuple(float(v) for v in m.groups()) for m in re.finditer(
            r"reset_time: ([\d.]+), sample_time: ([\d.]+), "
            r"fid_time: ([\d.]+)", f.read())]
    chunks = len(phases)
    steps = chunks * 2 * 4            # chunks x 2 batches x DDIM-4
    want = {k: v * steps for k, v in PER_STEP.items()}
    log(f"search: {len(fids)} candidates, FIDs {fids}")
    log(f"search: {chunks} chunks, {steps} guided DDIM steps at batch 32, "
        f"launches {launches} (expected {want}), wall {wall:.1f} s")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "search path")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    imgs_per_chunk = 2 * 16 * 2
    sample_s = [p[1] for p in phases]
    steady = sample_s[1:] or sample_s
    ips = imgs_per_chunk * len(steady) / sum(steady)
    log("search: per-chunk reset/sample/fid seconds: "
        + "; ".join(f"{a:.3f}/{b:.3f}/{c:.3f}" for a, b, c in phases))
    log(f"search: images/s through the guided sampler (sample phase = "
        f"guided DDIM-4 + Inception + moments, chunks after the first): "
        f"{ips:.2f}")
    return dict(fids=fids, launches=launches, expected_launches=want,
                chunks=chunks, guided_steps=steps, phases=phases,
                images_per_s=ips, wall_s=wall)


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
    smi = smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    _build.build_all()
    log(f"kernel build (nvcc sm_90a, parallel): "
        f"{_build.last_build_seconds():.1f} s")
    log(_build.ptxas_report())

    rows = phase_kernels()
    attn_ms, attn_sdpa_ms = attention_per_step(rows)

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
        parity_err = phase_parity(unet_sd, cls_sd)
        prof = phase_profile(unet_sd, cls_sd)
        search = phase_search(unet_sd, cls_sd)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = {r["name"]: r for r in rows
            if (r["T"], r["heads"], r["dtype"]) == (1024, 6, "bfloat16")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": search["launches"][name],
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
                   "kernel_rows": rows, "parity_max_abs_err": parity_err,
                   "attention_ms_per_step": attn_ms,
                   "sdpa_attention_ms_per_step": attn_sdpa_ms,
                   "profile": prof, "search": search, "kernels_line": line,
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
