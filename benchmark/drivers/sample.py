"""The sample traffic: one client, closed loop, requests of
``request_images`` images sampled with a searched schedule, as
``adt-torch sample`` makes them.

A request is the program's sampler over the mix's schedule
(``use_timestep``, in the sample command's format), with the
classifier's guidance where the configuration has a classifier:
``parse_timestep_string``, ``create_tables``, ``classifier_cond_fn``,
``ddim_sample_loop`` and ``to_uint8``, the calls of ``cli/main.py::
cmd_sample``; its labels and starting noise are drawn from the seed for
that request. A request's time runs from its issue to its uint8 images on
the host. The window sends requests until ``--seconds`` have passed;
with ``--trace 1``, ``trace_requests`` more follow it under the profiler.

The check, after the window: ``check_rows`` images drawn from the seed
among every request finished, each recomputed by the plain reference
from the same noise, label and schedule.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmark.harness.common import free, percentile, traced_call
from benchmark.harness.weights import seed_for
from benchmark.harness.wrappers import Counted
from benchmark.reference import ddim as ref_ddim
from benchmark.reference.numerics import exact_float32


def _inputs(ctx, r: int, stream: int = 5):
    """Request ``r``'s labels and starting noise, drawn on the card (the
    warm-up's requests from another stream)."""
    cfg, n = ctx.cfg, ctx.traffic["request_images"]
    s = cfg["image_size"]
    gen = torch.Generator(device=ctx.device).manual_seed(
        seed_for(ctx.seed, stream, r))
    y = (torch.randint(0, 1000, (n,), generator=gen, device=ctx.device)
         if cfg["class_cond"] else None)
    noise = torch.randn((n, 3, s, s), generator=gen, device=ctx.device)
    return y, noise, gen


def run(ctx):
    from autodiffusion_tpu_torch.models import create_tables
    from autodiffusion_tpu_torch.samplers import (ModelVarType,
                                                  classifier_cond_fn,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.search import to_uint8
    from autodiffusion_tpu_torch.search.space import parse_timestep_string

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    ctx.mark("program import")
    if dev.type == "cuda":
        from autodiffusion_tpu_torch.ops._build import build_all

        build_all()      # nvcc in a checkout's first run only
        ctx.mark("kernel libraries")
    weights = ctx.family.seeded_weights(cfg, ctx.seed, dev, inception=False)
    ctx.mark("weights")
    progs, mcfg = ctx.family.program_models(cfg, weights, dev)
    del weights          # the models hold their own copies
    ctx.mark("program models")
    unet = Counted(progs["unet"], "bench.unet")
    cls = (Counted(progs["classifier"], "bench.classifier")
           if "classifier" in progs else None)
    tables = create_tables(
        mcfg, parse_timestep_string(tr["use_timestep"])).to(dev)
    var_type = (ModelVarType.LEARNED_RANGE if cfg["learn_sigma"]
                else ModelVarType.FIXED_LARGE)
    scale = cfg.get("classifier_scale", 1.0)

    def request(r: int, stream: int = 5):
        y, noise, gen = _inputs(ctx, r, stream)
        t0 = time.perf_counter()

        def model_fn(x, t, i):
            return unet(x, t, y, keep_mask=None)

        cond = (classifier_cond_fn(cls, y, scale) if cls is not None
                else None)
        x0 = ddim_sample_loop(model_fn, tuple(noise.shape), tables,
                              device=dev, generator=gen, cond_fn=cond,
                              var_type=var_type, noise=noise)
        imgs = to_uint8(x0).cpu()
        return imgs, (time.perf_counter() - t0) * 1e3

    for r in range(tr["warmup_requests"]):
        request(r, stream=8)
    ctx.setup_done()

    done = []            # (request index, uint8 images on the host)
    ms, traced_ms = [], []
    counted = {"unet": unet}
    if cls is not None:
        counted["classifier"] = cls
    reading = None
    failed = 0

    def burst():
        # the traced requests come after the window, so that the profiler's
        # cost to the host (before and after its trace) reaches no timed one
        del traced_ms[:]
        for _ in range(tr["trace_requests"]):
            imgs, t = request(len(done))
            done.append((len(done), imgs))
            traced_ms.append(t)

    t0 = time.perf_counter()
    elapsed = None
    try:
        while time.perf_counter() - t0 < ctx.seconds:
            imgs, t = request(len(done))
            done.append((len(done), imgs))
            ms.append(t)
        elapsed = time.perf_counter() - t0
        if ctx.trace:
            reading, _ = traced_call(ctx, burst, counted)
    except RuntimeError as e:
        ctx.log(f"request failed: {e!r}")
        failed = 1
    if elapsed is None:
        elapsed = time.perf_counter() - t0
    n = tr["request_images"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    if reading is not None:
        reading["images"] = {
            "unet": reading["unet"]["images"],
            "classifier": reading.get("classifier", {}).get("images", 0)}
        reading["steps"] = reading["unet"]["calls"]
        reading["request_ms"] = list(ms)
        reading["units"] = {"traced": len(traced_ms), "untraced": len(ms),
                            "untraced_s": sum(ms) / 1e3}
    ctx.log(f"window: {len(ms)} requests of {n} images in "
            f"{elapsed:.3f} s; request ms p50 {percentile(ms, 50)!r} p90 "
            f"{percentile(ms, 90)!r}; peak {peak / 1e9:.3f} GB")
    del unet, cls, progs, tables
    free()
    values, control = ({}, {}) if failed else _check(ctx, done)
    free()
    return {
        "e2e": {"images_per_s": n * len(ms) / elapsed,
                "request_ms_p90": percentile(ms, 90)},
        "reading": reading,
        "attempted": len(done) + failed,
        "failed": failed,
        "values": values,
        "control": control,
        "peak": peak,
        "extra": {"requests": len(ms), "window_s": elapsed,
                  "images_per_s": n * len(ms) / elapsed,
                  "request_ms_p50": percentile(ms, 50), "request_ms": ms},
    }


def _check(ctx, done):
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    schedule = sorted(json.loads(tr["use_timestep"]))
    if not done:
        return {}, {}
    n = tr["request_images"]
    rng = np.random.default_rng(seed_for(ctx.seed, 7))
    picks = sorted(rng.choice(len(done) * n, min(tr["check_rows"],
                                                 len(done) * n), False))
    x_T, ys, prog = [], [], []
    for p in picks:
        r, j = divmod(int(p), n)
        y, noise, _ = _inputs(ctx, r)
        x_T.append(noise[j:j + 1])
        if y is not None:
            ys.append(y[j:j + 1])
        prog.append(done[r][1][j:j + 1])
    x_T, prog = torch.cat(x_T), torch.cat(prog)
    y = torch.cat(ys) if ys else None
    coeffs = [ref_ddim.step_coefficients(schedule, cfg["noise_schedule"],
                                         cfg["diffusion_steps"])] * len(x_T)
    with exact_float32():
        values, control, _ = ctx.family.Reference(
            cfg, ctx.seed, dev, inception=False).image_check(
                ctx, prog, x_T, coeffs, y, tr["check_block"])
    return values, control
