"""The search traffic: whole fitness calls of the ADM timestep search,
back to back, as the evolutionary search makes them.

Each call hands the program's fitness (``search.pipelines.
make_adm_fitness``, the ``BatchedFIDFitness`` it returns) one chunk of
candidates, K-step schedules drawn from the seed; the fitness samples
``num_samples`` images a candidate with guided or unguided DDIM, takes
their Inception features and returns the candidates' FIDs. The window
runs calls until ``--seconds`` have passed and divides every image by all
the time elapsed.

The check, after the window: the FIDs of ``fid_calls`` calls drawn from
the seed against the reference's float64 FIDs of the same features; and
``check_rows`` images drawn from the seed, each recomputed by the plain
reference from the same noise, label and schedule, with its features.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from benchmark.harness import checks
from benchmark.harness.common import (CONTROL, REFERENCE, Candidates,
                                      free, traced_call)
from benchmark.harness.models import np64, ref_stats
from benchmark.harness.weights import seed_for
from benchmark.harness.wrappers import Counted, FeatureTap
from benchmark.reference import ddim as ref_ddim
from benchmark.reference import fid as ref_fid
from benchmark.reference.numerics import exact_float32


class _FrechetLog:
    """Keeps the fitness's per-chunk timing lines (its logger's
    ``fid_time``: the Frechet distances of a chunk)."""

    def __init__(self):
        self.fid_s = []

    def writeseq(self, seq):
        m = re.search(r"fid_time: ([0-9.]+)", " ".join(map(str, seq)))
        if m:
            self.fid_s.append(float(m.group(1)))

    def writekvs(self, kvs):
        pass


def run(ctx):
    from autodiffusion_tpu_torch.fid import FIDStats, inception_apply
    from autodiffusion_tpu_torch.search import make_adm_fitness
    from autodiffusion_tpu_torch.utils import logger

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    frechet = _FrechetLog()
    logger.Logger.CURRENT = logger.Logger(None, log_to_stdout=False,
                                          formats=[])
    logger.Logger.CURRENT.text_outputs.append(frechet)
    ctx.mark("program import")
    if dev.type == "cuda":
        from autodiffusion_tpu_torch.ops._build import build_all

        build_all()      # nvcc in a checkout's first run only
        ctx.mark("kernel libraries")

    weights = ctx.family.seeded_weights(cfg, ctx.seed, dev)
    ctx.mark("weights")
    progs, _ = ctx.family.program_models(cfg, weights, dev)
    del weights          # the models hold their own copies
    ctx.mark("program models")
    unet = Counted(progs["unet"], "bench.unet")
    cls = (Counted(progs["classifier"], "bench.classifier")
           if "classifier" in progs else None)
    inception = progs["inception"]
    tap = FeatureTap(lambda imgs: inception_apply(inception, imgs))
    mu, sigma = ref_stats(cfg, ctx.seed, dev)
    stats = FIDStats(np64(mu), np64(sigma))
    ctx.mark("reference statistics")
    fseed = seed_for(ctx.seed, 4)
    chunk = tr["candidate_chunk"]

    def fitness_for(num_samples):
        return make_adm_fitness(
            model=unet, image_size=cfg["image_size"], feature_fn=tap,
            ref_stats=stats, num_samples=num_samples,
            batch_size=cfg["batch_size"],
            base_schedule=cfg["noise_schedule"],
            base_num_steps=cfg["diffusion_steps"], classifier=cls,
            classifier_scale=cfg.get("classifier_scale", 1.0),
            num_classes=1000 if cfg["class_cond"] else None,
            use_ddim=True, eta=tr["eta"], learn_sigma=cfg["learn_sigma"],
            candidate_chunk=chunk, seed=fseed,
            max_device_batch=tr["max_device_batch"], device=dev)

    fitness = fitness_for(cfg["num_samples"])
    # one sampler batch at the window's shapes: every kernel and library
    # the window uses is loaded and warm before it starts
    warm = fitness_for(fitness.device_batch)
    ctx.mark("fitness objects")
    warm(Candidates(ctx.seed, cfg["diffusion_steps"], cfg["time_step"],
                    stream=1).draw(chunk))
    del warm
    ctx.setup_done()

    cands = Candidates(ctx.seed, cfg["diffusion_steps"], cfg["time_step"],
                       stream=0)
    calls = []          # (eval index, candidates, FIDs)
    failed = 0
    counted = {"unet": unet, "features": tap}
    if cls is not None:
        counted["classifier"] = cls

    untraced_s = []     # seconds of each call outside the traced one

    def call(cs):
        idx = fitness.get_state()["eval_count"]
        fids = fitness(cs)
        calls.append((idx, cs, fids))
        return fids

    reading = None
    tap.keep = True
    t0 = time.perf_counter()
    try:
        while True:
            cs = cands.draw(chunk)
            if ctx.trace and reading is None:
                reading, _ = traced_call(ctx, lambda: call(cs), counted)
            else:
                t1 = time.perf_counter()
                call(cs)
                untraced_s.append(time.perf_counter() - t1)
            if (time.perf_counter() - t0 >= ctx.seconds
                    and (untraced_s or not ctx.trace)):
                break
    except (FloatingPointError, RuntimeError) as e:
        ctx.log(f"fitness call failed: {e!r}")
        failed += chunk
    elapsed = time.perf_counter() - t0
    tap.keep = False
    images = len(calls) * chunk * fitness.actual_samples
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    n_batches = -(-fitness.num_samples // fitness.device_batch)
    b = fitness.device_batch
    failed += sum(not np.isfinite(f) for _, _, fids in calls for f in fids)
    if reading is not None:
        reading["images"] = {"unet": reading["unet"]["images"],
                             "classifier": reading.get(
                                 "classifier", {}).get("images", 0),
                             "inception": reading["features"]["images"]}
        reading["steps"] = reading["unet"]["calls"]
        reading["units"] = {"traced": 1, "untraced": len(untraced_s),
                            "untraced_s": sum(untraced_s)}
    ctx.log(f"window: {len(calls)} fitness calls, {images} images in "
            f"{elapsed:.3f} s; device batch {chunk * b}; peak "
            f"{peak / 1e9:.3f} GB; Frechet s a chunk {frechet.fid_s}")

    kept = tap.kept
    tap.kept = []
    del fitness, unet, cls, inception, tap, progs
    free()
    values, control = ({}, {}) if failed else _check(
        ctx, calls, kept, n_batches, b, mu, sigma, fseed)
    del kept
    free()
    return {
        "e2e": {"images_per_s": images / elapsed},
        "reading": reading,
        "attempted": (len(calls) + bool(failed)) * chunk,
        "failed": failed,
        "values": values,
        "control": control,
        "peak": peak,
        "extra": {"fitness_calls": len(calls), "window_s": elapsed,
                  "device_batch": chunk * b, "frechet_s": frechet.fid_s,
                  "fids": [list(map(float, f)) for _, _, f in calls]},
    }


def _check(ctx, calls, kept, n_batches, b, mu, sigma, fseed):
    """The check's numbers, and with ``ctx.control`` the control's."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    if not calls:
        return {}, {}
    chunk = tr["candidate_chunk"]
    rng = np.random.default_rng(seed_for(ctx.seed, 7))
    values, control = {}, {}
    with exact_float32():
        root = ref_fid.sqrt_psd(sigma)
        got, want, ctrl = [], [], []
        for ci in sorted(rng.choice(len(calls), min(tr["fid_calls"],
                                                    len(calls)), False)):
            feats = torch.cat([kept[ci * n_batches + bi][1].reshape(
                chunk, b, -1) for bi in range(n_batches)], dim=1)
            for j in range(chunk):
                got.append(calls[ci][2][j])
                want.append(ref_fid.fid(feats[j], mu, sigma, root=root))
                if ctx.control:
                    ctrl.append(ref_fid.fid(feats[j], mu, sigma,
                                            CONTROL["moments"]))
        values["fid_gap"] = checks.rel_gap(got, want)
        if ctx.control:
            control["fid_gap"] = checks.rel_gap(ctrl, want)
        ctx.log(f"FIDs checked: program {got} reference {want}")

        # images and features of rows drawn from the seed
        rows = chunk * b
        total = len(calls) * n_batches * rows
        picks = sorted(rng.choice(total, min(tr["check_rows"], total),
                                  False))
        by_batch = {}
        for p in picks:
            by_batch.setdefault(p // rows, []).append(int(p % rows))
        x_T, ys, coeffs, prog_u8, prog_f = [], [], [], [], []
        s = cfg["image_size"]
        for kb, rs in by_batch.items():
            ci, bi = divmod(kb, n_batches)
            idx, cands, _ = calls[ci]
            gen = torch.Generator(device=dev).manual_seed(
                seed_for(fseed, idx, bi))
            y = (torch.randint(0, 1000, (b,), generator=gen, device=dev)
                 .repeat(chunk) if cfg["class_cond"] else None)
            noise = torch.randn((rows, 3, s, s), generator=gen, device=dev)
            r = torch.tensor(rs, device=dev)
            x_T.append(noise[r])
            if y is not None:
                ys.append(y[r])
            coeffs += [ref_ddim.step_coefficients(
                cands[j // b], cfg["noise_schedule"],
                cfg["diffusion_steps"]) for j in rs]
            prog_u8.append(kept[kb][0][r])
            prog_f.append(kept[kb][1][r])
        x_T, prog_u8, prog_f = (torch.cat(z) for z in (x_T, prog_u8, prog_f))
        y = torch.cat(ys) if ys else None
        ref = ctx.family.Reference(cfg, ctx.seed, dev, inception=True)
        blk = tr["check_block"]
        got, ctrl, _ = ref.image_check(ctx, prog_u8, x_T, coeffs, y, blk)
        values.update(got)
        control.update(ctrl)
        ref_f = ref.features(REFERENCE, prog_u8, blk)
        values["feature_gap"] = checks.feature_gap(prog_f, ref_f)
        if ctx.control:
            control["feature_gap"] = checks.feature_gap(
                ref.features(CONTROL["inception"], prog_u8, blk), ref_f)
    return values, control
