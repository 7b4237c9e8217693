"""Work counted from a configuration's shapes, on the meta device, where
it costs no device time.

``sites_per_image``: the attention and GroupNorm sites one image runs
through each model (the plain reference notes each call), the image run
by the model family's ``count_run``. ``flops_per_image``:
``torch.utils.flop_counter.FlopCounterMode`` over the same run of the
plain reference (for ADM, the guidance's gradient with respect to the
input included).
``least_seconds``: max(operations / peak, bytes / bandwidth) summed over
sites, with each operation's work from ``roofline/<op>.py``;
``kernel_patterns``: the kernel names that implement an operation, from
every ``roofline/kernels/<op>.<impl>.json``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, List

import torch

from benchmark.harness.spec import BENCH, load_json, module
from benchmark.harness.trace import matching
from benchmark.reference.numerics import Numerics

__all__ = ["sites_per_image", "flops_per_image", "least_seconds",
           "kernel_patterns", "peaks", "share"]

HERE = os.path.join(BENCH, "roofline")


def peaks() -> dict:
    return load_json(os.path.join(HERE, "peaks.json"))


def sites_per_image(models: Dict[str, torch.nn.Module], cfg: dict,
                    run: Callable) -> Dict[str, List[dict]]:
    """{model: its sites}, one image through each by the family's
    ``count_run``."""
    out = {}
    for name, m in models.items():
        out[name] = []
        run(name, m, cfg, Numerics(sites=out[name]))
    return out


def flops_per_image(models: Dict[str, torch.nn.Module], cfg: dict,
                    run: Callable) -> Dict[str, int]:
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    for name, m in models.items():
        with FlopCounterMode(display=False) as fc:
            run(name, m, cfg, Numerics())
        out[name] = int(fc.get_total_flops())
    return out


def least_seconds(op: str, sites: List[dict]) -> float:
    """The least time the card could take for ``op`` at ``sites``."""
    p = peaks()
    rate = {"bf16": p["bf16_flops_per_s"], "fp32": p["fp32_flops_per_s"]}
    work = module(os.path.join(HERE, op + ".py"), "bench_roofline_" + op)
    total = 0.0
    for site in sites:
        if site["op"] != op:
            continue
        for ops, nbytes, kind in work.work(site):
            total += max(ops / rate[kind], nbytes / p["hbm_bytes_per_s"])
    return total


def kernel_patterns(op: str, here: str = HERE) -> List[str]:
    pats = []
    for path in sorted(glob.glob(os.path.join(here, "kernels",
                                              op + ".*.json"))):
        with open(path) as f:
            pats += json.load(f)["patterns"]
    return pats


def share(r: dict, op: str):
    """Share (%) of ``op``'s roofline in a trace reading: the least time of
    its sites over every image each model ran, over the device time of
    the kernels that implement it. None where the traced work ran none of
    its sites or none of its kernels."""
    least = sum(least_seconds(op, r["sites_per_image"].get(k, [])) * n
                for k, n in r["images"].items() if n)
    spent = matching(r["kernel_s"], kernel_patterns(op))
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
