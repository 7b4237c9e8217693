"""What the drivers share: the run's context, the traced call, the
reference's precisions, and freeing the program's state."""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import trace as tracing
from benchmark.harness.weights import seed_for
from benchmark.reference.numerics import Numerics

__all__ = ["Context", "Candidates", "traced_call", "free", "REFERENCE",
           "CONTROL", "percentile"]

# the reference, and the controls of the check: the same plain models one
# precision below what the configuration states (bf16 diffusion models ->
# fp8 products; float32 Inception with cuDNN's TF32 -> bf16)
REFERENCE = Numerics()
CONTROL = {"diffusion": Numerics(fp8=True),
           "inception": Numerics(dtype=torch.bfloat16),
           "moments": torch.float32}


class Context:
    """One run: the cell, the arguments, the device, the clock from
    process start, and where log lines go (standard error)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, control: bool = False):
        self.cfg = cell.config
        self.family = cell.family
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.control = control
        self.setup_s: Optional[float] = None
        self.phases: Dict[str, float] = {}
        self._last = t_start

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def mark(self, phase: str) -> None:
        """Set-up's seconds since the last mark go to ``phase``, the device
        synchronised first (once CUDA is up)."""
        if self.device.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now

    def setup_done(self) -> None:
        self.mark("warm-up")
        self.setup_s = self._last - self.t_start
        self.log("setup phases: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in self.phases.items()))


class Candidates:
    """K-step schedules over T steps, drawn from the seed the way the
    evolutionary search draws its first population: the first K of a
    shuffled range(T), sorted."""

    def __init__(self, seed: int, steps: int, k: int, stream: int):
        self.rng = random.Random(seed_for(seed, 2, stream))
        self.steps, self.k = steps, k

    def draw(self, n: int) -> List[tuple]:
        out = []
        for _ in range(n):
            pool = list(range(self.steps))
            self.rng.shuffle(pool)
            out.append(tuple(sorted(pool[:self.k])))
        return out


def traced_call(ctx: Context, fn: Callable, counted: Dict[str, object]):
    """Run ``fn`` once under the profiler with the benchmark's ranges open,
    and read the trace: the summary, the launches and each wrapper's
    calls and images over the traced work."""
    for c in counted.values():
        c.tracing = True

    def once():
        for c in counted.values():
            c.reset()
        return fn()

    try:
        prof, launches, window, out = tracing.profiled(once, log=ctx.log)
    finally:
        for c in counted.values():
            c.tracing = False
    reading = tracing.summarize(prof, window)
    del prof
    reading["launches"] = sum(launches.values())
    reading["launches_by_kernel"] = launches
    for name, c in counted.items():
        reading[name] = {"calls": c.calls, "images": c.images}
    return reading, out


def free() -> None:
    """Hand the memory of what the caller dropped back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = max(0, min(len(v) - 1, -(-len(v) * q // 100) - 1))
    return float(v[int(k)])
