"""The traced run: one callable under torch.profiler, read into the
numbers the per-layer metrics take.

The profiler drops the first kernels of a window in an old process (a
count of launches, not a stretch of time), so the traced work follows a
pre-roll of empty spin kernels that nothing reads. The port counts its
own kernel launches (``ops.LAUNCHES``); a trace that holds fewer of them
than were launched is taken again after a pre-roll four times as long,
and after the last try the traced run fails: a trace is never read short.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["RANGES", "profiled", "summarize", "matching"]

PRE_ROLL = 1000
# the benchmark's own ranges around the calls it makes into the program
RANGES = ("bench.unet", "bench.classifier", "bench.features")
# the port's kernels in a profile, by launch counter: each launch runs one
# of them (a GroupNorm forward either the resident kernel or the split
# path's apply pass, after its partial sums)
PROFILE_TAGS = {"flash_fwd": ("flash_fwd_tma_kernel",),
                "flash_fwd_packed": ("flash_fwd_packed_kernel",),
                "flash_fwd_wide": ("flash_fwd_wide_kernel",),
                "flash_bwd_dq": ("flash_bwd_dq_tma_kernel",),
                "flash_bwd_dkv": ("flash_bwd_dkv_tma_kernel",),
                "group_norm_fwd": ("group_norm_fwd_resident_kernel",
                                   "group_norm_fwd_apply_kernel"),
                "group_norm_bwd": ("group_norm_bwd_kernel",)}


def _device_events(events) -> list:
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in RANGES and "spin_kernel" not in e.name]


def _short(events, launches: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    counts = {k: sum(any(tag in e.name for tag in tags) for e in events)
              for k, tags in PROFILE_TAGS.items()}
    return {k: (counts[k], launches.get(k, 0)) for k in counts
            if counts[k] != launches.get(k, 0)}


def profiled(fn: Callable, tries: int = 3, log=print):
    """(profile, launches, window seconds, fn's result) of one run of
    ``fn`` under torch.profiler, the device synchronised at its end. Raises
    when every try's trace misses launches the counters saw."""
    from torch.profiler import ProfilerActivity, profile

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts

    pre_roll = PRE_ROLL
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(pre_roll):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            time.sleep(0.02)
        short = _short(_device_events(prof.events()), launches)
        if not short:
            return prof, launches, window, out
        log(f"trace dropped kernels (traced, launched) {short} after a "
            f"pre-roll of {pre_roll}: taken again")
        pre_roll *= 4
    raise RuntimeError(f"every trace missed kernel launches: {short}")


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def range_device_s(events) -> Dict[str, float]:
    """Device seconds of the kernels inside each benchmark range. The
    profiler records each range a second time on the device's timeline,
    from the first to the last kernel launched inside it; on one stream a
    kernel whose start lies in that span was launched inside the range."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name in RANGES
                   and e.device_type == torch.autograd.DeviceType.CUDA)
    starts = [a for a, _, _ in spans]
    out = {r: 0.0 for r in RANGES}
    for e in _device_events(events):
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out[spans[i][2]] += e.time_range.elapsed_us() / 1e6
    return out


def _host_activity(cpu: list, starts: list, ranges: list, t: float) -> str:
    """What the host was doing at time ``t`` (us): the benchmark range
    around it and the innermost operation running."""
    outer = next((e.name for e in ranges
                  if e.time_range.start <= t <= e.time_range.end), "")
    inner = ""
    i = bisect.bisect_right(starts, t)
    for e in reversed(cpu[max(0, i - 4000):i]):
        if (e.time_range.end >= t and e.name not in RANGES
                and not e.name.startswith("cuda")):
            inner = e.name
            break
    name = " > ".join(x for x in (outer, inner) if x)
    return name or "python"


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """Busy time, device time inside each benchmark range, kernel totals,
    and the longest idle gaps by what the host was doing, of a trace."""
    events = prof.events()
    dev = _device_events(events)
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    spans = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(b - a for a, b in spans)
    cpu = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and "spin_kernel" not in e.name),
                 key=lambda e: e.time_range.start)
    ranges = [e for e in cpu if e.name in RANGES]
    in_range = range_device_s(events)
    kernels: Dict[str, float] = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    starts = [e.time_range.start for e in cpu]
    gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _)
                   in zip(spans, spans[1:])), reverse=True)[:500]
    idle: Dict[str, float] = {}
    for length, a, b in gaps:
        name = _host_activity(cpu, starts, ranges, (a + b) / 2)
        idle[name] = idle.get(name, 0.0) + length / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "range_device_s": in_range,
        "kernel_s": {k: v / 1e6 for k, v in kernels.items()},
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]},
    }


def matching(kernel_s: Dict[str, float], patterns: Sequence[str]) -> float:
    """Seconds of the kernels whose names hold any of ``patterns``."""
    return sum(v for k, v in kernel_s.items()
               if any(p in k for p in patterns))
