#!/usr/bin/env python3
"""One cell of the port's benchmark with the port's spans turned on, on
one NVIDIA GPU.

    python3 tools/span_trace.py --workload <cell> --seed <n> \\
        [--seconds 51] [--trace 0|1] [--spans 0|1]

Runs ``benchmark/run.py``'s cell in this process with the spans of
``autodiffusion_tpu_torch.utils.trace`` on (``--spans 1``) or off.

``--trace 0``: the cell's end-to-end run; spans on throughout and no
profiler, so the result line against a ``--spans 0`` run of the same seed
is the spans' on-cost.

``--trace 1 --spans 1``: the cell's traced run with spans on inside the
profiled call only, and the spans' device-side ranges left out of the
device's busy time as the benchmark leaves out its own ``bench.*`` ranges.
After the result line, one JSON line ``{"spans": ...}`` (also written to
``chiprun_out/span_trace_<cell>_<seed>.json``): the device seconds under
each ``adt.*`` name, a kernel counting under a span where the host call
that launched it lies inside the span's host interval, on whatever thread
(the profiler's device-side copy of a range holds only the kernels
launched directly inside it, so a range around another would read almost
nothing); and from them

- ``guidance_ms_per_image_step``: under ``adt.sampler.guidance`` per
  image-step (rows x steps of every ``adt.sampler.loop``);
- ``update_ms_per_image_step``: under ``adt.sampler.step`` less its
  ``model`` and ``guidance`` children, per image-step;
- ``frechet_ms_per_call``: host ms of ``adt.fitness.frechet`` a chunk;
- ``step_idle_ms``: device-idle ms a step between the first and the last
  kernel it launched;

with the benchmark's own ranges for the cross-checks and the idle gaps
named by the innermost span the host was in. The benchmark itself reads
none of this; these are the readings its harness would take once it
turns the spans on in its traced call.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from typing import Dict, List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import trace as bench_trace  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
PREFIX = "adt."
STEP, MODEL, GUIDANCE = ("adt.sampler.step", "adt.sampler.model",
                         "adt.sampler.guidance")


def kernels(events) -> list:
    """The device's work in a trace: the benchmark's choice of events,
    less the device-side copies of the port's spans."""
    return [e for e in bench_trace._device_events(events)
            if not e.name.startswith(PREFIX)]


def _runtime_call(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def launched(events) -> List[tuple]:
    """(host time of its launch, kernel) for every kernel whose runtime
    call (the CPU event of the same correlation id) the trace holds."""
    at = {e.id: e.time_range.start for e in events
          if e.device_type != CUDA and _runtime_call(e.name)}
    return [(at[e.id], e) for e in kernels(events) if e.id in at]


def _host_spans(events) -> Dict[str, List[Tuple[float, float]]]:
    out: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.device_type != CUDA and e.name.startswith(PREFIX):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _finder(spans: List[Tuple[float, float]]):
    """index(t): the interval of ``spans`` (sorted; one name's never
    overlap) that holds host time t, taken as [start, end), or -1."""
    starts = [a for a, _ in spans]

    def index(t: float) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < spans[i][1] else -1

    return index


def span_device_s(events) -> Dict[str, float]:
    """Device seconds of the kernels launched inside each ``adt.*`` name's
    spans. Per name, so nested spans each get their own total."""
    done = launched(events)
    out = {}
    for name, spans in _host_spans(events).items():
        index = _finder(spans)
        out[name] = sum(k.time_range.elapsed_us() for t, k in done
                        if index(t) >= 0) / 1e6
    return out


def step_idle_s(events) -> Tuple[float, int]:
    """(device-idle seconds inside the steps, the number of steps): each
    ``adt.sampler.step`` from the start of the first kernel it launched to
    the end of the last, less the union of the kernels in that stretch."""
    steps = _host_spans(events).get(STEP, [])
    index = _finder(steps)
    ends: Dict[int, Tuple[float, float]] = {}
    for t, k in launched(events):
        i = index(t)
        if i >= 0:
            lo, hi = ends.get(i, (k.time_range.start, k.time_range.end))
            ends[i] = (min(lo, k.time_range.start),
                       max(hi, k.time_range.end))
    work = bench_trace._union([(e.time_range.start, e.time_range.end)
                               for e in kernels(events)])
    idle = 0.0
    for a, b in ends.values():
        covered = sum(min(b, w1) - max(a, w0) for w0, w1 in work
                      if w1 > a and w0 < b)
        idle += (b - a) - covered
    return idle / 1e6, len(steps)


def readings(device_s: Dict[str, float], records: Sequence,
             idle: Tuple[float, int]) -> Dict[str, float]:
    """The four span readings from device seconds by name
    (:func:`span_device_s`), the span records (``utils.trace.Span``) and
    :func:`step_idle_s`; a reading whose spans are missing is left out."""
    image_steps = sum(r.attrs["rows"] * r.attrs["steps"] for r in records
                      if r.name == "adt.sampler.loop")
    chunks = sum(r.name == "adt.fitness.chunk" for r in records)
    frechet = [r.end_ns - r.start_ns for r in records
               if r.name == "adt.fitness.frechet"]
    out = {}
    if image_steps and GUIDANCE in device_s:
        out["guidance_ms_per_image_step"] = \
            device_s[GUIDANCE] * 1e3 / image_steps
    if image_steps and STEP in device_s:
        self_s = (device_s[STEP] - device_s.get(MODEL, 0.0)
                  - device_s.get(GUIDANCE, 0.0))
        out["update_ms_per_image_step"] = self_s * 1e3 / image_steps
    if chunks and frechet:
        out["frechet_ms_per_call"] = sum(frechet) / 1e6 / chunks
    if idle[1]:
        out["step_idle_ms"] = idle[0] * 1e3 / idle[1]
    return out


def idle_gaps_by_span(events, top: int = 10) -> List[list]:
    """The device's idle gaps, longest 500, summed by what the host was
    in at each gap's middle: the innermost ``adt.*`` span and the
    innermost operation (the benchmark's labelling, with the port's spans
    for its ranges)."""
    work = bench_trace._union([(e.time_range.start, e.time_range.end)
                               for e in kernels(events)])
    cpu = sorted((e for e in events if e.device_type != CUDA
                  and "spin_kernel" not in e.name),
                 key=lambda e: e.time_range.start)
    spans = sorted((e for e in cpu if e.name.startswith(PREFIX)),
                   key=lambda e: -e.time_range.start)
    ops = [e for e in cpu if not e.name.startswith(PREFIX)]
    starts = [e.time_range.start for e in ops]
    gaps = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _)
                   in zip(work, work[1:])), reverse=True)[:500]
    out: Dict[str, float] = {}
    for length, a, b in gaps:
        name = bench_trace._host_activity(ops, starts, spans, (a + b) / 2)
        out[name] = out.get(name, 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:top]]


def report(prof, records) -> dict:
    events = prof.events()
    dev = span_device_s(events)
    work = bench_trace._union([(e.time_range.start, e.time_range.end)
                               for e in kernels(events)])
    busy = sum(b - a for a, b in work) / 1e6
    # kernels with no runtime call in the trace count under no span
    unmatched = (sum(k.time_range.elapsed_us() for k in kernels(events))
                 - sum(k.time_range.elapsed_us()
                       for _, k in launched(events))) / 1e6
    bench = bench_trace.range_device_s(events)
    count: Dict[str, int] = {}
    for r in records:
        count[r.name] = count.get(r.name, 0) + 1
    return {"device_s": dev, "busy_s": busy, "unmatched_s": unmatched,
            "bench_s": bench,
            "readings": readings(dev, records, step_idle_s(events)),
            "idle_gaps": idle_gaps_by_span(events), "count": count,
            "outside_unet_share": 100 * (1 - (bench["bench.unet"]
                                              + bench["bench.features"])
                                         / busy)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import benchmark.run as bench_run

    from autodiffusion_tpu_torch.utils import trace

    held = []
    if args.trace and args.spans:
        profiled, device_events = bench_trace.profiled, \
            bench_trace._device_events

        def with_spans(fn, tries=3, log=print):
            def once():
                trace.take()        # a retake's records replace the last
                return fn()

            trace.enable(True)
            try:
                prof, launches, window, out = profiled(once, tries, log)
            finally:
                trace.enable(False)
            held.append((prof, trace.take()))
            return prof, launches, window, out

        bench_trace.profiled = with_spans
        bench_trace._device_events = lambda events: [
            e for e in device_events(events)
            if not e.name.startswith(PREFIX)]
    else:
        trace.enable(bool(args.spans))
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", str(args.trace)])
    if held:
        line = dict(report(*held[-1]), workload=args.workload,
                    seed=args.seed, device=torch.cuda.get_device_name(0))
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", f"span_trace_"
                               f"{args.workload}_{args.seed}.json"),
                  "w") as f:
            json.dump(line, f)
        print(json.dumps({"spans": line}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
