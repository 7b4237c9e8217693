#!/usr/bin/env python3
"""How often torch.profiler's short windows drop the port's kernels, on
one NVIDIA GPU.

    python3 tools/profiler_window_probe.py fresh
    python3 tools/profiler_window_probe.py long [SECONDS]
    python3 tools/profiler_window_probe.py head [SECONDS]

Each profile records ten launches of the bf16 dQ kernel (24 x 1024 x 64,
ADM-64's T = 1024 site with six heads at batch 4) between idle host time
of ``margin`` seconds on either side, and counts the kernels it holds
against the ten launched.

``fresh``: in a new process, three profiles each at margins of 0.02, 0.2
and 1.0 s, with and without a warm-up iteration inside the profile
(schedule warmup=1), with and without a PyTorch kernel on either side of
the launches; then two windows of 400 launches.

``long``: for SECONDS (330 unless given), every ~16 s a profile with
0.5 s margins and then one with 0.02 s margins, each with the first
kernels' start minus their launch's time on the profile's timeline (a
drift of the device's clock against the host's would show there).

``head``: for SECONDS (240 unless given), every ~10 s a pair of profiles
at 0.02 s margins, one plain and one whose window opens with a head
start (a 50 ms spin kernel launched before the ten, which then queue
behind it), in turns first and second: whether a head start keeps the
window's first kernels.

Each prints one JSON line a profile and writes them to
``chiprun_out/profiler_probe_<mode>.json``.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(mode: str, seconds: float = 0) -> int:
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from autodiffusion_tpu_torch.ops.flash_attention import (flash_bwd_dq,
                                                             flash_fwd)

    cuda = torch.autograd.DeviceType.CUDA
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(24, 1024, 64, device="cuda", generator=gen)
                   .bfloat16() for _ in range(4))
    o, lse = flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    mark = torch.zeros(1 << 20, device="cuda")

    def many(n=10, marker=False):
        if marker:
            mark.add_(1)
        for _ in range(n):
            flash_bwd_dq(q, k, v, do, lse, delta)
        if marker:
            mark.mul_(1.0001)

    def one(margin, warm=False, marker=False, n=10, head=0):
        sched = schedule(wait=0, warmup=1, active=1, repeat=1) \
            if warm else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            if warm:
                many(n, marker)
                torch.cuda.synchronize()
                prof.step()
            reset_launch_counts()
            time.sleep(margin)
            if head:
                torch.cuda._sleep(head)
            with record_function("window_run"):
                many(n, marker)
            torch.cuda.synchronize()
            time.sleep(margin)
            if warm:
                prof.step()
        evs = prof.events()
        port = sorted(e.time_range.start for e in evs
                      if e.device_type == cuda and "flash_bwd_dq" in e.name)
        launch = sorted(e.time_range.start for e in evs
                        if e.name == "cudaLaunchKernel")
        return {"margin": margin, "warm": warm, "marker": marker, "n": n,
                "head": head, "head_seen": sum(
                    e.device_type == cuda and "spin_kernel" in e.name
                    for e in evs),
                "launched": LAUNCHES["flash_bwd_dq"], "seen": len(port),
                "kernel_minus_launch_us": [round(a - b, 1) for a, b
                                           in zip(port, launch)][:3]}

    many()
    torch.cuda.synchronize()
    seconds = seconds or (240 if mode == "head" else 330)
    out = []

    def keep(rec):
        print(json.dumps(rec), flush=True)
        out.append(rec)

    if mode == "fresh":
        for margin in (0.02, 0.2, 1.0):
            for warm in (True, False):
                for marker in (False, True):
                    for _ in range(3):
                        keep(one(margin, warm, marker))
        for _ in range(2):
            keep(one(0.02, True, True, n=400))
    elif mode == "head":
        t0, turn = time.time(), 0
        while time.time() - t0 < seconds:
            heads = (0, 100_000_000) if turn % 2 == 0 else (100_000_000, 0)
            rec = {"t": round(time.time() - t0, 1)}
            for h in heads:
                rec["head" if h else "plain"] = one(0.02, head=h)
            keep(rec)
            turn += 1
            time.sleep(10)
    else:
        t0 = time.time()
        while time.time() - t0 < seconds:
            keep({"t": round(time.time() - t0, 1), "wide": one(0.5),
                  "short": one(0.02)})
            time.sleep(15)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"profiler_probe_{mode}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[1] not in ("fresh", "long",
                                                          "head"):
        print("usage: profiler_window_probe.py fresh | long | head "
              "[SECONDS]",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], *map(float, sys.argv[2:])))
