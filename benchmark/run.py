"""Run one cell of the benchmark of ``autodiffusion_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. The cell's entry in ``BENCHMARK.json`` names its
configuration and its traffic mix; the mix names the driver that runs it
(``benchmark/drivers/<driver>.py``). Set-up (weights made on the card from
the seed, the program's models, one warm-up at the window's shapes) is
timed from process start; the window then runs for ``--seconds``, and
the output of the timed path is checked against the plain reference
(``benchmark/reference``). With ``--trace 1`` one stretch of the window
runs under torch.profiler and the cell's per-layer metrics are read from
it; else its end-to-end metrics are reported.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each with its limit.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX and the JAX package must stay out of this process: compared by the
# top-level name of every module loaded
BANNED = ("jax", "jaxlib", "flax", "optax", "autodiffusion_tpu")


def _environment() -> None:
    """Every cache of the run inside the checkout, at fixed paths."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, reading) -> dict:
    """The cell's per-layer metrics from a trace reading; a reader that
    finds nothing to read returns None and the metric is left out."""
    from benchmark.roofline import count

    fam, cfg = cell.family, cell.config
    models = {k: m for k, m in fam.reference_models(cfg).items()
              if reading["images"].get(k)}
    reading["flops_per_image"] = count.flops_per_image(models, cfg,
                                                       fam.count_run)
    reading["sites_per_image"] = count.sites_per_image(models, cfg,
                                                       fam.count_run)
    for name, sec in sorted(reading["kernel_s"].items(),
                            key=lambda kv: -kv[1])[:30]:
        print(f"kernel {sec:.6f} s {name[:160]}", file=sys.stderr)
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    import torch

    from benchmark.harness import checks
    from benchmark.harness.common import Context
    from benchmark.harness.spec import Cell, load_spec, module

    cell = Cell(load_spec(), args.workload)
    ctx = Context(cell, args.seed, args.seconds, args.trace, "cuda", T_START)
    ctx.mark("imports")
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s), and "
              f"this machine has fewer", file=sys.stderr)
        return 2
    torch.zeros(1, device=ctx.device)
    ctx.mark("cuda context")
    out = module(cell.driver_path).run(ctx)

    metrics = {}
    if args.trace:
        metrics = per_layer(cell, out["reading"])
    else:
        for m in cell.end_to_end:
            value = ctx.setup_s if m["name"] == "setup_s" \
                else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    verdict = checks.verdict(out["values"], cell.limits["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": (checks.passed(verdict) and out["failed"] == 0
                          and out["attempted"] > 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["reading"]["busy_s"]
        device["window_s"] = out["reading"]["window_s"]
        result["breakdown"] = out["reading"]["breakdown"]
    result["checks"] = verdict

    bad = banned_modules()
    if bad:
        print(f"loaded in this process, and must not be: {bad}",
              file=sys.stderr)
        return 3
    info = dict(out["extra"], setup_s=ctx.setup_s, seed=args.seed,
                setup_phases=ctx.phases, control=out["control"])
    print(json.dumps({"info": info}))
    for line in checks.lines(verdict):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
