"""Readings that the correctness limits are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 1]

For each seed, in one process (the kernels build once): the cell's
driver runs a short window on the program, as ``run.py`` does, and the
check compares its output with the plain reference; then the control, the
reference in the program's place one precision below what the
configuration states (fp8 products for the bf16 diffusion models, a bf16
Inception for the float32 one, float32 moments for the float64 ones), is
compared with the reference in the same way. Prints one JSON line a seed
and, at the end, each number's largest sound reading and smallest control
reading.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.run import _environment  # noqa: E402


def readings(workload: str, seeds, seconds: float, device: str = "cuda",
             cell=None, log=print):
    """[{seed, program: {number: reading}, control: {...}}] for ``seeds``."""
    from benchmark.harness.common import Context
    from benchmark.harness.spec import Cell, load_spec, module

    cell = cell or Cell(load_spec(), workload)
    driver = module(cell.driver_path)
    out = []
    for seed in seeds:
        t0 = time.time()
        ctx = Context(cell, seed, seconds, False, device, t0, control=True)
        res = driver.run(ctx)
        row = {"seed": seed, "program": res["values"],
               "control": res["control"], "seconds": time.time() - t0,
               "setup_s": ctx.setup_s}
        log(json.dumps(row))
        out.append(row)
    return out


def summary(rows) -> dict:
    keys = rows[0]["program"].keys()
    return {k: {"lower": max(r["program"][k] for r in rows),
                "upper": min(r["control"][k] for r in rows)} for k in keys}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    _environment()
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
