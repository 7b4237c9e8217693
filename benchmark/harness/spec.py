"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration, whose file holds its sizes
and names its model family, ``families/<family>.py``, and a traffic mix,
``traffic/<mix>.json``, whose ``driver`` names the code that runs it,
``drivers/<driver>.py``. A per-layer metric is read by
``metrics/<metric>.py``; a cell's correctness limits are
``limits/<cell>.json``. Nothing here knows a cell, a family, a mix or a
metric by name: a new one is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")

__all__ = ["ROOT", "BENCH", "load_json", "load_spec", "Cell", "module",
           "reader"]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(path: str = "") -> dict:
    return load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def module(path: str, name: str = ""):
    """The Python file at ``path`` as a module (its name ``name``)."""
    name = name or "bench_" + os.path.splitext(
        os.path.basename(path))[0].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: str = BENCH):
    """The reader of per-layer metric ``metric``, ``metrics/<metric>.py``:
    its read(trace reading) gives a number, or None where the reading
    holds nothing to read. A metric that another one reads alike in cells
    that report another end-to-end metric re-exports its reader."""
    return module(os.path.join(bench, "metrics", metric + ".py"),
                  "bench_metric_" + metric.replace(".", "_")
                  .replace("-", "_"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        cfg = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.config_entry = cfg
        self.bench = os.path.join(root, "benchmark")
        self.config = load_json(os.path.join(root, cfg["file"]))
        from benchmark.harness.models import family

        self.family = family(self.config, self.bench)
        self.traffic = load_json(os.path.join(
            self.bench, "traffic", self.entry["traffic"] + ".json"))
        self.driver_path = os.path.join(self.bench, "drivers",
                                        self.traffic["driver"] + ".py")
        self.limits = load_json(os.path.join(self.bench, "limits",
                                             name + ".json"))
        self.end_to_end: List[dict] = [m for m in spec["end_to_end"]
                                       if _applies(m, name)]
        self.per_layer: List[dict] = [m for m in spec["per_layer"]
                                      if _applies(m, name)]
        self.chips = int(self.entry["chips"])

    def reader(self, metric: str):
        return reader(metric, self.bench)
