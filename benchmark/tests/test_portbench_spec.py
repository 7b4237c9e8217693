"""BENCHMARK.json against the contract's forms, and every file the
harness finds by name."""

import json
import os
import re
import shutil

import pytest

from conftest import ROOT

from benchmark.harness.spec import Cell, load_spec
from benchmark.roofline import count

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in SPEC["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            mover = e2e[m["moves"]]
            assert w in mover.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_found_by_name(cell):
    c = Cell(SPEC, cell)
    assert os.path.exists(c.driver_path)
    assert c.limits["limits"]
    for m in c.per_layer:
        assert hasattr(c.reader(m["name"]), "read")
    for m in c.end_to_end:
        assert m["name"] in ("setup_s", "images_per_s", "request_ms_p90")
    assert len(c.end_to_end) >= 2 and len(c.per_layer) >= 1
    assert {k for k in c.config_entry["reduced"]} <= set(
        c.config["reduced"])


STUB_FAMILY = """
import torch


def reference_models(cfg):
    with torch.device("meta"):
        return {"linear": torch.nn.Linear(cfg["width"], cfg["width"],
                                          bias=False)}


def count_run(name, model, cfg, P):
    model(torch.zeros(1, cfg["width"], device="meta"))
"""


def test_new_files_extend_without_edits(tmp_path):
    """A configuration (of a new model family too), a traffic mix, a
    metric and an operation's kernel patterns each come in as a new file
    and new entries: the harness finds them by name, and no file that is
    there changes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "benchmark").rglob("*")
               if q.is_file())}
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "adm64-guided.json"))
    cfg["num_channels"] = 256
    (b / "configs" / "adm64-wide.json").write_text(json.dumps(cfg))
    (b / "traffic" / "search-small.json").write_text(json.dumps(
        dict(json.load(open(b / "traffic" / "search-guided.json")),
             candidate_chunk=2)))
    (b / "metrics" / "unet.calls.py").write_text(
        "def read(r):\n    return r['unet']['calls']\n")
    (b / "limits" / "adm64-wide-search.json").write_text(json.dumps(
        json.load(open(b / "limits" / "adm64-guided-search.json"))))
    (b / "families" / "stub.py").write_text(STUB_FAMILY)
    (b / "configs" / "stub.json").write_text(json.dumps(
        {"name": "stub", "family": "stub", "width": 8, "reduced": {}}))
    (b / "limits" / "stub-search.json").write_text(json.dumps(
        json.load(open(b / "limits" / "adm64-guided-search.json"))))
    (b / "roofline" / "kernels" / "attention.other.json").write_text(
        json.dumps({"op": "attention", "impl": "another",
                    "patterns": ["other_attention_kernel"]}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="adm64-wide",
                                file="benchmark/configs/adm64-wide.json"))
    spec["configs"].append(dict(spec["configs"][0], name="stub",
                                file="benchmark/configs/stub.json",
                                reduced=[]))
    spec["workloads"].append({"name": "adm64-wide-search",
                              "config": "adm64-wide",
                              "traffic": "search-small", "chips": 1,
                              "why": "test"})
    spec["workloads"].append({"name": "stub-search", "config": "stub",
                              "traffic": "search-small", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "unet.calls", "unit": "calls",
                              "better": "lower", "source": "device_trace",
                              "layer": "models", "moves": "images_per_s",
                              "workloads": ["adm64-wide-search"]})
    cell = Cell(spec, "adm64-wide-search", root=str(tmp_path))
    assert cell.config["num_channels"] == 256
    assert cell.traffic["candidate_chunk"] == 2
    assert cell.driver_path.endswith("drivers/search.py")
    assert [m["name"] for m in cell.per_layer][-1] == "unet.calls"
    assert cell.reader("unet.calls").read({"unet": {"calls": 7}}) == 7
    assert cell.family.__name__ == "bench_family_adm"
    stub = Cell(spec, "stub-search", root=str(tmp_path))
    fam = stub.family
    models = fam.reference_models(stub.config)
    assert count.flops_per_image(models, stub.config, fam.count_run) == {
        "linear": 2 * 8 * 8}
    assert count.sites_per_image(models, stub.config, fam.count_run) == {
        "linear": []}
    pats = count.kernel_patterns("attention", str(b / "roofline"))
    assert "other_attention_kernel" in pats
    assert set(count.kernel_patterns("attention")) < set(pats)
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
