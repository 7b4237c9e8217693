"""What the benchmark loads: nothing of JAX or the JAX package, in the
process that runs a cell, and nothing of the program in the reference's.
Module names are compared by their top-level name, whole."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "optax", "autodiffusion_tpu"}
TESTS = os.path.dirname(os.path.abspath(__file__))


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = _loaded(
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_tiny\n"
        "import benchmark.run, benchmark.calibrate\n"
        "for c in ('adm64-guided-search', 'adm64-guided-sample'):\n"
        "    run_tiny(c, control=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % (ROOT, TESTS))
    assert "autodiffusion_tpu_torch" in top
    assert not top & BANNED, top & BANNED


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded(
        "import sys, json, torch; sys.path.insert(0, %r)\n"
        "from benchmark.reference import ddim, fid, inception, numerics, "
        "unet\n"
        "m = unet.UNet(image_size=32, num_channels=32, num_res_blocks=1,\n"
        "    attention_resolutions='16,8', num_head_channels=32,\n"
        "    use_new_attention_order=False, class_cond=False,\n"
        "    learn_sigma=True)\n"
        "P = numerics.Numerics()\n"
        "c = [ddim.step_coefficients([1, 500], 'linear')]\n"
        "ddim.guided_ddim(P, m, torch.randn(1, 3, 32, 32), c)\n"
        "inception.Inception()(P, torch.zeros(1, 32, 32, 3, "
        "dtype=torch.uint8))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % ROOT)
    assert not top & (BANNED | {"autodiffusion_tpu_torch"}), top


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "adm64-guided-search", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def _imports(path):
    import ast

    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    bench = os.path.join(ROOT, "benchmark")
    for d, _, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            names = set(_imports(path))
            assert not names & BANNED, (path, names & BANNED)
            if os.sep + "reference" + os.sep in path:
                assert "autodiffusion_tpu_torch" not in names, path
                assert names <= {"torch", "numpy", "math", "contextlib",
                                 "typing", "__future__"}, (path, names)
