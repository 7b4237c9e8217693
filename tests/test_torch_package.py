"""Package-level checks of the PyTorch port: what it imports, and that its
entry points never fall back to the CPU on their own.

Also home of ``one_torch_thread``, the module-scoped fixture the port's
test files share: the test suite runs in several worker processes on one
machine, and torch's default of one intra-op thread per core in each of
them oversubscribes the cores (a sub-second test took a minute that way).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "autodiffusion_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "autodiffusion_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PACKAGE):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    """Top-level names of every absolute import in the file, wherever it
    sits (module level, inside functions, under ``if``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20, sources
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {name}"
           for p in sources for name, line in _imported_roots(p)
           if name in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_parallel_is_scanned_and_exports_the_jax_names():
    """parallel/ (the multi-process layer) is among the scanned sources,
    and exports the JAX package's twelve names."""
    from autodiffusion_tpu.parallel import __all__ as jax_names

    import autodiffusion_tpu_torch.parallel as port

    scanned = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    assert {"parallel/__init__.py", "parallel/dist.py",
            "parallel/mesh.py"} <= scanned
    assert sorted(port.__all__) == sorted(jax_names) and len(jax_names) == 12
    assert all(callable(getattr(port, n)) for n in jax_names)


def test_import_scan_catches_forbidden_imports(tmp_path):
    """The scan is not vacuous: it sees imports inside functions and
    tells autodiffusion_tpu from autodiffusion_tpu_torch."""
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "from autodiffusion_tpu_torch import ops\n"
                   "def f():\n"
                   "    from autodiffusion_tpu.ops import flash_attention\n"
                   "    import jax.numpy as jnp\n"
                   "    importlib.import_module('flax.linen')\n")
    names = [n for n, _ in _imported_roots(str(src)) if n in FORBIDDEN]
    assert names == ["autodiffusion_tpu", "jax", "flax"]


# ------------------------------------------------------ no silent CPU path

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_unet_cfg():
    from autodiffusion_tpu_torch.models import ModelConfig

    return ModelConfig.adm64(image_size=32, num_channels=32,
                             num_res_blocks=1, num_head_channels=16,
                             attention_resolutions="16")


def _entry_points():
    from autodiffusion_tpu_torch.cli.main import main
    from autodiffusion_tpu_torch.fid import FIDStats, load_fid_inception
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig,
                                                create_classifier,
                                                create_model,
                                                create_sd_models,
                                                create_sr_model)
    from autodiffusion_tpu_torch.parallel import setup_dist
    from autodiffusion_tpu_torch.search import (make_adm_fitness,
                                                make_sd_fitness)

    def fitness(device=None):
        model = create_model(_tiny_unet_cfg(), device="cpu")
        ref = FIDStats(np.zeros(4), np.eye(4))
        kw = {} if device is None else {"device": device}
        return make_adm_fitness(model=model, image_size=32,
                                feature_fn=lambda x: x, ref_stats=ref,
                                num_samples=2, batch_size=2,
                                candidate_chunk=1, feature_dim=4, **kw)

    def sd_fitness(device=None):
        kw = {} if device is None else {"device": device}
        return make_sd_fitness(
            unet=None, vae=None, context_bank=torch.zeros(2, 3, 4),
            uncond_context=torch.zeros(3, 4), feature_fn=lambda x: x,
            ref_stats=FIDStats(np.zeros(4), np.eye(4)), num_samples=2,
            batch_size=2, candidate_chunk=1, feature_dim=4, **kw)

    def cli(*argv):
        return lambda **kw: main(
            list(argv) + (["--device", kw["device"]] if kw else []))

    return {
        "cli.main sample": cli("sample", "--model_path", "m.pt"),
        "cli.main evaluate": cli("evaluate", "--sample_batch", "s.npz",
                                 "--ref_stats", "r.npz",
                                 "--inception_path", "i.pth"),
        "cli.main ref-stats": cli("ref-stats", "--images", "s.npz",
                                  "--inception_path", "i.pth"),
        "cli.main search-sd": lambda **kw: main(
            ["search-sd", "--ckpt", "sd.ckpt", "--clip_vocab", "v.json",
             "--clip_merges", "m.txt", "--captions", "c.json",
             "--inception_path", "i.pth", "--ref_stats", "r.npz"]
            + (["--device", kw["device"]] if kw else [])),
        "create_sd_models": lambda **kw: create_sd_models(**kw),
        "make_sd_fitness": sd_fitness,
        "cli.main search": lambda **kw: main(
            ["search", "--model_path", "m.pt", "--inception_path", "i.pth",
             "--ref_stats", "r.npz"]
            + (["--device", kw["device"]] if kw else [])),
        "create_model": lambda **kw: create_model(_tiny_unet_cfg(), **kw),
        "create_classifier": lambda **kw: create_classifier(
            ClassifierConfig.adm64(image_size=32, classifier_width=32,
                                   classifier_depth=1), **kw),
        "make_adm_fitness": fitness,
        "load_fid_inception": lambda **kw: load_fid_inception(
            "missing.pth", **kw),
        "cli.main train": cli("train", "--data_dir", "missing.npy",
                              "--class_cond", "False"),
        "cli.main train-classifier": cli("train-classifier", "--data_dir",
                                         "missing_dir"),
        "cli.main nll": cli("nll", "--model_path", "m.pt", "--data_dir",
                            "missing_dir"),
        "cli.main txt2img": cli("txt2img", "--ckpt", "sd.ckpt", "--prompt",
                                "a cat", "--clip_vocab", "v.json",
                                "--clip_merges", "m.txt"),
        "cli.main img2img": cli("img2img", "--ckpt", "sd.ckpt", "--prompt",
                                "a cat", "--init_img", "i.png"),
        "cli.main ldm-sample": cli("ldm-sample", "--ckpt", "ldm.ckpt"),
        "cli.main ldm-sample cin": cli("ldm-sample", "--ckpt", "ldm.ckpt",
                                       "--num_classes", "1000"),
        "cli.main inpaint": cli("inpaint", "--ckpt", "ldm.ckpt", "--image",
                                "i.png", "--mask", "i_mask.png"),
        "cli.main convert": cli("convert", "--torch_path", "sd.ckpt",
                                "--out", "sd_dir", "--preset", "sd"),
        "cli.main sr-sample": cli("sr-sample", "--base_samples", "b.npz"),
        "cli.main selftest": cli("selftest", "--inception_path", "i.pth"),
        "setup_dist": lambda **kw: setup_dist("localhost:1", 2, 0, **kw),
        "create_sr_model": lambda **kw: create_sr_model(
            ModelConfig(image_size=32, num_channels=32, num_res_blocks=1,
                        channel_mult="1,2"), large_size=32, small_size=8,
            **kw),
    }


@pytest.mark.parametrize("name", ["cli.main search", "create_model",
                                  "create_classifier", "make_adm_fitness",
                                  "load_fid_inception", "cli.main search-sd",
                                  "create_sd_models", "make_sd_fitness",
                                  "cli.main sample", "cli.main evaluate",
                                  "cli.main ref-stats", "cli.main train",
                                  "cli.main train-classifier",
                                  "cli.main nll", "cli.main txt2img",
                                  "cli.main img2img", "cli.main ldm-sample",
                                  "cli.main ldm-sample cin",
                                  "cli.main inpaint", "cli.main convert",
                                  "cli.main sr-sample", "cli.main selftest",
                                  "create_sr_model", "setup_dist"])
def test_entry_points_raise_without_cuda(no_cuda, name):
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(device="cuda")


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    eps = _entry_points()
    assert next(eps["create_model"](device="cpu").parameters()).device \
        == torch.device("cpu")
    assert eps["make_adm_fitness"](device="cpu").device == torch.device("cpu")
    assert eps["make_sd_fitness"](device="cpu").device == torch.device("cpu")
    # the CLI gets past the device check and fails on the missing files
    with pytest.raises(FileNotFoundError):
        eps["cli.main search"](device="cpu")
    with pytest.raises(FileNotFoundError):
        eps["cli.main search-sd"](device="cpu")
    for cmd in ("sample", "evaluate", "ref-stats", "train",
                "train-classifier", "nll", "txt2img", "img2img",
                "ldm-sample", "ldm-sample cin", "inpaint", "convert",
                "sr-sample", "selftest"):
        with pytest.raises(FileNotFoundError):
            eps[f"cli.main {cmd}"](device="cpu")


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_cuda():
    res = _run_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA is not available" in res.stderr


def test_chip_smoke_refuses_without_the_package(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    res = _run_smoke(str(tmp_path), {})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
