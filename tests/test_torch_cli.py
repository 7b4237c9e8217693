"""The port's ``sample``, ``evaluate`` and ``ref-stats`` commands on the CPU:
their flags against the JAX CLI's, ``ref-stats`` and ``evaluate`` against
``adt``'s on the same files, and ``sample`` on a tiny config.

Tolerances (evaluate / ref-stats against adt's, images at the CLI's 299 px):
the statistics' mean 1e-4 of its largest |value| and covariance 1e-4 of its
largest |value| (Inception features 1e-4 of their scale apart,
tests/test_torch_fid.py); fid and inception_score 1e-4 relative; precision
and recall equal.
"""

import json

import numpy as np
import pytest
import torch

from autodiffusion_tpu.cli import main as jax_cli
from autodiffusion_tpu_torch.cli.main import build_parser, main
from autodiffusion_tpu_torch.fid import FIDStats, synthesize_pt_inception
from autodiffusion_tpu_torch.models import (ClassifierConfig, ModelConfig,
                                            create_classifier, create_model,
                                            random_init_)
from autodiffusion_tpu_torch.utils import logger
from test_torch_package import one_torch_thread  # noqa: F401

TINY = dict(image_size=32, num_channels=32, num_res_blocks=1,
            num_head_channels=16, attention_resolutions="16,8")


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


@pytest.mark.parametrize("cmd,fn", [("sample", "cmd_sample"),
                                    ("evaluate", "cmd_evaluate"),
                                    ("ref-stats", "cmd_ref_stats")])
def test_defaults_equal_the_jax_cli(monkeypatch, cmd, fn):
    seen = {}
    monkeypatch.setattr(jax_cli, fn, lambda args: seen.update(vars(args)) or 0)
    assert jax_cli.main([cmd]) == 0
    ours = vars(build_parser().parse_args([cmd]))
    for d in (seen, ours):
        d.pop("fn")
    assert ours.pop("device") == "cuda"
    assert ours == seen


def test_ref_stats_and_evaluate_match_adt(tmp_path, capsys):
    """``ref-stats`` then ``evaluate`` (with --ref_batch for precision and
    recall) through both CLIs on the same .npz files and the same
    pytorch_fid-layout .pth."""
    incep = str(tmp_path / "pt_inception.pth")
    torch.save(synthesize_pt_inception(7), incep)
    rng = np.random.RandomState(1)
    refs, samples = (str(tmp_path / f) for f in ("refs.npz", "samples.npz"))
    np.savez(refs, rng.randint(0, 256, (10, 64, 64, 3), dtype=np.uint8))
    np.savez(samples,
             arr_0=rng.randint(0, 256, (9, 64, 64, 3), dtype=np.uint8),
             arr_1=np.arange(9))
    metrics, stats = {}, {}
    for name, run in (("adt", jax_cli.main), ("port", main)):
        out = str(tmp_path / f"ref_{name}.npz")
        extra = ["--device", "cpu"] if name == "port" else []
        assert run(["ref-stats", "--images", refs, "--out", out,
                    "--inception_path", incep, "--batch_size", "4"]
                   + extra) == 0
        stats[name] = FIDStats.load(out)
        capsys.readouterr()
        assert run(["evaluate", "--sample_batch", samples, "--ref_stats",
                    out, "--ref_batch", refs, "--inception_path", incep,
                    "--batch_size", "4"] + extra) == 0
        metrics[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    got, want = stats["port"], stats["adt"]
    np.testing.assert_allclose(got.mu, want.mu, rtol=0,
                               atol=1e-4 * np.abs(want.mu).max())
    np.testing.assert_allclose(got.sigma, want.sigma, rtol=0,
                               atol=1e-4 * np.abs(want.sigma).max())
    got, want = metrics["port"], metrics["adt"]
    assert set(got) == set(want) == {"fid", "inception_score", "precision",
                                     "recall"}
    for key in ("fid", "inception_score"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert (got["precision"], got["recall"]) == (want["precision"],
                                                 want["recall"])


@pytest.fixture(scope="module")
def tiny_checkpoints(tmp_path_factory):
    """A tiny UNet (27 layers) and an ADM-64 classifier at 32 px, seeded."""
    d = tmp_path_factory.mktemp("ckpt")
    m = random_init_(create_model(ModelConfig.adm64(**TINY), device="cpu"),
                     0)
    torch.save(m.state_dict(), d / "model.pt")
    c = random_init_(create_classifier(ClassifierConfig.adm64(image_size=32),
                                       device="cpu"), 1)
    torch.save(c.state_dict(), d / "cls.pt")
    return d, m.layer_num


def _sample_argv(d, out, *extra):
    argv = ["sample", "--device", "cpu", "--model_path", str(d / "model.pt"),
            "--use_timestep", "[100, 500, 900]", "--num_samples", "5",
            "--batch_size", "2", "--seed", "3", "--out", str(out)]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    return argv + list(extra)


def _check_npz(path, n=5):
    with np.load(path) as z:
        assert z.files == ["arr_0", "arr_1"]
        arr, labels = z["arr_0"], z["arr_1"]
    assert arr.dtype == np.uint8 and arr.shape == (n, 32, 32, 3)
    assert labels.shape == (n,) and labels.min() >= 0 and labels.max() < 1000
    return arr, labels


def test_sample_ancestral_guided(tiny_checkpoints, tmp_path):
    """--use_ddim False with classifier guidance: 5 samples in batches of
    2 (the last one cut), labels and noise from one generator, so the same
    seed writes the same file."""
    d, _ = tiny_checkpoints
    argv = _sample_argv(d, tmp_path / "a.npz", "--use_ddim", "False",
                        "--classifier_path", str(d / "cls.pt"),
                        "--classifier_scale", "2.0")
    assert main(argv) == 0
    arr, labels = _check_npz(tmp_path / "a.npz")
    argv[argv.index(str(tmp_path / "a.npz"))] = str(tmp_path / "b.npz")
    assert main(argv) == 0
    arr2, labels2 = _check_npz(tmp_path / "b.npz")
    assert np.array_equal(arr, arr2) and np.array_equal(labels, labels2)
    with pytest.raises(ValueError, match="class_cond"):
        main(_sample_argv(d, tmp_path / "c.npz", "--class_cond", "False",
                          "--classifier_path", str(d / "cls.pt")))


def test_sample_ddim_with_skip_layers(tiny_checkpoints, tmp_path):
    """--skip_layers pairs one skip list with each sorted timestep; it
    changes the samples, and a list of the wrong length raises."""
    d, layer_num = tiny_checkpoints
    skips = [[0, 3], [], [layer_num - 1]]
    assert main(_sample_argv(d, tmp_path / "s.npz", "--skip_layers",
                             str(skips))) == 0
    arr, labels = _check_npz(tmp_path / "s.npz")
    assert main(_sample_argv(d, tmp_path / "p.npz")) == 0
    plain, plain_labels = _check_npz(tmp_path / "p.npz")
    assert np.array_equal(labels, plain_labels)
    assert not np.array_equal(arr, plain)
    with pytest.raises(ValueError, match="--skip_layers has 2 entries"):
        main(_sample_argv(d, tmp_path / "w.npz", "--skip_layers",
                          str(skips[:2])))
    with pytest.raises(ValueError, match="msgpack"):
        main(_sample_argv(d, tmp_path / "m.npz", "--model_path",
                          "model.msgpack"))
