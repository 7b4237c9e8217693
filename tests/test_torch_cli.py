"""The port's ``sample``, ``evaluate`` and ``ref-stats`` commands on the CPU:
their flags against the JAX CLI's, ``ref-stats`` and ``evaluate`` against
``adt``'s on the same files, and ``sample`` on a tiny config.

Tolerances (evaluate / ref-stats against adt's, images at the CLI's 299 px):
the statistics' mean 1e-4 of its largest |value| and covariance 1e-4 of its
largest |value| (Inception features 1e-4 of their scale apart,
tests/test_torch_fid.py); fid and inception_score 1e-4 relative; precision
and recall equal.
"""

import csv
import json
import os

import jax.numpy as jnp
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
                                    ("ref-stats", "cmd_ref_stats"),
                                    ("train", "cmd_train"),
                                    ("train-classifier",
                                     "cmd_train_classifier"),
                                    ("nll", "cmd_nll"),
                                    ("txt2img", "cmd_txt2img"),
                                    ("img2img", "cmd_img2img"),
                                    ("ldm-sample", "cmd_ldm_sample"),
                                    ("inpaint", "cmd_inpaint"),
                                    ("convert", "cmd_convert"),
                                    ("sr-sample", "cmd_sr_sample"),
                                    ("selftest", "cmd_selftest")])
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
    # a .msgpack model path is read as a flax tree: bytes that are none
    # raise the reader's named error
    bad = tmp_path / "model.msgpack"
    bad.write_bytes(b"\xc1")
    with pytest.raises(ValueError, match="msgpack"):
        main(_sample_argv(d, tmp_path / "m.npz", "--model_path", str(bad)))


# ------------------------------------------------------------------ training

def _train_argv(data, save_dir, *extra):
    argv = ["train", "--device", "cpu", "--data_dir", str(data),
            "--save_dir", str(save_dir), "--batch_size", "4",
            "--microbatch", "2", "--use_bf16", "False", "--dropout", "0.0",
            "--log_interval", "1"]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    return argv + list(extra)


@pytest.fixture(scope="module")
def npy_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    rng = np.random.RandomState(0)
    np.save(d / "imgs.npy", rng.randint(0, 256, (10, 32, 32, 3), np.uint8))
    np.save(d / "imgs_labels.npy", rng.randint(0, 1000, 10))
    return d / "imgs.npy"


def test_train_writes_checkpoints_and_resumes(npy_data, tmp_path):
    """Two steps write guided-diffusion's three .pt files; a resume from
    the directory loads them (the model equal to the saved one, AdamW's
    moments and count restored) and continues the step counter."""
    out = tmp_path / "run"
    assert main(_train_argv(npy_data, out, "--max_steps", "2")) == 0
    names = {"model000002.pt", "ema_0.9999_000002.pt", "opt000002.pt"}
    assert names <= set(os.listdir(out))
    saved = torch.load(out / "model000002.pt", weights_only=True)
    opt = torch.load(out / "opt000002.pt", weights_only=True)
    assert int(next(iter(opt["state"].values()))["step"]) == 2
    ema = torch.load(out / "ema_0.9999_000002.pt", weights_only=True)
    assert set(ema) == set(saved)

    from autodiffusion_tpu_torch.train import (create_train_state,
                                               resume_train_state)
    model = create_model(ModelConfig.adm64(**TINY, use_bf16=False),
                         device="cpu")
    state = create_train_state(model)
    resume_train_state(state, str(out))
    assert state.step == 2 and state.updates() == 2
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)

    assert main(_train_argv(npy_data, out, "--max_steps", "3",
                            "--resume_checkpoint", str(out))) == 0
    assert {"model000003.pt", "opt000003.pt"} <= set(os.listdir(out))
    opt = torch.load(out / "opt000003.pt", weights_only=True)
    assert int(next(iter(opt["state"].values()))["step"]) == 3
    assert "resuming model from" in (out / "log.txt").read_text()
    with open(out / "progress.csv") as f:
        assert [int(float(r["step"])) for r in csv.DictReader(f)] == [1, 2, 3]


def test_train_ofa_random_select_sandwich(npy_data, tmp_path):
    """--ofa_mode random_select: one update from four schedules' averaged
    gradients, logged per schedule length."""
    out = tmp_path / "ofa"
    assert main(_train_argv(npy_data, out, "--max_steps", "1",
                            "--ofa_mode", "random_select")) == 0
    log = (out / "log.txt").read_text()
    assert "loss_len1000" in log and "loss_len4 " in log
    assert (out / "model000001.pt").exists()


def test_train_refuses_what_is_not_ported(npy_data, tmp_path):
    with pytest.raises(ValueError, match="ofa_mode"):
        main(_train_argv(npy_data, tmp_path, "--ofa_mode", "every_step"))


def test_train_sr_small_size_from_npy(npy_data, tmp_path, monkeypatch):
    """--sr_small_size on the .npy bulk loader (no --lq_dir): low_res is
    each batch's area downsampling, 32 -> 16, and the SR model trains."""
    from autodiffusion_tpu_torch.models import SuperResModel

    seen = []
    real = SuperResModel.forward

    def record(self, x, t, low_res, y=None, **kw):
        seen.append((tuple(x.shape), tuple(low_res.shape)))
        return real(self, x, t, low_res, y, **kw)

    monkeypatch.setattr(SuperResModel, "forward", record)
    out = tmp_path / "sr"
    assert main(_train_argv(npy_data, out, "--sr_small_size", "16",
                            "--max_steps", "1")) == 0
    assert seen == [((2, 3, 32, 32), (2, 3, 16, 16))] * 2
    sd = torch.load(out / "model000001.pt", weights_only=True)
    assert sd["input_blocks.0.0.weight"].shape[1] == 6


def test_adt_train_checkpoint_samples_in_the_port(tmp_path):
    """A model tree in the files ``adt train`` writes (save_tree of the JAX
    model's params as model{step}.msgpack) samples in ``adt-torch sample``
    exactly as the same weights from a .pt do."""
    from autodiffusion_tpu.models import ModelConfig as JaxConfig
    from autodiffusion_tpu.models import create_model as jax_create_model
    from autodiffusion_tpu.utils.checkpoint import save_tree
    from autodiffusion_tpu_torch.models.convert import \
        unet_state_dict_from_flax
    from test_torch_models import _random_params

    jm = jax_create_model(JaxConfig.adm64(**TINY))
    params = _random_params(jm, 2, jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    save_tree(str(tmp_path / "model000001.msgpack"), params)
    torch.save(unet_state_dict_from_flax(params), tmp_path / "model.pt")
    arrs = []
    for name in ("model000001.msgpack", "model.pt"):
        out = tmp_path / f"{name}.npz"
        assert main(_sample_argv(tmp_path, out, "--model_path",
                                 str(tmp_path / name))) == 0
        arrs.append(_check_npz(out)[0])
    assert np.array_equal(arrs[0], arrs[1])


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(3)
    for i in range(6):
        Image.fromarray(rng.randint(0, 256, (36, 36, 3), dtype=np.uint8)) \
            .save(d / f"n{i % 3:03d}_{i}.png")
    return d


def test_train_classifier_command(png_dir, tmp_path):
    out = tmp_path / "cls"
    argv = ["train-classifier", "--device", "cpu", "--data_dir", str(png_dir),
            "--save_dir", str(out), "--iterations", "2", "--batch_size", "2",
            "--image_size", "32", "--classifier_width", "64",
            "--classifier_depth", "1", "--classifier_use_bf16", "False",
            "--num_classes", "3", "--log_interval", "1"]
    assert main(argv) == 0
    assert {"model000002.pt", "opt000002.pt"} <= set(os.listdir(out))
    rows = [json.loads(r) for r in open(out / "progress.json")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and 0 <= r["acc@5"] <= 1 for r in rows)
    sd = torch.load(out / "model000002.pt", weights_only=True)
    c = create_classifier(ClassifierConfig(
        image_size=32, classifier_width=64, classifier_depth=1),
        num_classes=3, device="cpu")
    c.load_state_dict(sd, strict=True)


def test_nll_command(png_dir, tmp_path, monkeypatch, capsys):
    """bits/dim of a trained checkpoint over an image folder, the 1000-step
    schedule swapped for a 10-step respacing to keep the CPU run short."""
    from autodiffusion_tpu_torch import models

    cfg = ModelConfig.adm64(image_size=32, num_channels=64,
                            num_res_blocks=1, use_bf16=False)
    m = random_init_(create_model(cfg, device="cpu"), 4)
    torch.save(m.state_dict(), tmp_path / "ema.pt")
    real = models.create_tables
    monkeypatch.setattr(models, "create_tables",
                        lambda c, ts=None: real(c, "ddim10"))
    assert main(["nll", "--device", "cpu", "--model_path",
                 str(tmp_path / "ema.pt"), "--data_dir", str(png_dir),
                 "--image_size", "32", "--num_channels", "64",
                 "--num_res_blocks", "1", "--num_samples", "4",
                 "--batch_size", "2"]) == 0
    bpd = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["bpd"]
    assert np.isfinite(bpd) and bpd > 0
