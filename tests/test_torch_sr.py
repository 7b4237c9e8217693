"""Super-resolution in the PyTorch port against the JAX package, on the CPU:
SuperResModel and create_sr_model, one SR train step with low_res, the
``sr-sample`` and ``train --sr_small_size`` commands; and the routing of
attention sites (ops/flash_attention.attention_route), with a D = 192
AttentionBlock (``sr-sample``'s head dim, which has no kernel) against
JAX.

Tiny models, float32, numpy-seeded inputs, weights carried over with the
converters. Tolerances: the models' forward TOL = 2e-4
(tests/test_torch_models.py); the bilinear upsampling 1e-6 (the same
interpolation weights in float32); the train step's as
tests/test_torch_train.py's; the sampling loop 2e-4 of the images' scale
with the draws injected.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from autodiffusion_tpu.cli import main as jax_cli
from autodiffusion_tpu.models import ModelConfig as JaxConfig
from autodiffusion_tpu.models import SuperResModel as JaxSR
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.models import create_sr_model as jax_create_sr
from autodiffusion_tpu.models.convert import convert_unet
from autodiffusion_tpu.models.unet import AttentionBlock as JaxAttention
from autodiffusion_tpu.samplers import ddim_sample_loop as jax_ddim
from autodiffusion_tpu.schedules import build_base_tables as jax_base_tables
from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu.train.state import create_train_state as jax_state
from autodiffusion_tpu.train.state import make_train_step as jax_train_step
from autodiffusion_tpu_torch.cli.main import _derive_low_res, main
from autodiffusion_tpu_torch.models import (ModelConfig, SuperResModel,
                                            create_sr_model)
from autodiffusion_tpu_torch.models.convert import (_attnblock,
                                                    unet_state_dict_from_flax)
from autodiffusion_tpu_torch.models.unet import AttentionBlock
from autodiffusion_tpu_torch.ops.flash_attention import (
    FLASH_GATE_SDPA, attention_route, flash_gate_on)
from autodiffusion_tpu_torch.samplers import ddim_sample_loop
from autodiffusion_tpu_torch.schedules import build_base_tables, build_tables
from autodiffusion_tpu_torch.train import create_train_state, make_train_step
from autodiffusion_tpu_torch.utils import logger
from test_torch_models import _random_params
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_train import _assert_params_close

TOL = 2e-4
NUM_CLASSES = 10
SR = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
          channel_mult=(1, 2), num_head_channels=16,
          use_scale_shift_norm=True, resblock_updown=True)


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("small,large", [(8, 16), (16, 64)])
def test_bilinear_upsampling_matches_jax_resize(small, large):
    """SuperResModel's upsampling (torch bilinear, align_corners False)
    against jax.image.resize's "bilinear", border rows and columns
    included: both take half-pixel centres, and at the border JAX's
    renormalised triangle weights equal torch's clamped source index."""
    low = np.random.RandomState(small).randn(2, 3, small, small) \
        .astype(np.float32)
    want = _nchw(jax.image.resize(_nhwc(low), (2, large, large, 3),
                                  "bilinear"))
    got = F.interpolate(torch.from_numpy(low), (large, large),
                        mode="bilinear", align_corners=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], atol=1e-6)
    np.testing.assert_allclose(got[..., -1], want[..., -1], atol=1e-6)


def _sr_pair(seed=0, num_classes=NUM_CLASSES, **over):
    cfg = dict(SR, **over)
    jm = JaxSR(unet=JaxUNet(out_channels=6, num_classes=num_classes,
                            use_new_attention_order=True, **cfg))
    return jm, cfg


def _sr_inputs(seed, large, small, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, large, large).astype(np.float32)
    low = rng.uniform(-1, 1, (b, 3, small, small)).astype(np.float32)
    return x, low, np.array([17.0, 901.0][:b], np.float32), \
        np.array([3, 7][:b])


@pytest.mark.parametrize("small,large", [(8, 16), (16, 64)])
def test_superres_model_matches_jax(small, large):
    """SuperResModel (a UNetModel of 6 inputs that concatenates the
    upsampled low_res) against the JAX SuperResModel, weights through the
    plain UNet converter onto its nested 'unet' module, as adt sr-sample
    builds them (JAX cli/main.py:385-390)."""
    jm, cfg = _sr_pair()
    x, low, t, y = _sr_inputs(small + large, large, small)
    params = _random_params(jm, 1, jnp.zeros((1, large, large, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, small, small, 3)),
                            jnp.zeros((1,), jnp.int32))
    pm = SuperResModel(in_channels=3, out_channels=6, num_classes=NUM_CLASSES,
                       use_new_attention_order=True, **cfg).eval()
    pm.load_state_dict(unet_state_dict_from_flax(params["params"]["unet"]),
                       strict=True)
    # the port's state dict is the plain UNet's: the JAX tree comes back
    back = convert_unet({k: v.numpy() for k, v in pm.state_dict().items()},
                        jm.unet)
    assert jax.tree_util.tree_structure(back["params"]) == \
        jax.tree_util.tree_structure(params["params"]["unet"])
    want = _nchw(jax.jit(jm.apply)(params, _nhwc(x), jnp.asarray(t),
                                   _nhwc(low), jnp.asarray(y)))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (x, t, low, y))).numpy()
    assert got.shape == (2, 6, large, large)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the conditioning reaches the output
    with torch.no_grad():
        other = pm(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(-low), torch.from_numpy(y)).numpy()
    assert np.abs(other - got).max() > 1e-3


def test_create_sr_model_matches_jax():
    """create_sr_model against the JAX factory at a tiny config (32 x 32
    from 8 x 8, the JAX sr-sample flags' kind: num_heads 4, head channels
    -1): the same module tree (the converted params' structure), 6 input
    channels, and the same output."""
    cfg = dict(image_size=32, num_channels=32, num_res_blocks=1,
               attention_resolutions="16,8", class_cond=True,
               learn_sigma=True, channel_mult="1,2")
    jm = jax_create_sr(JaxConfig(**cfg), large_size=32, small_size=8)
    pm = create_sr_model(ModelConfig(**cfg), large_size=32, small_size=8,
                         device="cpu")
    assert pm.input_blocks[0][0].weight.shape[1] == 6
    x, low, t, y = _sr_inputs(3, 32, 8)
    params = _random_params(jm, 2, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
                            jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1,), jnp.int32))
    pm.load_state_dict(unet_state_dict_from_flax(params["params"]["unet"]),
                       strict=True)
    want = _nchw(jax.jit(jm.apply)(params, _nhwc(x), jnp.asarray(t),
                                   _nhwc(low), jnp.asarray(y)))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (x, t, low, y))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ------------------------------------------------------- the train step

def test_sr_train_step_matches_jax():
    """One make_train_step update of a SuperResModel on a batch with
    "low_res" (microbatches 2, weight decay, an EMA) against the JAX
    step's, which threads low_res into the model call (JAX
    train/state.py:81-141): metrics, parameters and EMA after it, to
    tests/test_torch_train.py's tolerances."""
    jm, cfg = _sr_pair()
    large, small = 16, 8
    params = _random_params(jm, 5, jnp.zeros((1, large, large, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, small, small, 3)),
                            jnp.zeros((1,), jnp.int32))
    pm = SuperResModel(in_channels=3, out_channels=6, num_classes=NUM_CLASSES,
                       use_new_attention_order=True, **cfg)
    pm.load_state_dict(unet_state_dict_from_flax(params["params"]["unet"]),
                       strict=True)
    pm.train()
    rng = np.random.RandomState(11)
    x = (rng.randint(0, 256, (4, 3, large, large)) / 127.5 - 1).astype(
        np.float32)
    low = x.reshape(4, 3, small, 2, small, 2).mean(axis=(3, 5))
    y, t = rng.randint(0, NUM_CLASSES, 4), rng.randint(0, 1000, 4)
    w = (0.5 + rng.rand(4)).astype(np.float32)
    key = jax.random.key(7)
    noise = np.concatenate([_nchw(jax.random.normal(r, (2, large, large, 3)))
                            for r in jax.random.split(key, 2)])
    lr = 1e-3
    jstate = jax_state(params, lr=lr, weight_decay=0.05, ema_rates=(0.9,))
    jstate, want = jax.jit(jax_train_step(jm.apply, microbatches=2,
                                          class_cond=True))(
        jstate, jax_base_tables("cosine", 1000),
        {"x": _nhwc(x), "y": jnp.asarray(y), "low_res": _nhwc(low)},
        jnp.asarray(t), jnp.asarray(w), key)
    pstate = create_train_state(pm, lr=lr, weight_decay=0.05,
                                ema_rates=(0.9,))
    _, got = make_train_step(pm, microbatches=2, class_cond=True)(
        pstate, build_base_tables("cosine", 1000),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
         "low_res": torch.from_numpy(np.ascontiguousarray(low))},
        torch.from_numpy(t), torch.from_numpy(w),
        noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(v),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    ema = {n: e.numpy() for n, e in pstate.ema_state_dict(0).items()}
    for mine, theirs in ((sd, jstate.params), (ema, jstate.ema_params[0])):
        _assert_params_close(convert_unet(mine, jm.unet)["params"],
                             theirs["params"]["unet"], 2e-3 * lr, lr)


def test_derived_low_res_matches_jax():
    """The port's _derive_low_res (area downsampling, a block mean) equals
    the JAX CLI's on the same batch."""
    from autodiffusion_tpu.cli.main import _derive_low_res as jax_derive

    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    got = next(_derive_low_res(iter([{"x": x}]), 4))["low_res"]
    want = next(jax_derive(iter([{"x": x}]), 4))["low_res"]
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 4, 4, 3)


# ------------------------------------------------------------- sampling

def test_sr_ddim_loop_matches_jax_with_injected_noise():
    """Four DDIM steps of a SuperResModel conditioned on low_res and
    labels, both packages from the same x_T: the loop's images within
    2e-4 of their scale."""
    jm, cfg = _sr_pair(seed=3)
    large, small = 16, 8
    params = _random_params(jm, 6, jnp.zeros((1, large, large, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, small, small, 3)),
                            jnp.zeros((1,), jnp.int32))
    pm = SuperResModel(in_channels=3, out_channels=6, num_classes=NUM_CLASSES,
                       use_new_attention_order=True, **cfg).eval()
    pm.load_state_dict(unet_state_dict_from_flax(params["params"]["unet"]),
                       strict=True)
    rng = np.random.RandomState(4)
    low = rng.uniform(-1, 1, (2, 3, small, small)).astype(np.float32)
    y = np.array([1, 8])
    x_t = rng.randn(2, 3, large, large).astype(np.float32)
    want = _nchw(jax_ddim(
        lambda x, t, i: jm.apply(params, x, t, _nhwc(low), jnp.asarray(y)),
        (2, large, large, 3),
        jax_build_tables("ddim4", base_schedule="linear"),
        rng=jax.random.key(0), noise=_nhwc(x_t)))
    low_t, y_t = torch.from_numpy(low), torch.from_numpy(y)
    with torch.no_grad():
        got = ddim_sample_loop(
            lambda x, t, i: pm(x, t, low_t, y_t), (2, 3, large, large),
            build_tables("ddim4", base_schedule="linear"), device="cpu",
            noise=torch.from_numpy(x_t)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


SR_FLAGS = ["--large_size", "16", "--small_size", "8", "--num_channels",
            "32", "--num_res_blocks", "1", "--channel_mult", "1,2",
            "--use_bf16", "False", "--num_samples", "3", "--batch_size", "2",
            "--seed", "1"]


@pytest.fixture(scope="module")
def sr_files(tmp_path_factory):
    """A tiny SR model as a guided-diffusion .pt and as the .msgpack tree
    adt train --sr_small_size writes, and base samples with labels."""
    from autodiffusion_tpu.utils.checkpoint import save_tree

    d = tmp_path_factory.mktemp("sr")
    cfg = dict(image_size=16, num_channels=32, num_res_blocks=1,
               class_cond=True, learn_sigma=True, channel_mult="1,2")
    jm = jax_create_sr(JaxConfig(**cfg), large_size=16, small_size=8)
    params = _random_params(jm, 8, jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,)), jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((1,), jnp.int32))
    torch.save(unet_state_dict_from_flax(params["params"]["unet"]),
               d / "sr.pt")
    save_tree(str(d / "model000001.msgpack"), params)
    rng = np.random.RandomState(2)
    np.savez(d / "base.npz",
             arr_0=rng.randint(0, 256, (3, 8, 8, 3), dtype=np.uint8),
             arr_1=np.array([4, 900, 12]))
    np.savez(d / "base_nolabels.npz",
             rng.randint(0, 256, (3, 8, 8, 3), dtype=np.uint8))
    return d


def _stub_forward(monkeypatch, seen):
    """SuperResModel.forward records (x, low_res shapes, labels) and
    returns zeros of its output's shape: the command's loop and files
    without 2000 UNet calls (the model and the loop are held to JAX
    above)."""

    def record(self, x, t, low_res, y=None, **kw):
        seen.append((tuple(x.shape), tuple(low_res.shape),
                     None if y is None else tuple(y.tolist()),
                     float(low_res.abs().max())))
        return torch.zeros(x.shape[0], self.out[2].weight.shape[0],
                           *x.shape[2:])

    monkeypatch.setattr(SuperResModel, "forward", record)


def test_sr_sample_matches_adt_format(sr_files, tmp_path, monkeypatch):
    """adt-torch sr-sample and adt sr-sample on the same tiny .pt and
    base samples: one arr_0 of uint8 [3, 16, 16, 3] each. The port
    streams batches of 2 (the last one cut), each step conditioned on the
    batch's base samples in [-1, 1] and their labels (arr_1; class 0
    without one), DDIM or ancestral over the full 1000-step schedule."""
    out = tmp_path / "adt.npz"
    assert jax_cli.main(["sr-sample", "--model_path", str(sr_files / "sr.pt"),
                         "--base_samples", str(sr_files / "base.npz"),
                         "--out", str(out)] + SR_FLAGS) == 0
    with np.load(out) as z:
        assert z.files == ["arr_0"]
        want = z["arr_0"]
    seen = []
    _stub_forward(monkeypatch, seen)
    for base, ddim, labels in (("base.npz", "True", [(4, 900), (12,)]),
                               ("base_nolabels.npz", "False",
                                [(0, 0), (0,)])):
        seen.clear()
        out = tmp_path / f"port_{base}"
        assert main(["sr-sample", "--model_path", str(sr_files / "sr.pt"),
                     "--base_samples", str(sr_files / base), "--out",
                     str(out), "--device", "cpu", "--use_ddim", ddim]
                    + SR_FLAGS) == 0
        with np.load(out) as z:
            assert z.files == ["arr_0"]
            got = z["arr_0"]
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (3, 16, 16, 3)
        assert len(seen) == 2000
        assert [s[2] for s in (seen[0], seen[-1])] == labels
        assert {s[:2] for s in seen} == {((2, 3, 16, 16), (2, 3, 8, 8)),
                                         ((1, 3, 16, 16), (1, 3, 8, 8))}
        assert 0.5 < max(s[3] for s in seen) <= 1.0


def test_sr_sample_reads_adt_train_msgpack(sr_files, tmp_path, monkeypatch):
    """The .msgpack tree of adt train --sr_small_size ({"params": {"unet":
    ...}}) loads into the SuperResModel of adt-torch sr-sample as the same
    weights' .pt does, and the command takes it."""
    from autodiffusion_tpu_torch.cli.main import _load_state

    cfg = ModelConfig(image_size=16, num_channels=32, num_res_blocks=1,
                      class_cond=True, learn_sigma=True, channel_mult="1,2")
    models = []
    for name in ("sr.pt", "model000001.msgpack"):
        m = create_sr_model(cfg, large_size=16, small_size=8, device="cpu")
        _load_state(m, str(sr_files / name))
        models.append(m.state_dict())
    assert models[0].keys() == models[1].keys()
    for k in models[0]:
        torch.testing.assert_close(models[0][k], models[1][k], rtol=0,
                                   atol=0)
    _stub_forward(monkeypatch, [])
    assert main(["sr-sample", "--model_path",
                 str(sr_files / "model000001.msgpack"), "--base_samples",
                 str(sr_files / "base.npz"), "--out",
                 str(tmp_path / "m.npz"), "--device", "cpu"]
                + SR_FLAGS) == 0


# ------------------------------------------------------------- training

def _sr_train_argv(data, save_dir, *extra):
    return ["train", "--device", "cpu", "--data_dir", str(data),
            "--save_dir", str(save_dir), "--batch_size", "4",
            "--microbatch", "2", "--use_bf16", "False", "--dropout", "0.0",
            "--log_interval", "1", "--image_size", "32", "--num_channels",
            "32", "--num_res_blocks", "1", "--num_head_channels", "16",
            "--attention_resolutions", "16,8", "--sr_small_size", "8",
            "--max_steps", "1"] + list(extra)


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    """32 x 32 PNGs of two classes and their 8 x 8 partners (block means)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pairs")
    os.makedirs(d / "hi")
    os.makedirs(d / "lq")
    rng = np.random.RandomState(0)
    for i in range(4):
        hi = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
        blocks = hi.reshape(8, 4, 8, 4, 3)[:, 0, :, 0, :]
        hi = np.repeat(np.repeat(blocks, 4, axis=0), 4, axis=1)
        Image.fromarray(hi).save(d / "hi" / f"c{i % 2}_{i}.png")
        Image.fromarray(blocks).save(d / "lq" / f"c{i % 2}_{i}.png")
    return d


@pytest.mark.parametrize("pairs", ["derived", "lq_dir"])
def test_train_sr_small_size_trains(pair_dirs, tmp_path, monkeypatch, pairs):
    """adt-torch train --sr_small_size trains a SuperResModel one step, on
    low_res derived by area downsampling or read from --lq_dir partners
    (here the same block means): the model sees [4 -> 2 x 2, 3, 8, 8]
    low_res, the loss is finite, and the .pt written holds the plain
    UNet's keys with 6 input channels."""
    seen = []
    real = SuperResModel.forward

    def record(self, x, t, low_res, y=None, **kw):
        seen.append(low_res.detach().clone())
        return real(self, x, t, low_res, y, **kw)

    monkeypatch.setattr(SuperResModel, "forward", record)
    extra = ["--lq_dir", str(pair_dirs / "lq")] if pairs == "lq_dir" else []
    out = tmp_path / "run"
    assert main(_sr_train_argv(pair_dirs / "hi", out, *extra)) == 0
    assert [tuple(s.shape) for s in seen] == [(2, 3, 8, 8)] * 2
    sd = torch.load(out / "model000001.pt", weights_only=True)
    assert sd["input_blocks.0.0.weight"].shape[1] == 6
    assert "loss" in (out / "log.txt").read_text()
    import csv
    with open(out / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float(rows[0]["loss"]))


def test_train_sr_seeds_from_a_base_model(pair_dirs, tmp_path):
    """super_res_train.py:38-49: a base model's 3-channel .pt seeds the SR
    model, its input conv zero-padded to 6 channels."""
    from autodiffusion_tpu_torch.models import create_model

    base = create_model(ModelConfig.adm64(
        image_size=32, num_channels=32, num_res_blocks=1,
        num_head_channels=16, attention_resolutions="16,8", use_bf16=False),
        device="cpu")
    torch.save(base.state_dict(), tmp_path / "base.pt")
    out = tmp_path / "run"
    assert main(_sr_train_argv(pair_dirs / "hi", out, "--resume_checkpoint",
                               str(tmp_path / "base.pt"), "--lr",
                               "0")) == 0
    sd = torch.load(out / "model000001.pt", weights_only=True)
    w = sd["input_blocks.0.0.weight"]
    torch.testing.assert_close(w[:, :3], base.state_dict()[
        "input_blocks.0.0.weight"], rtol=0, atol=0)
    assert not w[:, 3:].any()


def test_train_sr_refuses_bad_pairs(pair_dirs, tmp_path):
    """The JAX CLI's errors: an image size that --sr_small_size does not
    divide; --lq_dir with an .npy data file."""
    with pytest.raises(ValueError, match="multiple of --sr_small_size"):
        main(_sr_train_argv(pair_dirs / "hi", tmp_path, "--sr_small_size",
                            "12"))
    npy = tmp_path / "imgs.npy"
    np.save(npy, np.zeros((4, 32, 32, 3), np.uint8))
    np.save(tmp_path / "imgs_labels.npy", np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="lq_dir"):
        main(_sr_train_argv(npy, tmp_path, "--lq_dir", str(pair_dirs)))


# ------------------------------------------------------ attention routes

CUDA = torch.device("cuda")


@pytest.mark.parametrize("d,grad,want", [
    (64, False, "kernel"), (64, True, "kernel"), (80, False, "kernel"),
    (80, True, "sdpa"), (40, False, "kernel"), (40, True, "sdpa"),
    (512, False, "kernel"), (512, True, "sdpa"), (96, False, "sdpa"),
    (160, False, "sdpa"), (192, False, "sdpa"), (192, True, "sdpa"),
    (128, True, "kernel"), (48, False, "sdpa")])
def test_attention_route_by_head_dim(monkeypatch, d, grad, want):
    """On the card (decided from the shape alone, no card needed): a head
    dim with a kernel (the forward's, or the backward's where a gradient
    is wanted) takes it at a site the gate does not list; every other head
    dim takes SDPA. On the CPU the same sites take the wrappers (their
    twins) or the plain twin."""
    monkeypatch.delenv("ADT_FLASH_GATE", raising=False)
    site = (100, 77, d, 3, grad)
    assert site not in FLASH_GATE_SDPA
    assert attention_route(*site, CUDA) == want
    assert attention_route(*site, "meta") == want
    assert attention_route(*site, "cpu") == \
        ("kernel" if want == "kernel" else "twin")


def test_attention_route_reads_the_gate(monkeypatch):
    """A site in the gate's table takes SDPA on the card, unless
    ADT_FLASH_GATE=0 (every kernel on); a site with a kernel and not in
    the table keeps it; the CPU never takes SDPA."""
    fa = __import__("sys").modules[
        "autodiffusion_tpu_torch.ops.flash_attention"]
    gated = (1024, 1024, 64, 6, False)
    monkeypatch.setattr(fa, "FLASH_GATE_SDPA", frozenset({gated}))
    monkeypatch.delenv("ADT_FLASH_GATE", raising=False)
    assert flash_gate_on()
    assert attention_route(*gated, CUDA) == "sdpa"
    assert attention_route(1024, 1024, 64, 6, True, CUDA) == "kernel"
    assert attention_route(*gated, "cpu") == "kernel"
    monkeypatch.setenv("ADT_FLASH_GATE", "0")
    assert not flash_gate_on()
    assert attention_route(*gated, CUDA) == "kernel"
    assert attention_route(1024, 1024, 96, 6, False, CUDA) == "sdpa"
    with pytest.raises(ValueError):
        attention_route(*gated, "xpu")


def test_committed_gate_is_site_shaped():
    """Every entry of the committed table is a (T, S, D, heads, gradient)
    site with a kernel (a site without one takes SDPA by the shape rule)."""
    for t, s, d, heads, grad in FLASH_GATE_SDPA:
        assert all(isinstance(v, int) and v > 0 for v in (t, s, d, heads))
        assert isinstance(grad, bool)
        assert attention_route(t, s, d, heads, grad, "cpu") == "kernel"


@pytest.mark.parametrize("grad", [False, True])
def test_both_attention_sites_take_one_dispatch(monkeypatch, grad):
    """AttentionBlock (heads first, the gradient flowing where one is
    wanted) and multihead_attention (tokens first, forward only) both
    reach a site's work through routed_attention, each with its site's
    (T, S, D, heads, gradient) key and the route attention_route gives it,
    on the CPU: D = 64 the wrappers' route ("kernel"), D = 160 the twin;
    each result is the reference math's."""
    fa = __import__("sys").modules[
        "autodiffusion_tpu_torch.ops.flash_attention"]
    seen = []
    real = fa._attend

    def record(key, route, q, k, v, tokens_first):
        seen.append((key, route, tokens_first))
        return real(key, route, q, k, v, tokens_first)

    monkeypatch.setattr(fa, "_attend", record)
    rng = np.random.RandomState(11)
    blk = AttentionBlock(128, num_heads=2)
    x = torch.from_numpy(rng.randn(2, 128, 4, 4).astype(np.float32))
    with torch.set_grad_enabled(grad):
        out = blk(x.requires_grad_(grad))
    q = torch.from_numpy(rng.randn(2, 10, 320).astype(np.float32))
    c = torch.from_numpy(rng.randn(2, 7, 320).astype(np.float32))
    got = fa.multihead_attention(q, c, c, 2)
    assert seen == [((16, 16, 64, 2, grad), "kernel", False),
                    ((10, 7, 160, 2, False), "twin", True)]
    assert out.requires_grad == grad
    want = fa.flash_attention_reference(
        *(z.reshape(2, -1, 2, 160).transpose(1, 2) for z in (q, c, c)))
    np.testing.assert_allclose(
        got.numpy(), want.transpose(1, 2).reshape(2, 10, -1).numpy(),
        atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("new_order", [True, False])
def test_attention_block_d192_matches_jax(new_order):
    """An AttentionBlock of 768 channels in 4 heads (D = 192, adt
    sr-sample's head dim at its defaults, which no kernel takes) against
    the JAX block, forward and the input gradient, float32 on the CPU."""
    c, heads = 768, 4
    jm = JaxAttention(num_heads=heads, new_order=new_order)
    rng = np.random.RandomState(9)
    x = rng.randn(2, c, 8, 8).astype(np.float32)
    params = _random_params(jm, 3, jnp.zeros((1, 8, 8, c)))
    pm = AttentionBlock(c, num_heads=heads, use_new_attention_order=new_order)
    sd = {}
    _attnblock(sd, "blk", params["params"])
    pm.load_state_dict({k[len("blk."):]: v for k, v in sd.items()},
                       strict=True)
    assert attention_route(64, 64, 192, heads, True, "cpu") == "twin"

    def jfn(xx):
        return jm.apply(params, xx)

    want, vjp = jax.vjp(jfn, _nhwc(x))
    g = np.random.RandomState(10).randn(*x.shape).astype(np.float32)
    want_dx = _nchw(vjp(_nhwc(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pm(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), _nchw(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx,
                               atol=TOL * np.abs(want_dx).max(), rtol=TOL)
