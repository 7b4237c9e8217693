"""The classifier's spatial pools (``spatial``, ``spatial_v2``) of the
PyTorch port against the JAX package, on the CPU.

EncoderUNetModel pools the spatial mean of every input block's output
(cast to the input's dtype) and of the middle block's, concatenated, into
Linear(., 2048) -> ReLU -> Linear (``spatial``) or Linear(., 2048) ->
GroupNorm32(32, 2048) -> SiLU -> Linear (``spatial_v2``), under
guided-diffusion's keys (``out.0``, ``out.2`` / ``out.0``, ``out.1``,
``out.3``: JAX models/convert.py:189-197). Tiny config, float32, seeded
parameters; tolerance TOL = 2e-4 as tests/test_torch_models.py's, the
training step's as tests/test_torch_train.py's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
from autodiffusion_tpu.models.convert import convert_classifier
from autodiffusion_tpu.schedules import build_base_tables as jax_base_tables
from autodiffusion_tpu.train.classifier import \
    make_classifier_train_step as jax_classifier_step
from autodiffusion_tpu.train.state import create_train_state as jax_state
from autodiffusion_tpu_torch.cli.main import main
from autodiffusion_tpu_torch.models import ClassifierConfig, create_classifier
from autodiffusion_tpu_torch.models.convert import \
    classifier_state_dict_from_flax
from autodiffusion_tpu_torch.models.nn import GroupNorm32
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel
from autodiffusion_tpu_torch.schedules import build_base_tables
from autodiffusion_tpu_torch.train import (create_train_state,
                                           make_classifier_train_step)
from autodiffusion_tpu_torch.utils import logger
from test_torch_models import _random_params
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_train import _assert_params_close

TOL = 2e-4
IMG = 16
CFG = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
           channel_mult=(1, 2), num_head_channels=16,
           use_scale_shift_norm=True, resblock_updown=True)
POOLS = ["spatial", "spatial_v2"]


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _pair(pool, seed=0):
    jm = JaxEncoder(out_channels=10, use_new_attention_order=False,
                    pool=pool, **CFG)
    params = _random_params(jm, seed, jnp.zeros((1, IMG, IMG, 3)),
                            jnp.zeros((1,)))
    pm = EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                          use_new_attention_order=False, pool=pool, **CFG)
    pm.load_state_dict(classifier_state_dict_from_flax(params), strict=True)
    return jm, params, pm.eval()


def _inputs(seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 3, IMG, IMG).astype(np.float32),
            np.array([17.0, 901.0][:b], np.float32))


@pytest.mark.parametrize("pool", POOLS)
def test_spatial_pool_keys_round_trip_through_convert_classifier(pool):
    """The port's state dict has guided-diffusion's head keys, and JAX's
    convert_classifier maps it back onto the flax tree exactly."""
    jm, params, pm = _pair(pool)
    head = sorted(k for k in pm.state_dict() if k.startswith("out."))
    want = (["out.0.bias", "out.0.weight", "out.2.bias", "out.2.weight"]
            if pool == "spatial" else
            ["out.0.bias", "out.0.weight", "out.1.bias", "out.1.weight",
             "out.3.bias", "out.3.weight"])
    assert head == want
    back = convert_classifier({k: v.numpy() for k, v in
                               pm.state_dict().items()}, jm)
    la, ta = jax.tree_util.tree_flatten(back)
    lb, tb = jax.tree_util.tree_flatten(params)
    assert ta == tb
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # one pool per input block (the in-conv 32, the level-0 ResBlock 32,
    # the downsampling ResBlock 32, the level-1 ResBlock 64) and one for
    # the middle block (64)
    assert pm.out[0].weight.shape == (2048, 32 + 32 + 32 + 64 + 64)


@pytest.mark.parametrize("pool", POOLS)
def test_spatial_pools_match_jax_fp32(pool):
    jm, params, pm = _pair(pool, seed=1)
    x, t = _inputs(2)
    want = np.asarray(jax.jit(jm.apply)(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_spatial_v2_norm_takes_the_fused_route_at_one_position(monkeypatch):
    """spatial_v2's GroupNorm runs on [B, 2048, 1, 1]: under
    ADT_FUSED_NORM=1 (the card's default route; the twins on the CPU) it
    goes through the fused GroupNorm at one position a channel and gives
    the plain chain's logits."""
    from autodiffusion_tpu_torch.models import nn as port_nn

    _, _, pm = _pair("spatial_v2", seed=4)
    x, t = _inputs(5)
    with torch.no_grad():
        plain = pm(torch.from_numpy(x), torch.from_numpy(t))
    shapes = []
    real = port_nn.fused_group_norm

    def record(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return real(x, *a, **kw)

    monkeypatch.setattr(port_nn, "fused_group_norm", record)
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    with torch.no_grad():
        fused = pm(torch.from_numpy(x), torch.from_numpy(t))
    assert (2, 2048, 1, 1) in shapes
    assert isinstance(pm.out[1], GroupNorm32)
    torch.testing.assert_close(fused, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pool", POOLS)
def test_spatial_pool_classifier_step_matches_jax(pool):
    """One classifier update (noised inputs) with each spatial head: loss,
    grad norm and the parameters after it, against JAX's."""
    jm, params, pm = _pair(pool, seed=6)
    pm.train()
    rng = np.random.RandomState(7)
    x = (rng.randint(0, 256, (4, 3, IMG, IMG)) / 127.5 - 1).astype(
        np.float32)
    y, t = rng.randint(0, 10, 4), rng.randint(0, 1000, 4)
    key = jax.random.key(2)
    noise = np.asarray(jax.random.normal(key, (4, IMG, IMG, 3))) \
        .transpose(0, 3, 1, 2)
    lr = 3e-4
    jstate = jax_state(params, lr=lr, weight_decay=0.05, ema_rates=())
    jstate, want = jax.jit(jax_classifier_step(jm.apply))(
        jstate, jax_base_tables("cosine", 1000),
        {"x": jnp.asarray(x.transpose(0, 2, 3, 1)), "y": jnp.asarray(y)},
        jnp.asarray(t), key)
    pstate = create_train_state(pm, lr=lr, weight_decay=0.05, ema_rates=())
    _, got = make_classifier_train_step(pm)(
        pstate, build_base_tables("cosine", 1000),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(t), noise=torch.from_numpy(np.ascontiguousarray(
            noise)))
    for k in ("loss", "grad_norm", "per_example_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, err_msg=k)
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    _assert_params_close(convert_classifier(sd, jm), jstate.params,
                         2e-3 * lr, lr)


def test_unknown_pool_is_refused():
    with pytest.raises(ValueError, match="unknown pool"):
        EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                         pool="mean", **CFG)


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(3)
    for i in range(6):
        Image.fromarray(rng.randint(0, 256, (36, 36, 3), dtype=np.uint8)) \
            .save(d / f"n{i % 3:03d}_{i}.png")
    return d


@pytest.mark.parametrize("pool", POOLS)
def test_train_classifier_spatial_pool_command(png_dir, tmp_path, pool):
    """adt-torch train-classifier --classifier_pool spatial|spatial_v2
    trains and writes a checkpoint the same pool's classifier loads."""
    out = tmp_path / "cls"
    assert main(["train-classifier", "--device", "cpu", "--data_dir",
                 str(png_dir), "--save_dir", str(out), "--iterations", "2",
                 "--batch_size", "2", "--image_size", "32",
                 "--classifier_width", "64", "--classifier_depth", "1",
                 "--classifier_use_bf16", "False", "--num_classes", "3",
                 "--log_interval", "1", "--classifier_pool", pool]) == 0
    rows = [json.loads(r) for r in open(out / "progress.json")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert {"model000002.pt", "opt000002.pt"} <= set(os.listdir(out))
    c = create_classifier(ClassifierConfig(
        image_size=32, classifier_width=64, classifier_depth=1,
        classifier_pool=pool), num_classes=3, device="cpu")
    c.load_state_dict(torch.load(out / "model000002.pt", weights_only=True),
                      strict=True)
