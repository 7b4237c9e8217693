"""The unconditional LSUN-256 configuration of the PyTorch port against
the JAX package, on the CPU: ``ModelConfig.lsun256`` (search_lsun_bedroom.sh),
a tiny UNet of its kind (no classes, guided-diffusion's legacy QKV order,
the linear schedule) and its DDIM over the published 15-step bedroom
schedule, and ``adt-torch search`` / ``sample`` with ``--class_cond False``.

The UNet's weights are the port's seeded ones carried to flax by the JAX
package's own converter. Tolerances: the forward 2e-4
(tests/test_torch_models.py); the 15-step DDIM, x_T injected, float32,
1e-4 of the images' scale.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import ModelConfig as JaxConfig
from autodiffusion_tpu.models import create_model as jax_create_model
from autodiffusion_tpu.models.convert import convert_unet
from autodiffusion_tpu.samplers import ddim_sample_loop as jax_ddim
from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu_torch.models import (ModelConfig, create_model,
                                            random_init_)
from autodiffusion_tpu_torch.samplers import ddim_sample_loop
from autodiffusion_tpu_torch.schedules import build_tables
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_search import _fresh_port_logger  # noqa: F401

# the published LSUN bedroom schedule (sample_LSUN_bedroom_subnet.sh:8)
BEDROOM_15 = [644, 737, 67, 804, 134, 871, 6, 639, 268, 335, 402, 469, 536,
              603, 670]
# a tiny model of the preset's kind: 32 channels at 32 x 32, attention at
# 16 and 8 (2 and 4 heads of 16), float32
TINY = dict(image_size=32, num_channels=32, num_res_blocks=1,
            num_head_channels=16, attention_resolutions="16,8",
            channel_mult="1,2,2", use_bf16=False, dropout=0.0)


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("overrides", [{}, TINY])
def test_lsun256_preset_matches_jax(overrides):
    """Every field of the port's ModelConfig.lsun256 equals the JAX
    preset's, with and without overrides; the JAX fields the port's
    config has no use for keep their defaults there."""
    port = ModelConfig.lsun256(**overrides)
    jax_cfg = JaxConfig.lsun256(**overrides)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    assert names <= {f.name for f in dataclasses.fields(JaxConfig)}
    for name in names:
        assert getattr(port, name) == getattr(jax_cfg, name), name
    for f in dataclasses.fields(JaxConfig):
        if f.name not in names:
            assert getattr(jax_cfg, f.name) == f.default, f.name
    if not overrides:
        assert (port.image_size, port.num_channels, port.class_cond,
                port.use_new_attention_order, port.noise_schedule) == \
            (256, 256, False, False, "linear")


def _pair(seed=0):
    """(JAX model, its params, the port's model): the port's seeded UNet
    carried to flax by the JAX converter."""
    pm = random_init_(create_model(ModelConfig.lsun256(**TINY),
                                   device="cpu"), seed)
    jm = jax_create_model(JaxConfig.lsun256(**TINY))
    params = convert_unet({k: v.numpy() for k, v in
                           pm.state_dict().items()}, jm)
    return jm, params, pm


def test_lsun_shaped_unet_matches_jax():
    """The tiny LSUN-kind UNet (no label embedding, legacy QKV order,
    learn_sigma: 6 output channels) on two noisy images at two
    timesteps, against the JAX UNet with the converted weights."""
    jm, params, pm = _pair()
    assert getattr(pm, "label_emb", None) is None
    assert all(not blk.new_order for blk in pm.modules()
               if type(blk).__name__ == "AttentionBlock")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    t = np.array([17.0, 901.0], np.float32)
    want = _nchw(jax.jit(jm.apply)(params, _nhwc(x), jnp.asarray(t)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == (2, 6, 32, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_lsun_unconditional_ddim_15_steps_matches_jax():
    """Unconditional DDIM over the published 15-step bedroom schedule on
    the preset's linear base schedule, both packages from the same x_T:
    the images within 1e-4 of their scale."""
    jm, params, pm = _pair(seed=1)
    x_t = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    jax_tables = jax_build_tables(BEDROOM_15, base_schedule="linear")
    tables = build_tables(BEDROOM_15, base_schedule="linear")
    assert tables.num_steps == 15
    want = _nchw(jax_ddim(lambda x, t, i: jm.apply(params, x, t),
                          (2, 32, 32, 3), jax_tables,
                          rng=jax.random.key(0), noise=_nhwc(x_t)))
    with torch.no_grad():
        got = ddim_sample_loop(lambda x, t, i: pm(x, t), (2, 3, 32, 32),
                               tables, device="cpu",
                               noise=torch.from_numpy(x_t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("t,heads,route", [(1024, 8, "kernel"),
                                           (256, 16, "sdpa"),
                                           (64, 16, "kernel")])
def test_lsun_attention_routes(monkeypatch, t, heads, route):
    """The LSUN-256 UNet's forward-only attention sites (head dim 64) on
    the card, as its flash A/B set them: the flash forward at T 1024 (8
    heads) and T 64 (16), SDPA at T 256 (16); every one on its kernel
    with the gate off, and on the wrappers (the twins) on the CPU."""
    from autodiffusion_tpu_torch.ops.flash_attention import attention_route

    monkeypatch.delenv("ADT_FLASH_GATE", raising=False)
    site = (t, t, 64, heads, False)
    assert attention_route(*site, "cuda") == route
    assert attention_route(*site, "meta") == route
    assert attention_route(*site, "cpu") == "kernel"
    monkeypatch.setenv("ADT_FLASH_GATE", "0")
    assert attention_route(*site, "cuda") == "kernel"


def _lsun_flags():
    cfg = ModelConfig.lsun256(**TINY)
    return ["--image_size", str(cfg.image_size),
            "--num_channels", str(cfg.num_channels),
            "--num_res_blocks", str(cfg.num_res_blocks),
            "--num_head_channels", str(cfg.num_head_channels),
            "--attention_resolutions", cfg.attention_resolutions,
            "--channel_mult", cfg.channel_mult,
            "--class_cond", "False", "--learn_sigma", "True",
            "--noise_schedule", "linear", "--resblock_updown", "True",
            "--use_scale_shift_norm", "True",
            "--use_new_attention_order", "False", "--use_bf16", "False"]


def test_cli_unconditional_search_and_sample_on_cpu(tmp_path, capsys):
    """``adt-torch search`` without a classifier on the LSUN kind's flags
    (DDIM-4, one epoch), then ``adt-torch sample --class_cond False`` over
    the 15-step bedroom schedule: finite FIDs, uint8 images and no
    labels in the .npz."""
    from autodiffusion_tpu_torch.cli.main import main
    from autodiffusion_tpu_torch.fid import (FIDStats, inception_apply,
                                             load_fid_inception,
                                             synthesize_pt_inception)

    pm = random_init_(create_model(ModelConfig.lsun256(**TINY),
                                   device="cpu"), 2)
    torch.save(pm.state_dict(), tmp_path / "model.pt")
    torch.save(synthesize_pt_inception(0), tmp_path / "incep.pth")
    inc = load_fid_inception(str(tmp_path / "incep.pth"), device="cpu")
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 32, 32, 3), dtype=np.uint8))
    FIDStats.from_features(inception_apply(inc, imgs)["pool3"].numpy()) \
        .save(str(tmp_path / "ref.npz"))

    argv = ["search", "--device", "cpu",
            "--model_path", str(tmp_path / "model.pt"),
            "--inception_path", str(tmp_path / "incep.pth"),
            "--ref_stats", str(tmp_path / "ref.npz"),
            "--save_dir", str(tmp_path / "run"), "--time_step", "4",
            "--num_samples", "2", "--batch_size", "2",
            "--candidate_chunk", "2", "--population_num", "2",
            "--select_num", "1", "--mutation_num", "1",
            "--crossover_num", "1", "--max_epochs", "1"] + _lsun_flags()
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["best"]) == 4 and np.isfinite(out["fid"])

    npz = tmp_path / "lsun.npz"
    argv = ["sample", "--device", "cpu",
            "--model_path", str(tmp_path / "model.pt"),
            "--use_timestep", json.dumps(BEDROOM_15), "--num_samples", "3",
            "--batch_size", "2", "--seed", "1", "--out", str(npz)] \
        + _lsun_flags()
    assert main(argv) == 0
    with np.load(npz) as z:
        assert z.files == ["arr_0"]
        arr = z["arr_0"]
    assert arr.dtype == np.uint8 and arr.shape == (3, 32, 32, 3)
    assert arr.std() > 0
