"""The port's models with the three kernel switches on, against the JAX
package.

``ADT_FUSED_NORM=1``, ``ADT_IM2COL_CONV=1`` and ``ADT_FUSED_CONV=all``
route GroupNorm32 through the fused GroupNorm, Conv3x3 through the im2col
conv and each ResBlock norm that feeds its conv into the fused
norm-act-conv (with the residual in the conv's epilogue where no keep
factor scales the branch). On CPU tensors every route computes its
kernels' plain twins. The JAX package's conv gates return False off the
TPU and its fused-norm gate too, so whatever the environment its models
run XLA's plain composition here: the references below are the same math
in another order, not the Pallas kernels (tests/test_torch_fused_norm.py
and tests/test_torch_conv.py hold the twins against those).

Tiny configs at 64 and 128 channels, the least the conv gates take, with
seeded random parameters carried flax -> port by ``models.convert``.
Tolerances as tests/test_torch_models.py (2e-4 for a forward) and
tests/test_torch_samplers.py (5e-4 for a guided DDIM loop, 2e-4 x scale
for the classifier gradient): float32 on the CPU on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.models.unet import ResBlock as JaxResBlock
from autodiffusion_tpu.samplers import classifier_cond_fn as jax_cond_fn
from autodiffusion_tpu.samplers import ddim_sample_loop as jax_ddim
from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu_torch.models import (ClassifierConfig, ModelConfig,
                                            create_classifier, create_model)
from autodiffusion_tpu_torch.models import nn as port_nn
from autodiffusion_tpu_torch.models import unet as port_unet
from autodiffusion_tpu_torch.models.convert import (
    _resblock, classifier_state_dict_from_flax, unet_state_dict_from_flax)
from autodiffusion_tpu_torch.models.unet import (EncoderUNetModel, ResBlock,
                                                 UNetModel)
from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                              ddim_sample_loop)
from autodiffusion_tpu_torch.schedules import build_tables
from test_torch_models import _random_params
from test_torch_package import one_torch_thread  # noqa: F401

TOL = 2e-4
LOOP_TOL = 5e-4
IMG = 8
COMMON = dict(model_channels=64, num_res_blocks=1, attention_ds=(2,),
              channel_mult=(1, 2), num_head_channels=32,
              use_scale_shift_norm=True, resblock_updown=True)
SWITCHES = {"ADT_FUSED_NORM": "1", "ADT_IM2COL_CONV": "1",
            "ADT_FUSED_CONV": "all"}
ROUTES = ("fused_group_norm", "conv3x3", "conv3x3_fused")


@pytest.fixture
def switches(monkeypatch):
    """All three switches on; returns the calls of each route."""
    for k, v in SWITCHES.items():
        monkeypatch.setenv(k, v)
    return _count_routes(monkeypatch)


def _count_routes(monkeypatch):
    calls = dict.fromkeys(ROUTES, 0)
    for name in ROUTES:
        real = getattr(port_nn, name)

        def counted(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(port_nn, name, counted)
    return calls


def _nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


# ------------------------------------------------------------------ ResBlock

@pytest.mark.parametrize("c_in,c_out,up,down,keep", [
    (64, 64, False, False, None),      # fused in and out, residual fused
    (64, 128, False, False, None),     # 1x1 skip as the fused residual
    (64, 64, False, False, 0.0),       # keep factor: residual outside
    (64, 64, False, True, None),       # down: fused norm + im2col in
    (128, 64, True, False, None),      # up, with a 1x1 skip
])
def test_resblock_matches_jax(switches, c_in, c_out, up, down, keep):
    rng = np.random.RandomState(0)
    x = rng.randn(2, IMG, IMG, c_in).astype(np.float32)
    emb = rng.randn(2, 96).astype(np.float32)
    jm = JaxResBlock(out_channels=c_out, up=up, down=down)
    params = _random_params(jm, 1, jnp.zeros((1, IMG, IMG, c_in)),
                            jnp.zeros((1, 96)))
    jkeep = None if keep is None else jnp.asarray(keep)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(emb), keep=jkeep)
    sd = {}
    _resblock(sd, "blk", params["params"])
    pm = ResBlock(c_in, 96, 0.0, out_channels=c_out, up=up,
                  down=down).eval()
    pm.load_state_dict({k[len("blk."):]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(_nchw(x)), torch.from_numpy(emb),
                 None if keep is None else torch.tensor(keep))
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want),
                               atol=TOL, rtol=TOL)
    updown = up or down
    assert switches == {"fused_group_norm": int(updown),
                        "conv3x3": int(updown),
                        "conv3x3_fused": 1 + (not updown)}


# ------------------------------------------------------------ whole models

@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(out_channels=6, num_classes=10,
                 use_new_attention_order=True, **COMMON)
    mp = _random_params(jm, 0, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)),
                        jnp.zeros((1,), jnp.int32))
    pm = UNetModel(in_channels=3, out_channels=6, num_classes=10,
                   use_new_attention_order=True, **COMMON).eval()
    pm.load_state_dict(unet_state_dict_from_flax(mp), strict=True)
    jc = JaxEncoder(out_channels=10, use_new_attention_order=False,
                    pool="attention", **COMMON)
    cp = _random_params(jc, 1, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))
    pc = EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                          use_new_attention_order=False, **COMMON).eval()
    pc.load_state_dict(classifier_state_dict_from_flax(cp), strict=True)
    return jm, mp, pm, jc, cp, pc


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    return x, np.array([17.0, 901.0], np.float32), np.array([3, 7])


def test_unet_matches_jax(models, switches):
    jm, mp, pm, *_ = models
    x, t, y = _inputs(2)
    keep = np.ones((2, pm.layer_num), np.float32)
    keep[0, 1] = 0.0
    want = jax.jit(jm.apply)(mp, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(y), keep_mask=jnp.asarray(keep))
    with torch.no_grad():
        got = pm(torch.from_numpy(_nchw(x)), torch.from_numpy(t),
                 torch.from_numpy(y), keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=TOL, rtol=TOL)
    assert min(switches.values()) > 0, switches


def test_classifier_matches_jax(models, switches):
    *_, jc, cp, pc = models
    x, t, _ = _inputs(3)
    want = jax.jit(jc.apply)(cp, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = pc(torch.from_numpy(_nchw(x)), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert min(switches.values()) > 0, switches


def test_switches_off_take_no_route(models, monkeypatch):
    """Unset, the switches leave the PR's default path: no call reaches
    the kernels' wrappers."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    calls = _count_routes(monkeypatch)
    _, _, pm, _, _, pc = models
    x, t, y = _inputs(4)
    with torch.no_grad():
        pm(torch.from_numpy(_nchw(x)), torch.from_numpy(t),
           torch.from_numpy(y))
    classifier_cond_fn(pc, torch.from_numpy(y), 1.0)(
        torch.from_numpy(_nchw(x)), torch.from_numpy(t))
    assert calls == dict.fromkeys(ROUTES, 0)


def test_classifier_gradient_matches_jax(models, switches):
    *_, jc, cp, pc = models
    x, t, y = _inputs(5)
    want = jax.jit(jax_cond_fn(lambda xx, tt: jc.apply(cp, xx, tt),
                               jnp.asarray(y), 1.5))(jnp.asarray(x),
                                                     jnp.asarray(t))
    got = classifier_cond_fn(pc, torch.from_numpy(y), 1.5)(
        torch.from_numpy(_nchw(x)), torch.from_numpy(t))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), _nchw(want),
                               atol=2e-4 * max(scale, 1.0), rtol=0)
    assert min(switches.values()) > 0, switches


def test_guided_ddim2_matches_jax(models, switches):
    jm, mp, pm, jc, cp, pc = models
    rng = np.random.RandomState(7)
    x_t = rng.randn(4, IMG, IMG, 3).astype(np.float32)
    y = np.array([1, 5, 1, 5])
    cand = [120, 803]
    j_cond = jax_cond_fn(lambda x, t: jc.apply(cp, x, t), jnp.asarray(y),
                         2.0)
    want = jax.jit(lambda x: jax_ddim(
        lambda xx, t, i: jm.apply(mp, xx, t, jnp.asarray(y)), x.shape,
        jax_build_tables(cand, base_schedule="cosine"),
        rng=jax.random.key(11), noise=x, cond_fn=j_cond))(jnp.asarray(x_t))
    y_t = torch.from_numpy(y)
    got = ddim_sample_loop(lambda x, t, i: pm(x, t, y_t), (4, 3, IMG, IMG),
                           build_tables(cand, base_schedule="cosine"),
                           device="cpu", noise=torch.from_numpy(_nchw(x_t)),
                           cond_fn=classifier_cond_fn(pc, y_t, 2.0))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=LOOP_TOL,
                               rtol=0)
    assert min(switches.values()) > 0, switches


# ------------------------------------------------------ ADM-64 launch counts

def test_adm64_route_counts(monkeypatch):
    """Calls of each route in one forward of the full-width ADM-64 UNet
    and classifier on the meta device (shapes only), the counts the launch
    accounting of chip_smoke.py relies on. UNet: 36 ResBlocks, 6 of them
    up/down (fused norm + im2col conv in, the other 30 fused in), every
    out-conv fused (36); 22 attention norms and the out norm fused. The
    classifier: 21 ResBlocks, 3 down; 13 attention norms and the out norm.
    Under guidance every classifier GroupNorm of the fused route also runs
    its backward kernel once."""
    for k, v in SWITCHES.items():
        monkeypatch.setenv(k, v)
    calls = dict.fromkeys(ROUTES, 0)

    def recorder(name):
        def run(x, *args, **kw):
            calls[name] += 1
            if name == "fused_group_norm":
                return torch.empty_like(x)
            w = args[0] if name == "conv3x3" else args[2]
            return torch.empty((x.shape[0], w.shape[0], *x.shape[2:]),
                               dtype=x.dtype, device=x.device)
        return run

    for name in ROUTES:
        monkeypatch.setattr(port_nn, name, recorder(name))
    monkeypatch.setattr(port_unet, "flash_attention",
                        lambda q, k, v: torch.empty_like(q))
    with torch.device("meta"):
        m = create_model(ModelConfig.adm64(), device="meta")
        m(torch.empty(1, 3, 64, 64), torch.zeros(1),
          torch.zeros(1, dtype=torch.long))
        assert calls == {"fused_group_norm": 29, "conv3x3": 6,
                         "conv3x3_fused": 66}
        calls.update(dict.fromkeys(ROUTES, 0))
        c = create_classifier(ClassifierConfig.adm64(), device="meta")
        c(torch.empty(1, 3, 64, 64), torch.zeros(1))
        assert calls == {"fused_group_norm": 17, "conv3x3": 3,
                         "conv3x3_fused": 39}
