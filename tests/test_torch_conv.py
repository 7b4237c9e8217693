"""3x3 convolutions of the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX package's Pallas kernels
in interpret mode (``conv3x3_im2col``, ``_conv3x3_fused_impl``, and the
custom-VJP wrappers ``conv3x3`` / ``conv3x3_fused``, as
tests/test_conv_im2col.py runs them on the CPU) and through the port's
wrappers on CPU tensors, which compute the plain twins of the CUDA kernels.
Layouts travel NHWC / HWIO (JAX) and NCHW / OIHW (port). Row tiles of one
row (every tile's halo comes from its neighbours) and of several rows, and
C_out blocks smaller than C_out, exercise the TPU kernels' tiling; the
port's twins have none, so agreement pins the halo and block handling.

Tolerances: float32 2e-5 (absolute and relative): both sides sum 9 C_in
float32 products on the CPU, in other orders. bfloat16: 2^-7 |want| plus
2^-8 max|want| (a unit in the last place of the value, plus one of the
largest for outputs near zero), since both round the same float32 sum once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.ops.conv_im2col import \
    _conv3x3_fused_impl as jax_fused_impl
from autodiffusion_tpu.ops.conv_im2col import conv3x3 as jax_conv3x3
from autodiffusion_tpu.ops.conv_im2col import \
    conv3x3_fused as jax_conv3x3_fused
from autodiffusion_tpu.ops.conv_im2col import \
    conv3x3_im2col as jax_conv3x3_im2col
from autodiffusion_tpu_torch.models import nn as port_nn
from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
from autodiffusion_tpu_torch.ops.conv_im2col import (
    conv3x3, conv3x3_fused, conv3x3_fused_kernel, conv3x3_im2col,
    conv3x3_reference, fused_conv_reference, resolve_use_fused_conv,
    resolve_use_im2col)
from test_torch_package import one_torch_thread  # noqa: F401

TOL = 2e-5


def _inputs(seed, b=2, h=6, w=5, c_in=16, c_out=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c_in).astype(np.float32)
    k = (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32)
    bias = (0.1 * rng.randn(c_out)).astype(np.float32)
    a = (1.0 + 0.3 * rng.randn(b, c_in)).astype(np.float32)
    off = (0.3 * rng.randn(b, c_in)).astype(np.float32)
    res = rng.randn(b, h, w, c_out).astype(np.float32)
    g = rng.randn(b, h, w, c_out).astype(np.float32)
    return x, k, bias, a, off, res, g


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(dtype)


def _oihw(k, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k, np.float32).transpose(3, 2, 0, 1))).to(dtype)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, dtype="float32", name=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=name)
    else:
        lim = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
        worst = float((np.abs(got - want) / lim).max())
        assert worst <= 1, f"{name}: max |d| / limit = {worst:.3g}"


# (tile_h, co_block) of the JAX kernel: one-row tiles, multi-row tiles,
# and C_out split into blocks
TILES = [(1, 24), (3, 8), (6, 12)]


@pytest.mark.parametrize("tile_h,co_block", TILES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv3x3_im2col_matches_jax_kernel(tile_h, co_block, with_bias):
    x, k, bias, *_ = _inputs(0)
    want = jax_conv3x3_im2col(jnp.asarray(x), jnp.asarray(k),
                              jnp.asarray(bias) if with_bias else None,
                              tile_h=tile_h, co_block=co_block,
                              interpret=True)
    got = conv3x3_im2col(_nchw(x), _oihw(k), _t(bias) if with_bias else None)
    assert got.shape == (2, 24, 6, 5) and got.dtype == torch.float32
    _close(_nhwc(got), want)
    assert torch.equal(got, conv3x3_reference(_nchw(x), _oihw(k),
                                              _t(bias) if with_bias
                                              else None))


def test_conv3x3_im2col_bf16_matches_jax_kernel():
    x, k, bias, *_ = _inputs(1, h=8, w=8, c_in=32, c_out=16)
    bf = jnp.bfloat16
    want = jax_conv3x3_im2col(jnp.asarray(x, bf), jnp.asarray(k, bf),
                              jnp.asarray(bias, bf), tile_h=2, co_block=16,
                              interpret=True)
    got = conv3x3_im2col(_nchw(np.asarray(jnp.asarray(x, bf), np.float32),
                               torch.bfloat16),
                         _oihw(np.asarray(jnp.asarray(k, bf), np.float32),
                               torch.bfloat16),
                         _t(np.asarray(jnp.asarray(bias, bf), np.float32)))
    assert got.dtype == torch.bfloat16
    _close(_nhwc(got), want, "bfloat16")


@pytest.mark.parametrize("with_bias", [True, False])
def test_conv3x3_gradients_match_jax(with_bias):
    """conv3x3's backward (PyTorch's conv gradients) against the JAX
    custom VJP (XLA's conv gradients), with the forward through the
    1-row-tile kernel."""
    x, k, bias, *_, g = _inputs(2)
    jargs = [jnp.asarray(x), jnp.asarray(k)] + \
        ([jnp.asarray(bias)] if with_bias else [])

    def f(*args):
        return jax_conv3x3(args[0], args[1],
                           args[2] if with_bias else None, 1, True)

    want_out, vjp = jax.vjp(f, *jargs)
    want = vjp(jnp.asarray(g))
    leaves = [_nchw(x).requires_grad_(True), _oihw(k).requires_grad_(True)]
    if with_bias:
        leaves.append(_t(bias).requires_grad_(True))
    out = conv3x3(leaves[0], leaves[1], leaves[2] if with_bias else None)
    _close(_nhwc(out), want_out)
    got = torch.autograd.grad(out, leaves, _nchw(g))
    _close(_nhwc(got[0]), want[0], name="dx")
    _close(got[1].numpy().transpose(2, 3, 1, 0), want[1], name="dw")
    if with_bias:
        _close(got[2].numpy(), want[2], name="dbias")


@pytest.mark.parametrize("tile_h,co_block", TILES)
@pytest.mark.parametrize("with_res", [True, False])
def test_conv3x3_fused_matches_jax_kernel(tile_h, co_block, with_res):
    x, k, bias, a, off, res, _ = _inputs(3)
    want = jax_fused_impl(jnp.asarray(x), jnp.asarray(a), jnp.asarray(off),
                          jnp.asarray(k), jnp.asarray(bias),
                          jnp.asarray(res) if with_res else None,
                          tile_h=tile_h, co_block=co_block, interpret=True)
    got = conv3x3_fused_kernel(_nchw(x), _t(a), _t(off), _oihw(k), _t(bias),
                               _nchw(res) if with_res else None)
    _close(_nhwc(got), want)
    assert torch.equal(got, fused_conv_reference(
        _nchw(x), _t(a), _t(off), _oihw(k), _t(bias),
        _nchw(res) if with_res else None))


def test_conv3x3_fused_bf16_matches_jax_kernel():
    """bfloat16: the JAX kernel adds the residual to the float32 sum and
    casts once, the port's twin (the JAX oracle's order) adds it after
    the cast; the limit covers that one rounding."""
    x, k, bias, a, off, res, _ = _inputs(4, h=8, w=8, c_in=32, c_out=16)
    bf = jnp.bfloat16
    jx, jk, jres = (jnp.asarray(v, bf) for v in (x, k, res))
    want = jax_fused_impl(jx, jnp.asarray(a), jnp.asarray(off), jk,
                          jnp.asarray(bias), jres, tile_h=2, co_block=16,
                          interpret=True)
    got = conv3x3_fused_kernel(
        _nchw(np.asarray(jx, np.float32), torch.bfloat16), _t(a), _t(off),
        _oihw(np.asarray(jk, np.float32), torch.bfloat16), _t(bias),
        _nchw(np.asarray(jres, np.float32), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(_nhwc(got), want, "bfloat16")


@pytest.mark.parametrize("with_res", [True, False])
def test_conv3x3_fused_gradients_match_jax(with_res):
    """conv3x3_fused's backward (the conv's gradients, the SiLU and the
    affine, as the JAX VJP differentiates its XLA expression) against the
    JAX custom VJP: dx, da, db, dw, dbias and dresidual."""
    x, k, bias, a, off, res, g = _inputs(5)
    jargs = [jnp.asarray(v) for v in (x, a, off, k, bias)]
    if with_res:
        jargs.append(jnp.asarray(res))

    def f(*args):
        return jax_conv3x3_fused(*args[:5], args[5] if with_res else None,
                                 1, True)

    want_out, vjp = jax.vjp(f, *jargs)
    want = vjp(jnp.asarray(g))
    leaves = [_nchw(x), _t(a), _t(off), _oihw(k), _t(bias)]
    if with_res:
        leaves.append(_nchw(res))
    leaves = [t.requires_grad_(True) for t in leaves]
    out = conv3x3_fused(*leaves[:5], leaves[5] if with_res else None)
    _close(_nhwc(out), want_out)
    got = torch.autograd.grad(out, leaves, _nchw(g))
    _close(_nhwc(got[0]), want[0], name="dx")
    _close(got[1].numpy(), want[1], name="da")
    _close(got[2].numpy(), want[2], name="db")
    _close(got[3].numpy().transpose(2, 3, 1, 0), want[3], name="dw")
    _close(got[4].numpy(), want[4], name="dbias")
    if with_res:
        _close(_nhwc(got[5]), want[5], name="dresidual")


def test_guidance_through_frozen_classifier_takes_no_weight_gradient(
        monkeypatch):
    """Classifier guidance through the fused and im2col conv routes: the
    gradient with respect to the input is the same whether the classifier's
    weights are frozen (as the search freezes them) or not, and with them
    frozen no weight gradient is computed (conv2d_weight would raise)."""
    from autodiffusion_tpu_torch.models import random_init_
    from autodiffusion_tpu_torch.models.unet import EncoderUNetModel
    from autodiffusion_tpu_torch.samplers import classifier_cond_fn

    for k, v in {"ADT_FUSED_NORM": "1", "ADT_IM2COL_CONV": "1",
                 "ADT_FUSED_CONV": "all"}.items():
        monkeypatch.setenv(k, v)
    routes = []
    for name in ("conv3x3", "conv3x3_fused"):
        real = getattr(port_nn, name)
        monkeypatch.setattr(port_nn, name,
                            lambda *a, _n=name, _r=real, **kw:
                            routes.append(_n) or _r(*a, **kw))
    clf = random_init_(EncoderUNetModel(
        image_size=8, in_channels=3, out_channels=10, model_channels=64,
        num_res_blocks=1, attention_ds=(2,), channel_mult=(1, 2),
        num_head_channels=32, use_scale_shift_norm=True,
        resblock_updown=True).eval(), 3)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
    t = torch.tensor([40.0, 700.0])
    y = torch.tensor([2, 7])

    wgrads = []
    real_wgrad = torch.nn.grad.conv2d_weight
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        lambda *a, **kw: wgrads.append(1) or real_wgrad(*a,
                                                                        **kw))
    unfrozen = classifier_cond_fn(clf, y, 1.0)(x, t)
    assert wgrads and {"conv3x3", "conv3x3_fused"} <= set(routes)

    def no_wgrad(*args, **kw):
        raise AssertionError("a weight gradient was computed")

    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", no_wgrad)
    clf.requires_grad_(False)
    frozen = classifier_cond_fn(clf, y, 1.0)(x, t)
    torch.testing.assert_close(frozen, unfrozen, atol=0, rtol=0)


def test_conv3x3_module_routes(monkeypatch):
    """Conv3x3 keeps nn.Conv2d's parameters; ADT_IM2COL_CONV=1 routes its
    forward through conv3x3, with the value of the unrouted conv, and
    ``affine=`` always goes through conv3x3_fused (its caller, ResBlock,
    holds the gate), with the value of the plain twin."""
    calls = []
    for name in ("conv3x3", "conv3x3_fused"):
        real = getattr(port_nn, name)
        monkeypatch.setattr(port_nn, name,
                            lambda *a, _n=name, _r=real: calls.append(_n)
                            or _r(*a))
    torch.manual_seed(0)
    mod = port_nn.Conv3x3(64, 64)
    assert set(mod.state_dict()) == {"weight", "bias"}
    x = torch.randn(2, 64, 5, 4)
    a, off = 1 + 0.3 * torch.randn(2, 64), 0.3 * torch.randn(2, 64)
    res = torch.randn(2, 64, 5, 4)
    monkeypatch.setenv("ADT_IM2COL_CONV", "0")
    with torch.no_grad():
        plain = mod(x)
        assert calls == []
        monkeypatch.setenv("ADT_IM2COL_CONV", "1")
        routed = mod(x)
        fused = mod(x, affine=(a, off), residual=res)
        twin = fused_conv_reference(x, a, off, mod.weight, mod.bias, res)
    assert calls == ["conv3x3", "conv3x3_fused"]
    torch.testing.assert_close(routed, plain, atol=TOL, rtol=TOL)
    torch.testing.assert_close(fused, twin, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="residual"):
        mod(x, residual=res)


def test_gates_read_environment(monkeypatch):
    f32, bf = torch.float32, torch.bfloat16
    monkeypatch.delenv("ADT_IM2COL_CONV", raising=False)
    monkeypatch.delenv("ADT_FUSED_CONV", raising=False)
    # default: off everywhere
    assert not resolve_use_im2col(192, 192, bf)
    assert not resolve_use_fused_conv(192, 192, bf)
    # only "1" turns the im2col conv on, only "all" the fused conv
    monkeypatch.setenv("ADT_IM2COL_CONV", "all")
    monkeypatch.setenv("ADT_FUSED_CONV", "1")
    assert not resolve_use_im2col(192, 192, bf)
    assert not resolve_use_fused_conv(192, 192, bf)
    monkeypatch.setenv("ADT_IM2COL_CONV", "1")
    monkeypatch.setenv("ADT_FUSED_CONV", "all")
    for chans in [(192, 192), (576, 576), (768, 768), (128, 256)]:
        assert resolve_use_im2col(*chans, bf)
        assert resolve_use_fused_conv(*chans, f32)
    # the stem (C_in 3), the output projection (C_out 6), C_in % 8 and
    # other dtypes stay off
    for chans in [(3, 192), (192, 6), (68, 64)]:
        assert not resolve_use_im2col(*chans, bf)
        assert not resolve_use_fused_conv(*chans, bf)
    assert not resolve_use_im2col(64, 64, torch.float16)
    assert not resolve_use_fused_conv(64, 64, torch.float16)
    monkeypatch.setenv("ADT_IM2COL_CONV", "0")
    monkeypatch.setenv("ADT_FUSED_CONV", "0")
    assert not resolve_use_im2col(192, 192, bf)
    assert not resolve_use_fused_conv(192, 192, bf)


def test_cpu_wrappers_run_twins_without_counting():
    reset_launch_counts()
    x, k, bias, a, off, res, _ = _inputs(6)
    conv3x3_im2col(_nchw(x), _oihw(k), _t(bias))
    conv3x3_fused_kernel(_nchw(x), _t(a), _t(off), _oihw(k), _t(bias),
                         _nchw(res))
    assert set(LAUNCHES.values()) == {0}


def test_wrappers_reject_bad_inputs():
    x, w = torch.zeros(2, 16, 4, 4), torch.zeros(8, 16, 3, 3)
    with pytest.raises(ValueError):
        conv3x3_im2col(x, torch.zeros(8, 16, 1, 1))
    with pytest.raises(TypeError):
        conv3x3_im2col(x, w.double())
    with pytest.raises(ValueError):
        conv3x3_im2col(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        conv3x3_fused_kernel(x, torch.zeros(2, 8), torch.zeros(2, 8), w)
