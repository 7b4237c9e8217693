"""Fused GroupNorm of the PyTorch port against the JAX package.

The same seeded numpy inputs go through the JAX package's Pallas kernels
(``fused_group_norm(..., interpret=True)``, as tests/test_fused_norm.py
runs them on the CPU) and through the port's wrappers on CPU tensors, which
compute the plain twins of the CUDA kernels. Activations travel as
[B, N, C] (JAX) and [B, C, N] (port).

Tolerances: float32 forward and every gradient 2e-5 (absolute and
relative): both sides compute in float32 on the CPU and differ only in
the order of their sums (the backward's sums run over at most a few
hundred terms here). bfloat16: one rounding of the output, 2^-7 |want|
(one unit in the last place of a bf16 value), since both round the same
float32 value, computed in another order, once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models.nn import GroupNorm32 as JaxGroupNorm32
from autodiffusion_tpu.ops.fused_norm import _fwd_impl as jax_fwd_impl
from autodiffusion_tpu.ops.fused_norm import \
    fused_group_norm as jax_fused_group_norm
from autodiffusion_tpu_torch.models import nn as port_nn
from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
from autodiffusion_tpu_torch.ops.fused_norm import (
    FusedGroupNormFunction, fused_group_norm, fused_norm_available,
    group_norm_bwd, group_norm_bwd_plain, group_norm_fwd,
    group_norm_fwd_plain, group_norm_reference)
from test_torch_package import one_torch_thread  # noqa: F401

TOL = 2e-5
BF16_RTOL = 2.0 ** -7

# (B, N, C): ADM-like channel counts at small token counts, several
# channels per group, one channel per group (C < 32) and N = 2
SHAPES = [(2, 64, 64), (3, 16, 96), (2, 7, 16), (2, 2, 64)]


def _inputs(shape, seed, film=True):
    b, n, c = shape
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, c) * 1.5 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    scale = (0.3 * rng.randn(b, c)).astype(np.float32) if film else None
    shift = (0.3 * rng.randn(b, c)).astype(np.float32) if film else None
    g = rng.randn(b, n, c).astype(np.float32)
    return x, gamma, beta, scale, shift, g


def _jnp(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


def _to_port(a, dtype=torch.float32):
    """[B, N, C] numpy -> [B, C, N] torch."""
    return _t(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)), dtype)


def _from_port(t):
    return t.float().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("film,act", [(True, "silu"), (False, "silu"),
                                      (True, "none"), (False, "none")])
def test_forward_matches_jax_kernel_fp32(shape, film, act):
    x, gamma, beta, scale, shift, _ = _inputs(shape, 0, film)
    want = jax_fused_group_norm(_jnp(x), _jnp(gamma), _jnp(beta),
                                scale=_jnp(scale), shift=_jnp(shift),
                                act=act, interpret=True)
    got = fused_group_norm(_to_port(x), _t(gamma), _t(beta),
                           scale=_t(scale), shift=_t(shift), act=act)
    np.testing.assert_allclose(_from_port(got), np.asarray(want),
                               atol=TOL, rtol=TOL)
    ref = group_norm_reference(_to_port(x), _t(gamma), _t(beta),
                               scale=_t(scale), shift=_t(shift), act=act)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,groups,act", [
    # odd HW: runs of 5 x 35 and 3 x 63 elements start off a 16-byte
    # boundary (the CUDA kernel's scalar heads and tails)
    ((3, 35, 40), 8, "silu"), ((2, 63, 96), 32, "none"),
    # long runs, many channels a group: 64 x 512 and 32 x 1089 elements
    ((2, 512, 256), 4, "silu"), ((1, 1089, 64), 2, "none")])
def test_forward_twin_matches_jax_kernel_with_stats(shape, groups, act):
    """group_norm_fwd_plain (the forward kernel's twin) against the JAX
    forward kernel in interpret mode, y and the per-group mu, rstd it
    saves, float32: 2e-5."""
    x, gamma, beta, scale, shift, _ = _inputs(shape, 7)
    b, _, c = shape
    want_y, want_mu, want_rstd = jax_fwd_impl(
        _jnp(x), _jnp(gamma).reshape(1, c), _jnp(beta).reshape(1, c),
        _jnp(scale), _jnp(shift), groups, 1e-5, act, True)
    y, mu, rstd = group_norm_fwd_plain(_to_port(x), _t(gamma), _t(beta),
                                       _t(scale), _t(shift), groups, 1e-5,
                                       act == "silu")
    np.testing.assert_allclose(_from_port(y), np.asarray(want_y), atol=TOL,
                               rtol=TOL)
    for got, want in ((mu, want_mu), (rstd, want_rstd)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).reshape(b, groups),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("film", [True, False])
def test_gradients_match_jax_kernel_fp32(shape, film):
    """All five cotangents (dx, dgamma, dbeta, dscale, dshift) of the
    port's autograd.Function (the backward kernel's twin) against the JAX
    custom VJP (the Pallas backward kernel in interpret mode)."""
    x, gamma, beta, scale, shift, g = _inputs(shape, 1, film)
    args = [_jnp(x), _jnp(gamma), _jnp(beta), _jnp(scale), _jnp(shift)]

    def f(x_, ga, be, sc, sh):
        return jax_fused_group_norm(x_, ga, be, scale=sc, shift=sh,
                                    act="silu", interpret=True)

    _, vjp = jax.vjp(f, *args)
    want = vjp(_jnp(g))
    leaves = [_to_port(x), _t(gamma), _t(beta), _t(scale), _t(shift)]
    leaves = [None if t is None else t.requires_grad_(True) for t in leaves]
    out = fused_group_norm(leaves[0], leaves[1], leaves[2], scale=leaves[3],
                           shift=leaves[4], act="silu")
    live = [t for t in leaves if t is not None]
    got = dict(zip(("dx", "dgamma", "dbeta", "dscale", "dshift"),
                   torch.autograd.grad(out, live, _to_port(g))))
    np.testing.assert_allclose(_from_port(got.pop("dx")),
                               np.asarray(want[0]), atol=TOL, rtol=TOL)
    for (name, a), b in zip(got.items(), want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 49, 96)])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_frozen_parameters_give_dx_alone(shape, act):
    """The guided samplers' case: x needs a gradient, gamma, beta and the
    FiLM terms do not (a frozen classifier). FusedGroupNormFunction's
    backward then returns the JAX kernel's dx (its custom VJP taken with
    respect to x alone, Pallas in interpret mode), float32 2e-5, and None
    for every other input."""
    x, gamma, beta, scale, shift, g = _inputs(shape, 8)

    def f(x_):
        return jax_fused_group_norm(x_, _jnp(gamma), _jnp(beta),
                                    scale=_jnp(scale), shift=_jnp(shift),
                                    act=act, interpret=True)

    _, vjp = jax.vjp(f, _jnp(x))
    (want,) = vjp(_jnp(g))
    px = _to_port(x).requires_grad_(True)
    out = fused_group_norm(px, _t(gamma), _t(beta), scale=_t(scale),
                           shift=_t(shift), act=act)
    with torch.no_grad():
        grads = out.grad_fn.apply(_to_port(g))
    assert len(grads) == 8 and all(a is None for a in grads[1:])
    np.testing.assert_allclose(_from_port(grads[0]), np.asarray(want),
                               atol=TOL, rtol=TOL)
    (dx,) = torch.autograd.grad(out, px, _to_port(g))
    assert torch.equal(dx, grads[0])


@pytest.mark.parametrize("grad_affine,grad_film", [(True, True), (True, False),
                                                   (False, True),
                                                   (False, False)])
def test_bwd_twin_gives_only_the_gradients_asked_for(grad_affine, grad_film):
    """group_norm_bwd's flags on CPU tensors (the twin): None for what was
    not asked, and what was asked equal to the full call's."""
    x, gamma, beta, scale, shift, g = _inputs((2, 9, 64), 9)
    args = (_to_port(x), _to_port(g), _t(gamma), _t(beta), _t(scale),
            _t(shift))
    _, mu, rstd = group_norm_fwd_plain(args[0], *args[2:], 32, 1e-5, True)
    full = group_norm_bwd(*args, mu, rstd, 32, True)
    got = group_norm_bwd(*args, mu, rstd, 32, True, grad_affine=grad_affine,
                         grad_film=grad_film)
    want = group_norm_bwd_plain(*args, mu, rstd, 32, True,
                                grad_affine=grad_affine, grad_film=grad_film)
    asked = (True, grad_film, grad_film, grad_affine, grad_affine)
    for a, b, f, on in zip(got, want, full, asked):
        if on:
            assert torch.equal(a, b) and torch.equal(a, f)
        else:
            assert a is None and b is None


def test_gradients_match_autograd_of_reference():
    """The backward kernel's twin against autograd of the forward twin."""
    x, gamma, beta, scale, shift, g = _inputs((2, 36, 64), 2)
    leaves = [t.requires_grad_(True) for t in
              (_to_port(x), _t(gamma), _t(beta), _t(scale), _t(shift))]
    twins = [t.detach().clone().requires_grad_(True) for t in leaves]
    got = torch.autograd.grad(FusedGroupNormFunction.apply(
        *leaves, 32, 1e-5, True), leaves, _to_port(g))
    ref = group_norm_reference(twins[0], twins[1], twins[2],
                               scale=twins[3], shift=twins[4])
    want = torch.autograd.grad(ref, twins, _to_port(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_matches_jax_kernel_within_one_rounding(shape):
    x, gamma, beta, scale, shift, g = _inputs(shape, 3)
    bf = jnp.bfloat16
    jx, jsc, jsh, jg = (_jnp(a, bf) for a in (x, scale, shift, g))

    def f(x_, sc, sh):
        return jax_fused_group_norm(x_, _jnp(gamma), _jnp(beta), scale=sc,
                                    shift=sh, act="silu", interpret=True)

    want, vjp = jax.vjp(f, jx, jsc, jsh)
    wdx, wdscale, wdshift = vjp(jg)
    px = _to_port(np.asarray(jx, np.float32), torch.bfloat16)
    psc, psh = (_t(np.asarray(a, np.float32), torch.bfloat16)
                .requires_grad_(True) for a in (jsc, jsh))
    px.requires_grad_(True)
    got = fused_group_norm(px, _t(gamma), _t(beta), scale=psc, shift=psh)
    assert got.dtype == torch.bfloat16
    dx, dscale, dshift = torch.autograd.grad(
        got, (px, psc, psh), _to_port(np.asarray(jg, np.float32),
                                      torch.bfloat16))
    for name, a, b in (("y", _from_port(got.detach()), want),
                       ("dx", _from_port(dx), wdx),
                       ("dscale", dscale.float().numpy(), wdscale),
                       ("dshift", dshift.float().numpy(), wdshift)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


def test_return_affine_matches_jax_fold(monkeypatch):
    """GroupNorm32(return_affine=True): the per-(sample, channel) float32
    (a, b) of the JAX fold, and silu(x a + b) equals the unfolded norm."""
    b_, n, c = 2, 16, 64
    x, gamma, beta, scale, shift, _ = _inputs((b_, n, c), 4)
    xs = x.reshape(b_, 4, 4, c)
    params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(gamma),
                                         "bias": jnp.asarray(beta)}}}
    ja, jb = JaxGroupNorm32().apply(params, jnp.asarray(xs),
                                    scale=jnp.asarray(scale),
                                    shift=jnp.asarray(shift),
                                    return_affine=True)
    monkeypatch.delenv("ADT_FUSED_NORM", raising=False)   # the plain chain
    norm = port_nn.GroupNorm32(c)
    with torch.no_grad():
        norm.weight.copy_(_t(gamma))
        norm.bias.copy_(_t(beta))
    px = _t(np.ascontiguousarray(xs.transpose(0, 3, 1, 2)))
    a, off = norm(px, scale=_t(scale), shift=_t(shift), return_affine=True)
    assert a.dtype == off.dtype == torch.float32 and a.shape == (b_, c)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(off.detach().numpy(), np.asarray(jb),
                               atol=TOL, rtol=TOL)
    folded = torch.nn.functional.silu(px * a[..., None, None]
                                      + off[..., None, None])
    plain = norm(px, scale=_t(scale), shift=_t(shift), act="silu")
    torch.testing.assert_close(folded, plain, atol=1e-5, rtol=1e-5)


def test_groupnorm32_fused_route(monkeypatch):
    """With ADT_FUSED_NORM=1 GroupNorm32 goes through fused_group_norm,
    and in float32 agrees with its default path."""
    calls = []
    real = port_nn.fused_group_norm

    def record(*args, **kw):
        calls.append(kw["act"])
        return real(*args, **kw)

    monkeypatch.setattr(port_nn, "fused_group_norm", record)
    x, gamma, beta, scale, shift, _ = _inputs((2, 16, 64), 5)
    norm = port_nn.GroupNorm32(64)
    with torch.no_grad():
        norm.weight.copy_(_t(gamma))
        norm.bias.copy_(_t(beta))
    px = _to_port(x).reshape(2, 64, 4, 4)
    monkeypatch.delenv("ADT_FUSED_NORM", raising=False)
    plain = norm(px, scale=_t(scale), shift=_t(shift), act="silu")
    assert calls == []
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    fused = norm(px, scale=_t(scale), shift=_t(shift), act="silu")
    assert calls == ["silu"]
    torch.testing.assert_close(fused, plain, atol=TOL, rtol=TOL)


def test_gate_reads_environment(monkeypatch):
    monkeypatch.delenv("ADT_FUSED_NORM", raising=False)
    assert not fused_norm_available((2, 64, 8, 8), 32)
    monkeypatch.setenv("ADT_FUSED_NORM", "0")
    assert not fused_norm_available((2, 64, 8, 8), 32)
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    assert fused_norm_available((2, 64, 8, 8), 32)
    assert fused_norm_available((2, 16, 3), 32)       # groups = C
    assert not fused_norm_available((2, 48, 8, 8), 32)   # 48 % 32
    assert fused_norm_available((2, 64, 1, 1), 32)   # one position a channel


def test_gate_defaults_on_for_cuda_tensors(monkeypatch):
    """GroupNorm32's CUDA path is the fused kernels unless
    ADT_FUSED_NORM=0 (the A/B's off arm); CPU tensors keep the plain
    chain unless ADT_FUSED_NORM=1."""
    monkeypatch.delenv("ADT_FUSED_NORM", raising=False)
    assert fused_norm_available((2, 64, 8, 8), 32, "cuda")
    assert not fused_norm_available((2, 64, 8, 8), 32, "cpu")
    assert not fused_norm_available((2, 48, 8, 8), 32, "cuda")
    monkeypatch.setenv("ADT_FUSED_NORM", "0")
    assert not fused_norm_available((2, 64, 8, 8), 32, "cuda")
    monkeypatch.setenv("ADT_FUSED_NORM", "1")
    assert fused_norm_available((2, 64, 8, 8), 32, "cuda")
    assert fused_norm_available((2, 64, 8, 8), 32, "cpu")


def test_groupnorm32_asks_the_gate_with_its_device(monkeypatch):
    seen = []
    monkeypatch.setattr(port_nn, "fused_norm_available",
                        lambda shape, g, dev: seen.append(dev) or False)
    port_nn.GroupNorm32(64)(torch.randn(2, 64, 4, 4))
    assert seen == ["cpu"]


def test_cpu_wrappers_run_twins_without_counting():
    reset_launch_counts()
    x, gamma, beta, scale, shift, g = _inputs((2, 9, 64), 6)
    args = (_to_port(x), _t(gamma), _t(beta), _t(scale), _t(shift))
    y, mu, rstd = group_norm_fwd(*args, 32, 1e-5, True)
    y2, mu2, rstd2 = group_norm_fwd_plain(*args, 32, 1e-5, True)
    assert torch.equal(y, y2) and torch.equal(mu, mu2) \
        and torch.equal(rstd, rstd2) and mu.shape == (2, 32)
    got = group_norm_bwd(args[0], _to_port(g), *args[1:], mu, rstd, 32, True)
    want = group_norm_bwd_plain(args[0], _to_port(g), *args[1:], mu, rstd,
                                32, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(LAUNCHES.values()) == {0}


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 64, 4)
    g = torch.ones(64)
    with pytest.raises(TypeError):
        group_norm_fwd(x.half(), g, g, None, None, 32, 1e-5, True)
    with pytest.raises(ValueError):
        group_norm_fwd(x, torch.ones(32), g, None, None, 32, 1e-5, True)
    with pytest.raises(ValueError):
        group_norm_fwd(x.to("meta"), g.to("meta"), g.to("meta"), None, None,
                       32, 1e-5, True)
    with pytest.raises(ValueError):
        fused_group_norm(x, g, g, act="relu")
