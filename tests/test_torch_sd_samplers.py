"""The port's Stable Diffusion schedule and samplers against the JAX
package's, on the CPU.

sqrt_linear betas and build_sd_tables are float64 numpy on both sides and
must agree to float32 rounding (exact betas, tables to 1e-7 relative).
plms_sample_loop runs the same elementwise stub model on both sides with
the same x_T, K = 1 ... 5, with one schedule and with per-sample [N, K]
tables of folded candidates: 1e-5 (float32 arithmetic in another order).
cfg_eps_fn is exact arithmetic on the same model outputs: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.samplers import cfg_eps_fn as jax_cfg
from autodiffusion_tpu.samplers import plms_sample_loop as jax_plms
from autodiffusion_tpu.schedules import build_sd_tables as jax_sd_tables
from autodiffusion_tpu.schedules import make_beta_schedule as jax_betas
from autodiffusion_tpu.schedules import stack_tables as jax_stack
from autodiffusion_tpu_torch.samplers import cfg_eps_fn, plms_sample_loop
from autodiffusion_tpu_torch.schedules import (build_sd_tables,
                                               make_beta_schedule,
                                               stack_tables)
from test_torch_package import one_torch_thread  # noqa: F401

FIELDS = ("timestep_map", "betas", "alphas_cumprod", "alphas_cumprod_prev",
          "alphas_cumprod_next", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2", "continuous_times")


@pytest.mark.parametrize("kw", [{}, dict(linear_start=0.0015,
                                         linear_end=0.0195)])
def test_sqrt_linear_betas_match_jax(kw):
    np.testing.assert_array_equal(make_beta_schedule("sqrt_linear", 1000, **kw),
                                  jax_betas("sqrt_linear", 1000, **kw))
    assert make_beta_schedule("sqrt_linear", 1000)[0] == pytest.approx(8.5e-4)


def _cands():
    rng = np.random.RandomState(0)
    out = [[94, 834, 217, 944, 574, 354], [0, 500, 999]]
    out += [sorted(rng.choice(1000, k, replace=False).tolist())
            for k in (1, 2, 4, 5, 10)]
    return out


@pytest.mark.parametrize("cand", _cands())
def test_build_sd_tables_match_jax(cand):
    """The published ADM candidate, one with step 0 (the CompVis
    alphas_prev quirk), random ones."""
    got, want = build_sd_tables(cand), jax_sd_tables(cand)
    for f in FIELDS:
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0, err_msg=f)
    # the quirk: alphas_prev[0] is the base process's alpha_bar[0]
    abar0 = 1.0 - make_beta_schedule("sqrt_linear", 1000)[0]
    assert got.alphas_cumprod_prev[0].item() == pytest.approx(abar0, rel=1e-7)


def _stub_eps(x, t, i, lib):
    """An elementwise stub model, the same on both sides."""
    return 0.3 * lib.sin(x) + 0.01 * x * (t / 1000.0).reshape(
        (-1,) + (1,) * (x.ndim - 1)) + 0.05 * i


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("folded", [False, True])
def test_plms_matches_jax(k, folded):
    rng = np.random.RandomState(k)
    shape = (4, 3, 5, 5)
    noise = rng.randn(*shape).astype(np.float32)
    cands = [sorted(rng.choice(1000, k, replace=False).tolist())
             for _ in range(2)]
    if folded:
        tp = stack_tables([build_sd_tables(c) for c in cands]).map(
            lambda a: a.repeat_interleave(2, dim=0))
        tj = jax.tree_util.tree_map(lambda a: jnp.repeat(a, 2, axis=0),
                                    jax_stack([jax_sd_tables(c)
                                               for c in cands]))
    else:
        tp, tj = build_sd_tables(cands[0]), jax_sd_tables(cands[0])
    calls = []

    def port_fn(x, t, i):
        calls.append(i)
        return _stub_eps(x, t, i, torch)

    got = plms_sample_loop(port_fn, shape, tp, noise=torch.from_numpy(noise))
    want = jax_plms(lambda x, t, i: _stub_eps(x, t, i, jnp), shape, tj,
                    rng=jax.random.key(0), noise=jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # K + 1 model calls: the first step calls twice
    assert calls == [k - 1, max(k - 2, 0)] + list(range(k - 2, -1, -1))


def _apply(x2, t2, c2, lib):
    return lib.tanh(x2) * c2.mean(axis=(1, 2)).reshape(-1, 1, 1, 1) \
        + 0.001 * t2.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0]])
def test_cfg_eps_matches_jax(mask):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 2, 2).astype(np.float32)
    t = np.array([5.0, 500.0, 900.0], np.float32)
    ctx = rng.randn(3, 6, 8).astype(np.float32)
    unc = rng.randn(6, 8).astype(np.float32)
    seen = []

    def port_apply(x2, t2, c2):
        seen.append(c2)
        return _apply(x2, t2, c2, torch)

    pm = None if mask is None else torch.tensor(mask)
    guided = cfg_eps_fn(port_apply, torch.from_numpy(ctx),
                        torch.from_numpy(unc), 7.5, prompt_mask=pm)
    jm = None if mask is None else jnp.asarray(mask)
    jguided = jax_cfg(lambda x2, t2, c2: _apply(x2, t2, c2, jnp),
                      jnp.asarray(ctx), jnp.asarray(unc), 7.5, prompt_mask=jm)
    for i in range(3):
        got = guided(torch.from_numpy(x), torch.from_numpy(t), i)
        want = jguided(jnp.asarray(x), jnp.asarray(t), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    # batch order [uncond | cond]: the unconditional context comes first
    np.testing.assert_array_equal(seen[0][:3].numpy(),
                                  np.broadcast_to(unc, (3, 6, 8)))
    np.testing.assert_array_equal(seen[0][3:].numpy(), ctx)


def test_cfg_prompt_mask_needs_the_step_index():
    guided = cfg_eps_fn(lambda x2, t2, c2: x2, torch.zeros(1, 2, 3),
                        torch.zeros(2, 3), 7.5,
                        prompt_mask=torch.ones(4))
    with pytest.raises(ValueError, match="step index"):
        guided(torch.zeros(1, 1), torch.zeros(1))
