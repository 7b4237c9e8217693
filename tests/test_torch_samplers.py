"""DDIM and ancestral sampling of the PyTorch port against the JAX package.

The same seeded inputs (x_T, labels, schedule tables, and for eta > 0 or
ancestral sampling the per-step noise the JAX scan draws) go through both
samplers with tiny models whose weights are carried flax -> port. Both run
float32 on the CPU.

Tolerances: p_mean_variance 1e-6 relative (the same float32 formulas on the
same tables); whole loops 5e-4 absolute, the 2e-4 model tolerance of
tests/test_torch_models.py carried through a few steps (and through the
classifier's gradient when guided).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.samplers import classifier_cond_fn as jax_cond_fn
from autodiffusion_tpu.samplers import ddim_sample_loop as jax_ddim
from autodiffusion_tpu.samplers import p_sample_loop as jax_ancestral
from autodiffusion_tpu.samplers import diffusion as jax_diffusion
from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu.schedules import stack_tables as jax_stack_tables
from autodiffusion_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, unet_state_dict_from_flax)
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.samplers import (ModelMeanType, ModelVarType,
                                              classifier_cond_fn,
                                              ddim_sample_loop,
                                              p_mean_variance, p_sample_loop)
from autodiffusion_tpu_torch.schedules import build_tables, stack_tables
from test_torch_package import one_torch_thread  # noqa: F401

IMG = 8
LOOP_TOL = 5e-4
COMMON = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
              channel_mult=(1, 2), num_head_channels=16,
              use_scale_shift_norm=True, resblock_updown=True)
CANDS = [[57, 412, 803], [120, 333, 901]]


def _random_params(module, seed, *args):
    """Seeded numpy values in the shapes of ``module.init(*args)``."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * std).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name.endswith("['positional_embedding']"):
            return (rng.randn(*leaf.shape)
                    / np.sqrt(leaf.shape[-1])).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(module.init, jax.random.key(0), *args))


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(out_channels=6, num_classes=10,
                 use_new_attention_order=True, **COMMON)
    mp = _random_params(jm, 0, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)),
                        jnp.zeros((1,), jnp.int32))
    pm = UNetModel(in_channels=3, out_channels=6, num_classes=10,
                   use_new_attention_order=True, **COMMON).eval()
    pm.load_state_dict(unet_state_dict_from_flax(mp), strict=True)
    ccfg = dict(COMMON, num_head_channels=32)
    jc = JaxEncoder(out_channels=10, use_new_attention_order=False,
                    pool="attention", **ccfg)
    cp = _random_params(jc, 1, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,)))
    pc = EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                          use_new_attention_order=False, **ccfg).eval()
    pc.load_state_dict(classifier_state_dict_from_flax(cp), strict=True)
    return jm, mp, pm, jc, cp, pc


def _tables(per_sample: bool, batch: int):
    """([K] tables for the batch, or [batch, K] with the two candidates
    folded in), for both packages."""
    if not per_sample:
        return (jax_build_tables(CANDS[0], base_schedule="cosine"),
                build_tables(CANDS[0], base_schedule="cosine"))
    per = batch // len(CANDS)
    jt = jax_stack_tables([jax_build_tables(c, base_schedule="cosine")
                           for c in CANDS])
    jt = jax.tree_util.tree_map(lambda a: jnp.repeat(a, per, axis=0), jt)
    pt = stack_tables([build_tables(c, base_schedule="cosine")
                       for c in CANDS]).map(
        lambda a: a.repeat_interleave(per, dim=0))
    return jt, pt


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _run(models, *, guided, per_sample, eta=0.0, with_jax=True,
         ancestral=False, var_type=ModelVarType.LEARNED_RANGE):
    """(port x_0 NCHW, JAX x_0 NCHW or None). ``ancestral`` runs
    p_sample_loop instead of DDIM; FIXED_LARGE takes the model's first 3
    output channels, as a learn_sigma=False model's."""
    jm, mp, pm, jc, cp, pc = models
    c = 3 if var_type == ModelVarType.FIXED_LARGE else 6
    jvar = getattr(jax_diffusion.ModelVarType, var_type.name)
    b = 4
    rng = np.random.RandomState(7)
    x_t = rng.randn(b, IMG, IMG, 3).astype(np.float32)
    y = np.array([1, 5, 1, 5])
    jt, pt = _tables(per_sample, b)
    key = jax.random.key(11)

    j_cond = p_cond = None
    if guided:
        j_cond = jax_cond_fn(lambda x, t: jc.apply(cp, x, t),
                             jnp.asarray(y), 2.0)
        p_cond = classifier_cond_fn(pc, torch.from_numpy(y), 2.0)

    want = None
    if with_jax:
        jloop, jkw = ((jax_ancestral, {}) if ancestral
                      else (jax_ddim, {"eta": eta}))
        want = _nchw(jax.jit(lambda x: jloop(
            lambda xx, t, i: jm.apply(mp, xx, t, jnp.asarray(y))[..., :c],
            x.shape, jt, rng=key, noise=x, cond_fn=j_cond, var_type=jvar,
            **jkw))(jnp.asarray(x_t)))

    step_noise = None
    if eta or ancestral:
        # the z the JAX scan draws at step i: normal(fold_in(rng, i))
        # after its split of the sampler key
        k_steps, _ = jax.random.split(key)
        step_noise = torch.from_numpy(np.stack([
            _nchw(jax.random.normal(jax.random.fold_in(k_steps, i),
                                    x_t.shape))
            for i in range(pt.num_steps)]))
    y_t = torch.from_numpy(y)
    loop, kw = ((p_sample_loop, {}) if ancestral
                else (ddim_sample_loop, {"eta": eta}))
    got = loop(lambda x, t, i: pm(x, t, y_t)[:, :c], (b, 3, IMG, IMG), pt,
               device="cpu", noise=torch.from_numpy(_nchw(x_t)),
               cond_fn=p_cond, step_noise=step_noise, var_type=var_type,
               **kw)
    return got.numpy(), want


@pytest.mark.parametrize("per_sample", [False, True])
def test_ddim_unguided_matches_jax(models, per_sample):
    got, want = _run(models, guided=False, per_sample=per_sample)
    assert got.dtype == np.float32 and got.shape == (4, 3, IMG, IMG)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL, rtol=0)


@pytest.mark.parametrize("per_sample", [False, True])
def test_ddim_classifier_guided_matches_jax(models, per_sample):
    got, want = _run(models, guided=True, per_sample=per_sample)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL, rtol=0)
    # guidance moved the samples (the comparison is not of two unguided runs)
    plain, _ = _run(models, guided=False, per_sample=per_sample,
                    with_jax=False)
    assert np.abs(got - plain).max() > 1e-3


def test_ddim_eta_with_injected_noise_matches_jax(models):
    got, want = _run(models, guided=False, per_sample=True, eta=0.5)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL, rtol=0)


ANCESTRAL_VARS = [ModelVarType.LEARNED_RANGE, ModelVarType.FIXED_LARGE]


@pytest.mark.parametrize("var_type", ANCESTRAL_VARS,
                         ids=[v.value for v in ANCESTRAL_VARS])
@pytest.mark.parametrize("per_sample", [False, True])
def test_ancestral_unguided_matches_jax(models, var_type, per_sample):
    """p_sample_loop with the z the JAX scan draws at each step
    (normal(fold_in(rng, i))) injected as step_noise."""
    got, want = _run(models, guided=False, per_sample=per_sample,
                     ancestral=True, var_type=var_type)
    assert got.dtype == np.float32 and got.shape == (4, 3, IMG, IMG)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL, rtol=0)


@pytest.mark.parametrize("var_type", ANCESTRAL_VARS,
                         ids=[v.value for v in ANCESTRAL_VARS])
def test_ancestral_classifier_guided_matches_jax(models, var_type):
    """Guidance on the mean (mean + variance * cond_fn), per-sample
    tables."""
    got, want = _run(models, guided=True, per_sample=True, ancestral=True,
                     var_type=var_type)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL, rtol=0)
    plain, _ = _run(models, guided=False, per_sample=True, ancestral=True,
                    var_type=var_type, with_jax=False)
    assert np.abs(got - plain).max() > 1e-3


def test_ancestral_draws_from_the_generator(models):
    """Without injected noise, x_T and every z but step 0's come from the
    generator: the same seed gives the same samples, another seed others."""
    _, _, pm, _, _, _ = models
    tables = build_tables(CANDS[0], base_schedule="cosine")
    y = torch.tensor([1, 5])

    def run(seed):
        return p_sample_loop(lambda x, t, i: pm(x, t, y), (2, 3, IMG, IMG),
                             tables, device="cpu",
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.isfinite(a).all()


def test_classifier_gradient_matches_jax(models):
    _, _, _, jc, cp, pc = models
    rng = np.random.RandomState(3)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    t = np.array([40.0, 700.0], np.float32)
    y = np.array([2, 9])
    want = jax.jit(jax_cond_fn(lambda xx, tt: jc.apply(cp, xx, tt),
                               jnp.asarray(y), 1.5))(jnp.asarray(x),
                                                     jnp.asarray(t))
    got = classifier_cond_fn(pc, torch.from_numpy(y), 1.5)(
        torch.from_numpy(_nchw(x)), torch.from_numpy(t))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), _nchw(want),
                               atol=2e-4 * max(scale, 1.0), rtol=0)


MEAN_VAR = [(m, v) for m in ModelMeanType for v in ModelVarType]


@pytest.mark.parametrize("mean_type,var_type", MEAN_VAR,
                         ids=[f"{m.value}-{v.value}" for m, v in MEAN_VAR])
@pytest.mark.parametrize("per_sample", [False, True])
def test_p_mean_variance_matches_jax(mean_type, var_type, per_sample):
    rng = np.random.RandomState(5)
    b, c = 4, 3
    x = rng.randn(b, 4, 4, c).astype(np.float32)
    learned = var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE)
    out = rng.randn(b, 4, 4, 2 * c if learned else c).astype(np.float32)
    if var_type == ModelVarType.LEARNED:
        out[..., c:] = -np.abs(out[..., c:]) - 3.0    # a log-variance
    jt, pt = _tables(per_sample, b)
    jmean = getattr(jax_diffusion.ModelMeanType, mean_type.name)
    jvar = getattr(jax_diffusion.ModelVarType, var_type.name)
    for i in range(pt.num_steps):
        want = jax_diffusion.p_mean_variance(
            jt, jnp.asarray(out), jnp.asarray(x), i, mean_type=jmean,
            var_type=jvar)
        got = p_mean_variance(pt, torch.from_numpy(_nchw(out)),
                              torch.from_numpy(_nchw(x)), i,
                              mean_type=mean_type, var_type=var_type)
        for g, w in zip(got, want):
            # table-shaped values are [1, 1, 1] or [N, 1, 1, 1] on both
            # sides; image-shaped ones go NHWC -> NCHW
            w = np.asarray(w)
            w = w.transpose(0, 3, 1, 2) if w.ndim == 4 else w
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
