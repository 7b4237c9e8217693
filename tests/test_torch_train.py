"""The port's training path against the JAX package's, on the CPU.

Tiny models (32 x 32, 32 channels, one res block, attention at 16 and 8;
a one-level-shallower classifier), float32, weights carried over with
``models.convert``, numpy-seeded inputs, and the JAX side's t and noise
injected into the port (JAX draws its noise from keys the test repeats).

Tolerances:
  * losses of a fixed elementwise model: 1e-5 relative + 1e-6 absolute,
    float32 math in other orders; the decoder NLL at t = 0 5e-3 relative
    (the log of a difference of two float32 CDFs near 1e-10);
  * the UNet's losses and metrics 2e-4 relative (the models' forward
    tolerance, tests/test_torch_models.py), its gradients 2e-4 relative +
    2e-4 of the largest |gradient| of the model;
  * parameters after AdamW steps: all but 1e-3 of the elements within
    2e-3 x lr per update, every element within 2.5 x lr per update. Adam
    divides a gradient by its own root mean square, so an element whose
    gradient is float32 noise on both sides (a bias a GroupNorm or the
    softmax removes) moves by +-lr at random; the EMA copies the same;
  * the draws of the t-samplers and the OFA table functions: equal.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.models.convert import convert_classifier, convert_unet
from autodiffusion_tpu.samplers import ModelMeanType as JMean
from autodiffusion_tpu.samplers import ModelVarType as JVar
from autodiffusion_tpu.schedules import build_base_tables as jax_base_tables
from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu.train import losses as jlosses
from autodiffusion_tpu.train import resample as jresample
from autodiffusion_tpu.train.classifier import \
    make_classifier_train_step as jax_classifier_step
from autodiffusion_tpu.train.loop import (
    ofa_random_select_tables_fn as jax_ofa_select)
from autodiffusion_tpu.train.loop import ofa_tables_fn as jax_ofa_tables
from autodiffusion_tpu.train.state import create_train_state as jax_state
from autodiffusion_tpu.train.state import make_train_step as jax_train_step
from autodiffusion_tpu_torch.models.convert import (
    classifier_state_dict_from_flax, unet_state_dict_from_flax)
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.samplers import ModelMeanType, ModelVarType
from autodiffusion_tpu_torch.samplers.diffusion import p_mean_variance
from autodiffusion_tpu_torch.schedules import build_base_tables, build_tables
from autodiffusion_tpu_torch.train import (LossSecondMomentResampler,
                                           UniformSampler, calc_bpd_loop,
                                           create_train_state,
                                           make_classifier_train_step,
                                           make_train_step,
                                           ofa_random_select_tables_fn,
                                           ofa_tables_fn, training_losses)
from test_torch_models import _random_params
from test_torch_package import one_torch_thread  # noqa: F401

IMG = 32
UNET = dict(model_channels=32, num_res_blocks=1, attention_ds=(2, 4),
            channel_mult=(1, 2, 2, 2), num_head_channels=16,
            use_scale_shift_norm=True, resblock_updown=True)
CLASSIFIER = dict(model_channels=32, num_res_blocks=1, attention_ds=(2, 4),
                  channel_mult=(1, 2, 2), num_head_channels=32,
                  use_scale_shift_norm=True, resblock_updown=True)
NUM_CLASSES = 10


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _images(seed, b, size=IMG):
    """Quantised images in [-1, 1] (with exact +-1 pixels, the decoder
    likelihood's edge bins), NCHW float32."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (b, 3, size, size)) / 127.5 - 1).astype(
        np.float32)


# ------------------------------------------------------------------ losses

def _toy_models(learned: bool):
    """The same elementwise function of (x_t, t) in both layouts."""

    def jax_fn(x_t, t):
        a = jnp.tanh(0.7 * x_t + t[:, None, None, None] / 1000.0)
        return jnp.concatenate([a, jnp.tanh(0.3 * x_t - 0.2)], -1) \
            if learned else a

    def port_fn(x_t, t):
        a = torch.tanh(0.7 * x_t + t[:, None, None, None] / 1000.0)
        return torch.cat([a, torch.tanh(0.3 * x_t - 0.2)], 1) \
            if learned else a

    return jax_fn, port_fn


LOSS_CASES = [
    ("learned_range", "epsilon", "mse"),
    ("learned_range", "epsilon", "rescaled_mse"),
    ("learned_range", "start_x", "mse"),
    ("learned_range", "epsilon", "kl"),
    ("fixed_large", "epsilon", "mse"),
    ("fixed_large", "start_x", "mse"),
    ("fixed_large", "epsilon", "rescaled_kl"),
]


@pytest.mark.parametrize("var,mean,loss", LOSS_CASES)
def test_training_losses_match_jax(var, mean, loss):
    x = _images(0, 5, 8)
    noise = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    t = np.array([0, 1, 3, 500, 999])
    jfn, pfn = _toy_models(var.startswith("learned"))
    want = jlosses.training_losses(
        jax_base_tables("cosine", 1000), jfn, _nhwc(x), jnp.asarray(t), None,
        mean_type=JMean(mean), var_type=JVar(var), loss_type=loss,
        noise=_nhwc(noise))
    got = training_losses(
        build_base_tables("cosine", 1000), pfn, torch.from_numpy(x),
        torch.from_numpy(t), mean_type=ModelMeanType(mean),
        var_type=ModelVarType(var), loss_type=loss,
        noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    # the decoder NLL at t = 0 (the first example) takes the log of a
    # difference of two float32 tanh CDFs; where it is ~1e-10 the two
    # packages' tanh roundings move the log by up to 0.3 %
    dec = t == 0
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(g[~dec], w[~dec], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(g[dec], w[dec], rtol=5e-3, err_msg=k)


def test_per_example_index_matches_int_index():
    """p_mean_variance with a [B] step tensor gives, row by row, what an
    int step gives (FIXED_LARGE's step-0 variance included)."""
    tables = build_tables("ddim10", base_schedule="cosine")
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 3, 4, 4).astype(np.float32))
    out = torch.from_numpy(rng.randn(4, 6, 4, 4).astype(np.float32))
    t = torch.tensor([0, 9, 1, 0])
    for var in (ModelVarType.LEARNED_RANGE, ModelVarType.FIXED_LARGE,
                ModelVarType.FIXED_SMALL):
        kw = dict(mean_type=ModelMeanType.EPSILON, var_type=var)
        mo = out if var == ModelVarType.LEARNED_RANGE else out[:, :3]
        batched = p_mean_variance(tables, mo, x, t, **kw)
        for b in range(4):
            single = p_mean_variance(tables, mo[b:b + 1], x[b:b + 1],
                                     int(t[b]), **kw)
            for got, want in zip(batched, single):
                torch.testing.assert_close(
                    got[b:b + 1], want.expand_as(got[b:b + 1]), rtol=0,
                    atol=0)


def test_calc_bpd_loop_matches_jax():
    """The full bound over a 10-step respaced schedule, the per-step noise
    JAX draws (fold_in(key, i)) injected into the port."""
    x = _images(3, 3, 8)
    key = jax.random.key(5)
    jtab = jax_build_tables("ddim10", base_schedule="cosine")
    noise = np.stack([_nchw(jax.random.normal(jax.random.fold_in(key, i),
                                              _nhwc(x).shape))
                      for i in range(10)])
    jfn, pfn = _toy_models(True)
    want = jlosses.calc_bpd_loop(jtab, jfn, _nhwc(x), key)
    got = calc_bpd_loop(build_tables("ddim10", base_schedule="cosine"), pfn,
                        torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    assert got["vb"].shape == (10, 3) and got["total_bpd"].shape == (3,)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ----------------------------------------------------------- UNet gradients

@pytest.fixture(scope="module")
def unet_pair():
    jm = JaxUNet(out_channels=6, num_classes=NUM_CLASSES,
                 use_new_attention_order=True, **UNET)
    params = _random_params(jm, 0, jnp.zeros((1, IMG, IMG, 3)),
                            jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    return jm, params


def _port_unet(params):
    pm = UNetModel(in_channels=3, out_channels=6, num_classes=NUM_CLASSES,
                   use_new_attention_order=True, **UNET)
    pm.load_state_dict(unet_state_dict_from_flax(params), strict=True)
    return pm.train()


def _batch(seed, b):
    rng = np.random.RandomState(seed)
    return (_images(seed, b), rng.randint(0, NUM_CLASSES, b),
            rng.randint(0, 1000, b), (0.5 + rng.rand(b)).astype(np.float32))


def _assert_tree_close(got, want, rtol=2e-4, scale_tol=2e-4, what=""):
    """Leaf by leaf within rtol + scale_tol x the largest |value| of all
    leaves (float32 sums err relative to the magnitudes summed)."""
    lg, tg = jax.tree_util.tree_flatten_with_path(got)
    lw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw
    scale = max(float(np.abs(np.asarray(w)).max()) for w in lw)
    for (path, g), w in zip(lg, lw):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=rtol, atol=scale_tol * scale,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_params_close(got, want, tol, lr_moves):
    """Parameters after AdamW updates: every element within 2.5 x the lr
    of all updates (``lr_moves``; no Adam update moves an element by more
    than about lr), and all but 1e-3 of the model's elements within
    ``tol``. Adam divides each gradient by its own root mean square, so
    where a gradient is float32 noise on both sides (the ResBlock in-conv
    biases before one-channel GroupNorm groups, the attention's key biases
    under the softmax) it moves the element by +-lr at random."""
    lg, tg = jax.tree_util.tree_flatten_with_path(got)
    lw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw
    off, total = 0, 0
    for (path, g), w in zip(lg, lw):
        diff = np.abs(np.asarray(g) - np.asarray(w))
        assert diff.max() <= 2.5 * lr_moves, jax.tree_util.keystr(path)
        off += int((diff > tol).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)


def test_training_loss_gradients_match_jax(unet_pair):
    """The mean weighted loss (LEARNED_RANGE, epsilon, MSE + vb) of the tiny
    UNet: the value and every parameter's gradient against jax.grad's,
    mapped by name. The vb term's detached mean shows here: without it the
    mean head's gradients would differ."""
    jm, params = unet_pair
    x, y, t, w = _batch(1, 4)
    noise = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    tables_j = jax_base_tables("cosine", 1000)

    def jloss(p):
        terms = jlosses.training_losses(
            tables_j, lambda xt, to: jm.apply(p, xt, to, jnp.asarray(y)),
            _nhwc(x), jnp.asarray(t), None, noise=_nhwc(noise))
        return (terms["loss"] * jnp.asarray(w)).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    pm = _port_unet(params)
    terms = training_losses(
        build_base_tables("cosine", 1000),
        lambda xt, to: pm(xt, to, torch.from_numpy(y)), torch.from_numpy(x),
        torch.from_numpy(t), noise=torch.from_numpy(noise))
    loss = (terms["loss"] * torch.from_numpy(w)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=2e-4)
    missing = [n for n, p in pm.named_parameters() if p.grad is None]
    assert not missing, missing
    grads = convert_unet({n: p.grad.numpy() for n, p in pm.named_parameters()},
                         jm)
    _assert_tree_close(grads, want_grads, what="grad ")


# ---------------------------------------------------------- the train step

def test_train_step_matches_jax(unet_pair):
    """Two make_train_step updates, microbatches=2, lr anneal over 4
    steps, weight decay and two EMA rates, against create_train_state +
    make_train_step: the metrics of each step, the parameters and both EMA
    copies after them."""
    jm, params = unet_pair
    lr, anneal = 1e-3, 4
    rates = (0.9, 0.99)
    jstate = jax_state(params, lr=lr, weight_decay=0.05, ema_rates=rates,
                       lr_anneal_steps=anneal)
    jstep = jax.jit(jax_train_step(jm.apply, microbatches=2,
                                   class_cond=True))
    pm = _port_unet(params)
    pstate = create_train_state(pm, lr=lr, weight_decay=0.05,
                                ema_rates=rates, lr_anneal_steps=anneal)
    pstep = make_train_step(pm, microbatches=2, class_cond=True)
    tj, tp = jax_base_tables("cosine", 1000), build_base_tables("cosine",
                                                                1000)
    for k in range(2):
        x, y, t, w = _batch(10 + k, 4)
        key = jax.random.key(k)
        # the JAX step splits its key over the microbatches and draws each
        # microbatch's noise from its key
        noise = np.concatenate([
            _nchw(jax.random.normal(r, (2, IMG, IMG, 3)))
            for r in jax.random.split(key, 2)])
        jstate, jm_metrics = jstep(
            jstate, tj, {"x": _nhwc(x), "y": jnp.asarray(y)},
            jnp.asarray(t), jnp.asarray(w), key)
        _, pm_metrics = pstep(
            pstate, tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.from_numpy(t), torch.from_numpy(w),
            noise=torch.from_numpy(noise))
        assert set(pm_metrics) == set(jm_metrics)
        for name, v in jm_metrics.items():
            np.testing.assert_allclose(pm_metrics[name].numpy(),
                                       np.asarray(v), rtol=2e-4, atol=1e-6,
                                       err_msg=name)
    assert pstate.step == int(jstate.step) == 2
    assert pstate.current_lr() == pytest.approx(lr * (1 - 2 / anneal))
    tol = 2e-3 * lr * 2
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    for got, want in [(convert_unet(sd, jm), jstate.params)] + [
            (convert_unet({n: e.numpy() for n, e in
                           pstate.ema_state_dict(i).items()}, jm),
             jstate.ema_params[i]) for i in range(len(rates))]:
        _assert_params_close(got, want, tol, 2 * lr)
    # the update moved the parameters well beyond the tolerance
    start = convert_unet(_port_unet(params).state_dict(), jm)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(start),
                                jax.tree_util.tree_leaves(jstate.params)))
    assert moved > 100 * tol


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_resume_from_adt_train_files_continues_jax(unet_pair, tmp_path,
                                                   grad_clip):
    """One JAX update (lr anneal over 4, weight decay, EMA, microbatches
    2; optionally optax's clipping), saved by the JAX TrainLoop.save as
    ``adt train`` writes it (model, ema and opt .msgpack); the port
    resumes from the directory, with AdamW's moments and step equal to
    optax's mu, nu and count and the learning rate one step into the
    anneal, and its next update equals JAX's next (the train step's
    tolerances above)."""
    from autodiffusion_tpu.train.loop import TrainLoop as JaxTrainLoop
    from autodiffusion_tpu_torch.train import resume_train_state

    jm, params = unet_pair
    lr, anneal, rates = 1e-3, 4, (0.9,)
    jstate = jax_state(params, lr=lr, weight_decay=0.05, ema_rates=rates,
                       grad_clip=grad_clip, lr_anneal_steps=anneal)
    jstep = jax.jit(jax_train_step(jm.apply, microbatches=2,
                                   class_cond=True))
    tj, tp = jax_base_tables("cosine", 1000), build_base_tables("cosine",
                                                                1000)

    def batch(k):
        x, y, t, w = _batch(20 + k, 4)
        key = jax.random.key(100 + k)
        noise = np.concatenate([
            _nchw(jax.random.normal(r, (2, IMG, IMG, 3)))
            for r in jax.random.split(key, 2)])
        return x, y, t, w, key, noise

    x, y, t, w, key, _ = batch(0)
    jstate, _ = jstep(jstate, tj, {"x": _nhwc(x), "y": jnp.asarray(y)},
                      jnp.asarray(t), jnp.asarray(w), key)
    JaxTrainLoop(state=jstate, step_fn=jstep, data=iter(()), batch_size=4,
                 save_dir=str(tmp_path)).save()
    assert sorted(os.listdir(tmp_path)) == [
        "ema_0.9_000001.msgpack", "model000001.msgpack",
        "opt000001.msgpack"]
    pm = _port_unet(params)
    pstate = create_train_state(pm, lr=lr, weight_decay=0.05,
                                ema_rates=rates, grad_clip=grad_clip,
                                lr_anneal_steps=anneal)
    resume_train_state(pstate, str(tmp_path))
    assert pstate.step == pstate.updates() == 1
    assert pstate.current_lr() == pytest.approx(lr * (1 - 1 / anneal))
    adam = jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
    adam = [n for n in adam if hasattr(n, "mu")][0]
    for field, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = convert_unet({n: pstate.optimizer.state[p][name].numpy()
                            for n, p in pm.named_parameters()}, jm)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
            got, getattr(adam, field))
    x, y, t, w, key, noise = batch(1)
    jstate, jm_metrics = jstep(
        jstate, tj, {"x": _nhwc(x), "y": jnp.asarray(y)}, jnp.asarray(t),
        jnp.asarray(w), key)
    _, pm_metrics = make_train_step(pm, microbatches=2, class_cond=True)(
        pstate, tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(t), torch.from_numpy(w),
        noise=torch.from_numpy(noise))
    for name, v in jm_metrics.items():
        np.testing.assert_allclose(pm_metrics[name].numpy(), np.asarray(v),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    assert pstate.step == int(jstate.step) == 2
    assert pstate.current_lr() == pytest.approx(lr * (1 - 2 / anneal))
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    for got, want in ((convert_unet(sd, jm), jstate.params),
                      (convert_unet({n: e.numpy() for n, e in
                                     pstate.ema_state_dict(0).items()}, jm),
                       jstate.ema_params[0])):
        _assert_params_close(got, want, 2e-3 * lr, lr)


def test_train_step_refuses_a_ragged_microbatch(unet_pair):
    pm = _port_unet(unet_pair[1])
    state = create_train_state(pm)
    x, y, t, w = _batch(0, 3)
    with pytest.raises(ValueError, match="does not divide into 2"):
        make_train_step(pm, microbatches=2, class_cond=True)(
            state, build_base_tables("cosine"),
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.from_numpy(t), torch.from_numpy(w))


def test_global_norm_clipping_matches_optax(unet_pair):
    """grad_clip scales the gradients to the clip norm before AdamW, as
    optax.clip_by_global_norm does: the same parameters after one step."""
    jm, params = unet_pair
    jstate = jax_state(params, lr=1e-3, ema_rates=(), grad_clip=0.01)
    pm = _port_unet(params)
    pstate = create_train_state(pm, lr=1e-3, ema_rates=(), grad_clip=0.01)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.random.RandomState(p.size % 97).randn(
            *p.shape).astype(np.float32)), params)
    jstate = jax.jit(lambda st, g: st.apply_gradients(g))(jstate, grads)
    sd_grads = unet_state_dict_from_flax(grads)
    pstate.apply_gradients([sd_grads[n] for n in pstate.names])
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    _assert_tree_close(convert_unet(sd, jm), jstate.params, rtol=0,
                       scale_tol=2e-6, what="param ")


# -------------------------------------------------------- the classifier

def test_classifier_step_matches_jax():
    """One classifier update (noised inputs): loss, acc@1, acc@5, grad norm
    and the parameters after it."""
    jm = JaxEncoder(out_channels=NUM_CLASSES, use_new_attention_order=False,
                    pool="attention", **CLASSIFIER)
    params = _random_params(jm, 4, jnp.zeros((1, IMG, IMG, 3)),
                            jnp.zeros((1,)))
    pm = EncoderUNetModel(image_size=IMG, in_channels=3,
                          out_channels=NUM_CLASSES,
                          use_new_attention_order=False, **CLASSIFIER)
    pm.load_state_dict(classifier_state_dict_from_flax(params), strict=True)
    pm.train()
    x, y, t, _ = _batch(6, 8)
    key = jax.random.key(3)
    noise = _nchw(jax.random.normal(key, (8, IMG, IMG, 3)))
    lr = 3e-4
    jstate = jax_state(params, lr=lr, weight_decay=0.05, ema_rates=())
    jstate, want = jax.jit(jax_classifier_step(jm.apply))(
        jstate, jax_base_tables("cosine", 1000),
        {"x": _nhwc(x), "y": jnp.asarray(y)}, jnp.asarray(t), key)
    pstate = create_train_state(pm, lr=lr, weight_decay=0.05, ema_rates=())
    _, got = make_classifier_train_step(pm)(
        pstate, build_base_tables("cosine", 1000),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(t), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in ("loss", "grad_norm", "per_example_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, err_msg=k)
    for k in ("acc@1", "acc@5"):
        assert float(got[k]) == float(want[k]), k
    sd = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    _assert_params_close(convert_classifier(sd, jm), jstate.params,
                         2e-3 * lr, lr)


# ------------------------------------------------ t-samplers and OFA tables

def test_resamplers_draw_as_jax():
    for port_cls, jax_cls in ((UniformSampler, jresample.UniformSampler),
                              (LossSecondMomentResampler,
                               jresample.LossSecondMomentResampler)):
        ps, js = port_cls(20), jax_cls(20)
        pr, jr = np.random.RandomState(7), np.random.RandomState(7)
        for k in range(60):
            tp, wp = ps.sample(6, pr)
            tj, wj = js.sample(6, jr)
            np.testing.assert_array_equal(tp, tj)
            np.testing.assert_array_equal(wp, wj)
            losses = np.random.RandomState(k).rand(6) * (1 + tp)
            ps.update_with_local_losses(tp, losses)
            js.update_with_losses(tj, losses)
        np.testing.assert_array_equal(ps.weights(), js.weights())
    # the loss-aware sampler warmed up and left the uniform distribution
    assert ps._warmed_up() and np.ptp(ps.weights()) > 0


@pytest.mark.parametrize("which", ["random_section", "random_select"])
def test_ofa_tables_fns_match_jax(which):
    port_fn, jax_fn = ((ofa_tables_fn, jax_ofa_tables)
                       if which == "random_section"
                       else (ofa_random_select_tables_fn, jax_ofa_select))
    pf, jf = port_fn("cosine", 1000), jax_fn("cosine", 1000)
    pr, jr = random.Random(11), random.Random(11)
    for step in range(4):
        got, want = pf(step, pr), jf(step, jr)
        if which == "random_section":
            got, want = [got], [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.timestep_map.numpy(),
                                          np.asarray(w.timestep_map))
            np.testing.assert_allclose(g.betas.numpy(), np.asarray(w.betas),
                                       rtol=1e-6)
