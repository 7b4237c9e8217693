"""Multistep DPM-Solver and the continuous-time search of the PyTorch port
against the JAX package, and the port's ``search-sd --sampler dpm_solver``
on the CPU.

The same seeded x_T and time knots go through both solvers, with a toy
elementwise eps function and with a tiny SD UNet (weights carried port ->
flax) under classifier-free guidance; both run float32 on the CPU.

Tolerances: the noise schedule's marginals 1e-6 relative (the same float32
interpolation); toy loops 1e-5; UNet loops the samplers' LOOP_TOL, 5e-4,
relative (the SD UNet's 3e-4 model tolerance, tests/test_torch_sd_models.py,
carried through a few steps), plus 1e-5 of the output's largest magnitude
absolute: with random weights and guidance 7.5 the x0 predictions reach a
few hundred, and float32 rounding of those reaches an element near 0.
"""

import json
import math
import random as pyrandom

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import SDUNetModel as JaxSDUNet
from autodiffusion_tpu.models.sd_convert import convert_sd_unet
from autodiffusion_tpu.samplers import DiscreteNoiseSchedule as JaxSchedule
from autodiffusion_tpu.samplers import cfg_eps_fn as jax_cfg
from autodiffusion_tpu.samplers import dpm_solver_sample_loop as jax_dpm
from autodiffusion_tpu.samplers import dpm_solver_times as jax_dpm_times
from autodiffusion_tpu.schedules import make_beta_schedule as jax_betas
from autodiffusion_tpu.search import ContinuousTimeSpace as JaxContinuous
from autodiffusion_tpu.search import parse_joint_string as jax_parse_joint
from autodiffusion_tpu.search.sd_pipelines import \
    make_sd_fitness as jax_sd_fitness
from autodiffusion_tpu_torch.fid import FIDStats, synthesize_pt_inception
from autodiffusion_tpu_torch.models import (AutoencoderKL, SDUNetModel,
                                            random_init_)
from autodiffusion_tpu_torch.ops import LAUNCHES, reset_launch_counts
from autodiffusion_tpu_torch.samplers import (DiscreteNoiseSchedule,
                                              cfg_eps_fn,
                                              dpm_solver_sample_loop,
                                              dpm_solver_times)
from autodiffusion_tpu_torch.schedules import make_beta_schedule
from autodiffusion_tpu_torch.search import (ContinuousTimeSpace,
                                            EvolutionSearcher,
                                            make_sd_fitness,
                                            parse_joint_string)
from autodiffusion_tpu_torch.utils import logger
from test_torch_package import one_torch_thread  # noqa: F401

LOOP_TOL = 5e-4
TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
                 num_heads=2, context_dim=16)


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _schedules():
    betas = make_beta_schedule("sqrt_linear", 1000)
    np.testing.assert_array_equal(betas, jax_betas("sqrt_linear", 1000))
    return (DiscreteNoiseSchedule.from_betas(betas),
            JaxSchedule.from_betas(betas))


@pytest.mark.parametrize("per_sample", [False, True])
def test_noise_schedule_matches_jax(per_sample):
    """Marginals and lambda's inverse at knots inside and outside the
    table's range (t below 1/N and above 1 hold the end values)."""
    ps, js = _schedules()
    rng = np.random.RandomState(0)
    t = np.concatenate([[1e-4, 1e-3, 0.5, 1.0, 1.2],
                        rng.uniform(1e-3, 1.0, 11)]).astype(np.float32)
    ts = [t[:8], t[8:]] if per_sample else [t]
    for v in ts:
        pt, jt = torch.from_numpy(v), jnp.asarray(v)
        for name in ("marginal_log_mean_coeff", "marginal_alpha",
                     "marginal_std", "marginal_lambda", "model_input_time"):
            np.testing.assert_allclose(
                getattr(ps, name)(pt).numpy(),
                np.asarray(getattr(js, name)(jt)), rtol=1e-6, atol=1e-6,
                err_msg=name)
        lam = js.marginal_lambda(jt)
        np.testing.assert_allclose(
            ps.inverse_lambda(torch.tensor(np.asarray(lam))).numpy(),
            np.asarray(js.inverse_lambda(lam)), rtol=1e-6, atol=1e-6)
    # a 0-dim time, as a single schedule's knot is
    assert ps.marginal_std(torch.tensor(0.5)).dim() == 0
    np.testing.assert_array_equal(dpm_solver_times(5),
                                  jax_dpm_times(5))


def _toy_eps(x, t, lib):
    """An elementwise stub model, the same on both sides."""
    return 0.4 * lib.tanh(x) + 0.002 * x * t.reshape(
        (-1,) + (1,) * (x.ndim - 1)) - 0.1


def _knots(per_sample, k, rng):
    """Descending [K+1] times, or [4, K+1] with two candidates' vectors
    folded over 4 samples."""
    def one():
        return np.sort(rng.uniform(1e-3, 1.0, k + 1))[::-1]
    if not per_sample:
        return one().astype(np.float32)
    a, b = one(), one()
    return np.stack([a, a, b, b]).astype(np.float32)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("predict_x0", [True, False])
@pytest.mark.parametrize("per_sample", [False, True])
def test_dpm_solver_toy_matches_jax(order, predict_x0, per_sample):
    ps, js = _schedules()
    rng = np.random.RandomState(order + 3 * predict_x0)
    shape = (4, 3, 5, 5)
    noise = rng.randn(*shape).astype(np.float32)
    times = _knots(per_sample, 5, rng)
    calls = []

    def port_fn(x, t):
        calls.append(t)
        return _toy_eps(x, t, torch)

    got = dpm_solver_sample_loop(port_fn, shape, ps, torch.from_numpy(times),
                                 device="cpu", order=order,
                                 predict_x0=predict_x0,
                                 noise=torch.from_numpy(noise))
    want = jax_dpm(lambda x, t: _toy_eps(x, t, jnp), shape, js,
                   jnp.asarray(times), rng=jax.random.key(0), order=order,
                   predict_x0=predict_x0, noise=jnp.asarray(noise))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # K model calls, each at the batch's model input times
    assert len(calls) == 5 and all(c.shape == (4,) for c in calls)


def _tiny_sd_unet():
    m = random_init_(SDUNetModel(**TINY_UNET), 1).eval()
    fm = JaxSDUNet(**TINY_UNET)
    params = convert_sd_unet({k: v.detach().numpy()
                              for k, v in m.state_dict().items()},
                             fm, prefix="")
    return m, fm, params


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("predict_x0", [True, False])
def test_dpm_solver_sd_unet_matches_jax(order, predict_x0):
    """Four steps of a tiny SD UNet under classifier-free guidance (7.5),
    one knot vector per sample (two candidates folded)."""
    m, fm, params = _tiny_sd_unet()
    ps, js = _schedules()
    rng = np.random.RandomState(10 + order)
    shape = (4, 4, 8, 8)
    noise = rng.randn(*shape).astype(np.float32)
    times = _knots(True, 4, rng)
    ctx = rng.randn(4, 5, 16).astype(np.float32)
    unc = rng.randn(5, 16).astype(np.float32)
    got = dpm_solver_sample_loop(
        cfg_eps_fn(m, torch.from_numpy(ctx), torch.from_numpy(unc), 7.5),
        shape, ps, torch.from_numpy(times), device="cpu", order=order,
        predict_x0=predict_x0, noise=torch.from_numpy(noise))
    jguided = jax_cfg(lambda x2, t2, c2: fm.apply(params, x2, t2, c2),
                      jnp.asarray(ctx), jnp.asarray(unc), 7.5)
    want = jax.jit(lambda x: jax_dpm(
        jguided, x.shape, js, jnp.asarray(times), rng=jax.random.key(0),
        order=order, predict_x0=predict_x0, noise=x))(
            jnp.asarray(noise.transpose(0, 2, 3, 1)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOOP_TOL,
                               atol=1e-5 * np.abs(want).max())


def test_dpm_solver_draws_from_the_generator():
    ps, _ = _schedules()
    times = torch.from_numpy(np.linspace(1.0, 1e-3, 4).astype(np.float32))

    def run(seed):
        return dpm_solver_sample_loop(
            lambda x, t: _toy_eps(x, t, torch), (2, 3, 4, 4), ps, times,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="order"):
        dpm_solver_sample_loop(lambda x, t: x, (1, 1), ps, times, order=4)


# ------------------------------------------------------------ search space

def test_continuous_space_draws_the_jax_candidates():
    """random, seed, mutate, and a crossover of parents that share knots
    (a positional mix would duplicate them: the repair must draw the same
    unused knots), from the same random.Random seed."""
    spaces = [cls.uniform_grid(5, grid_size=200, rng=pyrandom.Random(3))
              for cls in (ContinuousTimeSpace, JaxContinuous)]
    assert spaces[0].grid == spaces[1].grid
    for s in spaces:
        assert s.seed() == spaces[1].seed()
    streams = []
    for s in spaces:
        out = [s.random() for _ in range(4)]
        out += [s.mutate(out[0], 0.5), s.mutate(out[1], 1.0)]
        shared = tuple(sorted(out[2][:3] + out[3][3:]))
        assert len(set(shared)) == 5
        for _ in range(6):
            child = s.crossover(out[2], shared)
            assert len(set(child)) == 5
            out.append(child)
        streams.append(out)
    assert streams[0] == streams[1]
    assert all(isinstance(g, float) for c in streams[0] for g in c)


def test_parse_joint_string_matches_jax():
    s = ("{'timesteps': [834, 94, 574], "
         "'skip_layers': [[3, 1], [], [57, 0, 12]]}")
    got = parse_joint_string(s)
    assert got == jax_parse_joint(s)
    # skip lists follow their timesteps into sorted order
    assert got == ((94, 574, 834), ((), (0, 12, 57), (1, 3)))


# ------------------------------------------------------------ SD fitness

def _target(shape_nhwc, t_model, lib):
    """+-1 by a pattern of the sample, the latent element (NHWC) and the
    time. The model sees the batch doubled by guidance, [uncond | cond]:
    both halves get the same target."""
    n = shape_nhwc[0]
    j = (lib.arange(n) % (n // 2)).reshape(n, 1)
    k = lib.arange(int(np.prod(shape_nhwc[1:]))).reshape(1, -1)
    v = lib.sin(0.9 * j + 0.37 * k + 0.011 * t_model.reshape(n, 1))
    return lib.where(v >= 0, 1.0, -1.0).reshape(shape_nhwc)


def _denoiser_eps(x_nhwc, t_model, sched, lib):
    """eps of a stub denoiser whose x0 prediction is exactly _target: the
    last solver step is first order (lower_order_final), so when it ends
    at t = 1e-3 from t >= 0.15 the final latent is 0.95 target plus 0.06 of
    what came before, and its sign is the target's whatever x_T was (the
    packages' RNG streams differ)."""
    t = t_model / 1000.0 + 1.0 / 1000.0
    nd = (slice(None),) + (None,) * 3
    alpha, sigma = sched.marginal_alpha(t)[nd], sched.marginal_std(t)[nd]
    return (x_nhwc - alpha * _target(x_nhwc.shape, t_model, lib)) / sigma


def test_dpm_solver_sd_fitness_matches_jax_with_shared_stubs():
    """make_sd_fitness(sampler="dpm_solver") in both packages with the same
    stub denoiser, a decode that saturates by the latent's sign, and pixel
    features: the same images, so the FIDs agree to the moments' 1e-4."""
    ps, js = _schedules()
    feat, chunk = 8, 2

    class JaxUNet:
        def apply(self, params, x2, t2, c2):
            return _denoiser_eps(x2, t2, js, jnp)

    class JaxVAE:
        decode = None

        def apply(self, params, z, method=None):
            return 1e6 * jnp.repeat(z[..., :3], 2, axis=1).repeat(2, axis=2)

    class PortUNet(torch.nn.Module):
        def forward(self, x2, t2, c2):
            y = _denoiser_eps(x2.permute(0, 2, 3, 1), t2, ps, torch)
            return y.permute(0, 3, 1, 2)

    class PortVAE(torch.nn.Module):
        def decode(self, z):
            return 1e6 * z[:, :3].repeat_interleave(2, 2) \
                .repeat_interleave(2, 3)

    rng = np.random.RandomState(0)
    bank = rng.randn(5, 3, 16).astype(np.float32)
    feats = rng.randint(0, 256, (64, feat)).astype(np.float32)
    ref = FIDStats.from_features(feats)
    kw = dict(ref_stats=ref, num_samples=4, batch_size=2,
              sampler="dpm_solver", latent_hw=4, candidate_chunk=chunk,
              feature_dim=feat)
    cands = [(1e-3, 0.2, 0.5, 0.8, 1.0), (1e-3, 0.3, 0.45, 0.7, 0.9),
             (1e-3, 0.15, 0.4, 0.6, 0.95)]

    jfit = jax_sd_fitness(
        unet=JaxUNet(), unet_params=None, vae=JaxVAE(), vae_params=None,
        context_bank=jnp.asarray(bank), uncond_context=jnp.asarray(bank[0]),
        feature_fn=lambda im: {"pool3": im.astype(jnp.float32).reshape(
            im.shape[0], -1)[:, :feat]}, **kw)
    # the JAX package's host float64 Frechet, as the fitness comparison
    # of tests/test_torch_search.py takes it (its device one is float32)
    jfit._device_frechet = None
    want = jfit(cands)
    got = make_sd_fitness(
        unet=PortUNet(), vae=PortVAE(), context_bank=torch.from_numpy(bank),
        uncond_context=torch.from_numpy(bank[0]),
        feature_fn=lambda im: {"pool3": im.float().reshape(
            im.shape[0], -1)[:, :feat]}, device="cpu", **kw)(cands)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(np.round(got, 6))) == 3


def test_tiny_dpm_solver_search_through_the_python_api(tmp_path):
    """make_sd_fitness(sampler="dpm_solver") with a tiny UNet and VAE under
    the EvolutionSearcher over ContinuousTimeSpace: finite FIDs >= 0 for
    float-knot candidates, no kernel launch on the CPU, and the EA state
    (float candidates) reloads."""
    logger.configure(str(tmp_path))
    unet = random_init_(SDUNetModel(**TINY_UNET), 0).eval()
    vae = random_init_(AutoencoderKL(ch=32, ch_mult=(1, 2),
                                     num_res_blocks=1), 1).eval()
    gen = torch.Generator().manual_seed(2)
    bank = torch.randn(5, 7, 16, generator=gen)
    proj = torch.randn(3, 8, generator=gen)

    def features(imgs):
        x = imgs.float().mean(dim=(1, 2)) / 255.0
        return {"pool3": torch.tanh(x @ proj)}

    fitness = make_sd_fitness(
        unet=unet, vae=vae, context_bank=bank, uncond_context=bank[0] * 0,
        feature_fn=features, ref_stats=FIDStats(np.zeros(8), np.eye(8)),
        num_samples=4, batch_size=2, sampler="dpm_solver", latent_hw=8,
        candidate_chunk=2, feature_dim=8, device="cpu")
    ckpt = str(tmp_path / "ea_state.json")
    searcher = EvolutionSearcher(
        ContinuousTimeSpace.uniform_grid(4), fitness, population_num=4,
        select_num=2, mutation_num=1, crossover_num=1, max_epochs=1,
        checkpoint_path=ckpt)
    reset_launch_counts()
    best, fid = searcher.search()
    fids = list(searcher.vis_dict.values())
    assert len(fids) >= 4 and all(math.isfinite(f) and f >= 0 for f in fids)
    assert len(best) == 4 and all(isinstance(g, float) for g in best)
    assert fid == min(fids) and set(LAUNCHES.values()) == {0}
    again = EvolutionSearcher(ContinuousTimeSpace.uniform_grid(4), fitness)
    again.load(ckpt)
    assert again.vis_dict == searcher.vis_dict


def test_cli_search_sd_dpm_solver_on_cpu(tmp_path, monkeypatch, capsys):
    """``adt-torch search-sd --sampler dpm_solver --device cpu`` with tiny
    towers in place of the checkpoint's (the full-width towers are for the
    card): the EA runs over ContinuousTimeSpace and prints a float-knot
    best candidate."""
    from autodiffusion_tpu_torch.cli import main as cli
    from autodiffusion_tpu_torch.models import (CLIPTextConfig,
                                                CLIPTextEncoder)

    unet = random_init_(SDUNetModel(**TINY_UNET), 0).eval()
    vae = random_init_(AutoencoderKL(ch=32, ch_mult=(1, 2),
                                     num_res_blocks=1), 1).eval()
    clip = random_init_(CLIPTextEncoder(CLIPTextConfig(
        vocab_size=100, width=16, layers=1, heads=2, max_length=16)),
        2).eval()

    def tok(texts):
        return np.array([[1 + (len(t) + i) % 90 for i in range(16)]
                         for t in texts])

    monkeypatch.setattr(cli, "_sd_stack",
                        lambda args, dev: (unet, vae, clip, tok))
    torch.save(synthesize_pt_inception(0), tmp_path / "incep.pth")
    FIDStats(np.zeros(2048), np.eye(2048)).save(str(tmp_path / "ref.npz"))
    with open(tmp_path / "caps.json", "w") as f:
        json.dump({"images": [{"id": i, "file_name": f"{i}.jpg"}
                              for i in range(3)],
                   "annotations": [{"image_id": i, "caption": c}
                                   for i, c in enumerate(["a cat", "a dog",
                                                          "the sea"])]}, f)
    argv = ["search-sd", "--device", "cpu", "--sampler", "dpm_solver",
            "--ckpt", "unused", "--clip_vocab", "unused", "--clip_merges",
            "unused", "--captions", str(tmp_path / "caps.json"),
            "--inception_path", str(tmp_path / "incep.pth"),
            "--ref_stats", str(tmp_path / "ref.npz"),
            "--save_dir", str(tmp_path / "run"), "--H", "64", "--W", "64",
            "--time_step", "2", "--num_samples", "2", "--batch_size", "1",
            "--candidate_chunk", "2", "--population_num", "2",
            "--select_num", "1", "--mutation_num", "1",
            "--crossover_num", "1", "--max_epochs", "1", "--num_prompts",
            "3"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["best"]) == 3 and all(0 < g <= 1 for g in out["best"])
    assert math.isfinite(out["fid"]) and out["fid"] >= 0
