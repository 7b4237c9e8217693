"""The port's SD and latent-diffusion generation path against the JAX
package's, on the CPU at a tiny size in float32, and the five commands
(``txt2img``, ``img2img``, ``ldm-sample``, ``inpaint``, ``convert``) run
on the CPU.

Every random draw of the JAX side is made with JAX's keys and injected
into the port (x_T, the per-step z, the posterior draw, the q_sample
noise), as the JAX commands draw them. Tolerances, all stated against the
JAX result:

* DPM-Solver singlestep, adaptive and the model wrapper with an
  elementwise toy model: 1e-5 absolute and relative (the same float32
  formulas; the knots come from a float64 grid here and a float32 one in
  JAX, an ulp apart);
* loops through tiny UNets, VQ / KL first stages: 5e-4 of the output's
  largest |value| (the models' 3e-4 forward tolerance,
  tests/test_torch_sd_models.py, carried through a few steps);
* the inpainting mask resize, the composite's uint8 pixels and the params
  directory's files and trees: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from autodiffusion_tpu.models import AutoencoderKL as JaxVAE
from autodiffusion_tpu.models import ClassEmbedder as JaxClassEmbedder
from autodiffusion_tpu.models import CLIPTextConfig as JaxCLIPConfig
from autodiffusion_tpu.models import CLIPTextEncoder as JaxCLIP
from autodiffusion_tpu.models import SDUNetModel as JaxSDUNet
from autodiffusion_tpu.models import UNetModel as JaxUNet
from autodiffusion_tpu.models import VQModelInterface as JaxVQ
from autodiffusion_tpu.models.clip_text import convert_clip_text
from autodiffusion_tpu.models.convert import convert_unet
from autodiffusion_tpu.models.sd_convert import (convert_sd_unet,
                                                 convert_vae, convert_vq)
from autodiffusion_tpu.models.sd_convert import \
    load_sd_params_dir as jax_load_params_dir
from autodiffusion_tpu.models.sd_convert import \
    save_sd_params_dir as jax_save_params_dir
from autodiffusion_tpu.models.vae import SD_SCALE_FACTOR
from autodiffusion_tpu.samplers import DiscreteNoiseSchedule as JaxSchedule
from autodiffusion_tpu.samplers import ddim_sample_loop as jax_ddim
from autodiffusion_tpu.samplers.diffusion import ModelVarType as JVar
from autodiffusion_tpu.samplers.diffusion import q_sample as jax_q_sample
from autodiffusion_tpu.samplers.dpm_solver import \
    dpm_model_wrapper as jax_wrapper
from autodiffusion_tpu.samplers.dpm_solver import \
    dpm_solver_adaptive_loop as jax_adaptive
from autodiffusion_tpu.samplers.dpm_solver import \
    dpm_solver_singlestep_loop as jax_singlestep
from autodiffusion_tpu.samplers.dpm_solver import \
    singlestep_orders as jax_orders
from autodiffusion_tpu.schedules import build_sd_tables as jax_sd_tables
from autodiffusion_tpu.schedules import make_beta_schedule as jax_betas
from autodiffusion_tpu.schedules.respace import \
    make_ddim_timesteps as jax_ddim_timesteps
from autodiffusion_tpu_torch.cli import main as cli
from autodiffusion_tpu_torch.models import (AutoencoderKL, ClassEmbedder,
                                            CLIPTextConfig, CLIPTextEncoder,
                                            SDUNetModel, VQModelInterface,
                                            create_ldm_first_stage,
                                            create_ldm_unet,
                                            load_sd_params_dir, random_init_,
                                            save_sd_params_dir)
from autodiffusion_tpu_torch.models.convert import flax_tree_from_unet
from autodiffusion_tpu_torch.models.unet import UNetModel
from autodiffusion_tpu_torch.samplers import (DiscreteNoiseSchedule,
                                              ModelVarType, ddim_sample_loop,
                                              dpm_model_wrapper,
                                              dpm_solver_adaptive_loop,
                                              dpm_solver_singlestep_loop,
                                              singlestep_orders)
from autodiffusion_tpu_torch.schedules import (build_sd_tables,
                                               make_beta_schedule,
                                               make_ddim_timesteps)
from autodiffusion_tpu_torch.utils import logger
from test_torch_package import one_torch_thread  # noqa: F401

TOY_TOL = 1e-5
LOOP_REL = 5e-4
LATENT = 3
TINY_VQ = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1, attn_at_ds=(),
               z_channels=LATENT, embed_dim=LATENT, n_embed=64)
TINY_KL = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_at_ds=(2,))
TINY_LDM = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
                channel_mult=(1, 2), num_head_channels=16)
TINY_SD = dict(in_channels=4, model_channels=32, out_channels=4,
               num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
               num_heads=2, transformer_depth=1, context_dim=16)
TINY_CLIP = dict(vocab_size=100, width=16, layers=1, heads=2, max_length=16)
# a KL-f8 VAE, as SD's, for the commands (their latent is H / 8)
TINY_KL8 = dict(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, attn_at_ds=())


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _close_to_scale(got, want, rel=LOOP_REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _schedules():
    betas = make_beta_schedule("sqrt_linear", 1000)
    return (DiscreteNoiseSchedule.from_betas(betas),
            JaxSchedule.from_betas(jax_betas("sqrt_linear", 1000)))


def _toy_eps(x, t, lib):
    """An elementwise stub model, the same on both sides (layout-free)."""
    return 0.4 * lib.tanh(x) + 0.002 * x * t.reshape(
        (-1,) + (1,) * (x.ndim - 1)) - 0.1


# ------------------------------------------------------------ DPM-Solver

def test_singlestep_orders_match_jax():
    for steps in range(1, 13):
        for order in (1, 2, 3):
            assert singlestep_orders(steps, order) == jax_orders(steps, order)
            assert sum(singlestep_orders(steps, order)) == steps


@pytest.mark.parametrize("order,skip,predict_x0,solver", [
    (1, "time_uniform", True, "dpm_solver"),
    (2, "time_uniform", True, "dpm_solver"),
    (3, "time_uniform", True, "dpm_solver"),
    (3, "time_uniform", False, "dpm_solver"),
    (2, "logSNR", True, "taylor"),
    (3, "logSNR", False, "taylor"),
    (3, "time_quadratic", True, "taylor"),
    (2, "time_quadratic", False, "dpm_solver")])
def test_singlestep_loop_matches_jax(order, skip, predict_x0, solver):
    ps, js = _schedules()
    shape = (2, 3, 4, 4)
    noise = np.random.RandomState(order).randn(*shape).astype(np.float32)
    calls = []

    def port_fn(x, t):
        calls.append(t)
        return _toy_eps(x, t, torch)

    kw = dict(steps=7, order=order, skip_type=skip, predict_x0=predict_x0,
              solver_type=solver)
    got = dpm_solver_singlestep_loop(port_fn, shape, ps, device="cpu",
                                     noise=torch.from_numpy(noise), **kw)
    want = jax_singlestep(lambda x, t: _toy_eps(x, t, jnp), shape, js,
                          rng=jax.random.key(0), noise=jnp.asarray(noise),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOY_TOL,
                               rtol=TOY_TOL)
    assert len(calls) == 7                       # NFE == steps


@pytest.mark.parametrize("order,predict_x0", [(2, True), (3, True),
                                              (3, False)])
def test_adaptive_loop_matches_jax(order, predict_x0):
    ps, js = _schedules()
    shape = (2, 3, 4, 4)
    noise = np.random.RandomState(10 + order).randn(*shape) \
        .astype(np.float32)
    got, nfe = dpm_solver_adaptive_loop(
        lambda x, t: _toy_eps(x, t, torch), shape, ps, device="cpu",
        order=order, predict_x0=predict_x0, noise=torch.from_numpy(noise))
    want, jnfe = jax_adaptive(lambda x, t: _toy_eps(x, t, jnp), shape, js,
                              rng=jax.random.key(0), order=order,
                              predict_x0=predict_x0,
                              noise=jnp.asarray(noise))
    assert nfe == int(jnfe) and nfe > 3 * order   # several steps taken
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOY_TOL,
                               rtol=TOY_TOL)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
@pytest.mark.parametrize("guidance", ["uncond", "classifier-free"])
def test_model_wrapper_matches_jax(model_type, guidance):
    """The wrapped eps at per-sample times, the raw model conditional
    (on a [B, 1] context) under classifier-free guidance."""
    ps, js = _schedules()
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 4, 4).astype(np.float32)
    t_model = np.array([10.0, 250.0, 600.0, 990.0], np.float32)
    cond = rng.randn(4, 1).astype(np.float32)
    uncond = np.zeros((4, 1), np.float32)

    def raw(x, t, c=None, lib=torch):
        out = _toy_eps(x, t, lib)
        return out if c is None else out + 0.3 * c.reshape(
            (-1,) + (1,) * (x.ndim - 1))

    kw = dict(model_type=model_type, guidance_type=guidance,
              guidance_scale=3.0)
    if guidance == "classifier-free":
        fn = dpm_model_wrapper(raw, ps, condition=torch.from_numpy(cond),
                               uncond_condition=torch.from_numpy(uncond),
                               **kw)
        jfn = jax_wrapper(lambda a, b, c=None: raw(a, b, c, jnp), js,
                          condition=jnp.asarray(cond),
                          uncond_condition=jnp.asarray(uncond), **kw)
    else:
        fn = dpm_model_wrapper(raw, ps, **kw)
        jfn = jax_wrapper(lambda a, b: raw(a, b, None, jnp), js, **kw)
    got = fn(torch.from_numpy(x), torch.from_numpy(t_model))
    want = jfn(jnp.asarray(x), jnp.asarray(t_model))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOY_TOL,
                               rtol=TOY_TOL)


def test_model_wrapper_classifier_guidance_matches_jax():
    ps, js = _schedules()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 4, 4).astype(np.float32)
    t_model = np.array([100.0, 700.0], np.float32)
    w = rng.randn(3, 4, 4).astype(np.float32)

    def logp(x, t, c, lib):
        wl = torch.from_numpy(w) if lib is torch else jnp.asarray(w)
        return (lib.sin(x) * wl).reshape(x.shape[0], -1).sum(-1) * c

    got = dpm_model_wrapper(
        lambda a, b: _toy_eps(a, b, torch), ps, guidance_type="classifier",
        guidance_scale=2.0, condition=torch.tensor([1.0, -0.5]),
        classifier_fn=lambda a, b, c: logp(a, b, c, torch))(
        torch.from_numpy(x), torch.from_numpy(t_model))
    want = jax_wrapper(
        lambda a, b: _toy_eps(a, b, jnp), js, guidance_type="classifier",
        guidance_scale=2.0, condition=jnp.asarray([1.0, -0.5]),
        classifier_fn=lambda a, b, c: logp(a, b, c, jnp))(
        jnp.asarray(x), jnp.asarray(t_model))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOY_TOL,
                               rtol=TOY_TOL)


# ------------------------------------------------------ img2img, ldm, inpaint

def test_img2img_encode_and_noise_matches_jax():
    """The KL posterior draw, q_sample at index t_enc and DDIM over the
    first t_enc steps, with JAX's draws (cmd_img2img's key splits)."""
    vae = random_init_(AutoencoderKL(**TINY_KL), 2).eval()
    jvae = JaxVAE(**TINY_KL)
    vparams = convert_vae(_np_state(vae), jvae, prefix="")
    x = np.random.RandomState(5).uniform(-1, 1, (1, 3, 16, 16)) \
        .astype(np.float32)
    n, strength, steps = 2, 0.75, [1, 201, 401, 601, 801]
    key = jax.random.key(42)
    mean, logvar = jvae.apply(vparams, _nhwc(x), method=jvae.encode)
    enc_rng, key = jax.random.split(key)
    eps = jax.random.normal(enc_rng, (n,) + mean.shape[1:], mean.dtype)
    z0 = (mean + jnp.exp(0.5 * logvar) * eps) * SD_SCALE_FACTOR
    jt = jax_sd_tables(steps)
    t_enc = max(1, int(strength * jt.num_steps))
    assert t_enc == 3
    sub = jax.tree_util.tree_map(lambda a: a[..., :t_enc], jt)
    noise_rng, key = jax.random.split(key)
    noise = jax.random.normal(noise_rng, z0.shape)
    z_enc = jax_q_sample(jt, z0, jnp.full((n,), min(t_enc, jt.num_steps - 1)),
                         noise)
    want = jax_ddim(lambda a, t, i: _toy_eps(a, t / 1000.0, jnp),
                    z_enc.shape, sub, rng=key, clip_denoised=False,
                    var_type=JVar.FIXED_SMALL, noise=z_enc)
    with torch.no_grad():
        got = cli.img2img_latents(
            lambda a, t, i: _toy_eps(a, t / 1000.0, torch), vae,
            torch.from_numpy(x), build_sd_tables(steps), strength, n,
            posterior_noise=torch.from_numpy(_nchw(eps)),
            noise=torch.from_numpy(_nchw(noise)))
    assert got.shape == (n, 4, 8, 8)
    _close_to_scale(got.numpy(), _nchw(want))


def _jax_ldm_unet(cfg, in_ch, num_classes=0):
    if num_classes:
        return JaxSDUNet(in_channels=in_ch, out_channels=LATENT,
                         transformer_depth=1, context_dim=16, **cfg)
    return JaxUNet(out_channels=LATENT, use_scale_shift_norm=False,
                   resblock_updown=False, use_new_attention_order=False,
                   **cfg)


def _ldm_pair(in_ch, num_classes=0, seed=6):
    m = random_init_(create_ldm_unet(
        in_channels=in_ch, latent_channels=LATENT,
        num_channels=TINY_LDM["model_channels"],
        num_res_blocks=TINY_LDM["num_res_blocks"],
        channel_mult=TINY_LDM["channel_mult"],
        attention_ds=TINY_LDM["attention_ds"],
        num_head_channels=TINY_LDM["num_head_channels"],
        num_classes=num_classes, context_dim=16, use_bf16=False,
        device="cpu"), seed)
    jm = _jax_ldm_unet(TINY_LDM, in_ch, num_classes)
    sd = _np_state(m)
    params = (convert_sd_unet(sd, jm, prefix="") if num_classes
              else convert_unet(sd, jm))
    return m, jm, params


@pytest.mark.parametrize("num_classes", [0, 10])
def test_ldm_sample_ddim_eta1_matches_jax(num_classes):
    """cmd_ldm_sample's DDIM: eta 1 with CompVis's noise at the last step,
    through the unconditional ADM-layout UNet or the class-conditional
    cross-attention UNet on a ClassEmbedder token, then the VQ decode of
    z / scale_factor; x_T and each step's z are JAX's."""
    m, jm, params = _ldm_pair(LATENT, num_classes)
    shape = (2, LATENT, 8, 8)
    steps = [1, 334, 667]
    key = jax.random.key(0)
    x_t = np.random.RandomState(7).randn(*shape).astype(np.float32)
    k_steps, _ = jax.random.split(key)
    step_noise = np.stack([_nchw(jax.random.normal(
        jax.random.fold_in(k_steps, i), (2, 8, 8, LATENT)))
        for i in range(len(steps))])
    if num_classes:
        emb = random_init_(ClassEmbedder(16, num_classes), 8)
        y = np.array([3, 7])
        ctx = emb(torch.from_numpy(y)).detach()
        jctx = JaxClassEmbedder(embed_dim=16, n_classes=num_classes).apply(
            {"params": {"embedding": {"embedding":
                                      _np_state(emb)["embedding.weight"]}}},
            jnp.asarray(y))

        def jfn(x, t, i):
            return jm.apply(params, x, t, jctx)

        def pfn(x, t, i):
            return m(x, t, ctx)
    else:
        def jfn(x, t, i):
            return jm.apply(params, x, t)

        def pfn(x, t, i):
            return m(x, t)
    kw = dict(linear_start=0.0015, linear_end=0.0195)
    want = jax_ddim(jfn, (2, 8, 8, LATENT), jax_sd_tables(steps, **kw),
                    rng=key, eta=1.0, clip_denoised=False,
                    var_type=JVar.FIXED_SMALL, final_step_noise=True,
                    noise=_nhwc(x_t))
    with torch.no_grad():
        got = ddim_sample_loop(pfn, shape, build_sd_tables(steps, **kw),
                               device="cpu", eta=1.0, clip_denoised=False,
                               var_type=ModelVarType.FIXED_SMALL,
                               final_step_noise=True,
                               noise=torch.from_numpy(x_t),
                               step_noise=torch.from_numpy(step_noise))
    _close_to_scale(got.numpy(), _nchw(want))
    fs = random_init_(VQModelInterface(**TINY_VQ), 9).eval()
    jfs = JaxVQ(**TINY_VQ)
    fparams = convert_vq(_np_state(fs), jfs, prefix="")
    scale_factor = 0.5
    with torch.no_grad():
        dec = fs.decode(got / scale_factor)
    jdec = jfs.apply(fparams, _nhwc(got.numpy()) / scale_factor,
                     method=jfs.decode)
    assert dec.shape == (2, 3, 32, 32)
    _close_to_scale(dec.numpy(), _nchw(jdec))


@pytest.mark.parametrize("src,dst", [(16, 4), (20, 5), (18, 5), (10, 10),
                                     (7, 3), (4, 16)])
def test_mask_resize_samples_half_pixel_centres_as_jax(src, dst):
    """``nearest-exact`` is jax.image.resize's "nearest" (16 -> 4 picks
    rows 2, 6, 10, 14); torch's plain ``nearest`` is not."""
    import torch.nn.functional as F

    m = np.random.RandomState(src + dst).rand(src, src + 1) \
        .astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m)[None, :, :, None],
                                       (1, dst, dst + 1, 1), "nearest"))
    got = F.interpolate(torch.from_numpy(m)[None, None], size=(dst, dst + 1),
                        mode="nearest-exact")
    np.testing.assert_array_equal(got[0, 0].numpy(), want[0, :, :, 0])
    if (src, dst) == (16, 4):
        plain = F.interpolate(torch.from_numpy(m)[None, None],
                              size=(dst, dst + 1), mode="nearest")
        assert not np.array_equal(plain[0, 0].numpy(), want[0, :, :, 0])


def _inpaint_pair(size=32):
    """An image and a mask whose edges are not multiples of the VQ-f4
    grid (rows 3-12, columns 5-17 masked)."""
    rng = np.random.RandomState(11)
    img01 = rng.rand(size, size, 3).astype(np.float32)
    mask01 = np.zeros((size, size), np.float32)
    mask01[3:13, 5:18] = 1.0
    return img01, mask01


def test_inpaint_matches_jax():
    """cmd_inpaint's path: the masked image encoded by the VQ first stage,
    the mask resized to the encoder's (rounded-up) grid, DDIM through the
    concat-conditioned UNet (2 latent + 1 input channels) from JAX's x_T,
    the decode cropped and composited outside the mask."""
    img01, mask01 = _inpaint_pair()
    fs = random_init_(VQModelInterface(**TINY_VQ), 12).eval()
    jfs = JaxVQ(**TINY_VQ)
    fparams = convert_vq(_np_state(fs), jfs, prefix="")
    m, jm, params = _ldm_pair(2 * LATENT + 1)
    steps = jax_ddim_timesteps("uniform", 4, 1000)
    np.testing.assert_array_equal(make_ddim_timesteps("uniform", 4, 1000),
                                  steps)
    kw = dict(linear_start=0.0015, linear_end=0.0205)
    # the JAX command's lines
    masked = (1.0 - mask01)[..., None] * img01
    c = jfs.apply(fparams, jnp.asarray(masked * 2.0 - 1.0)[None],
                  method=jfs.encode)
    lh, lw = c.shape[1:3]
    assert (lh, lw) == (8, 8)
    cc = jax.image.resize(jnp.asarray(mask01 * 2.0 - 1.0)[None, :, :, None],
                          (1, lh, lw, 1), method="nearest")
    cond = jnp.concatenate([c, cc], axis=-1)
    x_t = np.random.RandomState(13).randn(1, LATENT, lh, lw) \
        .astype(np.float32)
    z = jax_ddim(lambda x, t, i: jm.apply(params, jnp.concatenate(
        [x, jnp.broadcast_to(cond, x.shape[:1] + cond.shape[1:])], -1), t),
        (1, lh, lw, LATENT), jax_sd_tables(steps, **kw),
        rng=jax.random.key(0), clip_denoised=False,
        var_type=JVar.FIXED_SMALL, noise=_nhwc(x_t))
    pred = jfs.apply(fparams, z, method=jfs.decode)
    pred01 = np.clip((np.asarray(pred[0], np.float32) + 1.0) / 2.0, 0, 1)
    pred01 = pred01[:32, :32]
    want = (((1.0 - mask01)[..., None] * img01
             + mask01[..., None] * pred01) * 255.0 + 0.5).astype(np.uint8)
    # the port's
    with torch.no_grad():
        pcond = cli.inpaint_condition(fs, img01, mask01, "cpu")
        np.testing.assert_array_equal(pcond[0, -1].numpy(),
                                      np.asarray(cc)[0, :, :, 0])
        _close_to_scale(pcond.numpy(), _nchw(cond))
        pz = ddim_sample_loop(
            lambda x, t, i: m(torch.cat(
                [x, pcond.expand(x.shape[0], -1, -1, -1)], 1), t),
            (1, LATENT, lh, lw), build_sd_tables(steps, **kw),
            device="cpu", clip_denoised=False,
            var_type=ModelVarType.FIXED_SMALL, noise=torch.from_numpy(x_t))
        _close_to_scale(pz.numpy(), _nchw(z))
        ppred = fs.decode(pz)[0].numpy()
    assert ppred.shape == (3, 32, 32)
    got = cli.inpaint_composite(ppred, img01, mask01)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    # outside the mask the image itself, exactly; inside within a step of
    # the 8-bit grid of JAX's
    out = mask01 == 0
    np.testing.assert_array_equal(got[out], want[out])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the composite of JAX's own decode is JAX's pixels exactly
    np.testing.assert_array_equal(
        cli.inpaint_composite(np.asarray(pred[0]).transpose(2, 0, 1),
                              img01, mask01), want)


# ---------------------------------------------------------- params directory

def _tiny_towers(seed=20, vae_cfg=TINY_KL):
    return (random_init_(SDUNetModel(**TINY_SD), seed).eval(),
            random_init_(AutoencoderKL(**vae_cfg), seed + 1).eval(),
            random_init_(CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP)),
                         seed + 2).eval())


def test_params_dir_round_trip_between_the_packages(tmp_path):
    """The port's params directory is the JAX package's byte for byte
    (save_sd_params_dir of the converters' trees); each package reads the
    other's, exactly."""
    unet, vae, clip = _tiny_towers()
    ju, jv = JaxSDUNet(**TINY_SD), JaxVAE(**TINY_KL)
    jcfg = JaxCLIPConfig(**TINY_CLIP)
    trees = (convert_sd_unet(_np_state(unet), ju, prefix=""),
             convert_vae(_np_state(vae), jv, prefix=""),
             convert_clip_text(_np_state(clip), jcfg))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_sd_params_dir(port_dir, unet, vae, clip)
    jax_save_params_dir(jax_dir, *trees)
    for name in ("sd_unet", "sd_vae", "sd_clip"):
        with open(os.path.join(port_dir, f"{name}.msgpack"), "rb") as f:
            mine = f.read()
        with open(os.path.join(jax_dir, f"{name}.msgpack"), "rb") as f:
            assert f.read() == mine, name
    loaded = jax_load_params_dir(port_dir, unet=ju, vae=jv,
                                 clip=JaxCLIP(jcfg), clip_config=jcfg)
    for got, want in zip(loaded, trees):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    for module, sd in zip(_tiny_towers(seed=30), load_sd_params_dir(jax_dir)):
        module.load_state_dict(sd, strict=True)
    for module, sd in zip((unet, vae, clip), load_sd_params_dir(jax_dir)):
        for k, v in module.state_dict().items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("updown,scale_shift,classes", [
    (True, True, 10), (False, False, None), (False, True, None)])
def test_adm_unet_tree_matches_convert_unet(updown, scale_shift, classes):
    """``convert --preset adm64 | default``'s tree: the port's walk of its
    UNet equals the JAX package's convert_unet of the same state dict."""
    cfg = dict(model_channels=32, num_res_blocks=2, attention_ds=(2,),
               channel_mult=(1, 2), num_head_channels=16,
               resblock_updown=updown, use_scale_shift_norm=scale_shift,
               num_classes=classes)
    m = random_init_(UNetModel(in_channels=3, out_channels=6, **cfg), 1)
    want = convert_unet(_np_state(m), JaxUNet(out_channels=6, **cfg))
    got = flax_tree_from_unet(m)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)


# ---------------------------------------------------- the commands, on the CPU

def _tok(texts):
    return np.array([[1 + (len(t) + 3 * i) % 90 for i in range(16)]
                     for t in texts])


@pytest.fixture
def tiny_sd(tmp_path, monkeypatch):
    """A CompVis-layout checkpoint of tiny towers; the CLI builds tiny
    towers (the full-width ones are for the card) and a stub tokenizer."""
    from autodiffusion_tpu_torch import models

    unet, vae, clip = _tiny_towers(vae_cfg=TINY_KL8)
    ckpt = str(tmp_path / "tiny.ckpt")
    sd = {}
    for prefix, module in (("model.diffusion_model.", unet),
                           ("first_stage_model.", vae),
                           ("cond_stage_model.transformer.", clip)):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})
    torch.save({"state_dict": sd}, ckpt)

    def create(use_bf16=True, device=None):
        with torch.device(device):
            return (SDUNetModel(**TINY_SD).eval(),
                    AutoencoderKL(**TINY_KL8).eval(),
                    CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP)).eval())

    monkeypatch.setattr(models, "create_sd_models", create)
    monkeypatch.setattr(models.ClipBPETokenizer, "from_files",
                        classmethod(lambda cls, v, m: _tok))
    return ckpt


def _arr(path):
    with np.load(path) as z:
        return z["arr_0"]


def test_txt2img_and_convert_on_cpu(tmp_path, tiny_sd, capsys):
    """PLMS over --timesteps, DDIM with a --prompt_mask, DPM-Solver; then
    ``convert --preset sd`` and the same txt2img from the params directory
    gives the same images as from the checkpoint file."""
    base = ["txt2img", "--device", "cpu", "--H", "32", "--W", "32",
            "--prompt", "a red cube", "--n_samples", "2", "--use_bf16",
            "False", "--clip_vocab", "v", "--clip_merges", "m"]
    runs = {
        "plms": ["--sampler", "plms", "--timesteps", "[51, 401, 751]"],
        "ddim": ["--sampler", "ddim", "--steps", "4", "--prompt_mask",
                 "[1, 0, 1, 1]"],
        "dpm": ["--sampler", "dpm_solver", "--timesteps",
                "[0.3, 1.0, 0.6]"]}
    for name, extra in runs.items():
        out = str(tmp_path / f"{name}.npz")
        assert cli.main(base + ["--ckpt", tiny_sd, "--out", out] + extra) == 0
        imgs = _arr(out)
        assert imgs.shape == (2, 32, 32, 3) and imgs.dtype == np.uint8
        assert imgs.std() > 0
    # --prompt_mask: rejected with dpm_solver and against the schedule
    assert cli.main(base + ["--ckpt", tiny_sd, "--sampler", "dpm_solver",
                            "--prompt_mask", "[1, 1]"]) == 1
    assert cli.main(base + ["--ckpt", tiny_sd, "--steps", "4",
                            "--prompt_mask", "[1, 0]"]) == 1
    assert "schedule has 4 steps" in capsys.readouterr().out
    params = str(tmp_path / "params")
    assert cli.main(["convert", "--device", "cpu", "--preset", "sd",
                     "--torch_path", tiny_sd, "--out", params]) == 0
    assert sorted(os.listdir(params)) == ["sd_clip.msgpack",
                                          "sd_unet.msgpack", "sd_vae.msgpack"]
    out = str(tmp_path / "from_dir.npz")
    assert cli.main(base + ["--ckpt", params, "--out", out]
                    + runs["plms"]) == 0
    np.testing.assert_array_equal(_arr(out), _arr(tmp_path / "plms.npz"))


def test_txt2img_prompts_run_in_batches(tmp_path, tiny_sd):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("one\n\ntwo\nthree\n")
    out = str(tmp_path / "o.npz")
    assert cli.main(["txt2img", "--device", "cpu", "--ckpt", tiny_sd,
                     "--from_file", str(prompts), "--n_samples", "2",
                     "--H", "32", "--W", "32", "--steps", "2",
                     "--use_bf16", "False", "--out", out]) == 0
    assert _arr(out).shape == (3, 32, 32, 3)
    assert cli.main(["txt2img", "--device", "cpu", "--ckpt", tiny_sd]) == 1


def test_img2img_on_cpu(tmp_path, tiny_sd):
    init = str(tmp_path / "init.png")
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 24, 3), dtype=np.uint8)).save(init)
    out = str(tmp_path / "i2i.npz")
    png = str(tmp_path / "pngs")
    assert cli.main(["img2img", "--device", "cpu", "--ckpt", tiny_sd,
                     "--init_img", init, "--prompt", "a boat", "--H", "32",
                     "--W", "32", "--steps", "4", "--strength", "0.5",
                     "--use_bf16", "False", "--out", out,
                     "--save_png_dir", png]) == 0
    assert _arr(out).shape == (2, 32, 32, 3)
    assert sorted(os.listdir(png)) == ["000000.png", "000001.png"]


def _ldm_ckpt(path, in_ch, num_classes=0, first_stage="vq"):
    m = random_init_(create_ldm_unet(
        in_channels=in_ch, latent_channels=LATENT, num_channels=32,
        num_res_blocks=1, channel_mult=(1, 2), attention_ds=(2,),
        num_head_channels=16, num_classes=num_classes, context_dim=16,
        use_bf16=False, device="cpu"), 1)
    fs = random_init_(create_ldm_first_stage(
        first_stage, ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
        attn_at_ds=(), latent_channels=LATENT, embed_dim=LATENT, n_embed=64,
        use_bf16=False, device="cpu"), 2)
    sd = {f"model.diffusion_model.{k}": v for k, v in m.state_dict().items()}
    sd.update({f"first_stage_model.{k}": v
               for k, v in fs.state_dict().items()})
    if num_classes:
        sd["cond_stage_model.embedding.weight"] = torch.randn(
            num_classes + 1, 16)
    torch.save({"state_dict": sd}, path)
    return path


LDM_FLAGS = ["--num_channels", "32", "--num_res_blocks", "1",
             "--channel_mult", "1,2", "--attention_ds", "2",
             "--num_head_channels", "16", "--fs_ch", "32", "--fs_ch_mult",
             "1,2,2", "--fs_num_res_blocks", "1", "--n_embed", "64",
             "--use_bf16", "False", "--device", "cpu", "--steps", "5"]


@pytest.mark.parametrize("num_classes,first_stage", [(0, "vq"), (10, "vq"),
                                                     (0, "kl")])
def test_ldm_sample_on_cpu(tmp_path, num_classes, first_stage):
    ckpt = _ldm_ckpt(str(tmp_path / "ldm.ckpt"), LATENT, num_classes,
                     first_stage)
    out = str(tmp_path / "ldm.npz")
    extra = (["--num_classes", str(num_classes), "--context_dim", "16"]
             if num_classes else [])
    assert cli.main(["ldm-sample", "--ckpt", ckpt, "--latent_size", "8",
                     "--n_samples", "2", "--first_stage", first_stage,
                     "--out", out] + LDM_FLAGS + extra) == 0
    imgs = _arr(out)
    assert imgs.shape == (2, 32, 32, 3) and imgs.std() > 0


def test_inpaint_on_cpu(tmp_path):
    ckpt = _ldm_ckpt(str(tmp_path / "inp.ckpt"), 2 * LATENT + 1)
    img01, mask01 = _inpaint_pair()
    indir = tmp_path / "in"
    indir.mkdir()
    for name in ("a", "b"):
        Image.fromarray((img01 * 255).astype(np.uint8)).save(
            indir / f"{name}.png")
        Image.fromarray((mask01 * 255).astype(np.uint8)).save(
            indir / f"{name}_mask.png")
    outdir = tmp_path / "out"
    flags = LDM_FLAGS
    assert cli.main(["inpaint", "--ckpt", ckpt, "--indir", str(indir),
                     "--outdir", str(outdir)] + flags) == 0
    assert sorted(os.listdir(outdir)) == ["a.png", "b.png"]
    got = np.asarray(Image.open(outdir / "a.png"))
    src = np.asarray(Image.open(indir / "a.png"))
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got[mask01 == 0], src[mask01 == 0])
    assert cli.main(["inpaint", "--ckpt", ckpt, "--indir",
                     str(tmp_path / "empty")] + flags) == 1


def test_convert_adm_preset_matches_convert_unet(tmp_path, monkeypatch):
    """``convert --preset adm64`` writes convert_unet's tree of the .pt,
    byte for byte as ``adt convert`` (ModelConfig.adm64 cut to a tiny
    width here)."""
    from autodiffusion_tpu.cli import main as jax_cli
    from autodiffusion_tpu.models import ModelConfig as JaxModelConfig
    from autodiffusion_tpu_torch.models import ModelConfig, create_model

    small = dict(image_size=32, num_channels=32, num_res_blocks=1,
                 num_head_channels=16, attention_resolutions="16")
    for cls in (ModelConfig, JaxModelConfig):
        orig = cls.adm64.__func__
        monkeypatch.setattr(cls, "adm64", classmethod(
            lambda c, _o=orig, **kw: _o(c, **dict(small, **kw))))
    pt = str(tmp_path / "m.pt")
    torch.save(random_init_(create_model(ModelConfig.adm64(),
                                         device="cpu"), 3).state_dict(), pt)
    mine, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    assert cli.main(["convert", "--device", "cpu", "--torch_path", pt,
                     "--out", mine]) == 0
    assert jax_cli.main(["convert", "--torch_path", pt, "--out",
                         theirs]) == 0
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
