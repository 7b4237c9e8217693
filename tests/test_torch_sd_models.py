"""The PyTorch port's Stable Diffusion towers against the JAX package's, on
the CPU at a tiny size in float32.

Weights go from the port's ``state_dict()`` (CompVis / HF names) through
the JAX package's own converters (convert_sd_unet, convert_vae,
convert_clip_text), inputs are made with numpy from a seed, and JAX runs
on the CPU (its attention is the einsum path there; the port's is the
kernels' plain twins). Tolerances: 3e-4 (atol and rtol) for the UNet and
the VAE (float32 sums over deep conv stacks in another order), 1e-4 for
the SpatialTransformer and the CLIP encoder.

Also: the flax -> port converters round-trip JAX-initialised weights, a
CompVis-layout checkpoint splits and loads with ``strict=True``, and at
the full v1 width the port's names are exactly the keys the JAX
converters read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models import AutoencoderKL as JaxVAE
from autodiffusion_tpu.models import CLIPTextConfig as JaxCLIPConfig
from autodiffusion_tpu.models import CLIPTextEncoder as JaxCLIP
from autodiffusion_tpu.models import SDUNetModel as JaxSDUNet
from autodiffusion_tpu.models.attention import \
    SpatialTransformer as JaxSpatialTransformer
from autodiffusion_tpu.models.clip_text import convert_clip_text
from autodiffusion_tpu.models.sd_convert import (_spatial_transformer,
                                                 convert_sd_unet, convert_vae)
from autodiffusion_tpu_torch.models import (SD_V1_UNET, SD_V1_VAE,
                                            AutoencoderKL, CLIPTextConfig,
                                            CLIPTextEncoder, SDUNetModel,
                                            create_sd_models,
                                            load_sd_checkpoint, random_init_,
                                            split_sd_checkpoint)
from autodiffusion_tpu_torch.models.attention import SpatialTransformer
from autodiffusion_tpu_torch.models.sd_convert import SD_PREFIXES
from autodiffusion_tpu_torch.models.convert import (
    clip_text_state_dict_from_flax, sd_unet_state_dict_from_flax,
    vae_state_dict_from_flax)
from test_torch_package import one_torch_thread  # noqa: F401

TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
                 num_heads=2, transformer_depth=1, context_dim=16)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_at_ds=(2,))
TINY_CLIP = dict(vocab_size=100, width=32, layers=2, heads=2,
                 max_length=16)


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("heads,dim_head,cross", [
    (2, 16, False), (2, 16, True), (1, 40, True), (1, 80, False),
    (2, 12, True)])
def test_spatial_transformer_matches_jax(heads, dim_head, cross):
    """Self- and cross-attention; D = 16 and 40 take the packed kernel's
    twin, 80 the flash forward's, 12 the plain route."""
    ctx_dim = 16 if cross else None
    m = random_init_(SpatialTransformer(32, heads, dim_head, 1, ctx_dim), 0)
    params = _spatial_transformer(
        {f"st.{k}": v for k, v in _np_state(m).items()}, "st", 1)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 6, 6).astype(np.float32)
    ctx = rng.randn(2, 7, 16).astype(np.float32) if cross else None
    with torch.no_grad():
        got = m(torch.from_numpy(x),
                None if ctx is None else torch.from_numpy(ctx)).numpy()
    want = JaxSpatialTransformer(heads=heads, dim_head=dim_head).apply(
        {"params": params}, _nhwc(x),
        None if ctx is None else jnp.asarray(ctx))
    np.testing.assert_allclose(got, _nchw(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("head_kw", [dict(num_heads=2),
                                     dict(num_heads=-1, num_head_channels=16)])
def test_sd_unet_matches_jax(head_kw):
    cfg = dict(TINY_UNET, **head_kw)
    m = random_init_(SDUNetModel(**cfg), 1)
    fm = JaxSDUNet(**{k: v for k, v in cfg.items()})
    params = convert_sd_unet(_np_state(m), fm, prefix="")
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    t = np.array([10.0, 700.0], np.float32)
    ctx = rng.randn(2, 5, 16).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx)).numpy()
    want = fm.apply(params, _nhwc(x), jnp.asarray(t), jnp.asarray(ctx))
    np.testing.assert_allclose(got, _nchw(want), atol=3e-4, rtol=3e-4)


def test_autoencoder_encode_decode_match_jax():
    m = random_init_(AutoencoderKL(**TINY_VAE), 2)
    fm = JaxVAE(**TINY_VAE)
    params = convert_vae(_np_state(m), fm, prefix="")
    x = np.random.RandomState(2).randn(2, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        mean, logvar = m.encode(torch.from_numpy(x))
        dec = m.decode(mean)
    jm, jl = fm.apply(params, _nhwc(x), method=fm.encode)
    jd = fm.apply(params, jm, method=fm.decode)
    for got, want in ((mean, jm), (logvar, jl), (dec, jd)):
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=3e-4,
                                   rtol=3e-4)


def test_clip_text_encoder_matches_jax():
    m = random_init_(CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP)), 3)
    cfg = JaxCLIPConfig(**TINY_CLIP)
    params = convert_clip_text(_np_state(m), cfg)
    ids = np.random.RandomState(3).randint(0, 100, (2, 16)).astype(np.int32)
    with torch.no_grad():
        got = m(torch.from_numpy(ids)).numpy()
    want = JaxCLIP(cfg).apply(params, jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_flax_to_port_converters_round_trip():
    """JAX-initialised weights of the three towers -> the port's state
    dicts (strict loads) -> the same outputs."""
    key = jax.random.key(0)
    rng = np.random.RandomState(4)
    x = rng.randn(1, 4, 8, 8).astype(np.float32)
    t = np.array([500.0], np.float32)
    ctx = rng.randn(1, 5, 16).astype(np.float32)
    fm = JaxSDUNet(**TINY_UNET)
    p = fm.init(key, _nhwc(x), jnp.asarray(t), jnp.asarray(ctx))
    # the zero-initialised output convs would hide a misplaced weight
    p = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(key, a.shape), p)
    m = SDUNetModel(**TINY_UNET)
    m.load_state_dict(sd_unet_state_dict_from_flax(p), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, _nchw(fm.apply(p, _nhwc(x), jnp.asarray(t),
                                                   jnp.asarray(ctx))),
                               atol=3e-4, rtol=3e-4)

    img = rng.randn(1, 3, 16, 16).astype(np.float32)
    fv = JaxVAE(**TINY_VAE)
    pv = fv.init(key, _nhwc(img))
    v = AutoencoderKL(**TINY_VAE)
    v.load_state_dict(vae_state_dict_from_flax(pv), strict=True)
    with torch.no_grad():
        got = v(torch.from_numpy(img))[0].numpy()
    np.testing.assert_allclose(got, _nchw(fv.apply(pv, _nhwc(img))[0]),
                               atol=3e-4, rtol=3e-4)

    ids = rng.randint(0, 100, (2, 16)).astype(np.int32)
    fc = JaxCLIP(JaxCLIPConfig(**TINY_CLIP))
    pc = fc.init(key, jnp.asarray(ids))
    c = CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP))
    c.load_state_dict(clip_text_state_dict_from_flax(pc), strict=True)
    with torch.no_grad():
        got = c(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(fc.apply(pc, jnp.asarray(ids))),
                               atol=1e-4, rtol=1e-4)


def _tiny_towers(seed):
    return (random_init_(SDUNetModel(**TINY_UNET), seed),
            random_init_(AutoencoderKL(**TINY_VAE), seed + 1),
            random_init_(CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP)),
                         seed + 2))


@pytest.mark.parametrize("wrapped", [True, False])
def test_compvis_checkpoint_splits_and_loads_strictly(tmp_path, wrapped):
    """One CompVis-layout state dict (the three prefixes plus keys no tower
    reads) as a .ckpt file, with or without the ``state_dict`` entry."""
    towers = _tiny_towers(5)
    full = {"betas": torch.zeros(3), "model_ema.decay": torch.tensor(0.9)}
    for prefix, tower in zip(SD_PREFIXES.values(), towers):
        full.update({prefix + k: v for k, v in tower.state_dict().items()})
    path = str(tmp_path / "sd.ckpt")
    torch.save({"state_dict": full, "global_step": 1} if wrapped else full,
               path)
    fresh = (SDUNetModel(**TINY_UNET), AutoencoderKL(**TINY_VAE),
             CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP)))
    for module, part, src in zip(fresh, split_sd_checkpoint(
            load_sd_checkpoint(path)), towers):
        module.load_state_dict(part, strict=True)
        for k, v in src.state_dict().items():
            assert torch.equal(module.state_dict()[k], v), k
    with pytest.raises(KeyError, match="first_stage_model"):
        split_sd_checkpoint({"model.diffusion_model.x": torch.zeros(1)})


class _Leaf:
    """A state-dict value that records its key when a converter reads it
    (``_np`` calls ``.detach().cpu().float().numpy()``) and reads as a
    zero-memory view of its shape."""

    def __init__(self, key, shape, read):
        self.key, self.shape, self.read = key, shape, read

    def detach(self):
        self.read.add(self.key)
        return self

    cpu = float = detach

    def numpy(self):
        return np.broadcast_to(np.float32(0), self.shape)


def test_full_width_names_match_the_jax_converters():
    """At the v1 width (on the meta device), the port's parameter names
    are exactly the keys the JAX converters read from a CompVis / HF state
    dict (the CLIP position ids, a buffer the converter skips, aside)."""
    with torch.device("meta"):
        unet, vae, clip = create_sd_models(device="meta")
    for module, convert in (
            (unet, lambda sd: convert_sd_unet(sd, JaxSDUNet(), prefix="")),
            (vae, lambda sd: convert_vae(sd, JaxVAE(**SD_V1_VAE),
                                         prefix="")),
            (clip, lambda sd: convert_clip_text(sd, JaxCLIPConfig()))):
        read = set()
        convert({k: _Leaf(k, tuple(v.shape), read)
                 for k, v in module.state_dict().items()})
        unread = set(module.state_dict()) - read - {
            "text_model.embeddings.position_ids"}
        assert not unread, sorted(unread)[:5]
    assert sum(p.numel() for p in unet.parameters()) == 859520964
    assert SD_V1_UNET["model_channels"] == 320
