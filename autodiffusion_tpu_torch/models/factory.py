"""Model factories: the canonical ADM-64 flag bundles, the Stable
Diffusion v1 towers and the latent-diffusion (LDM) UNets and first stages.

Port of autodiffusion_tpu/models/factory.py (guided_diffusion/
script_util.py:12-453) plus the v1-inference configuration the JAX CLI
builds its SD models with (models/sd_unet.py:25-44, models/vae.py:280-311,
models/clip_text.py:29-38; configs/stable-diffusion/v1-inference.yaml),
and the LDM models the JAX CLI's ``ldm-sample`` and ``inpaint`` build
(autodiffusion_tpu/cli/main.py:672-694,713-744,806-818; configs/
latent-diffusion/*.yaml).
Factories take an explicit ``device`` and build on ``cuda`` unless asked
for another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .. import compute_dtype, resolve_device
from ..schedules import build_base_tables, build_tables
from .clip_text import CLIPTextConfig, CLIPTextEncoder
from .sd_unet import SDUNetModel
from .unet import EncoderUNetModel, SuperResModel, UNetModel
from .vae import AutoencoderKL, VQModelInterface

__all__ = ["ModelConfig", "ClassifierConfig", "create_model",
           "create_sr_model",
           "create_classifier", "create_tables", "random_init_",
           "parse_channel_mult", "attention_ds", "NUM_CLASSES",
           "SD_V1_UNET", "SD_V1_VAE", "create_sd_models",
           "create_ldm_unet", "create_ldm_first_stage"]

NUM_CLASSES = 1000

# script_util.py:152-166
_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
}


def parse_channel_mult(image_size: int, channel_mult: str = "") -> Tuple[float, ...]:
    if channel_mult:
        return tuple(float(m) if "." in m else int(m) for m in channel_mult.split(","))
    try:
        return _CHANNEL_MULT[image_size]
    except KeyError:
        raise ValueError(f"unsupported image size: {image_size}")


def attention_ds(image_size: int, attention_resolutions: str) -> Tuple[int, ...]:
    """"32,16,8" -> downsample ratios (image_size // res)."""
    return tuple(image_size // int(r)
                 for r in str(attention_resolutions).split(",") if r)


@dataclasses.dataclass
class ModelConfig:
    """model_and_diffusion_defaults (script_util.py:43-72)."""

    image_size: int = 64
    num_channels: int = 128
    num_res_blocks: int = 2
    num_heads: int = 4
    num_heads_upsample: int = -1
    num_head_channels: int = -1
    attention_resolutions: str = "16,8"
    channel_mult: str = ""
    dropout: float = 0.0
    class_cond: bool = False
    use_scale_shift_norm: bool = True
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    learn_sigma: bool = False
    use_bf16: bool = False
    diffusion_steps: int = 1000
    noise_schedule: str = "linear"
    timestep_respacing: str = ""

    @classmethod
    def adm64(cls, **overrides) -> "ModelConfig":
        """The published ADM ImageNet-64 config
        (search_imagenet64_classifier_guidance.sh:1)."""
        base = dict(image_size=64, num_channels=192, num_res_blocks=3,
                    num_head_channels=64, attention_resolutions="32,16,8",
                    class_cond=True, learn_sigma=True, noise_schedule="cosine",
                    resblock_updown=True, use_new_attention_order=True,
                    use_scale_shift_norm=True, dropout=0.1, use_bf16=True)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def lsun256(cls, **overrides) -> "ModelConfig":
        """The LSUN bedroom / cat 256 unconditional config
        (search_lsun_bedroom.sh); guided-diffusion's legacy QKV order."""
        base = dict(image_size=256, num_channels=256, num_res_blocks=2,
                    num_head_channels=64, attention_resolutions="32,16,8",
                    class_cond=False, learn_sigma=True, noise_schedule="linear",
                    resblock_updown=True, use_scale_shift_norm=True,
                    use_bf16=True, dropout=0.1)
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass
class ClassifierConfig:
    """classifier_defaults (script_util.py:27-40)."""

    image_size: int = 64
    classifier_width: int = 128
    classifier_depth: int = 2
    classifier_attention_resolutions: str = "32,16,8"
    classifier_use_scale_shift_norm: bool = True
    classifier_resblock_updown: bool = True
    classifier_pool: str = "attention"
    classifier_use_bf16: bool = False

    @classmethod
    def adm64(cls, **overrides) -> "ClassifierConfig":
        base = dict(image_size=64, classifier_width=128, classifier_depth=4,
                    classifier_use_bf16=True)
        base.update(overrides)
        return cls(**base)


def create_model(cfg: ModelConfig, device=None) -> UNetModel:
    """The UNet of ``cfg`` on ``device`` (cuda by default), in eval mode,
    built (and initialised) on the device itself."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = UNetModel(
            in_channels=3,
            model_channels=cfg.num_channels,
            out_channels=6 if cfg.learn_sigma else 3,
            num_res_blocks=cfg.num_res_blocks,
            attention_ds=attention_ds(cfg.image_size,
                                      cfg.attention_resolutions),
            dropout=cfg.dropout,
            channel_mult=parse_channel_mult(cfg.image_size,
                                            cfg.channel_mult),
            num_classes=NUM_CLASSES if cfg.class_cond else None,
            num_heads=cfg.num_heads,
            num_head_channels=cfg.num_head_channels,
            num_heads_upsample=cfg.num_heads_upsample,
            use_scale_shift_norm=cfg.use_scale_shift_norm,
            resblock_updown=cfg.resblock_updown,
            use_new_attention_order=cfg.use_new_attention_order,
            dtype=compute_dtype(cfg.use_bf16))
    return model.eval()


def create_sr_model(cfg: ModelConfig, large_size: int = 256,
                    small_size: int = 64, device=None) -> SuperResModel:
    """The super-resolution UNet of ``cfg`` at ``large_size`` on
    ``device`` (cuda by default), in eval mode: sr_create_model_and_
    diffusion's model (script_util.py:298-414) as the JAX package's
    ``create_sr_model`` builds it, whose input concatenates the upsampled
    ``small_size`` conditioning (6 input channels). ``num_heads_upsample``
    is not passed on, as in the JAX factory."""
    del small_size  # the model takes any low-res size; kept for the API
    dev = resolve_device(device)
    with torch.device(dev):
        model = SuperResModel(
            in_channels=3,
            model_channels=cfg.num_channels,
            out_channels=6 if cfg.learn_sigma else 3,
            num_res_blocks=cfg.num_res_blocks,
            attention_ds=attention_ds(large_size, cfg.attention_resolutions),
            dropout=cfg.dropout,
            channel_mult=parse_channel_mult(large_size, cfg.channel_mult),
            num_classes=NUM_CLASSES if cfg.class_cond else None,
            num_heads=cfg.num_heads,
            num_head_channels=cfg.num_head_channels,
            use_scale_shift_norm=cfg.use_scale_shift_norm,
            resblock_updown=cfg.resblock_updown,
            use_new_attention_order=cfg.use_new_attention_order,
            dtype=compute_dtype(cfg.use_bf16))
    return model.eval()


def create_classifier(cfg: ClassifierConfig, num_classes: Optional[int] = None,
                      device=None) -> EncoderUNetModel:
    """The noisy classifier of ``cfg`` on ``device`` (cuda by default),
    built on the device itself."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = EncoderUNetModel(
            image_size=cfg.image_size,
            in_channels=3,
            model_channels=cfg.classifier_width,
            out_channels=num_classes or NUM_CLASSES,
            num_res_blocks=cfg.classifier_depth,
            attention_ds=attention_ds(cfg.image_size,
                                      cfg.classifier_attention_resolutions),
            channel_mult=parse_channel_mult(cfg.image_size),
            num_head_channels=64,
            use_scale_shift_norm=cfg.classifier_use_scale_shift_norm,
            resblock_updown=cfg.classifier_resblock_updown,
            use_new_attention_order=False,
            pool=cfg.classifier_pool,
            dtype=compute_dtype(cfg.classifier_use_bf16))
    return model.eval()


# v1-inference.yaml: the UNet (860 M parameters), the KL-f8 autoencoder and
# (CLIPTextConfig's defaults) the ViT-L/14 text tower
SD_V1_UNET = dict(in_channels=4, model_channels=320, out_channels=4,
                  num_res_blocks=2, attention_ds=(1, 2, 4),
                  channel_mult=(1, 2, 4, 4), num_heads=8,
                  transformer_depth=1, context_dim=768)
SD_V1_VAE = dict(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                 attn_at_ds=(), z_channels=4, embed_dim=4)


def create_sd_models(use_bf16: bool = True, device=None
                     ) -> Tuple[SDUNetModel, AutoencoderKL, CLIPTextEncoder]:
    """(UNet, AutoencoderKL, CLIP text encoder) of Stable Diffusion v1 on
    ``device`` (cuda by default), in eval mode, computing in bfloat16
    under ``use_bf16`` (parameters float32)."""
    dev = resolve_device(device)
    dtype = compute_dtype(use_bf16)
    # built on the device itself: a billion parameters' initialisation is
    # seconds on the card and much longer on the host
    with torch.device(dev):
        return (SDUNetModel(**SD_V1_UNET, dtype=dtype).eval(),
                AutoencoderKL(**SD_V1_VAE, dtype=dtype).eval(),
                CLIPTextEncoder(CLIPTextConfig(), dtype=dtype).eval())


def create_ldm_unet(*, in_channels: int, latent_channels: int,
                    num_channels: int, num_res_blocks: int,
                    channel_mult: Sequence[int], attention_ds: Sequence[int],
                    num_head_channels: int, num_classes: int = 0,
                    context_dim: int = 512, use_bf16: bool = True,
                    device=None):
    """An LDM's UNet on ``device`` (cuda by default), in eval mode.
    Unconditional (``num_classes`` 0; the celebahq / ffhq / churches and
    inpainting configs): the ADM ``UNetModel`` with
    ``use_scale_shift_norm``, ``resblock_updown`` and
    ``use_new_attention_order`` off. Class-conditional (cin256-v2,
    cin-ldm-vq-f8): the cross-attention ``SDUNetModel`` at
    ``context_dim``, transformer depth 1, conditioned on a ClassEmbedder
    token. ``in_channels`` is the latent's channels, or 2 latent + 1 for
    inpainting (x, the masked image's latent, the mask); the output is the
    latent's."""
    dev = resolve_device(device)
    dtype = compute_dtype(use_bf16)
    kw = dict(in_channels=in_channels, model_channels=num_channels,
              out_channels=latent_channels, num_res_blocks=num_res_blocks,
              attention_ds=tuple(attention_ds),
              channel_mult=tuple(channel_mult),
              num_head_channels=num_head_channels, dtype=dtype)
    with torch.device(dev):
        if num_classes:
            return SDUNetModel(**kw, transformer_depth=1,
                               context_dim=context_dim).eval()
        return UNetModel(**kw, use_scale_shift_norm=False,
                         resblock_updown=False,
                         use_new_attention_order=False).eval()


def create_ldm_first_stage(first_stage: str, *, ch: int,
                           ch_mult: Sequence[int], num_res_blocks: int,
                           attn_at_ds: Sequence[int], latent_channels: int,
                           embed_dim: int, n_embed: int,
                           use_bf16: bool = True, device=None):
    """An LDM's first stage on ``device`` (cuda by default), in eval mode:
    ``first_stage`` "vq" a VQModelInterface (z_channels the latent's,
    ``embed_dim`` and ``n_embed`` its codebook's), else an AutoencoderKL
    (embed_dim the latent's channels), the JAX CLI's ``_ldm_first_stage``."""
    dev = resolve_device(device)
    dtype = compute_dtype(use_bf16)
    kw = dict(ch=ch, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
              attn_at_ds=tuple(attn_at_ds), z_channels=latent_channels,
              dtype=dtype)
    with torch.device(dev):
        if first_stage == "vq":
            return VQModelInterface(**kw, embed_dim=embed_dim,
                                    n_embed=n_embed).eval()
        return AutoencoderKL(**kw, embed_dim=latent_channels).eval()


def create_tables(cfg: ModelConfig, use_timesteps=None):
    """Schedule tables for a config; ``use_timesteps`` (candidate list or
    "ddimN" string) overrides cfg.timestep_respacing."""
    spec = use_timesteps if use_timesteps is not None else (
        cfg.timestep_respacing or None)
    if spec is None:
        return build_base_tables(cfg.noise_schedule, cfg.diffusion_steps)
    return build_tables(spec, base_schedule=cfg.noise_schedule,
                        base_num_steps=cfg.diffusion_steps)


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Overwrite every parameter with seeded random values: weights
    N(0, 1/fan_in) (so the zero-initialised output convs of a fresh model
    carry signal too), biases N(0, 0.01^2), norm scales 1 + N(0, 0.1^2).
    For runs that need a model at full width without a checkpoint."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            std = 1.0 / math.sqrt(p[0].numel())
            if name.endswith("positional_embedding"):
                std = 1.0 / math.sqrt(p.shape[0])
            vals = torch.randn(p.shape, generator=gen) * std
        elif name.endswith("weight"):
            vals = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
        else:
            vals = 0.01 * torch.randn(p.shape, generator=gen)
        p.copy_(vals.to(p.dtype))
    return module
