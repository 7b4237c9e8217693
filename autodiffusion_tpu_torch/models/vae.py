"""AutoencoderKL, the Stable Diffusion first-stage VAE, and the VQ first
stage of the latent-diffusion models (NCHW).

Port of autodiffusion_tpu/models/vae.py (ldm/models/autoencoder.py:285-443
and ldm/modules/diffusionmodules/model.py:368-570): Encoder -> diagonal
Gaussian moments, Decoder, with the CompVis details kept: GroupNorm eps
1e-6, swish, the asymmetric (0, 1, 0, 1) padding of the stride-2
downsample conv, single-head attention blocks with 1x1-conv projections,
the quant / post_quant 1x1 convs, and the 0.18215 latent scale the caller
applies (v1-inference.yaml:17). :class:`VQModelInterface` is the LDM VQ
first stage (autoencoder.py:264-282): the same Encoder without the doubled
moments, and a nearest-codebook :class:`VectorQuantizer` on the way out. Module and parameter names are CompVis's
own (``encoder.down.{l}.block.{i}.norm1``, ``decoder.mid.attn_1.q``,
``decoder.up.{l}.upsample.conv``, ...), so ``first_stage_model.*`` of a
checkpoint loads with ``load_state_dict(strict=True)``.

The ResnetBlocks' GroupNorms and 3x3 convs take the port's kernels as the
ADM ResBlocks do: the fused GroupNorm on CUDA tensors (``ADT_FUSED_NORM=0``
turns it off), and behind their switches ``ADT_IM2COL_CONV=1`` the im2col
conv, ``ADT_FUSED_CONV=all`` the fused norm-act-conv (with the residual in
its epilogue). The attention
blocks' single head (D = 512 at the mid-block) goes to the flash forward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import no_tf32
from ..ops import resolve_use_fused_conv
from ..ops.flash_attention import multihead_attention
from .nn import Conv3x3, GroupNorm32, conv2d

__all__ = ["SD_SCALE_FACTOR", "VAEResnetBlock", "VAEAttnBlock",
           "VAEUpsample", "VAEDownsample", "Encoder", "Decoder",
           "AutoencoderKL", "VectorQuantizer", "VQModelInterface",
           "vae_group_norm"]

SD_SCALE_FACTOR = 0.18215


def vae_group_norm(channels: int) -> GroupNorm32:
    """CompVis Normalize: 32 groups, eps 1e-6."""
    return GroupNorm32(channels, eps=1e-6)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = vae_group_norm(in_channels)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.norm2 = vae_group_norm(out_channels)
        self.conv2 = Conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c_in, c_out = x.shape[1], self.conv1.out_channels
        # the norm-act-conv(-residual) fusion of autodiffusion_tpu
        # models/vae.py:41-69, behind the port's ADT_FUSED_CONV gate
        if resolve_use_fused_conv(c_in, c_out, x.dtype):
            h = self.conv1(x, affine=self.norm1(x, return_affine=True))
        else:
            h = self.conv1(self.norm1(x, act="silu"))
        if c_in != c_out:
            x = conv2d(self.nin_shortcut, x)
        if resolve_use_fused_conv(c_out, c_out, x.dtype):
            return self.conv2(h, affine=self.norm2(h, return_affine=True),
                              residual=x)
        return x + self.conv2(self.norm2(h, act="silu"))


class VAEAttnBlock(nn.Module):
    """Single-head spatial attention with 1x1-conv projections
    (model.py:141-184): the head dim is the channel count (512 at the
    mid-block)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = vae_group_norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (conv2d(m, h).reshape(b, c, hh * ww).transpose(1, 2)
                   for m in (self.q, self.k, self.v))        # [B, HW, C]
        h = multihead_attention(q, k, v, 1)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return x + conv2d(self.proj_out, h)


class VAEDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # torch pads (0, 1, 0, 1), then a stride-2 conv without padding
        return conv2d(self.conv, F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.conv, F.interpolate(x, scale_factor=2,
                                               mode="nearest"))


class _Level(nn.Module):
    """One resolution level: ``block`` and ``attn`` lists, and the
    ``downsample`` (encoder) or ``upsample`` (decoder) of CompVis's names."""

    def __init__(self, blocks, attns, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            setattr(self, resample_name, resample)

    def run(self, h: torch.Tensor) -> torch.Tensor:
        for i, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = VAEResnetBlock(ch)
        self.attn_1 = VAEAttnBlock(ch)
        self.block_2 = VAEResnetBlock(ch)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


def _out_conv(norm: GroupNorm32, conv: nn.Conv2d, h: torch.Tensor):
    """norm_out with swish, then conv_out in float32 (as the JAX model)."""
    return conv2d(conv, norm(h, act="silu").float())


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_at_ds: Sequence[int] = (),
                 in_channels: int = 3, z_channels: int = 4,
                 double_z: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        c, ds = ch, 1
        for level, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(VAEResnetBlock(c, ch * mult))
                c = ch * mult
                if ds in attn_at_ds:
                    attns.append(VAEAttnBlock(c))
            last = level == len(ch_mult) - 1
            self.down.append(_Level(blocks, attns, "downsample",
                                    None if last else VAEDownsample(c)))
            if not last:
                ds *= 2
        self.mid = _Mid(c)
        self.norm_out = vae_group_norm(c)
        # double_z: the moments' mean and log-variance (KL); one latent (VQ)
        self.conv_out = nn.Conv2d(c, (2 if double_z else 1) * z_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d(self.conv_in, x.to(self.dtype))
        for level in self.down:
            h = level.run(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return _out_conv(self.norm_out, self.conv_out, self.mid(h))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_at_ds: Sequence[int] = (),
                 z_channels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, c, 3, padding=1)
        self.mid = _Mid(c)
        levels = []
        ds = 2 ** (len(ch_mult) - 1)
        for level, mult in list(enumerate(ch_mult))[::-1]:
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResnetBlock(c, ch * mult))
                c = ch * mult
                if ds in attn_at_ds:
                    attns.append(VAEAttnBlock(c))
            levels.insert(0, _Level(blocks, attns, "upsample",
                                    VAEUpsample(c) if level else None))
            if level:
                ds //= 2
        self.up = nn.ModuleList(levels)        # up[level], as CompVis
        self.norm_out = vae_group_norm(c)
        self.conv_out = nn.Conv2d(c, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(conv2d(self.conv_in, z.to(self.dtype)))
        for level in reversed(self.up):
            h = level.run(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return _out_conv(self.norm_out, self.conv_out, h)


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar), decode(z) -> x in [-1, 1] (float32
    NCHW); the caller divides z by SD_SCALE_FACTOR. The encoder and decoder
    compute in ``dtype``; quant_conv and post_quant_conv in float32."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_at_ds: Sequence[int] = (),
                 z_channels: int = 4, embed_dim: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, attn_at_ds,
                               out_ch, z_channels, dtype)
        self.decoder = Decoder(ch, out_ch, ch_mult, num_res_blocks,
                               attn_at_ds, z_channels, dtype)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = conv2d(self.quant_conv, self.encoder(x).float())
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(conv2d(self.post_quant_conv, z.float()))

    def forward(self, x: torch.Tensor):
        mean, logvar = self.encode(x)
        return self.decode(mean), mean, logvar


class VectorQuantizer(nn.Module):
    """Nearest-codebook lookup, the inference path of taming's
    VectorQuantizer2 (autoencoder.py:6,39-41): the argmin over squared
    distances |z|^2 + |e|^2 - 2 z e^T to the embedding rows, in float32
    with TF32 off (a rounded product flips codes), then the row itself, in
    z's dtype. ``embedding.weight`` is CompVis's
    ``quantize.embedding.weight``."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def codes(self, z: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> the [B, H, W] codebook indices."""
        b, c, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, c).float()
        emb = self.embedding.weight.float()
        with no_tf32():
            d = ((flat * flat).sum(-1, keepdim=True) + (emb * emb).sum(-1)
                 - 2.0 * flat @ emb.T)
        return d.argmin(-1).reshape(b, h, w)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        q = self.embedding.weight.float()[self.codes(z)]       # [B, H, W, C]
        return q.permute(0, 3, 1, 2).to(z.dtype)


class VQModelInterface(nn.Module):
    """The VQ first stage of the LDM configs (vq-f4 / vq-f8: celebahq-,
    ffhq-, lsun_bedrooms-ldm-vq-4, cin-ldm-vq-f8, inpainting_big):
    encode(x) is the pre-quantization latent (Encoder + quant_conv, as
    ldm's VQModelInterface returns it), decode(h) quantizes it (unless
    ``force_not_quantize``), then post_quant_conv and the Decoder, to x in
    [-1, 1] (float32 NCHW). The encoder and decoder compute in ``dtype``;
    quant_conv, post_quant_conv and the quantizer in float32."""

    def __init__(self, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 attn_at_ds: Sequence[int] = (), z_channels: int = 3,
                 embed_dim: int = 3, n_embed: int = 8192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, attn_at_ds,
                               out_ch, z_channels, double_z=False,
                               dtype=dtype)
        self.decoder = Decoder(ch, out_ch, ch_mult, num_res_blocks,
                               attn_at_ds, z_channels, dtype)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = nn.Conv2d(z_channels, embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.quant_conv, self.encoder(x).float())

    def decode(self, h: torch.Tensor,
               force_not_quantize: bool = False) -> torch.Tensor:
        h = h.float()
        quant = h if force_not_quantize else self.quantize(h)
        return self.decoder(conv2d(self.post_quant_conv, quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
