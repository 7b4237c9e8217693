"""The Stable Diffusion latent UNet (openaimodel), NCHW.

Port of autodiffusion_tpu/models/sd_unet.py (ldm/modules/diffusionmodules/
openaimodel.py:413-744) with the v1-inference defaults: model_channels 320,
channel_mult (1, 2, 4, 4), SpatialTransformers with cross-attention over a
768-wide context at downsample ratios 1, 2 and 4, 8 heads (legacy=False,
so dim_head = ch // heads). It reuses the port's ADM ResBlock (the same
topology; use_scale_shift_norm=False here), Upsample and Downsample. The
module tree and parameter names are openaimodel's (``time_embed``,
``input_blocks.{i}.{j}``, ``middle_block``, ``output_blocks``,
``out.{0,2}``), so ``model.diffusion_model.*`` of a CompVis checkpoint
loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .attention import SpatialTransformer
from .nn import Downsample, GroupNorm32, Upsample, conv2d, linear, \
    timestep_embedding
from .unet import ResBlock

__all__ = ["SDUNetModel"]


class SDUNetModel(nn.Module):
    """forward(x [B, in_ch, H, W], timesteps [B], context [B, S,
    context_dim]) -> [B, out_ch, H, W] float32. Computes in ``dtype``; the
    final conv in float32, as the JAX model."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_ds: Sequence[int] = (1, 2, 4),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 8, num_head_channels: int = -1,
                 transformer_depth: int = 1, context_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.context_dim = context_dim
        self.dtype = dtype
        ted = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted),
                                        nn.SiLU(), nn.Linear(ted, ted))

        def res(c_in, c_out):
            return ResBlock(c_in, ted, 0.0, out_channels=c_out,
                            use_scale_shift_norm=False)

        def attn(ch):
            # per-block heads: ch // num_head_channels where that is given
            # (the class-conditional LDM configs), else num_heads
            heads = (ch // num_head_channels if num_head_channels > 0
                     else num_heads)
            return SpatialTransformer(ch, heads, ch // heads,
                                      transformer_depth, context_dim)

        ch = model_channels
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(in_channels, ch, 3, padding=1)])])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = nn.ModuleList([res(ch, mult * model_channels)])
                ch = mult * model_channels
                if ds in attention_ds:
                    blk.append(attn(ch))
                self.input_blocks.append(blk)
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList(
                    [Downsample(ch, True, out_channels=ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                blk = nn.ModuleList([res(ch + chans.pop(),
                                         mult * model_channels)])
                ch = mult * model_channels
                if ds in attention_ds:
                    blk.append(attn(ch))
                if level and i == num_res_blocks:
                    blk.append(Upsample(ch, True, out_channels=ch))
                    ds //= 2
                self.output_blocks.append(blk)
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    @staticmethod
    def _run(blk: nn.ModuleList, h, emb, context):
        for mod in blk:
            if isinstance(mod, ResBlock):
                h = mod(h, emb)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context)
            elif isinstance(mod, nn.Conv2d):
                h = conv2d(mod, h)
            else:
                h = mod(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.model_channels) \
            .to(self.dtype)
        emb = linear(self.time_embed[2],
                     torch.nn.functional.silu(linear(self.time_embed[0], emb)))
        context = context.to(self.dtype)
        h = x.to(self.dtype)
        hs = []
        for blk in self.input_blocks:
            h = self._run(blk, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for blk in self.output_blocks:
            h = self._run(blk, torch.cat([h, hs.pop()], dim=1), emb, context)
        h = self.out[0](h, act="silu")
        return conv2d(self.out[2], h.float())
