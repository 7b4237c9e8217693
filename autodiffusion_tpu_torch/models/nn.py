"""NN primitives shared by the diffusion models (NCHW).

Port of autodiffusion_tpu/models/nn.py (itself guided_diffusion/nn.py).
Parameters are float32; a module computes in the dtype of the activations
it is given, casting its parameters to that dtype where they are used
(flax's ``promote_dtype``). GroupNorm statistics are float32 whatever the
compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["timestep_embedding", "GroupNorm32", "conv2d", "linear",
           "conv1x1", "Upsample", "Downsample"]


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings, [N] -> [N, dim] float32
    ([cos | sin], zero-padded when dim is odd)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def conv2d(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in x's dtype (its float32 parameters cast at use)."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.conv2d(x, mod.weight.to(x.dtype), bias, mod.stride,
                    mod.padding, mod.dilation, mod.groups)


def conv1x1(mod: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-size-1 Conv1d ([B, C, T]) in x's dtype."""
    return F.conv1d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in x's dtype."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), bias)


class GroupNorm32(nn.GroupNorm):
    """32-group GroupNorm with inline FiLM and activation.

    ``forward(x, scale=, shift=, act=)`` is ``act(GN(x) * (1 + scale) +
    shift)``: statistics in float32 with var = max(E[x^2] - E[x]^2, 0) and
    eps 1e-5, the normalised value (times gamma, plus beta) cast back to x's
    dtype, then FiLM and SiLU in that dtype (autodiffusion_tpu
    models/nn.py:60-74,144-165). scale and shift are [B, C]. The parameters
    are nn.GroupNorm's ``weight`` and ``bias``, so guided-diffusion state
    dicts load unchanged."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__(min(num_groups, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.float().reshape(b, g, -1)
        mu = xg.mean(dim=-1, keepdim=True)
        var = ((xg * xg).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        gamma = self.weight.reshape(1, g, -1, 1)
        beta = self.bias.reshape(1, g, -1, 1)
        xg = xg.reshape(b, g, c // g, -1)
        h = (xg - mu[..., None]) * (rstd[..., None] * gamma) + beta
        h = h.reshape(x.shape).to(x.dtype)
        bshape = (b, c) + (1,) * (x.dim() - 2)
        if scale is not None:
            h = h * (1 + scale.reshape(bshape))
        if shift is not None:
            h = h + shift.reshape(bshape)
        if act == "silu":
            h = F.silu(h)
        return h


class Upsample(nn.Module):
    """2x nearest-neighbour upsample with an optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = nn.Conv2d(channels, out_channels or channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return conv2d(self.conv, x) if self.use_conv else x


class Downsample(nn.Module):
    """2x downsample: a stride-2 3x3 conv or a 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = nn.Conv2d(channels, out_channels or channels, 3,
                                stride=2, padding=1)
        elif (out_channels or channels) != channels:
            raise ValueError("an average-pool downsample keeps the channels")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.op, x) if self.use_conv else F.avg_pool2d(x, 2)
