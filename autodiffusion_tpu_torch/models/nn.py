"""NN primitives shared by the diffusion models.

Port of autodiffusion_tpu/models/nn.py (itself guided_diffusion/nn.py).
Parameters are float32; a module computes in the dtype of the activations
it is given, casting its parameters to that dtype where they are used
(flax's ``promote_dtype``). GroupNorm statistics are float32 whatever the
compute dtype.

Shapes are [B, C, H, W] whatever the layout. Two layouts run through
these modules, and each keeps the one it is given: NCHW (SD's UNet, the
KL VAE) and channels-last (the ADM UNet and classifier, which take their
input channels-last at entry, :func:`to_channels_last`, and the VQ
decoder, whose quantizer hands back a channels-last tensor). Channels-last is
the layout of cuDNN's Hopper convolutions (the sm90 NHWC implicit GEMMs)
and of the JAX reference (NHWC); in NCHW cuDNN copies every convolution's
input into NHWC and its output back. A conv casts its float32 weight into
the input's layout in the same copy as its dtype, and GroupNorm32 takes
the fused kernels' NHWC route on a channels-last input
(ops/fused_norm.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (conv3x3, conv3x3_fused, fused_group_norm,
                   fused_norm_available, memory_format, resolve_use_im2col)

__all__ = ["timestep_embedding", "GroupNorm32", "Conv3x3", "conv2d",
           "linear", "conv1x1", "Upsample", "Downsample", "zero_module",
           "to_channels_last"]


class _ToChannelsLast(torch.autograd.Function):
    """x in ``dtype`` and channels-last; its gradient back in x's dtype
    and layout (autograd's own cast would hand it back channels-last)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype, ctx.layout = x.dtype, memory_format(x)
        return x.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype, memory_format=ctx.layout), None


def to_channels_last(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A model's [B, C, H, W] input in ``dtype``, laid out channels-last
    (one copy); where x needs a gradient (the guidance's classifier) it
    flows back in x's own dtype and layout."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ToChannelsLast.apply(x, dtype)
    return x.to(dtype, memory_format=torch.channels_last)


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


def zero_module(module: nn.Module) -> nn.Module:
    """Zero every parameter of ``module`` (guided_diffusion/nn.py:68-74):
    a fresh model's output projections start at zero, as the JAX
    package's ``kernel_init=zero_init`` does."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def conv2d(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in x's dtype and layout (its float32 parameters cast
    at use, the weight into x's layout in the same copy, so that cuDNN
    sees one layout and returns it)."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    weight = mod.weight.to(x.dtype, memory_format=memory_format(x))
    return F.conv2d(x, weight, bias, mod.stride, mod.padding, mod.dilation,
                    mod.groups)


def conv1x1(mod: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-size-1 Conv1d ([B, C, T]) in x's dtype."""
    return F.conv1d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod`` applied in x's dtype."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), bias)


def _group_stats(x: torch.Tensor, groups: int, eps: float):
    """[B, G] GroupNorm statistics in float32 (fast-variance math): the one
    source of both GroupNorm32 paths, the normalise path and the affine
    fold (autodiffusion_tpu models/nn.py:60-74). Returns (xg [B, G, -1]
    float32, mu [B, G, 1], rstd [B, G, 1])."""
    b = x.shape[0]
    xg = x.float().reshape(b, groups, -1)
    mu = xg.mean(dim=-1, keepdim=True)
    var = ((xg * xg).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return xg, mu, torch.rsqrt(var + eps)


class GroupNorm32(nn.GroupNorm):
    """32-group GroupNorm with inline FiLM and activation.

    ``forward(x, scale=, shift=, act=)`` is ``act(GN(x) * (1 + scale) +
    shift)``: statistics in float32 with var = max(E[x^2] - E[x]^2, 0) and
    eps 1e-5, the normalised value (times gamma, plus beta) cast back to x's
    dtype, then FiLM and SiLU in that dtype (autodiffusion_tpu
    models/nn.py:60-74,144-165). scale and shift are [B, C]. The parameters
    are nn.GroupNorm's ``weight`` and ``bias``, so guided-diffusion state
    dicts load unchanged.

    Where :func:`~autodiffusion_tpu_torch.ops.fused_norm_available` says so
    (CUDA tensors, unless ``ADT_FUSED_NORM=0``; CPU tensors only under
    ``ADT_FUSED_NORM=1``) the whole operation goes through the fused
    GroupNorm kernels (ops/fused_norm.py), which apply FiLM and SiLU in
    float32 before one cast. The chain below is the CPU path and the
    tests' twin. Both keep x's layout (NCHW or channels-last; the fused
    kernels take their NHWC route on a channels-last x).
    ``return_affine=True`` returns instead
    the per-(sample, channel) float32 affine (a, b) with GN(x) * (1 +
    scale) + shift == x a + b, for the fused norm-act-conv (Conv3x3
    ``affine=``), which applies silu(x a + b) itself (models/nn.py:108-131)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__(min(num_groups, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                act: Optional[str] = None, return_affine: bool = False):
        b, c = x.shape[:2]
        g = self.num_groups
        if return_affine:
            _, mu, rstd = _group_stats(x, g, self.eps)
            mu_c, rstd_c = (t.repeat_interleave(c // g, dim=1)[..., 0]
                            for t in (mu, rstd))                  # [B, C]
            a = rstd_c * self.weight[None]
            off = self.bias[None] - mu_c * a
            if scale is not None:
                film = 1.0 + scale.reshape(b, c).float()
                a = a * film
                off = off * film
            if shift is not None:
                off = off + shift.reshape(b, c).float()
            return a, off
        if fused_norm_available(x.shape, g, x.device.type):
            return fused_group_norm(
                x, self.weight, self.bias,
                scale=None if scale is None else scale.reshape(b, c),
                shift=None if shift is None else shift.reshape(b, c),
                num_groups=g, eps=self.eps,
                act="silu" if act == "silu" else "none")
        xg, mu, rstd = _group_stats(x, g, self.eps)
        gamma = self.weight.reshape(1, g, -1, 1)
        beta = self.bias.reshape(1, g, -1, 1)
        xg = xg.reshape(b, g, c // g, -1)
        h = (xg - mu[..., None]) * (rstd[..., None] * gamma) + beta
        h = h.reshape(x.shape).to(x.dtype, memory_format=memory_format(x))
        bshape = (b, c) + (1,) * (x.dim() - 2)
        if scale is not None:
            h = h * (1 + scale.reshape(bshape))
        if shift is not None:
            h = h + shift.reshape(bshape)
        if act == "silu":
            h = F.silu(h)
        return h


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv (an ``nn.Conv2d``, so its state-dict keys are
    unchanged) with the port's two conv kernels behind it
    (autodiffusion_tpu models/nn.py:168-216).

    ``forward(x)`` takes the im2col conv kernel where
    :func:`~autodiffusion_tpu_torch.ops.resolve_use_im2col` says so
    (``ADT_IM2COL_CONV=1``), else PyTorch's conv. ``forward(x, affine=(a,
    b), residual=r)`` is the norm-act-conv, conv(silu(x a + b)) + bias
    (+ r), through the fused conv kernel; its caller (ResBlock) has already
    asked :func:`~autodiffusion_tpu_torch.ops.resolve_use_fused_conv`.
    Computes in x's dtype, the float32 parameters cast at use."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, affine=None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if affine is not None:
            a, off = affine
            return conv3x3_fused(x, a, off, self.weight.to(x.dtype),
                                 self.bias.to(x.dtype), residual)
        if residual is not None:
            raise ValueError("residual fusion needs affine")
        if resolve_use_im2col(x.shape[1], self.out_channels, x.dtype):
            return conv3x3(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        return conv2d(self, x)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample with an optional 3x3 conv."""

    def __init__(self, channels: int, use_conv: bool,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv3x3(channels, out_channels or channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


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
