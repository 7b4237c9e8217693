"""Cross-attention transformer blocks of the Stable Diffusion UNet (NCHW).

Port of autodiffusion_tpu/models/attention.py (ldm/modules/attention.py:
37-260): CrossAttention (self- or cross-attention through an optional
context), the GEGLU feed-forward, BasicTransformerBlock (self-attention,
cross-attention, feed-forward, each with a pre-LayerNorm and a residual)
and SpatialTransformer (1x1 convs around a transformer over the H W
tokens). Module and parameter names are CompVis's own
(``transformer_blocks.0.attn1.to_q``, ``ff.net.0.proj``, ``ff.net.2``,
``to_out.0``), so a CompVis state dict loads with ``load_state_dict``.

Attention goes through :func:`~autodiffusion_tpu_torch.ops.flash_attention.
multihead_attention` on the token-major [B, T, H * D] projections: the
packed kernel at D = 40, the flash forward at D = 80, plain PyTorch at
D = 160 (as the JAX package leaves D > 128 outside its kernels). A module
computes in the dtype of its input, its float32 parameters cast at use;
LayerNorm runs in float32 (eps 1e-5), the SpatialTransformer's GroupNorm
with eps 1e-6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import multihead_attention
from .nn import GroupNorm32, conv2d, linear, zero_module

__all__ = ["CrossAttention", "GEGLU", "FeedForward", "BasicTransformerBlock",
           "SpatialTransformer", "layer_norm"]


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``mod`` in float32, cast back to x's dtype."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps).to(x.dtype)


class CrossAttention(nn.Module):
    """softmax(q k^T / sqrt(d)) v over ``heads`` heads; ``context=None``
    is self-attention (attention.py:152-195). to_q / to_k / to_v have no
    bias, to_out has one."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim),
                                     nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        out = multihead_attention(linear(self.to_q, x), linear(self.to_k, ctx),
                                  linear(self.to_v, ctx), self.heads)
        return linear(self.to_out[0], out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = linear(self.proj, x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult 4 (attention.py:50-65): ``net.0`` the
    GEGLU, ``net.2`` the output projection."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.net[2], self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attention -> cross-attention -> feed-forward, each after a
    LayerNorm and with a residual (attention.py:196-217)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=heads, dim_head=dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(layer_norm(self.norm1, x))
        x = x + self.attn2(layer_norm(self.norm2, x), context)
        return x + self.ff(layer_norm(self.norm3, x))


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) -> 1x1 proj_in -> transformer blocks over the
    (h w) tokens -> 1x1 proj_out, plus the residual (attention.py:218-260).
    forward(x [B, C, H, W], context [B, S, context_dim])."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 depth: int = 1, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)
             for _ in range(depth)])
        self.proj_out = zero_module(nn.Conv2d(inner, in_channels, 1))

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, hh, ww = x.shape
        h = conv2d(self.proj_in, self.norm(x))
        inner = h.shape[1]
        h = h.reshape(b, inner, hh * ww).transpose(1, 2)       # [B, HW, C]
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.transpose(1, 2).reshape(b, inner, hh, ww)
        return conv2d(self.proj_out, h) + x
