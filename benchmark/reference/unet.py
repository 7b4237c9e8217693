"""Plain ADM UNet and noisy classifier (guided-diffusion's unet.py), for
the benchmark's correctness check.

The module tree and parameter names are guided-diffusion's own
(``time_embed``, ``label_emb``, ``input_blocks.N.M``, ``middle_block``,
``output_blocks``, ``out``), so one state dict serves this model and the
program's. Every product goes through a :class:`~.numerics.Numerics`
given to ``forward``: float32 for the reference, lower precisions for the
controls. Dropout is inactive (sampling). Parameters are plain modules
used only as holders of their tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .numerics import Numerics

__all__ = ["UNet", "Classifier", "channel_mult", "attention_ds"]


def channel_mult(image_size: int):
    return {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4),
            64: (1, 2, 3, 4), 32: (1, 2, 2, 2)}[image_size]


def attention_ds(image_size: int, resolutions: str):
    return tuple(image_size // int(r) for r in resolutions.split(",") if r)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch)


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb: int, out: int, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(_gn(ch), nn.SiLU(),
                                       nn.Conv2d(ch, out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, 2 * out))
        self.out_layers = nn.Sequential(_gn(out), nn.SiLU(), nn.Dropout(),
                                        nn.Conv2d(out, out, 3, padding=1))
        self.skip_connection = (nn.Identity() if out == ch
                                else nn.Conv2d(ch, out, 1))

    def forward(self, P: Numerics, x, emb):
        h = F.silu(P.group_norm(self.in_layers[0], x))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = P.conv2d(self.in_layers[2], h)
        scale, shift = P.linear(self.emb_layers[1], F.silu(emb)).chunk(2, 1)
        h = P.group_norm(self.out_layers[0], h, film=True)
        h = F.silu(h * (1 + scale[..., None, None]) + shift[..., None, None])
        h = P.conv2d(self.out_layers[3], h)
        skip = (x if isinstance(self.skip_connection, nn.Identity)
                else P.conv2d(self.skip_connection, x))
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, head_channels: int, new_order: bool):
        super().__init__()
        self.heads = ch // head_channels
        self.new_order = new_order
        self.norm = _gn(ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, P: Numerics, x, emb=None):
        b, c = x.shape[:2]
        xf = x.reshape(b, c, -1)
        t = xf.shape[-1]
        qkv = P.conv1d(self.qkv, P.group_norm(self.norm, xf))
        hd = c // self.heads
        if self.new_order:
            q, k, v = (z.reshape(b * self.heads, hd, t)
                       for z in qkv.chunk(3, dim=1))
        else:
            q, k, v = qkv.reshape(b * self.heads, 3 * hd, t).split(hd, 1)
        a = P.attention(q, k, v).reshape(b, c, t)
        return (xf + P.conv1d(self.proj_out, a)).reshape(x.shape)


class AttentionPool2d(nn.Module):
    def __init__(self, spatial: int, ch: int, head_channels: int, out: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(ch, spatial ** 2 + 1))
        self.qkv_proj = nn.Conv1d(ch, 3 * ch, 1)
        self.c_proj = nn.Conv1d(ch, out, 1)
        self.heads = ch // head_channels

    def forward(self, P: Numerics, x):
        b, c = x.shape[:2]
        xf = x.reshape(b, c, -1)
        xf = torch.cat([xf.mean(dim=-1, keepdim=True), xf], dim=-1)
        xf = xf + self.positional_embedding[None].to(xf.dtype)
        qkv = P.conv1d(self.qkv_proj, xf)
        t = qkv.shape[-1]
        q, k, v = (z.reshape(b * self.heads, c // self.heads, t)
                   for z in qkv.chunk(3, dim=1))
        a = P.attention(q, k, v, site=False).reshape(b, c, t)
        return P.conv1d(self.c_proj, a)[:, :, 0]


class Seq(nn.ModuleList):
    def forward(self, P, h, emb):
        for m in self:
            if isinstance(m, nn.Conv2d):
                h = P.conv2d(m, h)
            else:
                h = m(P, h, emb)
        return h


class _Trunk(nn.Module):
    def _trunk(self, in_ch, mc, nrb, attn_ds, mult, head_channels,
               new_order):
        self.mc = mc
        emb = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        ch = int(mult[0] * mc)
        self.input_blocks = nn.ModuleList(
            [Seq([nn.Conv2d(in_ch, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, m in enumerate(mult):
            for _ in range(nrb):
                blk = [ResBlock(ch, emb, int(m * mc))]
                ch = int(m * mc)
                if ds in attn_ds:
                    blk.append(AttentionBlock(ch, head_channels, new_order))
                self.input_blocks.append(Seq(blk))
                chans.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(Seq([ResBlock(ch, emb, ch,
                                                       down=True)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Seq([
            ResBlock(ch, emb, ch),
            AttentionBlock(ch, head_channels, new_order),
            ResBlock(ch, emb, ch)])
        return ch, ds, chans

    def _embed(self, P: Numerics, t):
        e = timestep_embedding(t, self.mc).to(P.act_dtype)
        return P.linear(self.time_embed[2],
                        F.silu(P.linear(self.time_embed[0], e)))


class UNet(_Trunk):
    """forward(P, x [B, 3, H, W], t [B], y [B] or None) -> [B, 6, H, W]
    float32 (eps and the variance's interpolation)."""

    def __init__(self, image_size: int, num_channels: int,
                 num_res_blocks: int, attention_resolutions: str,
                 num_head_channels: int, use_new_attention_order: bool,
                 class_cond: bool, learn_sigma: bool, **_):
        super().__init__()
        mult = channel_mult(image_size)
        attn = attention_ds(image_size, attention_resolutions)
        mc = num_channels
        ch, ds, chans = self._trunk(3, mc, num_res_blocks, attn, mult,
                                    num_head_channels,
                                    use_new_attention_order)
        if class_cond:
            # a given weight skips nn.Embedding's own normal_ init, whose
            # meta-device path imports torch._dynamo (seconds of set-up);
            # the benchmark's weights are loaded over it
            self.label_emb = nn.Embedding(
                1000, 4 * mc, _weight=torch.zeros(1000, 4 * mc))
        self.output_blocks = nn.ModuleList()
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(num_res_blocks + 1):
                blk = [ResBlock(ch + chans.pop(), 4 * mc, int(m * mc))]
                ch = int(m * mc)
                if ds in attn:
                    blk.append(AttentionBlock(ch, num_head_channels,
                                              use_new_attention_order))
                if level and i == num_res_blocks:
                    blk.append(ResBlock(ch, 4 * mc, ch, up=True))
                    ds //= 2
                self.output_blocks.append(Seq(blk))
        self.out = nn.Sequential(_gn(ch), nn.SiLU(),
                                 nn.Conv2d(ch, 6 if learn_sigma else 3, 3,
                                           padding=1))

    def forward(self, P: Numerics, x, t, y=None):
        emb = self._embed(P, t)
        if y is not None:
            emb = emb + self.label_emb.weight.to(emb.dtype)[y]
        h, hs = x.to(P.act_dtype), []
        for blk in self.input_blocks:
            h = blk(P, h, emb)
            hs.append(h)
        h = self.middle_block(P, h, emb)
        for blk in self.output_blocks:
            h = blk(P, torch.cat([h, hs.pop()], dim=1), emb)
        h = F.silu(P.group_norm(self.out[0], h))
        return P.conv2d(self.out[2], h).float()


class Classifier(_Trunk):
    """The ADM noisy classifier (EncoderUNetModel with the attention pool):
    forward(P, x, t) -> logits [B, 1000] float32."""

    def __init__(self, image_size: int, classifier_width: int,
                 classifier_depth: int,
                 classifier_attention_resolutions: str, **_):
        super().__init__()
        mult = channel_mult(image_size)
        ch, ds, _ = self._trunk(
            3, classifier_width, classifier_depth,
            attention_ds(image_size, classifier_attention_resolutions),
            mult, 64, False)
        self.out = nn.Sequential(_gn(ch), nn.SiLU(), AttentionPool2d(
            image_size // ds, ch, 64, 1000))

    def forward(self, P: Numerics, x, t):
        emb = self._embed(P, t)
        h = x.to(P.act_dtype)
        for blk in self.input_blocks:
            h = blk(P, h, emb)
        h = self.middle_block(P, h, emb)
        h = F.silu(P.group_norm(self.out[0], h))
        return self.out[2](P, h).float()

