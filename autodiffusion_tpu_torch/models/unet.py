"""ADM UNet and noisy classifier (NCHW), with layer masking.

Port of autodiffusion_tpu/models/unet.py. The module tree and parameter
names are guided-diffusion's own (guided_diffusion/unet.py: ``time_embed``,
``label_emb``, ``input_blocks.N.M``, ``middle_block``, ``output_blocks``,
``out``), so a published ``.pt`` loads with ``load_state_dict``.

Every prunable block (ResBlock / AttentionBlock) has a ``layer_id`` in
construction order, the numbering of Dynamic_UNetModel
(dynamic_unet.py:507-655): 58 ids for ADM-64. ``keep_mask`` ([L] for the
whole batch or [B, L] per sample, candidates folded into the batch)
multiplies each block's residual branch, so a skipped block is exactly the
reference's short-circuit. ``structural_skip`` (a set of layer ids, for
deploying a searched architecture) leaves those blocks' residual branches
out altogether: the same output as a zero in the keep mask, without their
work.

Self-attention goes through ``ops.flash_attention.routed_attention``,
which sends each site where ``attention_route`` says: the hand-written
kernels on the card where the head dim has one and the flash gate keeps
it, else SDPA; their plain twin on the CPU. Every GroupNorm32 not folded
into a conv takes the fused GroupNorm kernels on
CUDA tensors (ops/fused_norm.py; ``ADT_FUSED_NORM=0`` turns them off, the
A/B's "off" arm, and ``ADT_FUSED_NORM=1`` takes their twins on the CPU).
Two switches, off by default, route the convs through the port's conv
kernels (each wrapper takes its plain twin on CPU tensors):
``ADT_IM2COL_CONV=1`` every Conv3x3 not fused (ops/conv_im2col.py),
``ADT_FUSED_CONV=all`` each ResBlock norm that feeds its conv directly
into the fused norm-act-conv.
"""

from __future__ import annotations

from typing import AbstractSet, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resolve_use_fused_conv
from ..ops.flash_attention import routed_attention
from .nn import (Conv3x3, Downsample, GroupNorm32, Upsample, conv1x1,
                 conv2d, linear, timestep_embedding, zero_module)

__all__ = ["ResBlock", "AttentionBlock", "AttentionPool2d", "UNetModel",
           "SuperResModel", "EncoderUNetModel", "unet_layer_count"]


def _apply_keep(h: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """h * keep, keep a scalar or [B] factor (None keeps)."""
    if keep is None:
        return h
    keep = keep.to(h.dtype)
    return h * keep.reshape(keep.shape + (1,) * (h.dim() - keep.dim()))


def _keep_factor(keep_mask: Optional[torch.Tensor], layer_id: int):
    if keep_mask is None:
        return None
    return keep_mask[:, layer_id] if keep_mask.dim() == 2 \
        else keep_mask[layer_id]


class ResBlock(nn.Module):
    """Residual block with FiLM (scale-shift) timestep conditioning
    (guided_diffusion/unet.py:143-256).

    Behind ``ADT_FUSED_CONV`` (ops.resolve_use_fused_conv) a norm that
    feeds its conv directly is folded into the conv's own pass
    (autodiffusion_tpu models/unet.py:108-175): the in-norm of a block
    without up/down resampling, and the out-norm where dropout is a no-op;
    the residual rides the out-conv's epilogue when no keep factor scales
    the branch. With the gate off the block is the plain composition,
    unchanged."""

    def __init__(self, channels: int, emb_channels: int, dropout: float,
                 out_channels: Optional[int] = None,
                 use_conv: bool = False, use_scale_shift_norm: bool = True,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.out_channels = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            Conv3x3(channels, self.out_channels))
        self.updown = up or down
        if up:
            self.h_upd = Upsample(channels, False)
            self.x_upd = Upsample(channels, False)
        elif down:
            self.h_upd = Downsample(channels, False)
            self.x_upd = Downsample(channels, False)
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * self.out_channels
                      if use_scale_shift_norm else self.out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(self.out_channels), nn.SiLU(),
            nn.Dropout(dropout),
            zero_module(Conv3x3(self.out_channels, self.out_channels)))
        if self.out_channels == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv3x3(channels, self.out_channels)
        else:
            self.skip_connection = nn.Conv2d(channels, self.out_channels, 1)
        self.up, self.down = up, down

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        c_in, c_out = x.shape[1], self.out_channels
        fuse_in = not self.updown and resolve_use_fused_conv(c_in, c_out,
                                                             x.dtype)
        dropout = self.out_layers[2]
        fuse_out = ((not self.training or dropout.p == 0)
                    and resolve_use_fused_conv(c_out, c_out, x.dtype))
        in_norm, in_conv = self.in_layers[0], self.in_layers[2]
        if fuse_in:
            h = in_conv(x, affine=in_norm(x, return_affine=True))
        else:
            h = in_norm(x, act="silu")
            if self.updown:
                h = self.h_upd(h)
                x = self.x_upd(x)
            h = in_conv(h)
        emb_out = linear(self.emb_layers[1], F.silu(emb))
        norm, conv = self.out_layers[0], self.out_layers[3]
        scale = shift = None
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
        else:
            h = h + emb_out[:, :, None, None]
        skip = self._project(x)
        if fuse_out:
            aff = norm(h, scale=scale, shift=shift, return_affine=True)
            if keep is None:
                return conv(h, affine=aff, residual=skip)
            return skip + _apply_keep(conv(h, affine=aff), keep)
        h = conv(dropout(norm(h, scale=scale, shift=shift, act="silu")))
        return skip + _apply_keep(h, keep)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.skip_connection, (nn.Identity, Conv3x3)):
            return self.skip_connection(x)
        return conv2d(self.skip_connection, x)

    def skip_path(self, x: torch.Tensor) -> torch.Tensor:
        """The block with its residual branch left out: the resample and
        the channel projection only (a skipped dynamic block,
        dynamic_unet.py:245-249)."""
        return self._project(self.x_upd(x) if self.updown else x)


class AttentionBlock(nn.Module):
    """Spatial self-attention with residual (guided_diffusion/unet.py:
    259-393). ``use_new_attention_order`` selects QKVAttention ([q|k|v]
    blocks, heads inside each) or QKVAttentionLegacy (heads outermost,
    [q|k|v] inside each head)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1,
                 use_new_attention_order: bool = False):
        super().__init__()
        if num_head_channels == -1:
            self.num_heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by "
                                 f"head channels {num_head_channels}")
            self.num_heads = channels // num_head_channels
        self.new_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, channels * 3, 1)
        self.proj_out = zero_module(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.reshape(b, c, -1)
        t = xf.shape[-1]
        heads, hd = self.num_heads, c // self.num_heads
        qkv = conv1x1(self.qkv, self.norm(xf))                   # [b, 3c, t]
        if self.new_order:
            q, k, v = (z.reshape(b * heads, hd, t) for z in qkv.chunk(3, 1))
        else:
            q, k, v = qkv.reshape(b * heads, 3 * hd, t).split(hd, dim=1)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))          # [bh, t, hd]
        a = routed_attention(q, k, v, heads)                       # [bh, t, hd]
        a = a.transpose(1, 2).reshape(b, c, t)
        a = conv1x1(self.proj_out, a)
        return x + _apply_keep(a, keep).reshape(x.shape)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling head of the classifier
    (guided_diffusion/unet.py:19-68). Plain PyTorch: T = HW + 1 tokens."""

    def __init__(self, spacial_dim: int, embed_dim: int,
                 num_heads_channels: int, output_dim: Optional[int] = None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim or embed_dim, 1)
        self.num_heads = embed_dim // num_heads_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.reshape(b, c, -1)
        xf = torch.cat([xf.mean(dim=-1, keepdim=True), xf], dim=-1)
        xf = xf + self.positional_embedding[None].to(xf.dtype)
        qkv = conv1x1(self.qkv_proj, xf)
        heads, hd = self.num_heads, c // self.num_heads
        t = qkv.shape[-1]
        q, k, v = (z.reshape(b, heads, hd, t) for z in qkv.chunk(3, dim=1))
        scale = 1.0 / hd ** 0.25
        logits = torch.einsum("bhct,bhcs->bhts", q.float() * scale,
                              k.float() * scale)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bhcs->bhct", w, v).reshape(b, c, t)
        return conv1x1(self.c_proj, a)[:, :, 0]


def unet_layer_count(num_res_blocks: int, channel_mult: Sequence[float],
                     attention_ds: Sequence[int], resblock_updown: bool) -> int:
    """Total prunable layers, Dynamic_UNetModel's counter (58 for ADM-64)."""
    n = 0
    ds = 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            n += 1
            if ds in attention_ds:
                n += 1
        if level != len(channel_mult) - 1:
            if resblock_updown:
                n += 1
            ds *= 2
    n += 3  # middle: ResBlock, Attention, ResBlock
    for level in list(range(len(channel_mult)))[::-1]:
        for i in range(num_res_blocks + 1):
            n += 1
            if ds in attention_ds:
                n += 1
            if level and i == num_res_blocks:
                if resblock_updown:
                    n += 1
                ds //= 2
    return n


class _Blocks(nn.ModuleList):
    """TimestepEmbedSequential's role: a list of blocks, each with the
    layer id it answers to in a keep mask (None: not prunable)."""

    def __init__(self, *mods):
        super().__init__(mods)
        self.layer_ids: List[Optional[int]] = [None] * len(mods)

    def run(self, h, emb, keep_mask, skip: AbstractSet[int] = frozenset()):
        for mod, lid in zip(self, self.layer_ids):
            if lid in skip:
                # left out: a skipped attention block is the identity
                # (dynamic_unet.py:316-318)
                if isinstance(mod, ResBlock):
                    h = mod.skip_path(h)
                continue
            keep = None if lid is None else _keep_factor(keep_mask, lid)
            if isinstance(mod, ResBlock):
                h = mod(h, emb, keep)
            elif isinstance(mod, AttentionBlock):
                h = mod(h, keep)
            else:
                h = conv2d(mod, h) if isinstance(mod, nn.Conv2d) else mod(h)
        return h


class _Trunk(nn.Module):
    """Timestep embedding, input blocks and middle block: the part the UNet
    and the encoder classifier share (same construction, same names)."""

    def _build_trunk(self, in_channels, model_channels, num_res_blocks,
                     attention_ds, dropout, channel_mult, conv_resample,
                     num_heads, num_head_channels, use_scale_shift_norm,
                     resblock_updown, use_new_attention_order):
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        self.channel_mult = tuple(channel_mult)
        self.resblock_updown = resblock_updown
        ted = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted),
                                        nn.SiLU(), nn.Linear(ted, ted))
        self._lid = 0

        def attn(ch):
            return AttentionBlock(ch, num_heads=num_heads,
                                  num_head_channels=num_head_channels,
                                  use_new_attention_order=use_new_attention_order)

        def res(ch, out, up=False, down=False):
            return ResBlock(ch, ted, dropout, out_channels=out,
                            use_scale_shift_norm=use_scale_shift_norm,
                            up=up, down=down)

        self._attn, self._res = attn, res
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList(
            [_Blocks(nn.Conv2d(in_channels, ch, 3, padding=1))])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out = int(mult * model_channels)
                blk = self._blocks(res(ch, out))
                ch = out
                if ds in attention_ds:
                    self._append(blk, attn(ch))
                self.input_blocks.append(blk)
                chans.append(ch)
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    blk = self._blocks(res(ch, ch, down=True))
                else:
                    blk = _Blocks(Downsample(ch, conv_resample))
                self.input_blocks.append(blk)
                chans.append(ch)
                ds *= 2
        self.middle_block = self._blocks(res(ch, ch))
        self._append(self.middle_block, attn(ch))
        self._append(self.middle_block, res(ch, ch))
        return ch, ds, chans

    def _blocks(self, mod) -> _Blocks:
        blk = _Blocks()
        self._append(blk, mod)
        return blk

    def _append(self, blk: _Blocks, mod) -> None:
        blk.append(mod)
        prunable = isinstance(mod, (ResBlock, AttentionBlock))
        blk.layer_ids.append(self._lid if prunable else None)
        self._lid += prunable

    def _embed(self, timesteps, dtype):
        emb = timestep_embedding(timesteps, self.model_channels).to(dtype)
        emb = linear(self.time_embed[0], emb)
        return linear(self.time_embed[2], F.silu(emb))


class UNetModel(_Trunk):
    """The ADM UNet (guided_diffusion/unet.py:396-665) with layer masking.

    forward(x [B, C, H, W], timesteps [B], y [B] or None, keep_mask [L] or
    [B, L] or None, structural_skip a set of layer ids or None) ->
    [B, out_channels, H, W] float32. Computes in
    ``dtype`` (bfloat16 under ``use_bf16``); the final conv runs in float32
    as in the JAX model."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_ds: Sequence[int] = (2, 4, 8),
                 dropout: float = 0.0,
                 channel_mult: Sequence[float] = (1, 2, 3, 4),
                 conv_resample: bool = True,
                 num_classes: Optional[int] = None,
                 num_heads: int = 1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True,
                 use_new_attention_order: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        ted = model_channels * 4
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted)
        ch, ds, chans = self._build_trunk(
            in_channels, model_channels, num_res_blocks, attention_ds,
            dropout, channel_mult, conv_resample, num_heads,
            num_head_channels, use_scale_shift_norm, resblock_updown,
            use_new_attention_order)
        heads_up = num_heads if num_heads_upsample == -1 \
            else num_heads_upsample
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                ich = chans.pop()
                out = int(mult * model_channels)
                blk = self._blocks(self._res(ch + ich, out))
                ch = out
                if ds in attention_ds:
                    self._append(blk, AttentionBlock(
                        ch, num_heads=heads_up,
                        num_head_channels=num_head_channels,
                        use_new_attention_order=use_new_attention_order))
                if level and i == num_res_blocks:
                    if resblock_updown:
                        self._append(blk, self._res(ch, ch, up=True))
                    else:
                        blk.append(Upsample(ch, conv_resample))
                        blk.layer_ids.append(None)
                    ds //= 2
                self.output_blocks.append(blk)
        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_module(nn.Conv2d(ch, out_channels, 3, padding=1)))
        self.layer_num = self._lid
        expected = unet_layer_count(num_res_blocks, channel_mult,
                                    attention_ds, resblock_updown)
        if self.layer_num != expected:
            raise AssertionError((self.layer_num, expected))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                keep_mask: Optional[torch.Tensor] = None,
                structural_skip: Optional[AbstractSet[int]] = None
                ) -> torch.Tensor:
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("must specify y exactly when the model is "
                             "class-conditional")
        if keep_mask is not None and keep_mask.shape[-1] != self.layer_num:
            raise ValueError(f"keep_mask must have length {self.layer_num}, "
                             f"got {tuple(keep_mask.shape)}")
        emb = self._embed(timesteps, self.dtype)
        if y is not None:
            emb = emb + self.label_emb.weight.to(self.dtype)[y]
        skip = frozenset(structural_skip or ())
        h = x.to(self.dtype)
        hs = []
        for blk in self.input_blocks:
            h = blk.run(h, emb, keep_mask, skip)
            hs.append(h)
        h = self.middle_block.run(h, emb, keep_mask, skip)
        for blk in self.output_blocks:
            h = blk.run(torch.cat([h, hs.pop()], dim=1), emb, keep_mask,
                        skip)
        h = self.out[0](h, act="silu")
        return conv2d(self.out[2], h.float())


class SuperResModel(UNetModel):
    """The super-resolution UNet (guided_diffusion/unet.py:668-682): a
    UNetModel of ``in_channels`` * 2 inputs whose forward concatenates the
    bilinear upsampling of ``low_res`` (half-pixel centres,
    ``align_corners=False``, as ``jax.image.resize``'s "bilinear" at an
    upsampling) to x. Its parameters are the plain UNet's, so
    guided-diffusion's upsampler ``.pt`` loads with ``load_state_dict``.

    forward(x [B, C, H, W], timesteps [B], low_res [B, C, h, w], y, ...)
    -> UNetModel.forward's output."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels * 2, *args, **kwargs)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: torch.Tensor, y: Optional[torch.Tensor] = None,
                **kwargs) -> torch.Tensor:
        up = F.interpolate(low_res.float(), x.shape[2:], mode="bilinear",
                           align_corners=False)
        return super().forward(torch.cat([x.float(), up], dim=1),
                               timesteps, y, **kwargs)


class EncoderUNetModel(_Trunk):
    """Half-UNet noisy classifier (guided_diffusion/unet.py:685-896).
    ``pool`` is "attention" (the ADM classifier's head), "adaptive" (a
    spatial mean and a zero-initialised 1x1 conv), "spatial" or
    "spatial_v2" (the spatial means of every input block's and the middle
    block's output, concatenated, through Linear(., 2048) -> ReLU ->
    Linear, or Linear(., 2048) -> GroupNorm32 -> SiLU -> Linear).
    forward(x, timesteps) -> logits [B, out_channels] float32."""

    def __init__(self, image_size: int, in_channels: int,
                 model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_ds: Sequence[int] = (2, 4, 8),
                 dropout: float = 0.0,
                 channel_mult: Sequence[float] = (1, 2, 3, 4),
                 conv_resample: bool = True, num_heads: int = 1,
                 num_head_channels: int = -1,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True,
                 use_new_attention_order: bool = False,
                 pool: str = "attention",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in ("attention", "adaptive", "spatial", "spatial_v2"):
            raise ValueError(f"unknown pool {pool!r} (attention, adaptive, "
                             "spatial or spatial_v2)")
        self.dtype = dtype
        self.pool = pool
        ch, ds, chans = self._build_trunk(
            in_channels, model_channels, num_res_blocks, attention_ds,
            dropout, channel_mult, conv_resample, num_heads,
            num_head_channels, use_scale_shift_norm, resblock_updown,
            use_new_attention_order)
        feat = sum(chans) + ch
        if pool == "spatial":
            self.out = nn.Sequential(nn.Linear(feat, 2048), nn.ReLU(),
                                     nn.Linear(2048, out_channels))
        elif pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(feat, 2048),
                                     GroupNorm32(2048), nn.SiLU(),
                                     nn.Linear(2048, out_channels))
        elif pool == "adaptive":
            self.out = nn.Sequential(
                GroupNorm32(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                zero_module(nn.Conv2d(ch, out_channels, 1)), nn.Flatten())
        else:
            self.out = nn.Sequential(
                GroupNorm32(ch), nn.SiLU(),
                AttentionPool2d(image_size // ds, ch, num_head_channels,
                                out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor
                ) -> torch.Tensor:
        emb = self._embed(timesteps, self.dtype)
        h = x.to(self.dtype)
        spatial = self.pool.startswith("spatial")
        pools = []
        for blk in self.input_blocks:
            h = blk.run(h, emb, None)
            if spatial:
                # each input block's mean in x's dtype (unet.py:880-891)
                pools.append(h.to(x.dtype).mean(dim=(2, 3)))
        h = self.middle_block.run(h, emb, None)
        if spatial:
            pools.append(h.float().mean(dim=(2, 3)))
            h = linear(self.out[0], torch.cat(pools, dim=-1).float())
            if self.pool == "spatial":
                h = F.relu(h)
            else:
                h = self.out[1](h[:, :, None, None], act="silu")[:, :, 0, 0]
            return linear(self.out[-1], h)
        h = self.out[0](h, act="silu")
        if self.pool == "adaptive":
            # the mean in the compute dtype, the 1x1 conv in float32
            h = h.mean(dim=(2, 3), keepdim=True)
            return conv2d(self.out[3], h.float()).flatten(1)
        return self.out[2](h).float()
