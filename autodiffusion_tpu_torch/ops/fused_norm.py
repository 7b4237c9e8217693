"""Fused GroupNorm (+ FiLM) (+ SiLU): two hand-written Hopper kernels and
their plain twins.

Port of autodiffusion_tpu/ops/fused_norm.py. The TPU package wrote the
forward (``_fwd_kernel``) and a one-pass backward (``_bwd_kernel``) in
Pallas; here they are CUDA C++ kernels in ``ops/csrc/`` (built by
``ops/_build.py`` with nvcc for sm_90a):

  group_norm_fwd   y = act(GN(x) * (1 + scale) + shift), and mu, rstd
  group_norm_bwd   dx, dscale, dshift, dgamma, dbeta from x, dy, mu, rstd

x [B, C, ...] (any number of trailing spatial or token dims), gamma, beta
[C], scale, shift [B, C] or None, mu, rstd [B, G]. Each wrapper launches
its kernel on CUDA tensors (and counts the launch) or raises; on CPU
tensors it computes its plain PyTorch twin, which repeats the kernel's
arithmetic. :class:`FusedGroupNormFunction` wires the two into autograd.

Two layouts, chosen by what the input is, not by a switch: a 4-D x laid
out channels-last and not NCHW-contiguous (:func:`is_nhwc`: the ADM UNet's
and classifier's activations, and the VQ decoder's, whose quantizer hands
back a channels-last tensor) takes the kernels' NHWC route, anything else
(NCHW tensors, [B, C, T], [B, C, 1, 1]: SD's UNet, the KL VAE) the NCHW
route, unchanged. Outputs and dx come back in x's layout. In NHWC a (sample,
group) is HW chunks of C / G channels, C apart (12 bytes at ADM-64's top
level), too short for a block a run to coalesce, so the NHWC kernels cut a
sample into tiles of whole groups and slices of pixels, a thread a vector
along C: the forward holds a small tile in one block, else streams whole
pixel rows in two kernels (partial sums, then apply); the backward meets a
tile's slices in a thread block cluster through distributed shared memory
(ops/csrc/group_norm.cuh, group_norm_fwd.cu, group_norm_bwd.cu). A
channels-last x whose channels do not split into such vectors (C not a
multiple of 8, or tiles of more than 32 vectors) runs the NCHW route on an
NCHW copy. ``NHWC_LAUNCHES`` counts the calls on the NHWC route (on CPU
tensors the twin's).

Numerics (as the TPU kernels, fused_norm.py:77-151): statistics in float32
with var = max(E[x^2] - E[x]^2, 0) (not Welford: the kernels and the JAX
reference sum x and x^2), then z = (x - mu) (rstd gamma) + beta, FiLM and
SiLU in float32 and one cast to x's dtype (the NHWC kernels fold the
affine and FiLM terms into one product and sum a channel's pixels before
its group's channels: another order of the same float32 sums). The
backward recomputes z from the saved mu, rstd; dgamma and dbeta sum over
the batch. It computes only the gradients asked for (``grad_affine``,
``grad_film``), so that the guided samplers' frozen classifier gets dx
alone.
"""

from __future__ import annotations

import contextlib
import os
from math import lcm, prod
from typing import Optional, Tuple

import torch

from ._build import NHWC_LAUNCHES, launch

__all__ = ["fused_group_norm", "group_norm_reference", "fused_norm_available",
           "FusedGroupNormFunction", "group_norm_fwd", "group_norm_bwd",
           "group_norm_fwd_plain", "group_norm_bwd_plain", "is_nhwc",
           "memory_format", "NHWC_LAUNCHES"]


def is_nhwc(x: torch.Tensor) -> bool:
    """True for a 4-D tensor laid out channels-last and not NCHW-contiguous
    (a [B, C, 1, 1] or C = 1 tensor is both, and counts as NCHW)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _nhwc_route(x: torch.Tensor, groups: int) -> bool:
    """True where the call takes the NHWC kernels: x :func:`is_nhwc`, C a
    whole number of 16-byte vectors, and a tile of whole groups (lcm(C /
    G, vector)) of at most 32 vectors (the kernels' Tile: the forward's
    vectors are 16 bytes, the backward's four elements)."""
    if not is_nhwc(x):
        return False
    c, cpg = x.shape[1], x.shape[1] // groups
    return c % 8 == 0 and all(lcm(cpg, v) <= 32 * v
                              for v in (16 // x.element_size(), 4))


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """x's layout: channels-last where :func:`is_nhwc`, else contiguous
    (NCHW)."""
    return torch.channels_last if is_nhwc(x) else torch.contiguous_format


def fused_norm_available(x_shape, num_groups: int = 32,
                         device_type: str = "cpu") -> bool:
    """True when GroupNorm32 takes the fused kernels: by default for CUDA
    tensors (``device_type`` "cuda"), where ``ADT_FUSED_NORM=0`` turns
    them off for the A/B's "off" arm, and for CPU tensors (where the
    wrappers compute their plain twins) only under ``ADT_FUSED_NORM=1``,
    with which the tests drive the fused route on the CPU; and then only
    for channels divisible into groups. x_shape is [B, C, ...]. The JAX
    gate's TPU-backend test, VMEM cap on one sample's slab and
    two-position minimum have no counterpart here: the kernels stream a
    (sample, group) run of any length, one position a channel included
    (the spatial_v2 classifier head's GroupNorm over [B, 2048, 1, 1])."""
    default = "1" if device_type == "cuda" else "0"
    if os.environ.get("ADT_FUSED_NORM", default) != "1":
        return False
    c = x_shape[1]
    return c % min(num_groups, c) == 0


# ---------------------------------------------------------------- plain twins

def _per_channel(t: Optional[torch.Tensor], b: int, c: int):
    """A [B, C] FiLM term as float32 [B, C, 1], or 0.0 for None."""
    return 0.0 if t is None else t.float().reshape(b, c, 1)


def group_norm_fwd_plain(x, gamma, beta, scale, shift, groups: int,
                         eps: float, silu: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel: (y in x's dtype, mu, rstd [B, G])."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    mu = xg.mean(dim=-1)
    var = ((xg * xg).mean(dim=-1) - mu * mu).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    xc = x.float().reshape(b, c, -1)
    mu_c = mu.repeat_interleave(c // groups, dim=1)[..., None]
    rstd_c = rstd.repeat_interleave(c // groups, dim=1)[..., None]
    z = (xc - mu_c) * (rstd_c * gamma.float()[None, :, None]) \
        + beta.float()[None, :, None]
    u = z * (1.0 + _per_channel(scale, b, c)) + _per_channel(shift, b, c)
    if silu:
        u = u * torch.sigmoid(u)
    return u.to(x.dtype).reshape(x.shape), mu, rstd


def group_norm_bwd_plain(x, dy, gamma, beta, scale, shift, mu, rstd,
                         groups: int, silu: bool, *, grad_affine: bool = True,
                         grad_film: bool = True):
    """Plain twin of the backward kernel: (dx in x's dtype, dscale, dshift
    [B, C], dgamma, dbeta [C], all float32 but dx), as
    autodiffusion_tpu/ops/fused_norm.py:119-151. dgamma, dbeta are None
    unless ``grad_affine``, dscale, dshift None unless ``grad_film``, as
    the kernel leaves them unwritten."""
    b, c = x.shape[:2]
    per = c // groups
    xc = x.float().reshape(b, c, -1)
    g = dy.float().reshape(b, c, -1)
    mu_c = mu.float().repeat_interleave(per, dim=1)[..., None]
    rstd_c = rstd.float().repeat_interleave(per, dim=1)[..., None]
    film = 1.0 + _per_channel(scale, b, c)
    gam = gamma.float()[None, :, None]
    xhat = (xc - mu_c) * rstd_c
    z = xhat * gam + beta.float()[None, :, None]
    if silu:
        u = z * film + _per_channel(shift, b, c)
        sig = torch.sigmoid(u)
        du = g * (sig * (1.0 + u * (1.0 - sig)))
    else:
        du = g
    dscale = dshift = dgamma = dbeta = None
    if grad_film:
        dshift = du.sum(dim=-1)
        dscale = (du * z).sum(dim=-1)
    dz = du * film
    if grad_affine:
        dgamma = (dz * xhat).sum(dim=(0, 2))
        dbeta = dz.sum(dim=(0, 2))
    dxhat = dz * gam
    cnt = per * xc.shape[-1]
    m1 = dxhat.sum(dim=-1).reshape(b, groups, per).sum(-1) / cnt
    m2 = (dxhat * xhat).sum(dim=-1).reshape(b, groups, per).sum(-1) / cnt
    m1 = m1.repeat_interleave(per, dim=1)[..., None]
    m2 = m2.repeat_interleave(per, dim=1)[..., None]
    dx = rstd_c * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), dscale, dshift, dgamma, dbeta)


def group_norm_reference(x, gamma, beta, *, scale=None, shift=None,
                         num_groups: int = 32, eps: float = 1e-5,
                         act: str = "silu") -> torch.Tensor:
    """act(GN(x) * (1 + scale) + shift) in plain PyTorch, differentiable
    through autograd: the twin of the whole fused operation
    (autodiffusion_tpu/ops/fused_norm.py:287-305)."""
    groups = min(num_groups, x.shape[1])
    return group_norm_fwd_plain(x, gamma, beta, scale, shift, groups,
                                float(eps), act == "silu")[0]


# ------------------------------------------------------------------ wrappers

def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the twin); raises on a mix or another device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused GroupNorm inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused GroupNorm runs on cuda (or its plain twin "
                         f"on cpu), not {dev}")
    return dev.type == "cuda"


def _check(x, gamma, groups: int) -> None:
    if x.dim() < 3:
        raise ValueError(f"fused GroupNorm takes [B, C, ...] with at least "
                         f"one spatial dim, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused GroupNorm takes float32 or bfloat16, got "
                        f"{x.dtype}")
    c = x.shape[1]
    if gamma.shape != (c,) or c % groups:
        raise ValueError(f"{c} channels, gamma {tuple(gamma.shape)}, "
                         f"{groups} groups")


def _f32(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    if t is None or (t.dtype is torch.float32 and t.shape == shape
                     and t.is_contiguous()):
        return t
    return t.float().reshape(shape).contiguous()


def _on_device(x: torch.Tensor):
    """The device context of a launch on x's device: none where that
    device is already the current one (a guided step makes some 200
    launches, and the context costs more host time than the check)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor, nhwc: bool) -> torch.Tensor:
    """Dense in the kernels' layout (channels-last where ``nhwc``, else
    contiguous) with a 16-byte aligned start (the kernels move 16 bytes at
    a time)."""
    t = t.contiguous(memory_format=torch.channels_last if nhwc
                     else torch.contiguous_format)
    return t.clone() if t.data_ptr() % 16 else t


def group_norm_fwd(x, gamma, beta, scale, shift, groups: int, eps: float,
                   silu: bool):
    """Forward kernel: (y [B, C, ...] in x's dtype and layout, mu, rstd
    [B, G])."""
    _check(x, gamma, groups)
    fmt, nhwc = memory_format(x), _nhwc_route(x, groups)
    if not _on_cuda(x, gamma, beta, scale, shift):
        y, mu, rstd = group_norm_fwd_plain(x, gamma, beta, scale, shift,
                                           groups, eps, silu)
        NHWC_LAUNCHES["group_norm_fwd"] += nhwc
        return y.contiguous(memory_format=fmt), mu, rstd
    b, c = x.shape[:2]
    x = _aligned(x, nhwc)
    hw = prod(x.shape[2:])
    gamma, beta = _f32(gamma, (c,)), _f32(beta, (c,))
    scale, shift = _f32(scale, (b, c)), _f32(shift, (b, c))
    y = torch.empty_like(x)
    mu = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    with _on_device(x):
        launch("group_norm_fwd", x.data_ptr(), gamma.data_ptr(),
               beta.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
               mu.data_ptr(), rstd.data_ptr(), b, c, hw, groups, int(silu),
               int(x.dtype == torch.bfloat16), int(nhwc), float(eps))
    NHWC_LAUNCHES["group_norm_fwd"] += nhwc
    return y.contiguous(memory_format=fmt), mu, rstd


def group_norm_bwd(x, dy, gamma, beta, scale, shift, mu, rstd, groups: int,
                   silu: bool, *, grad_affine: bool = True,
                   grad_film: bool = True):
    """Backward kernel: (dx in x's dtype and layout, dscale, dshift [B, C],
    dgamma, dbeta [C]), all float32 but dx. Only the gradients asked for
    are computed: dgamma, dbeta are None unless ``grad_affine`` (then the
    batch sum is not launched either), dscale, dshift None unless
    ``grad_film``."""
    _check(x, gamma, groups)
    fmt, nhwc = memory_format(x), _nhwc_route(x, groups)
    if not _on_cuda(x, dy, gamma, beta, scale, shift, mu, rstd):
        dx, *rest = group_norm_bwd_plain(x, dy, gamma, beta, scale, shift,
                                         mu, rstd, groups, silu,
                                         grad_affine=grad_affine,
                                         grad_film=grad_film)
        NHWC_LAUNCHES["group_norm_bwd"] += nhwc
        return (dx.contiguous(memory_format=fmt), *rest)
    b, c = x.shape[:2]
    x = _aligned(x, nhwc)
    dy = _aligned(dy.to(x.dtype), nhwc)
    gamma, beta = _f32(gamma, (c,)), _f32(beta, (c,))
    scale, shift = _f32(scale, (b, c)), _f32(shift, (b, c))
    mu, rstd = _f32(mu, (b, groups)), _f32(rstd, (b, groups))
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dscale = dshift = part_g = part_b = dgamma = dbeta = None
    if grad_film:
        dscale, dshift = torch.empty((b, c), **f32), torch.empty((b, c), **f32)
    if grad_affine:
        part_g, part_b = torch.empty((b, c), **f32), torch.empty((b, c), **f32)
        dgamma, dbeta = torch.empty(c, **f32), torch.empty(c, **f32)
    with _on_device(x):
        launch("group_norm_bwd", x.data_ptr(), dy.data_ptr(),
               gamma.data_ptr(), beta.data_ptr(), _ptr(scale), _ptr(shift),
               mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(dscale),
               _ptr(dshift), _ptr(part_g), _ptr(part_b), _ptr(dgamma),
               _ptr(dbeta), b, c, x[0, 0].numel(), groups, int(silu),
               int(x.dtype == torch.bfloat16), int(nhwc))
    NHWC_LAUNCHES["group_norm_bwd"] += nhwc
    return (dx.contiguous(memory_format=fmt), dscale, dshift, dgamma,
            dbeta)


class FusedGroupNormFunction(torch.autograd.Function):
    """Autograd around the two kernels: the forward saves x and the
    per-(sample, group) mu, rstd; the backward is one launch of the
    backward kernel (the TPU package's custom VJP, fused_norm.py:177-226)
    for the gradients autograd asks for (``ctx.needs_input_grad``): a
    frozen gamma and beta, or FiLM terms that need no gradient (the guided
    samplers' frozen classifier), are neither computed nor returned.
    Gradients come back in the dtypes of the inputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps, silu):
        y, mu, rstd = group_norm_fwd(x, gamma, beta, scale, shift, groups,
                                     eps, silu)
        ctx.save_for_backward(x, gamma, beta, scale, shift, mu, rstd)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, scale, shift, mu, rstd = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dscale, dshift, dgamma, dbeta = group_norm_bwd(
            x, dy, gamma, beta, scale, shift, mu, rstd, ctx.groups, ctx.silu,
            grad_affine=need[1] or need[2], grad_film=need[3] or need[4])
        return (dx if need[0] else None,
                dgamma.to(gamma.dtype) if need[1] else None,
                dbeta.to(beta.dtype) if need[2] else None,
                dscale.to(scale.dtype).reshape(scale.shape) if need[3]
                else None,
                dshift.to(shift.dtype).reshape(shift.shape) if need[4]
                else None,
                None, None, None)


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, *,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     num_groups: int = 32, eps: float = 1e-5,
                     act: str = "silu") -> torch.Tensor:
    """act(GN(x) * (1 + scale) + shift) in one fused pass, differentiable.

    x: [B, C, ...]; gamma, beta: [C]; scale, shift: optional [B, C] FiLM
    conditioning; act: "silu" | "none". On CUDA tensors the kernels, on CPU
    tensors their twins, both through :class:`FusedGroupNormFunction`."""
    if act not in ("silu", "none"):
        raise ValueError(f"act must be 'silu' or 'none', got {act!r}")
    groups = min(num_groups, x.shape[1])
    return FusedGroupNormFunction.apply(x, gamma, beta, scale, shift, groups,
                                        float(eps), act == "silu")
