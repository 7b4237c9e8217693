"""Fused GroupNorm (+ FiLM) (+ SiLU): two hand-written Hopper kernels and
their plain twins.

Port of autodiffusion_tpu/ops/fused_norm.py. The TPU package wrote the
forward (``_fwd_kernel``) and a one-pass backward (``_bwd_kernel``) in
Pallas; here they are CUDA C++ kernels in ``ops/csrc/`` (built by
``ops/_build.py`` with nvcc for sm_90a):

  group_norm_fwd   y = act(GN(x) * (1 + scale) + shift), and mu, rstd
  group_norm_bwd   dx, dscale, dshift, dgamma, dbeta from x, dy, mu, rstd

Layout NCHW (any number of trailing spatial or token dims): x [B, C, ...],
gamma, beta [C], scale, shift [B, C] or None, mu, rstd [B, G]. Each wrapper
launches its kernel on CUDA tensors (and counts the launch) or raises; on
CPU tensors it computes its plain PyTorch twin, which repeats the kernel's
arithmetic. :class:`FusedGroupNormFunction` wires the two into autograd.

Numerics (as the TPU kernels, fused_norm.py:77-151): statistics in float32
with var = max(E[x^2] - E[x]^2, 0) (not Welford: the kernels and the JAX
reference sum x and x^2), then z = (x - mu) (rstd gamma) + beta, FiLM and
SiLU in float32 and one cast to x's dtype. The backward recomputes z from
the saved mu, rstd; dgamma and dbeta sum over the batch. It computes only
the gradients asked for (``grad_affine``, ``grad_film``), so that the
guided samplers' frozen classifier gets dx alone.
"""

from __future__ import annotations

import os
from math import prod
from typing import Optional, Tuple

import torch

from ._build import launch

__all__ = ["fused_group_norm", "group_norm_reference", "fused_norm_available",
           "FusedGroupNormFunction", "group_norm_fwd", "group_norm_bwd",
           "group_norm_fwd_plain", "group_norm_bwd_plain"]


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
    return None if t is None else t.float().reshape(shape).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernels move 16 bytes
    at a time)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def group_norm_fwd(x, gamma, beta, scale, shift, groups: int, eps: float,
                   silu: bool):
    """Forward kernel: (y [B, C, ...] in x's dtype, mu, rstd [B, G])."""
    _check(x, gamma, groups)
    if not _on_cuda(x, gamma, beta, scale, shift):
        return group_norm_fwd_plain(x, gamma, beta, scale, shift, groups,
                                    eps, silu)
    b, c = x.shape[:2]
    x = _aligned(x)
    hw = prod(x.shape[2:])
    gamma, beta = _f32(gamma, (c,)), _f32(beta, (c,))
    scale, shift = _f32(scale, (b, c)), _f32(shift, (b, c))
    y = torch.empty_like(x)
    mu = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    with torch.cuda.device(x.device):
        launch("group_norm_fwd", x.data_ptr(), gamma.data_ptr(),
               beta.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
               mu.data_ptr(), rstd.data_ptr(), b, c, hw, groups, int(silu),
               int(x.dtype == torch.bfloat16), float(eps))
    return y, mu, rstd


def group_norm_bwd(x, dy, gamma, beta, scale, shift, mu, rstd, groups: int,
                   silu: bool, *, grad_affine: bool = True,
                   grad_film: bool = True):
    """Backward kernel: (dx in x's dtype, dscale, dshift [B, C], dgamma,
    dbeta [C]), all float32 but dx. Only the gradients asked for are
    computed: dgamma, dbeta are None unless ``grad_affine`` (then the
    batch sum is not launched either), dscale, dshift None unless
    ``grad_film``."""
    _check(x, gamma, groups)
    if not _on_cuda(x, dy, gamma, beta, scale, shift, mu, rstd):
        return group_norm_bwd_plain(x, dy, gamma, beta, scale, shift, mu,
                                    rstd, groups, silu,
                                    grad_affine=grad_affine,
                                    grad_film=grad_film)
    b, c = x.shape[:2]
    x = _aligned(x)
    dy = _aligned(dy.to(x.dtype))
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
    with torch.cuda.device(x.device):
        launch("group_norm_bwd", x.data_ptr(), dy.data_ptr(),
               gamma.data_ptr(), beta.data_ptr(), _ptr(scale), _ptr(shift),
               mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(dscale),
               _ptr(dshift), _ptr(part_g), _ptr(part_b), _ptr(dgamma),
               _ptr(dbeta), b, c, x[0, 0].numel(), groups, int(silu),
               int(x.dtype == torch.bfloat16))
    return dx, dscale, dshift, dgamma, dbeta


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
