"""Flash attention: hand-written Hopper kernels and their plain twins.

Port of autodiffusion_tpu/ops/flash_attention.py. The TPU package wrote the
forward (``_attn_kernel``), its head-packed small-head-dim variant
(``_attn_kernel_packed``) and the FlashAttention-2 backward (``_dq_kernel``,
``_dkv_kernel``) in Pallas; here they are CUDA C++ kernels in ``ops/csrc/``
(built by ``ops/_build.py`` with nvcc for sm_90a):

  flash_fwd         o, lse = softmax(q k^T / sqrt(D)) v, logsumexp, for
                    D in {16, 32, 64, 80, 128}, on [N, T, D] or on the
                    token-major [B, T, H * D] layout
  flash_fwd_wide    the same at D = 512 (the VAE mid-block's single head),
                    each logit computed once for all 512 output columns
  flash_fwd_packed  the same for D = 40 (padded to 48) on the token-major
                    [B, T, H * D] layout of the attention projections
  flash_bwd_dq      dq from (q, k, v, dO, lse, delta)
  flash_bwd_dkv     dk, dv from the same

:func:`flash_fwd` takes [N, T, D] q and [N, S, D] k, v (N = batch * heads),
or with ``heads`` H the token-major [B, T, H * D] q and [B, S, H * D] k, v,
and launches ``flash_fwd`` or, at D = 512 and one head, ``flash_fwd_wide``;
:func:`flash_fwd_packed` takes [B, T, H * D] q and [B, S, H * D] k, v; the
backward wrappers take [N, T, D] with D in {16, 32, 64, 128}. All take
float32 or bfloat16. On a CUDA tensor a wrapper launches its kernel (and
counts the launch in ``LAUNCHES``) or raises; on a CPU tensor it computes
its plain PyTorch twin, which repeats the kernel's arithmetic.
:class:`FlashAttentionFunction` wires forward and backward into autograd;
:func:`multihead_attention` is the forward-only entry of the Stable
Diffusion models, routing each head dim to its kernel. Each source holds
two kernels for its function: bfloat16 inputs run on the tensor cores
(every bfloat16 kernel, the three forwards and both backwards at every
head dim, issues wgmma on tiles that TMA copies into shared memory),
float32 inputs on the CUDA cores, where the products keep their float32
operands (the tensor cores would round them to TF32).

Numerics (as the TPU kernels): products of input-dtype operands summed in
float32, the 1/sqrt(D) scale applied to the float32 logits after the dot,
float32 softmax state, p (and dS) cast to the input dtype before the second
product, outputs in the input dtype, lse in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ._build import LAUNCHES, launch, reset_launch_counts

__all__ = ["flash_attention", "flash_attention_reference",
           "FlashAttentionFunction", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "flash_fwd_packed",
           "flash_fwd_packed_plain", "multihead_attention", "LAUNCHES",
           "reset_launch_counts", "SUPPORTED_HEAD_DIMS", "FWD_HEAD_DIMS",
           "PACKED_HEAD_DIMS", "WIDE_HEAD_DIM"]

# head dims of the backward kernels (and of FlashAttentionFunction)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
# head dims of the forward: flash_fwd, and flash_fwd_wide at WIDE_HEAD_DIM
FWD_HEAD_DIMS = (16, 32, 64, 80, 128)
WIDE_HEAD_DIM = 512
# head dims of flash_fwd_packed (the Stable Diffusion 64x64 level; the
# dims that are multiples of 16 take flash_fwd on the same layout)
PACKED_HEAD_DIMS = (40,)

def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


# ---------------------------------------------------------------- plain twins

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in plain PyTorch, [..., T, D] x [..., S, D].

    What the forward kernel computes: float32 logits from input-dtype
    operands (the upcast is exact, so this is the input-dtype dot summed in
    float32), the scale applied after the dot, float32 softmax, p cast to
    v's dtype before the PV product. Differentiable through autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def flash_fwd_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel: (o, lse)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = (e / l).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(v.dtype)
    return o, (m + torch.log(l))[..., 0]


def _probs(q, k, lse):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    return torch.exp(logits - lse[..., None])


def flash_bwd_dq_plain(q, k, v, dout, lse, delta) -> torch.Tensor:
    """Plain twin of the dQ kernel."""
    p = _probs(q, k, lse)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype)
    return (torch.matmul(ds.float(), k.float()) * _scale(q.shape[-1])) \
        .to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the dK/dV kernel."""
    p = _probs(q, k, lse)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(k.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) \
        * _scale(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers

def _check(q, k, v, *more, dims=SUPPORTED_HEAD_DIMS, head_dim=None):
    """Validate; True for CUDA tensors (launch), False for CPU (twin). The
    head dim is the last axis unless ``head_dim`` gives it."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [N, T, D] q and [N, S, D] k, v; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != d:
        raise ValueError(f"k and v must be [{n}, S, {d}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernels take float32 or bfloat16 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v) + more}
    if len(devs) != 1:
        raise ValueError(f"flash kernel inputs on several devices: {devs}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash kernels run on cuda (or their plain twins "
                         f"on cpu), not {dev}")
    d = d if head_dim is None else head_dim
    if dev.type == "cuda" and d not in dims:
        raise ValueError(f"head dim {d} has no flash kernel; built for "
                         f"{dims}")
    return dev.type == "cuda"


def _no_grad_wanted(*tensors) -> None:
    """The forward-only kernels give no gradient: refuse inputs that ask
    for one rather than cut the graph silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("this flash forward has no backward kernel; call "
                           "it under torch.no_grad() (or use "
                           "flash_attention for head dims "
                           f"{SUPPORTED_HEAD_DIMS})")


def _arg(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernels load 16 bytes
    at a time)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def flash_fwd(q, k, v, heads: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o in v's dtype, lse [N, T] float32) for [N, T, D] q
    and [N, S, D] k, v; with ``heads`` H > 1, (o [B, T, H * D], lse
    [B * H, T]) for the token-major [B, T, H * D] q and [B, S, H * D] k, v,
    read and written in that layout. The ``flash_fwd`` kernel for D in
    FWD_HEAD_DIMS, ``flash_fwd_wide`` for D = 512 (one head)."""
    d = _check_packed(q, k, v, heads)
    if not _check(q, k, v, dims=FWD_HEAD_DIMS + (WIDE_HEAD_DIM,),
                  head_dim=d):
        return flash_fwd_plain(q, k, v) if heads == 1 else \
            flash_fwd_packed_plain(q, k, v, heads)
    if d == WIDE_HEAD_DIM and heads != 1:
        raise ValueError("the D = 512 kernel takes one head; got "
                         f"{heads} heads")
    _no_grad_wanted(q, k, v)
    q, k, v = _arg(q), _arg(k), _arg(v)
    b, t, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * heads, t), dtype=torch.float32, device=q.device)
    dims = (b, t, k.shape[1], d) if d == WIDE_HEAD_DIM else \
        (b, heads, t, k.shape[1], d)
    with torch.cuda.device(q.device):
        launch("flash_fwd_wide" if d == WIDE_HEAD_DIM else "flash_fwd",
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), *dims, int(q.dtype == torch.bfloat16),
               _scale(d))
    return o, lse


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, H * D] -> [B * H, L, D]."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2) \
        .reshape(b * heads, n, hd // heads)


def _tokens_first(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B * H, L, D] -> [B, L, H * D]."""
    bh, n, d = x.shape
    return x.reshape(b, bh // b, n, d).transpose(1, 2).reshape(b, n, -1)


def flash_fwd_packed_plain(q, k, v, heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the packed forward kernel: (o [B, T, H * D], lse
    [B * H, T])."""
    o, lse = flash_fwd_plain(_heads_first(q, heads), _heads_first(k, heads),
                             _heads_first(v, heads))
    return _tokens_first(o, q.shape[0]), lse


def _check_packed(q, k, v, heads: int) -> int:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("the token-major forwards take [B, T, H * D] q and "
                         f"[B, S, H * D] k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hd = q.shape
    if heads < 1 or hd % heads or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"{heads} heads do not split q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return hd // heads


def flash_fwd_packed(q, k, v, heads: int, *, _raw_pad: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed forward kernel: (o [B, T, H * D] in v's dtype, lse [B * H, T]
    float32) for token-major q [B, T, H * D] and k, v [B, S, H * D], read
    and written in that layout. ``_raw_pad`` (kernel checks only) makes the
    kernel read a padded head dim's padding from memory instead of zeroing
    it."""
    d = _check_packed(q, k, v, heads)
    if not _check(q, k, v, dims=PACKED_HEAD_DIMS, head_dim=d):
        return flash_fwd_packed_plain(q, k, v, heads)
    _no_grad_wanted(q, k, v)
    q, k, v = _arg(q), _arg(k), _arg(v)
    b, t, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * heads, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        launch("flash_fwd_packed", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               o.data_ptr(), lse.data_ptr(), b, heads, t, k.shape[1], d,
               int(q.dtype == torch.bfloat16), int(_raw_pad), _scale(d))
    return o, lse


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head, forward only, for token-major
    q [B, T, H * D] and k, v [B, S, H * D] -> [B, T, H * D]: the attention
    of the Stable Diffusion models (CrossAttention, VAEAttnBlock). Each head
    dim goes to its kernel, self- and cross-attention alike and whatever
    the token count: D = 40 (the SD 64x64 level) to ``flash_fwd_packed``
    and D in FWD_HEAD_DIMS (the SD 32x32 level's D = 80) to ``flash_fwd``,
    both on the layout as it is; D = 512 (the VAE mid-block's one head,
    or several) to ``flash_fwd_wide`` on [B * H, T, D]. Other head dims (the SD 16x16 and
    8x8 levels' D = 160) are plain PyTorch on [B * H, T, D], as the JAX
    package computes them outside its kernels. CPU tensors take the
    twins."""
    d = _check_packed(q, k, v, heads)
    if d in PACKED_HEAD_DIMS:
        return flash_fwd_packed(q, k, v, heads)[0]
    if d in FWD_HEAD_DIMS:
        return flash_fwd(q, k, v, heads=heads)[0]
    qh, kh, vh = (_heads_first(z, heads) for z in (q, k, v))
    if d == WIDE_HEAD_DIM:
        o = flash_fwd(qh, kh, vh)[0]
    else:
        o = flash_attention_reference(qh, kh, vh)
    return _tokens_first(o, q.shape[0])


def flash_bwd_dq(q, k, v, dout, lse, delta) -> torch.Tensor:
    """dQ kernel: dq [N,T,D] in q's dtype."""
    if not _check(q, k, v, dout, lse, delta):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta)
    q, k, v, dout = _arg(q), _arg(k), _arg(v), _arg(dout.to(q.dtype))
    lse, delta = _arg(lse.float()), _arg(delta.float())
    n, t, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), n, t, k.shape[1], d,
                int(q.dtype == torch.bfloat16), _scale(d))
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: (dk, dv) [N,S,D] in k's dtype."""
    if not _check(q, k, v, dout, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta)
    q, k, v, dout = _arg(q), _arg(k), _arg(v), _arg(dout.to(q.dtype))
    lse, delta = _arg(lse.float()), _arg(delta.float())
    n, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), n, t, k.shape[1], d,
                int(q.dtype == torch.bfloat16), _scale(d))
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd around the three kernels ([N, T, D] q, [N, S, D] k, v).

    The forward saves q, k, v, o and lse; the backward computes
    delta = rowsum(dO * O) in PyTorch (as the TPU path does outside its
    kernels) and launches the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        delta = (dout.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for q [..., T, D] and k, v [..., S, D].

    On CUDA tensors: the flash kernels, differentiable through
    :class:`FlashAttentionFunction`. On CPU tensors: the plain twin
    :func:`flash_attention_reference` (autograd gives its gradient)."""
    lead = q.shape[:-2]
    if q.device.type == "cpu":
        _check(q.reshape(-1, *q.shape[-2:]), k.reshape(-1, *k.shape[-2:]),
               v.reshape(-1, *v.shape[-2:]))
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    out = FlashAttentionFunction.apply(q.reshape(-1, *q.shape[-2:]),
                                       k.reshape(-1, *k.shape[-2:]),
                                       v.reshape(-1, *v.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])
