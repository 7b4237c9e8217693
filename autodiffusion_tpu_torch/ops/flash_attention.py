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

Routing (:func:`routed_attention`, the one dispatch of both attention
sites of the models, ``AttentionBlock`` and :func:`multihead_attention`,
asks :func:`attention_route` for each call's route): on the
card a site goes to its kernel where one exists for its head dim (the
forward's dims, or the backward's where a gradient is wanted) and the
flash gate keeps it there; every other site goes to
``torch.nn.functional.scaled_dot_product_attention``, the library path
(the JAX package computes the head dims it has no kernel for outside its
kernels, in plain einsum). The gate is a table of site shapes measured on
an H100, :data:`FLASH_GATE_SDPA`; ``ADT_FLASH_GATE=0`` keeps every kernel
on (the A/B's "kernels" arm). On the CPU a site with a kernel takes its
wrapper (which computes the twin) and every other site the plain twin.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import LAUNCHES, launch, reset_launch_counts

__all__ = ["flash_attention", "flash_attention_reference",
           "FlashAttentionFunction", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "flash_fwd_packed",
           "flash_fwd_packed_plain", "multihead_attention", "LAUNCHES",
           "reset_launch_counts", "SUPPORTED_HEAD_DIMS", "FWD_HEAD_DIMS",
           "PACKED_HEAD_DIMS", "WIDE_HEAD_DIM", "attention_route",
           "flash_gate_on", "FLASH_GATE_SDPA", "REPRO_KERNEL_SITES",
           "routed_attention"]

# head dims of the backward kernels (and of FlashAttentionFunction)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
# head dims of the forward: flash_fwd, and flash_fwd_wide at WIDE_HEAD_DIM
FWD_HEAD_DIMS = (16, 32, 64, 80, 128)
WIDE_HEAD_DIM = 512
# head dims of flash_fwd_packed (the Stable Diffusion 64x64 level; the
# dims that are multiples of 16 take flash_fwd on the same layout)
PACKED_HEAD_DIMS = (40,)
# every head dim some forward kernel takes (the packed kernel's D = 40 on
# either layout: [N, T, D] is the token-major layout with one head)
FORWARD_KERNEL_DIMS = FWD_HEAD_DIMS + PACKED_HEAD_DIMS + (WIDE_HEAD_DIM,)

# The flash gate: the attention sites, (T, S, D, heads a sample, gradient
# wanted), at which SDPA took less device time than the kernels in both
# rounds of chip_smoke.py's A/B (phase_flash_ab) by more than the rounds'
# spread, inside the program that owns the site, in two A/B runs on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5, "The flash gate"). A
# site with a gradient is decided forward and backward together (SDPA's
# backward needs SDPA's forward). Every other site with a kernel keeps it.
# The sites of REPRO_KERNEL_SITES are never on it (see there).
FLASH_GATE_SDPA = frozenset({
    # the guided DDIM step: the UNet's 16 x 16 level
    (256, 256, 64, 9, False),
    # the ADM-64 and SR training steps: every site
    (64, 64, 64, 12, True), (256, 256, 64, 9, True),
    (1024, 1024, 64, 6, True), (256, 256, 64, 12, True),
    # the SD UNet call: the 64 x 64 level's D = 40 self- and
    # cross-attention, the 32 x 32 level's cross-attention
    (4096, 4096, 40, 8, False), (4096, 77, 40, 8, False),
    (1024, 77, 80, 8, False),
    # the LSUN-256 UNet call: the 16 x 16 level (one A/B run, two rounds)
    (256, 256, 64, 16, False),
})

# The sites that keep their kernels for reproducibility, though SDPA took
# less time there in the A/B: the ADM-64 classifier's three sites with the
# input's gradient, (1024, 4), (256, 6) and (64, 8) heads (the guided step,
# and train-classifier's step, which shares their shapes). SDPA's backward
# is not deterministic on the card, so two guided runs from one seed
# differed, while the flash forward, dQ and dK/dV kernels give the same
# bits every run. Their cost: a 4-step batch-32 guided DDIM run took 215.87
# ms of device time with them on the kernels against 211.69 with them on
# SDPA (chip_smoke.py --guided-repro), 2.0 %. The rule is by shape: a
# gradient site of another model that should repeat bit for bit belongs
# here, and a gate entry equal to one of these raises at import.
REPRO_KERNEL_SITES = frozenset({
    (1024, 1024, 64, 4, True), (256, 256, 64, 6, True),
    (64, 64, 64, 8, True),
})
if FLASH_GATE_SDPA & REPRO_KERNEL_SITES:
    raise ValueError(f"the flash gate holds sites kept on the kernels for "
                     f"reproducibility: "
                     f"{sorted(FLASH_GATE_SDPA & REPRO_KERNEL_SITES)}")


def flash_gate_on() -> bool:
    """False under ``ADT_FLASH_GATE=0``: every site with a kernel keeps
    it (the A/B's "kernels" arm). Read at every call."""
    return os.environ.get("ADT_FLASH_GATE", "1") != "0"


def attention_route(t: int, s: int, d: int, heads: int, grad: bool,
                    device) -> str:
    """Where one attention call of T queries, S keys, head dim D and
    ``heads`` heads a sample runs: "kernel" (the flash wrappers), "sdpa"
    (``F.scaled_dot_product_attention``) or "twin" (the plain twin).

    A kernel exists for D in the forward kernels' dims, or, where a
    gradient is wanted, the backward kernels' (SUPPORTED_HEAD_DIMS). On
    CUDA a site without a kernel takes SDPA, and so does a site in
    :data:`FLASH_GATE_SDPA` unless ``ADT_FLASH_GATE=0``. On the CPU a site
    with a kernel takes the wrappers (their twins), any other the twin.
    The meta device, where the shapes of a run are read, takes the card's
    routes. A rule on the shape: a kernel that fails to build or launch
    raises."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"attention runs on cuda (or its plain twins on "
                         f"cpu), not {dev}")
    kernel = d in (SUPPORTED_HEAD_DIMS if grad else FORWARD_KERNEL_DIMS)
    if dev.type == "cpu":
        return "kernel" if kernel else "twin"
    if kernel and not (flash_gate_on()
                       and (t, s, d, heads, grad) in FLASH_GATE_SDPA):
        return "kernel"
    return "sdpa"


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
    """softmax(q k^T / sqrt(D)) v per head for token-major q [B, T, H * D]
    and k, v [B, S, H * D] -> [B, T, H * D]: the attention of the Stable
    Diffusion models (CrossAttention, VAEAttnBlock), through
    :func:`routed_attention`. Forward only, as the models that call it
    run: the forward kernels refuse inputs that want a gradient."""
    return routed_attention(q, k, v, heads, tokens_first=True)


def routed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, tokens_first: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v at one attention site of the models, on
    the route :func:`attention_route` gives the site: the one dispatch of
    ``AttentionBlock`` (heads first: q [B * heads, T, D] and k, v
    [B * heads, S, D], any strides; the gradient flows where one is
    wanted) and :func:`multihead_attention` (``tokens_first``: q
    [B, T, heads * D] and k, v [B, S, heads * D], forward only).

    The kernel route, heads first: :func:`flash_attention` where a
    gradient is wanted, else the forward kernel of the head dim. Tokens
    first: D = 40 (the SD 64x64 level) to ``flash_fwd_packed`` and D in
    FWD_HEAD_DIMS (the SD 32x32 level's D = 80) to ``flash_fwd``, both on
    the layout as it is; D = 512 (the VAE mid-block's one head, or
    several) to ``flash_fwd_wide`` on [B * H, T, D]. SDPA (on the card)
    and the plain twin (on the CPU) take [B, heads, T, D]: heads first
    made contiguous, since SDPA's fused kernels want the head dim
    innermost (3-D or strided inputs send it to its math path)."""
    if tokens_first:
        d = _check_packed(q, k, v, heads)
        grad = False
    else:
        d = q.shape[-1]
        grad = torch.is_grad_enabled() and any(z.requires_grad
                                               for z in (q, k, v))
    key = (q.shape[1], k.shape[1], d, heads, grad)
    return _attend(key, attention_route(*key, q.device), q, k, v,
                   tokens_first)


def _attend(key, route: str, q, k, v, tokens_first: bool) -> torch.Tensor:
    """The work of one site of :func:`routed_attention` on ``route``."""
    t, _, d, heads, grad = key
    if route == "kernel" and not tokens_first:
        q, k, v = (z.contiguous() for z in (q, k, v))
        if grad:
            return flash_attention(q, k, v)
        if d in PACKED_HEAD_DIMS:
            return flash_fwd_packed(q, k, v, 1)[0]
        return flash_fwd(q, k, v)[0]
    if route == "kernel":
        if d in PACKED_HEAD_DIMS:
            return flash_fwd_packed(q, k, v, heads)[0]
        if d in FWD_HEAD_DIMS:
            return flash_fwd(q, k, v, heads=heads)[0]
        qh, kh, vh = (_heads_first(z, heads) for z in (q, k, v))
        return _tokens_first(flash_fwd(qh, kh, vh)[0], q.shape[0])
    if tokens_first:
        b = q.shape[0]
        q4, k4, v4 = (z.reshape(b, z.shape[1], heads, d).transpose(1, 2)
                      for z in (q, k, v))
    else:
        b = q.shape[0] // heads
        q4, k4, v4 = (z.contiguous().view(b, heads, z.shape[1], d)
                      for z in (q, k, v))
    o = F.scaled_dot_product_attention(q4, k4, v4) if route == "sdpa" \
        else flash_attention_reference(q4, k4, v4)
    if tokens_first:
        return o.transpose(1, 2).reshape(b, t, heads * d)
    return o.reshape(b * heads, t, d)


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
