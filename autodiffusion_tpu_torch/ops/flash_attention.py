"""Flash attention: three hand-written Hopper kernels and their plain twins.

Port of autodiffusion_tpu/ops/flash_attention.py. The TPU package wrote the
forward (``_attn_kernel``) and the FlashAttention-2 backward
(``_dq_kernel``, ``_dkv_kernel``) in Pallas; here they are CUDA C++ kernels
in ``ops/csrc/`` (built by ``ops/_build.py`` with nvcc for sm_90a):

  flash_fwd       o, lse = softmax(q k^T / sqrt(D)) v, logsumexp
  flash_bwd_dq    dq from (q, k, v, dO, lse, delta)
  flash_bwd_dkv   dk, dv from the same

Each wrapper takes [N, T, D] q / dO and [N, S, D] k / v (N = batch * heads)
in float32 or bfloat16 with D in {16, 32, 64, 128}. On a CUDA tensor it
launches its kernel (and counts the launch in ``LAUNCHES``) or raises; on a
CPU tensor it computes its plain PyTorch twin, which repeats the kernel's
arithmetic. :class:`FlashAttentionFunction` wires the three into autograd.
Each source holds two kernels for its function: bfloat16 inputs run on the
tensor cores (mma.sync), float32 inputs on the CUDA cores, where the
products keep their float32 operands (the tensor cores would round them to
TF32).

Numerics (as the TPU kernels): products of input-dtype operands summed in
float32, the 1/sqrt(D) scale applied to the float32 logits after the dot,
float32 softmax state, p (and dS) cast to the input dtype before the second
product, outputs in the input dtype, lse in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_reference",
           "FlashAttentionFunction", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_dq_plain",
           "flash_bwd_dkv_plain", "LAUNCHES", "reset_launch_counts",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

# kernel name -> launches since the last reset (one per kernel launch)
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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

def _check(q, k, v, *more):
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
    if dev.type == "cuda" and d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no flash kernel; built for "
                         f"{SUPPORTED_HEAD_DIMS}")
    return dev.type == "cuda"


def _arg(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernels load 16 bytes
    at a time)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _launch(stem: str, *args) -> None:
    from ._build import SOURCES, library

    fn = getattr(library(stem), SOURCES[stem][0])
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{stem} kernel launch failed with CUDA error "
                           f"{rc}" + (" (unsupported head dim)" if rc == -1
                                      else ""))
    LAUNCHES[stem] += 1


def flash_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o [N,T,D] in v's dtype, lse [N,T] float32)."""
    if not _check(q, k, v):
        return flash_fwd_plain(q, k, v)
    q, k, v = _arg(q), _arg(k), _arg(v)
    n, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(), n, t, k.shape[1], d,
                int(q.dtype == torch.bfloat16), _scale(d))
    return o, lse


def flash_bwd_dq(q, k, v, dout, lse, delta) -> torch.Tensor:
    """dQ kernel: dq [N,T,D] in q's dtype."""
    if not _check(q, k, v, dout, lse, delta):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta)
    q, k, v, dout = _arg(q), _arg(k), _arg(v), _arg(dout.to(q.dtype))
    lse, delta = _arg(lse.float()), _arg(delta.float())
    n, t, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
        _launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
