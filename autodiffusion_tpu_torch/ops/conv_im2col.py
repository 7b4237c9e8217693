"""3x3 convolutions as implicit GEMMs: two hand-written Hopper kernels and
their plain twins.

Port of autodiffusion_tpu/ops/conv_im2col.py. The TPU package wrote the
im2col conv (``_conv_kernel``) and the norm-act-conv that takes the
ResBlock's GroupNorm, FiLM, SiLU and residual into the conv's own pass
(``_fused_conv_kernel``) in Pallas; here they are CUDA C++ kernels in
``ops/csrc/`` (built by ``ops/_build.py`` with nvcc for sm_90a):

  conv3x3         y = conv3x3(x) + bias
  conv3x3_fused   y = conv3x3(silu(x a + b) cast to x's dtype) + bias
                      (+ residual)

Layout: NCHW activations and OIHW weights, the port's own (the TPU kernels
take NHWC and HWIO). The kernels read and write NCHW directly
(csrc/conv3x3.cuh), so no copy of an activation surrounds a call; the
weights go to the kernels as [C_out, 3, 3, C_in], one small copy a call.
Stride 1, SAME padding, float32 or bfloat16, one dtype for x, w and the
output; bias, a, b float32. Each wrapper launches
its kernel on CUDA tensors (and counts the launch) or raises; on CPU
tensors it computes its plain twin.

Numerics: products of x.dtype operands summed in float32, the bias (and in
the fused kernel the residual) added to the float32 sum, one cast. The
plain twins compute the conv in float32 from the same operands. The fused
twin :func:`fused_conv_reference` mirrors the JAX oracle ``_xla_fused_ref``
(conv_im2col.py:460-473): the residual is added after the cast of the conv
output, so in bfloat16 kernel and twin may differ by one rounding there.

Gradients: :func:`conv3x3` differentiates with PyTorch's conv gradients
(``torch.nn.grad``), and :func:`conv3x3_fused` with autograd of its plain
twin, as the JAX package differentiates both outside Pallas
(conv_im2col.py:493-512,601-608).

Gates: :func:`resolve_use_im2col` and :func:`resolve_use_fused_conv` decide
from the channels, the dtype and the environment alone, each one switch
that turns on every eligible site. What the JAX gates took from TPU
measurements or from VMEM and Mosaic legality (measured whitelists, block
pickers, the TPU-backend test) is not carried over: a per-site whitelist
comes back only when an H100 A/B finds a site where a kernel wins.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import launch

__all__ = ["conv3x3", "conv3x3_im2col", "conv3x3_reference", "conv3x3_fused",
           "conv3x3_fused_kernel", "fused_conv_reference", "Conv3x3Function",
           "Conv3x3FusedFunction", "resolve_use_im2col",
           "resolve_use_fused_conv"]

def _eligible(c_in: int, c_out: int, dtype) -> bool:
    # tiny contractions (the RGB stem, K = 27) or outputs (the final
    # projection, C_out = 6) leave the tensor cores idle, as in the JAX
    # gate; C_in % 8 keeps the kernels' 16-byte weight loads aligned
    return (c_in >= 64 and c_out >= 64 and c_in % 8 == 0
            and dtype in (torch.float32, torch.bfloat16))


def resolve_use_im2col(c_in: int, c_out: int,
                       dtype=torch.bfloat16) -> bool:
    """Gate of the im2col conv at one Conv3x3 site: every eligible site
    where ``ADT_IM2COL_CONV=1``, none where it is unset or anything else."""
    return (os.environ.get("ADT_IM2COL_CONV") == "1"
            and _eligible(c_in, c_out, dtype))


def resolve_use_fused_conv(c_in: int, c_out: int,
                           dtype=torch.bfloat16) -> bool:
    """Gate of the fused norm-act-conv at one ResBlock norm-conv pair:
    every eligible site where ``ADT_FUSED_CONV=all``, none where it is
    unset or anything else."""
    return (os.environ.get("ADT_FUSED_CONV") == "all"
            and _eligible(c_in, c_out, dtype))


# ---------------------------------------------------------------- plain twins

def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the conv kernel: the conv of x.dtype operands in
    float32, plus the bias in float32, cast once to x.dtype."""
    b = None if bias is None else bias.float()
    return F.conv2d(x.float(), w.float(), b, padding=1).to(x.dtype)


def fused_conv_reference(x, a, b, w, bias=None, residual=None):
    """Plain twin of the fused conv, the JAX oracle's order
    (conv_im2col.py:460-473): silu(x a + b) in float32 cast to x.dtype,
    the conv (float32 sum, bias, one cast), then the residual added in
    x.dtype. Differentiable through autograd."""
    xf = x.float() * a[:, :, None, None] + b[:, :, None, None]
    out = conv3x3_reference((xf * torch.sigmoid(xf)).to(x.dtype), w, bias)
    return out if residual is None else out + residual


# ------------------------------------------------------------------ wrappers

def _check(x, w, *more) -> bool:
    """Validate; True for CUDA tensors (launch), False for CPU (twin)."""
    if x.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"3x3 conv kernels take x [B, C_in, H, W] and w "
                         f"[C_out, C_in, 3, 3]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"3x3 conv kernels take float32 or bfloat16 x and w "
                        f"of one dtype; got {x.dtype}, {w.dtype}")
    devs = {t.device for t in (x, w) + more if t is not None}
    if len(devs) != 1:
        raise ValueError(f"3x3 conv inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"3x3 conv kernels run on cuda (or their plain twins "
                         f"on cpu), not {dev}")
    if dev.type == "cuda" and x.shape[1] % 8:
        raise ValueError(f"C_in = {x.shape[1]}: the 3x3 conv kernels need a "
                         "multiple of 8")
    return dev.type == "cuda"


def _arg(t: Optional[torch.Tensor], dtype=None) -> Optional[torch.Tensor]:
    """Contiguous, in ``dtype`` if given, with a 16-byte aligned start
    (the kernels load weights 16 bytes at a time)."""
    if t is None:
        return None
    t = (t if dtype is None else t.to(dtype)).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv kernel: [B, C_in, H, W] x [C_out, C_in, 3, 3] -> [B, C_out,
    H, W] in x's dtype (forward only)."""
    if not _check(x, w, bias):
        return conv3x3_reference(x, w, bias)
    # the kernels take the weights as [C_out, 3, 3, C_in] (csrc/conv3x3.cuh)
    x, w, bias = _arg(x), _arg(w.permute(0, 2, 3, 1)), _arg(bias,
                                                            torch.float32)
    bsz, c_in, h, wd = x.shape
    y = torch.empty((bsz, w.shape[0], h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        launch("conv3x3", x.data_ptr(), w.data_ptr(), _ptr(bias),
               y.data_ptr(), bsz, c_in, h, wd, w.shape[0],
               int(x.dtype == torch.bfloat16))
    return y


def conv3x3_fused_kernel(x, a, b, w, bias=None, residual=None):
    """The fused conv kernel: conv3x3(silu(x a + b)) + bias (+ residual),
    a, b [B, C_in] float32, residual [B, C_out, H, W] (forward only)."""
    on_cuda = _check(x, w, a, b, bias, residual)
    bsz, c_in, h, wd = x.shape
    c_out = w.shape[0]
    if a.shape != (bsz, c_in) or b.shape != (bsz, c_in):
        raise ValueError(f"a, b must be [{bsz}, {c_in}]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if residual is not None and residual.shape != (bsz, c_out, h, wd):
        raise ValueError(f"residual must be [{bsz}, {c_out}, {h}, {wd}]; "
                         f"got {tuple(residual.shape)}")
    if not on_cuda:
        return fused_conv_reference(x, a, b, w, bias, residual)
    x, w = _arg(x), _arg(w.permute(0, 2, 3, 1))
    a, b, bias = (_arg(t, torch.float32) for t in (a, b, bias))
    residual = _arg(residual, x.dtype)
    y = torch.empty((bsz, c_out, h, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        launch("conv3x3_fused", x.data_ptr(), a.data_ptr(), b.data_ptr(),
               w.data_ptr(), _ptr(bias), _ptr(residual), y.data_ptr(), bsz,
               c_in, h, wd, c_out, int(x.dtype == torch.bfloat16))
    return y


class Conv3x3Function(torch.autograd.Function):
    """The conv kernel forward; PyTorch's conv gradients backward (in the
    dtype of x and w, as the JAX package's XLA conv VJP)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv3x3_im2col(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1) \
            if need_x else None
        dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1) \
            if need_w else None
        db = g.float().sum(dim=(0, 2, 3)).to(ctx.bias_dtype) \
            if need_b and ctx.has_bias else None
        return dx, dw, db


class Conv3x3FusedFunction(torch.autograd.Function):
    """The fused conv kernel forward; autograd of the plain twin
    :func:`fused_conv_reference` backward (conv_im2col.py:493-512)."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, residual):
        ctx.save_for_backward(x, a, b, w, bias, residual)
        return conv3x3_fused_kernel(x, a, b, w, bias, residual)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wants = [t is not None and need
                 for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(want) if t is not None
                      else None for t, want in zip(saved, wants)]
            out = fused_conv_reference(*leaves)
            inputs = [t for t, want in zip(leaves, wants) if want]
            grads = iter(torch.autograd.grad(out, inputs, g.to(out.dtype)))
        return tuple(next(grads) if want else None for want in wants)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias through the conv kernel (its twin on
    CPU tensors), differentiable."""
    return Conv3x3Function.apply(x, w, bias)


def conv3x3_fused(x, a, b, w, bias=None, residual=None) -> torch.Tensor:
    """silu(x a + b) -> 3x3 SAME conv -> + bias (+ residual) through the
    fused conv kernel (its twin on CPU tensors), differentiable."""
    return Conv3x3FusedFunction.apply(x, a, b, w, bias, residual)
