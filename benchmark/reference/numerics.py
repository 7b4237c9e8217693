"""The reference's arithmetic, in one place: every product of the plain
models goes through a :class:`Numerics`, which says in what precision it
runs.

``Numerics()`` is the reference proper: float32, TF32 off (set by the
caller with :func:`exact_float32`). The controls of the correctness check
are the same models in a lower precision than the configuration states:
``Numerics(fp8=True)`` rounds both operands of every product (convs,
linears, the attention's two matrix products) to float8 e4m3 with a
per-tensor scale and multiplies in float32, which is an fp8 matrix unit
with a float32 accumulator; ``Numerics(dtype=torch.bfloat16)`` computes
in bfloat16. GroupNorm and softmax statistics are float32 in every mode.

``Numerics(sites=[])`` also appends one dict per attention and GroupNorm
call to ``sites``: the shapes the benchmark's roofline counts its work
from.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

__all__ = ["Numerics", "exact_float32"]

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in full float32 on the card (TF32 off) for the
    block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    x = x.float()
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Numerics:
    def __init__(self, dtype: torch.dtype = torch.float32, fp8: bool = False,
                 sites: Optional[List[dict]] = None):
        self.dtype = dtype
        self.fp8 = fp8
        self.sites = sites

    def note(self, op: str, **shape) -> None:
        if self.sites is not None:
            self.sites.append(dict(op=op, **shape))

    def _in(self, *xs):
        if self.fp8:
            return tuple(_fp8(x) for x in xs)
        return tuple(x.to(self.dtype) for x in xs)

    def conv2d(self, mod, x):
        x, w = self._in(x, mod.weight)
        return F.conv2d(x, w, mod.bias.to(w.dtype), mod.stride, mod.padding)

    def conv1d(self, mod, x):
        x, w = self._in(x, mod.weight)
        return F.conv1d(x, w, mod.bias.to(w.dtype))

    def linear(self, mod, x):
        x, w = self._in(x, mod.weight)
        return F.linear(x, w, mod.bias.to(w.dtype))

    def group_norm(self, mod, x, film: bool = False):
        """GroupNorm with float32 statistics, returned in the activations'
        dtype."""
        self.note("groupnorm", n=x.shape[0], c=x.shape[1],
                  hw=x[0, 0].numel(), groups=mod.num_groups, film=film,
                  grad=x.requires_grad)
        out = F.group_norm(x.float(), mod.num_groups, mod.weight.float(),
                           mod.bias.float(), mod.eps)
        return out.to(self.act_dtype)

    @property
    def act_dtype(self) -> torch.dtype:
        return torch.float32 if self.fp8 else self.dtype

    def attention(self, q, k, v, site: bool = True):
        """softmax(q^T k / sqrt(d)) v^T for q [n, d, t], k, v [n, d, s]
        (guided-diffusion's channels-first QKVAttention), softmax in
        float32 -> [n, d, t]."""
        n, d, t = q.shape
        if site:
            self.note("attention", n=n, t=t, s=k.shape[-1], d=d,
                      grad=q.requires_grad)
        scale = d ** -0.25
        qs, ks = self._in(q * scale, k * scale)
        w = torch.softmax(torch.einsum("ndt,nds->nts", qs, ks).float(), -1)
        w, vv = self._in(w, v)
        return torch.einsum("nts,nds->ndt", w, vv).to(self.act_dtype)
