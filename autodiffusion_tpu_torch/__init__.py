"""AutoDiffusion on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``autodiffusion_tpu`` beside it, module for
module. The JAX package stays the reference the port is tested against;
this package never imports it, nor JAX.

Precision policy (as the JAX package's, models/nn.py and docs/DESIGN.md):
parameters are float32. With ``use_bf16`` a model computes in bfloat16,
casting each parameter to the compute dtype where it is used (flax's
``promote_dtype``). GroupNorm statistics, softmax and the timestep
embedding stay float32.

Devices: every entry point takes an explicit ``device`` and runs on
``cuda`` by default. Without CUDA it raises unless the caller asked for
the CPU; there is no silent CPU path.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "compute_dtype", "no_tf32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def compute_dtype(use_bf16: bool) -> torch.dtype:
    """The activation dtype of a model under the precision policy."""
    return torch.bfloat16 if use_bf16 else torch.float32


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in full float32 (no TF32) for the block:
    where a product's rounding decides a discrete result (an argmin, a
    precision / recall radius) or a statistic needs every bit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
