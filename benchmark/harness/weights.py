"""Seeded weights, made on the card in one draw.

The parameter names and shapes are those of the plain reference models
(built on the meta device, where they cost nothing), and the program's
models load the same tensors. One ``torch.randn`` on a generator on the
card fills every parameter of every model at once; each parameter is then
a view of that buffer, scaled in place: weights N(0, 1 / fan_in) (He's
N(0, 2 / fan_in) for the Inception's ReLU convs), biases N(0, 0.01^2)
(the Inception's folded biases N(0, 0.1^2)), GroupNorm scales
1 + N(0, 0.1^2), the label embedding N(0, 1). The output projections
that guided-diffusion starts at zero take the same N(0, 1 / fan_in), so
that every block carries signal and the images are not trivial. A model
may name parameters to be scaled further (the classifier's logits).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["seed_for", "make_weights"]


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and ``tags``."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)


def _scales(model: nn.Module, kind: str, extra: Dict[str, float]):
    """(name, shape, std, offset) for every parameter of ``model``."""
    norms = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, nn.GroupNorm)}
    out = []
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in norms:
            std, off = 0.1, 1.0
        elif name.endswith("bias"):
            std, off = (0.1 if kind == "inception" else 0.01), 0.0
        elif name == "label_emb.weight":
            std, off = 1.0, 0.0
        elif name.endswith("positional_embedding"):
            std, off = 1.0 / math.sqrt(shape[0]), 0.0
        else:
            fan_in = int(np.prod(shape[1:]))
            gain = 2.0 if kind == "inception" and ".conv." in name else 1.0
            std, off = math.sqrt(gain / fan_in), 0.0
        out.append((name, shape, std * extra.get(name, 1.0), off))
    return out


@torch.no_grad()
def make_weights(models: Dict[str, tuple], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: state dict} for ``models`` {model: (reference module on the
    meta device, kind, {parameter: further scale})}, float32 on
    ``device``, from one draw of a generator seeded by ``seed``."""
    plans = {key: _scales(m, kind, extra)
             for key, (m, kind, extra) in models.items()}
    total = sum(int(np.prod(s)) for plan in plans.values()
                for _, s, _, _ in plan)
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 1))
    flat = torch.randn(total, generator=gen, device=device)
    out, o = {}, 0
    for key, plan in plans.items():
        sd = {}
        for name, shape, std, off in plan:
            n = int(np.prod(shape))
            t = flat[o:o + n].view(shape)
            t.mul_(std)
            if off:
                t.add_(off)
            sd[name] = t
            o += n
        out[key] = sd
    return out
