"""Classifier guidance: the gradient of the classifier's log-probability.

Port of autodiffusion_tpu/samplers/guidance.py::classifier_cond_fn
(search_imagenet64_classifier_guidance.py:319-326): the sum of the
per-example selected log-softmax, differentiated with torch.autograd.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["classifier_cond_fn"]


def classifier_cond_fn(classifier_fn: Callable, y: torch.Tensor,
                       scale: float = 1.0) -> Callable:
    """cond_fn(x, t) = scale * grad_x log p(y | x, t), with
    ``classifier_fn(x, t) -> logits [B, num_classes]``."""

    def cond_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            logp = F.log_softmax(classifier_fn(x_in, t).float(), dim=-1)
            selected = logp.gather(1, y[:, None]).sum()
            (grad,) = torch.autograd.grad(selected, x_in)
        return grad * scale

    return cond_fn
