"""Inception features of uint8 images (port of autodiffusion_tpu/fid/
evaluator.py::inception_apply)."""

from __future__ import annotations

from typing import Dict

import torch

from .inception import FIDInceptionV3, preprocess

__all__ = ["inception_apply"]


@torch.no_grad()
def inception_apply(model: FIDInceptionV3, images_uint8: torch.Tensor,
                    resize_to: int = 299) -> Dict[str, torch.Tensor]:
    """uint8 NHWC images -> dict(pool3, spatial, logits) from ``model``
    (on the model's device)."""
    dev = next(model.parameters()).device
    return model(preprocess(images_uint8.to(dev), resize_to))
