"""Thin forwarding wrappers around the program's models, which the
benchmark hands to the program's entry points in their place.

Each counts its calls and the images they carry, and while ``tracing``
opens a profiler range (``bench.unet``, ``bench.classifier``,
``bench.features``) around the call, so the trace can say how much device
time each model took. Outside a traced window they add one Python call.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

__all__ = ["Counted", "FeatureTap"]


class _Tracing:
    tracing = False

    def _range(self):
        return (torch.profiler.record_function(self.range)
                if self.tracing else contextlib.nullcontext())


class Counted(nn.Module, _Tracing):
    """``inner`` called through: forward(*args, **kwargs) is
    inner(*args, **kwargs). ``layer_num`` is the inner model's."""

    def __init__(self, inner: nn.Module, range_name: str):
        super().__init__()
        self.inner = inner
        self.range = range_name
        self.layer_num = getattr(inner, "layer_num", None)
        self.reset()

    def reset(self):
        self.calls = 0
        self.images = 0

    def forward(self, x, *args, **kwargs):
        self.calls += 1
        self.images += x.shape[0]
        with self._range():
            return self.inner(x, *args, **kwargs)


class FeatureTap(_Tracing):
    """The fitness's feature_fn: the program's Inception on a batch of
    uint8 images, with each batch and its pool3 features kept on the
    device while ``keep`` is set, for the check after the window."""

    range = "bench.features"

    def __init__(self, feature_fn):
        self.feature_fn = feature_fn
        self.keep = False
        self.kept = []          # (uint8 images, pool3) a batch
        self.reset()

    def reset(self):
        self.calls = 0
        self.images = 0

    def __call__(self, images_uint8):
        self.calls += 1
        self.images += images_uint8.shape[0]
        with self._range():
            out = self.feature_fn(images_uint8)
        if self.keep:
            self.kept.append((images_uint8.clone(), out["pool3"].clone()))
        return out
