"""The numbers the correctness check compares, each against its limit.

``image_gap``: the mean absolute difference, in uint8 levels, between
the images the program delivered and the reference's images from the
same inputs, over every checked image (``image_gap_max``, the largest of
one image, is logged beside it: under strong guidance a single image
can swing by ten levels where the classifier's top two logits nearly
tie). ``feature_gap``: over the
checked images, the largest relative L2 distance between the pool3
features the program folded into its moments and the reference
Inception's of the same image. ``fid_gap``: over the candidates of the
checked fitness calls, the largest relative distance between the FID the
program returned and the reference's float64 FID of the same features.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["image_gaps", "feature_gap", "rel_gap", "verdict", "passed",
           "lines"]


def image_gaps(got_u8: torch.Tensor, want_u8: torch.Tensor):
    """(image_gap, image_gap_max)."""
    d = (got_u8.float() - want_u8.float().to(got_u8.device)).abs()
    per_image = d.reshape(d.shape[0], -1).mean(dim=1)
    return float(per_image.mean()), float(per_image.max())


def feature_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double().to(got.device)
    return float(((got - want).norm(dim=1)
                  / want.norm(dim=1).clamp_min(1e-30)).max())


def rel_gap(got, want) -> float:
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def verdict(values: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """{number: {"value", "limit"}} of every number the limits name; a
    number the run could not read is infinite."""
    return {k: {"value": values.get(k, float("inf")),
                "limit": float(v["limit"])} for k, v in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def lines(checks: dict):
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]
