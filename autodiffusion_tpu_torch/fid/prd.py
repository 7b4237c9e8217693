"""Improved precision and recall by manifold estimation.

Port of autodiffusion_tpu/fid/prd.py (evaluations/evaluator_v1.py:
282-507, ManifoldEstimator / DistanceBlock): each feature's manifold radius
is the squared distance to its k-th nearest neighbour in its own set
(k = 3); precision is the share of sample features inside some reference
sphere, recall the reverse. The pairwise distances run in float32 blocks
on the features' device, with TF32 off (ROADMAP rule 5: features are
reduced at full precision).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import no_tf32

__all__ = ["pairwise_sq_distances", "manifold_radii", "precision_recall"]


def pairwise_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D], [M, D] -> [N, M] squared L2 distances (float32)."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    with no_tf32():
        d = a2 + b2.T - 2.0 * (a @ b.T)
    return d.clamp_min(0.0)


def manifold_radii(feats: torch.Tensor, nhood_size: int = 3,
                   block: int = 2048) -> torch.Tensor:
    """[N] squared distance of each feature to its ``nhood_size``-th
    nearest neighbour, itself (distance 0) not counted."""
    out = []
    for i in range(0, feats.shape[0], block):
        d = pairwise_sq_distances(feats[i:i + block], feats)
        out.append(torch.kthvalue(d, nhood_size + 1, dim=1).values)
    return torch.cat(out)


def _fraction_covered(probes: torch.Tensor, refs: torch.Tensor,
                      ref_radii: torch.Tensor, block: int = 2048) -> float:
    covered = 0
    for i in range(0, probes.shape[0], block):
        d = pairwise_sq_distances(probes[i:i + block], refs)
        covered += int((d <= ref_radii[None, :]).any(dim=1).sum())
    return covered / probes.shape[0]


def precision_recall(ref_feats: torch.Tensor, sample_feats: torch.Tensor,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """(precision, recall) of [N, D] sample features against [M, D]
    reference features on one device (evaluator_v1.py:414-461)."""
    ref_radii = manifold_radii(ref_feats, nhood_size)
    sample_radii = manifold_radii(sample_feats, nhood_size)
    precision = _fraction_covered(sample_feats, ref_feats, ref_radii)
    recall = _fraction_covered(ref_feats, sample_feats, sample_radii)
    return precision, recall
