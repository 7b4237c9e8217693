"""FID evaluator: Inception activations of uint8 arrays, then FID, IS, sFID
and precision / recall against reference statistics or features.

Port of autodiffusion_tpu/fid/evaluator.py (evaluations/evaluator_v1.py:
249-280 compute_activations, :730-753 cal_fid). The Inception runs on the
model's device, a batch at a time (the last one at its own size); the
features stay there for precision / recall and go to the host in float64
for the moments and the Frechet distance.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .inception import FIDInceptionV3, preprocess
from .prd import precision_recall
from .stats import FIDStats, frechet_distance, inception_score

__all__ = ["FIDEvaluator", "make_inception_feature_fn", "inception_apply"]


@torch.no_grad()
def inception_apply(model: FIDInceptionV3, images_uint8: torch.Tensor,
                    resize_to: int = 299) -> Dict[str, torch.Tensor]:
    """uint8 NHWC images -> dict(pool3, spatial, logits) from ``model``
    (on the model's device)."""
    dev = next(model.parameters()).device
    return model(preprocess(images_uint8.to(dev), resize_to))


def make_inception_feature_fn(model: FIDInceptionV3, *,
                              resize_to: int = 299) -> Callable:
    """feature_fn(uint8 NHWC [B, H, W, 3]) -> dict(pool3, spatial,
    logits), without gradients, on ``model``'s device."""

    def feature_fn(images_uint8):
        return inception_apply(model, torch.as_tensor(images_uint8),
                               resize_to)

    return feature_fn


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class FIDEvaluator:
    """FID (and IS, sFID, precision / recall) of sample arrays against
    precomputed reference statistics.

    feature_fn: batched uint8 NHWC -> dict with at least "pool3" (tensors);
    any extractor works, the real InceptionV3 or a stub in tests.
    """

    def __init__(self, feature_fn: Callable, ref_stats: Optional[FIDStats],
                 ref_stats_spatial: Optional[FIDStats] = None,
                 batch_size: int = 100):
        self.feature_fn = feature_fn
        self.ref_stats = ref_stats
        self.ref_stats_spatial = ref_stats_spatial
        self.batch_size = batch_size

    def compute_activations(self, arr_uint8: np.ndarray,
                            want_softmax: bool = False,
                            want_spatial: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
        """[N, H, W, 3] uint8 -> (pool3 [N, 2048], softmax [N, 1008] or
        None, spatial [N, 2023] or None), float32 on the features' device.
        spatial holds the sFID features, the first 7 channels of the
        17 x 17 grid flattened channels-last as the JAX package flattens
        them (evaluator_v1.py:665-679), so their statistics interchange."""
        pools, smx, spat = [], [], []
        for i in range(0, arr_uint8.shape[0], self.batch_size):
            out = self.feature_fn(torch.from_numpy(
                np.ascontiguousarray(arr_uint8[i:i + self.batch_size])))
            pools.append(out["pool3"].float())
            if want_softmax and "logits" in out:
                smx.append(torch.softmax(out["logits"].float(), dim=-1))
            if want_spatial and "spatial" in out:
                s = out["spatial"].float()
                spat.append(s.permute(0, 2, 3, 1).reshape(s.shape[0], -1))
        return (torch.cat(pools),
                torch.cat(smx) if smx else None,
                torch.cat(spat) if spat else None)

    def cal_fid(self, arr_uint8: np.ndarray) -> float:
        """FID of a uint8 NHWC sample array against the reference
        statistics (evaluator_v1.py:730-753)."""
        pool3, _, _ = self.compute_activations(arr_uint8)
        return frechet_distance(FIDStats.from_features(_host(pool3)),
                                self.ref_stats)

    def cal_metrics(self, arr_uint8: np.ndarray,
                    ref_features: Optional[torch.Tensor] = None) -> dict:
        """fid, inception_score (when the features have logits), sfid (when
        spatial reference statistics were given) and precision / recall
        (when the reference batch's pool3 features are given), as the
        offline evaluator reports them (evaluations/evaluator.py)."""
        want_spatial = self.ref_stats_spatial is not None
        pool3, sm, spatial = self.compute_activations(
            arr_uint8, want_softmax=True, want_spatial=want_spatial)
        out = {"fid": frechet_distance(FIDStats.from_features(_host(pool3)),
                                       self.ref_stats)}
        if sm is not None:
            out["inception_score"] = inception_score(_host(sm))
        if want_spatial and spatial is not None:
            out["sfid"] = frechet_distance(
                FIDStats.from_features(_host(spatial)),
                self.ref_stats_spatial)
        if ref_features is not None:
            out["precision"], out["recall"] = precision_recall(
                ref_features.to(pool3.device), pool3)
        return out

    @staticmethod
    def stats_from_images(feature_fn: Callable, arr_uint8: np.ndarray,
                          batch_size: int = 100) -> FIDStats:
        """Reference statistics of a real-image array."""
        ev = FIDEvaluator(feature_fn, None, batch_size=batch_size)
        pool3, _, _ = ev.compute_activations(arr_uint8)
        return FIDStats.from_features(_host(pool3))
