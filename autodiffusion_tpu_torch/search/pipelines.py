"""The ADM search pipeline: models + guided DDIM or ancestral sampling +
FID fitness.

Port of autodiffusion_tpu/search/pipelines.py (get_cand_fid of
search_imagenet64_classifier_guidance.py:308-376 and its joint variant).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..fid.stats import FIDStats
from ..parallel.mesh import DataSharder
from ..samplers import (classifier_cond_fn, ddim_sample_loop,
                        p_sample_loop)
from ..samplers.diffusion import ModelVarType
from ..schedules import build_tables
from .fitness import BatchedFIDFitness, per_candidate, to_uint8

__all__ = ["make_adm_fitness", "keep_masks_for"]


def keep_masks_for(skip_layers: Sequence[Sequence[int]], layer_num: int) -> np.ndarray:
    """[K, layer_num] keep-mask matrix from per-step skip lists."""
    masks = np.ones((len(skip_layers), layer_num), dtype=np.float32)
    for i, skips in enumerate(skip_layers):
        for l in skips:
            masks[i, l] = 0.0
    return masks


def make_adm_fitness(*, model, image_size: int, feature_fn: Callable,
                     ref_stats: FIDStats, num_samples: int, batch_size: int,
                     base_schedule: str = "cosine", base_num_steps: int = 1000,
                     classifier=None, classifier_scale: float = 1.0,
                     num_classes: Optional[int] = 1000,
                     use_ddim: bool = True, eta: float = 0.0,
                     clip_denoised: bool = True, learn_sigma: bool = True,
                     joint: bool = False, candidate_chunk: int = 8,
                     seed: int = 0, feature_dim: int = 2048,
                     max_device_batch: Optional[int] = None,
                     device=None, shard_fn: Optional[Callable] = None
                     ) -> BatchedFIDFitness:
    """Fitness for timestep-only (joint=False) or joint timestep +
    architecture candidates. ``model`` / ``classifier`` are the port's
    UNetModel / EncoderUNetModel on ``device`` (cuda by default); their
    parameters are frozen (``requires_grad_(False)``).

    ``shard_fn`` (parallel.data_sharder; one rank when not given) runs
    the fitness data parallel: labels and noise are drawn at the global
    shape and each rank samples its rows of every candidate (the JAX
    package's batch-axis sharding constraints); the FIDs are those of one
    process."""
    dev = resolve_device(device)
    # frozen: guidance differentiates the classifier with respect to its
    # input only, so no weight gradient is asked for
    model.requires_grad_(False)
    if classifier is not None:
        classifier.requires_grad_(False)
    layer_num = model.layer_num
    var_type = (ModelVarType.LEARNED_RANGE if learn_sigma
                else ModelVarType.FIXED_LARGE)

    def payload_fn(cand):
        if joint:
            ts, skips = cand
            return {"tables": build_tables(ts, base_schedule=base_schedule,
                                           base_num_steps=base_num_steps),
                    "keep_masks": torch.from_numpy(
                        keep_masks_for(skips, layer_num))}
        return {"tables": build_tables(cand, base_schedule=base_schedule,
                                       base_num_steps=base_num_steps)}

    # this rank's rows of each candidate's slice (all of them in one
    # process)
    shard_fn = shard_fn or DataSharder()
    rows = per_candidate(shard_fn, candidate_chunk)

    def sample_fn(payload, gen: torch.Generator, batch_idx: int):
        n = payload["tables"].betas.shape[0]   # chunk * per-candidate slice
        tables = payload["tables"].map(rows)
        masks = rows(payload["keep_masks"]) if joint else None
        y = None
        if num_classes:
            # every folded candidate's slice draws the SAME labels, so the
            # candidates of a chunk stay comparable
            b = n // candidate_chunk
            y = rows(torch.randint(0, num_classes, (b,), generator=gen,
                                   device=dev).repeat(candidate_chunk))

        def model_fn(x, t, i):
            mask = masks[:, i] if joint else None
            return model(x, t, y, keep_mask=mask)

        cond = None
        if classifier is not None:
            if y is None:
                raise ValueError("classifier guidance needs class labels")
            cond = classifier_cond_fn(classifier, y, classifier_scale)
        shape = (n, 3, image_size, image_size)
        noise = torch.randn(shape, generator=gen, device=dev)
        loop = ddim_sample_loop if use_ddim else p_sample_loop
        kw = {"eta": eta} if use_ddim else {}
        x0 = loop(model_fn, shape, tables, device=dev, generator=gen,
                  var_type=var_type, clip_denoised=clip_denoised,
                  cond_fn=cond, noise=noise,
                  shard_fn=rows, **kw)
        return to_uint8(x0)

    return BatchedFIDFitness(
        payload_fn=payload_fn, sample_fn=sample_fn, feature_fn=feature_fn,
        ref_stats=ref_stats, num_samples=num_samples, batch_size=batch_size,
        candidate_chunk=candidate_chunk, seed=seed, feature_dim=feature_dim,
        max_device_batch=max_device_batch, device=dev, shard_fn=shard_fn)
