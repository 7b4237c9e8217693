"""Candidate fitness: batched FID with candidates folded into the batch.

Port of autodiffusion_tpu/search/fitness.py. A chunk of C same-K
candidates is evaluated as one batch: each candidate's payload (schedule
tables, keep masks) is stacked and repeated per sample to [C*b, ...]
(sample j belongs to candidate j // b), the sampler consumes per-sample
coefficients, and the Inception features reduce back to per-candidate
moments by a reshape. Only the [C] FIDs come back to the host.

Caller supplies:
  payload_fn(candidate) -> dict of ScheduleTables / tensors with a
      K-like leading axis
  sample_fn(per_sample_payload, generator, batch_idx) -> uint8
      [N, H, W, 3], N the leading length of the per-sample payload
  feature_fn(uint8 images) -> dict with "pool3" [N, D]
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..fid.stats import (FeatureStats, FIDStats, finalize_stats,
                         frechet_distance_eigh, make_device_frechet)
from ..schedules import ScheduleTables, stack_tables
from ..utils import logger

__all__ = ["BatchedFIDFitness", "to_uint8"]


def to_uint8(samples: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NCHW -> uint8 NHWC, the reference's rounding
    (search_imagenet64_classifier_guidance.py:352-354)."""
    return ((samples + 1) * 127.5).clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1).contiguous()


def _fold(payloads: Sequence[Dict[str, Any]], per_cand: int, device
          ) -> Dict[str, Any]:
    """Stack C candidates' payloads and repeat each per_cand times."""
    out = {}
    for key in payloads[0]:
        vals = [p[key] for p in payloads]
        if isinstance(vals[0], ScheduleTables):
            out[key] = stack_tables(vals).map(
                lambda t: t.repeat_interleave(per_cand, dim=0).to(device))
        else:
            out[key] = torch.stack([torch.as_tensor(v) for v in vals]) \
                .repeat_interleave(per_cand, dim=0).to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchedFIDFitness:
    """fitness(list of candidates) -> list of FIDs.

    candidate_chunk bounds how many candidates share one batch;
    num_samples images per candidate are generated in device_batch-sized
    slices and streamed into per-candidate moments. ``max_device_batch``
    caps candidate_chunk * device_batch; it is off (None) by default: the
    JAX package's default of 128 was sized for a 16 GB TPU, and no cap has
    been measured on this port's GPUs yet.
    """

    def __init__(self, *, payload_fn: Callable, sample_fn: Callable,
                 feature_fn: Callable, ref_stats: FIDStats,
                 num_samples: int, batch_size: int,
                 candidate_chunk: int = 8, feature_dim: int = 2048,
                 seed: int = 0, device_frechet: bool = True,
                 group_key_fn: Optional[Callable] = None,
                 max_device_batch: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.payload_fn = payload_fn
        self.sample_fn = sample_fn
        self.feature_fn = feature_fn
        self.ref_stats = ref_stats
        self.num_samples = num_samples
        self.batch_size = batch_size
        if max_device_batch and candidate_chunk * batch_size > max_device_batch:
            splits = -(-candidate_chunk * batch_size // max_device_batch)
            self.device_batch = -(-batch_size // splits)
        else:
            self.device_batch = batch_size
        # every candidate is scored on n_batches * device_batch samples: the
        # even slices can round num_samples up, and FID depends on the
        # sample count, so the actual count is disclosed
        self.actual_samples = (-(-num_samples // self.device_batch)
                               * self.device_batch)
        if self.actual_samples != num_samples:
            logger.log(f"fitness: {num_samples} samples/candidate rounds up "
                       f"to {self.actual_samples} "
                       f"(even device batches of {self.device_batch}); "
                       "compare FIDs at equal actual counts")
        self.candidate_chunk = candidate_chunk
        self.feature_dim = feature_dim
        self.seed = seed
        self._eval_count = 0
        # same-shape candidates can stack; default key = candidate length
        self.group_key_fn = group_key_fn or (lambda c: len(c[0]) if
                                             isinstance(c[0], tuple) else len(c))
        # features are centred on the reference mean before the moments
        # accumulate (shift-invariant covariance without cancellation)
        self._shift = torch.as_tensor(np.asarray(ref_stats.mu, np.float64),
                                      device=self.device)
        self._device_frechet = (make_device_frechet(ref_stats, self.device)
                                if device_frechet else None)

    # The noise stream advances with every chunk evaluation; a resumed
    # search continues it (EvolutionSearcher persists this state).
    def get_state(self) -> Dict[str, int]:
        return {"eval_count": self._eval_count}

    def set_state(self, state: Dict[str, int]) -> None:
        self._eval_count = int(state["eval_count"])

    def _generator(self, batch_idx: int) -> torch.Generator:
        seed = np.random.SeedSequence(
            [self.seed, self._eval_count, batch_idx]).generate_state(
                1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(
            int(seed) & ((1 << 63) - 1))

    def __call__(self, candidates: Sequence[Any]) -> List[float]:
        fids: Dict[int, float] = {}
        groups: Dict[Any, List[int]] = {}
        for i, c in enumerate(candidates):
            groups.setdefault(self.group_key_fn(c), []).append(i)
        for idxs in groups.values():
            for j in range(0, len(idxs), self.candidate_chunk):
                part = idxs[j:j + self.candidate_chunk]
                part_fids = self._eval_chunk([candidates[i] for i in part])
                for i, f in zip(part, part_fids):
                    fids[i] = f
        return [fids[i] for i in range(len(candidates))]

    def _eval_chunk(self, cands: List[Any]) -> List[float]:
        # pad a partial chunk to candidate_chunk (repeating the last
        # candidate) so every chunk has the same batch
        n_real = len(cands)
        cands = list(cands) + [cands[-1]] * (self.candidate_chunk - n_real)
        c = len(cands)
        b = self.device_batch
        t0 = time.time()
        per_sample = _fold([self.payload_fn(x) for x in cands], b,
                           self.device)
        reset_time = time.time() - t0

        t0 = time.time()
        stats = FeatureStats.zeros(self.feature_dim, (c,), self.device)
        n_batches = -(-self.num_samples // b)
        with torch.no_grad():
            for bi in range(n_batches):
                imgs = self.sample_fn(per_sample, self._generator(bi), bi)
                feats = self.feature_fn(imgs)["pool3"].double() - self._shift
                by_cand = feats.reshape(c, b, -1)
                stats = FeatureStats(
                    n=stats.n + b,
                    s1=stats.s1 + by_cand.sum(dim=1),
                    s2=stats.s2 + torch.einsum("cbd,cbe->cde", by_cand,
                                               by_cand))
        _sync(self.device)
        self._eval_count += 1
        sample_time = time.time() - t0

        t0 = time.time()
        if self._device_frechet is not None:
            out = [float(f) for f in self._device_frechet(stats)[:n_real]]
        else:
            out = [frechet_distance_eigh(
                finalize_stats(FeatureStats(stats.n[i], stats.s1[i],
                                            stats.s2[i]),
                               shift=self.ref_stats.mu), self.ref_stats)
                   for i in range(n_real)]
        # the reference's per-phase timing line
        # (search_imagenet64_classifier_guidance.py:375)
        logger.log(f"reset_time: {reset_time:.3f}, sample_time: "
                   f"{sample_time:.3f}, fid_time: {time.time() - t0:.3f}")
        # FID is non-negative: a materially negative or non-finite value
        # means the moment / Frechet numerics are broken, and the search
        # must not descend a corrupted landscape. Tiny negatives (rounding
        # at small n) clamp to 0.
        for f in out:
            if not math.isfinite(f) or f < -0.01:
                raise FloatingPointError(
                    f"fitness produced an invalid FID {f!r} (chunk FIDs: "
                    f"{out}); the moment/Frechet numerics are broken")
        return [max(f, 0.0) for f in out]
