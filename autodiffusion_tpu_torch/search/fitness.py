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

Data parallel (``shard_fn``, parallel.data_sharder): each rank evaluates
its rows of every candidate's batch (``per_candidate``), sample_fn
returns those rows, and the moments are summed over the ranks before the
Frechet, so every rank returns the same FIDs.

Spans (``utils.trace``, off unless turned on), all with the chunk's
``eval_count`` as trace id: ``adt.fitness.chunk`` (a whole chunk;
``candidates``) holds ``adt.fitness.payload`` (the folded payloads),
then per device batch ``adt.fitness.sample`` (``rows``; the sampler's
spans lie inside it), ``adt.fitness.features`` (``images``) and
``adt.fitness.moments`` (the shift and the batch's sums), and last
``adt.fitness.frechet`` (until the FIDs are host floats). The logged
``reset_time`` / ``sample_time`` / ``fid_time`` are taken at the same
boundaries.
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
from ..parallel.mesh import DataSharder
from ..schedules import ScheduleTables, stack_tables
from ..utils import logger, trace

__all__ = ["BatchedFIDFitness", "to_uint8", "per_candidate"]


def to_uint8(samples: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NCHW -> uint8 NHWC, the reference's rounding
    (search_imagenet64_classifier_guidance.py:352-354)."""
    return ((samples + 1) * 127.5).clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1).contiguous()


def per_candidate(shard_fn: Callable, c: int) -> Callable:
    """``shard_fn`` applied to each candidate's rows of a folded [C*b, ...]
    batch (sample j of candidate j // b): [C*b, ...] -> [C*b', ...] with
    b' = b / ranks, still candidate-major."""

    def fn(x):
        rest = tuple(x.shape[1:])
        by_row = x.reshape((c, x.shape[0] // c) + rest).transpose(0, 1)
        return shard_fn(by_row).transpose(0, 1).reshape((-1,) + rest)

    return fn


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
    been measured on this port's GPUs yet. ``shard_fn``
    (parallel.data_sharder; one rank when not given) is the data axis:
    sample_fn returns this rank's rows of each candidate and the moments
    are all-reduced in float64 over its ranks.
    """

    def __init__(self, *, payload_fn: Callable, sample_fn: Callable,
                 feature_fn: Callable, ref_stats: FIDStats,
                 num_samples: int, batch_size: int,
                 candidate_chunk: int = 8, feature_dim: int = 2048,
                 seed: int = 0, device_frechet: bool = True,
                 group_key_fn: Optional[Callable] = None,
                 max_device_batch: Optional[int] = None, device=None,
                 shard_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.shard_fn = shard_fn or DataSharder()
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
        with trace.span("adt.fitness.chunk", trace_id=self._eval_count,
                        candidates=c):
            t0 = time.perf_counter()
            with trace.span("adt.fitness.payload"):
                per_sample = _fold([self.payload_fn(x) for x in cands], b,
                                   self.device)
            t1 = time.perf_counter()
            stats = FeatureStats.zeros(self.feature_dim, (c,), self.device)
            n_batches = -(-self.num_samples // b)
            with torch.no_grad():
                for bi in range(n_batches):
                    with trace.span("adt.fitness.sample", rows=c * b):
                        imgs = self.sample_fn(per_sample,
                                              self._generator(bi), bi)
                    with trace.span("adt.fitness.features",
                                    images=imgs.shape[0]):
                        feats = self.feature_fn(imgs)["pool3"]
                    with trace.span("adt.fitness.moments"):
                        feats = feats.double() - self._shift
                        by_cand = feats.reshape(c, -1, feats.shape[-1])
                        stats = FeatureStats(
                            n=stats.n + by_cand.shape[1],
                            s1=stats.s1 + by_cand.sum(dim=1),
                            s2=stats.s2 + torch.einsum(
                                "cbd,cbe->cde", by_cand, by_cand))
            self.shard_fn.all_reduce_sum_(list(stats))
            _sync(self.device)
            self._eval_count += 1
            t2 = time.perf_counter()
            with trace.span("adt.fitness.frechet"):
                if self._device_frechet is not None:
                    out = [float(f)
                           for f in self._device_frechet(stats)[:n_real]]
                else:
                    out = [frechet_distance_eigh(
                        finalize_stats(FeatureStats(stats.n[i], stats.s1[i],
                                                    stats.s2[i]),
                                       shift=self.ref_stats.mu),
                        self.ref_stats) for i in range(n_real)]
            t3 = time.perf_counter()
        # the reference's per-phase timing line
        # (search_imagenet64_classifier_guidance.py:375)
        logger.log(f"reset_time: {t1 - t0:.3f}, sample_time: "
                   f"{t2 - t1:.3f}, fid_time: {t3 - t2:.3f}")
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
