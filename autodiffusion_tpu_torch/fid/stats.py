"""FID statistics: streamed feature moments, the Frechet distance and the
Inception Score.

Port of autodiffusion_tpu/fid/stats.py (evaluations/evaluator_v1.py:
86-157, 223-236). Moments accumulate in float64 on the device (the JAX
package's lesson: reduced-precision second moments drove FIDs negative);
the Frechet distance runs in float64, by eigendecompositions or, as the
reference, by the host's scipy sqrtm.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FeatureStats", "FIDStats", "accumulate_stats", "finalize_stats",
           "frechet_distance", "frechet_distance_eigh", "make_device_frechet",
           "inception_score"]


class FeatureStats(NamedTuple):
    """Running sums for the mean and covariance of a feature stream, with
    optional leading candidate axes: n [...], s1 [..., D], s2 [..., D, D]."""

    n: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor

    @classmethod
    def zeros(cls, dim: int, lead=(), device=None,
              dtype=torch.float64) -> "FeatureStats":
        lead = tuple(lead)
        return cls(torch.zeros(lead, dtype=dtype, device=device),
                   torch.zeros(lead + (dim,), dtype=dtype, device=device),
                   torch.zeros(lead + (dim, dim), dtype=dtype, device=device))


class FIDStats(NamedTuple):
    """Finalized statistics (host numpy float64)."""

    mu: np.ndarray          # [D]
    sigma: np.ndarray       # [D, D]

    @classmethod
    def from_features(cls, feats: np.ndarray) -> "FIDStats":
        feats = np.asarray(feats, dtype=np.float64)
        return cls(feats.mean(axis=0), np.cov(feats, rowvar=False))

    def save(self, path: str) -> None:
        np.savez(path, mu=self.mu, sigma=self.sigma)

    @classmethod
    def load(cls, path: str) -> "FIDStats":
        with np.load(path) as z:
            return cls(np.asarray(z["mu"]), np.asarray(z["sigma"]))


def accumulate_stats(stats: FeatureStats, feats: torch.Tensor,
                     shift: Optional[torch.Tensor] = None) -> FeatureStats:
    """Add a [B, D] batch of features, centred on ``shift`` (typically the
    reference mean; pass the same shift to :func:`finalize_stats`) so that
    s2 - n mu mu^T does not cancel."""
    f = feats.to(stats.s1.dtype)
    if shift is not None:
        f = f - shift.to(f.dtype)
    return FeatureStats(n=stats.n + feats.shape[0],
                        s1=stats.s1 + f.sum(dim=0),
                        s2=stats.s2 + f.T @ f)


def finalize_stats(stats: FeatureStats,
                   shift: Optional[np.ndarray] = None) -> FIDStats:
    """Sums -> (mu, unbiased covariance), np.cov's N-1 denominator; the
    mean adds the shift back."""
    n = float(stats.n)
    s1 = stats.s1.detach().cpu().double().numpy()
    s2 = stats.s2.detach().cpu().double().numpy()
    mu = s1 / n
    sigma = (s2 - n * np.outer(mu, mu)) / (n - 1)
    if shift is not None:
        mu = mu + np.asarray(shift, dtype=np.float64)
    return FIDStats(mu, sigma)


def frechet_distance(s1: FIDStats, s2: FIDStats, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) by the host's scipy
    sqrtm in float64, with the reference's guards (evaluator_v1.py:
    109-157): the diagonal jittered by ``eps`` when sqrtm is not finite, an
    imaginary part dropped when the diagonal's is within 1e-3 of 0."""
    import scipy.linalg

    def _sqrtm(a):
        out = scipy.linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out  # scipy < 1.18

    mu1, sigma1 = s1.mu, s1.sigma
    mu2, sigma2 = s2.mu, s2.sigma
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different dimensions: "
                         f"{mu1.shape} and {mu2.shape}")
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        warnings.warn(f"fid calculation produces singular product; adding "
                      f"{eps} to diagonal of cov estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def frechet_distance_eigh(s1: FIDStats, s2: FIDStats) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) on the host in float64,
    with tr sqrt(S1 S2) from eig(sqrt(S1) S2 sqrt(S1)) (two symmetric
    eigendecompositions instead of a dense sqrtm)."""
    diff = s1.mu - s2.mu
    w, v = np.linalg.eigh(s1.sigma)
    sqrt_s1 = (v * np.sqrt(np.maximum(w, 0.0))) @ v.T
    inner = sqrt_s1 @ s2.sigma @ sqrt_s1
    ev = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sqrt(np.maximum(ev, 0.0)).sum()
    return float(diff.dot(diff) + np.trace(s1.sigma) + np.trace(s2.sigma)
                 - 2.0 * tr_sqrt)


def make_device_frechet(ref_stats: FIDStats, device=None
                        ) -> Callable[[FeatureStats], np.ndarray]:
    """Frechet distances on the device from moments accumulated with
    ``shift = ref_stats.mu``: fn(stats with leading [C] axis) -> [C] FIDs.

    sqrt(sigma_ref) is computed once on the host in float64; each candidate
    then needs one float64 eigvalsh of sqrt_ref sigma sqrt_ref, with the
    exact rank truncation (sigma from n centred samples has rank <= n - 1,
    so only the top n - 1 eigenvalues are kept; the rest is eigensolver
    noise whose square roots would add up into the FID)."""
    w, v = np.linalg.eigh(np.asarray(ref_stats.sigma, np.float64))
    sqrt_ref = torch.from_numpy((v * np.sqrt(np.maximum(w, 0.0))) @ v.T) \
        .to(device)
    tr_ref = float(np.trace(ref_stats.sigma))

    def fn(stats: FeatureStats) -> np.ndarray:
        n = stats.n.double()                                   # [C]
        mu_delta = stats.s1.double() / n[:, None]              # mu - mu_ref
        sigma = (stats.s2.double() - n[:, None, None]
                 * mu_delta[:, :, None] * mu_delta[:, None, :]) \
            / (n[:, None, None] - 1.0)
        inner = sqrt_ref @ sigma @ sqrt_ref
        ev = torch.linalg.eigvalsh((inner + inner.transpose(-1, -2)) / 2.0)
        d = ev.shape[-1]
        idx = torch.arange(d, dtype=torch.float64, device=ev.device)
        keep = idx[None] >= (d - (n[:, None] - 1.0))
        tr_sqrt = torch.sqrt(torch.where(keep, ev, 0.0).clamp_min(0.0)).sum(-1)
        fid = ((mu_delta * mu_delta).sum(-1)
               + torch.diagonal(sigma, dim1=-2, dim2=-1).sum(-1) + tr_ref
               - 2.0 * tr_sqrt)
        return fid.cpu().numpy()

    return fn


def inception_score(softmax_probs: np.ndarray,
                    split_size: int = 5000) -> float:
    """exp(E KL(p(y|x) || p(y))) over splits, in float64 on the host
    (evaluator_v1.py:223-236)."""
    preds = np.asarray(softmax_probs, dtype=np.float64)
    scores = []
    for i in range(0, len(preds), split_size):
        part = preds[i:i + split_size]
        kl = part * (np.log(part + 1e-12)
                     - np.log(part.mean(axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))
