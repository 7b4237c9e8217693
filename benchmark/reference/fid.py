"""Plain feature moments and Frechet distance (evaluator_v1.py's FID), for
the benchmark's correctness check.

mu and the unbiased covariance of a candidate's features, then
||mu - mu_ref||^2 + tr S + tr S_ref - 2 tr sqrt(S S_ref), with
tr sqrt(S S_ref) the sum of the square roots of the eigenvalues of
sqrt(S_ref) S sqrt(S_ref). A covariance of n samples has rank n - 1 at
most, so only its top n - 1 eigenvalues are kept: the rest are zero, and
what an eigensolver returns for them is rounding. ``dtype`` float64 is the
reference; float32 its control.
"""

from __future__ import annotations

import torch

__all__ = ["sqrt_psd", "fid"]


def sqrt_psd(sigma: torch.Tensor) -> torch.Tensor:
    w, v = torch.linalg.eigh(sigma)
    return (v * w.clamp_min(0).sqrt()) @ v.T


def fid(features: torch.Tensor, mu_ref: torch.Tensor, sigma_ref: torch.Tensor,
        dtype: torch.dtype = torch.float64, root=None) -> float:
    """FID of features [n, D] against (mu_ref, sigma_ref); ``root``
    sqrt_psd(sigma_ref) in ``dtype``, where the caller has it."""
    f = features.to(dtype)
    n = f.shape[0]
    mu = f.mean(dim=0)
    c = f - mu
    sigma = c.T @ c / (n - 1)
    mu_ref, sigma_ref = mu_ref.to(dtype), sigma_ref.to(dtype)
    root = sqrt_psd(sigma_ref) if root is None else root.to(dtype)
    inner = root @ sigma @ root
    ev = torch.linalg.eigvalsh((inner + inner.T) / 2)
    top = ev[-(n - 1):] if n - 1 < ev.shape[0] else ev
    d = mu - mu_ref
    return float(d @ d + torch.trace(sigma) + torch.trace(sigma_ref)
                 - 2 * top.clamp_min(0).sqrt().sum())
