"""What every model family shares: the family of a configuration, found
by name (its file's ``family``, ``families/<family>.py``), modules given
their seeded tensors, and the reference FID statistics made from the
seed."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness.weights import seed_for

__all__ = ["family", "materialise", "ref_stats", "np64"]


def family(cfg: dict, bench: str = ""):
    """The module ``families/<cfg["family"]>.py`` under ``bench`` (the
    checkout's ``benchmark/`` by default)."""
    from benchmark.harness.spec import BENCH, module

    name = cfg["family"]
    return module(os.path.join(bench or BENCH, "families", name + ".py"),
                  "bench_family_" + name.replace(".", "_").replace("-", "_"))


def materialise(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """``module`` (on the meta device) holding the tensors of ``state``."""
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def ref_stats(cfg: dict, seed: int, device):
    """Reference FID statistics (mu [2048], sigma [2048, 2048], float64)
    from the seed: mu_i = m |z_i|, sigma = A A^T / 4096 with A [2048,
    4096] of N(0, s^2), full rank (``ref_mu_scale`` m, ``ref_std`` s)."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 6))
    d = 2048
    a = torch.randn(d, 2 * d, generator=gen, device=device,
                    dtype=torch.float64) * float(cfg["ref_std"])
    mu = torch.randn(d, generator=gen, device=device,
                     dtype=torch.float64).abs() * float(cfg["ref_mu_scale"])
    return mu, a @ a.T / (2 * d)


def np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()
