"""Beta (noise) schedules, computed in float64 on the host.

Reference behavior: guided_diffusion/gaussian_diffusion.py:18-62 (linear and
cosine schedules) and Stable Diffusion's
ldm/modules/diffusionmodules/util.py:21-43 (sqrt-space "linear" schedule).
All schedule derivation stays in host numpy float64 — the arrays are tiny
(length T<=1000) and the downstream respacing math is sensitive to rounding;
only the final per-step gathered tables are shipped to device as float32.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["make_beta_schedule", "betas_for_alpha_bar"]


def betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into per-step betas.

    beta_t = 1 - alpha_bar((t+1)/T) / alpha_bar(t/T), clipped at ``max_beta``
    (the clipping keeps the final steps from becoming singular).
    """
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


def make_beta_schedule(name: str, num_steps: int, *,
                       linear_start: float = None,
                       linear_end: float = None) -> np.ndarray:
    """Return float64 betas of shape [num_steps] for a named schedule.

    ``linear``  — the DDPM linear schedule, scaled so any T is equivalent to
                  the canonical T=1000 run (scale = 1000/T).
    ``cosine``  — the improved-DDPM cosine schedule,
                  alpha_bar(t) = cos^2(((t + 0.008)/1.008) * pi/2).
    ``sqrt_linear`` — Stable Diffusion's schedule: betas linear in sqrt-space
                  between ``linear_start`` (default 8.5e-4) and ``linear_end``
                  (default 1.2e-2).
    """
    if name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * 1e-4, scale * 2e-2, num_steps,
                           dtype=np.float64)
    if name == "cosine":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if name == "sqrt_linear":
        lo = 8.5e-4 if linear_start is None else linear_start
        hi = 1.2e-2 if linear_end is None else linear_end
        return np.linspace(lo ** 0.5, hi ** 0.5, num_steps,
                           dtype=np.float64) ** 2
    raise ValueError(f"unknown beta schedule: {name!r}")
