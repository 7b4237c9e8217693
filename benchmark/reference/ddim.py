"""Plain respaced schedules and classifier-guided DDIM (guided-diffusion's
gaussian_diffusion.py and respace.py), for the benchmark's correctness
check.

A candidate is a set of K original timesteps of a T-step base schedule;
its K-step process keeps the base's cumulative products at those steps.
Coefficients are worked out in float64 and used in float32, one row of
images at a time or many: every row carries its own schedule, label and
starting noise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

__all__ = ["base_alphas_cumprod", "step_coefficients", "guided_ddim",
           "to_uint8"]


def base_alphas_cumprod(schedule: str, steps: int = 1000) -> np.ndarray:
    if schedule == "linear":
        s = 1000.0 / steps
        betas = np.linspace(s * 1e-4, s * 2e-2, steps, dtype=np.float64)
    elif schedule == "cosine":
        f = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = np.array([min(1 - f((i + 1) / steps) / f(i / steps), 0.999)
                          for i in range(steps)], dtype=np.float64)
    else:
        raise ValueError(schedule)
    return np.cumprod(1.0 - betas)


def step_coefficients(timesteps: Sequence[int], schedule: str,
                      steps: int = 1000) -> dict:
    """{name: float64 [K]} of a candidate: its sorted timesteps and the
    respaced process's cumulative products (current and previous)."""
    ts = sorted(set(int(t) for t in timesteps))
    abar = base_alphas_cumprod(schedule, steps)[ts]
    return {"t": np.asarray(ts, np.float64), "abar": abar,
            "abar_prev": np.append(1.0, abar[:-1])}


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> uint8 NHWC, guided-diffusion's rounding."""
    return ((x + 1) * 127.5).clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1).contiguous()


def guided_ddim(P: Numerics, unet, x_T: torch.Tensor, coeffs: Sequence[dict],
                y: Optional[torch.Tensor] = None, classifier=None,
                classifier_scale: float = 1.0) -> torch.Tensor:
    """DDIM with eta 0 (clip_denoised, learned-range variance ignored by
    DDIM), with the classifier's gradient on the score
    (condition_score) when ``classifier`` is given. ``coeffs`` holds one
    :func:`step_coefficients` a row. Returns x_0 float32 [B, 3, H, W]."""
    dev = x_T.device
    cols = {k: torch.tensor(np.stack([c[k] for c in coeffs]), device=dev)
            for k in ("t", "abar", "abar_prev")}
    x = x_T.float()
    for i in range(cols["t"].shape[1] - 1, -1, -1):
        t = cols["t"][:, i].float()
        abar = cols["abar"][:, i].float()[:, None, None, None]
        abar_prev = cols["abar_prev"][:, i].float()[:, None, None, None]
        srecip = torch.sqrt(1.0 / cols["abar"][:, i]).float()[:, None, None,
                                                               None]
        srecipm1 = torch.sqrt(1.0 / cols["abar"][:, i] - 1).float()[
            :, None, None, None]
        with torch.no_grad():
            eps = unet(P, x, t, y)[:, :3]
        x0 = (srecip * x - srecipm1 * eps).clamp(-1, 1)
        eps = (srecip * x - x0) / srecipm1
        if classifier is not None:
            with torch.enable_grad():
                xi = x.detach().requires_grad_(True)
                logp = F.log_softmax(classifier(P, xi, t).float(), dim=-1)
                (grad,) = torch.autograd.grad(
                    logp.gather(1, y[:, None]).sum(), xi)
            eps = eps - torch.sqrt(1 - abar) * grad * classifier_scale
            x0 = srecip * x - srecipm1 * eps
        x = x0 * torch.sqrt(abar_prev) + torch.sqrt(1 - abar_prev) * eps
    return x
