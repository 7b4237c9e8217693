"""Multistep DPM-Solver / DPM-Solver++ (orders 1-3) over searched times.

Port of autodiffusion_tpu/samplers/dpm_solver.py (ldm/models/diffusion/
dpm_solver/dpm_solver.py): the SD search mutates the continuous time knots
(sd/scripts/search_ea.py:371-502), so a candidate is a [K+1] vector of
descending times in (0, 1], or [N, K+1] with candidates folded into the
batch. The JAX package runs the K steps as a ``lax.scan``; here they are a
Python loop.

The reference configuration (sampler.py:81): multistep, order 2,
lower_order_final, predict_x0 (DPM-Solver++ data-prediction updates,
dpm_solver.py:516-534,755-796,815-857), the discrete noise schedule with
piecewise-linear log-alpha interpolation (NoiseScheduleVP 'discrete') and
model input time (t - 1/N) * N.

model_fn(x, t_model) -> eps; classifier-free guidance goes inside model_fn.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .diffusion import _x_T

__all__ = ["DiscreteNoiseSchedule", "dpm_solver_sample_loop",
           "dpm_solver_times"]


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp`` (numpy's ``interp``): piecewise-linear over ascending
    ``xp``, held at the end values outside it."""
    i = torch.searchsorted(xp, x.contiguous(), right=True) \
        .clamp(1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    flat = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx))
                    * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class DiscreteNoiseSchedule(NamedTuple):
    """Piecewise-linear interpolation of 0.5 log(alpha_bar) over
    t = (i + 1) / N (float32)."""

    t_array: torch.Tensor           # [N]
    log_alpha_array: torch.Tensor   # [N]

    @classmethod
    def from_betas(cls, betas: np.ndarray) -> "DiscreteNoiseSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        return cls.from_alphas_cumprod(np.cumprod(1.0 - betas))

    @classmethod
    def from_alphas_cumprod(cls, abar: np.ndarray) -> "DiscreteNoiseSchedule":
        abar = np.asarray(abar, dtype=np.float64)
        n = len(abar)
        t = (np.arange(n, dtype=np.float64) + 1.0) / n
        return cls(torch.tensor(t, dtype=torch.float32),
                   torch.tensor(0.5 * np.log(abar), dtype=torch.float32))

    def to(self, device) -> "DiscreteNoiseSchedule":
        return DiscreteNoiseSchedule(self.t_array.to(device),
                                     self.log_alpha_array.to(device))

    def marginal_log_mean_coeff(self, t):
        return _interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(
            1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return log_a - 0.5 * torch.log(1.0 - torch.exp(2.0 * log_a))

    def model_input_time(self, t):
        n = self.t_array.shape[-1]
        return (t - 1.0 / n) * n

    def inverse_lambda(self, lamb):
        """t such that marginal_lambda(t) == lamb (dpm_solver.py:158-169,
        'discrete' branch), through the same piecewise-linear table."""
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb),
                                           -2.0 * lamb)
        # log_alpha_array falls with t: flip both for an ascending table
        return _interp(log_alpha, self.log_alpha_array.flip(0),
                       self.t_array.flip(0))


def dpm_solver_times(num_steps: int, t_0: float = 1e-3,
                     t_T: float = 1.0) -> np.ndarray:
    """Uniform-in-t default knots, descending [K+1] ('time_uniform')."""
    return np.linspace(t_T, t_0, num_steps + 1)


@torch.no_grad()
def dpm_solver_sample_loop(model_fn: Callable, shape: Sequence[int],
                           schedule: DiscreteNoiseSchedule,
                           times: torch.Tensor, *, device=None,
                           generator: Optional[torch.Generator] = None,
                           order: int = 2, lower_order_final: bool = True,
                           predict_x0: bool = True,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multistep DPM-Solver over descending ``times`` [K+1] (or [N, K+1],
    a vector per sample). Returns x at times[..., -1] (float32, ``shape``),
    after K model calls. x_T is ``noise`` or drawn from ``generator``;
    ``schedule`` and ``times`` must already be on ``device``."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    dev = torch.device(device) if device is not None else times.device
    ns = schedule
    K = times.shape[-1] - 1
    nd = len(shape) - 1

    def bshape(v):
        # scalar -> (1, .., 1); per-sample [N] -> (N, 1, .., 1)
        return v.reshape(v.shape + (1,) * nd)

    def t_at(i):
        return times[..., i]

    def model_value(x, t):
        """eps, or the data prediction x0 under predict_x0."""
        eps = model_fn(x, ns.model_input_time(t).expand(shape[0])).float()
        if predict_x0:
            return (x - bshape(ns.marginal_std(t)) * eps) \
                / bshape(ns.marginal_alpha(t))
        return eps

    def safe(v):
        return torch.where(v == 0, 1.0, v)

    def update(x, i, hist, eff):
        """From times[i] to times[i+1] at order ``eff``; hist newest-first."""
        s, t = t_at(i), t_at(i + 1)
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        log_a_s = ns.marginal_log_mean_coeff(s)
        log_a_t = ns.marginal_log_mean_coeff(t)
        sigma_s, sigma_t = ns.marginal_std(s), ns.marginal_std(t)
        alpha_t = torch.exp(log_a_t)
        h = lam_t - lam_s
        m0 = hist[0]
        # previous knots for the difference terms
        lam_1 = ns.marginal_lambda(t_at(max(i - 1, 0)))
        lam_2 = ns.marginal_lambda(t_at(max(i - 2, 0)))
        r0 = (lam_s - lam_1) / safe(h)
        r1 = (lam_1 - lam_2) / safe(h)
        d1_0 = (m0 - hist[1]) / bshape(safe(r0))
        if predict_x0:
            phi1 = torch.expm1(-h)
            base = bshape(sigma_t / sigma_s) * x - bshape(alpha_t * phi1) * m0
            if eff == 1:
                return base
            if eff == 2:
                return base - bshape(0.5 * alpha_t * phi1) * d1_0
        else:
            phi1 = torch.expm1(h)
            base = bshape(torch.exp(log_a_t - log_a_s)) * x \
                - bshape(sigma_t * phi1) * m0
            if eff == 1:
                return base
            if eff == 2:
                return base - bshape(0.5 * sigma_t * phi1) * d1_0
        d1_1 = (hist[1] - hist[2]) / bshape(safe(r1))
        d1 = d1_0 + bshape(r0 / safe(r0 + r1)) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / bshape(safe(r0 + r1))
        if predict_x0:
            return (base + bshape(alpha_t * (phi1 / h + 1.0)) * d1
                    - bshape(alpha_t * ((phi1 + h) / h ** 2 - 0.5)) * d2)
        return (base - bshape(sigma_t * (phi1 / h - 1.0)) * d1
                - bshape(sigma_t * ((phi1 - h) / h ** 2 - 0.5)) * d2)

    x = _x_T(shape, noise, generator, dev)
    m = model_value(x, t_at(0))
    hist = [m, m, m]
    for i in range(K):
        # warm up through the lower orders (dpm_solver.py:1103-1107) and
        # taper the final steps back down (min(order, steps + 1 - step)
        # when steps < 15, dpm_solver.py:1111-1114)
        eff = min(i + 1, order)
        if lower_order_final and K < 15:
            eff = min(eff, K - i)
        x = update(x, i, hist, eff)
        # the final model value is never used (dpm_solver.py:1124-1126)
        if i < K - 1:
            hist = [model_value(x, t_at(i + 1)), hist[0], hist[1]]
    return x
