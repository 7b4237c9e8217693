"""DPM-Solver / DPM-Solver++ (orders 1-3): multistep over searched times,
singlestep DPM-Solver-fast, the adaptive step-size solver, and the
reference's model wrapper.

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

model_fn(x, t_model) -> eps; classifier-free guidance goes inside model_fn
(or :func:`dpm_model_wrapper` builds it from another parameterization).
The singlestep loop unrolls its static order schedule; the adaptive loop
decides each step on the host from the step's error norm, one device
synchronisation a step (the JAX package's ``lax.while_loop`` keeps that on
the device). No command calls these two loops or the wrapper: the JAX CLI
does not either (``txt2img`` runs the multistep loop).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .diffusion import _x_T

__all__ = ["DiscreteNoiseSchedule", "dpm_solver_sample_loop",
           "dpm_solver_singlestep_loop", "dpm_solver_adaptive_loop",
           "dpm_solver_times", "singlestep_orders", "dpm_model_wrapper"]


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

    model_value = _model_value_fn(model_fn, ns, shape, predict_x0)

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


def _model_value_fn(model_fn: Callable, schedule: DiscreteNoiseSchedule,
                    shape: Sequence[int], predict_x0: bool) -> Callable:
    """(x, t) -> eps, or the data prediction x0 under predict_x0."""
    nd = len(shape) - 1

    def model_value(x, t):
        eps = model_fn(x, schedule.model_input_time(t).expand(shape[0])) \
            .float()
        if predict_x0:
            return (x - _bshape(schedule.marginal_std(t), nd) * eps) \
                / _bshape(schedule.marginal_alpha(t), nd)
        return eps

    return model_value


def _bshape(v: torch.Tensor, nd: int) -> torch.Tensor:
    # scalar -> (1, .., 1); per-sample [N] -> (N, 1, .., 1)
    return v.reshape(v.shape + (1,) * nd)


def singlestep_orders(steps: int, order: int) -> list:
    """DPM-Solver-fast's order schedule for a fixed budget of model calls
    (dpm_solver.py:439-500 get_orders_and_timesteps_for_singlestep_solver)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    if order == 1:
        return [1] * steps
    raise ValueError("order must be 1, 2 or 3")


def _singlestep_updates(ns: DiscreteNoiseSchedule, model_value: Callable,
                        nd: int, predict_x0: bool, solver_type: str):
    """The first-, second- and third-order singlestep updates from time s
    to t (dpm_solver.py:516-549, :551-631, :633-733; the 'dpm_solver' and
    'taylor' variants, noise and data prediction). Each returns x_t and
    the model values it computed, which the adaptive loop reuses."""
    if solver_type not in ("dpm_solver", "taylor"):
        raise ValueError(f"unknown solver_type {solver_type!r}")

    def b(v):
        return _bshape(v, nd)

    def coeffs(*us):
        """(log alpha, sigma) at each time of ``us``."""
        return ([ns.marginal_log_mean_coeff(u) for u in us],
                [ns.marginal_std(u) for u in us])

    def first(x, s, t, m_s=None):
        if m_s is None:
            m_s = model_value(x, s)
        h = ns.marginal_lambda(t) - ns.marginal_lambda(s)
        (la_s, la_t), (sig_s, sig_t) = coeffs(s, t)
        if predict_x0:
            x_t = b(sig_t / sig_s) * x - b(torch.exp(la_t)
                                          * torch.expm1(-h)) * m_s
        else:
            x_t = b(torch.exp(la_t - la_s)) * x \
                - b(sig_t * torch.expm1(h)) * m_s
        return x_t, m_s

    def second(x, s, t, r1=0.5, m_s=None):
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        (la_s, la_s1, la_t), (sig_s, sig_s1, sig_t) = coeffs(s, s1, t)
        if m_s is None:
            m_s = model_value(x, s)
        if predict_x0:
            phi_11, phi_1 = torch.expm1(-r1 * h), torch.expm1(-h)
            alpha_t = torch.exp(la_t)
            x_s1 = b(sig_s1 / sig_s) * x \
                - b(torch.exp(la_s1) * phi_11) * m_s
            m_s1 = model_value(x_s1, s1)
            x_t = b(sig_t / sig_s) * x - b(alpha_t * phi_1) * m_s
            if solver_type == "dpm_solver":
                x_t = x_t - (0.5 / r1) * b(alpha_t * phi_1) * (m_s1 - m_s)
            else:
                x_t = x_t + (1.0 / r1) * b(alpha_t * (phi_1 / h + 1.0)) \
                    * (m_s1 - m_s)
        else:
            phi_11, phi_1 = torch.expm1(r1 * h), torch.expm1(h)
            x_s1 = b(torch.exp(la_s1 - la_s)) * x - b(sig_s1 * phi_11) * m_s
            m_s1 = model_value(x_s1, s1)
            x_t = b(torch.exp(la_t - la_s)) * x - b(sig_t * phi_1) * m_s
            if solver_type == "dpm_solver":
                x_t = x_t - (0.5 / r1) * b(sig_t * phi_1) * (m_s1 - m_s)
            else:
                x_t = x_t - (1.0 / r1) * b(sig_t * (phi_1 / h - 1.0)) \
                    * (m_s1 - m_s)
        return x_t, m_s, m_s1

    def third(x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0, m_s=None, m_s1=None):
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        (la_s, la_s1, la_s2, la_t), (sig_s, sig_s1, sig_s2, sig_t) = \
            coeffs(s, s1, s2, t)
        if m_s is None:
            m_s = model_value(x, s)
        if predict_x0:
            phi_11, phi_12, phi_1 = (torch.expm1(-r1 * h),
                                     torch.expm1(-r2 * h), torch.expm1(-h))
            phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            alpha_s1, alpha_s2, alpha_t = (torch.exp(v)
                                           for v in (la_s1, la_s2, la_t))
            if m_s1 is None:
                x_s1 = b(sig_s1 / sig_s) * x - b(alpha_s1 * phi_11) * m_s
                m_s1 = model_value(x_s1, s1)
            x_s2 = (b(sig_s2 / sig_s) * x - b(alpha_s2 * phi_12) * m_s
                    + (r2 / r1) * b(alpha_s2 * phi_22) * (m_s1 - m_s))
            m_s2 = model_value(x_s2, s2)
            x_t = b(sig_t / sig_s) * x - b(alpha_t * phi_1) * m_s
            if solver_type == "dpm_solver":
                x_t = x_t + (1.0 / r2) * b(alpha_t * phi_2) * (m_s2 - m_s)
            else:
                d1, d2 = _taylor_diffs(m_s, m_s1, m_s2, r1, r2)
                x_t = x_t + b(alpha_t * phi_2) * d1 - b(alpha_t * phi_3) * d2
        else:
            phi_11, phi_12, phi_1 = (torch.expm1(r1 * h), torch.expm1(r2 * h),
                                     torch.expm1(h))
            phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            phi_3 = phi_2 / h - 0.5
            if m_s1 is None:
                x_s1 = b(torch.exp(la_s1 - la_s)) * x \
                    - b(sig_s1 * phi_11) * m_s
                m_s1 = model_value(x_s1, s1)
            x_s2 = (b(torch.exp(la_s2 - la_s)) * x - b(sig_s2 * phi_12) * m_s
                    - (r2 / r1) * b(sig_s2 * phi_22) * (m_s1 - m_s))
            m_s2 = model_value(x_s2, s2)
            x_t = b(torch.exp(la_t - la_s)) * x - b(sig_t * phi_1) * m_s
            if solver_type == "dpm_solver":
                x_t = x_t - (1.0 / r2) * b(sig_t * phi_2) * (m_s2 - m_s)
            else:
                d1, d2 = _taylor_diffs(m_s, m_s1, m_s2, r1, r2)
                x_t = x_t - b(sig_t * phi_2) * d1 - b(sig_t * phi_3) * d2
        return x_t, m_s, m_s1

    return first, second, third


def _taylor_diffs(m_s, m_s1, m_s2, r1, r2):
    d1_0 = (1.0 / r1) * (m_s1 - m_s)
    d1_1 = (1.0 / r2) * (m_s2 - m_s)
    return ((r2 * d1_0 - r1 * d1_1) / (r2 - r1),
            2.0 * (d1_1 - d1_0) / (r2 - r1))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int
              ) -> torch.Tensor:
    """``jnp.linspace``'s float32 arithmetic: start (1 - w) + stop w at
    w = i / (num - 1), the last point ``stop`` itself."""
    w = torch.arange(num - 1, dtype=torch.float32,
                     device=start.device) / (num - 1)
    return torch.cat([start * (1 - w) + stop * w, stop.reshape(1)])


@torch.no_grad()
def dpm_solver_singlestep_loop(model_fn: Callable, shape: Sequence[int],
                               schedule: DiscreteNoiseSchedule, *,
                               steps: int, order: int = 3, device=None,
                               generator: Optional[torch.Generator] = None,
                               t_0: float = 1e-3, t_T: float = 1.0,
                               skip_type: str = "time_uniform",
                               predict_x0: bool = True,
                               solver_type: str = "dpm_solver",
                               noise: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Singlestep DPM-Solver-fast for a fixed budget of ``steps`` model
    calls (dpm_solver.py:439-500 order schedule, :985-1056 'singlestep'):
    outer knots by ``skip_type`` (time_uniform, time_quadratic, logSNR),
    each interval one update of its order with r1 (and r2) from the
    interval's own inner grid (dpm_solver.py:1131-1137). ``schedule``
    must be on ``device``."""
    dev = torch.device(device) if device is not None \
        else schedule.t_array.device
    ns = schedule
    orders = singlestep_orders(steps, order)
    k = len(orders)
    if skip_type == "logSNR":
        lam_T = float(ns.marginal_lambda(_f32(t_T, dev)))
        lam_0 = float(ns.marginal_lambda(_f32(t_0, dev)))
        outer = ns.inverse_lambda(_linspace(_f32(lam_T, dev),
                                            _f32(lam_0, dev), k + 1))
    elif skip_type in ("time_uniform", "time_quadratic"):
        if skip_type == "time_uniform":
            grid = _linspace(_f32(t_T, dev), _f32(t_0, dev), steps + 1)
        else:
            grid = _linspace(_f32(t_T ** 0.5, dev), _f32(t_0 ** 0.5, dev),
                             steps + 1) ** 2
        outer = grid[torch.from_numpy(np.cumsum([0] + orders)).to(dev)]
    else:
        raise ValueError(f"unknown skip_type: {skip_type!r}")
    model_value = _model_value_fn(model_fn, ns, shape, predict_x0)
    first, second, third = _singlestep_updates(ns, model_value,
                                               len(shape) - 1, predict_x0,
                                               solver_type)

    def inner_lambdas(s, t, n):
        # get_time_steps over the interval (dpm_solver.py:1131-1137)
        if skip_type == "logSNR":
            return ns.marginal_lambda(ns.inverse_lambda(_linspace(
                ns.marginal_lambda(s), ns.marginal_lambda(t), n + 1)))
        if skip_type == "time_uniform":
            return ns.marginal_lambda(_linspace(s, t, n + 1))
        return ns.marginal_lambda(
            _linspace(torch.sqrt(s), torch.sqrt(t), n + 1) ** 2)

    x = _x_T(shape, noise, generator, dev)
    for i, o in enumerate(orders):
        s, t = outer[i], outer[i + 1]
        if o == 1:
            x, _ = first(x, s, t)
            continue
        lam = inner_lambdas(s, t, o)
        h = lam[-1] - lam[0]
        r1 = (lam[1] - lam[0]) / h
        if o == 2:
            x, _, _ = second(x, s, t, r1=r1)
        else:
            x, _, _ = third(x, s, t, r1=r1, r2=(lam[2] - lam[0]) / h)
    return x


@torch.no_grad()
def dpm_solver_adaptive_loop(model_fn: Callable, shape: Sequence[int],
                             schedule: DiscreteNoiseSchedule, *,
                             device=None,
                             generator: Optional[torch.Generator] = None,
                             order: int = 3, t_0: float = 1e-3,
                             t_T: float = 1.0, h_init: float = 0.05,
                             atol: float = 0.0078, rtol: float = 0.05,
                             theta: float = 0.9, t_err: float = 1e-5,
                             predict_x0: bool = True,
                             solver_type: str = "dpm_solver",
                             max_iters: int = 200,
                             noise: Optional[torch.Tensor] = None):
    """Adaptive step-size DPM-Solver (dpm_solver.py:909-963): an embedded
    lower / higher order pair (1-2 or 2-3), a step accepted where the
    scaled error E <= 1, the logSNR step h <- min(theta h E^(-1/order),
    lambda_0 - lambda_s); at most ``max_iters`` tries. The accept test
    reads E on the host: one synchronisation a step. Returns (x, model
    calls made)."""
    if order not in (2, 3):
        raise ValueError("the adaptive solver takes order 2 or 3")
    dev = torch.device(device) if device is not None \
        else schedule.t_array.device
    ns = schedule
    model_value = _model_value_fn(model_fn, ns, shape, predict_x0)
    first, second, third = _singlestep_updates(ns, model_value,
                                               len(shape) - 1, predict_x0,
                                               solver_type)
    if order == 2:
        def lower(x, s, t):
            x_l, m_s = first(x, s, t)
            return x_l, (m_s,)

        def higher(x, s, t, inter):
            return second(x, s, t, r1=0.5, m_s=inter[0])[0]
    else:
        def lower(x, s, t):
            x_l, m_s, m_s1 = second(x, s, t, r1=1.0 / 3.0)
            return x_l, (m_s, m_s1)

        def higher(x, s, t, inter):
            return third(x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0, m_s=inter[0],
                         m_s1=inter[1])[0]

    t0 = _f32(t_0, dev)
    lam_0 = ns.marginal_lambda(t0)
    x = _x_T(shape, noise, generator, dev)
    x_prev, s, h = x, _f32(t_T, dev), _f32(h_init, dev)
    nfe = it = 0
    while bool(torch.abs(s - t0) > t_err) and it < max_iters:
        t = ns.inverse_lambda(ns.marginal_lambda(s) + h)
        x_lower, inter = lower(x, s, t)
        x_higher = higher(x, s, t, inter)
        delta = torch.clamp_min(rtol * torch.maximum(x_lower.abs(),
                                                     x_prev.abs()), atol)
        err = ((x_higher - x_lower) / delta) ** 2
        e = torch.sqrt(err.reshape(shape[0], -1).mean(dim=-1)).max()
        if float(e) <= 1.0:
            x, x_prev, s = x_higher, x_lower, t
        h = torch.minimum(theta * h * e ** (-1.0 / order),
                          lam_0 - ns.marginal_lambda(s))
        nfe += order
        it += 1
    return x, nfe


def dpm_model_wrapper(raw_model: Callable, schedule: DiscreteNoiseSchedule,
                      *, model_type: str = "noise",
                      guidance_type: str = "uncond",
                      guidance_scale: float = 1.0,
                      classifier_fn: Optional[Callable] = None,
                      condition=None, uncond_condition=None) -> Callable:
    """The eps-prediction model_fn(x, t_model) the solver loops take, from
    the reference's model_wrapper variants (dpm_solver.py:177-348):

    model_type: 'noise' | 'x_start' | 'v' | 'score', the output's
        parameterization, turned into eps by the marginal alpha and sigma
        at each sample's own t.
    guidance_type:
        'uncond'           raw_model(x, t_model)
        'classifier'       eps - scale sigma_t grad_x log p(cond | x)
                           (classifier_fn(x, t_model, cond) -> [B] log p)
        'classifier-free'  one doubled batch over (uncond_condition,
                           condition); raw_model(x, t_model, c).
    """
    if model_type not in ("noise", "x_start", "v", "score"):
        raise ValueError(f"unknown model_type {model_type!r}")
    if guidance_type not in ("uncond", "classifier", "classifier-free"):
        raise ValueError(f"unknown guidance_type {guidance_type!r}")
    n = schedule.t_array.shape[-1]

    def per_sample(v, x):
        return _bshape(v, x.dim() - 1)

    def noise_pred(x, t_model, cond=None):
        out = raw_model(x, t_model) if cond is None else \
            raw_model(x, t_model, cond)
        if model_type == "noise":
            return out
        t = t_model / n + 1.0 / n          # model_input_time's inverse
        alpha = per_sample(schedule.marginal_alpha(t), x)
        sigma = per_sample(schedule.marginal_std(t), x)
        if model_type == "x_start":
            return (x - alpha * out) / sigma
        if model_type == "v":
            return alpha * out + sigma * x
        return -sigma * out                 # score

    if guidance_type == "uncond":
        return noise_pred

    if guidance_type == "classifier":
        if classifier_fn is None:
            raise ValueError("classifier guidance needs classifier_fn")

        def guided(x, t_model):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                grad, = torch.autograd.grad(
                    classifier_fn(xg, t_model, condition).sum(), xg)
            sigma = schedule.marginal_std(t_model / n + 1.0 / n)
            return noise_pred(x, t_model) \
                - guidance_scale * per_sample(sigma, x) * grad

        return guided

    def cfg(x, t_model):
        if guidance_scale == 1.0 or uncond_condition is None:
            return noise_pred(x, t_model, condition)
        eps = noise_pred(torch.cat([x, x]), torch.cat([t_model, t_model]),
                         torch.cat([uncond_condition, condition]))
        e_u, e_c = eps[:x.shape[0]], eps[x.shape[0]:]
        return e_u + guidance_scale * (e_c - e_u)

    return cfg
