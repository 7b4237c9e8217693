"""PLMS (pseudo linear multistep) sampling over ScheduleTables (NCHW).

Port of autodiffusion_tpu/samplers/plms.py (ldm/models/diffusion/plms.py:
121-258): Adams-Bashforth orders 2-4 on the eps history, with the pseudo
improved Euler step (two model calls) first, so a K-step schedule makes
K + 1 model calls. The JAX package runs the steps as a ``lax.scan`` with a
fixed history buffer; here they are a Python loop. Table fields are [K] or
[N, K] (a schedule per sample, candidates folded into the batch).

model_fn(x, t_orig, step_idx) -> eps (classifier-free guidance goes inside
model_fn, see samplers.guidance.cfg_eps_fn).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..schedules import ScheduleTables
from .diffusion import _at, _bcast_t, _x_T

__all__ = ["plms_sample_loop"]


@torch.no_grad()
def plms_sample_loop(model_fn: Callable, shape: Sequence[int],
                     tables: ScheduleTables, *, device=None,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PLMS sampling (eta is structurally 0, plms.py:25-27). Returns x_0
    (float32, ``shape``); x_T is ``noise`` or drawn from ``generator``.
    ``tables`` must already be on ``device``."""
    dev = torch.device(device) if device is not None else tables.betas.device
    K = tables.num_steps
    nd = len(shape) - 1

    def x_prev_from(x, e_t, i):
        a_t = _at(tables.alphas_cumprod, i, nd)
        a_prev = _at(tables.alphas_cumprod_prev, i, nd)
        sqrt_om = _at(tables.sqrt_one_minus_alphas_cumprod, i, nd)
        pred_x0 = (x - sqrt_om * e_t) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * e_t

    def eps(x, i):
        t = _bcast_t(tables.timestep_map[..., i], shape[0])
        return model_fn(x, t, i).float()

    x = _x_T(shape, noise, generator, dev)
    hist = []                                     # eps history, newest first
    for i in range(K - 1, -1, -1):
        e_t = eps(x, i)
        if not hist:
            # pseudo improved Euler: a second call at the next (lower) step
            e_next = eps(x_prev_from(x, e_t, i), max(i - 1, 0))
            e_prime = (e_t + e_next) / 2
        elif len(hist) == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif len(hist) == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                       - 9 * hist[2]) / 24
        x = x_prev_from(x, e_prime, i)
        hist = [e_t] + hist[:2]
    return x
