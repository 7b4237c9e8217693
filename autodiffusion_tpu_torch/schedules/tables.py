"""ScheduleTables: a diffusion schedule as a dataclass of tensors.

Port of autodiffusion_tpu/schedules/tables.py. Every coefficient is derived
in float64 numpy on the host (formula for formula
guided_diffusion/gaussian_diffusion.py:118-169) and shipped as float32
tensors. A table field is [K] for one candidate, [C, K] after
:func:`stack_tables`, or [N, K] per sample once candidates are folded into
the batch (:meth:`ScheduleTables.map` with ``repeat_interleave``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .beta import make_beta_schedule
from .respace import respaced_betas, space_timesteps

__all__ = ["ScheduleTables", "build_tables", "build_base_tables",
           "build_sd_tables", "stack_tables"]


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Per-step coefficients of a K-step (possibly respaced) process.

    ``timestep_map[..., i]`` is the original timestep fed to the model at
    respaced step i (ascending); every other field is float32."""

    timestep_map: torch.Tensor          # int64 [..., K]
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    continuous_times: torch.Tensor      # (step + 1) / T_base

    @property
    def num_steps(self) -> int:
        return self.betas.shape[-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ScheduleTables":
        """Apply ``fn`` to every field."""
        return ScheduleTables(**{f.name: fn(getattr(self, f.name))
                                 for f in dataclasses.fields(self)})

    def to(self, device) -> "ScheduleTables":
        return self.map(lambda t: t.to(device))


def _derive(betas: np.ndarray) -> dict:
    """All derived coefficient arrays from betas, float64 numpy."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1:
        raise ValueError("betas must be 1-D")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # log-variance clipped at step 0 because posterior_variance[0] == 0.
    if len(betas) > 1:
        plvc = np.log(np.append(posterior_variance[1], posterior_variance[1:]))
    else:
        plvc = np.log(np.maximum(posterior_variance, 1e-20))
    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=plvc,
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
    )


def _to_tables(betas: np.ndarray, timestep_map: Sequence[int],
               base_T: int, derived: Optional[dict] = None) -> ScheduleTables:
    d = _derive(betas) if derived is None else derived
    tmap = np.asarray(timestep_map, dtype=np.int64)
    cont = (tmap.astype(np.float64) + 1.0) / float(base_T)
    f32 = {k: torch.from_numpy(v.astype(np.float32)) for k, v in d.items()}
    return ScheduleTables(timestep_map=torch.from_numpy(tmap),
                          continuous_times=torch.from_numpy(
                              cont.astype(np.float32)),
                          **f32)


def build_base_tables(schedule: str = "linear", num_steps: int = 1000
                      ) -> ScheduleTables:
    """Tables for the full (unrespaced) T-step process."""
    betas = make_beta_schedule(schedule, num_steps)
    return _to_tables(betas, list(range(num_steps)), num_steps)


def build_tables(use_timesteps: Union[str, Iterable[int]], *,
                 base_schedule: str = "linear",
                 base_num_steps: int = 1000,
                 base_betas: Optional[np.ndarray] = None) -> ScheduleTables:
    """Tables for a respaced process over a subset of original timesteps
    (an iterable of steps, any order, or a :func:`space_timesteps` string
    such as ``"ddim4"``)."""
    if base_betas is None:
        base_betas = make_beta_schedule(base_schedule, base_num_steps)
    base_betas = np.asarray(base_betas, dtype=np.float64)
    T = len(base_betas)
    if isinstance(use_timesteps, str):
        use_timesteps = space_timesteps(T, use_timesteps)
    base_abar = np.cumprod(1.0 - base_betas)
    new_betas, timestep_map = respaced_betas(base_abar, use_timesteps)
    return _to_tables(new_betas, timestep_map, T)


def build_sd_tables(use_timesteps: Iterable[int], *,
                    base_num_steps: int = 1000,
                    linear_start: float = 0.00085,
                    linear_end: float = 0.012) -> ScheduleTables:
    """Tables with CompVis DDIM/PLMS semantics
    (ldm/modules/diffusionmodules/util.py:64-76 make_ddim_sampling_parameters).

    Differs from :func:`build_tables` in one quirk, kept on purpose:
    alphas_cumprod_prev[0] is alpha_bar[0] of the *base* process (not 1.0),
    as ``alphas_prev = [alphacums[0]] + alphacums[steps[:-1]]``. CompVis's
    "linear" schedule is sqrt-space linear, ``sqrt_linear`` here."""
    base_betas = make_beta_schedule("sqrt_linear", base_num_steps,
                                    linear_start=linear_start,
                                    linear_end=linear_end)
    T = len(base_betas)
    steps = sorted(set(int(t) for t in use_timesteps))
    if not steps:
        raise ValueError("use_timesteps must be non-empty")
    if steps[0] < 0 or steps[-1] >= T:
        raise ValueError(f"timesteps must lie in [0, {T})")
    abar = np.cumprod(1.0 - base_betas)
    a = abar[steps]
    a_prev = np.concatenate([[abar[0]], a[:-1]])
    # per-step betas consistent with (a, a_prev) through the generic
    # derivation, then every cumulative-product and posterior field from
    # the exact CompVis arrays: with step 0 in the subset the quirk makes
    # betas_k[0] == 0, and _derive's own cumprod would give 0/0 there
    betas_k = 1.0 - a / a_prev
    with np.errstate(divide="ignore", invalid="ignore"):
        d = _derive(betas_k)
    pv = betas_k * (1.0 - a_prev) / (1.0 - a)
    plvc = (np.log(np.append(pv[1], pv[1:])) if len(betas_k) > 1
            else np.log(np.maximum(pv, 1e-20)))
    d.update(
        posterior_variance=pv,
        posterior_log_variance_clipped=plvc,
        posterior_mean_coef1=betas_k * np.sqrt(a_prev) / (1.0 - a),
        posterior_mean_coef2=((1.0 - a_prev) * np.sqrt(1.0 - betas_k)
                              / (1.0 - a)),
        alphas_cumprod=a,
        alphas_cumprod_prev=a_prev,
        alphas_cumprod_next=np.append(a[1:], 0.0),
        sqrt_alphas_cumprod=np.sqrt(a),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - a),
        log_one_minus_alphas_cumprod=np.log(1.0 - a),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / a),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / a - 1.0),
    )
    return _to_tables(betas_k, steps, T, derived=d)


def stack_tables(tables: Sequence[ScheduleTables]) -> ScheduleTables:
    """Stack same-K tables along a new leading candidate axis."""
    ks = {t.num_steps for t in tables}
    if len(ks) != 1:
        raise ValueError(f"all candidates must share K; got K in {sorted(ks)}")
    return ScheduleTables(**{
        f.name: torch.stack([getattr(t, f.name) for t in tables], dim=0)
        for f in dataclasses.fields(ScheduleTables)})
