"""Ancestral and DDIM sampling over ScheduleTables (NCHW).

Port of autodiffusion_tpu/samplers/diffusion.py (guided_diffusion/
gaussian_diffusion.py:232-716). The JAX package runs the K steps as one
``lax.scan``; here they are a Python loop. Table fields are [K] (one
schedule for the batch) or [N, K] (a schedule per sample, candidates folded
into the batch).

model_fn(x, t_orig, step_idx) -> [N, C or 2C, H, W]: ``t_orig`` the
original-process timestep, ``step_idx`` the respaced index.
cond_fn(x, t_orig) -> grad log p(y | x), the shape of x.
x_T and the per-step noise may be given; what is not given is drawn from
``generator``.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence

import torch

from ..schedules import ScheduleTables

__all__ = ["ModelMeanType", "ModelVarType", "q_sample",
           "q_posterior_mean_variance", "p_mean_variance", "p_sample_loop",
           "ddim_sample_loop"]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


def _at(arr: torch.Tensor, i: int, x_ndim: int) -> torch.Tensor:
    """tables[..., i] broadcast against an x of rank ``x_ndim`` + 1."""
    v = arr[..., i]
    return v.reshape(v.shape + (1,) * x_ndim)


def q_sample(tables: ScheduleTables, x_start, i: int, noise):
    """Diffuse x_start to respaced step i (gaussian_diffusion.py:188-210)."""
    nd = x_start.dim() - 1
    return (_at(tables.sqrt_alphas_cumprod, i, nd) * x_start
            + _at(tables.sqrt_one_minus_alphas_cumprod, i, nd) * noise)


def q_posterior_mean_variance(tables: ScheduleTables, x_start, x_t, i: int):
    """q(x_{i-1} | x_i, x_0) (gaussian_diffusion.py:212-230)."""
    nd = x_t.dim() - 1
    mean = (_at(tables.posterior_mean_coef1, i, nd) * x_start
            + _at(tables.posterior_mean_coef2, i, nd) * x_t)
    var = _at(tables.posterior_variance, i, nd)
    log_var = _at(tables.posterior_log_variance_clipped, i, nd)
    return mean, var, log_var


def _split_model_output(model_out, x, var_type: ModelVarType):
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        c = x.shape[1]
        if model_out.shape[1] != 2 * c:
            raise ValueError(f"learned variance needs 2C output channels: "
                             f"{tuple(model_out.shape)} for {tuple(x.shape)}")
        return model_out[:, :c], model_out[:, c:]
    return model_out, None


def p_mean_variance(tables: ScheduleTables, model_out, x, i: int, *,
                    mean_type: ModelMeanType, var_type: ModelVarType,
                    clip_denoised: bool = True,
                    denoised_fn: Optional[Callable] = None):
    """Model output -> (mean, variance, log_variance, pred_xstart) of
    p(x_{i-1} | x_i) (gaussian_diffusion.py:232-326)."""
    nd = x.dim() - 1
    out, var_values = _split_model_output(model_out, x, var_type)

    if var_type == ModelVarType.LEARNED:
        log_variance = var_values
        variance = torch.exp(log_variance)
    elif var_type == ModelVarType.LEARNED_RANGE:
        min_log = _at(tables.posterior_log_variance_clipped, i, nd)
        max_log = torch.log(_at(tables.betas, i, nd))
        frac = (var_values + 1) / 2
        log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        # betas, with step 0's variance replaced by posterior_variance[1]
        # (gaussian_diffusion.py:278-289); taken per step, so per-sample
        # [N, K] tables broadcast over the batch axis, never the channels
        k1 = min(1, tables.num_steps - 1)
        variance = (_at(tables.posterior_variance, k1, nd) if i == 0
                    else _at(tables.betas, i, nd))
        log_variance = torch.log(variance)
    elif var_type == ModelVarType.FIXED_SMALL:
        variance = _at(tables.posterior_variance, i, nd)
        log_variance = _at(tables.posterior_log_variance_clipped, i, nd)
    else:
        raise NotImplementedError(var_type)

    def process(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process(
            _at(1.0 / tables.posterior_mean_coef1, i, nd) * out
            - _at(tables.posterior_mean_coef2 / tables.posterior_mean_coef1,
                  i, nd) * x)
        mean = out
    elif mean_type == ModelMeanType.START_X:
        pred_xstart = process(out)
        mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, i)
    elif mean_type == ModelMeanType.EPSILON:
        pred_xstart = process(_predict_xstart_from_eps(tables, x, i, out))
        mean, _, _ = q_posterior_mean_variance(tables, pred_xstart, x, i)
    else:
        raise NotImplementedError(mean_type)
    return mean, variance, log_variance, pred_xstart


def _predict_xstart_from_eps(tables, x, i, eps):
    nd = x.dim() - 1
    return (_at(tables.sqrt_recip_alphas_cumprod, i, nd) * x
            - _at(tables.sqrt_recipm1_alphas_cumprod, i, nd) * eps)


def _predict_eps_from_xstart(tables, x, i, x0):
    nd = x.dim() - 1
    return ((_at(tables.sqrt_recip_alphas_cumprod, i, nd) * x - x0)
            / _at(tables.sqrt_recipm1_alphas_cumprod, i, nd))


def _bcast_t(t: torch.Tensor, batch: int) -> torch.Tensor:
    return t.float().expand(batch) if t.dim() == 0 else t.float()


def _x_T(shape, noise, generator, dev) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=generator, device=dev)
            if noise is None else noise.to(dev)).float()


def _z(step_noise, i: int, x: torch.Tensor, generator, dev) -> torch.Tensor:
    return (torch.randn(x.shape, generator=generator, device=dev)
            if step_noise is None else step_noise[i].to(dev))


@torch.no_grad()
def p_sample_loop(model_fn, shape: Sequence[int], tables: ScheduleTables,
                  *, device=None, generator: Optional[torch.Generator] = None,
                  mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                  clip_denoised: bool = True,
                  denoised_fn: Optional[Callable] = None,
                  cond_fn: Optional[Callable] = None,
                  noise: Optional[torch.Tensor] = None,
                  step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral sampling (gaussian_diffusion.py:395-534). Returns x_0
    (float32, ``shape``). Guidance shifts the mean by variance * cond_fn
    (condition_mean, gaussian_diffusion.py:356-369); step 0 adds no noise.

    ``noise`` is x_T; ``step_noise`` [K, *shape] the per-step z (step i
    uses step_noise[i]); either is drawn from ``generator`` when absent.
    ``tables`` must already be on ``device``."""
    dev = torch.device(device) if device is not None else tables.betas.device
    x = _x_T(shape, noise, generator, dev)
    for i in range(tables.num_steps - 1, -1, -1):
        t = _bcast_t(tables.timestep_map[..., i], shape[0])
        model_out = model_fn(x, t, i).float()
        mean, variance, log_variance, _ = p_mean_variance(
            tables, model_out, x, i, mean_type=mean_type, var_type=var_type,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn)
        if cond_fn is not None:
            mean = mean + variance * cond_fn(x, t)
        if i == 0:
            x = mean
            continue
        x = mean + torch.exp(0.5 * log_variance) \
            * _z(step_noise, i, x, generator, dev)
    return x


@torch.no_grad()
def ddim_sample_loop(model_fn, shape: Sequence[int], tables: ScheduleTables,
                     *, device=None, generator: Optional[torch.Generator] = None,
                     eta: float = 0.0,
                     mean_type: ModelMeanType = ModelMeanType.EPSILON,
                     var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                     clip_denoised: bool = True,
                     denoised_fn: Optional[Callable] = None,
                     cond_fn: Optional[Callable] = None,
                     noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None,
                     final_step_noise: bool = False) -> torch.Tensor:
    """DDIM sampling, eq. 12 of Song et al. (gaussian_diffusion.py:536-716).
    Returns x_0 (float32, ``shape``).

    ``noise`` is x_T; ``step_noise`` [K, *shape] the per-step z (step i
    uses step_noise[i]); either is drawn from ``generator`` when absent.
    ``tables`` must already be on ``device``."""
    dev = torch.device(device) if device is not None else tables.betas.device
    nd = len(shape) - 1
    x = _x_T(shape, noise, generator, dev)
    for i in range(tables.num_steps - 1, -1, -1):
        t = _bcast_t(tables.timestep_map[..., i], shape[0])
        model_out = model_fn(x, t, i).float()
        _, _, _, pred_x0 = p_mean_variance(
            tables, model_out, x, i, mean_type=mean_type, var_type=var_type,
            clip_denoised=clip_denoised, denoised_fn=denoised_fn)
        eps = _predict_eps_from_xstart(tables, x, i, pred_x0)
        if cond_fn is not None:
            # guidance on the score (gaussian_diffusion.py:371-393
            # condition_score); the reference does NOT re-clip pred_xstart
            # after guidance
            eps = eps - (_at(tables.sqrt_one_minus_alphas_cumprod, i, nd)
                         * cond_fn(x, t))
            pred_x0 = _predict_xstart_from_eps(tables, x, i, eps)
        abar = _at(tables.alphas_cumprod, i, nd)
        abar_prev = _at(tables.alphas_cumprod_prev, i, nd)
        sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
                 * torch.sqrt(1 - abar / abar_prev))
        mean_pred = (pred_x0 * torch.sqrt(abar_prev)
                     + torch.sqrt(1 - abar_prev - sigma ** 2) * eps)
        # ADM zeroes the stochastic term at the final respaced step;
        # final_step_noise=True keeps it (CompVis DDIM semantics)
        if i == 0 and not final_step_noise:
            x = mean_pred
            continue
        x = mean_pred + sigma * _z(step_noise, i, x, generator, dev)
    return x
