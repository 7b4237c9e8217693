"""Training losses: MSE / rescaled-MSE / KL variational bound (NCHW).

Port of autodiffusion_tpu/train/losses.py (guided_diffusion/losses.py:12-77
and gaussian_diffusion.py:718-908), with the variance-learning trick kept:
the VLB term sees a detached mean, so learned-sigma training does not
fight the MSE objective. ``t`` is an int64 [B] tensor of respaced step
indices. The noise may be given (``noise``, and [K, ...] per step in
:func:`calc_bpd_loop`); what is not given is drawn from ``generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..samplers.diffusion import (ModelMeanType, ModelVarType, _at,
                                  _predict_eps_from_xstart, p_mean_variance,
                                  q_posterior_mean_variance, q_sample)
from ..schedules import ScheduleTables

__all__ = ["LossType", "normal_kl", "approx_standard_normal_cdf",
           "discretized_gaussian_log_likelihood", "mean_flat",
           "vb_terms_bpd", "training_losses", "calc_bpd_loop"]

_LOG2 = math.log(2.0)


class LossType:
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)) per element (nats)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of data discretised to 255 bins under a Gaussian
    (losses.py:50-77). x in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def mean_flat(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def vb_terms_bpd(tables: ScheduleTables, model_out, x_start, x_t, t, *,
                 mean_type: ModelMeanType, var_type: ModelVarType,
                 clip_denoised: bool = False):
    """KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) in bits, or the
    decoder NLL where t = 0 (gaussian_diffusion.py:718-751). Returns
    ([B] bits, pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(
        tables, x_start, x_t, t)
    mean, _, log_var, pred_x0 = p_mean_variance(
        tables, model_out, x_t, t, mean_type=mean_type, var_type=var_type,
        clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, mean, log_var)) / _LOG2
    decoder_nll = -mean_flat(discretized_gaussian_log_likelihood(
        x_start, means=mean, log_scales=0.5 * log_var)) / _LOG2
    return torch.where(t == 0, decoder_nll, kl), pred_x0


def _noise_like(x, generator: Optional[torch.Generator]):
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def training_losses(tables: ScheduleTables, model_fn: Callable, x_start,
                    t: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                    loss_type: str = LossType.MSE,
                    noise: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-example training losses (gaussian_diffusion.py:753-832).

    model_fn(x_t, t_orig) -> model output [B, C or 2C, H, W]; t is the
    respaced step index [B]. Returns {"loss", and "mse" / "vb" where the
    loss has them}, each [B]."""
    if noise is None:
        noise = _noise_like(x_start, generator)
    x_t = q_sample(tables, x_start, t, noise)
    t_orig = tables.timestep_map[t].float()
    terms: Dict[str, torch.Tensor] = {}

    model_out = model_fn(x_t, t_orig)
    if loss_type in (LossType.KL, LossType.RESCALED_KL):
        vb, _ = vb_terms_bpd(tables, model_out, x_start, x_t, t,
                             mean_type=mean_type, var_type=var_type)
        terms["loss"] = (vb * tables.num_steps
                         if loss_type == LossType.RESCALED_KL else vb)
        return terms

    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        c = x_start.shape[1]
        eps_out, var_values = model_out[:, :c], model_out[:, c:]
        # variance-only VLB: the mean prediction is detached so the vb term
        # trains only the variance head (gaussian_diffusion.py:792-806)
        frozen = torch.cat([eps_out.detach(), var_values], dim=1)
        vb, _ = vb_terms_bpd(tables, frozen, x_start, x_t, t,
                             mean_type=mean_type, var_type=var_type)
        if loss_type == LossType.RESCALED_MSE:
            vb = vb * tables.num_steps / 1000.0
        terms["vb"] = vb
        model_out = eps_out

    if mean_type == ModelMeanType.EPSILON:
        target = noise
    elif mean_type == ModelMeanType.START_X:
        target = x_start
    elif mean_type == ModelMeanType.PREVIOUS_X:
        target, _, _ = q_posterior_mean_variance(tables, x_start, x_t, t)
    else:
        raise NotImplementedError(mean_type)
    terms["mse"] = mean_flat((target - model_out) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms \
        else terms["mse"]
    return terms


def _prior_bpd(tables: ScheduleTables, x_start):
    """KL(q(x_T | x_0) || N(0, I)) in bits (gaussian_diffusion.py:834-850)."""
    i = tables.num_steps - 1
    nd = x_start.dim() - 1
    mean = _at(tables.sqrt_alphas_cumprod, i, nd) * x_start
    log_var = _at(tables.log_one_minus_alphas_cumprod, i, nd)
    kl = normal_kl(mean, log_var, torch.zeros_like(mean),
                   torch.zeros_like(log_var))
    return mean_flat(kl) / _LOG2


@torch.no_grad()
def calc_bpd_loop(tables: ScheduleTables, model_fn: Callable, x_start,
                  generator: Optional[torch.Generator] = None, *,
                  mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                  clip_denoised: bool = True,
                  noise: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The full variational bound in bits/dim over every timestep
    (gaussian_diffusion.py:852-908; scripts/image_nll.py). ``noise`` is
    [K, *x_start.shape] (step i uses noise[i]). Returns per-example
    total_bpd and prior_bpd [B], and per-(step, example) vb, xstart_mse
    and mse [K, B] (ascending t)."""
    b = x_start.shape[0]
    vbs, xstart_mses, mses = [], [], []
    for i in range(tables.num_steps):
        z = _noise_like(x_start, generator) if noise is None else noise[i]
        t = torch.full((b,), i, dtype=torch.long, device=x_start.device)
        x_t = q_sample(tables, x_start, t, z)
        model_out = model_fn(x_t, tables.timestep_map[t].float())
        vb, pred_x0 = vb_terms_bpd(tables, model_out, x_start, x_t, t,
                                   mean_type=mean_type, var_type=var_type,
                                   clip_denoised=clip_denoised)
        eps = _predict_eps_from_xstart(tables, x_t, t, pred_x0)
        vbs.append(vb)
        xstart_mses.append(mean_flat((pred_x0 - x_start) ** 2))
        mses.append(mean_flat((eps - z) ** 2))
    vb = torch.stack(vbs)
    prior = _prior_bpd(tables, x_start)
    return {"total_bpd": vb.sum(dim=0) + prior, "prior_bpd": prior,
            "vb": vb, "xstart_mse": torch.stack(xstart_mses),
            "mse": torch.stack(mses)}
