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

Spans (``utils.trace``, off unless turned on): each loop is one
``adt.sampler.loop`` (``rows``, ``steps``) of ``adt.sampler.step`` spans
(``index``, the respaced step), each holding ``adt.sampler.model`` (the
model_fn call) and, where guided, ``adt.sampler.guidance`` (the cond_fn
call, the classifier's forward and its input gradient, with its term
added); the rest of a step is the update. A loop inside a fitness chunk
carries the chunk's trace id, any other loop opens a fresh one.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence, Union

import torch

from ..schedules import ScheduleTables
from ..utils import trace

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


# a respaced step index: one int for the whole batch, or an int64 [B]
# tensor of per-example steps (training draws one t per example)
Index = Union[int, torch.Tensor]


def _at(arr: torch.Tensor, i: Index, x_ndim: int) -> torch.Tensor:
    """tables[..., i] broadcast against an x of rank ``x_ndim`` + 1
    (gaussian_diffusion.py:910-923 _extract_into_tensor): an int ``i``
    gives [...] + (1,) * x_ndim, a [B] ``i`` over [K] tables [B] + (1,) *
    x_ndim."""
    v = arr[..., i]
    return v.reshape(v.shape + (1,) * x_ndim)


def q_sample(tables: ScheduleTables, x_start, i: Index, noise):
    """Diffuse x_start to respaced step i (gaussian_diffusion.py:188-210)."""
    nd = x_start.dim() - 1
    return (_at(tables.sqrt_alphas_cumprod, i, nd) * x_start
            + _at(tables.sqrt_one_minus_alphas_cumprod, i, nd) * noise)


def q_posterior_mean_variance(tables: ScheduleTables, x_start, x_t,
                              i: Index):
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


def p_mean_variance(tables: ScheduleTables, model_out, x, i: Index, *,
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
        # [N, K] tables broadcast over the batch axis, never the channels,
        # and a [B] index per example
        k1 = min(1, tables.num_steps - 1)
        if isinstance(i, int):
            variance = (_at(tables.posterior_variance, k1, nd) if i == 0
                        else _at(tables.betas, i, nd))
        else:
            first = (i == 0).reshape(i.shape + (1,) * nd)
            variance = torch.where(first,
                                   _at(tables.posterior_variance, k1, nd),
                                   _at(tables.betas, i, nd))
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


def _all_rows(x):
    return x


def _x_T(shape, noise, generator, dev,
         shard: Callable = _all_rows) -> torch.Tensor:
    return shard((torch.randn(tuple(shape), generator=generator, device=dev)
                  if noise is None else noise.to(dev)).float())


def _z(step_noise, i: int, shape, generator, dev,
       shard: Callable) -> torch.Tensor:
    """Step i's z: drawn at ``shape`` (the global batch's) and sliced."""
    return shard(torch.randn(tuple(shape), generator=generator, device=dev)
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
                  step_noise: Optional[torch.Tensor] = None,
                  shard_fn: Optional[Callable] = None) -> torch.Tensor:
    """Ancestral sampling (gaussian_diffusion.py:395-534). Returns x_0
    (float32, ``shape``). Guidance shifts the mean by variance * cond_fn
    (condition_mean, gaussian_diffusion.py:356-369); step 0 adds no noise.

    ``noise`` is x_T; ``step_noise`` [K, *shape] the per-step z (step i
    uses step_noise[i]); either is drawn from ``generator`` when absent.
    ``tables`` must already be on ``device``. With ``shard_fn`` (this
    data-parallel rank's rows of a batch) ``shape``, ``noise`` and
    ``step_noise`` are the global batch's: each draw is made at the global
    shape and sliced, so every rank's rows equal those of one process;
    ``tables`` (where per sample), ``model_fn`` and ``cond_fn`` see this
    rank's rows, and so does the result."""
    dev = torch.device(device) if device is not None else tables.betas.device
    shard = shard_fn or _all_rows
    x = _x_T(shape, noise, generator, dev, shard)
    with trace.span("adt.sampler.loop", rows=x.shape[0],
                    steps=tables.num_steps):
        for i in range(tables.num_steps - 1, -1, -1):
            with trace.span("adt.sampler.step", index=i):
                t = _bcast_t(tables.timestep_map[..., i], x.shape[0])
                with trace.span("adt.sampler.model"):
                    model_out = model_fn(x, t, i).float()
                mean, variance, log_variance, _ = p_mean_variance(
                    tables, model_out, x, i, mean_type=mean_type,
                    var_type=var_type, clip_denoised=clip_denoised,
                    denoised_fn=denoised_fn)
                if cond_fn is not None:
                    with trace.span("adt.sampler.guidance"):
                        mean = mean + variance * cond_fn(x, t)
                if i == 0:
                    x = mean
                    continue
                x = mean + torch.exp(0.5 * log_variance) \
                    * _z(step_noise, i, shape, generator, dev, shard)
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
                     final_step_noise: bool = False,
                     shard_fn: Optional[Callable] = None) -> torch.Tensor:
    """DDIM sampling, eq. 12 of Song et al. (gaussian_diffusion.py:536-716).
    Returns x_0 (float32, ``shape``).

    ``noise`` is x_T; ``step_noise`` [K, *shape] the per-step z (step i
    uses step_noise[i]); either is drawn from ``generator`` when absent.
    ``tables`` must already be on ``device``. ``shard_fn`` as in
    :func:`p_sample_loop`."""
    dev = torch.device(device) if device is not None else tables.betas.device
    nd = len(shape) - 1
    shard = shard_fn or _all_rows
    x = _x_T(shape, noise, generator, dev, shard)
    with trace.span("adt.sampler.loop", rows=x.shape[0],
                    steps=tables.num_steps):
        for i in range(tables.num_steps - 1, -1, -1):
            with trace.span("adt.sampler.step", index=i):
                t = _bcast_t(tables.timestep_map[..., i], x.shape[0])
                with trace.span("adt.sampler.model"):
                    model_out = model_fn(x, t, i).float()
                _, _, _, pred_x0 = p_mean_variance(
                    tables, model_out, x, i, mean_type=mean_type,
                    var_type=var_type, clip_denoised=clip_denoised,
                    denoised_fn=denoised_fn)
                eps = _predict_eps_from_xstart(tables, x, i, pred_x0)
                if cond_fn is not None:
                    # guidance on the score (gaussian_diffusion.py:371-393
                    # condition_score); the reference does NOT re-clip
                    # pred_xstart after guidance
                    with trace.span("adt.sampler.guidance"):
                        eps = eps - (_at(tables.sqrt_one_minus_alphas_cumprod,
                                         i, nd) * cond_fn(x, t))
                    pred_x0 = _predict_xstart_from_eps(tables, x, i, eps)
                abar = _at(tables.alphas_cumprod, i, nd)
                abar_prev = _at(tables.alphas_cumprod_prev, i, nd)
                sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
                         * torch.sqrt(1 - abar / abar_prev))
                mean_pred = (pred_x0 * torch.sqrt(abar_prev)
                             + torch.sqrt(1 - abar_prev - sigma ** 2) * eps)
                # ADM zeroes the stochastic term at the final respaced
                # step; final_step_noise=True keeps it (CompVis DDIM
                # semantics)
                if i == 0 and not final_step_noise:
                    x = mean_pred
                    continue
                x = mean_pred + sigma * _z(step_noise, i, shape, generator,
                                           dev, shard)
    return x
