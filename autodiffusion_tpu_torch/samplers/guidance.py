"""Guidance: classifier gradients (ADM-G) and classifier-free guidance.

Port of autodiffusion_tpu/samplers/guidance.py: ``classifier_cond_fn``
(search_imagenet64_classifier_guidance.py:319-326), the sum of the
per-example selected log-softmax differentiated with torch.autograd, and
``cfg_eps_fn``, classifier-free guidance through one model call on the
doubled batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["classifier_cond_fn", "cfg_eps_fn"]


def classifier_cond_fn(classifier_fn: Callable, y: torch.Tensor,
                       scale: float = 1.0) -> Callable:
    """cond_fn(x, t) = scale * grad_x log p(y | x, t), with
    ``classifier_fn(x, t) -> logits [B, num_classes]``."""

    def cond_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            logp = F.log_softmax(classifier_fn(x_in, t).float(), dim=-1)
            selected = logp.gather(1, y[:, None]).sum()
            (grad,) = torch.autograd.grad(selected, x_in)
        return grad * scale

    return cond_fn


def cfg_eps_fn(apply_fn: Callable, ctx: torch.Tensor, uncond_ctx: torch.Tensor,
               guidance_scale: float,
               prompt_mask: Optional[torch.Tensor] = None) -> Callable:
    """Classifier-free guidance by the doubled batch, in the reference's
    batch order [uncond | cond] (ddim.py:184-191: cat([uc, c]), then
    chunk(2) -> e_t_uncond, e_t): eps = eps_u + scale (eps_c - eps_u).

    ``apply_fn(x2, t2, ctx2) -> eps`` is the conditional model on the
    doubled batch. ``prompt_mask`` (an optional [K] 0/1 vector, the
    txt2img_prompt_mask.py ablation) scales the guidance per step, so the
    sampler must pass the step index. Returns ``guided(x, t, i) -> eps``."""
    if uncond_ctx.dim() < ctx.dim():
        uncond_ctx = uncond_ctx[None].expand_as(ctx)

    def guided(x: torch.Tensor, t: torch.Tensor, i=None) -> torch.Tensor:
        n = x.shape[0]
        out = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                       torch.cat([uncond_ctx, ctx]))
        e_u, e_c = out[:n], out[n:]
        s = guidance_scale
        if prompt_mask is not None:
            if i is None:
                # a sampler that does not pass the step index would apply
                # full guidance at every step, and the ablation would
                # measure nothing
                raise ValueError(
                    "prompt_mask requires a sampler that passes the step "
                    "index (ddim/plms)")
            s = s * prompt_mask[i]
        return e_u + s * (e_c - e_u)

    return guided
