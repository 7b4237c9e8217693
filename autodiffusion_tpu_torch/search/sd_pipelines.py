"""The Stable Diffusion search pipeline: CLIP context bank + classifier-free
guided PLMS, DDIM or DPM-Solver + VAE decode + FID fitness.

Port of autodiffusion_tpu/search/sd_pipelines.py (get_cand_fid of
sd/scripts/search_ea.py:504-566). Candidates are integer timestep subsets
(PLMS, DDIM) or continuous time knots (DPM-Solver); the fitness is the FID
of the guided latent samples decoded through the VAE. The CLIP text tower
runs once per search, into a context bank the caller passes in; every
candidate batch takes its prompts from it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..fid.stats import FIDStats
from ..models.vae import SD_SCALE_FACTOR
from ..samplers import (DiscreteNoiseSchedule, cfg_eps_fn, ddim_sample_loop,
                        dpm_solver_sample_loop, plms_sample_loop)
from ..samplers.diffusion import ModelVarType
from ..schedules import build_sd_tables, make_beta_schedule
from .fitness import BatchedFIDFitness

__all__ = ["make_sd_fitness", "prompt_window", "sd_decode_to_uint8",
           "SD_SAMPLERS"]

SD_SAMPLERS = ("plms", "ddim", "dpm_solver")


def sd_decode_to_uint8(decode_fn: Callable, z: torch.Tensor) -> torch.Tensor:
    """Latents [N, 4, h, w] -> uint8 images [N, H, W, 3]: decode(z /
    0.18215), mapped from [-1, 1] to [0, 1] and clamped, x 255 rounded
    (search_ea.py:539-541 via decode_first_stage)."""
    x = decode_fn(z / SD_SCALE_FACTOR).float()
    x = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1) \
        .contiguous()


def prompt_window(n: int, candidate_chunk: int, batch_idx: int,
                  n_prompts: int) -> torch.Tensor:
    """Prompt indices of one fitness dispatch of ``n`` samples over
    ``candidate_chunk`` folded candidates: every candidate's slice of
    n // candidate_chunk samples draws the same prompts (so chunked FIDs
    stay comparable), and the window advances by the prompts consumed, so
    none is skipped across batches (search_ea.py:516-519)."""
    b = n // candidate_chunk
    start = (batch_idx * b) % n_prompts
    return (start + torch.arange(n) % b) % n_prompts


def make_sd_fitness(*, unet, vae, context_bank: torch.Tensor,
                    uncond_context: torch.Tensor, feature_fn: Callable,
                    ref_stats: FIDStats, num_samples: int, batch_size: int,
                    sampler: str = "plms", guidance_scale: float = 7.5,
                    latent_hw: int = 64, dpm_order: int = 2,
                    candidate_chunk: int = 4, seed: int = 0,
                    feature_dim: int = 2048, device=None) -> BatchedFIDFitness:
    """Fitness of candidates for the SD towers on ``device`` (cuda by
    default). ``context_bank`` [N, 77, 768] holds the CLIP embeddings of
    the evaluation prompts, ``uncond_context`` [77, 768] the empty
    prompt's. ``sampler`` is "plms", "ddim" (FIXED_SMALL, no clipping,
    eta 0) or "dpm_solver" (multistep at ``dpm_order``, lower_order_final,
    predict_x0); candidates are integer timesteps for the first two and
    K + 1 float times in (0, 1] for DPM-Solver."""
    dev = resolve_device(device)
    if sampler not in SD_SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; one of {SD_SAMPLERS}")
    bank = context_bank.to(dev)
    uncond = uncond_context.to(dev)
    n_prompts = bank.shape[0]
    # v1-inference.yaml's 1000-step sqrt_linear process
    noise_sched = DiscreteNoiseSchedule.from_betas(
        make_beta_schedule("sqrt_linear", 1000)).to(dev)

    def payload_fn(cand):
        if sampler == "dpm_solver":
            times = np.asarray(sorted(cand, reverse=True), np.float32)
            return {"times": torch.from_numpy(times)}
        return {"tables": build_sd_tables(cand)}

    def sample_fn(payload, gen: torch.Generator, batch_idx: int):
        n = (payload["times"] if sampler == "dpm_solver"
             else payload["tables"].betas).shape[0]   # chunk * slice
        ctx = bank[prompt_window(n, candidate_chunk, batch_idx,
                                 n_prompts).to(dev)]
        shape = (n, 4, latent_hw, latent_hw)
        noise = torch.randn(shape, generator=gen, device=dev)
        guided = cfg_eps_fn(unet, ctx, uncond, guidance_scale)
        if sampler == "dpm_solver":
            z = dpm_solver_sample_loop(guided, shape, noise_sched,
                                       payload["times"], device=dev,
                                       order=dpm_order, predict_x0=True,
                                       noise=noise)
        elif sampler == "plms":
            z = plms_sample_loop(guided, shape, payload["tables"],
                                 device=dev, noise=noise)
        else:
            z = ddim_sample_loop(guided, shape, payload["tables"], device=dev,
                                 generator=gen, clip_denoised=False,
                                 var_type=ModelVarType.FIXED_SMALL,
                                 noise=noise)
        return sd_decode_to_uint8(vae.decode, z)

    return BatchedFIDFitness(
        payload_fn=payload_fn, sample_fn=sample_fn, feature_fn=feature_fn,
        ref_stats=ref_stats, num_samples=num_samples, batch_size=batch_size,
        candidate_chunk=candidate_chunk, seed=seed, feature_dim=feature_dim,
        device=dev)
