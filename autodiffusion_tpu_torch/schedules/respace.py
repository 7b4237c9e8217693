"""Timestep-subset selection and schedule respacing.

This is the mathematical core of AutoDiffusion: given a base T-step schedule
and an arbitrary subset of K original timesteps (a search candidate), derive
a new K-step diffusion whose marginals match the base process at the kept
steps. Reference behavior: guided_diffusion/respace.py:7-85 (space_timesteps
and SpacedDiffusion), the in-place variant at
search_imagenet64_classifier_guidance.py:200-255 (reset_diffusion).

Unlike the reference — which mutates a deepcopied SpacedDiffusion object per
candidate — respacing here is a pure function from (base betas, timestep
subset) to a ScheduleTables pytree; see tables.py.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Set, Union

import numpy as np

__all__ = ["space_timesteps", "respaced_betas", "make_ddim_timesteps"]


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Select a subset of original timesteps, guided-diffusion style.

    ``section_counts`` may be:
      * ``"ddimN"`` — the unique fixed-stride subset of size N starting at 0
        (errors if no integer stride yields exactly N steps);
      * ``"a,b,c"`` or a list of ints — split [0, T) into len(counts)
        contiguous sections and place count_i evenly-rounded steps in
        section i.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot make exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    section_counts = list(section_counts)

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    taken: Set[int] = set()
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot take {count} steps from a section of {size}")
        if count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            taken.add(start + round(cur))
            cur += frac_stride
        start += size
    return taken


def make_ddim_timesteps(method: str, num_ddim_steps: int,
                        num_train_steps: int) -> np.ndarray:
    """Stable-Diffusion-style DDIM grids with the historical +1 offset
    (ldm/modules/diffusionmodules/util.py:46-57).

    ``uniform``: range(0, T, round(T / num_ddim)) + 1; the stride is
        rounded and the range not truncated, so the count can differ from
        the request when num_ddim does not divide T (30 steps of 1000 give
        31).
    ``quad``: round(linspace(0, sqrt(0.8 T), num_ddim)^2) + 1."""
    if method == "uniform":
        c = round(num_train_steps / num_ddim_steps)
        steps = np.asarray(list(range(0, num_train_steps, c)))
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_train_steps * 0.8),
                             num_ddim_steps) ** 2).astype(int)
    else:
        raise ValueError(f"unknown ddim discretization method: {method!r}")
    return steps + 1


def respaced_betas(base_alphas_cumprod: np.ndarray,
                   use_timesteps: Iterable[int]) -> "tuple[np.ndarray, List[int]]":
    """Derive the K-step betas for a subset of original timesteps.

    For kept steps t_0 < t_1 < ... (sorted ascending), the new process has
    beta_i = 1 - alpha_bar[t_i] / alpha_bar[t_{i-1}] (with alpha_bar[t_{-1}]
    taken as 1), which preserves the cumulative products at the kept steps.
    Returns (betas[K] float64, timestep_map list of original steps ascending).
    """
    use = sorted(set(int(t) for t in use_timesteps))
    if not use:
        raise ValueError("use_timesteps must be non-empty")
    T = len(base_alphas_cumprod)
    if use[0] < 0 or use[-1] >= T:
        raise ValueError(f"timesteps must lie in [0, {T}); got {use[0]}..{use[-1]}")
    last = 1.0
    betas = np.empty(len(use), dtype=np.float64)
    for i, t in enumerate(use):
        abar = float(base_alphas_cumprod[t])
        betas[i] = 1.0 - abar / last
        last = abar
    return betas, use
