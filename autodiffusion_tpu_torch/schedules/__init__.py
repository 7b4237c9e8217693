"""Diffusion schedules as data: betas, timestep subsets, coefficient tables."""

from .beta import betas_for_alpha_bar, make_beta_schedule
from .respace import make_ddim_timesteps, respaced_betas, space_timesteps
from .tables import (ScheduleTables, build_base_tables, build_sd_tables,
                     build_tables, stack_tables)

__all__ = [
    "betas_for_alpha_bar",
    "make_beta_schedule",
    "respaced_betas",
    "make_ddim_timesteps",
    "space_timesteps",
    "ScheduleTables",
    "build_base_tables",
    "build_tables",
    "build_sd_tables",
    "stack_tables",
]
