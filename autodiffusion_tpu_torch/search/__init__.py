"""Evolutionary search over timestep schedules (and architectures)."""

from .evolution import EvolutionSearcher, progressive_skip_hook
from .fitness import BatchedFIDFitness, to_uint8
from .pipelines import keep_masks_for, make_adm_fitness
from .sd_pipelines import make_sd_fitness, prompt_window, sd_decode_to_uint8
from .space import (ContinuousTimeSpace, JointSpace, TimestepSpace,
                    parse_joint_string, parse_timestep_string)

__all__ = [
    "EvolutionSearcher", "progressive_skip_hook", "BatchedFIDFitness",
    "to_uint8", "keep_masks_for", "make_adm_fitness", "ContinuousTimeSpace",
    "JointSpace", "TimestepSpace", "parse_joint_string",
    "parse_timestep_string", "make_sd_fitness", "prompt_window",
    "sd_decode_to_uint8",
]
