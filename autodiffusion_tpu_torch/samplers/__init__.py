"""Ancestral and DDIM sampling with classifier guidance, PLMS with
classifier-free guidance, and multistep DPM-Solver."""

from .diffusion import (ModelMeanType, ModelVarType, ddim_sample_loop,
                        p_mean_variance, p_sample_loop,
                        q_posterior_mean_variance, q_sample)
from .dpm_solver import (DiscreteNoiseSchedule, dpm_solver_sample_loop,
                         dpm_solver_times)
from .guidance import cfg_eps_fn, classifier_cond_fn
from .plms import plms_sample_loop

__all__ = ["ModelMeanType", "ModelVarType", "ddim_sample_loop",
           "p_mean_variance", "p_sample_loop", "q_posterior_mean_variance",
           "q_sample", "classifier_cond_fn", "cfg_eps_fn", "plms_sample_loop",
           "DiscreteNoiseSchedule", "dpm_solver_sample_loop",
           "dpm_solver_times"]
