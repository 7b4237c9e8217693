"""DDIM sampling with classifier guidance, and PLMS with classifier-free
guidance."""

from .diffusion import (ModelMeanType, ModelVarType, ddim_sample_loop,
                        p_mean_variance, q_posterior_mean_variance, q_sample)
from .guidance import cfg_eps_fn, classifier_cond_fn
from .plms import plms_sample_loop

__all__ = ["ModelMeanType", "ModelVarType", "ddim_sample_loop",
           "p_mean_variance", "q_posterior_mean_variance", "q_sample",
           "classifier_cond_fn", "cfg_eps_fn", "plms_sample_loop"]
