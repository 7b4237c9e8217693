"""DDIM sampling with classifier guidance."""

from .diffusion import (ModelMeanType, ModelVarType, ddim_sample_loop,
                        p_mean_variance, q_posterior_mean_variance, q_sample)
from .guidance import classifier_cond_fn

__all__ = ["ModelMeanType", "ModelVarType", "ddim_sample_loop",
           "p_mean_variance", "q_posterior_mean_variance", "q_sample",
           "classifier_cond_fn"]
