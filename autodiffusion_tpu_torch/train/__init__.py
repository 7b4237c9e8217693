"""Training: losses, timestep samplers, the train state and step, loops."""

from .classifier import classifier_accuracy, make_classifier_train_step
from .losses import (LossType, calc_bpd_loop,
                     discretized_gaussian_log_likelihood, normal_kl,
                     training_losses, vb_terms_bpd)
from .loop import (TrainLoop, ofa_random_select_tables_fn, ofa_tables_fn,
                   resume_train_state)
from .resample import (LossSecondMomentResampler, UniformSampler,
                       create_named_schedule_sampler)
from .state import TrainState, create_train_state, make_train_step

__all__ = [
    "LossType", "calc_bpd_loop", "discretized_gaussian_log_likelihood",
    "normal_kl", "training_losses", "vb_terms_bpd",
    "LossSecondMomentResampler", "UniformSampler",
    "create_named_schedule_sampler", "TrainState", "create_train_state",
    "make_train_step", "TrainLoop", "ofa_random_select_tables_fn",
    "ofa_tables_fn", "resume_train_state", "classifier_accuracy",
    "make_classifier_train_step",
]
