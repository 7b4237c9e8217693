"""Noisy-classifier training (the ADM-G guidance classifier).

Port of autodiffusion_tpu/train/classifier.py (scripts/classifier_train.py):
the EncoderUNetModel learns to classify q_sample-noised images at random
timesteps, so that its gradients can steer sampling; cross-entropy over
integer labels, AdamW, top-1 / top-5 accuracy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataSharder
from ..samplers.diffusion import q_sample
from ..schedules import ScheduleTables
from .state import TrainState, global_norm, take_grads

__all__ = ["make_classifier_train_step", "classifier_accuracy"]


def classifier_accuracy(logits: torch.Tensor, y: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    top1 = (logits.argmax(dim=-1) == y).float().mean()
    k = min(5, logits.shape[-1])
    topk = (logits.topk(k, dim=-1).indices == y[:, None]).any(dim=-1)
    return {"acc@1": top1, "acc@5": topk.float().mean()}


def make_classifier_train_step(classifier: nn.Module, *,
                               noised: bool = True,
                               data_sharder: Optional[Callable] = None
                               ) -> Callable:
    """step(state, tables, batch{x, y}, t, generator=None, noise=None) ->
    (state, metrics). ``noised`` trains on q_sample-noised inputs (the
    guidance classifier) or on clean images at t = 0
    (classifier_train.py --noised); noise is drawn from ``generator`` at
    the batch's shape when not given. ``data_sharder`` (one rank when not
    given) makes it data parallel: the batch, t and noise are global and
    each rank trains on its rows, with the gradients (the state's
    ``grad_buffer``), loss and accuracies averaged over the ranks before
    grad_norm and the update (as :func:`make_train_step`)."""
    data_sharder = data_sharder or DataSharder()

    def step(state: TrainState, tables: ScheduleTables,
             batch: Dict[str, torch.Tensor], t: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        x, y = batch["x"], batch["y"]
        if noised and noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        x, y, t, noise = (data_sharder(v) for v in (x, y, t, noise))
        if noised:
            x = q_sample(tables, x, t, noise)
            t_orig = tables.timestep_map[t].float()
        else:
            t_orig = torch.zeros(x.shape[0], device=x.device)
        state.bind_grads()
        logits = classifier(x, t_orig)
        per_example = F.cross_entropy(logits, y, reduction="none")
        loss = per_example.mean()
        loss.backward()
        grads = take_grads(state.params)
        metrics = {"loss": loss.detach(),
                   "per_example_loss": per_example.detach()}
        metrics.update(classifier_accuracy(logits.detach(), y))
        data_sharder.all_reduce_mean_([state.grad_buffer])
        data_sharder.all_reduce_mean_(
            [metrics[k] for k in ("loss", "acc@1", "acc@5")])
        metrics["grad_norm"] = global_norm(grads)
        state.apply_gradients(grads)
        return state, metrics

    return step
