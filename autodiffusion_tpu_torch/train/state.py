"""Train state and the train step (AdamW + EMA, bf16 compute over float32
parameters).

Port of autodiffusion_tpu/train/state.py (guided_diffusion/
train_util.py:100-275): ``torch.optim.AdamW`` for optax's ``adamw``
(both apply the decay from the old parameters, p - lr (adam + wd p)),
optax's ``linear_schedule(lr, 0, steps)`` anneal on the optimizer's own
update count, optax's global-norm clipping, and one float32 EMA copy of
the parameters per rate, updated as e r + p (1 - r) after every update.
Microbatch gradients are averaged, as the JAX package's ``lax.scan``
averages them. :meth:`TrainState.load_optax_state` takes over the state
of ``adt train``'s optimizer from its ``opt{step}.msgpack``. The step trains the module in whatever mode its caller
set (``model.train()`` for dropout).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..samplers.diffusion import ModelMeanType, ModelVarType
from ..schedules import ScheduleTables
from .losses import LossType, training_losses

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "global_norm", "take_grads"]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


def take_grads(params: Sequence[nn.Parameter], divide: int = 1
               ) -> List[torch.Tensor]:
    """Each parameter's accumulated gradient (zeros where none reached it,
    as jax.grad gives), divided by ``divide``; the parameters' .grad are
    cleared."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    for p in params:
        p.grad = None
    if divide != 1:
        torch._foreach_div_(grads, divide)
    return grads


class TrainState:
    """A module under training: its parameters, the AdamW optimizer over
    them, optional lr anneal and clipping, the EMA copies and the number
    of updates applied (``step``)."""

    def __init__(self, model: nn.Module, *, lr: float, weight_decay: float,
                 ema_rates: Sequence[float], grad_clip: Optional[float],
                 lr_anneal_steps: int):
        self.model = model
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr = lr
        self.lr_anneal_steps = lr_anneal_steps
        self.grad_clip = grad_clip
        self.optimizer = torch.optim.AdamW(self.params, lr=lr,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        self.ema_rates = tuple(float(r) for r in ema_rates)
        self.ema_params = tuple(
            [p.detach().float().clone() for p in self.params]
            for _ in self.ema_rates)
        self.step = 0

    def updates(self) -> int:
        """Updates the optimizer has applied (optax's count: it restarts
        with a fresh optimizer)."""
        st = self.optimizer.state.get(self.params[0], {})
        return int(st["step"]) if "step" in st else 0

    def current_lr(self) -> float:
        if not self.lr_anneal_steps:
            return self.lr
        frac = min(self.updates() / self.lr_anneal_steps, 1.0)
        return self.lr * (1.0 - frac)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update from ``grads`` (aligned with ``params``),
        then the EMA updates."""
        grads = list(grads)
        if self.grad_clip:
            norm = float(global_norm(grads))
            if norm >= self.grad_clip:
                torch._foreach_mul_(grads, self.grad_clip / norm)
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        for group in self.optimizer.param_groups:
            group["lr"] = self.current_lr()
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        live = [p.detach() for p in self.params]
        for rate, ema in zip(self.ema_rates, self.ema_params):
            torch._foreach_mul_(ema, rate)
            torch._foreach_add_(ema, live, alpha=1.0 - rate)
        self.step += 1

    def ema_state_dict(self, k: int) -> Dict[str, torch.Tensor]:
        """The k-th EMA copy under the module's parameter names."""
        return dict(zip(self.names, self.ema_params[k]))

    @torch.no_grad()
    def load_optax_state(self, tree, state_dict_fn: Callable) -> None:
        """AdamW's state from the JAX package's optax state tree (the
        ``opt{step}.msgpack`` of ``adt train``, as flax writes it: each
        tuple and namedtuple a map of its fields, so ``chain(clip?,
        adamw(schedule))`` is ``{"0": {"0": {"count", "mu", "nu"}, "1": {},
        "2": {"count"}}}``, one level deeper behind the clip's ``{}``).
        ScaleByAdamState's ``mu`` and ``nu`` become each parameter's
        ``exp_avg`` and ``exp_avg_sq`` through ``state_dict_fn`` (the flax
        param tree -> state dict mapping the model weights take), its
        ``count`` AdamW's ``step``; the schedule's own ``count``, which the
        anneal reads, must equal it."""
        counts, adam = [], []

        def walk(node):
            if not isinstance(node, dict):
                return
            if {"count", "mu", "nu"} <= set(node):
                adam.append(node)
                return
            if set(node) == {"count"}:
                counts.append(int(node["count"]))
            for v in node.values():
                walk(v)

        walk(tree)
        if len(adam) != 1:
            raise ValueError(f"the optax state holds {len(adam)} "
                             "ScaleByAdamState entries, not one")
        count = int(adam[0]["count"])
        if any(c != count for c in counts):
            raise ValueError(f"the schedule's count {counts} differs from "
                             f"Adam's {count}")
        mu, nu = (state_dict_fn(adam[0][k]) for k in ("mu", "nu"))
        missing = set(self.names) - set(mu) - set(nu)
        if missing:
            raise KeyError(f"the optax state lacks {sorted(missing)[:5]}")
        for name, p in zip(self.names, self.params):
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype)}

    @torch.no_grad()
    def load_ema_state_dict(self, k: int, sd: Dict[str, torch.Tensor]
                            ) -> None:
        missing = set(self.names) - set(sd)
        if missing:
            raise KeyError(f"EMA state dict lacks {sorted(missing)[:5]}")
        for name, e in zip(self.names, self.ema_params[k]):
            e.copy_(sd[name])


def create_train_state(model: nn.Module, *, lr: float = 1e-4,
                       weight_decay: float = 0.0,
                       ema_rates: Sequence[float] = (0.9999,),
                       grad_clip: Optional[float] = None,
                       lr_anneal_steps: int = 0) -> TrainState:
    """AdamW with train_util.py's settings, an optional linear lr anneal
    (train_util.py:288-295) and clipping, and EMA copies seeded from the
    module's parameters."""
    return TrainState(model, lr=lr, weight_decay=weight_decay,
                      ema_rates=ema_rates, grad_clip=grad_clip,
                      lr_anneal_steps=lr_anneal_steps)


def make_train_step(model: nn.Module, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
                    loss_type: str = LossType.MSE,
                    microbatches: int = 1,
                    class_cond: bool = False) -> Callable:
    """The train step of ``model``.

    step(state, tables, batch, t, loss_weights, generator=None,
    noise=None) -> (state, metrics): batch {"x": [B, C, H, W], optional
    "y": [B], optional "low_res": [B, C, h, w]}, where "low_res" trains a
    SuperResModel on (low, high) pairs, called as (x_t, t, low_res[, y])
    (the JAX step's signature), t the int64 [B] respaced steps, loss_weights [B] the
    t-sampler's importance weights, noise [B, C, H, W] or drawn from
    ``generator``. B = microbatches * micro; the microbatches' gradients
    are averaged. metrics: loss (the mean of the microbatches' weighted
    losses), grad_norm (global L2, before clipping), per_example_loss [B]
    and mse, vb where the loss has them. ``step.grads_and_metrics`` is the
    same without the update, for the OFA sandwich."""

    def grads_and_metrics(state: TrainState, tables: ScheduleTables,
                          batch: Dict[str, torch.Tensor], t: torch.Tensor,
                          loss_weights: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None
                          ) -> Tuple[List[torch.Tensor], Dict]:
        x, y, low_res = batch["x"], batch.get("y"), batch.get("low_res")
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(
                f"batch size {b} does not divide into {microbatches} "
                f"microbatches; pick --microbatch so it divides the batch "
                "(the microbatches are equal slices, as the JAX package's; "
                "the reference's ragged tail microbatch is not supported)")
        micro = b // microbatches
        for p in state.params:
            p.grad = None
        losses, terms_all = [], {}
        for m in range(microbatches):
            sl = slice(m * micro, (m + 1) * micro)
            ym = None if y is None else y[sl]
            lm = None if low_res is None else low_res[sl]

            def model_fn(x_t, t_orig):
                a = [x_t, t_orig]
                if lm is not None:
                    a.append(lm)
                if class_cond:
                    a.append(ym)
                return model(*a)

            terms = training_losses(
                tables, model_fn, x[sl], t[sl], generator,
                mean_type=mean_type, var_type=var_type, loss_type=loss_type,
                noise=None if noise is None else noise[sl])
            loss = (terms["loss"] * loss_weights[sl]).mean()
            loss.backward()
            losses.append(loss.detach())
            for k, v in terms.items():
                terms_all.setdefault(k, []).append(v.detach())
        grads = take_grads(state.params, microbatches)
        metrics = {"loss": torch.stack(losses).mean(),
                   "grad_norm": global_norm(grads),
                   "per_example_loss": torch.cat(terms_all["loss"])}
        for k in ("mse", "vb"):
            if k in terms_all:
                metrics[k] = torch.cat(terms_all[k]).mean()
        return grads, metrics

    def step(state: TrainState, tables: ScheduleTables, batch: Dict,
             t: torch.Tensor, loss_weights: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        grads, metrics = grads_and_metrics(state, tables, batch, t,
                                           loss_weights, generator, noise)
        state.apply_gradients(grads)
        return state, metrics

    step.grads_and_metrics = grads_and_metrics
    return step
