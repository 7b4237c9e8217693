"""Host-side training loops: standard and OFA supernet variants.

Port of autodiffusion_tpu/train/loop.py (guided_diffusion/
train_util.py:67-712). The device work (loss, gradients, optimizer, EMA)
is the step from train.state; this layer owns data iteration, timestep
sampling, logging (loss quartiles, train_util.py:816-858), checkpoints,
and the OFA respacing curricula:

  * TrainLoop          standard training on the full schedule
  * ofa_tables_fn      OFA_TrainLoop's random 4-section respacing per step
                       (train_util.py:410-530)
  * ofa_random_select  largest / 2x random / smallest-subset sandwich per
                       step (OFA_TrainLoop_random_select,
                       train_util.py:532-712)

The random streams are the JAX loop's: ``np.random.RandomState(seed)`` for
t, ``random.Random(seed)`` for the OFA draws and, one ``getrandbits(32)``
a step, the seed of the step's noise generator. Batches come in as numpy
[B, H, W, C] (the data loaders' layout) and go to the device as NCHW.
"""

from __future__ import annotations

import os
import random as pyrandom
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..schedules import ScheduleTables, build_base_tables, build_tables
from ..utils import logger
from ..utils.checkpoint import (find_latest_checkpoint, flax_state_dict,
                                load_checkpoint, load_msgpack,
                                parse_step_from_filename, save_checkpoint,
                                state_dict_from_flax_tree)
from .resample import UniformSampler
from .state import TrainState

__all__ = ["TrainLoop", "resume_train_state", "ofa_tables_fn",
           "ofa_random_select_tables_fn", "batch_to_device"]


def resume_train_state(state: TrainState, path_or_dir: str) -> TrainState:
    """Resume model, EMA, optimizer and step from checkpoint files.

    ``path_or_dir`` is a model checkpoint file or a directory holding
    ``model{step}`` / ``ema_{rate}_{step}`` / ``opt{step}`` files, either
    the port's ``.pt`` (the naming TrainLoop.save writes) or the JAX
    package's ``.msgpack``. The step is parsed from the file name. From
    ``.pt`` files all three resume; from ``.msgpack`` the model and EMA
    (through the converters), while the optimizer stays fresh: optax's
    moments are not mapped. Missing EMA / optimizer files fall back to the
    model's parameters / a fresh optimizer with a logged warning, the
    reference's resume (train_util.py:124-165,780-792)."""
    if os.path.isdir(path_or_dir):
        found = find_latest_checkpoint(path_or_dir)
        if found is None:
            raise FileNotFoundError(
                f"no model*.pt or model*.msgpack checkpoint in {path_or_dir}")
        model_path, step = found
    else:
        model_path = path_or_dir
        step = parse_step_from_filename(os.path.basename(model_path))
    ext = ".msgpack" if model_path.endswith(".msgpack") else ".pt"
    ckpt_dir = os.path.dirname(os.path.abspath(model_path))
    model = state.model

    def read(path):
        return flax_state_dict(path, model) if ext == ".msgpack" \
            else load_checkpoint(path)

    logger.log(f"resuming model from {model_path} at step {step}")
    model.load_state_dict(read(model_path), strict=True)

    opt_path = os.path.join(ckpt_dir, f"opt{step:06d}{ext}")
    if not os.path.exists(opt_path):
        logger.log(f"warning: {opt_path} not found, keeping fresh optimizer")
    elif ext == ".msgpack":
        state.load_optax_state(
            load_msgpack(opt_path),
            lambda tree: state_dict_from_flax_tree(tree, model))
    else:
        state.optimizer.load_state_dict(load_checkpoint(opt_path))

    for k, rate in enumerate(state.ema_rates):
        ema_path = os.path.join(ckpt_dir, f"ema_{rate}_{step:06d}{ext}")
        if os.path.exists(ema_path):
            state.load_ema_state_dict(k, read(ema_path))
        else:
            logger.log(f"warning: {ema_path} not found, seeding EMA from "
                       "model params")
            state.load_ema_state_dict(k, dict(model.named_parameters()))
    state.step = step
    return state


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """A loader's numpy batch ({"x": [B, H, W, C] float32, "y": [B],
    optional "low_res": [B, h, w, C] float32}) as tensors on ``device``:
    x and low_res NCHW, y int64."""
    out = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
        device).permute(0, 3, 1, 2).contiguous()
        for k in ("x", "low_res") if k in batch}
    if "y" in batch:
        out["y"] = torch.from_numpy(np.asarray(batch["y"])).long().to(device)
    return out


class TrainLoop:
    """run_loop() drives step(state, tables, batch, t, w, generator).

    tables_fn(step, rng) -> ScheduleTables lets the OFA variants respace
    per step; the default is the full base schedule. A tables_fn that
    returns a LIST of schedules selects the sandwich step, which needs
    ``grad_fn`` (make_train_step(...).grads_and_metrics)."""

    def __init__(self, *, state: TrainState, step_fn: Callable,
                 data: Iterator[Dict[str, np.ndarray]],
                 grad_fn: Optional[Callable] = None,
                 schedule_sampler=None,
                 tables: Optional[ScheduleTables] = None,
                 tables_fn: Optional[Callable] = None,
                 batch_size: int, lr_anneal_steps: int = 0,
                 log_interval: int = 10, save_interval: int = 10000,
                 save_dir: Optional[str] = None,
                 ema_rates: Optional[Sequence[float]] = None,
                 val_fn: Optional[Callable] = None, val_interval: int = 0,
                 seed: int = 0):
        self.state = state
        self.step_fn = step_fn
        self.grad_fn = grad_fn
        self.data = data
        self.device = state.params[0].device
        self.tables = tables if tables is not None else build_base_tables()
        self._tables_dev = self.tables.to(self.device)
        self.tables_fn = tables_fn
        self.schedule_sampler = schedule_sampler or UniformSampler(
            self.tables.num_steps)
        self.batch_size = batch_size
        self.lr_anneal_steps = lr_anneal_steps
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.save_dir = save_dir
        # default to the state's own rates so save() file names always
        # match the copies they hold
        self.ema_rates = tuple(ema_rates) if ema_rates is not None \
            else tuple(state.ema_rates)
        self.val_fn = val_fn
        self.val_interval = val_interval
        self.np_rng = np.random.RandomState(seed)
        self.py_rng = pyrandom.Random(seed)
        self.step = int(self.state.step)

    def run_loop(self, max_steps: Optional[int] = None) -> TrainState:
        while (not self.lr_anneal_steps or self.step < self.lr_anneal_steps):
            if max_steps is not None and self.step >= max_steps:
                break
            self.run_step(next(self.data))
            if self.log_interval and self.step % self.log_interval == 0:
                logger.dumpkvs()
            if self.save_interval and self.step and \
                    self.step % self.save_interval == 0:
                self.save()
            if (self.val_fn is not None and self.val_interval
                    and self.step % self.val_interval == 0):
                for k, v in self.val_fn(self.state).items():
                    logger.logkv(f"val_{k}", v)
                logger.dumpkvs()
        if self.save_interval and self.step % self.save_interval != 0:
            self.save()
        return self.state

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.py_rng.getrandbits(32))

    def _sample_t(self, sampler, num_steps: int):
        if num_steps != sampler.num_steps:
            sampler = UniformSampler(num_steps)
        t, w = sampler.sample(self.batch_size, self.np_rng)
        return (sampler, t, torch.from_numpy(t).long().to(self.device),
                torch.from_numpy(w).to(self.device))

    def run_step(self, batch: Dict[str, np.ndarray]) -> None:
        t0 = time.time()
        tables = self.tables
        if self.tables_fn is not None:
            tables = self.tables_fn(self.step, self.py_rng)
        if isinstance(tables, (list, tuple)):
            return self._run_sandwich_step(list(tables), batch, t0)
        tables_dev = self._tables_dev if tables is self.tables \
            else tables.to(self.device)
        # under OFA respacing t lives in the respaced [0, K) space, so the
        # sampler used is a uniform one over K
        sampler, t, t_dev, w = self._sample_t(self.schedule_sampler,
                                              tables.num_steps)
        self.state, metrics = self.step_fn(
            self.state, tables_dev, batch_to_device(batch, self.device),
            t_dev, w, self._generator())
        self.step = int(self.state.step)
        per_ex = metrics.pop("per_example_loss").float().cpu().numpy()
        sampler.update_with_local_losses(t, per_ex)
        logger.logkv("step", self.step)
        logger.logkv("samples", self.step * self.batch_size)
        logger.logkv_mean("step_time", time.time() - t0)
        for k, v in metrics.items():
            logger.logkv_mean(k, float(v))
        # loss quartiles by diffusion time (log_loss_dict,
        # train_util.py:816-858)
        quart = t * 4 // tables.num_steps
        for q in range(4):
            if (quart == q).any():
                logger.logkv_mean(f"loss_q{q}",
                                  float(per_ex[quart == q].mean()))

    def _run_sandwich_step(self, tlist, batch: Dict[str, np.ndarray],
                           t0: float) -> None:
        """ONE optimizer update from gradients accumulated over several
        respacings (the OFA random-select sandwich,
        train_util.py:668-712), averaged over the schedules as the JAX
        loop averages them (the reference sums)."""
        if self.grad_fn is None:
            raise ValueError(
                "tables_fn returned a list of schedules (sandwich mode) but "
                "TrainLoop was built without grad_fn; pass "
                "grad_fn=make_train_step(...).grads_and_metrics")
        dev_batch = batch_to_device(batch, self.device)
        total = None
        for tb in tlist:
            sampler, t, t_dev, w = self._sample_t(self.schedule_sampler,
                                                  tb.num_steps)
            grads, metrics = self.grad_fn(self.state, tb.to(self.device),
                                          dev_batch, t_dev, w,
                                          self._generator())
            if total is None:
                total = grads
            else:
                torch._foreach_add_(total, grads)
            sampler.update_with_local_losses(
                t, metrics.pop("per_example_loss").float().cpu().numpy())
            # the reference's per-schedule log line (diffusion_len_<name>)
            logger.logkv_mean(f"loss_len{tb.num_steps}",
                              float(metrics["loss"]))
        torch._foreach_div_(total, len(tlist))
        self.state.apply_gradients(total)
        self.step = int(self.state.step)
        logger.logkv("step", self.step)
        logger.logkv("samples", self.step * self.batch_size * len(tlist))
        logger.logkv_mean("step_time", time.time() - t0)

    def save(self) -> None:
        if not self.save_dir:
            return
        logger.log(f"saving model at step {self.step}...")
        save_checkpoint(f"{self.save_dir}/model{self.step:06d}.pt",
                        self.state.model.state_dict())
        for k, rate in enumerate(self.ema_rates):
            save_checkpoint(f"{self.save_dir}/ema_{rate}_{self.step:06d}.pt",
                            self.state.ema_state_dict(k))
        save_checkpoint(f"{self.save_dir}/opt{self.step:06d}.pt",
                        self.state.optimizer.state_dict())


def _ofa_section_counts(rng: pyrandom.Random, menu: Sequence[int],
                        sections: int) -> list:
    """Per-section step counts with the reference's coupling: the middle
    sections get at least as many steps as their outer neighbours
    (forward_backward redraws until p2 >= p1 and p3 >= p4,
    train_util.py:470-477)."""
    menu = list(menu)
    counts = [rng.choice(menu) for _ in range(sections)]
    if sections == 4:
        while counts[1] < counts[0]:
            counts[1] = rng.choice(menu)
        while counts[2] < counts[3]:
            counts[2] = rng.choice(menu)
    return counts


def ofa_tables_fn(base_schedule: str = "cosine", base_num_steps: int = 1000,
                  sections: int = 4,
                  steps_per_section: Sequence[int] = (2, 4, 6, 8)):
    """A random k-per-section respacing each step (OFA_TrainLoop,
    train_util.py:410-530), k from the small fixed menu
    ``steps_per_section``."""

    def fn(step: int, rng: pyrandom.Random) -> ScheduleTables:
        counts = _ofa_section_counts(rng, steps_per_section, sections)
        return build_tables(",".join(map(str, counts)),
                            base_schedule=base_schedule,
                            base_num_steps=base_num_steps)

    return fn


def ofa_random_select_tables_fn(base_schedule: str = "cosine",
                                base_num_steps: int = 1000,
                                k_menu: Sequence[int] = (25, 50, 100, 250)):
    """The sandwich rule: the largest, two random and the smallest subsets
    trained as ONE accumulated optimizer update per step
    (OFA_TrainLoop_random_select.forward_backward, train_util.py:639-712).
    Returns a LIST of four ScheduleTables per call.

    As in the JAX package: the random subsets' K comes from ``k_menu``
    with one step drawn per section (the reference draws K uniformly in
    [1, 400]), and the smallest subset is three random steps plus T - 1,
    drawn without replacement so that its K is 4."""

    def fn(step: int, rng: pyrandom.Random):
        out = [build_base_tables(base_schedule, base_num_steps)]   # largest
        for _ in range(2):                                          # random
            k = rng.choice(list(k_menu))
            skip = base_num_steps // k
            steps = [rng.randrange(i * skip, (i + 1) * skip)
                     for i in range(k)]
            out.append(build_tables(steps, base_schedule=base_schedule,
                                    base_num_steps=base_num_steps))
        smallest = sorted(rng.sample(range(1, base_num_steps - 1), 3)
                          + [base_num_steps - 1])
        out.append(build_tables(smallest, base_schedule=base_schedule,
                                base_num_steps=base_num_steps))
        return out

    return fn
