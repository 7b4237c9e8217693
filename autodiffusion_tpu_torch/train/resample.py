"""Timestep samplers for training (importance sampling over t).

Port of autodiffusion_tpu/train/resample.py (guided_diffusion/
resample.py:8-154): UniformSampler and LossSecondMomentResampler, numpy
only, the same draws from the same ``np.random.RandomState``. Data
parallel, a sampler's history takes the losses of every rank
(resample.py:71-104's all-gather), so every rank keeps the same history
and draws the same t.
"""

from __future__ import annotations

import numpy as np

from ..parallel.dist import all_gather_host

__all__ = ["UniformSampler", "LossSecondMomentResampler",
           "create_named_schedule_sampler"]


class UniformSampler:
    def __init__(self, num_steps: int):
        self.num_steps = num_steps

    def weights(self) -> np.ndarray:
        return np.ones(self.num_steps, dtype=np.float64)

    def sample(self, batch: int, rng: np.random.RandomState):
        """(t int32 [batch], importance weights float32 [batch])."""
        w = self.weights()
        p = w / w.sum()
        t = rng.choice(self.num_steps, size=(batch,), p=p)
        weights = 1.0 / (self.num_steps * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update_with_losses(self, ts: np.ndarray, losses: np.ndarray) -> None:
        pass

    def update_with_local_losses(self, ts: np.ndarray,
                                 losses: np.ndarray) -> None:
        """The uniform sampler keeps no history."""


class LossSecondMomentResampler(UniformSampler):
    """p_t proportional to sqrt(E[loss_t^2]), with a uniform warm-up and
    mixing (resample.py:124-154)."""

    def __init__(self, num_steps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        super().__init__(num_steps)
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_steps, history_per_term),
                                      np.float64)
        self._loss_counts = np.zeros(num_steps, np.int64)

    def update_with_local_losses(self, ts: np.ndarray,
                                 losses: np.ndarray) -> None:
        """Update the history with the per-example losses of every
        process, each passing its own rows (resample.py:71-104); one
        process's are its own. Data shards are equal in size, so the
        reference's gather of the batch sizes is not needed."""
        self.update_with_losses(
            np.asarray(all_gather_host(np.asarray(ts))).reshape(-1),
            np.asarray(all_gather_host(np.asarray(losses))).reshape(-1))

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_steps, dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


def create_named_schedule_sampler(name: str, num_steps: int):
    if name == "uniform":
        return UniformSampler(num_steps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_steps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
