"""Search spaces: typed candidates + the EA operators that act on them.

The reference encodes candidates as python-list *strings* passed through
``eval()`` (search_imagenet64_classifier_guidance.py:265-519). Here a
candidate is a hashable tuple pytree and each space is an object exposing
``random() / mutate() / crossover() / seed()`` so the evolutionary driver is
generic over (a) timestep-only search, (b) joint timestep+architecture
search with a compute budget, and (c) continuous-time search for DPM-Solver.

Operator semantics mirror the reference:
  * random: shuffle-prefix of the original steps (:265-274)
  * mutate: each gene replaced w.p. m_prob by an unused step, drawing
    without replacement (:434-476)
  * crossover: uniform gene mix of two parents (:400-432)
  * ddim seed: the exact uniform ddim-K schedule (:525-541)
Candidates are canonicalized to sorted tuples — fitness is order-invariant
(respacing sorts), so this dedupes the memo where the reference re-evaluates
permutations.
"""

from __future__ import annotations

import ast
import random as pyrandom
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..schedules import space_timesteps

__all__ = ["TimestepSpace", "JointSpace", "ContinuousTimeSpace",
           "parse_timestep_string", "parse_joint_string"]


def parse_timestep_string(s: str) -> Tuple[int, ...]:
    """Parse reference-format ``--use_timestep '[94, 834, ...]'`` strings
    (safely; the reference uses eval, classifier_sample.py:140-145)."""
    v = ast.literal_eval(s)
    return tuple(sorted(int(t) for t in v))


def parse_joint_string(s: str) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """Parse a reference-format joint candidate: either a dict string
    ``{'timesteps': [...], 'skip_layers': [[...], ...]}`` or separate lists.
    skip_layers[i] pairs with the i-th *sorted* timestep (the reference
    indexes skips via sorted timestep_map,
    search_dynamic_unet...progressive.py:392-397)."""
    v = ast.literal_eval(s)
    ts = [int(t) for t in v["timesteps"]]
    order = np.argsort(ts)
    skips = [tuple(sorted(int(l) for l in v["skip_layers"][i])) for i in order]
    return tuple(sorted(ts)), tuple(skips)


@dataclass
class TimestepSpace:
    """K-subset-of-[0,T) candidates (tuple of sorted ints)."""

    num_train_steps: int
    num_steps: int
    # optional +/-R window restriction around given steps
    # (search_imagenet64_classifier_guidance.py:657-679)
    search_space: Optional[Sequence[int]] = None
    rng: pyrandom.Random = field(default_factory=lambda: pyrandom.Random(0))

    def _pool(self) -> List[int]:
        if self.search_space is not None:
            return list(self.search_space)
        return list(range(self.num_train_steps))

    def random(self) -> Tuple[int, ...]:
        pool = self._pool()
        self.rng.shuffle(pool)
        return tuple(sorted(pool[: self.num_steps]))

    def seed(self, use_ddim: bool = True) -> Tuple[int, ...]:
        spec = ("ddim" if use_ddim else "") + str(self.num_steps)
        return tuple(sorted(space_timesteps(self.num_train_steps, spec)))

    def mutate(self, cand: Tuple[int, ...], m_prob: float) -> Tuple[int, ...]:
        cand = list(cand)
        unused = [i for i in self._pool() if i not in cand]
        self.rng.shuffle(unused)
        for i in range(len(cand)):
            if not unused:
                break
            if self.rng.random() < m_prob:
                cand[i] = unused.pop()
        return tuple(sorted(cand))

    def crossover(self, c1: Tuple[int, ...], c2: Tuple[int, ...]) -> Tuple[int, ...]:
        child = list({a if self.rng.random() < 0.5 else b
                      for a, b in zip(c1, c2)})
        # uniform mixing can collide genes; repair to K distinct steps (the
        # reference leaves duplicates in, silently shrinking K at respacing)
        pool = [g for g in (set(c1) | set(c2)) - set(child)]
        self.rng.shuffle(pool)
        while len(child) < self.num_steps and pool:
            child.append(pool.pop())
        unused = [i for i in self._pool() if i not in child]
        self.rng.shuffle(unused)
        while len(child) < self.num_steps:
            child.append(unused.pop())
        return tuple(sorted(child))

    @staticmethod
    def restricted_window(centers: Sequence[int], num_train_steps: int,
                          radius: Optional[int] = None) -> List[int]:
        """+/-R windows around given steps, R defaulting to T//100
        (search_imagenet64_classifier_guidance.py:657-679)."""
        r = radius if radius is not None else max(1, num_train_steps // 100)
        out = set()
        for c in centers:
            for t in range(max(0, c - r), min(num_train_steps, c + r + 1)):
                out.add(t)
        return sorted(out)


@dataclass
class JointSpace:
    """Joint (timesteps, per-step skip-layer sets) candidates under a compute
    budget: sum over steps of kept layers <= max_index_number
    (search_dynamic_unet...progressive.py:165-167,284-338).

    Candidate = (timesteps tuple sorted, skip_layers tuple-of-tuples aligned
    with sorted timesteps). ``skip_layer_range`` = (lo, hi) fractions of
    layer_num; the progressive schedule widens hi over epochs via
    ``set_skip_range``.
    """

    num_train_steps: int
    layer_num: int
    max_index_number: int
    skip_layer_range: Tuple[float, float] = (0.0, 0.0)
    max_timesteps: Optional[int] = None
    rng: pyrandom.Random = field(default_factory=lambda: pyrandom.Random(0))

    def set_skip_range(self, lo: float, hi: float) -> None:
        self.skip_layer_range = (lo, hi)

    def _random_skip(self) -> Tuple[int, ...]:
        lo, hi = self.skip_layer_range
        n = int((self.rng.random() * (hi - lo) + lo) * self.layer_num)
        layers = list(range(self.layer_num))
        self.rng.shuffle(layers)
        return tuple(sorted(layers[:n]))

    def budget_used(self, skips: Sequence[Sequence[int]]) -> int:
        return sum(self.layer_num - len(s) for s in skips)

    def is_feasible(self, cand) -> bool:
        ts, skips = cand
        return (len(ts) == len(set(ts))
                and self.budget_used(skips) <= self.max_index_number
                and all(0 <= t < self.num_train_steps for t in ts))

    def random(self):
        """Pack steps until the budget is exhausted (reference
        sample_active_subnet, :284-338)."""
        lo, hi = self.skip_layer_range
        min_cost = self.layer_num - int(self.layer_num * hi)
        if self.max_index_number < min_cost:
            raise ValueError(
                f"infeasible budget: max_index_number={self.max_index_number} "
                f"cannot fit one step of >= {min_cost} kept layers")
        pool = list(range(self.num_train_steps))
        self.rng.shuffle(pool)

        ts: List[int] = []
        skips: List[Tuple[int, ...]] = []
        used = 0
        while True:
            if self.max_index_number - used == min_cost:
                # only the maximal skip fits. _random_skip's int truncation
                # keeps its draw STRICTLY below hi*layer_num (n <= ceil-1),
                # so when hi*layer_num is an integer the rejection loop
                # below could never emit cost == min_cost and would spin
                # forever (reachable on the first iteration when the budget
                # equals min_cost). Construct the maximal skip directly,
                # exactly like the exact-fit branch at the bottom.
                n = int(self.layer_num * hi)
                layers = list(range(self.layer_num))
                self.rng.shuffle(layers)
                skip = tuple(sorted(layers[:n]))
            else:
                # rejection-sample a skip count that fits the remaining budget
                while True:
                    skip = self._random_skip()
                    if used + self.layer_num - len(skip) <= self.max_index_number:
                        break
            ts.append(pool[len(ts)])
            skips.append(skip)
            used += self.layer_num - len(skip)
            if len(ts) >= len(pool):
                break   # every train step used (reachable when hi >= 1 -
                        # 1/layer_num makes min_cost 0, so the budget
                        # checks below never trigger)
            if self.max_timesteps and len(ts) >= self.max_timesteps:
                break
            if used + min_cost > self.max_index_number:
                break
            if used + min_cost == self.max_index_number:
                n = int(self.layer_num * hi)
                layers = list(range(self.layer_num))
                self.rng.shuffle(layers)
                ts.append(pool[len(ts)])
                skips.append(tuple(sorted(layers[:n])))
                break
        order = np.argsort(ts)
        return tuple(sorted(ts)), tuple(skips[i] for i in order)

    def seed(self, use_ddim: bool = True):
        """ddim-K timesteps with no skipping, K = budget // layer_num."""
        k = max(1, self.max_index_number // self.layer_num)
        spec = ("ddim" if use_ddim else "") + str(k)
        ts = tuple(sorted(space_timesteps(self.num_train_steps, spec)))
        return ts, tuple(() for _ in ts)

    def mutate(self, cand, m_prob: float):
        """Mutate both genes (timesteps and per-step skips), then repair to
        the budget by dropping trailing steps (:517-585)."""
        ts, skips = list(cand[0]), [list(s) for s in cand[1]]
        unused = [i for i in range(self.num_train_steps) if i not in ts]
        self.rng.shuffle(unused)
        for i in range(len(ts)):
            if unused and self.rng.random() < m_prob:
                ts[i] = unused.pop()
        for i in range(len(skips)):
            if self.rng.random() < m_prob:
                skips[i] = list(self._random_skip())
        while self.budget_used(skips) > self.max_index_number and len(ts) > 1:
            ts.pop()
            skips.pop()
        order = np.argsort(ts)
        return (tuple(sorted(ts)),
                tuple(tuple(sorted(skips[i])) for i in order))

    def crossover(self, c1, c2):
        """Uniform gene mix over the common prefix; tail from the longer
        parent, then budget repair (:469-515)."""
        ts1, sk1 = c1
        ts2, sk2 = c2
        if len(ts1) < len(ts2):
            (ts1, sk1), (ts2, sk2) = (ts2, sk2), (ts1, sk1)
        ts, skips = [], []
        for i in range(len(ts1)):
            if i < len(ts2) and self.rng.random() < 0.5:
                ts.append(ts2[i]); skips.append(list(sk2[i]))
            else:
                ts.append(ts1[i]); skips.append(list(sk1[i]))
        # dedupe timesteps, keeping first occurrence
        seen, dts, dsk = set(), [], []
        for t, s in zip(ts, skips):
            if t not in seen:
                seen.add(t); dts.append(t); dsk.append(s)
        while self.budget_used(dsk) > self.max_index_number and len(dts) > 1:
            dts.pop(); dsk.pop()
        order = np.argsort(dts)
        return (tuple(sorted(dts)),
                tuple(tuple(sorted(dsk[i])) for i in order))


@dataclass
class ContinuousTimeSpace:
    """K+1 continuous times in (0, 1] for DPM-Solver, drawn from a dense
    grid (sd/scripts/search_ea.py:371-502,888-902). Candidate = sorted tuple
    of floats (descending order is applied at sampling time)."""

    grid: Tuple[float, ...]          # dense grid, e.g. 1000 points
    num_steps: int                   # number of knots (K+1 for order K)
    rng: pyrandom.Random = field(default_factory=lambda: pyrandom.Random(0))

    @classmethod
    def uniform_grid(cls, num_steps: int, t_0: float = 1e-3, t_T: float = 1.0,
                     grid_size: int = 1000, **kw) -> "ContinuousTimeSpace":
        grid = tuple(np.linspace(t_T, t_0, grid_size).tolist())
        return cls(grid=grid, num_steps=num_steps, **kw)

    def random(self) -> Tuple[float, ...]:
        idx = self.rng.sample(range(len(self.grid)), self.num_steps)
        return tuple(sorted(self.grid[i] for i in idx))

    def seed(self, use_ddim: bool = True) -> Tuple[float, ...]:
        idx = np.linspace(0, len(self.grid) - 1, self.num_steps).round().astype(int)
        return tuple(sorted(self.grid[i] for i in idx))

    def mutate(self, cand, m_prob: float):
        cand = list(cand)
        unused = [g for g in self.grid if g not in cand]
        self.rng.shuffle(unused)
        for i in range(len(cand)):
            if unused and self.rng.random() < m_prob:
                cand[i] = unused.pop()
        return tuple(sorted(cand))

    def crossover(self, c1, c2):
        child = [a if self.rng.random() < 0.5 else b for a, b in zip(c1, c2)]
        # a positional mix of two sorted parents duplicates any knot the
        # parents share; a duplicate knot makes h = lambda_t - lambda_s
        # exactly 0 in the DPM-Solver update (0/0 NaN at order 3, a
        # wasted NFE at order 2) — repair with unused grid knots, like
        # the discrete TimestepSpace does
        if len(set(child)) < len(child):
            unused = [g for g in self.grid if g not in child]
            self.rng.shuffle(unused)
            seen = set()
            for i, g in enumerate(child):
                if g in seen:
                    child[i] = unused.pop()
                seen.add(child[i])
        return tuple(sorted(child))
