"""Evolutionary schedule/architecture search driver (host logic).

Re-design of EvolutionSearcher (search_imagenet64_classifier_guidance.py:
155-199,521-584 and the progressive joint variant): population + memoized
fitness + mutation/crossover/random-refill per epoch, with two structural
changes:

  * fitness is evaluated in *batches*: each generation's unvisited
    candidates are collected first, then dispatched together to a fitness
    function that folds them into one batch (the reference
    evaluates serially inside is_legal, :276-298);
  * EA state (population, memo, rng) is checkpointed to JSON per epoch and
    resumable — the reference loses all state on a crash (SURVEY.md section 5).

The progressive joint-search schedule (widen the skip-layer range when the
best candidate stalls, search_dynamic_unet...progressive.py:688-699) is an
``on_epoch_start`` hook: see :func:`progressive_skip_hook`.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import logger

__all__ = ["EvolutionSearcher", "progressive_skip_hook"]

Candidate = Any          # hashable tuple pytree
BatchFitnessFn = Callable[[List[Candidate]], List[float]]


class EvolutionSearcher:
    def __init__(self, space, fitness_fn: BatchFitnessFn, *,
                 population_num: int = 50, select_num: int = 10,
                 mutation_num: int = 25, crossover_num: int = 15,
                 m_prob: float = 0.25, max_epochs: int = 10,
                 use_ddim_init_x: bool = True, use_ddim: bool = True,
                 init_m_prob: float = 0.1,
                 checkpoint_path: Optional[str] = None,
                 on_epoch_start: Optional[Callable] = None):
        self.space = space
        self.fitness_fn = fitness_fn
        self.population_num = population_num
        self.select_num = select_num
        self.mutation_num = mutation_num
        self.crossover_num = crossover_num
        self.m_prob = m_prob
        self.max_epochs = max_epochs
        self.use_ddim_init_x = use_ddim_init_x
        self.use_ddim = use_ddim
        self.init_m_prob = init_m_prob
        self.checkpoint_path = checkpoint_path
        self.on_epoch_start = on_epoch_start

        self.epoch = 0
        self.vis_dict: Dict[Candidate, float] = {}
        self.candidates: List[Candidate] = []
        self.top_k: List[Candidate] = []       # select_num best
        self.top_50: List[Candidate] = []      # population_num best (log table)
        self.best_history: List[float] = []    # best fid per epoch (stall hook)

    # ---------------- fitness plumbing ----------------

    def _evaluate(self, cands: Sequence[Candidate]) -> None:
        """Batch-evaluate any not-yet-visited candidates."""
        fresh = [c for c in cands if c not in self.vis_dict]
        if not fresh:
            return
        fids = self.fitness_fn(fresh)
        assert len(fids) == len(fresh)
        for c, f in zip(fresh, fids):
            self.vis_dict[c] = float(f)
            logger.log(f"cand: {list_repr(c)}, fid: {float(f)}")

    def _gather_unvisited(self, gen_fn: Callable[[], Candidate], want: int,
                          taken: set) -> List[Candidate]:
        out: List[Candidate] = []
        max_iters = want * 10
        while len(out) < want and max_iters > 0:
            max_iters -= 1
            c = gen_fn()
            if c in self.vis_dict or c in taken:
                continue
            taken.add(c)
            out.append(c)
        return out

    # ---------------- generation operators ----------------

    def _random_cands(self, num: int, taken: set) -> List[Candidate]:
        logger.log("random select ........")
        return self._gather_unvisited(self.space.random, num, taken)

    def _rng(self):
        # reuse the space's seeded rng so runs are reproducible end to end
        import random as pyrandom
        return getattr(self.space, "rng", pyrandom)

    def _mutations(self, num: int, m_prob: float, taken: set) -> List[Candidate]:
        logger.log("mutation ......")
        parents = self.top_k
        rng = self._rng()

        def gen():
            return self.space.mutate(rng.choice(parents), m_prob)

        return self._gather_unvisited(gen, num, taken)

    def _crossovers(self, num: int, taken: set) -> List[Candidate]:
        logger.log("cross ......")
        parents = self.top_k
        rng = self._rng()

        def gen():
            return self.space.crossover(rng.choice(parents), rng.choice(parents))

        return self._gather_unvisited(gen, num, taken)

    # ---------------- main loop ----------------

    def _init_population(self) -> None:
        # NB: with use_ddim_init_x the initial population is
        # population_num + 1 candidates (1 seed + N//2+1 random +
        # N-N//2-1 mutations). That off-by-one is the REFERENCE's exact
        # arithmetic (search_imagenet64_classifier_guidance.py:535-541)
        # and is kept for search-trajectory parity.
        taken: set = set()
        if self.use_ddim_init_x:
            seed = self.space.seed(self.use_ddim)
            taken.add(seed)
            cands = [seed]
            cands += self._random_cands(self.population_num // 2 + 1, taken)
            n_mut = self.population_num - self.population_num // 2 - 1

            def gen():
                return self.space.mutate(seed, self.init_m_prob)

            cands += self._gather_unvisited(gen, n_mut, taken)
        else:
            cands = self._random_cands(self.population_num, taken)
        self._evaluate(cands)
        self.candidates = cands

    def _update_top_k(self) -> None:
        logger.log("select ......")
        pool = list(dict.fromkeys(self.top_k + self.candidates))
        pool.sort(key=lambda c: self.vis_dict[c])
        self.top_k = pool[: self.select_num]
        pool50 = list(dict.fromkeys(self.top_50 + self.candidates))
        pool50.sort(key=lambda c: self.vis_dict[c])
        self.top_50 = pool50[: self.population_num]

    def search(self) -> Tuple[Candidate, float]:
        logger.log(
            f"population_num = {self.population_num} select_num = {self.select_num} "
            f"mutation_num = {self.mutation_num} crossover_num = {self.crossover_num} "
            f"random_num = {self.population_num - self.mutation_num - self.crossover_num} "
            f"max_epochs = {self.max_epochs}")
        if not self.candidates and self.epoch == 0:
            self._init_population()
            self._save()

        while self.epoch < self.max_epochs:
            logger.log(f"epoch = {self.epoch}")
            if self.on_epoch_start is not None:
                self.on_epoch_start(self)

            self._update_top_k()
            logger.log(f"epoch = {self.epoch} : top {len(self.top_50)} result")
            for i, cand in enumerate(self.top_50):
                logger.log(f"No.{i + 1} {list_repr(cand)} fid = {self.vis_dict[cand]}")
            self.best_history.append(self.vis_dict[self.top_50[0]])

            taken: set = set()
            mutation = self._mutations(self.mutation_num, self.m_prob, taken)
            cross = self._crossovers(self.crossover_num, taken)
            fill = self._random_cands(
                self.population_num - len(mutation) - len(cross), taken)
            self.candidates = mutation + cross + fill
            self._evaluate(self.candidates)

            self.epoch += 1
            self._save()

        self._update_top_k()
        best = self.top_k[0]
        logger.log(f"best cand: {list_repr(best)} fid = {self.vis_dict[best]}")
        return best, self.vis_dict[best]

    # ---------------- checkpoint / resume ----------------

    def _save(self) -> None:
        if not self.checkpoint_path:
            return
        state = {
            "epoch": self.epoch,
            "vis_dict": {repr(k): v for k, v in self.vis_dict.items()},
            "candidates": [repr(c) for c in self.candidates],
            "top_k": [repr(c) for c in self.top_k],
            "top_50": [repr(c) for c in self.top_50],
            "best_history": self.best_history,
        }
        # the space's RNG stream and any mutable space state must resume
        # too, or a seeded resumed run diverges from an uninterrupted one
        # (and the progressive joint search would reset its widened
        # skip_layer_range back to (0, 0))
        if hasattr(self.space, "rng"):
            state["space_rng"] = repr(self.space.rng.getstate())
        if hasattr(self.space, "skip_layer_range"):
            state["skip_layer_range"] = list(self.space.skip_layer_range)
        # the fitness noise stream must resume too (BatchedFIDFitness
        # folds an eval counter into each chunk's RNG): without it a
        # resumed run scores FRESH candidates with replayed noise from
        # count 0 instead of continuing the uninterrupted run's stream
        if hasattr(self.fitness_fn, "get_state"):
            state["fitness_state"] = self.fitness_fn.get_state()
        tmp = self.checkpoint_path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.checkpoint_path)),
                    exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.checkpoint_path)

    def load(self, path: Optional[str] = None) -> None:
        path = path or self.checkpoint_path
        with open(path) as f:
            state = json.load(f)
        self.epoch = state["epoch"]
        self.vis_dict = {ast.literal_eval(k): v
                         for k, v in state["vis_dict"].items()}
        self.candidates = [ast.literal_eval(c) for c in state["candidates"]]
        self.top_k = [ast.literal_eval(c) for c in state["top_k"]]
        self.top_50 = [ast.literal_eval(c) for c in state["top_50"]]
        self.best_history = state.get("best_history", [])
        if "space_rng" in state and hasattr(self.space, "rng"):
            self.space.rng.setstate(ast.literal_eval(state["space_rng"]))
        if "skip_layer_range" in state and hasattr(self.space,
                                                   "skip_layer_range"):
            self.space.skip_layer_range = tuple(state["skip_layer_range"])
        if "fitness_state" in state and hasattr(self.fitness_fn, "set_state"):
            self.fitness_fn.set_state(state["fitness_state"])
        logger.log(f"resumed search at epoch {self.epoch} "
                   f"({len(self.vis_dict)} evaluated candidates)")


def list_repr(cand: Candidate) -> str:
    """Reference-compatible log format: timestep candidates print as a plain
    list, joint candidates as the reference's dict form."""
    if isinstance(cand, tuple) and cand and isinstance(cand[0], tuple):
        ts, skips = cand
        return repr({"timesteps": list(ts), "skip_layers": [list(s) for s in skips]})
    return repr(list(cand))


def progressive_skip_hook(max_prun: float, min_prun: float = 0.0,
                          start_epoch: int = 4, stall_epochs: int = 2,
                          widen_steps: int = 5):
    """Progressive widening of the skip-layer range
    (search_dynamic_unet...progressive.py:688-699): keep hi=0 (pure timestep
    search) until the best fid stalls for ``stall_epochs`` or
    epoch > ``start_epoch``; then widen hi by max_prun/widen_steps per epoch
    up to max_prun; lo set to min_prun after epoch start_epoch+1."""

    def hook(searcher: EvolutionSearcher) -> None:
        space = searcher.space
        hist = searcher.best_history
        stalled = (len(hist) > stall_epochs
                   and len(set(hist[-stall_epochs:])) == 1)
        cur_lo, cur_hi = space.skip_layer_range
        if searcher.epoch > start_epoch or stalled:
            new_hi = min(max_prun, cur_hi + max_prun / widen_steps)
            new_lo = min_prun if searcher.epoch > start_epoch + 1 else cur_lo
            if (new_lo, new_hi) != (cur_lo, cur_hi):
                space.set_skip_range(new_lo, new_hi)
                logger.log(f"progressive: skip_layer_range -> ({new_lo}, {new_hi})")

    return hook
