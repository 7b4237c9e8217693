"""The check against a broken timed path: each fault the cells can have,
planted in the program underneath a tiny run on the CPU, breaks a limit
of the cell, by a number that reads at least three times the sound run's
of the same seed. (No cell spans chips, so no exchange between chips can
be left out. The limits are set at the cells' own sizes on the card,
where the sound runs keep them: test_portbench_control.py.)"""

import pytest
import torch

from conftest import run_tiny

from benchmark.harness import checks
from benchmark.harness.spec import Cell, load_spec


def _unchanged(monkeypatch, name):
    """Every sampler step returns its state: x_0 is x_T."""
    def loop(model_fn, shape, tables, **kw):
        return kw["noise"].float()
    mod = ("autodiffusion_tpu_torch.search.pipelines" if "search" in name
           else "autodiffusion_tpu_torch.samplers")
    monkeypatch.setattr(mod + ".ddim_sample_loop", loop)


def _images(monkeypatch, name, alter):
    from autodiffusion_tpu_torch.search import fitness

    real = fitness.to_uint8
    mod = ("autodiffusion_tpu_torch.search.pipelines" if "search" in name
           else "autodiffusion_tpu_torch.search")
    monkeypatch.setattr(mod + ".to_uint8", lambda x: alter(real(x)))


def _half(monkeypatch, name):
    """Half of the batch left out: its rows are copies of the rest."""
    def alter(u):
        h = u.shape[0] // 2
        u = u.clone()
        u[h:2 * h] = u[:h]
        return u
    _images(monkeypatch, name, alter)


def _answer(monkeypatch, name):
    """One answer altered where it is produced: an image of every batch
    inverted, or a candidate's FID 1 % off."""
    if "search" in name:
        from autodiffusion_tpu_torch.search.fitness import BatchedFIDFitness

        real = BatchedFIDFitness.__call__

        def call(self, cands):
            fids = real(self, cands)
            return [fids[0] * 1.01] + fids[1:]
        monkeypatch.setattr(BatchedFIDFitness, "__call__", call)
    else:
        def alter(u):
            u = u.clone()
            u[0] = 255 - u[0]
            return u
        _images(monkeypatch, name, alter)


FAULTS = {"unchanged": _unchanged, "half": _half, "answer": _answer}
CELLS = ["adm64-guided-search", "lsun256-search", "adm64-guided-sample"]


_SOUND = {}


def _sound(name):
    if name not in _SOUND:
        _SOUND[name] = run_tiny(name)[1]["values"]
    return _SOUND[name]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_breaks_a_limit(name, fault, monkeypatch):
    sound = _sound(name)
    FAULTS[fault](monkeypatch, name)
    _, out = run_tiny(name)
    limits = Cell(load_spec(), name).limits["limits"]
    verdict = checks.verdict(out["values"], limits)
    assert not checks.passed(verdict), verdict
    broken = [k for k, c in verdict.items()
              if c["value"] > c["limit"] and c["value"] > 3 * sound[k]]
    assert broken, (verdict, sound)
    assert torch.is_grad_enabled()
