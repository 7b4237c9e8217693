"""Schedule tables of the PyTorch port against the JAX package.

Both derive every coefficient in float64 numpy and cast once to float32,
so the tables must be bitwise equal (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from autodiffusion_tpu.schedules import build_tables as jax_build_tables
from autodiffusion_tpu.schedules import stack_tables as jax_stack_tables
from autodiffusion_tpu_torch.schedules import (ScheduleTables, build_tables,
                                               stack_tables)
from test_torch_package import one_torch_thread  # noqa: F401

FIELDS = [f.name for f in dataclasses.fields(ScheduleTables)]
PUBLISHED = [94, 834, 217, 944, 574, 354]


def _random_candidates(n, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return [sorted(rng.choice(1000, k, replace=False).tolist())
            for _ in range(n)]


def _assert_equal(port, ref):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("base", ["cosine", "linear"])
@pytest.mark.parametrize("spec", ["ddim4", "published", "random0", "random1",
                                  "random2"])
def test_tables_equal_jax(spec, base):
    if spec == "published":
        use = PUBLISHED
    elif spec.startswith("random"):
        use = _random_candidates(3)[int(spec[-1])]
    else:
        use = spec
    port = build_tables(use, base_schedule=base)
    ref = jax_build_tables(use, base_schedule=base)
    assert port.num_steps == ref.num_steps
    assert port.betas.dtype == torch.float32
    _assert_equal(port, ref)


def test_stack_tables_equal_jax():
    cands = _random_candidates(3, seed=1)
    port = stack_tables([build_tables(c, base_schedule="cosine")
                         for c in cands])
    ref = jax_stack_tables([jax_build_tables(c, base_schedule="cosine")
                            for c in cands])
    assert port.betas.shape == (3, 4)
    _assert_equal(port, ref)


def test_per_sample_fold_and_device_move():
    cands = _random_candidates(2, seed=2)
    folded = stack_tables([build_tables(c) for c in cands]).map(
        lambda t: t.repeat_interleave(5, dim=0)).to("cpu")
    assert folded.alphas_cumprod.shape == (10, 4)
    single = build_tables(cands[1])
    np.testing.assert_array_equal(folded.alphas_cumprod[7].numpy(),
                                  single.alphas_cumprod.numpy())


def test_stack_mismatched_k_raises():
    with pytest.raises(ValueError, match="share K"):
        stack_tables([build_tables("ddim4"), build_tables("ddim5")])


def test_invalid_specs_raise():
    with pytest.raises(ValueError):
        build_tables("ddim999")
    with pytest.raises(ValueError):
        build_tables([1000])
