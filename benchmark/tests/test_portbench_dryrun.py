"""Each driver end to end on the CPU at a tiny size: the window, the
result's arithmetic and the check, with the control beside it."""

import math

import pytest

from conftest import run_tiny

from benchmark.harness.common import percentile

CELLS = {"adm64-guided-search": ("image_gap", "feature_gap", "fid_gap"),
         "lsun256-search": ("image_gap", "feature_gap", "fid_gap"),
         "adm64-guided-sample": ("image_gap",)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_driver_runs_and_checks(name):
    ctx, out = run_tiny(name, control=True)
    assert ctx.setup_s > 0 and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["values"]) == set(CELLS[name])
    for k, v in out["values"].items():
        assert math.isfinite(v)
        # the control, one precision below, reads a wider gap
        assert out["control"][k] > v, (k, v, out["control"][k])
    assert out["e2e"]["images_per_s"] > 0


def test_rates_over_the_whole_window_and_p90_over_all_requests():
    ctx, out = run_tiny("adm64-guided-sample")
    n = ctx.traffic["request_images"]
    ex = out["extra"]
    assert out["e2e"]["images_per_s"] == pytest.approx(
        n * ex["requests"] / ex["window_s"])
    ctx, out = run_tiny("adm64-guided-search")
    ex = out["extra"]
    chunk, per = ctx.traffic["candidate_chunk"], ctx.cfg["num_samples"]
    assert out["e2e"]["images_per_s"] == pytest.approx(
        ex["fitness_calls"] * chunk * per / ex["window_s"])


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert percentile(values, 90) == 90
    assert percentile(values[::-1], 90) == 90
    assert percentile([5.0] * 9 + [100.0], 90) == 5.0
    assert percentile([5.0] * 9 + [100.0, 100.0], 90) == 100.0
    assert percentile([3.0], 90) == 3.0
