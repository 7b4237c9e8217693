"""The trace's reading: device time by the benchmark's ranges (kernels
that start inside a range's span on the device's timeline), and the
per-layer readers on a reading."""

import pytest
import torch

from benchmark.harness.trace import range_device_s

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, annotation=False):
        self.name, self.device_type = name, dev
        self.time_range = type("R", (), {
            "start": start, "end": end,
            "elapsed_us": lambda self_: end - start})()
        self.is_user_annotation = annotation


def test_kernels_belong_to_the_range_they_start_in():
    events = [Ev("bench.unet", CPU, 0, 100, True),
              Ev("bench.unet", CUDA, 20, 1200, True),
              Ev("conv_kernel", CUDA, 20, 1020),
              Ev("norm_kernel", CUDA, 1050, 1200),
              Ev("bench.features", CUDA, 1300, 3300, True),
              Ev("inception_kernel", CUDA, 1300, 3300),
              Ev("backward_kernel", CUDA, 3400, 7400),
              Ev("spin_kernel", CUDA, 7400, 7500)]
    got = range_device_s(events)
    assert got["bench.unet"] == pytest.approx(1150e-6)
    assert got["bench.features"] == pytest.approx(2000e-6)
    assert got["bench.classifier"] == 0.0


def _reader(name, cell="adm64-guided-search"):
    from benchmark.harness.spec import Cell, load_spec
    return Cell(load_spec(), cell).reader(name)


def test_readers_on_a_reading():
    r = {"busy_s": 10.0, "window_s": 12.0,
         "units": {"traced": 1, "untraced": 2, "untraced_s": 25.0},
         "range_device_s": {"bench.unet": 6.0, "bench.features": 0.5,
                            "bench.classifier": 1.0},
         "unet": {"calls": 16, "images": 6400},
         "classifier": {"calls": 16, "images": 6400},
         "features": {"calls": 4, "images": 1600},
         "images": {"unet": 6400, "classifier": 6400, "inception": 1600},
         "flops_per_image": {"unet": 2e11, "classifier": 1e11,
                             "inception": 1e10},
         "launches": 4176, "steps": 16}
    assert _reader("idle_share").read(r) == pytest.approx(100 / 6)
    assert _reader("sampler.outside_unet_share").read(r) == \
        pytest.approx(35.0)
    assert _reader("unet.ms_per_image_call").read(r) == \
        pytest.approx(6000 / 6400)
    assert _reader("fid.features_ms_per_image").read(r) == \
        pytest.approx(500 / 1600)
    assert _reader("host.launches_per_step").read(r) == 261
    flops = 6400 * 2e11 + 6400 * 1e11 + 1600 * 1e10
    assert _reader("mfu").read(r) == pytest.approx(
        100 * flops * 2 / (25.0 * 989e12))
    for name in ("mfu", "unet.ms_per_image_call", "host.launches_per_step",
                 "sampler.outside_unet_share"):
        assert _reader(name + ".sample", "adm64-guided-sample").read(r) \
            == _reader(name).read(r)
    r["units"]["untraced"] = 0
    assert _reader("mfu").read(r) is None


def test_request_idle_share_is_of_the_untraced_request():
    """The sample cell's idle share: busy time a traced request over the
    median untraced request, not over the traced (profiler-slowed) wall."""
    r = {"busy_s": 1.6, "window_s": 3.2, "units": {"traced": 4},
         "request_ms": [480.0, 500.0, 520.0, 900.0]}
    idle = _reader("idle_share.request", "adm64-guided-sample")
    assert idle.read(r) == pytest.approx(100 * (1 - 0.4 / 0.51))
    assert _reader("idle_share").read(r) == pytest.approx(50.0)
    assert _reader("sampler.request_ms_p50", "adm64-guided-sample").read(
        r) == pytest.approx(510.0)
    r["request_ms"] = []
    assert idle.read(r) is None
