"""The port's spans (``autodiffusion_tpu_torch.utils.trace``) on the CPU:
off they record nothing; on, the sampler and the fitness record one span
a boundary with the right parents, trace ids and counts, change no result
bit, and reach torch.profiler. Then ``tools/span_trace.py``'s reading of
a trace, on synthetic profiler events.
"""

import re

import numpy as np
import pytest
import torch

from autodiffusion_tpu_torch.fid import FIDStats
from autodiffusion_tpu_torch.models import random_init_
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                              ddim_sample_loop, p_sample_loop)
from autodiffusion_tpu_torch.schedules import build_tables
from autodiffusion_tpu_torch.search import make_adm_fitness
from autodiffusion_tpu_torch.utils import logger, trace
from test_torch_package import one_torch_thread  # noqa: F401
from tools import span_trace

IMG = 8
SAMPLER = ("adt.sampler.loop", "adt.sampler.step", "adt.sampler.model",
           "adt.sampler.guidance")


@pytest.fixture(autouse=True)
def spans_off():
    """Spans are process-wide: every test starts and ends with them off
    and no record left."""
    trace.enable(False)
    trace.take()
    yield
    trace.enable(False)
    trace.take()


@pytest.fixture(scope="module")
def tiny():
    common = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
                  channel_mult=(1, 2), num_head_channels=16)
    m = random_init_(UNetModel(in_channels=3, out_channels=6,
                               num_classes=10, **common), 0).eval()
    c = random_init_(EncoderUNetModel(image_size=IMG, in_channels=3,
                                      out_channels=10,
                                      use_new_attention_order=False,
                                      **common), 1).eval()
    return m, c


def _guided_loop(tiny, loop=ddim_sample_loop):
    m, c = tiny
    y = torch.tensor([1, 5, 1, 5])
    tables = build_tables((50, 300, 600, 900), base_schedule="cosine")
    return loop(lambda x, t, i: m(x, t, y), (4, 3, IMG, IMG), tables,
                device="cpu", generator=torch.Generator().manual_seed(3),
                cond_fn=classifier_cond_fn(c, y, 2.0))


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_off_record_nothing_and_share_one_null_context():
    first = trace.span("adt.sampler.step", index=3)
    assert trace.span("adt.fitness.chunk", trace_id=7, candidates=2) \
        is first
    with first:
        with trace.span("adt.sampler.model"):
            pass
    assert trace.take() == []


@pytest.mark.parametrize("loop", [ddim_sample_loop, p_sample_loop])
def test_guided_loop_records_a_span_a_boundary(tiny, loop):
    trace.enable(True)
    _guided_loop(tiny, loop)
    records = trace.take()
    by = _by_name(records)
    assert {k: len(v) for k, v in by.items()} == {
        "adt.sampler.loop": 1, "adt.sampler.step": 4,
        "adt.sampler.model": 4, "adt.sampler.guidance": 4}
    (lp,) = by["adt.sampler.loop"]
    assert lp.parent == -1 and lp.attrs == {"rows": 4, "steps": 4}
    steps = [i for i, r in enumerate(records) if r.name == SAMPLER[1]]
    assert [records[i].attrs["index"] for i in steps] == [3, 2, 1, 0]
    assert all(records[i].parent == 0 for i in steps)
    for name in SAMPLER[2:]:
        for r in by[name]:
            parent = records[r.parent]
            assert parent.name == "adt.sampler.step"
            assert parent.start_ns <= r.start_ns <= r.end_ns \
                <= parent.end_ns
    # one request, one trace id: a fresh one, below any fitness's
    assert len({r.trace_id for r in records}) == 1 and lp.trace_id < 0
    assert trace.take() == []


def test_each_loop_outside_a_fitness_opens_a_fresh_trace_id(tiny):
    trace.enable(True)
    _guided_loop(tiny)
    _guided_loop(tiny)
    ids = [r.trace_id for r in trace.take() if r.name == SAMPLER[0]]
    assert len(set(ids)) == 2


def _fitness(tiny, device_frechet=True):
    m, c = tiny

    def feature_fn(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :16]}

    ref = FIDStats.from_features(
        np.random.RandomState(0).randn(50, 16) * 40 + 127)
    # two candidates a chunk, two device batches of 2 images a candidate
    fit = make_adm_fitness(model=m, image_size=IMG, feature_fn=feature_fn,
                           ref_stats=ref, num_samples=4, batch_size=2,
                           classifier=c, num_classes=10, candidate_chunk=2,
                           feature_dim=16, seed=5, device="cpu")
    if not device_frechet:
        fit._device_frechet = None      # the host's eigh, per candidate
    return fit


CANDS = [(100, 500, 900), (50, 300, 700)]


@pytest.mark.parametrize("device_frechet", [True, False])
def test_fitness_chunk_spans_carry_its_eval_count(tiny, device_frechet):
    fit = _fitness(tiny, device_frechet)
    fit.set_state({"eval_count": 7})
    trace.enable(True)
    fit(CANDS)
    records = trace.take()
    by = _by_name(records)
    counts = {k: len(v) for k, v in by.items()}
    assert counts == {
        "adt.fitness.chunk": 1, "adt.fitness.payload": 1,
        "adt.fitness.sample": 2, "adt.fitness.features": 2,
        "adt.fitness.moments": 2, "adt.fitness.frechet": 1,
        "adt.sampler.loop": 2, "adt.sampler.step": 6,
        "adt.sampler.model": 6, "adt.sampler.guidance": 6}
    assert {r.trace_id for r in records} == {7}
    assert by["adt.fitness.chunk"][0].attrs == {"candidates": 2}
    assert [r.attrs for r in by["adt.fitness.sample"]] == [{"rows": 4}] * 2
    assert [r.attrs for r in by["adt.fitness.features"]] == \
        [{"images": 4}] * 2
    for name in ("adt.fitness.payload", "adt.fitness.sample",
                 "adt.fitness.features", "adt.fitness.moments",
                 "adt.fitness.frechet"):
        assert all(records[r.parent].name == "adt.fitness.chunk"
                   for r in by[name])
    for r in by["adt.sampler.loop"]:
        assert records[r.parent].name == "adt.fitness.sample"
        assert r.attrs == {"rows": 4, "steps": 3}
    order = [r.name for r in records if r.parent == 0]
    assert order == ["adt.fitness.payload"] + [
        "adt.fitness.sample", "adt.fitness.features",
        "adt.fitness.moments"] * 2 + ["adt.fitness.frechet"]
    # the next chunk carries the next eval_count
    fit(CANDS)
    assert {r.trace_id for r in trace.take()} == {8}


def test_fitness_log_line_keeps_its_format(tiny):
    lines = []

    class Keep:
        def writeseq(self, seq):
            lines.append(" ".join(map(str, seq)))

    logger.Logger.CURRENT = logger.Logger(None, log_to_stdout=False,
                                          formats=[])
    logger.Logger.CURRENT.text_outputs.append(Keep())
    try:
        _fitness(tiny)(CANDS)
    finally:
        logger.Logger.CURRENT = None
    assert len(lines) == 1 and re.fullmatch(
        r"reset_time: \d+\.\d{3}, sample_time: \d+\.\d{3}, "
        r"fid_time: \d+\.\d{3}", lines[0]), lines


def test_spans_change_no_image_and_no_fid(tiny):
    outs = {}
    for on in (False, True):
        trace.enable(on)
        outs[on] = (_guided_loop(tiny), _fitness(tiny)(CANDS))
        trace.enable(False)
    assert trace.take()       # the second run recorded
    assert torch.equal(outs[False][0], outs[True][0])
    assert outs[False][1] == outs[True][1]


def test_spans_reach_the_profiler(tiny):
    from torch.profiler import ProfilerActivity, profile

    trace.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fitness(tiny)(CANDS)
    names = {e.name for e in prof.events()}
    assert {"adt.fitness.chunk", "adt.fitness.frechet",
            *SAMPLER} <= names
    # the ranges nest as the records do: each step inside its loop
    loops = [e for e in prof.events() if e.name == SAMPLER[0]]
    steps = [e for e in prof.events() if e.name == SAMPLER[1]]
    assert len(loops) == 2 and len(steps) == 6
    assert all(any(lp.time_range.start <= s.time_range.start
                   and s.time_range.end <= lp.time_range.end
                   for lp in loops) for s in steps)


# tools/span_trace.py on synthetic events: times in us, as the profiler's

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, annotation=False, cid=0):
        self.name, self.device_type = name, dev
        self.time_range = type("R", (), {
            "start": start, "end": end,
            "elapsed_us": lambda self_: end - start})()
        self.is_user_annotation = annotation
        self.id = cid


def _step_trace():
    """One step: on the host the step's span (0-600 us) holds the model's
    (0-200) and the guidance's (250-500, its backward launched from
    another thread at 400); on the device the model's kernel, the
    guidance's forward and backward kernels and the update's run from
    1000 to 3000 us with 100 us of idle time. The spans' device-side
    copies hold only kernels launched directly inside them (the profiler's
    rule), so they read short; the launch rule reads every kernel."""
    return [Ev("adt.sampler.step", CPU, 0, 600, True),
            Ev("adt.sampler.model", CPU, 0, 200, True),
            Ev("adt.sampler.guidance", CPU, 250, 500, True),
            Ev("adt.sampler.step", CUDA, 2700, 3000, True),
            Ev("adt.sampler.guidance", CUDA, 2000, 2300, True),
            Ev("cudaLaunchKernel", CPU, 10, 20, cid=11),
            Ev("cudaLaunchKernel", CPU, 260, 270, cid=12),
            Ev("cuLaunchKernel", CPU, 400, 410, cid=13),
            Ev("aten::mul", CPU, 550, 570, cid=14),
            Ev("cudaLaunchKernel", CPU, 550, 560, cid=14),
            Ev("model_kernel", CUDA, 1000, 2000, cid=11),
            Ev("cls_fwd_kernel", CUDA, 2000, 2300, cid=12),
            Ev("flash_bwd_dq_kernel", CUDA, 2400, 2700, cid=13),
            Ev("ddim_update_kernel", CUDA, 2700, 3000, cid=14),
            Ev("spin_kernel", CUDA, -500, -10, cid=15)]


def test_span_device_seconds_follow_the_launch_on_any_thread():
    events = _step_trace()
    got = span_trace.span_device_s(events)
    assert got == pytest.approx({"adt.sampler.step": 1900e-6,
                                 "adt.sampler.model": 1000e-6,
                                 "adt.sampler.guidance": 600e-6})
    # the step's self time: the update alone
    r = span_trace.readings(got, [trace.Span("adt.sampler.loop", 0, 1, -1,
                                             -1, {"rows": 2, "steps": 1})],
                            span_trace.step_idle_s(events))
    assert r["update_ms_per_image_step"] == pytest.approx(0.3 / 2)
    assert r["guidance_ms_per_image_step"] == pytest.approx(0.6 / 2)
    # the ranges of the spans are not device work
    assert {e.name for e in span_trace.kernels(events)} == {
        "model_kernel", "cls_fwd_kernel", "flash_bwd_dq_kernel",
        "ddim_update_kernel"}


def test_step_idle_is_its_stretch_less_its_kernels():
    assert span_trace.step_idle_s(_step_trace()) == \
        (pytest.approx(100e-6), 1)
    # overlapping kernels count once; a step that launched nothing adds
    # no idle time
    events = [Ev("adt.sampler.step", CPU, 0, 100, True),
              Ev("adt.sampler.step", CPU, 200, 300, True),
              Ev("cudaLaunchKernel", CPU, 10, 11, cid=1),
              Ev("cudaLaunchKernel", CPU, 20, 21, cid=2),
              Ev("cudaLaunchKernel", CPU, 30, 31, cid=3),
              Ev("a", CUDA, 1000, 1400, cid=1),
              Ev("b", CUDA, 1300, 1500, cid=2),
              Ev("c", CUDA, 1900, 2500, cid=3)]
    assert span_trace.step_idle_s(events) == (pytest.approx(400e-6), 2)


def test_kernels_without_a_runtime_call_count_under_no_span():
    events = [Ev("adt.sampler.model", CPU, 0, 100, True),
              Ev("aten::add", CPU, 10, 20, cid=5),
              Ev("add_kernel", CUDA, 200, 300, cid=5)]
    assert span_trace.span_device_s(events) == {"adt.sampler.model": 0.0}


def test_readings_need_their_spans():
    assert span_trace.readings({}, [], (0.0, 0)) == {}
    chunk = trace.Span("adt.fitness.chunk", 0, 10, -1, 0, {})
    frechet = trace.Span("adt.fitness.frechet", 0, 90_000_000, 0, 0, {})
    got = span_trace.readings({"adt.sampler.guidance": 1.0},
                              [chunk, frechet, chunk], (0.004, 2))
    # no sampler loop: nothing per image-step
    assert got == {"frechet_ms_per_call": pytest.approx(45.0),
                   "step_idle_ms": pytest.approx(2.0)}
