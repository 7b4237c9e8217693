"""Shared pieces of the benchmark's CPU tests: the cells cut to a size the
CPU runs in seconds (widths and depth cut, every path kept)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = dict(num_channels=32, num_res_blocks=1, image_size=32,
                  attention_resolutions="16,8", classifier_width=32,
                  classifier_depth=1, classifier_attention_resolutions="16,8",
                  num_samples=2, batch_size=2)
TINY_TRAFFIC = dict(candidate_chunk=2, check_rows=3, check_block=2,
                    request_images=2, fid_calls=1, trace_requests=1,
                    warmup_requests=1)


def tiny_cell(name: str):
    from benchmark.harness.spec import Cell, load_spec

    cell = Cell(load_spec(), name)
    cell.config.update({k: v for k, v in TINY_MODEL.items()
                        if k in cell.config or k == "image_size"})
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items()
                         if k in cell.traffic})
    return cell


def run_tiny(name: str, seed: int = 123456789012, control: bool = False):
    """The cell's driver at the tiny size on the CPU: (context, output)."""
    from benchmark.harness.common import Context
    from benchmark.harness.spec import module

    torch.set_num_threads(4)
    cell = tiny_cell(name)
    ctx = Context(cell, seed, 0.01, False, "cpu", time.time(),
                  control=control)
    return ctx, module(cell.driver_path).run(ctx)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
