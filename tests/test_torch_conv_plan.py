"""The launch plan of the 3x3 conv kernels (ops/conv_im2col.py::conv_plan),
checked on the CPU at every bf16 conv site of ADM-64, the SD v1 UNet and
the SD VAE decoder, and at a few ragged shapes.

The sites are read from the full-width models on the meta device (shapes
only), both conv routes recorded, as tests/test_torch_fused_paths.py reads
them; each is planned at its search's device batch (ADM 32, the SD UNet 16,
the decoder 8) and at batch 1. A plan must:

* cover every output channel and every output pixel exactly once, with the
  tiles the kernel derives from it (csrc/conv3x3.cuh: the grid, each
  block's sub-tiles, a sub-tile's slab run inside the wgmma width);
* split K only into runs of whole 16-channel chunks, none empty;
* take at most 227 KB of shared memory, by the kernel's own layout;
* where it splits K, give at least 132 blocks (one per SM of an H100).
"""

import math

import pytest
import torch

from autodiffusion_tpu_torch.models import (ClassifierConfig, ModelConfig,
                                            create_classifier, create_model,
                                            create_sd_models)
from autodiffusion_tpu_torch.models import nn as port_nn
from autodiffusion_tpu_torch.models import unet as port_unet
from autodiffusion_tpu_torch.ops.conv_im2col import conv_plan

SMS = 132
SMEM_MAX = 232448   # 227 KB
WIDTHS = (80, 136)
SWITCHES = {"ADT_FUSED_NORM": "1", "ADT_IM2COL_CONV": "1",
            "ADT_FUSED_CONV": "all"}


def _record_sites(monkeypatch, run):
    """{(C_in, C_out, H, W)} of every conv3x3 / conv3x3_fused call of
    ``run()`` under the switches, on the meta device."""
    sites = set()

    def conv(x, w, *args, **kw):
        sites.add((x.shape[1], w.shape[0], x.shape[2], x.shape[3]))
        return torch.empty((x.shape[0], w.shape[0], *x.shape[2:]),
                           dtype=x.dtype, device=x.device)

    def fused(x, a, b, w, *args, **kw):
        return conv(x, w)

    for k, v in SWITCHES.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(port_nn, "conv3x3", conv)
    monkeypatch.setattr(port_nn, "conv3x3_fused", fused)
    monkeypatch.setattr(port_nn, "fused_group_norm",
                        lambda x, *a, **kw: torch.empty_like(x))
    with torch.device("meta"):
        run()
    return sites


def _adm64(monkeypatch):
    monkeypatch.setattr(port_unet, "flash_attention",
                        lambda q, k, v: torch.empty_like(q))

    def run():
        create_model(ModelConfig.adm64(), device="meta")(
            torch.empty(1, 3, 64, 64), torch.zeros(1),
            torch.zeros(1, dtype=torch.long))
        create_classifier(ClassifierConfig.adm64(), device="meta")(
            torch.empty(1, 3, 64, 64), torch.zeros(1))
    return _record_sites(monkeypatch, run)


def _sd(monkeypatch, part):
    import sys
    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    monkeypatch.setattr(fa, "flash_fwd_packed",
                        lambda q, *a, **kw: (torch.empty_like(q), None))
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda q, *a, **kw: (torch.empty_like(q), None))

    def run():
        unet, vae, _ = create_sd_models(device="meta")
        if part == "unet":
            unet(torch.empty(1, 4, 64, 64), torch.zeros(1),
                 torch.empty(1, 77, 768))
        else:
            vae.decode(torch.empty(1, 4, 64, 64))
    return _record_sites(monkeypatch, run)


def _smem(plan, w):
    """Shared memory of a block, by csrc/conv3x3.cuh's Geometry: per stage
    the weight tile [2][9][128][8] bf16, the raw input boxes [16][slab
    rows][W or tw + 16] bf16, a, b [2][2][16] float32 and an 8-byte
    mbarrier; two slab buffers [2][npix][8] bf16."""
    sw = plan.tw + 2
    if plan.packed:
        slab_rows, sub_rows = 2 * (plan.rows + 2), plan.rows + 2
    else:
        slab_rows, sub_rows = 2 * plan.rows + 2, plan.rows
    npix = math.ceil(max(slab_rows * sw, sub_rows * sw + 2 * sw + 2
                         + plan.nt) / 8) * 8
    raw_w = plan.tw if plan.tw == w else plan.tw + 16
    stage = 128 * 9 * 16 * 2 + 16 * slab_rows * raw_w * 2 + 2 * 2 * 16 * 4
    return plan.stages * (stage + 8) + 2 * 2 * npix * 8 * 2


def _check(batch, c_in, c_out, h, w):
    plan = conv_plan(batch, c_in, c_out, h, w, torch.bfloat16)
    assert plan.kernel == "igemm", (batch, c_in, c_out, h, w, plan)
    # a sub-tile's slab run, whole rows of tw + 2 pixels, fits the wgmma
    assert plan.nt in WIDTHS
    assert plan.rows >= 1 and plan.rows * (plan.tw + 2) <= plan.nt
    assert plan.tw == w or (plan.tw % 8 == 0 and plan.tw < w)
    assert not plan.packed or (plan.rows == h and plan.tw == w)

    # the grid the kernel launches, and what each block covers
    pixels = torch.zeros(batch, h, w, dtype=torch.int32)
    if plan.packed:
        groups = math.ceil(batch / 2)
        for g in range(groups):
            pixels[2 * g:2 * g + 2] += 1
        tiles = groups
    else:
        bands = math.ceil(h / (2 * plan.rows))
        cols = math.ceil(w / plan.tw)
        for band in range(bands):
            for col in range(cols):
                for s in range(2):
                    r0 = band * 2 * plan.rows + s * plan.rows
                    pixels[:, r0:r0 + plan.rows,
                           col * plan.tw:(col + 1) * plan.tw] += 1
        tiles = batch * bands * cols
    assert bool((pixels == 1).all()), "pixels not covered exactly once"
    channels = torch.zeros(c_out, dtype=torch.int32)
    co_tiles = math.ceil(c_out / 128)
    for y in range(co_tiles):
        channels[y * 128:(y + 1) * 128] += 1
    assert bool((channels == 1).all())
    assert plan.blocks == tiles * co_tiles * plan.splits

    # K: runs of whole chunks, in order, none empty
    chunks = c_in // 16
    assert c_in % 16 == 0
    runs = [range(z * plan.chunks_per_split,
                  min(chunks, (z + 1) * plan.chunks_per_split))
            for z in range(plan.splits)]
    assert all(len(r) > 0 for r in runs)
    assert [k for r in runs for k in r] == list(range(chunks))
    if plan.splits > 1:
        assert plan.blocks >= SMS

    assert 2 <= plan.stages <= 4
    assert plan.smem == _smem(plan, w) <= SMEM_MAX
    return plan


@pytest.mark.parametrize("model,batch", [("adm64", 32), ("unet", 16),
                                         ("decode", 8)])
def test_plan_at_every_site(monkeypatch, model, batch):
    sites = _adm64(monkeypatch) if model == "adm64" else \
        _sd(monkeypatch, model)
    assert sites
    for c_in, c_out, h, w in sorted(sites):
        for b in (batch, 1):
            _check(b, c_in, c_out, h, w)


def test_site_counts(monkeypatch):
    """The distinct bf16 conv sites the searches run: ADM-64 (UNet and
    classifier), the SD UNet and the decoder."""
    assert len(_adm64(monkeypatch)) == 32
    assert len(_sd(monkeypatch, "unet")) == 16
    assert len(_sd(monkeypatch, "decode")) == 6


@pytest.mark.parametrize("shape", [
    (2, 256, 128, 13, 32),     # H not a multiple of the tile's rows
    (3, 64, 64, 5, 8),         # W = 8, whole images packed in pairs
    (3, 64, 64, 9, 8),         # W = 8, more rows than one wgmma holds
    (4, 64, 192, 16, 16),      # C_out = 192: the last tile half masked
    (2, 128, 576, 9, 24),      # C_out = 576, W = 24
    (1, 32, 64, 7, 200),       # W > 64 and not a multiple of 64
    (32, 1536, 768, 8, 8),     # split K
    (1, 128, 128, 512, 512),   # a 512-wide row in tiles of 64 columns
])
def test_plan_ragged_shapes(shape):
    _check(*shape)


def test_plan_other_kernels():
    """bf16 shapes the implicit GEMM does not take go to the gather
    kernel; float32 to the CUDA-core kernel."""
    assert conv_plan(2, 72, 100, 7, 9, torch.bfloat16).kernel == "gather"
    assert conv_plan(2, 24, 64, 8, 8, torch.bfloat16).kernel == "gather"
    assert conv_plan(2, 64, 64, 8, 12, torch.bfloat16).kernel == "gather"
    assert conv_plan(2, 64, 64, 8, 8, torch.float32).kernel == "float32"
