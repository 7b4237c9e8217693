"""The roofline's work counts against hand counts at the sites of the
kernel table (PERF.md), and FlopCounterMode's count of the plain
reference against the convolutions' arithmetic."""

import pytest
import torch

from benchmark.harness.spec import Cell, load_spec
from benchmark.roofline import count
from benchmark.roofline import attention, groupnorm

BF16, HBM = 989e12, 3.35e12


def _ms(work):
    p = count.peaks()
    rate = {"bf16": p["bf16_flops_per_s"], "fp32": p["fp32_flops_per_s"]}
    return sum(max(o / rate[k], b / p["hbm_bytes_per_s"])
               for o, b, k in work) * 1e3


def test_flash_forward_is_four_ntsd():
    # ADM-64 UNet, T = S = 1024, 6 heads, D 64, batch 32: 0.0521 ms
    site = dict(n=32 * 6, t=1024, s=1024, d=64, grad=False)
    ((ops, nbytes, kind),) = attention.work(site)
    assert ops == 4 * 192 * 1024 * 1024 * 64 and kind == "bf16"
    assert nbytes == (2 * 192 * 1024 * 64 * 2) * 2 + 4 * 192 * 1024
    assert _ms(attention.work(site)) == pytest.approx(0.0521, abs=1e-4)


def test_attention_backward_is_ten_ntsd():
    site = dict(n=4, t=256, s=256, d=64, grad=True)
    fwd, bwd = attention.work(site)
    assert bwd[0] == 10 * 4 * 256 * 256 * 64
    assert bwd[1] == (3 * 4 * 256 * 64 + 4 * 4 * 256 * 64) * 2 + 8 * 4 * 256


def test_groupnorm_is_bytes_bound():
    # the VAE's C 256 at 512x512, batch 8: 0.6410 ms; the classifier's
    # backward at C 128, 64x64, batch 32, dx only: 0.0301 ms
    vae = dict(n=8, c=256, hw=512 * 512, groups=32, film=False, grad=False)
    assert _ms(groupnorm.work(vae)) == pytest.approx(0.6410, abs=1e-4)
    cls = dict(n=32, c=128, hw=64 * 64, groups=32, film=True, grad=True)
    assert _ms(groupnorm.work(cls)[1:]) == pytest.approx(0.0301, abs=1e-4)


def test_sites_and_flops_of_the_adm_unet():
    cell = Cell(load_spec(), "adm64-guided-search")
    cfg, fam = cell.config, cell.family
    ref = fam.reference_models(cfg)
    sites = count.sites_per_image(ref, cfg, fam.count_run)
    attn = [s for s in sites["unet"] if s["op"] == "attention"]
    # 32x32, 16x16, 8x8: 3 res blocks down, 4 up at each, plus the middle
    assert sorted({(s["t"], s["n"]) for s in attn}) == [
        (64, 12), (256, 9), (1024, 6)]
    assert len(attn) == 3 * 3 + 3 * 4 + 1
    assert all(s["grad"] for s in sites["classifier"])
    flops = count.flops_per_image(ref, cfg, fam.count_run)
    # the first conv alone: 2 x 64 x 64 x 192 x 27
    assert flops["unet"] > 2 * 64 * 64 * 192 * 27
    assert 200e9 < flops["unet"] < 240e9
    assert 60e9 < flops["classifier"] < 100e9
    assert 10e9 < flops["inception"] < 13e9


def test_flop_counter_counts_a_conv():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(2, 8, 16, 16, device="meta")
    w = torch.zeros(4, 8, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * 2 * 16 * 16 * 4 * 8 * 9


def test_share_reads_nothing_without_kernels():
    r = {"images": {"unet": 4}, "sites_per_image": {"unet": [
        dict(op="attention", n=1, t=64, s=64, d=64, grad=False)]},
        "kernel_s": {"some_gemm": 1.0}}
    assert count.share(r, "attention") is None
    r["kernel_s"]["flash_fwd_tma_kernel<64, 1>"] = 1e-3
    share = count.share(r, "attention")
    assert 0 < share < 100
