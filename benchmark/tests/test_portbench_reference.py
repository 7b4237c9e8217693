"""The plain reference against the program at a small size on the CPU,
in float32 (TF32 off where a card is used): the same weights give the
same UNet, classifier and Inception outputs, guided DDIM the same images,
and the float64 FID the program's. Only this test imports both."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from benchmark.harness.models import materialise
from benchmark.reference import ddim as ref_ddim
from benchmark.reference import fid as ref_fid
from benchmark.reference.numerics import Numerics, exact_float32

P = Numerics()


def _models(name, **over):
    cell = tiny_cell(name)
    fam = cell.family
    cfg = dict(cell.config, use_bf16=False, classifier_use_bf16=False,
               **over)
    w = fam.seeded_weights(cfg, 7, "cpu")
    progs, mcfg = fam.program_models(cfg, w, "cpu")
    refs = fam.reference_models(cfg)
    w2 = fam.seeded_weights(cfg, 7, "cpu")
    for k in refs:
        materialise(refs[k], w2[k])
    return cfg, progs, refs, mcfg


def _close(a, b, tol):
    scale = b.abs().max().item()
    assert (a - b).abs().max().item() <= tol * max(scale, 1e-6), \
        ((a - b).abs().max().item(), scale)


@pytest.mark.parametrize("name", ["adm64-guided-search", "lsun256-search"])
def test_unet_and_inception_match(name):
    cfg, progs, refs, _ = _models(name)
    g = torch.Generator().manual_seed(0)
    s = cfg["image_size"]
    x = torch.randn(2, 3, s, s, generator=g)
    t = torch.tensor([10.0, 900.0])
    y = torch.tensor([3, 999]) if cfg["class_cond"] else None
    with exact_float32(), torch.no_grad():
        _close(progs["unet"](x, t, y), refs["unet"](P, x, t, y), 1e-4)
        u8 = torch.randint(0, 256, (2, s, s, 3), generator=g,
                           dtype=torch.uint8)
        _close(progs["inception"](
            __import__("autodiffusion_tpu_torch.fid", fromlist=["x"])
            .preprocess(u8))["pool3"], refs["inception"](P, u8), 1e-4)
        if "classifier" in progs:
            _close(progs["classifier"](x, t),
                   refs["classifier"](P, x, t), 1e-4)


def test_guided_ddim_matches_the_program_sampler():
    from autodiffusion_tpu_torch.models import create_tables
    from autodiffusion_tpu_torch.samplers import (classifier_cond_fn,
                                                  ddim_sample_loop)
    from autodiffusion_tpu_torch.search import to_uint8

    cfg, progs, refs, mcfg = _models("adm64-guided-sample",
                                     classifier_logit_scale=100.0)
    g = torch.Generator().manual_seed(1)
    s = cfg["image_size"]
    noise = torch.randn(3, 3, s, s, generator=g)
    y = torch.tensor([1, 500, 998])
    ts = (17, 250, 600, 901)
    tables = create_tables(mcfg, ts)
    with exact_float32():
        x0 = ddim_sample_loop(
            lambda x, t, i: progs["unet"](x, t, y), noise.shape, tables,
            device="cpu", generator=g, noise=noise,
            cond_fn=classifier_cond_fn(progs["classifier"], y, 1.0))
        want = ref_ddim.guided_ddim(
            P, refs["unet"], noise, [ref_ddim.step_coefficients(
                ts, cfg["noise_schedule"])] * 3, y, refs["classifier"], 1.0)
    _close(x0, want, 1e-4)
    assert (to_uint8(x0).int() - ref_ddim.to_uint8(want).int()).abs() \
        .max() <= 1


def test_fid_matches_the_program_frechet():
    from autodiffusion_tpu_torch.fid.stats import (FeatureStats, FIDStats,
                                                   make_device_frechet)

    g = torch.Generator().manual_seed(2)
    d, n = 64, 40
    a = torch.randn(d, 2 * d, generator=g, dtype=torch.float64)
    sigma = a @ a.T / (2 * d)
    mu = torch.randn(d, generator=g, dtype=torch.float64).abs()
    feats = torch.randn(n, d, generator=g, dtype=torch.float64) * 1.3 + 0.2
    fn = make_device_frechet(FIDStats(mu.numpy(), sigma.numpy()), "cpu")
    c = feats - mu
    got = fn(FeatureStats(torch.tensor([float(n)], dtype=torch.float64),
                          c.sum(0)[None], (c.T @ c)[None]))[0]
    want = ref_fid.fid(feats, mu, sigma)
    assert abs(got - want) <= 1e-9 * want
    # the float32 control reads a larger gap than float64 rounding does
    ctrl = ref_fid.fid(feats, mu, sigma, torch.float32)
    assert abs(ctrl - want) > abs(got - want)
    assert np.isfinite(ctrl)
