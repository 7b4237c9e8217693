"""The port's offline FID evaluator against the JAX package's: the host
Frechet distance, the Inception Score, precision / recall by manifold
estimation, and FIDEvaluator.cal_metrics with synthesized Inception
weights at 75 px.

Tolerances:
  frechet_distance, inception_score  1e-12 relative (the same float64 host
                                     code on the same statistics)
  pairwise distances, radii          2e-6 of the largest squared norm
                                     (float32 |a|^2 + |b|^2 - 2 a.b cancels
                                     in both packages, in other orders)
  precision / recall                 equal (counts over those distances)
  cal_metrics                        fid, inception_score and sfid 1e-4
                                     relative (features 1e-4 of their scale
                                     apart, tests/test_torch_fid.py), P / R
                                     equal
  stub features                      1e-5 relative (JAX's features float32,
                                     the statistics float64 on both sides)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.fid import evaluator as jax_evaluator
from autodiffusion_tpu.fid import inception as jax_inception
from autodiffusion_tpu.fid import prd as jax_prd
from autodiffusion_tpu.fid import stats as jax_stats
from autodiffusion_tpu_torch.fid import (FIDEvaluator, FIDStats,
                                         frechet_distance, inception_score,
                                         load_fid_inception,
                                         make_inception_feature_fn,
                                         manifold_radii, pairwise_sq_distances,
                                         precision_recall,
                                         synthesize_pt_inception)
from test_torch_package import one_torch_thread  # noqa: F401


def _features(seed, n, d=16, offset=0.0):
    rng = np.random.RandomState(seed)
    mix = rng.randn(d, d) / np.sqrt(d)
    return rng.randn(n, d) @ mix * 3.0 + 40.0 + offset


@pytest.mark.parametrize("n", [50, 12])
def test_frechet_distance_matches_jax(n):
    """The scipy sqrtm path, full rank (n = 50 > D = 16) and singular
    (n = 12), where the reference's guards act."""
    a = FIDStats.from_features(_features(1, n))
    b = FIDStats.from_features(_features(2, n, offset=0.7))
    got = frechet_distance(a, b)
    want = jax_stats.frechet_distance(jax_stats.FIDStats(*a),
                                      jax_stats.FIDStats(*b))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="dimensions"):
        frechet_distance(a, FIDStats(np.zeros(3), np.eye(3)))


def test_inception_score_matches_jax():
    logits = np.random.RandomState(3).randn(23, 10) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for split in (5000, 7):
        assert inception_score(probs, split) == pytest.approx(
            jax_stats.inception_score(probs, split), rel=1e-12)


def test_precision_recall_matches_jax():
    ref = _features(4, 40).astype(np.float32)
    smp = _features(5, 30, offset=0.8).astype(np.float32)
    tol = 2e-6 * float((ref.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(
        pairwise_sq_distances(torch.from_numpy(ref),
                              torch.from_numpy(smp)).numpy(),
        np.asarray(jax_prd.pairwise_sq_distances(jnp.asarray(ref),
                                                 jnp.asarray(smp))),
        rtol=0, atol=tol)
    np.testing.assert_allclose(
        manifold_radii(torch.from_numpy(ref), block=16).numpy(),
        jax_prd.manifold_radii(ref, block=16), rtol=0, atol=tol)
    got = precision_recall(torch.from_numpy(ref), torch.from_numpy(smp))
    want = jax_prd.precision_recall(ref, smp)
    assert got == want
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] < 1.0


def test_cal_metrics_matches_jax_at_75px(tmp_path):
    """Both evaluators over the same synthesized pytorch_fid checkpoint,
    images resized to 75 px: reference statistics, spatial statistics and
    reference features from 16 images, then every metric of 12 samples in
    batches of 8 (the last one partial)."""
    path = str(tmp_path / "pt_inception.pth")
    torch.save(synthesize_pt_inception(5), path)
    rng = np.random.RandomState(0)
    samples = rng.randint(0, 256, (12, 64, 64, 3), dtype=np.uint8)
    refs = rng.randint(0, 256, (16, 64, 64, 3), dtype=np.uint8)

    jfn = jax_evaluator.make_inception_feature_fn(
        jax_inception.load_fid_inception_params(path), resize_to=75)
    jev = jax_evaluator.FIDEvaluator(
        jfn, jax_evaluator.FIDEvaluator.stats_from_images(jfn, refs, 8),
        batch_size=8)
    jref, _, jspatial = jev.compute_activations(refs, want_spatial=True)
    jev.ref_stats_spatial = jax_stats.FIDStats.from_features(jspatial)
    want = jev.cal_metrics(samples, ref_features=jref)

    pfn = make_inception_feature_fn(load_fid_inception(path, device="cpu"),
                                    resize_to=75)
    pev = FIDEvaluator(pfn, FIDEvaluator.stats_from_images(pfn, refs, 8),
                       batch_size=8)
    pref, _, pspatial = pev.compute_activations(refs, want_spatial=True)
    assert pref.shape == (16, 2048) and pspatial.shape == jspatial.shape
    # the spatial features flatten channels-last, as the JAX package's
    np.testing.assert_allclose(pspatial.numpy(), jspatial, rtol=0,
                               atol=1e-4 * np.abs(jspatial).max())
    pev.ref_stats_spatial = FIDStats.from_features(pspatial.numpy())
    got = pev.cal_metrics(samples, ref_features=pref)

    assert set(got) == set(want) == {"fid", "inception_score", "sfid",
                                     "precision", "recall"}
    for key in ("fid", "inception_score", "sfid"):
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert (got["precision"], got["recall"]) == (want["precision"],
                                                 want["recall"])
    assert got["fid"] > 0 and got["inception_score"] >= 1.0


def _stub_features(imgs, lib):
    """16 features of a uint8 NHWC batch: pixel means of a 4 x 4 grid."""
    x = imgs.reshape(imgs.shape[0], 4, 4, 4, 4, 3)
    return {"pool3": (x.astype(lib.float32) if lib is jnp
                      else x.float()).mean(axis=(2, 4, 5)).reshape(-1, 16)}


def test_cal_fid_and_reference_stats_match_jax_with_a_stub():
    """stats_from_images and cal_fid on a cheap 16-feature extractor, 13
    images in batches of 5 (the last one partial)."""
    rng = np.random.RandomState(6)
    refs = rng.randint(0, 256, (40, 16, 16, 3), dtype=np.uint8)
    samples = rng.randint(0, 200, (13, 16, 16, 3), dtype=np.uint8)
    jev = jax_evaluator.FIDEvaluator(
        lambda im: _stub_features(im, jnp),
        jax_evaluator.FIDEvaluator.stats_from_images(
            lambda im: _stub_features(im, jnp), refs, 5), batch_size=5)
    ref = FIDEvaluator.stats_from_images(
        lambda im: _stub_features(im, torch), refs, 5)
    np.testing.assert_allclose(ref.mu, jev.ref_stats.mu, rtol=1e-6)
    np.testing.assert_allclose(ref.sigma, jev.ref_stats.sigma, rtol=1e-5,
                               atol=1e-5 * np.abs(ref.sigma).max())
    pev = FIDEvaluator(lambda im: _stub_features(im, torch), ref,
                       batch_size=5)
    pool3, sm, spatial = pev.compute_activations(samples, want_softmax=True,
                                                 want_spatial=True)
    assert pool3.shape == (13, 16) and sm is None and spatial is None
    assert pev.cal_fid(samples) == pytest.approx(jev.cal_fid(samples),
                                                 rel=1e-5)
    # no logits and no spatial statistics: FID alone
    assert set(pev.cal_metrics(samples)) == {"fid"}
