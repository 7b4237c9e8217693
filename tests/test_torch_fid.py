"""FID pieces of the PyTorch port against the JAX package: the Inception
feature extractor, its preprocessing and checkpoint folding, the streamed
moments and the Frechet distances.

Tolerances:
  Inception outputs  1e-4 of the largest |value| (float32 through ~100
                     convolutions summed in other orders)
  preprocess         1e-5 absolute (the same bilinear weights in float32)
  BN folding         1e-6 relative (the port folds in float64, JAX in
                     float32)
  moments            1e-5 relative (JAX accumulates in float32, the port in
                     float64)
  Frechet            1e-8 relative against JAX's float64 host path; 1e-5
                     absolute where the port truncates to the rank n - 1
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.fid import inception as jax_inception
from autodiffusion_tpu.fid import stats as jax_stats
from autodiffusion_tpu_torch.fid import (FeatureStats, FIDInceptionV3,
                                         FIDStats, accumulate_stats,
                                         finalize_stats, fold_pt_inception,
                                         frechet_distance_eigh,
                                         inception_apply, load_fid_inception,
                                         make_device_frechet, preprocess,
                                         synthesize_pt_inception)
from autodiffusion_tpu_torch.models.convert import \
    inception_state_dict_from_flax
from test_torch_package import one_torch_thread  # noqa: F401


def _he_params(seed, size=75):
    """Values for the tree ``random_params(size=size)`` returns (its shapes
    by eval_shape): He-scaled kernels and small biases, so activations keep
    their scale through the ReLU stack."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda: jax_inception.random_params(jax.random.key(0), size))

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            fan_in = np.prod(leaf.shape[:-1])
            return (rng.randn(*leaf.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_inception_matches_jax_at_75px():
    params = _he_params(0)
    model = FIDInceptionV3()
    model.load_state_dict(inception_state_dict_from_flax(params), strict=True)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 75, 75, 3)) \
        .astype(np.float32)
    want = jax.jit(jax_inception.FIDInceptionV3().apply)(params,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for key in ("pool3", "logits", "spatial"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        if key == "spatial":
            w = w.transpose(0, 3, 1, 2)
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    assert got["pool3"].shape == (2, 2048)
    assert float(got["pool3"].abs().max()) > 1e-2   # not a vanishing net


@pytest.mark.parametrize("size", [75, 299])
def test_preprocess_matches_jax(size):
    imgs = np.random.RandomState(2).randint(0, 256, (3, 64, 64, 3),
                                            dtype=np.uint8)
    want = np.asarray(jax_inception.preprocess(jnp.asarray(imgs), size))
    got = preprocess(torch.from_numpy(imgs), size).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5,
                               rtol=0)


def test_bn_folding_matches_jax_loader(tmp_path):
    """A pytorch_fid-layout checkpoint folds to the same convs in both
    packages (BN eps 1e-3), and the port loads it strictly."""
    path = str(tmp_path / "pt_inception.pth")
    sd = synthesize_pt_inception(3)
    torch.save(sd, path)
    via_jax = inception_state_dict_from_flax(
        jax_inception.load_fid_inception_params(path))
    folded = fold_pt_inception(sd)
    assert set(folded) == set(via_jax) == set(FIDInceptionV3().state_dict())
    for key, want in via_jax.items():
        np.testing.assert_allclose(folded[key].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    model = load_fid_inception(path, device="cpu")
    imgs = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, 75, 75, 3), dtype=np.uint8))
    feats = inception_apply(model, imgs, resize_to=75)["pool3"]
    assert feats.shape == (2, 2048) and torch.isfinite(feats).all()


def _features(seed, n, d=16, offset=0.0):
    rng = np.random.RandomState(seed)
    mix = rng.randn(d, d) / np.sqrt(d)
    return (rng.randn(n, d) @ mix * 3.0 + 40.0 + offset).astype(np.float32)


def test_streamed_moments_match_jax():
    feats = _features(5, 96)
    shift = feats[:10].mean(0).astype(np.float64)
    st = FeatureStats.zeros(16)
    jst = jax_stats.FeatureStats.zeros(16)
    for chunk in np.split(feats, 3):
        st = accumulate_stats(st, torch.from_numpy(chunk),
                              torch.from_numpy(shift))
        jst = jax_stats.accumulate_stats(jst, jnp.asarray(chunk),
                                         jnp.asarray(shift, jnp.float32))
    got = finalize_stats(st, shift)
    want = jax_stats.finalize_stats(jst, shift)
    exact = FIDStats.from_features(feats)
    np.testing.assert_allclose(got.mu, want.mu, rtol=1e-5)
    np.testing.assert_allclose(got.sigma, want.sigma, rtol=1e-5,
                               atol=1e-5 * np.abs(want.sigma).max())
    # float64 streaming is np.cov to rounding
    np.testing.assert_allclose(got.mu, exact.mu, rtol=1e-12)
    np.testing.assert_allclose(got.sigma, exact.sigma, rtol=1e-10,
                               atol=1e-10)


def test_fid_stats_npz_interchange(tmp_path):
    s = FIDStats.from_features(_features(6, 30))
    path = str(tmp_path / "ref.npz")
    s.save(path)
    j = jax_stats.FIDStats.load(path)
    np.testing.assert_array_equal(j.mu, s.mu)
    np.testing.assert_array_equal(j.sigma, s.sigma)
    back = FIDStats.load(path)
    np.testing.assert_array_equal(back.sigma, s.sigma)


@pytest.mark.parametrize("n", [40, 10])
def test_device_frechet_matches_jax_host_eigh(n):
    """Per-candidate FIDs from moments centred on the reference mean, as
    the fitness accumulates them, against JAX's host float64 eigh
    Frechet. At n = 10 < D = 16 the port keeps only the top n - 1
    eigenvalues; what it drops is eigensolver noise."""
    ref = FIDStats.from_features(_features(7, 64))
    cands = [_features(8, n, offset=0.5), _features(9, n, offset=3.0)]
    shift = torch.from_numpy(ref.mu)
    stats = FeatureStats.zeros(16, (2,))
    for c, f in enumerate(cands):
        one = accumulate_stats(FeatureStats.zeros(16),
                               torch.from_numpy(f), shift)
        stats = FeatureStats(stats.n.index_put((torch.tensor(c),), one.n),
                             stats.s1.index_put((torch.tensor(c),), one.s1),
                             stats.s2.index_put((torch.tensor(c),), one.s2))
    got = make_device_frechet(ref, "cpu")(stats)
    want = [jax_stats.frechet_distance_eigh(
        jax_stats.FIDStats.from_features(f), jax_stats.FIDStats(*ref))
        for f in cands]
    assert got.dtype == np.float64 and got.shape == (2,)
    if n > 16:
        np.testing.assert_allclose(got, want, rtol=1e-8)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[0] < want[1]


def test_host_frechet_matches_jax_and_sqrtm():
    a = FIDStats.from_features(_features(10, 50))
    b = FIDStats.from_features(_features(11, 50, offset=1.0))
    got = frechet_distance_eigh(a, b)
    assert got == pytest.approx(jax_stats.frechet_distance_eigh(
        jax_stats.FIDStats(*a), jax_stats.FIDStats(*b)), rel=1e-12)
    assert got == pytest.approx(jax_stats.frechet_distance(
        jax_stats.FIDStats(*a), jax_stats.FIDStats(*b)), rel=1e-6)
