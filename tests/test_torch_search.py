"""Search layer of the PyTorch port against the JAX package: the batched
FID fitness, the evolutionary search, and ``adt-torch search`` end to end
on the CPU.

The fitness comparison gives both packages the same stub sampler and
feature function (deterministic images from each candidate's payload, the
first pixels as features), so the FIDs differ only by the moment and
Frechet numerics: JAX accumulates in float32, the port in float64, and
both finish in float64, hence the 1e-4 relative tolerance.
"""

import json
import random as pyrandom

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.search import BatchedFIDFitness as JaxFitness
from autodiffusion_tpu.search import EvolutionSearcher as JaxSearcher
from autodiffusion_tpu.search import JointSpace as JaxJointSpace
from autodiffusion_tpu.search import TimestepSpace as JaxTimestepSpace
from autodiffusion_tpu.search import make_adm_fitness as jax_adm_fitness
from autodiffusion_tpu.search import to_uint8 as jax_to_uint8
from autodiffusion_tpu_torch.fid import FIDStats
from autodiffusion_tpu_torch.search import (BatchedFIDFitness,
                                            EvolutionSearcher, JointSpace,
                                            TimestepSpace, make_adm_fitness,
                                            to_uint8)
from autodiffusion_tpu_torch.utils import logger
from test_torch_package import one_torch_thread  # noqa: F401

PIX, FEAT = 4, 8


@pytest.fixture(autouse=True)
def _fresh_port_logger():
    """The port's logger is process-global: start and end each test
    without one, so no test writes into another's log directory."""
    logger.Logger.CURRENT = None
    yield
    if logger.Logger.CURRENT is not None:
        logger.Logger.CURRENT.close()
    logger.Logger.CURRENT = None


def _pattern(n, per_cand, batch_idx):
    """[n, PIX, PIX, 3] float pattern: varies with the sample's index
    inside its candidate's slice and with the batch, not with the
    candidate, so the candidates differ only by their base level."""
    j = (np.arange(n) % per_cand)[:, None, None, None]
    k = np.arange(PIX * PIX * 3).reshape(1, PIX, PIX, 3)
    return (0.3 * np.sin(0.7 * j + 0.11 * k * (j + 1)
                         + 1.3 * batch_idx)).astype(np.float32)


def _ref_stats():
    rng = np.random.RandomState(9)
    imgs = np.clip((rng.randn(64, PIX, PIX, 3) * 0.3 + 1) * 127.5, 0, 255)
    feats = imgs.astype(np.uint8).astype(np.float32).reshape(64, -1)
    return FIDStats.from_features(feats[:, :FEAT])


def _jax_fitness(**kw):
    def payload_fn(cand):
        return {"v": jnp.asarray([float(cand[0])])}

    def sample_fn(static, payload, rng, batch_idx):
        base = payload["v"][:, 0] / 1000.0 * 2 - 1
        n = base.shape[0]
        # batch_idx is traced: pick the host-made pattern by indexing
        pats = np.stack([_pattern(n, n // kw["candidate_chunk"], b)
                         for b in range(4)])
        return jax_to_uint8(base[:, None, None, None]
                            + jnp.asarray(pats)[batch_idx])

    def feature_fn(imgs):
        return {"pool3": imgs.astype(jnp.float32).reshape(
            imgs.shape[0], -1)[:, :FEAT]}

    return JaxFitness(payload_fn=payload_fn, sample_fn=sample_fn,
                      feature_fn=feature_fn, ref_stats=_ref_stats(),
                      feature_dim=FEAT, **kw)


def _port_fitness(**kw):
    def payload_fn(cand):
        return {"v": torch.tensor([float(cand[0])])}

    def sample_fn(payload, gen, batch_idx):
        base = payload["v"][:, 0] / 1000.0 * 2 - 1
        n = base.shape[0]
        pat = torch.from_numpy(_pattern(n, n // kw["candidate_chunk"],
                                        batch_idx))
        return to_uint8((base[:, None, None, None] + pat)
                        .permute(0, 3, 1, 2))

    def feature_fn(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :FEAT]}

    return BatchedFIDFitness(payload_fn=payload_fn, sample_fn=sample_fn,
                             feature_fn=feature_fn, ref_stats=_ref_stats(),
                             feature_dim=FEAT, device="cpu", **kw)


CANDS = [(500, 1), (450, 2), (990, 3), (700, 4), (120, 5)]


@pytest.mark.parametrize("device_frechet", [True, False])
def test_fitness_matches_jax_with_shared_stubs(device_frechet):
    kw = dict(num_samples=32, batch_size=16, candidate_chunk=3, seed=4)
    want = _jax_fitness(device_frechet=False, **kw)(CANDS)
    port = _port_fitness(device_frechet=device_frechet, **kw)
    got = port(CANDS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the FIDs order the candidates by their distance from the reference
    assert np.argsort(got).tolist() == np.argsort(want).tolist()
    # five candidates in chunks of three: two chunk evaluations, the
    # second padded
    assert port.get_state() == {"eval_count": 2}


def test_fitness_sample_count_split_and_state():
    # an explicit cap splits the batch evenly, as the JAX package does
    kw = dict(candidate_chunk=4, batch_size=100, num_samples=100)
    port = _port_fitness(max_device_batch=128, **kw)
    ref = _jax_fitness(max_device_batch=128, **kw)
    assert (port.device_batch, port.actual_samples) == \
        (ref.device_batch, ref.actual_samples) == (25, 100)
    # the port leaves the cap off by default
    assert _port_fitness(**kw).device_batch == 100
    uneven = _port_fitness(candidate_chunk=2, batch_size=6, num_samples=16)
    assert uneven.actual_samples == 18
    uneven.set_state({"eval_count": 7})
    assert uneven.get_state() == {"eval_count": 7}


def test_fitness_invalid_fid_guard():
    f = _port_fitness(num_samples=16, batch_size=16, candidate_chunk=2)
    f._device_frechet = lambda stats: np.array([-5.46, 1.0])
    with pytest.raises(FloatingPointError, match="invalid FID"):
        f([(500, 1), (450, 2)])
    f._device_frechet = lambda stats: np.array([np.nan, 1.0])
    with pytest.raises(FloatingPointError, match="invalid FID"):
        f([(500, 1), (450, 2)])
    f._device_frechet = lambda stats: np.array([-1e-4, 1.0])
    assert f([(500, 1), (450, 2)]) == [0.0, 1.0]


def _run_ea(searcher_cls, space, calls):
    target = np.array([10, 200, 400, 600, 800, 950])

    def fitness(cands):
        calls.extend(cands)
        return [float(np.abs(np.sort(np.array(
            c[0] if isinstance(c[0], tuple) else c)) - target[:len(
                c[0] if isinstance(c[0], tuple) else c)]).mean())
            for c in cands]

    s = searcher_cls(space, fitness, population_num=12, select_num=4,
                     mutation_num=5, crossover_num=4, max_epochs=3)
    best = s.search()
    return best, s.vis_dict


@pytest.mark.parametrize("space", ["timestep", "joint"])
def test_evolution_proposes_the_jax_stream(space):
    """Same seed, same fitness: the port's EA evaluates the same candidates
    in the same order and ends on the same best."""
    def make(cls_t, cls_j):
        if space == "timestep":
            return cls_t(1000, 6, rng=pyrandom.Random(0))
        return cls_j(1000, 20, 60, (0.0, 0.2), rng=pyrandom.Random(0))

    jc, pc = [], []
    jbest, jvis = _run_ea(JaxSearcher, make(JaxTimestepSpace, JaxJointSpace),
                          jc)
    pbest, pvis = _run_ea(EvolutionSearcher, make(TimestepSpace, JointSpace),
                          pc)
    assert len(pc) > 20
    assert pc == jc
    assert pvis == jvis
    assert pbest == jbest


def _tiny_port_models():
    from autodiffusion_tpu_torch.models import random_init_
    from autodiffusion_tpu_torch.models.unet import (EncoderUNetModel,
                                                     UNetModel)

    common = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
                  channel_mult=(1, 2), num_head_channels=16)
    m = random_init_(UNetModel(in_channels=3, out_channels=6,
                               num_classes=10, **common), 0).eval()
    c = random_init_(EncoderUNetModel(image_size=8, in_channels=3,
                                      out_channels=10,
                                      use_new_attention_order=False,
                                      **common), 1).eval()
    return m, c


def test_guided_adm_fitness_runs_on_cpu():
    """make_adm_fitness with a tiny UNet and classifier: guided DDIM-3 of
    two folded candidates, pixel features, finite FIDs."""
    m, c = _tiny_port_models()

    def feature_fn(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :16]}

    ref = FIDStats.from_features(
        np.random.RandomState(0).randn(50, 16) * 40 + 127)
    fit = make_adm_fitness(model=m, image_size=8, feature_fn=feature_fn,
                           ref_stats=ref, num_samples=4, batch_size=4,
                           classifier=c, num_classes=10, candidate_chunk=2,
                           feature_dim=16, device="cpu")
    fids = fit([(100, 500, 900), (50, 300, 700), (10, 20, 999)])
    assert len(fids) == 3 and all(np.isfinite(fids)) and min(fids) >= 0
    # the same candidate in the same chunk position reproduces its FID
    again = make_adm_fitness(model=m, image_size=8, feature_fn=feature_fn,
                             ref_stats=ref, num_samples=4, batch_size=4,
                             classifier=c, num_classes=10,
                             candidate_chunk=2, feature_dim=16,
                             device="cpu")
    assert again([(100, 500, 900), (50, 300, 700)]) == fids[:2]


def _saturating_eps(x_shape, t, chunk, lib):
    """A stub eps model for both packages: eps = -1e6 s, s = +-1 by a
    pattern of the sample's index in its candidate's slice, the pixel (of
    the NHWC ``x_shape``) and the timestep. Ancestral sampling's last step returns its clipped x0
    prediction exactly (the respaced step 0 has alphas_cumprod_prev = 1),
    and that is s itself, whatever x_T and the per-step noise were: the
    two packages' RNG streams differ, their images do not."""
    n = x_shape[0]
    j = (lib.arange(n) % (n // chunk)).reshape(n, 1)
    k = lib.arange(int(np.prod(x_shape[1:]))).reshape(1, -1)
    tt = t.reshape(n, 1)
    v = lib.sin(0.7 * j + 0.11 * k * (j + 1) + 0.013 * tt)
    return -1e6 * lib.where(v >= 0, 1.0, -1.0).reshape(x_shape)


def test_ancestral_adm_fitness_matches_jax_with_shared_stubs():
    """make_adm_fitness(use_ddim=False) in both packages with the same
    stub eps model and pixel features (learn_sigma False: FIXED_LARGE):
    the same images, so the FIDs agree to the moments' 1e-4."""
    chunk = 2

    class JaxStub:
        layer_num = 1

        def apply(self, params, x, t):
            return _saturating_eps(x.shape, t, chunk, jnp).astype(
                jnp.float32)

    class PortStub(torch.nn.Module):
        layer_num = 1

        def forward(self, x, t, y=None, keep_mask=None):
            n, c, h, w = x.shape
            return _saturating_eps((n, h, w, c), t, chunk, torch) \
                .permute(0, 3, 1, 2).float()

    def jax_features(imgs):
        return {"pool3": imgs.astype(jnp.float32).reshape(
            imgs.shape[0], -1)[:, :FEAT]}

    def port_features(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :FEAT]}

    kw = dict(image_size=PIX, ref_stats=_ref_stats(), num_samples=16,
              batch_size=8, num_classes=None, use_ddim=False,
              learn_sigma=False, candidate_chunk=chunk, feature_dim=FEAT)
    cands = [(0, 300, 700), (20, 500, 999), (100, 400, 800)]
    want = jax_adm_fitness(model=JaxStub(), params=None,
                           feature_fn=jax_features, **kw)(cands)
    got = make_adm_fitness(model=PortStub(), feature_fn=port_features,
                           device="cpu", **kw)(cands)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(np.round(got, 6))) == 3


def test_guided_ancestral_adm_fitness_runs_on_cpu():
    """make_adm_fitness(use_ddim=False) with a tiny UNet and classifier:
    guided ancestral sampling of two folded candidates, finite FIDs, the
    same FIDs again from the same seed."""
    m, c = _tiny_port_models()

    def feature_fn(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :16]}

    ref = FIDStats.from_features(
        np.random.RandomState(0).randn(50, 16) * 40 + 127)

    def fitness():
        return make_adm_fitness(model=m, image_size=8, feature_fn=feature_fn,
                                ref_stats=ref, num_samples=4, batch_size=4,
                                classifier=c, num_classes=10,
                                use_ddim=False, candidate_chunk=2,
                                feature_dim=16, device="cpu")

    fids = fitness()([(100, 500, 900), (50, 300, 700)])
    assert len(fids) == 2 and all(np.isfinite(fids)) and min(fids) >= 0
    assert fitness()([(100, 500, 900), (50, 300, 700)]) == fids


def test_cli_search_end_to_end_on_cpu(tmp_path, capsys):
    """``adt-torch search --device cpu``: a tiny UNet checkpoint, random
    Inception weights, reference statistics, one epoch."""
    from autodiffusion_tpu_torch.cli.main import main
    from autodiffusion_tpu_torch.fid import (inception_apply,
                                             load_fid_inception,
                                             synthesize_pt_inception)
    from autodiffusion_tpu_torch.models import (ModelConfig, create_model,
                                                random_init_)

    flags = dict(image_size=32, num_channels=32, num_res_blocks=1,
                 num_head_channels=16, attention_resolutions="16,8")
    m = random_init_(create_model(ModelConfig.adm64(**flags), device="cpu"),
                     0)
    torch.save(m.state_dict(), tmp_path / "model.pt")
    torch.save(synthesize_pt_inception(0), tmp_path / "incep.pth")
    inc = load_fid_inception(str(tmp_path / "incep.pth"), device="cpu")
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 32, 32, 3), dtype=np.uint8))
    FIDStats.from_features(inception_apply(inc, imgs)["pool3"].numpy()) \
        .save(str(tmp_path / "ref.npz"))

    argv = ["search", "--device", "cpu",
            "--model_path", str(tmp_path / "model.pt"),
            "--inception_path", str(tmp_path / "incep.pth"),
            "--ref_stats", str(tmp_path / "ref.npz"),
            "--save_dir", str(tmp_path / "run"), "--time_step", "2",
            "--num_samples", "2", "--batch_size", "2",
            "--candidate_chunk", "2", "--population_num", "2",
            "--select_num", "1", "--mutation_num", "1",
            "--crossover_num", "1", "--max_epochs", "1"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["best"]) == 2 and np.isfinite(out["fid"])
    with open(tmp_path / "run" / "ea_state.json") as f:
        fids = list(json.load(f)["vis_dict"].values())
    assert len(fids) >= 2 and all(np.isfinite(fids)) and min(fids) >= 0
