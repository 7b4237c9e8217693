"""The joint timestep + layer-skip search of the PyTorch port (stage 2 of
AutoDiffusion: ``search --use_dynamic_unet True``) against the JAX
package, on the CPU; and the routes of the guided step's attention sites.

The joint fitness folds several candidates, each with its own per-step
keep masks [K, L], into one batch: every row must take its own
candidate's mask. The comparison with JAX gives both packages one stub
eps model whose output depends on each row's keep mask (and saturates, so
the ancestral loop's last step returns the same images whatever the two
packages' RNG streams drew): the FIDs then differ only by the moment and
Frechet numerics, hence 1e-4 relative (tests/test_torch_search.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.search import make_adm_fitness as jax_adm_fitness
from autodiffusion_tpu_torch.fid import FIDStats
from autodiffusion_tpu_torch.ops.flash_attention import (FLASH_GATE_SDPA,
                                                         REPRO_KERNEL_SITES,
                                                         attention_route)
from autodiffusion_tpu_torch.search import make_adm_fitness
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_search import (FEAT, PIX, _fresh_port_logger,  # noqa: F401
                               _ref_stats, _tiny_port_models)

LAYERS = 6


def _masked_eps(x_shape, t, keep, chunk, lib):
    """eps = -1e6 s, s = +-1 by a pattern of the sample's index in its
    candidate's slice, the pixel (of the NHWC ``x_shape``), the timestep
    and the row's keep mask [n, LAYERS] (a weighted count of its kept
    layers): rows that keep other layers get other images."""
    n = x_shape[0]
    j = (lib.arange(n) % (n // chunk)).reshape(n, 1)
    k = lib.arange(int(np.prod(x_shape[1:]))).reshape(1, -1)
    m = (keep @ (lib.arange(1, LAYERS + 1) * 1.0)).reshape(n, 1)
    v = lib.sin(0.7 * j + 0.11 * k * (j + 1) + 0.013 * t.reshape(n, 1)
                + 0.29 * m)
    return -1e6 * lib.where(v >= 0, 1.0, -1.0).reshape(x_shape)


# three candidates of three steps: the first and the third share their
# timesteps and differ only by their skip lists (the last step, index 0,
# included), so only the masks can tell their images apart
JOINT_CANDS = [
    ((0, 300, 700), ((), (1,), (2, 3))),
    ((20, 500, 999), ((0,), (), (5,))),
    ((0, 300, 700), ((1, 4), (0,), ())),
]


def test_joint_adm_fitness_matches_jax_with_shared_stubs():
    """make_adm_fitness(joint=True) in both packages, the same stub eps
    model (ancestral, learn_sigma False) and pixel features, three joint
    candidates in chunks of two (the second chunk padded): the FIDs agree
    to 1e-4 relative, and the three differ, the two with the same
    timesteps by their masks alone."""
    chunk = 2

    class JaxStub:
        layer_num = LAYERS

        def apply(self, params, x, t, keep_mask=None):
            return _masked_eps(x.shape, t, keep_mask, chunk, jnp).astype(
                jnp.float32)

    class PortStub(torch.nn.Module):
        layer_num = LAYERS

        def forward(self, x, t, y=None, keep_mask=None):
            n, c, h, w = x.shape
            return _masked_eps((n, h, w, c), t, keep_mask, chunk, torch) \
                .permute(0, 3, 1, 2).float()

    def jax_features(imgs):
        return {"pool3": imgs.astype(jnp.float32).reshape(
            imgs.shape[0], -1)[:, :FEAT]}

    def port_features(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :FEAT]}

    kw = dict(image_size=PIX, ref_stats=_ref_stats(), num_samples=16,
              batch_size=8, num_classes=None, use_ddim=False,
              learn_sigma=False, joint=True, candidate_chunk=chunk,
              feature_dim=FEAT)
    want = jax_adm_fitness(model=JaxStub(), params=None,
                           feature_fn=jax_features, **kw)(JOINT_CANDS)
    got = make_adm_fitness(model=PortStub(), feature_fn=port_features,
                           device="cpu", **kw)(JOINT_CANDS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(np.round(got, 6))) == 3


def _pixel_fitness(m, c, **kw):
    def feature_fn(imgs):
        return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :16]}

    ref = FIDStats.from_features(
        np.random.RandomState(0).randn(50, 16) * 40 + 127)
    return make_adm_fitness(model=m, image_size=8, feature_fn=feature_fn,
                            ref_stats=ref, num_samples=4, batch_size=4,
                            classifier=c, num_classes=10, joint=True,
                            candidate_chunk=2, feature_dim=16,
                            device="cpu", **kw)


def test_joint_fitness_keeps_each_candidates_mask_on_its_rows():
    """The guided joint fitness with a tiny UNet and classifier: a chunk
    [A, B] and a chunk [B, B] from fresh fitness objects draw the same
    labels and noise, so B's rows (the second slot) give the same FID in
    both only if each candidate's keep masks reach its own rows; A and B
    (the same timesteps, other skip lists) give other FIDs."""
    m, c = _tiny_port_models()
    L = m.layer_num
    ts = (100, 500, 900)
    a = (ts, ((0,), (), (L - 1,)))
    b = (ts, ((1, 2), (3,), ()))
    f_ab = _pixel_fitness(m, c)([a, b])
    f_bb = _pixel_fitness(m, c)([b, b])
    assert all(np.isfinite(f_ab + f_bb)) and min(f_ab + f_bb) >= 0
    assert f_ab[1] == f_bb[1]
    assert f_ab[0] != f_ab[1]
    # no skipped layer: yet another image set
    assert _pixel_fitness(m, c)([(ts, ((), (), ())), b])[0] not in f_ab


@pytest.mark.parametrize("t,heads", [(1024, 4), (256, 6), (64, 8)])
def test_classifier_gradient_sites_take_the_kernels(monkeypatch, t, heads):
    """The guided step's classifier sites (head dim 64, the input's
    gradient wanted) are off the flash gate: on the card they take the
    flash forward, dQ and dK/dV kernels, whose runs repeat bit for bit,
    not SDPA. The training steps' sites (the same shapes with 6, 9 and 12
    heads, and the SR step's) stay on SDPA."""
    monkeypatch.delenv("ADT_FLASH_GATE", raising=False)
    site = (t, t, 64, heads, True)
    assert site in REPRO_KERNEL_SITES
    assert site not in FLASH_GATE_SDPA
    for dev in ("cuda", "meta", "cpu"):
        assert attention_route(*site, dev) == "kernel"
    train = {1024: 6, 256: 9, 64: 12}[t]
    assert attention_route(t, t, 64, train, True, "cuda") == "sdpa"
    assert attention_route(t, t, 64, train, True, "meta") == "sdpa"


def test_repro_sites_are_the_guided_classifiers_gradient_sites(monkeypatch):
    """REPRO_KERNEL_SITES is the full-width ADM-64 classifier's sites with
    the input's gradient, read on the meta device where each asks for its
    route (4 at T 1024, 4 at T 256, 5 at T 64), and none of them is on the
    flash gate: a change of the classifier's widths shows here."""
    import sys

    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                create_classifier)

    fa = sys.modules["autodiffusion_tpu_torch.ops.flash_attention"]
    sites = {}

    def record(key, route, q, k, v, tokens_first):
        sites[key] = sites.get(key, 0) + 1
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "_attend", record)
    with torch.device("meta"):
        clf = create_classifier(ClassifierConfig.adm64(), device="meta")
    clf.requires_grad_(False)
    clf(torch.empty(1, 3, 64, 64, device="meta", requires_grad=True),
        torch.zeros(1, device="meta"))
    assert sites == {(1024, 1024, 64, 4, True): 4,
                     (256, 256, 64, 6, True): 4, (64, 64, 64, 8, True): 5}
    assert set(sites) == REPRO_KERNEL_SITES
    assert not REPRO_KERNEL_SITES & FLASH_GATE_SDPA


def test_cli_joint_search_end_to_end_on_cpu(tmp_path, capsys):
    """``adt-torch search --device cpu --use_dynamic_unet True``: a tiny
    UNet checkpoint, random Inception weights, a budget of two steps'
    layers (--index_step), one epoch with the progressive hook (which
    keeps the skip range at (0, 0) in the first epochs): every candidate
    two steps within the budget, the best printed as timesteps and skip
    lists, the FIDs finite."""
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
    budget = 2 * m.layer_num
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
            "--save_dir", str(tmp_path / "run"),
            "--use_dynamic_unet", "True", "--index_step", str(budget),
            "--max_prun", "0.1", "--min_prun", "0.0",
            "--num_samples", "2", "--batch_size", "2",
            "--candidate_chunk", "2", "--population_num", "2",
            "--select_num", "1", "--mutation_num", "1",
            "--crossover_num", "1", "--max_epochs", "1"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["best"]["timesteps"]) == 2
    assert out["best"]["skip_layers"] == [[], []]
    assert np.isfinite(out["fid"])
    with open(tmp_path / "run" / "ea_state.json") as f:
        state = json.load(f)
    fids = list(state["vis_dict"].values())
    assert len(fids) >= 2 and all(np.isfinite(fids)) and min(fids) >= 0
    with open(tmp_path / "run" / "log.txt") as f:
        cands = [line for line in f if line.startswith("cand: {")]
    assert len(cands) == len(fids)
