"""The port's data parallelism on the CPU: two processes over gloo.

One spawn of two ranks (``parallel.setup_dist`` given a localhost
coordinator, ``--device cpu``, so gloo) runs every phase below once and
saves each rank's results; each test reads one phase. What two ranks give
is held to the port's own one-process run of the same global batch in
this process, and that run to the JAX package in-process where the JAX
package has the function (jax.distributed takes about 30 s a process to
start, and its own two-process tests are marked slow). The phases live in
this module so that the workers (``worker_main``, which imports no JAX)
and the tests build the same models and inputs.

Tolerances:
  * train and classifier steps, world 2 against world 1 (the JAX
    package's two-process test): losses and metrics rtol 2e-5, parameters
    atol 1e-6; the ranks' losses and parameters are equal. An element
    whose gradient is float32 noise on both sides (at most 1e-6 of the
    model's largest |gradient|: the biases a one-channel GroupNorm group
    removes) moves by a random fraction of the lr under Adam, so those
    are held to 2.5 x lr, the bound of one Adam update;
  * train and classifier steps against the JAX package: the tolerances of
    tests/test_torch_train.py (metrics 2e-4 relative; parameters after
    AdamW within 2e-3 x lr but for 1e-3 of the elements, all within
    2.5 x lr);
  * FIDs: the two ranks equal, each within rtol 1e-4 of world 1 (the JAX
    package's two-process fitness tests);
  * the sample .npz, the gathers, the sampler history, the broadcast
    parameters, the batch slices and the tensor-parallel plan: equal.
"""

import os
import random
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodiffusion_tpu_torch.cli.main import main
from autodiffusion_tpu_torch.fid import FIDStats
from autodiffusion_tpu_torch.models import (AutoencoderKL, ModelConfig,
                                            SDUNetModel, create_model,
                                            random_init_)
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.parallel import (all_gather_host, barrier,
                                              data_sharder, make_mesh,
                                              param_shardings, rank,
                                              replicate, setup_dist,
                                              shard_batch, world_size)
from autodiffusion_tpu_torch.schedules import build_base_tables
from autodiffusion_tpu_torch.search import (TimestepSpace, make_adm_fitness,
                                            make_sd_fitness)
from autodiffusion_tpu_torch.train import (LossSecondMomentResampler,
                                           create_train_state,
                                           make_classifier_train_step,
                                           make_train_step)
from test_torch_package import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
IMG, FIT_IMG, BATCH, NUM_CLASSES = 16, 8, 4, 10
UNET = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
            channel_mult=(1, 2), num_head_channels=16,
            use_scale_shift_norm=True, resblock_updown=True)
CLASSIFIER = dict(model_channels=32, num_res_blocks=1, attention_ds=(2,),
                  channel_mult=(1, 2), num_head_channels=32,
                  use_scale_shift_norm=True, resblock_updown=True)
SD_UNET = dict(in_channels=4, model_channels=32, out_channels=4,
               num_res_blocks=1, attention_ds=(1, 2), channel_mult=(1, 2),
               num_heads=2, context_dim=16)
TINY = dict(image_size=32, num_channels=32, num_res_blocks=1,
            num_head_channels=16, attention_resolutions="16,8")
TRAIN_LR, CLS_LR = 1e-4, 3e-4
WORKER_TIMEOUT = 240


# ------------------------------------------------------------- the phases

def _unet(seed=0):
    return random_init_(UNetModel(
        in_channels=3, out_channels=6, num_classes=NUM_CLASSES,
        use_new_attention_order=True, **UNET), seed).train()


def _classifier(seed=1, image_size=IMG):
    return random_init_(EncoderUNetModel(
        image_size=image_size, in_channels=3, out_channels=NUM_CLASSES,
        use_new_attention_order=False, **CLASSIFIER), seed).train()


def _linear_with_buffer(seed):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    m[1].running_mean.fill_(float(seed))
    return m


def _basics(mesh):
    out = {"world": world_size(), "rank": rank()}
    if rank() == 1:
        time.sleep(0.5)
    out["arrived"] = time.time()
    barrier("basics")
    out["left"] = time.time()
    out["gather"] = all_gather_host(
        np.array([rank() * 10 + 1, rank() * 10 + 2], np.int32))
    sampler = LossSecondMomentResampler(10, history_per_term=2)
    sampler.update_with_local_losses(np.array([rank(), rank() + 5]),
                                      np.array([1.0 + rank(), 2.0 + rank()]))
    out["loss_counts"] = sampler._loss_counts.copy()
    out["loss_history"] = sampler._loss_history.copy()
    out["replicated"] = replicate(mesh, _linear_with_buffer(rank())) \
        .state_dict()
    out["shard"] = shard_batch(mesh, {"x": np.arange(8).reshape(4, 2),
                                      "s": np.float32(3),
                                      "t": [torch.arange(6)]})
    try:
        data_sharder(mesh)(np.zeros(3))
    except ValueError as e:
        out["indivisible"] = str(e)
    plan = param_shardings(make_mesh(model_parallel=2), _unet(),
                           min_weight_size=1024)
    out["tp_mesh"] = make_mesh(model_parallel=2).shape
    out["tp_sharded"] = sorted(n for n, p in plan.items()
                               if "Shard" in repr(p[1]))
    return out


def _capture_grads(state):
    """Record the gradients each update applies in ``state.grads``."""
    apply = state.apply_gradients

    def capture(grads):
        state.grads = [g.detach().clone() for g in grads]
        apply(grads)

    state.apply_gradients = capture
    return state


def _train_step(inputs, shard, micro=1):
    """One update of the tiny UNet (microbatches of ``micro`` rows, lr
    anneal, weight decay, an EMA) on the global batch of ``inputs``."""
    pm = _unet()
    state = _capture_grads(create_train_state(
        pm, lr=TRAIN_LR, weight_decay=0.05, ema_rates=(0.9,),
        lr_anneal_steps=4))
    local = BATCH // (1 if shard is None else shard.size)
    step = make_train_step(pm, microbatches=local // micro, class_cond=True,
                           data_sharder=shard)
    x, y, t, w, noise = (torch.from_numpy(inputs[k])
                         for k in ("x", "y", "t", "w", "noise"))
    _, metrics = step(state, build_base_tables("cosine", 1000),
                      {"x": x, "y": y}, t, w, noise=noise)
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "params": {n: p.detach().clone()
                       for n, p in pm.named_parameters()},
            "ema": {n: e.clone() for n, e in state.ema_state_dict(0).items()},
            "grads": dict(zip(state.names, state.grads))}


def _classifier_step(inputs, shard):
    pm = _classifier()
    state = _capture_grads(create_train_state(pm, lr=CLS_LR,
                                              weight_decay=0.05,
                                              ema_rates=()))
    x, y, t, noise = (torch.from_numpy(inputs[k])
                      for k in ("x", "y", "t", "cls_noise"))
    _, metrics = make_classifier_train_step(pm, data_sharder=shard)(
        state, build_base_tables("cosine", 1000), {"x": x, "y": y}, t,
        noise=noise)
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "params": {n: p.detach().clone()
                       for n, p in pm.named_parameters()},
            "grads": dict(zip(state.names, state.grads))}


def _features(imgs):
    return {"pool3": imgs.float().reshape(imgs.shape[0], -1)[:, :8]}


def _ref():
    return FIDStats.from_features(
        np.random.RandomState(2).randn(100, 8) * 40 + 127)


def _candidates(k):
    space = TimestepSpace(1000, k, rng=random.Random(1))
    return [space.random() for _ in range(2)]


def _adm_fids(shard, use_ddim):
    """One chunk of two candidates, guided by the classifier: 16 samples
    a candidate in two batches of 8."""
    unet = _unet(5).eval()
    clf = _classifier(6, FIT_IMG).eval()
    fitness = make_adm_fitness(
        model=unet, image_size=FIT_IMG, feature_fn=_features,
        ref_stats=_ref(), num_samples=16, batch_size=8, classifier=clf,
        classifier_scale=2.0, num_classes=NUM_CLASSES, use_ddim=use_ddim,
        candidate_chunk=2, seed=3, feature_dim=8, device="cpu",
        shard_fn=shard)
    return fitness(_candidates(4))


def _sd_fids(shard):
    unet = random_init_(SDUNetModel(**SD_UNET), 7).eval()
    vae = random_init_(AutoencoderKL(ch=32, ch_mult=(1, 2),
                                     num_res_blocks=1), 8).eval()
    gen = torch.Generator().manual_seed(9)
    bank = torch.randn(5, 7, 16, generator=gen)
    proj = torch.randn(3, 8, generator=gen)

    def features(imgs):
        x = imgs.float().mean(dim=(1, 2)) / 255.0
        return {"pool3": torch.tanh(x @ proj) * 40}

    fitness = make_sd_fitness(
        unet=unet, vae=vae, context_bank=bank, uncond_context=bank[0] * 0,
        feature_fn=features, ref_stats=FIDStats(np.zeros(8), np.eye(8)),
        num_samples=16, batch_size=8, sampler="plms", latent_hw=8,
        candidate_chunk=2, seed=3, feature_dim=8, device="cpu",
        shard_fn=shard)
    return fitness(_candidates(3))


def _sample_argv(d, out):
    """``adt-torch sample``: ancestral over three steps (a z drawn every
    step), 5 samples in global batches of 2 (the last cut)."""
    argv = ["sample", "--device", "cpu", "--model_path",
            os.path.join(d, "model.pt"), "--use_timestep", "[100, 500, 900]",
            "--num_samples", "5", "--batch_size", "2", "--seed", "3",
            "--use_ddim", "False", "--out", os.path.join(d, out)]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    return argv


def worker_main(pid: int, addr: str, d: str) -> None:
    """One rank of the two-process run: every phase, its results saved to
    ``d/rank{pid}.pt``."""
    torch.set_num_threads(1)
    setup_dist(addr, 2, pid, device="cpu")
    mesh = make_mesh()
    shard = data_sharder(mesh)
    with np.load(os.path.join(d, "inputs.npz")) as z:
        inputs = dict(z)
    res = {"basics": _basics(mesh),
           "train": _train_step(inputs, shard),
           "classifier": _classifier_step(inputs, shard),
           "fid_ddim": _adm_fids(shard, True),
           "fid_ancestral": _adm_fids(shard, False),
           "fid_sd": _sd_fids(shard)}
    assert main(_sample_argv(d, "world2.npz")) == 0
    torch.save(res, os.path.join(d, f"rank{pid}.pt"))
    barrier("end")


WORKER = ("import sys\n"
          "import test_torch_parallel as T\n"
          "T.worker_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])\n")


# ----------------------------------------------------------- the two ranks

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs (the JAX steps' noise, drawn from their keys, so that
    the port's steps can be held to JAX's), the sample checkpoint, then
    one spawn of two ranks; returns (directory, [rank 0's, rank 1's
    results])."""
    import jax

    d = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.RandomState(10)
    x = (rng.randint(0, 256, (BATCH, 3, IMG, IMG)) / 127.5 - 1).astype(
        np.float32)
    # the JAX train step splits its key over the microbatches (one row
    # each here) and draws each microbatch's noise from its key
    noise = np.concatenate([
        np.asarray(jax.random.normal(r, (1, IMG, IMG, 3)))
        for r in jax.random.split(jax.random.key(7), BATCH)])
    cls_noise = np.asarray(jax.random.normal(jax.random.key(3),
                                             (BATCH, IMG, IMG, 3)))
    np.savez(os.path.join(d, "inputs.npz"), x=x,
             y=rng.randint(0, NUM_CLASSES, BATCH),
             t=rng.randint(0, 1000, BATCH),
             w=(0.5 + rng.rand(BATCH)).astype(np.float32),
             noise=noise.transpose(0, 3, 1, 2).copy(),
             cls_noise=cls_noise.transpose(0, 3, 1, 2).copy())
    torch.save(random_init_(create_model(ModelConfig.adm64(**TINY),
                                         device="cpu"), 0).state_dict(),
               os.path.join(d, "model.pt"))
    with open(os.path.join(d, "worker.py"), "w") as f:
        f.write(WORKER)

    sock = socket.socket()
    sock.bind(("localhost", 0))
    addr = f"localhost:{sock.getsockname()[1]}"
    sock.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(d, "worker.py"), str(i), addr, d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    return d, [torch.load(os.path.join(d, f"rank{i}.pt"),
                          weights_only=False) for i in range(2)]


@pytest.fixture(scope="module")
def inputs(run):
    with np.load(os.path.join(run[0], "inputs.npz")) as z:
        return dict(z)


def test_world_size_and_rank(run):
    assert [(r["basics"]["world"], r["basics"]["rank"]) for r in run[1]] \
        == [(2, 0), (2, 1)]


def test_world_size_and_rank_without_a_group():
    assert (world_size(), rank()) == (1, 0)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    x = np.arange(6)
    np.testing.assert_array_equal(data_sharder(mesh)(x), x)
    assert all_gather_host(x) is x            # JAX's one-process identity


def test_barrier(run):
    """Rank 1 comes half a second late; rank 0 leaves only after it
    came (one host, one clock)."""
    r0, r1 = (r["basics"] for r in run[1])
    assert r0["left"] >= r1["arrived"] > r0["arrived"]


def test_all_gather_host_shape_and_dtype(run):
    for r in run[1]:
        g = r["basics"]["gather"]
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        assert g.shape == (2, 2) and g.tolist() == [[1, 2], [11, 12]]


def test_resampler_sees_both_ranks_rows(run):
    for r in run[1]:
        counts = r["basics"]["loss_counts"]
        for t in (0, 1, 5, 6):
            assert counts[t] == 1, (t, counts)
        assert counts.sum() == 4
    np.testing.assert_array_equal(run[1][0]["basics"]["loss_history"],
                                  run[1][1]["basics"]["loss_history"])


def test_replicate_takes_rank_0s_parameters_and_buffers(run):
    want = _linear_with_buffer(0).state_dict()
    assert not torch.equal(want["0.weight"],
                           _linear_with_buffer(1).state_dict()["0.weight"])
    for r in run[1]:
        got = r["basics"]["replicated"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_shard_batch_slices_and_refuses_an_indivisible_batch(run):
    for i, r in enumerate(run[1]):
        s = r["basics"]["shard"]
        np.testing.assert_array_equal(
            s["x"], np.arange(8).reshape(4, 2)[2 * i:2 * i + 2])
        assert s["s"] == np.float32(3)
        assert torch.equal(s["t"][0], torch.arange(6)[3 * i:3 * i + 3])
        assert "batch of 3 does not divide over the 2" in \
            r["basics"]["indivisible"]


def _assert_update_close(got, want, grads, lr):
    """Parameters after one update within atol 1e-6, but where the
    gradient was float32 noise (see the module's docstring): within
    2.5 x lr there."""
    gmax = max(float(g.abs().max()) for g in grads.values())
    for n, w in want.items():
        noise = grads[n].abs() <= 1e-6 * gmax
        diff = (got[n] - w).abs()
        assert float(torch.where(noise, 0.0, diff).max()) <= 1e-6, n
        assert float(torch.where(noise, diff, 0.0).max()) <= 2.5 * lr, n


def test_train_step_world_2_equals_world_1(run, inputs):
    r0, r1 = (r["train"] for r in run[1])
    assert float(r0["metrics"]["loss"]) == float(r1["metrics"]["loss"])
    assert float(r0["metrics"]["grad_norm"]) == \
        float(r1["metrics"]["grad_norm"])
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
    one = _train_step(inputs, None)
    for k in ("loss", "mse", "vb", "grad_norm"):
        np.testing.assert_allclose(float(r0["metrics"][k]),
                                   float(one["metrics"][k]), rtol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        torch.cat([r0["metrics"]["per_example_loss"],
                   r1["metrics"]["per_example_loss"]]).numpy(),
        one["metrics"]["per_example_loss"].numpy(), rtol=2e-5)
    start = _unet().state_dict()
    for what in ("params", "ema"):
        _assert_update_close(r0[what], one[what], one["grads"], TRAIN_LR)
    moved = max(float((one["params"][n] - start[n]).abs().max())
                for n in start)
    assert moved > 100 * 1e-6


def _jax_unet():
    from autodiffusion_tpu.models import UNetModel as JaxUNet

    return JaxUNet(out_channels=6, num_classes=NUM_CLASSES,
                   use_new_attention_order=True, **UNET)


def test_train_step_equals_jax(run, inputs):
    """The two ranks' update equals the JAX package's make_train_step on
    the same global batch, weights and noise."""
    import jax
    import jax.numpy as jnp

    from autodiffusion_tpu.models.convert import convert_unet
    from autodiffusion_tpu.schedules import build_base_tables as jax_tables
    from autodiffusion_tpu.train.state import create_train_state as jstate
    from autodiffusion_tpu.train.state import make_train_step as jstep
    from test_torch_train import _assert_params_close

    jm = _jax_unet()
    params = convert_unet({n: v.numpy() for n, v in
                           _unet().state_dict().items()}, jm)
    state = jstate(params, lr=TRAIN_LR, weight_decay=0.05, ema_rates=(0.9,),
                   lr_anneal_steps=4)
    state, want = jax.jit(jstep(jm.apply, microbatches=BATCH,
                                class_cond=True))(
        state, jax_tables("cosine", 1000),
        {"x": jnp.asarray(inputs["x"].transpose(0, 2, 3, 1)),
         "y": jnp.asarray(inputs["y"])}, jnp.asarray(inputs["t"]),
        jnp.asarray(inputs["w"]), jax.random.key(7))
    got = run[1][0]["train"]
    for k in ("loss", "mse", "vb", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]),
                                   float(want[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    for port, jax_tree in (("params", state.params),
                           ("ema", state.ema_params[0])):
        sd = {n: v.numpy() for n, v in got[port].items()}
        _assert_params_close(convert_unet(sd, jm), jax_tree,
                             2e-3 * TRAIN_LR, TRAIN_LR)


def test_classifier_step_world_2_equals_world_1_and_jax(run, inputs):
    import jax
    import jax.numpy as jnp

    from autodiffusion_tpu.models import EncoderUNetModel as JaxEncoder
    from autodiffusion_tpu.models.convert import convert_classifier
    from autodiffusion_tpu.schedules import build_base_tables as jax_tables
    from autodiffusion_tpu.train.classifier import \
        make_classifier_train_step as jax_classifier_step
    from autodiffusion_tpu.train.state import create_train_state as jstate
    from test_torch_train import _assert_params_close

    r0, r1 = (r["classifier"] for r in run[1])
    for k in r0["metrics"]:
        if k != "per_example_loss":
            assert float(r0["metrics"][k]) == float(r1["metrics"][k]), k
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
    one = _classifier_step(inputs, None)
    for k in ("loss", "grad_norm", "acc@1", "acc@5"):
        np.testing.assert_allclose(float(r0["metrics"][k]),
                                   float(one["metrics"][k]), rtol=2e-5,
                                   err_msg=k)
    _assert_update_close(r0["params"], one["params"], one["grads"], CLS_LR)

    jm = JaxEncoder(out_channels=NUM_CLASSES, use_new_attention_order=False,
                    pool="attention", **CLASSIFIER)
    params = convert_classifier({n: v.numpy() for n, v in
                                 _classifier().state_dict().items()}, jm)
    state, want = jax.jit(jax_classifier_step(jm.apply))(
        jstate(params, lr=CLS_LR, weight_decay=0.05, ema_rates=()),
        jax_tables("cosine", 1000),
        {"x": jnp.asarray(inputs["x"].transpose(0, 2, 3, 1)),
         "y": jnp.asarray(inputs["y"])}, jnp.asarray(inputs["t"]),
        jax.random.key(3))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(r0["metrics"][k]), float(want[k]),
                                   rtol=2e-4, err_msg=k)
    for k in ("acc@1", "acc@5"):
        assert float(r0["metrics"][k]) == float(want[k]), k
    sd = {n: v.numpy() for n, v in r0["params"].items()}
    _assert_params_close(convert_classifier(sd, jm), state.params,
                         2e-3 * CLS_LR, CLS_LR)


@pytest.mark.parametrize("phase", ["fid_ddim", "fid_ancestral", "fid_sd"])
def test_fitness_chunk_world_2_equals_world_1(run, phase):
    """Guided DDIM and guided ancestral chunks of the ADM fitness and a
    PLMS chunk of the SD fitness, two candidates folded: both ranks give
    the same FIDs, those of one process."""
    f0, f1 = (r[phase] for r in run[1])
    assert f0 == f1
    one = {"fid_ddim": lambda: _adm_fids(None, True),
           "fid_ancestral": lambda: _adm_fids(None, False),
           "fid_sd": lambda: _sd_fids(None)}[phase]()
    assert len(one) == 2 and one[0] != one[1]
    np.testing.assert_allclose(f0, one, rtol=1e-4)


def test_sample_world_2_equals_world_1(run):
    d = run[0]
    assert main(_sample_argv(d, "world1.npz")) == 0
    with np.load(os.path.join(d, "world2.npz")) as a, \
            np.load(os.path.join(d, "world1.npz")) as b:
        assert a.files == b.files == ["arr_0", "arr_1"]
        assert a["arr_0"].shape == (5, 32, 32, 3)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_param_shardings_match_jax(run):
    """At a model axis of 2, the port's plan shards exactly the parameters
    whose flax counterparts the JAX package's param_shardings shards (the
    counterparts found by carrying each parameter's index through the
    converter)."""
    import jax

    from autodiffusion_tpu.models.convert import convert_unet
    from autodiffusion_tpu.parallel import make_mesh as jax_mesh
    from autodiffusion_tpu.parallel import param_shardings as jax_plan

    got = run[1][0]["basics"]
    assert got["tp_mesh"] == {"data": 1, "model": 2}
    names = [n for n, _ in _unet().named_parameters()]
    marked = {n: np.full(p.shape, i + 1, np.float32)
              for i, (n, p) in enumerate(_unet().named_parameters())}
    tree = convert_unet(marked, _jax_unet())
    plan = jax_plan(jax_mesh(model_parallel=2, devices=jax.devices()[:2]),
                    tree["params"], min_weight_size=1024)
    want = sorted(
        names[int(np.asarray(leaf).flat[0]) - 1]
        for leaf, s in zip(jax.tree_util.tree_leaves(tree["params"]),
                           jax.tree_util.tree_leaves(plan))
        if "model" in str(s.spec))
    assert want and got["tp_sharded"] == want
    assert run[1][1]["basics"]["tp_sharded"] == want


# ------------------------------------------------- set-up without a spawn

TORCHRUN_ENV = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}


def test_setup_dist_is_a_no_op_in_one_process(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    setup_dist(device="cpu")
    setup_dist()                          # cuda, but no group to make
    import torch.distributed as dist
    assert not dist.is_initialized() and world_size() == 1


def test_setup_dist_refuses_a_cuda_group_without_nccl(monkeypatch):
    """No fallback: a CUDA entry point under torchrun needs NCCL (this
    torch has none), and never takes gloo instead."""
    import torch.distributed as dist

    for k, v in TORCHRUN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        setup_dist(device="cuda")
    assert not dist.is_initialized()


def test_setup_dist_refuses_coordinator_args_after_a_group(monkeypatch):
    from autodiffusion_tpu_torch.parallel import dist as pdist

    monkeypatch.setattr(pdist, "_INITIALIZED", True)
    setup_dist(device="cpu")              # no arguments: nothing to do
    with pytest.raises(RuntimeError, match="only be initialised once"):
        setup_dist("localhost:1", 2, 0, device="cpu")


@pytest.mark.parametrize("cmd", ["search", "evaluate", "nll"])
def test_one_process_commands_refuse_more_ranks(monkeypatch, cmd):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="runs one process"):
        main([cmd, "--device", "cpu"])


# ------------------------------------------------ the step in one process

def _step_inputs(seed=11):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(BATCH, 3, IMG, IMG) * 2 - 1)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, BATCH))
    t = torch.from_numpy(rng.randint(0, 1000, BATCH))
    return {"x": x, "y": y}, t, torch.ones(BATCH)


def test_train_step_gradients_live_in_one_flat_buffer():
    """Every gradient an update applies is a view of the state's flat
    buffer, what the data-parallel all-reduce takes in place, with no
    gather and no copy back; the next step fills a buffer of its own, so
    the gradients a caller kept from a step stay as they were."""
    pm = _unet()
    state = create_train_state(pm, lr=TRAIN_LR, ema_rates=())
    apply, seen, kept = state.apply_gradients, [], []

    def capture(grads):
        seen.append({g.untyped_storage().data_ptr() for g in grads})
        kept.append((grads, [g.clone() for g in grads]))
        apply(grads)

    state.apply_gradients = capture
    step = make_train_step(pm, microbatches=2, class_cond=True)
    batch, t, w = _step_inputs()
    tables = build_base_tables("cosine", 1000)
    for i in range(2):
        step(state, tables, batch, t, w, torch.Generator().manual_seed(i))
        assert seen[i] == {state.grad_buffer.untyped_storage().data_ptr()}
        assert state.grad_buffer.numel() == sum(p.numel()
                                                for p in pm.parameters())
    assert all(p.grad is None for p in pm.parameters())
    for grads, copies in kept:
        for g, c in zip(grads, copies):
            torch.testing.assert_close(g, c, rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(kept[0][1], kept[1][1]))


def test_drawn_noise_is_one_draw_a_microbatch(monkeypatch):
    """Without injected noise the step draws one microbatch's noise at a
    time, in order, from its generator: the one-process stream of the
    step before it was data parallel (on the card a draw's offset in the
    generator's stream depends on the draws before it), and the same at
    any number of ranks."""
    batch, t, w = _step_inputs()
    tables = build_base_tables("cosine", 1000)
    gen = torch.Generator().manual_seed(4)
    noise = torch.cat([torch.randn(BATCH // 2, 3, IMG, IMG, generator=gen)
                       for _ in range(2)])
    randn, shapes = torch.randn, []

    def recorded(*a, **kw):
        shapes.append(tuple(a[0]))
        return randn(*a, **kw)

    got = []
    for kw in (dict(generator=torch.Generator().manual_seed(4)),
               dict(noise=noise)):
        pm = _unet()
        state = create_train_state(pm, lr=TRAIN_LR, ema_rates=())
        step = make_train_step(pm, microbatches=2, class_cond=True)
        with monkeypatch.context() as m:
            m.setattr(torch, "randn", recorded)
            _, metrics = step(state, tables, batch, t, w, **kw)
        got.append(metrics)
    assert shapes == [(BATCH // 2, 3, IMG, IMG)] * 2
    for k in ("loss", "per_example_loss", "grad_norm"):
        torch.testing.assert_close(got[0][k], got[1][k], rtol=0, atol=0)
