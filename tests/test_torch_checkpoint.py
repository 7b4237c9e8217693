"""Checkpoints across the packages, on the CPU.

The port's flax-free msgpack reader against what the JAX package's
``save_tree`` writes (flax ``to_bytes``, chunked arrays forced by a small
chunk size), the resulting UNet against the JAX UNet on the same input
(2e-4 absolute and relative, the models' forward tolerance,
tests/test_torch_models.py), the port's ``.pt`` checkpoints read by the
JAX package, and the checkpoint lookup over a directory holding both
formats. Decoded values are compared exactly.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodiffusion_tpu.models.convert import convert_unet, load_torch_state_dict
from autodiffusion_tpu.utils.checkpoint import load_tree, save_tree
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.train import create_train_state, resume_train_state
from autodiffusion_tpu_torch.utils import logger
from autodiffusion_tpu_torch.utils.checkpoint import (
    MsgpackDecodeError, find_latest_checkpoint, flax_state_dict,
    load_msgpack, msgpack_bytes, parse_step_from_filename, save_checkpoint,
    save_msgpack)
from test_torch_models import (COMMON, IMG, TOL, _classifier_pair, _inputs,
                               _jax_unet, _port_unet, _unet_pair)
from autodiffusion_tpu_torch.utils import checkpoint as ckpt_mod
from test_torch_package import one_torch_thread  # noqa: F401


@pytest.fixture
def small_chunks(monkeypatch):
    """flax splits every array over 256 bytes into chunks."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)


def _fresh_unet():
    return UNetModel(in_channels=3, out_channels=6, num_classes=10,
                     use_new_attention_order=True, **COMMON).eval()


def test_msgpack_unet_from_jax_matches_jax(tmp_path, small_chunks):
    jm, params, _ = _unet_pair()
    path = str(tmp_path / "model000007.msgpack")
    save_tree(path, params)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    pm = _fresh_unet()
    pm.load_state_dict(flax_state_dict(path, pm), strict=True)
    x, t, y = _inputs(2)
    np.testing.assert_allclose(_port_unet(pm, x, t, y),
                               _jax_unet(jm, params, x, t, y),
                               atol=TOL, rtol=TOL)


def test_msgpack_classifier_from_jax(tmp_path):
    jm, params, want = _classifier_pair()
    path = str(tmp_path / "cls.msgpack")
    save_tree(path, params)
    pc = EncoderUNetModel(image_size=IMG, in_channels=3, out_channels=10,
                          use_new_attention_order=False,
                          **dict(COMMON, num_head_channels=32))
    sd = flax_state_dict(path, pc)
    for k, v in want.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_msgpack_reader_decodes_what_flax_writes(tmp_path, small_chunks):
    tree = {"params": {"w": np.arange(300, dtype=np.float32).reshape(3, 100),
                       "i": np.arange(5, dtype=np.int64),
                       "h": np.linspace(-2, 2, 7).astype(np.float16)},
            "bf16": jnp.linspace(-3, 3, 200, dtype=jnp.bfloat16),
            "scalars": {"np": np.float32(2.5), "int": 7, "neg": -300,
                        "big": 2 ** 40, "f": 0.1, "t": True, "f0": False,
                        "none": None, "s": "text"},
            "seq": [1, {"a": np.zeros((0, 3), np.float32)}]}
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(tree))
    got = load_msgpack(path)
    want = flax.serialization.msgpack_restore(open(path, "rb").read())
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path_, g), (_, w) in zip(flat_g, flat_w):
        if isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            np.testing.assert_array_equal(np.asarray(g, np.float32)
                                          if w.dtype == jnp.bfloat16
                                          else np.asarray(g),
                                          np.asarray(w, np.float32)
                                          if w.dtype == jnp.bfloat16
                                          else np.asarray(w))
        else:
            assert g == w and type(g) is type(w), path_
    assert got["params"]["w"].dtype == np.float32
    assert got["bf16"].dtype == np.float32


def _writer_tree():
    """Every form the writer takes: arrays of several dtypes and ranks
    (0-d, empty, non-contiguous, one over the test's chunk size), numpy
    scalars, ints at every msgpack width, floats, bools, None, strings
    past 31 and 255 bytes, lists, a map past 15 keys, keys out of order."""
    rng = np.random.RandomState(0)
    return {"params": {
        "w": rng.randn(3, 100).astype(np.float32),
        "wt": rng.randn(4, 6).astype(np.float32).T,
        "i": np.arange(5, dtype=np.int64), "u8": np.arange(7, dtype=np.uint8),
        "h": np.linspace(-2, 2, 7).astype(np.float16),
        "d": rng.randn(2, 2), "zero_d": np.array(3, np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "many": {f"k{j}": np.float32(j) for j in range(20)}},
        "count": np.int32(7),
        "scalars": {"ints": [0, 127, 128, 255, 256, 65535, 65536,
                             2 ** 32 - 1, 2 ** 32, 2 ** 63, -1, -32, -33,
                             -128, -129, -32768, -32769, -2 ** 31 - 1],
                    "f": 0.1, "t": True, "f0": False, "none": None,
                    "s": "x" * 40, "s2": "y" * 300, "tuple": (1, "a")},
        "b_last": {"z": 1, "a": 2}}


def test_msgpack_writer_is_flax_to_bytes(monkeypatch):
    """The port's bytes are the JAX package's ``save_tree``'s for the same
    tree, chunked arrays included (a 256-byte chunk size on both
    sides)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(ckpt_mod, "MAX_CHUNK_SIZE", 256)
    tree = _writer_tree()
    # save_tree's encoding: flax's to_bytes of the device-fetched tree
    want = flax.serialization.to_bytes(jax.device_get(tree))
    got = msgpack_bytes(tree)
    assert b"__msgpack_chunked_array__" in got
    assert got == want


def test_port_writes_what_jax_load_tree_reads(tmp_path, monkeypatch):
    """A UNet param tree written by the port loads with the JAX package's
    load_tree, bit for bit, and the port's reader gives it back."""
    monkeypatch.setattr(ckpt_mod, "MAX_CHUNK_SIZE", 4096)
    _, params, _ = _unet_pair(seed=8)
    tree = jax.device_get(params)
    path = str(tmp_path / "m.msgpack")
    save_msgpack(path, tree)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    for got in (load_tree(path, template), load_msgpack(path)):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
            got, tree)


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "starts no msgpack object"),
    (b"\x81\xa1a", "truncated"),
    (b"\x01\x02", "trailing"),
    # ext type 2 (a complex number) is none flax writes for arrays
    (b"\xd4\x02\x00", "ext type 2"),
])
def test_msgpack_reader_raises_a_named_error(tmp_path, data, match):
    path = tmp_path / "bad.msgpack"
    path.write_bytes(data)
    with pytest.raises(MsgpackDecodeError, match=match):
        load_msgpack(str(path))
    assert issubclass(MsgpackDecodeError, ValueError)


def test_port_pt_checkpoint_loads_in_jax(tmp_path):
    """A state dict the port writes (save_checkpoint, as TrainLoop.save
    does) goes through the JAX package's load_torch_state_dict +
    convert_unet and gives the port's output."""
    jm, _, pm = _unet_pair(seed=4)
    path = str(tmp_path / "model000002.pt")
    save_checkpoint(path, pm.state_dict())
    assert os.listdir(tmp_path) == ["model000002.pt"]       # no .tmp left
    params = convert_unet(load_torch_state_dict(path), jm)
    x, t, y = _inputs(3)
    np.testing.assert_allclose(_jax_unet(jm, params, x, t, y),
                               _port_unet(pm, x, t, y), atol=TOL, rtol=TOL)


def test_find_latest_checkpoint_over_both_formats(tmp_path):
    for name in ("model000010.msgpack", "model000012.msgpack",
                 "model000012.pt", "model000009.pt", "ema_0.9999_000020.pt",
                 "opt000030.pt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    path, step = find_latest_checkpoint(str(tmp_path))
    assert (os.path.basename(path), step) == ("model000012.pt", 12)
    (tmp_path / "model1000000.msgpack").write_bytes(b"")
    assert find_latest_checkpoint(str(tmp_path))[1] == 1000000
    assert find_latest_checkpoint(str(tmp_path / "missing")) is None
    assert parse_step_from_filename("ema_0.9999_000123.msgpack") == 123
    assert parse_step_from_filename("model.pt") == 0


def test_resume_from_a_jax_checkpoint_directory(tmp_path, capsys):
    """``adt train``'s directory (model / ema / opt msgpack): the model and
    the EMA copy load through the converters, the step comes from the file
    name, and AdamW takes optax's state (the moments, the update count and
    with it the anneal's position); without the opt file the optimizer
    stays fresh with a warning."""
    from autodiffusion_tpu.train.state import create_train_state as jax_state

    _, params, _ = _unet_pair(seed=5)
    _, ema, _ = _unet_pair(seed=6)
    save_tree(str(tmp_path / "model000003.msgpack"), params)
    save_tree(str(tmp_path / "ema_0.9999_000003.msgpack"), ema)
    # optax's state three updates in: counts 3, both moments 0.5
    opt = jax.tree_util.tree_map(
        lambda a: a + 3 if a.dtype == jnp.int32 else a + 0.5,
        jax_state(params, lr=1e-4, lr_anneal_steps=10).opt_state)
    save_tree(str(tmp_path / "opt000003.msgpack"), opt)
    logger.Logger.CURRENT = None
    pm = _fresh_unet()
    state = create_train_state(pm, lr=1e-4, ema_rates=(0.9999,),
                               lr_anneal_steps=10)
    resume_train_state(state, str(tmp_path))
    out = capsys.readouterr().out
    assert state.step == 3
    assert "opt000003" not in out
    assert state.updates() == 3
    assert state.current_lr() == pytest.approx(1e-4 * (1 - 3 / 10))
    for p in state.params:
        st = state.optimizer.state[p]
        assert float(st["step"]) == 3.0
        assert (st["exp_avg"] == 0.5).all() and (st["exp_avg_sq"] == 0.5).all()
    want = _unet_pair(seed=5)[2].state_dict()
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    want_ema = _unet_pair(seed=6)[2].state_dict()
    for k, v in state.ema_state_dict(0).items():
        torch.testing.assert_close(v, want_ema[k], rtol=0, atol=0)
    os.remove(tmp_path / "opt000003.msgpack")
    state = create_train_state(_fresh_unet(), ema_rates=(0.9999,))
    resume_train_state(state, str(tmp_path))
    assert "opt000003.msgpack not found, keeping fresh optimizer" in \
        capsys.readouterr().out
    assert state.updates() == 0 and not state.optimizer.state
