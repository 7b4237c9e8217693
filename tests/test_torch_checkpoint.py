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
from autodiffusion_tpu.utils.checkpoint import save_tree
from autodiffusion_tpu_torch.models.unet import EncoderUNetModel, UNetModel
from autodiffusion_tpu_torch.train import create_train_state, resume_train_state
from autodiffusion_tpu_torch.utils import logger
from autodiffusion_tpu_torch.utils.checkpoint import (
    MsgpackDecodeError, find_latest_checkpoint, flax_state_dict,
    load_msgpack, parse_step_from_filename, save_checkpoint)
from test_torch_models import (COMMON, IMG, TOL, _classifier_pair, _inputs,
                               _jax_unet, _port_unet, _unet_pair)
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
    name, and the optimizer stays fresh with a warning."""
    _, params, _ = _unet_pair(seed=5)
    _, ema, _ = _unet_pair(seed=6)
    save_tree(str(tmp_path / "model000003.msgpack"), params)
    save_tree(str(tmp_path / "ema_0.9999_000003.msgpack"), ema)
    save_tree(str(tmp_path / "opt000003.msgpack"), {"count": np.int32(3)})
    logger.Logger.CURRENT = None
    pm = _fresh_unet()
    state = create_train_state(pm, ema_rates=(0.9999,))
    resume_train_state(state, str(tmp_path))
    out = capsys.readouterr().out
    assert state.step == 3
    assert "opt000003.msgpack holds optax's state" in out
    assert state.updates() == 0 and not state.optimizer.state
    want = _unet_pair(seed=5)[2].state_dict()
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    want_ema = _unet_pair(seed=6)[2].state_dict()
    for k, v in state.ema_state_dict(0).items():
        torch.testing.assert_close(v, want_ema[k], rtol=0, atol=0)
