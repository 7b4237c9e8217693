"""The port's data loaders and key-value logger against the JAX package's,
on the CPU: the same seed gives the same batches (exactly), and the same
``logkv`` calls write the same ``progress.csv`` / ``progress.json`` /
``log.txt`` lines.
"""

import os

import numpy as np
import pytest

from autodiffusion_tpu.data import load_data as jax_load_data
from autodiffusion_tpu.data.native_loader import \
    NativeNpyLoader as JaxNpyLoader
from autodiffusion_tpu.utils import logger as jax_logger
from autodiffusion_tpu_torch.data import list_image_files_recursively, load_data
from autodiffusion_tpu_torch.data import native_loader
from autodiffusion_tpu_torch.data.native_loader import NativeNpyLoader
from autodiffusion_tpu_torch.utils import logger


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """14 PNGs of two classes and three sizes (one non-square), one in a
    sub-folder."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pngs")
    os.makedirs(d / "sub")
    rng = np.random.RandomState(0)
    for i in range(14):
        hw = [(40, 40), (48, 36), (70, 70)][i % 3]
        img = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
        name = f"{'cat' if i % 2 else 'dog'}_{i:02d}.png"
        Image.fromarray(img).save(d / ("sub" if i == 5 else "") / name)
    return str(d)


@pytest.mark.parametrize("kw", [
    dict(deterministic=True, random_flip=False),
    dict(class_cond=True, seed=3),
    dict(class_cond=True, random_crop=True, seed=5),
])
def test_load_data_gives_jax_batches(png_folder, kw):
    ours = load_data(data_dir=png_folder, batch_size=4, image_size=32, **kw)
    theirs = jax_load_data(data_dir=png_folder, batch_size=4, image_size=32,
                           **kw)
    for _ in range(5):                   # past one epoch of 3 batches
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert a["x"].shape == (4, 32, 32, 3) and a["x"].dtype == np.float32
    assert len(list_image_files_recursively(png_folder)) == 14


def test_load_data_refuses_a_small_dataset(png_folder):
    with pytest.raises(ValueError, match="< batch_size"):
        next(load_data(data_dir=png_folder, batch_size=15, image_size=32))


def test_native_loader_gives_jax_batches(tmp_path):
    rng = np.random.RandomState(1)
    np.save(tmp_path / "d.npy",
            rng.randint(0, 256, (23, 12, 10, 3), dtype=np.uint8))
    np.save(tmp_path / "d_labels.npy", rng.randint(0, 1000, 23))
    for kw in (dict(crop=8, seed=4), dict(crop=0, shuffle=False,
                                          random_flip=False)):
        ours = NativeNpyLoader(str(tmp_path / "d.npy"),
                               str(tmp_path / "d_labels.npy"), batch_size=5,
                               **kw)
        theirs = JaxNpyLoader(str(tmp_path / "d.npy"),
                              str(tmp_path / "d_labels.npy"), batch_size=5,
                              **kw)
        try:
            for _ in range(7):          # past one epoch of 4 batches
                a, b = next(ours), next(theirs)
                np.testing.assert_array_equal(a["x"], b["x"])
                np.testing.assert_array_equal(a["y"], b["y"])
        finally:
            ours.close()
            theirs.close()
    # built into the port's own build directory, never into native/
    assert os.path.dirname(native_loader.build_native()).endswith(
        os.path.join("autodiffusion_tpu_torch", "ops", "_build"))


def test_native_loader_refuses_short_labels(tmp_path):
    np.save(tmp_path / "d.npy", np.zeros((6, 4, 4, 3), np.uint8))
    np.save(tmp_path / "l.npy", np.arange(5))
    with pytest.raises(ValueError, match="one entry per image"):
        NativeNpyLoader(str(tmp_path / "d.npy"), str(tmp_path / "l.npy"),
                        batch_size=2)


def _drive(mod, d):
    mod.configure(d, log_to_stdout=False)
    mod.log("starting", 3, "steps")
    for step in range(3):
        mod.logkv("step", step)
        mod.logkv_mean("loss", 1.0 / (step + 1))
        mod.logkv_mean("loss", 0.5)
        if step == 1:
            mod.logkv("a_new_key", "text")
        mod.dumpkvs()
    mod.log("done")
    assert mod.get_dir() == d


def test_logger_writes_the_jax_lines(tmp_path):
    dirs = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    _drive(logger, dirs["port"])
    logger.Logger.CURRENT.close()
    _drive(jax_logger, dirs["jax"])
    files = {}
    for name, d in dirs.items():
        for f in ("progress.csv", "progress.json", "log.txt"):
            with open(os.path.join(d, f)) as fh:
                lines = fh.read().splitlines()
            # the first log line names the directory
            files[name, f] = lines[1:] if f == "log.txt" else lines
    for f in ("progress.csv", "progress.json", "log.txt"):
        assert files["port", f] == files["jax", f], f
    # the key added at step 1 rewrote the header with its column
    assert files["port", "progress.csv"][0] == "loss,step,a_new_key"
