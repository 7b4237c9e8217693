"""The rest of the port's ``data/coco.py`` (``CocoCaptions``,
``coco_image_batches``) and ``utils/config.py::args_to_dict`` against the
JAX package, on the CPU.

Three seeded images of odd sizes, written to disk and read back by both
packages with PIL (bicubic resize of the short side, centre crop): the
arrays are equal bit for bit, as are the captions, under both annotation
formats the loaders take.
"""

import argparse
import json

import numpy as np
import pytest

from autodiffusion_tpu.data.coco import CocoCaptions as JaxCoco
from autodiffusion_tpu.data.coco import coco_image_batches as jax_batches
from autodiffusion_tpu.utils.config import args_to_dict as jax_args_to_dict
from autodiffusion_tpu_torch.data import CocoCaptions, coco_image_batches
from autodiffusion_tpu_torch.utils.config import (add_dict_to_argparser,
                                                  args_to_dict)

SIZES = [(37, 53), (64, 29), (41, 41)]     # (width, height)
CAPTIONS = ["a red bus on a bridge", "two dogs in the snow",
            "a plate of pasta"]


@pytest.fixture(params=["subset", "coco"])
def coco_files(request, tmp_path):
    """(annotations json, image root) in the reference's 30K-subset format
    (a list; the images under their default val2014 names, JPEG) or the
    standard COCO format ("annotations" and "images"; PNG names)."""
    from PIL import Image

    rng = np.random.RandomState(5)
    root = tmp_path / "val2014"
    root.mkdir()
    ids = [391895, 522418, 184613]
    names = []
    for i, (w, h) in zip(ids, SIZES):
        arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        name = (f"COCO_val2014_{i:012d}.jpg" if request.param == "subset"
                else f"img_{i}.png")
        Image.fromarray(arr).save(root / name)
        names.append(name)
    if request.param == "subset":
        data = [{"image_id": i, "caption": c} for i, c in zip(ids, CAPTIONS)]
    else:
        data = {"images": [{"id": i, "file_name": n}
                           for i, n in zip(ids, names)],
                "annotations": [{"image_id": i, "caption": c}
                                for i, c in zip(ids, CAPTIONS)]}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(data))
    return str(path), str(root)


@pytest.mark.parametrize("size", [16, 24])
def test_coco_captions_and_images_match_jax(coco_files, size):
    ann, root = coco_files
    port = CocoCaptions(ann, root, image_size=size)
    ref = JaxCoco(ann, root, image_size=size)
    assert len(port) == len(ref) == 3
    assert port.captions() == ref.captions() == CAPTIONS
    for i in range(3):
        got, want = port.image(i), ref.image(i)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)
    assert len(CocoCaptions(ann, root, size, limit=2)) == 2


def test_coco_image_batches_match_jax(coco_files):
    """uint8 [B, H, W, 3] batches; the last partial batch is dropped."""
    ann, root = coco_files
    port = list(coco_image_batches(CocoCaptions(ann, root, 16), 2))
    ref = list(jax_batches(JaxCoco(ann, root, 16), 2))
    assert len(port) == len(ref) == 1
    assert port[0].shape == (2, 16, 16, 3) and port[0].dtype == np.uint8
    np.testing.assert_array_equal(port[0], ref[0])
    assert len(list(coco_image_batches(CocoCaptions(ann, root, 16), 3))) == 1
    assert list(coco_image_batches(CocoCaptions(ann, root, 16), 4)) == []


def test_args_to_dict_matches_jax():
    defaults = dict(image_size=64, class_cond=True, model_path="",
                    scale=1.5)
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)
    args = parser.parse_args(["--class_cond", "False", "--scale", "2"])
    keys = ["class_cond", "scale", "image_size"]
    got = args_to_dict(args, keys)
    assert got == jax_args_to_dict(args, keys) == {
        "class_cond": False, "scale": 2.0, "image_size": 64}
    assert list(got) == keys
    with pytest.raises(AttributeError):
        args_to_dict(args, ["missing"])
