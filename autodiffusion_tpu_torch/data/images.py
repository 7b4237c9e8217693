"""Image folder datasets for training and evaluation (ADM side).

Port of autodiffusion_tpu/data/images.py (guided_diffusion/
image_datasets.py:16-319): recursive folder listing, class labels parsed
from file name prefixes (the ImageNet convention "classname_rest.ext"),
centre or random crop to the model resolution, host numpy batches
[B, H, W, C] in [-1, 1], sharded across data-parallel processes. The same
seed gives the same batches as the JAX package: the same Python
``random`` streams drive the shuffle and the augmentation. PIL is imported
where an image is read; without it reading raises :class:`PILMissing`.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["list_image_files_recursively", "ImageDataset", "load_data",
           "PILMissing"]


class PILMissing(ImportError):
    """Reading an image folder needs Pillow, which is not installed."""


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise PILMissing("reading image files needs Pillow (PIL), which is "
                         "not installed; a uint8 [N, H, W, C] .npy dataset "
                         "needs no PIL (data/native_loader.py)") from e
    return Image

_EXTS = {"jpg", "jpeg", "png", "gif", "bmp", "webp"}


def list_image_files_recursively(data_dir: str) -> List[str]:
    results = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1].lower()
        if "." in entry and ext in _EXTS:
            results.append(full)
        elif os.path.isdir(full):
            results.extend(list_image_files_recursively(full))
    return results


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


def _random_crop(arr: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    h, w = arr.shape[:2]
    top = rng.randrange(h - size + 1)
    left = rng.randrange(w - size + 1)
    return arr[top:top + size, left:left + size]


class ImageDataset:
    """Resize-then-crop pipeline matching image_datasets.py:96-167.

    ``lq_dir``/``small_size`` add the reference fork's paired low-quality
    conditioning mode (image_datasets.py:108-166 + crop alignment at
    :243-313): each high-res image has a same-basename partner in
    ``lq_dir``; both are cropped with ALIGNED coordinates (same-size pairs
    crop identically; a ``resolution//small_size``-downscaled pair crops at
    the scaled-and-requantized coordinates, the reference's "//= with *="
    pixel-match trick) and flipped together. The pair is returned as
    ``cond["low_res"]`` for SuperResModel training."""

    def __init__(self, resolution: int, paths: List[str],
                 classes: Optional[List[int]] = None,
                 shard: int = 0, num_shards: int = 1,
                 random_crop: bool = False, random_flip: bool = True,
                 aug_seed: Optional[int] = None,
                 lq_dir: Optional[str] = None,
                 small_size: Optional[int] = None):
        self.resolution = resolution
        self.paths = paths[shard::num_shards]
        self.classes = None if classes is None else classes[shard::num_shards]
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.lq_dir = lq_dir
        self.small_size = small_size
        if lq_dir is not None and small_size is not None \
                and resolution % small_size:
            raise ValueError(
                f"resolution {resolution} must be an integer multiple of "
                f"small_size {small_size} for aligned pair crops")
        # fresh crop/flip decisions on every access, like the reference's
        # global-random augmentation (image_datasets.py:96-167) — a
        # per-index seed would freeze each image's augmentation across epochs
        self._rng = random.Random(aug_seed)

    def __len__(self) -> int:
        return len(self.paths)

    def _getitem_pair(self, idx: int) -> Tuple[np.ndarray, Dict]:
        """Paired (high, lq) access: the reference SKIPS the resize when an
        lq partner exists (images are assumed pre-sized,
        image_datasets.py:247/261) and aligns the crops."""
        Image = _pil_image()

        path = self.paths[idx]
        lq_path = os.path.join(self.lq_dir, os.path.basename(path))
        with open(path, "rb") as f:
            img = Image.open(f)
            img.load()
        with open(lq_path, "rb") as f:
            lq = Image.open(f)
            lq.load()
        arr = np.array(img.convert("RGB"))
        lq_arr = np.array(lq.convert("RGB"))
        rng = self._rng
        size = self.resolution
        if self.random_crop:
            top = rng.randrange(arr.shape[0] - size + 1)
            left = rng.randrange(arr.shape[1] - size + 1)
        else:
            top = (arr.shape[0] - size) // 2
            left = (arr.shape[1] - size) // 2
        if lq_arr.shape == arr.shape:
            # same-size pair (low-level vision task): identical crop
            arr = arr[top:top + size, left:left + size]
            lq_arr = lq_arr[top:top + size, left:left + size]
        else:
            # super-resolution pair: requantize the crop origin to the
            # low-res grid, then crop BOTH on that grid so the pair stays
            # pixel-aligned (random_crop_arr's "//= with *=",
            # image_datasets.py:301-313)
            if self.small_size is None:
                raise ValueError("small_size is required for differently "
                                 "sized lq pairs")
            scale = size // self.small_size
            top, left = top // scale, left // scale
            lq_arr = lq_arr[top:top + self.small_size,
                            left:left + self.small_size]
            top, left = top * scale, left * scale
            arr = arr[top:top + size, left:left + size]
        if self.random_flip and rng.random() < 0.5:
            arr, lq_arr = arr[:, ::-1], lq_arr[:, ::-1]
        cond = {"low_res": lq_arr.astype(np.float32) / 127.5 - 1}
        if self.classes is not None:
            cond["y"] = np.int64(self.classes[idx])
        return arr.astype(np.float32) / 127.5 - 1, cond

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict]:
        Image = _pil_image()

        if self.lq_dir is not None:
            return self._getitem_pair(idx)
        with open(self.paths[idx], "rb") as f:
            img = Image.open(f)
            img.load()
        img = img.convert("RGB")
        rng = self._rng
        # random_crop adds the reference's SCALE JITTER: the short side is
        # resized to a random size in [ceil(res/max_frac), ceil(res/min_frac)]
        # = [res, ceil(res/0.8)] before cropping (random_crop_arr,
        # image_datasets.py:276-296). Without it a square source resizes to
        # exactly res x res and the "random" crop degenerates to a
        # deterministic (0, 0) crop with zero augmentation.
        if self.random_crop:
            import math
            target = rng.randrange(self.resolution,
                                   math.ceil(self.resolution / 0.8) + 1)
        else:
            target = self.resolution
        # progressive downsize then resize so min side == target
        while min(*img.size) >= 2 * target:
            img = img.resize(tuple(x // 2 for x in img.size), Image.BOX)
        scale = target / min(*img.size)
        img = img.resize(tuple(round(x * scale) for x in img.size), Image.BICUBIC)
        arr = np.array(img)
        if self.random_crop:
            arr = _random_crop(arr, self.resolution, rng)
        else:
            arr = _center_crop(arr, self.resolution)
        if self.random_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        arr = arr.astype(np.float32) / 127.5 - 1  # [-1, 1]
        cond = {}
        if self.classes is not None:
            cond["y"] = np.int64(self.classes[idx])
        return arr, cond


def load_data(*, data_dir: str, batch_size: int, image_size: int,
              class_cond: bool = False, deterministic: bool = False,
              random_crop: bool = False, random_flip: bool = True,
              shard: int = 0, num_shards: int = 1,
              seed: int = 0, lq_dir: Optional[str] = None,
              small_size: Optional[int] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite generator of {"x": [B,H,W,3] f32, "y": [B] i64?, "low_res":
    [B,h,w,3] f32?} batches (load_data, image_datasets.py:16-92; the
    low_res key when lq_dir is given — super_res_train.py:91-101)."""
    if not data_dir:
        raise ValueError("unspecified data directory")
    paths = list_image_files_recursively(data_dir)
    classes = None
    if class_cond:
        names = [os.path.basename(p).split("_")[0] for p in paths]
        sorted_classes = {name: i for i, name in enumerate(sorted(set(names)))}
        classes = [sorted_classes[n] for n in names]
    ds = ImageDataset(image_size, paths, classes, shard=shard,
                      num_shards=num_shards, random_crop=random_crop,
                      random_flip=random_flip,
                      aug_seed=None if seed is None else seed + shard,
                      lq_dir=lq_dir, small_size=small_size)
    order = list(range(len(ds)))
    if len(order) < batch_size:
        raise ValueError(
            f"dataset has {len(order)} images < batch_size {batch_size}; "
            f"the batch loop would spin forever yielding nothing")
    rng = random.Random(seed)
    while True:
        if not deterministic:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            xs, ys, lows = [], [], []
            for j in order[i:i + batch_size]:
                arr, cond = ds[j]
                xs.append(arr)
                if "y" in cond:
                    ys.append(cond["y"])
                if "low_res" in cond:
                    lows.append(cond["low_res"])
            batch = {"x": np.stack(xs)}
            if ys:
                batch["y"] = np.asarray(ys)
            if lows:
                batch["low_res"] = np.stack(lows)
            yield batch
