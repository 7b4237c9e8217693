"""COCO captions and images for the Stable Diffusion search.

Port of autodiffusion_tpu/data/coco.py (sd/ldm/data/coco.py:15-49 +
build_dataloader.py:7-86): reads the ``captions_val2014_30K_samples.json``
subset (or a standard COCO annotation file) and the ``val2014/`` images.
The search needs the captions, for the CLIP context bank, and optionally
the images, for reference statistics (uint8 [B, H, W, 3] batches).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["CocoCaptions", "load_captions", "coco_image_batches"]


def load_captions(annotations_json: str,
                  limit: Optional[int] = None) -> List[Dict]:
    """[{image_id, caption, file_name?}, ...] from the reference's
    30K-sample subset format (a list) or the standard COCO annotation
    format (a dict with "annotations" and "images")."""
    with open(annotations_json) as f:
        data = json.load(f)
    if isinstance(data, dict) and "annotations" in data:
        id_to_file = {im["id"]: im["file_name"]
                      for im in data.get("images", [])}
        out = [{"image_id": a["image_id"], "caption": a["caption"],
                "file_name": id_to_file.get(a["image_id"])}
               for a in data["annotations"]]
    else:
        out = list(data)
    return out[:limit] if limit else out


class CocoCaptions:
    """Caption / image pairs (coco.py:15-49)."""

    def __init__(self, annotations_json: str,
                 image_root: Optional[str] = None, image_size: int = 512,
                 limit: Optional[int] = None):
        self.items = load_captions(annotations_json, limit)
        self.image_root = image_root
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.items)

    def captions(self) -> List[str]:
        return [it["caption"] for it in self.items]

    def image(self, idx: int) -> np.ndarray:
        """uint8 [S, S, 3]: the short side resized to ``image_size``
        (PIL bicubic), then the centre crop."""
        from .images import _pil_image

        Image = _pil_image()
        it = self.items[idx]
        name = (it.get("file_name")
                or f"COCO_val2014_{it['image_id']:012d}.jpg")
        img = Image.open(os.path.join(self.image_root, name)).convert("RGB")
        s = self.image_size
        scale = s / min(img.size)
        img = img.resize(tuple(round(x * scale) for x in img.size),
                         Image.BICUBIC)
        arr = np.array(img)
        h, w = arr.shape[:2]
        top, left = (h - s) // 2, (w - s) // 2
        return arr[top:top + s, left:left + s]


def coco_image_batches(ds: CocoCaptions,
                       batch_size: int) -> Iterator[np.ndarray]:
    """uint8 [B, H, W, 3] batches for reference statistics; the last
    partial batch is dropped."""
    for i in range(0, len(ds) - batch_size + 1, batch_size):
        yield np.stack([ds.image(j) for j in range(i, i + batch_size)])
