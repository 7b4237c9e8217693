"""COCO captions for the Stable Diffusion search.

Port of autodiffusion_tpu/data/coco.py::load_captions (sd/ldm/data/coco.py:
15-49): the search needs only the captions, for the CLIP context bank.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["load_captions"]


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
