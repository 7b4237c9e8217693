"""CompVis Stable Diffusion checkpoints -> the port's three towers.

Port of the checkpoint side of autodiffusion_tpu/models/sd_convert.py. The
port's SD modules carry the checkpoint's own names, so no layout
conversion is needed: a ``sd-v1-*.ckpt`` state dict is split by prefix
(as the reference loads it, sd/scripts/search_ea.py:55-72):

  model.diffusion_model.*          -> SDUNetModel
  first_stage_model.*              -> AutoencoderKL
  cond_stage_model.transformer.*   -> CLIPTextEncoder (HF ``text_model.*``)

and each part loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["SD_PREFIXES", "split_sd_checkpoint", "load_sd_checkpoint"]

SD_PREFIXES = {"unet": "model.diffusion_model.",
               "vae": "first_stage_model.",
               "clip": "cond_stage_model.transformer."}

StateDict = Dict[str, torch.Tensor]


def split_sd_checkpoint(sd: Mapping[str, torch.Tensor]
                        ) -> Tuple[StateDict, StateDict, StateDict]:
    """One CompVis state dict -> (unet, vae, clip) state dicts, each with
    its prefix stripped. Other keys (the EMA copy, the schedule buffers)
    are left out."""
    parts = []
    for prefix in SD_PREFIXES.values():
        part = {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
        if not part:
            raise KeyError(f"the checkpoint has no {prefix}* weights")
        parts.append(part)
    return tuple(parts)


def load_sd_checkpoint(path: str) -> StateDict:
    """A ``.ckpt`` file's state dict: its ``state_dict`` entry, or the file
    itself where it is a bare state dict. Tensors only (weights_only)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds no state dict")
    return obj
