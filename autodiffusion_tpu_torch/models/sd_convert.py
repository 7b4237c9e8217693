"""CompVis Stable Diffusion checkpoints -> the port's three towers.

Port of the checkpoint side of autodiffusion_tpu/models/sd_convert.py. The
port's SD modules carry the checkpoint's own names, so no layout
conversion is needed: a ``sd-v1-*.ckpt`` state dict is split by prefix
(as the reference loads it, sd/scripts/search_ea.py:55-72):

  model.diffusion_model.*          -> SDUNetModel
  first_stage_model.*              -> AutoencoderKL
  cond_stage_model.transformer.*   -> CLIPTextEncoder (HF ``text_model.*``)

and each part loads with ``load_state_dict(strict=True)``.

The own-format params directory is the JAX package's (sd_convert.py:
220-258, what ``adt convert --preset sd`` writes and every SD command
reads with ``--ckpt <dir>``): ``sd_unet.msgpack``, ``sd_vae.msgpack`` and
``sd_clip.msgpack``, the three towers' flax param trees in flax's msgpack
form, written and read here without flax.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import torch

from ..utils.checkpoint import load_msgpack, save_msgpack
from .convert import (clip_text_state_dict_from_flax,
                      flax_tree_from_clip_text, flax_tree_from_unet,
                      flax_tree_from_vae, sd_unet_state_dict_from_flax,
                      vae_state_dict_from_flax)

__all__ = ["SD_PREFIXES", "SD_PARAMS_FILES", "split_sd_checkpoint",
           "load_sd_checkpoint", "save_sd_params_dir", "load_sd_params_dir",
           "load_sd_weights", "strip_prefix"]

SD_PREFIXES = {"unet": "model.diffusion_model.",
               "vae": "first_stage_model.",
               "clip": "cond_stage_model.transformer."}

StateDict = Dict[str, torch.Tensor]

# the params directory's files, one a tower (UNet, VAE, CLIP)
SD_PARAMS_FILES = ("sd_unet.msgpack", "sd_vae.msgpack", "sd_clip.msgpack")


def strip_prefix(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """The entries of ``sd`` under ``prefix``, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def split_sd_checkpoint(sd: Mapping[str, torch.Tensor]
                        ) -> Tuple[StateDict, StateDict, StateDict]:
    """One CompVis state dict -> (unet, vae, clip) state dicts, each with
    its prefix stripped. Other keys (the EMA copy, the schedule buffers)
    are left out."""
    parts = []
    for prefix in SD_PREFIXES.values():
        part = strip_prefix(sd, prefix)
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


def save_sd_params_dir(path: str, unet, vae, clip) -> None:
    """Write the three towers (port modules holding the weights) as the
    params directory ``path``: each its JAX model's flax param tree
    (models/convert.py ``flax_tree_from_*``), loadable by the JAX
    package's ``load_sd_params_dir`` and by :func:`load_sd_params_dir`."""
    os.makedirs(path, exist_ok=True)
    for name, tree in zip(SD_PARAMS_FILES, (flax_tree_from_unet(unet),
                                            flax_tree_from_vae(vae),
                                            flax_tree_from_clip_text(clip))):
        save_msgpack(os.path.join(path, name), tree)


def load_sd_params_dir(path: str) -> Tuple[StateDict, StateDict, StateDict]:
    """A params directory (this package's or the JAX package's) -> the
    (unet, vae, clip) state dicts of the port's towers."""
    convert = (sd_unet_state_dict_from_flax, vae_state_dict_from_flax,
               clip_text_state_dict_from_flax)
    return tuple(fn(load_msgpack(os.path.join(path, name)))
                 for name, fn in zip(SD_PARAMS_FILES, convert))


def load_sd_weights(path: str) -> Tuple[StateDict, StateDict, StateDict]:
    """The (unet, vae, clip) state dicts of ``--ckpt``: a params directory
    or a CompVis checkpoint file."""
    if os.path.isdir(path):
        return load_sd_params_dir(path)
    return split_sd_checkpoint(load_sd_checkpoint(path))