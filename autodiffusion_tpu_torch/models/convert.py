"""Weights across packages: flax params of the JAX package -> state dicts.

The port's modules carry guided-diffusion's parameter names, so a
published ``.pt`` loads with ``load_state_dict(strict=True)`` and needs no
converter. These functions carry weights the other way round from the JAX
package's flax trees (inverting autodiffusion_tpu/models/convert.py, which
maps guided-diffusion state dicts onto flax), given as nested dicts of
numpy arrays:

  conv   [kh, kw, in, out] -> [out, in, kh, kw]
  dense  [in, out]         -> linear [out, in], or conv1d [out, in, 1]
  GroupNorm scale / bias   -> weight / bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["unet_state_dict_from_flax", "classifier_state_dict_from_flax",
           "inception_state_dict_from_flax"]

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _linear(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T[..., None])
    sd[prefix + ".bias"] = _t(p["bias"])


def _gn(sd: StateDict, prefix: str, p: Mapping) -> None:
    g = p["GroupNorm_0"]
    sd[prefix + ".weight"] = _t(g["scale"])
    sd[prefix + ".bias"] = _t(g["bias"])


def _resblock(sd: StateDict, prefix: str, p: Mapping) -> None:
    _gn(sd, prefix + ".in_layers.0", p["in_norm"])
    _conv(sd, prefix + ".in_layers.2", p["in_conv"])
    _linear(sd, prefix + ".emb_layers.1", p["emb_proj"])
    _gn(sd, prefix + ".out_layers.0", p["out_norm"])
    _conv(sd, prefix + ".out_layers.3", p["out_conv"])
    if "skip" in p:
        _conv(sd, prefix + ".skip_connection", p["skip"])


def _attnblock(sd: StateDict, prefix: str, p: Mapping) -> None:
    _gn(sd, prefix + ".norm", p["norm"])
    _conv1d(sd, prefix + ".qkv", p["qkv"])
    _conv1d(sd, prefix + ".proj_out", p["proj_out"])


def _levels(p: Mapping, side: str):
    return sorted({int(k.split("_")[1]) for k in p if k.startswith(side + "_")
                   and k.split("_")[1].isdigit()})


def _trunk(sd: StateDict, p: Mapping) -> None:
    """time_embed, input_blocks and middle_block (shared by the UNet and
    the classifier)."""
    _linear(sd, "time_embed.0", p["time_embed_0"])
    _linear(sd, "time_embed.2", p["time_embed_2"])
    _conv(sd, "input_blocks.0.0", p["in_conv"])
    idx = 1
    for level in _levels(p, "down"):
        i = 0
        while f"down_{level}_{i}_res" in p:
            _resblock(sd, f"input_blocks.{idx}.0", p[f"down_{level}_{i}_res"])
            if f"down_{level}_{i}_attn" in p:
                _attnblock(sd, f"input_blocks.{idx}.1",
                           p[f"down_{level}_{i}_attn"])
            idx += 1
            i += 1
        ds = p.get(f"down_{level}_ds")
        if ds is not None:
            if "op" in ds:
                _conv(sd, f"input_blocks.{idx}.0.op", ds["op"])
            else:
                _resblock(sd, f"input_blocks.{idx}.0", ds)
            idx += 1
    _resblock(sd, "middle_block.0", p["mid_res0"])
    _attnblock(sd, "middle_block.1", p["mid_attn"])
    _resblock(sd, "middle_block.2", p["mid_res1"])


def unet_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``UNetModel``'s flax params -> the port's UNetModel state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p)
    if "label_emb" in p:
        sd["label_emb.weight"] = _t(p["label_emb"]["embedding"])
    j = 0
    for level in reversed(_levels(p, "up")):
        n = 0
        while f"up_{level}_{n}_res" in p:
            n += 1
        for i in range(n):
            _resblock(sd, f"output_blocks.{j}.0", p[f"up_{level}_{i}_res"])
            sub = 1
            if f"up_{level}_{i}_attn" in p:
                _attnblock(sd, f"output_blocks.{j}.{sub}",
                           p[f"up_{level}_{i}_attn"])
                sub += 1
            us = p.get(f"up_{level}_us")
            if i == n - 1 and us is not None:
                if "conv" in us:
                    _conv(sd, f"output_blocks.{j}.{sub}.conv", us["conv"])
                else:
                    _resblock(sd, f"output_blocks.{j}.{sub}", us)
            j += 1
    _gn(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"])
    return sd


def classifier_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``EncoderUNetModel`` (attention pool) -> the port's state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p)
    _gn(sd, "out.0", p["out_norm"])
    pool = p["out_pool"]
    # flax keeps [T+1, C]; guided-diffusion [C, T+1]
    sd["out.2.positional_embedding"] = _t(
        np.asarray(pool["positional_embedding"]).T)
    _conv1d(sd, "out.2.qkv_proj", pool["qkv_proj"])
    _conv1d(sd, "out.2.c_proj", pool["c_proj"])
    return sd


def inception_state_dict_from_flax(params: Mapping) -> StateDict:
    """The JAX FIDInceptionV3's (BN-folded) flax params -> the port's
    FIDInceptionV3 state dict (same block and branch names)."""
    sd: StateDict = {}

    def walk(tree: Mapping, prefix: str) -> None:
        if "kernel" in tree:
            (_conv if np.ndim(tree["kernel"]) == 4 else _linear)(
                sd, prefix, tree)
            return
        for k, v in tree.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(params.get("params", params), "")
    return sd
