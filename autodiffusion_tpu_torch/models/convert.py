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
           "inception_state_dict_from_flax", "sd_unet_state_dict_from_flax",
           "vae_state_dict_from_flax", "clip_text_state_dict_from_flax"]

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


def _ln(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _spatial_transformer(sd: StateDict, prefix: str, p: Mapping) -> None:
    """A JAX SpatialTransformer -> CompVis names (sd_convert.py:34-60)."""
    _gn(sd, prefix + ".norm", p["norm"])
    _conv(sd, prefix + ".proj_in", p["proj_in"])
    _conv(sd, prefix + ".proj_out", p["proj_out"])
    d = 0
    while f"block_{d}" in p:
        bp, blk = f"{prefix}.transformer_blocks.{d}", p[f"block_{d}"]
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{bp}.{a}.{n}", blk[a][n])
            _linear(sd, f"{bp}.{a}.to_out.0", blk[a]["to_out"])
        _linear(sd, bp + ".ff.net.0.proj", blk["ff"]["geglu"]["proj"])
        _linear(sd, bp + ".ff.net.2", blk["ff"]["out"])
        for n in ("norm1", "norm2", "norm3"):
            _ln(sd, f"{bp}.{n}", blk[n])
        d += 1


def _trunk(sd: StateDict, p: Mapping, attn=_attnblock) -> None:
    """time_embed, input_blocks and middle_block (shared by the UNet, the
    classifier and, with ``attn`` the SpatialTransformer's, the SD
    UNet)."""
    _linear(sd, "time_embed.0", p["time_embed_0"])
    _linear(sd, "time_embed.2", p["time_embed_2"])
    _conv(sd, "input_blocks.0.0", p["in_conv"])
    idx = 1
    for level in _levels(p, "down"):
        i = 0
        while f"down_{level}_{i}_res" in p:
            _resblock(sd, f"input_blocks.{idx}.0", p[f"down_{level}_{i}_res"])
            if f"down_{level}_{i}_attn" in p:
                attn(sd, f"input_blocks.{idx}.1", p[f"down_{level}_{i}_attn"])
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
    attn(sd, "middle_block.1", p["mid_attn"])
    _resblock(sd, "middle_block.2", p["mid_res1"])


def unet_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``UNetModel``'s flax params -> the port's UNetModel state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p)
    if "label_emb" in p:
        sd["label_emb.weight"] = _t(p["label_emb"]["embedding"])
    _outputs(sd, p)
    return sd


def _outputs(sd: StateDict, p: Mapping, attn=_attnblock) -> None:
    """output_blocks, out.0 and out.2."""
    j = 0
    for level in reversed(_levels(p, "up")):
        n = 0
        while f"up_{level}_{n}_res" in p:
            n += 1
        for i in range(n):
            _resblock(sd, f"output_blocks.{j}.0", p[f"up_{level}_{i}_res"])
            sub = 1
            if f"up_{level}_{i}_attn" in p:
                attn(sd, f"output_blocks.{j}.{sub}", p[f"up_{level}_{i}_attn"])
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


def sd_unet_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``SDUNetModel``'s flax params -> the port's SDUNetModel state
    dict (openaimodel names, as convert_sd_unet reads them)."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p, _spatial_transformer)
    _outputs(sd, p, _spatial_transformer)
    return sd


def _vae_gn(sd: StateDict, prefix: str, p: Mapping) -> None:
    _gn(sd, prefix, p["gn"])


def _vae_res(sd: StateDict, prefix: str, p: Mapping) -> None:
    _vae_gn(sd, prefix + ".norm1", p["norm1"])
    _conv(sd, prefix + ".conv1", p["conv1"])
    _vae_gn(sd, prefix + ".norm2", p["norm2"])
    _conv(sd, prefix + ".conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(sd, prefix + ".nin_shortcut", p["nin_shortcut"])


def _vae_attn(sd: StateDict, prefix: str, p: Mapping) -> None:
    _vae_gn(sd, prefix + ".norm", p["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{prefix}.{n}", p[n])


def _vae_tower(sd: StateDict, prefix: str, p: Mapping, side: str) -> None:
    """An Encoder ("down") or Decoder ("up") of the JAX AutoencoderKL."""
    _conv(sd, prefix + ".conv_in", p["conv_in"])
    _vae_res(sd, prefix + ".mid.block_1", p["mid_block_1"])
    _vae_attn(sd, prefix + ".mid.attn_1", p["mid_attn_1"])
    _vae_res(sd, prefix + ".mid.block_2", p["mid_block_2"])
    resample = ("ds", "downsample") if side == "down" else ("us", "upsample")
    for level in _levels(p, side):
        lp = f"{prefix}.{side}.{level}"
        i = 0
        while f"{side}_{level}_block_{i}" in p:
            _vae_res(sd, f"{lp}.block.{i}", p[f"{side}_{level}_block_{i}"])
            if f"{side}_{level}_attn_{i}" in p:
                _vae_attn(sd, f"{lp}.attn.{i}", p[f"{side}_{level}_attn_{i}"])
            i += 1
        rs = p.get(f"{side}_{level}_{resample[0]}")
        if rs is not None:
            _conv(sd, f"{lp}.{resample[1]}.conv", rs["conv"])
    _vae_gn(sd, prefix + ".norm_out", p["norm_out"])
    _conv(sd, prefix + ".conv_out", p["conv_out"])


def vae_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``AutoencoderKL``'s flax params -> the port's AutoencoderKL
    state dict (CompVis first_stage_model names, as convert_vae reads
    them)."""
    p = params.get("params", params)
    sd: StateDict = {}
    _vae_tower(sd, "encoder", p["encoder"], "down")
    _vae_tower(sd, "decoder", p["decoder"], "up")
    _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def clip_text_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``CLIPTextEncoder``'s flax params -> the port's
    CLIPTextEncoder state dict (HF CLIPTextModel names under
    ``text_model.``, as convert_clip_text reads them)."""
    p = params.get("params", params)
    pre = "text_model."
    pos = np.asarray(p["position_embedding"])
    sd: StateDict = {
        pre + "embeddings.token_embedding.weight":
            _t(p["token_embedding"]["embedding"]),
        pre + "embeddings.position_embedding.weight": _t(pos),
        pre + "embeddings.position_ids": torch.arange(pos.shape[0])[None],
    }
    _ln(sd, pre + "final_layer_norm", p["final_ln"])
    i = 0
    while f"layer_{i}_attn" in p:
        lp = f"{pre}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, lp + "self_attn." + n, p[f"layer_{i}_attn"][n])
        _ln(sd, lp + "layer_norm1", p[f"layer_{i}_ln1"])
        _ln(sd, lp + "layer_norm2", p[f"layer_{i}_ln2"])
        _linear(sd, lp + "mlp.fc1", p[f"layer_{i}_fc1"])
        _linear(sd, lp + "mlp.fc2", p[f"layer_{i}_fc2"])
        i += 1
    return sd


def classifier_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``EncoderUNetModel`` (attention or adaptive pool) -> the
    port's state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p)
    _gn(sd, "out.0", p["out_norm"])
    if "out_conv" in p:                        # the adaptive pool
        _conv(sd, "out.3", p["out_conv"])
        return sd
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
