"""Weights across packages: the JAX package's flax param trees <-> the
port's state dicts.

The port's modules carry guided-diffusion's and CompVis's parameter names,
so a published ``.pt`` or ``.ckpt`` loads with
``load_state_dict(strict=True)`` and needs no converter. The
``*_state_dict_from_flax`` functions carry weights from the JAX package's
flax trees (inverting autodiffusion_tpu/models/convert.py and
sd_convert.py, which map those state dicts onto flax), given as nested
dicts of numpy arrays:

  conv   [kh, kw, in, out] -> [out, in, kh, kw]
  dense  [in, out]         -> linear [out, in], or conv1d [out, in, 1]
  GroupNorm scale / bias   -> weight / bias

The ``flax_tree_from_*`` functions go the JAX converters' way (their own
copy: ``convert_unet``, ``convert_sd_unet``, ``convert_vae``,
``convert_vq``, ``convert_clip_text``), from a port module and its state
dict to the float32 numpy tree the JAX model reads, for the files that
``convert`` writes and the JAX package's ``load_tree`` reads.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["unet_state_dict_from_flax", "classifier_state_dict_from_flax",
           "inception_state_dict_from_flax", "sd_unet_state_dict_from_flax",
           "vae_state_dict_from_flax", "vq_state_dict_from_flax",
           "clip_text_state_dict_from_flax", "flax_tree_from_unet",
           "flax_tree_from_vae", "flax_tree_from_clip_text"]

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


def vq_state_dict_from_flax(params: Mapping) -> StateDict:
    """A JAX ``VQModelInterface``'s flax params -> the port's
    VQModelInterface state dict (CompVis names, as convert_vq reads
    them): the KL layout and the ``quantize.embedding.weight`` codebook."""
    p = params.get("params", params)
    sd = vae_state_dict_from_flax(p)
    sd["quantize.embedding.weight"] = _t(p["quantize"]["embedding"])
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
    """A JAX ``EncoderUNetModel`` (any of its four pools) -> the port's
    state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _trunk(sd, p)
    if "out_fc0" in p:                         # the spatial pools
        _linear(sd, "out.0", p["out_fc0"])
        if "out_norm" in p:                    # spatial_v2
            _gn(sd, "out.1", p["out_norm"])
            _linear(sd, "out.3", p["out_fc1"])
        else:
            _linear(sd, "out.2", p["out_fc1"])
        return sd
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


# ------------------------------------------- state dicts -> flax param trees

def _a(sd: Mapping, key: str) -> np.ndarray:
    return sd[key].detach().cpu().float().numpy()


def _fconv(sd: Mapping, p: str) -> Dict:
    out = {"kernel": _a(sd, p + ".weight").transpose(2, 3, 1, 0)}
    if p + ".bias" in sd:
        out["bias"] = _a(sd, p + ".bias")
    return out


def _fdense(sd: Mapping, p: str) -> Dict:
    w = _a(sd, p + ".weight")
    out = {"kernel": (w[..., 0] if w.ndim == 3 else w).T}
    if p + ".bias" in sd:
        out["bias"] = _a(sd, p + ".bias")
    return out


def _fgn(sd: Mapping, p: str) -> Dict:
    return {"GroupNorm_0": _fln(sd, p)}


def _fln(sd: Mapping, p: str) -> Dict:
    return {"scale": _a(sd, p + ".weight"), "bias": _a(sd, p + ".bias")}


def _fres(sd: Mapping, p: str) -> Dict:
    out = {"in_norm": _fgn(sd, p + ".in_layers.0"),
           "in_conv": _fconv(sd, p + ".in_layers.2"),
           "emb_proj": _fdense(sd, p + ".emb_layers.1"),
           "out_norm": _fgn(sd, p + ".out_layers.0"),
           "out_conv": _fconv(sd, p + ".out_layers.3")}
    if p + ".skip_connection.weight" in sd:
        out["skip"] = _fconv(sd, p + ".skip_connection")
    return out


def _fattn(sd: Mapping, p: str, mod) -> Dict:
    """An AttentionBlock or a SpatialTransformer at ``p``."""
    if not hasattr(mod, "transformer_blocks"):
        return {"norm": _fgn(sd, p + ".norm"), "qkv": _fdense(sd, p + ".qkv"),
                "proj_out": _fdense(sd, p + ".proj_out")}
    out = {"norm": _fgn(sd, p + ".norm"), "proj_in": _fconv(sd, p + ".proj_in"),
           "proj_out": _fconv(sd, p + ".proj_out")}
    for d in range(len(mod.transformer_blocks)):
        bp = f"{p}.transformer_blocks.{d}"
        out[f"block_{d}"] = {
            **{a: {"to_q": _fdense(sd, f"{bp}.{a}.to_q"),
                   "to_k": _fdense(sd, f"{bp}.{a}.to_k"),
                   "to_v": _fdense(sd, f"{bp}.{a}.to_v"),
                   "to_out": _fdense(sd, f"{bp}.{a}.to_out.0")}
               for a in ("attn1", "attn2")},
            "ff": {"geglu": {"proj": _fdense(sd, bp + ".ff.net.0.proj")},
                   "out": _fdense(sd, bp + ".ff.net.2")},
            **{n: _fln(sd, f"{bp}.{n}") for n in ("norm1", "norm2", "norm3")}}
    return out


def flax_tree_from_unet(model, sd: Mapping = None) -> Dict:
    """The flax params of a port ``UNetModel`` (the JAX UNetModel's tree,
    convert_unet) or ``SDUNetModel`` (the JAX SDUNetModel's,
    convert_sd_unet), from ``sd`` (default: the module's own state dict),
    walking the module's blocks in construction order."""
    from .unet import ResBlock

    sd = model.state_dict() if sd is None else sd
    p: Dict = {"time_embed_0": _fdense(sd, "time_embed.0"),
               "time_embed_2": _fdense(sd, "time_embed.2"),
               "in_conv": _fconv(sd, "input_blocks.0.0")}
    if "label_emb.weight" in sd:
        p["label_emb"] = {"embedding": _a(sd, "label_emb.weight")}
    level = i = 0
    for idx, blk in enumerate(model.input_blocks):
        if idx == 0:
            continue
        pre = f"input_blocks.{idx}"
        if isinstance(blk[0], ResBlock) and not blk[0].down:
            p[f"down_{level}_{i}_res"] = _fres(sd, pre + ".0")
            if len(blk) > 1:
                p[f"down_{level}_{i}_attn"] = _fattn(sd, pre + ".1", blk[1])
            i += 1
        else:                   # the level's downsample: a ResBlock or conv
            p[f"down_{level}_ds"] = (_fres(sd, pre + ".0")
                                     if isinstance(blk[0], ResBlock)
                                     else {"op": _fconv(sd, pre + ".0.op")})
            level, i = level + 1, 0
    mid = model.middle_block
    p["mid_res0"] = _fres(sd, "middle_block.0")
    p["mid_attn"] = _fattn(sd, "middle_block.1", mid[1])
    p["mid_res1"] = _fres(sd, "middle_block.2")
    per_level = len(model.output_blocks) // len(model.channel_mult)
    for j, blk in enumerate(model.output_blocks):
        level, i = len(model.channel_mult) - 1 - j // per_level, j % per_level
        pre = f"output_blocks.{j}"
        p[f"up_{level}_{i}_res"] = _fres(sd, pre + ".0")
        sub = 1
        if len(blk) > sub and not isinstance(blk[sub], ResBlock) \
                and hasattr(blk[sub], "norm"):
            p[f"up_{level}_{i}_attn"] = _fattn(sd, f"{pre}.{sub}", blk[sub])
            sub += 1
        if len(blk) > sub:      # the level's upsample: a ResBlock or conv
            p[f"up_{level}_us"] = (
                _fres(sd, f"{pre}.{sub}") if isinstance(blk[sub], ResBlock)
                else {"conv": _fconv(sd, f"{pre}.{sub}.conv")})
    p["out_norm"] = _fgn(sd, "out.0")
    p["out_conv"] = _fconv(sd, "out.2")
    return {"params": p}


def _fvae_gn(sd: Mapping, p: str) -> Dict:
    return {"gn": _fgn(sd, p)}


def _fvae_res(sd: Mapping, p: str) -> Dict:
    out = {"norm1": _fvae_gn(sd, p + ".norm1"), "conv1": _fconv(sd, p + ".conv1"),
           "norm2": _fvae_gn(sd, p + ".norm2"), "conv2": _fconv(sd, p + ".conv2")}
    if p + ".nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _fconv(sd, p + ".nin_shortcut")
    return out


def _fvae_attn(sd: Mapping, p: str) -> Dict:
    return {"norm": _fvae_gn(sd, p + ".norm"),
            **{n: _fconv(sd, f"{p}.{n}") for n in ("q", "k", "v", "proj_out")}}


def _fvae_tower(sd: Mapping, prefix: str, tower, side: str) -> Dict:
    """The JAX Encoder ("down") or Decoder ("up") tree of a port tower."""
    out = {"conv_in": _fconv(sd, prefix + ".conv_in"),
           "norm_out": _fvae_gn(sd, prefix + ".norm_out"),
           "conv_out": _fconv(sd, prefix + ".conv_out"),
           "mid_block_1": _fvae_res(sd, prefix + ".mid.block_1"),
           "mid_attn_1": _fvae_attn(sd, prefix + ".mid.attn_1"),
           "mid_block_2": _fvae_res(sd, prefix + ".mid.block_2")}
    resample = ("ds", "downsample") if side == "down" else ("us", "upsample")
    levels = getattr(tower, side)
    order = range(len(levels)) if side == "down" \
        else reversed(range(len(levels)))
    for level in order:
        lp, lvl = f"{prefix}.{side}.{level}", levels[level]
        for i in range(len(lvl.block)):
            out[f"{side}_{level}_block_{i}"] = _fvae_res(sd, f"{lp}.block.{i}")
            if len(lvl.attn):
                out[f"{side}_{level}_attn_{i}"] = _fvae_attn(
                    sd, f"{lp}.attn.{i}")
        if hasattr(lvl, resample[1]):
            out[f"{side}_{level}_{resample[0]}"] = {
                "conv": _fconv(sd, f"{lp}.{resample[1]}.conv")}
    return out


def flax_tree_from_vae(model, sd: Mapping = None) -> Dict:
    """The flax params of a port ``AutoencoderKL`` (convert_vae's tree) or
    ``VQModelInterface`` (convert_vq's: the same and the codebook)."""
    sd = model.state_dict() if sd is None else sd
    p = {"encoder": _fvae_tower(sd, "encoder", model.encoder, "down"),
         "decoder": _fvae_tower(sd, "decoder", model.decoder, "up"),
         "quant_conv": _fconv(sd, "quant_conv"),
         "post_quant_conv": _fconv(sd, "post_quant_conv")}
    if "quantize.embedding.weight" in sd:
        p["quantize"] = {"embedding": _a(sd, "quantize.embedding.weight")}
    return {"params": p}


def flax_tree_from_clip_text(model, sd: Mapping = None) -> Dict:
    """The flax params of a port ``CLIPTextEncoder`` (convert_clip_text's
    tree)."""
    sd = model.state_dict() if sd is None else sd
    pre = "text_model."
    p: Dict = {
        "token_embedding": {
            "embedding": _a(sd, pre + "embeddings.token_embedding.weight")},
        "position_embedding": _a(sd,
                                 pre + "embeddings.position_embedding.weight"),
        "final_ln": _fln(sd, pre + "final_layer_norm")}
    for i in range(model.config.layers):
        lp = f"{pre}encoder.layers.{i}."
        p[f"layer_{i}_attn"] = {n: _fdense(sd, lp + "self_attn." + n)
                                for n in ("q_proj", "k_proj", "v_proj",
                                          "out_proj")}
        p[f"layer_{i}_ln1"] = _fln(sd, lp + "layer_norm1")
        p[f"layer_{i}_ln2"] = _fln(sd, lp + "layer_norm2")
        p[f"layer_{i}_fc1"] = _fdense(sd, lp + "mlp.fc1")
        p[f"layer_{i}_fc2"] = _fdense(sd, lp + "mlp.fc2")
    return {"params": p}
