"""The ADM family (guided-diffusion's UNet, its noisy classifier where the
configuration has one, and the FID InceptionV3): the plain reference's
models (on the meta device, for names, shapes, sites and FLOPs) and the
program's, both on the benchmark's seeded weights.

A configuration of this family holds guided-diffusion's model flags
(``image_size``, ``num_channels``, ...), the classifier's
(``classifier_width``, ...) where it has one, and the seeded weights'
``classifier_logit_scale``.

What a family file supplies, by these names: ``reference_models``,
``seeded_weights``, ``program_models``, ``count_run`` (one image through
a reference model, for the roofline's sites and the FLOP count) and
``Reference`` (the reference models for the check after the window).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.models import materialise
from benchmark.harness.weights import make_weights
from benchmark.reference.inception import Inception
from benchmark.reference.numerics import Numerics
from benchmark.reference.unet import Classifier, UNet

__all__ = ["reference_models", "seeded_weights", "program_models",
           "count_run", "Reference"]

UNET_FLAGS = ("image_size", "num_channels", "num_res_blocks",
              "num_head_channels", "attention_resolutions", "class_cond",
              "learn_sigma", "noise_schedule", "use_scale_shift_norm",
              "resblock_updown", "use_new_attention_order", "use_bf16",
              "dropout")


def guided(cfg: dict) -> bool:
    return "classifier_width" in cfg


def reference_models(cfg: dict) -> Dict[str, torch.nn.Module]:
    """{"unet", ["classifier"], "inception"} of the plain reference, on the
    meta device."""
    if not (cfg["use_scale_shift_norm"] and cfg["resblock_updown"]):
        raise ValueError("the reference UNet is written for "
                         "use_scale_shift_norm and resblock_updown")
    with torch.device("meta"):
        out = {"unet": UNet(**cfg)}
        if guided(cfg):
            out["classifier"] = Classifier(**cfg)
        out["inception"] = Inception()
    return {k: m.eval().requires_grad_(False) for k, m in out.items()}


def seeded_weights(cfg: dict, seed: int, device, inception: bool = True):
    """{model: state dict} made on ``device`` from ``seed``."""
    ref = reference_models(cfg)
    logits = float(cfg.get("classifier_logit_scale", 1.0))
    extra = {"classifier": {"out.2.c_proj.weight": logits,
                            "out.2.c_proj.bias": logits}}
    spec = {k: (m, "inception" if k == "inception" else "diffusion",
                extra.get(k, {}))
            for k, m in ref.items() if inception or k != "inception"}
    return make_weights(spec, seed, device)


def _loaded(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    for name, _ in module.named_buffers():
        raise ValueError(f"{name}: a buffer the weights do not set")
    return module.eval().requires_grad_(False)


def program_models(cfg: dict, weights: dict, device):
    """{"unet", ["classifier"], ["inception"]}: the program's models, built
    by its own factories on ``device``, as its ``sample`` command builds
    them, and loaded with the weights. (On the meta device the factories'
    own initialisation imports torch._dynamo: 9-15 s of set-up.)"""
    from autodiffusion_tpu_torch.fid import FIDInceptionV3
    from autodiffusion_tpu_torch.models import (ClassifierConfig,
                                                ModelConfig, create_classifier,
                                                create_model)

    mcfg = ModelConfig(**{k: cfg[k] for k in UNET_FLAGS})
    out = {"unet": _loaded(create_model(mcfg, device=device),
                           weights["unet"])}
    if "classifier" in weights:
        ccfg = ClassifierConfig(**{k: cfg[k] for k in (
            "image_size", "classifier_width", "classifier_depth",
            "classifier_attention_resolutions",
            "classifier_use_scale_shift_norm", "classifier_resblock_updown",
            "classifier_pool", "classifier_use_bf16")})
        out["classifier"] = _loaded(create_classifier(ccfg, device=device),
                                    weights["classifier"])
    if "inception" in weights:
        with torch.device(device):
            inc = FIDInceptionV3()
        out["inception"] = _loaded(inc, weights["inception"])
    return out, mcfg


def count_run(name: str, model, cfg: dict, P: Numerics) -> None:
    """One image through reference model ``name`` on the meta device, as
    the timed path runs it: the classifier with its gradient with respect
    to the input (the guidance), the Inception on uint8 pixels."""
    s = cfg["image_size"]
    x = torch.zeros(1, 3, s, s, device="meta")
    t = torch.zeros(1, device="meta")
    if name == "unet":
        y = (torch.zeros(1, dtype=torch.long, device="meta")
             if cfg["class_cond"] else None)
        with torch.no_grad():
            model(P, x, t, y)
    elif name == "classifier":
        with torch.enable_grad():
            xi = x.requires_grad_(True)
            logp = torch.log_softmax(model(P, xi, t), dim=-1)
            logp[:, 0].sum().backward()
    else:
        model(P, torch.zeros(1, s, s, 3, dtype=torch.uint8, device="meta"))


class Reference:
    """The plain reference models of a configuration on the benchmark's
    weights, made again from the seed once the program's are freed, and
    the image part of the check."""

    def __init__(self, cfg: dict, seed: int, device, inception: bool):
        self.cfg = cfg
        self.models = reference_models(cfg)
        if not inception:
            self.models.pop("inception")
        weights = seeded_weights(cfg, seed, device, inception)
        for k, m in self.models.items():
            materialise(m, weights[k])

    def images(self, P, x_T, coeffs, y, block: int) -> torch.Tensor:
        """uint8 images of guided DDIM from x_T, ``block`` rows at a time."""
        from benchmark.reference import ddim

        return torch.cat([ddim.to_uint8(ddim.guided_ddim(
            P, self.models["unet"], x_T[i:i + block], coeffs[i:i + block],
            None if y is None else y[i:i + block],
            self.models.get("classifier"),
            self.cfg.get("classifier_scale", 1.0)))
            for i in range(0, len(x_T), block)])

    def features(self, P, u8: torch.Tensor, block: int) -> torch.Tensor:
        with torch.no_grad():
            return torch.cat([self.models["inception"](P, u8[i:i + block])
                              for i in range(0, len(u8), block)])

    def image_check(self, ctx, prog_u8, x_T, coeffs, y, block: int):
        """({"image_gap"}, the control's, the reference's images); the
        caller holds TF32 off."""
        from benchmark.harness import checks
        from benchmark.harness.common import CONTROL, REFERENCE

        ref_u8 = self.images(REFERENCE, x_T, coeffs, y, block)
        gap, gap_max = checks.image_gaps(prog_u8, ref_u8)
        sat = float(((ref_u8 == 0) | (ref_u8 == 255)).float().mean())
        ctx.log(f"images checked: {len(x_T)}; image_gap_max {gap_max!r}; "
                f"saturated share {sat!r}; mean level "
                f"{float(ref_u8.float().mean())!r}")
        control = ({"image_gap": checks.image_gaps(self.images(
            CONTROL["diffusion"], x_T, coeffs, y, block), ref_u8)[0]}
            if ctx.control else {})
        return {"image_gap": gap}, control, ref_u8
