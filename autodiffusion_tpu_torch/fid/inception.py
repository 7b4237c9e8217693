"""FID InceptionV3 feature extractor (NCHW, batch norm folded into convs).

Port of autodiffusion_tpu/fid/inception.py: the pytorch_fid variant of
torchvision's InceptionV3 (the "pt_inception-2015-12-05" FID weights), with
its FID quirks: count_include_pad=False 3x3 average pools, the max-pool
branch of the last InceptionE block, a 1008-way logits head. Each
BasicConv2d is one conv with bias (BN eps 1e-3 folded in at load time).

Weights are not bundled: load the standard
``pt_inception-2015-12-05-6726825d.pth`` with :func:`load_fid_inception`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FIDInceptionV3", "preprocess", "fold_pt_inception",
           "load_fid_inception", "synthesize_pt_inception"]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=True, **kw)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg_cif(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_cif(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_cif(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(
            self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin, pool_type):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        # FID quirk: the last block (Mixed_7c) pools with a max
        bp = (_avg_cif(x) if self.pool_type == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """forward(x [B, 3, H, W] in [-1, 1]) -> dict(pool3 [B, 2048],
    spatial [B, 7, 17, 17], logits [B, 1008]), float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = m(x)
        spatial = x[:, :7]
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "spatial": spatial, "logits": self.fc(pool3)}


def preprocess(images_uint8: torch.Tensor, size: int = 299) -> torch.Tensor:
    """uint8 NHWC [0, 255] -> float32 NCHW [-1, 1] resized to ``size``
    (bilinear, half-pixel centres, no antialias: pytorch_fid's
    F.interpolate, which the JAX preprocess matches)."""
    x = images_uint8.permute(0, 3, 1, 2).float() / 255.0
    if tuple(x.shape[2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False)
    return x * 2.0 - 1.0


def fold_pt_inception(sd: Mapping[str, torch.Tensor], eps: float = 1e-3
                      ) -> Dict[str, torch.Tensor]:
    """A pytorch_fid state dict (conv + BatchNorm per BasicConv2d) -> this
    module's state dict, BN folded into each conv's weight and bias."""
    out: Dict[str, torch.Tensor] = {}
    for key, w in sd.items():
        if not key.endswith(".conv.weight"):
            continue
        p = key[: -len(".conv.weight")]
        g, b = sd[f"{p}.bn.weight"].double(), sd[f"{p}.bn.bias"].double()
        m, v = sd[f"{p}.bn.running_mean"].double(), sd[f"{p}.bn.running_var"].double()
        scale = g / torch.sqrt(v + eps)
        out[f"{p}.conv.weight"] = (w.double() * scale[:, None, None, None]).float()
        out[f"{p}.conv.bias"] = (b - m * scale).float()
    out["fc.weight"] = sd["fc.weight"].float()
    out["fc.bias"] = sd["fc.bias"].float()
    return out


def load_fid_inception(path: str, device=None) -> FIDInceptionV3:
    """The FID Inception from a pytorch_fid ``.pth`` file, on ``device``
    (cuda by default), in eval mode."""
    from .. import resolve_device

    dev = resolve_device(device)
    model = FIDInceptionV3()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(fold_pt_inception(sd), strict=True)
    return model.to(dev).eval()


def synthesize_pt_inception(seed: int) -> Dict[str, torch.Tensor]:
    """A random state dict in pytorch_fid's layout (conv weights He-scaled,
    BN statistics near identity), for runs without the real weights."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    for key, p in FIDInceptionV3().state_dict().items():
        if key.endswith(".conv.weight"):
            pre = key[: -len(".conv.weight")]
            fan_in = int(np.prod(p.shape[1:]))
            cout = p.shape[0]
            sd[key] = torch.from_numpy(
                (rng.randn(*p.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
            sd[f"{pre}.bn.weight"] = torch.from_numpy(
                (rng.rand(cout) + 0.5).astype(np.float32))
            sd[f"{pre}.bn.bias"] = torch.from_numpy(
                (rng.randn(cout) * 0.1).astype(np.float32))
            sd[f"{pre}.bn.running_mean"] = torch.from_numpy(
                (rng.randn(cout) * 0.1).astype(np.float32))
            sd[f"{pre}.bn.running_var"] = torch.from_numpy(
                (rng.rand(cout) + 0.5).astype(np.float32))
        elif key.startswith("fc."):
            sd[key] = torch.from_numpy(
                (rng.randn(*p.shape) * 0.02).astype(np.float32))
    return sd
