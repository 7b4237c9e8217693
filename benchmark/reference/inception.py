"""Plain FID InceptionV3 (pytorch_fid's ``pt_inception-2015-12-05``
network with each batch norm folded into its conv), for the benchmark's
correctness check: pool3 features [B, 2048] of uint8 NHWC images.

Parameter names are those of the folded network (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.conv``, ..., ``fc``), so one state dict serves this
model and the program's. Its FID quirks: 3x3 average pools that leave the
padding out of the count, a max pool in the last block's pool branch, a
bilinear resize to 299 with half-pixel centres and no antialias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .numerics import Numerics

__all__ = ["Inception", "preprocess"]


class C(nn.Module):
    """A folded BasicConv2d: conv with bias, then ReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)

    def forward(self, P: Numerics, x):
        return F.relu(P.conv2d(self.conv, x))


def _avg(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _seq(P, x, *mods):
    for m in mods:
        x = m(P, x)
    return x


class A(nn.Module):
    def __init__(self, cin, pool):
        super().__init__()
        self.branch1x1 = C(cin, 64, 1)
        self.branch5x5_1 = C(cin, 48, 1)
        self.branch5x5_2 = C(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = C(cin, 64, 1)
        self.branch3x3dbl_2 = C(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = C(96, 96, 3, padding=1)
        self.branch_pool = C(cin, pool, 1)

    def forward(self, P, x):
        return torch.cat([
            self.branch1x1(P, x),
            _seq(P, x, self.branch5x5_1, self.branch5x5_2),
            _seq(P, x, self.branch3x3dbl_1, self.branch3x3dbl_2,
                 self.branch3x3dbl_3),
            self.branch_pool(P, _avg(x))], 1)


class B(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = C(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = C(cin, 64, 1)
        self.branch3x3dbl_2 = C(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = C(96, 96, 3, stride=2)

    def forward(self, P, x):
        return torch.cat([
            self.branch3x3(P, x),
            _seq(P, x, self.branch3x3dbl_1, self.branch3x3dbl_2,
                 self.branch3x3dbl_3),
            F.max_pool2d(x, 3, stride=2)], 1)


class Cb(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = C(cin, 192, 1)
        self.branch7x7_1 = C(cin, c7, 1)
        self.branch7x7_2 = C(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = C(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = C(cin, c7, 1)
        self.branch7x7dbl_2 = C(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = C(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = C(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = C(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = C(cin, 192, 1)

    def forward(self, P, x):
        return torch.cat([
            self.branch1x1(P, x),
            _seq(P, x, self.branch7x7_1, self.branch7x7_2, self.branch7x7_3),
            _seq(P, x, self.branch7x7dbl_1, self.branch7x7dbl_2,
                 self.branch7x7dbl_3, self.branch7x7dbl_4,
                 self.branch7x7dbl_5),
            self.branch_pool(P, _avg(x))], 1)


class D(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = C(cin, 192, 1)
        self.branch3x3_2 = C(192, 320, 3, stride=2)
        self.branch7x7x3_1 = C(cin, 192, 1)
        self.branch7x7x3_2 = C(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = C(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = C(192, 192, 3, stride=2)

    def forward(self, P, x):
        return torch.cat([
            _seq(P, x, self.branch3x3_1, self.branch3x3_2),
            _seq(P, x, self.branch7x7x3_1, self.branch7x7x3_2,
                 self.branch7x7x3_3, self.branch7x7x3_4),
            F.max_pool2d(x, 3, stride=2)], 1)


class E(nn.Module):
    def __init__(self, cin, pool_max: bool):
        super().__init__()
        self.pool_max = pool_max
        self.branch1x1 = C(cin, 320, 1)
        self.branch3x3_1 = C(cin, 384, 1)
        self.branch3x3_2a = C(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = C(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = C(cin, 448, 1)
        self.branch3x3dbl_2 = C(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = C(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = C(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = C(cin, 192, 1)

    def forward(self, P, x):
        b3 = self.branch3x3_1(P, x)
        bd = _seq(P, x, self.branch3x3dbl_1, self.branch3x3dbl_2)
        pool = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_max
                else _avg(x))
        return torch.cat([
            self.branch1x1(P, x),
            self.branch3x3_2a(P, b3), self.branch3x3_2b(P, b3),
            self.branch3x3dbl_3a(P, bd), self.branch3x3dbl_3b(P, bd),
            self.branch_pool(P, pool)], 1)


class Inception(nn.Module):
    """forward(P, uint8 NHWC images) -> pool3 [B, 2048] float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = C(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = C(32, 32, 3)
        self.Conv2d_2b_3x3 = C(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = C(64, 80, 1)
        self.Conv2d_4a_3x3 = C(80, 192, 3)
        self.Mixed_5b, self.Mixed_5c, self.Mixed_5d = \
            A(192, 32), A(256, 64), A(288, 64)
        self.Mixed_6a = B(288)
        self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e = \
            Cb(768, 128), Cb(768, 160), Cb(768, 160), Cb(768, 192)
        self.Mixed_7a = D(768)
        self.Mixed_7b, self.Mixed_7c = E(1280, False), E(2048, True)
        self.fc = nn.Linear(2048, 1008)

    def forward(self, P: Numerics, images_uint8):
        x = preprocess(images_uint8).to(P.act_dtype)
        x = _seq(P, x, self.Conv2d_1a_3x3, self.Conv2d_2a_3x3,
                 self.Conv2d_2b_3x3)
        x = F.max_pool2d(x, 3, stride=2)
        x = _seq(P, x, self.Conv2d_3b_1x1, self.Conv2d_4a_3x3)
        x = F.max_pool2d(x, 3, stride=2)
        x = _seq(P, x, self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                 self.Mixed_6a, self.Mixed_6b, self.Mixed_6c, self.Mixed_6d,
                 self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c)
        return x.float().mean(dim=(2, 3))


def preprocess(images_uint8: torch.Tensor, size: int = 299) -> torch.Tensor:
    x = images_uint8.permute(0, 3, 1, 2).float() / 255.0
    if tuple(x.shape[2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False)
    return x * 2.0 - 1.0
