"""Independent torch mirror of the pytorch_fid InceptionV3 graph.

The port's own copy of the JAX package's mirror (autodiffusion_tpu/fid/
torch_mirror.py): a straight re-implementation of the network pytorch_fid
builds for pt_inception-2015-12-05-6726825d.pth (BasicConv2d = conv +
BN(eps 1e-3) + relu, count_include_pad=False average pools, the max-pool
branch in Mixed_7c / FIDInceptionE_2, 1008-way logits head), with the
batch norms as modules and the checkpoint's own keys, where the port's
``FIDInceptionV3`` folds each BN into its conv. ``adt-torch selftest``
(fid/selftest.py) holds the port's network to it, with synthesized weights
here and with the genuine checkpoint wherever that file is at hand.

Reference: evaluations/evaluator_v1.py:160-175,665-679 (TF backend) and
sd/scripts/search_ea.py:95-182 (pytorch_fid backend).
"""

from __future__ import annotations

__all__ = ["build_torch_mirror", "load_mirror_state"]


def _modules():
    import torch
    import torch.nn.functional as F
    from torch import nn

    class TBasicConv2d(nn.Module):
        def __init__(self, cin, cout, **kw):
            super().__init__()
            self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
            self.bn = nn.BatchNorm2d(cout, eps=1e-3)

        def forward(self, x):
            return F.relu(self.bn(self.conv(x)))

    def _avg_cif(x):
        return F.avg_pool2d(x, 3, stride=1, padding=1,
                            count_include_pad=False)

    class TInceptionA(nn.Module):
        def __init__(self, cin, pool_features):
            super().__init__()
            self.branch1x1 = TBasicConv2d(cin, 64, kernel_size=1)
            self.branch5x5_1 = TBasicConv2d(cin, 48, kernel_size=1)
            self.branch5x5_2 = TBasicConv2d(48, 64, kernel_size=5, padding=2)
            self.branch3x3dbl_1 = TBasicConv2d(cin, 64, kernel_size=1)
            self.branch3x3dbl_2 = TBasicConv2d(64, 96, kernel_size=3, padding=1)
            self.branch3x3dbl_3 = TBasicConv2d(96, 96, kernel_size=3, padding=1)
            self.branch_pool = TBasicConv2d(cin, pool_features, kernel_size=1)

        def forward(self, x):
            b1 = self.branch1x1(x)
            b5 = self.branch5x5_2(self.branch5x5_1(x))
            bd = self.branch3x3dbl_3(
                self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
            bp = self.branch_pool(_avg_cif(x))
            return torch.cat([b1, b5, bd, bp], 1)

    class TInceptionB(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.branch3x3 = TBasicConv2d(cin, 384, kernel_size=3, stride=2)
            self.branch3x3dbl_1 = TBasicConv2d(cin, 64, kernel_size=1)
            self.branch3x3dbl_2 = TBasicConv2d(64, 96, kernel_size=3, padding=1)
            self.branch3x3dbl_3 = TBasicConv2d(96, 96, kernel_size=3, stride=2)

        def forward(self, x):
            b3 = self.branch3x3(x)
            bd = self.branch3x3dbl_3(
                self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
            bp = F.max_pool2d(x, 3, stride=2)
            return torch.cat([b3, bd, bp], 1)

    class TInceptionC(nn.Module):
        def __init__(self, cin, c7):
            super().__init__()
            self.branch1x1 = TBasicConv2d(cin, 192, kernel_size=1)
            self.branch7x7_1 = TBasicConv2d(cin, c7, kernel_size=1)
            self.branch7x7_2 = TBasicConv2d(c7, c7, kernel_size=(1, 7),
                                            padding=(0, 3))
            self.branch7x7_3 = TBasicConv2d(c7, 192, kernel_size=(7, 1),
                                            padding=(3, 0))
            self.branch7x7dbl_1 = TBasicConv2d(cin, c7, kernel_size=1)
            self.branch7x7dbl_2 = TBasicConv2d(c7, c7, kernel_size=(7, 1),
                                               padding=(3, 0))
            self.branch7x7dbl_3 = TBasicConv2d(c7, c7, kernel_size=(1, 7),
                                               padding=(0, 3))
            self.branch7x7dbl_4 = TBasicConv2d(c7, c7, kernel_size=(7, 1),
                                               padding=(3, 0))
            self.branch7x7dbl_5 = TBasicConv2d(c7, 192, kernel_size=(1, 7),
                                               padding=(0, 3))
            self.branch_pool = TBasicConv2d(cin, 192, kernel_size=1)

        def forward(self, x):
            b1 = self.branch1x1(x)
            b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
            bd = self.branch7x7dbl_5(self.branch7x7dbl_4(
                self.branch7x7dbl_3(self.branch7x7dbl_2(
                    self.branch7x7dbl_1(x)))))
            bp = self.branch_pool(_avg_cif(x))
            return torch.cat([b1, b7, bd, bp], 1)

    class TInceptionD(nn.Module):
        def __init__(self, cin):
            super().__init__()
            self.branch3x3_1 = TBasicConv2d(cin, 192, kernel_size=1)
            self.branch3x3_2 = TBasicConv2d(192, 320, kernel_size=3, stride=2)
            self.branch7x7x3_1 = TBasicConv2d(cin, 192, kernel_size=1)
            self.branch7x7x3_2 = TBasicConv2d(192, 192, kernel_size=(1, 7),
                                              padding=(0, 3))
            self.branch7x7x3_3 = TBasicConv2d(192, 192, kernel_size=(7, 1),
                                              padding=(3, 0))
            self.branch7x7x3_4 = TBasicConv2d(192, 192, kernel_size=3, stride=2)

        def forward(self, x):
            b3 = self.branch3x3_2(self.branch3x3_1(x))
            b7 = self.branch7x7x3_4(self.branch7x7x3_3(
                self.branch7x7x3_2(self.branch7x7x3_1(x))))
            bp = F.max_pool2d(x, 3, stride=2)
            return torch.cat([b3, b7, bp], 1)

    class TInceptionE(nn.Module):
        def __init__(self, cin, pool_type):
            super().__init__()
            self.pool_type = pool_type
            self.branch1x1 = TBasicConv2d(cin, 320, kernel_size=1)
            self.branch3x3_1 = TBasicConv2d(cin, 384, kernel_size=1)
            self.branch3x3_2a = TBasicConv2d(384, 384, kernel_size=(1, 3),
                                             padding=(0, 1))
            self.branch3x3_2b = TBasicConv2d(384, 384, kernel_size=(3, 1),
                                             padding=(1, 0))
            self.branch3x3dbl_1 = TBasicConv2d(cin, 448, kernel_size=1)
            self.branch3x3dbl_2 = TBasicConv2d(448, 384, kernel_size=3,
                                               padding=1)
            self.branch3x3dbl_3a = TBasicConv2d(384, 384, kernel_size=(1, 3),
                                                padding=(0, 1))
            self.branch3x3dbl_3b = TBasicConv2d(384, 384, kernel_size=(3, 1),
                                                padding=(1, 0))
            self.branch_pool = TBasicConv2d(cin, 192, kernel_size=1)

        def forward(self, x):
            b1 = self.branch1x1(x)
            b3 = self.branch3x3_1(x)
            b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
            bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
            bd = torch.cat([self.branch3x3dbl_3a(bd),
                            self.branch3x3dbl_3b(bd)], 1)
            if self.pool_type == "avg":
                bp = _avg_cif(x)
            else:
                # FID quirk: Mixed_7c uses a max pool
                # (pytorch_fid FIDInceptionE_2)
                bp = F.max_pool2d(x, 3, stride=1, padding=1)
            bp = self.branch_pool(bp)
            return torch.cat([b1, b3, bd, bp], 1)

    class TorchFIDInception(nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv2d_1a_3x3 = TBasicConv2d(3, 32, kernel_size=3, stride=2)
            self.Conv2d_2a_3x3 = TBasicConv2d(32, 32, kernel_size=3)
            self.Conv2d_2b_3x3 = TBasicConv2d(32, 64, kernel_size=3, padding=1)
            self.Conv2d_3b_1x1 = TBasicConv2d(64, 80, kernel_size=1)
            self.Conv2d_4a_3x3 = TBasicConv2d(80, 192, kernel_size=3)
            self.Mixed_5b = TInceptionA(192, 32)
            self.Mixed_5c = TInceptionA(256, 64)
            self.Mixed_5d = TInceptionA(288, 64)
            self.Mixed_6a = TInceptionB(288)
            self.Mixed_6b = TInceptionC(768, 128)
            self.Mixed_6c = TInceptionC(768, 160)
            self.Mixed_6d = TInceptionC(768, 160)
            self.Mixed_6e = TInceptionC(768, 192)
            self.Mixed_7a = TInceptionD(768)
            self.Mixed_7b = TInceptionE(1280, "avg")
            self.Mixed_7c = TInceptionE(2048, "max")
            self.fc = nn.Linear(2048, 1008)

        def forward(self, x):
            x = self.Conv2d_1a_3x3(x)
            x = self.Conv2d_2a_3x3(x)
            x = self.Conv2d_2b_3x3(x)
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Conv2d_3b_1x1(x)
            x = self.Conv2d_4a_3x3(x)
            x = F.max_pool2d(x, 3, stride=2)
            x = self.Mixed_5b(x)
            x = self.Mixed_5c(x)
            x = self.Mixed_5d(x)
            x = self.Mixed_6a(x)
            x = self.Mixed_6b(x)
            x = self.Mixed_6c(x)
            x = self.Mixed_6d(x)
            x = self.Mixed_6e(x)
            spatial = x[:, :7]
            x = self.Mixed_7a(x)
            x = self.Mixed_7b(x)
            x = self.Mixed_7c(x)
            pool3 = x.mean(dim=(2, 3))
            return {"pool3": pool3, "spatial": spatial,
                    "logits": self.fc(pool3)}

    return TorchFIDInception


def build_torch_mirror():
    """Fresh mirror model in eval mode (requires torch)."""
    return _modules()().eval()


def load_mirror_state(model, path: str):
    """Strict-layout state_dict load: the ONLY keys a genuine pytorch_fid
    checkpoint may lack are the num_batches_tracked BN buffers; any other
    mismatch means the file is not a pt_inception checkpoint."""
    import torch

    missing, unexpected = model.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True),
        strict=False)
    if unexpected:
        raise ValueError(f"unexpected keys in checkpoint: {unexpected[:5]}")
    bad = [k for k in missing if not k.endswith("num_batches_tracked")]
    if bad:
        raise ValueError(f"missing keys in checkpoint: {bad[:5]}")
    return model
