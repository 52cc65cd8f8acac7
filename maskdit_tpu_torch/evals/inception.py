"""InceptionV3 feature extractor for FID / IS / sFID / P&R, NCHW.

Counterpart of maskdit_tpu/evals/inception.py: the TF-Slim InceptionV3
("inception-2015-12-05") in its FID variant, with the three pooling quirks
that tell the TF graph from torchvision's: count_include_pad=False average
pools in the A, C and E blocks, and a max pool in ``Mixed_7c``'s pool
branch. Module names give ``state_dict()`` the keys of the community
``pt_inception-2015-12-05`` file (``Mixed_5b.branch1x1.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ``fc.weight``, ...).

Per batch of uint8 NCHW images (any resolution; bilinear to 299, scaled to
[-1, 1]) it gives:
  pool    (N, 2048)  pool_3 features (FID, precision / recall);
  spatial (N, 2023)  ADM's sFID features: Mixed_6d's ReLU'd 1x1 branch,
                     first 7 channels, flattened in (H, W, C) order;
  logits  (N, 1008)  classifier logits (Inception Score).
The detector runs in fp32 with TF32 off (``utils.precision.exact_fp32``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from maskdit_tpu_torch.utils.precision import exact_fp32


class BasicConv(nn.Module):
    """conv (no bias) + frozen batch norm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_tf(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool that divides by the pixels inside the
    image (TF's, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_tf(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        """Returns the block's output and its 1x1 branch (the sFID tap)."""
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_tf(x))
        return torch.cat([b1, b7, bd, bp], dim=1), b1


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool`` is 'avg' (Mixed_7b, count_include_pad=False) or 'max'
    (Mixed_7c: TF's graph max-pools here, torchvision average-pools)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool == "avg":
            bp = _avg_pool_tf(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """The FID InceptionV3; input NCHW float in [-1, 1] at 299x299."""

    def __init__(self, num_logits: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
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
        self.fc = nn.Linear(2048, num_logits)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6a(x)
        x, _ = self.Mixed_6b(x)
        x, _ = self.Mixed_6c(x)
        # ADM's sFID tap, TF node "mixed_6/conv:0" (reference evaluator.py:36)
        x, branch1x1 = self.Mixed_6d(x)
        x, _ = self.Mixed_6e(x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool = x.mean(dim=(2, 3))
        n = x.shape[0]
        return {
            "pool": pool,
            # ADM flattens the NHWC TF tensor: published mu_s / sigma_s
            # index the features in (H, W, C) order
            "spatial": branch1x1[:, :7].permute(0, 2, 3, 1).reshape(n, -1),
            "logits": self.fc(pool),
        }


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 NCHW (any size) -> float NCHW at 299x299 in [-1, 1]: bilinear
    with half-pixel centres and no antialias, the function
    ``jax.image.resize(..., 'bilinear', antialias=False)`` computes."""
    x = images.float()
    if x.shape[-2:] != (299, 299):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=False)
    return x / 127.5 - 1.0


def random_state_dict(seed: int = 0, num_logits: int = 1008) -> dict[str, torch.Tensor]:
    """Random detector weights for ``--random_detector`` (machinery runs;
    the metrics they give are meaningless): He-normal convs, an identity
    batch norm, a LeCun-normal ``fc`` with a zero bias, all from ``seed`` on
    the CPU."""
    g = torch.Generator().manual_seed(seed)
    state = InceptionV3(num_logits).state_dict()
    state["fc.bias"].zero_()
    for key, value in state.items():
        if key.endswith("conv.weight") or key == "fc.weight":
            fan_in = math.prod(value.shape[1:])
            gain = 1.0 if key == "fc.weight" else 2.0
            value.copy_(torch.randn(value.shape, generator=g) * math.sqrt(gain / fan_in))
    return state


class Detector:
    """uint8 NCHW numpy images -> dict of float32 numpy features, computed
    on ``device``."""

    def __init__(self, state_dict: Optional[dict], device="cuda"):
        self.device = torch.device(device)
        net = InceptionV3()
        net.load_state_dict(random_state_dict(0) if state_dict is None else state_dict,
                            strict=True)
        self.net = net.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, images) -> dict[str, np.ndarray]:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with exact_fp32():
            out = self.net(preprocess(x))
        return {k: v.cpu().numpy() for k, v in out.items()}


def make_detector(state_dict: Optional[dict], device="cuda") -> Detector:
    """The detector with ``state_dict`` (pytorch-fid layout), or with
    ``random_state_dict(0)`` where it is None."""
    return Detector(state_dict, device)
