"""RCNet, the radar convolution network over the rasterised radar map, NCHW
(counterpart of achelous_tpu/models/rcnet.py).

8 RCBlocks (2 per stage): each runs a RadarConv (3x3 avg-pool + modulated
deformable conv), a 1x1 conv + BN + ReLU residual, then a stride-2 3x3 or
a 1x1 exit conv.  Features are tapped after blocks 3/5/7 at strides
8/16/32 with a quarter of the image widths.  At S0 the RadarConvs of
blocks 0-3 (C = 3, 8, 8, 8) are K1 launches and those of blocks 4-7
(C = 12, 12, 24, 24) use K2 (ops/deform.py DeformableConv2d).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.core.config import WIDTHS
from achelous_tpu_torch.ops.deform import DeformableConv2d
from achelous_tpu_torch.ops.norm import BatchNorm


class RadarConv(nn.Module):
    def __init__(self, cin: int, features: int, band: Optional[int] = None):
        super().__init__()
        self.deformable_conv = DeformableConv2d(cin, features, band=band)

    def forward(self, x):
        return self.deformable_conv(x)


class RCBlock(nn.Module):
    def __init__(self, cin: int, features: int, down: bool = False,
                 band: Optional[int] = None):
        super().__init__()
        self.radar_conv = RadarConv(cin, cin, band=band)
        self.weight_conv1 = nn.Conv2d(cin, cin, 1)
        self.norm = BatchNorm(cin)
        if down:
            self.weight_conv2 = nn.Conv2d(cin, features, 3, stride=2,
                                          padding=1)
        else:
            self.weight_conv2 = nn.Conv2d(cin, features, 1)

    def forward(self, x):
        y = F.relu(self.norm(self.weight_conv1(self.radar_conv(x))))
        return self.weight_conv2(x + y)


def block_specs(phi: str, in_channels: int = 3
                ) -> list[Tuple[int, int, bool]]:
    """(cin, features, down) of the 8 blocks:
    stage 0: (in -> w0/4, down), (w0/4 -> w0/4, down);
    stage i > 0: (w[i-1]/4 -> w[i-1]/4), (w[i-1]/4 -> w[i]/4, down)."""
    widths = WIDTHS[phi]
    specs = []
    cin = in_channels
    for i in range(4):
        if i == 0:
            outs = ((widths[0] // 4, True), (widths[0] // 4, True))
        else:
            outs = ((widths[i - 1] // 4, False), (widths[i] // 4, True))
        for feat, down in outs:
            specs.append((cin, feat, down))
            cin = feat
    return specs


class RCNet(nn.Module):
    """Returns (s8, s16, s32) channels-first features."""

    def __init__(self, phi: str = "S0", band: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.rc_blocks = nn.ModuleList(
            RCBlock(cin, feat, down=down, band=band)
            for cin, feat, down in block_specs(phi, in_channels))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, block in enumerate(self.rc_blocks):
            x = block(x)
            if i > 1 and i % 2 == 1:          # taps after blocks 3, 5, 7
                outs.append(x)
        return tuple(outs)
