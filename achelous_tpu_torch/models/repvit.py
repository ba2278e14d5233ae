"""RepViT backbone (`rv`), NCHW (counterpart of achelous_tpu/models/repvit.py;
reference backbone/vision/repvit_modules/repvit.py:31-371).

MobileNet-style blocks whose stride-1 token mixer is a reparameterizable
RepVGGDW (depthwise 3x3 + depthwise 1x1 + identity).  The features are the
outputs at the variant's `out_slices` (slice 0 is the patch embedding).
Keys are the reference's: `features.0.{0,2}` (the stem's Conv2d_BN pairs,
`c` and `bn`), `features.{i+1}.token_mixer.{0,1,2}`,
`features.{i+1}.channel_mixer.m.{0,2}`.  The squeeze-excite follows timm
0.6.7: round(c * 0.25) channels, 1x1 convs with bias.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm


def conv2d_bn(cin: int, cout: int, k: int = 1, stride: int = 1,
              groups: int = 1, bn_zero: bool = False) -> nn.Sequential:
    """The reference's Conv2d_BN: bias-free conv (padding (k-1)//2) + BN,
    keys `c`, `bn`; `bn_zero` starts the BN's scale at 0."""
    bn = BatchNorm(cout)
    if bn_zero:
        nn.init.zeros_(bn.weight)
    return nn.Sequential(OrderedDict(
        c=nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                    bias=False),
        bn=bn))


class TimmSqueezeExcite(nn.Module):
    """timm 0.6.7 SqueezeExcite: global mean, 1x1 reduce to round(c / 4)
    (Python's round, half to even), ReLU, 1x1 expand, sigmoid scale."""
    # flax holds both 1x1 convs as Dense kernels
    FLAX_KIND = {"conv_reduce": "dense", "conv_expand": "dense"}

    def __init__(self, channels: int, rd_ratio: float = 0.25):
        super().__init__()
        rd = round(channels * rd_ratio)
        self.conv_reduce = nn.Conv2d(channels, rd, 1)
        self.conv_expand = nn.Conv2d(rd, channels, 1)

    def forward(self, x):
        s = self.conv_expand(F.relu(self.conv_reduce(
            x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class RepVGGDW(nn.Module):
    """Depthwise 3x3 conv+BN + depthwise 1x1 conv+BN + the input; deploy:
    one depthwise 3x3 conv (`reparam_conv`)."""

    def __init__(self, dim: int, deploy: bool = False):
        super().__init__()
        if deploy:
            self.reparam_conv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)
            return
        self.conv = conv2d_bn(dim, dim, 3, groups=dim)
        self.conv1 = conv2d_bn(dim, dim, 1, groups=dim)

    def forward(self, x):
        if hasattr(self, "reparam_conv"):
            return self.reparam_conv(x)
        return self.conv(x) + self.conv1(x) + x


class Residual(nn.Module):
    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x):
        return x + self.m(x)


class RepViTBlock(nn.Module):
    def __init__(self, inp: int, oup: int, kernel_size: int = 3,
                 stride: int = 1, use_se: bool = False, deploy: bool = False):
        super().__init__()
        se = TimmSqueezeExcite(inp) if use_se else nn.Identity()
        if stride == 2:
            self.token_mixer = nn.Sequential(
                conv2d_bn(inp, inp, kernel_size, 2, groups=inp), se,
                conv2d_bn(inp, oup, 1))
        else:
            # stride 1 keeps the width (oup == inp): RepVGGDW mixer
            self.token_mixer = nn.Sequential(RepVGGDW(inp, deploy), se)
        self.channel_mixer = Residual(nn.Sequential(
            conv2d_bn(oup, 2 * oup, 1), nn.GELU(),
            conv2d_bn(2 * oup, oup, 1, bn_zero=True)))

    def forward(self, x):
        return self.channel_mixer(self.token_mixer(x))


# (c, use_se, stride) per block, and the out_slices (repvit.py:262-371)
CFGS = {
    "S0": ([(32, 1, 1), (32, 0, 1), (32, 0, 1), (48, 0, 2), (48, 1, 1),
            (48, 0, 1), (48, 0, 1), (96, 0, 2)] +
           [(96, se, 1) for se in (1, 0) * 7] + [(96, 0, 1)] +
           [(176, 0, 2), (176, 1, 1), (176, 0, 1)],
           (2, 6, 22, 25)),
    "S1": ([(32, 1, 1), (32, 0, 1), (32, 0, 1), (48, 0, 2), (48, 1, 1),
            (48, 0, 1), (48, 0, 1), (120, 0, 2)] +
           [(120, se, 1) for se in (1, 0) * 6] + [(120, 0, 1)] +
           [(224, 0, 2), (224, 1, 1), (224, 0, 1)],
           (2, 6, 20, 24)),
    "S2": ([(32, 1, 1), (32, 0, 1), (32, 1, 1), (32, 0, 1), (32, 0, 1),
            (64, 0, 2), (64, 1, 1), (64, 0, 1), (64, 1, 1), (64, 0, 1),
            (64, 0, 1), (144, 0, 2)] +
           [(144, se, 1) for se in (1, 0) * 9] + [(144, 0, 1)] +
           [(288, 0, 2), (288, 1, 1), (288, 0, 1)],
           (4, 10, 30, 34)),
}


class RepViT(nn.Module):
    def __init__(self, phi: str = "S0", in_chans: int = 3,
                 deploy: bool = False):
        super().__init__()
        cfg, self.out_slices = CFGS[phi]
        c0 = cfg[0][0]
        layers = [nn.Sequential(conv2d_bn(in_chans, c0 // 2, 3, 2),
                                nn.GELU(), conv2d_bn(c0 // 2, c0, 3, 2))]
        cin = c0
        for c, use_se, s in cfg:
            layers.append(RepViTBlock(cin, c, 3, s, bool(use_se), deploy))
            cin = c
        self.features = nn.ModuleList(layers)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        outputs = []
        for layer in self.features:
            x = layer(x)
            outputs.append(x)
        return tuple(outputs[i] for i in self.out_slices)
