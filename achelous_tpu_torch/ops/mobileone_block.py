"""MobileOne over-parameterized conv block, NCHW (counterpart of
achelous_tpu/ops/mobileone_block.py; shared by the `mo` backbone and
FastViT's stem, embeddings and token mixers).

Reference backbone/vision/mobileone_modules/mobileone.py:55-277 and
backbone/vision/fastvit_modules/modules/mobileone.py.  Train form:
`num_conv_branches` k x k conv+BN branches (`rbr_conv.{i}`), a 1x1 conv+BN
scale branch (`rbr_scale`, only for k > 1) and a BN of the input
(`rbr_skip`, only where the widths agree and the stride is 1), summed,
then the optional squeeze-excite (`se`) and activation.  Deploy form: one
conv with bias (`reparam_conv`), produced by `core/reparam.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.blocks import rep_branch
from achelous_tpu_torch.ops.norm import BatchNorm


class SEBlock(nn.Module):
    """Squeeze-excite: global mean, 1x1 reduce to int(C * rd_ratio), ReLU,
    1x1 expand, sigmoid scale."""
    # flax holds both 1x1 convs as Dense kernels
    FLAX_KIND = {"reduce": "dense", "expand": "dense"}

    def __init__(self, channels: int, rd_ratio: float = 0.0625):
        super().__init__()
        rd = int(channels * rd_ratio)
        self.reduce = nn.Conv2d(channels, rd, 1)
        self.expand = nn.Conv2d(rd, channels, 1)

    def forward(self, x):
        s = self.expand(F.relu(self.reduce(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MobileOneBlock(nn.Module):
    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, use_se: bool = False,
                 use_act: bool = True, use_scale_branch: bool = True,
                 num_conv_branches: int = 1, act: str = "relu",
                 deploy: bool = False):
        super().__init__()
        k = kernel_size
        self.use_act, self.act = use_act, act
        self.se = SEBlock(features) if use_se else None
        if deploy:
            self.reparam_conv = nn.Conv2d(cin, features, k, stride, k // 2,
                                          groups=groups)
            return
        if cin == features and stride == 1:
            self.rbr_skip = BatchNorm(cin)
        if use_scale_branch and k > 1:
            self.rbr_scale = rep_branch(cin, features, 1, stride, groups)
        if num_conv_branches:
            self.rbr_conv = nn.ModuleList(
                rep_branch(cin, features, k, stride, groups)
                for _ in range(num_conv_branches))

    def forward(self, x):
        if hasattr(self, "reparam_conv"):
            y = self.reparam_conv(x)
        else:
            y = self.rbr_skip(x) if hasattr(self, "rbr_skip") else 0.0
            if hasattr(self, "rbr_scale"):
                y = y + self.rbr_scale(x)
            for branch in getattr(self, "rbr_conv", ()):
                y = y + branch(x)
        if self.se is not None:
            y = self.se(y)
        if not self.use_act:
            return y
        return F.relu(y) if self.act == "relu" else F.gelu(y)
