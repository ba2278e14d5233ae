"""Composite blocks of the necks, NCHW (counterpart of
achelous_tpu/ops/blocks.py): the CSP blocks of the `cdf` neck
(`Bottleneck`, `CSPLayer`; reference neck/cspdualfpn.py:42-78) and the
reparameterizable `RepVGGBlock` of the `rdf` neck (reference
backbone/conv_utils/repvgg_conv.py:40-165).

Attribute names are the reference's (`conv1`, `conv2`, `conv3`, `m.{i}`,
each a `ConvBN` (`conv`, `bn`); `rbr_dense`, `rbr_1x1`, `rbr_identity`,
`rbr_reparam`), so reference state dicts and the JAX package's
`dualfpn_neck_mapping(phi, ...)` name these parameters.

`RepVGGBlock(deploy=True)` is the single fused 3x3 conv; the train-form
state is folded into it by `core/reparam.py`, a pure state-dict transform.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.primitives import ConvBN


def rep_branch(cin: int, cout: int, k: int, stride: int = 1,
               groups: int = 1) -> nn.Sequential:
    """A bias-free k x k conv (padding k//2) + BatchNorm(eps 1e-5): keys
    `conv`, `bn`, the branch of every reparameterizable block."""
    return nn.Sequential(OrderedDict(
        conv=nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                       bias=False),
        bn=BatchNorm(cout)))


class Bottleneck(nn.Module):
    """1x1 reduce + 3x3, with the input added where the widths agree."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "silu"):
        super().__init__()
        hidden = int(features * expansion)
        self.conv1 = ConvBN(cin, hidden, 1, act=act)
        # conv2 is built WITHOUT an act argument in the reference
        # (cspdualfpn.py:47), so it takes BaseConv's default ReLU, not SiLU
        self.conv2 = ConvBN(hidden, features, 3, act="relu")
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add else y


class CSPLayer(nn.Module):
    """Cross-stage partial fuse: two 1x1 branches, `n` bottlenecks on the
    first, concat, 1x1 to `features`."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu"):
        super().__init__()
        hidden = int(features * expansion)
        self.conv1 = ConvBN(cin, hidden, 1, act=act)
        self.conv2 = ConvBN(cin, hidden, 1, act=act)
        self.conv3 = ConvBN(2 * hidden, features, 1, act=act)
        self.m = nn.Sequential(*(Bottleneck(hidden, hidden, shortcut, 1.0, act)
                                 for _ in range(n)))

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)],
                                    dim=1))


class RepVGGBlock(nn.Module):
    """Train form: 3x3 conv+BN + 1x1 conv+BN + BN of the input (where the
    widths agree and the stride is 1), then ReLU.  Deploy form: one 3x3
    conv with bias (`rbr_reparam`), then ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 groups: int = 1, deploy: bool = False):
        super().__init__()
        if deploy:
            self.rbr_reparam = nn.Conv2d(cin, features, 3, stride, 1,
                                         groups=groups)
            return
        self.rbr_dense = rep_branch(cin, features, 3, stride, groups)
        self.rbr_1x1 = rep_branch(cin, features, 1, stride, groups)
        if cin == features and stride == 1:
            self.rbr_identity = BatchNorm(cin)

    def forward(self, x):
        if hasattr(self, "rbr_reparam"):
            return F.relu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if hasattr(self, "rbr_identity"):
            y = y + self.rbr_identity(x)
        return F.relu(y)
