"""CSP blocks of the `cdf` neck, NCHW (counterpart of
achelous_tpu/ops/blocks.py `Bottleneck` and `CSPLayer`; reference
neck/cspdualfpn.py:42-78).

Attribute names are the reference's (`conv1`, `conv2`, `conv3`, `m.{i}`),
each a `ConvBN` (`conv`, `bn`), so reference state dicts and the JAX
package's `dualfpn_neck_mapping(phi, "cdf")` name these parameters.
`RepVGGBlock` comes with the `rdf` neck.
"""
from __future__ import annotations

import torch
from torch import nn

from achelous_tpu_torch.ops.primitives import ConvBN


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
