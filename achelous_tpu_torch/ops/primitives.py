"""Conv / norm / attention building blocks, NCHW (counterpart of
achelous_tpu/ops/primitives.py).

Attribute names follow the reference torch modules, so the keys of a
reference state dict (and of `achelous_tpu.utils.torch_import`'s mapping)
name these parameters:
  - ConvBN          BaseConv / DWConv   (`conv` or `conv.dconv`/`conv.pconv`, `bn`)
  - YoloConv        neck/spp.py Conv    (`conv`, `bn`)
  - GhostModule     ghost_conv.py       (`primary_conv.{0,1}`, `cheap_operation.{0,1}`)
  - GhostBottleneck ghost_conv.py       (`ghost1`, `ghost2`, `shortcut.{0..3}`)
  - SPP, SPPF       neck/spp.py         (`cv1`, `cv2`)
  - Upsample        ghostdualfpn.py     (`upsample.0`)
  - ECA             eca.py              (`conv`)
  - ShuffleAttention shuffle_attention.py (`cweight` ... `gn`)

The JAX package's `DepthwiseConvFMA` and `ops/smallconv.py` are TPU
workarounds; the depthwise convs here are plain grouped `nn.Conv2d`s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.resize import upsample2x


def act_fn(name: str | None):
    """Activation by name, as the JAX package names them; GELU is exact."""
    if name is None or name == "none":
        return lambda x: x
    return {
        "relu": F.relu,
        "silu": F.silu,
        "lrelu": lambda x: F.leaky_relu(x, 0.1),
        "gelu": F.gelu,
        "hswish": F.hardswish,
        "sigmoid": torch.sigmoid,
    }[name]


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max-pool with symmetric padding k//2."""
    return F.max_pool2d(x, k, 1, k // 2)


def avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(k, 1, padding=k//2) with count_include_pad=True (also the
    JAX package's channels-first `avg_pool_same_cf`: the port is NCHW)."""
    return F.avg_pool2d(x, k, 1, k // 2, count_include_pad=True)


class _DWConv(nn.Module):
    """Depthwise k x k then pointwise 1x1, both bias-free."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.dconv = nn.Conv2d(cin, cin, k, 1, (k - 1) // 2, groups=cin,
                               bias=False)
        self.pconv = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class ConvBN(nn.Module):
    """Conv + BatchNorm(eps 1e-3, momentum 0.03) + activation `act`;
    `ds_conv=True` makes the conv a depthwise-separable pair."""

    def __init__(self, cin: int, features: int, kernel: int = 1,
                 ds_conv: bool = False, act: str = "relu"):
        super().__init__()
        self.act = act_fn(act)
        if ds_conv:
            self.conv = _DWConv(cin, features, kernel)
        else:
            self.conv = nn.Conv2d(cin, features, kernel, 1, (kernel - 1) // 2,
                                  bias=False)
        self.bn = BatchNorm(features, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class YoloConv(nn.Module):
    """conv + BN(eps 1e-3, momentum 0.03) + SiLU."""

    def __init__(self, cin: int, features: int, kernel: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, 1, kernel // 2,
                              bias=False)
        self.bn = BatchNorm(features, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class GhostModule(nn.Module):
    """1x1 primary conv to ceil(oup/2) channels, a cheap depthwise 3x3 conv
    for as many more, concat and slice to `oup`."""

    def __init__(self, inp: int, oup: int, relu: bool = True):
        super().__init__()
        self.oup = oup
        init_ch = math.ceil(oup / 2)
        act = nn.ReLU() if relu else nn.Identity()
        self.primary_conv = nn.Sequential(
            nn.Conv2d(inp, init_ch, 1, bias=False), BatchNorm(init_ch), act)
        self.cheap_operation = nn.Sequential(
            nn.Conv2d(init_ch, init_ch, 3, 1, 1, groups=init_ch, bias=False),
            BatchNorm(init_ch), act)

    def forward(self, x):
        x1 = self.primary_conv(x)
        x2 = self.cheap_operation(x1)
        return torch.cat([x1, x2], dim=1)[:, :self.oup]


class GhostBottleneck(nn.Module):
    """Stride-1 ghost bottleneck of the GDF neck; the shortcut projection
    appears whenever in != out."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int):
        super().__init__()
        self.ghost1 = GhostModule(in_chs, mid_chs, relu=True)
        self.ghost2 = GhostModule(mid_chs, out_chs, relu=False)
        if in_chs == out_chs:
            self.shortcut = nn.Identity()
        else:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_chs, in_chs, 3, 1, 1, groups=in_chs, bias=False),
                BatchNorm(in_chs),
                nn.Conv2d(in_chs, out_chs, 1, bias=False),
                BatchNorm(out_chs))

    def forward(self, x):
        return self.ghost2(self.ghost1(x)) + self.shortcut(x)


class SPP(nn.Module):
    """1x1 reduce, {5,9,13} max-pools, concat, 1x1 expand."""

    POOLS = (5, 9, 13)

    def __init__(self, cin: int, c2: int):
        super().__init__()
        c_ = cin // 2
        self.cv1 = YoloConv(cin, c_)
        self.cv2 = YoloConv(c_ * (len(self.POOLS) + 1), c2)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [max_pool_same(x, k)
                                         for k in self.POOLS], dim=1))


class SPPF(nn.Module):
    """1x1 reduce, three serial 5x5 max-pools, concat of the four, 1x1
    expand; the same parameters as SPP."""

    K = 5

    def __init__(self, cin: int, c2: int):
        super().__init__()
        c_ = cin // 2
        self.cv1 = YoloConv(cin, c_)
        self.cv2 = YoloConv(c_ * 4, c2)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(max_pool_same(outs[-1], self.K))
        return self.cv2(torch.cat(outs, dim=1))


class _Upsample2x(nn.Module):
    def forward(self, x):
        return upsample2x(x, align_corners=True)


class Upsample(nn.Module):
    """1x1 ConvBN(relu) then bilinear align-corners 2x."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.upsample = nn.Sequential(ConvBN(cin, features, 1),
                                      _Upsample2x())

    def forward(self, x):
        return self.upsample(x)


class ECA(nn.Module):
    """Efficient channel attention: global average pool, then a 1-D conv
    along the channel axis with an odd kernel taken from log2(C)."""

    def __init__(self, channels: int):
        super().__init__()
        k = int(abs((math.log(channels, 2) + 1) / 2))
        k = k if k % 2 else k + 1
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        w = self.conv(x.mean((2, 3))[:, None, :])        # [B, 1, C]
        return x * torch.sigmoid(w)[:, 0, :, None, None]


class ShuffleAttention(nn.Module):
    """Channels split as (G, 2, C/2G): the first half of each group gets
    channel attention (global-pool scale), the second spatial attention
    (per-channel instance norm); then a 2-group channel shuffle."""

    G = 4
    # flax keeps these as [C/2G] vectors ("flat" in the JAX mapping), so
    # they take no weight decay (core/init.py flax_kinds)
    FLAX_KIND = dict.fromkeys(("cweight", "cbias", "sweight", "sbias"),
                              "vector")

    def __init__(self, channels: int):
        super().__init__()
        c2g = channels // (2 * self.G)
        self.cweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.cbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.sweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.sbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.gn = nn.GroupNorm(c2g, c2g)

    def forward(self, x):
        b, c, h, w = x.shape
        c2g = c // (2 * self.G)
        xg = x.reshape(b, self.G, 2, c2g, h, w)
        x0, x1 = xg[:, :, 0], xg[:, :, 1]                # [b, G, c2g, h, w]

        def p(t):
            return t.view(1, 1, c2g, 1, 1).to(x.dtype)

        s = x0.mean((3, 4), keepdim=True)
        x0 = x0 * torch.sigmoid(p(self.cweight) * s + p(self.cbias))

        mu = x1.mean((3, 4), keepdim=True)
        var = (x1 - mu).square().mean((3, 4), keepdim=True)
        xn = (x1 - mu) * torch.rsqrt(var + 1e-5)
        xn = p(self.gn.weight) * xn + p(self.gn.bias)
        xn = p(self.sweight) * xn + p(self.sbias)
        x1 = x1 * torch.sigmoid(xn)

        out = torch.stack([x0, x1], dim=2).reshape(b, c, h, w)
        # channel shuffle with 2 groups
        return out.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(
            b, c, h, w)
