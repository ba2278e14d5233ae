"""PoolFormer backbone (`pf`), NCHW (counterpart of
achelous_tpu/models/poolformer.py; reference
backbone/vision/poolformer_modules/poolformer.py:65-216,244-430 and its
Achelous S0/S1/S2 subclasses, :546-595).

A MetaFormer whose token mixer is avg_pool(3, count_include_pad=False) - x:
at the border the pool averages only the pixels inside the map.  The norm
is GroupNorm with one group (statistics over C, H, W; a per-channel
affine).  Each stage's output goes through its own GroupNorm
(`norm{2i}`).  Keys are the reference's: `patch_embed.proj`,
`network.{2i}.{j}.{norm1,norm2,mlp.fc1,mlp.fc2,layer_scale_1,
layer_scale_2}`, `network.{2i+1}.proj`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm1(nn.GroupNorm):
    """torch GroupNorm(1, C), eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__(1, channels, eps=1e-5)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class PoolFormerBlock(nn.Module):
    def __init__(self, dim: int, pool_size: int = 3, mlp_ratio: float = 4.0,
                 layer_scale_init_value: float = 1e-5):
        super().__init__()
        self.pool_size = pool_size
        self.norm1 = GroupNorm1(dim)
        self.norm2 = GroupNorm1(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(
            torch.full((dim,), layer_scale_init_value))
        self.layer_scale_2 = nn.Parameter(
            torch.full((dim,), layer_scale_init_value))

    def forward(self, x):
        k = self.pool_size
        y = self.norm1(x)
        pooled = F.avg_pool2d(y, k, 1, k // 2, count_include_pad=False)
        x = x + self.layer_scale_1[:, None, None] * (pooled - y)
        return x + self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """A strided conv (`proj`): the 7x7 stride-4 stem (padding 2) and the
    3x3 stride-2 downsampling between stages (padding 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 padding: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, k, stride, padding)

    def forward(self, x):
        return self.proj(x)


class PoolFormer(nn.Module):
    def __init__(self, layers: Sequence[int], embed_dims: Sequence[int],
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4),
                 layer_scale_init_value: float = 1e-5, in_chans: int = 3):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dims[0], 7, 4, 2)
        network = []
        for i, dim in enumerate(embed_dims):
            network.append(nn.Sequential(*(
                PoolFormerBlock(dim, mlp_ratio=mlp_ratios[i],
                                layer_scale_init_value=layer_scale_init_value)
                for _ in range(layers[i]))))
            if i < 3:
                network.append(PatchEmbed(dim, embed_dims[i + 1], 3, 2, 1))
            setattr(self, f"norm{2 * i}", GroupNorm1(dim))
        self.network = nn.ModuleList(network)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        feats = []
        for i in range(4):
            x = self.network[2 * i](x)
            feats.append(getattr(self, f"norm{2 * i}")(x))
            if i < 3:
                x = self.network[2 * i + 1](x)
        return tuple(feats)


# (layers, embed_dims, layer_scale_init_value) of poolformer_S0/S1/S2
VARIANTS = {
    "S0": ((2, 2, 6, 2), (32, 48, 96, 176), 1e-5),
    "S1": ((4, 4, 12, 4), (32, 48, 120, 224), 1e-5),
    "S2": ((6, 6, 18, 6), (32, 64, 144, 288), 1e-6),
}


def poolformer(phi: str, in_chans: int = 3) -> PoolFormer:
    layers, dims, ls = VARIANTS[phi]
    return PoolFormer(layers, dims, layer_scale_init_value=ls,
                      in_chans=in_chans)
