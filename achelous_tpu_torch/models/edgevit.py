"""EdgeViT backbone (`ev`), NCHW (counterpart of
achelous_tpu/models/edgevit.py; reference
backbone/vision/edgevit_modules/edgevit.py:12-360).

Local-Global-Local blocks: a conv-attention `LocalAgg` where sr_ratio > 1,
then `SelfAttn`, whose `GlobalSparseAttn` subsamples the tokens by a
strided slice (the reference's AvgPool2d(1, sr) keeps every sr-th pixel:
it averages one pixel), attends among them, and spreads the result back
with a non-overlapping depthwise ConvTranspose2d (`LocalProp`) and a
LayerNorm.  As in the reference, the features of stages 1-3 are taken
right after each patch embedding, before the stage's blocks; the last is
the final stage's output through a BatchNorm.  Keys are the reference's:
`patch_embed{i}.{proj,norm}`, `blocks{i}.{j}.LocalAgg.*`,
`blocks{i}.{j}.SelfAttn.*`, `norm`.  The attention is plain PyTorch, as
it is plain XLA in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm


def depthwise_conv_transpose(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, sr: int) -> torch.Tensor:
    """ConvTranspose2d(k=sr, stride=sr, groups=C): each pixel of x
    [B,C,h,w] becomes an sr x sr patch scaled by its channel's kernel
    (weight [C,1,sr,sr])."""
    return F.conv_transpose2d(x, weight, bias, stride=sr,
                              groups=x.shape[1])


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, conv: bool):
        super().__init__()
        layer = (lambda a, b: nn.Conv2d(a, b, 1)) if conv else nn.Linear
        self.fc1 = layer(dim, hidden)
        self.fc2 = layer(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class GlobalSparseAttn(nn.Module):
    """Multi-head attention among every sr-th token ([B, N, C] in and
    out)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads, self.sr = num_heads, sr_ratio
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.LocalProp = nn.ConvTranspose2d(dim, dim, sr_ratio, sr_ratio,
                                                groups=dim)
            # a plain nn.LayerNorm in the reference: torch's eps 1e-5
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        sr = self.sr
        if sr > 1:
            x = x.reshape(b, h, w, c)[:, ::sr, ::sr].reshape(b, -1, c)
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, -1, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # [B, h, n, hd]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, -1)
        x = (attn @ v).transpose(1, 2).reshape(b, -1, c)
        if sr > 1:
            x = x.transpose(1, 2).reshape(b, c, h // sr, w // sr)
            x = depthwise_conv_transpose(x, self.LocalProp.weight,
                                         self.LocalProp.bias, sr)
            x = self.norm(x.flatten(2).transpose(1, 2))
        return self.proj(x)


class LocalAgg(nn.Module):
    """Conv attention: depthwise 3x3 position embedding, BN, 1x1, depthwise
    5x5, 1x1 (residual), then BN + 1x1 MLP (residual)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.pos_embed = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)
        self.norm1 = BatchNorm(dim)
        self.conv1 = nn.Conv2d(dim, dim, 1)
        self.attn = nn.Conv2d(dim, dim, 5, 1, 2, groups=dim)
        self.conv2 = nn.Conv2d(dim, dim, 1)
        self.norm2 = BatchNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), conv=True)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x))))
        return x + self.mlp(self.norm2(x))


class SelfAttn(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.pos_embed = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = GlobalSparseAttn(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), conv=False)

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)                     # [B, N, C]
        t = t + self.attn(self.norm1(t), h, w)
        t = t + self.mlp(self.norm2(t))
        return t.transpose(1, 2).reshape(b, c, h, w)


class LGLBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.LocalAgg = (LocalAgg(dim, mlp_ratio) if sr_ratio > 1
                         else nn.Identity())
        self.SelfAttn = SelfAttn(dim, num_heads, sr_ratio, mlp_ratio)

    def forward(self, x):
        return self.SelfAttn(self.LocalAgg(x))


class PatchEmbed(nn.Module):
    """Non-overlapping patch conv + LayerNorm over the channels (a plain
    nn.LayerNorm in the reference: eps 1e-5)."""

    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class EdgeViT(nn.Module):
    def __init__(self, depth: Sequence[int], embed_dim: Sequence[int],
                 head_dim: int, sr_ratios: Sequence[int] = (4, 2, 2, 1),
                 mlp_ratio: float = 4.0, in_chans: int = 3):
        super().__init__()
        cin = in_chans
        for i, dim in enumerate(embed_dim):
            heads = max(dim // head_dim, 1)
            setattr(self, f"patch_embed{i + 1}",
                    PatchEmbed(cin, dim, 4 if i == 0 else 2))
            setattr(self, f"blocks{i + 1}", nn.ModuleList(
                LGLBlock(dim, heads, sr_ratios[i], mlp_ratio)
                for _ in range(depth[i])))
            cin = dim
        self.norm = BatchNorm(embed_dim[-1])

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"patch_embed{i}")(x)
            if i < 4:
                feats.append(x)
            for block in getattr(self, f"blocks{i}"):
                x = block(x)
        feats.append(self.norm(x))
        return tuple(feats)


# (depth, embed_dim, head_dim) of edgevit_xxs / xs / s (edgevit.py:332-360)
VARIANTS = {
    "S0": ((1, 1, 3, 2), (32, 48, 96, 176), 20),
    "S1": ((1, 1, 3, 1), (32, 48, 120, 224), 32),
    "S2": ((1, 2, 5, 3), (32, 64, 144, 288), 32),
}


def edgevit(phi: str, in_chans: int = 3) -> EdgeViT:
    depth, dims, head_dim = VARIANTS[phi]
    return EdgeViT(depth, dims, head_dim, in_chans=in_chans)
