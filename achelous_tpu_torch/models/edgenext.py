"""EdgeNeXt backbone, NCHW (counterpart of achelous_tpu/models/edgenext.py).

ConvNeXt-style conv encoders plus SDTA blocks with XCA cross-covariance
attention.  Attribute names are the reference's (`downsample_layers`,
`stages`, `dwconv`, `pwconv1`, `xca.qkv`, `pos_embd.token_projection`, ...),
so reference state dicts name these parameters.  LayerNorm eps is 1e-6 and
normalises over C; GELU is exact.  Returns the 4 stage outputs at strides
4/8/16/32.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


@functools.lru_cache(maxsize=None)
def _fourier_pos_table(h: int, w: int, hidden_dim: int = 32,
                       temperature: float = 10000.0) -> np.ndarray:
    """Static sinusoidal table [h, w, 2*hidden_dim] (a copy of the JAX
    package's table, so both sides feed the same numbers)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] / (h + eps) * scale
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] / (w + eps) * scale
    y = np.broadcast_to(y, (h, w))
    x = np.broadcast_to(x, (h, w))
    dim_t = np.arange(hidden_dim, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / hidden_dim)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    px = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                  axis=-1).reshape(h, w, -1)
    py = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                  axis=-1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1).astype(np.float32)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channel axis of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PositionalEncodingFourier(nn.Module):
    """Learned 1x1 projection of the static Fourier table -> [1, dim, h, w]."""

    # flax holds the projection as a Dense kernel
    FLAX_KIND = {"token_projection": "dense"}

    def __init__(self, dim: int, hidden_dim: int = 32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)

    def forward(self, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
        table = torch.from_numpy(_fourier_pos_table(h, w, self.hidden_dim))
        table = table.to(device=like.device, dtype=like.dtype)
        return self.token_projection(table.permute(2, 0, 1)[None])


class ConvEncoder(nn.Module):
    """Depthwise kxk, LN, 1x1 expand (x4), GELU, 1x1 project, layer scale,
    residual."""

    def __init__(self, dim: int, expan_ratio: int = 4, kernel_size: int = 7,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size,
                                padding=kernel_size // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, expan_ratio * dim)
        self.pwconv2 = nn.Linear(expan_ratio * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x):
        inp = x
        x = self.dwconv(x).permute(0, 2, 3, 1)             # NHWC
        x = self.pwconv2(F.gelu(self.pwconv1(self.norm(x))))
        return inp + (self.gamma * x).permute(0, 3, 1, 2)


class XCA(nn.Module):
    """Cross-covariance attention: q, k, v as [B, h, d, N] with q/k
    L2-normalised along N; attention over the d x d channel covariance."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):                                   # [B, N, C]
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 4, 1)                # [B, h, d, N]
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = (q @ k.transpose(-2, -1)) * self.temperature
        out = attn.softmax(dim=-1) @ v                      # [B, h, d, N]
        return self.proj(out.permute(0, 3, 1, 2).reshape(b, n, c))


class SDTAEncoder(nn.Module):
    """Split depthwise transpose attention: cascaded depthwise 3x3 over
    channel splits, XCA with layer scale, inverted-bottleneck MLP, one
    outer residual."""

    def __init__(self, dim: int, expan_ratio: int = 4, scales: int = 1,
                 use_pos_emb: bool = False, num_heads: int = 8,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.width = max(math.ceil(dim / scales), math.floor(dim // scales))
        self.nums = 1 if scales == 1 else scales - 1
        self.convs = nn.ModuleList(
            nn.Conv2d(self.width, self.width, 3, padding=1, groups=self.width)
            for _ in range(self.nums))
        self.pos_embd = PositionalEncodingFourier(dim) if use_pos_emb else None
        self.norm_xca = nn.LayerNorm(dim, eps=LN_EPS)
        self.gamma_xca = nn.Parameter(torch.full((dim,), layer_scale_init_value))
        self.xca = XCA(dim, num_heads=num_heads)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, expan_ratio * dim)
        self.pwconv2 = nn.Linear(expan_ratio * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x):                                   # [B, C, H, W]
        b, c, h, w = x.shape
        inp = x
        splits = torch.split(x, self.width, dim=1)
        outs = []
        sp = None
        for i, conv in enumerate(self.convs):
            sp = splits[i] if i == 0 else sp + splits[i]
            sp = conv(sp)
            outs.append(sp)
        x = torch.cat(outs + list(splits[self.nums:]), dim=1)

        if self.pos_embd is not None:
            x = x + self.pos_embd(h, w, x)
        t = x.reshape(b, c, h * w).transpose(1, 2)          # [B, N, C]
        t = t + self.gamma_xca * self.xca(self.norm_xca(t))
        x = t.reshape(b, h, w, c)                           # NHWC
        x = self.pwconv2(F.gelu(self.pwconv1(self.norm(x))))
        return inp + (self.gamma * x).permute(0, 3, 1, 2)


class EdgeNeXt(nn.Module):
    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 heads: Sequence[int], in_chans: int = 3,
                 global_block: Sequence[int] = (0, 1, 1, 1),
                 use_pos_embd_xca: Sequence[bool] = (False, True, False, False),
                 kernel_sizes: Sequence[int] = (3, 5, 7, 9),
                 d2_scales: Sequence[int] = (2, 2, 3, 4),
                 expan_ratio: int = 4):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(in_chans, dims[0], 4, stride=4),
            LayerNorm2d(dims[0], eps=LN_EPS))])
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[i - 1], eps=LN_EPS),
                nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList()
        for i in range(4):
            blocks = []
            for j in range(depths[i]):
                if j > depths[i] - global_block[i] - 1:
                    blocks.append(SDTAEncoder(
                        dims[i], expan_ratio=expan_ratio, scales=d2_scales[i],
                        use_pos_emb=use_pos_embd_xca[i], num_heads=heads[i]))
                else:
                    blocks.append(ConvEncoder(dims[i], expan_ratio=expan_ratio,
                                              kernel_size=kernel_sizes[i]))
            self.stages.append(nn.Sequential(*blocks))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
            feats.append(x)
        return tuple(feats)


EDGENEXT_VARIANTS = {
    "S0": functools.partial(EdgeNeXt, (2, 2, 6, 2), (32, 48, 96, 176),
                            (4, 4, 4, 4)),
    "S1": functools.partial(EdgeNeXt, (3, 3, 9, 3), (32, 48, 120, 224),
                            (4, 4, 4, 4)),
    "S2": functools.partial(EdgeNeXt, (3, 3, 9, 3), (32, 64, 144, 288),
                            (8, 8, 8, 8)),
}
