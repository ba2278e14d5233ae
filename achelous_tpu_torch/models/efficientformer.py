"""EfficientFormerV2 backbone (`ef`), NCHW (counterpart of
achelous_tpu/models/efficientformer.py; the reference's ImageEncoder).

Hybrid conv + 4D attention with learned relative-position bias tables and
talking heads: stride-2 attention in the last blocks of stage 2, plain
attention in the last blocks of stage 3, and an attention-downsample
embedding between them.  Attribute names are the reference's
(`patch_embed`, `network.{2i}.{j}.token_mixer.q.0`, `...layer_scale_1`,
`network.5.attn.q.local.0`, `norm{0,2,4,6}`, ...), so reference state dicts
and `achelous_mapping(phi, "ef", ...)` name these parameters.  The bias
index tables are non-persistent buffers, built from the feature
resolution.  BatchNorm eps 1e-5; GELU is exact.

Attention4D's core goes through K3 (`ops/hopper_attention.py`); the
downsampling attention is plain PyTorch, as it is plain XLA in the JAX
package.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.core.config import WIDTHS
from achelous_tpu_torch.ops.hopper_attention import fused_bias_attention
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.param_cache import ParamCache
from achelous_tpu_torch.ops.resize import resize_bilinear

DEPTHS = {"L": (5, 5, 15, 10), "S2": (4, 4, 12, 8), "S1": (3, 3, 9, 6),
          "S0": (2, 2, 6, 4)}
EXPANSION_RATIOS = {
    "L": {0: [4, 4, 4, 4, 4], 1: [4, 4, 4, 4, 4],
          2: [4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4],
          3: [4, 4, 4, 3, 3, 3, 3, 4, 4, 4]},
    "S2": {0: [4, 4, 4, 4], 1: [4, 4, 4, 4],
           2: [4, 4, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4], 3: [4, 4, 3, 3, 3, 3, 4, 4]},
    "S1": {0: [4, 4, 4], 1: [4, 4, 4], 2: [4, 4, 3, 3, 3, 3, 4, 4, 4],
           3: [4, 4, 3, 3, 4, 4]},
    "S0": {0: [4, 4], 1: [4, 4], 2: [4, 3, 3, 3, 4, 4], 3: [4, 3, 3, 4]},
}
VIT_NUM = {"L": 6, "S2": 4, "S1": 2, "S0": 2}


@functools.lru_cache(maxsize=None)
def bias_idxs_same(resolution: int) -> Tuple[np.ndarray, int]:
    """Attention4D bias index table [N, N] over a res x res grid, and the
    number of distinct offsets (ImageEncoder.py:108-121)."""
    points = list(itertools.product(range(resolution), range(resolution)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n), len(offsets)


@functools.lru_cache(maxsize=None)
def bias_idxs_down(resolution: int) -> Tuple[np.ndarray, int]:
    """Attention4DDownsample bias index table [N2, N], queries on the
    stride-2 grid, and the number of distinct offsets (:238-257)."""
    res2 = math.ceil(resolution / 2)
    points = list(itertools.product(range(resolution), range(resolution)))
    points_ = list(itertools.product(range(res2), range(res2)))
    offsets, idxs = {}, []
    k = math.ceil(resolution / res2)
    for p1 in points_:
        for p2 in points:
            off = (abs(p1[0] * k - p2[0]), abs(p1[1] * k - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return (np.asarray(idxs, np.int64).reshape(len(points_), len(points)),
            len(offsets))


def conv_bn(cin: int, cout: int, k: int, stride: int = 1,
            groups: int = 1) -> nn.Sequential:
    """Conv (with bias, padding (k-1)//2) + BatchNorm: keys `.0`, `.1`."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                   groups=groups), BatchNorm(cout))


def _proj(cin: int, cout: int) -> nn.Sequential:
    """GELU, 1x1 conv, BatchNorm: keys `.1`, `.2`."""
    return nn.Sequential(nn.GELU(), nn.Conv2d(cin, cout, 1), BatchNorm(cout))


def _bias_table(module: nn.Module, idxs: np.ndarray, n_off: int):
    module.attention_biases = nn.Parameter(
        torch.zeros(module.num_heads, n_off))
    module.register_buffer("attention_bias_idxs", torch.from_numpy(idxs),
                           persistent=False)


class Attention4D(nn.Module):
    """Multi-head attention over a res x res map with a relative-position
    bias and talking heads; with `stride`, a depthwise stride conv first and
    a bilinear resize back to `resolution` after."""
    # flax holds the head mixes as [h, h] parameters
    FLAX_KIND = {"talking_head1": "param", "talking_head2": "param"}

    def __init__(self, dim: int, key_dim: int = 32, num_heads: int = 8,
                 attn_ratio: int = 4, resolution: int = 7,
                 stride: Optional[int] = None):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = attn_ratio * key_dim
        self.resolution = resolution
        self.res = resolution
        self.stride_conv = None
        if stride is not None:
            self.res = math.ceil(resolution / stride)
            self.stride_conv = conv_bn(dim, dim, 3, stride, groups=dim)
        nh_kd, dh = key_dim * num_heads, self.d * num_heads
        self.q = conv_bn(dim, nh_kd, 1)
        self.k = conv_bn(dim, nh_kd, 1)
        self.v = conv_bn(dim, dh, 1)
        self.v_local = conv_bn(dh, dh, 3, groups=dh)
        self.talking_head1 = nn.Conv2d(num_heads, num_heads, 1)
        self.talking_head2 = nn.Conv2d(num_heads, num_heads, 1)
        self.proj = _proj(dh, dim)
        _bias_table(self, *bias_idxs_same(self.res))
        self._kernel_args = ParamCache()

    def _apply(self, fn, *args, **kwargs):
        self._kernel_args.clear()
        return super()._apply(fn, *args, **kwargs)

    def kernel_args(self, dt: torch.dtype):
        """(bias [h,N,N], th1_w, th1_b, th2_w, th2_b) as K3 takes them: the
        gathered bias table and the head mixes (weights [g_out, h_in]) in
        the compute dtype `dt`, as the JAX package rounds them.  Built once
        and again only when a parameter changes (ops/param_cache.py)."""
        h = self.num_heads
        tensors = (self.attention_biases, self.attention_bias_idxs,
                   self.talking_head1.weight, self.talking_head1.bias,
                   self.talking_head2.weight, self.talking_head2.bias)

        def build():
            mix = []
            for c in (self.talking_head1, self.talking_head2):
                mix += [c.weight.reshape(h, h).to(dt), c.bias.to(dt)]
            return (self.attention_biases[:, self.attention_bias_idxs].to(dt),
                    *mix)

        return self._kernel_args.get(tensors, build, dt)

    def forward(self, x):
        if self.stride_conv is not None:
            x = self.stride_conv(x)
        b, h, n = x.shape[0], self.num_heads, self.res * self.res

        def heads(t, c):                       # [B, h*c, res, res] -> [B,h,N,c]
            return t.reshape(b, h, c, n).transpose(2, 3).contiguous()

        v = self.v(x)
        v_local = self.v_local(v)
        out = fused_bias_attention(
            heads(self.q(x), self.key_dim), heads(self.k(x), self.key_dim),
            heads(v, self.d), *self.kernel_args(x.dtype),
            self.key_dim ** -0.5)
        out = out.transpose(2, 3).reshape(b, h * self.d, self.res, self.res)
        out = out + v_local
        if self.stride_conv is not None:
            out = resize_bilinear(out, (self.resolution, self.resolution),
                                  align_corners=False)
        return self.proj(out)


class LGQuery(nn.Module):
    """Local-global query: stride-2 depthwise conv plus stride-2
    subsampling, then a 1x1 conv + BN."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.local = nn.Sequential(nn.Conv2d(in_dim, in_dim, 3, 2, 1,
                                             groups=in_dim))
        self.proj = conv_bn(in_dim, out_dim, 1)

    def forward(self, x):
        return self.proj(self.local(x) + x[:, :, ::2, ::2])


class Attention4DDownsample(nn.Module):
    """Attention from the stride-2 grid of queries onto every position;
    plain softmax attention with a relative-position bias."""

    def __init__(self, dim: int, out_dim: int, resolution: int,
                 key_dim: int = 16, num_heads: int = 8, attn_ratio: int = 4):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = attn_ratio * key_dim
        self.res, self.res2 = resolution, math.ceil(resolution / 2)
        nh_kd, dh = key_dim * num_heads, self.d * num_heads
        self.q = LGQuery(dim, nh_kd)
        self.k = conv_bn(dim, nh_kd, 1)
        self.v = conv_bn(dim, dh, 1)
        self.v_local = conv_bn(dh, dh, 3, stride=2, groups=dh)
        self.proj = _proj(dh, out_dim)
        _bias_table(self, *bias_idxs_down(resolution))

    def forward(self, x):
        b, h = x.shape[0], self.num_heads
        n, n2 = self.res * self.res, self.res2 * self.res2
        q = self.q(x).reshape(b, h, self.key_dim, n2).transpose(2, 3)
        k = self.k(x).reshape(b, h, self.key_dim, n)
        v = self.v(x)
        v_local = self.v_local(v)
        bias = self.attention_biases[:, self.attention_bias_idxs].to(x.dtype)
        attn = (q @ k) * self.key_dim ** -0.5 + bias
        out = attn.softmax(dim=-1) @ v.reshape(b, h, self.d, n).transpose(2, 3)
        out = out.transpose(2, 3).reshape(b, h * self.d, self.res2, self.res2)
        return self.proj(out + v_local)


class Mlp4D(nn.Module):
    """1x1 conv + BN, GELU, depthwise 3x3 conv + BN, GELU, 1x1 conv + BN."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.norm1 = BatchNorm(hidden)
        self.mid = nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.mid_norm = BatchNorm(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.norm2 = BatchNorm(dim)

    def forward(self, x):
        x = F.gelu(self.norm1(self.fc1(x)))
        x = F.gelu(self.mid_norm(self.mid(x)))
        return self.norm2(self.fc2(x))


class EFBlock(nn.Module):
    """FFN block, or attention + FFN block, each branch scaled by a layer
    scale that starts at 1e-5."""
    # flax keeps the layer scales as [dim] vectors: no weight decay
    FLAX_KIND = {"layer_scale_1": "vector", "layer_scale_2": "vector"}

    def __init__(self, dim: int, mlp_ratio: float, use_attn: bool,
                 resolution: int, stride: Optional[int] = None):
        super().__init__()
        self.token_mixer = None
        if use_attn:
            self.token_mixer = Attention4D(dim, resolution=resolution,
                                           stride=stride)
            self.layer_scale_1 = nn.Parameter(torch.full((dim, 1, 1), 1e-5))
        self.mlp = Mlp4D(dim, int(dim * mlp_ratio))
        self.layer_scale_2 = nn.Parameter(torch.full((dim, 1, 1), 1e-5))

    def forward(self, x):
        if self.token_mixer is not None:
            x = x + self.layer_scale_1 * self.token_mixer(x)
        return x + self.layer_scale_2 * self.mlp(x)


class Embedding(nn.Module):
    """Stride-2 3x3 conv + BN between stages 0-1 and 1-2."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 3, 2, 1)
        self.norm = BatchNorm(cout)

    def forward(self, x):
        return self.norm(self.proj(x))


class AttnEmbedding(nn.Module):
    """Downsampling attention plus a stride-2 3x3 conv + BN, stage 2-3."""

    def __init__(self, cin: int, cout: int, resolution: int):
        super().__init__()
        self.attn = Attention4DDownsample(cin, cout, resolution)
        self.conv = nn.Conv2d(cin, cout, 3, 2, 1)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.attn(x) + self.bn(self.conv(x))


class EfficientFormerV2(nn.Module):
    """Stem, 4 stages with their downsampling embeddings, and a BatchNorm
    on each stage's output.  Returns the 4 stage outputs at strides
    4/8/16/32 of a `resolution`-square input."""

    def __init__(self, phi: str = "S0", resolution: int = 320,
                 in_chans: int = 3):
        super().__init__()
        dims, layers = WIDTHS[phi], DEPTHS[phi]
        vit_num = VIT_NUM[phi]
        self.patch_embed = nn.Sequential(
            nn.Conv2d(in_chans, dims[0] // 2, 3, 2, 1), BatchNorm(dims[0] // 2),
            nn.GELU(),
            nn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1), BatchNorm(dims[0]),
            nn.GELU())
        network = []
        for i in range(4):
            res = math.ceil(resolution / 2 ** (i + 2))
            blocks = []
            for j in range(layers[i]):
                use_attn = i >= 2 and j > layers[i] - 1 - vit_num
                blocks.append(EFBlock(
                    dims[i], EXPANSION_RATIOS[phi][i][j], use_attn, res,
                    stride=2 if use_attn and i == 2 else None))
            network.append(nn.Sequential(*blocks))
            if i < 2:
                network.append(Embedding(dims[i], dims[i + 1]))
            elif i == 2:
                network.append(AttnEmbedding(dims[i], dims[i + 1], res))
            setattr(self, f"norm{2 * i}", BatchNorm(dims[i]))
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
