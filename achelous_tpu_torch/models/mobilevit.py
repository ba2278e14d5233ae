"""MobileViT backbone (`mv`), NCHW (counterpart of
achelous_tpu/models/mobilevit.py; reference
backbone/vision/mobilevit_modules/mobilevit.py:7-240).

MV2 inverted residuals and MobileViT blocks: a local 3x3 conv, a 1x1
projection to `dim`, a transformer over the patch grid (attention batched
over the ph*pw positions of a patch, as the reference's einops rearrange
'b d (h ph) (w pw) -> b (ph pw) (h w) d'), a 1x1 projection back, concat
with the block's input and a 3x3 fuse.

Attribute names are the reference's (`conv1.0`, `mv2.{i}.conv.{j}`,
`mvit.{i}.transformer.layers.{t}.0.fn.to_qkv`, ...), so its state dicts
name these parameters.  The JAX package scans the transformer layers and
stores their parameters stacked on axis 0; here each layer is a module of
its own, and the JAX mapping's stacked entries (a stack index as each
entry's fifth element) carry one slice to each.  JAX's `jax.checkpoint`
of each layer is a training-memory device and is not ported.

LayerNorm (eps 1e-5) and the attention softmax run in the compute dtype,
as the flax modules do: LayerNorm's statistics in float32 and its output
in that dtype, the softmax of bf16 logits returned in bf16.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm


def conv_bn_silu(cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1) -> nn.Sequential:
    """Bias-free conv, BatchNorm (eps 1e-5), SiLU: the reference's
    conv_nxn_bn / conv_1x1_bn."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride, 1 if k == 3 else 0, groups=groups,
                  bias=False),
        BatchNorm(cout), nn.SiLU())


class MV2Block(nn.Module):
    """Inverted residual: 1x1 expand (unless expansion 1), depthwise 3x3
    (stride), 1x1 project; the input added at stride 1 and equal widths."""

    def __init__(self, inp: int, oup: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        hidden = int(inp * expansion)
        dw = conv_bn_silu(hidden, hidden, 3, stride, groups=hidden)
        pwl = [nn.Conv2d(hidden, oup, 1, bias=False), BatchNorm(oup)]
        pw = list(conv_bn_silu(inp, hidden)) if expansion != 1 else []
        self.conv = nn.Sequential(*pw, *dw, *pwl)
        self.use_res = stride == 1 and inp == oup

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Attention(nn.Module):
    """Multi-head self-attention over [B, P, N, D]."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x):
        b, p, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, p, n, 3, self.heads, self.dim_head)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)          # [B,P,h,N,dh] each
        attn = (q @ k.transpose(-1, -2)) * self.dim_head ** -0.5
        out = attn.softmax(-1) @ v
        return self.to_out(out.transpose(2, 3).reshape(b, p, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # indices 0 and 3 as in the reference (its dropouts sit at 2 and 4)
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.SiLU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class Transformer(nn.Module):
    """Pre-norm attention + feed-forward, each with a residual, `depth`
    times (JAX's TransformerBlock, one module a layer).  JAX's scan
    stacks each parameter of the layers into one leaf [depth, ...], so
    every one is of rank >= 2 there (decayed) and each Dense kernel of
    rank 3 (re-drawn by `weights_init` at the stack's fans): kind
    "stacked" (core/init.py)."""

    FLAX_KIND = {"layers": "stacked"}

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, Attention(dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim))]) for _ in range(depth))

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class MobileViTBlock(nn.Module):
    def __init__(self, channel: int, dim: int, depth: int, mlp_dim: int,
                 kernel_size: int = 3, patch_size: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.ph, self.pw = patch_size
        self.conv1 = conv_bn_silu(channel, channel, kernel_size)
        self.conv2 = conv_bn_silu(channel, dim)
        self.transformer = Transformer(dim, depth, 4, 8, mlp_dim)
        self.conv3 = conv_bn_silu(dim, channel)
        self.conv4 = conv_bn_silu(2 * channel, channel, kernel_size)

    def forward(self, x):
        y = x
        x = self.conv2(self.conv1(x))
        b, d, hh, ww = x.shape
        ph, pw = self.ph, self.pw
        h, w = hh // ph, ww // pw
        # 'b d (h ph) (w pw) -> b (ph pw) (h w) d'
        x = x.reshape(b, d, h, ph, w, pw).permute(0, 3, 5, 2, 4, 1).reshape(
            b, ph * pw, h * w, d)
        x = self.transformer(x)
        x = x.reshape(b, ph, pw, h, w, d).permute(0, 5, 3, 1, 4, 2).reshape(
            b, d, hh, ww)
        return self.conv4(torch.cat([self.conv3(x), y], dim=1))


class MobileViT(nn.Module):
    """Returns the feature maps at strides 4/8/16/32."""

    DEPTHS = (2, 4, 3)

    def __init__(self, dims: Sequence[int], channels: Sequence[int],
                 expansion: int = 4, in_chans: int = 3):
        super().__init__()
        c, d, L = channels, dims, self.DEPTHS
        self.conv1 = conv_bn_silu(in_chans, c[0], 3, 2)
        self.mv2 = nn.ModuleList([
            MV2Block(c[0], c[1], 1, expansion),
            MV2Block(c[1], c[2], 2, expansion),
            MV2Block(c[2], c[3], 1, expansion),
            MV2Block(c[3], c[3], 1, expansion),
            MV2Block(c[3], c[4], 2, expansion),
            MV2Block(c[5], c[6], 2, expansion),
            MV2Block(c[7], c[8], 2, expansion)])
        self.mvit = nn.ModuleList([
            MobileViTBlock(c[5], d[0], L[0], int(d[0] * 2)),
            MobileViTBlock(c[7], d[1], L[1], int(d[1] * 4)),
            MobileViTBlock(c[9], d[2], L[2], int(d[2] * 4))])
        self.conv2 = conv_bn_silu(c[9], c[10])

    def forward(self, x):
        x = self.conv1(x)
        for blk in self.mv2[:4]:
            x = blk(x)
        feat2 = x
        feat3 = x = self.mvit[0](self.mv2[4](x))
        feat4 = x = self.mvit[1](self.mv2[5](x))
        feat5 = self.conv2(self.mvit[2](self.mv2[6](x)))
        return feat2, feat3, feat4, feat5


MOBILEVIT_VARIANTS = {
    "S0": dict(dims=(64, 80, 96),
               channels=(16, 16, 32, 32, 48, 48, 96, 96, 96, 96, 176),
               expansion=2),
    "S1": dict(dims=(96, 120, 144),
               channels=(16, 32, 32, 32, 48, 48, 120, 120, 120, 120, 224)),
    "S2": dict(dims=(144, 192, 240),
               channels=(16, 32, 32, 32, 64, 64, 144, 144, 144, 144, 288)),
}


def mobilevit(phi: str, in_chans: int = 3) -> MobileViT:
    return MobileViT(**MOBILEVIT_VARIANTS[phi], in_chans=in_chans)
