"""FastViT backbone (`fv`, RDF neck only), NCHW (counterpart of
achelous_tpu/models/fastvit.py; reference
backbone/vision/fastvit_modules/fastvit.py:63-1016 and
modules/replknet.py:13-130).

RepMixer token mixing + ConvFFN + reparameterizable large-kernel
downsampling; the MHSA stages and RepCPE are built for completeness (the
S0-S2 variants are all RepMixer).  A stem of three MobileOne blocks in
GELU, then 4 stages, each output through a BatchNorm (`norm{2i}`).  Keys
are the reference's: `patch_embed.{0,1,2}`, `network.{2i}.{j}` (blocks:
`token_mixer.{norm,mixer,layer_scale}`, `convffn.{conv,fc1,fc2}`,
`layer_scale`), `network.{2i+1}.proj.{0,1}` (ReparamLargeKernelConv +
MobileOne 1x1).  With `deploy`, every reparameterizable module is its
single conv (`reparam_conv`, `lkb_reparam`), filled by `core/reparam.py`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.blocks import rep_branch
from achelous_tpu_torch.ops.mobileone_block import MobileOneBlock
from achelous_tpu_torch.ops.norm import BatchNorm

LAYER_SCALE_INIT = 1e-5


def _layer_scale(dim: int) -> nn.Parameter:
    return nn.Parameter(torch.full((dim, 1, 1), LAYER_SCALE_INIT))


class ReparamLargeKernelConv(nn.Module):
    """k x k conv+BN plus a small-kernel conv+BN, summed.  The reference's
    forward calls its activation and discards the result (replknet.py:88;
    GELU is not in place), so the block is linear; so is this one, so that
    reference weights forward the same."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int, groups: int, small_kernel: int = 3,
                 deploy: bool = False):
        super().__init__()
        k = kernel_size
        if deploy:
            self.lkb_reparam = nn.Conv2d(cin, features, k, stride, k // 2,
                                         groups=groups)
            return
        self.lkb_origin = rep_branch(cin, features, k, stride, groups)
        self.small_conv = rep_branch(cin, features, small_kernel, stride,
                                     groups)

    def forward(self, x):
        if hasattr(self, "lkb_reparam"):
            return self.lkb_reparam(x)
        return self.lkb_origin(x) + self.small_conv(x)


class RepMixer(nn.Module):
    """x + layer_scale * (mixer(x) - norm(x)), both depthwise MobileOne
    blocks without activation; deploy: one depthwise conv."""
    # flax keeps the layer scale as a [dim] vector
    FLAX_KIND = {"layer_scale": "vector"}

    def __init__(self, dim: int, kernel_size: int = 3, deploy: bool = False):
        super().__init__()
        k = kernel_size
        if deploy:
            self.reparam_conv = nn.Conv2d(dim, dim, k, 1, k // 2, groups=dim)
            return
        self.norm = MobileOneBlock(dim, dim, k, groups=dim, use_act=False,
                                   use_scale_branch=False,
                                   num_conv_branches=0)
        self.mixer = MobileOneBlock(dim, dim, k, groups=dim, use_act=False)
        self.layer_scale = _layer_scale(dim)

    def forward(self, x):
        if hasattr(self, "reparam_conv"):
            return self.reparam_conv(x)
        return x + self.layer_scale * (self.mixer(x) - self.norm(x))


class ConvFFN(nn.Module):
    """Depthwise 7x7 conv+BN, 1x1 expand, GELU, 1x1 project."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.conv = rep_branch(cin, out, 7, groups=cin)
        self.fc1 = nn.Conv2d(out, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, out, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.conv(x))))


class MHSA(nn.Module):
    """Multi-head self-attention over the map's pixels (head_dim 32, no
    qkv bias); plain PyTorch, as it is plain XLA in the JAX package."""

    def __init__(self, dim: int, head_dim: int = 32):
        super().__init__()
        self.head_dim = head_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, c, h, w = x.shape
        heads = c // self.head_dim
        t = x.flatten(2).transpose(1, 2)                     # [B, N, C]
        qkv = self.qkv(t).reshape(b, -1, 3, heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # [B, h, N, d]
        attn = torch.softmax((q * self.head_dim ** -0.5) @ k.transpose(-2, -1),
                             -1)
        o = (attn @ v).transpose(1, 2).reshape(b, h * w, c)
        return self.proj(o).transpose(1, 2).reshape(b, c, h, w)


class RepCPE(nn.Module):
    """Conditional positional encoding: a depthwise conv plus the input;
    deploy: one depthwise conv."""

    def __init__(self, dim: int, spatial: int = 7, deploy: bool = False):
        super().__init__()
        conv = nn.Conv2d(dim, dim, spatial, 1, spatial // 2, groups=dim)
        if deploy:
            self.reparam_conv = conv
        else:
            self.pe = conv

    def forward(self, x):
        if hasattr(self, "reparam_conv"):
            return self.reparam_conv(x)
        return self.pe(x) + x


class RepMixerBlock(nn.Module):
    FLAX_KIND = {"layer_scale": "vector"}

    def __init__(self, dim: int, mlp_ratio: float, deploy: bool = False):
        super().__init__()
        self.token_mixer = RepMixer(dim, deploy=deploy)
        self.convffn = ConvFFN(dim, int(dim * mlp_ratio), dim)
        self.layer_scale = _layer_scale(dim)

    def forward(self, x):
        x = self.token_mixer(x)
        return x + self.layer_scale * self.convffn(x)


class AttentionBlock(nn.Module):
    FLAX_KIND = {"layer_scale_1": "vector", "layer_scale_2": "vector"}

    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.norm = BatchNorm(dim)
        self.token_mixer = MHSA(dim)
        self.convffn = ConvFFN(dim, int(dim * mlp_ratio), dim)
        self.layer_scale_1 = _layer_scale(dim)
        self.layer_scale_2 = _layer_scale(dim)

    def forward(self, x):
        x = x + self.layer_scale_1 * self.token_mixer(self.norm(x))
        return x + self.layer_scale_2 * self.convffn(x)


class PatchEmbed(nn.Module):
    """Stride-2 ReparamLargeKernelConv (7x7, 8 groups) + MobileOne 1x1."""

    def __init__(self, cin: int, cout: int, deploy: bool = False):
        super().__init__()
        self.proj = nn.Sequential(
            ReparamLargeKernelConv(cin, cout, 7, 2, groups=8, deploy=deploy),
            MobileOneBlock(cout, cout, 1, act="gelu", deploy=deploy))

    def forward(self, x):
        return self.proj(x)


class FastViT(nn.Module):
    def __init__(self, layers: Sequence[int], embed_dims: Sequence[int],
                 mlp_ratios: Sequence[float],
                 token_mixers: Sequence[str] = ("repmixer",) * 4,
                 pos_embs: Sequence[bool] = (False,) * 4, in_chans: int = 3,
                 deploy: bool = False):
        super().__init__()
        d0 = embed_dims[0]
        self.patch_embed = nn.Sequential(
            MobileOneBlock(in_chans, d0, 3, stride=2, act="gelu",
                           deploy=deploy),
            MobileOneBlock(d0, d0, 3, stride=2, groups=d0, act="gelu",
                           deploy=deploy),
            MobileOneBlock(d0, d0, 1, act="gelu", deploy=deploy))
        network = []
        for i, dim in enumerate(embed_dims):
            if pos_embs[i]:
                setattr(self, f"pos_emb{i}", RepCPE(dim, deploy=deploy))
            network.append(nn.Sequential(*(
                RepMixerBlock(dim, mlp_ratios[i], deploy=deploy)
                if token_mixers[i] == "repmixer"
                else AttentionBlock(dim, mlp_ratios[i])
                for _ in range(layers[i]))))
            if i < 3:
                network.append(PatchEmbed(dim, embed_dims[i + 1], deploy))
            setattr(self, f"norm{2 * i}", BatchNorm(dim))
        self.network = nn.ModuleList(network)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        feats = []
        for i in range(4):
            pos = getattr(self, f"pos_emb{i}", None)
            if pos is not None:
                x = pos(x)
            x = self.network[2 * i](x)
            feats.append(getattr(self, f"norm{2 * i}")(x))
            if i < 3:
                x = self.network[2 * i + 1](x)
        return tuple(feats)


# (layers, embed_dims, mlp_ratios) of fastvit_s0/s1/s2 (fastvit.py:957-1016)
VARIANTS = {
    "S0": ((2, 2, 4, 2), (32, 48, 96, 176), (3, 3, 3, 3)),
    "S1": ((2, 2, 6, 2), (32, 48, 120, 224), (3, 3, 3, 3)),
    "S2": ((2, 2, 6, 2), (32, 64, 144, 288), (4, 4, 4, 4)),
}


def fastvit(phi: str, in_chans: int = 3, deploy: bool = False) -> FastViT:
    layers, dims, ratios = VARIANTS[phi]
    return FastViT(layers, dims, ratios, in_chans=in_chans, deploy=deploy)
