"""PointNet++ (SSG) semantic segmentation of the raw radar point cloud, the
`pn2` point-cloud branch (counterpart of achelous_tpu/models/pointnet2.py).

The canonical pointnet2_sem_seg: 4 set-abstraction levels (npoint 128 /
32 / 8 / 4, radius 0.1 / 0.2 / 0.4 / 0.8, nsample 32 / 32 / 32 / 16 on
512-point radar frames) and 4 feature-propagation levels, then a 2-layer
head.  Attribute names are the canonical module's (`sa1.mlp_convs.0`,
`sa1.mlp_bns.0`, `fp4.mlp_convs.0`, `conv1`, `bn1`, `conv2`); the set
abstraction's 1x1 convs are `Conv2d` over [B, C, K, S] groups and the
feature propagation's `Conv1d` over [B, C, N], as there.  The public
layout is the JAX package's: points in as [B, N, C], log-probabilities
out as [B, N, classes].  xyz stays float32 whatever the compute dtype;
each MLP takes its input in the dtype of its weights.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.pointops import (index_points, sample_and_group,
                                             square_distance)

SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
FP_MLPS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))


def _mlp(conv, cin: int, widths: Sequence[int]):
    convs, bns = nn.ModuleList(), nn.ModuleList()
    for w in widths:
        convs.append(conv(cin, w, 1))
        bns.append(BatchNorm(w))
        cin = w
    return convs, bns


def _run_mlp(x: torch.Tensor, convs, bns) -> torch.Tensor:
    x = x.to(convs[0].weight.dtype)
    for conv, bn in zip(convs, bns):
        x = F.relu(bn(conv(x)))
    return x


class SetAbstraction(nn.Module):
    """FPS centres, ball-query groups, a shared MLP per point and a max
    over each group."""

    def __init__(self, npoint: int, radius: float, nsample: int, cin: int,
                 mlp: Sequence[int]):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_convs, self.mlp_bns = _mlp(nn.Conv2d, cin + 3, mlp)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor]):
        """xyz [B,N,3], feats [B,N,C] -> (centres [B,S,3], [B,S,mlp[-1]])."""
        new_xyz, grouped = sample_and_group(self.npoint, self.radius,
                                            self.nsample, xyz, feats)
        x = _run_mlp(grouped.permute(0, 3, 2, 1), self.mlp_convs,
                     self.mlp_bns)                           # [B,C,K,S]
        return new_xyz, x.amax(dim=2).transpose(1, 2)


class FeaturePropagation(nn.Module):
    """Inverse-distance interpolation from the 3 nearest sparse points,
    concat with the skip features, shared MLP."""

    def __init__(self, cin: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp_convs, self.mlp_bns = _mlp(nn.Conv1d, cin, mlp)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                feats1: Optional[torch.Tensor], feats2: torch.Tensor):
        """Interpolate feats2 [B,S,C2] at xyz2 [B,S,3] onto xyz1 [B,N,3],
        concat after feats1 [B,N,C1] -> [B,N,mlp[-1]]."""
        b, n, _ = xyz1.shape
        s = xyz2.shape[1]
        if s == 1:
            interp = feats2.expand(b, n, feats2.shape[-1])
        else:
            # nearest first; a stable sort puts the lower index first on
            # equal distances, as jax.lax.top_k does
            d2, idx = square_distance(xyz1, xyz2).sort(dim=-1, stable=True)
            k = min(3, s)
            w = 1.0 / (d2[..., :k] + 1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            neigh = index_points(feats2, idx[..., :k])       # [B,N,k,C2]
            interp = (neigh * w[..., None]).sum(dim=2)
        x = interp if feats1 is None else torch.cat(
            [feats1.to(interp.dtype), interp], dim=-1)
        x = _run_mlp(x.transpose(1, 2), self.mlp_convs, self.mlp_bns)
        return x.transpose(1, 2)


class PointNet2Seg(nn.Module):
    # flax holds every 1x1 conv of PointNet++ as a Dense kernel
    FLAX_KIND = {"": "dense"}

    def __init__(self, num_classes: int, channel: int = 5,
                 npoints: Sequence[int] = (128, 32, 8, 4),
                 radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
                 nsamples: Sequence[int] = (32, 32, 32, 16)):
        super().__init__()
        cin = channel
        for i, (npoint, radius, nsample, mlp) in enumerate(
                zip(npoints, radii, nsamples, SA_MLPS), 1):
            setattr(self, f"sa{i}",
                    SetAbstraction(npoint, radius, nsample, cin, mlp))
            cin = mlp[-1]
        # fp4 runs first: sparse level 4 onto level 3, skip = level-3 feats
        skips = (0,) + tuple(m[-1] for m in SA_MLPS[:3])
        below = SA_MLPS[3][-1]
        for lvl in range(4, 0, -1):
            mlp = FP_MLPS[4 - lvl]
            setattr(self, f"fp{lvl}",
                    FeaturePropagation(skips[lvl - 1] + below, mlp))
            below = mlp[-1]
        self.conv1 = nn.Conv1d(below, 128, 1)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv1d(128, num_classes, 1)

    def forward(self, points: torch.Tensor):
        """points [B, N, C], xyz in the first 3 channels -> (log-probs
        [B, N, classes], None)."""
        xyzs, feats = [points[..., :3].float()], [points]
        for i in range(1, 5):
            nxyz, nf = getattr(self, f"sa{i}")(xyzs[-1], feats[-1])
            xyzs.append(nxyz)
            feats.append(nf)
        f = feats[4]
        for lvl in range(3, -1, -1):
            f = getattr(self, f"fp{lvl + 1}")(
                xyzs[lvl], xyzs[lvl + 1], feats[lvl] if lvl > 0 else None, f)
        x = F.relu(self.bn1(self.conv1(f.transpose(1, 2))))
        x = self.conv2(x).transpose(1, 2)
        return F.log_softmax(x, dim=-1), None
