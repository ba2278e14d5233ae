"""PointNet semantic segmentation of the raw radar point cloud (counterpart
of achelous_tpu/models/pointnet.py).

Inside, points are channels-first [B, C, N] with `nn.Conv1d` 1x1 layers, as
in the reference (pointnet_utils.py / pointnet_sem_seg.py), whose attribute
names (`conv1`, `bn1`, `fc1`, `feat.stn`, ...) these modules keep.  The
public layout matches the JAX package: points in as [B, N, C], per-point
log-probabilities out as [B, N, classes].
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm


class STN(nn.Module):
    """Spatial transformer predicting a k x k alignment matrix."""

    def __init__(self, cin: int, k: int):
        super().__init__()
        self.k = k
        self.conv1 = nn.Conv1d(cin, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        for i, c in enumerate((64, 128, 1024, 512, 256), 1):
            setattr(self, f"bn{i}", BatchNorm(c))

    def forward(self, x):                                   # [B, C, N]
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = x.amax(dim=2)
        x = F.relu(self.bn4(self.fc1(x)))
        x = F.relu(self.bn5(self.fc2(x)))
        x = self.fc3(x)
        iden = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, -1)
        return (x + iden).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """Input and feature transforms; returns the 160-channel per-point
    features [B, 160, N] (128 global + 32 local) and the 32x32 transform."""

    def __init__(self, channel: int):
        super().__init__()
        self.stn = STN(channel, 3)
        self.conv1 = nn.Conv1d(channel, 32, 1)
        self.conv2 = nn.Conv1d(32, 64, 1)
        self.conv3 = nn.Conv1d(64, 128, 1)
        self.bn1 = BatchNorm(32)
        self.bn2 = BatchNorm(64)
        self.bn3 = BatchNorm(128)
        self.fstn = STN(32, 32)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:  # [B, C, N]
        n = x.shape[2]
        trans = self.stn(x)
        xyz = torch.bmm(x[:, :3].transpose(1, 2), trans).transpose(1, 2)
        x = torch.cat([xyz, x[:, 3:]], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        trans_feat = self.fstn(x)
        x = torch.bmm(x.transpose(1, 2), trans_feat).transpose(1, 2)
        pointfeat = x
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))
        gfeat = x.amax(dim=2, keepdim=True).expand(-1, -1, n)
        return torch.cat([gfeat, pointfeat], dim=1), trans_feat


class PointNetSeg(nn.Module):
    # flax holds every 1x1 conv of PointNet as a Dense kernel
    FLAX_KIND = {"": "dense"}

    def __init__(self, num_classes: int, channel: int = 5):
        super().__init__()
        self.feat = PointNetEncoder(channel)
        self.conv1 = nn.Conv1d(160, 128, 1)
        self.conv2 = nn.Conv1d(128, 100, 1)
        self.conv3 = nn.Conv1d(100, 64, 1)
        self.conv4 = nn.Conv1d(64, num_classes, 1)
        self.bn1 = BatchNorm(128)
        self.bn2 = BatchNorm(100)
        self.bn3 = BatchNorm(64)

    def forward(self, points: torch.Tensor):
        """points [B, N, C] -> (log-probs [B, N, classes], 32x32 transform)."""
        x, trans_feat = self.feat(points.transpose(1, 2))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.conv4(x).transpose(1, 2)
        return F.log_softmax(x, dim=-1), trans_feat
