"""YOLOX-style decoupled detection head, NCHW (counterpart of
achelous_tpu/models/heads.py).

Per scale: 1x1 stem to 64 (nano) or 256 channels, two 5x5
depthwise-separable towers for cls and reg, then 1x1 predictors; the
output is the channel concat [reg(4), obj(1), cls(K)].  Attribute names are
the reference's (`stems`, `cls_convs`, `reg_convs`, `*_preds`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from achelous_tpu_torch.ops.primitives import ConvBN


class DecoupleHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 nano_head: bool = True):
        super().__init__()
        base = 64 if nano_head else 256

        def tower():
            return nn.Sequential(*(ConvBN(base, base, 5, ds_conv=True)
                                   for _ in range(2)))

        self.stems = nn.ModuleList(ConvBN(c, base, 1) for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(base, num_classes, 1)
                                       for _ in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(base, 4, 1)
                                       for _ in in_channels)
        self.obj_preds = nn.ModuleList(nn.Conv2d(base, 1, 1)
                                       for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        outs = []
        for k, x in enumerate(feats):
            x = self.stems[k](x)
            cls_feat = self.cls_convs[k](x)
            reg_feat = self.reg_convs[k](x)
            outs.append(torch.cat([self.reg_preds[k](reg_feat),
                                   self.obj_preds[k](reg_feat),
                                   self.cls_preds[k](cls_feat)], dim=1))
        return tuple(outs)
