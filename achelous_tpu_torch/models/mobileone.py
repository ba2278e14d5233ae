"""MobileOne backbone (`mo`, RDF neck only), NCHW (counterpart of
achelous_tpu/models/mobileone.py; reference
backbone/vision/mobileone_modules/mobileone.py:55-440).

A stem block and 4 stages, each of [depthwise 3x3, pointwise 1x1]
MobileOne pairs; the stage widths are the shared table's, the stem's
min(64, widths[0]).  At train time each block has `NUM_BRANCHES[phi]` conv
branches, folded into one conv in the deploy form (`core/reparam.py`).
Keys are the reference's: `stage0`, `stage{s}.{2b}` (depthwise) and
`stage{s}.{2b+1}` (pointwise).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from achelous_tpu_torch.core.config import WIDTHS
from achelous_tpu_torch.ops.mobileone_block import MobileOneBlock

NUM_BLOCKS = (2, 8, 10, 1)
NUM_BRANCHES = {"S0": 4, "S1": 1, "S2": 1}


class MobileOne(nn.Module):
    def __init__(self, phi: str = "S0", in_chans: int = 3,
                 deploy: bool = False):
        super().__init__()
        widths, branches = WIDTHS[phi], NUM_BRANCHES[phi]
        cin = min(64, widths[0])
        self.stage0 = MobileOneBlock(in_chans, cin, 3, stride=2,
                                     deploy=deploy)
        for si, (planes, nb) in enumerate(zip(widths, NUM_BLOCKS), start=1):
            blocks = []
            for bi in range(nb):
                blocks += [
                    MobileOneBlock(cin, cin, 3, stride=2 if bi == 0 else 1,
                                   groups=cin, num_conv_branches=branches,
                                   deploy=deploy),
                    MobileOneBlock(cin, planes, 1,
                                   num_conv_branches=branches,
                                   deploy=deploy)]
                cin = planes
            setattr(self, f"stage{si}", nn.Sequential(*blocks))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stage0(x)
        feats = []
        for si in range(1, 5):
            x = getattr(self, f"stage{si}")(x)
            feats.append(x)
        return tuple(feats)
