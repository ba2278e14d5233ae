"""Dual-FPN neck with two segmentation decoders, NCHW (counterpart of
achelous_tpu/models/necks.py, the `gdf`, `cdf` and `rdf` families).

As in the reference (neck/ghostdualfpn.py), the neck owns the vision
backbone (`backbone`), so the keys of a reference state dict name its
parameters; `forward_feats` runs the neck alone on backbone features.

Topology:
  s32 -> SPP (SPPF without `use_spp`) -> fpn5
  fpn5 -up-> cat(s16) -> fuse -> fpn4
  fpn4 -up-> cat(s8)  -> fuse -> fpn3
  fpn3 -> ShuffleAttention x2 -> two decoders, each 3x (1x1 + bilinear 2x
  + block) + head block -> seg logits at input resolution
  det feats = (fpn5 + s32, fpn4 + s16, fpn3 + s8)

The fuse is a ghost bottleneck (`gdf`), a CSP layer (`cdf`) or a RepVGG
block (`rdf`), the decoder block a ghost module, a CSP bottleneck or a
RepVGG block.  The reference's CSP and RepVGG necks keep the ghost neck's
attribute names (`ghost_5_to_4`, `se_seg_ghost_3_to_2`, ...), and so does
the port.  With `deploy`, the RepVGG blocks are built in their fused form
(`core/reparam.py` folds the train form's state into it).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from achelous_tpu_torch.core.config import WIDTHS
from achelous_tpu_torch.ops.blocks import Bottleneck, CSPLayer, RepVGGBlock
from achelous_tpu_torch.ops.primitives import (GhostBottleneck, GhostModule,
                                               ShuffleAttention, SPP, SPPF,
                                               Upsample)

HOPS = ("3_to_2", "2_to_1", "1_to_0")


class DualFPN(nn.Module):
    def __init__(self, num_seg: int, phi: str = "S0",
                 backbone: nn.Module | None = None, family: str = "gdf",
                 use_spp: bool = True, deploy: bool = False):
        super().__init__()
        if family not in ("gdf", "cdf", "rdf"):
            raise ValueError(f"neck family must be gdf, cdf or rdf, got "
                             f"{family!r}")
        w = WIDTHS[phi]

        def fuse(c):                      # 2c -> c after upsample + concat
            if family == "gdf":
                return GhostBottleneck(2 * c, 2 * c, c)
            if family == "cdf":
                return CSPLayer(2 * c, c)
            return RepVGGBlock(2 * c, c, deploy=deploy)

        def block(cin, cout):
            if family == "gdf":
                return GhostModule(cin, cout)
            if family == "cdf":
                return Bottleneck(cin, cout)
            return RepVGGBlock(cin, cout, deploy=deploy)

        self.backbone = backbone
        self.spp = (SPP if use_spp else SPPF)(w[3], w[3])
        self.upsample_5_to_4 = Upsample(w[3], w[2])
        self.ghost_5_to_4 = fuse(w[2])
        self.upsample_4_to_3 = Upsample(w[2], w[1])
        self.ghost_4_to_3 = fuse(w[1])
        self.stage_3_lane_seg = ShuffleAttention(w[1])
        self.stage_3_semantic_seg = ShuffleAttention(w[1])
        # decoder channel plan w1 -> w1 -> w0 -> w0, then the class head
        plan = ((w[1], w[1]), (w[1], w[0]), (w[0], w[0]))
        for prefix, classes in (("lane_seg", 2), ("se_seg", num_seg)):
            for hop, (cin, cout) in zip(HOPS, plan):
                setattr(self, f"{prefix}_{hop}", Upsample(cin, cout))
                setattr(self, f"{prefix}_ghost_{hop}", block(cout, cout))
            setattr(self, f"{prefix}_head", block(w[0], classes))

    def _decoder(self, x, prefix: str):
        for hop in HOPS:
            x = getattr(self, f"{prefix}_{hop}")(x)
            x = getattr(self, f"{prefix}_ghost_{hop}")(x)
        return getattr(self, f"{prefix}_head")(x)

    def forward_feats(self, feats: Tuple[torch.Tensor, ...]):
        """Neck on the backbone's 4 maps (strides 4/8/16/32) ->
        (sem, lane, (p5, p4, p3))."""
        _, s8, s16, s32 = feats
        fpn5 = self.spp(s32)
        fpn4 = self.ghost_5_to_4(torch.cat([self.upsample_5_to_4(fpn5), s16],
                                           dim=1))
        fpn3 = self.ghost_4_to_3(torch.cat([self.upsample_4_to_3(fpn4), s8],
                                           dim=1))
        lane = self._decoder(self.stage_3_lane_seg(fpn3), "lane_seg")
        sem = self._decoder(self.stage_3_semantic_seg(fpn3), "se_seg")
        return sem, lane, (fpn5 + s32, fpn4 + s16, fpn3 + s8)

    def forward(self, image: torch.Tensor):
        return self.forward_feats(self.backbone(image))
