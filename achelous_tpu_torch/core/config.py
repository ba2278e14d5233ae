"""Model configuration (counterpart of achelous_tpu/core/config.py).

One width table and one frozen dataclass that every module reads.  The
port builds every axis the JAX package builds: the eight backbones
(`BACKBONES`) at S0-S2 and EfficientFormerV2 (`ef`) also at L, the `gdf`,
`cdf` and `rdf` necks with SPP or SPPF (`use_spp`), and the PointNet
(`pn`) and PointNet++ (`pn2`) point-cloud branches.  It refuses what the
JAX package refuses, with its messages: the `rdf` neck takes only the
MobileOne (`mo`) and FastViT (`fv`) backbones, and only `ef` has the L
size.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# shared 4-stage channel widths (strides 4 / 8 / 16 / 32)
WIDTHS: dict[str, Tuple[int, int, int, int]] = {
    "L": (40, 80, 192, 384),
    "S2": (32, 64, 144, 288),
    "S1": (32, 48, 120, 224),
    "S0": (32, 48, 96, 176),
}

BACKBONES = ("en", "mv", "ef", "ev", "rv", "pf", "mo", "fv")
NECKS = ("gdf", "cdf", "rdf")
PC_MODELS = ("pn", "pn2")


@dataclasses.dataclass(frozen=True)
class AchelousConfig:
    """Configuration of the 5-task Achelous model (the fields the serving
    slice reads, with the JAX package's defaults)."""

    # task dimensions
    num_det: int = 7
    num_seg: int = 9
    pc_classes: int = 8

    # architecture axes
    phi: str = "S0"
    backbone: str = "en"
    neck: str = "gdf"
    pc_model: str = "pn"
    nano_head: bool = True
    use_spp: bool = True      # SPP, else SPPF (serial 5x5 max-pools)

    # inputs
    resolution: int = 320
    image_channels: int = 3
    radar_channels: int = 3
    pc_channels: int = 5
    pc_points: int = 512

    # numerics: activation/compute dtype; parameters are made in float32
    dtype: torch.dtype = torch.float32

    # deformable-conv offsets are clipped to [-band, band] cells; None
    # samples at the unclipped offset (reference checkpoints need None)
    deform_band: Optional[int] = 4

    def __post_init__(self):
        if self.phi not in WIDTHS:
            raise ValueError(f"phi must be one of {tuple(WIDTHS)}, got "
                             f"{self.phi!r}")
        if self.backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got "
                             f"{self.backbone!r}")
        if self.neck not in NECKS:
            raise ValueError(f"neck must be one of {NECKS}, got "
                             f"{self.neck!r}")
        if self.pc_model not in PC_MODELS:
            raise ValueError(f"pc_model must be one of {PC_MODELS}, got "
                             f"{self.pc_model!r}")
        if self.neck == "rdf" and self.backbone not in ("mo", "fv"):
            raise ValueError("rdf neck only supports 'mo'/'fv' backbones "
                             "(reference neck/repdualfpn.py:53-69)")
        if self.phi == "L" and self.backbone != "ef":
            raise ValueError("only EfficientFormerV2 supports the L size "
                             "(reference neck/ghostdualfpn.py:96-98)")
        if self.resolution % 32 != 0:
            raise ValueError("resolution must be a multiple of 32")
        if self.num_seg > 31:
            raise ValueError("num_seg must be <= 31")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{self.dtype}")

    @property
    def det_in_channels(self) -> Tuple[int, int, int]:
        """Channels of the radar-fused P3/P4/P5 det features: width*5/4."""
        w = WIDTHS[self.phi]
        return (w[1] * 5 // 4, w[2] * 5 // 4, w[3] * 5 // 4)

    @property
    def name(self) -> str:
        """The reference's naming convention, e.g. EF-GDF-PN-S0."""
        return (f"{self.backbone.upper()}-{self.neck.upper()}-"
                f"{self.pc_model.upper()}-{self.phi}")

    def replace(self, **kw) -> "AchelousConfig":
        return dataclasses.replace(self, **kw)
