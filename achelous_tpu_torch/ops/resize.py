"""Bilinear 2x upsampling (counterpart of achelous_tpu/ops/resize.py).

The reference upsamples with `nn.Upsample(mode='bilinear',
align_corners=True)`; so does the port.  The JAX package's matmul form of
the same resize is a TPU formulation and is not carried over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W]."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=align_corners)
