"""Bilinear resizing (counterpart of achelous_tpu/ops/resize.py).

The reference resizes with `nn.Upsample` / `F.interpolate(mode='bilinear')`;
so does the port.  The JAX package's matmul form of the same resize is a
TPU formulation and is not carried over.  With `align_corners=False` the
source coordinate of output pixel o is (o + 0.5) * n_in / n_out - 0.5,
clipped to [0, n_in - 1], which is what the JAX interpolation matrices
compute.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,*size]."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,2H,2W]."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=align_corners)
