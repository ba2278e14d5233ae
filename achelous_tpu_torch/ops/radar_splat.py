"""Radar points -> the channels-first radar map, on the device (counterpart
of achelous_tpu/ops/radar_splat.py, which replaces the reference's offline
notebook, radar_feature_map_generate.ipynb cells 5-8).

The notebook's semantics, order-dependent:
  row = int(u / 6), col = int(v / 3.375)          # 1920x1080 -> 320x320
  if cell occupied and row >= 1: row -= 1          # collision bump
  map[c, row, col] = value                         # overwrite, last wins
  out-of-range points are skipped (the notebook's try/except)
  final transpose(0, 2, 1) -> the stored map is [c, v-axis, u-axis]

`splat_radar_points` is that loop, on the host, for one frame: the oracle.
`splat_radar_fast` is the batched, order-independent splat the training
loop runs on the device: last write wins, no bump.  A scatter with
repeated indices has no defined order on the card, so it takes the order
from the data, as the JAX package does: a scatter-max of each point's
index into its cell picks the cell's last point, and a gather reads its
values.  Both emit the reference's stored layout [3, v, u], the port's
channels-first radar input.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _indices(points: torch.Tensor, resolution: int, image_w: float,
             image_h: float):
    """points [..., 5] = (range, doppler, rcs, u, v) -> (row, col, valid);
    row and col are clamped into the grid where not valid."""
    u, v = points[..., 3].float(), points[..., 4].float()
    fr = torch.floor(u / (image_w / resolution))
    fc = torch.floor(v / (image_h / resolution))
    valid = ((fr >= 0) & (fr < resolution) & (fc >= 0) & (fc < resolution)
             & torch.isfinite(u) & torch.isfinite(v))
    row = torch.where(valid, fr, 0.0).long()
    col = torch.where(valid, fc, 0.0).long()
    return row, col, valid


def splat_radar_points(points: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       resolution: int = 320, image_w: float = 1920.0,
                       image_h: float = 1080.0) -> torch.Tensor:
    """The notebook's splat of one frame, points [N, 5] in order, `valid`
    [N] masking padding rows -> [3, R, R] float32 on the points' device."""
    r = resolution
    row, col, ok = _indices(points, r, image_w, image_h)
    if valid is not None:
        ok = ok & valid.bool()
    feats = points[:, :3].float().cpu().numpy()
    grid = np.zeros((3, r, r), np.float32)
    occupied = np.zeros((r, r), bool)
    for rw, cl, o, f in zip(row.tolist(), col.tolist(), ok.tolist(), feats):
        if not o:
            continue
        if occupied[rw, cl] and rw >= 1:      # channel 0's cell, as there
            rw -= 1
        grid[:, cl, rw] = f
        occupied[rw, cl] = True
    return torch.from_numpy(grid).to(points.device)


def splat_radar_fast(points: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     resolution: int = 320, image_w: float = 1920.0,
                     image_h: float = 1080.0) -> torch.Tensor:
    """Last-write-wins splat without the bump: points [B, N, 5] (or
    [N, 5]), `valid` [B, N] -> [B, 3, R, R] (or [3, R, R]) float32.  A
    cell hit by several points keeps the highest-index one."""
    if points.dim() == 2:
        return splat_radar_fast(points[None], None if valid is None
                                else valid[None], resolution, image_w,
                                image_h)[0]
    r = resolution
    b, n = points.shape[:2]
    row, col, ok = _indices(points, r, image_w, image_h)
    if valid is not None:
        ok = ok & valid.bool()
    # cell (v, u) at v * r + u, the stored layout; invalid points land in
    # a dropped slot
    flat = torch.where(ok, col * r + row, r * r)
    order = torch.arange(n, device=points.device).expand(b, n)
    winner = torch.full((b, r * r + 1), -1, dtype=torch.int64,
                        device=points.device).scatter_reduce(
        1, flat, order, "amax", include_self=True)[:, :-1]
    feats = points[..., :3].float().transpose(1, 2)            # [B,3,N]
    vals = torch.gather(feats, 2, winner.clamp(min=0)[:, None].expand(
        b, 3, r * r))
    vals = torch.where(winner[:, None] >= 0, vals, 0.0)
    return vals.reshape(b, 3, r, r)


def minmax_normalize(radar_map: torch.Tensor) -> torch.Tensor:
    """Global min-max (reference utils/utils.py:51-54; the predict path
    applies it, the training path feeds the raw map)."""
    lo, hi = radar_map.min(), radar_map.max()
    return (radar_map - lo) / torch.clamp(hi - lo, min=1e-12)
