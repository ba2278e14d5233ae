"""Point-cloud set operations of PointNet++ (counterpart of
achelous_tpu/ops/pointops.py): farthest point sampling, ball query,
grouping.  Points are [B, N, C] with xyz in float32.

`farthest_point_sample` here is the plain PyTorch version of K4, the CPU
path and the oracle of the CUDA kernel in ops/hopper_pointops.py;
`sample_and_group` reaches FPS through that wrapper.  Indices are int64,
torch's index type; their values are the JAX package's int32 indices.

Squared distances are summed as `(dx*dx + dy*dy) + dz*dz`, one rounding
per operation, the order the JAX package and the kernel use, so that
indices agree exactly and not only up to ties of rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

FPS_INIT = 1e10       # starting distance of every valid point


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distance between [B,S,3] and [B,N,3] -> [B,S,N]."""
    d = a[:, :, None, :] - b[:, None, :, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """FPS indices [B, npoint] (int64) over xyz [B, N, 3]: starts at point
    0, takes the first maximum on ties; points where the bool `valid`
    [B, N] is False keep distance -1 and are never picked while a valid
    point remains."""
    b, n, _ = xyz.shape
    dist = torch.full((b, n), FPS_INIT, dtype=xyz.dtype, device=xyz.device)
    if valid is not None:
        dist = torch.where(valid, dist, -1.0)
    idxs = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    farthest = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for i in range(npoint):
        c = xyz[rows, farthest][:, None, :]                  # [B,1,3]
        dx, dy, dz = (xyz - c).unbind(-1)
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, d)
        if valid is not None:
            dist = torch.where(valid, dist, -1.0)
        idxs[:, i] = farthest
        farthest = torch.argmax(dist, dim=-1)     # first maximum on ties
    return idxs


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points [B, N, C] by an integer index [B, ...] -> [B, ..., C]."""
    b = points.shape[0]
    flat = idx.reshape(b, -1, 1).expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(*idx.shape, points.shape[-1])


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Indices [B, S, min(nsample, N)] of the first in-radius points of
    each centre, by index; slots past the found count repeat the first
    found point, and a centre with none gets point 0."""
    d2 = square_distance(new_xyz, xyz)                       # [B,S,N]
    n = xyz.shape[1]
    nsample = min(nsample, n)
    # the JAX package compares float32 distances with radius**2 rounded to
    # float32; make that rounding explicit
    r2 = torch.tensor(radius ** 2, dtype=d2.dtype, device=d2.device)
    order = torch.arange(n, device=xyz.device)
    key = torch.where(d2 <= r2, order, n)         # out of the ball -> n
    idx = key.sort(dim=-1).values[..., :nsample]
    first = idx[..., :1]
    idx = torch.where(idx < n, idx, first)
    return torch.where(first < n, idx, 0)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, feats: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set-abstraction grouping: FPS centres [B, S, 3] and neighbourhoods
    [B, S, K, 3 + C] of [xyz relative to the centre, point features], in
    xyz's dtype (float32), as the JAX package promotes them."""
    from achelous_tpu_torch.ops.hopper_pointops import farthest_point_sample \
        as fps
    # the indices take no gradient: K4 sees xyz without its graph
    new_xyz = index_points(xyz, fps(xyz.detach().contiguous(), npoint))
    g_idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped = index_points(xyz, g_idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat(
            [grouped, index_points(feats, g_idx).to(grouped.dtype)], dim=-1)
    return new_xyz, grouped
