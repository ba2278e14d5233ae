"""Wrapper of the farthest-point-sampling CUDA kernel (counterpart of
achelous_tpu/ops/pallas_pointops.py; source in csrc/pointops.cu).

  K4  farthest_point_sample  <- pallas_farthest_point_sample
                                (PointNet++ set abstraction, 4 a frame)

A tensor on the CPU goes to the plain PyTorch version in ops/pointops.py.
A CUDA tensor goes to the kernel or the call raises: nothing falls back.
The kernel's launches are counted in `farthest_point_sample.launches`.
The launch is the custom operator `achelous::farthest_point_sample`, which
`torch.export` keeps as one node (as ops/hopper_deform.py does for K1 and
K2).

The kernel takes float32 xyz (the PointNet++ branch keeps xyz in float32
whatever the compute dtype) and returns int64 indices with exactly the
plain version's values.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from achelous_tpu_torch.kernels import build
from achelous_tpu_torch.ops.hopper_deform import on_cuda

# a float4 copy of one batch element's points lives in shared memory: 16
# bytes a point, under the 227 KB a block can opt into
FPS_MAX_POINTS = 12288
# points a thread the kernel is compiled for, and the most threads each
# runs with (<= 8 points: 1024 threads at <= 64 registers; 16 and 24: 512
# threads at <= 128), as csrc/pointops.cu fps_max_threads gives them (the
# CUDA tests hold the two to each other)
FPS_PPT = (1, 2, 4, 8, 16, 24)
FPS_MAX_THREADS = {1: 1024, 2: 1024, 4: 1024, 8: 1024, 16: 512, 24: 512}
# points a thread the plan aims for: fewer make the block wider and its
# barrier and cross-warp reduce slower, more lengthen each thread's update
# (kernels/sweep.py: best at 512 and at 128 points on the H100)
FPS_POINTS = 4


def fps_plan(n: int, points: int = FPS_POINTS) -> Tuple[int, int]:
    """K4's launch for N = n points: (threads a block, points a thread).
    The block takes ~n / `points` threads (a multiple of 32, at least one
    warp, at most 1024), each thread the fewest points from FPS_PPT that
    cover N within its variant's thread limit."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"fps_plan: N must be 1..{FPS_MAX_POINTS}, got {n}")

    def warps(k):
        return max(32, (-(-n // k) + 31) // 32 * 32)
    limit = min(1024, warps(points))
    return next((warps(ppt), ppt) for ppt in FPS_PPT
                if warps(ppt) <= min(limit, FPS_MAX_THREADS[ppt]))


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K4: FPS indices [B, npoint] (int64) over xyz [B, N, 3] float32,
    with an optional bool mask `valid` [B, N]."""
    if xyz.device.type == "cpu":
        from achelous_tpu_torch.ops.pointops import \
            farthest_point_sample as plain
        return plain(xyz, npoint, valid)
    on_cuda("farthest_point_sample", xyz)
    return torch.ops.achelous.farthest_point_sample(xyz, npoint, valid)


@torch.library.custom_op("achelous::farthest_point_sample", mutates_args=())
def _fps_op(xyz: torch.Tensor, npoint: int,
            valid: Optional[torch.Tensor]) -> torch.Tensor:
    """K4's launch on the plan `fps_plan` picks, as an operator."""
    return launch_fps(xyz, npoint, valid, None)


@_fps_op.register_fake
def _(xyz, npoint, valid):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int64)


def launch_fps(xyz: torch.Tensor, npoint: int,
               valid: Optional[torch.Tensor],
               plan: Optional[Tuple[int, int]],
               tree: Optional[bool] = None) -> torch.Tensor:
    """K4 on CUDA tensors with a launch plan (threads, points a thread);
    None takes `fps_plan(N)`.  `tree`: the cross-warp compare tree (2-4
    warps) rather than redux.sync; None takes it up to 4 warps, where
    kernels/sweep.py found it faster on the H100.
    `kernels/sweep.py` and the CUDA tests pass others."""
    on_cuda("farthest_point_sample", xyz)
    if xyz.dtype != torch.float32:
        raise TypeError(f"farthest_point_sample: xyz must be float32, got "
                        f"{xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"farthest_point_sample: xyz must be [B,N,3], got "
                         f"{tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"farthest_point_sample: N must be 1..{FPS_MAX_POINTS}"
                         f", got {n}")
    if isinstance(npoint, bool) or not isinstance(npoint, int) or npoint < 0:
        raise ValueError(f"farthest_point_sample: npoint must be an int >= 0, "
                         f"got {npoint!r}")
    tensors = [xyz]
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (b, n):
            raise ValueError(f"farthest_point_sample: valid must be a bool "
                             f"[{b},{n}] tensor, got {valid.dtype} "
                             f"{tuple(valid.shape)}")
        tensors.append(valid)
    for t in tensors:
        if t.device != xyz.device:
            raise ValueError(f"farthest_point_sample: all tensors must be on "
                             f"{xyz.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("farthest_point_sample: tensors must be "
                             "contiguous")
    threads, ppt = fps_plan(n) if plan is None else plan
    if tree is None:
        tree = threads <= 128
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(xyz.device):
        err = lib.achelous_farthest_point_sample(
            build.ptr(xyz), None if valid is None else build.ptr(valid),
            build.ptr(out), b, n, npoint, threads, ppt, int(tree),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.raise_on("farthest_point_sample", err)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
