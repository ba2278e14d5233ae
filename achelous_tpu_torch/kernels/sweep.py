"""K4's and K2's launch plans against their alternatives, on the card.

    python -m achelous_tpu_torch.kernels.sweep

Times K4 (float32, batch 1) at PointNet++'s four levels for every plan of
1-16 points a thread (`hopper_pointops.fps_plan(n, points)`), blocks of
2-4 warps both with the cross-warp compare tree and with redux.sync, and
K2 (bf16, batch 1, band 4) at RCNet's two shapes for every tile height (8
or 4 rows) and channel group G of 1, 2, 4 and 8, through `launch_fps` and
`launch_samples` (which count their launches like the wrappers).  Prints
each one's device time a call, the median of 7 readings of 20 queued
calls, with the range of the readings, beside the plan the wrappers
choose (the wrapper takes the tree up to 4 warps); the two reductions of
one plan are read in turn.  Needs a GPU.
"""
from __future__ import annotations

import itertools
import subprocess

import numpy as np
import torch

from achelous_tpu_torch.kernels.timing import cuda_ms
from achelous_tpu_torch.ops.hopper_deform import (SAMPLES_GROUPS,
                                                  SAMPLES_ROWS, SamplesPlan,
                                                  deform_samples_plan,
                                                  launch_samples, sm_count)
from achelous_tpu_torch.ops.hopper_pointops import fps_plan, launch_fps

K4_SHAPES = ((512, 128), (128, 32), (32, 8), (8, 4))
K4_POINTS = (1, 2, 4, 8, 16)
K2_SHAPES = ((12, 40), (24, 20))
BAND = 4
READINGS = 7


def readings(*fns):
    """READINGS device-time readings (us a call, 20 queued calls each) of
    every fn, taken in turn."""
    got = [[] for _ in fns]
    for _ in range(READINGS):
        for r, fn in zip(got, fns):
            r.append(1e3 * cuda_ms(fn, iters=20, warmup=2, hold_device=True))
    return [np.array(r) for r in got]


def show(r):
    return f"{np.median(r):.2f} us ({r.min():.2f}-{r.max():.2f})"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sweep needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)

    for n, npoint in K4_SHAPES:
        xyz = torch.rand(1, n, 3, device=dev)
        chosen = fps_plan(n)
        for plan in sorted({fps_plan(n, k) for k in K4_POINTS}):
            mark = "  <- fps_plan" if plan == chosen else ""
            label = f"K4 {n}->{npoint}: {plan[0]} threads x {plan[1]} points"
            if 64 <= plan[0] <= 128:
                tree, redux = readings(
                    lambda plan=plan: launch_fps(xyz, npoint, None, plan,
                                                 True),
                    lambda plan=plan: launch_fps(xyz, npoint, None, plan,
                                                 False))
                print(f"{label} tree {show(tree)}, redux {show(redux)}"
                      f"{mark}")
            else:
                r, = readings(lambda plan=plan: launch_fps(xyz, npoint, None,
                                                           plan))
                print(f"{label} {show(r)}{mark}")

    sms = sm_count(dev)
    for c, h in K2_SHAPES:
        x = torch.rand(1, c, h, h, device=dev).to(torch.bfloat16)
        off = ((torch.rand(1, 18, h, h, device=dev) * 2 - 1) * 3).to(
            torch.bfloat16)
        mask = (torch.rand(1, 9, h, h, device=dev) * 2).to(torch.bfloat16)
        chosen = deform_samples_plan(1, c, h, h, sms)
        for g, rows in itertools.product(SAMPLES_GROUPS, SAMPLES_ROWS):
            blocks = -(-h // rows) * -(-h // 8) * -(-c // g)
            plan = SamplesPlan(rows, g, blocks)
            r, = readings(lambda plan=plan: launch_samples(
                x, off, mask, BAND, plan))
            mark = "  <- deform_samples_plan" if plan == chosen else ""
            print(f"K2 C={c} {h}x{h}: {rows}x8 tiles, G={g}, {blocks} "
                  f"blocks: {show(r)}{mark}")


if __name__ == "__main__":
    main()
