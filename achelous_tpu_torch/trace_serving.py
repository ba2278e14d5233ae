"""Where the serving path's time goes on the GPU.

    python -m achelous_tpu_torch.trace_serving [--backbone en|ef]
        [--pc_model pn|pn2] [--out DIR]

Serves requests of one path (default EN-GDF-PN-S0; 320x320, bf16, batch 1,
random weights with non-zero deformable offsets and, for `ef`, drawn
layer scales, bias tables and talking heads) under torch.profiler and
prints, per frame:
wall time, the device's busy time (the sum of kernel times; the rest of
the frame the device idles), kernel launches, and the kernels with the
most device time.  The full table goes to DIR/serving_profile.txt
(default traces/), named after the path.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity, profile

from achelous_tpu_torch.entry import (entry, perturb_attention,
                                      perturb_deform_convs)

FRAMES = 20


def profile_frames(fn, q, frames: int = FRAMES):
    """Serve `frames` requests `fn(*q)` under torch.profiler: (wall ms a
    frame, device busy ms a frame, kernels a frame, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn(*q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    rows = kernel_rows(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / frames
    launches = sum(e.count for e in rows) / frames
    return wall_ms, busy_ms, launches, prof


def kernel_rows(events):
    """The device rows of a profile that are kernels or copies: not the
    device-side spans of `record_function` ranges, which carry a host
    row's name."""
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="en", choices=("en", "ef"))
    ap.add_argument("--pc_model", default="pn", choices=("pn", "pn2"))
    ap.add_argument("--out", default="traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_serving needs a CUDA device")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device("cuda", 0)
    fn, _ = entry(dev, torch.Generator().manual_seed(0), args.backbone,
                  args.pc_model)
    perturb_deform_convs(fn.model)
    perturb_attention(fn.model)
    r = fn.cfg.resolution
    q = (torch.rand(1, 3, r, r, device=dev, dtype=torch.bfloat16),
         torch.rand(1, 3, r, r, device=dev, dtype=torch.bfloat16),
         torch.rand(1, fn.cfg.pc_points, fn.cfg.pc_channels, device=dev,
                    dtype=torch.bfloat16))
    for _ in range(10):
        fn(*q)
    torch.cuda.synchronize()

    wall_ms, busy_ms, launches, prof = profile_frames(fn, q)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60)
    (out / f"serving_profile_{fn.cfg.name}.txt").write_text(table)
    print(f"{fn.cfg.name} per frame: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches:.0f} kernels")
    rows = kernel_rows(prof.key_averages())
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3 / FRAMES:8.4f} ms "
              f"{e.count / FRAMES:5.1f}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
