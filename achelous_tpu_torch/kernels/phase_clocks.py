"""Where the time of K1-K4 goes inside one call, on the card.

    python -m achelous_tpu_torch.kernels.phase_clocks

Builds the kernels a second time with -DACHELOUS_PHASE_CLOCKS=1, so that
thread 0 of every block stamps clock64() between the kernel's phases
(csrc/phase_clock.cuh), runs K1 at the four RadarConv shapes of the
serving path, K2 at its two, K3 at EfficientFormerV2-S0's and K4 at
PointNet++'s four levels (bf16, K4 float32, batch 1, seeded random
inputs), and prints for each the median over blocks of every phase's
cycles and of the whole block, with the card's SM clock.  K4's one block
sums each part of a step over its steps, and the report divides by the
steps.  SM clocks are not synchronised across SMs, so only differences
within a block are read.  The shipped library has no stamps.  Needs a GPU.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from achelous_tpu_torch.kernels import build
from achelous_tpu_torch.ops.hopper_deform import (deform_samples_plan,
                                                  pack_radarconv_weights,
                                                  sm_count)
from achelous_tpu_torch.ops.hopper_pointops import fps_plan

FLAGS = ("-DACHELOUS_PHASE_CLOCKS=1",)
PHASES, BLOCKS = 8, 4096            # csrc/phase_clock.cuh
K1_SHAPES = ((0, 3, 320), (1, 8, 160), (2, 8, 80), (3, 8, 80))
K1_PHASES = ("stage", "row sums", "pool", "conv (thread 0)",
             "sample+project, sync", "reduce+store")
K3_PHASES = ("stage q,k,bias", "pass 1 (warp 0)", "stats, wait v",
             "pass 2 (warp 0)", "reduce+store")
K2_SHAPES = ((4, 12, 40), (6, 24, 20))
K2_PHASES = ("load offset, mask; clip", "corners, weights",
             "gather+store")
K4_SHAPES = ((512, 128), (128, 32), (32, 8), (8, 4))
K4_PHASES = ("centre+distance update", "warp reduce",
             "slots, barrier, cross-warp reduce")
BAND = 4


def load():
    build.build(FLAGS)
    lib = ctypes.CDLL(str(build.library_path(FLAGS)))
    for name, (argtypes, restype) in build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    for name in ("achelous_deform_phase_clocks",
                 "achelous_attention_phase_clocks",
                 "achelous_pointops_phase_clocks"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def stamps(read) -> np.ndarray:
    """The stamps of the blocks that ran since the last read, [n, PHASES];
    reading also zeroes them."""
    torch.cuda.synchronize()
    buf = np.zeros((BLOCKS, PHASES), np.int64)
    if read(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("reading the phase stamps failed")
    return buf[buf[:, 0] != 0]


def report(label, rows, names):
    d = np.diff(rows[:, :len(names) + 1], axis=1)
    total = rows[:, len(names)] - rows[:, 0]
    print(f"{label}: {len(rows)} blocks, median block {np.median(total):.0f}"
          f" cycles (max {total.max()})")
    for name, col in zip(names, d.T):
        print(f"  {name:24s} {np.median(col):8.0f} cycles "
              f"({100 * np.median(col) / np.median(total):4.1f} %)")


def report_steps(label, rows, names):
    """K4: each row holds the phases' cycles summed over the steps, then
    the whole loop's cycles and the step count."""
    steps = rows[:, len(names) + 1]
    per = rows[:, :len(names) + 1] / steps[:, None]
    print(f"{label}: {len(rows)} blocks, {int(steps[0])} steps, median "
          f"{np.median(per[:, len(names)]):.0f} cycles a step")
    for name, col in zip(names, per.T):
        print(f"  {name:34s} {np.median(col):8.1f} cycles a step "
              f"({100 * np.median(col) / np.median(per[:, len(names)]):4.1f}"
              f" %)")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv"],
                         capture_output=True, text=True).stdout.strip())
    lib = load()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = build.ptr

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dev)

    for block, c, h in K1_SHAPES:
        x = torch.rand(1, c, h, h, device=dev).to(torch.bfloat16)
        packed = pack_radarconv_weights(
            t(18, c, 3, 3, scale=0.3), t(18, scale=3.0), t(9, c, 3, 3),
            t(9), t(c, c, 3, 3, scale=0.2))
        out = torch.empty_like(x)

        def k1():
            err = lib.achelous_fused_radarconv(
                p(x), *(p(w) for w in packed), p(out), 1, c, c, h, h, BAND,
                1, stream)
            build.raise_on("fused_radarconv", err)

        for _ in range(3):
            k1()
        stamps(lib.achelous_deform_phase_clocks)
        k1()
        report(f"K1 block {block} C={c} {h}x{h} bf16",
               stamps(lib.achelous_deform_phase_clocks), K1_PHASES)

    for block, c, h in K2_SHAPES:
        x, off, mask = (torch.rand(1, ch, h, h, device=dev) * sc for ch, sc in
                        ((c, 1.0), (18, 6.0), (9, 2.0)))
        x, off, mask = (a.to(torch.bfloat16) for a in (x, off - 3.0, mask))
        out = torch.empty(1, 9 * c, h, h, device=dev, dtype=torch.bfloat16)
        plan = deform_samples_plan(1, c, h, h, sm_count(dev))

        def k2():
            err = lib.achelous_deform_samples(
                p(x), p(off), p(mask), p(out), 1, c, h, h, BAND, 1,
                plan.rows, plan.group, stream)
            build.raise_on("deform_samples", err)

        for _ in range(3):
            k2()
        stamps(lib.achelous_deform_phase_clocks)
        k2()
        report(f"K2 block {block} C={c} {h}x{h} bf16 {plan}",
               stamps(lib.achelous_deform_phase_clocks), K2_PHASES)

    for n, npoint in K4_SHAPES:
        xyz = torch.rand(1, n, 3, device=dev)
        idx = torch.empty(1, npoint, dtype=torch.int64, device=dev)
        threads, ppt = fps_plan(n)
        # blocks of 2-4 warps: the compare tree and redux.sync
        trees = (True, False) if 64 <= threads <= 128 else (False,)
        for tree in trees:
            def k4(tree=tree):
                err = lib.achelous_farthest_point_sample(
                    p(xyz), None, p(idx), 1, n, npoint, threads, ppt,
                    int(tree), stream)
                build.raise_on("farthest_point_sample", err)

            for _ in range(3):
                k4()
            stamps(lib.achelous_pointops_phase_clocks)
            k4()
            how = f", {'tree' if tree else 'redux'}" if len(trees) > 1 else ""
            report_steps(f"K4 {n}->{npoint} f32, {threads} threads x {ppt}"
                         f"{how}", stamps(lib.achelous_pointops_phase_clocks),
                         K4_PHASES)

    h, n, dk, dv = 8, 100, 32, 128
    args = [t(*s, scale=0.5).to(torch.bfloat16) for s in
            ((1, h, n, dk), (1, h, n, dk), (1, h, n, dv), (h, n, n), (h, h),
             (h,), (h, h), (h,))]
    out = torch.empty_like(args[2])

    def k3():
        err = lib.achelous_bias_attention(
            *(p(a) for a in args), p(out), 1, h, n, dk, dv, dk ** -0.5, 1,
            stream)
        build.raise_on("fused_bias_attention", err)

    for _ in range(3):
        k3()
    stamps(lib.achelous_attention_phase_clocks)
    k3()
    report(f"K3 h={h} N={n} dk={dk} dv={dv} bf16",
           stamps(lib.achelous_attention_phase_clocks), K3_PHASES)


if __name__ == "__main__":
    main()
