"""Where the time of K1 and K3 goes inside one call, on the card.

    python -m achelous_tpu_torch.kernels.phase_clocks

Builds the kernels a second time with -DACHELOUS_PHASE_CLOCKS=1, so that
thread 0 of every block stamps clock64() between the kernel's phases
(csrc/phase_clock.cuh), runs K1 at the four RadarConv shapes of the
serving path and K3 at EfficientFormerV2-S0's (bf16, batch 1, seeded
random inputs), and prints for each the median over blocks of every
phase's cycles and of the whole block, with the card's SM clock.  SM
clocks are not synchronised across SMs, so only differences within a
block are read.  The shipped library has no stamps.  Needs a GPU.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from achelous_tpu_torch.kernels import build
from achelous_tpu_torch.ops.hopper_deform import pack_radarconv_weights

FLAGS = ("-DACHELOUS_PHASE_CLOCKS=1",)
PHASES, BLOCKS = 8, 4096            # csrc/phase_clock.cuh
K1_SHAPES = ((0, 3, 320), (1, 8, 160), (2, 8, 80), (3, 8, 80))
K1_PHASES = ("stage", "row sums", "pool", "conv (thread 0)",
             "sample+project, sync", "reduce+store")
K3_PHASES = ("stage q,k,bias", "pass 1 (warp 0)", "stats, wait v",
             "pass 2 (warp 0)", "reduce+store")
BAND = 4


def load():
    build.build(FLAGS)
    lib = ctypes.CDLL(str(build.library_path(FLAGS)))
    for name, (argtypes, restype) in build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    for name in ("achelous_deform_phase_clocks",
                 "achelous_attention_phase_clocks"):
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
