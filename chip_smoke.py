"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from achelous_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the serving path gives it,
then serves 8 requests through the port's entry point (EN-GDF-PN-S0,
320x320, bf16, batch 1) and checks them against the same weights run in
float32 through the plain versions on the CPU.  Any failure raises; the last
line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

The line before it lists each kernel with its launches on the serving path,
its worst float32 error against the plain version and both times.  Imports
nothing of JAX.  Exits non-zero without a result where no GPU is visible.
"""
from __future__ import annotations

import copy
import json
import subprocess

import numpy as np
import torch

REQUESTS = 8
BAND = 4
# Kernel vs plain, same inputs on the card.  float32: the two sum in other
# orders (and the conv inside K1 is not cuDNN's), ~1e-6 relative per value,
# so 1e-4 leaves margin.  bf16: both compute in float32 and round the output
# once to bf16 (2^-8 relative), so results differ by at most one bf16 step.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # rtol, atol
# Serving path in bf16 on the card vs float32 plain on the CPU, same (bf16-
# representable) weights: max |bf16 - f32| / max(1, max |f32|) per output.
# bf16 keeps 8 bits; errors compound over ~60 layers.
MAIN_PATH_TOL = 5e-2
# (block, C, H) of the RadarConvs on the serving path at batch 1
K1_SHAPES = ((0, 3, 320), (1, 8, 160), (2, 8, 80), (3, 8, 80))
K2_SHAPES = ((4, 12, 40), (5, 12, 40), (6, 24, 20), (7, 24, 20))
# offset regimes: zero, |o| < 1, |o| about 3, beyond the band
K1_OFFSETS = ((0.0, 0.0), (0.05, 0.3), (0.3, 3.0), (2.0, 8.0))
K2_OFFSETS = (0.0, 0.7, 3.0, 9.0)


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this test "
                         "runs only on a GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 10,
            hold_device: bool = False) -> float:
    """ms per call of `fn` between CUDA events, after warm-up.  By default
    the events see calls as the host issues them, launch overhead
    included.  With `hold_device` a sleep kernel first holds the GPU while
    the host queues every call, so the events bracket back-to-back device
    work: the device time of one call.  Then `iters` times the launches of
    one call must stay under the ~1000 launches the CUDA runtime queues; past
    that the host blocks and its own pace leaks into the reading."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold_device:
        torch.cuda._sleep(200_000_000)      # ~0.1 s of GPU cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn) -> float:
    """Median device time of one call over 5 readings of 5 queued calls
    (the plain versions launch ~100 kernels a call)."""
    return float(np.median([cuda_ms(fn, iters=5, warmup=2, hold_device=True)
                            for _ in range(5)]))


def k1_case(rng, c, h, ow, ob, dev):
    """Raw input and RadarConv weights (port layout) for one K1 call."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t(rng.randn(18, c, 3, 3) * ow),
            t(rng.randn(18) * ob), t(rng.randn(9, c, 3, 3) * 0.3),
            t(rng.randn(9) * 0.3), t(rng.randn(c, c, 3, 3) * 0.2))


def k2_case(rng, c, h, scale, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t((rng.rand(1, 18, h, h) * 2 - 1) * scale),
            t(rng.rand(1, 9, h, h) * 2))


def check(name, got, want, dtype):
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version, "
                             f"max abs err {err} (rtol {rtol}, atol {atol})")
    return err


def check_kernels(dev):
    """Phase 3: K1 and K2 against their plain versions at the serving
    shapes, float32 (TF32 off) and bf16; returns per-kernel results."""
    from achelous_tpu_torch.ops import deform, hopper_deform as hd
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    results = {}
    specs = (
        ("fused_radarconv", hd.fused_radarconv, deform.fused_radarconv_reference,
         K1_SHAPES, K1_OFFSETS, lambda c, h, o: k1_case(rng, c, h, *o, dev)),
        ("deform_samples", hd.deform_samples, deform.banded_deform_samples,
         K2_SHAPES, K2_OFFSETS, lambda c, h, o: k2_case(rng, c, h, o, dev)),
    )
    for name, kernel, plain, shapes, offsets, make in specs:
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        ms = plain_ms = 0.0
        for block, c, h in shapes:
            for off in offsets:
                args = make(c, h, off)
                for dt in (torch.float32, torch.bfloat16):
                    a = [x.to(dt) for x in args]
                    got = kernel(*a, BAND)
                    want = plain(*a, BAND)
                    torch.cuda.synchronize()
                    worst[dt] = max(worst[dt], check(
                        f"{name} block {block} {dt} offsets {off}", got,
                        want, dt))
            # time the serving dtype at the largest-offset regime: device
            # time per call, and the rate the host issues calls at
            a = [x.to(torch.bfloat16) for x in args]
            t_k, t_p = (device_ms(lambda: f(*a, BAND))
                        for f in (kernel, plain))
            h_k, h_p = (cuda_ms(lambda: f(*a, BAND)) for f in (kernel, plain))
            ms += t_k
            plain_ms += t_p
            log(f"kernel {name} block {block} C={c} {h}x{h} bf16: device "
                f"{t_k:.4f} ms (plain {t_p:.4f} ms); as issued "
                f"{h_k:.4f} ms (plain {h_p:.4f} ms)")
        log(f"kernel {name}: max abs err f32 {worst[torch.float32]:.3g}, "
            f"bf16 {worst[torch.bfloat16]:.3g}")
        results[name] = dict(max_abs_err=worst[torch.float32], ms=ms,
                             plain_ms=plain_ms)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return results


def requests(cfg, n: int, seed: int = 100):
    """n distinct seeded requests, made in bulk: (image, radar, points)."""
    rng = np.random.RandomState(seed)
    r = cfg.resolution
    img = rng.rand(n, 1, 3, r, r).astype(np.float32)
    rad = rng.rand(n, 1, 3, r, r).astype(np.float32)
    pts = rng.rand(n, 1, cfg.pc_points, cfg.pc_channels).astype(np.float32)
    return [tuple(torch.from_numpy(a[i]) for a in (img, rad, pts))
            for i in range(n)]


def main_path(dev):
    """Phase 4: serve REQUESTS requests through entry() and check them."""
    from achelous_tpu_torch.entry import entry, perturb_deform_convs
    from achelous_tpu_torch.models.achelous import cast_compute
    from achelous_tpu_torch.ops import hopper_deform as hd

    fn, _ = entry(dev, torch.Generator().manual_seed(0))
    model, cfg = fn.model, fn.cfg
    perturb_deform_convs(model)
    # the same (bf16) weights in float32 on the CPU: the plain versions
    ref_model = cast_compute(copy.deepcopy(model).cpu(), torch.float32)

    reqs = requests(cfg, REQUESTS)
    dev_reqs = [tuple(t.to(dev, cfg.dtype) for t in q) for q in reqs]
    fn(*dev_reqs[0])                                   # warm-up
    torch.cuda.synchronize()

    def counts():
        return {"fused_radarconv": hd.fused_radarconv.launches,
                "deform_samples": hd.deform_samples.launches}

    hd.reset_launch_counts()
    outs = []
    for i, q in enumerate(dev_reqs):
        before = counts()
        outs.append(fn(*q))
        rose = {n: c - before[n] for n, c in counts().items()}
        if rose != {"fused_radarconv": 4, "deform_samples": 4}:
            raise AssertionError(f"request {i}: kernel launches {rose}, want "
                                 f"4 of each (RCNet blocks 0-3 and 4-7)")
    torch.cuda.synchronize()
    total = counts()
    log(f"main path: launches over {REQUESTS} requests {total}")

    r, k = cfg.resolution, cfg.num_det
    worst = {}
    with torch.inference_mode():
        for q, dq, (dets, sem, lane, pc) in zip(reqs, dev_reqs, outs):
            det = model(*dq)[0]
            # the reference sees the same bf16-rounded inputs
            want_det, want_sem, want_lane, want_pc = ref_model(
                *(t.to(cfg.dtype).float() for t in q))
            got = {"det": det, "sem": sem, "lane": lane, "pc": pc}
            want = {"det": want_det, "sem": want_sem, "lane": want_lane,
                    "pc": want_pc}
            shapes = {"sem": (1, cfg.num_seg, r, r), "lane": (1, 2, r, r),
                      "pc": (1, cfg.pc_points, cfg.pc_classes)}
            for name, s in shapes.items():
                if tuple(got[name].shape) != s:
                    raise AssertionError(f"{name} shape {tuple(got[name].shape)}"
                                         f", want {s}")
            for lvl, (g, stride) in enumerate(zip(det, (8, 16, 32))):
                s = (1, 5 + k, r // stride, r // stride)
                if tuple(g.shape) != s:
                    raise AssertionError(f"det[{lvl}] shape {tuple(g.shape)},"
                                         f" want {s}")
            if dets.boxes.shape != (1, 100, 4) or not bool(
                    torch.isfinite(dets.boxes).all()):
                raise AssertionError("detections: bad shape or non-finite")
            pairs = [("sem", got["sem"], want["sem"]),
                     ("lane", got["lane"], want["lane"]),
                     ("pc", got["pc"], want["pc"])]
            pairs += [(f"det{i}", g, w) for i, (g, w) in
                      enumerate(zip(got["det"], want["det"]))]
            for name, g, w in pairs:
                g = g.float().cpu()
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name}: non-finite output")
                e = ((g - w).abs().max() / max(1.0, w.abs().max().item())
                     ).item()
                worst[name] = max(worst.get(name, 0.0), e)
    log("main path vs float32 plain (max err / max(1, max|ref|)): "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()))
    bad = {n: e for n, e in worst.items() if e > MAIN_PATH_TOL}
    if bad:
        raise AssertionError(f"main path outside {MAIN_PATH_TOL}: {bad}")

    q = dev_reqs[0]
    ms_full = cuda_ms(lambda: fn(*q), iters=50)
    with torch.inference_mode():
        ms_fwd = cuda_ms(lambda: model(*q), iters=50)
    log(f"main path bf16 bs1 {r}x{r}: fwd+decode+NMS {ms_full:.3f} ms/frame, "
        f"fwd only {ms_fwd:.3f} ms/frame")
    return total


def main():
    log(device_line())
    dev = torch.device("cuda", 0)
    from achelous_tpu_torch.kernels import build
    secs = build.build()
    log(f"build: {secs:.2f} s ({build.library_path().name})")
    kernels = check_kernels(dev)
    counts = main_path(dev)
    rows = []
    for name, replaces in (
            ("fused_radarconv", "achelous_tpu/ops/pallas_deform.py:445"),
            ("deform_samples", "achelous_tpu/ops/pallas_deform.py:219")):
        rows.append({"name": name, "route": "cuda",
                     "source": "achelous_tpu_torch/csrc/deform.cu",
                     "replaces": replaces, "launches": counts[name],
                     **kernels[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
