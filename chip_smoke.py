"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from achelous_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the serving paths give it
(K1 fused RadarConv, K2 deformable sampling, K3 fused bias attention, K4
farthest point sampling), then serves 8 requests through the port's entry
point on each of three paths (320x320, bf16, batch 1):

    EN-GDF-PN-S0   K1 x4, K2 x4 a request
    EN-GDF-PN2-S0  K1 x4, K2 x4, K4 x4
    EF-GDF-PN-S0   K1 x4, K2 x4, K3 x4

and checks them against the same weights run in float32 through the plain
versions on the CPU.  K2 is also held against its plain version on the
exact route (band None) at C = 3, 320^2, and K4 at batch 3; K2's and K4's
launch plans are logged.  K1 is timed as its single launch on weights packed
once (the pack, which DeformableConv2d caches, is timed once beside it);
each path logs its kernel launches a request and its kernels/frame under
torch.profiler.  Any failure raises; the last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

The line before it lists each kernel with its launches on the serving
paths, its worst float32 error against the plain version, its device time
and the plain version's over one frame's calls, and the least time the
card could take for the same work.  Imports nothing of JAX.  Exits non-zero
without a result where no GPU is visible.
"""
from __future__ import annotations

import copy
import json
import subprocess

import numpy as np
import torch

from achelous_tpu_torch.kernels.timing import cuda_ms, device_ms

REQUESTS = 8
BAND = 4
# Kernel vs plain, same inputs on the card.  float32: the two sum in other
# orders (and the conv inside K1 is not cuDNN's), ~1e-6 relative per value,
# so 1e-4 leaves margin.  bf16: both compute in float32 and round the output
# once to bf16 (2^-8 relative), so results differ by at most one bf16 step.
# K4's indices must be equal.
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
# K3 at EfficientFormerV2-S0's Attention4D: stage-2 blocks 4-5 (after the
# stride-2 conv) and stage-3 blocks 2-3, all N = 10^2 at 320x320
K3_CALLS = ("stage2.4", "stage2.5", "stage3.2", "stage3.3")
K3_HEADS, K3_DK, K3_DV, K3_N = 8, 32, 128, 100
# K4 at PointNet++'s four set-abstraction levels: (N, npoint)
K4_SHAPES = ((512, 128), (128, 32), (32, 8), (8, 4))
# (name, backbone, pc_model, launches a request of each kernel)
PATHS = (
    ("EN-GDF-PN-S0", "en", "pn",
     {"fused_radarconv": 4, "deform_samples": 4}),
    ("EN-GDF-PN2-S0", "en", "pn2",
     {"fused_radarconv": 4, "deform_samples": 4, "farthest_point_sample": 4}),
    ("EF-GDF-PN-S0", "ef", "pn",
     {"fused_radarconv": 4, "deform_samples": 4, "fused_bias_attention": 4}),
)
# The least time of a call: the larger of its bytes (each input read once,
# each output written once) over the HBM rate and its operations over the
# peak rate for the inputs' type (NVIDIA's H100 SXM data sheet at 700 W:
# 3.35 TB/s; 989 TFLOP/s bf16 dense, 67 TFLOP/s float32 outside the tensor
# cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def wrappers():
    """Kernel name -> its wrapper, which counts launches in `launches`."""
    from achelous_tpu_torch.ops import (hopper_attention, hopper_deform,
                                        hopper_pointops)
    return {"fused_radarconv": hopper_deform.fused_radarconv,
            "deform_samples": hopper_deform.deform_samples,
            "fused_bias_attention": hopper_attention.fused_bias_attention,
            "farthest_point_sample": hopper_pointops.farthest_point_sample}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nb: int, flops: float, dtype) -> tuple[float, float]:
    """(ms to move `nb` bytes, ms to do `flops` operations) on an H100."""
    return nb / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def k1_case(rng, c, h, ow, ob, dev):
    """Raw input and RadarConv weights (port layout) for one K1 call."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t(rng.randn(18, c, 3, 3) * ow),
            t(rng.randn(18) * ob), t(rng.randn(9, c, 3, 3) * 0.3),
            t(rng.randn(9) * 0.3), t(rng.randn(c, c, 3, 3) * 0.2))


def k1_flops(args) -> float:
    """Per pixel: 3x3 pool (10 a channel), offset and modulator conv
    (27 x 9C MACs), tap weights and the sigmoid (~126), modulated bilinear
    samples (9 taps x 9 a channel), projection (9C x Cout MACs)."""
    _, c, h, w = args[0].shape
    cout = args[5].shape[0]
    return h * w * (10 * c + 486 * c + 126 + 81 * c + 18 * c * cout)


def k2_case(rng, c, h, scale, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t((rng.rand(1, 18, h, h) * 2 - 1) * scale),
            t(rng.rand(1, 9, h, h) * 2))


def k2_flops(args) -> float:
    """Per tap and pixel: bilinear weights (~10), then 4 MACs and the mask
    product per channel."""
    b, c, h, w = args[0].shape
    return b * 9 * h * w * (10 + 9 * c)


def k3_case(rng, b, n, dev):
    """q, k, v, bias, th1_w, th1_b, th2_w, th2_b, float32, non-symmetric
    head mixes."""
    h = K3_HEADS
    shapes = ((b, h, n, K3_DK), (b, h, n, K3_DK), (b, h, n, K3_DV), (h, n, n),
              (h, h), (h,), (h, h), (h,))
    return [torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(dev)
            for s in shapes]


def k3_flops(args) -> float:
    """q.k^T, scale and bias, two head mixes with their biases, softmax
    (~5 a logit), P.v."""
    b, h, n, dk = args[0].shape
    dv = args[2].shape[-1]
    logits = b * h * n * n
    return logits * (2 * dk + 2 + 2 * (2 * h + 1) + 5 + 2 * dv)


def k4_flops(n: int, npoint: int) -> float:
    """Per step and point: 3 subtractions, 3 products, 2 sums, the min and
    the argmax comparison."""
    return npoint * n * 10


def check(name, got, want, dtype, top):
    """Max abs error of the kernel's output against the plain version's;
    raises outside TOL.  `top[dtype]` keeps the largest |output| seen, the
    scale a bf16 step is read against."""
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version, "
                             f"max abs err {err} (rtol {rtol}, atol {atol})")
    top[dtype] = max(top[dtype], w.abs().max().item())
    return err


def timed(name, label, kernel, plain, plain_iters=5):
    """Device and as-issued ms of one call, kernel and plain; logged."""
    t_k, t_p = device_ms(kernel), device_ms(plain, plain_iters)
    h_k, h_p = cuda_ms(kernel), cuda_ms(plain)
    log(f"kernel {name} {label}: device {t_k:.4f} ms (plain {t_p:.4f} ms); "
        f"as issued {h_k:.4f} ms (plain {h_p:.4f} ms)")
    return t_k, t_p


def result(worst, ms, plain_ms, t_bytes, t_ops):
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=sum(max(b, o) for b, o in zip(t_bytes, t_ops)),
                bound_by="bytes" if sum(t_bytes) >= sum(t_ops)
                else "operations",
                # no single PyTorch call computes these functions: the
                # RadarConv and its banded sampling have none, the head mix
                # sits inside the softmax, FPS is sequential
                library_ms=None)


def check_deform_kernels(dev, rng):
    """K1 and K2 against their plain versions at the serving shapes,
    float32 (TF32 off) and bf16."""
    from achelous_tpu_torch.ops import deform, hopper_deform
    w = wrappers()
    results = {}

    def k1_bind(a):
        """K1 on one case: the weights packed once, outside any timing, as
        DeformableConv2d caches them; the call is the kernel's one launch."""
        packed = hopper_deform.pack_radarconv_weights(*a[1:])
        return lambda: w["fused_radarconv"](a[0], *packed, BAND)

    specs = (
        ("fused_radarconv", deform.fused_radarconv_reference, K1_SHAPES,
         K1_OFFSETS, lambda c, h, o: k1_case(rng, c, h, *o, dev), k1_flops,
         k1_bind),
        ("deform_samples", deform.banded_deform_samples, K2_SHAPES,
         K2_OFFSETS, lambda c, h, o: k2_case(rng, c, h, o, dev), k2_flops,
         lambda a: lambda: w["deform_samples"](*a, BAND)),
    )
    for name, plain, shapes, offsets, make, flops, bind in specs:
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        top = dict(worst)
        ms = plain_ms = 0.0
        t_bytes, t_ops = [], []
        for block, c, h in shapes:
            for off in offsets:
                args = make(c, h, off)
                for dt in (torch.float32, torch.bfloat16):
                    a = [x.to(dt) for x in args]
                    got = bind(a)()
                    want = plain(*a, BAND)
                    torch.cuda.synchronize()
                    worst[dt] = max(worst[dt], check(
                        f"{name} block {block} {dt} offsets {off}", got,
                        want, dt, top))
            # time the serving dtype at the largest-offset regime: device
            # time per call, and the rate the host issues calls at
            a = [x.to(torch.bfloat16) for x in args]
            if name == "deform_samples":
                plan = hopper_deform.deform_samples_plan(
                    1, c, h, h, hopper_deform.sm_count(dev))
                log(f"kernel deform_samples block {block} C={c} {h}x{h} "
                    f"bf16: plan {plan}")
            kernel = bind(a)
            t_k, t_p = timed(name, f"block {block} C={c} {h}x{h} bf16",
                             kernel, lambda: plain(*a, BAND))
            if name == "fused_radarconv" and block == 0:
                def pack():
                    return hopper_deform.pack_radarconv_weights(*a[1:])
                log(f"kernel fused_radarconv: weight pack (once a module, "
                    f"cached) device {device_ms(pack):.4f} ms, as issued "
                    f"{cuda_ms(pack):.4f} ms")
            ms += t_k
            plain_ms += t_p
            out = kernel()
            tb, to = bound(nbytes(*a, out), flops(a), torch.bfloat16)
            t_bytes.append(tb)
            t_ops.append(to)
        if name == "deform_samples":
            worst = check_exact_samples(dev, rng, worst, top)
        log(f"kernel {name}: max abs err f32 {worst[torch.float32]:.3g}, "
            f"bf16 {worst[torch.bfloat16]:.3g} (max |out| "
            f"{top[torch.bfloat16]:.3g})")
        results[name] = result(worst[torch.float32], ms, plain_ms, t_bytes,
                               t_ops)
    return results


def check_exact_samples(dev, rng, worst, top):
    """K2 on the exact route (band None), which a reference checkpoint
    takes at every RCNet block: block 0's shape, C = 3 at 320^2, offsets
    past the band.  Timed and logged; not part of a serving frame."""
    from achelous_tpu_torch.ops import deform, hopper_deform
    kernel = wrappers()["deform_samples"]
    args = k2_case(rng, 3, 320, 9.0, dev)
    for dt in (torch.float32, torch.bfloat16):
        a = [x.to(dt) for x in args]
        got = kernel(*a, None)
        want = deform.banded_deform_samples(*a, None)
        torch.cuda.synchronize()
        worst[dt] = max(worst[dt], check(
            f"deform_samples band None C=3 320x320 {dt}", got, want, dt, top))
    plan = hopper_deform.deform_samples_plan(1, 3, 320, 320,
                                             hopper_deform.sm_count(dev))
    log(f"kernel deform_samples band None C=3 320x320 bf16: plan {plan}")
    timed("deform_samples", "band None C=3 320x320 bf16",
          lambda: kernel(*a, None),
          lambda: deform.banded_deform_samples(*a, None))
    return worst


def check_attention_kernel(dev, rng):
    """K3 against its plain version at the serving shape (batch 1, N = 100)
    and at N = 16, batch 2, float32 (TF32 off) and bf16."""
    from achelous_tpu_torch.ops.attention import reference_bias_attention
    kernel = wrappers()["fused_bias_attention"]
    scale = K3_DK ** -0.5
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    top = dict(worst)
    for b, n in ((1, K3_N), (2, 16)):
        args = k3_case(rng, b, n, dev)
        for dt in (torch.float32, torch.bfloat16):
            a = [x.to(dt) for x in args]
            got = kernel(*a, scale)
            want = reference_bias_attention(*a, scale)
            torch.cuda.synchronize()
            worst[dt] = max(worst[dt], check(
                f"fused_bias_attention B={b} N={n} {dt}", got, want, dt,
                top))
    ms = plain_ms = 0.0
    t_bytes, t_ops = [], []
    for call in K3_CALLS:
        a = [x.to(torch.bfloat16) for x in k3_case(rng, 1, K3_N, dev)]
        t_k, t_p = timed("fused_bias_attention", f"{call} N={K3_N} bf16",
                         lambda: kernel(*a, scale),
                         lambda: reference_bias_attention(*a, scale))
        ms += t_k
        plain_ms += t_p
        tb, to = bound(nbytes(*a, kernel(*a, scale)), k3_flops(a),
                       torch.bfloat16)
        t_bytes.append(tb)
        t_ops.append(to)
    log(f"kernel fused_bias_attention: max abs err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g} "
        f"(max |out| {top[torch.bfloat16]:.3g})")
    return result(worst[torch.float32], ms, plain_ms, t_bytes, t_ops)


def k4_cases(rng):
    """(label, xyz [B,N,3] float32 numpy, npoint, valid or None)."""
    cases = [(f"random {n}->{s}", rng.rand(1, n, 3), s, None)
             for n, s in K4_SHAPES]
    # the data loader resamples 512 points with replacement: duplicates,
    # and coarse coordinates make equal distances common
    base = np.round(rng.rand(60, 3) * 16) / 16
    for n, s in K4_SHAPES:
        cases.append((f"resampled {n}->{s}",
                      base[rng.randint(0, 60, (1, n))], s, None))
        cases.append((f"valid {n}->{s}", rng.randn(1, n, 3), s,
                      rng.rand(1, n) > 0.3))
        cases.append((f"identical {n}->{s}", np.ones((1, n, 3)), s, None))
    # batch 3: a block a batch element
    cases.append(("random B=3 512->128", rng.rand(3, 512, 3), 128, None))
    cases.append(("valid B=3 512->128", rng.randn(3, 512, 3), 128,
                  rng.rand(3, 512) > 0.3))
    return [(lbl, x.astype(np.float32), s, v) for lbl, x, s, v in cases]


def check_fps_kernel(dev, rng):
    """K4's indices equal its plain version's on the card, at the four
    set-abstraction shapes, on random points, resampled duplicates, a valid
    mask and identical points."""
    from achelous_tpu_torch.ops.hopper_pointops import fps_plan
    from achelous_tpu_torch.ops.pointops import farthest_point_sample as plain
    kernel = wrappers()["farthest_point_sample"]
    log("kernel farthest_point_sample plans (threads, points a thread): "
        + ", ".join(f"N={n} {fps_plan(n)}" for n, _ in K4_SHAPES)
        + "; cross-warp winner by compare tree up to 4 warps")
    cases = k4_cases(rng)
    for label, xyz, npoint, valid in cases:
        x = torch.from_numpy(xyz).to(dev)
        v = None if valid is None else torch.from_numpy(valid).to(dev)
        got, want = kernel(x, npoint, v), plain(x, npoint, v)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"farthest_point_sample {label}: {bad} "
                                 f"indices differ from the plain version")
    ms = plain_ms = 0.0
    t_bytes, t_ops = [], []
    for n, npoint in K4_SHAPES:
        x = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32)).to(dev)
        t_k, t_p = timed("farthest_point_sample", f"{n}->{npoint} f32",
                         lambda: kernel(x, npoint), lambda: plain(x, npoint),
                         plain_iters=1)
        ms += t_k
        plain_ms += t_p
        tb, to = bound(nbytes(x, kernel(x, npoint)), k4_flops(n, npoint),
                       torch.float32)
        t_bytes.append(tb)
        t_ops.append(to)
    log(f"kernel farthest_point_sample: indices equal on {len(cases)} "
        f"cases")
    return result(0.0, ms, plain_ms, t_bytes, t_ops)


def check_kernels(dev):
    """Phase 3: every kernel against its plain version; per-kernel
    results."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    results = check_deform_kernels(dev, rng)
    results["fused_bias_attention"] = check_attention_kernel(dev, rng)
    results["farthest_point_sample"] = check_fps_kernel(dev, rng)
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


def record_set_abstraction(model):
    """Per set-abstraction level, a list that collects (xyz in, centres
    out) of every forward, and the hooks' handles."""
    records, handles = [], []
    for i in range(1, 5):
        rec = []
        handles.append(getattr(model.pc_seg_model, f"sa{i}")
                       .register_forward_hook(
                           lambda m, inp, out, rec=rec:
                           rec.append((inp[0], out[0]))))
        records.append(rec)
    return records, handles


def check_fps_on_path(npoints, card_records, ref_records):
    """The PN2 path's FPS on the card picked exactly the plain version's
    indices on the same bf16-rounded points, at every level."""
    from achelous_tpu_torch.ops.pointops import farthest_point_sample as plain
    kernel = wrappers()["farthest_point_sample"]
    for lvl, (card, ref) in enumerate(zip(card_records, ref_records)):
        if len(card) != REQUESTS or len(ref) != REQUESTS:
            raise AssertionError(f"sa{lvl + 1}: {len(card)} card and "
                                 f"{len(ref)} reference records")
        for i, ((xyz, centres), (rxyz, rcentres)) in enumerate(zip(card, ref)):
            if not (torch.equal(xyz.cpu(), rxyz)
                    and torch.equal(centres.cpu(), rcentres)):
                raise AssertionError(f"sa{lvl + 1} request {i}: FPS centres "
                                     f"on the card differ from plain")
            got = kernel(xyz.contiguous(), npoints[lvl]).cpu()
            if not torch.equal(got, plain(rxyz, npoints[lvl])):
                raise AssertionError(f"sa{lvl + 1} request {i}: FPS indices "
                                     f"on the card differ from plain")


def serve_path(dev, label, backbone, pc_model, want_rose):
    """Phase 4: serve REQUESTS requests through entry() on one path, with
    the launch counts set to 0 just before and read just after; check the
    outputs against float32 plain on the CPU."""
    from achelous_tpu_torch.entry import (entry, perturb_attention,
                                          perturb_deform_convs)
    from achelous_tpu_torch.models.achelous import cast_compute

    fn, _ = entry(dev, torch.Generator().manual_seed(0), backbone, pc_model)
    model, cfg = fn.model, fn.cfg
    if cfg.name != label:
        raise AssertionError(f"entry built {cfg.name}, want {label}")
    perturb_deform_convs(model)
    perturb_attention(model)
    # the same (bf16) weights in float32 on the CPU: the plain versions
    ref_model = cast_compute(copy.deepcopy(model).cpu(), torch.float32)
    pn2 = pc_model == "pn2"

    reqs = requests(cfg, REQUESTS)
    dev_reqs = [tuple(t.to(dev, cfg.dtype) for t in q) for q in reqs]
    fn(*dev_reqs[0])                                   # warm-up
    torch.cuda.synchronize()
    if pn2:
        card_sa, hooks = record_set_abstraction(model)
        ref_sa, ref_hooks = record_set_abstraction(ref_model)

    w = wrappers()
    want_rose = {n: want_rose.get(n, 0) for n in w}
    for f in w.values():
        f.launches = 0
    outs = []
    for i, q in enumerate(dev_reqs):
        before = {n: f.launches for n, f in w.items()}
        outs.append(fn(*q))
        rose = {n: f.launches - before[n] for n, f in w.items()}
        if rose != want_rose:
            raise AssertionError(f"{label} request {i}: kernel launches "
                                 f"{rose}, want {want_rose}")
    torch.cuda.synchronize()
    counts = {n: f.launches for n, f in w.items()}
    log(f"main path {label}: launches over {REQUESTS} requests {counts}; "
        f"a request {want_rose}")

    r, k = cfg.resolution, cfg.num_det
    worst = {}
    with torch.inference_mode():
        for q, dq, (dets, sem, lane, pc) in zip(reqs, dev_reqs, outs):
            det = model.det_head(model.image_radar_encoder(*dq[:2])[0])
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
    log(f"main path {label} vs float32 plain (max err / max(1, max|ref|)): "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()))
    bad = {n: e for n, e in worst.items() if e > MAIN_PATH_TOL}
    if bad:
        raise AssertionError(f"{label} outside {MAIN_PATH_TOL}: {bad}")
    if pn2:
        for h in hooks + ref_hooks:
            h.remove()
        check_fps_on_path([getattr(model.pc_seg_model, f"sa{i}").npoint
                           for i in range(1, 5)], card_sa, ref_sa)
        log(f"main path {label}: FPS indices on the card equal plain at "
            f"every level of every request")
    return counts, model, fn


def time_path(label, model, fn, dev_req):
    from achelous_tpu_torch.trace_serving import profile_frames
    ms_full = cuda_ms(lambda: fn(*dev_req), iters=50)
    with torch.inference_mode():
        ms_fwd = cuda_ms(lambda: model(*dev_req), iters=50)
    log(f"main path {label} bf16 bs1 320x320: fwd+decode+NMS {ms_full:.3f} "
        f"ms/frame, fwd only {ms_fwd:.3f} ms/frame")
    wall, busy, kernels, _ = profile_frames(fn, dev_req, frames=5)
    log(f"main path {label} under torch.profiler, 5 frames: kernels/frame "
        f"{kernels:.0f}, device busy {busy:.3f} ms/frame of {wall:.3f} ms "
        f"wall")


def main():
    log(device_line())
    dev = torch.device("cuda", 0)
    from achelous_tpu_torch.kernels import build
    secs = build.build()
    log(f"build: {secs:.2f} s ({build.library_path().name})")
    kernels = check_kernels(dev)
    launches = {n: 0 for n in kernels}
    for label, backbone, pc_model, want_rose in PATHS:
        counts, model, fn = serve_path(dev, label, backbone, pc_model,
                                       want_rose)
        for n, c in counts.items():
            launches[n] += c
        q = tuple(torch.rand(s, device=dev).to(fn.cfg.dtype) for s in
                  ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5)))
        time_path(label, model, fn, q)
        del model, fn
    rows = []
    for name, source, replaces in (
            ("fused_radarconv", "achelous_tpu_torch/csrc/deform.cu",
             "achelous_tpu/ops/pallas_deform.py:445"),
            ("deform_samples", "achelous_tpu_torch/csrc/deform.cu",
             "achelous_tpu/ops/pallas_deform.py:219"),
            ("fused_bias_attention", "achelous_tpu_torch/csrc/attention.cu",
             "achelous_tpu/ops/pallas_attention.py:69"),
            ("farthest_point_sample", "achelous_tpu_torch/csrc/pointops.cu",
             "achelous_tpu/ops/pallas_pointops.py:58")):
        if launches[name] == 0:
            raise AssertionError(f"{name}: no launch on the serving paths")
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
