"""Where a training step's time goes on the GPU.

    python -m achelous_tpu_torch.trace_training [--steps N] [--out DIR]
        [--backbone ef] [--pc_model pn2]

EN-GDF-PN-S0 (or EF-GDF-PN-S0, EN-GDF-PN2-S0) at 320x320, batch 32, bf16
compute on float32 parameters, the default TrainConfig, random weights
with non-zero deformable offsets (and EF's attention scales drawn),
synthetic batches: two steps to warm up, then N (default 3) under
torch.profiler.  Prints, per step: wall time, the device's busy time (the
sum of kernel times), kernel launches, each phase of the step
(`train_step/forward`, `/losses`, `/backward`, `/update`) with its host
time and the device time of the kernels it launched, K1's, K2's and K3's
backward (the plain versions' recompute and autograd), and the kernels
with the most device time.  The backward's kernels are launched from
autograd's own thread, so `/backward` shows their host time only; their
device time is the busy time less the other phases'.  The full table goes to
DIR/training_profile.txt (default traces/).  Needs a GPU.
"""
from __future__ import annotations

import argparse
import pathlib

import torch

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.entry import perturb_attention, perturb_deform_convs
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.trace_serving import kernel_rows, profile_frames
from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                  create_train_state,
                                                  make_train_step)

PHASES = ("train_step/forward", "train_step/losses", "train_step/backward",
          "train_step/update", "FusedRadarConvBackward",
          "DeformSamplesBackward", "FusedBiasAttentionBackward")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="traces")
    ap.add_argument("--backbone", default="en", choices=["en", "ef"])
    ap.add_argument("--pc_model", default="pn", choices=["pn", "pn2"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_training needs a CUDA device")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    dev = torch.device("cuda", 0)
    cfg = AchelousConfig(resolution=320, dtype=torch.bfloat16,
                         backbone=args.backbone, pc_model=args.pc_model)
    tcfg = TrainConfig()
    model = create_model(cfg, dev, torch.Generator().manual_seed(0),
                         train=True)
    perturb_deform_convs(model)
    perturb_attention(model)
    state = create_train_state(model, cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    batch = synthetic_batch(cfg, tcfg.batch_size, tcfg.max_gt, seed=100,
                            device=dev)
    for _ in range(2):
        step(state, batch, 1e-3)
    torch.cuda.synchronize()

    wall, busy, kernels, prof = profile_frames(
        lambda: step(state, batch, 1e-3), (), frames=args.steps)
    events = prof.key_averages()
    (out / f"training_profile_{cfg.name}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=80))
    n = args.steps
    print(f"{cfg.name} train bs{tcfg.batch_size} per step: wall {wall:.2f} "
          f"ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), "
          f"{kernels:.0f} kernels")
    for e in events:
        if e.key in PHASES and \
                e.device_type == torch.autograd.DeviceType.CPU:
            print(f"  {e.key:28s} host {e.cpu_time_total / 1e3 / n:9.2f} ms"
                  f", device {e.device_time_total / 1e3 / n:9.2f} ms, "
                  f"{e.count / n:.0f}x")
    rows = kernel_rows(events)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"{e.count / n:6.1f}x  {e.key[:90]}")


if __name__ == "__main__":
    main()
