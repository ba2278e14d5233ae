"""Prediction CLI (counterpart of achelous_tpu/predict_cli.py; the
reference's predict.py mode switch, predict.py:23-141).

Modes: predict (one image), dir_predict, heatmap, export (`torch.export`),
video (cv2 frame loop), fps (test_interval latency probe).  The reference
advertises 'video' and 'fps' (predict.py:141) and documents their knobs
(predict.py:33-52) but ships no branch for either; they follow the
documented semantics, as in JAX.

  python -m achelous_tpu_torch.predict_cli --mode predict --image img.jpg \\
      --radar_csv r.csv --ckpt logs/ckpt/best_epoch_weights

Runs on the GPU unless `--device cpu`; bf16, as the JAX CLI.  `--weights`
reads a `weights.save_weights` file, `--ckpt`
a `train/checkpoints` checkpoint, whose EMA parameters and statistics it
serves; with `--deploy` they are folded first (in float32), so a trained
RV-, MO- or FV- checkpoint is served in its deploy form:

  python -m achelous_tpu_torch.predict_cli --backbone mo --neck rdf \
      --ckpt logs/ckpt/last_epoch_weights --deploy --image img.jpg \
      --radar_csv r.csv

The video mode imports cv2, and raises its ImportError where cv2 is
missing.
"""
from __future__ import annotations

import argparse
import json
import os

from achelous_tpu_torch.core.config import (BACKBONES, NECKS, PC_MODELS,
                                            WIDTHS)
from achelous_tpu_torch.train.cli import parse_band


def build_parser():
    p = argparse.ArgumentParser(description="Achelous predictor (PyTorch)")
    p.add_argument("--mode", default="predict",
                   choices=["predict", "dir_predict", "heatmap", "export",
                            "video", "fps"])
    p.add_argument("--backbone", default="en", choices=BACKBONES)
    p.add_argument("--neck", default="gdf", choices=NECKS)
    p.add_argument("--phi", default="S0", choices=sorted(WIDTHS))
    p.add_argument("--pc_model", default="pn", choices=PC_MODELS)
    p.add_argument("--resolution", type=int, default=320)
    p.add_argument("--confidence", type=float, default=0.35)
    p.add_argument("--nms_iou", type=float, default=0.35)
    p.add_argument("--image", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--radar_npz", default="")
    p.add_argument("--radar_csv", default="")
    p.add_argument("--ckpt", default="",
                   help="train/checkpoints checkpoint (<dir>/<name>, no "
                        ".pt) whose EMA to serve")
    p.add_argument("--weights", default="",
                   help="weight file of weights.save_weights; "
                        "torch-transplant stamps select the unclipped "
                        "deformable path")
    p.add_argument("--deform_band", default="auto", type=parse_band,
                   help="deformable-conv offset band: 'auto' (config "
                        "default, or unclipped for stamped torch "
                        "transplants), 'none' (unclipped) or an integer "
                        "cell radius")
    p.add_argument("--deploy", action="store_true",
                   help="fold the reparameterizable blocks (RepVGG, "
                        "MobileOne, RepVGGDW, RepMixer, large-kernel conv) "
                        "into single convs before serving")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: the GPU)")
    p.add_argument("--out", default="export_results")
    # video mode (reference predict.py:33-44)
    p.add_argument("--video", default="", help="input video path")
    p.add_argument("--video_out", default="", help="annotated output path"
                   " (empty = don't save, reference video_save_path='')")
    p.add_argument("--video_fps", type=float, default=0.0,
                   help="output fps (0 = inherit from the input)")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = all)")
    # fps mode (reference predict.py:46-52)
    p.add_argument("--test_interval", type=int, default=100,
                   help="detections per fps measurement")
    return p


def load_predictor(args, dtype=None):
    """The predictor of `args`, computing in `dtype` (bf16, as the JAX CLI,
    where None)."""
    import torch

    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.predict import AchelousPredictor
    band = args.deform_band
    cfg_kw = {} if band == "auto" else {"deform_band": band}
    cfg = AchelousConfig(backbone=args.backbone, neck=args.neck, phi=args.phi,
                         pc_model=args.pc_model, resolution=args.resolution,
                         dtype=dtype or torch.bfloat16, **cfg_kw)
    kw = dict(confidence=args.confidence, nms_iou=args.nms_iou,
              deploy=args.deploy, device=args.device)
    if args.weights:
        # the file's provenance stamp decides the band unless
        # --deform_band was given
        return AchelousPredictor.from_weights(
            cfg, args.weights, force_band=(band != "auto"), **kw)
    state_dict = None
    if args.ckpt:
        from achelous_tpu_torch.models.achelous import create_model
        from achelous_tpu_torch.train.checkpoints import CheckpointManager
        from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                          create_train_state)
        model = create_model(cfg, "cpu", train=True)
        state = CheckpointManager(os.path.dirname(args.ckpt)).restore(
            os.path.basename(args.ckpt),
            create_train_state(model, cfg, TrainConfig()))
        state_dict = {**state.ema_params, **state.ema_batch_stats}
    return AchelousPredictor(cfg, state_dict, **kw)


def run_one(pred, args, image_path, out_dir):
    from PIL import Image
    import numpy as np

    from achelous_tpu_torch.visualize import render_detection
    img = Image.open(image_path)
    r = pred.detect(img, radar_npz=args.radar_npz or None,
                    radar_csv=args.radar_csv or None)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]
    summary = {
        "image": image_path,
        "num_detections": int(len(r["boxes"])),
        "detections": [
            {"box": b.tolist(), "score": float(s),
             "class": pred.class_names[int(c)] if int(c) < len(pred.class_names)
             else int(c)}
            for b, s, c in zip(r["boxes"], r["scores"], r["classes"])],
        "drivable_pixels": int((r["drivable"] == 8).sum()),
        "waterline_pixels": int((r["waterline"] > 0).sum()),
    }
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(summary, f, indent=1)
    np.savez_compressed(os.path.join(out_dir, stem + "_masks.npz"),
                        semantic=r["semantic"].astype(np.uint8),
                        waterline=r["waterline"].astype(np.uint8))
    render_detection(img, r, pred.class_names).save(
        os.path.join(out_dir, stem + "_vis.jpg"))
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "detections"}))
    return summary


def main(argv=None):
    args = build_parser().parse_args(argv)
    pred = load_predictor(args)
    if args.mode == "predict":
        return run_one(pred, args, args.image, args.out)
    if args.mode == "dir_predict":
        return [run_one(pred, args, os.path.join(args.image_dir, name),
                        args.out)
                for name in sorted(os.listdir(args.image_dir))
                if name.lower().endswith((".jpg", ".jpeg", ".png"))]
    if args.mode == "heatmap":
        from PIL import Image
        import numpy as np
        hm = pred.detect_heatmap(Image.open(args.image),
                                 radar_npz=args.radar_npz or None,
                                 radar_csv=args.radar_csv or None)
        os.makedirs(args.out, exist_ok=True)
        out = os.path.join(args.out, "heatmap.npy")
        np.save(out, hm)
        res = {"heatmap": out, "max": float(hm.max())}
    elif args.mode == "export":
        from achelous_tpu_torch.predict import export_program
        os.makedirs(args.out, exist_ok=True)
        path = export_program(pred, os.path.join(args.out, "achelous.pt2"))
        res = {"exported": path, "bytes": os.path.getsize(path)}
    elif args.mode == "video":
        res = run_video(pred, args)
    else:
        res = run_fps_probe(pred, args)
    print(json.dumps(res))
    return res


def run_video(pred, args) -> dict:
    """cv2 frame loop: detect every frame, draw, write the annotated video
    (the reference's documented-but-unshipped 'video' mode,
    predict.py:33-44: video_path -> detect_image per frame -> fps overlay ->
    optional VideoWriter at video_fps)."""
    import time

    import cv2
    import numpy as np
    from PIL import Image

    from achelous_tpu_torch.visualize import render_detection

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise ValueError(f"could not open video {args.video!r}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    writer = None
    n, t_total = 0, 0.0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        pil = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        t0 = time.perf_counter()
        r = pred.detect(pil, radar_npz=args.radar_npz or None,
                        radar_csv=args.radar_csv or None)
        dt = time.perf_counter() - t0
        t_total += dt
        n += 1
        vis = render_detection(pil, r, pred.class_names)
        out = cv2.cvtColor(np.asarray(vis.convert("RGB")), cv2.COLOR_RGB2BGR)
        cv2.putText(out, f"fps= {1.0 / max(dt, 1e-9):.2f}", (0, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
        if args.video_out:
            if writer is None:
                h, w = out.shape[:2]
                writer = cv2.VideoWriter(
                    args.video_out, cv2.VideoWriter_fourcc(*"mp4v"),
                    args.video_fps or src_fps, (w, h))
            writer.write(out)
        if args.max_frames and n >= args.max_frames:
            break
    cap.release()
    if writer is not None:
        writer.release()
    return {"frames": n, "video_out": args.video_out or None,
            "mean_detect_s": round(t_total / max(n, 1), 4),
            "mean_fps": round(n / t_total, 2) if t_total else None}


def run_fps_probe(pred, args) -> dict:
    """The reference's 'fps' mode (predict.py:46-52): the full detect
    pipeline test_interval times on one image, in seconds/image.  Each
    call brings its results to the host, so this is the synchronous end
    to end latency (preprocess + forward + decode + NMS + unmap), as the
    reference's get_FPS times whole detections."""
    import time

    from PIL import Image

    img = Image.open(args.image)
    kw = dict(radar_npz=args.radar_npz or None,
              radar_csv=args.radar_csv or None)
    pred.detect(img, **kw)                      # warm-up
    t0 = time.perf_counter()
    for _ in range(args.test_interval):
        pred.detect(img, **kw)
    dt = (time.perf_counter() - t0) / args.test_interval
    return {"test_interval": args.test_interval,
            "seconds_per_image": dt, "fps": 1.0 / dt}


if __name__ == "__main__":
    main()
