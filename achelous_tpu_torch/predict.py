"""Inference wrapper (counterpart of achelous_tpu/predict.py; the reference's
`achelous` class and predict.py modes, achelous.py:116-655).

`AchelousPredictor` runs one request function, `Request`: the 5-task
forward, decode, class-aware NMS and the float32 softmax of the semantic
and waterline logits, under `torch.inference_mode`.  Letterboxing the
frame, reading the radar (an npz map, or a CSV splatted on the
predictor's device), resampling the point cloud and mapping the results
back to the frame's pixels surround it.  The reference min-max normalises
the radar map at predict time only (achelous.py:212) while its training
feeds raw maps, so that is opt-in (`minmax_radar`), as in JAX.

`export_program` is the counterpart of JAX's `export_stablehlo`:
`torch.export` of the request function, saved with `torch.export.save`.
Each hand-written kernel is one custom-operator node of the exported graph
(`achelous::fused_radarconv`, ...), so the program that
`torch.export.load` returns launches them.

`AchelousPredictor.sharded_infer(devices)` is the counterpart of JAX's
data-parallel inference over a mesh (the reference's `nn.DataParallel`
wrap, achelous.py:176): a batch split over devices, each holding a
replica of the request function, the outputs gathered in batch order.

Everything runs on the GPU unless the caller passes the CPU as `device`.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.waterscenes import (PC_FEATURES, SPLAT_FEATURES,
                                                 letterbox, load_radar_csv,
                                                 preprocess_image,
                                                 resample_pointcloud)
from achelous_tpu_torch.models.achelous import _device, create_model
from achelous_tpu_torch.ops.postprocess import (Detections, decode_outputs,
                                                non_max_suppression)
from achelous_tpu_torch.ops.radar_splat import (minmax_normalize,
                                                splat_radar_fast)
from achelous_tpu_torch.ops.resize import resize_bilinear
from achelous_tpu_torch.weights import load_weights

# WaterScenes benchmark classes (model_data/waterscenes_benchmark.txt)
DEFAULT_CLASS_NAMES = ("pier", "buoy", "sailor", "ship", "boat", "vessel",
                       "kayak")
# the provenance stamp of weights trained with unbounded deformable offsets
TRANSPLANT = "torch-transplant"
DRIVABLE_CLASS = 8      # the semantic class the drivable mask keeps


class Request(nn.Module):
    """The request function as a module (what `torch.export` takes):
    (image, radar, points) -> a flat tuple of tensors, `unpack` regroups
    it as (Detections, sem_prob, lane_prob, pc, det maps)."""

    def __init__(self, model: nn.Module, confidence: float, nms_iou: float,
                 max_det: int):
        super().__init__()
        self.model = model
        self.confidence, self.nms_iou, self.max_det = (confidence, nms_iou,
                                                       max_det)

    def forward(self, image, radar, points):
        cfg = self.model.cfg
        r = cfg.resolution
        det, sem, lane, pc = self.model(image, radar, points)
        dets = non_max_suppression(decode_outputs(det, (r, r)), cfg.num_det,
                                   self.confidence, self.nms_iou,
                                   self.max_det)
        return (*dets, torch.softmax(sem.float(), 1),
                torch.softmax(lane.float(), 1), pc, *det)


def unpack(outputs):
    """A `Request`'s flat outputs -> (Detections, sem_prob [B,C,R,R],
    lane_prob [B,2,R,R], pc [B,N,classes], det maps)."""
    n = len(Detections._fields)
    dets = Detections(*outputs[:n])
    sem, lane, pc, *det = outputs[n:]
    return dets, sem, lane, pc, tuple(det)


class AchelousPredictor:
    """End-to-end inference for one Achelous config on one device."""

    def __init__(self, cfg: AchelousConfig,
                 state_dict: Optional[dict] = None,
                 confidence: float = 0.35, nms_iou: float = 0.35,
                 max_det: int = 100, class_names=DEFAULT_CLASS_NAMES,
                 seed: int = 0, deploy: bool = False,
                 minmax_radar: bool = False,
                 device: torch.device | str = torch.device("cuda")):
        """`state_dict` (tensors or arrays by the port's train-form keys)
        replaces the parameters drawn from `seed`.  `deploy` folds every
        reparameterizable block (RepVGG, MobileOne, RepVGGDW, RepMixer,
        the large-kernel conv) into its single conv after the state dict
        is loaded and before the compute cast, in float32, as JAX's
        predictor folds before it compiles (`core/reparam.py`); where the
        configuration has none (EN, MV, EF, EV, PF with gdf or cdf), the
        model is the same.  Raises where `device` is a GPU and none is
        visible."""
        self.cfg = cfg
        self.device = _device(device)
        self.confidence, self.nms_iou = confidence, nms_iou
        self.class_names = class_names
        self.minmax_radar = minmax_radar
        model = create_model(cfg, self.device,
                             torch.Generator().manual_seed(seed),
                             deploy=deploy, state_dict=state_dict)
        self.model = model
        self.request = Request(model, confidence, nms_iou, max_det)

    @torch.inference_mode()
    def infer(self, image, radar, points):
        """The request function on prepared inputs: (Detections,
        sem_prob, lane_prob, pc, det maps)."""
        return unpack(self.request(image, radar, points))

    def sharded_infer(self, devices=None):
        """Data-parallel batched inference (counterpart of JAX's
        `sharded_infer`; the reference's `nn.DataParallel` wrap,
        achelous.py:176): a function of (image [B,...], radar [B,...],
        points [B,...]) that splits the batch into len(devices) equal
        shards, runs shard i through a replica of the request function
        (weights copied) on devices[i], and returns `infer`'s outputs with
        every tensor concatenated in batch order on devices[0].  The shards
        are issued one after another from the calling thread; a device
        runs its shard while the host issues the next, up to the request's
        host synchronisations (NMS's early exit).  Inference crosses no
        batch boundary (eval BatchNorm, NMS per image), so the outputs
        equal the single request's on the whole batch.  `devices` defaults
        to every visible GPU; a batch that the devices do not divide
        raises (JAX's fallback to XLA compositions is TPU machinery)."""
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("no CUDA device is visible; pass the "
                                   "devices, e.g. ['cpu', 'cpu']")
            devices = [torch.device("cuda", i) for i in range(n)]
        devices = [_device(d) for d in devices]
        replicas = [copy.deepcopy(self.request).to(d) for d in devices]

        @torch.inference_mode()
        def infer_sharded(image, radar, points):
            b, k = image.shape[0], len(devices)
            if b % k:
                raise ValueError(f"batch {b} not divisible by {k} devices")
            s = b // k
            outs = [req(*(t[i * s:(i + 1) * s].to(d, non_blocking=True)
                          for t in (image, radar, points)))
                    for i, (d, req) in enumerate(zip(devices, replicas))]
            return unpack([torch.cat([o[j].to(devices[0]) for o in outs])
                           for j in range(len(outs[0]))])

        return infer_sharded

    @classmethod
    def from_weights(cls, cfg: AchelousConfig, weights_path: str,
                     force_band: bool = False, **kwargs
                     ) -> "AchelousPredictor":
        """A predictor on a `weights.save_weights` file, honouring its
        provenance stamp: weights stamped "torch-transplant" were trained
        with unbounded deformable offsets, which the banded default would
        clip, so they are served at `deform_band=None` (K2 on every
        RadarConv) unless `force_band`."""
        state_dict, meta = load_weights(weights_path)
        if meta.get("provenance") == TRANSPLANT and not force_band \
                and cfg.deform_band is not None:
            logging.warning(
                "weights %s are a torch transplant (trained with unbounded "
                "deform offsets): overriding deform_band=%r -> None (exact "
                "gather).  Pass force_band=True to keep the banded path.",
                weights_path, cfg.deform_band)
            print(f"[achelous] torch-transplant weights: deform_band="
                  f"{cfg.deform_band!r} -> None (exact-gather parity path)",
                  flush=True)
            cfg = dataclasses.replace(cfg, deform_band=None)
        return cls(cfg, state_dict, **kwargs)

    # -- input preparation -------------------------------------------------
    def _batch(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, self.cfg.dtype)[None]

    def prepare_image(self, pil_image) -> torch.Tensor:
        """Letterboxed, normalised [1, 3, R, R]."""
        r = self.cfg.resolution
        img, _, _ = letterbox(pil_image.convert("RGB"), (r, r))
        return self._batch(preprocess_image(np.asarray(img))
                           .transpose(2, 0, 1).copy())

    def prepare_radar(self, npz_path: Optional[str] = None,
                      csv_path: Optional[str] = None) -> torch.Tensor:
        """The channels-first radar map [1, 3, R, R]: the npz's `arr_0`
        ([3, R, R], as the reference stores it), else the CSV's first
        `pc_points` points splatted on the device, else zeros."""
        cfg = self.cfg
        r = cfg.resolution
        if npz_path and os.path.exists(npz_path):
            m = torch.from_numpy(np.load(npz_path)["arr_0"]
                                 .astype(np.float32)).to(self.device)
        elif csv_path and os.path.exists(csv_path):
            pts = load_radar_csv(csv_path, SPLAT_FEATURES)
            n_real = min(len(pts), cfg.pc_points)
            pad = np.zeros((cfg.pc_points - n_real, 5), np.float32)
            pts = np.concatenate([pts[:n_real], pad])
            valid = np.arange(cfg.pc_points) < n_real
            m = splat_radar_fast(torch.from_numpy(pts).to(self.device),
                                 torch.from_numpy(valid).to(self.device),
                                 resolution=r)
        else:
            m = torch.zeros((cfg.radar_channels, r, r), device=self.device)
        if self.minmax_radar:
            m = minmax_normalize(m)
        return m.to(cfg.dtype)[None]

    def prepare_pointcloud(self, csv_path: Optional[str]) -> torch.Tensor:
        """[1, pc_points, 5]: the CSV's points resampled (RandomState(0))
        and L2-normalised per column, else zeros."""
        cfg = self.cfg
        if csv_path and os.path.exists(csv_path):
            feats = load_radar_csv(csv_path, PC_FEATURES)
            pc, _ = resample_pointcloud(feats, None, cfg.pc_points,
                                        np.random.RandomState(0))
        else:
            pc = np.zeros((cfg.pc_points, cfg.pc_channels), np.float32)
        return self._batch(pc)

    def prepare(self, pil_image, radar_npz=None, radar_csv=None):
        return (self.prepare_image(pil_image),
                self.prepare_radar(radar_npz, radar_csv),
                self.prepare_pointcloud(radar_csv))

    # -- main entry ----------------------------------------------------------
    def detect(self, pil_image, radar_npz: Optional[str] = None,
               radar_csv: Optional[str] = None) -> Dict:
        """5-task inference on one PIL image, in the frame's pixels
        (reference detect_image, achelous.py:182-449): boxes (y1, x1, y2,
        x2), scores, classes, the semantic, drivable and waterline masks,
        and each point's class."""
        cfg = self.cfg
        iw, ih = pil_image.size
        dets, sem_prob, lane_prob, pc, _ = self.infer(
            *self.prepare(pil_image, radar_npz, radar_csv))
        valid = dets.valid[0].cpu().numpy()
        boxes_n = dets.boxes[0].cpu().numpy()[valid]
        scores = (dets.obj_conf[0] * dets.cls_conf[0]).cpu().numpy()[valid]
        classes = dets.cls_idx[0].cpu().numpy()[valid]
        boxes = yolo_correct_boxes(boxes_n, (cfg.resolution, cfg.resolution),
                                   (ih, iw), True) if len(boxes_n) else \
            np.zeros((0, 4), np.float32)
        sem_cls = self._unletterbox_mask(sem_prob[0], (ih, iw)).argmax(-1)
        lane_cls = self._unletterbox_mask(lane_prob[0], (ih, iw)).argmax(-1)
        sem_cls = sem_cls.cpu().numpy()
        # drivable-area extraction keeps class 8 only (achelous.py:297)
        drivable = np.where(sem_cls == DRIVABLE_CLASS, sem_cls, 0)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "semantic": sem_cls, "drivable": drivable,
                "waterline": lane_cls.cpu().numpy(),
                "pc_pred": pc[0].argmax(-1).cpu().numpy()}

    def _unletterbox_mask(self, prob: torch.Tensor, image_hw) -> torch.Tensor:
        """Probabilities [C, R, R] -> [H, W, C] on the frame: the gray bars
        cropped, the rest resized bilinearly (achelous.py:283-318)."""
        r = self.cfg.resolution
        ih, iw = image_hw
        scale = min(r / ih, r / iw)
        nh, nw = int(ih * scale), int(iw * scale)
        top, left = (r - nh) // 2, (r - nw) // 2
        crop = prob[:, top:top + nh, left:left + nw]
        return resize_bilinear(crop[None], (ih, iw),
                               align_corners=False)[0].permute(1, 2, 0)

    def detect_heatmap(self, pil_image, radar_npz=None, radar_csv=None
                       ) -> np.ndarray:
        """Per-level max(sigmoid(cls)) * sigmoid(obj) score maps,
        max-composited at input resolution [R, R] (reference
        detect_heatmap, achelous.py:451-555)."""
        *_, det = self.infer(*self.prepare(pil_image, radar_npz, radar_csv))
        with torch.inference_mode():
            return heatmap_composite(det, self.cfg.resolution).cpu().numpy()


def heatmap_composite(maps, resolution: int) -> torch.Tensor:
    """Head maps [1, 5+K, h, w] per level -> the max over levels of each
    level's score map, resized bilinearly to [R, R]."""
    r = resolution
    composite = torch.zeros((r, r), device=maps[0].device)
    for m in maps:
        m = m.float()
        score = torch.sigmoid(m[0, 5:]).amax(0) * torch.sigmoid(m[0, 4])
        up = resize_bilinear(score[None, None], (r, r), align_corners=False)
        composite = torch.maximum(composite, up[0, 0])
    return composite


def yolo_correct_boxes(boxes: np.ndarray, input_shape, image_shape,
                       letterbox_image: bool = True) -> np.ndarray:
    """Normalised xyxy boxes -> (y1, x1, y2, x2) in the original image's
    pixels, the letterbox undone (reference utils/utils_bbox.py:5-30; a
    copy of the JAX package's numpy version)."""
    boxes = np.asarray(boxes, dtype=np.float32)
    box_xy = (boxes[..., 0:2] + boxes[..., 2:4]) / 2
    box_wh = boxes[..., 2:4] - boxes[..., 0:2]
    box_yx = box_xy[..., ::-1]
    box_hw = box_wh[..., ::-1]
    input_shape = np.array(input_shape, dtype=np.float32)
    image_shape = np.array(image_shape, dtype=np.float32)
    if letterbox_image:
        new_shape = np.round(image_shape * np.min(input_shape / image_shape))
        off = (input_shape - new_shape) / 2.0 / input_shape
        scale = input_shape / new_shape
        box_yx = (box_yx - off) * scale
        box_hw = box_hw * scale
    mins = box_yx - box_hw / 2.0
    maxs = box_yx + box_hw / 2.0
    out = np.concatenate([mins, maxs], axis=-1)
    out *= np.concatenate([image_shape, image_shape], axis=-1)
    return out


def example_request(cfg: AchelousConfig, device) -> tuple:
    """Zero inputs of a batch-1 request, the shapes an export is traced
    at."""
    r = cfg.resolution
    kw = dict(dtype=cfg.dtype, device=device)
    return (torch.zeros(1, cfg.image_channels, r, r, **kw),
            torch.zeros(1, cfg.radar_channels, r, r, **kw),
            torch.zeros(1, cfg.pc_points, cfg.pc_channels, **kw))


def export_program(predictor: AchelousPredictor, path: str) -> str:
    """`torch.export` of the predictor's request function at batch 1, saved
    to `path` (replaces the reference's ONNX export, achelous.py:557-593).
    `load_program(path)` runs it."""
    with torch.no_grad():
        program = torch.export.export(
            predictor.request, example_request(predictor.cfg,
                                               predictor.device),
            strict=False)
    torch.export.save(program, path)
    return path


def load_program(path: str):
    """The exported request function: a callable of (image, radar,
    points) returning `Request`'s flat outputs (`unpack` regroups them).
    Its kernel nodes launch the port's kernels, whose operators this
    module's imports registered."""
    return torch.export.load(path).module()


def kernel_nodes(path_or_program) -> dict[str, int]:
    """The `achelous::` operator nodes of an exported program's graph, by
    name."""
    program = path_or_program
    if isinstance(program, str):
        program = torch.export.load(program)
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("achelous."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts

