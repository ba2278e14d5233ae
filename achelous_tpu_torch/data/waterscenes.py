"""WaterScenes-format data pipeline, host side (counterpart of
achelous_tpu/data/waterscenes.py; reference utils/dataloader.py:87-233,
utils/utils.py:44-54, utils_seg_line/utils.py:7-12).

  * annotation txt lines: "<image_path> x1,y1,x2,y2,cls ..." per sample
  * letterbox resize (bicubic, gray 128 bars) + ImageNet normalisation
    (data/native.py)
  * boxes -> cxcywh in input-pixel coordinates, sub-pixel boxes dropped
  * semantic png: labels >= num_seg clipped to num_seg (ignore), one-hot
  * waterline png (black when missing), clipped to 2 classes
  * radar map: the reference's .npz when present, otherwise the raw radar
    points of the CSV, splatted on the device (ops/radar_splat.py,
    `train.loop.device_batch`)
  * point cloud: 512-point resample with replacement + per-column L2
    normalisation (sklearn normalize(axis=0), dataloader.py:137-141)

Samples and `collate`'s batches are numpy in the JAX package's layout
(image, radar map [H, W, 3] channels-last), array for array equal to its
own; `train.loop.device_batch` moves a batch to the device and makes the
image and radar channels-first.  Pillow decodes the images and masks and is
imported where it is used.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data import native

PC_FEATURES = ["x", "y", "z", "comp_velocity", "rcs"]   # achelous.py:92
SPLAT_FEATURES = ["range", "doppler", "rcs", "u", "v"]  # notebook cell 4


def preprocess_image(img: np.ndarray) -> np.ndarray:
    """/255 + ImageNet mean/std (reference utils/utils.py:44-48)."""
    x = img.astype(np.float32) / 255.0
    return (x - native.IMAGENET_MEAN) / native.IMAGENET_STD


def letterbox(image, input_shape, fill=(128, 128, 128), resample=None):
    """Aspect-preserving Pillow resize (bicubic unless `resample`) with
    gray bars: (new image, scale, (dx, dy)), as the reference's
    utils/dataloader.py:184-197 and the JAX package's predictor do it."""
    from PIL import Image
    iw, ih = image.size
    h, w = input_shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    # Image.NEAREST is 0: `resample or BICUBIC` would resample masks bicubic
    resized = image.resize((nw, nh),
                           Image.BICUBIC if resample is None else resample)
    canvas = Image.new(image.mode if image.mode != "1" else "L",
                       (w, h), fill if image.mode == "RGB" else 0)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    canvas.paste(resized, (dx, dy))
    return canvas, scale, (dx, dy)


def load_radar_csv(path: str, columns: Sequence[str]) -> np.ndarray:
    """The named columns of a radar CSV as float32 [N, len(columns)]; no
    rows where the header lacks one of them."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    if not all(c in header for c in columns):
        return np.zeros((0, len(columns)), np.float32)
    return native.parse_radar_csv(path, [header.index(c) for c in columns])


def resample_pointcloud(feats: np.ndarray, labels: Optional[np.ndarray],
                        n_points: int, rng: np.random.RandomState):
    """Resample with replacement to n_points + per-column L2 normalise
    (reference dataloader.py:137-141)."""
    if len(feats) == 0:
        out = np.zeros((n_points, feats.shape[1]), np.float32)
        lab = np.zeros((n_points,), np.int32)
        return out, lab
    idx = rng.choice(feats.shape[0], n_points, replace=True)
    f = feats[idx]
    norms = np.linalg.norm(f, axis=0, keepdims=True)
    f = f / np.maximum(norms, 1e-12)
    lab = labels[idx].astype(np.int32).reshape(-1) if labels is not None else \
        np.zeros((n_points,), np.int32)
    return f.astype(np.float32), lab


@dataclass
class WaterScenesPaths:
    """Directory layout of a WaterScenes-format dataset
    (reference train.py:219-270 path wiring)."""
    annotation_file: str          # txt: "<img_path> x1,y1,x2,y2,cls ..."
    semantic_dir: str             # <name>.png semantic masks
    waterline_dir: str            # <name>.png waterline masks (may be missing)
    radar_map_dir: str = ""       # <name>.npz pre-rasterized maps (optional)
    radar_csv_dir: str = ""       # <name>.csv raw radar points
    pc_label_column: str = "label"

    @classmethod
    def under(cls, root: str, annotation: str = "train.txt"):
        """The layout `train.cli` reads under a dataset root: the
        annotation file and semantic/, waterline/, radar_map/, radar/."""
        return cls(annotation_file=os.path.join(root, annotation),
                   semantic_dir=os.path.join(root, "semantic"),
                   waterline_dir=os.path.join(root, "waterline"),
                   radar_map_dir=os.path.join(root, "radar_map"),
                   radar_csv_dir=os.path.join(root, "radar"))


class WaterScenesDataset:
    """Host-side sample loader; batches assemble with `collate`.  Its own
    `np.random.RandomState(seed)` draws the point resampling, the
    augmentation and the mosaic, in the JAX package's order."""

    def __init__(self, cfg: AchelousConfig, paths: WaterScenesPaths,
                 max_gt: int = 50, seed: int = 0, augment=None):
        self.cfg = cfg
        self.paths = paths
        self.max_gt = max_gt
        self.rng = np.random.RandomState(seed)
        self.augment = augment        # data.augment.AugmentConfig or None
        with open(paths.annotation_file, encoding="utf-8") as f:
            self.lines = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.lines)

    def _name(self, line: str) -> str:
        return os.path.splitext(line.split()[0].split("/")[-1])[0]

    def __getitem__(self, index: int) -> dict:
        sample = self._load_one(index)
        a = self.augment
        if (a is not None and getattr(a, "mosaic_prob", 0.0) > 0.0
                and self.rng.rand() < a.mosaic_prob):
            from achelous_tpu_torch.data.augment import mosaic_samples
            others = [self._load_one(self.rng.randint(len(self.lines)))
                      for _ in range(3)]
            sample = mosaic_samples([sample] + others, self.cfg.resolution,
                                    self.rng, a.mosaic_center)
        return sample

    def _mask(self, d: str, name: str, size, clip_max: int) -> np.ndarray:
        """A label png letterboxed (black where the file is missing)."""
        from PIL import Image
        p = os.path.join(d, name + ".png")
        m = Image.open(p).convert("L") if os.path.exists(p) else \
            Image.new("L", size, 0)
        return native.letterbox_mask(np.asarray(m), self.cfg.resolution,
                                     clip_max)

    def _load_one(self, index: int) -> dict:
        from PIL import Image
        cfg = self.cfg
        r = cfg.resolution
        line = self.lines[index % len(self.lines)]
        parts = line.split()
        name = self._name(line)

        image = Image.open(parts[0])
        if image.mode != "RGB":
            image = image.convert("RGB")
        if self.augment is not None:
            from achelous_tpu_torch.data.augment import hsv_jitter
            image = Image.fromarray(hsv_jitter(
                np.asarray(image), self.rng, self.augment.hue,
                self.augment.sat, self.augment.val))
        iw, ih = image.size
        scale = min(r / iw, r / ih)
        dx, dy = (r - int(iw * scale)) // 2, (r - int(ih * scale)) // 2
        img = native.letterbox_image(np.asarray(image), r)

        # boxes: xyxy pixel -> letterboxed -> cxcywh (dataloader.py:218-231,
        # 109-110)
        boxes = np.array([list(map(int, b.split(","))) for b in parts[1:]],
                         np.float32).reshape(-1, 5)
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * (int(iw * scale) / iw) + dx
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * (int(ih * scale) / ih) + dy
            boxes[:, 0:2] = np.clip(boxes[:, 0:2], 0, None)
            boxes[:, 2] = np.minimum(boxes[:, 2], r)
            boxes[:, 3] = np.minimum(boxes[:, 3], r)
            keep = ((boxes[:, 2] - boxes[:, 0] > 1) &
                    (boxes[:, 3] - boxes[:, 1] > 1))
            boxes = boxes[keep]
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            boxes[:, 0:2] = boxes[:, 0:2] + wh / 2
            boxes[:, 2:4] = wh

        seg = self._mask(self.paths.semantic_dir, name, (iw, ih), cfg.num_seg)
        wl = self._mask(self.paths.waterline_dir, name, (iw, ih), 2)

        # radar map: npz if present, else raw points for the device splat
        radar_map = None
        radar_points = np.zeros((cfg.pc_points, 5), np.float32)
        radar_points_valid = np.zeros((cfg.pc_points,), bool)
        npz = os.path.join(self.paths.radar_map_dir or "", name + ".npz")
        if self.paths.radar_map_dir and os.path.exists(npz):
            radar_map = np.load(npz)["arr_0"].astype(np.float32)
            radar_map = np.transpose(radar_map, (1, 2, 0))   # CHW -> HWC
        elif self.paths.radar_csv_dir:
            pts = load_radar_csv(os.path.join(self.paths.radar_csv_dir,
                                              name + ".csv"), SPLAT_FEATURES)
            n = min(len(pts), cfg.pc_points)
            radar_points[:n] = pts[:n]
            radar_points_valid[:n] = True

        # point cloud branch features + labels
        pc = np.zeros((cfg.pc_points, cfg.pc_channels), np.float32)
        pc_labels = np.zeros((cfg.pc_points,), np.int32)
        if self.paths.radar_csv_dir:
            p = os.path.join(self.paths.radar_csv_dir, name + ".csv")
            if os.path.exists(p):
                feats = load_radar_csv(p, PC_FEATURES)
                labs = load_radar_csv(p, [self.paths.pc_label_column])
                pc, pc_labels = resample_pointcloud(
                    feats, labs, cfg.pc_points, self.rng)

        sample = {"image": img, "seg": seg, "wl": wl, "boxes": boxes,
                  "radar_map": radar_map, "radar_points": radar_points,
                  "radar_points_valid": radar_points_valid,
                  "pc": pc, "pc_labels": pc_labels, "name": name}
        if self.augment is not None:
            from achelous_tpu_torch.data.augment import augment_sample
            sample = augment_sample(sample, r, self.augment, self.rng)
        return sample

    def original_masks(self, index: int):
        """The seg and waterline label maps at the image's own resolution,
        labels clipped to the ignore index, as the reference's eval reads
        the raw label pngs (utils_seg/callbacks.py:169-186)."""
        from PIL import Image
        line = self.lines[index % len(self.lines)]
        name = self._name(line)
        with Image.open(line.split()[0]) as im:
            iw, ih = im.size

        def load(d, clip_max):
            p = os.path.join(d, name + ".png")
            if os.path.exists(p):
                m = Image.open(p).convert("L")
            else:
                m = Image.new("L", (iw, ih), 0)
            arr = np.asarray(m).astype(np.int32).copy()
            arr[arr >= clip_max] = clip_max
            return arr

        return (load(self.paths.semantic_dir, self.cfg.num_seg),
                load(self.paths.waterline_dir, 2))


def collate(samples: List[dict], cfg: AchelousConfig, max_gt: int = 50) -> dict:
    """The static-shape batch, numpy, channels-last (`make_train_step`'s
    keys; `train.loop.device_batch` makes it the step's layout).  Samples
    without a pre-rasterized radar map give `radar_points` [B,N,5] and
    `radar_points_valid` [B,N] instead of `radar`."""
    b = len(samples)
    batch = {
        "image": np.stack([s["image"] for s in samples]).astype(np.float32),
        "pc": np.stack([s["pc"] for s in samples]),
        "pc_labels": np.stack([s["pc_labels"] for s in samples]),
        "seg_labels": np.stack([s["seg"] for s in samples]),
        "wl_labels": np.stack([s["wl"] for s in samples]),
    }
    batch["seg_onehot"] = np.eye(cfg.num_seg + 1, dtype=np.float32)[
        batch["seg_labels"]]
    batch["wl_onehot"] = np.eye(3, dtype=np.float32)[batch["wl_labels"]]

    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_classes = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        n = min(len(s["boxes"]), max_gt)
        if n:
            gt_boxes[i, :n] = s["boxes"][:n, :4]
            gt_classes[i, :n] = s["boxes"][:n, 4]
            gt_mask[i, :n] = True
    batch.update(gt_boxes=gt_boxes, gt_classes=gt_classes, gt_mask=gt_mask)

    if samples[0]["radar_map"] is not None:
        batch["radar"] = np.stack([s["radar_map"] for s in samples])
    else:
        batch["radar_points"] = np.stack([s["radar_points"] for s in samples])
        batch["radar_points_valid"] = np.stack(
            [s["radar_points_valid"] for s in samples])
    return batch
