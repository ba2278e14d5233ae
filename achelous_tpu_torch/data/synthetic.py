"""Synthetic batches in the training layout (counterpart of
achelous_tpu/data/synthetic.py), for tests and benchmarks without the
WaterScenes dataset.

The same `numpy.random.RandomState(seed)` draws in the same order as the
JAX package, so both packages get identical numbers; the image and the
radar map are returned channels-first, and every array as a tensor on
`device` (the GPU unless the CPU is asked for).
"""
from __future__ import annotations

import numpy as np
import torch

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.models.achelous import _device


def synthetic_arrays(cfg: AchelousConfig, batch_size: int, max_gt: int = 50,
                     seed: int = 0) -> dict:
    """The JAX package's `synthetic_batch` arrays, as numpy, in its layout
    (image and radar [B,R,R,3])."""
    rng = np.random.RandomState(seed)
    r = cfg.resolution
    n_gt = rng.randint(1, min(6, max_gt), size=batch_size)
    gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_gt), np.int32)
    gt_mask = np.zeros((batch_size, max_gt), bool)
    for i, n in enumerate(n_gt):
        gt_boxes[i, :n, 0] = rng.uniform(16, r - 16, n)
        gt_boxes[i, :n, 1] = rng.uniform(16, r - 16, n)
        gt_boxes[i, :n, 2:4] = rng.uniform(8, 64, (n, 2))
        gt_classes[i, :n] = rng.randint(0, cfg.num_det, n)
        gt_mask[i, :n] = True
    seg = rng.randint(0, cfg.num_seg + 1, (batch_size, r, r)).astype(np.int32)
    wl = rng.randint(0, 3, (batch_size, r, r)).astype(np.int32)
    return {
        "image": rng.rand(batch_size, r, r,
                          cfg.image_channels).astype(np.float32),
        "radar": rng.rand(batch_size, r, r,
                          cfg.radar_channels).astype(np.float32),
        "pc": rng.rand(batch_size, cfg.pc_points,
                       cfg.pc_channels).astype(np.float32),
        "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_mask": gt_mask,
        "seg_labels": seg,
        "seg_onehot": np.eye(cfg.num_seg + 1, dtype=np.float32)[seg],
        "wl_labels": wl,
        "wl_onehot": np.eye(3, dtype=np.float32)[wl],
        "pc_labels": rng.randint(0, cfg.pc_classes,
                                 (batch_size, cfg.pc_points)).astype(np.int32),
    }


def to_batch(arrays: dict, device: torch.device | str = torch.device("cuda")
             ) -> dict:
    """numpy arrays in the JAX layout -> tensors on `device`, image and
    radar channels-first."""
    device = _device(device)
    out = {}
    for k, v in arrays.items():
        if k in ("image", "radar"):
            v = v.transpose(0, 3, 1, 2)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def synthetic_batch(cfg: AchelousConfig, batch_size: int, max_gt: int = 50,
                    seed: int = 0,
                    device: torch.device | str = torch.device("cuda")
                    ) -> dict:
    """A training batch of tensors on `device`: image [B,3,R,R], radar
    [B,3,R,R], pc [B,N,C], gt_boxes [B,G,4] (cxcywh pixels), gt_classes
    [B,G], gt_mask [B,G], seg_labels [B,R,R] (ignore = num_seg),
    seg_onehot [B,R,R,num_seg+1], wl_labels [B,R,R], wl_onehot [B,R,R,3],
    pc_labels [B,N]."""
    return to_batch(synthetic_arrays(cfg, batch_size, max_gt, seed), device)
