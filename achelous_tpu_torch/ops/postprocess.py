"""Detection decode + class-aware NMS (counterpart of
achelous_tpu/ops/postprocess.py), with the JAX semantics kept exactly:

  decode: per level (xy + grid) * stride, exp(min(wh, 20)) * stride,
          sigmoid(obj/cls), normalised to [0, 1]; anchors level-major and
          row-major over (y, x), as the JAX package's NHWC flatten orders
          them
  nms:    per image, score = obj * max-class conf >= conf_thres, non-finite
          boxes dropped, the top `pre_nms_topk` candidates by score (stable:
          ties keep the lower anchor first), boxes clipped to +-1e4, then
          greedy suppression expressed as a fixpoint over a strict-rank,
          same-class pair mask (IoU > thresh), and a stable compaction of
          the kept candidates into `max_det` slots.

The JAX package's `nms_single` is the per-image body that it vmaps; here
`non_max_suppression` writes the batch dimension out instead.  None of
this was a Pallas kernel in JAX; it stays plain PyTorch.

The suppression fixpoint ends early once an iteration changes nothing.
Eagerly that is a Python `if` on the data; under `torch.export`, which
cannot trace a branch on data, the same condition drives a `while_loop`
operator, so an exported program iterates exactly as often.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

_BOX_CAP = 1e4


def make_grids(hw: Sequence[Tuple[int, int]], input_h: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """Static anchor grid (x, y) and per-anchor stride, level-major
    row-major."""
    grids, strides = [], []
    for h, w in hw:
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grids.append(np.stack([xs, ys], axis=-1).reshape(-1, 2))
        strides.append(np.full((h * w, 1), input_h / h))
    return (np.concatenate(grids, 0).astype(np.float32),
            np.concatenate(strides, 0).astype(np.float32))


def decode_outputs(outputs: Sequence[torch.Tensor],
                   input_shape: Tuple[int, int]) -> torch.Tensor:
    """Head maps [B, 5+K, H, W] per level -> [B, A, 5+K] normalised
    (cx, cy, w, h, obj, cls...)."""
    hw = [(o.shape[2], o.shape[3]) for o in outputs]
    b, ch = outputs[0].shape[:2]
    flat = torch.cat([o.permute(0, 2, 3, 1).reshape(b, -1, ch)
                      for o in outputs], dim=1)
    grids, strides = make_grids(hw, float(input_shape[0]))
    kw = dict(dtype=flat.dtype, device=flat.device)
    grids = torch.as_tensor(grids, **kw)
    strides = torch.as_tensor(strides, **kw)
    xy = (flat[..., :2] + grids) * strides
    wh = torch.exp(torch.clamp(flat[..., 2:4], max=20.0)) * strides
    scores = torch.sigmoid(flat[..., 4:])
    norm = torch.tensor([input_shape[1], input_shape[0], input_shape[1],
                         input_shape[0]], **kw)
    boxes = torch.cat([xy, wh], dim=-1) / norm
    return torch.cat([boxes, scores], dim=-1)


class Detections(NamedTuple):
    """Static-shape padded detections."""
    boxes: torch.Tensor      # [B, max_det, 4] x1, y1, x2, y2 (normalised)
    obj_conf: torch.Tensor   # [B, max_det]
    cls_conf: torch.Tensor   # [B, max_det]
    cls_idx: torch.Tensor    # [B, max_det] int32
    valid: torch.Tensor      # [B, max_det] bool


def _pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """IoU of [B, P, 4] xyxy boxes -> [B, P, P]."""
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-16)


def _suppress(overlap: torch.Tensor, live: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """K_{n+1} = {i live : no j in K_n suppresses i}."""
    return live & ~(overlap & keep[:, None, :]).any(dim=2)


def _fixpoint(overlap: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    keep = live
    for _ in range(live.shape[1]):
        new_keep = _suppress(overlap, live, keep)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _fixpoint_exported(overlap: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """`_fixpoint` as a traceable loop: iterate while the last step
    changed `keep` (the fixpoint is reached within the longest suppression
    chain, at most the candidate count)."""
    from torch._higher_order_ops.while_loop import while_loop

    def changed(keep, moved):
        return moved.clone()            # the operator forbids aliasing

    def step(keep, moved):
        new_keep = _suppress(overlap, live, keep)
        return new_keep, (new_keep != keep).any()

    moved = torch.ones((), dtype=torch.bool, device=live.device)
    return while_loop(changed, step, (live, moved))[0]


def non_max_suppression(decoded: torch.Tensor, num_classes: int,
                        conf_thres: float = 0.5, nms_thres: float = 0.4,
                        max_det: int = 100,
                        pre_nms_topk: int = 512) -> Detections:
    """Class-aware greedy NMS over [B, A, 5+K] decoded predictions."""
    decoded = decoded.float()
    b, a = decoded.shape[:2]
    cxcy, wh = decoded[..., :2], decoded[..., 2:4]
    boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1)
    obj = decoded[..., 4]
    cls_conf, cls_idx = decoded[..., 5:5 + num_classes].max(dim=-1)
    scores = obj * cls_conf
    live = (scores >= conf_thres) & torch.isfinite(boxes).all(dim=-1)

    p = min(pre_nms_topk, a)
    cand_scores, cand = torch.sort(torch.where(live, scores, -1.0), dim=1,
                                   descending=True, stable=True)
    cand_scores, cand = cand_scores[:, :p], cand[:, :p]
    cand_live = cand_scores >= max(conf_thres, 0.0)

    def take(t):
        return torch.gather(t, 1, cand)

    ccls = take(cls_idx)
    cboxes = torch.gather(boxes, 1, cand[..., None].expand(-1, -1, 4))
    cboxes = torch.nan_to_num(cboxes, nan=0.0, posinf=_BOX_CAP,
                              neginf=-_BOX_CAP).clamp(-_BOX_CAP, _BOX_CAP)

    rank = torch.arange(p, device=decoded.device)
    # overlap[i, j]: candidate j (strictly higher rank, same class) can
    # suppress i
    overlap = ((_pairwise_iou(cboxes) > nms_thres)
               & (ccls[:, :, None] == ccls[:, None, :])
               & (rank[None, :] < rank[:, None])
               & cand_live[:, None, :] & cand_live[:, :, None])
    # iterate `_suppress` to its fixpoint: the greedy solution, reached
    # within the longest suppression chain
    keep = (_fixpoint_exported(overlap, cand_live)
            if torch.compiler.is_exporting()
            else _fixpoint(overlap, cand_live))

    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
    order = order[:, :max_det]
    return Detections(
        torch.gather(cboxes, 1, order[..., None].expand(-1, -1, 4)),
        torch.gather(take(obj), 1, order),
        torch.gather(take(cls_conf), 1, order),
        torch.gather(ccls, 1, order).to(torch.int32),
        torch.gather(keep, 1, order))
