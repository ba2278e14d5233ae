"""YOLOX detection loss with SimOTA dynamic-k assignment (counterpart of
achelous_tpu/losses/detection.py).

The JAX package vectorises the reference's per-image, per-GT loops with
static shapes, and this port keeps its exact semantics, over a batch
dimension written out where JAX `vmap`s:

  * GTs are padded to `max_gt` with a validity mask;
  * the candidate pool is a cost mask (BIG_COST) instead of a compaction;
  * each GT's variable k is a fixed top-10 with a rank mask;
  * an anchor claimed by several GTs keeps the lowest-cost one.

Ties break at the lowest index, as `jax.lax.top_k`, `argmin` and `argmax`
do: the top-k is a stable sort (`torch.topk` promises no order on ties,
and equal costs are common early in training), and `torch.argmin` /
`torch.argmax` return the first extremum.  The assignment runs without
gradient (JAX's `stop_gradient`).  The loss takes the head's NCHW maps.
Under `parallel.dist.batch_group` the assignment stays per image and the
loss's sums and the foreground count are the global batch's.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from achelous_tpu_torch.parallel.dist import all_reduce_sum, current_group

BIG_COST = 1e9  # excludes non-candidate anchors / padded GTs from the top-k
TOPK = 10       # dynamic k = clamp(int(sum of the top-10 IoUs), 1) <= 10


def _bce_with_logits(logits, targets):
    """Elementwise binary cross-entropy on logits, in the JAX package's
    form, with JAX's derivatives at logit 0: jnp.maximum's splits the
    gradient (as torch.maximum's does) and jnp.abs's is 1 there (torch's
    is 0), which identical logits reach."""
    nonneg = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-nonneg)))


def _bce_probs(p, targets, eps=1e-12):
    """torch F.binary_cross_entropy on probabilities (logs clamped at
    -100), with the JAX package's eps."""
    logp = torch.log(p + eps).clamp_min(-100.0)
    log1mp = torch.log(1.0 - p + eps).clamp_min(-100.0)
    return -(targets * logp + (1.0 - targets) * log1mp)


def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between [..., G, 4] and [..., A, 4] cxcywh boxes -> [..., G, A]."""
    a_, b_ = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a_[..., :2] - a_[..., 2:] / 2,
                       b_[..., :2] - b_[..., 2:] / 2)
    br = torch.minimum(a_[..., :2] + a_[..., 2:] / 2,
                       b_[..., :2] + b_[..., 2:] / 2)
    area_a = a[..., 2:].prod(-1)
    area_b = b[..., 2:].prod(-1)
    en = (tl < br).all(-1).to(a.dtype)
    area_i = (br - tl).prod(-1) * en
    return area_i / (area_a[..., :, None] + area_b[..., None, :] - area_i
                     + 1e-16)


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - GIoU of cxcywh boxes, per row of [N, 4]."""
    p_tl, p_br = pred[:, :2] - pred[:, 2:] / 2, pred[:, :2] + pred[:, 2:] / 2
    t_tl = target[:, :2] - target[:, 2:] / 2
    t_br = target[:, :2] + target[:, 2:] / 2
    tl, br = torch.maximum(p_tl, t_tl), torch.minimum(p_br, t_br)
    area_p = pred[:, 2:].prod(1)
    area_g = target[:, 2:].prod(1)
    en = (tl < br).all(-1).to(pred.dtype)
    area_i = (br - tl).prod(1) * en
    area_u = area_p + area_g - area_i
    iou = area_i / (area_u + 1e-16)
    c_tl, c_br = torch.minimum(p_tl, t_tl), torch.maximum(p_br, t_br)
    area_c = (c_br - c_tl).prod(1).clamp_min(1e-16)
    giou = iou - (area_c - area_u) / area_c
    one = torch.ones_like(giou)
    # jnp.clip: its gradient splits at the bounds (torch's clamp passes it)
    return 1.0 - torch.minimum(torch.maximum(giou, -one), one)


@functools.lru_cache(maxsize=None)
def _anchor_geometry(hw: tuple, strides: tuple):
    """Static (x_shifts, y_shifts, stride) per anchor, level-major."""
    xs, ys, ss = [], [], []
    for (h, w), s in zip(hw, strides):
        yv, xv = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xs.append(xv.reshape(-1))
        ys.append(yv.reshape(-1))
        ss.append(np.full(h * w, s))
    return (np.concatenate(xs).astype(np.float32),
            np.concatenate(ys).astype(np.float32),
            np.concatenate(ss).astype(np.float32))


def _lowest_index_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in index order (jax.lax.top_k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def simota_assign(decoded_boxes, obj_logits, cls_logits, gt_boxes, gt_classes,
                  gt_mask, x_c, y_c, strides, num_classes: int,
                  center_radius: float = 2.5):
    """SimOTA assignment of a batch.

    decoded_boxes [B,A,4] cxcywh pixels; obj_logits [B,A]; cls_logits
    [B,A,K]; gt_boxes [B,G,4] cxcywh pixels (padded), gt_classes [B,G],
    gt_mask [B,G] bool; x_c, y_c, strides [A] anchor centres and strides.
    Returns fg_mask [B,A] bool, matched_gt [B,A] int64, pred_ious [B,A],
    num_fg [B]."""
    a = decoded_boxes.shape[1]
    g = gt_boxes.shape[1]
    gt_mask = gt_mask.bool()

    # in-box / in-centre priors
    cx, cy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]          # [B,G,1]
    hw, hh = 0.5 * gt_boxes[..., 2:3], 0.5 * gt_boxes[..., 3:4]
    in_box = ((x_c > cx - hw) & (x_c < cx + hw) &
              (y_c > cy - hh) & (y_c < cy + hh))             # [B,G,A]
    r = center_radius * strides
    in_center = ((x_c > cx - r) & (x_c < cx + r) &
                 (y_c > cy - r) & (y_c < cy + r))
    in_box = in_box & gt_mask[..., None]
    in_center = in_center & gt_mask[..., None]
    fg_cand = in_box.any(1) | in_center.any(1)               # [B,A]
    in_both = in_box & in_center

    # pairwise cost
    ious = pairwise_iou_cxcywh(gt_boxes, decoded_boxes)      # [B,G,A]
    iou_cost = -torch.log(ious + 1e-8)
    probs = (torch.sigmoid(cls_logits.float())
             * torch.sigmoid(obj_logits.float())[..., None])  # [B,A,K]
    gt_onehot = F.one_hot(gt_classes.long(), num_classes).float()
    cls_cost = _bce_probs(torch.sqrt(probs)[:, None],
                          gt_onehot[:, :, None]).sum(-1)      # [B,G,A]
    cost = cls_cost + 3.0 * iou_cost + 100000.0 * (~in_both)
    invalid = (~fg_cand[:, None, :]) | (~gt_mask[..., None])
    cost = torch.where(invalid, torch.full_like(cost, BIG_COST), cost)
    ious_m = torch.where(invalid, torch.zeros_like(ious), ious)

    # dynamic k: each GT takes its dynamic_k lowest-cost anchors
    k = min(TOPK, a)
    topk_ious = _lowest_index_topk(ious_m, k)[0]
    dynamic_ks = topk_ious.sum(-1).to(torch.int32).clamp_min(1)
    neg_cost_top, top_idx = _lowest_index_topk(-cost, k)      # [B,G,k]
    rank = torch.arange(k, device=cost.device)
    take = (rank < dynamic_ks[..., None]) & gt_mask[..., None]
    take = take & (-neg_cost_top < BIG_COST)
    matching = torch.zeros_like(cost).scatter_reduce(
        -1, top_idx, take.float(), "amax")

    # an anchor claimed by several GTs keeps the lowest-cost one
    claimed = matching.sum(1, keepdim=True)                  # [B,1,A]
    best_gt = cost.argmin(1)                                 # [B,A]
    keep = F.one_hot(best_gt, g).transpose(1, 2).to(matching.dtype)
    matching = torch.where(claimed > 1, matching * keep, matching)

    fg_mask = matching.sum(1) > 0.0
    matched_gt = matching.argmax(1)
    pred_ious = (matching * ious_m).sum(1)
    num_fg = fg_mask.float().sum(-1)
    return fg_mask, matched_gt, pred_ious, num_fg


class YoloXLoss:
    """Batched YOLOX loss: (5 * IoU loss + objectness BCE + class BCE) over
    the foreground anchors, divided by the batch's total foreground count
    (at least 1)."""

    def __init__(self, num_classes: int, strides: Sequence[int] = (8, 16, 32)):
        self.num_classes = num_classes
        self.strides = tuple(strides)

    def __call__(self, det_maps: Sequence[torch.Tensor],
                 gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                 gt_mask: torch.Tensor) -> torch.Tensor:
        """det_maps: 3x [B, 5+K, H, W] raw head outputs; gt_boxes [B,G,4]
        cxcywh pixels; gt_classes [B,G]; gt_mask [B,G]."""
        hw = tuple((m.shape[2], m.shape[3]) for m in det_maps)
        b, ch = det_maps[0].shape[:2]
        flat = torch.cat([m.reshape(b, ch, -1).transpose(1, 2)
                          for m in det_maps], 1).float()      # [B,A,5+K]
        dev = flat.device
        x_np, y_np, s_np = _anchor_geometry(hw, self.strides)
        xs, ys, s = (torch.from_numpy(v).to(dev) for v in (x_np, y_np, s_np))
        x_c, y_c = (xs + 0.5) * s, (ys + 0.5) * s

        # train-path decode: pixel scale, logits left raw for the BCE terms;
        # wh logits clamped so a divergence cannot emit inf boxes
        xy = (flat[..., :2] + torch.stack([xs, ys], -1)) * s[:, None]
        wh = torch.exp(flat[..., 2:4].clamp_max(20.0)) * s[:, None]
        boxes = torch.cat([xy, wh], -1)                      # [B,A,4]
        obj_logits = flat[..., 4]
        cls_logits = flat[..., 5:]

        gt_boxes = gt_boxes.float()
        fg, mgt, pious, nfg = simota_assign(
            boxes.detach(), obj_logits.detach(), cls_logits.detach(),
            gt_boxes, gt_classes, gt_mask, x_c, y_c, s, self.num_classes)

        nfg = nfg.sum()
        group = current_group()
        fg_f = fg.float()
        reg_t = torch.gather(gt_boxes, 1, mgt[..., None].expand(-1, -1, 4))
        cls_t = (F.one_hot(torch.gather(gt_classes.long(), 1, mgt),
                           self.num_classes).float() * pious[..., None])

        loss_iou = (giou_loss(boxes.reshape(-1, 4), reg_t.reshape(-1, 4))
                    * fg_f.reshape(-1)).sum()
        loss_obj = _bce_with_logits(obj_logits[..., None],
                                    fg_f[..., None]).sum()
        loss_cls = (_bce_with_logits(cls_logits, cls_t).sum(-1) * fg_f).sum()
        loss = 5.0 * loss_iou + loss_obj + loss_cls
        if group is not None:
            # the sums and the foreground count over the global batch
            loss, nfg = all_reduce_sum(torch.stack([loss, nfg]), group)
        return loss / nfg.clamp_min(1.0)
