"""Segmentation losses on NCHW logits (counterpart of
achelous_tpu/losses/segmentation.py, which takes NHWC).

The integer target [B,H,W] uses `num_classes` as the ignore index; the
one-hot target [B,H,W,num_classes+1] of `dice_loss` carries the ignore
class in its last slot, which is dropped.  Everything is computed in
float32 whatever the logits' dtype.

Under `parallel.dist.batch_group` each loss is the global batch's: every
numerator and denominator (the CE weights, the focal and NLL counts, the
dice tp / fp / fn) is summed over the group before the division, through
the differentiable `all_reduce_sum`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from achelous_tpu_torch.parallel.dist import all_reduce_sum, current_group


def _pixels(logits: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] -> [B*H*W, C] float32, pixels in the JAX package's NHWC
    order."""
    c = logits.shape[1]
    return logits.float().movedim(1, -1).reshape(-1, c)


def _global_sums(*sums: torch.Tensor):
    """The tensors summed over the open batch group (one all-reduce), or
    as they are without one."""
    group = current_group()
    if group is None:
        return sums
    sizes = [t.numel() for t in sums]
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in sums]), group)
    return tuple(t.view_as(s) for t, s in
                 zip(torch.split(flat, sizes), sums))


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every value of `x` over the global batch."""
    if current_group() is None:
        return x.mean()
    total, n = _global_sums(x.sum(), x.new_full((), float(x.numel())))
    return total / n


def _picked_nll(logits, target, cls_weights, num_classes):
    """Per-pixel -log p[target] (0 at ignored pixels, weighted if asked)
    and the keep mask."""
    target = target.reshape(-1).long()
    keep = target != num_classes
    tgt = torch.where(keep, target, torch.zeros_like(target))
    logp = F.log_softmax(_pixels(logits), -1)
    nll = -logp.gather(1, tgt[:, None])[:, 0]
    w = None
    if cls_weights is not None:
        w = torch.as_tensor(cls_weights, dtype=torch.float32,
                            device=nll.device)[tgt]
    return nll, keep, w


def ce_loss(logits: torch.Tensor, target: torch.Tensor,
            cls_weights: Optional[torch.Tensor],
            num_classes: int) -> torch.Tensor:
    """Weighted CE with ignore index `num_classes`: sum(w * nll) / sum(w)
    over the kept pixels (torch's mean with class weights)."""
    nll, keep, w = _picked_nll(logits, target, cls_weights, num_classes)
    w = keep.float() if w is None else w * keep
    num, den = _global_sums((nll * w).sum(), w.sum())
    return num / den.clamp_min(1e-12)


def focal_loss(logits: torch.Tensor, target: torch.Tensor,
               cls_weights: Optional[torch.Tensor], num_classes: int,
               alpha: float = 0.5, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss, the mean over ALL pixels: ignored pixels add 0 but
    count in the denominator."""
    nll, keep, w = _picked_nll(logits, target, cls_weights, num_classes)
    if w is not None:
        nll = nll * w
    logpt = -(nll * keep)
    pt = torch.exp(logpt)
    return _mean(-((1.0 - pt) ** gamma) * (alpha * logpt))


def dice_loss(logits: torch.Tensor, onehot_target: torch.Tensor,
              beta: float = 1.0, smooth: float = 1e-5) -> torch.Tensor:
    """1 - mean dice of the softmax probabilities against the one-hot
    target [B,H,W,C+1], its trailing ignore slot dropped."""
    n, c = logits.shape[:2]
    probs = F.softmax(_pixels(logits).reshape(n, -1, c), -1)
    tgt = onehot_target.reshape(n, -1, onehot_target.shape[-1]).float()
    tgt = tgt[..., :-1]
    tp, p_sum, t_sum = _global_sums((tgt * probs).sum((0, 1)),
                                    probs.sum((0, 1)), tgt.sum((0, 1)))
    fp, fn = p_sum - tp, t_sum - tp
    score = ((1 + beta ** 2) * tp + smooth) / (
        (1 + beta ** 2) * tp + beta ** 2 * fn + fp + smooth)
    return 1.0 - score.mean()


def pc_nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """NLL of per-point log-probabilities [B,N,K] at labels [B,N], taken
    once (the reference applies log_softmax a second time)."""
    picked = log_probs.float().gather(-1, labels[..., None].long())
    return -_mean(picked)
