"""Learning-rate schedules and the batch-size lr scaling rule (this port's
copy of achelous_tpu/train/schedule.py, which is numpy-free Python).

Reference loss/detection_loss.py:488-520 (YOLOX warm-cos with quadratic
warm-up and a min-lr tail; step decay) and train.py:489-494 (lr * bs/64
clamped to the optimizer's limits).  Schedules are functions of the
EPOCH, as the reference's set_optimizer_lr(epoch).
"""
from __future__ import annotations

import math
from typing import Callable


def yolox_warm_cos_lr(lr: float, min_lr: float, total_epochs: int,
                      warmup_ratio: float = 0.05,
                      warmup_lr_ratio: float = 0.1,
                      no_aug_ratio: float = 0.05) -> Callable[[int], float]:
    """The reference's get_lr_scheduler defaults (warm-up 5 % of the
    epochs, at most 3, from 10 % of lr; a min-lr tail over the last 5 %,
    at most 15)."""
    warmup_total = min(max(warmup_ratio * total_epochs, 1), 3)
    warmup_lr_start = max(warmup_lr_ratio * lr, 1e-6)
    no_aug = min(max(no_aug_ratio * total_epochs, 1), 15)

    def f(epoch: int) -> float:
        if epoch <= warmup_total:
            return ((lr - warmup_lr_start) *
                    (epoch / float(warmup_total)) ** 2 + warmup_lr_start)
        if epoch >= total_epochs - no_aug:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
            math.pi * (epoch - warmup_total)
            / (total_epochs - warmup_total - no_aug)))

    return f


def step_lr(lr: float, min_lr: float, total_epochs: int,
            step_num: int = 10) -> Callable[[int], float]:
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_epochs / step_num

    def f(epoch: int) -> float:
        return lr * decay_rate ** (epoch // step_size)

    return f


def get_lr_scheduler(decay_type: str, lr: float, min_lr: float,
                     total_epochs: int) -> Callable[[int], float]:
    if decay_type == "cos":
        return yolox_warm_cos_lr(lr, min_lr, total_epochs)
    return step_lr(lr, min_lr, total_epochs)


def scale_lr(init_lr: float, batch_size: int, optimizer: str = "sgd",
             nbs: int = 64) -> tuple[float, float]:
    """(init_lr_fit, min_lr_fit) of reference train.py:489-494."""
    lr_max = 1e-3 if optimizer == "adam" else 5e-2
    lr_min = 3e-4 if optimizer == "adam" else 5e-4
    min_lr = init_lr * 0.01
    init_fit = min(max(batch_size / nbs * init_lr, lr_min), lr_max)
    min_fit = min(max(batch_size / nbs * min_lr, lr_min * 1e-2), lr_max * 1e-2)
    return init_fit, min_fit
