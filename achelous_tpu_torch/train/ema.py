"""EMA of the parameters and BatchNorm statistics (counterpart of
achelous_tpu/train/ema.py; reference loss/detection_loss.py:433-463).

The decay ramps as d = decay * (1 - exp(-updates / tau)); every float
tensor moves to e * d + (1 - d) * p, other tensors (integer buffers) are
copied.  The EMA tensors are updated in place.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor],
               new: Mapping[str, torch.Tensor], updates: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """One EMA step of every tensor of `ema` towards `new` (same keys);
    `updates` is the post-increment count, d is computed in float32 as
    the JAX package computes it."""
    f32 = np.float32
    d = float(f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(tau))))
    floats = [k for k, e in ema.items() if e.is_floating_point()]
    for k, e in ema.items():
        if not e.is_floating_point():
            e.copy_(new[k])
    if floats:
        es = [ema[k] for k in floats]
        torch._foreach_mul_(es, d)
        torch._foreach_add_(es, [new[k].to(ema[k].dtype) for k in floats],
                            alpha=float(np.float32(1.0) - np.float32(d)))
