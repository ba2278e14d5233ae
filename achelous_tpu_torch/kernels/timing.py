"""Device time of a call on the card, between CUDA events."""
from __future__ import annotations

import numpy as np
import torch


def cuda_ms(fn, iters: int = 100, warmup: int = 10,
            hold_device: bool = False) -> float:
    """ms per call of `fn` between CUDA events, after warm-up.  By default
    the events see calls as the host issues them, launch overhead
    included.  With `hold_device` a sleep kernel first holds the GPU while
    the host queues every call, so the events bracket back-to-back device
    work: the device time of one call.  Then `iters` times the launches of
    one call must stay under the ~1000 launches the CUDA runtime queues; past
    that the host blocks and its own pace leaks into the reading."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold_device:
        torch.cuda._sleep(200_000_000)      # ~0.1 s of GPU cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 5) -> float:
    """Median device time of one call over 5 readings of `iters` queued
    calls (the plain versions launch ~100 kernels a call; plain FPS
    ~10 a step, so it is read one call at a time)."""
    return float(np.median([cuda_ms(fn, iters=iters, warmup=2,
                                    hold_device=True) for _ in range(5)]))
