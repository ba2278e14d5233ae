"""Entry point of the serving path (counterpart of `entry()` in the
repository's __graft_entry__.py).

    fn, (image, radar, points) = entry(device, generator)
    detections, sem, lane, pc = fn(image, radar, points)

EN-GDF-PN-S0 at 320x320, bf16, batch 1: the 5-task forward, then decode +
class-aware NMS.  The radar map is channels-first [1,3,320,320], the image
[1,3,320,320] and the points [1,512,5]; the example inputs are zeros.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.models.achelous import create_model, example_inputs
from achelous_tpu_torch.ops.postprocess import (decode_outputs,
                                                non_max_suppression)

CONF_THRES = 0.35
NMS_THRES = 0.35


def serving_config(dtype: torch.dtype = torch.bfloat16,
                   resolution: int = 320) -> AchelousConfig:
    return AchelousConfig(phi="S0", backbone="en", neck="gdf", pc_model="pn",
                          resolution=resolution, dtype=dtype)


def make_fn(model, cfg: AchelousConfig):
    """The request function: forward, then decode + NMS.  It carries
    its `model` and `cfg` as attributes."""
    r = cfg.resolution

    @torch.inference_mode()
    def fn(image, radar, points):
        det, sem, lane, pc = model(image, radar, points)
        decoded = decode_outputs(det, (r, r))
        dets = non_max_suppression(decoded, cfg.num_det,
                                   conf_thres=CONF_THRES, nms_thres=NMS_THRES)
        return dets, sem, lane, pc

    fn.model, fn.cfg = model, cfg
    return fn


def perturb_deform_convs(model, seed: int = 3):
    """Draw the RadarConvs' offset and modulator convs (zero at init) from
    a numpy seed, so that sampling leaves the zero-offset regime: random
    weights that exercise the deformable kernels as trained ones do."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "offset_conv"):
                for conv in (m.offset_conv, m.modulator_conv):
                    for p in (conv.weight, conv.bias):
                        p.copy_(torch.from_numpy(
                            rng.randn(*p.shape).astype(np.float32) * 0.1))


def entry(device: torch.device | str = "cpu",
          generator: Optional[torch.Generator] = None):
    """(fn, example_args) for EN-GDF-PN-S0 at 320^2, bf16, batch 1, with
    parameters drawn from the CPU `generator` (seed 0 when None)."""
    cfg = serving_config()
    model = create_model(cfg, device, generator)
    return make_fn(model, cfg), example_inputs(cfg, 1, device)
