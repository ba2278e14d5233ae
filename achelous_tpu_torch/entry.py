"""Entry point of the serving path (counterpart of `entry()` in the
repository's __graft_entry__.py).

    fn, (image, radar, points) = entry(device, generator, backbone, pc_model)
    detections, sem, lane, pc = fn(image, radar, points)

At 320x320, bf16, batch 1: the 5-task forward, then decode + class-aware
NMS.  The default is EN-GDF-PN-S0, the repository's flagship; `backbone`
"ef" gives EF-GDF-PN-S0 and `pc_model` "pn2" EN-GDF-PN2-S0; `phi`, `neck`
and `use_spp` give the other configurations of BENCH_SWEEP.json
(EN-GDF-PN-S1/S2, SPPF, MV-GDF-PN-S1, EN-CDF-PN2-S2) and every other one
the JAX package builds: the backbones `ev`, `rv`, `pf`, `mo`, `fv`, the
`rdf` neck (with `mo` or `fv`) and EfficientFormerV2-L (`backbone="ef",
phi="L"`).  `deploy` serves the reparameterized form: the train form drawn
from the generator, folded in float32 (`core/reparam.py`), then cast.  The
radar map is channels-first [1,3,320,320], the image [1,3,320,320] and the
points [1,512,5]; the example inputs are zeros.  `with_pc=False` serves
the 3-task Achelous3T: `fn(image, radar)` returns (detections, sem,
lane), and the example inputs are (image, radar).  Everything runs on the
GPU unless the caller passes the CPU as `device`.
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
                   resolution: int = 320, backbone: str = "en",
                   pc_model: str = "pn", phi: str = "S0", neck: str = "gdf",
                   use_spp: bool = True) -> AchelousConfig:
    return AchelousConfig(phi=phi, backbone=backbone, neck=neck,
                          pc_model=pc_model, resolution=resolution,
                          dtype=dtype, use_spp=use_spp)


def make_fn(model, cfg: AchelousConfig):
    """The request function: forward, then decode + NMS.  It carries
    its `model` and `cfg` as attributes."""
    r = cfg.resolution

    @torch.inference_mode()
    def fn(image, radar, points=None):
        det, sem, lane, *pc = model(image, radar, points)
        decoded = decode_outputs(det, (r, r))
        dets = non_max_suppression(decoded, cfg.num_det,
                                   conf_thres=CONF_THRES, nms_thres=NMS_THRES)
        return (dets, sem, lane, *pc)

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


def perturb_attention(model, seed: int = 4, layer_scale: float = 0.05):
    """Draw the layer scales (1e-5 at init: EfficientFormerV2's, and
    FastViT's and PoolFormer's where they remain) at `layer_scale`,
    EfficientFormerV2's attention bias tables (0 at init) and talking
    heads from a numpy seed, so that the blocks behind them, and the
    attention kernel, reach the outputs.  At these scales zeroing the
    attention kernel's output moves EF-GDF-PN-S0's outputs by most of
    their range, while bf16 stays well inside chip_smoke.py's gate against
    float32; larger layer scales drift past it on random weights, and
    deeper models (EF-L, three times S0's attention blocks a stage) take
    a smaller one."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_scale" in name:
                scale = layer_scale
            elif "attention_biases" in name or "talking_head" in name:
                scale = 0.5
            else:
                continue
            p.copy_(torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32) * scale))


def entry(device: torch.device | str = torch.device("cuda"),
          generator: Optional[torch.Generator] = None,
          backbone: str = "en", pc_model: str = "pn", phi: str = "S0",
          neck: str = "gdf", use_spp: bool = True, deploy: bool = False,
          state_dict: Optional[dict] = None, with_pc: bool = True):
    """(fn, example_args) for {backbone}-{neck}-{pc_model}-{phi} at 320^2,
    bf16, batch 1, on `device`, with parameters drawn from the CPU
    `generator` (seed 0 when None) or taken from `state_dict` (train-form
    keys), in the deploy form with `deploy`, without the point-cloud
    branch with `with_pc=False`.  Raises where the device is a GPU and
    none is visible."""
    cfg = serving_config(backbone=backbone, pc_model=pc_model, phi=phi,
                         neck=neck, use_spp=use_spp)
    model = create_model(cfg, device, generator, deploy=deploy,
                         state_dict=state_dict, with_pc=with_pc)
    args = example_inputs(cfg, 1, device)
    return make_fn(model, cfg), (args if with_pc else args[:2])
