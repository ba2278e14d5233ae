"""Top-level Achelous assembly (counterpart of achelous_tpu/models/achelous.py).

One forward produces, channels-first:
  det:   3 scale maps [B, 4+1+num_det, Hs, Ws]   (strides 8/16/32)
  sem:   [B, num_seg, R, R]  semantic seg logits
  lane:  [B, 2, R, R]        waterline seg logits
  pc:    [B, N, pc_classes]  point-cloud seg log-probs

The module tree is the reference's (nets/Achelous.py, IREncoder.py):
`image_radar_encoder` holds the neck (`fpn`, which holds the backbone), the
radar encoder and the per-scale fusion; `det_head` and `pc_seg_model` sit
beside it.  So `state_dict()` keys are the reference torch keys.  The
backbone is any of the JAX package's eight (`make_backbone`); the neck's
fuse and decoder blocks ghost (`gdf`), CSP (`cdf`) or RepVGG (`rdf`) ones;
the point-cloud branch PointNet (`pn`) or PointNet++ (`pn2`).

`Achelous(cfg, with_pc=False)` is the 3-task Achelous3T (reference
nets/Achelous.py:56-76, JAX `Achelous(with_pc=False)`): no `pc_seg_model`,
the forward takes no point cloud and returns (det, sem, lane).

`Achelous(cfg, deploy=True)` builds the deploy form, in which every
reparameterizable block (RepVGG, MobileOne, RepVGGDW, RepMixer, the large
kernel conv) is its single fused conv; `core/reparam.reparameterize` folds
a train-form state dict into its keys, and `create_model(..., deploy=True)`
does both.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.core.config import AchelousConfig, WIDTHS
from achelous_tpu_torch.core.init import init_params
from achelous_tpu_torch.core.reparam import reparameterize
from achelous_tpu_torch.models.edgenext import EDGENEXT_VARIANTS
from achelous_tpu_torch.models.edgevit import edgevit
from achelous_tpu_torch.models.efficientformer import EfficientFormerV2
from achelous_tpu_torch.models.fastvit import fastvit
from achelous_tpu_torch.models.heads import DecoupleHead
from achelous_tpu_torch.models.mobileone import MobileOne
from achelous_tpu_torch.models.mobilevit import mobilevit
from achelous_tpu_torch.models.necks import DualFPN
from achelous_tpu_torch.models.pointnet import PointNetSeg
from achelous_tpu_torch.models.pointnet2 import PointNet2Seg
from achelous_tpu_torch.models.poolformer import poolformer
from achelous_tpu_torch.models.rcnet import RCNet
from achelous_tpu_torch.models.repvit import RepViT
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.ops.primitives import ECA

STAGES = (3, 4, 5)


def make_backbone(cfg: AchelousConfig, deploy: bool = False) -> nn.Module:
    """The vision backbone named by `cfg.backbone`; `deploy` builds the
    reparameterizable families (`rv`, `mo`, `fv`) in their fused form."""
    c, phi = cfg.image_channels, cfg.phi
    if cfg.backbone == "en":
        return EDGENEXT_VARIANTS[phi](in_chans=c)
    if cfg.backbone == "mv":
        return mobilevit(phi, in_chans=c)
    if cfg.backbone == "ef":
        return EfficientFormerV2(phi, cfg.resolution, in_chans=c)
    if cfg.backbone == "ev":
        return edgevit(phi, in_chans=c)
    if cfg.backbone == "rv":
        return RepViT(phi, in_chans=c, deploy=deploy)
    if cfg.backbone == "pf":
        return poolformer(phi, in_chans=c)
    if cfg.backbone == "mo":
        return MobileOne(phi, in_chans=c, deploy=deploy)
    if cfg.backbone == "fv":
        return fastvit(phi, in_chans=c, deploy=deploy)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


class IRFusion(nn.Module):
    """Per-scale image-radar fusion: ECA on each modality, channel concat
    (C + C/4), BN + ReLU."""

    def __init__(self, phi: str):
        super().__init__()
        w = WIDTHS[phi]
        for i, stage in enumerate(STAGES):
            c_img, c_rad = w[i + 1], w[i + 1] // 4
            setattr(self, f"channel_attn_stage{stage}",
                    nn.ModuleList([ECA(c_img), ECA(c_rad)]))
            setattr(self, f"norm_stage{stage}", BatchNorm(c_img + c_rad))

    def forward(self, img_feats: Sequence[torch.Tensor],
                radar_feats: Sequence[torch.Tensor]):
        fused = []
        for stage, fi, fr in zip(STAGES, img_feats, radar_feats):
            eca_img, eca_radar = getattr(self, f"channel_attn_stage{stage}")
            x = torch.cat([eca_img(fi), eca_radar(fr)], dim=1)
            fused.append(F.relu(getattr(self, f"norm_stage{stage}")(x)))
        return tuple(fused)


class IREncoder(IRFusion):
    """Image branch (backbone + neck), radar branch (RCNet) and their
    fusion; returns (fused P3/P4/P5, sem, lane)."""

    def __init__(self, cfg: AchelousConfig, deploy: bool = False):
        super().__init__(cfg.phi)
        self.fpn = DualFPN(cfg.num_seg, cfg.phi,
                           backbone=make_backbone(cfg, deploy),
                           family=cfg.neck, use_spp=cfg.use_spp,
                           deploy=deploy)
        self.radar_encoder = RCNet(cfg.phi, band=cfg.deform_band,
                                   in_channels=cfg.radar_channels)

    def forward(self, image, radar_map):
        sem, lane, (p5, p4, p3) = self.fpn(image)
        fused = super().forward((p3, p4, p5), self.radar_encoder(radar_map))
        return fused, sem, lane


class Achelous(nn.Module):
    def __init__(self, cfg: AchelousConfig, deploy: bool = False,
                 with_pc: bool = True):
        super().__init__()
        self.cfg, self.deploy, self.with_pc = cfg, deploy, with_pc
        self.image_radar_encoder = IREncoder(cfg, deploy)
        self.det_head = DecoupleHead(cfg.num_det, cfg.det_in_channels,
                                     nano_head=cfg.nano_head)
        if with_pc:
            pc_model = PointNet2Seg if cfg.pc_model == "pn2" else PointNetSeg
            self.pc_seg_model = pc_model(cfg.pc_classes, cfg.pc_channels)

    def forward(self, image: torch.Tensor, radar_map: torch.Tensor,
                point_cloud: Optional[torch.Tensor] = None):
        """image [B,3,R,R], radar_map [B,3,R,R], point_cloud [B,N,5] ->
        (det, sem, lane, pc); (det, sem, lane) without the point-cloud
        branch."""
        fused, sem, lane = self.image_radar_encoder(image, radar_map)
        det = self.det_head(fused)
        if not self.with_pc:
            return det, sem, lane
        pc, _ = self.pc_seg_model(point_cloud)
        return det, sem, lane, pc


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to `dtype` except the BatchNorms', which stay
    float32 (their affine is folded in float32, ops/norm.py)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model


def _device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run on the CPU")
    return device


def create_model(cfg: AchelousConfig,
                 device: torch.device | str = torch.device("cuda"),
                 generator: Optional[torch.Generator] = None,
                 train: bool = False, deploy: bool = False,
                 state_dict: Optional[dict] = None,
                 with_pc: bool = True) -> Achelous:
    """The model on `device` (the GPU unless the CPU is asked for),
    parameters drawn from `generator` (seed 0 when None) as the JAX
    initializers draw them, or taken from `state_dict` (train-form keys).
    For serving: in eval mode, frozen, cast to `cfg.dtype`; with `deploy`,
    the train form folded into the deploy form first, in float32 (as the
    JAX predictor folds before it compiles).  With `train`: in train mode
    (batch statistics), float32 parameters that take gradients;
    `forward_compute` runs it in `cfg.dtype`.  `with_pc=False` builds
    the 3-task Achelous3T, which serves only: the JAX package's losses
    take four outputs, so it does not train."""
    device = _device(device)
    if train and deploy:
        raise ValueError("the deploy form serves only; train the train form")
    if train and not with_pc:
        raise ValueError("Achelous3T (with_pc=False) serves only: the "
                         "training losses take the point-cloud output")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_params(Achelous(cfg, with_pc=with_pc), generator)
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in state_dict.items()})
    if train:
        return model.train().to(device)
    if deploy:
        folded = reparameterize(model.state_dict())
        model = Achelous(cfg, deploy=True, with_pc=with_pc)
        model.load_state_dict(folded)
    return cast_compute(model.eval().requires_grad_(False).to(device),
                        cfg.dtype)


def forward_compute(model: Achelous, image: torch.Tensor, radar: torch.Tensor,
                    points: torch.Tensor,
                    tensors: Optional[dict[str, torch.Tensor]] = None):
    """The forward of a model with float32 parameters in `model.cfg.dtype`,
    as the flax modules compute: the inputs and every parameter but the
    BatchNorms' (float32, ops/norm.py) are cast to that dtype at use, and
    autograd carries the gradients back to the float32 parameters.  So K1
    and K2 see one dtype, the one they serve in.  `tensors` (parameters and
    BatchNorm statistics by name, e.g. the EMA's) stand in for the model's
    own."""
    dtype = model.cfg.dtype
    args = tuple(t.to(dtype) for t in (image, radar, points))
    if dtype == torch.float32 and tensors is None:
        return model(*args)
    norms = {n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    params = dict(model.named_parameters())
    if tensors is not None:
        params.update(tensors)
    params = {n: p if n.rpartition(".")[0] in norms else p.to(dtype)
              for n, p in params.items()}
    return torch.func.functional_call(model, params, args)


def example_inputs(cfg: AchelousConfig, batch: int = 1,
                   device: torch.device | str = torch.device("cuda")):
    """Zero-filled (image [B,3,R,R], radar [B,3,R,R], points [B,N,5]) on
    `device` (the GPU unless the CPU is asked for)."""
    r = cfg.resolution
    kw = dict(dtype=cfg.dtype, device=_device(device))
    return (torch.zeros(batch, cfg.image_channels, r, r, **kw),
            torch.zeros(batch, cfg.radar_channels, r, r, **kw),
            torch.zeros(batch, cfg.pc_points, cfg.pc_channels, **kw))
