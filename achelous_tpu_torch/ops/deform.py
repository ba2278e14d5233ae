"""Modulated deformable convolution (DCNv2) of RCNet, NCHW (counterpart of
achelous_tpu/ops/deform.py).

Plain PyTorch versions of the two kernels in `ops/hopper_deform.py` live
here; they are the CPU path and the oracle the kernels are held against:

  banded_deform_samples      K2's function: modulated bilinear samples
  fused_radarconv_reference  K1's function: a whole RadarConv

Sampling semantics (torchvision `deform_conv2d`): tap `ki = ky*3 + kx`
reads offset channels `2ki` (dy) and `2ki+1` (dx) and samples the input at
`(y + ky - 1 + dy, x + kx - 1 + dx)` bilinearly, with corners outside the
image reading 0.  With an integer `band` the offsets are first clipped to
[-band, band]; this equals the JAX package's hat-window sum over the band,
whose row tiling and offset tiers are TPU cost devices and are not ported.
The bilinear weights are taken from the offset's own fractional part,
`o - floor(o)`, so they do not lose bits to the pixel coordinate.

Both functions compute in float32 and return the input's dtype, as the
kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from achelous_tpu_torch.ops import hopper_deform
from achelous_tpu_torch.ops.param_cache import ParamCache
from achelous_tpu_torch.ops.primitives import avg_pool_same

TAPS = 9    # 3x3 deformable conv


def banded_deform_samples(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor,
                          band: Optional[int]) -> torch.Tensor:
    """x [B,C,H,W], offset [B,18,H,W], mask [B,9,H,W] -> samples
    [B,9C,H,W] (tap-major, channel `ki*C + ci`), modulated by `mask`.

    `band` None samples at the unclipped offset (the exact path)."""
    b, c, h, w = x.shape
    dev = x.device
    xf = x.float().reshape(b, c, h * w)
    oy = offset[:, 0::2].float()                     # [B,9,H,W]
    ox = offset[:, 1::2].float()
    if band is not None:
        oy = oy.clamp(-band, band)
        ox = ox.clamp(-band, band)
    fy, fx = torch.floor(oy), torch.floor(ox)
    wy1, wx1 = oy - fy, ox - fx
    # integer base corner; offsets beyond the image are clamped to a
    # position that is still outside it, which keeps the cast in range
    taps = torch.arange(TAPS, device=dev)
    y0 = (torch.arange(h, device=dev).view(1, 1, h, 1)
          + (taps // 3 - 1).view(1, TAPS, 1, 1)
          + fy.clamp(-(h + 2), h + 2).long())
    x0 = (torch.arange(w, device=dev).view(1, 1, 1, w)
          + (taps % 3 - 1).view(1, TAPS, 1, 1)
          + fx.clamp(-(w + 2), w + 2).long())
    acc = None
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi, xi = y0 + dy, x0 + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
            idx = idx.reshape(b, 1, TAPS * h * w).expand(b, c, -1)
            v = torch.gather(xf, 2, idx).reshape(b, c, TAPS, h, w)
            t = v * (wy * wx * valid)[:, None]
            acc = t if acc is None else acc + t
    acc = acc * mask.float()[:, None]                # [B,C,9,H,W]
    return acc.transpose(1, 2).reshape(b, TAPS * c, h, w).to(x.dtype)


def projection_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Deformable-conv weight [Cout,C,3,3] -> [Cout, 9C], columns in the
    samples' tap-major order."""
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def fused_radarconv_reference(x: torch.Tensor, w_off: torch.Tensor,
                              b_off: torch.Tensor, w_mod: torch.Tensor,
                              b_mod: torch.Tensor, weight: torch.Tensor,
                              band: int) -> torch.Tensor:
    """One RadarConv on the RAW input x [B,C,H,W]: 3x3 avg-pool -> offset
    conv (w_off [18,C,3,3]) and modulator conv (w_mod [9,C,3,3], 2*sigmoid)
    -> banded sampling of the pooled map -> projection by the deformable
    weight [Cout,C,3,3].  Returns [B,Cout,H,W]."""
    pooled = avg_pool_same(x.float(), 3)
    off = F.conv2d(pooled, w_off.float(), b_off.float(), padding=1)
    mask = 2.0 * torch.sigmoid(F.conv2d(pooled, w_mod.float(), b_mod.float(),
                                        padding=1))
    samples = banded_deform_samples(pooled, off, mask, band)
    out = torch.einsum("bihw,oi->bohw", samples,
                       projection_matrix(weight.float()))
    return out.to(x.dtype)


class DeformableConv2d(nn.Module):
    """RadarConv's pooled 3x3 modulated deformable conv (reference
    conv_utils/dcn.py + RadarEncoder.py 'pool' calculator), stride 1.

    The module owns the 3x3 avg-pool in front of it, as the JAX module does
    with `input_pool=True`.  Offset and modulator convs start at zero, so
    at init this is a plain conv with x1 modulation.

    With an integer band and at most `FUSED_MAX_C` channels in and out, the
    whole module is one call of K1, on weights packed once
    (`hopper_deform.pack_radarconv_weights`) and packed again only when a
    parameter changes (`ops/param_cache.py`); otherwise pool and
    offset/modulator convs run in PyTorch, K2 samples, and a matmul
    projects.
    """

    def __init__(self, cin: int, features: int, band: Optional[int] = None):
        super().__init__()
        self.band = band
        self.offset_conv = nn.Conv2d(cin, 2 * TAPS, 3, 1, 1, bias=True)
        self.modulator_conv = nn.Conv2d(cin, TAPS, 3, 1, 1, bias=True)
        self.regular_conv = nn.Conv2d(cin, features, 3, 1, 1, bias=False)
        self.fused = (band is not None
                      and max(cin, features) <= hopper_deform.FUSED_MAX_C)
        self._packed = ParamCache()

    def _apply(self, fn, *args, **kwargs):
        self._packed.clear()
        return super()._apply(fn, *args, **kwargs)

    def packed_weights(self):
        """(wconv, bconv, wproj) as K1 reads them."""
        params = (self.offset_conv.weight, self.offset_conv.bias,
                  self.modulator_conv.weight, self.modulator_conv.bias,
                  self.regular_conv.weight)
        return self._packed.get(
            params, lambda: hopper_deform.pack_radarconv_weights(*params))

    def zero_init_(self):
        for conv in (self.offset_conv, self.modulator_conv):
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return hopper_deform.fused_radarconv(x, *self.packed_weights(),
                                                 self.band)
        pooled = avg_pool_same(x, 3)
        off = self.offset_conv(pooled)
        mask = 2.0 * torch.sigmoid(self.modulator_conv(pooled))
        samples = hopper_deform.deform_samples(pooled, off, mask, self.band)
        return torch.einsum("bihw,oi->bohw", samples,
                            projection_matrix(self.regular_conv.weight))
