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

The offset's gradient follows the JAX package's where the two differ: at
an integer offset inside the band.  There JAX differentiates its hat
weights `max(0, 1 - |o - d|)` with `jnp.abs`'s slope 1 at 0 and
`jnp.maximum`'s half slope at a tie, which gives `-v(o) + (v(o+1) -
v(o-1)) / 2` along each axis, where `o - floor(o)` gives the one-sided
`v(o+1) - v(o)`.  Every offset is integer at the zero initialisation of
the offset convs, so the first training step depends on it.
`banded_deform_samples` adds the difference as a term whose value is 0
(`_TieSlope`), only when the offset takes a gradient.  On the bound,
o = +-band, JAX differs twice more: its hat window stops at the band, so
the cell past it adds no half slope, and `jnp.clip` passes half of what
arrives where `clamp` passes all of it; the tie term leaves out that
cell, and another zero-valued term takes back the other half (`_clip`).

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
    ties = (band is not None and torch.is_grad_enabled()
            and offset.requires_grad)
    if band is not None:
        oy, ox = _clip(oy, band, ties), _clip(ox, band, ties)
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

    def corner(src, dy, dx):
        """src at (y0 + dy, x0 + dx) [B,C,9,H,W], and where that lies in
        the image [B,9,H,W]."""
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        idx = idx.reshape(b, 1, TAPS * h * w).expand(b, c, -1)
        return torch.gather(src, 2, idx).reshape(b, c, TAPS, h, w), valid

    acc, gathered = None, {}
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            v, valid = corner(xf, dy, dx)
            if ties:
                gathered[dy, dx] = v, valid
            t = v * (wy * wx * valid)[:, None]
            acc = t if acc is None else acc + t
    if ties:
        with torch.no_grad():
            slopes = _tie_slopes(lambda dy, dx: gathered.get((dy, dx))
                                 or corner(xf, dy, dx), oy, ox, wy1, wx1,
                                 band)
        acc = (acc + _TieSlope.apply(oy[:, None], slopes[0])
               + _TieSlope.apply(ox[:, None], slopes[1]))
    acc = acc * mask.float()[:, None]                # [B,C,9,H,W]
    return acc.transpose(1, 2).reshape(b, TAPS * c, h, w).to(x.dtype)


def _clip(o: torch.Tensor, band: int, grad: bool) -> torch.Tensor:
    """o clipped to [-band, band].  With `grad`, the slope where |o| ==
    band is `jnp.clip`'s 1/2, not `clamp`'s 1: a term whose value is 0
    takes back the other half there."""
    out = o.clamp(-band, band)
    if grad:
        at = torch.where(o.abs() == band, o, 0.0)
        out = out - 0.5 * (at - at.detach())
    return out


def _tie_slopes(corner, oy, ox, wy1, wx1, band: int):
    """What JAX's offset gradient adds to the one-sided one at integer
    offsets, per channel, along y and x ([B,C,9,H,W] each; 0 where the
    offset is not integer): -(v(o+1) + v(o-1)) / 2 along the axis, the
    other axis interpolated.  JAX's hat window ends at the band, so on
    the bound the cell past it adds no half: there the term is
    -v(o+1) - v(o-1)/2 at o = band and -v(o+1)/2 at o = -band."""
    def at(dy, dx):
        v, valid = corner(dy, dx)
        return v * valid[:, None]

    wy = (1.0 - wy1)[:, None], wy1[:, None]
    wx = (1.0 - wx1)[:, None], wx1[:, None]

    def slope(o, w1, up, down):
        o = o[:, None]
        s = (-0.5 * (up + down) - torch.where(o == band, 0.5 * up, 0.0)
             + torch.where(o == -band, 0.5 * down, 0.0))
        return torch.where((w1 == 0)[:, None], s, 0.0)

    return (slope(oy, wy1, sum(wx[dx] * at(1, dx) for dx in (0, 1)),
                  sum(wx[dx] * at(-1, dx) for dx in (0, 1))),
            slope(ox, wx1, sum(wy[dy] * at(dy, 1) for dy in (0, 1)),
                  sum(wy[dy] * at(dy, -1) for dy in (0, 1))))


class _TieSlope(torch.autograd.Function):
    """0 of `slope`'s shape, whose gradient w.r.t. `o` (broadcast over
    `slope`'s channel axis 1) is `slope`: a slope added to an offset's
    gradient without touching a value."""

    @staticmethod
    def forward(ctx, o, slope):
        ctx.save_for_backward(slope)
        return torch.zeros_like(slope)

    @staticmethod
    def backward(ctx, g):
        slope, = ctx.saved_tensors
        return (g * slope).sum(1, keepdim=True), None


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
    # flax holds the deformable weight as a plain parameter
    FLAX_KIND = {"regular_conv": "param"}

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
