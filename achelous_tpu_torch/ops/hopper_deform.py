"""Wrappers of RCNet's two CUDA kernels (counterpart of
achelous_tpu/ops/pallas_deform.py; sources in csrc/deform.cu).

  K1  fused_radarconv  <- pallas_fused_radarconv        (RCNet blocks 0-3)
  K2  deform_samples   <- pallas_deform_samples_cfio    (RCNet blocks 4-7)

A tensor on the CPU goes to the plain PyTorch version in ops/deform.py.  A
CUDA tensor goes to the kernel or the call raises: nothing falls back.
Each wrapper counts its kernel launches in its `launches` attribute.

On a CUDA tensor each kernel is reached through a custom operator,
`achelous::fused_radarconv` and `achelous::deform_samples`
(`torch.library.custom_op`), whose implementation is the ctypes launch and
whose fake implementation gives the output's shape and dtype.  So
`torch.export` traces a kernel as one node of its graph, and a program
loaded from the saved export launches the kernel (and counts it) as the
eager path does.

Where a gradient is asked for, each wrapper is a `torch.autograd.Function`
(`FusedRadarConv`, `DeformSamples`) built as the JAX package's
`custom_vjp`s (`_fused_fwd`/`_fused_bwd`, `_cfio_fwd`/`_cfio_bwd`): the
forward is the kernel and saves only its inputs; the backward runs the
plain version again under autograd and pulls the output's gradient back
through it.  Neither JAX kernel has a backward kernel, and neither has one
here.  On the CPU the Functions' forward is the plain version too.

The kernels take bf16 or float32 and compute in float32.  Outputs are
allocated here; the kernels launch on the current stream and do not
synchronise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from achelous_tpu_torch.kernels import build

FUSED_MAX_C = 8      # K1 keeps this many in/out channels in registers
TAPS = 9
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K2's launch (csrc/deform.cu deform_samples_kernel): tiles of 8 or 4
# rows x 8 pixels, a thread per (tap, pixel), G channels a block
SAMPLES_TILE = 8
SAMPLES_ROWS = (8, 4)
SAMPLES_GROUPS = (8, 4, 2, 1)
# K2's plan aims for two blocks an SM: the best plans of kernels/sweep.py
# at both serving shapes (one block an SM, with more channels a block, ran
# 0.2-0.5 us slower on the H100)
SAMPLES_BLOCKS_PER_SM = 2


def on_cuda(name: str, x: torch.Tensor):
    """Raise unless x is on a CUDA device (a meta tensor would reach an
    operator's fake implementation and run nothing)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")


def _check_cuda(name: str, x: torch.Tensor, *others: torch.Tensor):
    on_cuda(name, x)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in (x,) + others:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if max(t.numel(), x.numel() * TAPS) >= 2 ** 31:
            raise ValueError(f"{name}: tensors too large for 32-bit "
                             f"indexing")


def pack_radarconv_weights(w_off: torch.Tensor, b_off: torch.Tensor,
                           w_mod: torch.Tensor, b_mod: torch.Tensor,
                           weight: torch.Tensor):
    """A RadarConv's weights in the float32 layout K1 reads, tap-major:

      wconv [9, 9C, 4]  row ki: the three conv outputs tap ki needs (dy =
                        offset channel 2ki, dx = 2ki+1, modulator ki, then
                        a 0 pad) over the conv's inputs in (ky, kx, ci)
                        order
      bconv [9, 4]      their biases, the same way
      wproj [9C, Cout]  the projection, rows in (ki, ci) order

    from w_off [18,C,3,3], b_off [18], w_mod [9,C,3,3], b_mod [9] and the
    deformable weight [Cout,C,3,3].  The weights never change while a model
    serves, so callers pack once (DeformableConv2d caches the result)."""
    c = w_off.shape[1]
    zeros = torch.zeros_like(w_mod)
    w3 = torch.stack([w_off[0::2], w_off[1::2], w_mod, zeros], dim=-1)
    wconv = w3.float().permute(0, 2, 3, 1, 4).reshape(
        TAPS, TAPS * c, 4).contiguous()
    bconv = torch.stack([b_off[0::2], b_off[1::2], b_mod,
                         torch.zeros_like(b_mod)], dim=-1).float().contiguous()
    wproj = weight.float().permute(2, 3, 1, 0).reshape(
        TAPS * c, weight.shape[0]).contiguous()
    return wconv, bconv, wproj


def unpack_radarconv_weights(wconv: torch.Tensor, bconv: torch.Tensor,
                             wproj: torch.Tensor):
    """The inverse of `pack_radarconv_weights`: (w_off, b_off, w_mod,
    b_mod, weight) in float32, contiguous, so the plain version computes
    on them exactly as on the module's own weights."""
    c = wconv.shape[1] // TAPS
    w = wconv.reshape(TAPS, 3, 3, c, 4).permute(0, 4, 3, 1, 2)  # [9,4,C,3,3]
    w_off = torch.stack([w[:, 0], w[:, 1]], dim=1).reshape(2 * TAPS, c, 3, 3)
    b_off = bconv[:, :2].reshape(2 * TAPS)
    weight = wproj.reshape(3, 3, c, -1).permute(3, 2, 0, 1)
    return tuple(t.contiguous() for t in
                 (w_off, b_off, w[:, 2], bconv[:, 2], weight))


def wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def pullback(ctx, plain, g: torch.Tensor):
    """The gradients of `plain` at the inputs `ctx` saved, for those that
    need one (JAX's `jax.vjp` of the plain composition)."""
    need = ctx.needs_input_grad[:len(ctx.saved_tensors)]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        grads = iter(torch.autograd.grad(
            plain(*ins), [t for t, n in zip(ins, need) if n], g))
    return tuple(next(grads) if n else None for n in need)


def _plain_radarconv(band: int):
    from achelous_tpu_torch.ops.deform import fused_radarconv_reference

    def plain(x, wconv, bconv, wproj):
        return fused_radarconv_reference(
            x, *unpack_radarconv_weights(wconv, bconv, wproj), band)
    return plain


class FusedRadarConv(torch.autograd.Function):
    """K1 with a gradient: the kernel forward; the backward is the autograd
    of `fused_radarconv_reference` on the unpacked weights, which reaches
    the module's own conv parameters through the pack."""

    @staticmethod
    def forward(ctx, x, wconv, bconv, wproj, band):
        ctx.band = band
        ctx.save_for_backward(x, wconv, bconv, wproj)
        return _fused_forward(x, wconv, bconv, wproj, band)

    @staticmethod
    def backward(ctx, g):
        return pullback(ctx, _plain_radarconv(ctx.band), g) + (None,)


def fused_radarconv(x: torch.Tensor, wconv: torch.Tensor,
                    bconv: torch.Tensor, wproj: torch.Tensor,
                    band: int) -> torch.Tensor:
    """K1: a whole RadarConv, one launch.  x [B,C,H,W] raw; the weights as
    `pack_radarconv_weights` lays them out; integer band.  Returns
    [B,Cout,H,W] in x's dtype; differentiable (`FusedRadarConv`)."""
    if wants_grad(x, wconv, bconv, wproj):
        return FusedRadarConv.apply(x, wconv, bconv, wproj, band)
    return _fused_forward(x, wconv, bconv, wproj, band)


def _fused_forward(x, wconv, bconv, wproj, band):
    if x.device.type == "cpu":
        return _plain_radarconv(band)(x, wconv, bconv, wproj)
    on_cuda("fused_radarconv", x)
    return torch.ops.achelous.fused_radarconv(x, wconv, bconv, wproj, band)


@torch.library.custom_op("achelous::fused_radarconv", mutates_args=())
def _fused_op(x: torch.Tensor, wconv: torch.Tensor, bconv: torch.Tensor,
              wproj: torch.Tensor, band: int) -> torch.Tensor:
    """K1's checks and launch, as an operator."""
    _check_cuda("fused_radarconv", x)
    if x.dim() != 4:
        raise ValueError(f"fused_radarconv: x must be [B,C,H,W], got "
                         f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    cout = wproj.shape[-1]
    if not (1 <= c <= FUSED_MAX_C and 1 <= cout <= FUSED_MAX_C):
        raise ValueError(f"fused_radarconv: channels in/out must be 1.."
                         f"{FUSED_MAX_C}, got {c}/{cout}")
    want = {"wconv": (wconv, (TAPS, TAPS * c, 4)), "bconv": (bconv, (TAPS, 4)),
            "wproj": (wproj, (TAPS * c, cout))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_radarconv: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_radarconv: {name} must be float32 (from "
                            f"pack_radarconv_weights), got {t.dtype}")
    if isinstance(band, bool) or not isinstance(band, int) or band < 0:
        raise ValueError(f"fused_radarconv: band must be an int >= 0, got "
                         f"{band!r}")
    _check_cuda("fused_radarconv", x, wconv, bconv, wproj)
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.achelous_fused_radarconv(
            build.ptr(x), build.ptr(wconv), build.ptr(bconv),
            build.ptr(wproj), build.ptr(out),
            b, c, cout, h, w, band, _DTYPE_CODE[x.dtype],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.raise_on("fused_radarconv", err)
    fused_radarconv.launches += 1
    return out


@_fused_op.register_fake
def _(x, wconv, bconv, wproj, band):
    return x.new_empty((x.shape[0], wproj.shape[-1], x.shape[2], x.shape[3]))


class SamplesPlan(NamedTuple):
    """K2's launch: tiles of `rows` x 8 pixels; `group` channels a block;
    blocks."""
    rows: int
    group: int
    blocks: int


@functools.lru_cache(maxsize=256)
def deform_samples_plan(b: int, c: int, h: int, w: int,
                        sms: int) -> SamplesPlan:
    """K2's launch plan for x [b, c, h, w] on a card of `sms` SMs: the
    largest G in SAMPLES_GROUPS (not past C rounded up to a power of two),
    then the taller tile, that still give SAMPLES_BLOCKS_PER_SM blocks an
    SM, else G = 1 on 4-row tiles."""
    cap = 1 << (c - 1).bit_length()
    tiles = {rows: -(-h // rows) * -(-w // SAMPLES_TILE)
             for rows in SAMPLES_ROWS}
    plans = [SamplesPlan(rows, g, b * tiles[rows] * -(-c // g))
             for g in SAMPLES_GROUPS if g <= cap for rows in SAMPLES_ROWS]
    return next((p for p in plans
                 if p.blocks >= SAMPLES_BLOCKS_PER_SM * sms), plans[-1])


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class DeformSamples(torch.autograd.Function):
    """K2 with a gradient: the kernel forward; the backward is the autograd
    of `banded_deform_samples`."""

    @staticmethod
    def forward(ctx, x, offset, mask, band):
        ctx.band = band
        ctx.save_for_backward(x, offset, mask)
        return _samples_forward(x, offset, mask, band)

    @staticmethod
    def backward(ctx, g):
        from achelous_tpu_torch.ops.deform import banded_deform_samples
        band = ctx.band
        return pullback(ctx, lambda x, o, m: banded_deform_samples(
            x, o, m, band), g) + (None,)


def deform_samples(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   band: Optional[int]) -> torch.Tensor:
    """K2: modulated bilinear samples.  x [B,C,H,W], offset [B,18,H,W],
    mask [B,9,H,W], all one dtype; band an int >= 0 or None (no clip).
    Returns [B,9C,H,W] in x's dtype; differentiable (`DeformSamples`)."""
    if wants_grad(x, offset, mask):
        return DeformSamples.apply(x, offset, mask, band)
    return _samples_forward(x, offset, mask, band)


def _samples_forward(x, offset, mask, band):
    if x.device.type == "cpu":
        from achelous_tpu_torch.ops.deform import banded_deform_samples
        return banded_deform_samples(x, offset, mask, band)
    on_cuda("deform_samples", x)
    return torch.ops.achelous.deform_samples(x, offset, mask, band)


@torch.library.custom_op("achelous::deform_samples", mutates_args=())
def _samples_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                band: Optional[int]) -> torch.Tensor:
    """K2's launch on the plan `deform_samples_plan` picks, as an
    operator."""
    return launch_samples(x, offset, mask, band, None)


@_samples_op.register_fake
def _(x, offset, mask, band):
    return x.new_empty((x.shape[0], TAPS * x.shape[1], x.shape[2],
                        x.shape[3]))


def launch_samples(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   band: Optional[int],
                   plan: Optional[SamplesPlan]) -> torch.Tensor:
    """K2 on CUDA tensors with a launch plan; None takes
    `deform_samples_plan`.  `kernels/sweep.py` and the CUDA tests pass
    others."""
    _check_cuda("deform_samples", x, offset, mask)
    if x.dim() != 4:
        raise ValueError(f"deform_samples: x must be [B,C,H,W], got "
                         f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    for name, t, ch in (("offset", offset, 2 * TAPS), ("mask", mask, TAPS)):
        if tuple(t.shape) != (b, ch, h, w):
            raise ValueError(f"deform_samples: {name} must be "
                             f"{(b, ch, h, w)}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"deform_samples: {name} dtype {t.dtype} != "
                            f"x dtype {x.dtype}")
    if band is not None and (isinstance(band, bool)
                             or not isinstance(band, int) or band < 0):
        raise ValueError(f"deform_samples: band must be None or an int >= 0, "
                         f"got {band!r}")
    out = torch.empty((b, TAPS * c, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = deform_samples_plan(b, c, h, w, sm_count(x.device))
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.achelous_deform_samples(
            build.ptr(x), build.ptr(offset), build.ptr(mask), build.ptr(out),
            b, c, h, w,
            -1 if band is None else band, _DTYPE_CODE[x.dtype], plan.rows,
            plan.group,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.raise_on("deform_samples", err)
    deform_samples.launches += 1
    return out


fused_radarconv.launches = 0
deform_samples.launches = 0


def reset_launch_counts():
    fused_radarconv.launches = 0
    deform_samples.launches = 0
