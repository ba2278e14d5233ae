"""Wrapper of the fused bias-attention CUDA kernel (counterpart of
achelous_tpu/ops/pallas_attention.py; source in csrc/attention.cu).

  K3  fused_bias_attention  <- fused_bias_attention
                               (EfficientFormerV2 Attention4D, 4 a frame)

A tensor on the CPU goes to the plain PyTorch version in ops/attention.py.
A CUDA tensor goes to the kernel or the call raises: nothing falls back.
The wrapper counts its kernel launches in its `launches` attribute.  The
launch is the custom operator `achelous::fused_bias_attention`, which
`torch.export` keeps as one node (as ops/hopper_deform.py does for K1 and
K2).

Where a gradient is asked for, the wrapper is a `torch.autograd.Function`
(`FusedBiasAttention`) built as K1's and K2's are (ops/hopper_deform.py):
the forward is the kernel and saves only its eight inputs; the backward
runs `reference_bias_attention` again under autograd and pulls the
output's gradient back through it.  The JAX package trains
EfficientFormerV2 through that same plain composition; neither package
has a backward kernel.  `launches` counts forward launches only.

All inputs share one dtype, float32 or bf16 (the caller rounds the bias
table and the head mixes to the compute dtype first, as the JAX package
does; Attention4D caches them so rounded); the kernel runs both products
on tensor cores (bf16 operands; float32 inputs split into three bf16
planes), everything else in float32, and returns that dtype.
"""
from __future__ import annotations

import ctypes

import torch

from achelous_tpu_torch.kernels import build
from achelous_tpu_torch.ops.attention import reference_bias_attention
from achelous_tpu_torch.ops.hopper_deform import (on_cuda, pullback,
                                                  wants_grad)

MAX_HEADS = 8         # the head mixes keep one value per head in registers
MAX_KEY_DIM = 64      # every head's keys staged in shared memory, 16 at least
MAX_TOKENS = 4096     # the keys stream through in chunks; the grid bounds N
MAX_VALUE_DIM = 1024  # 64 value columns a block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, th1_w: torch.Tensor,
                         th1_b: torch.Tensor, th2_w: torch.Tensor,
                         th2_b: torch.Tensor, scale: float) -> torch.Tensor:
    """K3.  q, k [B,h,N,dk]; v [B,h,N,dv]; bias [h,N,N]; th*_w [h,h] as
    [g_out, h_in]; th*_b [h].  Returns [B,h,N,dv] in q's dtype;
    differentiable (`FusedBiasAttention`)."""
    args = (q, k, v, bias, th1_w, th1_b, th2_w, th2_b)
    if wants_grad(*args):
        return FusedBiasAttention.apply(*args, scale)
    return _attention_forward(*args, scale)


class FusedBiasAttention(torch.autograd.Function):
    """K3 with a gradient: the kernel forward; the backward is the autograd
    of `reference_bias_attention` on the saved inputs, which reaches the
    float32 bias table and head mixes through the caller's gather and
    casts."""

    @staticmethod
    def forward(ctx, q, k, v, bias, th1_w, th1_b, th2_w, th2_b, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, th1_w, th1_b, th2_w, th2_b)
        return _attention_forward(q, k, v, bias, th1_w, th1_b, th2_w, th2_b,
                                  scale)

    @staticmethod
    def backward(ctx, g):
        scale = ctx.scale
        return pullback(ctx, lambda *a: reference_bias_attention(*a, scale),
                        g) + (None,)


def _attention_forward(q, k, v, bias, th1_w, th1_b, th2_w, th2_b, scale):
    args = (q, k, v, bias, th1_w, th1_b, th2_w, th2_b)
    if q.device.type == "cpu":
        return reference_bias_attention(*args, scale)
    on_cuda("fused_bias_attention", q)
    return torch.ops.achelous.fused_bias_attention(*args, scale)


@torch.library.custom_op("achelous::fused_bias_attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, th1_w: torch.Tensor,
                  th1_b: torch.Tensor, th2_w: torch.Tensor,
                  th2_b: torch.Tensor, scale: float) -> torch.Tensor:
    """K3's checks and launch, as an operator."""
    args = (q, k, v, bias, th1_w, th1_b, th2_w, th2_b)
    name = "fused_bias_attention"
    on_cuda(name, q)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32 or "
                        f"bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B,h,N,dk], got "
                         f"{tuple(q.shape)}")
    b, h, n, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    want = {"k": (b, h, n, dk), "v": (b, h, n, dv), "bias": (h, n, n),
            "th1_w": (h, h), "th1_b": (h,), "th2_w": (h, h), "th2_b": (h,)}
    for key, t in zip(want, args[1:]):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} must be {want[key]}, got "
                             f"{tuple(t.shape)}")
    for t in args:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, got "
                             f"{t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: all tensors must be {q.dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if not (1 <= h <= MAX_HEADS and 1 <= dk <= MAX_KEY_DIM
            and 1 <= n <= MAX_TOKENS and 1 <= dv <= MAX_VALUE_DIM):
        raise ValueError(f"{name}: needs 1 <= h <= {MAX_HEADS}, 1 <= dk <= "
                         f"{MAX_KEY_DIM}, 1 <= N <= {MAX_TOKENS}, 1 <= dv <= "
                         f"{MAX_VALUE_DIM}; got h={h}, dk={dk}, N={n}, dv={dv}")
    if max(q.numel(), v.numel(), bias.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: tensors too large for 32-bit indexing")
    out = torch.empty((b, h, n, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.achelous_bias_attention(
            *(build.ptr(t) for t in args), build.ptr(out), b, h, n, dk, dv,
            float(scale), _DTYPE_CODE[q.dtype],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.raise_on(name, err)
    fused_bias_attention.launches += 1
    return out


@_attention_op.register_fake
def _(q, k, v, bias, th1_w, th1_b, th2_w, th2_b, scale):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


fused_bias_attention.launches = 0
