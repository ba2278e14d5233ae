"""Inference BatchNorm (counterpart of achelous_tpu/ops/norm.py).

The affine is folded in float32 from the float32 parameters and running
statistics, then applied in the activation dtype — no float32 copy of the
activations, so a bf16 BN costs what a bf16 multiply-add costs.  Parameter
and buffer names are torch BatchNorm's (`weight`, `bias`, `running_mean`,
`running_var`), so reference state dicts load by name.  The channel axis
is 1 for any rank ([B,C], [B,C,N], [B,C,H,W]).

Only the serving path is ported: batch statistics (training) are not.
"""
from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("BatchNorm is inference-only in this port; "
                               "call .eval()")
        t = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        shift = self.bias.float() - self.running_mean.float() * t
        shape = (-1,) + (1,) * (x.dim() - 2)
        return x * t.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)
