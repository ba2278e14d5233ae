"""BatchNorm with float32 statistics (counterpart of achelous_tpu/ops/norm.py
`F32BatchNorm`).

Inference (`eval()`): the affine is folded in float32 from the float32
parameters and running statistics, then applied in the activation dtype —
no float32 copy of the activations, so a bf16 BN costs what a bf16
multiply-add costs.

Training (`train()`): the batch mean and the biased variance are taken in
float32 over every axis but the channels, the input is normalised and
scaled in float32 and cast back to its dtype, and the running statistics
move by `momentum` (torch's convention: flax's momentum m is torch's
1 - m; the JAX package's default m = 0.9 is 0.1 here, its ConvBN /
YoloConv m = 0.97 is 0.03).  Unlike torch's `F.batch_norm`, the running
variance takes the same biased variance.

The JAX package computes that variance as E[x^2] - E[x]^2; here it is
E[(x - E[x])^2], equal in exact arithmetic.  The one-pass form cancels in
float32 where a channel's spread is small against its mean, as in
PointNet's fully connected BatchNorms over a batch of 2, whose two
samples' features nearly coincide: there its variance is rounding
noise.

Under `parallel.dist.batch_group(group)` with more than one rank, the
batch is this rank's rows of a global batch: the mean is the group's sum
over its count, the variance the group's sum of squares about that mean
over the count, both through the differentiable `all_reduce_sum`, so the
output, the gradients and the running statistics (equal on every rank)
are those of the global batch, as the JAX package's BatchNorm on a
batch-sharded mesh computes them.  Without a group the code path is the
single-process one.

Parameter and buffer names are torch BatchNorm's (`weight`, `bias`,
`running_mean`, `running_var`), so reference state dicts load by name.
The channel axis is 1 for any rank ([B,C], [B,C,N], [B,C,H,W]).
"""
from __future__ import annotations

import torch
from torch import nn

from achelous_tpu_torch.parallel.dist import all_reduce_sum, current_group


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 2)
        if self.training:
            return self._train_forward(x, shape)
        t = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        shift = self.bias.float() - self.running_mean.float() * t
        return x * t.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)

    def _train_forward(self, x: torch.Tensor, shape) -> torch.Tensor:
        xf = x.float()
        axes = [0] + list(range(2, x.dim()))
        group = current_group()
        if group is None:
            mean = xf.mean(axes)
            var = (xf - mean.view(shape)).square().mean(axes)
        else:
            # the rows' count rides with the sums: one all-reduce
            n = xf.new_full((1,), float(x.numel() // x.shape[1]))
            sums = all_reduce_sum(torch.cat([xf.sum(axes), n]), group)
            count = sums[-1]
            mean = sums[:-1] / count
            var = all_reduce_sum((xf - mean.view(shape)).square().sum(axes),
                                 group) / count
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        y = ((xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
             * self.weight.float().view(shape) + self.bias.float().view(shape))
        return y.to(x.dtype)
