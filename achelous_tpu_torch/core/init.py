"""Parameter initialisation that follows the JAX package's flax defaults.

flax `nn.Conv` / `nn.Dense` kernels are lecun-normal (a normal truncated at
two standard deviations, variance 1/fan_in) with zero biases; norms start
at ones/zeros with running statistics 0/1.  Modules whose flax parameters
start elsewhere (zero offset/modulator convs, layer scales, attention
temperatures) set those values when they are built, and `init_params`
leaves any module that defines `zero_init_` to zero itself afterwards.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated at +-2, which lecun_normal divides out
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal()` for a torch weight whose dim 0 is `out`."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv/linear weight from `generator` in module order."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for m in model.modules():
        if hasattr(m, "zero_init_"):
            m.zero_init_()
    return model
