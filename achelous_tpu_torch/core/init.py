"""Parameter initialisation (counterpart of achelous_tpu/core/init.py and
of the flax defaults the JAX package builds its parameters with).

flax `nn.Conv` / `nn.Dense` kernels are lecun-normal (a normal truncated at
two standard deviations, variance 1/fan_in) with zero biases; norms start
at ones/zeros with running statistics 0/1.  Modules whose flax parameters
start elsewhere (zero offset/modulator convs, layer scales, attention
temperatures) set those values when they are built, and `init_params`
leaves any module that defines `zero_init_` to zero itself afterwards.

`weights_init` is the reference's `weights_init` (loss/detection_loss.py:
466-485) as the JAX package applies it: every tensor whose flax
counterpart is a conv kernel of rank >= 3 is re-drawn by one of four
schemes with one gain, and every BatchNorm's scale is drawn from
N(1, 0.02) and its bias set to 0.

Where a parameter's flax counterpart is of another kind than torch's
layout says, the module above it names that kind in `FLAX_KIND`, keyed by
the parameter's or a child module's name ("" for everything beneath the
module): "vector" (a rank-1 leaf that torch shapes [1,C,1,1] or [C,1,1]),
"dense" (an `nn.Dense` kernel held by a torch `Conv1d` / `Conv2d`) or
"param" (a plain parameter held by a torch conv or linear layer) or
"stacked" (a `ModuleList` of identical layers whose flax parameters are
one leaf each, stacked on a leading [depth] axis by `nn.scan`: MobileViT's
transformer).  `flax_kinds` reads them; weight decay
(train/train_state.py `decay_mask`) skips the vectors and takes every
stacked parameter (a stacked bias or norm is of rank 2 in flax), and
`weights_init` keeps the dense and plain weights and re-draws each stacked
`nn.Linear` weight as one slice of its flax kernel [depth, in, out], a
rank-3 leaf: fans over depth * in and out * depth, and `orthogonal`
orthogonalises the [depth * in, out] matrix across the stack.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from achelous_tpu_torch.ops.norm import BatchNorm

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")

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
    """Draw every conv/linear weight from `generator` in module order (and
    EdgeViT's depthwise ConvTranspose2d's, [C, 1, k, k]: its dim 0 is the
    input, but its fan-in, k * k, is its flax kernel's)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                          nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for m in model.modules():
        if hasattr(m, "zero_init_"):
            m.zero_init_()
    return model


def flax_kinds(model: nn.Module) -> dict[str, str]:
    """Parameter name -> its flax kind, for the parameters some module's
    `FLAX_KIND` names (the innermost such module decides)."""
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for mname, m in model.named_modules():
        for key, kind in getattr(m, "FLAX_KIND", {}).items():
            prefix = ".".join(p for p in (mname, key) if p)
            for n in names:
                if not prefix or n == prefix or n.startswith(prefix + "."):
                    out[n] = kind
    return out


def flax_conv_weights(model: nn.Module) -> list[str]:
    """Names of the weights whose flax counterpart is a kernel of rank >= 3
    (those `weights_init` re-draws: conv kernels and the stacked Dense
    kernels), in module order."""
    kinds = flax_kinds(model)
    out = []
    for name, m in model.named_modules():
        kind = kinds.get(f"{name}.weight")
        if (isinstance(m, (nn.Conv1d, nn.Conv2d)) and kind is None
                or isinstance(m, nn.Linear) and kind == "stacked"):
            out.append(f"{name}.weight")
    return out


def stacked_weights(model: nn.Module) -> list[list[str]]:
    """For each `nn.Linear` of a "stacked" layer list, the names of its
    weight in every layer, in layer order (one flax kernel each)."""
    out = []
    for mname, m in model.named_modules():
        for key, kind in getattr(m, "FLAX_KIND", {}).items():
            if kind != "stacked":
                continue
            layers = m.get_submodule(key)
            prefix = ".".join(p for p in (mname, key) if p)
            out += [[f"{prefix}.{t}.{sub}.weight" for t in range(len(layers))]
                    for sub, lin in layers[0].named_modules()
                    if isinstance(lin, nn.Linear)]
    return out


def _scheme(shape, init_type: str, gain: float,
            generator: torch.Generator) -> torch.Tensor:
    """One conv weight [out, in/groups, *k] drawn by the scheme; fans as
    torch's `_calculate_fan_in_and_fan_out` and the JAX package take them."""
    recep = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * recep, shape[0] * recep
    normal = torch.randn(shape, generator=generator)
    if init_type == "normal":
        return gain * normal
    if init_type == "xavier":
        return gain * math.sqrt(2.0 / (fan_in + fan_out)) * normal
    if init_type == "kaiming":
        return math.sqrt(2.0 / fan_in) * normal
    # orthogonal (torch's orthogonal_): rows or columns of the
    # [out, in * k] matrix orthonormal, whichever are fewer
    flat = normal.reshape(shape[0], -1)
    if flat.shape[0] < flat.shape[1]:
        flat = flat.t()
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    if shape[0] < fan_in:
        q = q.t()
    return gain * q.reshape(shape)


@torch.no_grad()
def weights_init(model: nn.Module, init_type: str = "normal",
                 init_gain: float = 0.02,
                 generator: torch.Generator | None = None) -> nn.Module:
    """Re-draw the model's conv weights (`flax_conv_weights`, the stacked
    Dense kernels a stack at a time) by `init_type` (normal: gain *
    N(0, 1); xavier: xavier-normal with gain; kaiming: kaiming-normal,
    fan_in, a = 0; orthogonal with gain) and every
    BatchNorm's scale from N(1, 0.02), its bias 0; in place, drawn on the
    CPU from `generator` (seed 0 when None)."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = dict(model.named_parameters())
    stack = {n: names for names in stacked_weights(model) for n in names}
    for name in flax_conv_weights(model):
        names = stack.get(name, [name])
        if name != names[0]:
            continue
        # one flax kernel, drawn as a torch weight with its stack's layers
        # last ([out, in, *k, depth]; depth 1 unless stacked, which
        # changes no fan and no draw): the fans and orthogonal's
        # [out, in * depth] matrix are flax's; layer t takes [..., t]
        ws = [params[n] for n in names]
        full = _scheme((*ws[0].shape, len(ws)), init_type, init_gain,
                       generator)
        for t, w in enumerate(ws):
            w.copy_(full[..., t])
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                    generator=generator))
            m.bias.zero_()
    return model
