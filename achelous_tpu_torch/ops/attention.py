"""Attention with a relative-position bias and talking heads (counterpart of
achelous_tpu/ops/pallas_attention.py `reference_bias_attention`).

`reference_bias_attention` is the plain PyTorch version of K3, the CPU
path and the oracle of the CUDA kernel in ops/hopper_attention.py.

The head mixes are the reference's 1x1 convs over the head axis, held as
their weights [g_out, h_in]: out_g = sum_h w[g, h] * a_h + b[g].  (The JAX
package holds the transpose, [h_in, g_out].)
"""
from __future__ import annotations

import torch


def reference_bias_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             th1_w: torch.Tensor, th1_b: torch.Tensor,
                             th2_w: torch.Tensor, th2_b: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """q, k [B,h,N,dk]; v [B,h,N,dv]; bias [h,N,N]; th*_w [h,h] as
    [g_out, h_in]; th*_b [h].  Computes in float32: q.k^T * scale + bias,
    head mix th1, softmax over the keys, head mix th2, then @ v.  Returns
    [B,h,N,dv] in q's dtype."""
    a = torch.einsum("bhnc,bhmc->bhnm", q.float(), k.float()) * scale \
        + bias.float()
    a = torch.einsum("bhnm,gh->bgnm", a, th1_w.float()) \
        + th1_b.float()[None, :, None, None]
    a = a.softmax(dim=-1)
    a = torch.einsum("bhnm,gh->bgnm", a, th2_w.float()) \
        + th2_b.float()[None, :, None, None]
    return torch.einsum("bhnm,bhmc->bhnc", a, v.float()).to(q.dtype)
