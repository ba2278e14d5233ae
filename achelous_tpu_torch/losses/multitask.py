"""Multi-task weighting: homoscedastic uncertainty and gradient surgery
(counterpart of achelous_tpu/losses/multitask.py).

`log_vars` are persistent trainable parameters, with the Kendall
regulariser `+ s_i / 2`.  MGDA and CAGrad solve their small simplex
problems over the task-gradient Gram matrix by Frank-Wolfe with a fixed
number of iterations (250 and 200), exactly as the JAX package does; ties
in the Frank-Wolfe vertex and the line-search candidates go to the lowest
index (`torch.argmin` returns the first minimum, as `jnp.argmin` does).
The solvers' loops run on the CPU on the [T, T] Gram matrix (a few
hundred tiny steps, which on the card would cost a launch each); the
[T, P] products stay on the gradients' device.

One deliberate difference: CAGrad's solve runs in float64.  Its line
search squares and cubes Gram entries, and with raw task gradients whose
norms reach 1e5 (the point-cloud task at initialisation) those overflow
float32, where the JAX package's solve returns NaN and the step is
skipped.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def uncertainty_weighted(losses: Sequence[torch.Tensor],
                         log_vars: torch.Tensor,
                         regularize: bool = True) -> torch.Tensor:
    """sum_i exp(-s_i) * L_i (+ s_i / 2)."""
    stacked = torch.stack(list(losses))
    total = (torch.exp(-log_vars) * stacked).sum()
    if regularize:
        total = total + 0.5 * log_vars.sum()
    return total


def _vertex(scores: torch.Tensor) -> torch.Tensor:
    """One-hot of the first minimum."""
    return torch.nn.functional.one_hot(scores.argmin(), scores.shape[0]).to(
        scores.dtype)


def minnorm_weights(gram: torch.Tensor, iters: int = 250) -> torch.Tensor:
    """Min-norm point of the convex hull of the task gradients: min w^T G w
    over the simplex, Frank-Wolfe with exact line search."""
    t = gram.shape[0]
    gram = gram.float()
    w = torch.full((t,), 1.0 / t, dtype=torch.float32, device=gram.device)
    for _ in range(iters):
        gw = gram @ w
        d = _vertex(gw) - w
        dgd = d @ gram @ d
        gamma = (-(d @ gw) / dgd.clamp_min(1e-12)).clamp(0.0, 1.0)
        w = w + gamma * d
    return w


def mgda_combine(task_grads: torch.Tensor, normalization: str = "l2",
                 losses: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MGDA's combined gradient from flat task gradients [T, P], each
    normalised first ('l2', 'loss', 'loss+' or 'none')."""
    if normalization == "l2":
        gn = task_grads.norm(dim=1)
    elif normalization == "loss":
        gn = losses
    elif normalization == "loss+":
        gn = losses * task_grads.norm(dim=1)
    else:
        gn = torch.ones(task_grads.shape[0], dtype=task_grads.dtype,
                        device=task_grads.device)
    g = task_grads / gn.clamp_min(1e-12)[:, None]
    return minnorm_weights((g @ g.T).cpu()).to(g.device) @ g


def cagrad_combine(task_grads: torch.Tensor, c: float = 0.4,
                   rescale: int = 1, iters: int = 200) -> torch.Tensor:
    """Conflict-averse gradient: Frank-Wolfe on F(w) = w^T A b + cc ||g_w||
    over the simplex (A the Gram matrix, b uniform weights, cc = c ||g0||),
    whose line search is the closed-form roots of a quadratic."""
    t = task_grads.shape[0]
    a_mat = (task_grads @ task_grads.T).cpu().double()
    g0_norm = torch.sqrt(a_mat.mean().clamp_min(0.0) + 1e-8)
    cc = c * g0_norm + 1e-8
    b = a_mat.mean(1)
    eps = 1e-8

    def objective(w):
        return w @ b + cc * torch.sqrt((w @ a_mat @ w).clamp_min(0.0) + eps)

    w = torch.full((t,), 1.0 / t, dtype=torch.float64)
    for _ in range(iters):
        aw = a_mat @ w
        waw = (w @ aw).clamp_min(0.0) + eps
        d = _vertex(b + cc * aw / torch.sqrt(waw)) - w
        beta = d @ b
        wad = d @ aw
        dad = (d @ a_mat @ d).clamp_min(1e-12)
        # dF/dgamma = 0: beta^2 (wAw + 2g wAd + g^2 dAd) = cc^2 (wAd + g dAd)^2
        qa = beta ** 2 * dad - cc ** 2 * dad ** 2
        qb = 2.0 * (beta ** 2 * wad - cc ** 2 * wad * dad)
        qc = beta ** 2 * waw - cc ** 2 * wad ** 2
        disc = torch.sqrt((qb ** 2 - 4.0 * qa * qc).clamp_min(0.0))
        denom = torch.where(qa.abs() > 1e-20, 2.0 * qa, torch.ones_like(qa))
        r1 = ((-qb + disc) / denom).clamp(0.0, 1.0)
        r2 = ((-qb - disc) / denom).clamp(0.0, 1.0)
        cands = torch.stack([torch.zeros_like(r1), torch.ones_like(r1),
                             r1, r2])
        vals = torch.stack([objective(w + g * d) for g in cands])
        w = w + cands[vals.argmin()] * d
    gw = w.to(task_grads) @ task_grads
    lmbda = cc.to(gw) / (gw.norm() + 1e-8)
    g = task_grads.mean(0) + lmbda * gw
    if rescale == 0:
        return g
    if rescale == 1:
        return g / (1.0 + c ** 2)
    return g / (1.0 + c)
