"""Train state and the multi-task train step (counterpart of
achelous_tpu/train/train_state.py; reference utils/utils_fit.py:15-203).

One step: the 4-task forward in `cfg.dtype` on float32 parameters
(`models.achelous.forward_compute`), the losses (SimOTA YOLOX detection,
focal/CE + dice for both segmentations, NLL for the points), their sum or
uncertainty weighting (or MGDA / CAGrad surgery on the 4 task gradients),
gradients, SGD-Nesterov (or Adam) with coupled weight decay, EMA.
BatchNorm statistics are the batch's (ops/norm.py).  The JAX package's
deliberate fixes to the reference are kept: `log_vars` are persistent
trainable parameters, the point-cloud NLL reads the log-probabilities
once, and every parameter (layer scales, temperatures) is trained.

The optimizer follows optax's chain as the JAX package builds it:
`add_decayed_weights(wd, mask)` then `sgd(lr=1, momentum, nesterov)` (the
trace t <- g + m t, the update g + m t), the learning rate applied after
it; Adam is `scale_by_adam(b1=momentum, b2=0.999)`.  The decay mask is
"the JAX counterpart of the parameter has rank >= 2": torch's rank, save
for the parameters that flax keeps as vectors (kind "vector" in
`core/init.flax_kinds`), which torch shapes [1,C,1,1] or [C,1,1], and
those it stacks over a scan's layers (kind "stacked"), all of rank >= 2.

A step whose loss or global gradient norm is not finite changes nothing
(parameters, optimizer state, BatchNorm statistics, EMA) but the step
counter.  With `freeze_backbone` the update of the vision backbone
(`image_radar_encoder.fpn.backbone.*`, flax's `backbone`) is multiplied
by 0; its momentum trace still moves, as in optax.

Across ranks (`make_train_step(..., group=...)`): each rank holds a
replica of the state and its rows of the global batch, and the step is
the single-process step on that global batch, as the JAX package computes
it on a batch-sharded mesh.  BatchNorm and the losses take their
statistics and sums over the group (`parallel.dist.batch_group`); every
rank computes the global losses, so autograd gives each the gradient of W
times the loss w.r.t. its own rows, and the mean of the ranks' gradients
(one flat all-reduce) is the global gradient.  MGDA and CAGrad solve on
each task's gradient so averaged.  With `grad_accum`, micro-batch m is
the global batch's m-th slice, as in the JAX package's scan: the ranks
exchange rows first (`jax_micro_layout`), and its BatchNorm statistics
are taken across the ranks.  grad_norm, the metrics and the non-finite
decision are computed from all-reduced values, the same on every rank,
so every rank takes the same step and the EMA moves alike everywhere.

The step's phases are named for torch.profiler (`train_step/forward`,
`/losses`, `/backward`, `/update`; `trace_training.py` reads them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.core.init import flax_kinds, weights_init
from achelous_tpu_torch.losses.detection import YoloXLoss
from achelous_tpu_torch.losses.multitask import (cagrad_combine, mgda_combine,
                                                 uncertainty_weighted)
from achelous_tpu_torch.losses.segmentation import (ce_loss, dice_loss,
                                                    focal_loss, pc_nll_loss)
from achelous_tpu_torch.models.achelous import Achelous, forward_compute
from achelous_tpu_torch.parallel import dist as pdist
from achelous_tpu_torch.train.ema import ema_update

BACKBONE = "image_radar_encoder.fpn.backbone."
METRICS = ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc")
ADAM_B2, ADAM_EPS = 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference train.py flags (train.py:35-57), with the JAX
    package's defaults; see achelous_tpu/train/train_state.py for each.
    `fit` passes the backbone freeze to the step while epoch <
    freeze_epochs; `create_train_state` re-draws the weights by
    `init_type` (None keeps the flax default initialisation)."""
    batch_size: int = 32
    epochs: int = 100
    lr_init: float = 0.03
    lr_decay: str = "cos"            # cos | step
    optimizer: str = "sgd"           # sgd | adam
    momentum: float = 0.937
    weight_decay: float = 5e-4
    focal: bool = True
    dice: bool = True
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    max_gt: int = 50                 # GT padding of the batches
    mtl: str = "sum"                 # sum | uncertainty | mgda | cagrad
    freeze_epochs: int = 0           # backbone frozen for these epochs
    init_type: Optional[str] = None  # core/init.INIT_TYPES, or None
    init_gain: float = 0.02
    grad_accum: int = 1              # micro-batches a step, one update


@dataclasses.dataclass
class TrainState:
    """What one step reads and writes.  `model` holds the float32
    parameters and the BatchNorm statistics (its buffers); `opt_state`
    holds, per trainable name (the model's parameter names and
    "log_vars"), the SGD momentum trace (`{"trace": ...}`) or Adam's
    moments (`{"mu": ..., "nu": ..., "count": n}`).  `data_rng` holds the
    host generators' states at the end of the last epoch `fit` ran (its
    shuffle and each dataset's), so a resumed run draws what an
    uninterrupted one would."""
    step: int
    epoch: int
    model: Achelous
    log_vars: torch.Tensor
    opt_state: dict
    ema_params: dict
    ema_batch_stats: dict
    ema_updates: int
    data_rng: dict = dataclasses.field(default_factory=dict)

    def trainable(self) -> dict[str, torch.Tensor]:
        out = dict(self.model.named_parameters())
        out["log_vars"] = self.log_vars
        return out

    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The model's persistent buffers (BatchNorm running statistics)."""
        params = {n for n, _ in self.model.named_parameters()}
        return {n: t for n, t in
                self.model.state_dict(keep_vars=True).items()
                if n not in params}


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor of the state: parameters, BatchNorm statistics,
    log_vars, optimizer state, EMA (what `fit` broadcasts from rank 0)."""
    out = list(state.model.state_dict(keep_vars=True).values())
    out.append(state.log_vars)
    for tree in (*state.opt_state.values(), state.ema_params,
                 state.ema_batch_stats):
        if isinstance(tree, dict):
            out.extend(tree.values())
    return out


def decay_mask(model: nn.Module) -> set[str]:
    """Names of the parameters that take weight decay: those whose JAX
    counterpart has rank >= 2 (conv and dense kernels, XCA temperatures,
    and every parameter JAX's scan stacks: MobileViT's transformer norms
    and biases too), not other norms, biases or flax-flat vectors."""
    kinds = flax_kinds(model)
    return {n for n, p in model.named_parameters()
            if kinds.get(n) == "stacked"
            or p.ndim >= 2 and kinds.get(n) != "vector"}


def create_train_state(model: Achelous, cfg: AchelousConfig,
                       tcfg: TrainConfig, seed: int = 0) -> TrainState:
    """A fresh state around a training-form model
    (`create_model(..., train=True)`): its weights re-drawn by
    `tcfg.init_type` if set (`core/init.weights_init`, from `seed`), zero
    optimizer state and log_vars, the EMA at the model's values."""
    if tcfg.init_type is not None:
        weights_init(model, tcfg.init_type, tcfg.init_gain,
                     torch.Generator().manual_seed(seed))
    dev = next(model.parameters()).device
    log_vars = torch.zeros(3, dtype=torch.float32, device=dev,
                           requires_grad=True)
    state = TrainState(step=0, epoch=0, model=model, log_vars=log_vars,
                       opt_state={}, ema_params={}, ema_batch_stats={},
                       ema_updates=0)
    zeros = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
             for n, p in state.trainable().items()}
    if tcfg.optimizer == "sgd":
        state.opt_state = {"trace": zeros}
    else:
        state.opt_state = {"mu": zeros,
                           "nu": {n: torch.zeros_like(t)
                                  for n, t in zeros.items()},
                           "count": 0}
    state.ema_params = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
    state.ema_batch_stats = {n: t.detach().clone()
                             for n, t in state.batch_stats().items()}
    return state


def compute_losses(cfg: AchelousConfig, tcfg: TrainConfig, det_loss_fn,
                   outputs, batch):
    """(loss_seg, loss_wl, loss_det, loss_pc) of the model's outputs."""
    det, sem, lane, pc = outputs
    loss_det = det_loss_fn(det, batch["gt_boxes"], batch["gt_classes"],
                           batch["gt_mask"])
    seg_fn = focal_loss if tcfg.focal else ce_loss
    loss_seg = seg_fn(sem, batch["seg_labels"], None, cfg.num_seg)
    loss_wl = seg_fn(lane, batch["wl_labels"], None, 2)
    if tcfg.dice:
        loss_seg = loss_seg + dice_loss(sem, batch["seg_onehot"])
        loss_wl = loss_wl + dice_loss(lane, batch["wl_onehot"])
    loss_pc = pc_nll_loss(pc, batch["pc_labels"])
    return loss_seg, loss_wl, loss_det, loss_pc


def _grads(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each parameter's .grad, zeros where it got none (as jax.grad)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.items()}


@torch.no_grad()
def _apply_update(tcfg: TrainConfig, state: TrainState,
                  params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], lr: float,
                  freeze_backbone: bool):
    """Optimizer state and parameters, in place."""
    decayed = decay_mask(state.model)
    names = list(params)
    g = [grads[n] + tcfg.weight_decay * params[n] if n in decayed
         else grads[n] for n in names]
    if tcfg.optimizer == "sgd":
        trace = [state.opt_state["trace"][n] for n in names]
        torch._foreach_mul_(trace, tcfg.momentum)
        torch._foreach_add_(trace, g)
        updates = torch._foreach_add(g, torch._foreach_mul(trace,
                                                           tcfg.momentum))
    else:
        b1, f32 = tcfg.momentum, np.float32
        mu = [state.opt_state["mu"][n] for n in names]
        nu = [state.opt_state["nu"][n] for n in names]
        state.opt_state["count"] += 1
        count = state.opt_state["count"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=float(f32(1.0) - f32(b1)))
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g),
                            alpha=float(f32(1.0) - f32(ADAM_B2)))
        mu_hat = torch._foreach_div(mu, float(f32(1) - f32(b1) ** count))
        nu_hat = torch._foreach_div(nu, float(f32(1) - f32(ADAM_B2) ** count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
    for n, u in zip(names, updates):
        if not (freeze_backbone and n.startswith(BACKBONE)):
            params[n].add_(u, alpha=-lr)


def jax_micro_layout(batch: dict, group, accum: int) -> dict:
    """This rank's rows for `accum` micro-batches as the JAX package's scan
    takes them from the global batch B (rank 0's rows, then rank 1's,
    ...): micro-batch m is the global rows [m * B / a, (m + 1) * B / a),
    and rank r's m-th slice becomes the r-th of W equal parts of it.  The
    rows cross ranks (`pdist.gather_rows`)."""
    full = pdist.gather_rows(batch, group)
    w, r = pdist.world_size(group), pdist.rank(group)
    mb = next(iter(full.values())).shape[0] // accum
    share = mb // w
    idx = torch.cat([torch.arange(m * mb + r * share,
                                  m * mb + (r + 1) * share)
                     for m in range(accum)])
    return {k: v[idx.to(v.device)] for k, v in full.items()}


def make_train_step(cfg: AchelousConfig, tcfg: TrainConfig, group=None
                    ) -> Callable[..., tuple[TrainState, dict]]:
    """train_step(state, batch, lr, freeze_backbone=False) ->
    (state, metrics), the state updated in place.  With a process `group`
    of more than one rank, `batch` is this rank's rows of the global batch
    and the step is the global batch's (module docstring).

    batch (data/synthetic.py's layout): image [B,3,R,R], radar [B,3,R,R],
    pc [B,N,C], gt_boxes [B,G,4], gt_classes [B,G], gt_mask [B,G],
    seg_labels [B,R,R], seg_onehot [B,R,R,num_seg+1], wl_labels [B,R,R],
    wl_onehot [B,R,R,3], pc_labels [B,N].  metrics: loss, loss_det,
    loss_seg, loss_wl, loss_pc, grad_norm (0-d float32 tensors), lr and
    skipped_nonfinite (floats)."""
    det_loss_fn = YoloXLoss(cfg.num_det)
    if tcfg.mtl in ("mgda", "cagrad") and tcfg.grad_accum > 1:
        raise NotImplementedError(
            "grad_accum needs per-micro-batch task gradients under "
            "mgda/cagrad; use mtl=sum or uncertainty")

    def losses(state, batch):
        with record_function("train_step/forward"):
            outputs = forward_compute(state.model, batch["image"],
                                      batch["radar"], batch["pc"])
        with record_function("train_step/losses"):
            return compute_losses(cfg, tcfg, det_loss_fn, outputs, batch)

    def total_and_metrics(state, batch):
        ls, lw, ld, lp = losses(state, batch)
        if tcfg.mtl == "uncertainty":
            total = uncertainty_weighted([ls, lw, ld], state.log_vars) + lp
        else:
            total = ls + lw + ld + lp
        return total, {"loss": total, "loss_det": ld, "loss_seg": ls,
                       "loss_wl": lw, "loss_pc": lp}

    def accum_grads(state, params, batch):
        """Mean gradient and metrics over `grad_accum` micro-batches, the
        BatchNorm statistics moving with each in turn."""
        a = tcfg.grad_accum
        b = batch["image"].shape[0]
        if b % a:
            raise ValueError(f"batch size {b} not divisible by "
                             f"grad_accum {a}")
        if a > 1 and pdist.current_group() is not None:
            batch = jax_micro_layout(batch, group, a)
        sums = {k: torch.zeros((), dtype=torch.float32,
                               device=state.log_vars.device) for k in METRICS}
        for i in range(a):
            micro = {k: v[i * (b // a):(i + 1) * (b // a)]
                     for k, v in batch.items()}
            total, m = total_and_metrics(state, micro)
            with record_function("train_step/backward"):
                total.backward()
            for k in METRICS:
                sums[k] += m[k].detach().float()
        grads = _grads(params)
        if a == 1:
            return grads, sums
        inv = float(np.float32(1.0 / a))
        return ({n: g * inv for n, g in grads.items()},
                {k: v * inv for k, v in sums.items()})

    def surgery_grads(state, params, batch):
        """MGDA / CAGrad: one forward, four pullbacks, the flat task
        gradients combined; log_vars get none."""
        ls, lw, ld, lp = losses(state, batch)
        model_params = [p for n, p in params.items() if n != "log_vars"]
        rows = []
        for loss in (ls, lw, ld, lp):
            with record_function("train_step/backward"):
                gs = torch.autograd.grad(loss, model_params,
                                         retain_graph=True, allow_unused=True)
            rows.append(torch.cat([
                (torch.zeros_like(p) if g is None else g).reshape(-1)
                for p, g in zip(model_params, gs)]))
        task_grads = torch.stack(rows)
        if pdist.current_group() is not None:
            with record_function("train_step/all_reduce"):
                pdist.average_([task_grads], group)
        if tcfg.mtl == "mgda":
            combined = mgda_combine(task_grads, "l2",
                                    torch.stack([ls, lw, ld, lp]).detach())
        else:
            combined = cagrad_combine(task_grads)
        grads, at = {}, 0
        for n, p in params.items():
            if n == "log_vars":
                grads[n] = torch.zeros_like(p)
                continue
            grads[n] = combined[at:at + p.numel()].view_as(p)
            at += p.numel()
        metrics = {"loss": (ls + lw + ld + lp).detach(), "loss_det": ld,
                   "loss_seg": ls, "loss_wl": lw, "loss_pc": lp}
        return grads, {k: v.detach().float() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict, lr: float,
                   freeze_backbone: bool = False):
        params = state.trainable()
        for p in params.values():
            p.grad = None
        stats = state.batch_stats()
        before = {n: t.detach().clone() for n, t in stats.items()}
        with pdist.batch_group(group):
            if tcfg.mtl in ("mgda", "cagrad"):
                grads, metrics = surgery_grads(state, params, batch)
            else:
                grads, metrics = accum_grads(state, params, batch)
                if pdist.current_group() is not None:
                    with record_function("train_step/all_reduce"):
                        pdist.average_(grads.values(), group)
        grad_norm = torch.sqrt(sum(
            g.float().square().sum() for g in grads.values()))
        step_ok = bool(torch.isfinite(metrics["loss"])
                       & torch.isfinite(grad_norm))
        if step_ok:
            with record_function("train_step/update"):
                _apply_update(tcfg, state, params, grads, lr,
                              freeze_backbone)
                state.ema_updates += 1
                ema_update(state.ema_params,
                           {n: p.detach() for n, p in params.items()
                            if n != "log_vars"},
                           state.ema_updates, tcfg.ema_decay, tcfg.ema_tau)
                ema_update(state.ema_batch_stats, stats, state.ema_updates,
                           tcfg.ema_decay, tcfg.ema_tau)
        else:
            with torch.no_grad():
                for n, t in stats.items():
                    t.copy_(before[n])
        for p in params.values():
            p.grad = None
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = float(lr)
        metrics["grad_norm"] = grad_norm.detach()
        metrics["skipped_nonfinite"] = 0.0 if step_ok else 1.0
        return state, metrics

    return train_step


def make_eval_step(cfg: AchelousConfig, tcfg: TrainConfig, group=None):
    """eval_step(state, batch) -> the validation losses, BatchNorm on its
    running statistics (reference utils_fit.py:216-309); with a process
    `group`, the losses of the global batch whose rows `batch` holds."""
    det_loss_fn = YoloXLoss(cfg.num_det)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            outputs = forward_compute(model, batch["image"], batch["radar"],
                                      batch["pc"])
        finally:
            model.train(was_training)
        with pdist.batch_group(group):
            ls, lw, ld, lp = compute_losses(cfg, tcfg, det_loss_fn, outputs,
                                            batch)
        return {"loss": ls + lw + ld + lp, "loss_det": ld, "loss_seg": ls,
                "loss_wl": lw, "loss_pc": lp}

    return eval_step
