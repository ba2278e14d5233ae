"""What each rank runs in the port's distributed CPU tests
(test_torch_port_distributed.py, test_torch_port_distributed_fit.py) and
the launcher that starts it: `run_ranks` spawns fn(rank, world, ...) in
`world` processes of one process group, so this module imports torch,
numpy and the port only (no JAX), and every result is numpy or plain
Python.

The global batch is rank 0's rows, then rank 1's (`rows`), as the JAX
package assembles it from its processes' rows.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from datetime import timedelta
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.synthetic import synthetic_batch
from achelous_tpu_torch.entry import perturb_deform_convs
from achelous_tpu_torch.losses import detection as tdet
from achelous_tpu_torch.losses import segmentation as tseg
from achelous_tpu_torch.models.achelous import create_model
from achelous_tpu_torch.ops.norm import BatchNorm
from achelous_tpu_torch.parallel.dist import batch_group
from achelous_tpu_torch.train import train_state as tts

THREADS = 2
STEP_RES, STEP_BATCH, STEP_MAX_GT, STEP_LR = 64, 8, 8, 0.01
# per-sample point-cloud scales (test_torch_port_train.py's): PointNet's
# fully connected BatchNorms over a micro-batch of 4 stay well conditioned
PC_SCALES = np.array([1.0, 3.0, 0.5, 2.0, 1.5, 0.7, 2.5, 1.2], np.float32)
STEP_CASES = {"sum": ("sum", 1), "uncertainty": ("uncertainty", 1),
              "cagrad": ("cagrad", 1), "accum2": ("sum", 2)}


def _rank_main(rank, world, tmp, backend, fn, args):
    dist.init_process_group(backend,
                            init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(minutes=10))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo"
              ) -> list:
    """fn(rank, world, *args) in `world` spawned processes joined in one
    process group of `backend` (a file rendezvous in a temporary
    directory); each rank's result, in rank order, through a file a rank.
    `fn` is a module-level function, and `args` and the results are
    pickled, so they hold no CUDA tensors.  A rank that raises ends the
    others, and `torch.multiprocessing.spawn` raises its error here."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main,
                                    args=(world, tmp, backend, fn, args),
                                    nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"r{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def rows(n: int, rank: int, world: int) -> slice:
    """This rank's rows of a global batch of n."""
    lb = n // world
    return slice(rank * lb, (rank + 1) * lb)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def to_numpy(tree):
    """Tensors of a nested dict / list as numpy arrays (results travel
    pickled by value)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# BatchNorm and the losses
# ---------------------------------------------------------------------------


def layout_batch() -> dict[str, np.ndarray]:
    """A global batch of 8 rows in three dtypes (`gather_rows` moves
    bytes)."""
    return {"f": np.arange(48, dtype=np.float32).reshape(8, 2, 3),
            "i": np.arange(8, dtype=np.int64) * 7,
            "b": np.arange(8) % 3 == 0}


def batchnorm_rank(rank, world, cases):
    """Each case: the port's training BatchNorm on this rank's rows of x
    under the group; its output, running statistics and the gradients of
    sum(y * cotangent) over this rank's rows.  Then `broadcast_` of rank
    0's weights into a RadarConv whose K1 weight pack is cached: its
    output before and after (the pack must not be stale); and
    `layout_batch()`'s rows gathered from the ranks and laid out for two
    micro-batches (`jax_micro_layout`)."""
    from achelous_tpu_torch.ops.deform import DeformableConv2d
    from achelous_tpu_torch.parallel.dist import broadcast_, gather_rows
    torch.set_num_threads(THREADS)
    torch.manual_seed(rank)
    conv = DeformableConv2d(3, 3, band=4).eval()
    for p in conv.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 3, 8, 8)
                         .astype(np.float32))
    with torch.no_grad():
        before = conv(x).numpy()
        broadcast_(list(conv.parameters()), dist.group.WORLD)
        after = conv(x).numpy()
    glob = layout_batch()
    mine = {k: t(v[rows(len(v), rank, world)]) for k, v in glob.items()}
    out = [{"conv_before": before, "conv_after": after,
            "gathered": to_numpy(gather_rows(mine, dist.group.WORLD)),
            "layout": to_numpy(tts.jax_micro_layout(mine, dist.group.WORLD,
                                                    2))}]
    for x, params, momentum, ct in cases:
        sl = rows(len(x), rank, world)
        bn = BatchNorm(x.shape[1], momentum=momentum).train()
        bn.load_state_dict({k: t(v) for k, v in params.items()})
        xl = t(x[sl]).requires_grad_(True)
        with batch_group(dist.group.WORLD):
            y = bn(xl)
        (y * t(ct[sl])).sum().backward()
        out.append({"y": y.detach().numpy(), "x_grad": xl.grad.numpy(),
                    "w_grad": bn.weight.grad.numpy(),
                    "b_grad": bn.bias.grad.numpy(),
                    "mean": bn.running_mean.numpy(),
                    "var": bn.running_var.numpy()})
    return out


def losses_rank(rank, world, det_cases, seg):
    """The losses on this rank's rows under the group: each value (the
    global batch's) and its gradient w.r.t. this rank's inputs."""
    torch.set_num_threads(THREADS)
    out = {}
    group = dist.group.WORLD
    for kind, (maps, boxes, classes, mask) in det_cases.items():
        sl = rows(len(boxes), rank, world)
        pm = [t(m[sl]).requires_grad_(True) for m in maps]
        with batch_group(group):
            loss = tdet.YoloXLoss(7)(pm, t(boxes[sl]), t(classes[sl]),
                                     t(mask[sl]))
        loss.backward()
        out[f"det/{kind}"] = (float(loss), [p.grad.numpy() for p in pm])
    n_cls = seg["n_cls"]
    sl = rows(len(seg["logits"]), rank, world)
    fns = {
        "ce": lambda lg: tseg.ce_loss(lg, t(seg["labels"][sl]), None, n_cls),
        "ce_weighted": lambda lg: tseg.ce_loss(
            lg, t(seg["labels"][sl]), t(seg["weights"]), n_cls),
        "focal": lambda lg: tseg.focal_loss(lg, t(seg["labels"][sl]), None,
                                            n_cls),
        "dice": lambda lg: tseg.dice_loss(lg, t(seg["onehot"][sl]))}
    for name, fn in fns.items():
        lg = t(seg["logits"][sl]).requires_grad_(True)
        with batch_group(group):
            loss = fn(lg)
        loss.backward()
        out[name] = (float(loss), [lg.grad.numpy()])
    lp = t(seg["logp"][sl]).requires_grad_(True)
    with batch_group(group):
        loss = tseg.pc_nll_loss(lp, t(seg["pc_labels"][sl]))
    loss.backward()
    out["pc_nll"] = (float(loss), [lp.grad.numpy()])
    return out


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------


def step_setup(mtl: str, accum: int):
    """EN-GDF-PN-S0 at 64^2, float32, offset convs drawn: (cfg, tcfg,
    state, the global batch in rank order)."""
    cfg = AchelousConfig(resolution=STEP_RES)
    tcfg = tts.TrainConfig(max_gt=STEP_MAX_GT, mtl=mtl, grad_accum=accum)
    model = create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                         train=True)
    perturb_deform_convs(model)
    batch = synthetic_batch(cfg, STEP_BATCH, STEP_MAX_GT, seed=5,
                            device="cpu")
    batch["pc"] = batch["pc"] * t(PC_SCALES)[:, None, None]
    return cfg, tcfg, tts.create_train_state(model, cfg, tcfg), batch


def state_arrays(state) -> dict[str, np.ndarray]:
    """The state's tensors by kind, as test_torch_port_train.py's
    `update_errors` reads them: parameters and log_vars ("param/"),
    BatchNorm statistics ("stat/"), the EMA ("ema/"); and the momentum
    trace ("trace/")."""
    def a(v):
        return v.detach().numpy().copy()
    out = {f"param/{n}": a(p) for n, p in state.model.named_parameters()}
    out.update({f"stat/{n}": a(v) for n, v in state.batch_stats().items()})
    out.update({f"ema/{n}": a(v) for n, v in
                {**state.ema_params, **state.ema_batch_stats}.items()})
    out["param/log_vars"] = a(state.log_vars)
    out.update({f"trace/{n}": a(v)
                for n, v in state.opt_state["trace"].items()})
    return out


def step_rank(rank, world, names):
    """One step of each STEP_CASES entry in `names` on this rank's rows:
    (metrics, the state's tensors after the step)."""
    torch.set_num_threads(THREADS)
    out = {}
    for name in names:
        cfg, tcfg, state, batch = step_setup(*STEP_CASES[name])
        sl = rows(STEP_BATCH, rank, world)
        step = tts.make_train_step(cfg, tcfg, dist.group.WORLD)
        state, m = step(state, {k: v[sl] for k, v in batch.items()},
                        STEP_LR)
        out[name] = ({k: float(v) for k, v in m.items()},
                     state_arrays(state))
    return out


def assert_state_gate(before, got, want, spread=None):
    """Each tensor's change over the run within the bound of
    test_torch_port_train.py's `update_errors` around the single process's
    change: 5e-2 of the tensor's own largest change plus 1e-3 of the RMS
    change of its kind (parameters with log_vars, BatchNorm statistics,
    EMA, momentum trace), plus twice `spread[name]` where given.  Returns
    the largest difference as a share of its bound."""
    assert set(got) == set(want)
    errs = {}
    for kind in ("param/", "stat/", "ema/", "trace/"):
        keys = [k for k in want if k.startswith(kind)]
        rms = np.sqrt(np.mean(np.concatenate(
            [np.square(want[k] - before[k]).ravel() for k in keys])))
        for k in keys:
            dw, dg = want[k] - before[k], got[k] - before[k]
            errs[k] = (np.abs(dg - dw).max(),
                       5e-2 * np.abs(dw).max() + 1e-3 * rms
                       + (2 * spread[k] if spread else 0.0))
    bad = {k: e for k, e in errs.items() if e[0] > e[1]}
    assert not bad, sorted(bad.items())[:10]
    assert max(np.abs(want[k] - before[k]).max() for k in want) > 0
    return max(e[0] / e[1] for e in errs.values())


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

FIT = dict(res=64, points=64, batch=4, epochs=2, max_gt=8, lr=0.01)


def fit_setup(tree):
    from achelous_tpu_torch.data.waterscenes import (WaterScenesDataset,
                                                     WaterScenesPaths)
    from achelous_tpu_torch.train.train_state import TrainConfig
    cfg = AchelousConfig(resolution=FIT["res"], pc_points=FIT["points"])
    tcfg = TrainConfig(batch_size=FIT["batch"], epochs=FIT["epochs"],
                       max_gt=FIT["max_gt"], lr_init=FIT["lr"])
    return (cfg, tcfg,
            WaterScenesDataset(cfg, WaterScenesPaths.under(tree)),
            WaterScenesDataset(cfg, WaterScenesPaths.under(tree, "val.txt")))


def recorded_fit(log_dir, tree, state=None, group=None):
    """`fit` with every batch its training and validation loops drew
    recorded, in order: (state, [(kind, [batches])] an epoch, progress
    messages)."""
    from achelous_tpu_torch.train import loop
    cfg, tcfg, train_ds, val_ds = fit_setup(tree)
    real = loop.batches_from
    calls = []

    def recording(dataset, *a, **kw):
        if not kw.get("drop_last", True):       # the online evaluation
            yield from real(dataset, *a, **kw)
            return
        kind = "train" if dataset is train_ds else "val"
        got = []
        calls.append((kind, got))
        for b in real(dataset, *a, **kw):
            got.append(b)
            yield b

    msgs = []
    loop.batches_from = recording
    try:
        state = loop.fit(cfg, tcfg, train_ds, val_ds, log_dir=log_dir,
                         eval_period=1, save_period=1, state=state,
                         device="cpu", progress=msgs.append, group=group)
    finally:
        loop.batches_from = real
    return state, calls, msgs


def fit_rank(rank, world, root, tree):
    """The 2-epoch run into <root>/full/r<rank>: its final state, recorded
    batches and data_rng."""
    torch.set_num_threads(THREADS)
    state, calls, msgs = recorded_fit(f"{root}/full/r{rank}", tree,
                                      group=dist.group.WORLD)
    return {"state": state_arrays(state), "calls": calls, "msgs": msgs,
            "counters": (state.step, state.epoch, state.ema_updates),
            "data_rng": to_numpy(state.data_rng)}


def resume_rank(rank, world, root, tree):
    """A new process per rank: rank 0's epoch-1 checkpoint of the 2-epoch
    run restored on every rank, then `fit` to the end."""
    from achelous_tpu_torch.train.checkpoints import CheckpointManager
    torch.set_num_threads(THREADS)
    cfg, tcfg, _, _ = fit_setup(tree)
    state = tts.create_train_state(
        create_model(cfg, "cpu", torch.Generator().manual_seed(0),
                     train=True), cfg, tcfg)
    ckpt = CheckpointManager(f"{root}/full/r0/ckpt")
    state = ckpt.restore(ckpt.periodic()[0], state)
    if state.epoch != 1:
        raise AssertionError(f"checkpoint at epoch {state.epoch}")
    state, _, msgs = recorded_fit(f"{root}/resume/r{rank}", tree,
                                  state=state, group=dist.group.WORLD)
    return {"state": state_arrays(state), "msgs": msgs,
            "counters": (state.step, state.epoch, state.ema_updates)}
