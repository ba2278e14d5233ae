"""The training run: epoch loop, loss history, online evaluation
(counterpart of achelous_tpu/train/loop.py; reference train.py:637-703,
utils/utils_fit.py:15-381 and the four eval callbacks).

Host batches come from a `WaterScenesDataset` through `batches_from`
(numpy, channels-last, as the JAX package builds them) and a background
prefetch; `device_batch` moves each to the device, channels-first, and
splats a batch's raw radar points there (`ops/radar_splat.splat_radar_fast`)
when it carries no pre-rasterized map.

`fit(..., group=...)` trains across the ranks of a process group, as the
JAX package's `fit` does on a mesh of several processes: every rank loads
its `DistributedSampler` shard of each epoch, `tcfg.batch_size` is the
global batch, and each step is the single-process step on the global
batch (train/train_state.py).  That global batch is rank 0's rows, then
rank 1's, and so on, as `jax.make_array_from_process_local_data`
assembles it; with `grad_accum`, micro-batch m is that global batch's
m-th slice, as in the JAX package's scan.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from achelous_tpu_torch.core.config import AchelousConfig
from achelous_tpu_torch.data.prefetch import prefetch
from achelous_tpu_torch.data.sampler import DistributedSampler
from achelous_tpu_torch.data.waterscenes import WaterScenesDataset, collate
from achelous_tpu_torch.models.achelous import (_device, create_model,
                                                forward_compute)
from achelous_tpu_torch.ops.postprocess import (decode_outputs,
                                                non_max_suppression)
from achelous_tpu_torch.ops.radar_splat import splat_radar_fast
from achelous_tpu_torch.parallel import dist as pdist
from achelous_tpu_torch.train.checkpoints import CheckpointManager
from achelous_tpu_torch.train.schedule import get_lr_scheduler, scale_lr
from achelous_tpu_torch.train.train_state import (TrainConfig, TrainState,
                                                  create_train_state,
                                                  make_eval_step,
                                                  make_train_step,
                                                  state_tensors)
from achelous_tpu_torch.utils.metrics import (compute_det_metrics, fast_hist,
                                              pc_mean_iou, per_class_iu,
                                              per_class_pa_recall,
                                              voc_per_class_table)


class LossHistory:
    """Per-epoch records appended to `<log_dir>/history.jsonl`, with the
    loss, mAP and mIoU curves as pngs where matplotlib is installed
    (reference utils/callbacks.py:21-83)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.records: List[dict] = []

    def append(self, epoch: int, **metrics):
        rec = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        self.records.append(rec)
        with open(os.path.join(self.log_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.plot()

    def plot(self):
        """epoch_loss.png, epoch_map.png and epoch_miou.png; each series
        plots the epochs where its key is present (metrics exist only on
        eval epochs)."""
        if len(self.records) < 2:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return

        def save_series(fname, ylabel, series):
            drawn = False
            fig, ax = plt.subplots(figsize=(7, 4))
            for key, label, color in series:
                pts = [(r["epoch"], r[key]) for r in self.records
                       if r.get(key) is not None]
                if pts:
                    ax.plot(*zip(*pts), color=color, label=label,
                            linewidth=2, marker="o", markersize=3)
                    drawn = True
            if drawn:
                ax.set_xlabel("epoch")
                ax.set_ylabel(ylabel)
                ax.grid(True)
                ax.legend()
                fig.savefig(os.path.join(self.log_dir, fname),
                            bbox_inches="tight")
            plt.close(fig)

        save_series("epoch_loss.png", "loss",
                    [("loss", "loss", "red"),
                     ("val_loss", "val_loss", "coral")])
        save_series("epoch_map.png", "mAP",
                    [("mAP50", "mAP50", "red"),
                     ("mAP50-95", "mAP50-95", "coral")])
        save_series("epoch_miou.png", "mIoU",
                    [("miou_sem", "semantic", "red"),
                     ("miou_wl", "waterline", "royalblue"),
                     ("miou_pc", "point cloud", "seagreen")])


def batches_from(dataset: WaterScenesDataset, cfg: AchelousConfig,
                 batch_size: int, max_gt: int, shuffle: bool,
                 rng: np.random.RandomState,
                 drop_last: bool = True,
                 sampler: Optional[DistributedSampler] = None,
                 epoch: int = 0) -> Iterable[dict]:
    """Static-shape numpy batches.  drop_last=True as the reference's
    DataLoaders (train.py:589-603).  With drop_last=False the tail batch is
    padded to batch_size by wrapping around; `n_valid` says how many
    leading samples are real and `indices` carries the dataset indices, so
    an evaluation scores every sample once.

    With a `sampler`, the batches are this rank's shard of `epoch`
    (`sampler.epoch_indices(epoch)`, `rng` not drawn) and `batch_size` is
    the rank's own (reference DistributedSampler, train.py:576-580)."""
    if sampler is not None:
        idx = sampler.epoch_indices(epoch)
    else:
        idx = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(idx)
    end = len(idx) - batch_size + 1 if drop_last else len(idx)
    for s in range(0, max(end, 0 if drop_last else 1), batch_size):
        take = idx[s:s + batch_size]
        n_valid = len(take)
        if n_valid < batch_size:        # pad by cyclic wrapping (never scored)
            take = np.concatenate([take, np.resize(idx, batch_size - n_valid)])
        batch = collate([dataset[i] for i in take], cfg, max_gt)
        batch["n_valid"] = n_valid
        batch["indices"] = take
        yield batch


_HOST_ONLY_KEYS = ("radar_points", "radar_points_valid", "n_valid", "indices")


def device_batch(batch: dict, cfg: AchelousConfig,
                 device: torch.device | str = torch.device("cuda")) -> dict:
    """A host batch as tensors on `device` (the GPU unless the CPU is asked
    for), image and radar channels-first; a batch of raw radar points is
    splatted there into its [B, 3, R, R] radar map."""
    device = _device(device)
    out = {}
    for k, v in batch.items():
        if k in _HOST_ONLY_KEYS:
            continue
        if k in ("image", "radar"):
            v = v.transpose(0, 3, 1, 2)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            device, non_blocking=True)
    if "radar" not in out:
        pts = torch.from_numpy(batch["radar_points"]).to(device)
        ok = torch.from_numpy(batch["radar_points_valid"]).to(device)
        out["radar"] = splat_radar_fast(pts, ok, cfg.resolution)
    return out


def unletterbox_argmax(prob: np.ndarray, orig_hw: tuple[int, int]
                       ) -> np.ndarray:
    """A class-probability map at letterbox resolution [R, R, K] -> labels
    at the original image resolution: crop the bars, resize the
    probabilities bilinearly (Pillow, where the size differs), argmax
    (reference utils_seg/callbacks.py:169-186)."""
    r = prob.shape[0]
    ih, iw = orig_hw
    scale = min(r / iw, r / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dx, dy = (r - nw) // 2, (r - nh) // 2
    crop = np.ascontiguousarray(prob[dy:dy + nh, dx:dx + nw], np.float32)
    if (ih, iw) == (nh, nw):
        return np.argmax(crop, -1).astype(np.int32)
    from PIL import Image
    chans = [np.asarray(Image.fromarray(crop[..., c], mode="F")
                        .resize((iw, ih), Image.BILINEAR))
             for c in range(crop.shape[-1])]
    return np.argmax(np.stack(chans, -1), -1).astype(np.int32)


@torch.no_grad()
def evaluate_epoch(cfg: AchelousConfig, state: TrainState,
                   dataset: WaterScenesDataset, batch_size: int = 8,
                   conf_thres: float = 0.02, nms_thres: float = 0.5,
                   use_ema: bool = True, class_names=None) -> dict:
    """Online evaluation over a validation set: detection mAP, semantic
    and waterline mIoU at each image's own resolution, point-cloud mIoU
    (the reference's four EvalCallbacks, in memory).  Every image is scored
    once; detection mAP is taken in letterbox pixels, where every IoU equals
    the original's.  The model runs in eval mode on the EMA's weights and
    statistics (or its own) in `cfg.dtype`."""
    model = state.model
    dev = state.log_vars.device
    tensors = {**state.ema_params, **state.ema_batch_stats} if use_ema \
        else None
    r = cfg.resolution
    all_dets, all_gts = [], []
    sem_hist = np.zeros((cfg.num_seg, cfg.num_seg), np.int64)
    wl_hist = np.zeros((2, 2), np.int64)
    pc_conf = np.zeros((cfg.pc_classes, cfg.pc_classes), np.int64)
    was_training = model.training
    model.eval()
    try:
        for batch in batches_from(dataset, cfg, batch_size, 50, False,
                                  np.random.RandomState(0), drop_last=False):
            db = device_batch(batch, cfg, dev)
            det, sem, lane, pc = forward_compute(
                model, db["image"], db["radar"], db["pc"], tensors)
            dets = non_max_suppression(decode_outputs(det, (r, r)),
                                       cfg.num_det, conf_thres, nms_thres)
            dets = type(dets)(*(t.cpu().numpy() for t in dets))
            sem_prob = sem.float().softmax(1).permute(0, 2, 3, 1).cpu().numpy()
            wl_prob = lane.float().softmax(1).permute(0, 2, 3, 1).cpu().numpy()
            pc_pred = pc.argmax(-1).cpu().numpy()
            for i in range(batch["n_valid"]):
                v = dets.valid[i]
                all_dets.append({
                    "boxes": dets.boxes[i][v] * r,   # pixels for matching
                    "scores": (dets.obj_conf[i] * dets.cls_conf[i])[v],
                    "classes": dets.cls_idx[i][v]})
                gm = batch["gt_mask"][i]
                gb = batch["gt_boxes"][i][gm]
                all_gts.append({
                    "boxes": np.concatenate([gb[:, :2] - gb[:, 2:] / 2,
                                             gb[:, :2] + gb[:, 2:] / 2], -1),
                    "classes": batch["gt_classes"][i][gm]})
                seg_orig, wl_orig = dataset.original_masks(
                    int(batch["indices"][i]))
                sem_hist += fast_hist(
                    seg_orig.flatten(),
                    unletterbox_argmax(sem_prob[i], seg_orig.shape).flatten(),
                    cfg.num_seg)
                # labels == 2 are the ignore class; fast_hist drops them
                wl_hist += fast_hist(
                    wl_orig.flatten(),
                    unletterbox_argmax(wl_prob[i], wl_orig.shape).flatten(), 2)
                pc_conf += fast_hist(batch["pc_labels"][i].flatten(),
                                     pc_pred[i].flatten(), cfg.pc_classes)
    finally:
        model.train(was_training)
    out = {**compute_det_metrics(all_dets, all_gts, cfg.num_det,
                                 per_class=True),
           "n_images": len(all_gts),
           "miou_sem": float(np.nanmean(per_class_iu(sem_hist))),
           "miou_wl": float(np.nanmean(per_class_iu(wl_hist))),
           "miou_pc": pc_mean_iou(pc_conf)}

    def cname(i):
        return (class_names[i] if class_names and i < len(class_names)
                else f"c{i}")
    for c, ap in out.pop("per_class_ap50").items():
        out[f"ap50/{cname(c)}"] = ap
    out.pop("per_class_ap")
    for c, row in voc_per_class_table(all_dets, all_gts,
                                      cfg.num_det).items():
        out[f"lamr/{cname(c)}"] = row["lamr"]
    sem_iu, sem_pa = per_class_iu(sem_hist), per_class_pa_recall(sem_hist)
    for c in range(cfg.num_seg):
        out[f"iou_sem/{c}"] = float(sem_iu[c])
        out[f"pa_sem/{c}"] = float(sem_pa[c])
    for c, v in enumerate(per_class_iu(pc_conf)):
        out[f"iou_pc/{c}"] = float(v)
    return out


def _mean(total: Optional[dict], n: int) -> dict:
    return {k: float(v) / max(n, 1) for k, v in (total or {}).items()}


def _add(total: Optional[dict], m: dict) -> dict:
    """Running sums of the step's metrics, on the device."""
    if total is None:
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in m.items()}
    return {k: total[k] + v for k, v in m.items()}


def rng_state(rng: np.random.RandomState) -> dict:
    """A generator's state as `torch.load(weights_only=True)` reads it."""
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def set_rng_state(rng: np.random.RandomState, saved: dict):
    rng.set_state(("MT19937", saved["keys"].numpy().astype(np.uint32),
                   saved["pos"], saved["has_gauss"], saved["cached"]))


def _restore_rngs(rngs: dict, saved: dict, world: int, rank: int):
    """Set this rank's host generators from a state's `data_rng`: the
    flat form one process writes, or {"ranks": [...]} with an entry a rank.
    Refuses a state written at another number of ranks."""
    ranks = saved.get("ranks")
    if (len(ranks) if ranks is not None else 1) != world:
        raise ValueError(
            f"the state carries the data generators of "
            f"{len(ranks) if ranks is not None else 1} rank(s); resume it "
            f"with as many, not {world}")
    for name, r in rngs.items():
        set_rng_state(r, (ranks[rank] if ranks is not None else saved)[name])


def _broadcast_state(state: TrainState, group):
    """Every rank takes rank 0's state: its tensors in place (`copy_`, so
    the kernels' caches of packed weights rebuild), its counters and
    data_rng."""
    pdist.broadcast_(state_tensors(state), group)
    held = [state.step, state.epoch, state.ema_updates, state.data_rng,
            state.opt_state.get("count")]
    torch.distributed.broadcast_object_list(held, src=0, group=group)
    (state.step, state.epoch, state.ema_updates, state.data_rng,
     count) = held
    if count is not None:
        state.opt_state["count"] = count


def fit(cfg: AchelousConfig, tcfg: TrainConfig,
        train_ds: WaterScenesDataset, val_ds: Optional[WaterScenesDataset],
        log_dir: str = "logs", epochs: Optional[int] = None,
        eval_period: int = 10, save_period: int = 10,
        state: Optional[TrainState] = None, seed: int = 0,
        device: torch.device | str = torch.device("cuda"),
        progress: Callable[[str], None] = print,
        group=None) -> TrainState:
    """A whole training run (reference train.py:637-703 + fit_one_epoch):
    for each epoch from `state.epoch`, the shuffled training batches
    through `make_train_step` at the epoch's learning rate, the backbone
    frozen while epoch < `tcfg.freeze_epochs`; the validation losses; the
    online evaluation every `eval_period` epochs and at the last; a line of
    `history.jsonl`; the checkpoints under `<log_dir>/ckpt`.

    Without `state`, a fresh model on `device` (the GPU unless the CPU is
    asked for), drawn from `seed`.  Each epoch's end stores the states of
    the shuffle's generator and of the datasets' own (point resampling,
    augmentation, mosaic) in `state.data_rng`, which the checkpoints
    carry; a resumed run sets them back, so it draws the batches of an
    uninterrupted run.  A state without them (one converted from the JAX
    package) replays the shuffles of the epochs it skips.

    With a process `group` of W > 1 ranks (the JAX package's multi-process
    mesh): rank 0's state is broadcast to every rank first; each rank
    loads its `DistributedSampler` shard (the training one shuffled from
    `seed`, the validation one in order) in batches of `tcfg.batch_size` /
    W, and the steps and validation losses are the global batch's; the
    online evaluation runs on rank 0 over the whole validation set, and
    rank 0 alone writes the history and the checkpoints.  `data_rng`
    holds every rank's generators (gathered on rank 0), so a resume at W
    ranks gives each its own back; one at another W is refused.
    `progress` is called on every rank."""
    epochs = epochs or tcfg.epochs
    if state is None:
        model = create_model(cfg, device, torch.Generator().manual_seed(seed),
                             train=True)
        state = create_train_state(model, cfg, tcfg, seed)
    dev = state.log_vars.device
    world = pdist.world_size(group) if group is not None else 1
    rank = pdist.rank(group) if world > 1 else 0
    sampler = val_sampler = None
    local_bs = tcfg.batch_size
    if world > 1:
        _broadcast_state(state, group)
        local_bs = pdist.local_batch_size(tcfg.batch_size, world)
        sampler = DistributedSampler(len(train_ds), world, rank, seed=seed)
        if val_ds is not None:
            val_sampler = DistributedSampler(len(val_ds), world, rank,
                                             shuffle=False)
    init_lr, min_lr = scale_lr(tcfg.lr_init, tcfg.batch_size, tcfg.optimizer)
    lr_fn = get_lr_scheduler(tcfg.lr_decay, init_lr, min_lr, epochs)
    train_step = make_train_step(cfg, tcfg, group)
    eval_step = make_eval_step(cfg, tcfg, group)
    history = ckpt = None
    if rank == 0:
        history = LossHistory(log_dir)
        ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"))
    rng = np.random.RandomState(seed)
    rngs = {"shuffle": rng, "train": train_ds.rng}
    if val_ds is not None:
        rngs["val"] = val_ds.rng
    if state.data_rng:
        _restore_rngs(rngs, state.data_rng, world, rank)
    elif sampler is None:
        for _ in range(state.epoch):
            rng.shuffle(np.arange(len(train_ds)))

    for epoch in range(state.epoch, epochs):
        lr = float(np.float32(lr_fn(epoch)))
        t0 = time.time()
        tr, n_b = None, 0
        with prefetch(batches_from(train_ds, cfg, local_bs, tcfg.max_gt,
                                   True, rng, sampler=sampler, epoch=epoch),
                      depth=2) as batches:
            for batch in batches:
                state, m = train_step(state, device_batch(batch, cfg, dev),
                                      lr, epoch < tcfg.freeze_epochs)
                tr = _add(tr, m)
                n_b += 1
        tr = _mean(tr, n_b)

        val = {}
        if val_ds is not None:
            vm, n_v = None, 0
            for batch in batches_from(val_ds, cfg, local_bs, tcfg.max_gt,
                                      False, rng, sampler=val_sampler,
                                      epoch=epoch):
                vm = _add(vm, eval_step(state, device_batch(batch, cfg, dev)))
                n_v += 1
            val = {f"val_{k}": v for k, v in _mean(vm, n_v).items()}
            if rank == 0 and ((epoch + 1) % eval_period == 0
                              or epoch == epochs - 1):
                val.update(evaluate_epoch(cfg, state, val_ds,
                                          batch_size=tcfg.batch_size))
        state.epoch = epoch + 1
        mine = {name: rng_state(r) for name, r in rngs.items()}
        if world > 1:
            ranks = [None] * world
            torch.distributed.all_gather_object(ranks, mine, group=group)
            state.data_rng = {"ranks": ranks}
        else:
            state.data_rng = mine
        if rank == 0:
            history.append(epoch, **{"lr": lr, **tr, **val})
            ckpt.save_epoch(epoch, state, tr.get("loss", 0.0),
                            val.get("val_loss", tr.get("loss", 0.0)),
                            save_period)
        progress(f"epoch {epoch + 1}/{epochs} "
                 f"loss={tr.get('loss', float('nan')):.3f} "
                 f"val={val.get('val_loss', float('nan')):.3f} "
                 f"({time.time() - t0:.1f}s)")
    return state
