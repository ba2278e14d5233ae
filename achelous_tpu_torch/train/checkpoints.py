"""Checkpoints of the whole train state (counterpart of
achelous_tpu/train/checkpoints.py, which saves with orbax).

`torch.save` of the state's tensors and counters under
`<directory>/<name>.pt`: the model's state dict (parameters and BatchNorm
statistics), log_vars, the optimizer state, the EMA, the counters and the
host generators' states, so a resume is exact.  A run across ranks
(`train/loop.fit(..., group=...)`) is saved by rank 0 with every rank's
generators in `data_rng["ranks"]`; `fit` gives each rank its own back on
a resume and refuses a resume at another number of ranks.  The policy is the reference's (utils_fit.py:345-381):
a periodic epoch checkpoint named by its losses, `best_epoch_weights`
(val loss <= the best so far) and `last_epoch_weights`; the newest
`keep` periodic checkpoints are kept and older ones removed.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from achelous_tpu_torch.train.train_state import TrainState

PERIODIC = "ep"


def state_dict(state: TrainState) -> dict:
    return {"step": state.step, "epoch": state.epoch,
            "model": state.model.state_dict(),
            "log_vars": state.log_vars.detach(),
            "opt_state": state.opt_state,
            "ema_params": state.ema_params,
            "ema_batch_stats": state.ema_batch_stats,
            "ema_updates": state.ema_updates,
            "data_rng": state.data_rng}


@torch.no_grad()
def load_state_dict(state: TrainState, saved: dict) -> TrainState:
    """Copy a saved state into `state` (same model), in place."""
    state.model.load_state_dict(saved["model"])
    state.log_vars.copy_(saved["log_vars"])

    def copy_tree(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                copy_tree(dst[k], v)
            elif isinstance(v, torch.Tensor):
                dst[k].copy_(v)
            else:
                dst[k] = v
    for key in ("opt_state", "ema_params", "ema_batch_stats"):
        copy_tree(getattr(state, key), saved[key])
    state.step, state.epoch = saved["step"], saved["epoch"]
    state.ema_updates = saved["ema_updates"]
    state.data_rng = saved.get("data_rng", {})
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric: Optional[float] = None
        self.keep = keep

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name + ".pt")

    def save(self, name: str, state: TrainState):
        tmp = self._path(name) + ".tmp"
        torch.save(state_dict(state), tmp)
        os.replace(tmp, self._path(name))

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load checkpoint `name` into `state` (the template)."""
        saved = torch.load(self._path(name), map_location="cpu",
                           weights_only=True)
        return load_state_dict(state, saved)

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def periodic(self) -> list[str]:
        """The periodic checkpoints' names, oldest first."""
        names = [f[:-3] for f in os.listdir(self.directory)
                 if f.startswith(PERIODIC) and f.endswith(".pt")]
        return sorted(names)

    def save_epoch(self, epoch: int, state: TrainState, train_loss: float,
                   val_loss: float, save_period: int = 10):
        if (epoch + 1) % save_period == 0:
            self.save(f"{PERIODIC}{epoch + 1:03d}-loss{train_loss:.3f}-"
                      f"val_loss{val_loss:.3f}", state)
            for old in self.periodic()[:-self.keep]:
                os.remove(self._path(old))
        if self.best_metric is None or val_loss <= self.best_metric:
            self.best_metric = val_loss
            self.save("best_epoch_weights", state)
        self.save("last_epoch_weights", state)
