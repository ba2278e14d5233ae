"""Flax variables -> this port's state dict (the inverse of
achelous_tpu/utils/torch_import.py `transplant`).

`entries` is a mapping in that module's format, a list of
`(flax_path, collection, torch_key, transform[, stack_index])`, e.g. the
list `achelous_mapping(...)` builds.  Each flax value is turned back into
the torch layout its transform names, then reshaped to the shape the
port's own parameter has (`like[torch_key]`), so size-preserving
transforms (`flat`, `conv1d_dense`, `conv1x1_dense`) need no guessing.

Pure numpy: pass the flax variables as numpy arrays (or anything
`np.asarray` takes) and `like` as a name -> shape-bearing array dict such
as `model.state_dict()`.

The JAX package's mapping has no PointNet++ entries; `pointnet2_entries`
supplies them in the same format.  Its `with_torch_prefix` takes four
fields an entry and so cannot carry MobileViT's stacked entries, whose
fifth field is the layer's index on the stacking axis; `torch_prefixed`
keeps it.

`save_weights` / `load_weights` are the port's weight file: `torch.save`
of `{"state_dict": ..., "meta": ...}` (the counterpart of the JAX
package's msgpack with its `__achelous_meta__` stamp), read back with
`weights_only=True`.  meta["provenance"] == "torch-transplant" marks
weights trained with unbounded deformable offsets (predict.py).

The 3-task Achelous3T (`create_model(..., with_pc=False)`) has no
`pc_seg_model`: its state dict takes the entries of the JAX package's
`achelous_mapping(..., with_pc=False)`, whose variables have no `pc_seg`.

`load_train_state_from_jax` carries a whole JAX `TrainState` (params and
batch_stats, log_vars, the EMA, the optax momentum trace or Adam moments,
the counters) into the port's `TrainState`, through the same entries.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

# flax layout -> torch layout, one per transform name of torch_import
INVERSE = {
    "conv": lambda v: np.transpose(v, (3, 2, 0, 1)),        # HWIO -> OIHW
    "dense": np.transpose,                                  # [in,out] -> [out,in]
    "conv1x1_dense": np.transpose,                          # then [out,in,1,1]
    "conv1d_dense": np.transpose,                           # then [out,in,1]
    "vec": lambda v: v,
    "flat": lambda v: v,
    "convt_dw": lambda v: np.transpose(v, (2, 0, 1))[:, None],
    "conv1d": lambda v: np.transpose(v, (2, 1, 0)),         # [k,in,out] -> [out,in,k]
}


def _bn_entries(path, key):
    return [(path + ("scale",), "params", key + ".weight", "vec"),
            (path + ("bias",), "params", key + ".bias", "vec"),
            (path + ("mean",), "batch_stats", key + ".running_mean", "vec"),
            (path + ("var",), "batch_stats", key + ".running_var", "vec")]


def _dense_entries(path, key, tf):
    return [(path + ("kernel",), "params", key + ".weight", tf),
            (path + ("bias",), "params", key + ".bias", "vec")]


def pointnet2_entries(prefix: str = "pc_seg_model.") -> list:
    """Entries for the `pn2` branch: the flax `PointNet2Seg` under `pc_seg`
    (as the JAX Achelous names it) -> the port's `PointNet2Seg` under torch
    key `prefix`.  flax `sa{i}/mlp_{j}_dense|_bn` are `sa{i}.mlp_convs.{j}`
    (1x1 Conv2d) and `sa{i}.mlp_bns.{j}`, `fp{l}/...` the same with Conv1d,
    `head1_dense|_bn` are `conv1`/`bn1` and `head2` is `conv2`."""
    out = []
    # MLP depths of models/pointnet2.py: SA_MLPS, FP_MLPS
    levels = [(f"sa{i}", "conv1x1_dense", 3) for i in range(1, 5)]
    levels += [(f"fp{lvl}", "conv1d_dense", 3 if lvl == 1 else 2)
               for lvl in range(4, 0, -1)]
    for name, tf, depth in levels:
        for j in range(depth):
            path = ("pc_seg", name)
            key = f"{prefix}{name}"
            out += _dense_entries(path + (f"mlp_{j}_dense",),
                                  f"{key}.mlp_convs.{j}", tf)
            out += _bn_entries(path + (f"mlp_{j}_bn",), f"{key}.mlp_bns.{j}")
    out += _dense_entries(("pc_seg", "head1_dense"), prefix + "conv1",
                          "conv1d_dense")
    out += _bn_entries(("pc_seg", "head1_bn"), prefix + "bn1")
    out += _dense_entries(("pc_seg", "head2"), prefix + "conv2", "conv1d_dense")
    return out


def torch_prefixed(entries: Iterable, tprefix: str) -> list:
    """`entries` with `tprefix` before every torch key, each entry's other
    fields (a stack index too) as they are."""
    return [(e[0], e[1], tprefix + e[2], *e[3:]) for e in entries]


def save_weights(path: str, state_dict: Mapping, meta: Mapping | None = None
                 ) -> str:
    """Write `state_dict` (tensors or numpy arrays, stored on the CPU) and
    the provenance stamp `meta` to `path`."""
    import torch
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          .detach().cpu() for k, v in state_dict.items()}
    torch.save({"state_dict": sd, "meta": dict(meta or {})}, path)
    return path


def load_weights(path: str) -> tuple[dict, dict]:
    """(state_dict, meta) from a file `save_weights` wrote; meta is {} for
    an unstamped file."""
    import torch
    doc = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(doc, dict) or "state_dict" not in doc:
        raise ValueError(f"{path}: not a weight file of save_weights")
    return dict(doc["state_dict"]), dict(doc.get("meta", {}))


def _get(tree, path):
    node = tree
    for p in path:
        if p not in node:
            raise KeyError(f"flax path {'/'.join(path)}: missing {p!r}")
        node = node[p]
    return np.asarray(node)


def state_dict_from_jax(variables: Mapping, entries: Iterable,
                        like: Mapping) -> dict[str, np.ndarray]:
    """Return {torch_key: array} for every key of `like`, in `like`'s
    shapes and float dtype.  Raises on a missing flax path, a size that
    does not fit, or a key of `like` that no entry fills."""
    out = {}
    for entry in entries:
        path, coll, key, tf = entry[:4]
        value = _get(variables[coll], path)
        if len(entry) == 5:
            value = value[entry[4]]
        if key not in like:
            raise KeyError(f"torch key {key!r} (from {coll}/{'/'.join(path)}) "
                           f"is not a key of the port's state dict")
        target = like[key]
        value = INVERSE[tf](value)
        if value.size != int(np.prod(target.shape)):
            raise ValueError(f"{key}: flax {coll}/{'/'.join(path)} has "
                             f"{value.size} values, port shape "
                             f"{tuple(target.shape)}")
        out[key] = np.ascontiguousarray(
            value.reshape(tuple(target.shape)), dtype=np.float32)
    missing = sorted(set(like) - set(out))
    if missing:
        raise ValueError(f"{len(missing)} port keys have no flax source: "
                         + ", ".join(missing[:20]))
    return out


def _split(sd: Mapping, keys) -> dict:
    return {k: v for k, v in sd.items() if k in keys}


def _opt_leaves(opt_state):
    """The optax states inside a (nested) chain state, depth first."""
    if hasattr(opt_state, "_fields"):          # an optax NamedTuple state
        yield opt_state
        for v in opt_state:
            yield from _opt_leaves(v)
    elif isinstance(opt_state, (tuple, list)):
        for v in opt_state:
            yield from _opt_leaves(v)


def load_train_state_from_jax(state, jstate, entries: Iterable) -> None:
    """Copy a JAX `TrainState` (achelous_tpu/train/train_state.py; leaves
    anything `np.asarray` takes) into the port's `TrainState` `state`, in
    place.  The optimizer state is read from the optax chain: the SGD
    `trace`, or Adam's `mu`, `nu` and `count`; each over {"model",
    "log_vars"}, carried as the parameters are."""
    import torch

    entries = list(entries)
    like = state.model.state_dict()
    pnames = {n for n, _ in state.model.named_parameters()}
    param_entries = [e for e in entries if e[1] == "params"]
    like_params = _split(like, pnames)

    def full(params, stats):
        return state_dict_from_jax({"params": params, "batch_stats": stats},
                                   entries, like)

    def trainable(tree):
        out = state_dict_from_jax({"params": tree["model"]}, param_entries,
                                  like_params)
        out["log_vars"] = np.asarray(tree["log_vars"], np.float32)
        return out

    def copy(dst: dict, src: dict):
        for k, t in dst.items():
            t.copy_(torch.from_numpy(np.asarray(src[k])))

    with torch.no_grad():
        state.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in
             full(jstate.params, jstate.batch_stats).items()})
        state.log_vars.copy_(torch.from_numpy(
            np.asarray(jstate.log_vars, np.float32)))
        ema = full(jstate.ema_params, jstate.ema_batch_stats)
        copy(state.ema_params, _split(ema, pnames))
        copy(state.ema_batch_stats, _split(ema, set(ema) - pnames))
        for leaf in _opt_leaves(jstate.opt_state):
            for field in ("trace", "mu", "nu"):
                if field in getattr(leaf, "_fields", ()):
                    copy(state.opt_state[field],
                         trainable(getattr(leaf, field)))
            if "count" in getattr(leaf, "_fields", ()) and \
                    "count" in state.opt_state:
                state.opt_state["count"] = int(np.asarray(leaf.count))
    state.step = int(np.asarray(jstate.step))
    state.epoch = int(np.asarray(jstate.epoch))
    state.ema_updates = int(np.asarray(jstate.ema_updates))
