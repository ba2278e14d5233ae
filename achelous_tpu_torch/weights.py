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
supplies them in the same format.
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
