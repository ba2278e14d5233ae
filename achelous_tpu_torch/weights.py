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
