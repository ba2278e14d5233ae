"""Tensors derived from a module's parameters, kept between calls.

A kernel may want its weights in another layout or dtype than the module
holds them (K1's packed conv weights, K3's gathered bias table).  Building
them costs launches on every call; `ParamCache` builds them once and again
only when a parameter changes.  The key is the tensors themselves, held
by the cache, with each one's `data_ptr()` and `_version`: an in-place
update (`copy_`, `load_state_dict`, an optimizer step) bumps the version,
and a move or cast (`module.to`, `.cuda()`, `.bfloat16()`) must call
`clear()` from the module's `_apply`, since new storage may reuse an old
address.  Keying on the objects matters where a caller passes tensors
made afresh on every call, as the training form's casts of float32
parameters are (`models.achelous.forward_compute`): a fresh cast has
version 0 and may land where the last one lay, so address and version
alone would hand back a value built from old weights.  Such a caller
never hits the cache, and it holds one stale set of tensors at most.

Where a gradient is asked for, the tensors are built afresh on every call
and never cached: a cached tensor made under `torch.inference_mode` cannot
enter a graph that needs a gradient, and a cached one made under
`no_grad` would cut the graph.  Under `torch.export` they are built afresh
too, inside the traced graph: the parameters are fake tensors there, with
no storage to key on, and a cached fake would outlive its trace.
"""
from __future__ import annotations

from typing import Callable, Hashable, Sequence

import torch


class ParamCache:
    def __init__(self):
        self.tensors = ()
        self.key = None
        self.value = None

    def clear(self):
        self.tensors, self.key, self.value = (), None, None

    def get(self, tensors: Sequence[torch.Tensor], build: Callable,
            extra: Hashable = None):
        """`build()`, or its cached result while `tensors` are the very
        objects of the last call, each as it was, and `extra` (e.g. the
        compute dtype) is unchanged."""
        if torch.compiler.is_exporting():
            return build()
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return build()
        if any(t.is_inference() for t in tensors):
            return build()                 # no version counter to key on
        key = tuple((t.data_ptr(), t._version) for t in tensors) + (extra,)
        same = (len(tensors) == len(self.tensors)
                and all(a is b for a, b in zip(tensors, self.tensors)))
        if not same or key != self.key:
            with torch.no_grad():
                self.value = build()
            self.tensors, self.key = tuple(tensors), key
        return self.value
