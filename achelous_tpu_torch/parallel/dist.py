"""Data parallelism across ranks (counterpart of achelous_tpu/parallel/mesh.py;
reference train.py:313-324, 415-420, 576-580).

The JAX package replicates the train state over a 1-D mesh and shards the
batch; GSPMD then computes the single-device step on the GLOBAL batch:
BatchNorm statistics over the global batch, the detection loss over the
global foreground count, the dice sums and every mean over the global
batch, the multi-task solves on global task gradients.  A plain
`DistributedDataParallel` wrap computes none of these, so the port does it
by hand.  Each rank holds a replica of the state and its own rows of the
global batch; `batch_group(group)` tells BatchNorm (`ops/norm.py`) and the
losses (`losses/`) which process group the batch spans, and they take
their sums over it through `all_reduce_sum`, a differentiable all-reduce.

Every rank then computes the global loss, and autograd through
`all_reduce_sum` (whose backward sums the cotangents over the group)
gives rank r the gradient of W times that loss with respect to its own
rows; the mean of the ranks' gradients (`average_`) is the global
gradient.  Parameters read after the reductions only (the uncertainty
weighting's `log_vars`) get the same gradient on every rank, which the
mean leaves as it is.

With no group, or a group of one rank, `current_group()` is None and every
path is the single-process one, bit for bit.

Backends: `nccl` where each rank has a GPU of its own; `gloo` on the CPU,
or where ranks share one GPU (NCCL refuses two ranks on one device).
Every device-tensor collective here is an all-reduce or a broadcast,
which gloo also does on CUDA tensors; host objects travel by
`all_gather_object` / `broadcast_object_list`.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, Iterable

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group",
                                                        default=None)


def world_size(group=None) -> int:
    """Ranks in `group` (the default group where None), 1 without one."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_batch_size(global_batch_size: int, world: int) -> int:
    """Each rank's share of the global batch (the reference divides the
    batch by the GPUs of a node under DDP, train.py:580)."""
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {world} processes")
    return global_batch_size // world


def init_from_env(backend: str):
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment); returns
    (group, rank, world, local_rank).  Raises where the group cannot be
    formed: a run that asked for ranks never trains as one process."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"{', '.join(missing)} not set: start the ranks "
                           f"with torchrun")
    local = int(os.environ["LOCAL_RANK"])
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.group.WORLD, dist.get_rank(), dist.get_world_size(), local


def rank_device(device: str, backend: str, local_rank: int,
                local_world: int) -> torch.device:
    """This rank's device: `cuda` means cuda:LOCAL_RANK; an explicit
    cuda:k is shared by every rank of the node, which gloo allows and NCCL
    refuses."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("the nccl backend needs a GPU a rank; use "
                             "--dist_backend gloo on the CPU")
        return dev
    if dev.index is None:
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(
                f"local rank {local_rank} has no GPU of its own ({n} "
                f"visible): run as many ranks a node as GPUs, or share one "
                f"with --device cuda:0 --dist_backend gloo")
        return torch.device("cuda", local_rank)
    if backend == "nccl" and local_world > 1:
        raise ValueError(f"NCCL refuses two ranks on one device "
                         f"({dev}): use --device cuda for a GPU a rank, or "
                         f"--dist_backend gloo to share it")
    return dev


@contextlib.contextmanager
def batch_group(group):
    """While open, BatchNorm in train mode and the losses take their
    statistics and sums over the ranks of `group`: the batch they see is
    this rank's rows of a global batch that spans the group."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_group():
    """The group of the open `batch_group` scope, or None where there is
    none or it has one rank."""
    group = _GROUP.get()
    if group is None or world_size(group) == 1:
        return None
    return group


class AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the sum over the group
    of the cotangents, the gradient of the sum of every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return AllReduceSum.apply(x, group)


def _flat_apply(tensors: list[torch.Tensor], op: Callable) -> None:
    """`op` on one flat buffer a dtype of `tensors`, copied back in place
    (`copy_` moves each tensor's version, so caches keyed on it rebuild)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            op(flat)
            at = 0
            for t in ts:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()


def average_(tensors: Iterable[torch.Tensor], group) -> None:
    """Each tensor replaced, in place, by its mean over the group."""
    w = world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(w)
    _flat_apply(list(tensors), op)


def broadcast_(tensors: Iterable[torch.Tensor], group, src: int = 0) -> None:
    """Each tensor overwritten, in place, by rank `src`'s."""
    _flat_apply(list(tensors),
                lambda flat: dist.broadcast(flat, src=src, group=group))


def gather_rows(tensors: dict[str, torch.Tensor], group
                ) -> dict[str, torch.Tensor]:
    """Each tensor's rows from every rank of the group, concatenated in
    rank order: the global batch of which `tensors` are this rank's rows.
    Every rank holds tensors of the same shapes; each broadcasts its own
    as one byte buffer in turn."""
    w, me = world_size(group), rank(group)
    items = [(k, v.contiguous()) for k, v in tensors.items()]
    mine = torch.cat([v.reshape(-1).view(torch.uint8) for _, v in items])
    parts = []
    for src in range(w):
        buf = mine if src == me else torch.empty_like(mine)
        dist.broadcast(buf, src=src, group=group)
        at, got = 0, {}
        for k, v in items:
            nbytes = v.numel() * v.element_size()
            got[k] = buf[at:at + nbytes].view(v.dtype).view_as(v)
            at += nbytes
        parts.append(got)
    return {k: torch.cat([p[k] for p in parts]) for k, _ in items}
