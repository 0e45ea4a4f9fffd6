"""The active process group, and the few collectives the port's
multi-process paths need.

Counterpart of the context half of ``repro.sharding`` (``use`` /
``active_mesh``): ``use(group)`` installs a ``torch.distributed`` process
group for the code inside the ``with`` block, and ``active_group()``
returns it (or ``None``), held thread-locally as ``repro``'s ``_Ctx``
holds its mesh.  Under an active group the DP solves shard their scenarios
over the group's ranks (``solver_backends.shard_scenarios``); the train
step takes its group as an argument (``launch.steps.make_train_step``).

``repro``'s logical-axis rule tables (``RULES_*``, ``spec_for``,
``constrain``) are XLA layouts for GSPMD and are not ported: the port's
multi-process paths split one axis (scenarios, or batch rows) over the
ranks of a group, and every rank holds whole parameters and whole tables.

The collectives take tensors on the card or on the host.  Under ``gloo``
a CUDA tensor is staged through a host copy: which gloo collectives take
CUDA tensors depends on the build of torch, so every one goes through the
host there.  A failed collective raises; nothing falls back to one
process.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist


class _Ctx(threading.local):
    group: Optional[dist.ProcessGroup] = None


_ctx = _Ctx()


@contextlib.contextmanager
def use(group: Optional[dist.ProcessGroup]):
    """Make ``group`` the active process group inside the ``with`` block
    (``None`` runs the block in one process)."""
    prev = _ctx.group
    _ctx.group = group
    try:
        yield
    finally:
        _ctx.group = prev


def active_group() -> Optional[dist.ProcessGroup]:
    return _ctx.group


def _staged(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collective of ``group`` takes it: a host copy of a CUDA
    tensor under gloo, else ``x`` itself."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along axis
    0 in rank order, on ``x``'s device."""
    xs = _staged(group, x.contiguous())
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, xs, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place; returns ``x``."""
    xs = _staged(group, x)
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=group)
    if xs is not x:
        x.copy_(xs)
    return x


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` on every rank with rank ``src``'s (a rank of
    ``group``); returns ``x``."""
    xs = _staged(group, x)
    dist.broadcast(xs, group=group, group_src=src)
    if xs is not x:
        x.copy_(xs)
    return x


def check_same(values, group, what: str) -> None:
    """Raise ``RuntimeError`` unless every rank of ``group`` passes the same
    integers ``values``."""
    dev = "cuda" if dist.get_backend(group) == dist.Backend.NCCL else "cpu"
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=dev)
    every = all_gather_cat(mine[None], group)
    if not bool((every == mine).all()):
        raise RuntimeError(f"the ranks disagree on {what}: "
                           f"{every.tolist()}")
