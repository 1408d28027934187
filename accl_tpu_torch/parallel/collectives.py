"""Functional collectives over rank lists.

Port of ``accl_tpu/parallel/collectives.py``.  There each function runs
inside ``shard_map`` on one member's value and lowers to an XLA
collective over a mesh axis.  Here the axis is the list itself: every
function takes one tensor per member, in rank order, and returns one per
member.  The XLA lowerings become torch ops over the list; members that
end with the same value share one tensor.  The explicit ``ring_*``
schedules go through ``accl_tpu_torch/ops/ring.py``: its CUDA kernels on
the card, its plain versions on the CPU, with the JAX schedule's chunk
order (chunk ``(r - 1)`` first, then ``(r - 2 - s)`` at step ``s``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops import ring as ring_ops


# ---------------------------------------------------------------------------
# direct lowerings
# ---------------------------------------------------------------------------
def all_reduce(xs: Sequence[torch.Tensor], op: str = "sum") -> list:
    """All-reduce over the members (psum / pmax / pmin / pmean)."""
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    total = xs[0]
    for x in xs[1:]:
        if op == "max":
            total = torch.maximum(total, x)
        elif op == "min":
            total = torch.minimum(total, x)
        else:
            total = total + x
    if op == "mean":
        total = total / len(xs)
    return [total] * len(xs)


def reduce(xs: Sequence[torch.Tensor], root: int, op: str = "sum") -> list:
    """Rooted reduce: every member computes the reduction, the caller
    keeps the root's copy."""
    return all_reduce(xs, op)


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = True,
               gather_axis: int = 0) -> list:
    """All-gather: concatenated along ``gather_axis`` (tiled) or stacked
    on a new axis there."""
    out = (torch.cat(list(xs), dim=gather_axis) if tiled
           else torch.stack(list(xs), dim=gather_axis))
    return [out] * len(xs)


def reduce_scatter(xs: Sequence[torch.Tensor], scatter_axis: int = 0) -> list:
    """Reduce-scatter: member r gets block r of the sum, split along
    ``scatter_axis``."""
    total = all_reduce(xs)[0]
    return list(torch.chunk(total, len(xs), dim=scatter_axis))


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> list:
    """Personalized exchange: member r gets block r of every member's
    value, concatenated along ``concat_axis`` (tiled), or with
    ``tiled=False`` (``x.shape[split_axis]`` = P) stacked on a new axis at
    ``concat_axis`` after ``split_axis`` is removed."""
    P = len(xs)
    if tiled:
        parts = [torch.chunk(x, P, dim=split_axis) for x in xs]
        return [torch.cat([parts[s][r] for s in range(P)], dim=concat_axis)
                for r in range(P)]
    return [torch.stack([x.select(split_axis, r) for x in xs], dim=concat_axis)
            for r in range(P)]


def broadcast(xs: Sequence[torch.Tensor], root: int) -> list:
    """Every member gets the root's value."""
    return [xs[root]] * len(xs)


def scatter(xs: Sequence[torch.Tensor], root: int) -> list:
    """Member i gets block i of the root's value (leading dim = P)."""
    return [xs[root][i] for i in range(len(xs))]


def gather(xs: Sequence[torch.Tensor], root: int) -> list:
    """Every member's block, stacked; the caller keeps the root's copy."""
    return all_gather(xs, tiled=False)


def ppermute(xs: Sequence[torch.Tensor], perm) -> list:
    """Point-to-point permutation: ``dst`` gets ``src``'s value for each
    (src, dst) pair; members that receive nothing get zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src]
    return out


def send_recv(xs: Sequence[torch.Tensor], src: int, dst: int) -> list:
    """``dst`` gets ``src``'s value, every other member zeros."""
    return ppermute(xs, [(src, dst)])


def barrier(xs: Sequence[torch.Tensor]) -> list:
    """A trivial sum over the members (any collective is a sync): each
    gets the member count."""
    one = torch.ones((), dtype=torch.int32, device=xs[0].device)
    return all_reduce([one] * len(xs))


# ---------------------------------------------------------------------------
# explicit ring schedules
# ---------------------------------------------------------------------------
def ring_reduce_scatter(xs: Sequence[torch.Tensor]) -> list:
    """Ring reduce-scatter: each member's [P * n, ...] -> its reduced chunk
    [n, ...], P - 1 steps of the ring (ops/ring.py)."""
    P = len(xs)
    shape = xs[0].shape
    n = shape[0] // P
    flat = [x.contiguous().reshape(P, -1) for x in xs]
    return [o.reshape((n,) + tuple(shape[1:]))
            for o in ring_ops.ring_reduce_scatter(flat)]


def ring_all_gather(xs: Sequence[torch.Tensor]) -> list:
    """Ring all-gather: each member's [n, ...] -> [P * n, ...] in rank
    order, P - 1 relay steps (ops/ring.py)."""
    P = len(xs)
    shape = xs[0].shape
    flat = [x.contiguous().reshape(-1) for x in xs]
    return [o.reshape((P * shape[0],) + tuple(shape[1:]))
            for o in ring_ops.ring_all_gather(flat)]


def ring_all_reduce(xs: Sequence[torch.Tensor]) -> list:
    """Ring reduce-scatter then ring all-gather; P divides x.shape[0]."""
    return ring_all_gather(ring_reduce_scatter(xs))


def hierarchical_all_reduce(xs) -> list:
    """Two-level all-reduce over ``xs[d][i]`` (d over the slow axis, i
    over the fast one): reduce-scatter inside each fast group, all-reduce
    the shards across groups, all-gather back inside each group."""
    shards = [reduce_scatter(row) for row in xs]
    across = [all_reduce([shards[d][i] for d in range(len(xs))])[0]
              for i in range(len(xs[0]))]
    return [all_gather(across) for _ in xs]
