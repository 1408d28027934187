"""Functional collectives over rank lists, on one card or on several.

Port of ``accl_tpu/parallel/collectives.py``.  There each function runs
inside ``shard_map`` on one member's value and lowers to an XLA
collective over a mesh axis.  Here the axis is the list itself: every
function takes one tensor per member, in rank order, and returns one per
member.  The XLA lowerings become torch ops over the list; members that
end with the same value share one tensor.  The explicit ``ring_*``
schedules go through ``accl_tpu_torch/ops/ring.py``: its CUDA kernels on
the card, its plain versions on the CPU, with the JAX schedule's chunk
order (chunk ``(r - 1)`` first, then ``(r - 2 - s)`` at step ``s``).

Members on several cards (their tensors on more than one device, or
``devices=`` given, as a mesh's ``devices`` or ``["cpu"] * P`` on the
CPU): every function returns member r's result as its own tensor on
``devices[r]``, and every crossing from one member to another goes
through :func:`move`, which counts it (``moves()``; the twin of
``CudaEngine._move``): a copy onto the other card, or the tensor itself
when both members share one.  Reductions fold in rank order, so they are
bitwise the one-card forms.  A reduction folds on member 0's card and
sends each member the result (2 (P - 1) moves); a gather, a
reduce-scatter and an all-to-all send each member's block straight to
the members that need it (P (P - 1) moves); a broadcast and a scatter
move P - 1 tensors from the root.  The ``ring_*`` schedules reach the
ring kernels' cross-card mode (``ops/ring.py``), whose hops are stores
over NVLink inside the kernel: they move nothing through :func:`move`.
:func:`fan_out`, :func:`fan_in` and :func:`gather_sum` are the
crossings of the models' layers over cards, each with a backward that
folds in a fixed order.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from ..ops import ring as ring_ops

_moves_lock = threading.Lock()
_moves = 0


def moves() -> int:
    """Crossings from one member to another since the last
    :func:`reset_moves` (forward and backward)."""
    return _moves


def reset_moves() -> None:
    """Set the count of :func:`moves` to 0."""
    global _moves
    with _moves_lock:
        _moves = 0


def _count(n: int = 1) -> None:
    global _moves
    with _moves_lock:
        _moves += n


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


class _Move(torch.autograd.Function):
    """A counted crossing; its gradient crosses back, counted too."""

    @staticmethod
    def forward(ctx, t, device):
        ctx.src = t.device
        _count()
        return _to(t, device)

    @staticmethod
    def backward(ctx, g):
        _count()
        return _to(g, ctx.src), None


def move(t: torch.Tensor, device) -> torch.Tensor:
    """The one point where a tensor goes from one member to another: a
    copy onto ``device`` when ``t`` lies elsewhere (a peer copy, which
    PyTorch orders after both cards' current streams), ``t`` itself when
    it lies there already.  Counted in :func:`moves` either way, so a
    test on the CPU can count what each function moves.  Differentiable:
    the gradient crosses back, counted."""
    return _Move.apply(t, torch.device(device))


class _FanOut(torch.autograd.Function):
    """Each member's copy, ``uses`` views a member; the backward folds
    every use's gradient on member 0's card, the last use of the last
    member first, into member 0's copy."""

    @staticmethod
    def forward(ctx, t, copies, uses):
        ctx.hub, ctx.uses = t.device, uses
        return tuple(c.view_as(c) for c in (t,) + copies
                     for _ in range(uses))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for i in reversed(range(len(grads))):
            g = grads[i]
            if i >= ctx.uses:  # another member's use crosses back
                _count()
                g = _to(g, ctx.hub)
            total = g if total is None else total + g
        return total, None, None


def fan_out(copies: Sequence[torch.Tensor], uses: int = 1) -> list:
    """One tensor as the members hold it, ``copies[r]`` on member r's
    card (the same values; member 0's carries the gradient, the others
    none), handed to its consumers: member r's entries are
    ``out[r * uses:(r + 1) * uses]``, one view of its copy for each of
    its ``uses`` consumers, in the order it consumes them.  Nothing moves
    forward.  The backward brings every use's gradient to member 0's
    card (a counted move each, apart from member 0's) and sums them
    there in one fixed order, the last use of the last member first: the
    order in which autograd accumulates the uses of one tensor consumed
    on one card by the same consumers, so the fold is the one-card
    model's and does not depend on the order in which the cards finish
    their backward work."""
    if len(copies) == 1 and uses == 1:
        return [copies[0]]
    return list(_FanOut.apply(copies[0], tuple(copies[1:]), uses))


def fan_in(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The members' ``parts`` summed on member 0's card (``device``) in
    member order, ((p0 + p1) + p2) + ..., the fold of the one-card
    :func:`all_reduce`: len(parts) - 1 counted moves (and as many back
    in the backward)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + move(p, device)
    return total


class _GatherSum(torch.autograd.Function):
    """Every member's part to the members ``at`` by the ring all-gather,
    summed there in member order; the first sum carries the gradient."""

    @staticmethod
    def forward(ctx, at, *parts):
        ctx.devices = [p.device for p in parts]
        n, shape, dt = parts[0].numel(), parts[0].shape, parts[0].dtype
        # the all-gather moves bits: 32-bit words whatever the dtype
        words = [p.contiguous().reshape(-1).view(torch.int32) for p in parts]
        gathered = ring_ops.ring_all_gather(words)
        sums = []
        for a in at:
            g = gathered[a].view(dt)
            total = g[0]
            for r in range(1, len(parts)):
                total = total + g[r]
            sums.append(total.view(shape))
        ctx.mark_non_differentiable(*sums[1:])
        return tuple(sums)

    @staticmethod
    def backward(ctx, g, *_others):
        grads = [g]
        for d in ctx.devices[1:]:  # fan_in's backward: the sum's crosses
            _count()
            grads.append(_to(g, d))
        return (None, *grads)


def gather_sum(parts: Sequence[torch.Tensor], at: Sequence[int]) -> list:
    """The members' ``parts`` summed in member order, ((p0 + p1) + p2) +
    ..., on the card of each member in ``at`` (``at[0]`` = 0): every part
    reaches those cards by the ring all-gather (on several cards its
    cross-card mode, one launch a card; its hops move nothing through
    :func:`move`).  The sums have :func:`fan_in`'s bits; the first
    carries the gradient, as :func:`fan_in`'s does (the others none).
    The parts' bytes must be a whole number of 32-bit words."""
    return list(_GatherSum.apply(tuple(at), *parts))


def _placement(xs: Sequence[torch.Tensor], devices) -> Optional[list]:
    """Each member's device when the members are on several cards
    (``devices`` given, or the tensors on more than one device), else
    None: the one-card path."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != len(xs):
            raise ValueError(f"{len(xs)} members, {len(devs)} devices")
        return devs
    devs = [x.device for x in xs]
    return devs if len(set(devs)) > 1 else None


def _fold_op(op: str):
    if op == "max":
        return torch.maximum
    if op == "min":
        return torch.minimum
    return torch.add


# ---------------------------------------------------------------------------
# direct lowerings
# ---------------------------------------------------------------------------
def all_reduce(xs: Sequence[torch.Tensor], op: str = "sum",
               devices=None) -> list:
    """All-reduce over the members (psum / pmax / pmin / pmean)."""
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"unknown reduce op {op!r}")
    devs = _placement(xs, devices)
    if devs is not None:
        fold = _fold_op(op)
        total = xs[0]
        for x in xs[1:]:
            total = fold(total, move(x, devs[0]))
        if op == "mean":
            total = total / len(xs)
        return [total] + [move(total, d) for d in devs[1:]]
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


def reduce(xs: Sequence[torch.Tensor], root: int, op: str = "sum",
           devices=None) -> list:
    """Rooted reduce: every member computes the reduction, the caller
    keeps the root's copy."""
    return all_reduce(xs, op, devices)


def _gathered(xs, devs, r: int, combine) -> torch.Tensor:
    """Member r's ``combine`` of every member's value, each other
    member's moved straight to it."""
    return combine([x if s == r else move(x, devs[r])
                    for s, x in enumerate(xs)])


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = True,
               gather_axis: int = 0, devices=None) -> list:
    """All-gather: concatenated along ``gather_axis`` (tiled) or stacked
    on a new axis there."""
    def combine(parts):
        return (torch.cat(list(parts), dim=gather_axis) if tiled
                else torch.stack(list(parts), dim=gather_axis))

    devs = _placement(xs, devices)
    if devs is not None:
        return [_gathered(xs, devs, r, combine) for r in range(len(xs))]
    out = combine(xs)
    return [out] * len(xs)


def reduce_scatter(xs: Sequence[torch.Tensor], scatter_axis: int = 0,
                   devices=None) -> list:
    """Reduce-scatter: member r gets block r of the sum, split along
    ``scatter_axis``."""
    devs = _placement(xs, devices)
    if devs is not None:
        P = len(xs)
        blocks = [torch.chunk(x, P, dim=scatter_axis) for x in xs]
        out = []
        for r in range(P):
            total = blocks[0][r] if r == 0 else move(blocks[0][r], devs[r])
            for s in range(1, P):
                b = blocks[s][r]
                total = total + (b if s == r else move(b, devs[r]))
            out.append(total)
        return out
    total = all_reduce(xs)[0]
    return list(torch.chunk(total, len(xs), dim=scatter_axis))


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True,
               devices=None) -> list:
    """Personalized exchange: member r gets block r of every member's
    value, concatenated along ``concat_axis`` (tiled), or with
    ``tiled=False`` (``x.shape[split_axis]`` = P) stacked on a new axis at
    ``concat_axis`` after ``split_axis`` is removed."""
    P = len(xs)
    devs = _placement(xs, devices)
    if tiled:
        parts = [torch.chunk(x, P, dim=split_axis) for x in xs]
    else:
        parts = [[x.select(split_axis, r) for r in range(P)] for x in xs]

    def block(s: int, r: int) -> torch.Tensor:
        b = parts[s][r]
        return b if devs is None or s == r else move(b, devs[r])

    if tiled:
        return [torch.cat([block(s, r) for s in range(P)], dim=concat_axis)
                for r in range(P)]
    return [torch.stack([block(s, r) for s in range(P)], dim=concat_axis)
            for r in range(P)]


def broadcast(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Every member gets the root's value."""
    devs = _placement(xs, devices)
    if devs is not None:
        return [xs[root] if r == root else move(xs[root], devs[r])
                for r in range(len(xs))]
    return [xs[root]] * len(xs)


def scatter(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Member i gets block i of the root's value (leading dim = P)."""
    devs = _placement(xs, devices)
    if devs is not None:
        return [xs[root][i] if i == root else move(xs[root][i], devs[i])
                for i in range(len(xs))]
    return [xs[root][i] for i in range(len(xs))]


def gather(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Every member's block, stacked; the caller keeps the root's copy."""
    return all_gather(xs, tiled=False, devices=devices)


def ppermute(xs: Sequence[torch.Tensor], perm, devices=None) -> list:
    """Point-to-point permutation: ``dst`` gets ``src``'s value for each
    (src, dst) pair; members that receive nothing get zeros."""
    devs = _placement(xs, devices)
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = (xs[src] if devs is None or src == dst
                    else move(xs[src], devs[dst]))
    return out


def send_recv(xs: Sequence[torch.Tensor], src: int, dst: int,
              devices=None) -> list:
    """``dst`` gets ``src``'s value, every other member zeros."""
    return ppermute(xs, [(src, dst)], devices)


def barrier(xs: Sequence[torch.Tensor], devices=None) -> list:
    """A trivial sum over the members (any collective is a sync): each
    gets the member count."""
    devs = _placement(xs, devices)
    if devs is not None:
        return all_reduce([torch.ones((), dtype=torch.int32, device=d)
                           for d in devs], devices=devs)
    one = torch.ones((), dtype=torch.int32, device=xs[0].device)
    return all_reduce([one] * len(xs))


# ---------------------------------------------------------------------------
# explicit ring schedules
# ---------------------------------------------------------------------------
def ring_reduce_scatter(xs: Sequence[torch.Tensor]) -> list:
    """Ring reduce-scatter: each member's [P * n, ...] -> its reduced chunk
    [n, ...], P - 1 steps of the ring (ops/ring.py; members on several
    cards take the kernels' cross-card mode)."""
    P = len(xs)
    shape = xs[0].shape
    n = shape[0] // P
    flat = [x.contiguous().reshape(P, -1) for x in xs]
    return [o.reshape((n,) + tuple(shape[1:]))
            for o in ring_ops.ring_reduce_scatter(flat)]


def ring_all_gather(xs: Sequence[torch.Tensor]) -> list:
    """Ring all-gather: each member's [n, ...] -> [P * n, ...] in rank
    order, P - 1 relay steps (ops/ring.py; members on several cards take
    the kernels' cross-card mode)."""
    P = len(xs)
    shape = xs[0].shape
    flat = [x.contiguous().reshape(-1) for x in xs]
    return [o.reshape((P * shape[0],) + tuple(shape[1:]))
            for o in ring_ops.ring_all_gather(flat)]


def ring_all_reduce(xs: Sequence[torch.Tensor]) -> list:
    """Ring reduce-scatter then ring all-gather; P divides x.shape[0]."""
    return ring_all_gather(ring_reduce_scatter(xs))


def hierarchical_all_reduce(xs, devices=None) -> list:
    """Two-level all-reduce over ``xs[d][i]`` (d over the slow axis, i
    over the fast one): reduce-scatter inside each fast group, all-reduce
    the shards across groups, all-gather back inside each group.
    ``devices[d][i]``: member (d, i)'s device, for members on several
    cards."""
    D, F = len(xs), len(xs[0])
    devs = devices
    if devs is None and len({x.device for row in xs for x in row}) > 1:
        devs = [[x.device for x in row] for row in xs]
    if devs is None:
        shards = [reduce_scatter(row) for row in xs]
        across = [all_reduce([shards[d][i] for d in range(D)])[0]
                  for i in range(F)]
        return [all_gather(across) for _ in xs]
    shards = [reduce_scatter(row, devices=devs[d]) for d, row in enumerate(xs)]
    across = [all_reduce([shards[d][i] for d in range(D)],
                         devices=[devs[d][i] for d in range(D)])
              for i in range(F)]
    return [all_gather([across[i][d] for i in range(F)], devices=devs[d])
            for d in range(D)]
