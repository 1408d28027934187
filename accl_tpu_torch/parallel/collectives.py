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
:func:`spread`, :func:`fan_out`, :func:`gather_sum` (and
:func:`own_card_sums`) and :func:`collect` are the crossings of a value
every card holds in the models' layers over cards (:func:`fan_in` where
one card sums): each card's copy carries a gradient, and the backwards
fold in a fixed order, so each card's gradient is bitwise the one-card
model's.

Members in several processes (a mesh over processes, after
``utils.bringup.initialize_multihost``): every function takes one entry
per member as before, ``None`` for a member another process holds (the
counterpart of a global ``jax.Array``'s addressable shards), with
``devices=`` naming every member's device (the mesh's ``devices``: a
``ProcessDevice`` for another process's member), and returns its own
members' results (``None`` for the others').  Every process must make
the same calls in the same order over the same lists, as with any
collective library (a mismatch raises ``ACCLError`` at its first
crossing).  Each crossing between two processes is a :func:`move` that
both run: the sender sees a local source and a remote destination, the
receiver the reverse (``utils/ipc.py``: a shared file on the CPU, a CUDA
IPC staging buffer on the card).  It is counted in :func:`moves` by each
of the two processes, and also in :func:`process_moves`; a crossing
between two members of another process is nobody's here.  The folds and
their order are the one-process forms', so the results are bitwise the
one-process mesh's.  Across processes, with k members outside member
0's process (``root``'s for a broadcast and a scatter): an all-reduce
makes 2 k crossings between processes (its fold on member 0's card, its
result sent back); a broadcast and a scatter k; an all-gather, a
reduce-scatter and an all-to-all one for each pair of members in two
processes, both ways.  The ``ring_*`` schedules cross in the kernels
(the cross-process form of ``ops/ring.py``) on the card, and as
messages of the transport in their plain versions on the CPU, none of
them a :func:`move`.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from ..constants import ACCLError
from ..ops import ring as ring_ops
from ..utils import ipc

_moves_lock = threading.Lock()
_moves = 0
_process_moves = 0


def moves() -> int:
    """Crossings from one member to another since the last
    :func:`reset_moves` (forward and backward) that this process took
    part in."""
    return _moves


def process_moves() -> int:
    """Of :func:`moves`, the crossings between this process and another
    one."""
    return _process_moves


def reset_moves() -> None:
    """Set the counts of :func:`moves` and :func:`process_moves` to 0."""
    global _moves, _process_moves
    with _moves_lock:
        _moves = _process_moves = 0


def _count(n: int = 1, across: bool = False) -> None:
    global _moves, _process_moves
    with _moves_lock:
        _moves += n
        if across:
            _process_moves += n


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _cross(t: torch.Tensor, device, src, dst) -> torch.Tensor:
    """Every counted crossing: ``t`` to ``device``, from card ``src`` to
    card ``dst`` (the cards' indices where the caller knows them, cards
    numbered in the order of their first rank, 0 the hub; else the
    devices)."""
    _count()
    return _to(t, device)


class _Move(torch.autograd.Function):
    """A counted crossing; its gradient crosses back, counted too."""

    @staticmethod
    def forward(ctx, t, device):
        ctx.src = t.device
        return _cross(t, device, t.device, device)

    @staticmethod
    def backward(ctx, g):
        return _cross(g, ctx.src, g.device, ctx.src), None


def move(t: Optional[torch.Tensor], device, src=None):
    """The one point where a tensor goes from one member to another: a
    copy onto ``device`` when ``t`` lies elsewhere (a peer copy, which
    PyTorch orders after both cards' current streams), ``t`` itself when
    it lies there already.  Counted in :func:`moves` either way, so a
    test on the CPU can count what each function moves.  Differentiable:
    the gradient crosses back, counted.

    Across processes ``device``, or the source (``t``'s device, or
    ``src`` where ``t`` is ``None``, another process's member), is a
    ``ProcessDevice`` of another process: the crossing is a send (``t``
    here, ``device`` there: returns ``None``), a receive (``t`` ``None``,
    ``src`` there, ``device`` here: returns the tensor), or nothing of
    this process's (both there: ``None``).  Both processes run it, in the
    same order (module docstring).  No gradient crosses processes."""
    source = t.device if t is not None else src
    if source is None:
        raise ValueError("move(None, ...) needs src=, the member's device")
    there, here = ipc.is_remote(source), not ipc.is_remote(device)
    if not there and here:
        if t is None:
            raise ValueError(f"move: no tensor for the member on {source}")
        return _Move.apply(t, ipc.local(device))
    if there and not here:
        return None
    _count(across=True)
    tr = ipc.transport()
    if not there:
        if t.requires_grad and torch.is_grad_enabled():
            raise ACCLError("move: a tensor that requires a gradient cannot "
                            "cross processes (no gradient crosses them)")
        tr.send(t, device.process_index)
        return None
    return tr.recv(source.process_index, ipc.local(device))


def _move(t: Optional[torch.Tensor], device, src):
    """:func:`move` of a member's value ``t`` (``None``: another
    process's, on ``src``)."""
    return move(t, device) if t is not None else move(t, device, src)


def _both(fold):
    """``fold`` of two values of one member, ``None`` where another
    process holds it."""
    return lambda a, b: None if a is None or b is None else fold(a, b)


def card_homes(devices) -> list:
    """Each rank's card, named by the first rank on it; every CPU rank is
    a card of its own (the CPU stands for as many cards as it is
    named)."""
    first = {}
    return [r if torch.device(d).type == "cpu"
            else first.setdefault(torch.device(d), r)
            for r, d in enumerate(devices)]


def _cards_of(copies) -> tuple:
    """The distinct tensors of ``copies`` (one a card: ranks that share a
    card share its tensor), in the order of their first rank, and each
    rank's index among them."""
    uniq, idx = [], []
    for t in copies:
        for i, u in enumerate(uniq):
            if u is t:
                idx.append(i)
                break
        else:
            idx.append(len(uniq))
            uniq.append(t)
    return uniq, tuple(idx)


def _fold_chain(grads, idx, uses, devices) -> list:
    """The uses' gradients folded in the one-card order, the last use of
    the last rank first, along the cards: the fold crosses to the next
    rank's card wherever it differs from the fold's (a counted move), and
    ends on rank 0's card; then it goes back along the cards, card 1 from
    card 0, card 2 from card 1, ..., so that every card holds it."""
    total, at = None, None
    for i in reversed(range(len(grads))):
        c = idx[i // uses]
        if total is not None and c != at:
            total = _cross(total, devices[c], at, c)
        total = grads[i] if total is None else total + grads[i]
        at = c
    out = [total]
    for c in range(1, len(devices)):
        out.append(_cross(out[-1], devices[c], c - 1, c))
    return out


class _FanOut(torch.autograd.Function):
    """Each rank's ``uses`` views of its card's copy; the backward folds
    every use's gradient in the one-card order and gives the fold to
    every card's copy (:func:`_fold_chain`)."""

    @staticmethod
    def forward(ctx, idx, uses, *cards):
        ctx.idx, ctx.uses = idx, uses
        ctx.devices = [t.device for t in cards]
        return tuple(cards[c].view_as(cards[c]) for c in idx
                     for _ in range(uses))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *_fold_chain(grads, ctx.idx, ctx.uses, ctx.devices))


def fan_out(copies: Sequence[torch.Tensor], uses: int = 1) -> list:
    """One tensor as the ranks hold it, ``copies[r]`` on rank r's card
    (the same values; ranks that share a card pass the same tensor),
    handed to its consumers: rank r's entries are ``out[r * uses:(r + 1)
    * uses]``, one view of its copy for each of its ``uses`` consumers,
    in the order it consumes them.  Nothing moves forward.

    The backward folds every use's gradient in one fixed order, the last
    use of the last rank first: the order in which autograd accumulates
    the uses of one tensor consumed on one card by the same consumers,
    so the fold is the one-card model's and does not depend on the order
    in which the cards finish their backward work.  Every card's copy
    gets the whole fold as its gradient (the gradient of a replicated
    value, psummed over the ranks, stays on each card).  The fold runs
    along the cards in rank order: the card of the last rank folds its
    ranks' uses and hands the partial fold to the card of the rank
    before, and so on to rank 0's card, which holds the whole fold (a
    counted move wherever the next rank's card differs; ranks that share
    a card fold there without one); then the fold goes back along the
    cards, a counted move a card.  (An all-gather of every use's
    gradient, folded on each card, moves P - 1 times the bytes and timed
    no faster on four H100s: ``bench/model_cards.py``.)"""
    if len(copies) == 1 and uses == 1:
        return [copies[0]]
    uniq, idx = _cards_of(copies)
    return list(_FanOut.apply(idx, uses, *uniq))


def fan_in(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The members' ``parts`` summed on member 0's card (``device``) in
    member order, ((p0 + p1) + p2) + ..., the fold of the one-card
    :func:`all_reduce`: len(parts) - 1 counted moves (and as many back
    in the backward)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + move(p, device)
    return total


class _OwnCard(torch.autograd.Function):
    """Per-card results of ``combine(parts)`` (computed without
    autograd); the backward gives each part the gradient of the result on
    its own card (``homes[r]``: the index of rank r's card among the
    results), with no crossing: the transpose of a psum, whose gradient
    stays on each chip."""

    @staticmethod
    def forward(ctx, combine, homes, *parts):
        ctx.homes = homes
        return tuple(combine(parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(grads[h] for h in ctx.homes))


def own_card_sums(combine, parts: Sequence[torch.Tensor],
                  homes: Sequence[int]) -> list:
    """``combine(parts)``, a list of results one a card, each result with
    a gradient: part r takes that of result ``homes[r]``, on its own
    card (the same value on every card).  Every result must then reach
    the loss, as every card's stream does."""
    return list(_OwnCard.apply(combine, tuple(homes), *parts))


def _gather_sums(at, parts) -> list:
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
    return sums


def gather_sum(parts: Sequence[torch.Tensor], at: Sequence[int],
               homes: Sequence[int]) -> list:
    """The members' ``parts`` summed in member order, ((p0 + p1) + p2) +
    ..., on the card of each member in ``at`` (``at[0]`` = 0): every part
    reaches those cards by the ring all-gather (on several cards its
    cross-card mode, one launch a card; its hops move nothing through
    :func:`move`).  The sums have :func:`fan_in`'s bits.  Every sum
    carries a gradient: part r takes that of the sum on its own card,
    ``at[homes[r]]``, with no crossing, as a psum's gradient stays on
    each chip; so every sum must reach the loss.  The parts' bytes must
    be a whole number of 32-bit words."""
    at = tuple(at)
    return own_card_sums(lambda ps: _gather_sums(at, ps), parts, homes)


class _Spread(torch.autograd.Function):
    """The hub's tensor copied to every other card; the backward passes
    the hub's gradient alone."""

    @staticmethod
    def forward(ctx, x, devices):
        out = [x.view_as(x)]
        for c in range(1, len(devices)):
            t = _cross(x, devices[c], 0, c)
            out.append(t.view_as(t) if t is x else t)
        return tuple(out)

    @staticmethod
    def backward(ctx, g, *_others):
        return g, None


def spread(x: torch.Tensor, devices: Sequence) -> list:
    """``x`` (on ``devices[0]``, the hub) as every card holds it: ``x``
    on the hub, a copy on each other card of ``devices`` (a counted move
    each).  Each copy carries a gradient, but the backward passes on the
    hub's alone: the others are the same value (every card's stream
    folds the same gradient), so nothing is counted twice and nothing
    crosses."""
    return list(_Spread.apply(x, tuple(torch.device(d) for d in devices)))


class _Collect(torch.autograd.Function):
    """The hub's copy forward; its gradient to every copy."""

    @staticmethod
    def forward(ctx, *copies):
        ctx.devices = [c.device for c in copies]
        return copies[0].view_as(copies[0])

    @staticmethod
    def backward(ctx, g):
        return (g, *(_cross(g, d, 0, c)
                     for c, d in enumerate(ctx.devices) if c))


def collect(copies: Sequence[torch.Tensor]) -> torch.Tensor:
    """The hub's copy of a value every card holds (``copies[0]``), on to
    what the hub alone computes.  The backward hands its gradient to
    every copy (a counted move each but the hub's): every card's copy
    reaches the loss, so every card runs its own backward."""
    return _Collect.apply(*copies)


def _placement(xs: Sequence[torch.Tensor], devices) -> Optional[list]:
    """Each member's device when the members are on several cards
    (``devices`` given, or the tensors on more than one device), else
    None: the one-card path.  Another process's member keeps its
    ``ProcessDevice`` (its entry of ``xs`` must be ``None``)."""
    if devices is not None:
        devs = [d if ipc.is_remote(d) else ipc.local(d) for d in devices]
        if len(devs) != len(xs):
            raise ValueError(f"{len(xs)} members, {len(devs)} devices")
        for r, (x, d) in enumerate(zip(xs, devs)):
            if (x is None) != ipc.is_remote(d):
                raise ValueError(f"member {r} on {d}: "
                                 f"{'None' if x is None else 'a tensor'} "
                                 f"given")
        return devs
    if any(x is None for x in xs):
        raise ValueError("a None member needs devices= naming its process")
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
        fold = _both(_fold_op(op))
        total = xs[0]
        for s, x in enumerate(xs[1:], 1):
            total = fold(total, _move(x, devs[0], devs[s]))
        if op == "mean" and total is not None:
            total = total / len(xs)
        return [total] + [_move(total, d, devs[0]) for d in devs[1:]]
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


def _gathered(xs, devs, r: int, combine) -> Optional[torch.Tensor]:
    """Member r's ``combine`` of every member's value, each other
    member's moved straight to it (``None`` for another process's
    member)."""
    parts = [x if s == r else _move(x, devs[r], devs[s])
             for s, x in enumerate(xs)]
    return None if any(p is None for p in parts) else combine(parts)


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
        blocks = [None if x is None else torch.chunk(x, P, dim=scatter_axis)
                  for x in xs]
        add = _both(torch.add)

        def block(s, r):
            b = None if blocks[s] is None else blocks[s][r]
            return b if s == r else _move(b, devs[r], devs[s])

        out = []
        for r in range(P):
            total = block(0, r)
            for s in range(1, P):
                total = add(total, block(s, r))
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
        parts = [None if x is None else torch.chunk(x, P, dim=split_axis)
                 for x in xs]
    else:
        parts = [None if x is None else
                 [x.select(split_axis, r) for r in range(P)] for x in xs]

    def block(s: int, r: int) -> torch.Tensor:
        b = None if parts[s] is None else parts[s][r]
        return b if devs is None or s == r else _move(b, devs[r], devs[s])

    join = torch.cat if tiled else torch.stack
    out = []
    for r in range(P):
        got = [block(s, r) for s in range(P)]
        out.append(None if any(b is None for b in got)
                   else join(got, dim=concat_axis))
    return out


def broadcast(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Every member gets the root's value."""
    devs = _placement(xs, devices)
    if devs is not None:
        return [xs[root] if r == root else
                _move(xs[root], devs[r], devs[root]) for r in range(len(xs))]
    return [xs[root]] * len(xs)


def scatter(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Member i gets block i of the root's value (leading dim = P)."""
    devs = _placement(xs, devices)
    if devs is not None:
        src = xs[root]
        blocks = [None] * len(xs) if src is None else list(src)
        return [blocks[i] if i == root else
                _move(blocks[i], devs[i], devs[root])
                for i in range(len(xs))]
    return [xs[root][i] for i in range(len(xs))]


def gather(xs: Sequence[torch.Tensor], root: int, devices=None) -> list:
    """Every member's block, stacked; the caller keeps the root's copy."""
    return all_gather(xs, tiled=False, devices=devices)


def ppermute(xs: Sequence[torch.Tensor], perm, devices=None) -> list:
    """Point-to-point permutation: ``dst`` gets ``src``'s value for each
    (src, dst) pair; members that receive nothing get zeros."""
    devs = _placement(xs, devices)
    out = [None if x is None else torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = (xs[src] if devs is None or src == dst
                    else _move(xs[src], devs[dst], devs[src]))
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
        return all_reduce([None if ipc.is_remote(d) else
                           torch.ones((), dtype=torch.int32, device=d)
                           for d in devs], devices=devs)
    one = torch.ones((), dtype=torch.int32, device=xs[0].device)
    return all_reduce([one] * len(xs))


# ---------------------------------------------------------------------------
# explicit ring schedules
# ---------------------------------------------------------------------------
def _first(xs) -> torch.Tensor:
    return next(x for x in xs if x is not None)


def ring_reduce_scatter(xs: Sequence[torch.Tensor], devices=None) -> list:
    """Ring reduce-scatter: each member's [P * n, ...] -> its reduced chunk
    [n, ...], P - 1 steps of the ring (ops/ring.py; members on several
    cards take the kernels' cross-card mode, members of several processes
    its cross-process form, with ``devices``)."""
    P = len(xs)
    shape = _first(xs).shape
    n = shape[0] // P
    flat = [None if x is None else x.contiguous().reshape(P, -1) for x in xs]
    return [None if o is None else o.reshape((n,) + tuple(shape[1:]))
            for o in ring_ops.ring_reduce_scatter(flat, devices=devices)]


def ring_all_gather(xs: Sequence[torch.Tensor], devices=None) -> list:
    """Ring all-gather: each member's [n, ...] -> [P * n, ...] in rank
    order, P - 1 relay steps (ops/ring.py; members on several cards take
    the kernels' cross-card mode, members of several processes its
    cross-process form, with ``devices``)."""
    P = len(xs)
    shape = _first(xs).shape
    flat = [None if x is None else x.contiguous().reshape(-1) for x in xs]
    return [None if o is None else o.reshape((P * shape[0],)
                                             + tuple(shape[1:]))
            for o in ring_ops.ring_all_gather(flat, devices=devices)]


def ring_all_reduce(xs: Sequence[torch.Tensor], devices=None) -> list:
    """Ring reduce-scatter then ring all-gather; P divides x.shape[0]."""
    return ring_all_gather(ring_reduce_scatter(xs, devices), devices)


def hierarchical_all_reduce(xs, devices=None) -> list:
    """Two-level all-reduce over ``xs[d][i]`` (d over the slow axis, i
    over the fast one): reduce-scatter inside each fast group, all-reduce
    the shards across groups, all-gather back inside each group.
    ``devices[d][i]``: member (d, i)'s device, for members on several
    cards or processes (``None`` in ``xs`` for another process's member;
    with the slow axis over the processes, the all-reduce across groups
    makes every crossing between them: 2 k per fast member i, k the slow
    members outside member (0, i)'s process)."""
    D, F = len(xs), len(xs[0])
    devs = devices
    if devs is None and len({x.device for row in xs for x in row}) > 1:
        devs = [[x.device for x in row] for row in xs]
    if devs is None and any(x is None for row in xs for x in row):
        raise ValueError("a None member needs devices= naming its process")
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
