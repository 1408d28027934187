"""The flagship transformer LM: forward, loss and the train step.

Port of ``accl_tpu/models/transformer.py``.  Tensor parallelism runs over
P ranks held as lists (the convention of ``ops/fused.py``): the head and
hidden shards of each block (q/k/v, attention, ``wo``, ``w1``, ``w3``,
``w2``) are one tensor per rank, split as ``param_specs`` says.  The
values JAX replicates over the ``tp`` axis (the residual stream, the
norms, the embedding and the logits) are held once.  The row-parallel
combine after the attention-out and MLP-down projections is the sum over
the rank list (``lax.psum``'s role), or with ``fused=True`` the pipelined
``ops.fused.fused_matmul_allreduce``.  The projections are
``torch.matmul``, as the JAX package leaves them to XLA.

Parameters are a plain dict in the JAX pytree's layout, the sharded
leaves replaced by rank lists (``shard_params``).  ``attn="flash"`` runs
the flash kernels of ``ops/flash.py``, backward included; ``attn="dense"``
the dense reference.  ``remat`` checkpoints each block.

Training (``make_train_step``) holds the parameters once for all data
members: each member's local ``(loss_sum, count)`` is backpropagated in
turn, and autograd's accumulation into the shared leaves sums the
replicated gradients over the members, the role JAX's replication-aware
transpose plays; the tp-sharded leaves keep per-shard gradients.  The SGD
update, or an optimizer's (``accl_tpu_torch.optim.adamw``, the JAX
package's optax path), is applied in place.

Sequence parallelism (``sp`` > 1) splits the sequence into ``sp``
members' shards for attention only: ``forward`` takes the global tokens
in the schedule's layout (natural for ``sp_schedule="contiguous"``,
permuted by ``parallel.ring_attention.zigzag_indices`` for "zigzag"),
holds the residual stream once, and for each tp rank's heads runs
``ring_attention`` over the shards of its q/k/v.  The token-wise layers
compute the same rows the members would.  ``loss_fn`` takes each shard's
last label from the next shard, as the JAX package's sp arm does.

Meshes over several cards (a ``RankMesh`` with ``devices``, the
counterpart of the JAX package's ``Mesh`` over chips): ``place_params``
(or ``init_params``/``shard_params`` with ``mesh=``) puts tp rank r's
shards on the card of the mesh slot (d, r) of data member d, the
replicated leaves on the card of rank 0, the member's hub, and a copy of
each block's norms on every other card; the result is a
``PlacedParams`` (the dict of the one-card layout, with its ``places``),
or with a ``dp`` axis a ``Replicas`` list of one per member.
``forward`` embeds on the hub and copies the residual stream to every
card once; then each card norms its own stream, each rank projects,
attends and multiplies on its own card (its flash kernels there), and
every rank's row-parallel partial goes to every card, which sums the
partials in rank order (the fold of the one-card combine) into its own
stream, so every card's stream and the hub's logits are bitwise the
one-card forward's.  Every crossing is a counted ``collectives.move``.
Every card's stream carries a gradient of its own and every card runs
its own backward, as every chip does under ``shard_map``: the hub's last
stream goes on to the final norm and the logits through
``collectives.collect``, whose backward hands the stream's gradient to
every card once; ``collectives.fan_out`` hands each rank one view per
projection that reads its card's normed stream, and its backward folds
their gradients in the order autograd accumulates the same projections
of one tensor on one card (the last projection of the last rank first),
along the cards from the last rank's to the hub, then gives the fold
back to every card; each rank's row-parallel partial takes the gradient
of its own card's sum (``collectives.gather_sum``, a psum's transpose);
the spread of the embedded stream passes the hub's gradient alone into
the embedding.  Every card's stream gradient is the one-card model's
bit for bit, and only the hub's norm scales collect gradients (the other
cards' copies are detached).  So a step over cards is bitwise the
one-card step.  The train step over such a mesh (``make_train_step``)
backpropagates each data member on its own cards, folds the members'
gradients leaf by leaf in member order on member 0's cards (``(g0 + g1)
+ ...``, the one-card step's accumulation), and sends each member the
mean, so every replica takes the same update and stays bitwise equal to
the others.

A mesh with an sp axis over cards (dp x tp x sp) places one tree per
(data member d, sp member s), an :class:`SpReplicas` per data member:
tp rank r's shards on slot (d, r, s)'s card.  Member s's residual
stream is its shard of the sequence (the schedule's layout), held on
the cards of its tp group as above; the attention of tp rank r is
``ring_attention`` over the sp group (d, r, ·), each member on its card;
the row-parallel combines never leave a tp group.  ``loss_fn`` sums each
shard on its hub, its labels split from the whole sequence's as its
tokens are.  The step runs one backward over a data member's shard
losses and folds every leaf's gradients over the (d, s) trees in order
on the first tree's cards, then sends the mean to every copy.  The
forward is bitwise the one-card ``forward(sp=)``; the loss and the
gradients fold per shard, a different summation from the one-card
step's single sum and full-sequence products.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash import flash_attention
from ..ops.fused import fused_chunks, fused_matmul_allreduce
from ..constants import ACCLError
from ..optim import apply_updates
from ..parallel.collectives import (_both, _move, all_reduce, card_homes,
                                    collect, fan_in, fan_out, gather_sum,
                                    move, spread)
from ..parallel.ring_attention import (_dense_attention, expand_gqa_kv,
                                       ring_attention, zigzag_indices,
                                       zigzag_indices_inverse)
from ..utils import ipc
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ModelConfig, with the same fields, defaults and
    validation."""

    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: Optional[int] = None
    d_head: int = 32
    d_ff: int = 512
    dtype: str = "float32"
    attn: str = "dense"
    sp_schedule: str = "contiguous"
    attn_window: Optional[int] = None
    mlp: str = "gelu"
    rope: bool = False
    rope_theta: float = 10000.0
    remat: bool = False

    def __post_init__(self):
        if self.attn not in ("dense", "flash"):
            raise ValueError(f"unknown attn implementation {self.attn!r}")
        if self.sp_schedule not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown sp schedule {self.sp_schedule!r}")
        if self.n_kv_heads is not None and (
                self.n_kv_heads <= 0
                or self.n_heads % self.n_kv_heads != 0):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must divide "
                f"n_heads={self.n_heads}")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window={self.attn_window} must be "
                             f">= 1")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp flavor {self.mlp!r}")
        if self.rope and self.d_head % 2 != 0:
            raise ValueError(
                f"rope rotates feature PAIRS; d_head={self.d_head} "
                f"must be even")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def param_specs(cfg: ModelConfig) -> dict:
    """Per leaf, the axis split over the tp ranks (None = replicated): the
    positions of ``tp`` in the JAX package's PartitionSpecs."""
    block = {"ln1": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0, "ln2": None,
             "w1": 1, "w2": 0}
    if cfg.mlp == "swiglu":
        block["w3"] = 1
    return {"embed": None, "ln_f": None,
            "blocks": [dict(block) for _ in range(cfg.n_layers)]}


def tp_size(params: dict) -> int:
    """The number of tensor-parallel ranks ``params`` is split over."""
    return len(params["blocks"][0]["wq"]) if params["blocks"] else 1


def shard_params(params: dict, cfg: ModelConfig, tp: int, mesh=None) -> dict:
    """Split ``params`` over ``tp`` ranks: each sharded leaf becomes a list
    of ``tp`` contiguous tensors (rank r holds the r-th slice of its
    split axis), replicated leaves stay single.  ``params`` may be the
    full layout (tensors everywhere) or already split over any rank
    count.  tp must divide n_kv_heads, as ``shard_params`` requires in
    the JAX package.  With a ``mesh`` over several cards the split is
    placed on its cards (:func:`place_params`; tp must be its extent).  A
    placed container (:class:`Replicas`, :class:`SpReplicas`) stands for
    its first tree: every tree holds the same values."""
    params = placed_trees(params)[0]
    if mesh is not None and mesh.devices is not None:
        if mesh.shape.get("tp", 1) != tp:
            raise ValueError(f"tp={tp}, the mesh's tp extent is "
                             f"{mesh.shape.get('tp', 1)}")
        return place_params(params, cfg, mesh)
    if cfg.kv_heads % tp != 0:
        raise ValueError(
            f"tensor-parallel extent {tp} must divide "
            f"n_kv_heads={cfg.kv_heads} (the grouped K/V "
            f"projections shard their head axis over 'tp')")
    if cfg.d_ff % tp != 0:
        raise ValueError(f"tensor-parallel extent {tp} must divide "
                         f"d_ff={cfg.d_ff}")

    def split(leaf, axis):
        if axis is None:
            return leaf
        full = leaf
        if isinstance(leaf, list):
            full = leaf[0] if len(leaf) == 1 else torch.cat(
                [t.to(leaf[0].device) for t in leaf], dim=axis)
        if tp == 1:
            return [full]
        return [c.contiguous() for c in torch.chunk(full, tp, dim=axis)]

    specs = param_specs(cfg)
    return {
        "embed": params["embed"],
        "ln_f": params["ln_f"],
        "blocks": [{k: split(blk[k], spec[k]) for k in spec}
                   for blk, spec in zip(params["blocks"], specs["blocks"])],
    }


def init_params(rng, cfg: ModelConfig, tp: int = 1, device="cuda",
                mesh=None) -> dict:
    """Parameters split over ``tp`` ranks, in the JAX package's draw
    order.  ``rng`` a ``numpy.random.Generator``: the JAX package's
    numbers (the same seed gives the same weights), drawn on the host;
    ``rng`` a ``torch.Generator`` on ``device``: drawn there, at the same
    0.02 scale (the way to make a full-width model on the card).  With a
    ``mesh`` over several cards: drawn on its slot 0's device and placed
    on its cards (:func:`place_params`)."""
    if mesh is not None and mesh.devices is not None:
        full = init_params(rng, cfg, 1, mesh.device)
        return shard_params(full, cfg, tp, mesh=mesh)
    dev = resolve_device(device, "init_params")

    def g(*shape, scale=0.02):
        if isinstance(rng, np.random.Generator):
            draw = rng.standard_normal(shape) * scale
            return torch.from_numpy(draw.astype(np.float32)).to(dev)
        return torch.randn(shape, generator=rng, device=dev) * scale

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    G = cfg.kv_heads
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": ones(D)}
        blk["wq"] = g(D, H, Dh)
        blk["wk"] = g(D, G, Dh)
        blk["wv"] = g(D, G, Dh)
        blk["wo"] = g(H, Dh, D)
        blk["ln2"] = ones(D)
        blk["w1"] = g(D, Fd)
        blk["w2"] = g(Fd, D)
        if cfg.mlp == "swiglu":
            blk["w3"] = g(D, Fd)
        blocks.append(blk)
    params = {"embed": g(cfg.vocab, D), "blocks": blocks, "ln_f": ones(D)}
    return shard_params(params, cfg, tp)


@dataclass(eq=False)
class Places:
    """Where one replica's ranks live: rank r on ``devices[r]``, the mesh
    slot ``slots[r]``.  Every card holds a residual stream of its own:
    rank r reads its card's, the stream of rank ``homes[r]``, the first
    rank on that card (on the CPU, which stands for as many cards as it
    is named, every rank its own); ``cards`` are the ranks whose card
    holds a stream, 0 first.  Rank 0's card, the hub, holds the
    replicated leaves the ranks share and computes the logits; every
    other card holds a copy of the replicated leaves its stream reads
    (:meth:`copy`), or, where each rank computes on rows of its own (the
    ep members of ``models.moe``), each rank its own tensor of them
    (:meth:`own`)."""
    devices: tuple
    slots: tuple

    def __post_init__(self):
        self.homes = tuple(card_homes(self.devices))
        self.cards = tuple(sorted(set(self.homes)))
        self._copies = {}
        self._own = {}

    def copy(self, leaf: torch.Tensor, r: int) -> torch.Tensor:
        """The replicated ``leaf`` (the hub's) as rank r's card holds it:
        ``leaf`` itself on the hub's card; elsewhere a copy, made with a
        counted move, kept, and made again once ``leaf`` has changed in
        place (an optimizer step bumps its version)."""
        home = self.homes[r]
        if home == 0:
            return leaf
        got = self._copies.get((home, id(leaf)))
        if got is None or got[0] is not leaf or got[1] != leaf._version:
            with torch.no_grad():
                got = (leaf, leaf._version,
                       move(leaf.detach(), self.devices[home]))
            self._copies[(home, id(leaf))] = got
        return got[2]

    def own(self, leaf: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's own tensor of the replicated ``leaf`` (the hub's), one
        that collects rank r's gradient: ``leaf`` itself for rank 0; for
        any other rank a tensor of its own over its card's copy of the
        leaf (one copy a card, made with a counted move by the first rank
        on the card; on the hub's card the leaf's own storage), kept,
        made again once ``leaf`` has changed in place, and requiring a
        gradient while ``leaf`` does (:meth:`owned`)."""
        if r == 0:
            return leaf
        mine = self._own.setdefault(id(leaf), {})
        got = mine.get(r)
        if got is None or got[0] is not leaf or got[1] != leaf._version:
            home = self.homes[r]
            with torch.no_grad():
                if home != r:  # the card's copy, its storage shared
                    t = self.own(leaf, home).detach()
                else:
                    t = move(leaf.detach(), self.devices[r])
            got = (leaf, leaf._version, t)
            mine[r] = got
        return got[2].requires_grad_(leaf.requires_grad)

    def owned(self, leaf: Optional[torch.Tensor] = None) -> list:
        """The other ranks' own tensors of ``leaf`` (:meth:`own`) as
        (rank, tensor) pairs in rank order; the tensors of every leaf
        with ``leaf`` None."""
        if leaf is None:
            return [got[2] for mine in self._own.values()
                    for got in mine.values()]
        mine = self._own.get(id(leaf), {})
        return [(r, mine[r][2]) for r in sorted(mine) if mine[r][0] is leaf]


class PlacedParams(dict):
    """Parameters placed on a mesh's cards (:func:`place_params`): the
    dict of the one-card layout, with the ``places`` of its ranks.
    ``utils.tree.tree_map`` keeps the class and its ``places``."""

    def __init__(self, *args, places: Optional[Places] = None, **kw):
        super().__init__(*args, **kw)
        self.places = places


class Replicas(list):
    """One placed parameter tree per data-parallel member of a mesh over
    several cards (:func:`place_params`), in member order; with an sp
    axis each member's entry is an :class:`SpReplicas`."""


class SpReplicas(list):
    """One data member's parameters over the sp members of a mesh over
    several cards (:func:`place_params` on a mesh with an sp axis): entry
    s is the :class:`PlacedParams` tree of sp member s, its tp rank r's
    shards on slot (d, r, s)'s card and its replicated leaves on (d, 0,
    s)'s, in ring order.  Every tree is its own storage and holds the
    same values.  ``forward``, ``loss_fn`` and ``make_train_step`` run
    member s on its shard of the sequence with these parameters; the
    train step folds the trees' gradients over sp (and dp), the psum
    over the data axes that the JAX package's replication-aware
    transpose makes, and updates every tree alike."""


def placed_trees(params) -> list:
    """The placed trees of ``params`` in (dp, sp) order: a
    :class:`Replicas` list member by member, each :class:`SpReplicas` sp
    member by sp member, and any lists nested as they are (``init_opt``'s
    states); a single tree as a list of one."""
    if isinstance(params, list):
        return [t for p in params for t in placed_trees(p)]
    return [params]


def nest_as(params, flat):
    """``flat``, one entry per tree of ``params`` in :func:`placed_trees`'
    order, nested in lists as the trees are; one tree's entry itself."""
    it = iter(flat)

    def build(p):
        return [build(x) for x in p] if isinstance(p, list) else next(it)

    return build(params)


def _rank_tree(node):
    """The rank each leaf of a parameter tree lives on, in its structure:
    r for entry r of a rank list (a list of tensors), 0 for a replicated
    leaf (the hub's)."""
    if isinstance(node, dict):
        return {k: _rank_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        if node and all(isinstance(t, torch.Tensor) for t in node):
            return list(range(len(node)))
        return [_rank_tree(v) for v in node]
    return 0


def place_split(split: dict, mesh, inner: str, seq: Optional[str] = None):
    """A tree already split over ``mesh``'s ``inner`` axis (rank lists of
    its extent, replicated leaves single) placed on the mesh's cards: for
    data member d (and sp member s of the ``seq`` axis, when the mesh
    has it), entry r of every rank list on the card of slot (d, r, s) and
    every other leaf on the card of (d, 0, s).  Copies, so that every
    replica is its own storage, apart from the input's.  Returns a
    :class:`PlacedParams`, with a ``seq`` axis an :class:`SpReplicas`
    list of one per sp member, and with a dp axis a :class:`Replicas`
    list of one of those per data member."""
    if mesh.devices is None:
        raise ValueError("place_params: the mesh has every slot on one "
                         "device; shard_params splits over it")
    shape = mesh.shape
    placed_axes = ("dp", inner) + ((seq,) if seq else ())
    other = sorted(k for k in shape if k not in placed_axes)
    if other:
        raise ACCLError(f"place_params: axes {other} of the model over "
                        f"several cards are not part of accl_tpu_torch yet "
                        f"(ROADMAP item 13); the model places "
                        f"{' x '.join(placed_axes)}")
    check_process_axes(mesh, (inner,) + ((seq,) if seq else ()))
    n_dp = shape.get("dp", 1)
    n_seq = shape.get(seq, 1) if seq else 1

    def put(node, devs):
        if isinstance(node, dict):
            return {k: put(v, devs) for k, v in node.items()}
        if isinstance(node, list) and node and isinstance(node[0], dict):
            return [put(v, devs) for v in node]
        if isinstance(node, list):
            return [t.to(devs[r], copy=True) for r, t in enumerate(node)]
        return node.to(devs[0], copy=True)

    replicas = []
    for d in range(n_dp):
        members = []
        for s in range(n_seq):
            at = {"dp": d, **({seq: s} if seq else {})}
            slots = mesh.group(inner, **at)
            devs = tuple(mesh.slot_device(x) for x in slots)
            if not mesh.is_local(slots[0]):  # another process's member
                members.append(None)
                continue
            members.append(PlacedParams(put(split, devs),
                                        places=Places(devs, slots)))
        replicas.append(members[0] if n_seq == 1 else SpReplicas(members))
    return replicas[0] if n_dp == 1 else Replicas(replicas)


def place_params(params, cfg: ModelConfig, mesh):
    """``params`` (any device, full or split over any tp count; a placed
    container stands for its first tree) placed on the cards of ``mesh``,
    a mesh over several cards with axes dp, tp and sp
    (:func:`place_split`): tp rank r's shards of data member d and sp
    member s on slot (d, r, s)'s card, the replicated leaves on (d, 0,
    s)'s, and a copy of each block's norms on every other card of that
    tp group (``Places.copy``).  On a mesh over several processes each
    process places its own data members only: another process's member
    is ``None`` (an :class:`SpReplicas` of ``None`` with an sp axis); a
    tp or sp group over several processes raises ``ACCLError``."""
    placed = place_split(shard_params(params, cfg, mesh.shape.get("tp", 1)),
                         mesh, "tp", seq="sp")
    for rep in placed_trees(placed):
        if rep is None:
            continue
        for blk in rep["blocks"]:
            for c in rep.places.cards[1:]:
                rep.places.copy(blk["ln1"], c)
                rep.places.copy(blk["ln2"], c)
    return placed


def _places(params, leaf: str = "wq") -> Optional[Places]:
    """The placement of ``params``' ranks: its ``places``, or, for a plain
    dict whose tensors lie on several devices, each rank on its first
    block's ``leaf`` entry's device; None on one card."""
    if isinstance(params, Replicas):
        raise ValueError("a Replicas list holds one tree per data member: "
                         "pass one member's tree")
    got = getattr(params, "places", None)
    if got is not None or not params["blocks"]:
        return got
    devs = tuple(w.device for w in params["blocks"][0][leaf])
    if len(set(devs) | {params["embed"].device}) <= 1:
        return None
    if params["embed"].device != devs[0]:
        raise ValueError(f"the replicated leaves live on "
                         f"{params['embed'].device}, rank 0 on {devs[0]}")
    return Places(devs, tuple(range(len(devs))))


def check_process_axes(mesh, axes) -> None:
    """Raise ``ACCLError`` naming an axis of ``axes`` whose groups span
    several processes: only the dp axis may cross them."""
    for axis in axes:
        if axis and mesh.group_processes(axis):
            raise ACCLError(
                f"the {axis} axis spans several processes (its group "
                f"{mesh.group_processes(axis)[0]} does): a {axis} group "
                f"across processes is not part of accl_tpu_torch yet "
                f"(ROADMAP item 13e); only dp may cross processes")


def tree_devices(mesh, inner: str, seq: Optional[str] = None) -> list:
    """The slot devices of every placed tree of ``mesh`` in (dp, sp)
    order (:func:`placed_trees`' order), each along ``inner``: what
    :func:`_mean_grads_cards` needs of a tree another process holds."""
    shape = mesh.shape
    out = []
    for d in range(shape.get("dp", 1)):
        for s in range(shape.get(seq, 1) if seq else 1):
            slots = mesh.group(inner, dp=d, **({seq: s} if seq else {}))
            out.append(tuple(mesh.slot_device(x) for x in slots))
    return out


def placed_replicas(params, mesh, inner: str, n_dp: int,
                    seq: Optional[str] = None) -> list:
    """The data members' entries of ``params`` (a :class:`Replicas` list,
    or one member's), each checked to be placed on member d's slots of
    ``mesh`` along ``inner`` (with a ``seq`` axis: an
    :class:`SpReplicas` whose tree s lies on the slots (d, ·, s)); on a
    mesh over several processes, ``None`` exactly for the members other
    processes hold."""
    reps = list(params) if isinstance(params, Replicas) else [params]
    if len(reps) != n_dp:
        raise ValueError(f"{len(reps)} parameter replicas, the mesh has "
                         f"{n_dp} dp members")
    n_seq = mesh.shape.get(seq, 1) if seq else 1
    for d, rep in enumerate(reps):
        local = mesh.is_local(mesh.group(inner, dp=d)[0])
        if not local:
            if any(t is not None for t in placed_trees(rep)):
                raise ValueError(f"replica {d} belongs to another process: "
                                 f"pass None (place_params)")
            continue
        trees = list(rep) if isinstance(rep, SpReplicas) else [rep]
        if len(trees) != n_seq:
            raise ValueError(f"replica {d} holds {len(trees)} sp trees, "
                             f"the mesh has {n_seq} sp members "
                             f"(place_params)")
        for s, tree in enumerate(trees):
            want = mesh.group(inner, dp=d, **({seq: s} if seq else {}))
            got = getattr(tree, "places", None)
            if got is None or tuple(got.slots) != want:
                which = f"replica {d}" + (f", sp member {s}," if n_seq > 1
                                          else "")
                raise ValueError(f"{which} is not placed on this mesh's "
                                 f"slots {want} (place_params)")
    return reps


def card_closures(reps, tokens, n_dp: int, loss) -> list:
    """One loss closure per data member: its rows of the batch, moved to
    its hub (its first tree's), through ``loss(params, tokens)``; ``None``
    for a member of another process (every process passes the whole
    batch)."""
    tokens = torch.as_tensor(tokens)
    B = tokens.shape[0]
    if B % n_dp:
        raise ValueError(f"batch {B} does not split over {n_dp} dp members")
    b = B // n_dp
    return [None if placed_trees(rep)[0] is None else
            (lambda p, t=tokens[d * b:(d + 1) * b].to(
                placed_trees(rep)[0].places.devices[0]): loss(p, t))
            for d, rep in enumerate(reps)]


def sgd_cards(closures, reps, lr: float, devices=None):
    """Plain SGD over :func:`_mean_grads_cards`, every replica's tree of
    this process in place with the same arithmetic.  Returns the mean
    loss."""
    g_means, mean_loss = _mean_grads_cards(closures, reps, devices)
    with torch.no_grad():
        for rep, g_mean in zip(placed_trees(reps), g_means):
            if rep is None:
                continue
            for p, g in zip(tree_leaves(rep), tree_leaves(g_mean)):
                p.sub_(g * lr)
    return mean_loss


def _mm(a, b):
    """a @ b with jnp's type promotion (einsum promotes mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _rope(x, positions, theta: float):
    """Rotary position embedding on [B, T, h, Dh]: feature pairs (i, i +
    Dh/2) rotated by position-dependent angles, in float32, cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _global_positions(T: int, cfg: ModelConfig, sp: int,
                      device) -> torch.Tensor:
    """Global positions of T tokens in the schedule's layout: 0..T-1, or
    under zigzag sequence parallelism the zigzag permutation (member idx
    holds chunk idx and its mirror chunk 2P-1-idx)."""
    if sp > 1 and cfg.sp_schedule == "zigzag":
        return zigzag_indices(T, sp).to(device)
    return torch.arange(T, device=device)


def _on_cards(places: Places, fn, *per_rank) -> list:
    """``fn(*(a[c] for a in per_rank), c)`` on every card that holds a
    residual stream (``places.cards``), each with autograd: the same
    operations on copies of the same operands, so every card's values,
    and in the backward its gradients, are the hub's bit for bit.
    Returns the results per rank (the ranks of one card share its
    result)."""
    return _per_rank(places, [fn(*[a[c] for a in per_rank], c)
                              for c in places.cards])


def _per_rank(places: Places, by_card) -> list:
    """Per-card values (``places.cards`` order) as the ranks hold them."""
    got = dict(zip(places.cards, by_card))
    return [got[h] for h in places.homes]


def _spread(x, places: Places) -> list:
    """The hub's residual stream copied to every other card (a counted
    move each; ``collectives.spread``: in the backward the hub's gradient
    alone goes on into the embedding): the streams per rank."""
    return _per_rank(places, spread(x, [places.devices[c]
                                        for c in places.cards]))


def _collect(x, places: Places):
    """The hub's stream of the streams per rank ``x``, on to the final
    norm and the logits (``collectives.collect``: its gradient goes back
    to every card's stream, a counted move each)."""
    return collect([x[c] for c in places.cards])


def _norm(x, scale, places: Optional[Places]):
    """``_rmsnorm`` of the residual stream: on one card, or on every
    card's stream with that card's copy of ``scale``."""
    if places is None:
        return _rmsnorm(x, scale)
    return _on_cards(places, lambda xc, c: _rmsnorm(xc, places.copy(scale, c)),
                     x)


def _sum_on_cards(parts, places: Places) -> list:
    """The row-parallel partials summed in rank order on every card that
    holds a stream, ((p0 + p1) + p2) + ..., the fold of the one-card
    combine, each card's with the hub's bits (``gather_sum``: every
    partial to every card by the ring all-gather); each card's sum
    carries the gradient of its stream, and each partial takes that of
    its own card's sum (no crossing)."""
    if len(places.cards) == 1:
        return [fan_in(parts, places.devices[0])] * len(parts)
    return _per_rank(places, gather_sum(
        parts, places.cards,
        homes=[places.cards.index(h) for h in places.homes]))


def _add_on_cards(x, s, places: Optional[Places]):
    """The residual ``x + s``, on one card or on every card's stream."""
    if places is None:
        return x + s
    return _on_cards(places, lambda xc, sc, c: xc + sc, x, s)


def block_qkv(h, blk, cfg: ModelConfig, positions, places=None):
    """Per-rank q/k/v projections of one block's normed input [B, T, D]
    (+ RoPE when ``positions`` is given): lists of [B, T, h_r, Dh].  With
    ``places`` ``h`` holds each card's normed stream (per rank) and rank
    r's projections run on its card from its card's copy, with
    ``fan_out``'s backward (the uses' gradients folded along the cards,
    the fold given to every card); the positions, an index the hub
    computed, are copied along."""
    B, T, D = (h if places is None else h[0]).shape
    dt = cfg.tdtype
    qs, ks, vs = [], [], []
    hs = None if places is None else fan_out(h, uses=3)
    hq = hk = hv = h if places is None else None
    for r, (wq, wk, wv) in enumerate(zip(blk["wq"], blk["wk"], blk["wv"])):
        if hs is not None:
            hq, hk, hv = hs[3 * r:3 * r + 3]
            if positions is not None:
                positions = positions.to(hq.device)
        q = _mm(hq, wq.to(dt).reshape(D, -1)).reshape(B, T, wq.shape[1], -1)
        k = _mm(hk, wk.to(dt).reshape(D, -1)).reshape(B, T, wk.shape[1], -1)
        v = _mm(hv, wv.to(dt).reshape(D, -1)).reshape(B, T, wv.shape[1], -1)
        if positions is not None:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    return qs, ks, vs


def _fused_row_combine(hs, ws, out_shape, dtype, places=None):
    """The fused lane of the row-parallel projections: sum_r hs[r] @ ws[r]
    through the pipelined ``fused_matmul_allreduce`` (chunked ring, plain
    matmuls), as the JAX package's ``_fused_row_combine``; with
    ``places`` over the ranks' cards, each card's result (per rank), each
    with the gradient of its card's stream."""
    outs = fused_matmul_allreduce(
        hs, ws, use_pallas=False, chunks=fused_chunks(),
        devices=None if places is None else places.devices)
    if places is None:
        return outs[0].reshape(out_shape).to(dtype)
    return _on_cards(places, lambda c: outs[c].reshape(out_shape).to(dtype))


def block_attn_out(x, attn, blk, cfg: ModelConfig, fused: bool = False,
                   places=None):
    """Attention-out projection of the per-rank attention [B, T, h_r, Dh],
    the row-parallel combine over the ranks, and the residual.  With
    ``places`` (``x`` each card's stream, per rank) each rank multiplies
    on its card and every card sums the partials in rank order
    (:func:`_sum_on_cards`) into its own stream."""
    dt = cfg.tdtype
    wo = [w.to(dt) for w in blk["wo"]]
    B, T = attn[0].shape[0], attn[0].shape[1]
    if fused and len(wo) > 1:
        hs = [a.reshape(B * T, -1) for a in attn]
        ws = [w.reshape(-1, w.shape[-1]) for w in wo]
        return _add_on_cards(x, _fused_row_combine(
            hs, ws, (B, T, wo[0].shape[-1]), dt, places), places)
    parts = [_mm(a.reshape(B, T, -1), w.reshape(-1, w.shape[-1]))
             for a, w in zip(attn, wo)]
    if places is not None:
        return _add_on_cards(x, _sum_on_cards(parts, places), places)
    return x + all_reduce(parts)[0]


def block_mlp(x, blk, cfg: ModelConfig, fused: bool = False, places=None):
    """Post-attention MLP (gelu or swiglu) per rank over its hidden shard,
    the row-parallel combine, and the residual.  With ``places`` each
    card norms its own stream, rank r multiplies on its card, and every
    card sums the partials, as in :func:`block_attn_out`."""
    dt = cfg.tdtype
    h = _norm(x, blk["ln2"], places)
    uses = 2 if cfg.mlp == "swiglu" else 1
    hs = [h] * (uses * len(blk["w1"])) if places is None \
        else fan_out(h, uses=uses)
    ms = []
    for r, w1 in enumerate(blk["w1"]):
        m = _mm(hs[uses * r], w1.to(dt))
        if cfg.mlp == "swiglu":
            m = F.silu(m) * _mm(hs[uses * r + 1], blk["w3"][r].to(dt))
        else:
            m = F.gelu(m, approximate="tanh")
        ms.append(m)
    w2 = [w.to(dt) for w in blk["w2"]]
    B, T = ms[0].shape[0], ms[0].shape[1]
    if fused and len(w2) > 1:
        hs = [m.reshape(B * T, -1) for m in ms]
        return _add_on_cards(x, _fused_row_combine(
            hs, w2, (B, T, w2[0].shape[-1]), dt, places), places)
    parts = [_mm(m, w) for m, w in zip(ms, w2)]
    if places is not None:
        return _add_on_cards(x, _sum_on_cards(parts, places), places)
    return x + all_reduce(parts)[0]


def _local_attention(q, k, v, cfg: ModelConfig):
    """One rank's causal attention over its heads [B, T, h_r, Dh]."""
    if cfg.attn == "flash":
        # the matmul input format follows the activations: bf16 stays on
        # the fast format, float32 keeps exact float32 numerics
        mxu = q.dtype if q.dtype in (torch.bfloat16, torch.float16) \
            else torch.float32
        return flash_attention(q, k, v, causal=True, mxu_dtype=mxu,
                               window=cfg.attn_window)
    if k.shape[2] != q.shape[2]:
        k, v = expand_gqa_kv(k, v, q.shape[2])
    return _dense_attention(q, k, v, causal=True, window=cfg.attn_window)


def _sp_attention(q, k, v, cfg: ModelConfig, sp: int):
    """One rank's causal attention over its heads with the sequence split
    into ``sp`` members' shards: ring attention over the shards (the
    schedule and window of ``cfg``), the outputs put back in sequence."""
    outs = ring_attention(q.chunk(sp, dim=1), k.chunk(sp, dim=1),
                          v.chunk(sp, dim=1), causal=True,
                          schedule=cfg.sp_schedule, window=cfg.attn_window)
    return torch.cat(outs, dim=1)


def _sp_refusals(cfg: ModelConfig) -> None:
    """The JAX package's refusals under sequence parallelism, with its
    texts."""
    if cfg.attn_window is not None and cfg.sp_schedule != "contiguous":
        raise ValueError(
            "attn_window under sequence parallelism requires "
            "the contiguous schedule (the zigzag layout's "
            "split chunks break the one-neighbor-hop bound)")
    if cfg.attn == "flash":
        raise ValueError(
            "attn='flash' is the single-shard attention kernel; "
            "with sequence parallelism the ring layer owns the "
            "attention schedule — use attn='dense' when sp is on")


def _block(x, blk, cfg: ModelConfig, rope_pos, fused: bool, sp: int = 1,
           places=None):
    """One transformer block on the residual stream [B, T, D] (with
    ``places``, each card's, per rank)."""
    h = _norm(x, blk["ln1"], places)
    qs, ks, vs = block_qkv(h, blk, cfg, rope_pos, places)
    if sp > 1:
        _sp_refusals(cfg)
        attn = [_sp_attention(q, k, v, cfg, sp)
                for q, k, v in zip(qs, ks, vs)]
    else:
        attn = [_local_attention(q, k, v, cfg)
                for q, k, v in zip(qs, ks, vs)]
    x = block_attn_out(x, attn, blk, cfg, fused=fused, places=places)
    return block_mlp(x, blk, cfg, fused=fused, places=places)


def _sp_block(xs, blks, cfg: ModelConfig, positions, fused: bool,
              places):
    """One transformer block over the sp members of a mesh of cards: sp
    member s's residual stream ``xs[s]`` is its shard of the sequence,
    held on every card of its tp group (per rank, as :func:`_block`'s
    ``x`` with ``places[s]``), ``blks[s]`` its tree's block,
    ``positions[s]`` its rows' global positions (RoPE) or None.  Each
    rank's q/k/v, attention-out and MLP run on its card for its shard;
    the attention of tp rank r is ``ring_attention`` over the sp group
    (d, r, ·), each member on its card; the row-parallel combines stay
    inside each tp group.  Returns the streams, as ``xs``."""
    _sp_refusals(cfg)
    qkv = [block_qkv(_norm(x, b["ln1"], p), b, cfg, pos, p)
           for x, b, pos, p in zip(xs, blks, positions, places)]
    attn = [[None] * len(qkv[0][0]) for _ in xs]
    for r in range(len(qkv[0][0])):
        outs = ring_attention(
            [m[0][r] for m in qkv], [m[1][r] for m in qkv],
            [m[2][r] for m in qkv], causal=True, schedule=cfg.sp_schedule,
            window=cfg.attn_window, devices=[p.devices[r] for p in places])
        for s, o in enumerate(outs):
            attn[s][r] = o
    return [block_mlp(block_attn_out(x, a, b, cfg, fused=fused, places=p),
                      b, cfg, fused=fused, places=p)
            for x, a, b, p in zip(xs, attn, blks, places)]


def _shard_tokens(trees, tokens) -> list:
    """The global tokens [B, T] (the schedule's layout), or their labels
    or mask, split into the sp members' shards, each on its member's hub
    (the batch arriving split ``P(dp, sp)``)."""
    tokens = torch.as_tensor(tokens)
    S, T = len(trees), tokens.shape[1]
    if T % S:
        raise ValueError(f"sequence length {T} does not split over {S} "
                         f"sp members")
    Tl = T // S
    return [tokens[:, s * Tl:(s + 1) * Tl].to(t.places.devices[0])
            for s, t in enumerate(trees)]


def _forward_shards(trees, toks, cfg: ModelConfig, fused: bool) -> list:
    """The forward over the sp members of a mesh of cards: ``trees`` an
    :class:`SpReplicas`, ``toks`` its members' token shards
    (:func:`_shard_tokens`).  Member s embeds its shard on its hub,
    spreads the stream over its tp group's cards and runs the blocks
    (:func:`_sp_block`; with ``cfg.remat`` each block over all members
    is one checkpoint, the ring coupling them).  Returns each member's
    logits [B, T / sp, vocab] on its hub."""
    S = len(trees)
    places = [t.places for t in trees]
    Tl = toks[0].shape[1]
    xs = [_spread(t["embed"][tok].to(cfg.tdtype), p)
          for t, tok, p in zip(trees, toks, places)]
    # each shard's global positions, computed on its hub (JAX's
    # _global_positions under the member's axis index)
    positions = [(_global_positions(S * Tl, cfg, S, tok.device)
                  [s * Tl:(s + 1) * Tl] if cfg.rope else None)
                 for s, tok in enumerate(toks)]
    for i in range(cfg.n_layers):
        blks = [t["blocks"][i] for t in trees]
        if cfg.remat:
            xs = checkpoint(_sp_block, xs, blks, cfg, positions, fused,
                            places, use_reentrant=False)
        else:
            xs = _sp_block(xs, blks, cfg, positions, fused, places)
    return [_mm(_rmsnorm(_collect(x, t.places), t["ln_f"]),
                t["embed"].to(cfg.tdtype).t()) for x, t in zip(xs, trees)]


def _sp_params(params, sp: int) -> bool:
    """Whether ``params`` are placed over sp members (an
    :class:`SpReplicas`), checked against ``sp``."""
    if not isinstance(params, SpReplicas):
        return False
    if sp != len(params):
        raise ValueError(f"the parameters are placed over {len(params)} sp "
                         f"members; sp={sp}")
    return True


def forward(params, tokens, cfg: ModelConfig, fused: bool = False,
            sp: int = 1):
    """Token ids [B, T] -> logits [B, T, vocab], tensor-parallel over the
    ranks ``params`` is split over (``shard_params``), on the device the
    parameters live on.  ``fused=True`` pipelines the row-parallel
    combines (the fused lane; no effect at tp = 1).  With ``cfg.remat``
    each block is recomputed on the backward pass
    (``torch.utils.checkpoint``, ``jax.checkpoint``'s role): only the
    block inputs stay live across layers.  ``sp`` > 1 splits the
    sequence over that many members for ring attention (``cfg.attn``
    "dense"; the ring runs the flash kernels per hop on the card): the
    tokens and logits are in the schedule's layout.  Parameters placed
    on several cards (:func:`place_params`) run with a residual stream on
    every card and each rank on its card; the logits are the hub's.
    Parameters placed over the sp members of such a mesh (an
    :class:`SpReplicas`; ``sp`` its length) run each member on its shard
    of the sequence on its tp group's cards, attention by the ring over
    the sp cards (:func:`_forward_shards`); the members' logits are
    gathered on member 0's hub, in the schedule's layout."""
    if cfg.sp_schedule == "zigzag" and sp <= 1:
        # the zigzag layout means something only under sequence
        # parallelism; without it the causal mask would read the permuted
        # sequence as natural order
        raise ValueError("sp_schedule='zigzag' requires an sp axis "
                         "(tokens are in zigzag order)")
    if _sp_params(params, sp):
        shards = _forward_shards(params, _shard_tokens(params, tokens), cfg,
                                 fused)
        hub = shards[0].device
        return torch.cat([shards[0]] + [move(lg, hub) for lg in shards[1:]],
                         dim=1)
    places = _places(params)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    T = tokens.shape[1]
    if T % sp:
        raise ValueError(f"sequence length {T} does not split over {sp} "
                         f"sp members")
    x = embed[tokens].to(cfg.tdtype)
    if places is not None:
        x = _spread(x, places)
    rope_pos = (_global_positions(T, cfg, sp, embed.device) if cfg.rope
                else None)
    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(_block, x, blk, cfg, rope_pos, fused, sp, places,
                           use_reentrant=False)
        else:
            x = _block(x, blk, cfg, rope_pos, fused, sp, places)
    if places is not None:
        x = _collect(x, places)
    x = _rmsnorm(x, params["ln_f"])
    return _mm(x, embed.to(cfg.tdtype).t())


def loss_fn(params, tokens, cfg: ModelConfig, fused: bool = False,
            sp: int = 1):
    """Next-token cross entropy on [B, T] tokens: the last position has no
    label and is masked.  Returns (sum_loss, count), float32 scalars local
    to the caller (the sum-and-count discipline).  With ``sp`` > 1 the
    tokens are in the schedule's layout and each member's shard takes its
    last label from the shard holding its global successor.  Parameters
    placed over sp members (an :class:`SpReplicas`): each member's sum
    and count on its hub (:func:`_loss_shards`), folded in member order
    on member 0's."""
    if _sp_params(params, sp):
        sums, counts = _loss_shards(params, tokens, cfg, fused)
        hub = sums[0].device
        total, count = sums[0], counts[0]
        for s_, c in zip(sums[1:], counts[1:]):
            total = total + move(s_, hub)
            count = count + move(c, hub)
        return total, count
    logits = forward(params, tokens, cfg, fused=fused, sp=sp).float()
    labels, valid = _labels(torch.as_tensor(tokens, device=logits.device),
                            cfg, sp)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll), torch.sum(valid.float())


def _labels(tokens, cfg: ModelConfig, sp: int):
    """The next-token labels (int64) and their valid mask, [B, T] each,
    of tokens [B, T] in the schedule's layout: each position's label is
    its global successor's token; the global last position has none and
    is masked."""
    tokens = tokens.long()
    B, T = tokens.shape
    zigzag = sp > 1 and cfg.sp_schedule == "zigzag"
    if zigzag:
        # labels in natural order, then permuted into the zigzag layout:
        # each chunk's last label is its global successor's token
        tokens = tokens[:, zigzag_indices_inverse(T, sp).to(tokens.device)]
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    valid = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    valid[:, -1] = False
    if zigzag:
        perm = zigzag_indices(T, sp).to(tokens.device)
        labels, valid = labels[:, perm], valid[:, perm]
    return labels, valid


def _loss_shards(params, tokens, cfg: ModelConfig, fused: bool = False):
    """``loss_fn`` over the sp members of a mesh of cards (``params`` an
    :class:`SpReplicas`): each member's (sum, count) of its shard's
    next-token cross entropy on its hub, from its own logits (no
    gather).  Returns (sums, counts), one per member; their sum is a
    different summation from the one-card loss's single sum over [B, T]
    (the same terms, folded per shard)."""
    tokens = torch.as_tensor(tokens)
    logits = _forward_shards(params, _shard_tokens(params, tokens), cfg,
                             fused)
    # the labels and mask of the whole sequence, split as the tokens are
    labels, valid = [_shard_tokens(params, t)
                     for t in _labels(tokens, cfg, len(params))]
    sums, counts = [], []
    for lg, lab, ok in zip(logits, labels, valid):
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        sums.append(torch.sum(torch.where(ok, nll, 0.0)))
        counts.append(torch.sum(ok.float()))
    return sums, counts


def _mean_grads(loss_closures: Sequence[Callable], params):
    """Mean gradients for loss closures returning a LOCAL ``(loss_sum,
    count)`` pair, one closure per data-parallel member (the
    sum-and-count discipline of the JAX package's ``_mean_grads``).

    Each member's loss_sum is backpropagated into the shared leaves in
    turn, so a leaf's gradient is the sum over the members (JAX's psum
    of replicated gradients) and a tp-sharded leaf keeps its shard's.
    The counts and losses sum over the members; gradients are divided by
    the total.  Returns ``(g_mean, mean_loss)``, g_mean in ``params``'s
    structure; the leaves are left without gradients."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    total = loss_tot = None
    try:
        for closure in loss_closures:
            loss_sum, count = closure(params)
            loss_sum.backward()
            loss_sum, count = loss_sum.detach(), count.detach()
            total = count if total is None else total + count
            loss_tot = loss_sum if loss_tot is None else loss_tot + loss_sum
        denom = torch.clamp_min(total, 1.0)
        grads = {id(p): (p.grad.div_(denom) if p.grad is not None
                         else torch.zeros_like(p)) for p in leaves}
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    return tree_map(lambda p: grads[id(p)], params), loss_tot / denom


def _mean_grads_cards(loss_closures: Sequence[Callable], replicas,
                      devices=None):
    """:func:`_mean_grads` over a mesh of several cards: closure d runs on
    data member d's replica (``replicas[d]``, on that member's cards) and
    is backpropagated there.  A member placed over sp members (an
    :class:`SpReplicas`) has one tree per sp member and its closure
    returns one (sum, count) per tree (or per ep member of its tree):
    they take one backward together, since the ring (the all-to-alls)
    couples them.  The counts and losses, then each leaf's gradients, are
    folded over the trees in (dp, sp) order on the first tree's cards,
    ``((g00 + g01) + ...) + g10 ...``, as the one-card step accumulates
    its dp members (over sp the fold adds per-shard gradients, a
    different summation from the one-card step's full-T products),
    divided by the total count there, and the mean is sent to every
    tree's copy of the leaf (2 (n - 1) counted moves a leaf over n trees;
    the total count goes to the first tree's other cards once).  Each
    leaf is gathered whole on the first tree's card.  A tree whose ranks
    hold their own copies of a replicated leaf (``Places.own``, the MoE
    members) first folds their gradients in rank order, the hub's first,
    along its cards: the partial fold crosses to each next rank's card
    where it differs (a counted move) and, in the first tree, back to the
    hub; the copies are made again from the updated leaf at their next
    use.

    Over several processes (``replicas`` with ``None`` for the members
    of other processes, their closures ``None``; ``devices``: every
    tree's slot devices, :func:`tree_devices`) the fold is the same, in
    the process of the first tree, each crossing between processes a
    :func:`move` that both run; the mean loss is then sent to each other
    process's first tree's hub (one crossing a process), so every process
    returns it.
    Returns ``(g_means, mean_loss)``: one gradient tree per tree, in
    (dp, sp) order (``None`` for another process's), and the loss on
    this process's first tree's hub; the leaves are left without
    gradients."""
    trees = placed_trees(replicas)
    devs = (list(devices) if devices is not None
            else [t.places.devices for t in trees])
    mine = [t for t in trees if t is not None]
    leaves = [None if p is None else tree_leaves(p) for p in trees]
    ranks = tree_leaves(_rank_tree(mine[0]))
    add = _both(torch.add)
    for ls in leaves:
        for p in ls or ():
            p.grad = None
            p.requires_grad_(True)

    def grad(tree, p):
        """p's gradient and its ranks' own copies', folded in rank order
        along the cards; with the card it ends on."""
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        homes, at = tree.places.homes, 0
        for r, c in tree.places.owned(p):
            if homes[r] != at:
                g, at = move(g, c.device), homes[r]
            g = g + (c.grad if c.grad is not None else torch.zeros_like(c))
        return g, at

    try:
        got, first = [], 0
        for closure, params in zip(loss_closures, replicas):
            src = devs[first][0]  # where another process's member sums
            first += len(placed_trees(params))
            if closure is None:  # another process's member
                got.append((None, src))
                continue
            loss_sum, count = closure(params)
            if isinstance(loss_sum, torch.Tensor):
                loss_sum, count = [loss_sum], [count]
            torch.autograd.backward(list(loss_sum))
            got.append(((loss_sum, count), src))
        # every member returns as many (sum, count) pairs as this one's
        k = len(next(m for m, _src in got if m is not None)[0])
        losses, counts, srcs = [], [], []
        for m, src in got:
            loss_sum, count = m if m is not None else ([None] * k,) * 2
            losses += [t if t is None else t.detach() for t in loss_sum]
            counts += [t if t is None else t.detach() for t in count]
            srcs += [src] * k
        hub = devs[0]
        total, loss_tot = counts[0], losses[0]
        for c, loss, src in zip(counts[1:], losses[1:], srcs[1:]):
            total = add(total, _move(c, hub[0], src))
            loss_tot = add(loss_tot, _move(loss, hub[0], src))
        denom = None if total is None else torch.clamp_min(total, 1.0)
        denoms = [denom] + [_move(denom, d, hub[0]) for d in hub[1:]]
        means = [[] for _ in trees]
        for i, r in enumerate(ranks):
            gs = [(None, 0) if t is None else grad(t, ls[i])
                  for t, ls in zip(trees, leaves)]
            dev = devs[0][r]
            acc, at = gs[0]
            if at != 0:  # the first tree's fold back to its hub
                acc = move(acc, dev)
            for j, (g, _at) in enumerate(gs[1:], 1):
                acc = add(acc, _move(g, dev, devs[j][r]))
            acc = None if acc is None else acc / denoms[r]
            means[0].append(acc)
            for j in range(1, len(trees)):
                means[j].append(_move(acc, devs[j][r], dev))
    finally:
        for ls, t in zip(leaves, trees):
            if t is None:
                continue
            for p in ls + t.places.owned():
                p.grad = None
                p.requires_grad_(False)
    mean_loss = None if loss_tot is None else loss_tot / denom
    seen = {ipc.process_of(hub[0])}
    for j in range(1, len(trees)):
        q = ipc.process_of(devs[j][0])
        if q not in seen:  # another process's first tree: send it the loss
            seen.add(q)
            sent = _move(mean_loss, devs[j][0], hub[0])
            mean_loss = mean_loss if sent is None else sent
    out = []
    for params, ms in zip(trees, means):
        if params is None:
            out.append(None)
            continue
        it = iter(ms)
        out.append(tree_map(lambda _leaf, it=it: next(it), params))
    return out, mean_loss


def sum_count_device_step(loss_closures: Sequence[Callable], params,
                          lr: float):
    """Plain SGD over :func:`_mean_grads`: p - lr g_mean for every leaf,
    in place (the parameters are updated, not copied).  Returns
    ``(params, mean_loss)``."""
    g_mean, mean_loss = _mean_grads(loss_closures, params)
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(g_mean)):
            p.sub_(g.mul_(lr))
    return params, mean_loss


def _param_structure(tree):
    """The dict/list nesting of a tree, its leaves None."""
    if isinstance(tree, dict):
        return {k: _param_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_param_structure(v) for v in tree])
    return None


def opt_state_specs(optimizer, params, specs) -> Any:
    """The optimizer state's specs, as the JAX package derives them: the
    state of ``optimizer.init`` on shape-only (meta) copies of
    ``params``, every node in the parameters' structure replaced by
    ``specs`` (the moments follow the parameters' tp split) and every
    other leaf None (replicated, as the step count)."""
    want = _param_structure(params)
    state = optimizer.init(tree_map(
        lambda t: torch.empty_like(t, device="meta"), params))

    def walk(node):
        if _param_structure(node) == want:
            return specs
        if hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return None

    return walk(state)


def make_train_step(mesh, cfg: ModelConfig, lr: float = 1e-3,
                    dp: Optional[str] = "dp", tp: Optional[str] = "tp",
                    sp: Optional[str] = "sp", optimizer=None, params=None,
                    check_vma: Optional[bool] = None, fused: bool = False):
    """The train step over ``mesh`` (a ``parallel.mesh.RankMesh``).

    Default (``optimizer=None``): plain SGD at ``lr``.  Returns
    ``(step_fn, (param_specs, token_spec))`` with ``step_fn(params,
    tokens) -> (params, mean_loss)``: the token batch [B, T] split over
    the ``dp`` members (B divisible by dp) and, along the sequence, over
    the ``sp`` members (the tokens in the schedule's layout), each dp
    member's ``loss_fn`` over its sp shards and the tp rank lists, the
    mean gradient as ``_mean_grads`` forms it, and the update applied to
    ``params`` in place.  ``params`` must be split over the mesh's tp
    extent (``shard_params``) and live on its device.  ``token_spec``
    names the axes the token dimensions split over, as ``P(dp, sp)``.

    Over a mesh of several cards (``mesh.devices``; axes dp, tp and sp)
    ``params`` is what :func:`place_params` returns for it (a
    :class:`Replicas` list with a dp axis, of :class:`SpReplicas` with an
    sp axis), each member's loss runs on its own cards (with sp, one
    backward over its shards' losses) and the trees' gradients fold as
    :func:`_mean_grads_cards` says; every tree (and, with an optimizer,
    its state, nested as the trees are: a list of one per dp member, of
    one per sp member) is updated in place with the same arithmetic.

    With an ``optimizer`` (``accl_tpu_torch.optim.adamw``, or any object
    with its ``init(params)`` and ``update(grads, state, params)``; it
    must be parameter-local, as in the JAX package) ``params`` is
    required, to derive the state's specs (``opt_state_specs``: the
    moments split as the parameters they mirror, the count replicated).
    Returns ``(step_fn, (param_specs, opt_state_specs, token_spec),
    init_opt)`` with ``step_fn(params, opt_state, tokens) -> (params,
    opt_state, mean_loss)`` over the same members and mean gradient, the
    parameters and the state's moments updated in place, and
    ``init_opt(params)`` a fresh state beside the parameters (each moment
    on its leaf's card).

    Axes not in the mesh are dropped.  ``check_vma`` is accepted and
    changes nothing."""
    shape = mesh.shape
    dp = dp if dp in shape else None
    tp = tp if tp in shape else None
    sp = sp if sp in shape else None
    if cfg.sp_schedule == "zigzag" and sp is None:
        raise ValueError("ModelConfig(sp_schedule='zigzag') needs an 'sp' "
                         "axis in the mesh — zigzag-ordered tokens train "
                         "on wrong labels without the zigzag ring")
    n_dp = shape[dp] if dp else 1
    n_tp = shape[tp] if tp else 1
    n_sp = shape[sp] if sp else 1
    specs = param_specs(cfg)
    cards = mesh.devices is not None
    check_process_axes(mesh, (tp, sp))
    tree_devs = tree_devices(mesh, "tp", sp) if cards else None

    def closures(params, tokens):
        if tp_size(params) != n_tp:
            raise ValueError(f"params are split over {tp_size(params)} tp "
                             f"ranks, the mesh has {n_tp}")
        if params["embed"].device != mesh.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"mesh on {mesh.device}")
        tokens = torch.as_tensor(tokens, device=mesh.device)
        B = tokens.shape[0]
        if B % n_dp:
            raise ValueError(f"batch {B} does not split over {n_dp} dp "
                             f"members")
        b = B // n_dp
        return [(lambda p, t=tokens[d * b:(d + 1) * b]:
                 loss_fn(p, t, cfg, fused=fused, sp=n_sp))
                for d in range(n_dp)]

    def loss(p, t):
        if isinstance(p, SpReplicas):
            return _loss_shards(p, t, cfg, fused)
        return loss_fn(p, t, cfg, fused=fused)

    if optimizer is None:
        def step_fn(params, tokens):
            if cards:
                reps = placed_replicas(params, mesh, "tp", n_dp, seq=sp)
                return params, sgd_cards(card_closures(reps, tokens, n_dp,
                                                       loss), reps, lr,
                                         tree_devs)
            return sum_count_device_step(closures(params, tokens), params,
                                         lr)

        return step_fn, (specs, (dp, sp))

    if params is None:
        raise ValueError("optimizer path needs `params` (a host or "
                         "sharded pytree) to derive optimizer-state "
                         "PartitionSpecs")
    state_specs = opt_state_specs(
        optimizer, next(t for t in placed_trees(params) if t is not None),
        specs)

    def opt_step_fn(params, opt_state, tokens):
        if cards:
            reps = placed_replicas(params, mesh, "tp", n_dp, seq=sp)
            g_means, mean_loss = _mean_grads_cards(
                card_closures(reps, tokens, n_dp, loss), reps, tree_devs)
            new = []
            for tree, g_mean, state in zip(placed_trees(params), g_means,
                                           placed_trees(opt_state)):
                if tree is None:  # another process's member
                    new.append(None)
                    continue
                updates, state = optimizer.update(g_mean, state, tree)
                apply_updates(tree, updates)
                new.append(state)
            return params, nest_as(params, new), mean_loss
        g_mean, mean_loss = _mean_grads(closures(params, tokens), params)
        updates, opt_state = optimizer.update(g_mean, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, mean_loss

    def init_opt(params):
        return nest_as(params, [None if t is None else optimizer.init(t)
                                for t in placed_trees(params)])

    return opt_step_fn, (specs, state_specs, (dp, sp)), init_opt
