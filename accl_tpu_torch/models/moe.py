"""Mixture-of-Experts transformer: the expert-parallel model family.

Port of ``accl_tpu/models/moe.py``: a switch-style (top-1) MoE transformer
whose expert FFN banks shard one expert per member over ``ep``, the tokens
routed by the all-to-all pair of ``parallel.strategies``
(``expert_dispatch`` / ``expert_combine``) or, with ``fused=True``, by
``ops.fused.fused_expert_ffn``.  ``ep = 1`` runs every expert on every
token and selects by the routing one-hot: the dense reference.

Parameters are a plain dict in the JAX pytree's layout; the expert banks
``we1`` [E, D, F] and ``we2`` [E, F, D] are lists of ``ep`` tensors, one
slice of experts per member (``shard_params``), the other leaves held
once.  With ``ep`` > 1 the batch splits over the members in rank order:
each member routes its own tokens, with its own capacity and its own
load-balance aux loss, as each ``shard_map`` member does in the JAX
package.  The expert products are ``torch.matmul``, as the JAX package
leaves its einsums to XLA; attention is the dense reference.  GELU is the
tanh approximation, ``jax.nn.gelu``'s default.

Expert parallelism over several cards (a mesh with ``devices``, axes dp
and ep): ``place_params`` puts member e's expert slice on the card of
slot (d, e) of data member d, the other leaves on the card of (d, 0),
the hub, and member e's own tensor of each of them over its card's copy,
one copy a card (``transformer.Places.own``).  Member e runs its B / ep rows on its card
from the embedding to the logits and its loss, as each ``shard_map``
member does in the JAX package: the dispatch and combine all-to-alls,
through the counted ``parallel.collectives.move``, are the only
crossings of the forward, each expert runs on its own card, and the
combined rows stay on the member's card.  The forward gathers the
logits on the hub.  The train step backpropagates every member's loss
on its card, folds the members' losses and counts in member order on
the hub, and each replicated leaf's gradients over the members' tensors
in member order along their cards, then over the data members as the transformer's does
(``transformer._mean_grads_cards``); the banks keep their own
gradients, and the copies are made again from the updated leaves.  A
member's products run over its own rows, so the step is another
summation of the replicated leaves' gradients than the one-card step's
(tests/test_torch_model_cards.py states the bounds); the banks' are the
one-card step's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused import fused_expert_ffn
from ..parallel.collectives import move
from ..parallel.ring_attention import _dense_attention
from ..parallel.strategies import expert_combine, expert_dispatch
from ..utils.device import resolve_device
from .transformer import (
    Places,
    _mm,
    _places,
    _rmsnorm,
    card_closures,
    place_split,
    placed_replicas,
    placed_trees,
    sgd_cards,
    tree_devices,
    sum_count_device_step,
)


@dataclass(frozen=True)
class MoEConfig:
    """The JAX package's MoEConfig, with the same fields and defaults."""

    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    n_experts: int = 4          # == ep extent when sharded
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def param_specs(cfg: MoEConfig) -> dict:
    """Per leaf, the axis split over the ep members (None = replicated):
    the expert banks on their expert axis, everything else replicated."""
    block = {"ln1": None, "wq": None, "wk": None, "wv": None, "wo": None,
             "ln2": None, "router": None, "we1": 0, "we2": 0}
    return {"embed": None, "ln_f": None,
            "blocks": [dict(block) for _ in range(cfg.n_layers)]}


def ep_size(params: dict) -> int:
    """The number of expert-parallel members ``params`` is split over."""
    return len(params["blocks"][0]["we1"]) if params["blocks"] else 1


def _bank(leaf) -> torch.Tensor:
    """A whole expert bank from its per-member slices."""
    return leaf[0] if len(leaf) == 1 else torch.cat(
        [t.to(leaf[0].device) for t in leaf])


def place_params(params: dict, cfg: MoEConfig, mesh):
    """``params`` (any device, banks split over any count) placed on the
    cards of ``mesh``, a mesh over several cards with axes dp and ep
    (``transformer.place_split``): expert member e's slice of the banks
    of data member d on slot (d, e)'s card, every other leaf on (d,
    0)'s, the hub, and member e's own tensor of each of those over its
    card's copy, one copy a card (``Places.own``: made again once the
    hub's leaf changes)."""
    placed = place_split(shard_params(params, cfg, mesh.shape.get("ep", 1)),
                         mesh, "ep")
    for rep in placed_trees(placed):
        if rep is None:  # another process's member
            continue
        for e in range(1, len(rep.places.devices)):
            _member_tree(rep, rep.places, e)
    return placed


def _member_block(blk: dict, places: Places, e: int) -> dict:
    """Member e's block: its own tensor of every replicated leaf
    (``Places.own``), the expert banks' rank lists as they are (every
    member's tokens reach every bank by the all-to-alls)."""
    return {k: v if isinstance(v, list) else places.own(v, e)
            for k, v in blk.items()}


def _member_tree(params, places: Places, e: int) -> dict:
    """Member e's tree (:func:`_member_block` for every block)."""
    return {"embed": places.own(params["embed"], e),
            "ln_f": places.own(params["ln_f"], e),
            "blocks": [_member_block(b, places, e)
                       for b in params["blocks"]]}


def shard_params(params: dict, cfg: MoEConfig, ep: int) -> dict:
    """Split the expert banks over ``ep`` members (member r holds the r-th
    contiguous slice of experts); the other leaves stay single.
    ``params`` may be the full layout or already split over any count."""
    if cfg.n_experts % ep != 0:
        raise ValueError(f"expert-parallel extent {ep} must divide "
                         f"n_experts={cfg.n_experts}")
    specs = param_specs(cfg)

    def split(leaf, axis):
        if axis is None:
            return leaf
        full = _bank(leaf) if isinstance(leaf, list) else leaf
        return [c.contiguous() for c in torch.chunk(full, ep, dim=axis)]

    return {
        "embed": params["embed"],
        "ln_f": params["ln_f"],
        "blocks": [{k: split(blk[k], spec[k]) for k in spec}
                   for blk, spec in zip(params["blocks"], specs["blocks"])],
    }


def init_params(rng, cfg: MoEConfig, ep: int = 1, device="cuda") -> dict:
    """Parameters with the expert banks split over ``ep`` members, in the
    JAX package's draw order.  ``rng`` a ``numpy.random.Generator``: the
    JAX package's numbers, drawn on the host; a ``torch.Generator`` on
    ``device``: drawn there at the same 0.02 scale."""
    dev = resolve_device(device, "init_params")

    def g(*shape, scale=0.02):
        if isinstance(rng, np.random.Generator):
            draw = rng.standard_normal(shape) * scale
            return torch.from_numpy(draw.astype(np.float32)).to(dev)
        return torch.randn(shape, generator=rng, device=dev) * scale

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    D, H, Dh, Fd, E = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                       cfg.n_experts)
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": ones(D)}
        blk["wq"] = g(D, H, Dh)
        blk["wk"] = g(D, H, Dh)
        blk["wv"] = g(D, H, Dh)
        blk["wo"] = g(H, Dh, D)
        blk["ln2"] = ones(D)
        blk["router"] = g(D, E)
        blk["we1"] = g(E, D, Fd)
        blk["we2"] = g(E, Fd, D)
        blocks.append(blk)
    params = {"embed": g(cfg.vocab, D), "blocks": blocks, "ln_f": ones(D)}
    return shard_params(params, cfg, ep)


def _route(x, blk, cfg: MoEConfig):
    """Top-1 routing of tokens x [N, D]: (expert index [N], gate [N],
    switch load-balance aux E sum_e frac_tokens_e mean_prob_e, one-hot
    [N, E] float32)."""
    logits = _mm(x, blk["router"].to(cfg.tdtype))
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, cfg.n_experts).float()
    aux = cfg.n_experts * torch.sum(torch.mean(onehot, dim=0)
                                    * torch.mean(probs, dim=0))
    return expert_idx, gate, aux, onehot


def _expert(t, w1, w2):
    """One expert's FFN on tokens t [T, D]."""
    return _mm(F.gelu(_mm(t, w1), approximate="tanh"), w2)


def _expert_members(xs, blks, cfg: MoEConfig, capacity: int,
                    fused: bool = False, devs=None) -> tuple:
    """The routed FFN of the ep members: member e's rows ``xs[e]`` [n, D]
    routed with ``blks[e]``'s router to the members' experts by the
    all-to-all pair (``fused=True``: ``fused_expert_ffn``, bitwise the
    same) at ``capacity`` a member and expert, gated.  ``devs``: the
    members' cards (each member's rows, router and result on its own; the
    all-to-alls cross between them), or None on one device.  Returns
    (each member's [n, D], each member's aux)."""
    dt = cfg.tdtype
    routes = [_route(x, b, cfg) for x, b in zip(xs, blks)]
    idxs = [r[0] for r in routes]
    ffns = [functools.partial(_expert, w1=w1[0].to(dt), w2=w2[0].to(dt))
            for w1, w2 in zip(blks[0]["we1"], blks[0]["we2"])]
    if fused:
        ys = fused_expert_ffn(xs, idxs, ffns, capacity=capacity,
                              devices=devs)
    else:
        inputs, info = expert_dispatch(xs, idxs, capacity=capacity,
                                       devices=devs)
        ys = expert_combine([f(t) for f, t in zip(ffns, inputs)], info,
                            devices=devs)
    return ([y * r[1].to(dt)[:, None] for y, r in zip(ys, routes)],
            [r[2] for r in routes])


def _moe_ffn(h, blk, cfg: MoEConfig, ep: int = 1,
             capacity: Optional[int] = None, fused: bool = False,
             places: Optional[Places] = None):
    """Top-1 routed FFN on h [B, T, D] -> (y [B, T, D], aux).

    ``ep`` = 1: the dense reference, every expert on every token, aux a
    scalar.  ``ep`` > 1: the batch splits over the members, each routing
    its own B / ep rows to the members' experts (:func:`_expert_members`),
    aux one scalar per member.  ``capacity`` overrides the per-expert
    budget ceil(tokens capacity_factor / E) of each member; serving passes
    a member's token count, which makes the dispatch drop-free.  With
    ``places`` (members on several cards; ``h`` on the hub, as the
    serving path holds it) member e's rows move to its card, are routed
    there with its own router and come back to the hub."""
    B, T, D = h.shape
    dt = cfg.tdtype
    if ep == 1:
        x = h.reshape(B * T, D)
        expert_idx, gate, aux, onehot = _route(x, blk, cfg)
        y_all = torch.einsum("nd,edf->enf", x, _bank(blk["we1"]).to(dt))
        y_all = F.gelu(y_all, approximate="tanh")
        y_all = torch.einsum("enf,efd->end", y_all,
                             _bank(blk["we2"]).to(dt))
        y = torch.einsum("end,ne->nd", y_all, onehot.to(dt))
        return (y * gate.to(dt)[:, None]).reshape(B, T, D), aux
    if B % ep:
        raise ValueError(f"batch {B} does not split over {ep} ep members")
    if len(blk["we1"]) != ep or ep != cfg.n_experts:
        raise ValueError(f"expert parallelism over {ep} members needs the "
                         f"{cfg.n_experts} experts split one per member "
                         f"(banks split over {len(blk['we1'])})")
    b = B // ep
    xs = list(h.reshape(ep, b * T, D))
    blks, devs = [blk] * ep, None
    if places is not None:
        devs = places.devices
        xs = [x if e == 0 else move(x, devs[e]) for e, x in enumerate(xs)]
        blks = [_member_block(blk, places, e) for e in range(ep)]
    ys, aux = _expert_members(xs, blks, cfg, _capacity(cfg, b * T, capacity),
                              fused, devs)
    if devs is not None:
        ys = [y if e == 0 else move(y, devs[0]) for e, y in enumerate(ys)]
    return torch.cat(ys).reshape(B, T, D), aux


def _capacity(cfg: MoEConfig, n: int, capacity: Optional[int]) -> int:
    """A member's per-expert budget over its n tokens: ``capacity``, or
    ceil(n capacity_factor / E)."""
    return (capacity if capacity is not None else
            int(np.ceil(n * cfg.capacity_factor / cfg.n_experts)))


def moe_block_qkv(h, blk, cfg: MoEConfig):
    """q/k/v projections of one block's normed input [B, T, D] -> [B, T, H,
    Dh] each; shared by the training forward and the serving path."""
    B, T, D = h.shape
    dt = cfg.tdtype
    return tuple(_mm(h, blk[w].to(dt).reshape(D, -1)).reshape(
        B, T, cfg.n_heads, cfg.d_head) for w in ("wq", "wk", "wv"))


def moe_block_attn_out(x, attn, blk, cfg: MoEConfig):
    """Attention-out projection and residual (shared with moe_decode)."""
    B, T = x.shape[0], x.shape[1]
    wo = blk["wo"].to(cfg.tdtype)
    return x + _mm(attn.reshape(B, T, -1), wo.reshape(-1, wo.shape[-1]))


def _add_aux(total, aux):
    if total is None:
        return aux
    if isinstance(aux, list):
        return [a + b for a, b in zip(total, aux)]
    return total + aux


def _forward_members(params, places: Places, tokens, cfg: MoEConfig,
                     fused: bool = False) -> tuple:
    """The forward over the ep members' cards: member e's B / ep rows of
    ``tokens`` on its card from the embedding to the logits, with its own
    copies of the replicated leaves; the expert all-to-alls are the only
    crossings.  Returns (each member's logits [B / ep, T, vocab], each
    member's aux summed over the layers), each on its member's card."""
    devs = places.devices
    ep = len(devs)
    B, T = tokens.shape
    if B % ep:
        raise ValueError(f"batch {B} does not split over {ep} ep members")
    if ep != cfg.n_experts:
        raise ValueError(f"expert parallelism over {ep} members needs the "
                         f"{cfg.n_experts} experts split one per member")
    b, D, dt = B // ep, cfg.d_model, cfg.tdtype
    trees = [_member_tree(params, places, e) for e in range(ep)]
    xs = [t["embed"][tokens[e * b:(e + 1) * b].to(devs[e])].to(dt)
          for e, t in enumerate(trees)]
    cap = _capacity(cfg, b * T, None)
    aux_total = None
    for i in range(cfg.n_layers):
        blks = [t["blocks"][i] for t in trees]
        hs = []
        for e, blk in enumerate(blks):
            q, k, v = moe_block_qkv(_rmsnorm(xs[e], blk["ln1"]), blk, cfg)
            xs[e] = moe_block_attn_out(
                xs[e], _dense_attention(q, k, v, causal=True), blk, cfg)
            hs.append(_rmsnorm(xs[e], blk["ln2"]).reshape(b * T, D))
        ys, aux = _expert_members(hs, blks, cfg, cap, fused, devs)
        xs = [x + y.reshape(b, T, D) for x, y in zip(xs, ys)]
        aux_total = _add_aux(aux_total, aux)
    return ([_mm(_rmsnorm(x, t["ln_f"]), t["embed"].to(dt).t())
             for x, t in zip(xs, trees)], aux_total)


def forward(params, tokens, cfg: MoEConfig, ep: int = 1,
            fused: bool = False):
    """Token ids [B, T] -> (logits [B, T, vocab], aux summed over the
    layers), on the device the parameters live on.  ``ep`` > 1: the batch
    split over that many members, the banks one expert per member, and the
    aux one float32 scalar per member (a list).  Parameters placed on
    several cards (:func:`place_params`) run each member's rows on its
    card (:func:`_forward_members`), its aux there; the logits are
    gathered on the hub."""
    places = _places(params, "we1")
    if places is not None:
        logits, aux = _forward_members(params, places,
                                       torch.as_tensor(tokens), cfg, fused)
        hub = places.devices[0]
        return torch.cat([logits[0]] + [move(lg, hub) for lg in logits[1:]]
                         ), aux
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    dt = cfg.tdtype
    x = embed[tokens].to(dt)
    aux_total = None
    for blk in params["blocks"]:
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = moe_block_qkv(h, blk, cfg)
        attn = _dense_attention(q, k, v, causal=True)
        x = moe_block_attn_out(x, attn, blk, cfg)
        h = _rmsnorm(x, blk["ln2"])
        m, aux = _moe_ffn(h, blk, cfg, ep, fused=fused)
        aux_total = _add_aux(aux_total, aux)
        x = x + m
    x = _rmsnorm(x, params["ln_f"])
    return _mm(x, embed.to(dt).t()), aux_total


def loss_fn(params, tokens, cfg: MoEConfig, ep: int = 1,
            fused: bool = False):
    """Next-token cross entropy plus the router load-balance aux: returns
    (loss_sum, count), float32 scalars, the sum-and-count discipline of
    the transformer's ``loss_fn``.  The aux enters count-weighted
    (``router_aux_weight * aux * count``) per member, so that after the
    division by the global count it is the token-weighted mean of the
    members' aux losses.  Parameters placed on several cards: each
    member's sum and count on its card (:func:`_loss_members`), folded in
    member order on the hub."""
    if _places(params, "we1") is not None:
        sums, counts = _loss_members(params, tokens, cfg, fused)
        hub = sums[0].device
        total, count = sums[0], counts[0]
        for s_, c in zip(sums[1:], counts[1:]):
            total = total + move(s_, hub)
            count = count + move(c, hub)
        return total, count
    logits, aux = forward(params, tokens, cfg, ep, fused=fused)
    nll, valid = _nll(logits, torch.as_tensor(tokens, device=logits.device))
    B = nll.shape[0]
    if ep == 1:
        count = torch.sum(valid.float())
        return (torch.sum(nll) + cfg.router_aux_weight * aux * count,
                count)
    b = B // ep
    loss_sum = count = None
    for r, a in enumerate(aux):
        c = torch.sum(valid[r * b:(r + 1) * b].float())
        s = torch.sum(nll[r * b:(r + 1) * b]) + cfg.router_aux_weight * a * c
        loss_sum = s if loss_sum is None else loss_sum + s
        count = c if count is None else count + c
    return loss_sum, count


def _nll(logits, tokens) -> tuple:
    """Next-token negative log-likelihood [B, T] of tokens [B, T] (0 at
    the masked last position) and its valid mask."""
    tokens = tokens.long()
    B, T = tokens.shape
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
    valid = torch.ones((B, T), dtype=torch.bool, device=logits.device)
    valid[:, -1] = False
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.where(valid, nll, 0.0), valid


def _loss_members(params, tokens, cfg: MoEConfig, fused: bool = False):
    """``loss_fn`` over the ep members' cards: each member's (sum,
    count) of its rows on its card, the aux count-weighted as
    :func:`loss_fn` weighs it.  Returns (sums, counts), one per member."""
    places = _places(params, "we1")
    tokens = torch.as_tensor(tokens)
    logits, aux = _forward_members(params, places, tokens, cfg, fused)
    b = tokens.shape[0] // len(logits)
    sums, counts = [], []
    for e, (lg, a) in enumerate(zip(logits, aux)):
        nll, valid = _nll(lg, tokens[e * b:(e + 1) * b].to(lg.device))
        c = torch.sum(valid.float())
        sums.append(torch.sum(nll) + cfg.router_aux_weight * a * c)
        counts.append(c)
    return sums, counts


def make_train_step(mesh, cfg: MoEConfig, lr: float = 1e-3,
                    dp: Optional[str] = "dp", ep: Optional[str] = "ep",
                    fused: bool = False):
    """The train step over ``mesh`` (a ``parallel.mesh.RankMesh``), plain
    SGD at ``lr``: the token batch [B, T] splits over (dp, ep) in that
    order, each dp member's ``loss_fn`` runs its ep members' rows with the
    expert all-to-all, and the update is the transformer's
    ``sum_count_device_step``, in place.  ``params`` must hold the banks
    split over the mesh's ep extent, which must equal ``n_experts``.
    Returns ``(step_fn, (param_specs, token_spec))``, ``token_spec`` the
    axes the batch dimension splits over.  Over a mesh of several cards
    ``params`` is what :func:`place_params` returns for it, and the
    members' gradients fold as ``transformer._mean_grads_cards`` says."""
    shape = mesh.shape
    dp = dp if dp in shape else None
    ep = ep if ep in shape else None
    if ep is not None and shape[ep] != cfg.n_experts:
        raise ValueError(
            f"ep axis size {shape[ep]} != n_experts {cfg.n_experts}")
    n_dp = shape[dp] if dp else 1
    n_ep = shape[ep] if ep else 1

    cards = mesh.devices is not None

    def card_step(params, tokens):
        reps = placed_replicas(params, mesh, "ep", n_dp)
        if torch.as_tensor(tokens).shape[0] % (n_dp * n_ep):
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{n_dp} dp x {n_ep} ep members")
        return params, sgd_cards(card_closures(
            reps, tokens, n_dp,
            lambda p, t: _loss_members(p, t, cfg, fused=fused)), reps, lr,
            tree_devices(mesh, "ep"))

    def step_fn(params, tokens):
        if cards:
            return card_step(params, tokens)
        if ep_size(params) != n_ep:
            raise ValueError(f"expert banks are split over "
                             f"{ep_size(params)} ep members, the mesh has "
                             f"{n_ep}")
        if params["embed"].device != mesh.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"mesh on {mesh.device}")
        tokens = torch.as_tensor(tokens, device=mesh.device)
        B = tokens.shape[0]
        if B % (n_dp * n_ep):
            raise ValueError(f"batch {B} does not split over {n_dp} dp x "
                             f"{n_ep} ep members")
        b = B // n_dp
        closures = [
            (lambda p, t=tokens[d * b:(d + 1) * b]:
             loss_fn(p, t, cfg, n_ep, fused=fused)) for d in range(n_dp)]
        return sum_count_device_step(closures, params, lr)

    token_spec = (tuple(a for a in (dp, ep) if a) or None,)
    return step_fn, (param_specs(cfg), token_spec)
