"""Parallelism strategies over rank lists.

Port of ``accl_tpu/parallel/strategies.py``.  There each strategy runs
inside ``shard_map`` on one member's value over a mesh axis; here the
axis is a list with one entry per member, in rank order (the convention
of ``collectives.py``), and each function returns one entry per member.
Values every member ends with alike are one object, repeated.

- data parallel: ``sync_gradients`` (allreduce, optionally over the bf16,
  f16 or int8 wire), ZeRO ``zero_shard_gradients`` /
  ``zero_unshard_params`` (reduce-scatter + all-gather);
- tensor parallel: ``column_parallel`` / ``row_parallel``;
- pipeline parallel: ``pipeline_apply`` (GPipe ticks over a neighbour
  shift);
- expert parallel: ``expert_dispatch`` / ``expert_combine`` (all-to-all).

A gradient "tree" is a tensor or any dict/list nesting of tensors (the
model's parameter layout included).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ops.quantized import quantized_all_reduce
from ..utils.tree import tree_leaves, tree_map
from .collectives import all_gather, all_reduce, all_to_all, ppermute, \
    reduce_scatter


def _per_member(fn: Callable, trees: Sequence) -> list:
    """Apply ``fn`` (members' leaves -> members' results) leaf by leaf
    over per-member trees of one structure."""
    P = len(trees)
    flat = [tree_leaves(t) for t in trees]
    results = [fn([flat[r][i] for r in range(P)])
               for i in range(len(flat[0]))]
    out = []
    for r in range(P):
        it = iter(res[r] for res in results)
        out.append(tree_map(lambda _leaf: next(it), trees[r]))
    return out


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------
def _pad_to_multiple(flat: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad a flat tensor so its length divides ``size``."""
    pad = (-flat.shape[0]) % size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def sync_gradients(grads: Sequence, compress: Optional[str] = None,
                   mean: bool = True, error_feedback: bool = False,
                   stochastic: bool = False, seed: int = 0) -> list:
    """All-reduce per-member gradient trees across the data-parallel
    members (``grads[r]`` is member r's tree): the mean (or with
    ``mean=False`` the sum) of each leaf, in its dtype.

    ``compress="bf16"|"f16"`` rounds each member's payload to half
    precision before the float32 sum (the on-the-wire fp16 lane);
    ``compress="int8"`` runs each flattened, zero-padded leaf through the
    int8 block-scaled ring allreduce of ``ops/quantized.py``, with its
    ``error_feedback``, ``stochastic`` and ``seed`` (those apply to the
    int8 lane only)."""
    size = len(grads)

    def sync_leaf(gs):
        orig = gs[0].dtype
        if compress == "int8":
            flats = [_pad_to_multiple(g.float().reshape(-1), size)
                     for g in gs]
            out = quantized_all_reduce(flats, error_feedback=error_feedback,
                                       stochastic=stochastic, seed=seed)[0]
            if mean:
                out = out / size
            res = out[:gs[0].numel()].reshape(gs[0].shape).to(orig)
            return [res] * size
        if compress == "bf16":
            gs = [g.to(torch.bfloat16).float() for g in gs]
        elif compress == "f16":
            gs = [g.to(torch.float16).float() for g in gs]
        out = all_reduce(gs, "mean" if mean else "sum")[0]
        return [out.to(orig)] * size

    return _per_member(sync_leaf, grads)


def zero_shard_gradients(grads: Sequence) -> list:
    """ZeRO-1 style: reduce-scatter each flattened, zero-padded gradient
    leaf, so member r owns block r of the reduced values."""
    size = len(grads)
    return _per_member(
        lambda gs: reduce_scatter([_pad_to_multiple(g.reshape(-1), size)
                                   for g in gs]), grads)


def zero_unshard_params(shards: Sequence, shapes) -> list:
    """Inverse of :func:`zero_shard_gradients`: all-gather the owned
    blocks back into full leaves.  ``shapes`` is a tree of shape tuples in
    the shards' structure (tuples inside it are shapes, not nodes)."""
    shape_list = []

    def collect(node):
        if isinstance(node, dict):
            for k in node:
                collect(node[k])
        elif isinstance(node, list):
            for x in node:
                collect(x)
        else:
            shape_list.append(tuple(node))

    collect(shapes)
    it = iter(shape_list)

    def gather_leaf(ss):
        shape = next(it)
        n = 1
        for d in shape:
            n *= d
        full = all_gather(list(ss))[0]
        return [full[:n].reshape(shape)] * len(ss)

    return _per_member(gather_leaf, shards)


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------
def column_parallel(xs: Sequence[torch.Tensor],
                    w_shards: Sequence[torch.Tensor],
                    gather_output: bool = False) -> list:
    """y_r = x_r @ W[:, shard r] with float32 accumulation, in x's dtype;
    with ``gather_output`` every member gets the columns concatenated.
    (Megatron's column-parallel linear; no communication without the
    gather.)"""
    ys = [torch.matmul(x.float(), w.float()).to(x.dtype)
          for x, w in zip(xs, w_shards)]
    if gather_output:
        return all_gather(ys, gather_axis=ys[0].dim() - 1)
    return ys


def row_parallel(x_shards: Sequence[torch.Tensor],
                 w_shards: Sequence[torch.Tensor]) -> list:
    """y = sum_r x[shard r] @ W[shard r, :]: the float32 partial products
    all-reduce over the members (the fused matmul + allreduce pattern),
    cast to x's dtype."""
    partial = [torch.matmul(x.float(), w.float())
               for x, w in zip(x_shards, w_shards)]
    out = all_reduce(partial)[0].to(x_shards[0].dtype)
    return [out] * len(partial)


# ---------------------------------------------------------------------------
# pipeline parallel
# ---------------------------------------------------------------------------
def pipeline_apply(stage_fn: Callable, params: Sequence,
                   x_microbatches: torch.Tensor) -> list:
    """GPipe-style pipeline over P members, member i holding stage i's
    ``params[i]``.  ``x_microbatches`` [M, ...] enters stage 0; the
    schedule runs M + P - 1 ticks, each stage's output shifting to the
    next member every tick (no wraparound).  The last member gets the
    outputs [M, ...]; every other member zeros."""
    P = len(params)
    M = x_microbatches.shape[0]
    fwd = [(i, i + 1) for i in range(P - 1)]
    x0 = x_microbatches[0].float()
    act = [torch.zeros_like(y) for y in ppermute(
        [stage_fn(p, x0) for p in params], fwd)]
    ys = [[] for _ in range(P)]
    for t in range(M + P - 1):
        mb = min(max(t, 0), M - 1)
        outs = [stage_fn(params[i], x_microbatches[mb].float() if i == 0
                         else act[i]) for i in range(P)]
        for i in range(P):
            ys[i].append(outs[i])
        act = ppermute(outs, fwd)
    last = torch.stack(ys[P - 1][P - 1:P - 1 + M])
    return [torch.zeros_like(last)] * (P - 1) + [last]


# ---------------------------------------------------------------------------
# expert parallel (MoE)
# ---------------------------------------------------------------------------
def expert_dispatch(xs: Sequence[torch.Tensor],
                    expert_idxs: Sequence[torch.Tensor],
                    capacity: int = 0) -> tuple:
    """Route each member's tokens to the member hosting their expert via
    all-to-all (one expert per member).  xs[r] [N, D], expert_idxs[r] [N]
    in [0, P).  Returns (expert inputs [P cap, D] per member, combine info
    per member); tokens over capacity combine to zero."""
    P = len(xs)
    N, D = xs[0].shape
    cap = capacity or -(-N // P)
    buckets, infos = [], []
    for x, idx in zip(xs, expert_idxs):
        idx = idx.long()
        onehot = torch.nn.functional.one_hot(idx, P)            # [N, P]
        pos_in_expert = torch.cumsum(onehot, dim=0) * onehot - 1
        slot = torch.sum(pos_in_expert * onehot, dim=1)          # [N]
        keep = slot < cap
        b = torch.zeros((P, cap, D), dtype=x.dtype, device=x.device)
        b.index_put_((idx, slot.clamp(0, cap - 1)),
                     torch.where(keep[:, None], x, 0.0), accumulate=True)
        buckets.append(b)
        infos.append((idx, slot, keep, cap))
    recv = all_to_all(buckets, split_axis=0, concat_axis=0, tiled=False)
    return [r.reshape(P * cap, D) for r in recv], infos


def expert_combine(ys: Sequence[torch.Tensor], infos: Sequence) -> list:
    """Inverse of :func:`expert_dispatch`: return the expert outputs
    [P cap, D] to their source members and scatter them back into token
    order."""
    P = len(ys)
    cap = infos[0][3]
    D = ys[0].shape[-1]
    back = all_to_all([y.reshape(P, cap, D) for y in ys], split_axis=0,
                      concat_axis=0, tiled=False)
    out = []
    for b, (idx, slot, keep, _cap) in zip(back, infos):
        gathered = b[idx, slot.clamp(0, cap - 1)]
        out.append(torch.where(keep[:, None], gathered, 0.0))
    return out
