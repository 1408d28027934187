"""Attention across sequence shards: the ring (contiguous and zigzag),
windowed and Ulysses schedules, and the dense reference.

Port of ``accl_tpu/parallel/ring_attention.py``.  There each function runs
inside ``shard_map`` on one member's sequence shard and rotates K/V with
``ppermute``.  Here the sp axis is the list (``parallel/collectives.py``):
each schedule takes one [B, T_local, H, D] tensor per member, in rank
order, and returns one per member.  K/V rotation is list rotation, and the
last hop's rotation, whose result nothing reads, is dropped.

``impl="flash"`` (the default on the card) computes each hop's blocks with
``ops.flash.flash_attention_lse`` and folds the partial attentions by
log-sum-exp.  Every hop is one launch over the members whose arriving
shard is live on it, stacked along the batch axis: the packed kernels
treat every (batch, head) row on its own, and their schedule depends on
the lengths and the head size only, so each member's rows are what a call
for that member alone gives.  A dead hop makes no launch and no merge:
merging a partial at lse = -inf leaves the carry as it was.  The first
live partial of a carry is taken as the carry, which is what merging it
into the JAX package's zero carry gives.  ``impl="dense"`` is the
streaming-softmax reference, member by member, hop by hop.  Gradients are
autograd through the hops (``ops.flash``'s ``_FlashPacked``, so an lse
that feeds a merge brings its cotangent into the backward kernels), the
merges and the rotations.

Members on several cards (their shards on more than one device, or
``devices=``): each member's shards, carries and output stay on its own
card; a rotation is a counted ``collectives.move`` of every K/V shard to
the next member's card (the windowed schedule moves only the tails); a
flash hop is one launch per card over that card's live members, stacked
as above, so each member's rows are bitwise what one launch over every
member gives.  Where a backward will run (autograd records the hop),
each live member's hop is a launch of its own instead, so that its
gradients are the same bits whichever members share its card (the
backward's plan depends on the launch's size).  Ulysses' two
all-to-alls cross through the same move and its attention is one launch
per card over that card's members.  The outputs are bitwise the
one-card schedules'.  The gradients are too where the backward's plan
cuts the one-card ring's stacked launch as it cuts each member's own
(short shards, every cut at the plan's minimum); at long shards the
split tiles' fp32 partials round apart.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .collectives import _placement, all_to_all, move

NEG_INF = -1e30


def _flash_defaults(q):
    """Whether the flash hops run (on the card; the CPU takes the dense
    reference unless asked for "flash"), and the MXU input format: 16-bit
    activations keep their format, float32 stays exact."""
    on_card = q.device.type == "cuda"
    mxu = (q.dtype if q.dtype in (torch.bfloat16, torch.float16)
           else torch.float32)
    return on_card, mxu


def _rotate(xs: list, devs: Optional[list] = None) -> list:
    """One ring hop: member i + 1 gets member i's value (``ppermute`` with
    the pairs (i, i + 1 mod P)); with ``devs`` (members on several cards)
    each value moves to its new member's card, counted."""
    out = xs[-1:] + xs[:-1]
    if devs is None:
        return out
    return [move(x, d) for x, d in zip(out, devs)]


def _block_attn(q, k, v, bias):
    """Scores and masked streaming-softmax contributions of one K/V block.
    q [B, Tq, H, D], k/v [B, Tk, H, D], bias [Tq, Tk] additive.  Returns
    (m_blk [B, H, Tq], p [B, H, Tq, Tk], pv [B, Tq, H, D])."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]))).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias[None, None, :, :]
    m_blk = torch.amax(s, dim=-1)
    p = torch.exp(s - m_blk[..., None])
    # fully masked rows (m_blk == NEG_INF give exp(0) = 1) contribute 0
    dead = m_blk <= NEG_INF / 2
    p = torch.where(dead[..., None], 0.0, p)
    m_blk = torch.where(dead, NEG_INF, m_blk)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_blk, p, pv


def zigzag_indices(T: int, P: int) -> torch.Tensor:
    """The global sequence permutation of the zigzag causal layout: member
    i holds chunk i and its mirror chunk 2P - 1 - i (each T / (2P) long),
    so every member does the same causal work on every hop.  ``x[:, perm]``
    reorders a [B, T, ...] sequence into zigzag order; the inverse
    (``zigzag_indices_inverse``) takes outputs back."""
    if T % (2 * P) != 0:
        raise ValueError(f"T={T} not divisible by 2*P={2 * P}")
    C = T // (2 * P)
    chunks = []
    for i in range(P):
        chunks.append(np.arange(i * C, (i + 1) * C))
        j = 2 * P - 1 - i
        chunks.append(np.arange(j * C, (j + 1) * C))
    return torch.from_numpy(np.concatenate(chunks))


def zigzag_indices_inverse(T: int, P: int) -> torch.Tensor:
    """Inverse of :func:`zigzag_indices` (natural <- zigzag)."""
    perm = zigzag_indices(T, P)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(T)
    return inv


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], causal: bool = False,
                   impl: Optional[str] = None, schedule: str = "contiguous",
                   flash_opts: Optional[dict] = None,
                   window: Optional[int] = None, devices=None) -> list:
    """Exact attention over the sequence the members' shards make up.

    ``qs``, ``ks``, ``vs``: one [B, T_local, H, D] shard per member (K/V
    may carry G heads, G dividing H), the global sequence their rank-major
    concatenation.  Returns one [B, T_local, H, D] output per member;
    numerics accumulate in float32.

    ``impl``: "flash" (the flash kernels per hop, lse-weighted folds) or
    "dense" (the streaming-softmax reference); None is flash on the card
    and dense on the CPU.  ``schedule="zigzag"`` (causal) expects the
    sequence permuted by :func:`zigzag_indices` and returns outputs in
    that order.  ``flash_opts`` go to every flash call.  ``window``
    (causal, contiguous, window <= T_local) is sliding-window attention:
    the local windowed block plus one neighbour hop.  ``devices``: the
    members' devices, for members on several cards (by default the
    shards' own, when they lie on more than one)."""
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring_attention schedule {schedule!r}")
    qs, ks, vs = list(qs), list(ks), list(vs)
    devs = _placement(qs, devices)
    if impl is None:
        impl = "flash" if _flash_defaults(qs[0])[0] else "dense"
    H = qs[0].shape[2]
    if ks[0].shape[2] != H:
        if H % ks[0].shape[2] != 0:
            raise ValueError(f"K/V heads {ks[0].shape[2]} must divide q "
                             f"heads {H} for GQA")
        if impl == "dense":
            kv = [expand_gqa_kv(k, v, H) for k, v in zip(ks, vs)]
            ks, vs = [k for k, _ in kv], [v for _, v in kv]
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (a sliding "
                             "window is a trailing-context mask)")
        if schedule != "contiguous":
            raise ValueError("window composes with the contiguous "
                             "schedule only (the zigzag layout's split "
                             "chunks break the one-neighbor-hop bound)")
        Tl = qs[0].shape[1]
        if window < 1 or window > Tl:
            raise ValueError(
                f"window={window} must be in [1, T_local={Tl}]: larger "
                "windows span more than one neighbor shard (shard the "
                "sequence into fewer, longer pieces)")
        return _ring_attention_windowed(qs, ks, vs, window, impl,
                                        flash_opts=flash_opts, devs=devs)
    if schedule == "zigzag":
        if not causal:
            raise ValueError("zigzag schedule only makes sense for causal "
                             "attention (non-causal hops are already "
                             "balanced)")
        if impl == "flash":
            return _ring_attention_flash_zigzag(qs, ks, vs,
                                                flash_opts=flash_opts,
                                                devs=devs)
        if impl != "dense":
            raise ValueError(f"unknown ring_attention impl {impl!r}")
        return _ring_attention_dense_zigzag(qs, ks, vs, devs)
    if impl == "flash":
        return _ring_attention_flash(qs, ks, vs, causal,
                                     flash_opts=flash_opts, devs=devs)
    if impl != "dense":
        raise ValueError(f"unknown ring_attention impl {impl!r}")
    bias_fn = None
    if causal:
        Tl = qs[0].shape[1]
        ar = torch.arange(Tl, device=qs[0].device)

        def bias_fn(idx, src):
            keep = (idx * Tl + ar)[:, None] >= (src * Tl + ar)[None, :]
            return torch.where(keep, 0.0, NEG_INF)
    return _dense_ring_loop(qs, ks, vs, bias_fn, devs)


def _dense_ring_loop(qs, ks, vs, bias_fn: Optional[Callable],
                     devs: Optional[list] = None) -> list:
    """The dense ring schedule of the contiguous and zigzag layouts: K/V
    rotate around the ring and each member folds every arriving shard
    into a streaming-softmax accumulator.  ``bias_fn(idx, src)`` is the
    [Tl, Tl] additive mask of the shard that started at member ``src``,
    seen from member ``idx`` (None: unmasked); on several cards each
    member's mask is copied to its card."""
    P = len(qs)
    B, Tl, H, _D = qs[0].shape
    dev = qs[0].device
    qf = [q.float() for q in qs]
    o = [torch.zeros_like(q) for q in qf]
    m = [torch.full((B, H, Tl), NEG_INF, device=q.device) for q in qs]
    lsum = [torch.zeros((B, H, Tl), device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    zero_bias = torch.zeros((Tl, Tl), device=dev)
    for s in range(P):
        for idx in range(P):
            src = (idx - s) % P
            bias = bias_fn(idx, src) if bias_fn is not None else zero_bias
            if devs is not None:
                bias = bias.to(qf[idx].device)
            m_blk, p, pv = _block_attn(qf[idx], kc[idx], vc[idx], bias)
            m_new = torch.maximum(m[idx], m_blk)
            # the all-dead case: exp(NEG_INF - NEG_INF) = 1
            alpha = torch.where(m[idx] <= NEG_INF / 2, 0.0,
                                torch.exp(m[idx] - m_new))
            beta = torch.where(m_blk <= NEG_INF / 2, 0.0,
                               torch.exp(m_blk - m_new))
            lsum[idx] = lsum[idx] * alpha + torch.sum(p, dim=-1) * beta
            o[idx] = (o[idx] * alpha.transpose(1, 2)[..., None]
                      + pv * beta.transpose(1, 2)[..., None])
            m[idx] = m_new
        if s < P - 1:
            kc, vc = _rotate(kc, devs), _rotate(vc, devs)
    return [(oi / torch.clamp_min(li, 1e-30).transpose(1, 2)[..., None])
            .to(q.dtype) for oi, li, q in zip(o, lsum, qs)]


def _lse_merge(o, lse, o_i, lse_i, _NI=NEG_INF):
    """lse-weighted merge of normalized partial attentions (exact; a dead
    partial carries lse = -inf and weight 0).  o/o_i [B, T, H, D] (o the
    float32 carry), lse/lse_i [B, H, T].  Returns (o', lse')."""
    m_new = torch.maximum(lse, lse_i)
    safe = torch.where(m_new <= _NI / 2, 0.0, m_new)
    w_r = torch.where(lse <= _NI / 2, 0.0, torch.exp(lse - safe))
    w_i = torch.where(lse_i <= _NI / 2, 0.0, torch.exp(lse_i - safe))
    # a normal-range epsilon: 1e-38 is subnormal in float32 and flushes to
    # zero on the card, making the both-dead case 0/0 = NaN
    tot = torch.clamp_min(w_r + w_i, 1e-30)
    wr4 = (w_r / tot).transpose(1, 2)[..., None]  # [B, T, H, 1]
    wi4 = (w_i / tot).transpose(1, 2)[..., None]
    o_new = o * wr4 + o_i.float() * wi4
    lse_new = torch.where((w_r + w_i) == 0.0, _NI, safe + torch.log(tot))
    return o_new, lse_new


def _fold(carry, part):
    """Merge partial ``part`` = (o_i, lse_i) into ``carry`` (None before the
    first live partial, which becomes the carry as it is)."""
    o_i, lse_i = part
    if carry is None:
        return o_i.float(), lse_i
    return _lse_merge(carry[0], carry[1], o_i, lse_i)


def _flash_hop(items, causal: bool, mxu, flash_opts,
               members: Optional[list] = None) -> list:
    """One flash launch over ``items`` ((q, k, v), all of one shape),
    stacked along the batch axis; returns each item's (out [B, Tq, H, D],
    lse [B, H, Tq]).  Items on several cards make one launch per card,
    over that card's items.  ``members``: each item's member, when the
    members are on several cards: where autograd records the hop, each
    member's items make a launch of their own, on its card, whichever
    other members share that card.  The backward kernels' plan cuts its
    work by the launch's size, so a member's gradients are the same bits
    on any placement only when its launches are its own; the forward's
    rows are the same bits in any stack."""
    from ..ops.flash import flash_attention_lse

    opts = dict(flash_opts or {})
    opts.setdefault("mxu_dtype", mxu)
    B = items[0][0].shape[0]
    own = members is not None and torch.is_grad_enabled() and any(
        t.requires_grad for it in items for t in it)
    groups: dict = {}
    for i, it in enumerate(items):
        groups.setdefault(members[i] if own else it[0].device,
                          []).append(i)
    got = [None] * len(items)
    for idxs in groups.values():
        q, k, v = (torch.cat([items[i][j] for i in idxs]) for j in range(3))
        out, lse = flash_attention_lse(q, k, v, causal=causal, **opts)
        for i, part in zip(idxs, zip(out.split(B), lse.split(B))):
            got[i] = part
    return got


def _ring_attention_flash(qs, ks, vs, causal: bool,
                          flash_opts: Optional[dict] = None,
                          devs: Optional[list] = None) -> list:
    """The contiguous flash ring: on hop s member idx holds the shard that
    started at src = (idx - s) mod P, which is the diagonal (s = 0, causal
    flash), in the past (src < idx, unmasked flash) or in the future (no
    launch, no merge) — so hop 0 is one causal launch over the P members
    and hop s one unmasked launch over the P - s members idx >= s; without
    ``causal`` every hop is one unmasked launch over all P."""
    P = len(qs)
    mxu = _flash_defaults(qs[0])[1]
    carry = [None] * P
    kc, vc = list(ks), list(vs)
    for s in range(P):
        live = [idx for idx in range(P)
                if not causal or s == 0 or (idx - s) % P < idx]
        parts = _flash_hop([(qs[i], kc[i], vc[i]) for i in live],
                           causal and s == 0, mxu, flash_opts,
                           None if devs is None else live)
        for idx, part in zip(live, parts):
            carry[idx] = _fold(carry[idx], part)
        if s < P - 1:
            kc, vc = _rotate(kc, devs), _rotate(vc, devs)
    return [c[0].to(q.dtype) for c, q in zip(carry, qs)]


def _ring_attention_dense_zigzag(qs, ks, vs,
                                 devs: Optional[list] = None) -> list:
    """The dense zigzag schedule: the shared ring loop with the causal mask
    taken from the zigzag global positions of the local rows (chunk idx
    and its mirror 2P - 1 - idx)."""
    P = len(qs)
    Tl = qs[0].shape[1]
    if Tl % 2 != 0:
        raise ValueError(f"zigzag needs an even local length, got {Tl}")
    C = Tl // 2
    ar = torch.arange(C, device=qs[0].device)

    def positions(r):
        return torch.cat([r * C + ar, (2 * P - 1 - r) * C + ar])

    def bias_fn(idx, src):
        keep = positions(idx)[:, None] >= positions(src)[None, :]
        return torch.where(keep, 0.0, NEG_INF)

    return _dense_ring_loop(qs, ks, vs, bias_fn, devs)


def _ring_attention_flash_zigzag(qs, ks, vs,
                                 flash_opts: Optional[dict] = None,
                                 devs: Optional[list] = None) -> list:
    """The flash zigzag schedule.  Member idx holds chunks (idx, 2P-1-idx),
    q halves ql and qh of C = T_local / 2 rows.  With the arriving chunks
    (a, 2P-1-a), a = (idx - s) mod P, the live half-chunk pairs are:

      (qh, kl): always, unmasked            [merged into the hi carry]
      a < idx:  (ql, kl) unmasked           [lo carry]
      a == idx: (ql, kl) and (qh, kh) causal [the diagonal hop, s = 0]
      a > idx:  (qh, kh) unmasked           [hi carry]
      (ql, kh): never

    Hop 0 is one causal launch over the 2P diagonal pairs and one unmasked
    launch over the P (qh, kl) pairs; every later hop is one unmasked
    launch over the 2P live pairs.  The merges follow the JAX schedule's
    order: lo, then hi with (qh, kl), then hi with the other pair."""
    P = len(qs)
    Tl = qs[0].shape[1]
    if Tl % 2 != 0:
        raise ValueError(f"zigzag needs an even local length, got {Tl}")
    C = Tl // 2
    mxu = _flash_defaults(qs[0])[1]
    ql = [q[:, :C] for q in qs]
    qh = [q[:, C:] for q in qs]
    lo, hi = [None] * P, [None] * P
    kc, vc = list(ks), list(vs)
    for s in range(P):
        causal_items, full_items = [], []
        for idx in range(P):
            k, v = kc[idx], vc[idx]
            kl, kh, vl, vh = k[:, :C], k[:, C:], v[:, :C], v[:, C:]
            src = (idx - s) % P
            full_items.append((("hb", idx), (qh[idx], kl, vl)))
            if src < idx:
                full_items.append((("li", idx), (ql[idx], kl, vl)))
            elif src == idx:
                causal_items.append((("li", idx), (ql[idx], kl, vl)))
                causal_items.append((("he", idx), (qh[idx], kh, vh)))
            else:
                full_items.append((("he", idx), (qh[idx], kh, vh)))
        parts = {}
        for items, causal in ((causal_items, True), (full_items, False)):
            if items:
                outs = _flash_hop([it for _key, it in items], causal, mxu,
                                  flash_opts, None if devs is None else
                                  [key[1] for key, _it in items])
                parts.update(zip((key for key, _it in items), outs))
        for idx in range(P):
            if ("li", idx) in parts:
                lo[idx] = _fold(lo[idx], parts[("li", idx)])
            hi[idx] = _fold(hi[idx], parts[("hb", idx)])
            if ("he", idx) in parts:
                hi[idx] = _fold(hi[idx], parts[("he", idx)])
        if s < P - 1:
            kc, vc = _rotate(kc, devs), _rotate(vc, devs)
    return [torch.cat([a[0], b[0]], dim=1).to(q.dtype)
            for a, b, q in zip(lo, hi, qs)]


def _banded_cross_lse(q, kk, vv, offset: int, window: int, live: bool):
    """lse-emitting dense attention of a q shard against one K/V shard
    under a trailing window, in relative coordinates: q row i sits
    ``offset + i - j`` positions after k row j, and a cell counts iff
    0 <= offset + i - j < window (the >= 0 half is causality).  ``live``
    gates the whole block.  Returns (o [B, T, H, D] float32 normalized,
    lse [B, H, T]) with dead rows at lse = -inf and o = 0, the
    ``_lse_merge`` contract."""
    T, H = q.shape[1], q.shape[2]
    Tk = kk.shape[1]
    if kk.shape[2] != H:
        kk, vv = expand_gqa_kv(kk, vv, H)
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    d = (offset + torch.arange(T, device=q.device)[:, None]
         - torch.arange(Tk, device=q.device)[None, :])
    keep = (d >= 0) & (d < window) & live
    s = torch.where(keep[None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - shift)
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    lsum = torch.sum(p, dim=-1, keepdim=True)
    # a normal-range epsilon: 1e-38 is subnormal and flushes to zero on the
    # card, turning the dead-row guard into 0/0 = NaN
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.clamp_min(lsum, 1e-30),
                       vv.float())
    lse = torch.where(lsum[..., 0] == 0.0, NEG_INF,
                      shift[..., 0] + torch.log(torch.clamp_min(
                          lsum[..., 0], 1e-30)))
    return out, lse


def _ring_attention_windowed(qs, ks, vs, window: int, impl: str,
                             flash_opts: Optional[dict] = None,
                             devs: Optional[list] = None) -> list:
    """Sliding-window attention over contiguous shards (causal, window <=
    T_local): a query's band lies in its own shard and the previous one,
    so the ring collapses to the local windowed block (one flash launch
    over all members, the grid schedule's windowed walk) and one
    neighbour hop of the previous shard's last window - 1 K/V rows against
    this shard's first window - 1 queries, a banded dense cross (member 0
    has no previous shard: no cross, no merge).  Merged by lse."""
    P = len(qs)
    B, Tl, H, D = qs[0].shape
    if impl == "flash":
        opts = dict(flash_opts or {})
        opts["window"] = window
        local = [(o.float(), lse) for o, lse in _flash_hop(
            list(zip(qs, ks, vs)), True, _flash_defaults(qs[0])[1], opts,
            None if devs is None else list(range(P)))]
    elif impl == "dense":
        # the same banded helper at offset 0: its d >= 0 arm is the causal
        # mask
        local = [_banded_cross_lse(q, k, v, 0, window, True)
                 for q, k, v in zip(qs, ks, vs)]
    else:
        raise ValueError(f"unknown ring_attention impl {impl!r}")
    Wn = window - 1  # the boundary band (window = 1: self only)
    if Wn == 0:
        return [o.to(q.dtype) for (o, _lse), q in zip(local, qs)]
    # the hop moves only the previous shard's last Wn rows, the only ones
    # any query here can see
    ktail = _rotate([k[:, Tl - Wn:] for k in ks], devs)
    vtail = _rotate([v[:, Tl - Wn:] for v in vs], devs)
    out = [local[0][0].to(qs[0].dtype)]
    for idx in range(1, P):
        o_loc, lse_loc = local[idx]
        # tail row j' is position Tl - Wn + j' of the previous shard, so
        # local query i sits i + Wn - j' positions after it
        o_bs, lse_bs = _banded_cross_lse(qs[idx][:, :Wn], ktail[idx],
                                         vtail[idx], Wn, window, True)
        o_b = torch.zeros((B, Tl, H, D), device=o_bs.device)
        o_b[:, :Wn] = o_bs
        lse_b = torch.full((B, H, Tl), NEG_INF, device=o_bs.device)
        lse_b[:, :, :Wn] = lse_bs
        o, _lse = _lse_merge(o_loc, lse_loc, o_b, lse_b)
        out.append(o.to(qs[idx].dtype))
    return out


def ulysses_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], causal: bool = False,
                      attn_fn: Optional[Callable] = None,
                      attn_fn_gqa_aware: bool = False,
                      devices=None) -> list:
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all reshards
    sequence to heads, so each member attends over the whole sequence on
    H / P of the heads, and a second one reshards back.  H % P == 0.

    ``qs``: one [B, T_local, H, D] per member; ``ks``/``vs``: [B, T_local,
    H or G, D] (grouped K/V reshard their own head axis: G % P == 0).
    Returns one [B, T_local, H, D] per member.  The attention runs once,
    on the members' head subsets stacked along the batch axis: by default
    ``ops.flash.flash_attention`` on the card (one launch, grouped K/V in
    place) and the dense reference on the CPU.  A caller's ``attn_fn``
    gets K/V expanded to one head per q head unless
    ``attn_fn_gqa_aware``.  Members on several cards (``devices``, or
    the shards' own devices): the all-to-alls cross through the counted
    move, and the attention runs once per card over that card's
    members."""
    qs, ks, vs = list(qs), list(ks), list(vs)
    devs = _placement(qs, devices)
    P = len(qs)
    B, Tl, H, D = qs[0].shape
    G = ks[0].shape[2]
    if H % P != 0:
        raise ValueError(f"heads {H} not divisible by sp={P}")
    if G != H and (G % P != 0 or H % G != 0):
        raise ValueError(f"K/V heads {G} must divide q heads {H} and "
                         f"be divisible by sp={P} for Ulysses GQA")

    # the members of each card, in member order (one card: all of them)
    groups: dict = {}
    for r in range(P):
        groups.setdefault(None if devs is None else devs[r], []).append(r)

    def seq_to_heads(xs):
        # [B, Tl, h, D] -> per card [len(card) B, P Tl, h / P, D] (h: that
        # tensor's heads)
        h = xs[0].shape[2]
        xs = all_to_all([x.reshape(B, Tl, P, h // P, D) for x in xs],
                        split_axis=2, concat_axis=1, tiled=True,
                        devices=devs)
        return [torch.cat([xs[r].reshape(B, P * Tl, h // P, D)
                           for r in rs]) for rs in groups.values()]

    qgs, kgs, vgs = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    wants_expansion = attn_fn is not None and not attn_fn_gqa_aware
    if attn_fn is None:
        on_card, mxu = _flash_defaults(qs[0])
        if on_card:
            from ..ops.flash import flash_attention

            def attn_fn(q, k, v):
                return flash_attention(q, k, v, causal=causal,
                                       mxu_dtype=mxu)
        else:
            def attn_fn(q, k, v):
                return _dense_attention(q, k, v, causal=causal)
            wants_expansion = True
    back = [None] * P
    for rs, qg, kg, vg in zip(groups.values(), qgs, kgs, vgs):
        if kg.shape[2] != qg.shape[2] and wants_expansion:
            kg, vg = expand_gqa_kv(kg, vg, qg.shape[2])
        og = attn_fn(qg, kg, vg)
        for r, x in zip(rs, og.split(B)):
            back[r] = x.reshape(B, P * Tl, 1, H // P, D)
    back = all_to_all(back, split_axis=1, concat_axis=2, tiled=True,
                      devices=devs)
    return [x.reshape(B, Tl, H, D) for x in back]


def expand_gqa_kv(k, v, n_q_heads: int):
    """Grouped K/V [B, T, G, D] -> one head per q head, each K/V head
    repeated across its consecutive group (q head n reads K/V head
    n // (H / G), the flash kernels' row sharing)."""
    group = n_q_heads // k.shape[2]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=2),
            v.repeat_interleave(group, dim=2))


def _dense_attention(q, k, v, causal: bool = False,
                     window: Optional[int] = None):
    """Reference dense attention on [B, T, H, D] with float32
    accumulation; ``window`` (causal) keeps each row's trailing
    ``window`` columns."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))  # float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        qpos = torch.arange(T, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
