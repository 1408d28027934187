"""Int8 block-scaled quantized ring collectives over P ranks held as
separate tensors.

Port of ``accl_tpu/ops/quantized.py``.  Payloads cross each ring hop as
int8 with one fp32 scale per ``block`` elements (symmetric absmax
scaling); accumulation stays fp32.  The JAX module is jnp inside
``shard_map`` and reaches no Pallas kernel, so this one is plain torch
ops over per-rank lists, as ``ops/ring.py``'s plain versions are: every
function takes a list with one tensor per rank, in ring order.

Ranks on several cards: the ring entries take ``place(t, src, dst)``,
the hook that carries rank ``src``'s tensor to rank ``dst`` (the
engine's counted ``CudaEngine._move``, ``parallel.collectives.move`` in
``parallel/``).  Each rank's quantize, fold, error carry and hop
generator then run on its own tensor's card, and the only tensors that
cross are what the reference ``ppermute``s: at each hop the left
neighbour's ``q`` and ``scale``, two crossings.  The all-gather relays
the wire form P - 1 hops and every rank dequantizes its own
``[P, rows, block]`` stack once, so no rank ever holds another's fp32
operand.  With ``place`` left out (one card) the functions compute what
they always did, the gathered result built once and shared.

Error model: one quantization rounds to within scale/2 = absmax/254 per
element.  The ring reduce-scatter requantizes the running partial each
hop, so the worst-case error grows linearly in P; ``error_feedback``
carries each hop's requantization error into that rank's next
quantization instead of dropping it.

Stochastic rounding (``stochastic=True``) draws its uniforms from a
``torch.Generator`` seeded per (seed, rank, hop), the role ``_hop_key``
plays in the JAX module.  The two generators give different bits, so
stochastic results are held to an error bound, not to the JAX package's
values.  Each rank's generator is made on its own tensor's device; a
draw there depends only on the seed and the shape, so a rank on a card
of its own draws the bits it draws on a card shared with the others
(``chip_smoke.py`` phase multi_card holds the two bitwise across
cards).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

DEFAULT_BLOCK = 256

#: ``place(t, src, dst)``: rank ``src``'s tensor ``t`` as rank ``dst``
#: receives it, one counted crossing (module docstring)
Place = Callable[[torch.Tensor, int, int], torch.Tensor]

#: 1/127 rounded to float32.  XLA compiles the JAX module's
#: ``amax / 127.0`` into ``amax * f32(1/127)`` (its simplifier turns a
#: divide by a constant into a multiply by the reciprocal), so the scale
#: is computed that way here to match the compiled reference bit for bit.
#: Eager jnp divides, and its scale can differ from this by one ulp.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def dequantize_add(q: torch.Tensor, scale: torch.Tensor, n: int,
                   x: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """x + sign * dequantize_blockwise(q, scale, n), rounded once (a fused
    multiply-add, ``torch.addcmul``).  XLA contracts the JAX module's
    ``dequantize_blockwise(...) + x`` and ``x - dequantize_blockwise(...)``
    into FMAs when it compiles them, so the ring folds and the
    error-feedback residuals round once here too."""
    rows, block = q.shape
    qf = q.to(torch.float32).reshape(-1)[:n]
    sf = scale.expand(rows, block).reshape(-1)[:n]
    return torch.addcmul(x, qf, sf, value=sign)


def _blocks(x: torch.Tensor, block: int):
    n = x.shape[0]
    rows = -(-n // block)
    pad = rows * block - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(rows, block), n


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK,
                       generator: Optional[torch.Generator] = None):
    """Flat float tensor -> (q int8 [rows, block], scale f32 [rows, 1], n).

    Per-block absmax maps to ±127 (scale = absmax * f32(1/127), as the
    compiled JAX program computes it); an all-zero block gets scale 1, so
    it dequantizes exactly.  Rounding is to nearest even (``torch.round``,
    as ``jnp.round``), or with ``generator`` stochastic: floor(r + u),
    u ~ U[0, 1)."""
    x2, n = _blocks(x.to(torch.float32), block)
    amax = x2.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax * _INV_127)
    r = x2 / scale
    if generator is not None:
        u = torch.rand(r.shape, generator=generator, dtype=torch.float32,
                       device=r.device)
        rounded = torch.floor(r + u)
    else:
        rounded = torch.round(r)
    q = rounded.clamp(-127, 127).to(torch.int8)
    return q, scale, n


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` -> flat f32 [n]."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def hop_generator(seed: int, rank: int, hop: int,
                  device: torch.device) -> torch.Generator:
    """A generator decorrelated per (seed, rank, hop), for stochastic
    rounding inside the ring loop."""
    mixed = (((seed * 0x9E3779B1 + rank) * 0x85EBCA77 + hop)
             & 0x7FFFFFFFFFFFFFFF)
    return torch.Generator(device=device).manual_seed(mixed)


def _ring_reduce_scatter_q(xs: Sequence[torch.Tensor], block: int,
                           error_feedback: bool = False,
                           stochastic: bool = False, seed: int = 0,
                           place: Optional[Place] = None):
    """Quantized ring reduce-scatter returning each rank's WIRE-FORM
    carry (q, scale) of its reduced chunk, and the chunk length n, so
    the all-reduce feeds it straight into the gather without a
    dequantize/requantize round at the seam.

    Rank r starts with its chunk (r - 1) quantized; at hop s it receives
    the left neighbour's (q, scale), folds acc = dequant + chunk
    (r - 2 - s) (+ its own carried error with ``error_feedback``) and
    requantizes.  The error carry stays with the rank that made it.
    With ``place`` the left neighbour's (q, scale) cross to rank r
    through it, two crossings a rank and hop."""
    P = len(xs)
    N = xs[0].shape[0]
    if N % P:
        raise ValueError(f"quantized ring reduce-scatter needs the payload "
                         f"({N}) divisible by the ring size ({P}); pad the "
                         f"input")
    n = N // P
    chunks = [x.to(torch.float32).reshape(P, n) for x in xs]

    def gen(r, hop):
        return (hop_generator(seed, r, hop, xs[r].device) if stochastic
                else None)

    carry = []
    for r in range(P):
        x0 = chunks[r][(r - 1) % P]
        q0, s0, _ = quantize_blockwise(x0, block, gen(r, 0))
        err0 = dequantize_add(q0, s0, n, x0, -1.0) if error_feedback \
            else None
        carry.append((q0, s0, err0))
    for s in range(P - 1):
        nxt = []
        for r in range(P):
            q, sc, _ = carry[(r - 1) % P]  # arrives from the left
            if place is not None:
                q, sc = place(q, (r - 1) % P, r), place(sc, (r - 1) % P, r)
            err = carry[r][2]
            acc = dequantize_add(q, sc, n, chunks[r][(r - 2 - s) % P])
            if error_feedback:
                acc = acc + err
            qn, scn, _ = quantize_blockwise(acc, block, gen(r, s + 1))
            if error_feedback:
                err = dequantize_add(qn, scn, n, acc, -1.0)
            nxt.append((qn, scn, err))
        carry = nxt
    return [(q, sc) for q, sc, _ in carry], n


def _per_rank(out: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """The one result every rank ends with, as each rank's own: on rank
    r's device, ``like[r]``'s (the tensor itself wherever they share a
    device, so on one card every rank holds the same tensor)."""
    return [out if t.device == out.device else out.to(t.device)
            for t in like]


def relay(parts: Sequence[tuple], place: Place) -> list:
    """Ring relay across cards: ``parts[r]`` (a tuple of rank r's
    tensors) travels P - 1 hops to the right, each tensor one crossing
    through ``place`` a hop, as the reference ``ppermute``s it.  Returns,
    per rank, every origin's parts in origin order, each on that rank's
    card."""
    P = len(parts)
    got = [[None] * P for _ in range(P)]
    for r in range(P):
        got[r][r] = tuple(parts[r])
    carry = [tuple(p) for p in parts]
    for s in range(P - 1):
        carry = [tuple(place(t, (r - 1) % P, r) for t in carry[(r - 1) % P])
                 for r in range(P)]
        for r in range(P):
            got[r][(r - 1 - s) % P] = carry[r]
    return got


def _deq_stack(qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
               n: int) -> torch.Tensor:
    """Origin-major (q, scale) carries -> flat [P * n] f32, dequantized
    once."""
    # [P, rows, block]
    deq = torch.stack(list(qs)).to(torch.float32) * torch.stack(list(scales))
    return deq.reshape(len(qs), -1)[:, :n].reshape(-1)


def _ring_all_gather_q(carries: Sequence[tuple], n: int,
                       place: Optional[Place] = None) -> list:
    """Ring all-gather of already-quantized (q, scale) pairs -> flat
    [P * n] f32 per rank (rank-major), dequantized once at the end.  The
    relay moves the wire form unchanged, so every rank ends with the
    same [P, rows, block] stack whatever the hop order: on one card it
    is built once and shared.  With ``place`` the carries are relayed
    across the cards (:func:`relay`) and each rank dequantizes its own
    stack on its own card."""
    if place is not None:
        return [_deq_stack([q for q, _ in got], [sc for _, sc in got], n)
                for got in relay(carries, place)]
    out = _deq_stack([q for q, _ in carries], [sc for _, sc in carries], n)
    return _per_rank(out, [q for q, _ in carries])


def quantized_ring_reduce_scatter(xs: Sequence[torch.Tensor],
                                  block: int = DEFAULT_BLOCK,
                                  error_feedback: bool = False,
                                  stochastic: bool = False,
                                  seed: int = 0,
                                  place: Optional[Place] = None) -> list:
    """Per rank flat [P * n] -> that rank's reduced chunk [n] f32, with
    int8 + per-block-scale wire traffic on every hop."""
    carries, n = _ring_reduce_scatter_q(xs, block, error_feedback,
                                        stochastic, seed, place)
    return [dequantize_blockwise(q, sc, n) for q, sc in carries]


def quantized_ring_all_gather(xs: Sequence[torch.Tensor],
                              block: int = DEFAULT_BLOCK,
                              stochastic: bool = False,
                              seed: int = 0,
                              place: Optional[Place] = None) -> list:
    """Per rank flat [n] -> [P * n] f32 (rank-major).  Each contribution
    is quantized once and relayed, so the error is one round trip
    whatever P is."""
    carries = []
    for r, x in enumerate(xs):
        g = hop_generator(seed, r, 0, x.device) if stochastic else None
        q, sc, _ = quantize_blockwise(x.to(torch.float32), block, g)
        carries.append((q, sc))
    return _ring_all_gather_q(carries, xs[0].shape[0], place)


def quantized_all_reduce(xs: Sequence[torch.Tensor],
                         block: int = DEFAULT_BLOCK,
                         error_feedback: bool = False,
                         stochastic: bool = False, seed: int = 0,
                         place: Optional[Place] = None) -> list:
    """Per rank flat [P * n] -> [P * n] f32: quantized ring
    reduce-scatter whose wire-form carry feeds the quantized ring
    all-gather directly."""
    carries, n = _ring_reduce_scatter_q(xs, block, error_feedback,
                                        stochastic, seed, place)
    return _ring_all_gather_q(carries, n, place)
