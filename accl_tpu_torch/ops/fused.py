"""Fused compute/communication: chunked ring pipelines and the
tensor-parallel matmul whose partial products are reduce-scattered
around the ring.

Port of ``accl_tpu/ops/fused.py``, in its three tiers, over P ranks held
as separate tensors (every function takes a list with one tensor per
rank, in ring order, and returns one per rank):

1. ``chunked_ring_*`` — the driver's fused lane (``ACCL_FUSED=1`` or
   per-call ``fused=``).  The flat payload splits into C independent
   per-chunk ring chains.  The fp32 fold is the ring's, ``local +
   incoming`` with chunk ``(my - 2 - step) % P`` at step ``step``, so the
   lane is bitwise equal to the ring lane whenever the payload divides
   P*C and the ring runs as one segment.  ``wire=(block, error_feedback)``
   runs the int8 quantize/dequantize of ``ops/quantized.py`` inside the
   chunk loop.  These are jnp in the JAX package, not Pallas, so here
   they are torch ops.  Ranks on several cards pass ``place(t, src,
   dst)`` (``ops/quantized.py``): each rank folds on its own card, and
   each chunk's accumulator (on the int8 wire its ``(q, scale)``)
   crosses to the right neighbour once a step, as the reference
   ``ppermute``s it; the all-gather relays the chunks and every rank
   stacks, or dequantizes, its own result.  The hop bytes of the trace
   rows are then what crosses.

2. ``fused_matmul_allreduce`` — allreduce-into-matmul: with ``chunks=C``
   the reduce-scatter computes each local partial product just in time
   and the all-gather relays reduced product rows.  ``pallas_matmul`` is
   its compute half: the hand-written CUDA kernel ``accl_matmul``
   (``csrc/fused.cu``) on the card, launched under ``matmul_plan``
   (tile rows and split of K from the shape and the card's SM count).

3. ``fused_matmul_reduce_scatter`` — the hand-scheduled kernel
   ``accl_fused_matmul_rs`` (``csrc/fused.cu``): the ring reduce-scatter
   of sum_r x_r @ w_r with each hop's partial matmul inside the ring
   loop.  ``fused_matmul_allreduce_pallas`` is that kernel followed by
   the ring all-gather kernel of ``ops/ring.py``.  Ranks on several
   cards take the kernel's cross-card mode (``accl_fused_matmul_rs_cross``,
   one launch per card, counted in ``launches_cross``): every rank's
   landing slots and flags on its own card (``_cross_tables``, the
   tables of ``ops/ring.py``'s cross-card mode), the cards' streams
   joined around the launches, the host's gate of an eager launch and
   the entry handshake counted on the card, as in the ring kernels'
   cross-card mode, so that it too can be captured in a CUDA graph and
   replayed.  ``ring.rank_tables()`` runs that mode on one card.
   Across cards the plain version moves each landing accumulator to its
   rank's card (a counted ``parallel.collectives.move``).

Beside each kernel wrapper sits its plain PyTorch version.  A wrapper
runs the plain version only when it is given CPU tensors; given CUDA
tensors it launches its kernel or raises.  Each wrapper counts its
launches in its ``launches`` attribute.  The plain versions multiply
with ``torch.matmul`` in float32, which on the card is a full fp32
product only while ``torch.backends.cuda.matmul.allow_tf32`` is False
(PyTorch's default); the kernels never use TF32.

Device tracing: with ``ACCL_DEVICE_TRACE`` set the chunked lanes and the
chunked ``fused_matmul_allreduce`` record one stamp row per (step,
chunk) pipeline slot and rank, computed on the host as in the reference
(``_fused_stamp_rows``, accl_tpu/ops/fused.py:110; no kernel takes
part), on the overlapped logical clock.

4. ``fused_expert_ffn`` — reduce-scatter-into-MoE-dispatch: the routed
   expert FFN with the capacity dimension cut into chunks, each chunk's
   dispatch all-to-all, expert FFN and return all-to-all in turn, bitwise
   equal to ``parallel.strategies.expert_dispatch`` -> FFN ->
   ``expert_combine`` wherever the FFN computes each row on its own.  The
   expert products are ``torch.matmul``, as the JAX package leaves them
   to XLA; with ``ACCL_DEVICE_TRACE`` it records a stamp row per (step,
   chunk) pipeline slot and member, as the chunked lanes do.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from ..observability.trace import record_device_steps
from . import _build
from . import quantized as q_ops
from . import ring as ring_ops
from .ring import _fold, _ptrs, device_trace_enabled, ring_all_gather

#: default pipeline depth of the fused lane — chunks per ring step
DEFAULT_FUSED_CHUNKS = 4

#: ACCL_FUSED_CHUNKS, read once (None = not read yet), so the chunking
#: stays stable across calls
_FUSED_CHUNKS: Optional[int] = None


def fused_chunks() -> int:
    """The ``ACCL_FUSED_CHUNKS`` pipeline depth, cached at first use."""
    global _FUSED_CHUNKS
    if _FUSED_CHUNKS is None:
        try:
            _FUSED_CHUNKS = max(1, int(os.environ.get(
                "ACCL_FUSED_CHUNKS", str(DEFAULT_FUSED_CHUNKS))))
        except ValueError:
            _FUSED_CHUNKS = DEFAULT_FUSED_CHUNKS
    return _FUSED_CHUNKS


def _reset_fused_chunks_cache() -> None:
    """Test hook: force the next call to re-read the env."""
    global _FUSED_CHUNKS
    _FUSED_CHUNKS = None


def _pick_chunks(n: int, requested: Optional[int]) -> int:
    """Largest chunk count <= requested that divides n (>= 1)."""
    c = max(1, min(requested or fused_chunks(), n))
    while n % c:
        c -= 1
    return c


def _rank_devices(xs, devices) -> Optional[list]:
    """Each rank's device when the ranks are on several cards, as
    ``parallel.collectives`` finds it (imported at call time: the parallel
    package imports this one)."""
    from ..parallel.collectives import _placement
    return _placement(xs, devices)


def _move(t: torch.Tensor, device) -> torch.Tensor:
    """``parallel.collectives.move``: the counted crossing between ranks."""
    from ..parallel.collectives import move
    return move(t, device)


def _pad_flat(x: torch.Tensor, length: int) -> torch.Tensor:
    if x.shape[0] == length:
        return x
    return torch.cat([x, x.new_zeros((length - x.shape[0],) + x.shape[1:])])


def _fused_stamp_rows(P: int, C: int, idx: int, chunk_bytes: int,
                      slot0: int = 0) -> torch.Tensor:
    """Rank ``idx``'s stamp rows, one per (step, chunk) pipeline slot, in
    DEVICE_TRACE_FIELDS order, on the overlapped clock: xfer(i) = [2i,
    2i + 2], reduce(i) = [2i + 2, 2i + 4], so slot i + 1's hop covers
    slot i's fold.  With C == 1 nothing pipelines, and the rows carry the
    ring's sequential 3-phase clock."""
    steps = (P - 1) * C
    slots = slot0 + torch.arange(steps, dtype=torch.int32)
    my = torch.full((steps,), idx, dtype=torch.int32)
    nbytes = torch.full((steps,), chunk_bytes, dtype=torch.int32)
    if C == 1:
        send, wait, phase = 3 * slots, 3 * slots + 1, 3 * slots + 2
    else:
        send, wait, phase = 2 * slots, 2 * slots + 2, 2 * slots + 4
    return torch.stack([my, slots, send, wait, phase, (my + 1) % P,
                        (my + P - 1) % P, nbytes, nbytes], dim=1)


def _wire_hop_bytes(m: int, block: int) -> int:
    """Per-hop wire bytes of one int8 sub-chunk: the int8 payload and one
    fp32 scale per block (quantize_blockwise pads m to whole blocks)."""
    rows = -(-m // block)
    return rows * block + rows * 4


def _trace_fused(collective: str, P: int, C: int, hop_bytes: int,
                 phases: int = 1) -> None:
    """With the gate on, record each rank's rows of a chunked lane of
    ``phases`` ring phases (2 for the allreduce)."""
    if not device_trace_enabled():
        return
    span = (P - 1) * C
    for r in range(P):
        record_device_steps(collective, torch.cat([
            _fused_stamp_rows(P, C, r, hop_bytes, slot0=k * span)
            for k in range(phases)]))


# ---------------------------------------------------------------------------
# tier 1: chunked ring collectives — the driver's fused lane
# ---------------------------------------------------------------------------
def _rs_chains_fp(views, op: str, P: int, C: int,
                  place: Optional[q_ops.Place] = None) -> list:
    """C reduce-scatter chains per rank over views[r] [P, C, m]; returns
    rank r's list of C reduced accumulators.  With ``place`` each
    chunk's accumulator crosses to the right neighbour once a step."""
    fold = _fold(op)
    accs = [[views[r][(r - 1) % P, c] for c in range(C)] for r in range(P)]
    for s in range(P - 1):
        landed = [accs[(r - 1) % P] for r in range(P)]
        if place is not None:
            landed = [[place(a, (r - 1) % P, r) for a in row]
                      for r, row in enumerate(landed)]
        # local + incoming: the ring's fold order
        accs = [[fold(views[r][(r - 2 - s) % P, c], landed[r][c])
                 for c in range(C)] for r in range(P)]
    return accs


def _rs_chains_q(views, C: int, block: int, error_feedback: bool,
                 place: Optional[q_ops.Place] = None) -> list:
    """C quantized reduce-scatter chains over views[r] [P, C, m]: chunk c
    is one ring of ops/quantized.py over the ranks' [P, m] slices, its
    (q, scale) crossing through ``place`` when given.  Returns, per
    chunk, the ranks' wire-form (q, scale) carries, the seam feed for
    the gather."""
    return [q_ops._ring_reduce_scatter_q([v[:, c].reshape(-1) for v in views],
                                         block, error_feedback,
                                         place=place)[0]
            for c in range(C)]


def _ag_chains(parts, place: Optional[q_ops.Place] = None):
    """C all-gather chains: parts[r] is rank r's list of C per-chunk
    tensors; the result is [P, C, ...] with origin-major placement.  The
    relay moves values unchanged, so every rank ends with this same
    tensor whatever the hop order: on one card it is built once and
    shared.  With ``place`` the chunks are relayed across the cards
    (``quantized.relay``) and each rank stacks its own: a list, one
    tensor a rank."""
    if place is not None:
        return [torch.stack([torch.stack(list(row)) for row in got])
                for got in q_ops.relay(parts, place)]
    return torch.stack([torch.stack(list(row)) for row in parts])


def _deq_gathered(per_chunk, m: int, place: Optional[q_ops.Place] = None):
    """Gather each chunk's wire-form carries and dequantize once -> flat
    [P * C * m] (origin-major, then chunk).  With ``place`` the carries
    are relayed across the cards and each rank dequantizes its own: a
    list, one tensor a rank."""
    P = len(per_chunk[0])
    if place is not None:
        per_rank = [q_ops._ring_all_gather_q(carries, m, place)
                    for carries in per_chunk]
        return [torch.stack([g[r].view(P, m) for g in per_rank],
                            dim=1).reshape(-1) for r in range(P)]
    return torch.stack([q_ops._ring_all_gather_q(carries, m)[0].view(P, m)
                        for carries in per_chunk], dim=1).reshape(-1)


def _own(out, xs: Sequence[torch.Tensor], fn=lambda t: t) -> list:
    """Each rank's result: ``fn`` of each rank's own tensor when the lane
    ran across cards (``out`` a list), else ``fn`` of the one shared
    result, handed to every rank (``quantized._per_rank``)."""
    if isinstance(out, list):
        return [fn(o) for o in out]
    return q_ops._per_rank(fn(out), xs)


def chunked_ring_reduce_scatter(xs: Sequence[torch.Tensor], op: str = "sum",
                                chunks: Optional[int] = None,
                                wire: Optional[tuple] = None,
                                collective: str = "fused_reduce_scatter",
                                place: Optional[q_ops.Place] = None
                                ) -> list:
    """Per rank flat [P * n] -> that rank's reduced [n], as C per-chunk
    ring chains.  ``wire=(block, error_feedback)`` rides the int8 wire
    with per-hop requantization inside the loop.  ``place``: the ranks
    sit on several cards (``ops/quantized.py``)."""
    P = len(xs)
    if P == 1:
        return list(xs)
    N = xs[0].shape[0]
    if N % P:
        raise ValueError(f"fused reduce-scatter needs the payload ({N}) "
                         f"divisible by the ring size ({P})")
    n = N // P
    C = _pick_chunks(n, chunks)
    m = n // C
    if wire is not None:
        if op == "max":
            raise ValueError("int8 wire lane carries sums, not max")
        block, ef = wire
        views = [x.to(torch.float32).reshape(P, C, m) for x in xs]
        per_chunk = _rs_chains_q(views, C, block, ef, place)
        _trace_fused(collective, P, C, _wire_hop_bytes(m, block))
        return [torch.cat([q_ops.dequantize_blockwise(*chunk[r], m)
                           for chunk in per_chunk]) for r in range(P)]
    views = [x.reshape(P, C, m) for x in xs]
    _trace_fused(collective, P, C, m * xs[0].element_size())
    return [torch.cat(row) for row in _rs_chains_fp(views, op, P, C, place)]


def chunked_ring_all_gather(xs: Sequence[torch.Tensor],
                            chunks: Optional[int] = None,
                            wire: Optional[tuple] = None,
                            collective: str = "fused_all_gather",
                            place: Optional[q_ops.Place] = None) -> list:
    """Per rank flat [n] -> [P * n] (rank-major), as C per-chunk relay
    chains.  On the int8 lane each contribution is quantized once and
    relayed in wire form."""
    P = len(xs)
    if P == 1:
        return list(xs)
    n = xs[0].shape[0]
    C = _pick_chunks(n, chunks)
    m = n // C
    if wire is not None:
        block = wire[0]
        rows = [x.to(torch.float32).reshape(C, m) for x in xs]
        per_chunk = [[q_ops.quantize_blockwise(v, block)[:2] for v in col]
                     for col in zip(*rows)]
        _trace_fused(collective, P, C, _wire_hop_bytes(m, block))
        return _own(_deq_gathered(per_chunk, m, place), xs)
    out = _ag_chains([list(x.reshape(C, m)) for x in xs], place)
    _trace_fused(collective, P, C, m * xs[0].element_size())
    return _own(out, xs, lambda t: t.reshape(-1))


def chunked_ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum",
                            chunks: Optional[int] = None,
                            wire: Optional[tuple] = None,
                            collective: str = "fused_allreduce",
                            place: Optional[q_ops.Place] = None) -> list:
    """Per rank flat [N] -> [N] allreduced: chunked reduce-scatter
    feeding chunked all-gather, padded internally to a P*C multiple; on
    the int8 lane the wire-form carry crosses the seam without a
    dequantize/requantize round."""
    P = len(xs)
    if P == 1:
        return list(xs)
    N = xs[0].shape[0]
    C = max(1, chunks or fused_chunks())
    padN = -(-N // (P * C)) * (P * C)
    m = padN // P // C
    if wire is not None:
        if op == "max":
            raise ValueError("int8 wire lane carries sums, not max")
        block, ef = wire
        views = [_pad_flat(x, padN).to(torch.float32).reshape(P, C, m)
                 for x in xs]
        dt = xs[0].dtype if xs[0].is_floating_point() else None
        out = _deq_gathered(_rs_chains_q(views, C, block, ef, place), m,
                            place)
        _trace_fused(collective, P, C, _wire_hop_bytes(m, block), phases=2)
        return _own(out, xs, lambda t: t[:N] if dt is None
                    else t[:N].to(dt))
    views = [_pad_flat(x, padN).reshape(P, C, m) for x in xs]
    parts = _rs_chains_fp(views, op, P, C, place)
    _trace_fused(collective, P, C, m * xs[0].element_size(), phases=2)
    return _own(_ag_chains(parts, place), xs,
                lambda t: t.reshape(-1)[:N])


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------
#: input dtypes the CUDA kernels take, with their code in csrc/fused.cu
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ranks one fused launch can hold (MAXP in csrc/ring_sync.cuh)
MAX_RANKS = 32
#: the tile geometry of csrc/fused.cu: output tile columns (BN), k per
#: pipeline stage (BK), the fused kernel's tile rows (FUSED_BM) and the
#: row counts accl_matmul is built for, largest first
TILE_N = 128
TILE_K = 16
FUSED_TILE_M = 128
TILE_MS = (128, 64)
#: blocks of accl_matmul that one SM holds (__launch_bounds__(256, 2), at
#: most 64 KB of shared memory each; the fused kernel holds one per SM)
BLOCKS_PER_SM = 2
#: the most ranges K is split into, and the fewest TILE_K slices in one
MAX_SPLIT = 16
MIN_SPLIT_SLICES = 4


class MatmulPlan(NamedTuple):
    """One ``accl_matmul`` launch: output tiles of ``bm`` x TILE_N, a grid
    of (tiles along n, tiles along m, ``split``) blocks, block z taking k
    in [z k_per_split, (z + 1) k_per_split) (the last range is cut at
    k).  A split tile's partials are summed in the order z = 0, 1, ...."""
    bm: int
    split: int
    k_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_plan(m: int, n: int, k: int, sms: int) -> MatmulPlan:
    """Tile rows and split of K for ``[m, k] @ [k, n]`` on a card of
    ``sms`` SMs.  128-row tiles when they alone give every SM a block;
    else 64-row tiles, and when those are still fewer than the SMs, K is
    split so that tiles x split fills the BLOCKS_PER_SM blocks every SM
    holds without starting a second wave (each range at least
    MIN_SPLIT_SLICES slices of TILE_K, at most MAX_SPLIT ranges).  At
    [128, 1792] @ [1792, 4096] on 132 SMs: 64 tiles of 64 x 128, K split
    in 4 ranges of 448, 256 blocks."""
    tiles_n = _cdiv(n, TILE_N)
    big, small = TILE_MS
    bm = big if _cdiv(m, big) * tiles_n >= sms else small
    tiles = max(1, _cdiv(m, bm) * tiles_n)
    slices = _cdiv(k, TILE_K)
    split = 1
    if tiles < sms:
        split = max(1, min(sms * BLOCKS_PER_SM // tiles,
                           slices // MIN_SPLIT_SLICES, MAX_SPLIT))
    per = max(1, _cdiv(slices, split))
    return MatmulPlan(bm, max(1, _cdiv(slices, per)), per * TILE_K)


def stripe_tiles(tiles: int, stripes: int, st: int) -> tuple:
    """[first, last) of the row-major FUSED_TILE_M x TILE_N output tiles
    that stripe ``st`` of the fused kernel owns on every rank."""
    return st * tiles // stripes, (st + 1) * tiles // stripes


def fused_stripes(P: int, tiles: int, resident: int) -> int:
    """Tile stripes per rank of one fused launch: as many as fit
    co-resident (``resident`` blocks over P ranks), at most one per
    output tile, so that every stripe holds a tile."""
    fit = resident // P
    if fit < 1:
        raise RuntimeError(f"fused matmul kernel: {P} ranks do not fit "
                           f"co-resident on this card")
    return min(fit, max(1, tiles))


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.accl_fused_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check_operands(ts, what: str) -> None:
    dev, dt = ts[0].device, ts[0].dtype
    for t in ts:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: every tensor must share device {dev} "
                             f"and dtype {dt}, got {t.device} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev} (cpu or cuda only)")
    if dev.type == "cuda" and dt not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernel takes float32 or "
                         f"bfloat16, not {dt}")


def _check_rank_operands(xs, ws, what: str) -> Optional[tuple]:
    """Each rank's operands contiguous on that rank's device, every
    rank's on one device type, one dtype (one the kernels take on the
    card).  Returns the layout (each rank's card) when the ranks sit on
    several cards, else None."""
    dev, dt = xs[0].device, xs[0].dtype
    spread = False
    for x, w in zip(xs, ws):
        xd = x.device
        for t in (x, w):
            if t.device != xd or xd.type != dev.type or t.dtype != dt:
                raise ValueError(f"{what}: every tensor must share device "
                                 f"type {dev.type} and dtype {dt}, each "
                                 f"rank's on one device, got {t.device} "
                                 f"{t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: operands must be contiguous")
        spread = spread or xd != dev
    _check_operands([xs[0]], what)
    return tuple(x.device.index for x in xs) if spread else None


def _vec(ts, k: int, n: int, elem: int) -> bool:
    """Whether the kernels may move 16 bytes at a time: every row of
    every operand and result starts on 16 bytes."""
    v = 16 // elem
    return k % v == 0 and n % v == 0 and all(t.data_ptr() % 16 == 0
                                             for t in ts)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(m: int, n: int, k: int, device: int) -> MatmulPlan:
    return matmul_plan(m, n, k, _sms(device))


@functools.lru_cache(maxsize=None)
def _resident_cross(dtype_code: int, device: int) -> int:
    """Blocks of the fused kernel's cross-card mode that fit on the card
    together (cached per device and dtype)."""
    lib = _build.load("fused")
    got = lib.accl_fused_resident_mode(dtype_code, 1, device)
    if got < 0:
        _raise_on(lib, -got, "accl_fused_resident_mode")
    return got


@functools.lru_cache(maxsize=None)
def _resident(dtype_code: int, device: int) -> int:
    """Blocks of the fused kernel that fit on the card together (cached
    per device and dtype)."""
    lib = _build.load("fused")
    got = lib.accl_fused_resident(dtype_code, device)
    if got < 0:
        _raise_on(lib, -got, "accl_fused_resident")
    return got


_scratch_lock = threading.Lock()
#: (device, stream, name) -> scratch tensor, reused in stream order: the
#: split-K partials ("ws", float32) and the split-K counters and ring
#: flags ("counters", "flags", int32, which the kernels leave at zero)
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream, name: str, numel: int):
    """One launch's scratch on the current stream.  Under a CUDA graph
    capture it is made anew, in the graph's private pool, which holds it
    for the graph's life: a cached tensor is replaced, and freed, by a
    larger launch on a stream of the same handle, and the stream pool
    hands handles out again."""
    def make():
        if name == "ws":
            return torch.empty(numel, dtype=torch.float32, device=dev)
        return torch.zeros(numel, dtype=torch.int32, device=dev)

    if torch.cuda.is_current_stream_capturing():
        return make()
    key = (dev.index, stream.cuda_stream, name)
    with _scratch_lock:
        cur = _scratch.get(key)
        if cur is None or cur.numel() < numel:
            cur = _scratch[key] = make()
        return cur


# ---------------------------------------------------------------------------
# tier 2: matmul and allreduce-into-matmul
# ---------------------------------------------------------------------------
def pallas_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] -> [m, n] float32, through torch.matmul."""
    return x.float() @ w.float()


def pallas_matmul(x: torch.Tensor, w: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[m, k] @ [k, n] -> [m, n] float32, with fp32 accumulation; x and w
    both float32 or both bfloat16.  On the card: the ``accl_matmul``
    kernel of csrc/fused.cu."""
    _check_operands([x, w], "pallas_matmul")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pallas_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    if out is not None and (tuple(out.shape) != (m, n)
                            or out.dtype != torch.float32
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"pallas_matmul: out must be contiguous float32 "
                         f"[{m}, {n}] on {x.device}")
    if x.device.type == "cpu":
        res = pallas_matmul_plain(x, w)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    dev = x.device
    device = dev.index or 0
    plan = _plan(m, n, k, device)
    stream = torch.cuda.current_stream(dev)
    # held until the launch: under a capture each is a new tensor
    scratch = (None, None)
    if plan.split > 1:
        scratch = (_scratch_for(dev, stream, "ws", plan.split * m * n),
                   _scratch_for(dev, stream, "counters",
                                _cdiv(m, plan.bm) * _cdiv(n, TILE_N)))
    lib = _build.load("fused")
    rc = lib.accl_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                         KERNEL_DTYPES[x.dtype], plan.bm, plan.split,
                         plan.k_per_split,
                         int(_vec((x, w, out), k, n, x.element_size())),
                         *(None if t is None else t.data_ptr()
                           for t in scratch), device, stream.cuda_stream)
    _raise_on(lib, rc, "pallas_matmul")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def fused_matmul_allreduce(xs: Sequence[torch.Tensor],
                           ws: Sequence[torch.Tensor],
                           use_pallas: bool = True,
                           chunks: Optional[int] = None,
                           devices=None) -> list:
    """Tensor-parallel contraction: rank r holds x_r [M, K] and the
    K-shard w_r [K, N]; every rank gets sum_r x_r @ w_r, [M, N] float32.

    ``chunks=None`` (or <= 1): each rank's matmul, then a sum over the
    ranks (the JAX form's psum).  ``chunks=C``: the pipelined form — the
    reduce-scatter computes each local row-block partial just in time and
    folds ``partial + incoming``, then the all-gather relays the reduced
    product rows; rows are zero-padded to a P*C multiple internally.
    ``use_pallas`` picks the matmul kernel over the plain product.

    Ranks on several cards (their tensors on more than one device, or
    ``devices=``): each rank multiplies on its own card, every crossing
    is a counted ``parallel.collectives.move`` (a landing accumulator to
    the right neighbour, the reduced rows to every card; without chunks
    the products to rank 0's card and the sum back out), with the same
    folds, so each card's result is bitwise the one-card form's.  The
    ranks of one card share its result (every CPU rank is a card of its
    own).  Each card's result carries a gradient, the transpose of a
    psum: the rows rank r reduced (without chunks: its product) take the
    gradient of the result on rank r's own card, so every card's result
    must reach the loss."""
    P = len(xs)
    dot = pallas_matmul if use_pallas else pallas_matmul_plain
    devs = _rank_devices(xs, devices)
    if devs is not None:
        # imported at call time: the parallel package imports this one
        from ..parallel.collectives import card_homes, own_card_sums
        homes = card_homes(devs)
        cards = sorted(set(homes))
    if chunks is None or chunks <= 1:
        prods = [dot(x, w) for x, w in zip(xs, ws)]
        if devs is not None:

            def combine(ps):
                total = torch.stack([ps[0]] + [_move(p, devs[0])
                                               for p in ps[1:]]).sum(0)
                return [total] + [_move(total, devs[c]) for c in cards[1:]]

            sums = own_card_sums(combine, prods,
                                 [cards.index(h) for h in homes])
            return [sums[cards.index(h)] for h in homes]
        total = torch.stack(prods).sum(0)
        return [total] * P
    if P == 1:
        return [dot(xs[0], ws[0])]
    M, K = xs[0].shape
    N = ws[0].shape[1]
    C = chunks
    padM = -(-M // (P * C)) * (P * C)
    mrows = padM // (P * C)
    xv = [_pad_flat(x, padM).reshape(P, C, mrows, K) for x in xs]
    accs = [[dot(xv[r][(r - 1) % P, c], ws[r]) for c in range(C)]
            for r in range(P)]
    for s in range(P - 1):
        landed = [accs[(r - 1) % P] for r in range(P)]
        if devs is not None:
            landed = [[_move(a, devs[r]) for a in landed[r]]
                      for r in range(P)]
        accs = [[dot(xv[r][(r - 2 - s) % P, c], ws[r]) + landed[r][c]
                 for c in range(C)] for r in range(P)]
    _trace_fused("fused_matmul_allreduce", P, C, mrows * N * 4, phases=2)
    if devs is not None:
        # each card's rows: its own ranks' carry their gradient, the other
        # cards' arrive without one (their card's result carries it)
        outs = {h: _ag_chains([accs[q] if q == h else
                               [_move(a if homes[q] == h else a.detach(),
                                      devs[h]) for a in accs[q]]
                               for q in range(P)]).reshape(padM, N)[:M]
                for h in cards}
        return [outs[h] for h in homes]
    out = _ag_chains(accs).reshape(padM, N)[:M]
    return [out] * P


# ---------------------------------------------------------------------------
# tier 3: the hand-scheduled fused matmul reduce-scatter
# ---------------------------------------------------------------------------
def fused_matmul_reduce_scatter_plain(xs: Sequence[torch.Tensor],
                                      ws: Sequence[torch.Tensor],
                                      devices=None) -> list:
    """Per rank x_r [P, m, K] and w_r [K, N] -> that rank's reduced
    [m, N] float32 block, hop by hop: acc starts as x_r[r - 1] @ w_r; at
    hop s the accumulator arrives from the left and acc = x_r[r - 2 - s]
    @ w_r + arrival.  Ranks on several cards (their tensors on more than
    one device, or ``devices=``): each hop's arrival is a counted
    ``parallel.collectives.move`` onto its rank's card."""
    P = len(xs)
    devs = _rank_devices(xs, devices)
    acc = [pallas_matmul_plain(xs[r][(r - 1) % P], ws[r]) for r in range(P)]
    for s in range(P - 1):
        landing = [acc[(r - 1) % P] for r in range(P)]
        if devs is not None:
            landing = [_move(a, d) for a, d in zip(landing, devs)]
        acc = [pallas_matmul_plain(xs[r][(r - 2 - s) % P], ws[r])
               + landing[r] for r in range(P)]
    return acc


#: the cross-card mode's per-rank slots and flags: (layout, streams) ->
#: ``ring._Tables``, guarded by ``ring._tables_lock``
_cross_tables: dict = {}


def _launch_rs_cross(xs, ws, out, m: int, N: int, K: int,
                     layout: tuple) -> None:
    """The cross-card mode of ``accl_fused_matmul_rs``: one launch per
    card (``ring.card_groups``), each on its card's current stream, over
    the per-rank tables of ``_cross_tables`` (``ring._launch_on_cards``:
    the joins, the gate of an eager launch, none under CUDA graph
    capture).  Counts one launch per card."""
    P = len(xs)
    dt = KERNEL_DTYPES[xs[0].dtype]
    groups = ring_ops.card_groups(layout)
    streams = {c: torch.cuda.current_stream(c) for c, _r in groups}
    ring_ops.enable_peers([c for c, _r in groups])
    tiles = _cdiv(m, FUSED_TILE_M) * _cdiv(N, TILE_N)
    S = min(min(fused_stripes(len(ranks), tiles, _resident_cross(dt, c))
                for c, ranks in groups), ring_ops.MAX_STRIPES)
    vec = _vec([*xs, *ws, *out], K, N, xs[0].element_size())
    lib = _build.load("fused")

    def launch(c, ranks, slots, flags, gate, seq):
        return lib.accl_fused_matmul_rs_cross(
            _ptrs(xs), _ptrs(ws), _ptrs(out), m, N, K, P,
            (ctypes.c_int * len(ranks))(*ranks), len(ranks), dt, S,
            int(vec), slots, flags, gate, seq, c, streams[c].cuda_stream)

    ring_ops._launch_on_cards(layout, streams, 2 * m * N * 4,
                              _cross_tables, launch,
                              "fused_matmul_reduce_scatter")
    fused_matmul_reduce_scatter.launches += len(groups)
    fused_matmul_reduce_scatter.launches_cross += len(groups)


def fused_matmul_reduce_scatter(xs: Sequence[torch.Tensor],
                                ws: Sequence[torch.Tensor],
                                out: Optional[Sequence[torch.Tensor]] = None
                                ) -> list:
    """Ring reduce-scatter of the partial products sum_r x_r @ w_r: rank
    r's x_r [P, m, K] (P row blocks of its activations) and K-shard w_r
    [K, N] -> its reduced [m, N] float32 block (row block r of the sum),
    on its own device.  On the card: one cooperative launch of
    ``accl_fused_matmul_rs``, or with the ranks on several cards (or under
    ``ring.rank_tables()``) one launch per card of its cross-card mode."""
    P = len(xs)
    if not 1 <= P <= MAX_RANKS or len(ws) != P:
        raise ValueError(f"fused_matmul_reduce_scatter: {P} ranks with "
                         f"{len(ws)} weights (1..{MAX_RANKS} ranks)")
    layout = _check_rank_operands(xs, ws, "fused_matmul_reduce_scatter")
    shape = tuple(xs[0].shape)
    if len(shape) != 3 or shape[0] != P:
        raise ValueError(f"fused_matmul_reduce_scatter: x must be [P={P}, "
                         f"m, K], got {shape}")
    _, m, K = shape
    N = ws[0].shape[1] if ws[0].dim() == 2 else -1
    for x, w in zip(xs, ws):
        if tuple(x.shape) != shape or tuple(w.shape) != (K, N):
            raise ValueError(f"fused_matmul_reduce_scatter: every x must be "
                             f"{shape} and every w [{K}, N]")
    if out is not None:
        for o, x in zip(out, xs):
            if (tuple(o.shape) != (m, N) or o.dtype != torch.float32
                    or o.device != x.device or not o.is_contiguous()):
                raise ValueError(f"fused_matmul_reduce_scatter: outputs must "
                                 f"be contiguous float32 [{m}, {N}] on their "
                                 f"rank's device")
    dev = xs[0].device
    if dev.type == "cpu":
        res = fused_matmul_reduce_scatter_plain(xs, ws)
        if out is None:
            return res
        return [o.copy_(r) for o, r in zip(out, res)]
    if P == 1:
        return [pallas_matmul(xs[0][0], ws[0],
                              None if out is None else out[0])]
    if out is None:
        out = [torch.empty((m, N), dtype=torch.float32, device=x.device)
               for x in xs]
    if m == 0 or N == 0:
        return list(out)
    if layout is None and getattr(ring_ops._form, "tables", False):
        layout = tuple(x.device.index for x in xs)
    if layout is not None:
        _launch_rs_cross(xs, ws, out, m, N, K, layout)
        return list(out)
    dt = KERNEL_DTYPES[xs[0].dtype]
    device = dev.index or 0
    S = fused_stripes(P, _cdiv(m, FUSED_TILE_M) * _cdiv(N, TILE_N),
                      _resident(dt, device))
    stream = torch.cuda.current_stream(dev)
    flags = _scratch_for(dev, stream, "flags", P * S * 4)
    # the landing slots may be freed when this returns, before the kernel
    # ends: the caching allocator hands them out again only to work queued
    # after the kernel on this stream
    landing = torch.empty(P * 2 * m * N, dtype=torch.float32, device=dev)
    vec = _vec([*xs, *ws, *out, landing], K, N, xs[0].element_size())
    lib = _build.load("fused")
    rc = lib.accl_fused_matmul_rs(
        _ptrs(xs), _ptrs(ws), _ptrs(out), m, N, K, P, dt, S, int(vec),
        landing.data_ptr(), flags.data_ptr(), device, stream.cuda_stream)
    _raise_on(lib, rc, "fused_matmul_reduce_scatter")
    fused_matmul_reduce_scatter.launches += 1
    return list(out)


fused_matmul_reduce_scatter.launches = 0
#: the launches of the cross-card mode (one per card), within ``launches``
fused_matmul_reduce_scatter.launches_cross = 0


def fused_matmul_allreduce_pallas(xs: Sequence[torch.Tensor],
                                  ws: Sequence[torch.Tensor]) -> list:
    """Allreduce-into-matmul, kernel form: sum_r x_r @ w_r for x_r
    [M, K] (M divisible by P) and K-shards w_r [K, N] — the fused
    reduce-scatter kernel, then the ring all-gather kernel relays the
    reduced product rows.  Every rank gets [M, N] float32, on its own
    device (ranks on several cards take both kernels' cross-card modes)."""
    P = len(xs)
    M, K = xs[0].shape
    if P == 1:
        return [pallas_matmul(xs[0], ws[0])]
    if M % P:
        raise ValueError(f"M ({M}) must divide into the ring size ({P}); "
                         f"pad the row dimension")
    m = M // P
    mine = fused_matmul_reduce_scatter([x.view(P, m, K) for x in xs], ws)
    gathered = ring_all_gather([b.view(-1) for b in mine])
    return [g.view(M, ws[0].shape[1]) for g in gathered]


def fused_expert_ffn(xs: Sequence[torch.Tensor],
                     expert_idxs: Sequence[torch.Tensor], ffn,
                     capacity: int = 0, chunks: Optional[int] = None,
                     devices=None) -> list:
    """Route each member's tokens to their expert and run the expert FFN
    with the capacity dimension split into C chunks: chunk c's dispatch
    all-to-all, the FFN on it, and its return all-to-all.  Same slotting
    and capacity as ``parallel.strategies.expert_dispatch`` /
    ``expert_combine`` (tokens over capacity come back as zeros).

    ``xs[r]`` [N, D] and ``expert_idxs[r]`` [N] in [0, P): member r's
    tokens and their experts (one expert per member).  ``ffn``: member
    r's expert as ``ffn[r]`` ([T, D] -> [T, D] row-wise), or one callable
    for all.  Returns one [N, D] per member.  Members on several cards
    (``devices``, or the tokens' own devices): every chunk's all-to-alls
    cross through the counted ``parallel.collectives.move``."""
    from ..parallel.collectives import all_to_all
    from ..parallel.strategies import _expert_buckets, _expert_unbucket

    P = len(xs)
    N, D = xs[0].shape
    ffns = list(ffn) if isinstance(ffn, (list, tuple)) else [ffn] * P
    if len(expert_idxs) != P or len(ffns) != P:
        raise ValueError(f"fused_expert_ffn: one expert index tensor and "
                         f"one ffn per member ({P} members, "
                         f"{len(expert_idxs)} index tensors, {len(ffns)} "
                         f"ffns)")
    cap = capacity or -(-N // P)
    C = _pick_chunks(cap, chunks)
    ck = cap // C
    buckets, infos = _expert_buckets(xs, expert_idxs, cap)
    back_parts = [[] for _ in range(P)]
    for c in range(C):
        recv = all_to_all([b[:, c * ck:(c + 1) * ck] for b in buckets],
                          split_axis=0, concat_axis=0, tiled=False,
                          devices=devices)
        ys = [f(r.reshape(P * ck, D)).reshape(P, ck, D)
              for f, r in zip(ffns, recv)]
        back = all_to_all(ys, split_axis=0, concat_axis=0, tiled=False,
                          devices=devices)
        for parts, y in zip(back_parts, back):
            parts.append(y)
    _trace_fused("fused_expert_ffn", P, C,
                 ck * D * xs[0].element_size())
    return _expert_unbucket([torch.cat(parts, dim=1) for parts in back_parts],
                            infos)
