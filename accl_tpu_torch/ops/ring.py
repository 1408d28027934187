"""Ring collectives over P ranks held as separate tensors, on one card or
on several.

Port of ``accl_tpu/ops/ring.py``.  There each rank is a chip and the two
Pallas kernels hop over inter-chip remote DMA, one launch per segment
and phase; here every rank's buffer is a tensor, and the two
hand-written CUDA kernels in ``csrc/ring.cu`` hop between the ranks'
memory through a table of per-rank pointers, one persistent launch per
phase and card that walks every segment of a call.

Ranks on several cards (the cross-card mode): when the ranks' tensors
sit on more than one card, each phase is one launch per card, holding
that card's ranks (``card_groups``), with every rank's landing slots and
flags on its own card (``_tables_for``) and each hop a store over NVLink
into the right neighbour's slot.  Before the launches the cards'
streams are joined (each waits for every other), so no card's blocks
start while another card is still busy with earlier work, and after
them the first card's stream waits for every card's; the blocks of an
eager launch then wait for the host's gate, which opens once every
card's launch is enqueued or gives the launch up when one fails, and
every block enters through a handshake with both neighbours
(``csrc/ring.cu`` ``ring_kernel_cross``), whose count of earlier blocks
each rank keeps on its card.  The results are bitwise the one-card
launch's.  ``rank_tables()`` runs the same mode on one card, for tests.
The cards must have peer access to each other (``enable_peers``).  A
cross-card launch can be captured in a CUDA graph and replayed, between
eager launches on the same tables in any order: a captured launch has
no gate, and its handshake reads its count from the card.  Under capture
the tables must already exist at their size (an eager warm-up on the
same streams makes them), every card's current stream must be one that
can join the capture (not its default stream), and the capture's owner
joins the other cards' streams back before it ends.  Two threads that
launch on the same cards must do so in one order, as with any
collective library.

Every function takes a list with one tensor per rank, in ring order.
Beside each kernel wrapper sits its plain PyTorch version, a Python loop
over the same hops with the same chunk indexing.  A wrapper runs the
plain version only when it is given CPU tensors; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its kernel launches
in its ``launches`` attribute.

Device tracing (accl_tpu/ops/ring.py:56-96): with ``ACCL_DEVICE_TRACE``
set (read once, at the first ring call), every ring collective yields
one stamp row per (segment, rank, step) in the order of
``observability.trace.DEVICE_TRACE_FIELDS``, grouped as the reference's
segmented drivers land theirs: one record per segment and rank (the
reference's one per ``pallas_call`` and shard) under ``"reduce_scatter"``
or ``"all_gather"``.  On the card the kernels write the rows into a
buffer allocated for that launch only (the ``ring_kernel<T, KIND,
true>`` instantiation); the wrapper synchronizes the stream after the
launch and lands the rows in the collector before it returns, as the
reference's drivers block on each ``pallas_call``'s rows.  The plain
versions record the same rows, computed from the schedule
(:func:`stamp_rows`), at once.
With the gate on, the segmented all-gather and reduce-scatter cut their
launch into the reference's segments, so each segment has its rows.  The
rows' landing synchronizes the stream, so a launch with the gate on
cannot be captured in a CUDA graph: it raises there.

Self-ring mode (``ring_size``, accl_tpu/ops/ring.py:151-175, 274-294,
398-424): on a one-member axis the reference runs its kernels as a ring
of V virtual ranks on one chip, every hop a real DMA to the chip itself
with the semaphore handshakes and the ACK window.  Here a one-member
operand list with ``ring_size=V`` does the same: the all-gather of [n]
gives [V, n] (the operand in every row), the reduce-scatter of [V, n]
gives x[0] + (x[1] + (... + x[V - 1])) (or the max, in that order), the
allreduce of [V n] is one then the other.  The kernel runs it as one
rank whose right and left neighbour is itself (``ring_kernel`` with
P = 1 and a ring length V): each of the V - 1 hops of a tile goes
through that rank's own landing slots and flags, as in the reference,
and the fold order is the reference's with my = 0 by construction.  The
other form, V ranks whose operand pointers all name the one input,
would need every rank's chunks rotated by its index to fold in that
order (which the kernel's pointer-and-stride geometry cannot express
without a rotated copy of the input) and V distinct results where the
reference has one.  The stamp rows are the reference's: V - 1 per call,
rank and both peers 0.

Ranks in several processes (the cross-process form of the cross-card
mode, after ``utils.bringup.initialize_multihost``): ``ring_reduce_scatter``,
``ring_all_gather`` and ``ring_all_reduce`` (and their plain versions)
take ``devices=``, each rank's device in ring order, a
``ProcessDevice`` for a rank of another process, and operand lists with
``None`` for those ranks; they return this process's ranks' results
(``None`` elsewhere).  Every process must make the same calls in the
same order.  On the card each process launches ``ring_kernel_cross``
once a card for its own ranks (counted in ``launches_cross`` and
``launches_procs`` of this process), over tables whose every rank's
slots and flags are an allocation of their owner's ``cudaMalloc``,
exported by a CUDA IPC handle and opened by the other processes
(``utils/ipc.py``; the kernel reads only its own ranks' operand and
result pointers, so the others' are null).  The launch agrees across
the processes through the transport's board: each process synchronizes
its cards' current streams, posts the launch (its number, a signature of
the call and whether its pointers are 16-byte aligned) and waits until
every process has; the plan (stripes, tile width, vector access) is then
derived from what every process knows, the layout and the agreed
alignment and resident blocks.  After enqueueing, each process posts that
and waits until every process has, and only then opens its own gate, so
a process whose launch failed (it gives up, process-wide) makes every
other process's blocks end at once and its host raise ``ACCLError``
naming it.  The stream synchronization before the barrier stands in for
the joins of the one-process mode (``accl_ring_join``): no process's
blocks start while another process's stream still holds earlier work,
and no interprocess event is needed; the entry handshake guards the
order of launches on the tables as it does across cards.  A table's
slots that a larger call outgrows are kept until the transport closes
(a peer may have them mapped).  On the CPU the plain versions make the
same hops, each hop between two processes a message of the transport
(a shared file under ``/dev/shm``).  Not across processes: CUDA graph
capture, and the device-trace rows (both raise).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from ..constants import ACCLError
from ..observability.trace import DEVICE_TRACE_FIELDS, record_device_steps
from . import _build

#: stamp-row width of the device-trace rows (STAMP_COLS in csrc/ring.cu)
DEVICE_TRACE_COLS = len(DEVICE_TRACE_FIELDS)

#: ACCL_DEVICE_TRACE, read once at the first ring call (None = not read)
_DEVICE_TRACE: Optional[bool] = None


def device_trace_enabled() -> bool:
    """The ``ACCL_DEVICE_TRACE`` gate, cached at its first reading."""
    global _DEVICE_TRACE
    if _DEVICE_TRACE is None:
        _DEVICE_TRACE = os.environ.get(
            "ACCL_DEVICE_TRACE", "0") not in ("", "0")
    return bool(_DEVICE_TRACE)


def _reset_device_trace_cache() -> None:
    """Test hook: the next ring call re-reads the env."""
    global _DEVICE_TRACE
    _DEVICE_TRACE = None


def stamp_rows(P: int, chunk_bytes: int,
               V: Optional[int] = None) -> torch.Tensor:
    """The [P, V - 1, DEVICE_TRACE_COLS] int32 stamp rows of one segment
    of a ring of V = P hops (or of the self-ring, P = 1), computed from
    the schedule (the reference's ``_stamp_row``): rank r's step s reads
    r, s, 3s, 3s + 1, 3s + 2, its right and left neighbours, and the
    chunk's bytes sent and received."""
    V = P if V is None else V
    my = torch.arange(P).view(P, 1).expand(P, V - 1)
    st = torch.arange(V - 1).view(1, V - 1).expand(P, V - 1)
    nb = torch.full((P, V - 1), chunk_bytes)
    return torch.stack([my, st, 3 * st, 3 * st + 1, 3 * st + 2,
                        (my + 1) % P, (my + P - 1) % P, nb, nb],
                       dim=-1).to(torch.int32)


#: the collector's name of each launch kind
_TRACE_NAME = {"rs": "reduce_scatter", "ag": "all_gather"}


def _record_rows(kind: str, rows) -> None:
    """Land [segments, P, V - 1, cols] rows: one record per segment and
    rank."""
    for seg in rows:
        for rank_rows in seg:
            record_device_steps(_TRACE_NAME[kind], rank_rows)


def _trace_plain(kind: str, P: int, widths, elem: int,
                 V: Optional[int] = None) -> None:
    """With the gate on, record the rows a plain run of segments of these
    chunk widths stands for (a ring of V hops, V = P by default)."""
    V = P if V is None else V
    if V > 1 and device_trace_enabled():
        _record_rows(kind, [stamp_rows(P, w * elem, V)
                            for w in widths if w])



# ---------------------------------------------------------------------------
# Flow-control window algebra (twin of accl_tpu/ops/ring.py:132-148, and
# of the predicates compiled into csrc/ring.cu).
#
# All-gather: the slot a rank lands its NEXT incoming chunk in was last
# read by its own forwarding send one step ago, so from step 1 on the
# left neighbour is held off until the ACK; a slot is ACKed as soon as the
# send out of it completes, except in the last two steps, whose slots are
# never written again.
# ---------------------------------------------------------------------------
def ag_waits_ack(step: int, P: int) -> bool:
    return step >= 1


def ag_signals_ack(step: int, P: int) -> bool:
    return step <= P - 3


# Reduce-scatter: the landing buffer is double-buffered; a slot is
# reusable after the fold that consumed it, two steps after it was written.
def rs_waits_ack(step: int, P: int) -> bool:
    return step >= 2


def rs_signals_ack(step: int, P: int) -> bool:
    return step <= P - 4


#: default segment length in elements of the flat payload (1 MiB fp32)
DEFAULT_SEG_ELEMS = 1 << 18

#: dtypes the CUDA kernels take, with their code in csrc/ring.cu
KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.float64: 2,
                 torch.int32: 3, torch.int64: 4}
#: ranks one launch can hold (MAXP in csrc/ring.cu)
MAX_RANKS = 32


def _fold(op: str):
    if op not in ("sum", "max"):
        raise ValueError(f"ring reduction op must be 'sum' or 'max', got {op!r}")
    return torch.maximum if op == "max" else torch.add


def _ring_len(P: int, ring_size: Optional[int]) -> int:
    """The ring's length: P ranks, or the self-ring's ``ring_size``
    virtual ranks on a one-member list (accl_tpu/ops/ring.py:171-175)."""
    if ring_size is None:
        return P
    if ring_size != P and P != 1:
        raise ValueError("ring_size override requires a 1-member axis "
                         f"(self-ring mode); got P={P}, "
                         f"ring_size={ring_size}")
    if ring_size < 1:
        raise ValueError(f"ring_size must be >= 1, got {ring_size}")
    return ring_size


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _at(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` on ``like``'s device: a hop from one rank's card to the
    next's (``t`` itself when they share a device)."""
    return t if t.device == like.device else t.to(like.device)


def ring_reduce_scatter_plain(xs: Sequence[torch.Tensor], op: str = "sum",
                              out: Optional[Sequence[torch.Tensor]] = None,
                              ring_size: Optional[int] = None, devices=None):
    """Per rank [V, n] -> that rank's reduced [n], hop by hop over a ring
    of V = P ranks (or the self-ring of ``ring_size`` on one rank): acc
    starts as chunk (my - 1); at step s the accumulator arrives from the
    left and acc = x[(my - 2 - s) % V] + arrival.  With ``devices`` naming
    ranks of other processes (``None`` in ``xs``), each hop between two
    processes goes through the transport."""
    fold = _fold(op)
    P = len(xs)
    V = _ring_len(P, ring_size)
    layout = _process_layout(xs, devices, "ring_reduce_scatter")
    hops = _hops(layout, xs, "ring_reduce_scatter")
    acc = [x if x is None else x[(r - 1) % V].clone()
           for r, x in enumerate(xs)]
    for step in range(V - 1):
        landing = hops(acc)
        acc = [x if x is None else fold(x[(r - 2 - step) % V], landing[r])
               for r, x in enumerate(xs)]
    if out is None:
        return acc
    for o, a in zip(out, acc):
        if o is not None:
            o.copy_(a)
    return list(out)


def ring_all_gather_plain(xs: Sequence[torch.Tensor],
                          out: Optional[Sequence[torch.Tensor]] = None,
                          ring_size: Optional[int] = None, devices=None):
    """Per rank [n] -> [V, n], hop by hop over a ring of V = P ranks (or
    the self-ring of ``ring_size`` on one rank): the local block goes to
    out[my]; at step s the newest chunk arrives from the left and is
    placed at out[(my - s - 1) % V].  ``devices``: as for
    :func:`ring_reduce_scatter_plain`."""
    P = len(xs)
    V = _ring_len(P, ring_size)
    layout = _process_layout(xs, devices, "ring_all_gather")
    hops = _hops(layout, xs, "ring_all_gather")
    if out is None:
        out = [x if x is None else x.new_empty((V,) + tuple(x.shape))
               for x in xs]
    comm = []
    for r in range(P):
        if xs[r] is not None:
            out[r][r].copy_(xs[r])
        comm.append(xs[r] if xs[r] is None else xs[r].clone())
    for step in range(V - 1):
        comm = hops(comm)
        for r in range(P):
            if xs[r] is not None:
                out[r][(r - step - 1) % V].copy_(comm[r])
    return list(out)


# ---------------------------------------------------------------------------
# ranks in several processes: the layout, the plain hops over the transport
# ---------------------------------------------------------------------------
def _process_layout(xs, devices, what: str) -> Optional[tuple]:
    """((process, device), ...) per rank when ``devices`` names a rank of
    another process (its operand ``None``), else None.  Every rank of this
    process must have its tensor, on its device."""
    from ..utils import ipc

    if devices is None:
        if any(x is None for x in xs):
            raise ValueError(f"{what}: a None operand needs devices= naming "
                             f"its rank's process")
        return None
    if len(devices) != len(xs):
        raise ValueError(f"{what}: {len(xs)} ranks, {len(devices)} devices")
    if not any(ipc.is_remote(d) for d in devices):
        return None
    layout = []
    for r, (x, d) in enumerate(zip(xs, devices)):
        remote = ipc.is_remote(d)
        if remote != (x is None):
            raise ValueError(f"{what}: rank {r} on {d} needs "
                             f"{'None' if remote else 'its tensor'}")
        if not remote and x.device != ipc.local(d):
            raise ValueError(f"{what}: rank {r}'s tensor is on {x.device}, "
                             f"its device {d}")
        layout.append((ipc.process_of(d), ipc.local(d)))
    return tuple(layout)


def _hops(layout: Optional[tuple], xs, what: str):
    """``hops(vals)``: each rank's left neighbour's value on the rank's
    device, one step of the plain versions.  Across processes (``layout``)
    the values leaving this process are sent first, in rank order, then
    those arriving are received, in rank order, so the k-th message from
    one process to another is the same rank's in both."""
    P = len(xs)
    if layout is None:
        return lambda vals: [_at(vals[(r - 1) % P], xs[r]) for r in range(P)]
    from ..utils import bringup, ipc

    me = bringup.process_index()

    def hops(vals):
        tr = ipc.transport()
        for r in range(P):
            lp, rp = layout[(r - 1) % P][0], layout[r][0]
            if lp == me and rp != me:
                tr.send(vals[(r - 1) % P], rp, what)
        out = []
        for r in range(P):
            lp, rp = layout[(r - 1) % P][0], layout[r][0]
            if rp != me:
                out.append(None)
            elif lp == me:
                out.append(_at(vals[(r - 1) % P], xs[r]))
            else:
                out.append(tr.recv(lp, layout[r][1], what))
        return out

    return hops


# ---------------------------------------------------------------------------
# the launch geometry of csrc/ring.cu, and its plain version
# ---------------------------------------------------------------------------
#: bytes of one landing slot: a tile of one chunk
SLOT_BYTES = 32768
#: the most that one launch's landing slots may take: they should stay
#: in the card's 50 MB L2
SCRATCH_BYTES = 32 << 20
#: threads of a block (THREADS in csrc/ring.cu)
THREADS = 256
_NO_LIMIT = 1 << 62


class Part(NamedTuple):
    """Segments of one width in a launch: element j of chunk c of segment
    i sits at ``x_off + i x_seg + c x_chunk + j`` in an operand and at
    ``o_off + i o_seg + c o_chunk + j`` in a result; columns with
    ``c w + j >= lim`` are padding, neither read nor written."""
    nseg: int
    w: int
    x_off: int
    x_seg: int
    x_chunk: int
    o_off: int
    o_seg: int
    o_chunk: int
    lim: int = _NO_LIMIT


def tile_waits_ack(hop: int, H: int) -> bool:
    """A stripe of H hops, numbered across its tiles, each landing read
    once: the reduce-scatter's windows over a ring of H + 1
    (tile_waits_ack in csrc/ring_sync.cuh)."""
    return rs_waits_ack(hop, H + 1)


def tile_signals_ack(hop: int, H: int) -> bool:
    return rs_signals_ack(hop, H + 1)


def allreduce_parts(N: int, P: int, seg_elems: int = DEFAULT_SEG_ELEMS):
    """The segments of a flat [N] allreduce, as the reference cuts them
    (accl_tpu/ops/ring.py:461-476): whole segments of length
    max(P, (min(seg_elems, N) // P) P), chunk width length / P, then a
    ragged last segment of chunk width ceil(s / P) whose padding is
    masked.  Operand and result share the layout."""
    seg = max(P, (min(seg_elems, N) // P) * P)
    nfull, rem = divmod(N, seg)
    parts = []
    if nfull:
        w = seg // P
        parts.append(Part(nfull, w, 0, seg, w, 0, seg, w))
    if rem:
        wl = -(-rem // P)
        off = nfull * seg
        parts.append(Part(1, wl, off, 0, wl, off, 0, wl, rem))
    return parts


def tiling(parts, P: int, elem: int, resident: int):
    """(tile width, tiles, stripes per rank) of one launch.  Stripes: as
    many as fit co-resident (``resident`` blocks over P ranks), no more
    than there are tiles, and no more than SCRATCH_BYTES of slots.  The
    tile width spreads the columns over those stripes, between one
    16-byte vector per thread and SLOT_BYTES."""
    fit = resident // P
    if fit < 1:
        raise RuntimeError(f"ring kernel: {P} ranks do not fit co-resident "
                           f"on this card")
    V = 16 // elem

    def up(a, b):
        return -(-a // b) * b

    slot = max(V, SLOT_BYTES // elem)
    cap = min(fit, max(1, SCRATCH_BYTES // (P * 2 * slot * elem)))
    cols = sum(p.nseg * p.w for p in parts)
    widest = max(p.w for p in parts)
    tw = max(up(-(-cols // cap), THREADS * V), THREADS * V)
    tw = min(tw, slot, up(widest, V))
    ntiles = sum(p.nseg * -(-p.w // tw) for p in parts)
    stripes = min(fit, ntiles, max(1, SCRATCH_BYTES // (P * 2 * tw * elem)))
    return tw, ntiles, stripes


def _geometry(parts, tw: int, ntiles: int, aligned: bool, V: int):
    """The GEOMETRY_WORDS int64 words of struct Geometry (csrc/ring.cu)."""
    words, first = [], 0
    for p in list(parts) + [Part(0, 1, 0, 0, 0, 0, 0, 0)] * (2 - len(parts)):
        tps = -(-p.w // tw) if p.nseg else 1
        strides = (p.x_off, p.x_seg if p.nseg > 1 else 0, p.x_chunk,
                   p.o_off, p.o_seg if p.nseg > 1 else 0, p.o_chunk)
        vec = aligned and all(v % V == 0 for v in strides)
        words += [p.nseg, p.w, tps, first if p.nseg else ntiles, *strides,
                  p.lim, int(vec)]
        first += p.nseg * tps
    words += [tw, ntiles]
    return (ctypes.c_int64 * len(words))(*words)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(xs, out, what: str) -> Optional[tuple]:
    """Ranks 1..MAX_RANKS, one dtype, every tensor on the CPU or every one
    on a card; rank r's result on rank r's operand's device.  Returns
    the layout (each rank's card) when the ranks sit on several cards,
    else None."""
    if not 1 <= len(xs) <= MAX_RANKS:
        raise ValueError(f"{what}: {len(xs)} ranks (1..{MAX_RANKS} supported)")
    dev, dt = xs[0].device, xs[0].dtype
    spread = False
    for t in xs:
        if t.device != dev:
            spread = True
        if t.dtype != dt or (spread and t.device.type != dev.type):
            raise ValueError(f"{what}: every tensor must share device type "
                             f"{dev.type} and dtype {dt}, got {t.device} "
                             f"{t.dtype}")
    for r, t in enumerate(out or ()):
        if t.device != (xs[r].device if spread else dev) or t.dtype != dt:
            raise ValueError(f"{what}: rank {r}'s result must be on its "
                             f"operand's device {xs[r].device} in {dt}, got "
                             f"{t.device} {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev} (cpu or cuda only)")
    if dev.type == "cuda" and dt not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernel takes "
                         f"{sorted(str(d) for d in KERNEL_DTYPES)}, not {dt}")
    return tuple(t.device.index for t in xs) if spread else None


def _ptrs(ts) -> "ctypes.Array":
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.accl_ring_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def _resident(kind: int, dtype_code: int, device: int,
              stamp: int = 0) -> int:
    """Blocks of one kernel that fit on the card together (cached);
    ``stamp``: bit 0 the device-trace instantiation, bit 1 the cross-card
    mode."""
    lib = _build.load("ring")
    got = lib.accl_ring_resident(kind, dtype_code, int(stamp), device)
    if got < 0:
        _raise_on(lib, -got, "accl_ring_resident")
    return got


_scratch_lock = threading.Lock()
#: (device, stream) -> [landing slots (bytes), flags (int32, kept zero)]
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream, nbytes: int, nflags: int):
    """The slots and flags of one launch on the current stream, kept per
    device and stream and reused in stream order; the kernels leave the
    flags at zero.  Under a CUDA graph capture they are made anew, in the
    graph's private pool, which holds them for the graph's life: a cached
    buffer is replaced, and freed, by a larger launch on a stream of the
    same handle, and the stream pool hands handles out again."""
    if torch.cuda.is_current_stream_capturing():
        return [torch.empty(nbytes, dtype=torch.uint8, device=dev),
                torch.zeros(nflags, dtype=torch.int32, device=dev)]
    key = (dev.index, stream.cuda_stream)
    with _scratch_lock:
        cur = _scratch.get(key)
        if cur is None or cur[0].numel() < nbytes:
            slots = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            cur = [slots, cur[1] if cur else None]
        if cur[1] is None or cur[1].numel() < nflags:
            cur[1] = torch.zeros(nflags, dtype=torch.int32, device=dev)
        _scratch[key] = cur
        return cur


def kernel_info(kind: int, dtype: torch.dtype, stamp: int,
                device: int = 0) -> dict:
    """Registers, local (spill) bytes and blocks per SM of one
    ``ring_kernel`` instantiation (kind 0 reduce-scatter by sum, 1 by
    max, 2 all-gather; ``stamp`` bit 0 the device-trace one, bit 1 the
    cross-card mode's ``ring_kernel_cross``)."""
    lib = _build.load("ring")
    out = (ctypes.c_int * 3)()
    _raise_on(lib, lib.accl_ring_kernel_info(kind, KERNEL_DTYPES[dtype],
                                             int(stamp), device, out),
              "accl_ring_kernel_info")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


@functools.lru_cache(maxsize=256)
def _plan(parts: tuple, P: int, elem: int, k: int, code: int, device: int,
          aligned: bool, stamp: bool = False, layout: Optional[tuple] = None):
    """(stripes, geometry words, slot bytes) of one launch (cached: a
    driver repeats the same few shapes).  With ``layout`` (the card of
    each rank) the cross-card mode's: every card's launch has the same
    stripes, as many as fit on the card that holds the most ranks, and
    the slot bytes are one rank's."""
    if layout is None:
        tw, ntiles, S = tiling(parts, P, elem,
                               _resident(k, code, device, stamp))
        return S, _geometry(parts, tw, ntiles, aligned, 16 // elem), \
            P * S * 2 * tw * elem
    groups = card_groups(layout)
    most = max(len(ranks) for _c, ranks in groups)
    resident = min(_resident(k, code, c, int(stamp) | 2) for c, _r in groups)
    tw, ntiles, S = tiling(parts, most, elem, resident)
    S = min(S, MAX_STRIPES)
    return S, _geometry(parts, tw, ntiles, aligned, 16 // elem), \
        S * 2 * tw * elem


# ---------------------------------------------------------------------------
# ranks on several cards: the per-card launch plan, pure functions of a
# layout (the card of each rank, in rank order)
# ---------------------------------------------------------------------------
#: words at the head of a rank's flags (HS_WORDS in csrc/ring_sync.cuh):
#: the handshake's two counts, a card's copy of the host's gate, and the
#: rank's count of its blocks that ended every earlier launch (HS_DONE)
#: and the launch under way (HS_ENDED)
HS_WORDS = 6
HS_DONE = 4
HS_ENDED = 5
#: stripes a rank's flags have room for in the cross-card mode
MAX_STRIPES = 1024


def card_groups(layout: Sequence[int]) -> list:
    """[(card, [ranks])]: one launch per card, cards in the order of
    their first rank, each card's ranks in rank order."""
    groups: dict = {}
    for r, c in enumerate(layout):
        groups.setdefault(c, []).append(r)
    return list(groups.items())


#: the per-rank-table form on one card (``rank_tables``), per thread
_form = threading.local()


class rank_tables:
    """``with rank_tables():`` launches this thread's ring kernels in the
    cross-card mode's per-rank-table form even when every rank shares one
    card (one launch, .sys flags, the entry handshake): the form a
    one-card test holds against the one-launch form."""

    def __enter__(self):
        self._saved = getattr(_form, "tables", False)
        _form.tables = True
        return self

    def __exit__(self, *exc):
        _form.tables = self._saved


class _Tables:
    """The landing slots and flags of every rank of one layout on one set
    of streams (each rank's on its own card; the flags' head keeps the
    handshake's count), and the host's gate of the eager launches (two
    words of mapped host memory: the launches opened, and whether one
    was given up) with the number of the last one.  Once a launch on them
    was captured in a CUDA graph (``captured``), no buffer of theirs is
    freed: slots outgrown are ``held``, and tables dropped after a launch
    was given up are kept in ``_held_tables``, since a replay still
    writes them."""

    __slots__ = ("slots", "flags", "gate", "seq", "captured", "held")

    def __init__(self, gate: int):
        self.slots: list = []
        self.flags: list = []
        self.gate = gate
        self.seq = 0
        self.captured = False
        self.held: list = []


_tables_lock = threading.RLock()
#: (layout, ((card, stream), ...)) -> _Tables
_tables: dict = {}
#: tables dropped after a launch was given up whose buffers a captured
#: launch still writes
_held_tables: list = []
#: card sets whose pairs have peer access enabled
_peers_enabled: set = set()


def enable_peers(cards: Sequence[int]) -> None:
    """Enable peer access between every pair of ``cards`` (once per set),
    or raise naming a pair that has none: there is no staging through
    the host."""
    key = tuple(sorted(set(cards)))
    if len(key) < 2 or key in _peers_enabled:
        return
    lib = _build.load("ring")
    pair = (ctypes.c_int * 2)()
    rc = lib.accl_ring_enable_peers((ctypes.c_int * len(key))(*key),
                                    len(key), pair)
    if rc != 0:
        msg = lib.accl_ring_error_string(rc).decode()
        raise RuntimeError(f"ring kernels: no peer access from cuda:{pair[0]}"
                           f" to cuda:{pair[1]} (CUDA error {rc}: {msg})")
    _peers_enabled.add(key)


def _tables_key(layout: tuple, streams: dict) -> tuple:
    return (layout, tuple(sorted((c, s.cuda_stream)
                                 for c, s in streams.items())))


def _tables_for(layout: tuple, streams: dict, slot_bytes: int,
                registry: Optional[dict] = None, capturing: bool = False,
                what: str = "ring kernels") -> _Tables:
    """The tables of ``layout`` on the cards' current ``streams``, each
    rank's slots grown to ``slot_bytes``.  Whatever is made anew is made
    on the rank's card and its stream is synchronized before any launch
    can use it: a neighbour card writes into these buffers with no order
    on this card's stream (a fresh zero must be in place, and no earlier
    work on this stream may still hold the memory).  ``registry``: where
    the tables are kept (the ring kernels' ``_tables`` by default;
    ``ops.fused`` keeps its own, which the same lock guards).  Under CUDA
    graph capture (``capturing``) nothing may be made or synchronized:
    tables missing or too small raise, naming the eager warm-up."""
    registry = _tables if registry is None else registry
    key = _tables_key(layout, streams)
    with _tables_lock:
        tabs = registry.get(key)
        if capturing:
            if tabs is None or any(t is None or t.numel() < slot_bytes
                                   for t in tabs.slots):
                raise RuntimeError(
                    f"{what}: a cross-card launch under CUDA graph capture "
                    f"needs its tables, made by an eager launch of the same "
                    f"size (or larger) on the same streams: run the step "
                    f"once eagerly on those streams before capturing (a "
                    f"warm-up)")
            tabs.captured = True
            return tabs
        if tabs is None:
            lib = _build.load("ring")
            gate = ctypes.c_void_p()
            _raise_on(lib, lib.accl_ring_gate_new(ctypes.byref(gate)),
                      "accl_ring_gate_new")
            tabs = registry[key] = _Tables(gate.value)
            # slots and flags on the card of the rank that reads them
            tabs.flags = [torch.zeros(HS_WORDS + 4 * MAX_STRIPES,
                                      dtype=torch.int32, device=f"cuda:{c}")
                          for c in layout]
            tabs.slots = [None] * len(layout)
            made = set(layout)
        else:
            made = set()
        for r, c in enumerate(layout):
            if tabs.slots[r] is None or tabs.slots[r].numel() < slot_bytes:
                if tabs.captured and tabs.slots[r] is not None:
                    tabs.held.append(tabs.slots[r])
                tabs.slots[r] = torch.empty(slot_bytes, dtype=torch.uint8,
                                            device=f"cuda:{c}")
                made.add(c)
        for c in made:
            streams[c].synchronize()
        return tabs


def _c_int(value: int) -> int:
    """``value`` mod 2^32 as the C int that holds its bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _gate_word(tabs: _Tables, word: int, value: int) -> None:
    """Store ``value`` (mod 2^32) into word ``word`` of ``tabs``' gate,
    which the blocks read over the bus."""
    ctypes.c_int32.from_address(tabs.gate + 4 * word).value = _c_int(value)


def _capturing_cards(streams: dict) -> list:
    """The cards among ``streams`` (card -> its current stream) whose
    stream is capturing a CUDA graph.  A default stream never captures,
    and is not asked: asking it while a capture is under way elsewhere
    would make it depend on that capture, which CUDA refuses."""
    got = []
    for c, s in streams.items():
        if s.cuda_stream == 0:
            continue
        with torch.cuda.device(c):
            if torch.cuda.is_current_stream_capturing():
                got.append(c)
    return got


def _launch_on_cards(layout: tuple, streams: dict, slot_bytes: int,
                    registry: dict, launch, what: str) -> None:
    """One launch of a cross-card mode (the ring kernels', or
    ``ops.fused``'s with its ``registry``) over the tables of ``layout``
    on the cards' current ``streams``: ``launch(card, ranks, slots,
    flags, gate, seq)`` enqueues one card's launch (``slots`` and
    ``flags`` the per-rank pointer tables) and returns its CUDA error
    code.  The cards' streams are joined before the launches
    (``accl_ring_join``) and the first card's waits for every card's
    after them (``accl_ring_join_back``).  An eager launch passes the
    tables' gate and its number, and opens it once every card's launch is
    enqueued, or gives it up when one fails, so that the blocks already
    enqueued end at once.  Under CUDA graph capture on any card's stream,
    the launch passes no gate (a graph launch enqueues every card's
    kernel or none) and reads nothing of the host's gate count; the
    capturing card's stream leads the joins, which first fork the others
    into the capture where they do not capture yet."""
    groups = card_groups(layout)
    cards = [c for c, _r in groups]
    capturing = _capturing_cards(streams)
    if capturing:
        idle = [c for c in cards
                if c not in capturing and streams[c].cuda_stream == 0]
        if idle:
            raise RuntimeError(
                f"{what}: under CUDA graph capture every card's current "
                f"stream must be able to join the capture; cuda:{idle[0]}'s "
                f"is its default stream (make a side stream current there)")
        cards = capturing[:1] + [c for c in cards if c != capturing[0]]
    lib = _build.load("ring")
    with _tables_lock:
        tabs = _tables_for(layout, streams, slot_bytes, registry,
                           bool(capturing), what)
        P = len(layout)
        slots = (ctypes.c_void_p * P)(*[t.data_ptr() for t in tabs.slots])
        flags = (ctypes.c_void_p * P)(*[t.data_ptr() for t in tabs.flags])
        n = len(cards)
        if n > 1:
            join = ((ctypes.c_int * n)(*cards), (ctypes.c_void_p * n)(
                *[streams[c].cuda_stream for c in cards]), n)
            _raise_on(lib, lib.accl_ring_join(
                *join, int(0 < len(capturing) < n)), "accl_ring_join")
        gate, seq = None, 0
        if not capturing:
            gate, seq = tabs.gate, (tabs.seq + 1) & 0xFFFFFFFF
        for c, ranks in groups:
            rc = launch(c, ranks, slots, flags, gate, _c_int(seq))
            if rc != 0:
                if not capturing:
                    # the blocks enqueued on earlier cards wait for the
                    # gate: give the launch up so they end at once, and
                    # make fresh tables for the next launch (these may
                    # hold its slots)
                    _gate_word(tabs, 1, 1)
                    registry.pop(_tables_key(layout, streams), None)
                    if tabs.captured:
                        _held_tables.append(tabs)
                _raise_on(lib, rc, what)
        if not capturing:
            tabs.seq = seq
            _gate_word(tabs, 0, seq)
        if n > 1:
            _raise_on(lib, lib.accl_ring_join_back(*join),
                      "accl_ring_join_back")


def _launch_cross(kind: str, xs, outs, parts, op: str, land: bool,
                  layout: tuple) -> None:
    """The cross-card mode of :func:`_launch`: one launch per card over
    the per-rank tables, in the order of ``card_groups``, each on its
    card's current stream (:func:`_launch_on_cards`).  Counts one launch
    per card."""
    P, elem = len(xs), xs[0].element_size()
    code = KERNEL_DTYPES[xs[0].dtype]
    k = 2 if kind == "ag" else int(op == "max")
    groups = card_groups(layout)
    streams = {c: torch.cuda.current_stream(c) for c, _r in groups}
    stamp = device_trace_enabled()
    if stamp and land and _capturing_cards(streams):
        raise RuntimeError(
            "ring kernels: ACCL_DEVICE_TRACE lands its stamp rows after "
            "a synchronize, which a CUDA graph capture cannot hold; unset "
            "it to capture")
    enable_peers([c for c, _r in groups])
    xp = [t.data_ptr() for t in xs]
    op_ = [t.data_ptr() for t in outs]
    aligned = all(a % 16 == 0 for a in xp + op_)
    S, geo, slot_bytes = _plan(tuple(parts), P, elem, k, code, layout[0],
                               aligned, stamp, layout)
    nseg = sum(p.nseg for p in parts)
    stamps = {c: torch.empty(nseg * P * (P - 1) * DEVICE_TRACE_COLS,
                             dtype=torch.int32, device=f"cuda:{c}")
              for c in streams} if stamp else {}
    lib = _build.load("ring")
    wrapper = ring_all_gather if kind == "ag" else ring_reduce_scatter
    key_xs = (ctypes.c_void_p * P)(*xp)
    key_outs = (ctypes.c_void_p * P)(*op_)

    def launch(c, ranks, slots, flags, gate, seq):
        st = stamps.get(c)
        return lib.accl_ring_launch_cross(
            k, code, key_xs, key_outs, P,
            (ctypes.c_int * len(ranks))(*ranks), len(ranks), S, geo,
            slots, flags, gate, seq, None if st is None else st.data_ptr(),
            c, streams[c].cuda_stream)

    _launch_on_cards(layout, streams, slot_bytes, _tables, launch,
                    wrapper.__name__)
    wrapper.launches += len(groups)
    wrapper.launches_cross += len(groups)
    if stamps:
        wrapper.launches_stamp += len(groups)
        if land:
            rows = torch.empty(nseg, P, P - 1, DEVICE_TRACE_COLS,
                               dtype=torch.int32)
            for c, ranks in groups:
                streams[c].synchronize()
                got = stamps[c].view(nseg, P, P - 1, DEVICE_TRACE_COLS)
                rows[:, ranks] = got[:, ranks].cpu()
            _record_rows(kind, rows)


class _ProcTables:
    """The tables of one layout across processes on this process's
    streams: each rank's slots and flags as pointers (this process's
    ranks' from its own ``cudaMalloc``, the others' opened from their IPC
    handles), this process's gate of its eager launches and the number of
    the last one, ``tid`` the number of this layout's table sets (the same
    in every process: they make them in one order), the slots' bytes, and
    the other processes' slots this process opened (``opened``: (handle,
    card) pairs, unmapped when the slots grow)."""

    __slots__ = ("slots", "flags", "gate", "seq", "tid", "gen",
                 "slot_bytes", "opened")

    def __init__(self, gate: int, tid: int, P: int):
        self.slots, self.flags = [0] * P, [0] * P
        self.gate, self.seq, self.tid, self.gen = gate, 0, tid, 0
        self.slot_bytes = 0
        self.opened: list = []


#: (layout, ((card, stream), ...)) -> _ProcTables
_proc_tables: dict = {}
#: layout -> table sets made for it
_proc_table_ids: dict = {}
#: (layout, kind, dtype code) -> the fewest co-resident blocks of any
#: process's cards
_proc_resident: dict = {}
#: the bytes of a rank's flags (HS_WORDS + 4 MAX_STRIPES int32)
FLAG_BYTES = 4 * (HS_WORDS + 4 * MAX_STRIPES)


def _proc_tables_for(tr, layout: tuple, streams: dict,
                     slot_bytes: int) -> _ProcTables:
    """The tables of ``layout`` across processes on this process's
    ``streams``, each rank's slots at least ``slot_bytes`` (made and
    exchanged with every process: the plan agrees, so every process
    decides alike).  Called after the launch barrier, when no launch on
    them is in flight in any process; slots outgrown stay allocated until
    the transport closes."""
    me = tr.process
    key = _tables_key(layout, streams)
    tabs = _proc_tables.get(key)
    card = min(streams)
    if tabs is None:
        lib = _build.load("ring")
        gate = ctypes.c_void_p()
        _raise_on(lib, lib.accl_ring_gate_new(ctypes.byref(gate)),
                  "accl_ring_gate_new")
        tid = _proc_table_ids.get(layout, 0)
        _proc_table_ids[layout] = tid + 1
        tabs = _proc_tables[key] = _ProcTables(gate.value, tid, len(layout))
        mine = {r: (tr.malloc(FLAG_BYTES, dev.index), dev.index)
                for r, (p, dev) in enumerate(layout) if p == me}
        tabs.flags, _opened = _shared_ptrs(tr, len(layout),
                                           f"ring/{tid}/flags", mine, card)
    if tabs.slot_bytes < slot_bytes:
        for handle, dev in tabs.opened:
            tr.unmap(handle, dev)
        mine = {r: (tr.malloc(slot_bytes, dev.index), dev.index)
                for r, (p, dev) in enumerate(layout) if p == me}
        tabs.slots, tabs.opened = _shared_ptrs(
            tr, len(layout), f"ring/{tabs.tid}/slots/{tabs.gen}", mine, card)
        tabs.gen += 1
        tabs.slot_bytes = slot_bytes
    return tabs


def _shared_ptrs(tr, P: int, key: str, mine: dict, card: int) -> tuple:
    """Every rank's pointer of one kind of buffer, and the (handle, card)
    pairs opened: this process's ranks' (``mine``: rank -> (pointer,
    card)) and every other process's, whose IPC handles are exchanged
    under ``key`` and opened on ``card``."""
    got = tr.exchange(key, json.dumps({
        str(r): tr.export(ptr, c).hex() for r, (ptr, c) in mine.items()
    }).encode())
    ptrs, opened = [0] * P, []
    for r, (ptr, _c) in mine.items():
        ptrs[r] = ptr
    for v in got:
        for r, h in json.loads(v).items():
            if int(r) not in mine:
                handle = bytes.fromhex(h)
                ptrs[int(r)] = tr.open(handle, card)
                opened.append((handle, card))
    return ptrs, opened


def _plan_procs(tr, parts, layout: tuple, elem: int, k: int, code: int,
                aligned: bool):
    """(stripes, geometry words, slot bytes) of a cross-process launch,
    from what every process knows: the stripes as many as fit beside the
    most ranks any process holds on one card, on the card with the fewest
    co-resident blocks of any process (exchanged once a layout and
    kernel), and the agreed alignment."""
    rkey = (layout, k, code)
    if rkey not in _proc_resident:
        mine = min(_resident(k, code, dev.index, 2)
                   for p, dev in layout if p == tr.process)
        got = tr.exchange(f"resident/{_digest(rkey)}", str(mine).encode())
        _proc_resident[rkey] = min(int(v) for v in got)
    per: dict = {}
    for p, dev in layout:
        per[(p, str(dev))] = per.get((p, str(dev)), 0) + 1
    tw, ntiles, S = tiling(parts, max(per.values()), elem,
                           _proc_resident[rkey])
    S = min(S, MAX_STRIPES)
    return S, _geometry(parts, tw, ntiles, aligned, 16 // elem), \
        S * 2 * tw * elem


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _launch_procs(kind: str, xs, outs, parts, op: str,
                  layout: tuple) -> None:
    """The cross-process form of :func:`_launch_cross` (module
    docstring): this process's launches, one a card of its ranks, after
    the transport's barrier, its gate opened once every process has
    enqueued.  Counts one launch a card of this process."""
    from ..utils import ipc

    tr = ipc.transport()
    me = tr.process
    wrapper = ring_all_gather if kind == "ag" else ring_reduce_scatter
    what = wrapper.__name__
    P = len(layout)
    mine = [r for r in range(P) if layout[r][0] == me]
    elem, code = xs[mine[0]].element_size(), KERNEL_DTYPES[xs[mine[0]].dtype]
    k = 2 if kind == "ag" else int(op == "max")
    groups: dict = {}
    for r in mine:
        groups.setdefault(layout[r][1].index, []).append(r)
    streams = {c: torch.cuda.current_stream(c) for c in groups}
    if device_trace_enabled():
        raise ACCLError(f"{what}: ACCL_DEVICE_TRACE's stamp rows are not "
                        f"landed across processes (unset it)")
    if _capturing_cards(streams):
        raise ACCLError(f"{what}: a launch across processes cannot be "
                        f"captured in a CUDA graph yet (ROADMAP item 13e): "
                        f"each process's gate is opened by its host after "
                        f"every process enqueued")
    enable_peers(list(groups))
    xp = [0] * P
    op_ = [0] * P
    for r in mine:
        xp[r], op_[r] = xs[r].data_ptr(), outs[r].data_ptr()
    aligned = all(a % 16 == 0 for a in xp + op_ if a)
    sig = int(_digest((kind, k, code, tuple(parts), tuple(
        (p, str(d)) for p, d in layout))), 16) >> 1
    for st in streams.values():
        st.synchronize()
    lib = _build.load("ring")
    with _tables_lock:
        tr.launches = seq = getattr(tr, "launches", 0) + 1
        aligned = tr.arrive(seq, sig, aligned, what)
        S, geo, slot_bytes = _plan_procs(tr, parts, layout, elem, k, code,
                                         aligned)
        tabs = _proc_tables_for(tr, layout, streams, slot_bytes)
        slots = (ctypes.c_void_p * P)(*tabs.slots)
        flags = (ctypes.c_void_p * P)(*tabs.flags)
        key_xs = (ctypes.c_void_p * P)(*xp)
        key_outs = (ctypes.c_void_p * P)(*op_)
        gseq = (tabs.seq + 1) & 0xFFFFFFFF
        for c, ranks in groups.items():
            rc = lib.accl_ring_launch_cross(
                k, code, key_xs, key_outs, P,
                (ctypes.c_int * len(ranks))(*ranks), len(ranks), S, geo,
                slots, flags, tabs.gate, _c_int(gseq), None, c,
                streams[c].cuda_stream)
            if rc != 0:
                _gate_word(tabs, 1, 1)
                _proc_tables.pop(_tables_key(layout, streams), None)
                tr.give_up()
                _raise_on(lib, rc, what)
        try:
            tr.enqueued(seq, what)
        except ACCLError:
            _gate_word(tabs, 1, 1)
            _proc_tables.pop(_tables_key(layout, streams), None)
            raise
        tabs.seq = gseq
        _gate_word(tabs, 0, gseq)
    wrapper.launches += len(groups)
    wrapper.launches_cross += len(groups)
    wrapper.launches_procs += len(groups)


def _launch(kind: str, xs, outs, parts, layout: Optional[tuple],
            op: str = "sum", land: bool = True,
            V: Optional[int] = None) -> None:
    """One launch of csrc/ring.cu over ``parts``: kind "rs" (rank r's
    result at chunk r of the result layout) or "ag" (rank r's operand at
    chunk r of the operand layout), over a ring of V = P hops a tile, or
    the self-ring of one rank and V hops.  Counts it on its wrapper.
    Ranks on several cards (``layout``, from :func:`_check`: each rank's
    card, or None when they share one), or under ``rank_tables``, take
    the cross-card mode, one launch per card (``_launch_cross``).
    With the device-trace gate on, launches the stamp instantiation into
    a buffer of its own and, after the stream has run it, lands the rows
    in the collector (which a CUDA graph capture cannot hold: it raises
    there); ``land=False`` drops them unsynchronized, for timing the
    instantiation alone."""
    if layout is None and getattr(_form, "tables", False) \
            and len(xs) > 1 and (V is None or V == len(xs)):
        layout = tuple(t.device.index for t in xs)
    if layout is not None:
        return _launch_cross(kind, xs, outs, parts, op, land, layout)
    return _launch_one(kind, xs, outs, parts, op, land, V)


def _launch_one(kind: str, xs, outs, parts, op: str = "sum",
                land: bool = True, V: Optional[int] = None) -> None:
    """The one-card launch of :func:`_launch`."""
    dev, dt = xs[0].device, xs[0].dtype
    P, elem = len(xs), xs[0].element_size()
    V = P if V is None else V
    code = KERNEL_DTYPES[dt]
    k = 2 if kind == "ag" else int(op == "max")
    xp = [t.data_ptr() for t in xs]
    op_ = [t.data_ptr() for t in outs]
    aligned = all(a % 16 == 0 for a in xp + op_)
    device = dev.index or 0
    stamp = device_trace_enabled()
    S, geo, nbytes = _plan(tuple(parts), P, elem, k, code, device, aligned,
                           stamp)
    stream = torch.cuda.current_stream(dev)
    if stamp and land and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "ring kernels: ACCL_DEVICE_TRACE lands its stamp rows after "
            "a synchronize, which a CUDA graph capture cannot hold; unset "
            "it to capture")
    slots, flags = _scratch_for(dev, stream, nbytes, P * S * 4)
    stamps = None
    if stamp:
        nseg = sum(p.nseg for p in parts)
        stamps = torch.empty(nseg * P * (V - 1) * DEVICE_TRACE_COLS,
                             dtype=torch.int32, device=dev)
    lib = _build.load("ring")
    rc = lib.accl_ring_launch(
        k, code, (ctypes.c_void_p * P)(*xp), (ctypes.c_void_p * P)(*op_), P,
        V, S, geo, slots.data_ptr(), flags.data_ptr(),
        None if stamps is None else stamps.data_ptr(), device,
        stream.cuda_stream)
    wrapper = ring_all_gather if kind == "ag" else ring_reduce_scatter
    _raise_on(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    if V != P:
        wrapper.launches_self += 1
    if stamps is not None:
        wrapper.launches_stamp += 1
        if land:
            stream.synchronize()
            _record_rows(kind, stamps.view(-1, P, V - 1,
                                           DEVICE_TRACE_COLS).cpu())


def _local_check(xs, out, layout, what: str) -> list:
    """:func:`_check` over this process's ranks of a cross-process call;
    returns their indices."""
    mine = [r for r, x in enumerate(xs) if x is not None]
    if out is not None and any((out[r] is None) != (xs[r] is None)
                               for r in range(len(xs))):
        raise ValueError(f"{what}: results None exactly where operands are")
    _check([xs[r] for r in mine], None if out is None else
           [out[r] for r in mine], what)
    return mine


def _reduce_scatter_procs(xs, op, out, layout, devices):
    """:func:`ring_reduce_scatter` across processes."""
    what = "ring_reduce_scatter"
    mine = _local_check(xs, out, layout, what)
    _fold(op)
    P = len(xs)
    x0 = xs[mine[0]]
    if x0.dim() != 2 or x0.shape[0] != P:
        raise ValueError(f"{what}: operands must be [P={P}, n], got "
                         f"{tuple(x0.shape)}")
    n, row = x0.shape[1], x0.stride(0)
    for r in mine:
        if xs[r].shape != x0.shape or xs[r].stride() != (row, 1):
            raise ValueError(f"{what}: operands need one shape and strides "
                             f"(row, 1)")
        if out is not None and (out[r].shape != (n,)
                                or not out[r].is_contiguous()):
            raise ValueError(f"{what}: outputs must be contiguous [{n}]")
    if x0.device.type == "cpu":
        return ring_reduce_scatter_plain(xs, op, out, devices=devices)
    if out is None:
        out = [None if x is None else torch.empty(n, dtype=x.dtype,
                                                  device=x.device)
               for x in xs]
    if n:
        _launch_procs("rs", xs, out, [Part(1, n, 0, 0, row, 0, 0, 0)], op,
                      layout)
    return list(out)


def _all_gather_procs(xs, out, layout, devices):
    """:func:`ring_all_gather` across processes."""
    what = "ring_all_gather"
    mine = _local_check(xs, out, layout, what)
    P = len(xs)
    x0 = xs[mine[0]]
    n = x0.shape[0]
    row = n if out is None else out[mine[0]].stride(0)
    for r in mine:
        if tuple(xs[r].shape) != (n,) or not xs[r].is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous [{n}]")
        if out is not None and (tuple(out[r].shape) != (P, n)
                                or out[r].stride() != (row, 1)):
            raise ValueError(f"{what}: outputs must be [{P}, {n}] with "
                             f"strides (row, 1)")
    if x0.device.type == "cpu":
        return ring_all_gather_plain(xs, out, devices=devices)
    if out is None:
        out = [None if x is None else torch.empty((P, n), dtype=x.dtype,
                                                  device=x.device)
               for x in xs]
    if n:
        _launch_procs("ag", xs, out, [Part(1, n, 0, 0, 0, 0, 0, row)], "sum",
                      layout)
    return list(out)


def ring_reduce_scatter(xs: Sequence[torch.Tensor], op: str = "sum",
                        out: Optional[Sequence[torch.Tensor]] = None,
                        ring_size: Optional[int] = None, devices=None):
    """Ring reduce-scatter: rank r's [P, n] operand (rows may be strided,
    columns contiguous) -> rank r's reduced chunk r, [n].  SUM or MAX.
    With ``ring_size=V`` on one rank (the self-ring mode): [V, n] -> [n],
    x[0] + (x[1] + (... + x[V - 1])).  ``devices``: each rank's device,
    naming the ranks of other processes (module docstring)."""
    procs = _process_layout(xs, devices, "ring_reduce_scatter")
    if procs is not None:
        if ring_size not in (None, len(xs)):
            raise ValueError("ring_reduce_scatter: no self-ring across "
                             "processes")
        return _reduce_scatter_procs(xs, op, out, procs, devices)
    layout = _check(xs, out, "ring_reduce_scatter")
    _fold(op)
    P = len(xs)
    V = _ring_len(P, ring_size)
    shape = tuple(xs[0].shape)
    if len(shape) != 2 or shape[0] != V:
        raise ValueError(f"ring_reduce_scatter: operands must be "
                         f"[{'P' if V == P else 'V'}={V}, n], got {shape}")
    n = shape[1]
    row = xs[0].stride(0)
    strides = (row, 1)
    for x in xs:
        if x.shape != shape or x.stride() != strides:
            raise ValueError("ring_reduce_scatter: operands need one shape "
                             "and strides (row, 1)")
    if out is not None:
        for o in out:
            if o.shape != (n,) or not o.is_contiguous():
                raise ValueError("ring_reduce_scatter: outputs must be "
                                 f"contiguous [{n}]")
    if xs[0].device.type == "cpu":
        _trace_plain("rs", P, [n], xs[0].element_size(), V)
        return ring_reduce_scatter_plain(xs, op, out, ring_size)
    if out is None:
        out = [torch.empty(n, dtype=x.dtype, device=x.device) for x in xs]
    if V == 1:
        out[0].copy_(xs[0][0])
        return list(out)
    if n:
        _launch("rs", xs, out, [Part(1, n, 0, 0, row, 0, 0, 0)], layout, op,
                V=V)
    return list(out)


ring_reduce_scatter.launches = 0
#: the launches of the device-trace instantiation, within ``launches``
ring_reduce_scatter.launches_stamp = 0
#: the launches in the self-ring mode, within ``launches``
ring_reduce_scatter.launches_self = 0
#: the launches in the cross-card mode (one per card), within ``launches``
ring_reduce_scatter.launches_cross = 0
#: the launches across processes (one per card of this process), within
#: ``launches_cross``
ring_reduce_scatter.launches_procs = 0


def ring_all_gather(xs: Sequence[torch.Tensor],
                    out: Optional[Sequence[torch.Tensor]] = None,
                    ring_size: Optional[int] = None, devices=None):
    """Ring all-gather: rank r's contiguous [n] -> [P, n] on every rank
    (output rows may be strided, columns contiguous).  With
    ``ring_size=V`` on one rank (the self-ring mode): [n] -> [V, n], the
    operand in every row.  ``devices``: as for
    :func:`ring_reduce_scatter`."""
    procs = _process_layout(xs, devices, "ring_all_gather")
    if procs is not None:
        if ring_size not in (None, len(xs)):
            raise ValueError("ring_all_gather: no self-ring across "
                             "processes")
        return _all_gather_procs(xs, out, procs, devices)
    layout = _check(xs, out, "ring_all_gather")
    P = len(xs)
    V = _ring_len(P, ring_size)
    n = xs[0].shape[0]
    for x in xs:
        if tuple(x.shape) != (n,) or not x.is_contiguous():
            raise ValueError(f"ring_all_gather: operands must be contiguous "
                             f"[{n}]")
    row = n
    if out is not None:
        row = out[0].stride(0)
        for o in out:
            if tuple(o.shape) != (V, n) or o.stride() != (row, 1):
                raise ValueError(f"ring_all_gather: outputs must be [{V}, "
                                 f"{n}] with strides (row, 1)")
    if xs[0].device.type == "cpu":
        _trace_plain("ag", P, [n], xs[0].element_size(), V)
        return ring_all_gather_plain(xs, out, ring_size)
    if out is None:
        out = [torch.empty((V, n), dtype=x.dtype, device=x.device)
               for x in xs]
    if V == 1:
        out[0][0].copy_(xs[0])
        return list(out)
    if n:
        _launch("ag", xs, out, [Part(1, n, 0, 0, 0, 0, 0, row)], layout,
                V=V)
    return list(out)


ring_all_gather.launches = 0
ring_all_gather.launches_stamp = 0
ring_all_gather.launches_self = 0
ring_all_gather.launches_cross = 0
ring_all_gather.launches_procs = 0


def _phases(plain: bool, ring_size: Optional[int] = None, devices=None):
    """(reduce-scatter, all-gather): the kernel wrappers, or with
    ``plain=True`` the plain versions on any device (how chip_smoke.py
    composes the reference result on the card); each called with
    ``ring_size`` and ``devices``."""
    rs, ag = ((ring_reduce_scatter_plain, ring_all_gather_plain) if plain
              else (ring_reduce_scatter, ring_all_gather))
    return (functools.partial(rs, ring_size=ring_size, devices=devices),
            functools.partial(ag, ring_size=ring_size, devices=devices))


def ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum",
                    out: Optional[Sequence[torch.Tensor]] = None,
                    plain: bool = False, ring_size: Optional[int] = None,
                    devices=None):
    """Ring allreduce = ring reduce-scatter then ring all-gather.
    Per rank [P * n] -> the same shape, reduced.  With ``ring_size=V`` on
    one rank (the self-ring mode): [V * n] -> the V chunks' fold, tiled V
    times.  ``devices``: as for :func:`ring_reduce_scatter` (``None`` for
    the operands and results of other processes' ranks)."""
    P = len(xs)
    V = _ring_len(P, ring_size)
    if V == 1:
        return [xs[0].clone()] if out is None else [out[0].copy_(xs[0])]
    rs, ag = _phases(plain, ring_size, devices)
    n = next(x for x in xs if x is not None).shape[0] // V

    def view(ts):
        return [t if t is None else t.view(V, n) for t in ts]

    mine = rs(view(xs), op)
    gathered = ag(mine, None if out is None else view(out))
    return [g if g is None else g.reshape(-1) for g in gathered]


# ---------------------------------------------------------------------------
# segmentation drivers (twins of accl_tpu/ops/ring.py:450-528): the same
# segment lengths, so each element lands in the same rank's chunk and is
# folded in the same order.  On the card each phase is one launch that
# walks every segment.  CPU tensors, and ``plain=True`` on any device,
# compose the plain versions segment by segment with the reference's
# zero-padded ragged tail: the reference result chip_smoke.py holds the
# card's against.
# ---------------------------------------------------------------------------
def _span(t: torch.Tensor):
    """[first, last) byte address a contiguous tensor covers."""
    a = t.data_ptr()
    return a, a + t.numel() * t.element_size()


def alias_fault(xs, outs, in_place: bool = False) -> Optional[str]:
    """Why the kernels may not write the flat results ``outs`` while they
    read the flat operands ``xs``, or None.  A launch reads every rank's
    operand and writes every rank's result, so each result must be
    disjoint from every operand and every other result.  The one
    exception, with ``in_place`` (the allreduce): a result may be exactly
    its own rank's operand, because the last read of each element and
    its write are one thread's, and the all-gather runs in a later
    launch."""
    spans = [_span(t) for t in xs]
    P = len(spans)
    for r, o in enumerate(outs):
        a, b = _span(o)
        for q, (c, d) in enumerate(spans):
            if a < d and c < b and a < b and not (
                    in_place and q == r and (a, b) == (c, d)):
                kind = "operand" if q < P else "result"
                return f"rank {r}'s result overlaps rank {q % P}'s {kind}"
        spans.append((a, b))
    return None


def _flat_check(xs, out, what: str, out_len: int,
                in_place: bool = False) -> Optional[tuple]:
    """:func:`_check` for flat operands and results; returns its layout."""
    layout = _check(xs, out, what)
    n = xs[0].shape[0]
    for x in xs:
        if x.dim() != 1 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous [{n}]")
    for o in out or ():
        if tuple(o.shape) != (out_len,) or not o.is_contiguous():
            raise ValueError(f"{what}: results must be contiguous "
                             f"[{out_len}]")
    fault = alias_fault(xs, out or (), in_place)
    if fault:
        raise ValueError(f"{what}: {fault}")
    return layout


def _segments_plain(xs, op, seg_elems):
    P = len(xs)
    N = xs[0].shape[0]
    seg = max(P, (min(seg_elems, N) // P) * P)
    outs = [torch.empty_like(x) for x in xs]
    off = 0
    while off < N:
        s = min(seg, N - off)
        padded = -(-s // P) * P
        for kind in ("rs", "ag"):
            _trace_plain(kind, P, [padded // P], xs[0].element_size())
        if padded == s:
            ring_all_reduce([x[off:off + s] for x in xs], op,
                            out=[o[off:off + s] for o in outs], plain=True)
        else:
            pieces = []
            for x in xs:
                p = x.new_zeros(padded)
                p[:s] = x[off:off + s]
                pieces.append(p)
            for o, r in zip(outs, ring_all_reduce(pieces, op, plain=True)):
                o[off:off + s] = r[:s]
        off += s
    return outs


def segment_parts(n: int, seg_elems: int, row: int, kind: str):
    """The reference's segments of a flat all-gather or reduce-scatter
    (accl_tpu/ops/ring.py:486-528): whole segments of min(seg_elems, n)
    columns, then the rest; ``row`` is the stride of the [P, n] side (the
    result of the all-gather, the operand of the reduce-scatter)."""
    seg = min(seg_elems, n)
    nfull, rem = divmod(n, seg)
    ag = kind == "ag"
    parts = []
    if nfull:
        parts.append(Part(nfull, seg, 0, seg, 0 if ag else row, 0, seg,
                          row if ag else 0))
    if rem:
        off = nfull * seg
        parts.append(Part(1, rem, off, 0, 0 if ag else row, off, 0,
                          row if ag else 0))
    return parts


def _into(out, results):
    if out is None:
        return results
    for o, r in zip(out, results):
        o.copy_(r)
    return list(out)


def ring_all_reduce_segmented(xs: Sequence[torch.Tensor], op: str = "sum",
                              seg_elems: int = DEFAULT_SEG_ELEMS,
                              plain: bool = False,
                              out: Optional[Sequence[torch.Tensor]] = None):
    """Flat per-rank [N] -> [N] allreduced, segment by segment; the last
    segment is ragged.  ``out`` may be the operands themselves, or
    results disjoint from every operand (``alias_fault``)."""
    P = len(xs)
    N = xs[0].shape[0]
    layout = _flat_check(xs, out, "ring_all_reduce_segmented", N,
                         in_place=True)
    _fold(op)
    if P == 1:
        return _into(out, [xs[0].clone()])
    if plain or xs[0].device.type == "cpu":
        return _into(out, _segments_plain(xs, op, seg_elems))
    if out is None:
        out = [torch.empty_like(x) for x in xs]
    if N == 0:
        return list(out)
    parts = allreduce_parts(N, P, seg_elems)
    _launch("rs", xs, out, parts, layout, op)
    _launch("ag", out, out, parts, layout)
    return list(out)


def ring_all_gather_segmented(xs: Sequence[torch.Tensor],
                              seg_elems: int = DEFAULT_SEG_ELEMS,
                              plain: bool = False,
                              out: Optional[Sequence[torch.Tensor]] = None):
    """Flat per-rank [n] -> [P * n] (rank-major).  Segments do not change
    which rank owns an element here, so on the card and the CPU this is
    one all-gather into the [P, n] view of each result; ``plain=True``
    gathers segment by segment.  Results must be disjoint from every
    operand and from each other."""
    P = len(xs)
    n = xs[0].shape[0]
    layout = _flat_check(xs, out, "ring_all_gather_segmented", P * n)
    if P == 1:
        return _into(out, [xs[0].clone()])
    if out is None:
        out = [x.new_empty(P * n) for x in xs]
    trace = device_trace_enabled()
    if not plain and not trace:
        ring_all_gather(xs, out=[o.view(P, n) for o in out])
        return list(out)
    if not plain and xs[0].device.type == "cuda":
        if n:
            _launch("ag", xs, out, segment_parts(n, seg_elems, n, "ag"),
                    layout)
        return list(out)
    seg = min(seg_elems, n)
    off = 0
    while off < n:
        s = min(seg, n - off)
        ring_all_gather_plain([x[off:off + s] for x in xs],
                              out=[o.view(P, n)[:, off:off + s] for o in out])
        _trace_plain("ag", P, [s], xs[0].element_size())
        off += s
    return list(out)


def ring_reduce_scatter_segmented(xs: Sequence[torch.Tensor], op: str = "sum",
                                  seg_elems: int = DEFAULT_SEG_ELEMS,
                                  plain: bool = False,
                                  out: Optional[Sequence[torch.Tensor]] = None):
    """Flat per-rank [P * n] (rank-major) -> that rank's reduced [n].  As
    for the all-gather, one reduce-scatter of the [P, n] views;
    ``plain=True`` folds segment by segment.  Results must be disjoint
    from every operand and from each other."""
    P = len(xs)
    n = xs[0].shape[0] // P
    layout = _flat_check(xs, out, "ring_reduce_scatter_segmented", n)
    _fold(op)
    if P == 1:
        return _into(out, [xs[0].clone()])
    if out is None:
        out = [x.new_empty(n) for x in xs]
    trace = device_trace_enabled()
    if not plain and not trace:
        return ring_reduce_scatter([x.view(P, n) for x in xs], op, out=out)
    if not plain and xs[0].device.type == "cuda":
        if n:
            _launch("rs", xs, out, segment_parts(n, seg_elems, n, "rs"),
                    layout, op)
        return list(out)
    seg = min(seg_elems, n)
    off = 0
    while off < n:
        s = min(seg, n - off)
        ring_reduce_scatter_plain([x.view(P, n)[:, off:off + s] for x in xs],
                                  op, out=[o[off:off + s] for o in out])
        _trace_plain("rs", P, [s], xs[0].element_size())
        off += s
    return list(out)
