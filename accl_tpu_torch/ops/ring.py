"""Ring collectives over P ranks held as separate tensors on one device.

Port of ``accl_tpu/ops/ring.py``.  There each rank is a chip and the two
Pallas kernels hop over inter-chip remote DMA, one launch per segment
and phase; here every rank's buffer is a tensor on the same card, and
the two hand-written CUDA kernels in ``csrc/ring.cu`` hop between
regions of its memory through a table of per-rank pointers, one
persistent launch per phase that walks every segment of a call.

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
launch into the reference's segments, so each segment has its rows.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional, Sequence

import torch

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


def stamp_rows(P: int, chunk_bytes: int) -> torch.Tensor:
    """The [P, P - 1, DEVICE_TRACE_COLS] int32 stamp rows of one segment,
    computed from the schedule (the reference's ``_stamp_row``): rank r's
    step s reads r, s, 3s, 3s + 1, 3s + 2, its right and left
    neighbours, and the chunk's bytes sent and received."""
    my = torch.arange(P).view(P, 1).expand(P, P - 1)
    st = torch.arange(P - 1).view(1, P - 1).expand(P, P - 1)
    nb = torch.full((P, P - 1), chunk_bytes)
    return torch.stack([my, st, 3 * st, 3 * st + 1, 3 * st + 2,
                        (my + 1) % P, (my + P - 1) % P, nb, nb],
                       dim=-1).to(torch.int32)


#: the collector's name of each launch kind
_TRACE_NAME = {"rs": "reduce_scatter", "ag": "all_gather"}


def _record_rows(kind: str, rows) -> None:
    """Land [segments, P, P - 1, cols] rows: one record per segment and
    rank."""
    for seg in rows:
        for rank_rows in seg:
            record_device_steps(_TRACE_NAME[kind], rank_rows)


def _trace_plain(kind: str, P: int, widths, elem: int) -> None:
    """With the gate on, record the rows a plain run of segments of these
    chunk widths stands for."""
    if P > 1 and device_trace_enabled():
        _record_rows(kind, [stamp_rows(P, w * elem) for w in widths if w])



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


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def ring_reduce_scatter_plain(xs: Sequence[torch.Tensor], op: str = "sum",
                              out: Optional[Sequence[torch.Tensor]] = None):
    """Per rank [P, n] -> that rank's reduced [n], hop by hop: acc starts
    as chunk (my - 1); at step s the accumulator arrives from the left and
    acc = x[(my - 2 - s) % P] + arrival."""
    fold = _fold(op)
    P = len(xs)
    acc = [xs[r][(r - 1) % P].clone() for r in range(P)]
    for step in range(P - 1):
        landing = [acc[(r - 1) % P] for r in range(P)]
        acc = [fold(xs[r][(r - 2 - step) % P], landing[r]) for r in range(P)]
    if out is None:
        return acc
    for o, a in zip(out, acc):
        o.copy_(a)
    return list(out)


def ring_all_gather_plain(xs: Sequence[torch.Tensor],
                          out: Optional[Sequence[torch.Tensor]] = None):
    """Per rank [n] -> [P, n], hop by hop: the local block goes to
    out[my]; at step s the newest chunk arrives from the left and is
    placed at out[(my - s - 1) % P]."""
    P = len(xs)
    if out is None:
        out = [x.new_empty((P,) + tuple(x.shape)) for x in xs]
    comm = []
    for r in range(P):
        out[r][r].copy_(xs[r])
        comm.append(xs[r].clone())
    for step in range(P - 1):
        comm = [comm[(r - 1) % P] for r in range(P)]
        for r in range(P):
            out[r][(r - step - 1) % P].copy_(comm[r])
    return list(out)


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
def _check(xs, out, what: str):
    if not 1 <= len(xs) <= MAX_RANKS:
        raise ValueError(f"{what}: {len(xs)} ranks (1..{MAX_RANKS} supported)")
    dev, dt = xs[0].device, xs[0].dtype
    for t in (*xs, *(out or ())):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: every tensor must share device {dev} "
                             f"and dtype {dt}, got {t.device} {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {dev} (cpu or cuda only)")
    if dev.type == "cuda" and dt not in KERNEL_DTYPES:
        raise ValueError(f"{what}: the CUDA kernel takes "
                         f"{sorted(str(d) for d in KERNEL_DTYPES)}, not {dt}")


def _ptrs(ts) -> "ctypes.Array":
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.accl_ring_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def _resident(kind: int, dtype_code: int, device: int,
              stamp: bool = False) -> int:
    """Blocks of one kernel that fit on the card together (cached)."""
    lib = _build.load("ring")
    got = lib.accl_ring_resident(kind, dtype_code, int(stamp), device)
    if got < 0:
        _raise_on(lib, -got, "accl_ring_resident")
    return got


_scratch_lock = threading.Lock()
#: (device, stream) -> [landing slots (bytes), flags (int32, kept zero)]
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream, nbytes: int, nflags: int):
    """The slots and flags of one launch, kept per device and stream and
    reused in stream order; the kernels leave the flags at zero."""
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


def kernel_info(kind: int, dtype: torch.dtype, stamp: bool,
                device: int = 0) -> dict:
    """Registers, local (spill) bytes and blocks per SM of one
    ``ring_kernel`` instantiation (kind 0 reduce-scatter by sum, 1 by
    max, 2 all-gather; ``stamp`` the device-trace one)."""
    lib = _build.load("ring")
    out = (ctypes.c_int * 3)()
    _raise_on(lib, lib.accl_ring_kernel_info(kind, KERNEL_DTYPES[dtype],
                                             int(stamp), device, out),
              "accl_ring_kernel_info")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


@functools.lru_cache(maxsize=256)
def _plan(parts: tuple, P: int, elem: int, k: int, code: int, device: int,
          aligned: bool, stamp: bool = False):
    """(stripes, geometry words, slot bytes) of one launch (cached: a
    driver repeats the same few shapes)."""
    tw, ntiles, S = tiling(parts, P, elem, _resident(k, code, device, stamp))
    return S, _geometry(parts, tw, ntiles, aligned, 16 // elem), \
        P * S * 2 * tw * elem


def _launch(kind: str, xs, outs, parts, op: str = "sum",
            land: bool = True) -> None:
    """One launch of csrc/ring.cu over ``parts``: kind "rs" (rank r's
    result at chunk r of the result layout) or "ag" (rank r's operand at
    chunk r of the operand layout).  Counts it on its wrapper.  With the
    device-trace gate on, launches the stamp instantiation into a buffer
    of its own and, after the stream has run it, lands the rows in the
    collector; ``land=False`` drops them unsynchronized, for timing the
    instantiation alone."""
    dev, dt = xs[0].device, xs[0].dtype
    P, elem = len(xs), xs[0].element_size()
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
    slots, flags = _scratch_for(dev, stream, nbytes, P * S * 4)
    stamps = None
    if stamp:
        nseg = sum(p.nseg for p in parts)
        stamps = torch.empty(nseg * P * (P - 1) * DEVICE_TRACE_COLS,
                             dtype=torch.int32, device=dev)
    lib = _build.load("ring")
    rc = lib.accl_ring_launch(
        k, code, (ctypes.c_void_p * P)(*xp), (ctypes.c_void_p * P)(*op_), P,
        S, geo, slots.data_ptr(), flags.data_ptr(),
        None if stamps is None else stamps.data_ptr(), device,
        stream.cuda_stream)
    wrapper = ring_all_gather if kind == "ag" else ring_reduce_scatter
    _raise_on(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    if stamps is not None:
        wrapper.launches_stamp += 1
        if land:
            stream.synchronize()
            _record_rows(kind, stamps.view(-1, P, P - 1,
                                           DEVICE_TRACE_COLS).cpu())


def ring_reduce_scatter(xs: Sequence[torch.Tensor], op: str = "sum",
                        out: Optional[Sequence[torch.Tensor]] = None):
    """Ring reduce-scatter: rank r's [P, n] operand (rows may be strided,
    columns contiguous) -> rank r's reduced chunk r, [n].  SUM or MAX."""
    _check(xs, out, "ring_reduce_scatter")
    _fold(op)
    P = len(xs)
    shape = tuple(xs[0].shape)
    if len(shape) != 2 or shape[0] != P:
        raise ValueError(f"ring_reduce_scatter: operands must be [P={P}, n], "
                         f"got {shape}")
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
        _trace_plain("rs", P, [n], xs[0].element_size())
        return ring_reduce_scatter_plain(xs, op, out)
    if out is None:
        out = [torch.empty(n, dtype=xs[0].dtype, device=xs[0].device)
               for _ in range(P)]
    if P == 1:
        out[0].copy_(xs[0][0])
        return list(out)
    if n:
        _launch("rs", xs, out, [Part(1, n, 0, 0, row, 0, 0, 0)], op)
    return list(out)


ring_reduce_scatter.launches = 0
#: the launches of the device-trace instantiation, within ``launches``
ring_reduce_scatter.launches_stamp = 0


def ring_all_gather(xs: Sequence[torch.Tensor],
                    out: Optional[Sequence[torch.Tensor]] = None):
    """Ring all-gather: rank r's contiguous [n] -> [P, n] on every rank
    (output rows may be strided, columns contiguous)."""
    _check(xs, out, "ring_all_gather")
    P = len(xs)
    n = xs[0].shape[0]
    for x in xs:
        if tuple(x.shape) != (n,) or not x.is_contiguous():
            raise ValueError(f"ring_all_gather: operands must be contiguous "
                             f"[{n}]")
    row = n
    if out is not None:
        row = out[0].stride(0)
        for o in out:
            if tuple(o.shape) != (P, n) or o.stride() != (row, 1):
                raise ValueError(f"ring_all_gather: outputs must be [{P}, "
                                 f"{n}] with strides (row, 1)")
    if xs[0].device.type == "cpu":
        _trace_plain("ag", P, [n], xs[0].element_size())
        return ring_all_gather_plain(xs, out)
    if out is None:
        out = [torch.empty((P, n), dtype=xs[0].dtype, device=xs[0].device)
               for _ in range(P)]
    if P == 1:
        out[0][0].copy_(xs[0])
        return list(out)
    if n:
        _launch("ag", xs, out, [Part(1, n, 0, 0, 0, 0, 0, row)])
    return list(out)


ring_all_gather.launches = 0
ring_all_gather.launches_stamp = 0


def _phases(plain: bool):
    """(reduce-scatter, all-gather): the kernel wrappers, or with
    ``plain=True`` the plain versions on any device (how chip_smoke.py
    composes the reference result on the card)."""
    if plain:
        return ring_reduce_scatter_plain, ring_all_gather_plain
    return ring_reduce_scatter, ring_all_gather


def ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum",
                    out: Optional[Sequence[torch.Tensor]] = None,
                    plain: bool = False):
    """Ring allreduce = ring reduce-scatter then ring all-gather.
    Per rank [P * n] -> the same shape, reduced."""
    P = len(xs)
    if P == 1:
        return [xs[0].clone()] if out is None else [out[0].copy_(xs[0])]
    rs, ag = _phases(plain)
    n = xs[0].shape[0] // P
    mine = rs([x.view(P, n) for x in xs], op)
    gathered = ag(mine, None if out is None else [o.view(P, n) for o in out])
    return [g.reshape(-1) for g in gathered]


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


def _flat_check(xs, out, what: str, out_len: int, in_place: bool = False):
    _check(xs, out, what)
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
    _flat_check(xs, out, "ring_all_reduce_segmented", N, in_place=True)
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
    _launch("rs", xs, out, parts, op)
    _launch("ag", out, out, parts)
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
    _flat_check(xs, out, "ring_all_gather_segmented", P * n)
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
            _launch("ag", xs, out, segment_parts(n, seg_elems, n, "ag"))
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
    _flat_check(xs, out, "ring_reduce_scatter_segmented", n)
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
            _launch("rs", xs, out, segment_parts(n, seg_elems, n, "rs"), op)
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
