"""Ring collectives over P ranks held as separate tensors on one device.

Port of ``accl_tpu/ops/ring.py``.  There each rank is a chip and the two
Pallas kernels hop over inter-chip remote DMA; here every rank's buffer
is a tensor on the same card, and the two hand-written CUDA kernels in
``csrc/ring.cu`` hop between regions of its memory through a table of
per-rank pointers.

Every function takes a list with one tensor per rank, in ring order.
Beside each kernel wrapper sits its plain PyTorch version, a Python loop
over the same hops with the same chunk indexing.  A wrapper runs the
plain version only when it is given CPU tensors; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its kernel launches
in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build

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


def _stripes(lib, kind: int, dt: torch.dtype, is_max: bool, P: int, n: int,
             device: torch.device) -> int:
    S = lib.accl_ring_stripes(kind, KERNEL_DTYPES[dt], int(is_max), P, n,
                              device.index or 0)
    if S < 0:
        _raise_on(lib, -S, "accl_ring_stripes")
    if S == 0:
        raise RuntimeError(f"ring kernel: {P} ranks do not fit co-resident "
                           f"on this card")
    return S


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
    for x in xs:
        if tuple(x.shape) != shape or x.stride() != (row, 1):
            raise ValueError("ring_reduce_scatter: operands need one shape "
                             "and strides (row, 1)")
    if out is not None:
        for o in out:
            if tuple(o.shape) != (n,) or not o.is_contiguous():
                raise ValueError("ring_reduce_scatter: outputs must be "
                                 f"contiguous [{n}]")
    if xs[0].device.type == "cpu":
        return ring_reduce_scatter_plain(xs, op, out)
    if out is None:
        out = [torch.empty(n, dtype=xs[0].dtype, device=xs[0].device)
               for _ in range(P)]
    if P == 1:
        out[0].copy_(xs[0][0])
        return list(out)
    if n == 0:
        return list(out)
    lib = _build.load("ring")
    dev = xs[0].device
    S = _stripes(lib, 0, xs[0].dtype, op == "max", P, n, dev)
    # scratch may be freed when this returns, before the kernel ends: the
    # caching allocator hands it out again only to work queued after the
    # kernel on this stream
    landing = torch.empty(P * 2 * n, dtype=xs[0].dtype, device=dev)
    flags = torch.empty(P * S * 4, dtype=torch.int32, device=dev)
    rc = lib.accl_ring_reduce_scatter(
        _ptrs(xs), row, _ptrs(out), n, P, KERNEL_DTYPES[xs[0].dtype],
        int(op == "max"), S, landing.data_ptr(), flags.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "ring_reduce_scatter")
    ring_reduce_scatter.launches += 1
    return list(out)


ring_reduce_scatter.launches = 0


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
        return ring_all_gather_plain(xs, out)
    if out is None:
        out = [torch.empty((P, n), dtype=xs[0].dtype, device=xs[0].device)
               for _ in range(P)]
    if P == 1:
        out[0][0].copy_(xs[0])
        return list(out)
    if n == 0:
        return list(out)
    lib = _build.load("ring")
    dev = xs[0].device
    S = _stripes(lib, 1, xs[0].dtype, False, P, n, dev)
    comm = torch.empty(P * 2 * n, dtype=xs[0].dtype, device=dev)
    flags = torch.empty(P * S * 4, dtype=torch.int32, device=dev)
    rc = lib.accl_ring_all_gather(
        _ptrs(xs), _ptrs(out), row, n, P, KERNEL_DTYPES[xs[0].dtype], S,
        comm.data_ptr(), flags.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "ring_all_gather")
    ring_all_gather.launches += 1
    return list(out)


ring_all_gather.launches = 0


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
# segment lengths and ragged-tail padding, so each element lands in the
# same rank's chunk and is folded in the same order.  One launch per
# segment and phase.
# ---------------------------------------------------------------------------
def ring_all_reduce_segmented(xs: Sequence[torch.Tensor], op: str = "sum",
                              seg_elems: int = DEFAULT_SEG_ELEMS,
                              plain: bool = False):
    """Flat per-rank [N] -> [N] allreduced; the last segment is padded up
    to a multiple of P."""
    P = len(xs)
    if P == 1:
        return [xs[0].clone()]
    N = xs[0].shape[0]
    seg = max(P, (min(seg_elems, N) // P) * P)
    outs = [torch.empty_like(x) for x in xs]
    off = 0
    while off < N:
        s = min(seg, N - off)
        padded = -(-s // P) * P
        if padded == s:
            ring_all_reduce([x[off:off + s] for x in xs], op,
                            out=[o[off:off + s] for o in outs], plain=plain)
        else:
            pieces = []
            for x in xs:
                p = x.new_zeros(padded)
                p[:s] = x[off:off + s]
                pieces.append(p)
            for o, r in zip(outs, ring_all_reduce(pieces, op, plain=plain)):
                o[off:off + s] = r[:s]
        off += s
    return outs


def ring_all_gather_segmented(xs: Sequence[torch.Tensor],
                              seg_elems: int = DEFAULT_SEG_ELEMS,
                              plain: bool = False):
    """Flat per-rank [n] -> [P * n] (rank-major), segmented; each segment
    gathers straight into its columns of the [P, n] result."""
    P = len(xs)
    if P == 1:
        return [xs[0].clone()]
    n = xs[0].shape[0]
    seg = min(seg_elems, n)
    outs = [x.new_empty(P * n) for x in xs]
    off = 0
    while off < n:
        s = min(seg, n - off)
        _phases(plain)[1]([x[off:off + s] for x in xs],
                          out=[o.view(P, n)[:, off:off + s] for o in outs])
        off += s
    return outs


def ring_reduce_scatter_segmented(xs: Sequence[torch.Tensor], op: str = "sum",
                                  seg_elems: int = DEFAULT_SEG_ELEMS,
                                  plain: bool = False):
    """Flat per-rank [P * n] (rank-major) -> that rank's reduced [n],
    segmented along the per-rank chunk dimension."""
    P = len(xs)
    if P == 1:
        return [xs[0].clone()]
    n = xs[0].shape[0] // P
    seg = min(seg_elems, n)
    outs = [x.new_empty(n) for x in xs]
    off = 0
    while off < n:
        s = min(seg, n - off)
        _phases(plain)[0]([x.view(P, n)[:, off:off + s] for x in xs], op,
                          out=[o[off:off + s] for o in outs])
        off += s
    return outs
