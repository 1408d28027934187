"""CUDA backend: each rank's buffers are tensors on its device, every
rank on one card or, with ``devices=``, each on a card of its own.

Port of ``accl_tpu/backends/tpu.py``.  Each rank holds a normal
:class:`~accl_tpu_torch.accl.ACCL` handle and submits call descriptors; a
world-level gang scheduler (:class:`CudaEngine`) pairs up the
descriptors of one collective instance across ranks and runs the
collective for the whole gang: inline on the last-arriving rank's thread
when every member blocks on it (leader dispatch), or on the executor
thread.  Payloads of allreduce / allgather / reduce-scatter at or above
``ACCL_RING_THRESHOLD`` bytes (default 4 MiB) go through the segmented
ring drivers to the hand-written CUDA ring kernels (ops/ring.py); below
it plain torch ops over the gang's operands do the work, in the lane
order of the JAX engine's ``_collective_fn``.  A descriptor marked
``fused`` takes those three collectives at any size to the chunked ring
lane (ops/fused.py); the int8 block-scaled wire spec takes the ring lane
to the quantized ring (ops/quantized.py), and the fused lane to its
quantized chunks.

The kernels take a table of per-rank device pointers, so operands that
are whole buffers of the gang's dtype reach them without a copy.

Ranks on several cards (``CudaWorld(P, devices=[...])``, the twin of
``TpuWorld(P, devices=)``, tpu.py:231-241 and :2484): rank r's buffers,
operand queue, results and events live on ``devices[r]``, one card may
hold several ranks, and every pair of cards must have peer access (the
world raises naming a pair without it; nothing is staged through the
host).  The ring lane runs the kernels' cross-card mode (one launch per
card, ops/ring.py).  The torch-op lanes keep their arithmetic and fold
order: an operand that meets another rank's crosses to that rank's card
by one explicit copy, and each rank's result lands on its own card,
through :meth:`CudaEngine._move`, the one point where a tensor goes from
one rank to another (``peer_moves`` counts them).  The fused lane and
the int8 ring lane are rings across the cards, as the reference's
``ppermute`` lanes are: each rank quantizes and folds on its own card,
and only one hop's carry crosses to the right neighbour (each fused
chunk's accumulator, or its int8 ``(q, scale)``; ops/fused.py,
ops/quantized.py), so no card holds another rank's operand.  The plain
reductions and gathers below the ring threshold (the int8 and cast
roundtrip lanes among them) gather the operands on one hub rank's card
(the root, else the comm's first member) and send each rank its result
from there; a broadcast moves along its binomial tree; an alltoall moves
each block straight to its receiver; a send moves its payload once, to
the receiver.  With ``devices`` left out the engine takes the one-card
path, with no move at all.

Observability, as in tpu.py: each request's flight record and span are
stamped at gang-ready and at dispatch, with the lane that ran it
(``leader``, ``executor``, ``local``, ``p2p``); the engine's own
:class:`MetricsRegistry` counts the dispatch lanes; a link twin
accounts the bytes each gang's schedule moves per rank pair (at the
compressed width on the wire lanes) and the gang-assembly wait; a
:class:`Watchdog` over the world's flight recorders names the missing
ranks of a stuck gang (``gang_assembly_snapshot``); under
``ACCL_TELEMETRY_INTERVAL_MS`` a :class:`TelemetrySampler` publishes the
engine stats and link rows, and ``CudaWorld.link_matrix`` folds the rows
into the P x P matrix of a communicator or a tenant.  A launch returns at
enqueue, so while tracing is on the engine synchronizes the stream after
a gang's program and only then stamps ``t_device_end`` (and lands the
ring kernels' device-trace rows); with tracing off it adds no
synchronize.

Persistent plans (plans.py, tpu.py:187-1428): ``arm_plan`` pairs the
ranks' captured descriptor streams into one :class:`PlanRing` of pinned
slots (gang programs with their operand and result views, pre-paired
p2p moves, local ops); a replay is a generation bump whose last-arriving
rank runs every slot inline, on the card's current stream, under the
engine's one-program-at-a-time claim.  An operand that is a copy (a
widened dtype, a padded bcast placeholder) is rebuilt on every replay.
Batched dispatch (tpu.py:1534-1675): the executor extends a popped
gang with up to ``_BATCH_CAP`` - 1 queued gangs of the same program and
no read-after-write on a (rank, address), and runs them back to back
under one claim (no fusion into one program, as JAX compiles them);
ring-lane gangs and ``profile_sync`` never batch.

Resilience (tpu.py:883-987): ``abort_comm`` marks a communicator
aborted (later submits, plan arms and replays on it are refused), bumps
its fence generation, fences its plan rings and completes its partial
gangs and pending receives with the abort bits; complete gangs already
queued run to the end.  ``rebuild_gang_tables`` does the same drain for
a grow, ``export_join_state`` and ``comm_count`` answer a joiner, and
``reset_comm_errors`` clears the fences.  With
``ACCL_WATCHDOG_ACTION=abort`` the watchdog aborts a hung communicator
from a rank that arrived at its gang (``CudaWorld._watchdog_abort``).

Kernel streams (tpu.py:353-357, 493-660, 1740-1995): each rank has an
operand queue (``push_krnl`` puts the operand on the device as a tensor)
and output streams keyed (rank, stream id), fed through one delivery
point, ``_push_stream``; ``pop_stream`` returns the message's bytes.  An
``OP0_STREAM`` collective reserves its operand in the submitting rank's
own thread, so two stream calls issued back to back on one rank pair
with their operands in call order; a short operand completes with
``SEGMENTER_EXPECTED_BTT_ERROR``.  Stream gangs run through the same gang
plans, ring drivers and kernels as buffer gangs, never batch, and have
no plan slot.  On the card the joins are explicit: a pushed operand
carries the event of its host-to-device copy, which the launching stream
waits on; a delivered result carries the event recorded after its
program, which ``pop_stream`` synchronizes before it copies the result
back.  A stream call under CUDA graph capture raises.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..accl import ACCL
from ..arithconfig import (
    COMPRESSOR_WIRE_DTYPE,
    DEFAULT_COMPRESS_BLOCK,
    ArithConfig,
)
from ..buffer import BaseBuffer
from ..communicator import Communicator, Rank
from ..constants import (
    TAG_ANY,
    ACCLError,
    CCLOCall,
    CompressionFlags,
    ErrorCode,
    Operation,
    ReduceFunction,
    StreamFlags,
    TuningKey,
    env_int,
)
from ..ops import fused as fused_ops
from ..ops import quantized as q_ops
from ..observability import flight as _flight
from ..observability import health as _health
from ..observability import metrics as _metrics
from ..observability import telemetry as _telemetry
from ..observability import trace as _trace
from ..observability.telemetry import LINK_COUNTER_FIELDS
from ..ops import ring as ring_ops
from ..request import Request
from ..utils.device import resolve_device, resolve_devices
from ..utils.logging import get_logger
from .base import CCLODevice

#: address quantum: a buffer's handle space is its byte size rounded up
#: to whole quanta (plus one, so the end address of a slice still
#: resolves to it), so sub-range addresses of buffers of any size resolve
#: to the right buffer
_ADDR_STRIDE = 1 << 20


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class CudaBuffer(BaseBuffer):
    """Host numpy array paired with a tensor on the engine's device (the
    FPGABuffer analog: host map + device allocation)."""

    def __init__(self, host: np.ndarray, device: torch.device, address: int,
                 engine: Optional["CudaEngine"] = None, rank: int = 0):
        super().__init__(host, address)
        self._engine = engine
        self._rank = rank
        # own storage, never an alias of the host array (on the CPU
        # torch.from_numpy would alias it and let un-synced host writes
        # leak into "device" state; tpu.py:76-81 copies for the same
        # reason).  It starts zeroed, as the host array create_buffer
        # makes; contents move only through the syncs below.
        self._dev = torch.zeros(host.shape[0], dtype=torch_dtype(host.dtype),
                                device=device)

    @property
    def dev(self) -> torch.Tensor:
        return self._dev

    def sync_to_device(self) -> None:
        self._dev.copy_(torch.from_numpy(self._host))

    def sync_from_device(self) -> None:
        # .cpu() waits for the work queued on the tensor's stream
        self._host[:] = self._dev.cpu().numpy()

    def slice(self, start: int, end: int) -> "BaseBuffer":
        return _CudaBufferSlice(self, start, end)

    def free(self) -> None:
        """Drop the buffer from its engine (and the gang plans that hold
        it), so its memory goes with the last reference: what a sweep
        that makes buffers per call needs.  A plan ring that holds it
        keeps it until the plan is closed."""
        if self._engine is not None:
            self._engine.free_buffer(self._rank, self)
            self._engine = None


class _CudaBufferSlice(BaseBuffer):
    """Sub-span view used by the driver's partial sync."""

    def __init__(self, parent: CudaBuffer, start: int, end: int):
        super().__init__(parent.host[start:end],
                         parent.address + start * parent.host.itemsize)
        self._parent = parent
        self._start = start
        self._end = end

    def sync_to_device(self) -> None:
        self._parent.dev[self._start:self._end].copy_(
            torch.from_numpy(self._parent.host[self._start:self._end]))

    def sync_from_device(self) -> None:
        self._parent.host[self._start:self._end] = \
            self._parent.dev[self._start:self._end].cpu().numpy()

    def slice(self, start: int, end: int) -> "BaseBuffer":
        return _CudaBufferSlice(self._parent, self._start + start,
                                self._start + end)


def _parse_wire_spec(wire_dtype: str):
    """Decode a wire spec: (name, block, error_feedback).  The cast lanes
    are ("float16" | "bfloat16", 0, False); an "int8:<block>:<ef>" spec
    names the block-scaled lane."""
    if wire_dtype.startswith("int8"):
        parts = wire_dtype.split(":")
        block = int(parts[1]) if len(parts) > 1 else DEFAULT_COMPRESS_BLOCK
        return "int8", block, len(parts) > 2 and parts[2] == "1"
    return wire_dtype, 0, False


_WIRE_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _wire_roundtrip(x: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """One wire hop of compression: the payload crosses in the config's
    compressed representation and is widened on arrival — a cast pair
    (round to nearest even, as in the JAX engine) for the f16/bf16
    lanes, a blockwise quantize/dequantize for the int8 lane (its scale
    is absmax * f32(1/127), as XLA compiles the JAX engine's, so a second
    roundtrip can move a block's values by an ulp there and here
    alike)."""
    if not wire_dtype:
        return x
    name, block, _ef = _parse_wire_spec(wire_dtype)
    if name == "int8":
        if x.element_size() <= 1:
            return x
        q, sc, n = q_ops.quantize_blockwise(x.reshape(-1), block)
        return q_ops.dequantize_blockwise(q, sc, n).reshape(x.shape).to(
            x.dtype)
    if name not in _WIRE_TORCH:
        raise ACCLError(f"wire lane {name!r} is not part of accl_tpu_torch yet")
    wd = _WIRE_TORCH[name]
    if x.element_size() > wd.itemsize:
        return x.to(wd).to(x.dtype)
    return x


def _tree_bcast(vs: list, root: int,
                place: Optional[Callable] = None) -> list:
    """Binomial-tree broadcast (the schedule of tpu.py:2038): log2(P)
    rounds of doubling senders; each rank receives the payload once, by
    ``place(t, src, dst)`` when the ranks sit on several cards."""
    P = len(vs)
    vs = list(vs)
    k = 1
    while k < P:
        for j in range(k):
            if j + k < P:
                src, dst = (root + j) % P, (root + j + k) % P
                vs[dst] = vs[src] if place is None else place(vs[src], src,
                                                               dst)
        k *= 2
    return vs


def _tree_gather(vs: list, root: int) -> torch.Tensor:
    """Binomial-tree gather (the schedule of tpu.py:2060): blocks double
    each round toward the root; the rel-ordered accumulator is rolled to
    global rank order at the end.  Returns the root's [P * n]."""
    P = len(vs)
    n = vs[0].shape[0]
    # acc[rel] holds the rel-ordered blocks rank (root + rel) has so far
    acc = {rel: [vs[(root + rel) % P]] for rel in range(P)}
    k = 1
    while k < P:
        for j in range(0, P, 2 * k):
            if j + k < P:
                acc[j] = acc[j] + acc.pop(j + k)
        k *= 2
    return torch.roll(torch.cat(acc[0]), root * n)


def _mark_spans(gang: dict, lane: Optional[str] = None,
                t_ready: Optional[int] = None,
                t_dispatch: Optional[int] = None,
                t_dev0: Optional[int] = None,
                t_dev1: Optional[int] = None) -> None:
    """Stamp a gang's member spans with scheduler events (tpu.py:147;
    a no-op per member whose request has no span)."""
    for _call, req in gang.values():
        span = req.trace
        if span is None:
            continue
        if lane is not None:
            span.lane = lane
        if t_ready is not None:
            span.t_gang_ready = t_ready
        if t_dispatch is not None:
            span.t_dispatch = t_dispatch
        if t_dev0 is not None:
            span.t_device_begin = t_dev0
        if t_dev1 is not None:
            span.t_device_end = t_dev1


def _observing() -> bool:
    """Whether the link twin counts: while the metrics registry or the
    flight recorder, its readers, is on (ACCL_METRICS, ACCL_FLIGHT).  With
    both off the engine skips it, and the link rows read what was counted
    before."""
    return _metrics.enabled() or _flight.enabled()


def _mark_flight(gang: dict, state: int, lane: Optional[str] = None,
                 t: Optional[int] = None) -> None:
    """Stamp a gang's member flight records with one state transition
    (tpu.py:170): a few attribute writes per member, while the flight
    recorder is on."""
    if not _flight.enabled():
        return
    for _call, req in gang.values():
        rec = req.flight
        if rec is None:
            continue
        if state == _flight.S_DISPATCHED:
            rec.mark_dispatched(lane, t)
        else:
            rec.state = state
            if state == _flight.S_GANG_READY and t is not None:
                rec.t_gang_ready = t


def _collective_program(op: Operation, nranks: int, in_len: int, root: int,
                        func: int, wire_dtype: str, ring: bool,
                        fused: bool, place: Optional[Callable] = None
                        ) -> Callable:
    """The program that takes the place of the JAX engine's
    ``_collective_fn`` (tpu.py:2100): a function from the gang's per-rank
    operands ([in_len] each, rank order) to the per-rank results, in the
    same lane order — the fused lane when the descriptor asks for it, the
    quantized ring for the int8 wire spec on the ring lane, the ring
    drivers at or above the threshold, plain torch ops over the rank axis
    below it.

    ``place(t, src, dst)`` (local ranks) is given when the gang's ranks
    sit on several cards: every torch-op lane then moves each operand it
    combines, and each result it hands out, through it (module
    docstring), and computes exactly what it computes on one card; the
    fused and quantized rings move only each hop's carry through it."""
    n = in_len // nranks if op in (Operation.scatter, Operation.reduce_scatter,
                                   Operation.alltoall) else in_len
    is_max = func == int(ReduceFunction.MAX)
    red = "max" if is_max else "sum"
    wire_name, wire_block, wire_ef = _parse_wire_spec(wire_dtype)
    # the quantized ring owns its wire hops: SUM only, and the payload
    # must divide into the ring; MAX and ragged payloads take the
    # roundtrip model around the plain ring (tpu.py:2146-2171)
    q_ring = (ring and wire_name == "int8" and not is_max
              and op in (Operation.allreduce, Operation.allgather,
                         Operation.reduce_scatter)
              and in_len % nranks == 0)
    # the fused lane's int8 twin quantizes inside its chunk loop
    fused_q = fused and wire_name == "int8" and not is_max

    def quant(v):
        return _wire_roundtrip(v, wire_dtype)

    def reduce_all(vs):
        stacked = torch.stack(vs)
        return stacked.amax(0) if is_max else stacked.sum(0)

    def q_ring_body(vs: list) -> list:
        if op == Operation.allreduce:
            return q_ops.quantized_all_reduce(vs, wire_block, wire_ef,
                                              place=place)
        if op == Operation.allgather:
            return q_ops.quantized_ring_all_gather(vs, wire_block,
                                                   place=place)
        return q_ops.quantized_ring_reduce_scatter(vs, wire_block, wire_ef,
                                                   place=place)

    def fused_body(vs: list) -> list:
        # the fused lane owns its wire hops end to end: int8 inside the
        # chunk loop, the cast lanes roundtrip at the endpoints
        # (tpu.py:2177-2199)
        if fused_q:
            w = (wire_block, wire_ef)
            vf = [v.to(torch.float32) for v in vs]  # each on its own card
            if op == Operation.allreduce:
                outs = fused_ops.chunked_ring_all_reduce(vf, wire=w,
                                                         place=place)
            elif op == Operation.allgather:
                outs = fused_ops.chunked_ring_all_gather(vf, wire=w,
                                                         place=place)
            else:
                outs = fused_ops.chunked_ring_reduce_scatter(vf, wire=w,
                                                             place=place)
            return [o.to(vs[0].dtype) for o in outs]
        vs = [quant(v) for v in vs]
        if op == Operation.allreduce:
            outs = fused_ops.chunked_ring_all_reduce(vs, red, place=place)
        elif op == Operation.allgather:
            outs = fused_ops.chunked_ring_all_gather(vs, place=place)
        else:
            outs = fused_ops.chunked_ring_reduce_scatter(vs, red,
                                                         place=place)
        return [quant(o) for o in outs]

    # ranks on several cards (``place`` given): the same arithmetic, with
    # every crossing made explicit; the fused and quantized rings hop from
    # card to card through ``place`` themselves; below the threshold the
    # hub is the rank whose card combines
    hub = root if op in (Operation.reduce, Operation.gather,
                         Operation.scatter) else 0

    def move(t, src: int, dst: int):
        return t if place is None or src == dst else place(t, src, dst)

    def gather(vs: list, to: int) -> list:
        return vs if place is None else [move(v, r, to)
                                         for r, v in enumerate(vs)]

    def scatter(ys: list, frm: int) -> list:
        return ys if place is None else [move(y, frm, r)
                                         for r, y in enumerate(ys)]

    def body(vs: list, outs: Optional[list] = None) -> list:
        """``outs``: per-rank result views the ring drivers may write
        into directly (lossless ring lane only, see ``_direct_outs``)."""
        if fused:
            return fused_body(vs)
        if q_ring:
            dt = vs[0].dtype
            return [o.to(dt) for o in q_ring_body(
                [v.to(torch.float32) for v in vs])]
        vs = [quant(v) for v in vs]
        if ring:  # across cards the kernels' cross-card mode moves each hop
            if op == Operation.allreduce:
                outs = ring_ops.ring_all_reduce_segmented(vs, red, out=outs)
            elif op == Operation.allgather:
                outs = ring_ops.ring_all_gather_segmented(vs, out=outs)
            else:
                outs = ring_ops.ring_reduce_scatter_segmented(vs, red,
                                                              out=outs)
        elif op in (Operation.allreduce, Operation.reduce):
            total = reduce_all(gather(vs, hub))
            outs = ([total] * nranks if op == Operation.reduce
                    else scatter([total] * nranks, hub))
        elif op == Operation.bcast:
            outs = _tree_bcast(vs, root, place)
        elif op == Operation.gather:
            outs = [_tree_gather(gather(vs, hub), root)] * nranks
        elif op == Operation.allgather:
            outs = scatter([torch.cat(gather(vs, hub))] * nranks, hub)
        elif op == Operation.scatter:
            # only the root's operand matters: mask the rest to zero (made
            # on the root's card) and reduce-scatter, as the JAX lowering
            # does
            masked = [vs[root] if r == root else torch.zeros_like(vs[root])
                      for r in range(nranks)]
            total = torch.stack(masked).sum(0)
            outs = scatter([total[r * n:(r + 1) * n]
                            for r in range(nranks)], hub)
        elif op == Operation.reduce_scatter:
            # SUM: reduce then slice; MAX: reduce fully, keep own chunk
            total = reduce_all(gather(vs, hub))
            outs = scatter([total[r * n:(r + 1) * n]
                            for r in range(nranks)], hub)
        elif op == Operation.alltoall:
            outs = [torch.cat([move(v[r * n:(r + 1) * n], s_, r)
                               for s_, v in enumerate(vs)])
                    for r in range(nranks)]
        else:
            raise ACCLError(f"collective {op.name} not lowered")
        return [quant(o) for o in outs]

    return body


class PlanRing:
    """Fixed-slot submission/completion ring for one armed persistent
    plan (plans.py; tpu.py:187).

    Every descriptor of the captured program is pre-resolved at arm
    time into a *slot* — a pinned gang program with its operand and
    result views, a pre-paired p2p move, or a local op — so a replay is
    a sequence-counter bump: the rank's ``gen``-th replay joins
    generation ``gen``; the LAST member to arrive runs every slot inline
    while the others wait on the completion side of the ring.

    ``invalid`` is the epoch fence: a fence poisons the ring and wakes
    every waiter — a replay can raise on a fenced plan but never
    silently run it."""

    __slots__ = ("slots", "members", "nmembers", "comm_gens", "cv",
                 "rank_gen", "gen_count", "done_gen", "invalid",
                 "replays", "refs")

    def __init__(self, slots: list, members: frozenset, comm_gens: dict):
        self.slots = slots
        self.members = members
        self.nmembers = len(members)
        #: per-rank plan handles sharing this ring (release_ring drops
        #: the pinned state only when the LAST holder releases)
        self.refs = 0
        #: comm id -> the engine's fence generation at arm time; any bump
        #: makes the ring unreplayable
        self.comm_gens = comm_gens
        self.cv = threading.Condition()
        self.rank_gen: dict = {}    # rank -> replays this rank issued
        self.gen_count: dict = {}   # generation -> arrivals so far
        self.done_gen = 0           # completed replay generations
        self.invalid: Optional[str] = None
        self.replays = 0


class CudaEngine:
    """World-level gang scheduler and collective executor over one
    device (``cuda`` by default; tests pass ``cpu``), or with ``devices``
    over one device per rank (``devices[r]``; ``device`` is then rank 0's,
    for the callers that read one)."""

    _GANG_PLANS_CAP = 256

    def __init__(self, nranks: int, device="cuda", devices=None):
        self.nranks = nranks
        #: each rank's device (None: every rank on ``device``, the
        #: one-card path)
        self.rank_devices: Optional[list] = None
        if devices is not None:
            self.rank_devices = resolve_devices(devices, nranks,
                                                "CudaEngine")
            self._check_peers()
            device = self.rank_devices[0]
        self.device = torch.device(device)
        #: tensors moved from one rank to another (``_move``)
        self.peer_moves = 0
        self._move_lock = threading.Lock()
        self._lock = threading.Lock()
        #: payloads at or above this many bytes ride the ring kernels
        self.ring_threshold_bytes = env_int("ACCL_RING_THRESHOLD", 4 << 20,
                                            minimum=0)
        #: flat-tree registers, stored as schedule hints (the program
        #: builder owns the schedule below the ring threshold)
        self.tuning_registers: dict = {}
        self._buffers: list[dict[int, CudaBuffer]] = [{} for _ in range(nranks)]
        self._bases: list[list[int]] = [[] for _ in range(nranks)]
        self._next_addr = [_ADDR_STRIDE] * nranks
        self._comms: dict[int, list[int]] = {}
        self._arithcfgs: list = []
        self._arithcfg_ids: dict = {}
        self._gangs: dict = {}
        self._gang_plans: OrderedDict = OrderedDict()
        # complete gangs awaiting execution; at most one gang runs at any
        # moment, on the executor (_exec_busy) or inline (_inline_busy)
        self._ready: deque = deque()
        self._ready_cv = threading.Condition()
        self._shutdown = False
        self._exec_busy = False
        self._inline_busy = False
        #: leader dispatch for blocking gangs (_dispatch_gang);
        #: ACCL_LEADER_DISPATCH=0 sends every gang through the executor,
        #: the A/B lane of the call-rate bench (tpu.py:272-275)
        self.leader_dispatch = os.environ.get("ACCL_LEADER_DISPATCH",
                                              "1") != "0"
        #: exact perf-counter mode (ACCL_PROFILE_SYNC=1, tpu.py:269): the
        #: stream is synchronized before each gang's end stamp, so a
        #: call's duration is its device time, and no gang batches
        self.profile_sync = os.environ.get("ACCL_PROFILE_SYNC", "0") == "1"
        #: persistent-plan rings (pinned, outside the _gang_plans LRU),
        #: the arm board pairing concurrent per-rank arms into one ring,
        #: and the per-comm fence generation each ring snapshots at arm
        #: (abort_comm and rebuild_gang_tables bump it)
        self._plan_rings: list = []
        self._plan_board: list = []
        self._plan_cv = threading.Condition()
        self._comm_gen: dict = {}
        #: aborted communicator -> the abort bits its calls complete with
        self._aborted_comms: dict = {}
        #: the dispatch-lane, batch and plan counters (tpu.py:314)
        self.metrics = _metrics.MetricsRegistry()
        for k in ("leader_dispatches", "executor_dispatches", "batches",
                  "batched_gangs", "plan_replays", "plan_auto_captures"):
            self.metrics.inc(k, 0)
        #: link twin, kept as what a call can count cheaply and
        #: expanded into per-link rows only when read (link_stats_for):
        #: gangs dispatched per (op, comm, operand bytes, wire spec,
        #: root), and the gang-assembly wait per (src, comm, peer) as
        #: [seeks, seek_wait_ns]
        self._link_gangs: dict = {}
        self._link_waits: dict = {}
        self._link_lock = threading.Lock()
        #: hang watchdog, armed by start_watchdog once the world's flight
        #: recorders exist
        self._watchdog: Optional[_health.Watchdog] = None
        #: kernel streams: (rank, stream id) -> deque of (tensor, event),
        #: and each rank's operand queue (OP0_STREAM sources) of (tensor,
        #: numpy dtype, event); the event is None off the card
        self._streams: dict = {}
        self._stream_cv = threading.Condition()
        self._krnl_in: list = [deque() for _ in range(nranks)]
        self._log = get_logger("accl_tpu_torch.cuda")
        self._exec_thread = threading.Thread(
            target=self._exec_loop, name="accl-gang-exec", daemon=True)
        self._exec_thread.start()

    # ------------------------------------------------------------------
    # ranks on several cards
    # ------------------------------------------------------------------
    def _check_peers(self) -> None:
        """Every pair of the ranks' cards must have peer access
        (``cudaDeviceCanAccessPeer``): raise naming the first pair that
        has none."""
        cards = sorted({d.index for d in self.rank_devices
                        if d.type == "cuda"})
        for a in cards:
            for b in cards:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise ACCLError(
                        f"CudaEngine: cuda:{a} has no peer access to "
                        f"cuda:{b} (cudaDeviceCanAccessPeer): ranks on these "
                        f"cards cannot share a world")

    def device_of(self, rank: int) -> torch.device:
        """Rank ``rank``'s device."""
        return self.device if self.rank_devices is None \
            else self.rank_devices[rank]

    def cards(self) -> list:
        """The distinct devices of the world's ranks, in rank order."""
        if self.rank_devices is None:
            return [self.device]
        return list(dict.fromkeys(self.rank_devices))

    def _move(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """The one point where a tensor goes from rank ``src`` to rank
        ``dst`` (world ranks) on a world of several cards: one explicit
        copy onto ``dst``'s device when the two ranks' devices differ (a
        peer copy, which PyTorch orders after both cards' current
        streams), the tensor itself when they share one.  Counted in
        ``peer_moves`` either way, so a test on the CPU can count what
        each lane moves."""
        with self._move_lock:
            self.peer_moves += 1
        dev = self.rank_devices[dst]
        return t if t.device == dev else t.to(dev)

    # ------------------------------------------------------------------
    # buffers
    # ------------------------------------------------------------------
    def create_buffer(self, rank: int, length: int, dtype) -> CudaBuffer:
        host = np.zeros(length, dtype=dtype)
        span = (host.nbytes // _ADDR_STRIDE + 1) * _ADDR_STRIDE
        # one critical section: _bases must stay sorted for resolve()
        with self._lock:
            addr = self._next_addr[rank]
            self._next_addr[rank] += span
            buf = CudaBuffer(host, self.device_of(rank), addr, self, rank)
            self._buffers[rank][addr] = buf
            self._bases[rank].append(addr)
        return buf

    def free_buffer(self, rank: int, buf: CudaBuffer) -> None:
        """Forget one buffer: its address stops resolving, and the cached
        gang plans that hold it are dropped."""
        with self._lock:
            if self._buffers[rank].pop(buf.address, None) is None:
                return
            self._bases[rank].remove(buf.address)
            for sig in [sig for sig, plan in self._gang_plans.items()
                        if any(b is buf or r is buf
                               for b, _o, r, _ro in plan["ops"])]:
                del self._gang_plans[sig]

    @property
    def stats(self) -> dict:
        """Dispatch-lane counter snapshot (the engine registry's
        counters)."""
        return self.metrics.counters()

    def resolve(self, rank: int, addr: int):
        """Map a descriptor address to (buffer, element offset)."""
        if addr == 0:
            return None, 0
        bases = self._bases[rank]
        i = bisect.bisect_right(bases, addr) - 1
        if i < 0:
            return None, 0
        buf = self._buffers[rank][bases[i]]
        off_bytes = addr - bases[i]
        if off_bytes > buf.host.nbytes:
            return None, 0
        return buf, off_bytes // buf.host.itemsize

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------
    def set_comm(self, comm: Communicator) -> int:
        members = [r.session for r in comm.ranks]
        with self._lock:
            if comm.id in self._comms:
                if self._comms[comm.id] != members:
                    raise ACCLError(f"communicator {comm.id} re-uploaded with "
                                    f"different membership")
            else:
                self._comms[comm.id] = members
        return comm.id

    def register_arithcfg(self, cfg: ArithConfig) -> int:
        with self._lock:
            if cfg not in self._arithcfg_ids:
                self._arithcfgs.append(cfg)
                self._arithcfg_ids[cfg] = len(self._arithcfgs) - 1
            return self._arithcfg_ids[cfg]

    def wire_dtype_for(self, arithcfg_id: int) -> str:
        """Wire spec of a config: "" for identity pairs, the dtype name
        for the cast lanes, ``int8:<block>:<ef>`` for the block-scaled
        lane (decoded by :func:`_parse_wire_spec`)."""
        if not 0 <= arithcfg_id < len(self._arithcfgs):
            return ""
        cfg = self._arithcfgs[arithcfg_id]
        if cfg.elem_ratio_log == 0:
            return ""
        name = COMPRESSOR_WIRE_DTYPE.get(cfg.compressor_tdest, "")
        if name == "int8":
            return (f"int8:{cfg.block or DEFAULT_COMPRESS_BLOCK}"
                    f":{int(bool(cfg.error_feedback))}")
        return name

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, rank: int, call: CCLOCall, request: Request) -> None:
        scenario = call.scenario
        if scenario in (Operation.config, Operation.nop):
            request.complete(0, 0.0)
            return
        # abort fence: a call on an aborted comm completes at once
        # instead of assembling a gang that can never run
        if self._aborted_comms:
            err = self._aborted_comms.get(call.comm)
            if err is not None:
                request.complete(err, 0.0)
                return
        span = request.trace
        rec = request.flight
        try:
            if call.stream_flags:
                self._refuse_capture("a stream call")
            if scenario in (Operation.copy, Operation.combine):
                if rec is not None:
                    rec.mark_dispatched("local", _trace.now_ns())
                if span is not None:
                    span.lane = "local"
                    span.t_dispatch = span.t_device_begin = _trace.now_ns()
                if scenario == Operation.copy:
                    self._exec_copy(rank, call)
                else:
                    self._exec_combine(rank, call)
                if span is not None:
                    span.t_device_end = _trace.now_ns()
                request.complete(0, 1.0)
            elif scenario in (Operation.send, Operation.recv):
                if rec is not None:
                    rec.mark_dispatched("p2p", _trace.now_ns())
                if span is not None:
                    span.lane = "p2p"
                    span.t_dispatch = span.t_device_begin = _trace.now_ns()
                if scenario == Operation.send:
                    self._submit_send(rank, call, request)
                else:
                    self._submit_recv(rank, call, request)
            else:
                self._submit_collective(rank, call, request)
        except Exception as e:  # surface as an engine error, not a hang
            request.description += f" [{e}]"
            request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)

    # -- local ops -----------------------------------------------------
    def _exec_copy(self, rank: int, call: CCLOCall) -> None:
        """A local copy; its stream variants (reference copy_to_stream /
        copy_from_stream, tpu.py:491-512) take the operand from the
        rank's kernel queue (OP0) or deliver into its kernel stream
        ``tag`` (RES)."""
        n = call.count
        if call.stream_flags & StreamFlags.OP0_STREAM:
            q_in = self._krnl_in[rank]
            item = q_in.popleft() if q_in else None
            if item is None or item[0].shape[0] < n:
                raise ACCLError(
                    f"stream operand {0 if item is None else item[0].shape[0]}"
                    f" elems < required {n}")
            vals = self._joined(item)[:n]
            src = None
        else:
            src, soff = self.resolve(rank, call.addr_0)
            vals = src.dev[soff:soff + n]
        if call.stream_flags & StreamFlags.RES_STREAM:
            # the message is the buffer's contents now, not a view of it
            self._push_stream(rank, call.tag,
                              vals if src is None else vals.clone())
            return
        dst, doff = self.resolve(rank, call.addr_2)
        if src is dst:
            vals = vals.clone()  # overlapping ranges of one buffer
        dst.dev[doff:doff + n].copy_(vals)  # casts to the RES dtype

    def _exec_combine(self, rank: int, call: CCLOCall) -> None:
        op0, o0 = self.resolve(rank, call.addr_0)
        op1, o1 = self.resolve(rank, call.addr_1)
        res, o2 = self.resolve(rank, call.addr_2)
        n = call.count
        a, b = op0.dev[o0:o0 + n], op1.dev[o1:o1 + n]
        # arithmetic in the widest operand dtype, result in the RES dtype
        cd = a.dtype if a.element_size() >= b.element_size() else b.dtype
        a, b = a.to(cd), b.to(cd)
        out = torch.maximum(a, b) if call.function == int(
            ReduceFunction.MAX) else a + b
        res.dev[o2:o2 + n].copy_(out)

    # -- point-to-point ------------------------------------------------
    def _submit_send(self, rank: int, call: CCLOCall, request: Request) -> None:
        n = call.count
        # buffered eager semantics: the payload is captured now, the
        # sender completes, delivery happens when the matching recv comes
        if call.stream_flags & StreamFlags.OP0_STREAM:
            data = self._joined(self._krnl_in[rank].popleft())[:n]
        else:
            src, soff = self.resolve(rank, call.addr_0)
            data = src.dev[soff:soff + n].clone()
        if call.compression_flags & CompressionFlags.ETH_COMPRESSED:
            data = _wire_roundtrip(data, self.wire_dtype_for(call.arithcfg))
        dst_rank = self._comms[call.comm][call.root_src_dst]
        if call.stream_flags & StreamFlags.RES_STREAM:
            # stream_put: the payload lands in the destination's stream
            if self.rank_devices is not None:
                data = self._move(data, rank, dst_rank)
            self._push_stream(dst_rank, call.tag, data)
            request.complete(0, 1.0)
            return
        # the channel key carries no tag: tags are matched at seek time,
        # so a TAG_ANY recv pairs with any pending send
        gkey = ("p2p", call.comm, rank, dst_rank)
        with self._lock:
            self._gangs.setdefault(gkey, deque()).append(
                ("data", call.tag, data))
        self._try_deliver(gkey)
        request.complete(0, 1.0)

    def _submit_recv(self, rank: int, call: CCLOCall, request: Request) -> None:
        src_rank = self._comms[call.comm][call.root_src_dst]
        gkey = ("p2p", call.comm, src_rank, rank)
        with self._lock:
            self._gangs.setdefault(gkey, deque()).append(
                ("recv", call.tag, (rank, call, request)))
        self._try_deliver(gkey)

    def _try_deliver(self, gkey) -> None:
        """Pair the oldest recv with the oldest send of one channel; a
        tag mismatch at the head is PACK_SEQ_NUMBER_ERROR, not a reorder
        (the rx pool's seek semantics, tpu.py:575)."""
        while True:
            seq_err = None
            with self._lock:
                q = self._gangs.get(gkey)
                if not q:
                    return
                datas = [i for i, e in enumerate(q) if e[0] == "data"]
                recvs = [i for i, e in enumerate(q) if e[0] == "recv"]
                if not datas or not recvs:
                    return
                ri, di = recvs[0], datas[0]
                rtag, dtag = q[ri][1], q[di][1]
                if rtag != TAG_ANY and rtag != dtag:
                    seq_err = q[ri][2]
                    del q[ri]
                else:
                    data = q[di][2]
                    rank, call, request = q[ri][2]
                    for i in sorted((ri, di), reverse=True):
                        del q[i]
            if seq_err is not None:
                seq_err[2].complete(int(ErrorCode.PACK_SEQ_NUMBER_ERROR), 0.0)
                continue
            try:
                dst, doff = self.resolve(rank, call.addr_2)
                moved = data[:call.count]
                if self.rank_devices is not None:
                    moved = self._move(moved, gkey[2], rank)
                if call.compression_flags & CompressionFlags.ETH_COMPRESSED:
                    moved = _wire_roundtrip(moved,
                                            self.wire_dtype_for(call.arithcfg))
                if call.stream_flags & StreamFlags.RES_STREAM:
                    if dst is not None and moved.dtype != dst.dev.dtype:
                        moved = moved.to(dst.dev.dtype)  # the RES dtype
                    self._push_stream(rank, call.tag, moved)
                else:
                    dst.dev[doff:doff + moved.shape[0]].copy_(moved)
            except Exception as e:
                request.description += f" [{e}]"
                request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)
                continue
            if request.trace is not None:  # delivery ends the device window
                request.trace.t_device_end = _trace.now_ns()
            request.complete(0, 1.0)

    # -- collectives ---------------------------------------------------
    def _submit_collective(self, rank: int, call: CCLOCall,
                           request: Request) -> None:
        P = len(self._comms[call.comm])
        # an OP0_STREAM operand is reserved here, in the submitting rank's
        # own thread (tpu.py:634-660): popping it when the gang runs, on
        # an arbitrary member's thread, would let a later local stream op
        # of this rank take it first
        if call.stream_flags & StreamFlags.OP0_STREAM:
            in_len = call.count * (
                P if Operation(call.scenario) in (
                    Operation.scatter, Operation.reduce_scatter,
                    Operation.alltoall) else 1)
            q_in = self._krnl_in[rank]
            item = q_in.popleft() if q_in else None
            if item is None or item[0].shape[0] < in_len:
                # a short operand would be truncated or padded silently,
                # corrupting the result with retcode 0
                request.description += (
                    f" [stream operand "
                    f"{0 if item is None else item[0].shape[0]}"
                    f" elems < required {in_len}]")
                request.complete(
                    int(ErrorCode.SEGMENTER_EXPECTED_BTT_ERROR), 0.0)
                return
            request.krnl_operand = item
        gkey = ("coll", int(call.scenario), call.comm, call.tag)
        # gang arrival, for the straggler wait of the link twin
        observing = _observing()
        if observing:
            request.link_arrival_ns = _trace.now_ns()
        ready = None
        with self._lock:
            q = self._gangs.setdefault(gkey, deque())
            # join the first gang of this key the rank is not in (FIFO)
            for gang in q:
                if rank not in gang:
                    gang[rank] = (call, request)
                    if len(gang) == P:
                        ready = gang
                        q.remove(gang)
                    break
            else:
                gang = {rank: (call, request)}
                q.append(gang)
                if P == 1:
                    ready = gang
                    q.remove(gang)
        if ready is not None:
            t_ready = _trace.now_ns()  # the last member arrived
            _mark_flight(ready, _flight.S_GANG_READY, t=t_ready)
            if _trace.enabled():
                _mark_spans(ready, t_ready=t_ready)
            if observing:
                self._account_gang_wait(call.comm, ready, t_ready)
            # plan auto-capture (ACCL_PLAN_AUTO): arm a one-slot ring
            # when EVERY member of this instance declared intent, so all
            # ranks switch to replay on the same future instance
            # (tpu.py:688-692)
            if all(r_.plan_intent for _c, r_ in ready.values()):
                self._arm_auto_ring(int(call.scenario), call.comm, ready)
            self._dispatch_gang(int(call.scenario), call.comm, ready, request)

    def _dispatch_gang(self, scenario: int, comm_id: int, gang: dict,
                       leader_req: Request) -> None:
        """Leader dispatch (tpu.py:696): when every member blocks on the
        gang, the last-arriving rank runs it inline — deferred to its
        Request.wait, out of its submission lock — provided the engine
        is idle; otherwise the gang goes to the executor queue.  Either
        way gangs run one at a time in completion order.
        ``leader_dispatch`` False sends every gang to the executor."""
        if self.leader_dispatch and all(req.sync for _c, req in gang.values()):
            def run_inline() -> None:
                with self._ready_cv:
                    idle = (not self._ready and not self._exec_busy
                            and not self._inline_busy)
                    if idle:
                        self._inline_busy = True
                if not idle:
                    self._enqueue_ready(scenario, comm_id, gang)
                    return
                try:
                    self.metrics.inc("leader_dispatches")
                    _mark_flight(gang, _flight.S_DISPATCHED, lane="leader",
                                 t=_trace.now_ns())
                    if _trace.enabled():
                        _mark_spans(gang, lane="leader")
                    self._exec_gang(scenario, comm_id, gang)
                finally:
                    with self._ready_cv:
                        self._inline_busy = False
                        # wakes the executor, and a plan-replay leader
                        # parked on the one-program-at-a-time claim
                        self._ready_cv.notify_all()

            leader_req.pre_wait = run_inline
            return
        self._enqueue_ready(scenario, comm_id, gang)

    def _enqueue_ready(self, scenario: int, comm_id: int, gang: dict) -> None:
        with self._ready_cv:
            self._ready.append((scenario, comm_id, gang))
            self._ready_cv.notify()

    def _exec_loop(self) -> None:
        """The executor thread (tpu.py:1494); parks while an inline
        dispatch or a plan replay runs.  A popped gang takes compatible
        queued gangs with it into one batch (_extend_batch)."""
        while True:
            with self._ready_cv:
                while not (self._ready and not self._inline_busy):
                    if self._shutdown and not self._ready:
                        return
                    self._ready_cv.wait()
                scenario, comm_id, gang = self._ready.popleft()
                self._exec_busy = True
            try:
                items = self._extend_batch(scenario, comm_id, gang)
                if items is None:
                    self.metrics.inc("executor_dispatches")
                    self._exec_gang(scenario, comm_id, gang)
                else:
                    self.metrics.inc("batches")
                    self.metrics.inc("batched_gangs", len(items))
                    self._exec_gang_batch(items)
            except Exception as e:  # a gang plan that cannot be built
                self._log.error("executor gang dispatch failed: %s", e)
                for _call, request in gang.values():
                    if not request.done:
                        request.description += f" [{e}]"
                        request.complete(int(ErrorCode.DMA_INTERNAL_ERROR),
                                         0.0)
            finally:
                with self._ready_cv:
                    self._exec_busy = False
                    self._ready_cv.notify_all()

    #: most gangs one batch runs under one claim of the dispatch slot
    #: (tpu.py:1534)
    _BATCH_CAP = 8

    def _extend_batch(self, scenario: int, comm_id: int, gang: dict):
        """Extend ``gang`` with queued gangs of the same program and no
        read-after-write hazard (a candidate reading a (rank, address)
        an earlier member writes ends the batch), JAX's rules
        (tpu.py:1536-1588), so the same gangs are eligible in both
        packages.  Only the executor pops, so peeking then popping is
        race-free.  Returns [(op, comm, gang, plan)] when a batch of two
        or more formed, else None."""
        op = Operation(scenario)
        if op == Operation.barrier or self.profile_sync:
            # profile_sync: each call's duration must be its own device
            # time, never a share of a batch's
            return None
        with self._ready_cv:
            if not self._ready:
                return None
        plan = self._gang_plan(op, comm_id, gang)
        if plan["ring"] or plan["streams"]:
            # the ring lane always dispatches alone (tpu.py:1562-1570); a
            # stream operand has no address for the read-after-write guard
            return None
        items = [(op, comm_id, gang, plan)]
        res_addrs = set(plan["res_addrs"])
        while len(items) < self._BATCH_CAP:
            with self._ready_cv:
                if not self._ready:
                    break
                nscen, ncomm, ngang = self._ready[0]
            nop = Operation(nscen)
            if nop == Operation.barrier:
                break
            try:
                nplan = self._gang_plan(nop, ncomm, ngang)
            except Exception:  # the candidate's own turn reports it
                break
            if (nplan["fn_key"] != plan["fn_key"] or nplan["streams"]
                    or nplan["opnd_addrs"] & res_addrs):
                break
            with self._ready_cv:
                popped = self._ready.popleft()
            items.append((nop, ncomm, popped[2], nplan))
            res_addrs |= nplan["res_addrs"]
        return items if len(items) > 1 else None

    def _exec_gang(self, scenario: int, comm_id: int, gang: dict) -> None:
        """Run one gang and complete its members (tpu.py:1590): the
        dispatch stamp (the leader lane pre-tags its members, every other
        gang is the executor's), then, under tracing, the device window."""
        try:
            _mark_flight(gang, _flight.S_DISPATCHED, lane="executor",
                         t=_trace.now_ns())
            if _trace.enabled():
                td = _trace.now_ns()
                for _c, req in gang.values():
                    span = req.trace
                    if span is not None:
                        if span.lane is None:
                            span.lane = "executor"
                        span.t_dispatch = td
            dt_ns, t0, t1 = self._run_collective(Operation(scenario),
                                                 comm_id, gang)
            if _trace.enabled():
                _mark_spans(gang, t_dev0=t0, t_dev1=t1)
        except Exception as e:
            self._log.debug("gang %s failed: %s", Operation(scenario).name, e)
            for _call, request in gang.values():
                request.description += f" [{e}]"
                request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)
            return
        for _call, request in gang.values():
            request.complete(0, float(dt_ns))

    def _exec_gang_batch(self, items: list) -> None:
        """Run K same-program, RAW-independent gangs back to back under
        the executor's one claim of the dispatch slot (tpu.py:1616): one
        flight/span stamp with lane ``batched``, one device window, and
        each call's duration the batch's time / K.  If a member fails,
        the members that ran before it complete as they are and the
        rest fail."""
        t0 = time.perf_counter_ns()
        ran = 0
        try:
            tf = _trace.now_ns()
            for _op, _c, gang, _plan in items:
                _mark_flight(gang, _flight.S_DISPATCHED, lane="batched",
                             t=tf)
            if _trace.enabled():
                td = _trace.now_ns()
                for _op, _c, gang, _plan in items:
                    _mark_spans(gang, lane="batched", t_dispatch=td)
            t0 = time.perf_counter_ns()
            for op, comm_id, gang, plan in items:
                self._run_plan(op, comm_id, gang, plan)
                ran += 1
            t1 = self._end_stamp()
            if _trace.enabled():
                for _op, _c, gang, _plan in items:
                    _mark_spans(gang, t_dev0=t0, t_dev1=t1)
            err = None
        except Exception as e:
            self._log.debug("batched gang failed: %s", e)
            t1 = time.perf_counter_ns()
            err = e
        per_call = float(t1 - t0) / max(ran, 1)
        for i, (_op, _c, gang, _plan) in enumerate(items):
            for _call, request in gang.values():
                if i < ran:
                    request.complete(0, per_call)
                else:
                    request.description += f" [{err}]"
                    request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)

    def _end_stamp(self) -> int:
        """The device-end stamp: on the card a launch returns at enqueue,
        so under tracing or ``profile_sync`` the stream (every card's) is
        synchronized first; otherwise the stamp is the enqueue's end."""
        if (self.profile_sync or _trace.enabled()) \
                and self.device.type == "cuda":
            for dev in self.cards():
                torch.cuda.current_stream(dev).synchronize()
        return time.perf_counter_ns()

    def _gang_plan(self, op: Operation, comm_id: int, gang: dict) -> dict:
        """Resolve one gang signature into an execution plan (buffers,
        datapath dtype, operand length, ring decision, program) and cache
        it (tpu.py:1676): a training loop's repeated descriptors pay this
        once.  The threshold is in the signature, so changing it
        re-plans."""
        members = self._comms[comm_id]
        # stream_flags is in the signature: a stream gang addresses no
        # buffer (all zero), and must not reuse a buffer gang's plan
        sig = (int(op), comm_id, self.ring_threshold_bytes, tuple(
            (g, c.addr_0, c.addr_2, c.count, c.root_src_dst, c.function,
             c.compression_flags, c.arithcfg, c.stream_flags, c.tag,
             c.fused)
            for g, c in ((m, gang[m][0]) for m in members)))
        with self._lock:
            plan = self._gang_plans.get(sig)
            if plan is not None:
                self._gang_plans.move_to_end(sig)
                return plan
        nranks = len(members)
        any_call = next(iter(gang.values()))[0]
        n = any_call.count
        root = any_call.root_src_dst
        wire_dtype = (self.wire_dtype_for(any_call.arithcfg)
                      if any_call.compression_flags
                      & CompressionFlags.ETH_COMPRESSED else "")
        in_len = {
            Operation.bcast: n, Operation.scatter: n * nranks,
            Operation.gather: n, Operation.allgather: n, Operation.reduce: n,
            Operation.allreduce: n, Operation.reduce_scatter: n * nranks,
            Operation.alltoall: n * nranks, Operation.barrier: 0,
        }[op]
        # the collective runs in the widest representation in the gang;
        # narrower operands widen on the way in, results narrow to each
        # result buffer's dtype on the way out
        dtype = None
        for g in members:
            call = gang[g][0]
            for addr in (call.addr_0, call.addr_2):
                b, _o = self.resolve(g, addr)
                if b is not None and (dtype is None or b.host.dtype.itemsize
                                      > np.dtype(dtype).itemsize):
                    dtype = b.host.dtype
        if dtype is None:
            # a stream->stream collective addresses no buffer: the dtype
            # comes from the reserved operands (tpu.py:1747-1759)
            for g in members:
                item = getattr(gang[g][1], "krnl_operand", None)
                if item is not None:
                    dtype = item[1]
                    break
        if dtype is None and op != Operation.barrier:
            raise ACCLError(
                "collective addresses no buffer and no stream operand "
                "was reserved — cannot derive the datapath dtype")
        ops = []
        streams = []
        for li, g in enumerate(members):
            call = gang[g][0]
            op0_stream = bool(call.stream_flags & StreamFlags.OP0_STREAM)
            res_stream = bool(call.stream_flags & StreamFlags.RES_STREAM)
            # operand: op0 for contributors; a bcast non-root contributes
            # its result buffer as a placeholder; an OP0_STREAM member's
            # comes from its reservation when the gang runs
            if op0_stream:
                buf, off = None, 0
            else:
                buf, off = self.resolve(g, call.addr_0)
                if buf is None:
                    buf, off = self.resolve(g, call.addr_2)
            write_out = not (op in (Operation.reduce, Operation.gather)
                             and li != root)
            res, roff = self.resolve(g, call.addr_2)
            # a RES_STREAM member's result goes to its kernel stream, never
            # to a buffer view
            ops.append((buf, off, res if write_out and not res_stream
                        else None, roff))
            streams.append((op0_stream,
                            call.tag if res_stream and write_out else None))
        ring = (op in (Operation.allreduce, Operation.allgather,
                       Operation.reduce_scatter)
                and nranks > 1
                and in_len * np.dtype(dtype).itemsize
                >= self.ring_threshold_bytes)
        # the fused lane is a descriptor opt-in and takes precedence over
        # the threshold's choice (tpu.py:1795-1801)
        fused = (bool(any_call.fused)
                 and op in (Operation.allreduce, Operation.allgather,
                            Operation.reduce_scatter)
                 and nranks > 1)
        plan = {
            "op": op,
            "members": tuple(members),
            # per member (operand from the queue, result stream id or
            # None); empty when no member streams
            "streams": (tuple(streams) if any(a or t is not None
                                               for a, t in streams) else ()),
            "in_len": in_len,
            # the lossless ring lane writes straight into the result
            # buffers: no wire roundtrip runs after it
            "out_len": ({Operation.allreduce: in_len,
                         Operation.allgather: in_len * nranks,
                         Operation.reduce_scatter: in_len // nranks}[op]
                        if ring and not fused and not wire_dtype else 0),
            "dtype": None if dtype is None else torch_dtype(dtype),
            "itemsize": 0 if dtype is None else np.dtype(dtype).itemsize,
            "wire_dtype": wire_dtype,
            "ops": ops,
            "ring": ring,
            "program": (None if op == Operation.barrier else
                        _collective_program(op, nranks, in_len, root,
                                            any_call.function, wire_dtype,
                                            ring, fused,
                                            self._placer(members))),
            # batching (tpu.py:1817-1826): gangs of one fn_key run the
            # same program; the address sets, keyed by (rank, address)
            # because every rank's allocator mints the same numbers,
            # drive the read-after-write guard
            "fn_key": (tuple(members), op, nranks, in_len, root,
                       any_call.function, wire_dtype, str(dtype), ring,
                       fused),
            "opnd_addrs": frozenset((g, b.address) for g, (b, _o, _r, _ro)
                                    in zip(members, ops) if b is not None),
            "res_addrs": frozenset((g, r.address) for g, (_b, _o, r, _ro)
                                   in zip(members, ops) if r is not None),
        }
        with self._lock:
            self._gang_plans[sig] = plan
            while len(self._gang_plans) > self._GANG_PLANS_CAP:
                self._gang_plans.popitem(last=False)
        return plan

    def _placer(self, members) -> Optional[Callable]:
        """The program's ``place`` over a comm's members (local ranks to
        world ranks), or None on one card."""
        if self.rank_devices is None:
            return None
        members = list(members)
        return lambda t, src, dst: self._move(t, members[src], members[dst])

    def _run_collective(self, op: Operation, comm_id: int,
                        gang: dict) -> tuple:
        """Run one gang's program (:meth:`_run_plan`).  Returns (duration
        ns, device-begin ns, device-end ns).  On the card a launch
        returns at enqueue: with tracing and ``profile_sync`` off the
        duration is the enqueue; with either on the stream is
        synchronized before the end stamp, so the window holds the
        device work.  The ring wrappers land their device-trace rows
        themselves, each after its launch."""
        if op == Operation.barrier:
            t = time.perf_counter_ns()
            return 0, t, t  # gang completion is the synchronization
        plan = self._gang_plan(op, comm_id, gang)
        t0, t1 = self._run_plan(op, comm_id, gang, plan)
        if self.profile_sync or _trace.enabled():
            t1 = self._end_stamp()
        return t1 - t0, t0, t1

    def _run_plan(self, op: Operation, comm_id: int, gang: dict,
                  plan: dict, xs: Optional[list] = None,
                  outs: Optional[list] = None) -> tuple:
        """Gather the gang's operands (views of the rank buffers where the
        dtype and length allow), run the program, write each result into
        its rank's buffer; (program start ns, program end ns).  A plan
        slot passes its operands ``xs`` and result views ``outs`` (None:
        the results are copied) already resolved."""
        if _observing():
            self._account_gang_links(op, comm_id, gang,
                                     plan["in_len"] * plan["itemsize"],
                                     plan["wire_dtype"])
        streams = plan["streams"]
        if xs is None:
            xs = [self._operand(plan, r, gang)
                  for r in range(len(plan["ops"]))]
            outs = self._direct_outs(plan, xs)
        t0 = time.perf_counter_ns()
        ys = plan["program"](xs, outs)
        t1 = time.perf_counter_ns()
        for r, ((_buf, _off, res, roff), y) in enumerate(zip(plan["ops"],
                                                             ys)):
            if streams and streams[r][1] is not None:
                self._push_stream(plan["members"][r], streams[r][1],
                                  self._owned(y, xs))
            elif res is not None and (outs is None or y is not outs[r]):
                res.dev[roff:roff + y.shape[0]].copy_(y)
        return t0, t1

    @staticmethod
    def _owned(y: torch.Tensor, xs: list) -> torch.Tensor:
        """``y`` as a kernel stream's message: a copy when it may alias
        memory a later call writes (a view, or an operand itself)."""
        if y._base is None and not any(y is x for x in xs):
            return y
        return y.clone()

    def _operand(self, plan: dict, r: int,
                 gang: Optional[dict] = None) -> torch.Tensor:
        """Rank ``r``'s operand: a view of its buffer (or, for an
        OP0_STREAM member, of its reserved queue operand), or a copy
        widened to the datapath dtype or padded to the operand length (a
        short bcast placeholder)."""
        buf, off, _res, _roff = plan["ops"][r]
        in_len = plan["in_len"]
        if buf is None:
            item = gang[plan["members"][r]][1].krnl_operand
            shard = self._joined(item)[:in_len]
        else:
            shard = buf.dev[off:off + in_len]
        if shard.dtype != plan["dtype"]:
            shard = shard.to(plan["dtype"])
        if shard.shape[0] < in_len:
            pad = shard.new_zeros(in_len - shard.shape[0])
            shard = torch.cat([shard, pad])
        return shard

    @staticmethod
    def _direct_outs(plan: dict, xs: list) -> Optional[list]:
        """The ranks' result views, when the ring drivers may write into
        them in place of a copy afterwards: every rank's result buffer
        has the datapath dtype and room for the whole result, and the
        views alias the operands only as the kernels allow
        (``ring.alias_fault``).  Otherwise None, and the results are
        copied."""
        n, dtype = plan["out_len"], plan["dtype"]
        if not n:
            return None
        outs = []
        for _buf, _off, res, roff in plan["ops"]:
            if res is None or res.dev.dtype != dtype or \
                    res.dev.shape[0] - roff < n:
                return None
            outs.append(res.dev[roff:roff + n])
        in_place = plan["op"] == Operation.allreduce
        if ring_ops.alias_fault(xs, outs, in_place):
            return None
        return outs

    # -- link twin (tpu.py:764-880) -------------------------------------
    @staticmethod
    def _wire_ratio(wire_dtype: str) -> float:
        """Wire bytes per logical byte of a wire spec ("" = 1.0): the cast
        lanes halve the payload; the int8 lane packs ~4:1 plus one fp32
        scale per block."""
        if not wire_dtype:
            return 1.0
        name, block, _ef = _parse_wire_spec(wire_dtype)
        if name == "int8":
            return (1.0 + 4.0 / max(block, 1)) / 4.0
        return 0.5

    def _account_gang_links(self, op, comm_id: int, gang: dict,
                            nbytes: int, wire_dtype: str = "") -> None:
        """Count one dispatched gang for the link twin (one dict update;
        :meth:`_gang_link_rows` turns it into per-link bytes when the
        rows are read).  A compressed wire also counts its logical and
        wire bytes in the engine registry (compressed_tx_*)."""
        P = len(self._comms.get(comm_id, ()))
        if P < 2 or nbytes <= 0:
            return
        ratio = self._wire_ratio(wire_dtype)
        if ratio < 1.0:
            name = Operation(op).name
            # nbytes is in_len x itemsize, which carries the P factor of
            # the n*P-operand collectives: divide it back out, so logical
            # = count x payload_factor as the metrics count it
            per_count = nbytes // (
                P if name in ("scatter", "reduce_scatter", "alltoall")
                else 1)
            logical = int(per_count * _metrics.payload_factor(name, P))
            self.metrics.inc("compressed_tx_logical_bytes", logical)
            self.metrics.inc("compressed_tx_bytes", int(logical * ratio))
        key = (int(op), comm_id, nbytes, wire_dtype,
               next(iter(gang.values()))[0].root_src_dst)
        with self._link_lock:
            self._link_gangs[key] = self._link_gangs.get(key, 0) + 1

    def _gang_link_rows(self, op: int, comm_id: int, nbytes: int,
                        wire_dtype: str, root_local: int) -> list:
        """The per-link counters of one gang, as tpu.py accounts them:
        ring collectives move busbw_factor x nbytes per rank to the right
        neighbour over P - 1 (allgather, reduce_scatter, alltoall) or
        2 (P - 1) (allreduce) hops; rooted collectives put the payload on
        the root's links; a compressed wire adds comp_tx_bytes.  Returns
        [((src, comm, peer), counts)]."""
        members = self._comms.get(comm_id, [])
        P = len(members)
        name = Operation(op).name
        ratio = self._wire_ratio(wire_dtype)
        rows = []
        if name in ("allreduce", "allgather", "reduce_scatter",
                    "alltoall"):
            if name == "allgather":
                nbytes *= P
            per_link = int(nbytes * _metrics.busbw_factor(name, P))
            hops = 2 * (P - 1) if name == "allreduce" else P - 1
            comp = int(per_link * ratio) if ratio < 1.0 else 0
            for i, src in enumerate(members):
                rows.append(((src, comm_id, members[(i + 1) % P]),
                             {"tx_msgs": hops, "tx_bytes": per_link,
                              "comp_tx_bytes": comp}))
                rows.append(((src, comm_id, members[(i - 1) % P]),
                             {"rx_msgs": hops, "rx_bytes": per_link}))
        elif name in ("bcast", "scatter", "gather", "reduce"):
            root = members[root_local] if root_local < P else members[0]
            to_root = name in ("gather", "reduce")
            # each root <-> member link carries 1/P of scatter's operand
            per_link = nbytes // P if name == "scatter" else nbytes
            comp = int(per_link * ratio) if ratio < 1.0 else 0
            for m in members:
                if m == root:
                    continue
                a, b = (m, root) if to_root else (root, m)
                rows.append(((a, comm_id, b), {"tx_msgs": 1,
                                               "tx_bytes": per_link,
                                               "comp_tx_bytes": comp}))
                rows.append(((b, comm_id, a), {"rx_msgs": 1,
                                               "rx_bytes": per_link}))
        return rows

    def _account_gang_wait(self, comm_id: int, gang: dict,
                           t_ready: int) -> None:
        """Straggler wait: each non-last member's (t_last - t_own) is
        put on the link to the last-arriving rank, the one it waited
        for."""
        known = {r: t for r, (_c, req) in gang.items()
                 if (t := getattr(req, "link_arrival_ns", None)) is not None}
        if len(known) < 2:
            return
        last_rank = max(known, key=known.__getitem__)
        t_last = known[last_rank]
        with self._link_lock:
            for r, t in known.items():
                if r != last_rank:
                    w = self._link_waits.setdefault((r, comm_id, last_rank),
                                                    [0, 0])
                    w[0] += 1
                    w[1] += max(t_last - t, 0)

    def _link_table(self) -> dict:
        """(src, comm, peer) -> counters: the gangs counted so far,
        expanded into per-link rows, and the waits."""
        with self._link_lock:
            gangs = dict(self._link_gangs)
            waits = {k: list(v) for k, v in self._link_waits.items()}
        table: dict = {}
        for key, n in gangs.items():
            for link, counts in self._gang_link_rows(*key):
                row = table.setdefault(link, {})
                for f, v in counts.items():
                    row[f] = row.get(f, 0) + n * v
        for link, (seeks, wait_ns) in waits.items():
            row = table.setdefault(link, {})
            row["seeks"] = row.get("seeks", 0) + seeks
            row["seek_wait_ns"] = row.get("seek_wait_ns", 0) + wait_ns
        return table

    def link_stats_for(self, rank: int) -> list:
        """One rank's link rows: {"comm", "peer", *LINK_COUNTER_FIELDS},
        peers as global ranks."""
        rows = []
        for (src, comm, peer), c in sorted(self._link_table().items()):
            if src != rank:
                continue
            row = {"comm": comm, "peer": peer}
            for f in LINK_COUNTER_FIELDS:
                row[f] = int(c.get(f, 0))
            rows.append(row)
        return rows

    # -- persistent-plan rings (tpu.py:989-1428) -----------------------
    def arm_plan(self, rank: int, calls: Sequence[CCLOCall],
                 expected: frozenset, timeout_s: float) -> PlanRing:
        """Arm one rank's captured descriptor stream.  Ranks arming
        concurrently (every member of ``expected``) rendezvous on the arm
        board; the LAST arrival lowers the whole group into one
        :class:`PlanRing`.  A rank that waits out ``timeout_s`` raises
        naming the ranks that never armed."""
        with self._plan_cv:
            group = None
            for g in self._plan_board:
                # join only a group with the IDENTICAL member union, so
                # two concurrent captures that share ranks never fuse
                if rank not in g["arrived"] and not g["building"] \
                        and g["expected"] == set(expected):
                    group = g
                    break
            if group is None:
                group = {"arrived": {}, "expected": set(expected),
                         "ring": None, "error": None, "building": False}
                self._plan_board.append(group)
            group["arrived"][rank] = list(calls)
            complete = set(group["arrived"]) >= group["expected"]
            if complete:
                group["building"] = True
        if complete:
            ring = err = None
            try:
                ring = self._build_ring(group["arrived"], group["expected"])
            except Exception as e:  # every armer sees the same failure
                err = e
            with self._plan_cv:
                group["ring"], group["error"] = ring, err
                if group in self._plan_board:
                    self._plan_board.remove(group)
                if ring is not None:
                    self._plan_rings.append(ring)
                self._plan_cv.notify_all()
            if err is not None:
                raise err if isinstance(err, ACCLError) else ACCLError(
                    f"plan arm failed: {err}")
            with ring.cv:
                ring.refs += 1  # this rank's plan handle
            return ring
        deadline = time.monotonic() + timeout_s
        with self._plan_cv:
            while group["ring"] is None and group["error"] is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._plan_cv.wait(remaining):
                    if group["ring"] is not None \
                            or group["error"] is not None:
                        break
                    if group["building"]:
                        # the build always publishes a ring or an error
                        deadline = time.monotonic() + timeout_s
                        continue
                    missing = sorted(set(group["expected"])
                                     - set(group["arrived"]))
                    err = ACCLError(
                        f"plan arm timed out after {timeout_s:.0f}s "
                        f"waiting for rank(s) {missing} to capture the "
                        f"same plan — capture_plan is collective over "
                        f"every gang/p2p peer of the captured program")
                    # poison and retire the group, so a late arm opens a
                    # fresh one instead of completing this rank's
                    group["error"] = err
                    if group in self._plan_board:
                        self._plan_board.remove(group)
                    self._plan_cv.notify_all()
                    raise err
            if group["error"] is not None:
                e = group["error"]
                raise e if isinstance(e, ACCLError) else ACCLError(
                    f"plan arm failed: {e}")
            ring = group["ring"]
        # refs outside the board lock: release_ring takes ring.cv, then
        # _plan_cv
        with ring.cv:
            ring.refs += 1
        return ring

    def _build_ring(self, lists: dict, expected: set) -> PlanRing:
        """Lower a complete arm group into ring slots: merge the per-rank
        call streams into one serializable schedule (the gang pairing the
        scheduler would do per call, done once), resolving every operand
        (tpu.py:1084)."""
        ranks = sorted(lists)
        comm_gens: dict = {}

        def note_comm(comm_id: int) -> list:
            members = self._comms.get(comm_id)
            if members is None:
                raise ACCLError(f"plan arm: unknown communicator {comm_id}")
            if comm_id in self._aborted_comms:
                raise ACCLError(
                    f"plan arm: communicator {comm_id} is aborted — "
                    f"recover first, then capture",
                    int(ErrorCode.COMM_ABORTED))
            comm_gens.setdefault(comm_id, self._comm_gen.get(comm_id, 0))
            return members

        heads = {r: 0 for r in ranks}
        total = sum(len(v) for v in lists.values())
        made = 0
        slots: list = []
        pending: dict = {}  # (comm, src, dst) -> deque of sends
        while made < total:
            progressed = False
            for r in ranks:
                i = heads[r]
                if i >= len(lists[r]):
                    continue
                call = lists[r][i]
                op = Operation(call.scenario)
                if call.stream_flags:
                    raise ACCLError("plan arm: stream-operand calls are not "
                                    "replayable — keep stream traffic eager")
                if op in (Operation.config, Operation.nop):
                    pass
                elif op in (Operation.copy, Operation.combine):
                    slots.append({"kind": "local", "rank": r, "call": call})
                elif op == Operation.send:
                    dst = note_comm(call.comm)[call.root_src_dst]
                    pending.setdefault((call.comm, r, dst),
                                       deque()).append((r, call))
                elif op == Operation.recv:
                    src = note_comm(call.comm)[call.root_src_dst]
                    q = pending.get((call.comm, src, r))
                    if not q:
                        continue  # sender not reached yet
                    s_rank, s_call = q.popleft()
                    slots.append(self._p2p_slot(s_rank, s_call, r, call))
                else:  # gang collective
                    members = note_comm(call.comm)
                    ready = True
                    for m in members:
                        if m not in lists:
                            raise ACCLError(
                                f"plan arm: comm {call.comm} member {m} "
                                f"never captured this plan — every member "
                                f"must capture_plan the same program")
                        j = heads[m]
                        if j >= len(lists[m]) or \
                                (lists[m][j].scenario, lists[m][j].comm,
                                 lists[m][j].tag) != (call.scenario,
                                                      call.comm, call.tag):
                            ready = False
                            break
                    if not ready:
                        continue
                    gang = {m: (lists[m][heads[m]], None) for m in members}
                    slots.append(self._gang_slot(op, call.comm, gang))
                    for m in members:
                        heads[m] += 1
                    made += len(members)
                    progressed = True
                    continue
                heads[r] += 1
                made += 1
                progressed = True
            if not progressed:
                raise ACCLError(
                    "plan arm: captured steps do not form a serializable "
                    "schedule (cross-rank call order diverges, or a recv "
                    "waits on a send outside the plan) — record the "
                    "program with analysis.record_program and check it")
        leftover = sum(len(q) for q in pending.values())
        if leftover:
            raise ACCLError(
                f"plan arm: {leftover} send(s) have no matching recv "
                f"inside the plan — p2p must pair within the captured "
                f"program")
        return PlanRing(slots, frozenset(expected), comm_gens)

    def _gang_slot(self, op: Operation, comm_id: int, gang: dict) -> dict:
        """One gang's slot: its plan, the operands that are views of the
        rank buffers (None where the operand is a copy, rebuilt on every
        replay so it reads the buffer as it is then) and the result views
        the ring drivers may write into (``_direct_outs``, decided once:
        a rebuilt copy is fresh memory, so the alias check holds)."""
        if op == Operation.barrier:  # the replay rendezvous is the barrier
            return {"kind": "gang", "op": op, "comm": comm_id, "gang": gang,
                    "plan": None}
        plan = self._gang_plan(op, comm_id, gang)
        views = []
        for buf, off, _res, _roff in plan["ops"]:
            v = buf.dev[off:off + plan["in_len"]]
            views.append(v if v.dtype == plan["dtype"]
                         and v.shape[0] == plan["in_len"] else None)
        xs = [v if v is not None else self._operand(plan, r)
              for r, v in enumerate(views)]
        return {"kind": "gang", "op": op, "comm": comm_id, "gang": gang,
                "plan": plan, "views": views,
                "outs": self._direct_outs(plan, xs)}

    def _p2p_slot(self, s_rank: int, s_call: CCLOCall, d_rank: int,
                  d_call: CCLOCall) -> dict:
        """A pre-paired send/recv, moved as the eager lane moves it: the
        sender's wire roundtrip on its payload, the receiver's on its
        count of it, then a copy into the receive buffer (the PACK_SEQ
        tag discipline checked once, here)."""
        if d_call.tag != TAG_ANY and d_call.tag != s_call.tag:
            raise ACCLError(
                f"plan arm: recv tag {d_call.tag} does not match the oldest "
                f"pending send tag {s_call.tag} on route {s_rank}->{d_rank} "
                f"(the PACK_SEQ sequence discipline)")
        sbuf, soff = self.resolve(s_rank, s_call.addr_0)
        dbuf, doff = self.resolve(d_rank, d_call.addr_2)
        if sbuf is None or dbuf is None:
            raise ACCLError("plan arm: p2p operand does not resolve to a "
                            "registered device buffer")

        def wire(call):
            return (self.wire_dtype_for(call.arithcfg)
                    if call.compression_flags
                    & CompressionFlags.ETH_COMPRESSED else "")

        return {"kind": "p2p", "s_rank": s_rank, "d_rank": d_rank,
                "src": sbuf, "soff": soff,
                "n_send": s_call.count, "send_wire": wire(s_call),
                "dst": dbuf, "doff": doff, "n_recv": d_call.count,
                "recv_wire": wire(d_call)}

    def ring_replay(self, rank: int, ring: PlanRing, run_async: bool = False,
                    timeout_s: float = 60.0) -> int:
        """The replay hot path: bump this rank's sequence counter; the
        generation's LAST arrival executes every slot inline, everyone
        else rides the completion side.  Returns the generation (the
        async ticket's token)."""
        with ring.cv:
            if ring.invalid is not None:
                raise ACCLError(
                    f"plan replay: plan invalidated ({ring.invalid})",
                    int(ErrorCode.COMM_ABORTED))
            g = ring.rank_gen.get(rank, 0) + 1
            ring.rank_gen[rank] = g
            n = ring.gen_count.get(g, 0) + 1
            last = n == ring.nmembers
            if last:
                ring.gen_count.pop(g, None)
            else:
                ring.gen_count[g] = n
        if last:
            self._ring_execute(ring, g, timeout_s)
            return g
        if run_async:
            return g
        if not self.ring_wait(ring, g, timeout_s):
            raise ACCLError(
                f"plan replay: generation {g} never completed within "
                f"{timeout_s:.0f}s (a member rank stopped replaying?)")
        return g

    def ring_wait(self, ring: PlanRing, gen: int,
                  timeout_s: float = 60.0) -> bool:
        """Completion side of the ring: block until generation ``gen``
        finished.  False on timeout; raises when the ring was fenced."""
        deadline = time.monotonic() + timeout_s
        with ring.cv:
            while ring.done_gen < gen:
                if ring.invalid is not None:
                    raise ACCLError(
                        f"plan replay: plan invalidated ({ring.invalid})",
                        int(ErrorCode.COMM_ABORTED))
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                ring.cv.wait(remaining)
        return True

    def _ring_execute(self, ring: PlanRing, gen: int,
                      timeout_s: float) -> None:
        # generation order: an async pump can trigger gen g while g - 1
        # runs on another thread, and the slots rebind no buffers but
        # write them, so executions land in order
        deadline = time.monotonic() + timeout_s
        with ring.cv:
            while ring.done_gen < gen - 1 and ring.invalid is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ACCLError(
                        f"plan replay: generation {gen - 1} never "
                        f"completed within {timeout_s:.0f}s")
                ring.cv.wait(remaining)
            if ring.invalid is not None:
                raise ACCLError(
                    f"plan replay: plan invalidated ({ring.invalid})",
                    int(ErrorCode.COMM_ABORTED))
        # epoch fence: the comm generations must still match the armed
        # snapshot, and no comm may be aborted (tpu.py:1284-1296)
        for comm_id, gen0 in ring.comm_gens.items():
            if self._comm_gen.get(comm_id, 0) != gen0 \
                    or comm_id in self._aborted_comms:
                self._invalidate_ring(
                    ring, f"communicator {comm_id} fenced since arm")
                raise ACCLError(
                    f"plan replay: communicator {comm_id} was fenced "
                    f"(abort/epoch bump) since the plan was armed — "
                    f"re-capture on the recovered communicator",
                    int(ErrorCode.COMM_ABORTED))
        # claim the engine's one-program-at-a-time slot, as the leader
        # and executor lanes do
        with self._ready_cv:
            while (self._ready or self._exec_busy
                   or self._inline_busy) and not self._shutdown:
                self._ready_cv.wait(0.05)
            if self._shutdown:
                raise ACCLError("plan replay: engine shut down while "
                                "waiting for the dispatch slot")
            self._inline_busy = True
        try:
            self.metrics.inc("plan_replays")
            for slot in ring.slots:
                self._exec_slot(slot)
            if _trace.enabled():
                self._end_stamp()
        except Exception as e:
            self._invalidate_ring(ring, f"replay execution failed: {e}")
            if isinstance(e, ACCLError):
                raise
            raise ACCLError(f"plan replay failed: {e}") from e
        finally:
            with self._ready_cv:
                self._inline_busy = False
                self._ready_cv.notify_all()
        with ring.cv:
            ring.done_gen = gen
            ring.replays += 1
            ring.cv.notify_all()

    def _exec_slot(self, slot: dict) -> None:
        kind = slot["kind"]
        if kind == "gang":
            plan = slot["plan"]
            if plan is None:  # barrier
                return
            xs = [v if v is not None else self._operand(plan, r)
                  for r, v in enumerate(slot["views"])]
            self._run_plan(slot["op"], slot["comm"], slot["gang"], plan,
                           xs, slot["outs"])
        elif kind == "local":
            call = slot["call"]
            if call.scenario == Operation.copy:
                self._exec_copy(slot["rank"], call)
            else:
                self._exec_combine(slot["rank"], call)
        else:  # p2p
            src, dst = slot["src"], slot["dst"]
            data = src.dev[slot["soff"]:slot["soff"] + slot["n_send"]]
            if src is dst:
                data = data.clone()  # the eager send's captured payload
            data = _wire_roundtrip(data, slot["send_wire"])[:slot["n_recv"]]
            if self.rank_devices is not None:
                data = self._move(data, slot["s_rank"], slot["d_rank"])
            data = _wire_roundtrip(data, slot["recv_wire"])
            dst.dev[slot["doff"]:slot["doff"] + data.shape[0]].copy_(data)

    def _invalidate_ring(self, ring: PlanRing, reason: str) -> None:
        with ring.cv:
            if ring.invalid is None:
                ring.invalid = reason
            ring.cv.notify_all()

    def invalidate_rings(self, comm_id: Optional[int], reason: str) -> None:
        """Fence every armed ring touching ``comm_id`` (None = all), wake
        their waiters and evict them — the driver's fencing contract,
        and what resilience calls on abort and rebuild."""
        with self._plan_cv:
            keep = []
            for ring in self._plan_rings:
                if comm_id is None or comm_id in ring.comm_gens:
                    self._invalidate_ring(ring, reason)
                else:
                    keep.append(ring)
            self._plan_rings = keep

    def release_ring(self, ring: PlanRing) -> None:
        """Drop one rank's handle on a ring (its plan was closed or
        collected); when the LAST holder releases, the ring is fenced,
        evicted and its pinned slots dropped."""
        with ring.cv:
            ring.refs -= 1
            if ring.refs > 0:
                return
        self._invalidate_ring(ring, "plan released")
        with self._plan_cv:
            if ring in self._plan_rings:
                self._plan_rings.remove(ring)
        ring.slots = []

    def _arm_auto_ring(self, scenario: int, comm_id: int,
                       gang: dict) -> None:
        """ACCL_PLAN_AUTO: every member of this gang instance carried plan
        intent — arm a one-slot ring from the gang's descriptors and
        publish it on each member's request (the driver adopts it after
        completion, so every rank switches on the SAME instance).  A
        failure leaves the gang on its eager path, where the same plan
        error then fails it (tpu.py:1401)."""
        if any(c.stream_flags for c, _r in gang.values()):
            return  # stream operands are not replayable (tpu.py:1121)
        try:
            gang2 = {g: (c, None) for g, (c, _r) in gang.items()}
            ring = PlanRing(
                [self._gang_slot(Operation(scenario), comm_id, gang2)],
                frozenset(self._comms[comm_id]),
                {comm_id: self._comm_gen.get(comm_id, 0)})
            with self._plan_cv:
                self._plan_rings.append(ring)
            for _c, req in gang.values():
                req.plan_ring = ring
            self.metrics.inc("plan_auto_captures")
        except Exception as e:
            self._log.warning("plan auto-capture failed: %s", e)

    # -- kernel streams (tpu.py:1968-1995) -------------------------------
    def _refuse_capture(self, what: str) -> None:
        """A queue pop or push cannot be a node of a CUDA graph: under
        capture a stream call raises, as a plan arm refuses stream
        traffic."""
        if self.device.type == "cuda" \
                and torch.cuda.is_current_stream_capturing():
            raise ACCLError(f"{what} under CUDA graph capture: kernel "
                            f"streams are not capturable — keep stream "
                            f"traffic eager")

    def _event(self, dev: torch.device):
        """An event recorded on ``dev``'s current stream (None off the
        card): what a consumer on another stream waits for."""
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def _joined(self, item) -> torch.Tensor:
        """A queue operand, with its card's current stream made to wait
        for its host-to-device copy."""
        t, ev = item[0], item[-1]
        if ev is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(ev)
            t.record_stream(stream)
        return t

    def push_krnl(self, rank: int, data: np.ndarray) -> None:
        """Queue one operand for the rank's next OP0_STREAM call, on the
        device as a tensor."""
        self._refuse_capture("push_krnl")
        # a copy: the operand is what the array holds now
        arr = np.array(data).reshape(-1)
        dev = self.device_of(rank)
        t = torch.from_numpy(arr).to(dev)
        self._krnl_in[rank].append((t, arr.dtype, self._event(dev)))

    def _push_stream(self, rank: int, strm: int, data: torch.Tensor) -> None:
        """Deliver ``data`` into (rank, strm)'s kernel stream and wake the
        waiters: the one delivery point of every RES_STREAM path (local
        copy, stream_put, receive landing, gang results).  The message
        carries the event recorded after the work that made it."""
        ev = self._event(data.device)
        with self._stream_cv:
            self._streams.setdefault((rank, strm), deque()).append(
                (data, ev))
            self._stream_cv.notify_all()

    def pop_stream(self, rank: int, strm: int,
                   timeout_s: float) -> Optional[np.ndarray]:
        """The next message of (rank, strm) as a host array, once the
        device work that made it is done; None on timeout."""
        key = (rank, strm)
        with self._stream_cv:
            if not self._stream_cv.wait_for(lambda: self._streams.get(key),
                                            timeout=timeout_s):
                return None
            data, ev = self._streams[key].popleft()
        if ev is not None:
            ev.synchronize()
        return data.cpu().numpy()

    # -- resilience (tpu.py:883-987) -------------------------------------
    def _drain_comm(self, comm_id: int) -> tuple:
        """Under the lock: pop every partial gang and p2p entry of
        ``comm_id`` and its cached gang plans, bump its fence generation.
        Returns (entries evicted, requests to complete)."""
        self._comm_gen[comm_id] = self._comm_gen.get(comm_id, 0) + 1
        evicted, drained = 0, []
        for key in [k for k in self._gangs
                    if (k[0] == "coll" and k[2] == comm_id)
                    or (k[0] == "p2p" and k[1] == comm_id)]:
            for entry in self._gangs.pop(key):
                evicted += 1
                if key[0] == "coll":  # rank -> (call, request)
                    drained.extend(req for _c, req in entry.values())
                elif entry[0] == "recv":  # ("recv", tag, (rank, call, req))
                    drained.append(entry[2][2])
        for sig in [sig for sig in self._gang_plans if sig[1] == comm_id]:
            del self._gang_plans[sig]
            evicted += 1
        return evicted, drained

    def abort_comm(self, comm_id: int, err_bits: int) -> bool:
        """Abort ``comm_id``: later submits on it complete with
        ``err_bits``, its rings are fenced, and its partial gangs and
        pending receives complete with ``err_bits`` now, so every blocked
        waiter wakes.  A gang that is complete runs to the end (it has
        every member); a partial one never launched anything."""
        with self._lock:
            self._aborted_comms[comm_id] = err_bits
            _n, drained = self._drain_comm(comm_id)
        self.invalidate_rings(comm_id, "communicator aborted")
        for req in drained:
            if not req.done:
                req.complete(err_bits, 0.0)
        return True

    def comm_count(self) -> int:
        """Comm slots the engine knows: a joiner pads its driver's table
        to this before the grown comm is uploaded."""
        with self._lock:
            return (max(self._comms) + 1) if self._comms else 0

    def export_join_state(self, comm_id: int = 0) -> dict:
        """The sponsor's state for an in-process joiner: the comm-slot
        count, the abort fences and the members of ``comm_id`` (the
        engine is the control plane, so the wire exchange of the native
        emulator collapses to this dict)."""
        with self._lock:
            return {"comm_count": (max(self._comms) + 1) if self._comms
                    else 0,
                    "aborted": dict(self._aborted_comms),
                    "members": list(self._comms.get(comm_id, []))}

    def rebuild_gang_tables(self, comm_id: int) -> int:
        """Drop every partial gang, pending receive and cached gang plan
        of ``comm_id`` (the grow path: a successor must assemble against
        a clean table) and fence its rings; returns how many entries went.
        Their requests complete with the comm's abort bits
        (``COMM_ABORTED`` when it was never aborted)."""
        with self._lock:
            err = self._aborted_comms.get(comm_id,
                                          int(ErrorCode.COMM_ABORTED))
            evicted, drained = self._drain_comm(comm_id)
        self.invalidate_rings(comm_id, "gang tables rebuilt (grow)")
        for req in drained:
            if not req.done:
                req.complete(err, 0.0)
        return evicted

    def reset_comm_errors(self) -> None:
        """Clear the abort fences (the driver's reset_errors) and fence
        every ring: a healed world re-captures."""
        with self._lock:
            self._aborted_comms.clear()
        self.invalidate_rings(None, "reset_errors")

    # -- hang diagnosis (tpu.py:1441-1492) -------------------------------
    def start_watchdog(self, recorders, abort_hook=None
                       ) -> Optional[_health.Watchdog]:
        """Arm the hang watchdog over the world's flight recorders
        (``ACCL_WATCHDOG_TIMEOUT`` seconds; 0 disables); a fire report
        embeds :meth:`gang_assembly_snapshot`, and under
        ``ACCL_WATCHDOG_ACTION=abort`` ``abort_hook(comm, report)`` aborts
        the hung communicator."""
        if self._watchdog is None:
            self._watchdog = _health.Watchdog(
                recorders, introspect=self.gang_assembly_snapshot,
                name="accl-cuda", abort_hook=abort_hook).start()
        return self._watchdog

    def gang_assembly_snapshot(self) -> list:
        """Every partial gang still assembling: which ranks arrived,
        which members are missing, the oldest arrival's age; and every
        unmatched send or recv of the p2p channels."""
        now = _trace.now_ns()
        with self._lock:
            items = [(k, ([dict(g) for g in q] if k[0] == "coll"
                          else [(e[0], e[1]) for e in q]))
                     for k, q in self._gangs.items() if q]
        out = []
        for key, gangs in items:
            if key[0] == "coll":
                _kind, scenario, comm_id, tag = key
                members = self._comms.get(comm_id, [])
                for gang in gangs:
                    recs = [req.flight for _c, req in gang.values()
                            if req.flight is not None]
                    out.append({
                        "kind": "collective",
                        "collective": Operation(scenario).name,
                        "comm": comm_id, "tag": tag,
                        "arrived": sorted(gang),
                        "missing": [m for m in members if m not in gang],
                        "oldest_age_us": round(max(
                            (r.age_ns(now) for r in recs), default=0)
                            / 1e3, 1),
                    })
            else:
                _kind, comm_id, src, dst = key
                for kind, tag in gangs:
                    out.append({"kind": kind, "comm": comm_id, "src": src,
                                "dst": dst, "tag": tag})
        return out

    def shutdown(self) -> None:
        # a replay after close raises at once instead of waiting out its
        # generation
        self.invalidate_rings(None, "engine shut down")
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        with self._ready_cv:
            self._shutdown = True
            self._ready_cv.notify_all()
        self._exec_thread.join(timeout=10)


class CudaDeviceView(CCLODevice):
    """One rank's handle on the shared CudaEngine."""

    #: every rank uploads to the one engine's communicator table
    #: (tpu.py:2285): a rank outside a group burns its id driver-side
    comm_table_is_shared = True

    def __init__(self, engine: CudaEngine, rank: int):
        self._engine = engine
        self._rank = rank

    def start(self, call: CCLOCall, request: Request) -> None:
        self._engine.submit(self._rank, call, request)

    def sanitizer_domain(self):
        """Every rank of a CudaWorld shares one in-process engine, so its
        identity is the sanitizer's exchange domain and the pool of
        ``capture_plan``'s cross-rank validation (tpu.py:2295)."""
        return ("cuda", id(self._engine))

    # -- persistent plans: the engine's shared ring (tpu.py:2428-2450)
    def arm_plan(self, calls, expected, timeout_s: float) -> PlanRing:
        return self._engine.arm_plan(self._rank, calls, expected, timeout_s)

    def plan_replay(self, ring: PlanRing, run_async: bool = False,
                    timeout_s: float = 60.0) -> int:
        return self._engine.ring_replay(self._rank, ring, run_async,
                                        timeout_s)

    def plan_wait(self, ring: PlanRing, token: int, timeout_s: float) -> bool:
        return self._engine.ring_wait(ring, token, timeout_s)

    def invalidate_plans(self, comm_id: int = -1) -> None:
        """Fence the engine's rings on ``comm_id`` (-1: every ring)."""
        self._engine.invalidate_rings(
            None if comm_id < 0 else comm_id,
            "invalidated by the driver")

    def plan_release(self, ring: PlanRing) -> None:
        """Release a dead plan's ring (the plan's finalizer)."""
        self._engine.release_ring(ring)

    # -- resilience: the ranks share one engine, so one abort covers the
    # world with no propagation (tpu.py:2440-2477)
    def abort_comm(self, comm_id: int, err_bits: int) -> bool:
        return self._engine.abort_comm(comm_id, err_bits)

    def join_sync(self, sponsor_session: int, timeout_s: float = 10.0) -> int:
        """In-process join: the engine is the control plane, so the
        sponsor cannot be deaf and epochs are already shared (0)."""
        return 0

    def comm_count(self) -> int:
        return self._engine.comm_count()

    def export_join_state(self, comm_id: int = 0) -> dict:
        return self._engine.export_join_state(comm_id)

    def rebuild_gang_tables(self, comm_id: int) -> int:
        return self._engine.rebuild_gang_tables(comm_id)

    def reset_errors(self) -> None:
        self._engine.reset_comm_errors()

    @property
    def engine_metrics(self) -> _metrics.MetricsRegistry:
        """The shared engine's registry (ACCL.metrics() merges its
        dispatch-lane counters under engine/ keys)."""
        return self._engine.metrics

    def engine_stats(self) -> dict:
        """Engine stats in the key set of the reference's TPU view
        (tpu.py:2308-2345): the live plan rings (``plans_live``), the
        handles pinning them (``plan_ring_refs``), the highest comm fence
        generation, their replays, and the dispatch-lane, batch and plan
        counters."""
        eng = self._engine
        counters = eng.metrics.counters()
        with eng._plan_cv:
            rings = [r for r in eng._plan_rings if r.invalid is None]
            plan_ring_refs = sum(r.refs for r in rings)
            ring_replays = sum(r.replays for r in rings)
        with eng._ready_cv:
            ready_depth = len(eng._ready)
        with eng._lock:
            gen = max(eng._comm_gen.values(), default=0)
        link_rows = sum(1 for (src, _c, _p) in eng._link_table()
                        if src == self._rank)
        return {
            "version": 3,
            "link_rows": link_rows,
            "compressed_tx_bytes": counters.get("compressed_tx_bytes", 0),
            "compressed_tx_logical_bytes":
                counters.get("compressed_tx_logical_bytes", 0),
            "plans_live": len(rings),
            "plan_ring_refs": plan_ring_refs,
            "plan_ring_generation": gen,
            "plan_ring_replays": ring_replays,
            "plan_replays": counters.get("plan_replays", 0),
            "plan_auto_captures": counters.get("plan_auto_captures", 0),
            "leader_dispatches": counters.get("leader_dispatches", 0),
            "executor_dispatches": counters.get("executor_dispatches", 0),
            "batches": counters.get("batches", 0),
            "batched_gangs": counters.get("batched_gangs", 0),
            "ready_depth": ready_depth,
        }

    def link_stats(self) -> list:
        """This rank's link rows from the engine's link twin."""
        return self._engine.link_stats_for(self._rank)

    def gang_assembly_snapshot(self) -> list:
        return self._engine.gang_assembly_snapshot()

    def create_buffer(self, length: int, dtype: np.dtype) -> BaseBuffer:
        return self._engine.create_buffer(self._rank, length, dtype)

    def push_krnl(self, data: np.ndarray) -> None:
        self._engine.push_krnl(self._rank, data)

    def pop_stream(self, strm: int, nbytes: int,
                   timeout_s: float = 10.0) -> Optional[bytes]:
        arr = self._engine.pop_stream(self._rank, strm, timeout_s)
        return None if arr is None else arr.tobytes()[:nbytes]

    def setup_rx_buffers(self, n_bufs: int, buf_size: int) -> None:
        pass  # no rx pool: the engine moves payloads within device memory

    def upload_communicator(self, comm: Communicator) -> int:
        return self._engine.set_comm(comm)

    def upload_arithconfig(self, cfg: ArithConfig) -> int:
        return self._engine.register_arithcfg(cfg)

    def set_tuning(self, key: int, value: int) -> None:
        """RING_THRESHOLD_BYTES is live; the flat-tree registers are
        stored as hints (ACCL.set_tuning validated the key)."""
        if key == int(TuningKey.RING_THRESHOLD_BYTES):
            self._engine.ring_threshold_bytes = int(value)
        else:
            self._engine.tuning_registers[int(key)] = int(value)


class CudaWorld:
    """N ranks: per-rank ACCL handles over one CudaEngine, and
    ``run(fn)``, which calls ``fn(accl, rank)`` on one thread per rank.
    The ranks share ``device`` (the card by default; without CUDA that
    raises), or with ``devices`` rank r sits on ``devices[r]`` (the twin
    of ``TpuWorld(nranks, devices=)``): at least ``nranks`` entries, one
    card may hold several ranks, every pair of cards needs peer access;
    ``["cpu"] * nranks`` runs that world's code path on the CPU."""

    def __init__(self, nranks: int, device="cuda", devices=None):
        dev = (resolve_device(device, "CudaWorld") if devices is None
               else None)
        self.nranks = nranks
        self.online_tuner = None
        self.engine = CudaEngine(nranks, dev, devices)
        self.devices = [CudaDeviceView(self.engine, r) for r in range(nranks)]
        self.accls = [ACCL(d) for d in self.devices]
        self._pool = ThreadPoolExecutor(max_workers=nranks)
        ranks = [Rank(ip="127.0.0.1", port=0, session=r) for r in range(nranks)]
        # an exporter the ranks' bring-up starts is this world's to stop
        had_exporter = _health.exporter_port() is not None
        for r, a in enumerate(self.accls):
            a.initialize(ranks, r)
        self._owns_exporter = (not had_exporter
                               and _health.exporter_port() is not None)
        # the hang watchdog over the ranks' flight recorders (none under
        # ACCL_WATCHDOG_TIMEOUT=0 or ACCL_FLIGHT=0)
        self.engine.start_watchdog(
            [a.flight_recorder for a in self.accls
             if a.flight_recorder is not None],
            abort_hook=self._watchdog_abort)
        # the telemetry sampler (none under ACCL_TELEMETRY_INTERVAL_MS=0,
        # the default): the shared engine is one stats source, so rank
        # 0's view is polled alone; every rank's link rows are
        self.telemetry = _telemetry.sampler_from_env(
            [self.devices[0].engine_stats], name="accl-cuda",
            link_sources=[(r, d.link_stats)
                          for r, d in enumerate(self.devices)])
        # the online tuner (ACCL_TUNE_ONLINE=1, tuning/online.py), as the
        # JAX package's TpuWorld arms it: unset constructs nothing and
        # dispatch stays bit-identical
        from ..tuning import online as _online

        self.online_tuner = _online.ensure_online_tuner_from_env(self)

    def run(self, fn: Callable, *args, timeout: Optional[float] = 300) -> list:
        futures = [self._pool.submit(self._on_device, fn, self.accls[r], r,
                                     *args)
                   for r in range(self.nranks)]
        return [f.result(timeout=timeout) for f in futures]

    def _on_device(self, fn, accl, rank, *args):
        dev = self.engine.device_of(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return fn(accl, rank, *args)

    def _watchdog_abort(self, comm_id: int, report: dict) -> None:
        """The ``ACCL_WATCHDOG_ACTION=abort`` hook (accl_tpu/backends/
        emu.py:1030-1049): abort the hung comm with RANK_FAILED from a
        rank that arrived at its stuck gang."""
        hangs = report.get("analysis", {}).get("hangs", [])
        arrived = next((h["arrived"] for h in hangs
                        if h.get("comm") == comm_id), [])
        for r in list(arrived) or list(range(self.nranks)):
            try:
                self.accls[r].abort(comm_id, error=int(ErrorCode.RANK_FAILED))
                return
            except Exception:  # noqa: BLE001 — try the next arrived rank
                continue

    def link_stats(self) -> dict:
        """rank -> that rank's link rows (the engine's link twin)."""
        return {r: d.link_stats() for r, d in enumerate(self.devices)}

    def link_matrix(self, comm: int = 0,
                    tenant: Optional[str] = None) -> dict:
        """The world's P x P link traffic matrix of one communicator
        (telemetry.link_matrix).  ``tenant`` slices by tenant label
        instead: the union of every communicator the drivers label with
        it (tpu.py:2524-2541)."""
        if tenant is not None:
            comms = set()
            for a in self.accls:
                comms.update(a.tenant_comm_ids(tenant))
            doc = _telemetry.link_matrix(self.link_stats(),
                                         nranks=self.nranks, comms=comms)
            doc["tenant"] = tenant
            return doc
        return _telemetry.link_matrix(self.link_stats(), nranks=self.nranks,
                                      comm=comm)

    def close(self) -> None:
        """Stop the online tuner, the telemetry sampler, the watchdog,
        the executor and, when this world's bring-up started it, the
        OpenMetrics exporter.  The tuner's loop thread stops first, so
        no A/B runs into the engine's shutdown fence."""
        if self.online_tuner is not None:
            from ..tuning import online as _online

            _online.stop_world_tuner(self)
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        self.engine.shutdown()
        self._pool.shutdown(wait=False)
        if self._owns_exporter:
            _health.stop_exporter()
            self._owns_exporter = False

    def __enter__(self) -> "CudaWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
