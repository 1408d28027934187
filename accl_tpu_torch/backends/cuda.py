"""CUDA backend: one card holds every rank, each rank's buffers are
tensors in its memory.

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

Left out of this port: persistent plans and plan rings, batched async
dispatch, kernel streams, resilience, observability and link accounting
(the int8 lane's wire-byte accounting with it).  A descriptor that asks
for one of them is refused with an ACCLError.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

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
from ..ops import ring as ring_ops
from ..request import Request
from ..utils.device import resolve_device
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

    def __init__(self, host: np.ndarray, device: torch.device, address: int):
        super().__init__(host, address)
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


def _tree_bcast(vs: list, root: int) -> list:
    """Binomial-tree broadcast (the schedule of tpu.py:2038): log2(P)
    rounds of doubling senders; each rank receives the payload once."""
    P = len(vs)
    vs = list(vs)
    k = 1
    while k < P:
        for j in range(k):
            if j + k < P:
                vs[(root + j + k) % P] = vs[(root + j) % P]
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


def _collective_program(op: Operation, nranks: int, in_len: int, root: int,
                        func: int, wire_dtype: str, ring: bool,
                        fused: bool) -> Callable:
    """The program that takes the place of the JAX engine's
    ``_collective_fn`` (tpu.py:2100): a function from the gang's per-rank
    operands ([in_len] each, rank order) to the per-rank results, in the
    same lane order — the fused lane when the descriptor asks for it, the
    quantized ring for the int8 wire spec on the ring lane, the ring
    drivers at or above the threshold, plain torch ops over the rank axis
    below it."""
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
            return q_ops.quantized_all_reduce(vs, wire_block, wire_ef)
        if op == Operation.allgather:
            return q_ops.quantized_ring_all_gather(vs, wire_block)
        return q_ops.quantized_ring_reduce_scatter(vs, wire_block, wire_ef)

    def fused_body(vs: list) -> list:
        # the fused lane owns its wire hops end to end: int8 inside the
        # chunk loop, the cast lanes roundtrip at the endpoints
        # (tpu.py:2177-2199)
        if fused_q:
            w = (wire_block, wire_ef)
            vf = [v.to(torch.float32) for v in vs]
            if op == Operation.allreduce:
                outs = fused_ops.chunked_ring_all_reduce(vf, wire=w)
            elif op == Operation.allgather:
                outs = fused_ops.chunked_ring_all_gather(vf, wire=w)
            else:
                outs = fused_ops.chunked_ring_reduce_scatter(vf, wire=w)
            return [o.to(vs[0].dtype) for o in outs]
        vs = [quant(v) for v in vs]
        if op == Operation.allreduce:
            outs = fused_ops.chunked_ring_all_reduce(vs, red)
        elif op == Operation.allgather:
            outs = fused_ops.chunked_ring_all_gather(vs)
        else:
            outs = fused_ops.chunked_ring_reduce_scatter(vs, red)
        return [quant(o) for o in outs]

    def body(vs: list) -> list:
        if fused:
            return fused_body(vs)
        if q_ring:
            dt = vs[0].dtype
            return [o.to(dt) for o in
                    q_ring_body([v.to(torch.float32) for v in vs])]
        vs = [quant(v) for v in vs]
        if ring:
            if op == Operation.allreduce:
                outs = ring_ops.ring_all_reduce_segmented(vs, red)
            elif op == Operation.allgather:
                outs = ring_ops.ring_all_gather_segmented(vs)
            else:
                outs = ring_ops.ring_reduce_scatter_segmented(vs, red)
        elif op in (Operation.allreduce, Operation.reduce):
            total = reduce_all(vs)
            outs = [total] * nranks
        elif op == Operation.bcast:
            outs = _tree_bcast(vs, root)
        elif op == Operation.gather:
            outs = [_tree_gather(vs, root)] * nranks
        elif op == Operation.allgather:
            outs = [torch.cat(vs)] * nranks
        elif op == Operation.scatter:
            # only the root's operand matters: mask the rest to zero and
            # reduce-scatter, as the JAX lowering does
            masked = [v if r == root else torch.zeros_like(v)
                      for r, v in enumerate(vs)]
            total = torch.stack(masked).sum(0)
            outs = [total[r * n:(r + 1) * n] for r in range(nranks)]
        elif op == Operation.reduce_scatter:
            # SUM: reduce then slice; MAX: reduce fully, keep own chunk
            total = reduce_all(vs)
            outs = [total[r * n:(r + 1) * n] for r in range(nranks)]
        elif op == Operation.alltoall:
            outs = [torch.cat([v[r * n:(r + 1) * n] for v in vs])
                    for r in range(nranks)]
        else:
            raise ACCLError(f"collective {op.name} not lowered")
        return [quant(o) for o in outs]

    return body


class CudaEngine:
    """World-level gang scheduler and collective executor over one
    device (``cuda`` by default; tests pass ``cpu``)."""

    _GANG_PLANS_CAP = 256

    def __init__(self, nranks: int, device="cuda"):
        self.nranks = nranks
        self.device = torch.device(device)
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
        self.stats = {"leader_dispatches": 0, "executor_dispatches": 0}
        self._log = get_logger("accl_tpu_torch.cuda")
        self._exec_thread = threading.Thread(
            target=self._exec_loop, name="accl-gang-exec", daemon=True)
        self._exec_thread.start()

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
            buf = CudaBuffer(host, self.device, addr)
            self._buffers[rank][addr] = buf
            self._bases[rank].append(addr)
        return buf

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
        try:
            if call.stream_flags != StreamFlags.NO_STREAM:
                raise ACCLError("kernel streams are not part of "
                                "accl_tpu_torch yet")
            if scenario == Operation.copy:
                self._exec_copy(rank, call)
                request.complete(0, 1.0)
            elif scenario == Operation.combine:
                self._exec_combine(rank, call)
                request.complete(0, 1.0)
            elif scenario == Operation.send:
                self._submit_send(rank, call, request)
            elif scenario == Operation.recv:
                self._submit_recv(rank, call, request)
            else:
                self._submit_collective(rank, call, request)
        except Exception as e:  # surface as an engine error, not a hang
            request.description += f" [{e}]"
            request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)

    # -- local ops -----------------------------------------------------
    def _exec_copy(self, rank: int, call: CCLOCall) -> None:
        n = call.count
        src, soff = self.resolve(rank, call.addr_0)
        dst, doff = self.resolve(rank, call.addr_2)
        vals = src.dev[soff:soff + n]
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
        src, soff = self.resolve(rank, call.addr_0)
        # buffered eager semantics: the payload is captured now, the
        # sender completes, delivery happens when the matching recv comes
        data = src.dev[soff:soff + call.count].clone()
        if call.compression_flags & CompressionFlags.ETH_COMPRESSED:
            data = _wire_roundtrip(data, self.wire_dtype_for(call.arithcfg))
        dst_rank = self._comms[call.comm][call.root_src_dst]
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
                if call.compression_flags & CompressionFlags.ETH_COMPRESSED:
                    moved = _wire_roundtrip(moved,
                                            self.wire_dtype_for(call.arithcfg))
                dst.dev[doff:doff + moved.shape[0]].copy_(moved)
            except Exception as e:
                request.description += f" [{e}]"
                request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)
                continue
            request.complete(0, 1.0)

    # -- collectives ---------------------------------------------------
    def _submit_collective(self, rank: int, call: CCLOCall,
                           request: Request) -> None:
        P = len(self._comms[call.comm])
        gkey = ("coll", int(call.scenario), call.comm, call.tag)
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
            self._dispatch_gang(int(call.scenario), call.comm, ready, request)

    def _dispatch_gang(self, scenario: int, comm_id: int, gang: dict,
                       leader_req: Request) -> None:
        """Leader dispatch (tpu.py:696): when every member blocks on the
        gang, the last-arriving rank runs it inline — deferred to its
        Request.wait, out of its submission lock — provided the engine
        is idle; otherwise the gang goes to the executor queue.  Either
        way gangs run one at a time in completion order."""
        if all(req.sync for _c, req in gang.values()):
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
                    self.stats["leader_dispatches"] += 1
                    self._exec_gang(scenario, comm_id, gang)
                finally:
                    with self._ready_cv:
                        self._inline_busy = False
                        if self._ready or self._shutdown:
                            self._ready_cv.notify()

            leader_req.pre_wait = run_inline
            return
        self._enqueue_ready(scenario, comm_id, gang)

    def _enqueue_ready(self, scenario: int, comm_id: int, gang: dict) -> None:
        with self._ready_cv:
            self._ready.append((scenario, comm_id, gang))
            self._ready_cv.notify()

    def _exec_loop(self) -> None:
        """The executor thread (tpu.py:1494); parks while an inline
        dispatch runs."""
        while True:
            with self._ready_cv:
                while not (self._ready and not self._inline_busy):
                    if self._shutdown and not self._ready:
                        return
                    self._ready_cv.wait()
                scenario, comm_id, gang = self._ready.popleft()
                self._exec_busy = True
            try:
                self.stats["executor_dispatches"] += 1
                self._exec_gang(scenario, comm_id, gang)
            finally:
                with self._ready_cv:
                    self._exec_busy = False
                    self._ready_cv.notify_all()

    def _exec_gang(self, scenario: int, comm_id: int, gang: dict) -> None:
        try:
            dt_ns = self._run_collective(Operation(scenario), comm_id, gang)
        except Exception as e:
            self._log.debug("gang %s failed: %s", Operation(scenario).name, e)
            for _call, request in gang.values():
                request.description += f" [{e}]"
                request.complete(int(ErrorCode.DMA_INTERNAL_ERROR), 0.0)
            return
        for _call, request in gang.values():
            request.complete(0, float(dt_ns))

    def _gang_plan(self, op: Operation, comm_id: int, gang: dict) -> dict:
        """Resolve one gang signature into an execution plan (buffers,
        datapath dtype, operand length, ring decision, program) and cache
        it (tpu.py:1676): a training loop's repeated descriptors pay this
        once.  The threshold is in the signature, so changing it
        re-plans."""
        members = self._comms[comm_id]
        sig = (int(op), comm_id, self.ring_threshold_bytes, tuple(
            (g, c.addr_0, c.addr_2, c.count, c.root_src_dst, c.function,
             c.compression_flags, c.arithcfg, c.tag, c.fused)
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
        if dtype is None and op != Operation.barrier:
            raise ACCLError("collective addresses no buffer: cannot derive "
                            "the datapath dtype")
        ops = []
        for li, g in enumerate(members):
            call = gang[g][0]
            # operand: op0 for contributors; a bcast non-root contributes
            # its result buffer as a placeholder
            buf, off = self.resolve(g, call.addr_0)
            if buf is None:
                buf, off = self.resolve(g, call.addr_2)
            write_out = not (op in (Operation.reduce, Operation.gather)
                             and li != root)
            res, roff = self.resolve(g, call.addr_2)
            ops.append((buf, off, res if write_out else None, roff))
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
            "in_len": in_len,
            "dtype": None if dtype is None else torch_dtype(dtype),
            "ops": ops,
            "ring": ring,
            "program": (None if op == Operation.barrier else
                        _collective_program(op, nranks, in_len, root,
                                            any_call.function, wire_dtype,
                                            ring, fused)),
        }
        with self._lock:
            self._gang_plans[sig] = plan
            while len(self._gang_plans) > self._GANG_PLANS_CAP:
                self._gang_plans.popitem(last=False)
        return plan

    def _run_collective(self, op: Operation, comm_id: int, gang: dict) -> int:
        """Gather the gang's operands (views of the rank buffers where the
        dtype and length allow), run the program, write each result into
        its rank's buffer.  Returns the program's host duration in ns: on
        the card that is the enqueue, not the device time."""
        if op == Operation.barrier:
            return 0  # gang completion is the synchronization
        plan = self._gang_plan(op, comm_id, gang)
        in_len, dtype = plan["in_len"], plan["dtype"]
        xs = []
        for buf, off, _res, _roff in plan["ops"]:
            shard = buf.dev[off:off + in_len]
            if shard.dtype != dtype:
                shard = shard.to(dtype)
            if shard.shape[0] < in_len:  # placeholder short buffer (bcast)
                pad = shard.new_zeros(in_len - shard.shape[0])
                shard = torch.cat([shard, pad])
            xs.append(shard)
        t0 = time.perf_counter_ns()
        ys = plan["program"](xs)
        t1 = time.perf_counter_ns()
        for (_buf, _off, res, roff), y in zip(plan["ops"], ys):
            if res is not None:
                res.dev[roff:roff + y.shape[0]].copy_(y)
        return t1 - t0

    def shutdown(self) -> None:
        with self._ready_cv:
            self._shutdown = True
            self._ready_cv.notify_all()
        self._exec_thread.join(timeout=10)


class CudaDeviceView(CCLODevice):
    """One rank's handle on the shared CudaEngine."""

    def __init__(self, engine: CudaEngine, rank: int):
        self._engine = engine
        self._rank = rank

    def start(self, call: CCLOCall, request: Request) -> None:
        self._engine.submit(self._rank, call, request)

    def create_buffer(self, length: int, dtype: np.dtype) -> BaseBuffer:
        return self._engine.create_buffer(self._rank, length, dtype)

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
    """N ranks on one device: per-rank ACCL handles over one CudaEngine,
    and ``run(fn)``, which calls ``fn(accl, rank)`` on one thread per
    rank.  ``device`` defaults to the card; without CUDA that raises."""

    def __init__(self, nranks: int, device="cuda"):
        dev = resolve_device(device, "CudaWorld")
        self.nranks = nranks
        self.engine = CudaEngine(nranks, dev)
        self.devices = [CudaDeviceView(self.engine, r) for r in range(nranks)]
        self.accls = [ACCL(d) for d in self.devices]
        self._pool = ThreadPoolExecutor(max_workers=nranks)
        ranks = [Rank(ip="127.0.0.1", port=0, session=r) for r in range(nranks)]
        for r, a in enumerate(self.accls):
            a.initialize(ranks, r)

    def run(self, fn: Callable, *args, timeout: Optional[float] = 300) -> list:
        futures = [self._pool.submit(self._on_device, fn, self.accls[r], r,
                                     *args)
                   for r in range(self.nranks)]
        return [f.result(timeout=timeout) for f in futures]

    def _on_device(self, fn, accl, rank, *args):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        return fn(accl, rank, *args)

    def close(self) -> None:
        self.engine.shutdown()
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "CudaWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
