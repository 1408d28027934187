"""Record-mode backend: capture collective programs with zero execution.

Port of ``accl_tpu/analysis/record.py`` over the port's ``ACCL``.
:class:`LintDevice` implements the ``CCLODevice`` surface but moves no
data: every call descriptor completes instantly with retcode 0 and is
appended to the rank's
:class:`~accl_tpu_torch.analysis.program.CollectiveProgram`.  Unmodified
driver code — the same ``fn(accl, rank)`` bodies ``CudaWorld`` runs —
therefore executes in microseconds and leaves behind exactly the
per-rank descriptor streams the static checkers reason about.  (Do not
assert on result DATA under record mode: buffers stay zero.  Programs
that verify payloads are linted by a shadow
:class:`~accl_tpu_torch.analysis.sanitizer.CaptureSession` on a real
world.)

:class:`LintWorld` is the ``CudaWorld``-shaped harness over N
LintDevices; ``run(fn)`` + ``check()`` is the whole API:

    world = LintWorld(4)
    world.run(my_rank_fn)
    for f in world.check():
        print(f.render())
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..accl import ACCL
from ..arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from ..backends.base import CCLODevice
from ..buffer import BaseBuffer
from ..communicator import Communicator, Rank
from ..constants import DATA_TYPE_SIZE, CCLOCall, CfgFunc, DataType, Operation
from ..observability import trace as _trace
from ..request import Request
from .checks import check_programs
from .program import CollectiveProgram, RecordedCall

#: reverse map of the default arithcfg table: config -> the
#: (uncompressed, compressed) dtype pair, so the record backend can label
#: calls with real dtype names instead of raw table ids
_CFG_TO_PAIR = {cfg: pair for pair, cfg in DEFAULT_ARITH_CONFIG.items()}


class LintBuffer(BaseBuffer):
    """Host-only numpy span with a fake (never reused) device address."""

    def __init__(self, host: np.ndarray, device: "LintDevice",
                 address: int, owner: bool = True, host_only: bool = False):
        super().__init__(host, address)
        self._device = device
        self._owner = owner
        self._host_only = host_only

    @property
    def is_host_only(self) -> bool:
        return self._host_only

    def sync_to_device(self) -> None:
        pass

    def sync_from_device(self) -> None:
        pass

    def slice(self, start: int, end: int) -> "LintBuffer":
        itemsize = self._host.itemsize
        return LintBuffer(self._host[start:end], self._device,
                          self._address + start * itemsize, owner=False,
                          host_only=self._host_only)

    def free(self) -> None:
        if self._owner:
            self._device.free_mem(self._address)


class LintDevice(CCLODevice):
    """The no-execution ``CCLODevice``: every start() records + completes."""

    def __init__(self, rank: int, nranks: int,
                 program: Optional[CollectiveProgram] = None):
        self.rank = rank
        self.nranks = nranks
        self.program = program if program is not None \
            else CollectiveProgram(rank, nranks)
        self._arith_pairs: dict = {}   # table id -> (DataType, DataType)
        self._next_arith = 0
        # bump allocator: addresses are NEVER reused, so a freed range
        # referenced later is attributable to exactly one allocation
        self._next_addr = 0x1000
        self.max_eager_size = 0

    # -- call path ----------------------------------------------------
    def start(self, call: CCLOCall, request: Request) -> None:
        op = Operation(call.scenario)
        if op == Operation.config:
            # configuration is driver bring-up, not program content; the
            # eager threshold is kept for protocol-accurate deadlock sim
            if call.function == int(CfgFunc.set_max_eager_msg_size):
                self.max_eager_size = call.count
            request.complete(0, 0.0)
            return
        pair = self._arith_pairs.get(call.arithcfg)
        dtype = pair[0].name if pair else f"arithcfg{call.arithcfg}"
        wire = pair[1].name if pair else dtype
        elem_bytes = (DATA_TYPE_SIZE[pair[0]] // 8) if pair else 4
        rec = request.flight
        self.program.calls.append(RecordedCall(
            index=len(self.program.calls), rank=self.rank, op=op,
            comm=call.comm, root=call.root_src_dst,
            function=call.function, tag=call.tag, count=call.count,
            arithcfg=call.arithcfg,
            compression=int(call.compression_flags),
            stream_flags=int(call.stream_flags), addr0=call.addr_0,
            addr1=call.addr_1, addr2=call.addr_2, dtype=dtype,
            wire_dtype=wire, elem_bytes=elem_bytes,
            run_async=not request.sync, desc=request.description,
            flight_seq=rec.seq if rec is not None else -1,
            request=request))
        if rec is not None:
            rec.mark_dispatched("lint", _trace.now_ns())
        request.complete(0, 0.0)

    # -- device memory (bump allocator, no storage) --------------------
    def alloc_mem(self, nbytes: int, alignment: int = 64) -> int:
        addr = (self._next_addr + alignment - 1) // alignment * alignment
        self._next_addr = addr + max(nbytes, 1)
        self.program.record_alloc(addr, nbytes)
        return addr

    def free_mem(self, address: int) -> None:
        self.program.record_free(address)

    # -- buffers ------------------------------------------------------
    def create_buffer(self, length: int, dtype: np.dtype,
                      host_only: bool = False) -> BaseBuffer:
        host = np.zeros(length, dtype=dtype)
        addr = self.alloc_mem(max(host.nbytes, 1))
        return LintBuffer(host, self, addr, host_only=host_only)

    # -- configuration ------------------------------------------------
    def setup_rx_buffers(self, n_bufs: int, buf_size: int) -> None:
        pass

    def upload_communicator(self, comm: Communicator) -> int:
        # global identity rides the session field of each rank row (the
        # worlds populate it the same way), so sub-communicator
        # membership translates back to world ranks for the checkers
        self.program.record_comm(
            comm.id, [r.session for r in comm.ranks])
        return comm.id

    def upload_arithconfig(self, cfg: ArithConfig) -> int:
        aid = self._next_arith
        self._next_arith += 1
        # a custom config (the int8 pair) is labelled by no dtype
        self._arith_pairs[aid] = _CFG_TO_PAIR.get(
            cfg, (DataType.none, DataType.none))
        return aid

    def close(self) -> None:
        pass


class LintWorld:
    """N recorded ranks, ``CudaWorld``-shaped.

    ``run(fn)`` executes ``fn(accl, rank, *args)`` for every rank
    SEQUENTIALLY — record-mode calls never block, so thread-pool
    concurrency would only make the capture nondeterministic.
    """

    def __init__(self, nranks: int, initialize: bool = True):
        self.nranks = nranks
        self.programs = {r: CollectiveProgram(r, nranks)
                         for r in range(nranks)}
        self.devices = [LintDevice(r, nranks, self.programs[r])
                        for r in range(nranks)]
        self.accls = [ACCL(d) for d in self.devices]
        if initialize:
            ranks = [Rank(ip="127.0.0.1", port=0, session=r)
                     for r in range(nranks)]
            for r, a in enumerate(self.accls):
                a.initialize(ranks, r)

    def run(self, fn: Callable, *args) -> list:
        return [fn(self.accls[r], r, *args) for r in range(self.nranks)]

    def check(self) -> list:
        """Run the full static checker suite over the captured programs
        (protocol-accurate eager threshold from the recorded config)."""
        eager = min((d.max_eager_size for d in self.devices), default=0)
        return check_programs(self.programs, eager_threshold=eager)

    def close(self) -> None:
        for a in self.accls:
            a.deinit()

    def __enter__(self) -> "LintWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def record_program(fn: Callable, nranks: int) -> "LintWorld":
    """One-shot convenience: run ``fn(accl, rank)`` under a fresh
    LintWorld and return the world (``.programs`` / ``.check()``)."""
    world = LintWorld(nranks)
    world.run(fn)
    return world
