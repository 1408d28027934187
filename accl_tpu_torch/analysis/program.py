"""Collective program capture: the data model the sanitizer lints.

Port of ``accl_tpu/analysis/program.py``, whole.

A :class:`CollectiveProgram` is one rank's ordered record of every call
descriptor it marshalled — op, communicator, root, count, dtype pair,
operand address ranges, async-ness — plus its communicator tables and
alloc/free event log.  It is produced two ways:

- **record mode** — :class:`~accl_tpu_torch.analysis.record.LintDevice`
  implements the ``CCLODevice`` surface with no data movement and
  captures the program from unmodified driver code (the ACCL+ idea of
  validating collective programs against a simulator before hardware,
  arxiv 2312.11742, taken one step further: no simulation at all, just
  the descriptor stream);
- **shadow mode** — a
  :class:`~accl_tpu_torch.analysis.sanitizer.CaptureSession` records the same
  facts while the calls execute on a real backend.

Both feed :func:`accl_tpu_torch.analysis.checks.check_programs`, which — like
HiCCL's separation of logical collective composition from execution
(arxiv 2408.05962) — reasons about the *composition* symbolically:
issue order, parameter agreement, send/recv matching, buffer hazards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..constants import (
    GANG_OPERATIONS,
    TAG_ANY,
    CCLOCall,
    CompressionFlags,
    Operation,
)

#: operations that reference no operand memory at all
_NO_OPERAND_OPS = frozenset((Operation.barrier, Operation.nop,
                             Operation.config))

#: per-operation extent multipliers: how many ``count``-element payloads
#: each operand role spans (``P`` = communicator size).  Mirrors the
#: sync_in/sync_out sizing in the driver's collective entry points
#: (accl.py) — the descriptor carries the per-rank count, the engine
#: derives each operand's true span from the op semantics.
def _extent_counts(op: Operation, nranks: int) -> dict:
    P = nranks
    if op in (Operation.scatter, Operation.reduce_scatter):
        return {"op0": P, "op1": 1, "res": 1}
    if op in (Operation.gather, Operation.allgather):
        return {"op0": 1, "op1": 1, "res": P}
    if op == Operation.alltoall:
        return {"op0": P, "op1": 1, "res": P}
    return {"op0": 1, "op1": 1, "res": 1}


@dataclass
class RecordedCall:
    """One captured call descriptor with the facts the checkers need."""

    index: int                    # position in this rank's program
    rank: int                     # issuing rank (global)
    op: Operation
    comm: int
    root: int                     # root_src_dst word (root / src / dst)
    function: int
    tag: int
    count: int
    arithcfg: int
    compression: int
    stream_flags: int
    addr0: int
    addr1: int
    addr2: int
    dtype: str                    # uncompressed dtype label ("float32")
    wire_dtype: str               # compressed/wire dtype label
    elem_bytes: int
    run_async: bool
    desc: str = ""
    flight_seq: int = -1          # flight-recorder seq when armed
    request: Optional[object] = None  # the live Request (leak check)

    @property
    def is_gang(self) -> bool:
        return self.op in GANG_OPERATIONS

    @property
    def is_p2p(self) -> bool:
        return self.op in (Operation.send, Operation.recv)

    def signature(self) -> tuple:
        """Cross-rank agreement fingerprint: every descriptor field all
        ranks of a collective must derive identically.  Deliberately
        EXCLUDED because they are legitimately per-rank: operand
        addresses, per-operand compression bits (only the ROOT of a
        compressed rooted collective marks its buffers — _build's
        flag_operands), stream flags (mem<->stream variants are a
        per-rank choice) and the tag (gang tags are TAG_ANY except the
        root-only RES_STREAM lane).  Of the compression word only the
        WIRE format bit must agree."""
        eth = int(self.compression) & int(CompressionFlags.ETH_COMPRESSED)
        return (self.op.name, self.count, self.root, self.function,
                self.dtype, self.wire_dtype, eth)

    def operand_extents(self, nranks: int) -> list:
        """``(role, address, nbytes)`` for every present operand.
        Dummy operands (address 0) are absent by construction."""
        if self.op in _NO_OPERAND_OPS:
            return []
        mult = _extent_counts(self.op, nranks)
        out = []
        for role, addr in (("op0", self.addr0), ("op1", self.addr1),
                           ("res", self.addr2)):
            if addr != 0:
                out.append((role, addr,
                            self.count * mult[role] * self.elem_bytes))
        return out

    def describe(self) -> str:
        extra = f", root={self.root}" if self.op in (
            Operation.bcast, Operation.scatter, Operation.gather,
            Operation.reduce) else ""
        peer = (f", dst={self.root}" if self.op == Operation.send
                else f", src={self.root}" if self.op == Operation.recv
                else "")
        fn = (f", fn={self.function}" if self.op in (
            Operation.reduce, Operation.allreduce,
            Operation.reduce_scatter, Operation.combine) else "")
        wire = (f", wire={self.wire_dtype}"
                if self.wire_dtype != self.dtype else "")
        return (f"{self.op.name}(count={self.count}, dtype={self.dtype}"
                f"{wire}{extra}{peer}{fn}, comm={self.comm})")


def tags_match(send_tag: int, recv_tag: int) -> bool:
    """Reference tag semantics: a TAG_ANY recv matches any send tag."""
    return recv_tag == TAG_ANY or send_tag == TAG_ANY \
        or send_tag == recv_tag


def call_fingerprint(call: CCLOCall) -> tuple:
    """The runtime sanitizer's cross-rank agreement key for one raw
    descriptor (the record-mode twin is RecordedCall.signature): the
    descriptor words every rank must derive identically.  Excluded as
    legitimately per-rank: operand addresses, per-operand compression
    bits (root-only on compressed rooted collectives), stream flags and
    the tag (root-only RES_STREAM lane) — only the WIRE format
    (arithcfg + ETH bit) must agree."""
    eth = (int(call.compression_flags)
           & int(CompressionFlags.ETH_COMPRESSED))
    return (int(call.scenario), call.count, call.comm, call.root_src_dst,
            call.function, call.arithcfg, eth)


def fingerprint_str(fp: tuple) -> str:
    try:
        name = Operation(fp[0]).name
    except ValueError:  # pragma: no cover — corrupt descriptor
        name = f"op{fp[0]}"
    return (f"{name}(count={fp[1]}, comm={fp[2]}, root/src/dst={fp[3]}, "
            f"fn={fp[4]}, arithcfg={fp[5]}, wire_compressed={bool(fp[6])})")


@dataclass
class CollectiveProgram:
    """One rank's captured call stream + the context to interpret it."""

    rank: int
    nranks: int
    calls: list = field(default_factory=list)
    #: comm id -> list of member GLOBAL ranks (session ids), in comm
    #: rank order — so comm-local roots translate to global ranks
    comms: dict = field(default_factory=dict)
    #: address -> (nbytes, alloc_index); lint allocations never reuse
    #: addresses, so a freed range can be attributed unambiguously
    allocs: dict = field(default_factory=dict)
    #: address -> call index at which it was freed
    frees: dict = field(default_factory=dict)

    def record_comm(self, comm_id: int, members: list) -> None:
        self.comms[comm_id] = list(members)

    def comm_members(self, comm_id: int) -> list:
        """Global ranks of a communicator; unknown comms fall back to
        the world so checks degrade gracefully on partial captures."""
        return self.comms.get(comm_id, list(range(self.nranks)))

    def record_alloc(self, address: int, nbytes: int) -> None:
        self.allocs[address] = (nbytes, len(self.calls))

    def record_free(self, address: int) -> None:
        self.frees[address] = len(self.calls)

    def gang_calls(self, comm_id: int) -> list:
        return [c for c in self.calls if c.is_gang and c.comm == comm_id]

    def to_dict(self) -> dict:
        """JSON-ready rendering (the accl_lint --json payload)."""
        return {
            "rank": self.rank,
            "nranks": self.nranks,
            "comms": {str(k): v for k, v in self.comms.items()},
            "calls": [{
                "index": c.index, "op": c.op.name, "comm": c.comm,
                "root": c.root, "function": c.function, "tag": c.tag,
                "count": c.count, "dtype": c.dtype,
                "wire_dtype": c.wire_dtype, "async": c.run_async,
                "desc": c.desc, "flight_seq": c.flight_seq,
            } for c in self.calls],
        }
