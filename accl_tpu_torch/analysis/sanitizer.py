"""Runtime collective sanitizer (``ACCL_SANITIZE=1``) + shadow capture.

Port of ``accl_tpu/analysis/sanitizer.py``, whole.  Two consumers share
the single driver hook in ``ACCL._execute`` (one module-bool read on the
off path, the same gating discipline as the trace/flight/metrics
observers):

- **runtime sanitizer** — ``ACCL_SANITIZE=1`` (or :func:`set_enabled`)
  turns on per-call hazard checks *before* dispatch: communicator and
  root/peer validity, operand address-range overlap, and — on backends
  whose ranks share the process (``CudaWorld``, whose ranks share one
  engine) — a cross-rank **call-fingerprint exchange**: every gang call
  posts its descriptor fingerprint to a shared per-(comm, instance) slot
  and compares against its peers, so a mismatched-order / mismatched-
  parameter program raises an ``ACCLError`` naming BOTH divergent calls
  (tagged with their flight-recorder seqs) instead of wedging until the
  watchdog.  Blocking callers additionally wait for full gang agreement
  (bounded by ``ACCL_SANITIZE_TIMEOUT``, default 60 s), which also
  converts a missing-member hang into an immediate error listing the
  arrived/missing rank sets.

- **shadow capture** — :class:`CaptureSession` records every call into
  per-rank :class:`~accl_tpu_torch.analysis.program.CollectiveProgram`
  while it executes on the real backend; ``ACCL.capture_plan`` validates
  its captured program through it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..constants import (
    DATA_TYPE_SIZE,
    GANG_OPERATIONS,
    SANITIZER_ABORT_ERROR,
    ACCLError,
    CCLOCall,
    Operation,
)
from ..observability.trace import now_ns
from ..utils.logging import get_logger
from .program import (
    CollectiveProgram,
    RecordedCall,
    call_fingerprint,
    fingerprint_str,
)

#: rooted collectives + p2p: ops whose root_src_dst must be a member
_ROOTED_OR_P2P = frozenset((
    Operation.bcast, Operation.scatter, Operation.gather,
    Operation.reduce, Operation.send, Operation.recv,
))

#: aliased-operand warnings already emitted (bounded): an in-place
#: collective inside a training loop must warn ONCE, not once per step
_warned_aliases: set = set()

# ---------------------------------------------------------------------------
# gating: one module bool on the hot path
# ---------------------------------------------------------------------------
_enabled = os.environ.get("ACCL_SANITIZE", "0") not in ("", "0")
_capture: Optional["CaptureSession"] = None
_active = _enabled


def _recompute() -> None:
    global _active
    _active = _enabled or _capture is not None


def enabled() -> bool:
    """True when the runtime sanitizer lane is on."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Programmatic twin of ``ACCL_SANITIZE`` (tests toggle this)."""
    global _enabled
    _enabled = bool(on)
    _recompute()


def active() -> bool:
    """The driver's gate: sanitizer on OR a capture session installed."""
    return _active


def barrier_timeout_s() -> float:
    raw = os.environ.get("ACCL_SANITIZE_TIMEOUT", "60")
    try:
        return float(raw)
    except ValueError:
        return 60.0


# ---------------------------------------------------------------------------
# shadow capture
# ---------------------------------------------------------------------------
class CaptureSession:
    """Record calls from a real backend into CollectiveProgram maps.

    One session is process-global (installed via ``with`` or
    :meth:`install`); the driver hook feeds it from every ACCL instance,
    and ranks are identified by the session field of their world-comm
    row — the same global identity LintDevice records.
    """

    def __init__(self):
        self.programs: dict = {}
        self.eager_threshold: int = 1 << 62
        self._lock = threading.Lock()

    def install(self) -> "CaptureSession":
        global _capture
        _capture = self
        _recompute()
        return self

    def uninstall(self) -> None:
        global _capture
        if _capture is self:
            _capture = None
            _recompute()

    def __enter__(self) -> "CaptureSession":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def record(self, accl, call: CCLOCall, desc: str, req,
               run_async: bool) -> None:
        if not accl._communicators:
            return  # pre-bring-up local op: no rank identity to file under
        world = accl.communicator(0)
        rank = world.ranks[world.local_rank].session
        pair = accl._arith_pairs.get(call.arithcfg)
        dtype = pair[0].name if pair else f"arithcfg{call.arithcfg}"
        wire = pair[1].name if pair else dtype
        elem = (DATA_TYPE_SIZE[pair[0]] // 8) if pair else 4
        with self._lock:
            prog = self.programs.get(rank)
            if prog is None:
                prog = self.programs[rank] = CollectiveProgram(
                    rank, world.size)
            for comm in accl._communicators:
                if comm.id not in prog.comms:
                    prog.record_comm(
                        comm.id, [r.session for r in comm.ranks])
            self.eager_threshold = min(self.eager_threshold,
                                       accl.max_eager_size)
            rec = req.flight
            prog.calls.append(RecordedCall(
                index=len(prog.calls), rank=rank,
                op=Operation(call.scenario), comm=call.comm,
                root=call.root_src_dst, function=call.function,
                tag=call.tag, count=call.count, arithcfg=call.arithcfg,
                compression=int(call.compression_flags),
                stream_flags=int(call.stream_flags), addr0=call.addr_0,
                addr1=call.addr_1, addr2=call.addr_2, dtype=dtype,
                wire_dtype=wire, elem_bytes=elem, run_async=run_async,
                desc=desc,
                flight_seq=rec.seq if rec is not None else -1,
                request=req))

    def check(self) -> list:
        from .checks import check_programs

        eager = (0 if self.eager_threshold >= 1 << 62
                 else self.eager_threshold)
        return check_programs(self.programs, eager_threshold=eager)


# ---------------------------------------------------------------------------
# cross-rank fingerprint exchange
# ---------------------------------------------------------------------------
class _Slot:
    __slots__ = ("fp", "first_rank", "first_info", "arrived", "poison",
                 "complete", "created")

    def __init__(self, fp: tuple, rank: int, info: str):
        self.fp = fp
        self.first_rank = rank
        self.first_info = info
        self.arrived: set = set()
        self.poison: Optional[tuple] = None  # (rank, info, fp)
        self.complete = False
        self.created = time.monotonic()


_xchg_lock = threading.Lock()
_xchg_cv = threading.Condition(_xchg_lock)
_slots: dict = {}  # (domain, comm, instance) -> _Slot


def _reset_exchange() -> None:
    """Test hook: drop every in-flight agreement slot."""
    with _xchg_cv:
        _slots.clear()
        _xchg_cv.notify_all()


def _sweep_slots_locked() -> None:
    """Expire stale slots (poisoned/timed-out episodes whose members
    never all arrived, partial async instances of dead worlds) so the
    registry stays bounded and a NEW world whose domain key happens to
    collide with a torn-down one (id()/pointer reuse) can never trip
    over a dead world's poisoned slot.  Called under _xchg_lock when
    the registry grows; anything older than 2x the barrier budget has
    already raised on every waiter."""
    if len(_slots) <= 64:
        return
    horizon = time.monotonic() - 2.0 * barrier_timeout_s()
    for key in [k for k, s in _slots.items() if s.created < horizon]:
        del _slots[key]


def _mismatch_error(key: tuple, mine: tuple, mine_info: str,
                    theirs: tuple, their_rank: int,
                    their_info: str) -> ACCLError:
    _domain, comm, idx = key
    return ACCLError(
        f"collective sanitizer: cross-rank call mismatch on comm "
        f"{comm} at gang instance #{idx}: this rank issued "
        f"{fingerprint_str(mine)} [{mine_info}] but rank {their_rank} "
        f"issued {fingerprint_str(theirs)} [{their_info}] — without "
        f"ACCL_SANITIZE this program hangs until the watchdog fires. "
        f"Record it with analysis.record_program for the full report.")


def _gang_exchange(domain, comm_id: int, instance: int, fp: tuple,
                   rank: int, nranks: int, info: str,
                   wait: bool) -> None:
    """Post this rank's fingerprint for one gang instance and verify
    agreement; blocking callers wait for the whole gang (bounded)."""
    key = (domain, comm_id, instance)
    with _xchg_cv:
        _sweep_slots_locked()
        slot = _slots.get(key)
        if slot is None:
            slot = _slots[key] = _Slot(fp, rank, info)
        slot.arrived.add(rank)
        if slot.poison is None and fp != slot.fp:
            slot.poison = (rank, info, fp)
        if len(slot.arrived) >= nranks:
            slot.complete = True
            _slots.pop(key, None)
        if slot.poison is not None or slot.complete:
            _xchg_cv.notify_all()
        if slot.poison is not None:
            p_rank, p_info, p_fp = slot.poison
            if p_rank == rank:  # I am the divergent arrival
                raise _mismatch_error(key, fp, info, slot.fp,
                                      slot.first_rank, slot.first_info)
            raise _mismatch_error(key, fp, info, p_fp, p_rank, p_info)
        if not wait or slot.complete:
            return
        deadline = time.monotonic() + barrier_timeout_s()
        while not slot.complete and slot.poison is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not _xchg_cv.wait(remaining):
                if slot.complete or slot.poison is not None:
                    break
                missing = [r for r in range(nranks)
                           if r not in slot.arrived]
                raise ACCLError(
                    f"collective sanitizer: gang instance #{instance} "
                    f"on comm {comm_id} ({fingerprint_str(fp)} "
                    f"[{info}]) timed out after "
                    f"{barrier_timeout_s():.0f}s waiting for "
                    f"agreement: arrived ranks "
                    f"{sorted(slot.arrived)}, missing {missing} — the "
                    f"missing ranks never issued this collective "
                    f"(desync or early exit)")
        if slot.poison is not None:
            p_rank, p_info, p_fp = slot.poison
            raise _mismatch_error(key, fp, info, p_fp, p_rank, p_info)


# ---------------------------------------------------------------------------
# per-call runtime checks (the ACCL._execute hook body)
# ---------------------------------------------------------------------------
def _runtime_checks(accl, call: CCLOCall, desc: str, req,
                    run_async: bool) -> None:
    op = Operation(call.scenario)
    comms = accl._communicators
    if not comms:
        # pre-bring-up local-op lane (copy/nop on the implicit world
        # comm): _build keeps it permissive, so must the sanitizer —
        # nothing is resolvable before initialize anyway
        return
    if not 0 <= call.comm < len(comms):
        raise ACCLError(
            f"collective sanitizer: {desc}: unknown communicator id "
            f"{call.comm} (this rank has {len(comms)})")
    comm = comms[call.comm]
    P = comm.size
    if op in _ROOTED_OR_P2P and not 0 <= call.root_src_dst < P:
        role = {"send": "dst", "recv": "src"}.get(op.name, "root")
        raise ACCLError(
            f"collective sanitizer: {desc}: {role} {call.root_src_dst} "
            f"is outside comm {call.comm} (size {P}) — roots and peers "
            f"are comm-LOCAL ranks")

    # operand overlap: partial overlaps corrupt (both streams move
    # concurrently); exact aliasing is backend-dependent -> warn once
    pair = accl._arith_pairs.get(call.arithcfg)
    elem = (DATA_TYPE_SIZE[pair[0]] // 8) if pair else 0
    if elem and call.count:
        rec = RecordedCall(
            index=-1, rank=comm.local_rank, op=op, comm=call.comm,
            root=call.root_src_dst, function=call.function, tag=call.tag,
            count=call.count, arithcfg=call.arithcfg,
            compression=int(call.compression_flags),
            stream_flags=int(call.stream_flags), addr0=call.addr_0,
            addr1=call.addr_1, addr2=call.addr_2, dtype="", wire_dtype="",
            elem_bytes=elem, run_async=run_async)
        ext = rec.operand_extents(P)
        for i in range(len(ext)):
            for j in range(i + 1, len(ext)):
                ra, aa, na = ext[i]
                rb, ab, nb = ext[j]
                if aa == ab and na == nb:
                    dedup = (desc, ra, rb, aa, na)
                    if dedup not in _warned_aliases:
                        if len(_warned_aliases) > 1024:
                            _warned_aliases.clear()
                        _warned_aliases.add(dedup)
                        get_logger("accl_tpu_torch.sanitizer",
                                   rank=comm.local_rank).warning(
                            "%s: %s and %s alias the same buffer "
                            "[%#x, +%d) — in-place behavior is "
                            "backend-dependent", desc, ra, rb, aa, na)
                elif aa < ab + nb and ab < aa + na:
                    raise ACCLError(
                        f"collective sanitizer: {desc}: operand {ra} "
                        f"[{aa:#x}, +{na}) partially overlaps {rb} "
                        f"[{ab:#x}, +{nb}) — the engine would corrupt "
                        f"both")

    # cross-rank fingerprint agreement (in-process worlds only)
    if op in GANG_OPERATIONS and P > 1:
        domain_fn = getattr(accl._device, "sanitizer_domain", None)
        domain = domain_fn() if domain_fn is not None else None
        if domain is not None:
            instance = accl._sanitize_seq.get(call.comm, 0)
            accl._sanitize_seq[call.comm] = instance + 1
            flight = req.flight
            info = (f"rank {comm.local_rank}, flight seq "
                    f"{flight.seq}" if flight is not None
                    else f"rank {comm.local_rank}")
            _gang_exchange(domain, call.comm, instance,
                           call_fingerprint(call), comm.local_rank, P,
                           info, wait=not run_async)


def on_call(accl, call: CCLOCall, desc: str, req,
            run_async: bool) -> None:
    """The one driver hook: feed the capture session and/or run the
    runtime checks.  Only reached when :func:`active` is True."""
    cap = _capture
    if cap is not None:
        cap.record(accl, call, desc, req, run_async)
    if _enabled:
        try:
            _runtime_checks(accl, call, desc, req, run_async)
        except ACCLError:
            # the call will never dispatch: retire its flight record
            # (distinct retcode, not engine success) so the watchdog
            # never reports the aborted call as a hung gang
            rec = req.flight
            if rec is not None and rec.in_flight:
                rec.finish(SANITIZER_ABORT_ERROR, now_ns())
            raise
