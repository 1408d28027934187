"""Always-on per-rank flight recorder: the collective black box.

Unlike the opt-in tracer (``ACCL_TRACE``), the flight recorder is ON by
default: every rank keeps a fixed-size, lock-cheap ring of the last N
collective records — seq, collective, comm, dtype/shape, dispatch lane,
state transitions (submitted → queued → gang-ready → dispatched →
complete) and monotonic timestamps — so when a gang wedges in
production there is always a recent history to dump, the way the
reference CCLO's host-visible retcode/cycle-counter state machine keeps
a wedged offload engine diagnosable (PAPER §driver/firmware; ACCL+,
arxiv 2312.11742).

Overhead discipline: one small ``__slots__`` object and a bounded
``deque.append`` per call, plus a handful of attribute writes at each
state transition — no locks on the record path (the per-rank seq comes
from an atomic ``itertools.count``; ``deque`` appends are GIL-atomic).
``ACCL_FLIGHT=0`` turns it off entirely; ``ACCL_FLIGHT_CAP`` resizes
the ring (default 512 records per rank).

Port of ``accl_tpu/observability/flight.py``, whole.  Dump paths:
:meth:`ACCL.dump_flight_recorder`, ``SIGUSR1`` (dumps every live rank
to ``ACCL_FLIGHT_DUMP``; the handler is installed only from the main
thread and never over an application's own), and automatically when the
:class:`~accl_tpu_torch.observability.health.Watchdog` fires.  Cross-rank
dumps merge and diagnose through :func:`merge_flight_dumps` (the
``scripts/accl_doctor.py`` engine): order/shape/dtype desyncs,
missing gang members, stragglers.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import weakref
from typing import Iterable, Optional

from .trace import now_ns

# record states, in lifecycle order (ints: one attribute write per
# transition on the always-on path; names only materialize at dump time)
S_SUBMITTED = 0
S_QUEUED = 1
S_GANG_READY = 2
S_DISPATCHED = 3
S_COMPLETE = 4
S_FAILED = 5
S_ABORTED = 6  # finalized by a communicator abort (COMM_ABORTED), not
#              # an engine fault — a terminal state, never "in flight"
S_RECOVERING = 7  # a recovery-supervisor phase record (non-gang): the
#              # rank is mid detect->abort->probe->shrink/grow->resume;
#              # finish() retires it complete/failed like any record
STATE_NAMES = ("submitted", "queued", "gang_ready", "dispatched",
               "complete", "failed", "aborted", "recovering")

#: states that mean "this record is retired" — the hang analyzer and
#: the watchdog must treat all three alike (an abort in flight is a
#: recovery action, not a phantom hang)
TERMINAL_STATE_NAMES = ("complete", "failed", "aborted")

#: retcode bit marking an abort-finalized call (constants.ErrorCode.
#: COMM_ABORTED; kept as a literal here so the always-on record path
#: adds no import edge)
_COMM_ABORTED_BIT = 1 << 27

#: retcode bit for an engine receive-timeout (constants.ErrorCode.
#: RECEIVE_TIMEOUT_ERROR) — the trigger for the r20 forensic capture
#: (ROADMAP item 5's standing sub-comm allgather wedge ships a bare
#: timeout today; the forensics attach the per-peer link rows and
#: gang-assembly state the post-mortem needs)
_RECEIVE_TIMEOUT_BIT = 1 << 11

#: record fields every dump carries — the schema the CI hang smoke and
#: accl_doctor validate against
RECORD_SCHEMA_KEYS = (
    "seq", "req_id", "rank", "collective", "comm", "tag", "dtype",
    "count", "nbytes", "nranks", "lane", "state", "gang", "retcode",
    "age_us", "t_submit", "t_queue", "t_gang_ready", "t_dispatch",
    "t_complete", "tenant",
)


class FlightRecord:
    """One collective call's black-box record (mutated in place as the
    call moves through the stack; the ring holds the live object, so a
    dump mid-flight shows the exact stage a wedged call reached)."""

    __slots__ = ("seq", "req_id", "rank", "collective", "comm", "tag",
                 "dtype", "count", "nbytes", "nranks", "lane", "state",
                 "gang", "retcode", "tenant", "t_submit", "t_queue",
                 "t_gang_ready", "t_dispatch", "t_complete", "_recorder")

    def __init__(self, recorder: "FlightRecorder", seq: int, req_id: int,
                 collective: str, comm: int, tag: int, dtype: str,
                 count: int, nbytes: int, nranks: int, gang: bool,
                 t_submit: int, tenant: Optional[str] = None):
        self._recorder = recorder
        self.seq = seq
        self.req_id = req_id
        self.rank = recorder.rank
        self.collective = collective
        self.comm = comm
        self.tag = tag
        self.dtype = dtype
        self.count = count
        self.nbytes = nbytes
        self.nranks = nranks
        self.gang = gang
        self.tenant = tenant
        self.lane: Optional[str] = None
        self.state = S_SUBMITTED
        self.retcode = 0
        self.t_submit = t_submit
        self.t_queue = 0
        self.t_gang_ready = 0
        self.t_dispatch = 0
        self.t_complete = 0

    @property
    def in_flight(self) -> bool:
        # a recovery-phase record is a live episode until finish()
        # retires it (it is never gang=True, so the watchdog's
        # stuck-GANG scan and the merge hang analysis both skip it)
        return self.state < S_COMPLETE or self.state == S_RECOVERING

    def age_ns(self, now: Optional[int] = None) -> int:
        """Nanoseconds since submit (in flight) or submit→complete."""
        end = self.t_complete or (now if now is not None else now_ns())
        return max(end - self.t_submit, 0)

    def mark_dispatched(self, lane: str, t: int) -> None:
        """The one dispatch-stamp used by every lane (emu descriptor
        post, local/p2p, gang executor/leader/batched); a lane already
        tagged by an earlier stage (leader pre-tag) is preserved."""
        self.state = S_DISPATCHED
        self.t_dispatch = t
        if self.lane is None:
            self.lane = lane

    def mark_recovering(self, t: int) -> None:
        """Flip a supervisor phase record into the live `recovering`
        state (resilience/supervisor.py publishes one record per
        state-machine transition; finish() retires it)."""
        self.state = S_RECOVERING
        self.t_dispatch = t
        if self.lane is None:
            self.lane = "supervisor"

    def finish(self, retcode: int, t: int) -> None:
        self.retcode = retcode
        self.t_complete = t
        if retcode == 0:
            self.state = S_COMPLETE
        elif retcode & _COMM_ABORTED_BIT:
            self.state = S_ABORTED
        else:
            self.state = S_FAILED
            if retcode & _RECEIVE_TIMEOUT_BIT:
                # RECEIVE_TIMEOUT forensics (r20): capture the link
                # rows + gang-assembly state at classification time —
                # best-effort, never raising on the record path
                self._recorder._note_timeout(self)
        self._recorder._note_finished(self)

    def summary(self, now: Optional[int] = None) -> str:
        """One-line human rendering, used by error embedding and logs."""
        return (f"seq={self.seq} {self.collective} comm={self.comm} "
                f"state={STATE_NAMES[self.state]} lane={self.lane} "
                f"dtype={self.dtype} count={self.count} "
                f"age={self.age_ns(now) / 1e6:.1f}ms")

    def to_dict(self, now: Optional[int] = None) -> dict:
        return {
            "seq": self.seq, "req_id": self.req_id, "rank": self.rank,
            "collective": self.collective, "comm": self.comm,
            "tag": self.tag, "dtype": self.dtype, "count": self.count,
            "nbytes": self.nbytes, "nranks": self.nranks,
            "lane": self.lane, "state": STATE_NAMES[self.state],
            "gang": self.gang, "retcode": self.retcode,
            "tenant": self.tenant,
            "age_us": round(self.age_ns(now) / 1e3, 1),
            "t_submit": self.t_submit, "t_queue": self.t_queue,
            "t_gang_ready": self.t_gang_ready,
            "t_dispatch": self.t_dispatch, "t_complete": self.t_complete,
        }

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return f"FlightRecord(r{self.rank} {self.summary()})"


class FlightRecorder:
    """Fixed-size ring of one rank's last N FlightRecords."""

    def __init__(self, rank: int, capacity: Optional[int] = None):
        from collections import deque

        from ..constants import env_int

        self.rank = rank
        # env_int raises the naming ACCLError on a malformed knob (the
        # clear-error contract) — construction time, not the record path
        self.capacity = capacity if capacity is not None else env_int(
            "ACCL_FLIGHT_CAP", 512, minimum=1)
        self._records: "deque[FlightRecord]" = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        #: highest seq that reached complete/failed (monotonic
        #: best-effort: lock-free, diagnostic — not a synchronization
        #: primitive)
        self.last_completed_seq = -1
        #: monotonic ns of the most recent non-zero retcode (the
        #: watchdog's "degraded" signal)
        self.last_error_ns = 0
        #: monotonic ns of the most recent COMM_ABORTED finalization
        #: (the watchdog's "aborted" health signal)
        self.last_abort_ns = 0
        #: zero-arg providers polled when a record classifies as
        #: RECEIVE_TIMEOUT (set_forensics_sources) — e.g. the device's
        #: link_stats / the engine's gang_assembly_snapshot
        self._forensics_sources: dict = {}
        #: captured forensic snapshots, newest last (bounded: a timeout
        #: storm must not grow the dump without bound)
        self._forensics: "deque" = deque(maxlen=8)

    # -- record path (always-on; keep it allocation + append only) -----
    def new_record(self, req_id: int, collective: str, comm: int,
                   tag: int, dtype: str, count: int, nbytes: int,
                   nranks: int, gang: bool, t_submit: int,
                   tenant: Optional[str] = None) -> FlightRecord:
        rec = FlightRecord(self, next(self._seq), req_id, collective,
                           comm, tag, dtype, count, nbytes, nranks, gang,
                           t_submit, tenant)
        self._records.append(rec)
        return rec

    def _note_finished(self, rec: FlightRecord) -> None:
        if rec.seq > self.last_completed_seq:
            self.last_completed_seq = rec.seq
        if rec.retcode != 0:
            self.last_error_ns = rec.t_complete
        if rec.state == S_ABORTED:
            self.last_abort_ns = rec.t_complete

    # -- RECEIVE_TIMEOUT forensics (r20, ROADMAP item 5 wedge) ---------
    def set_forensics_sources(self, sources: dict) -> None:
        """Arm zero-arg provider callables (e.g. ``{"link_rows":
        device.link_stats, "gang_assembly": engine.gang_assembly_
        snapshot}``) polled the instant a record classifies as
        RECEIVE_TIMEOUT.  The snapshot carries a WALL-CLOCK stamp
        alongside the monotonic one — the ingredient the detsched
        virtual clock hides, so a wedge under a virtualized schedule
        still correlates with host logs."""
        self._forensics_sources = dict(sources)

    def _note_timeout(self, rec: FlightRecord) -> None:
        if not self._forensics_sources:
            return
        import time as _time

        snap = {
            "seq": rec.seq,
            "req_id": rec.req_id,
            "collective": rec.collective,
            "comm": rec.comm,
            "tag": rec.tag,
            "tenant": rec.tenant,
            "retcode": rec.retcode,
            "t_complete": rec.t_complete,
            "wall_clock": _time.time(),
            "wall_clock_iso": _time.strftime(
                "%Y-%m-%dT%H:%M:%S%z", _time.localtime()),
        }
        for name, fn in self._forensics_sources.items():
            try:
                snap[name] = fn()
            except Exception as e:  # noqa: BLE001 — diagnostics only
                snap[name] = f"<capture failed: {e!r}>"
        self._forensics.append(snap)

    # -- queries --------------------------------------------------------
    def records(self) -> list:
        """Point-in-time snapshot of the ring.  list(deque) copies in
        one C call under the GIL; the retry covers the (not observed,
        but not contractual) case of a mutation surfacing mid-copy —
        a reader must never raise because a rank kept submitting."""
        for _ in range(8):
            try:
                return list(self._records)
            except RuntimeError:  # pragma: no cover — copy/append race
                continue
        return []

    def in_flight(self) -> list:
        # iterate the SNAPSHOT, not the live deque: a Python-level
        # comprehension over the deque can hit "deque mutated during
        # iteration" when another thread appends between items
        return [r for r in self.records() if r.in_flight]

    def __len__(self) -> int:
        return len(self._records)

    def dump(self) -> dict:
        now = now_ns()
        doc = {
            "rank": self.rank,
            "capacity": self.capacity,
            "last_completed_seq": self.last_completed_seq,
            "records": [r.to_dict(now) for r in self.records()],
        }
        if self._forensics:
            # RECEIVE_TIMEOUT forensic snapshots (r20): link rows +
            # gang-assembly state captured at classification time, with
            # wall-clock stamps
            doc["timeout_forensics"] = list(self._forensics)
        return doc


#: lifecycle event names (r13) published as zero-duration records so
#: post-mortem dumps carry the happens-before anchors the
#: analysis.checks lifecycle checkers reason over: fences (abort/
#: shrink/grow/reset) order-stamp when a communicator's old world died;
#: plan_capture marks a re-arm; engine_teardown marks the instant after
#: which NO successful completion may ever publish on that rank.
FENCE_EVENTS = frozenset(("abort", "shrink", "grow", "reset_errors"))
PLAN_CAPTURE_EVENT = "plan_capture"
TEARDOWN_EVENT = "engine_teardown"
#: r19 online tuner: one anchor per hot-swapped selection install (and
#: per revert), so merge_flight_dumps can order retunes against the
#: traffic they reshaped.  Same zero-duration mark_event discipline as
#: the fences — an install IS a fence for captured plans.
RETUNE_EVENT = "retune_install"
RETUNE_REVERT_EVENT = "retune_revert"


def mark_event(recorder: Optional["FlightRecorder"], name: str,
               comm: int = -1, retcode: int = 0,
               lane: str = "fence") -> None:
    """Publish one zero-duration lifecycle event record (cold paths
    only — abort/shrink/grow/reset/plan-arm/teardown).  ``comm=-1``
    means every communicator (reset_errors, teardown)."""
    if recorder is None or not _enabled:
        return
    t = now_ns()
    rec = recorder.new_record(-1, name, comm, 0, "-", 0, 0, 0, False, t)
    rec.lane = lane
    rec.finish(retcode, t)


# ---------------------------------------------------------------------------
# module state: enable switch + live-recorder registry + SIGUSR1
# ---------------------------------------------------------------------------
_enabled = os.environ.get("ACCL_FLIGHT", "1") != "0"
_registry_lock = threading.Lock()
_recorders: list = []  # weakref.ref[FlightRecorder]
_signal_installed = False


def enabled() -> bool:
    """Module-bool gate, same discipline as trace.enabled()."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = on


def register(recorder: FlightRecorder) -> FlightRecorder:
    """Track a live recorder for process-wide dumps (SIGUSR1, doctor);
    weak refs, so closed worlds' recorders age out with GC."""
    with _registry_lock:
        _recorders[:] = [r for r in _recorders if r() is not None]
        _recorders.append(weakref.ref(recorder))
    _install_signal_handler()
    return recorder


def recorders() -> list:
    """Live recorders, registration order."""
    with _registry_lock:
        out = [r() for r in _recorders]
    return [r for r in out if r is not None]


def dump_all() -> dict:
    """Every live rank's ring, in one merged+analyzed document."""
    return merge_flight_dumps([r.dump() for r in recorders()])


def dump_all_to(path: str) -> str:
    with open(path, "w") as f:
        json.dump(dump_all(), f, indent=1)
    return path


def _sigusr1(_signum, _frame) -> None:  # pragma: no cover — signal path
    path = os.environ.get("ACCL_FLIGHT_DUMP", "accl_flight_dump.json")
    try:
        dump_all_to(path)
        from ..utils.logging import get_logger

        get_logger().warning("SIGUSR1: flight recorder dumped to %s", path)
    except Exception:
        pass  # never let the diagnostic path kill the process


def _install_signal_handler() -> None:
    """Arm SIGUSR1 -> dump-all (once; only possible from the main
    thread — worker-thread registration silently skips, matching
    signal module semantics)."""
    global _signal_installed
    if _signal_installed:
        return
    try:
        import signal

        # never steal SIGUSR1 from the application: training launchers
        # commonly bind it (checkpoint-on-signal, log rotation) — the
        # dump hook only claims a DEFAULT disposition
        if signal.getsignal(signal.SIGUSR1) not in (signal.SIG_DFL,
                                                    None):
            _signal_installed = True  # decided: leave theirs in place
            return
        signal.signal(signal.SIGUSR1, _sigusr1)
        _signal_installed = True
    except (ValueError, AttributeError, OSError):
        pass


# ---------------------------------------------------------------------------
# cross-rank merge + desync analysis (the accl_doctor engine)
# ---------------------------------------------------------------------------
def first_divergence(seqs: dict, sig_fn) -> Optional[dict]:
    """First position where per-rank ordered sequences disagree.

    ``seqs`` maps rank -> ordered list; ``sig_fn(item)`` projects each
    item to a comparable signature.  A position diverges when two ranks
    hold DIFFERENT non-None signatures there (a rank that simply ran
    out contributes None — uneven depth alone is a hang/straggler
    question, not an order question).  Returns ``{"index", "per_rank"}``
    (rank -> signature or None) or None.  Shared by the post-mortem
    analyzer (:func:`merge_flight_dumps`) and the pre-dispatch static
    checkers of the reference's analysis layer (not ported yet) so both
    report the same
    first-divergent-seq semantics.
    """
    members = sorted(seqs)
    depth = max((len(v) for v in seqs.values()), default=0)
    for i in range(depth):
        sigs = {r: (sig_fn(seqs[r][i]) if i < len(seqs[r]) else None)
                for r in members}
        distinct = {s for s in sigs.values() if s is not None}
        if len(distinct) > 1:
            return {"index": i, "per_rank": sigs}
    return None


def _load(dump) -> dict:
    """Load one dump dict or path; a path whose JSON is truncated
    mid-record (a crash-time dump) is salvaged via
    :func:`trace.salvage_torn_json` instead of raising — the recovered
    dict carries ``_torn`` = {"tail_bytes_skipped"} so the merge can
    report the skip (r14 satellite)."""
    if isinstance(dump, str):
        with open(dump) as f:
            text = f.read()
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            from .trace import salvage_torn_json

            # merged docs FIRST: a merged doc contains nested per-rank
            # "records" arrays, so probing "records" first would match
            # rank 0's array and silently drop every other rank; a
            # per-rank dump has no "ranks" key and falls through
            try:
                doc, skipped = salvage_torn_json(text, "ranks")
            except ValueError:
                doc, skipped = salvage_torn_json(text, "records")
            doc["_torn"] = {"path": dump,
                            "tail_bytes_skipped": skipped}
            doc.setdefault("rank", -1)
            doc.setdefault("last_completed_seq", -1)
            from ..utils.logging import get_logger

            get_logger("accl_tpu_torch.flight").warning(
                "flight dump %s is truncated mid-record — salvaged %d "
                "record(s), skipped %d torn tail byte(s)",
                dump, len(doc.get("records", [])), skipped)
            return doc
    return dump


def merge_flight_dumps(dumps: Iterable, out_path: Optional[str] = None,
                       ) -> dict:
    """Merge per-rank flight dumps and diagnose cross-rank failure
    modes.  Accepts dump dicts (from :meth:`FlightRecorder.dump`) or
    paths to their JSON files; a dict that already carries a ``ranks``
    list (a previous merge / watchdog report) contributes every rank.

    The analysis pinpoints:

    - ``desyncs`` — the first seq position where two ranks issued
      different gang collectives on one communicator (order/shape/dtype
      mismatch: the classic collective-order bug hierarchical schedules
      amplify, HiCCL arxiv 2408.05962);
    - ``hangs`` — in-flight gang instances past their expected
      membership: which ranks arrived, which are missing, and the
      head-of-queue call each missing rank is actually blocked on;
    - ``stragglers`` — ranks whose completed-gang progress trails the
      furthest rank on the same communicator.
    """
    per_rank: dict = {}
    torn: list = []
    torn_ranks: set = set()
    for d in dumps:
        d = _load(d)
        rds = d["ranks"] if "ranks" in d else [d]
        if "_torn" in d:
            torn.append(dict(d["_torn"],
                             records_recovered=sum(
                                 len(rd.get("records", ())) for rd in rds)))
        for rd in rds:
            rd.setdefault("records", [])
            rd.setdefault("last_completed_seq", -1)
            per_rank[rd["rank"]] = rd
            if "_torn" in d:
                torn_ranks.add(rd["rank"])
    ranks = sorted(per_rank)
    # a full ring has evicted its oldest records, and different ranks
    # evict DIFFERENT amounts (gang/non-gang mixes differ): positional
    # cross-rank comparison is then meaningless and would produce false
    # desync/straggler findings — those analyses are gated per comm on
    # every contributor still holding its full history.  A TORN dump
    # (crash-truncated, r14 satellite) lost its tail the same way, so
    # its ranks gate identically.
    wrapped = {r: r in torn_ranks
               or len(per_rank[r]["records"])
               >= per_rank[r].get("capacity", 1 << 62) for r in ranks}

    # -- per-comm, per-rank ordered gang signatures --------------------
    def sig(rec: dict) -> tuple:
        return (rec["collective"], rec["tag"], rec["count"], rec["dtype"])

    by_comm: dict = {}
    for r in ranks:
        for rec in sorted(per_rank[r]["records"], key=lambda x: x["seq"]):
            if not rec.get("gang"):
                continue
            by_comm.setdefault(rec["comm"], {}).setdefault(
                r, []).append(rec)

    desyncs: list = []
    truncated_comms: list = []
    for comm, seqs in sorted(by_comm.items()):
        members = sorted(seqs)
        if len(members) < 2:
            continue
        if any(wrapped[r] for r in members):
            truncated_comms.append(comm)
            continue
        div = first_divergence(seqs, sig)
        if div is not None:  # first divergence per comm; later ones cascade
            i, sigs = div["index"], div["per_rank"]
            desyncs.append({
                "comm": comm,
                "index": i,
                "per_rank": {
                    str(r): (None if sigs[r] is None else {
                        "collective": sigs[r][0], "tag": sigs[r][1],
                        "count": sigs[r][2], "dtype": sigs[r][3],
                        "seq": seqs[r][i]["seq"]})
                    for r in members},
            })

    # -- hung gang instances -------------------------------------------
    hangs: list = []
    stuck: dict = {}
    for r in ranks:
        for rec in per_rank[r]["records"]:
            if rec.get("gang") and rec["state"] not in TERMINAL_STATE_NAMES:
                key = (rec["collective"], rec["comm"], rec["tag"],
                       rec["count"], rec["dtype"])
                stuck.setdefault(key, {})[r] = rec
    for key, arrived in sorted(stuck.items()):
        coll, comm, tag, count, dtype = key
        nranks = max(rec["nranks"] for rec in arrived.values())
        # communicator membership is not in the dumps (a withheld rank
        # may have issued NOTHING on the comm): when the merged rank set
        # is the whole world (or this is the global comm), every dumped
        # rank is expected; for sub-comms of a larger merge, only ranks
        # seen on that comm can be attributed
        participants = set(by_comm.get(comm, {})) | set(arrived)
        world = (ranks if comm == 0 or len(ranks) <= nranks
                 else sorted(participants))
        missing = [r for r in world if r not in arrived]
        blocked_on = {}
        for r in missing:
            head = next((rec for rec in sorted(per_rank[r]["records"],
                                               key=lambda x: x["seq"])
                         if rec["state"] not in TERMINAL_STATE_NAMES),
                        None)
            blocked_on[str(r)] = head  # None == rank is idle / absent
        hangs.append({
            "collective": coll, "comm": comm, "tag": tag,
            "count": count, "dtype": dtype, "nranks": nranks,
            "arrived": sorted(arrived),
            "missing": missing,
            "oldest_age_us": max(rec["age_us"]
                                 for rec in arrived.values()),
            "arrived_records": {str(r): rec
                                for r, rec in sorted(arrived.items())},
            "missing_blocked_on": blocked_on,
            "last_completed_seq": {
                str(r): per_rank[r]["last_completed_seq"] for r in ranks},
        })

    # -- stragglers -----------------------------------------------------
    stragglers: list = []
    for comm, seqs in sorted(by_comm.items()):
        if any(wrapped[r] for r in seqs):
            continue  # completed-count comparison is eviction-skewed
        done = {r: sum(1 for rec in v if rec["state"] == "complete")
                for r, v in seqs.items()}
        if len(done) < 2:
            continue
        lead = max(done.values())
        behind = {r: n for r, n in done.items() if n < lead}
        if behind:
            stragglers.append({
                "comm": comm, "completed_lead": lead,
                "behind": {str(r): n for r, n in sorted(behind.items())},
            })

    doc = {
        "generated_ns": now_ns(),
        "nranks": len(ranks),
        "ranks": [per_rank[r] for r in ranks],
        "analysis": {
            "desyncs": desyncs,
            "hangs": hangs,
            "stragglers": stragglers,
            # comms whose order analysis was skipped because a rank's
            # ring wrapped (uneven eviction would fake desyncs); hang
            # detection (in-flight records only) still covers them
            "truncated_comms": truncated_comms,
            # crash-truncated dump files the tolerant loader salvaged
            # (r14 satellite): path, records recovered, tail skipped —
            # their ranks' order analysis is gated like a wrapped ring
            "torn_dumps": torn,
            "ok": not desyncs and not hangs,
        },
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
    return doc
