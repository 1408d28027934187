"""Structured per-call tracing: event spans + Perfetto export.

Every collective call carries a :class:`TraceSpan` through the whole
stack — submit (driver), queue-enter (request layer), gang-ready and
dispatch (backend gang scheduler, lane-tagged: leader / executor /
batched / emu), device-begin/end (compiled program window), and
callback-complete.  Spans from every rank of an in-process world land
in one bounded ring buffer (:class:`TraceCollector`) and export as
Chrome/Perfetto ``trace_event`` JSON: one process (pid) per rank, one
track (tid) per stage/lane, and gang members share a gang id so a
fused gang program shows as one aligned slice across ranks.

Port of ``accl_tpu/observability/trace.py``, whole.  On the card a
launch returns at enqueue, so the gang engine stamps ``t_device_end``
after a stream synchronize that it makes only while tracing is on
(backends/cuda.py): the device window of a span is launch enqueue
through completion, never enqueue alone.

Overhead discipline: tracing is OFF unless ``ACCL_TRACE`` is set
(``1`` = collect, any other non-``0`` value = collect and dump to that
path at exit).  When off, :func:`enabled` is a module-bool read and
:func:`new_span` is never called — the instrumented hot paths allocate
nothing (tests/test_observability.py pins this).

Device timelines: under ``ACCL_DEVICE_TRACE`` the CUDA ring kernels
(ops/csrc/ring.cu, stamp mode) write per-step stamp rows —
:data:`DEVICE_TRACE_FIELDS` — into a device buffer; after the call's
completion sync the host lands them here through
:func:`record_device_steps`, one record per segment and rank (the
reference's one per ``pallas_call`` and shard), and
:meth:`TraceCollector.to_perfetto` renders them as per-rank
``device:<collective>`` tracks next to the host spans.  Stamps are
LOGICAL event-order clocks, as in the reference: one unit = one
in-kernel phase boundary, anchored at the host-side arrival time of the
stamp buffer.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Iterator, List, Optional

#: per-step stamp-row schema of the ACCL_DEVICE_TRACE kernel output
#: (ops/ring.py writes rows in exactly this column order): the virtual
#: rank, the ring step, three logical phase stamps (send-issue,
#: recv/ack-wait done, reduce/copy done), the two ring neighbors, and
#: the per-neighbor byte counts of the step
DEVICE_TRACE_FIELDS = (
    "rank", "step", "seq_send", "seq_wait", "seq_phase",
    "tx_peer", "rx_peer", "tx_bytes", "rx_bytes",
)

#: monotonic nanosecond clock shared by every instrumentation point —
#: comparable across threads of one process, which is exactly the
#: in-process multi-rank world the collector merges
now_ns = time.perf_counter_ns

_lock = threading.Lock()
_enabled = False
_dump_path: Optional[str] = None
_collector: Optional["TraceCollector"] = None
_atexit_armed = False


class TraceSpan:
    """One call's event record: monotonic ns timestamps per stage.

    Unset stages stay None (e.g. gang-ready on the emulator backend,
    whose native engine matches calls below the Python layer); export
    skips slices whose endpoints are missing."""

    __slots__ = ("name", "desc", "rank", "gang_id", "lane", "tenant",
                 "count", "dtype", "nbytes", "nranks", "t_submit",
                 "t_queue", "t_gang_ready", "t_dispatch",
                 "t_device_begin", "t_device_end", "t_complete")

    def __init__(self, name: str, desc: str = "", rank: int = -1,
                 count: int = 0, dtype: str = "", nbytes: int = 0,
                 nranks: int = 1):
        self.name = name
        self.desc = desc
        self.rank = rank
        self.gang_id: Optional[int] = None
        self.lane: Optional[str] = None
        #: tenant/lane label of the issuing communicator (r20) — spans
        #: of a labeled tenant render on their own per-tenant call track
        self.tenant: Optional[str] = None
        self.count = count
        self.dtype = dtype
        self.nbytes = nbytes
        self.nranks = nranks
        self.t_submit: Optional[int] = None
        self.t_queue: Optional[int] = None
        self.t_gang_ready: Optional[int] = None
        self.t_dispatch: Optional[int] = None
        self.t_device_begin: Optional[int] = None
        self.t_device_end: Optional[int] = None
        self.t_complete: Optional[int] = None

    def timestamps(self) -> dict:
        return {k: getattr(self, "t_" + k) for k in (
            "submit", "queue", "gang_ready", "dispatch", "device_begin",
            "device_end", "complete")}

    def __repr__(self) -> str:  # pragma: no cover — debug aid
        return (f"TraceSpan({self.name!r}, rank={self.rank}, "
                f"gang={self.gang_id}, lane={self.lane})")


class TraceCollector:
    """Bounded ring buffer of completed spans + the gang-id registry.

    Gang ids pair up the per-rank spans of one collective *instance*:
    rank R's Nth call with a given (op, comm, tag, root) signature
    belongs to the same gang as every other rank's Nth call with that
    signature — the same FIFO-per-key discipline the gang engine's
    assembly and the emulator's rx seek both implement, so the
    driver-level assignment matches what the engines actually pair."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._spans: deque = deque(maxlen=capacity)
        #: device stamp-buffer records (r15): one entry per traced
        #: kernel invocation — {"collective", "base_ns", "rows"}
        self._device: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._gang_seq = 0
        # (key, occurrence) -> gang id; bounded so an unbounded run
        # cannot grow the table past the ring buffer's usefulness
        self._gang_ids: OrderedDict = OrderedDict()
        self._occurrence: dict = {}

    # -- span intake ---------------------------------------------------
    def add(self, span: TraceSpan) -> None:
        with self._lock:
            self._spans.append(span)

    def gang_id_for(self, key: tuple, rank: int) -> int:
        """Gang id of `rank`'s next occurrence of call signature `key`."""
        with self._lock:
            n = self._occurrence.get((key, rank), 0)
            self._occurrence[(key, rank)] = n + 1
            gid = self._gang_ids.get((key, n))
            if gid is None:
                gid = self._gang_seq
                self._gang_seq += 1
                self._gang_ids[(key, n)] = gid
                while len(self._gang_ids) > 4 * self.capacity:
                    self._gang_ids.popitem(last=False)
            return gid

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._device.clear()
            self._gang_ids.clear()
            self._occurrence.clear()

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    # -- device stamp buffers (r15, ACCL_DEVICE_TRACE) -----------------
    def add_device_steps(self, collective: str, rows: List[list],
                         base_ns: Optional[int] = None) -> None:
        """One traced kernel invocation's stamp rows (DEVICE_TRACE_
        FIELDS order), anchored at ``base_ns`` (host arrival time by
        default — the stamps themselves are logical event counters)."""
        with self._lock:
            self._device.append({
                "collective": collective,
                "base_ns": base_ns if base_ns is not None else now_ns(),
                "rows": [list(map(int, r)) for r in rows],
            })

    def device_records(self) -> list:
        with self._lock:
            return list(self._device)

    def device_link_bytes(self) -> dict:
        """Per-neighbor byte counts folded out of the stamp buffers:
        {(rank, peer): tx_bytes} — the device-side half of the link
        matrix (the gang engine's link twin measures the host side)."""
        out: dict = {}
        for rec in self.device_records():
            for row in rec["rows"]:
                r = dict(zip(DEVICE_TRACE_FIELDS, row))
                key = (r["rank"], r["tx_peer"])
                out[key] = out.get(key, 0) + r["tx_bytes"]
        return out

    def __len__(self) -> int:
        return len(self._spans)

    # -- export --------------------------------------------------------
    def to_perfetto(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object.

        Track layout: pid = rank (process_name metadata "rank N"), tids
        are per-rank stage tracks — ``call`` (submit→complete), ``queue``
        (queue-enter→dispatch, with the gang-ready boundary in args),
        and one ``lane:<name>`` track per dispatch lane holding the
        device-begin→device-end slice.  Gang members carry the same
        ``gang#<id>`` slice name and (for fused gang programs, whose
        device window is measured once per gang) identical ts/dur — the
        aligned cross-rank slice a Perfetto timeline groups visually."""
        events: list = []
        tids: dict = {}
        procs: set = set()

        def tid(pid: int, label: str) -> int:
            key = (pid, label)
            t = tids.get(key)
            if t is None:
                t = len([1 for k in tids if k[0] == pid])
                tids[key] = t
                events.append({"name": "thread_name", "ph": "M", "ts": 0,
                               "pid": pid, "tid": t,
                               "args": {"name": label}})
            return t

        def slice_ev(pid: int, label: str, name: str, t0, t1, args):
            if t0 is None or t1 is None:
                return
            events.append({
                "name": name, "ph": "X", "cat": "accl",
                "ts": t0 / 1e3, "dur": max(t1 - t0, 0) / 1e3,
                "pid": pid, "tid": tid(pid, label), "args": args,
            })

        for s in self.spans():
            pid = s.rank if s.rank >= 0 else 9999
            if pid not in procs:
                procs.add(pid)
                events.append({
                    "name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                    "tid": 0, "args": {"name": (
                        f"rank {pid}" if pid != 9999 else "host")}})
            gid = f" gang#{s.gang_id}" if s.gang_id is not None else ""
            args = {"desc": s.desc, "count": s.count, "dtype": s.dtype,
                    "nbytes": s.nbytes, "nranks": s.nranks,
                    "gang_id": s.gang_id, "lane": s.lane,
                    "tenant": s.tenant,
                    "timestamps_ns": s.timestamps()}
            call_track = ("call" if s.tenant is None
                          else f"call:{s.tenant}")
            slice_ev(pid, call_track, s.name + gid, s.t_submit,
                     s.t_complete, args)
            slice_ev(pid, "queue", s.name + gid, s.t_queue,
                     s.t_dispatch or s.t_complete,
                     {"gang_ready_ns": s.t_gang_ready})
            if s.lane is not None:
                slice_ev(pid, f"lane:{s.lane}", s.name + gid,
                         s.t_device_begin or s.t_dispatch,
                         s.t_device_end or s.t_complete, args)
        # device stamp-buffer tracks (r15): one `device:<collective>`
        # track per rank; each step renders its transfer window
        # (send-issue -> recv/ack-wait done) and its reduce/copy window
        # as consecutive slices on the logical stamp clock (1 stamp
        # unit = 1 us), anchored at the buffer's host arrival time
        for rec in self.device_records():
            base = rec["base_ns"]
            coll = rec["collective"]
            for row in rec["rows"]:
                r = dict(zip(DEVICE_TRACE_FIELDS, row))
                pid = r["rank"]
                if pid not in procs:
                    procs.add(pid)
                    events.append({
                        "name": "process_name", "ph": "M", "ts": 0,
                        "pid": pid, "tid": 0,
                        "args": {"name": f"rank {pid}"}})
                label = f"device:{coll}"
                t0 = base + r["seq_send"] * 1000
                t1 = base + r["seq_wait"] * 1000
                t2 = base + r["seq_phase"] * 1000
                slice_ev(pid, label,
                         f"s{r['step']}:xfer->r{r['tx_peer']}", t0, t1,
                         {"step": r["step"], "tx_peer": r["tx_peer"],
                          "rx_peer": r["rx_peer"],
                          "tx_bytes": r["tx_bytes"],
                          "rx_bytes": r["rx_bytes"],
                          "device_track": True,
                          "device_phase": "xfer"})
                slice_ev(pid, label, f"s{r['step']}:reduce", t1, t2,
                         {"step": r["step"], "device_track": True,
                          "device_phase": "reduce"})
        return {"traceEvents": events, "displayTimeUnit": "ns"}

    def dump(self, path: str) -> str:
        """Write the Perfetto JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
        return path


# ---------------------------------------------------------------------------
# module state: enable/disable + singleton collector
# ---------------------------------------------------------------------------
def _init_from_env() -> None:
    raw = os.environ.get("ACCL_TRACE", "")
    if raw and raw != "0":
        enable(None if raw == "1" else raw)


def enable(dump_path: Optional[str] = None,
           capacity: Optional[int] = None) -> "TraceCollector":
    """Turn tracing on; with `dump_path`, the Perfetto JSON is written
    there at interpreter exit (the ACCL_TRACE=<path> behavior)."""
    global _enabled, _dump_path, _collector, _atexit_armed
    with _lock:
        if _collector is None or (capacity is not None
                                  and _collector.capacity != capacity):
            _collector = TraceCollector(
                capacity or int(os.environ.get("ACCL_TRACE_CAP", "65536")))
        _enabled = True
        _dump_path = dump_path
        if dump_path and not _atexit_armed:
            import atexit

            atexit.register(_dump_at_exit)
            _atexit_armed = True
        return _collector


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def _dump_at_exit() -> None:  # pragma: no cover — exercised by CI smoke
    if _enabled and _dump_path and _collector is not None:
        try:
            _collector.dump(_dump_path)
        except OSError:
            pass


def enabled() -> bool:
    """Fast gate every instrumentation point checks first — a module
    bool read, so the disabled path costs one attribute lookup."""
    return _enabled


def collector() -> TraceCollector:
    global _collector
    with _lock:
        if _collector is None:
            _collector = TraceCollector(
                int(os.environ.get("ACCL_TRACE_CAP", "65536")))
        return _collector


def record_device_steps(collective: str, buf) -> None:
    """Land one ACCL_DEVICE_TRACE stamp buffer in the collector — what
    ops/ring.py calls for each (segment, rank) of a traced launch once
    the launch has completed.  ``buf`` is a (steps, len(DEVICE_TRACE_
    FIELDS)) int32 array or tensor (a leading dim is flattened).
    Never raises: a malformed buffer must not take the workload down."""
    try:
        import numpy as np

        arr = np.asarray(buf).reshape(-1, len(DEVICE_TRACE_FIELDS))
        collector().add_device_steps(collective, arr.tolist())
    except Exception:  # noqa: BLE001 — observability must stay passive
        pass


def new_span(name: str, desc: str = "", rank: int = -1, count: int = 0,
             dtype: str = "", nbytes: int = 0,
             nranks: int = 1) -> Optional[TraceSpan]:
    """Allocate a span for one call — returns None when tracing is off,
    so callers hold the no-allocation fast path with one check."""
    if not _enabled:
        return None
    return TraceSpan(name, desc, rank, count, dtype, nbytes, nranks)


# ---------------------------------------------------------------------------
# marked windows
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def traced_window(label: str, rank: int = -1,
                  xla_logdir: Optional[str] = None) -> Iterator[None]:
    """Mark a host window in the trace: a ``window:<label>`` span on the
    host pseudo-rank, or on ``rank``'s track (the overlap accountant
    intersects a rank's wire intervals with that rank's windows).  With
    ``xla_logdir`` (or the ``ACCL_XLA_TRACE`` env var) also capture the
    window through utils/profiling.xla_trace, the reference's names: the
    file it writes there is a ``torch.profiler`` Chrome trace (host
    activity, and the card's kernels where one is present), not an XLA
    capture, and covers the same marked region as the span."""
    logdir = xla_logdir or os.environ.get("ACCL_XLA_TRACE", "")
    span = new_span(f"window:{label}", rank=rank)
    if span is not None:
        span.t_submit = span.t_queue = span.t_dispatch = now_ns()
        span.lane = "window"
    try:
        if logdir:
            from ..utils.profiling import xla_trace

            with xla_trace(logdir):
                yield
        else:
            yield
    finally:
        if span is not None:
            span.t_device_begin = span.t_submit
            span.t_device_end = span.t_complete = now_ns()
            collector().add(span)


# ---------------------------------------------------------------------------
# multi-process merge
# ---------------------------------------------------------------------------
def salvage_torn_json(text: str, list_key: str) -> tuple:
    """Best-effort parse of a JSON document truncated mid-write (a
    crash-time dump: the process died inside ``json.dump``).  Finds the
    ``"<list_key>": [`` array and decodes its elements one by one until
    the torn tail, reconstructing ``{<scalars before the array>,
    <list_key>: [complete elements]}``.  Returns ``(doc, skipped_tail_
    bytes)`` — the caller reports the skip instead of raising, so ONE
    rank's torn dump cannot take the whole post-mortem merge down.
    Raises ValueError only when not even the array start is present."""
    import re

    decoder = json.JSONDecoder()
    m = re.search(r'"%s"\s*:\s*\[' % re.escape(list_key), text)
    if m is None:
        raise ValueError(f"no {list_key!r} array found in torn document")
    # scalar fields before the array (rank/capacity/... or nothing)
    doc: dict = {}
    for sm in re.finditer(
            r'"([A-Za-z0-9_]+)"\s*:\s*(-?\d+(?:\.\d+)?|"(?:[^"\\]|\\.)*"'
            r'|true|false|null)\s*,', text[:m.start()]):
        try:
            doc[sm.group(1)] = json.loads(sm.group(2))
        except json.JSONDecodeError:  # pragma: no cover — regex-vetted
            continue
    items: list = []
    pos = m.end()
    n = len(text)
    while True:
        while pos < n and text[pos] in " \t\r\n,":
            pos += 1
        if pos >= n or text[pos] == "]":
            break
        try:
            item, end = decoder.raw_decode(text, pos)
        except json.JSONDecodeError:
            break  # the torn tail starts here
        items.append(item)
        pos = end
    doc[list_key] = items
    return doc, max(n - pos, 0)


def merge_trace_files(paths, out_path: Optional[str] = None) -> dict:
    """Merge per-process trace files (e.g. one per multihost rank) into
    one timeline, aligning clocks by shared gang ids: each file is
    shifted so the device-begin of the first gang it shares with the
    reference file coincides — the cross-rank alignment an in-process
    world gets for free from the shared monotonic clock."""
    merged: list = []
    ref_gangs: dict = {}
    torn: list = []
    seen_meta: set = set()
    for i, path in enumerate(paths):
        with open(path) as f:
            text = f.read()
        try:
            events = json.loads(text).get("traceEvents", [])
        except json.JSONDecodeError:
            # crash-time dump truncated mid-record (r14 satellite):
            # salvage the complete prefix, skip the torn tail with a
            # warning + a count in the merged doc — one dead rank must
            # not take the whole post-mortem timeline down
            doc_part, skipped = salvage_torn_json(text, "traceEvents")
            events = doc_part.get("traceEvents", [])
            torn.append({"path": str(path),
                         "events_recovered": len(events),
                         "tail_bytes_skipped": skipped})
            from ..utils.logging import get_logger

            get_logger("accl_tpu_torch.trace").warning(
                "trace file %s is truncated mid-record — salvaged %d "
                "event(s), skipped %d torn tail byte(s)",
                path, len(events), skipped)
        gangs = {}
        for ev in events:
            args = ev.get("args") or {}
            gid = args.get("gang_id")
            if gid is None or ev.get("ph") != "X" or gid in gangs:
                continue
            # anchor on the DEVICE window, not the slice ts: the call
            # slice starts at the rank-local submit time, and shifting
            # by that would absorb exactly the cross-rank submit skew
            # the merged timeline exists to reveal — a fused gang's
            # device-begin is the instant genuinely shared across ranks
            dev0 = (args.get("timestamps_ns") or {}).get("device_begin")
            anchor = dev0 / 1e3 if dev0 else ev["ts"]
            if anchor > 0:
                gangs[gid] = anchor
        offset = 0.0
        if i == 0:
            ref_gangs = gangs
        else:
            shared = sorted(set(gangs) & set(ref_gangs))
            if shared:
                g = shared[0]
                offset = ref_gangs[g] - gangs[g]
        for ev in events:
            if ev.get("ph") == "X":
                ev = dict(ev, ts=ev["ts"] + offset)
            elif ev.get("ph") == "M":
                # metadata dedup (r15 satellite): every input file
                # re-emits its own thread_name/process_name rows, so a
                # merge used to carry one copy per file for the same
                # (pid, tid) — Perfetto renders duplicated track names.
                # Keep the FIRST declaration per (event, pid, tid).
                mkey = (ev.get("name"), ev.get("pid"), ev.get("tid"))
                if mkey in seen_meta:
                    continue
                seen_meta.add(mkey)
            merged.append(ev)
    doc = {"traceEvents": merged, "displayTimeUnit": "ns"}
    if torn:
        doc["torn_files"] = torn
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f)
    return doc


_init_from_env()
