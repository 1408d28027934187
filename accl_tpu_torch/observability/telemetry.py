"""Engine telemetry: the stats sampler and the P x P link matrix.

Port of ``accl_tpu/observability/telemetry.py``, whole.  The gang engine
keeps cheap internal counters (dispatch lanes, batches, plan rings, the
compressed-wire accounting) and a link twin of per-(comm, peer) rows;
``CudaDeviceView.engine_stats`` and ``link_stats`` read them.  This
module is the one polling loop that snapshots them and publishes them
into the :class:`~accl_tpu_torch.observability.metrics.MetricsRegistry`
as ``engine/*`` and ``link/*`` families, so /metrics scrapes and the
regression sentinel see the engine's interior.

Overhead discipline: ``ACCL_TELEMETRY_INTERVAL_MS=0`` (the default) is
the hard off switch: no sampler thread is created, and the call path is
untouched either way (the sampler only adds a reader of counters the
engine keeps anyway).

Schema versioning: ``ENGINE_STATS_FIELDS_V1``/``_V2``/``_V3`` name the
stats field order per version (append only; v2 appends ``link_rows``,
v3 the compressed-wire pair).  Fields past a decoder's table are kept as
``engine/unknown_field_<i>`` gauges.  :data:`LINK_STATS_FIELDS_V3` is
the link-row schema, :func:`decode_link_stats` its strict decoder (a
length that is not a whole number of rows raises, never mis-slices),
and :func:`link_matrix` folds every rank's rows into the world-level
P x P traffic matrix, sliced by communicator or by a set of them (a
tenant's).  The sampler publishes the matrix as ``link/*`` families.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from .metrics import MetricsRegistry, default_registry

#: engine-stats version-1 field order (the reference's stats ABI,
#: accl_tpu/observability/telemetry.py:47 — APPEND ONLY)
ENGINE_STATS_FIELDS_V1 = (
    "retrans_store_depth",
    "retrans_store_evictions",
    "retrans_sent",
    "nacks_tx",
    "nacks_rx",
    "fenced_drops",
    "rx_occupancy",
    "rx_occupancy_hwm",
    "rx_staged",
    "rx_staged_hwm",
    "rx_pending",
    "egress_depth",
    "egress_hwm",
    "ingress_depth",
    "seeks",
    "seek_misses",
    "plans_live",
    "plan_tokens",
    "plan_replays",
    "wire_accepted_frames",
    "wire_rejected_frames",
    "tx_msgs",
    "tx_payload_bytes",
    "joins_sponsored",
    "joins_completed",
)

#: v2 appends the link-plane row count — the only new scalar; the
#: per-peer counters themselves ride the separate link_stats array
ENGINE_STATS_FIELDS_V2 = ENGINE_STATS_FIELDS_V1 + ("link_rows",)

#: v3 appends the quantized-wire accounting pair: wire bytes
#: that left through a compressed lane and their uncompressed
#: equivalent (saved bytes = logical - compressed, published by the
#: sampler as the wire/compressed_saved_bytes family)
ENGINE_STATS_FIELDS_V3 = ENGINE_STATS_FIELDS_V2 + (
    "compressed_tx_bytes",
    "compressed_tx_logical_bytes",
)

#: version -> field table (decode_engine_stats consults this so a v1
#: decoder over a v2 engine keeps field 25 as unknown_field_25 — the
#: forward-compat contract the table-driven tests pin both ways)
ENGINE_STATS_FIELDS_BY_VERSION = {
    1: ENGINE_STATS_FIELDS_V1,
    2: ENGINE_STATS_FIELDS_V2,
    3: ENGINE_STATS_FIELDS_V3,
}

#: per-row field order of a link row (the reference's link ABI — row
#: stride is its length; CudaEngine.link_stats_for writes these keys).
#: v3 appends comp_tx_bytes: compressed wire bytes
#: sent to the peer, so the link matrix can attribute quantized
#: traffic per link.
LINK_STATS_FIELDS_V3 = (
    "comm",
    "peer",
    "tx_msgs",
    "tx_bytes",
    "rx_msgs",
    "rx_bytes",
    "retrans_sent",
    "nacks_tx",
    "nacks_rx",
    "fenced_drops",
    "seeks",
    "seek_wait_ns",
    "comp_tx_bytes",
)
#: kept as an alias: v2 consumers named the schema by version
LINK_STATS_FIELDS_V2 = LINK_STATS_FIELDS_V3

#: link-row fields that are per-link COUNTERS (everything but the key)
LINK_COUNTER_FIELDS = LINK_STATS_FIELDS_V3[2:]

#: monotonic fields — published into the registry as counter DELTAS
#: (``engine/<name>`` counters); everything else is a point-in-time
#: gauge (depths, occupancy, high-water marks), published as the MAX
#: across the sampled ranks of a world.  The gang engine's extra
#: dispatch-lane fields are classified here too.
COUNTER_FIELDS = frozenset((
    "retrans_store_evictions",
    "retrans_sent",
    "nacks_tx",
    "nacks_rx",
    "fenced_drops",
    "seeks",
    "seek_misses",
    "plan_replays",
    "wire_accepted_frames",
    "wire_rejected_frames",
    "tx_msgs",
    "tx_payload_bytes",
    "joins_sponsored",
    "joins_completed",
    # quantized wire accounting (v3)
    "compressed_tx_bytes",
    "compressed_tx_logical_bytes",
    # gang-engine dispatch-lane counters (CudaDeviceView.engine_stats)
    "plan_auto_captures",
    "leader_dispatches",
    "executor_dispatches",
    "batches",
    "batched_gangs",
))


def interval_ms() -> int:
    """Sampler period; ``0`` (the default) = telemetry OFF — no thread,
    zero added work anywhere.  Malformed values raise the naming
    ACCLError (the constants.env_int clear-error contract)."""
    from ..constants import env_int

    return env_int("ACCL_TELEMETRY_INTERVAL_MS", 0, minimum=0)


class TelemetrySampler:
    """Daemon thread polling per-rank ``engine_stats()`` dicts into a
    MetricsRegistry as ``engine/*`` families.

    ``sources`` is a list of zero-arg callables, one per rank, each
    returning a flat {field: int} dict (CudaDeviceView.engine_stats).
    Counters are aggregated as summed deltas across ranks (so the
    family is world-total and survives sampler restarts without double
    counting); gauges as the max across
    ranks (the binding resource is the hottest rank's).  A source that
    raises (e.g. its world closed mid-poll) is skipped — telemetry must
    never take a workload down.
    """

    def __init__(self, sources: Iterable[Callable[[], dict]],
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0, name: str = "accl",
                 link_sources: Optional[Iterable[
                     Tuple[int, Callable[[], list]]]] = None):
        self._sources = list(sources)
        #: (global rank, zero-arg callable returning decoded link rows)
        #: — the link plane; empty = no link plane on this world
        self._link_sources = list(link_sources or [])
        self._registry = registry if registry is not None \
            else default_registry()
        self.interval_s = max(interval_s, 0.001)
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: last published counter totals, per field (summed over ranks):
        #: each sample publishes the positive delta
        self._published: dict = {}
        #: last published per-link counter totals, per (src, dst, field)
        self._link_published: dict = {}
        #: most recent world-level link matrix (link_matrix doc), for
        #: callers and tests without re-polling the engines
        self.last_link_matrix: Optional[dict] = None
        #: samples taken (tests assert liveness without sleeping blind)
        self.samples = 0

    # -- one poll -------------------------------------------------------
    def sample(self) -> dict:
        """Poll every source once and publish; returns the aggregated
        {field: value} snapshot (counters as running totals)."""
        counters: dict = {}
        gauges: dict = {}
        for src in self._sources:
            try:
                stats = src()
            except Exception:  # noqa: BLE001 — a dead world mid-poll
                continue
            for k, v in stats.items():
                if k == "version":
                    continue
                if k in COUNTER_FIELDS:
                    counters[k] = counters.get(k, 0) + int(v)
                else:
                    gauges[k] = max(gauges.get(k, 0), int(v))
        deltas: dict = {}
        for k, total in counters.items():
            delta = total - self._published.get(k, 0)
            if delta > 0:
                self._registry.inc(f"engine/{k}", delta)
                self._published[k] = total
                deltas[k] = delta
        # quantized-wire families: compressed bytes on the wire
        # and the bytes the compressed lanes SAVED vs their logical
        # (uncompressed) traffic — the headline multiplier observable
        comp = deltas.get("compressed_tx_bytes", 0)
        logical = deltas.get("compressed_tx_logical_bytes", 0)
        if comp:
            self._registry.inc("wire/compressed_tx_bytes", comp)
        if logical > comp:
            self._registry.inc("wire/compressed_saved_bytes",
                               logical - comp)
        for k, v in gauges.items():
            self._registry.set_gauge(f"engine/{k}", v)
        self._sample_links()
        self.samples += 1
        return {**counters, **gauges}

    def _sample_links(self) -> None:
        """Poll the link plane and publish ``link/*`` families:
        one counter per (field, src, dst) link cell plus the world
        total per field — the exported form of the P×P traffic matrix.
        Same delta discipline and same never-take-the-workload-down
        tolerance as the scalar plane."""
        if not self._link_sources:
            return
        per_rank: dict = {}
        for rank, src in self._link_sources:
            try:
                per_rank[rank] = src()
            except Exception:  # noqa: BLE001 — a dead world mid-poll
                continue
        if not per_rank:
            return
        # the real world size comes from the configured sources, not
        # from whoever answered this poll: a dead/closing rank must
        # not shrink the matrix and drop live ranks' cells toward it
        nranks = max(r for r, _src in self._link_sources) + 1
        matrix = link_matrix(per_rank, nranks=nranks)
        self.last_link_matrix = matrix
        for field, cells in matrix["fields"].items():
            world_total = 0
            for s, row in enumerate(cells):
                for d, total in enumerate(row):
                    world_total += total
                    key = (field, s, d)
                    delta = total - self._link_published.get(key, 0)
                    if delta > 0:
                        self._registry.inc(
                            f"link/{field}/r{s}->r{d}", delta)
                        self._link_published[key] = total
            key = (field, "world")
            delta = world_total - self._link_published.get(key, 0)
            if delta > 0:
                self._registry.inc(f"link/{field}", delta)
                self._link_published[key] = world_total

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "TelemetrySampler":
        if self._thread is None and self._sources:
            self._thread = threading.Thread(
                target=self._loop, name=f"{self._name}-telemetry",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        # sample immediately, then on the period: a short-lived world
        # still lands one snapshot in the registry
        while True:
            try:
                self.sample()
            except Exception:  # pragma: no cover — never kill the host
                pass
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


def sampler_from_env(sources: Iterable[Callable[[], dict]],
                     registry: Optional[MetricsRegistry] = None,
                     name: str = "accl",
                     link_sources: Optional[Iterable[
                         Tuple[int, Callable[[], list]]]] = None,
                     ) -> Optional[TelemetrySampler]:
    """Arm a sampler per ``ACCL_TELEMETRY_INTERVAL_MS`` — None (and no
    thread, no work) when the knob is 0/unset.  Worlds call this at
    bring-up and ``stop()`` it in close()."""
    ms = interval_ms()
    if ms <= 0:
        return None
    return TelemetrySampler(sources, registry=registry,
                            interval_s=ms / 1000.0, name=name,
                            link_sources=link_sources).start()


def decode_engine_stats(values, version: int = 1,
                        total_fields: Optional[int] = None) -> dict:
    """Decode a flat capi stats array into the named dict.  ``version``
    selects the field table THIS DECODER applies (a v1 caller decoding
    a v2 engine's array passes 1); fields past the selected schema's
    knowledge (a NEWER engine) are kept as ``unknown_field_<i>`` so
    nothing is silently dropped."""
    names = ENGINE_STATS_FIELDS_BY_VERSION.get(
        version, ENGINE_STATS_FIELDS_V3 if version > 3
        else ENGINE_STATS_FIELDS_V1)
    out = {"version": version}
    for i, v in enumerate(values):
        if total_fields is not None and i >= total_fields:
            break
        key = names[i] if i < len(names) else f"unknown_field_{i}"
        out[key] = int(v)
    return out


def decode_link_stats(values: Sequence[int]) -> List[dict]:
    """Decode a flat ``accl_engine_link_stats`` array into per-link row
    dicts (:data:`LINK_STATS_FIELDS_V2` order).  The array length MUST
    be a whole number of rows: anything else means the caller and the
    engine disagree on the stride, and slicing anyway would silently
    shift every counter into the wrong field — raise the naming error
    instead (the compat-hardening satellite's contract)."""
    from ..constants import ACCLError

    stride = len(LINK_STATS_FIELDS_V2)
    vals = list(values)
    if len(vals) % stride != 0:
        raise ACCLError(
            f"decode_link_stats: flat array length {len(vals)} is not "
            f"a multiple of the per-peer stride {stride} — the engine "
            f"and this decoder disagree on the link-row schema "
            f"(mixed-version world?); refusing to mis-slice")
    return [
        {name: int(vals[r * stride + i])
         for i, name in enumerate(LINK_STATS_FIELDS_V2)}
        for r in range(len(vals) // stride)
    ]


def link_matrix(per_rank_rows: dict, nranks: Optional[int] = None,
                comm: Optional[int] = 0,
                comms: Optional[Iterable[int]] = None) -> dict:
    """Fold per-rank link rows into the world-level P×P traffic matrix.

    ``per_rank_rows`` maps GLOBAL rank -> decoded link rows (the
    ``link_stats()`` output of that rank's device).  ``comm`` selects
    which communicator's rows to fold (default 0, the global comm,
    whose comm-local peer ranks ARE global ranks); ``comm=None`` folds
    every comm — callers owning sub-communicators must map peers to
    global ranks themselves first.  ``comms`` (tenant slicing)
    overrides ``comm`` with an explicit SET of communicator ids to fold
    — the per-tenant view: a tenant's traffic is the union of its
    communicators' rows.  Peer indices in non-global comms are
    comm-local; slice consumers treat rows/cols as comm-local
    coordinates (world kill/join drills keep sub-comm membership
    contiguous from rank 0, so the slice stays meaningful).

    Returns ``{"nranks": P, "fields": {field: P×P list-of-lists}}``
    with ``matrix[src][dst]`` = rank src's counter toward peer dst for
    the tx-side fields, and rank src's RECEIVE-side observation OF dst
    for rx/nacks_tx/fenced/seek fields (both orientations describe the
    src<->dst link; keeping the observer as the row preserves which
    side measured it)."""
    ranks = sorted(per_rank_rows)
    P = nranks if nranks is not None else (max(ranks) + 1 if ranks else 0)
    comm_set = None if comms is None else {int(c) for c in comms}
    fields = {f: [[0] * P for _ in range(P)] for f in LINK_COUNTER_FIELDS}
    for src, rows in per_rank_rows.items():
        if src >= P:
            continue
        for row in rows:
            if comm_set is not None:
                if row.get("comm") not in comm_set:
                    continue
            elif comm is not None and row.get("comm") != comm:
                continue
            dst = int(row.get("peer", -1))
            if not 0 <= dst < P:
                continue
            for f in LINK_COUNTER_FIELDS:
                fields[f][src][dst] += int(row.get(f, 0))
    doc = {"nranks": P, "comm": comm, "fields": fields}
    if comm_set is not None:
        doc["comm"] = None
        doc["comms"] = sorted(comm_set)
    return doc


def slowest_link(matrix: dict,
                 field: str = "seek_wait_ns") -> Optional[Tuple[int, int]]:
    """The (observer, peer) pair with the largest value of ``field`` in
    a :func:`link_matrix` document — for ``seek_wait_ns`` that is the
    link whose peer kept its receiver blocked longest, i.e. the slowest
    link of the world.  None when the matrix carries no signal."""
    cells = matrix.get("fields", {}).get(field)
    if not cells:
        return None
    best, best_v = None, 0
    for src, row in enumerate(cells):
        for dst, v in enumerate(row):
            if v > best_v:
                best, best_v = (src, dst), v
    return best


def link_imbalance(matrix: dict, field: str = "tx_bytes") -> float:
    """Max/mean ratio over the nonzero cells of one matrix field — the
    congestion-skew observable (1.0 = perfectly
    balanced; large = one link carries disproportionate traffic)."""
    cells = matrix.get("fields", {}).get(field, [])
    vals = [v for row in cells for v in row if v > 0]
    if not vals:
        return 1.0
    return max(vals) / (sum(vals) / len(vals))
