"""Metrics registry: counters, fixed-bucket latency histograms, and
derived algorithmic/bus bandwidth per (collective, dtype, size bucket).

Port of ``accl_tpu/observability/metrics.py``, whole.  The driver, the
gang engine (``CudaEngine.metrics``, the dispatch-lane counters) and the
bench harnesses (bench/callrate.py, bench/sweep.py) publish into a
:class:`MetricsRegistry`, queryable via ``ACCL.metrics()`` /
``ACCL.dump_metrics()`` (text + JSON) and the OpenMetrics exporter of
health.py.  The bandwidth conventions (payload and busbw correction
factors) are the nccl-tests ones, the same factors bench/sweep.py
records in its CSVs.  The HELP table is the reference's, family for
family, so an exporter consumer reads both packages alike.

Metrics are always on by default (a handful of dict ops per call);
``ACCL_METRICS=0`` turns the driver's per-call publishing off for
overhead-critical runs.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..constants import env_int

#: fixed histogram bucket upper bounds, microseconds (powers of 4 —
#: 1 µs .. ~16.8 s, 13 buckets + overflow): coarse enough to stay
#: allocation-free per observation, fine enough to separate the
#: dispatch lanes the callrate bench distinguishes
LATENCY_BUCKETS_US = tuple(4 ** k for k in range(13))

#: collectives whose per-rank payload is count*P elements (the driver
#: count is per-peer / per-chunk) — the nccl-tests size convention
_XP_COLLECTIVES = ("allgather", "reduce_scatter", "alltoall")

#: HELP text for the exporter's well-known families (OpenMetrics `# HELP`
#: lines) — the schema contract exporter consumers (dashboards,
#: alerting) pin in tests/test_flight_recorder.py.  Keys are the FINAL
#: metric names after prefixing/sanitizing (see to_openmetrics name()).
METRIC_HELP = {
    "accl_health": ("world health gauge: 0=ok 1=degraded 2=hung "
                    "3=aborted 4=recovering 5=slow"),
    "accl_watchdog_checks": "watchdog scan sweeps executed",
    "accl_watchdog_fires": "watchdog hang detections (one per episode)",
    "accl_membership_joins": ("replacement ranks admitted through the "
                              "elastic join protocol"),
    "accl_membership_grows": ("communicators grown back toward full "
                              "size (ACCL.grow_communicator)"),
    "accl_membership_shrinks": ("ULFM-style shrinks to a survivor set "
                                "(ACCL.shrink_communicator)"),
    "accl_membership_rank_deaths": ("peer ranks declared dead by a "
                                    "recovery supervisor probe"),
    "accl_recovery_rounds": "recovery-supervisor episodes entered",
    "accl_recovery_halts": ("recovery episodes that gave up (halt "
                            "policy or max rounds exhausted)"),
    "accl_recovery_latency_us": ("end-to-end recovery episode latency, "
                                 "detect -> resume"),
    "accl_join_wait_us": ("time a grow-policy supervisor spent waiting "
                          "for a replacement to announce itself"),
    "accl_plans_captures": ("persistent collective plans captured + "
                            "armed (ACCL.capture_plan)"),
    "accl_plans_replays": ("plan replays issued through the submission "
                           "ring (sync + async + auto lanes)"),
    "accl_plans_invalidations": ("plans fenced by an abort/epoch bump/"
                                 "membership change/reset — each one "
                                 "is a replay that was REFUSED instead "
                                 "of running on a dead world"),
    "accl_wire_accepted_frames": ("ingress wire frames that passed "
                                  "structural validation"),
    "accl_wire_rejected_frames": ("ingress wire frames rejected as "
                                  "malformed (truncated/unknown type/"
                                  "count mismatch/out-of-range comm) — "
                                  "nonzero means a corrupting transport "
                                  "or hostile peer"),
    # ---- engine telemetry families (r14, observability/telemetry.py:
    # the ACCL_TELEMETRY_INTERVAL_MS sampler over accl_engine_stats) ----
    "accl_engine_retrans_store_depth": (
        "live slots in the eager retransmit store (gauge, max rank)"),
    "accl_engine_retrans_store_evictions": (
        "retransmit-store ring wraps over a live slot — a NACK after "
        "an eviction can no longer be served"),
    "accl_engine_retrans_sent": "eager segments retransmitted on NACK",
    "accl_engine_nacks_tx": "NACK solicitations sent (receiver side)",
    "accl_engine_nacks_rx": "NACK solicitations received (sender side)",
    "accl_engine_fenced_drops": ("ingress frames dropped at an abort/"
                                 "epoch fence"),
    "accl_engine_rx_occupancy": "rx-pool buffers RESERVED right now",
    "accl_engine_rx_occupancy_hwm": ("rx-pool occupancy high-water "
                                     "since bring-up"),
    "accl_engine_rx_staged": ("ingress messages parked in the rx-pool "
                              "staging queue (pool exhausted)"),
    "accl_engine_rx_staged_hwm": "rx-pool staging-queue high-water",
    "accl_engine_rx_pending": "rx notifications queued, not yet sought",
    "accl_engine_egress_depth": ("segments staged in the egress "
                                 "pipeline right now"),
    "accl_engine_egress_hwm": "egress staging high-water since bring-up",
    "accl_engine_ingress_depth": ("transport deliveries executing "
                                  "inside the engine right now"),
    "accl_engine_seeks": "recovered-seek entries (blocking rx matches)",
    "accl_engine_seek_misses": ("seeks that timed out after the whole "
                                "recovery budget — misses/seeks is the "
                                "seek-miss rate"),
    "accl_engine_plans_live": "valid persistent plans armed engine-side",
    "accl_engine_plan_tokens": "plan replay tokens in flight/unclaimed",
    "accl_engine_plan_replays": "plan replays queued through the ring",
    "accl_engine_wire_accepted_frames": ("ingress frames that passed "
                                         "structural validation"),
    "accl_engine_wire_rejected_frames": ("ingress frames rejected as "
                                         "malformed"),
    "accl_engine_tx_msgs": "egress messages handed to the transport",
    "accl_engine_tx_payload_bytes": ("egress payload bytes handed to "
                                     "the transport"),
    "accl_engine_joins_sponsored": "elastic joins answered as sponsor",
    "accl_engine_joins_completed": "elastic joins completed as joiner",
    # ---- quantized wire lane (r17, engine stats v3) ----
    "accl_engine_compressed_tx_bytes": (
        "egress payload bytes that left through a compressed wire lane "
        "(f16/bf16 cast or int8 block-scaled)"),
    "accl_engine_compressed_tx_logical_bytes": (
        "uncompressed-equivalent bytes of the compressed egress "
        "traffic (saved = logical - compressed)"),
    "accl_wire_compressed_tx_bytes": (
        "wire bytes sent compressed, summed across the world's "
        "compressed lanes (r17 quantized wire)"),
    "accl_wire_compressed_saved_bytes": (
        "wire bytes SAVED by compression vs the logical uncompressed "
        "traffic — the bandwidth-multiplier observable"),
    # ---- per-link wire telemetry (r15, accl_engine_link_stats) ----
    "accl_engine_link_rows": ("(comm, peer) link rows the engine's "
                              "per-link counter plane is tracking "
                              "(gauge, max rank)"),
    # gang-scheduler twin fields (CudaDeviceView.engine_stats)
    "accl_engine_plan_ring_refs": ("per-rank plan handles pinning live "
                                   "gang-scheduler plan rings"),
    "accl_engine_plan_ring_generation": ("max per-comm fence generation "
                                         "(abort/rebuild bumps it)"),
    "accl_engine_plan_ring_replays": "replays issued on live plan rings",
    "accl_engine_plan_auto_captures": ("plan rings armed by the "
                                       "ACCL_PLAN_AUTO streak detector"),
    "accl_engine_leader_dispatches": ("gangs executed inline on the "
                                      "last-arriving rank's thread"),
    "accl_engine_executor_dispatches": "gangs executed on the executor",
    "accl_engine_batches": "fused executor dispatch batches",
    "accl_engine_batched_gangs": "gangs fused into executor batches",
    "accl_engine_ready_depth": ("complete gangs queued behind the "
                                "executor right now"),
    # ---- per-call collective families (observe_call) ----
    "accl_collective_calls": ("collective calls completed, per "
                              "(collective, dtype, size_bucket)"),
    "accl_collective_errors": "collective calls with non-zero retcode",
    "accl_collective_bytes": "per-rank payload bytes moved",
    "accl_collective_latency_us": ("submit→complete latency histogram "
                                   "(power-of-4 µs buckets)"),
    "accl_collective_algbw_gbps": "algorithmic bandwidth (nccl-tests)",
    "accl_collective_busbw_gbps": ("bus bandwidth (nccl-tests "
                                   "correction factors)"),
    # ---- registry self-protection (r20 cardinality guard) ----
    "accl_metrics_dropped_series": (
        "new metric series refused because the registry hit "
        "ACCL_METRICS_MAX_SERIES — nonzero means a dynamic label "
        "(tenant name, peer id) is minting unbounded families"),
    # ---- per-tenant collective families (r20, observe_call tenant=) ----
    "accl_tenant_collective_calls": ("collective calls completed per "
                                     "(tenant, collective, dtype, "
                                     "size_bucket)"),
    "accl_tenant_collective_errors": ("per-tenant collective calls with "
                                      "non-zero retcode"),
    "accl_tenant_collective_bytes": "per-tenant per-rank payload bytes",
    "accl_tenant_collective_latency_us": (
        "per-tenant submit->complete latency histogram (power-of-4 µs "
        "buckets) — the SLOTracker's estimator substrate"),
    "accl_tenant_collective_algbw_gbps": (
        "per-tenant algorithmic bandwidth (nccl-tests)"),
    "accl_tenant_collective_busbw_gbps": (
        "per-tenant bus bandwidth (nccl-tests correction factors)"),
    # ---- regression sentinel (r14, observability/sentinel.py) ----
    "accl_sentinel_checks": "sentinel comparison sweeps executed",
    "accl_sentinel_findings": ("sentinel drift findings (p50/p99/"
                               "bandwidth past threshold vs baseline)"),
    # ---- per-tenant SLO tracker (r20, observability/slo.py) ----
    "accl_slo_checks": "SLO tracker evaluation sweeps executed",
    "accl_slo_findings": ("fresh SLO findings delivered (fast/slow "
                          "burn-rate breaches, budget exhaustion, "
                          "busbw floor breaches) per tenant objective"),
    # ---- online tuner retune episodes (r19, tuning/online.py) ----
    "accl_tuning_retunes_proposed": ("retune hypotheses opened from a "
                                     "sentinel finding or fabric "
                                     "re-score (one cell or one axis, "
                                     "never a full sweep)"),
    "accl_tuning_retunes_verified": ("retune hypotheses whose "
                                     "challenger won the interleaved "
                                     "best-of A/B against the "
                                     "incumbent"),
    "accl_tuning_retunes_installed": ("retune selections hot-swapped "
                                      "into the live SelectionPolicy "
                                      "and backend registers"),
    "accl_tuning_retunes_rejected": ("retune hypotheses dropped: "
                                     "challenger lost the A/B, "
                                     "hysteresis margin unmet, or "
                                     "cooldown suppressed the cell"),
    "accl_tuning_retunes_reverted": ("installed retunes rolled back "
                                     "after a post-install sentinel "
                                     "regression on the same cell"),
    # ---- per-engine registry bare names (CudaEngine.metrics — the
    # dispatch-lane counters ACCL.metrics() merges under engine/ keys;
    # HELP here keeps the per-engine registry itself exportable) ----
    "accl_leader_dispatches": ("gangs executed inline on the last-"
                               "arriving rank's thread"),
    "accl_executor_dispatches": "gangs executed on the executor thread",
    "accl_batches": "fused executor dispatch batches",
    "accl_batched_gangs": "gangs fused into executor batches",
    "accl_plan_replays": "plan replays issued through the ring",
    "accl_plan_auto_captures": ("plan rings armed by the ACCL_PLAN_AUTO "
                                "streak detector"),
    "accl_compressed_tx_bytes": ("wire bytes the gang scheduler moved "
                                 "through a compressed lane (r17)"),
    "accl_compressed_tx_logical_bytes": (
        "uncompressed-equivalent bytes of the compressed gang traffic"),
}

#: HELP for families minted with dynamic name parts (bench lane labels,
#: unknown newer-engine fields): matched by prefix after sanitizing.
#: The schema-completeness test (tests/test_telemetry.py) enforces that
#: every ``inc``/``set_gauge``/``observe_value`` literal in the tree
#: resolves through METRIC_HELP or one of these prefixes.
METRIC_HELP_PREFIXES = {
    "accl_callrate_": ("callrate bench lane gauge (calls_per_s / "
                       "latency_us / overhead_vs_raw_x per lane)"),
    "accl_sweep_": "bench sweep peak bus-bandwidth gauge per collective",
    "accl_engine_unknown_field_": ("engine stats field past this "
                                   "build's schema (newer engine)"),
    # r15 wire layer: one counter per (field, src->dst) link cell plus
    # the world total per field — the exported P×P traffic matrix
    # (observability/telemetry.py link_matrix / TelemetrySampler)
    "accl_link_": ("per-link wire counter (tx/rx msgs+bytes, "
                   "retransmits, NACKs, fenced drops, seek wait) per "
                   "src->dst link cell, world total when unsuffixed"),
    # r16 learned algorithm selection (the tuning layer): one counter
    # per algorithm the armed SelectionPolicy chose for a descriptor
    # signature (flat/tree/ring/hierarchical/static)
    "accl_tuning_selected_": ("calls whose descriptor signature the "
                              "ACCL_TUNE_TABLE selection policy "
                              "resolved to this algorithm lane"),
    # r20 per-tenant observability: verdict/budget gauges and any other
    # tenant-scoped family minted by the SLO tracker
    # (observability/slo.py) under tenant/<name>/...
    "accl_tenant_": ("per-tenant observability family (SLO verdicts, "
                     "budget-remaining, burn rates) under the "
                     "tenant/<name>/ namespace"),
}


def metric_help_for(name: str) -> Optional[str]:
    """HELP text for a FINAL (sanitized, prefixed) family name — exact
    entries first, then the dynamic-name prefixes.  None = the family
    is unknown to this build (the doctor renders it as unrecognized
    instead of crashing; the schema test fails the build that MINTED an
    unknown name)."""
    if name in METRIC_HELP:
        return METRIC_HELP[name]
    for prefix, text in METRIC_HELP_PREFIXES.items():
        if name.startswith(prefix):
            return text
    return None


def payload_factor(coll: str, p: int) -> int:
    """Per-rank payload in units of `count` elements."""
    return p if coll in _XP_COLLECTIVES else 1


def busbw_factor(coll: str, p: int) -> float:
    """Bus-bandwidth correction factors (nccl-tests conventions)."""
    if p <= 1:
        return 1.0
    if coll == "allreduce":
        return 2.0 * (p - 1) / p
    if coll in _XP_COLLECTIVES:
        return (p - 1) / p
    return 1.0


def size_bucket(nbytes: int) -> str:
    """Power-of-two size-bucket label (upper bound, human units)."""
    if nbytes <= 0:
        return "0B"
    ub = 1 << max(nbytes - 1, 0).bit_length()
    for unit in ("B", "KiB", "MiB", "GiB"):
        if ub < 1024:
            return f"<={ub}{unit}"
        ub //= 1024
    return f"<={ub}TiB"


class _CallStats:
    __slots__ = ("calls", "errors", "total_ns", "min_ns", "max_ns",
                 "total_bytes", "total_engine_ns", "nranks", "hist")

    def __init__(self, nbuckets: int):
        self.calls = 0
        self.errors = 0
        self.total_ns = 0.0
        self.min_ns = float("inf")
        self.max_ns = 0.0
        self.total_bytes = 0
        self.total_engine_ns = 0.0
        self.nranks = 1
        self.hist = [0] * (nbuckets + 1)  # + overflow


#: default hard bound on distinct series across every table in one
#: registry (counters + gauges + value histograms + call signatures +
#: tenant call signatures) — generous for real worlds, small enough
#: that a tenant-name bug (unbounded labels) cannot OOM the exporter
DEFAULT_MAX_SERIES = 4096

#: the overflow family itself — exempt from the bound so the drop is
#: always countable even at capacity
_DROPPED_SERIES = "metrics/dropped_series"


class MetricsRegistry:
    """Thread-safe counters + gauges + per-call-signature stats.

    New-series creation is bounded by ``ACCL_METRICS_MAX_SERIES``
    (constants env contract: a malformed value raises a clear
    :class:`~accl_tpu_torch.constants.ACCLError` naming the knob).  Once the
    bound is hit, observations that would mint a NEW series are dropped
    and counted under ``metrics/dropped_series``; existing series keep
    updating normally.
    """

    def __init__(self, max_series: Optional[int] = None):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._calls: dict = {}
        #: per-(tenant, collective, dtype, size_bucket) call stats —
        #: the r20 tenant dimension (observe_call tenant=...)
        self._tenant_calls: dict = {}
        #: named value histograms (power-of-4 µs buckets, same shape as
        #: the per-call latency histograms): recovery latency, join
        #: wait — anything that is a distribution but not a collective
        self._values: dict = {}
        self._max_series = (
            max_series if max_series is not None
            else env_int("ACCL_METRICS_MAX_SERIES", DEFAULT_MAX_SERIES,
                         minimum=16))

    # -- cardinality guard (call under self._lock) ---------------------
    def _admit_locked(self, table: dict, key) -> bool:
        """True if `key` may be inserted into `table`: already present,
        or the registry still has series headroom.  A refused insert is
        counted under the (exempt) overflow family."""
        if key in table:
            return True
        total = (len(self._counters) + len(self._gauges)
                 + len(self._values) + len(self._calls)
                 + len(self._tenant_calls))
        if total < self._max_series:
            return True
        self._counters[_DROPPED_SERIES] = \
            self._counters.get(_DROPPED_SERIES, 0) + 1
        return False

    # -- counters / gauges --------------------------------------------
    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            if name != _DROPPED_SERIES and \
                    not self._admit_locked(self._counters, name):
                return
            self._counters[name] = self._counters.get(name, 0) + value

    # -- named value histograms ---------------------------------------
    def observe_value(self, name: str, value_us: float) -> None:
        """One observation into the named histogram (µs domain, fixed
        power-of-4 buckets — allocation-free after the first)."""
        with self._lock:
            st = self._values.get(name)
            if st is None:
                if not self._admit_locked(self._values, name):
                    return
                st = self._values[name] = {
                    "count": 0, "sum_us": 0.0,
                    "hist": [0] * (len(LATENCY_BUCKETS_US) + 1)}
            st["count"] += 1
            st["sum_us"] += value_us
            for i, ub in enumerate(LATENCY_BUCKETS_US):
                if value_us <= ub:
                    st["hist"][i] += 1
                    break
            else:
                st["hist"][-1] += 1

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            if not self._admit_locked(self._gauges, name):
                return
            self._gauges[name] = value

    # -- per-call stats ------------------------------------------------
    @staticmethod
    def _record_call_locked(st: "_CallStats", nbytes: int,
                            duration_ns: float, nranks: int, ok: bool,
                            engine_ns: float) -> None:
        st.calls += 1
        st.nranks = nranks
        if not ok:
            st.errors += 1
            return
        st.total_ns += duration_ns
        st.min_ns = min(st.min_ns, duration_ns)
        st.max_ns = max(st.max_ns, duration_ns)
        st.total_bytes += nbytes
        st.total_engine_ns += engine_ns
        us = duration_ns / 1e3
        for i, ub in enumerate(LATENCY_BUCKETS_US):
            if us <= ub:
                st.hist[i] += 1
                break
        else:
            st.hist[-1] += 1

    def observe_call(self, collective: str, dtype: str, nbytes: int,
                     duration_ns: float, nranks: int = 1, ok: bool = True,
                     engine_ns: float = 0.0,
                     tenant: Optional[str] = None) -> None:
        """Record one completed call: count, latency histogram bucket,
        byte volume (bandwidth is derived at snapshot time).  With
        `tenant`, the same observation also lands in the per-tenant
        table (its own latency histogram per signature — the SLO
        tracker's estimator substrate)."""
        key = (collective, dtype, size_bucket(nbytes))
        with self._lock:
            st = self._calls.get(key)
            if st is None:
                if not self._admit_locked(self._calls, key):
                    st = None
                else:
                    st = self._calls[key] = \
                        _CallStats(len(LATENCY_BUCKETS_US))
            if st is not None:
                self._record_call_locked(st, nbytes, duration_ns, nranks,
                                         ok, engine_ns)
            if tenant is None:
                return
            tkey = (tenant,) + key
            tst = self._tenant_calls.get(tkey)
            if tst is None:
                if not self._admit_locked(self._tenant_calls, tkey):
                    return
                tst = self._tenant_calls[tkey] = \
                    _CallStats(len(LATENCY_BUCKETS_US))
            self._record_call_locked(tst, nbytes, duration_ns, nranks,
                                     ok, engine_ns)

    # -- query ---------------------------------------------------------
    @staticmethod
    def _call_doc(coll: str, dtype: str, bucket: str,
                  st: "_CallStats") -> dict:
        good = st.calls - st.errors
        avg_ns = st.total_ns / good if good else 0.0
        algbw = st.total_bytes / st.total_ns if st.total_ns > 0 else 0.0
        return {
            "collective": coll,
            "dtype": dtype,
            "size_bucket": bucket,
            "calls": st.calls,
            "errors": st.errors,
            "nranks": st.nranks,
            "bytes": st.total_bytes,
            "latency_us": {
                "min": round(st.min_ns / 1e3, 2) if good else 0.0,
                "avg": round(avg_ns / 1e3, 2),
                "max": round(st.max_ns / 1e3, 2),
                # exact sum: the OpenMetrics histogram _sum
                # (avg*calls would re-round)
                "total": round(st.total_ns / 1e3, 2),
            },
            "hist_us": {
                **{f"le_{ub}": n for ub, n in
                   zip(LATENCY_BUCKETS_US, st.hist)},
                "inf": st.hist[-1],
            },
            # 6 decimals: a small-message call is a few µGB/s
            # and must not round to a flat 0.0
            "algbw_GBps": round(algbw, 6),
            "busbw_GBps": round(
                algbw * busbw_factor(coll, st.nranks), 6),
        }

    def snapshot(self) -> dict:
        """Full registry state; bandwidths in GB/s (bytes/ns)."""
        with self._lock:
            calls = {}
            for (coll, dtype, bucket), st in self._calls.items():
                calls["|".join((coll, dtype, bucket))] = \
                    self._call_doc(coll, dtype, bucket, st)
            tenant_calls = {}
            for (tenant, coll, dtype, bucket), st in \
                    self._tenant_calls.items():
                doc = self._call_doc(coll, dtype, bucket, st)
                doc["tenant"] = tenant
                tenant_calls["|".join((tenant, coll, dtype, bucket))] = doc
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "values": {k: {"count": v["count"],
                                   "sum_us": round(v["sum_us"], 2),
                                   "hist": list(v["hist"])}
                               for k, v in self._values.items()},
                    "calls": calls,
                    "tenant_calls": tenant_calls}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_text(self) -> str:
        """Aligned human-readable dump (the dump_metrics text mode)."""
        snap = self.snapshot()
        lines = ["== counters =="]
        for k in sorted(snap["counters"]):
            lines.append(f"  {k:<40} {snap['counters'][k]}")
        if snap["gauges"]:
            lines.append("== gauges ==")
            for k in sorted(snap["gauges"]):
                lines.append(f"  {k:<40} {snap['gauges'][k]:.3f}")
        if snap["values"]:
            lines.append("== value histograms (us) ==")
            for k in sorted(snap["values"]):
                v = snap["values"][k]
                avg = v["sum_us"] / v["count"] if v["count"] else 0.0
                lines.append(f"  {k:<40} n={v['count']} avg={avg:.1f}")
        lines.append("== calls ==")
        hdr = (f"  {'collective':<16} {'dtype':<10} {'size':<10} "
               f"{'calls':>7} {'err':>4} {'avg_us':>10} {'min_us':>10} "
               f"{'max_us':>10} {'algbw':>11} {'busbw':>11}")
        lines.append(hdr)
        for k in sorted(snap["calls"]):
            c = snap["calls"][k]
            lines.append(
                f"  {c['collective']:<16} {c['dtype']:<10} "
                f"{c['size_bucket']:<10} {c['calls']:>7} {c['errors']:>4} "
                f"{c['latency_us']['avg']:>10.2f} "
                f"{c['latency_us']['min']:>10.2f} "
                f"{c['latency_us']['max']:>10.2f} "
                f"{c['algbw_GBps']:>11.6f} {c['busbw_GBps']:>11.6f}")
        return "\n".join(lines)

    def to_openmetrics(self) -> str:
        """OpenMetrics text exposition (the /metrics scrape body served
        by observability.health.start_exporter).

        Layout: counters as ``accl_<name>_total``, gauges as
        ``accl_<name>`` (names already carrying the ``accl_`` prefix —
        e.g. the watchdog's ``accl_health`` — are not double-prefixed),
        and the per-signature call stats as labeled families:
        ``accl_collective_calls_total`` / ``_errors_total`` /
        ``_bytes_total``, an ``accl_collective_latency_us`` histogram
        with cumulative power-of-4 buckets, and ``accl_collective_
        algbw_gbps`` / ``busbw_gbps`` gauges."""
        import re

        def name(n: str) -> str:
            n = re.sub(r"[^a-zA-Z0-9_:]", "_", n)
            return n if n.startswith("accl_") else f"accl_{n}"

        def esc(v) -> str:
            return str(v).replace("\\", r"\\").replace('"', r'\"')

        snap = self.snapshot()
        out = []

        def describe(n: str) -> None:
            text = metric_help_for(n)
            if text is not None:
                out.append(f"# HELP {n} {text}")

        for k in sorted(snap["counters"]):
            n = name(k)
            describe(n)
            out.append(f"# TYPE {n} counter")
            out.append(f"{n}_total {snap['counters'][k]}")
        tenant_health = {}
        for k in sorted(snap["gauges"]):
            m = re.match(r"^tenant/([^/]+)/health$", k)
            if m:
                # per-tenant health rides the accl_health family as a
                # labeled sample (the SLO tracker's verdict surface)
                tenant_health[m.group(1)] = snap["gauges"][k]
                continue
            n = name(k)
            describe(n)
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {snap['gauges'][k]}")
        if tenant_health:
            describe("accl_health")
            out.append("# TYPE accl_health gauge")
            for t in sorted(tenant_health):
                out.append(
                    f'accl_health{{tenant="{esc(t)}"}} {tenant_health[t]}')
        for k in sorted(snap["values"]):
            n = name(k)
            v = snap["values"][k]
            describe(n)
            out.append(f"# TYPE {n} histogram")
            cum = 0
            for ub, cnt in zip(LATENCY_BUCKETS_US, v["hist"]):
                cum += cnt
                out.append(f'{n}_bucket{{le="{ub}"}} {cum}')
            cum += v["hist"][-1]
            out.append(f'{n}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{n}_sum {v['sum_us']}")
            out.append(f"{n}_count {v['count']}")
        def emit_call_tables(table: dict, base: str) -> None:
            if not table:
                return
            for fam, kind in ((f"{base}_calls", "counter"),
                              (f"{base}_errors", "counter"),
                              (f"{base}_bytes", "counter"),
                              (f"{base}_latency_us", "histogram"),
                              (f"{base}_algbw_gbps", "gauge"),
                              (f"{base}_busbw_gbps", "gauge")):
                describe(fam)
                out.append(f"# TYPE {fam} {kind}")
            for k in sorted(table):
                c = table[k]
                lbl = (f'collective="{esc(c["collective"])}",'
                       f'dtype="{esc(c["dtype"])}",'
                       f'size_bucket="{esc(c["size_bucket"])}"')
                if "tenant" in c:
                    lbl = f'tenant="{esc(c["tenant"])}",' + lbl
                out.append(f"{base}_calls_total{{{lbl}}} {c['calls']}")
                out.append(f"{base}_errors_total{{{lbl}}} {c['errors']}")
                out.append(f"{base}_bytes_total{{{lbl}}} {c['bytes']}")
                cum = 0
                for ub in LATENCY_BUCKETS_US:
                    cum += c["hist_us"][f"le_{ub}"]
                    out.append(f"{base}_latency_us_bucket"
                               f'{{{lbl},le="{ub}"}} {cum}')
                cum += c["hist_us"]["inf"]
                out.append(f"{base}_latency_us_bucket"
                           f'{{{lbl},le="+Inf"}} {cum}')
                out.append(f"{base}_latency_us_sum"
                           f"{{{lbl}}} {c['latency_us']['total']}")
                out.append(f"{base}_latency_us_count{{{lbl}}} {cum}")
                out.append(f"{base}_algbw_gbps{{{lbl}}} {c['algbw_GBps']}")
                out.append(f"{base}_busbw_gbps{{{lbl}}} {c['busbw_GBps']}")

        emit_call_tables(snap["calls"], "accl_collective")
        emit_call_tables(snap.get("tenant_calls", {}),
                         "accl_tenant_collective")
        out.append("# EOF")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._calls.clear()
            self._tenant_calls.clear()
            self._values.clear()


_default = MetricsRegistry()
_metrics_enabled = os.environ.get("ACCL_METRICS", "1") != "0"


def default_registry() -> MetricsRegistry:
    """The process-wide registry every rank's driver publishes into —
    in-process worlds (EmuWorld/TpuWorld) aggregate across ranks, the
    natural unit the bench harnesses report on."""
    return _default


def enabled() -> bool:
    return _metrics_enabled


def set_enabled(on: bool) -> None:
    global _metrics_enabled
    _metrics_enabled = on


def dump_metrics(registry: Optional[MetricsRegistry] = None,
                 as_json: bool = False) -> str:
    reg = registry if registry is not None else _default
    return reg.to_json() if as_json else reg.to_text()


# ---------------------------------------------------------------------------
# OpenMetrics validator (r14): the schema contract, enforced by
# construction.  tests/test_telemetry.py runs every exporter body
# through this, and the METRIC_HELP completeness test closes the drift
# class where a new family ships without HELP text — a scrape consumer
# should never meet an undocumented family.
# ---------------------------------------------------------------------------
def validate_openmetrics(text: str, require_help: bool = True) -> list:
    """Validate an OpenMetrics exposition body; returns a list of
    problem strings (empty = valid).  Checks the subset of the spec the
    exporter promises: ``# TYPE`` precedes a family's samples, sample
    names extend their declared family correctly (``_total`` for
    counters; ``_bucket``/``_sum``/``_count`` for histograms), values
    parse as numbers, histogram buckets are cumulative-monotonic with a
    ``+Inf`` bound, label syntax is well-formed, and the body ends with
    ``# EOF``.  With ``require_help``, every declared family must also
    resolve through :func:`metric_help_for`."""
    import re

    problems: list = []
    lines = text.splitlines()
    if not lines or lines[-1].strip() != "# EOF":
        problems.append("missing terminal '# EOF' line")
    types: dict = {}
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
        r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*)?\})?'
        r' (\S+)$')
    # histogram cumulative check state: (family, labels-sans-le) -> last
    hist_last: dict = {}

    def family_of(name: str) -> Optional[str]:
        for fam, kind in types.items():
            if kind == "counter" and name == f"{fam}_total":
                return fam
            if kind == "histogram" and name in (
                    f"{fam}_bucket", f"{fam}_sum", f"{fam}_count"):
                return fam
            if kind == "gauge" and name == fam:
                return fam
        return None

    for i, ln in enumerate(lines, 1):
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split(None, 3)
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "info"):
                problems.append(f"line {i}: malformed TYPE line: {ln!r}")
                continue
            types[parts[2]] = parts[3]
            continue
        if ln.startswith("#"):
            continue
        m = sample_re.match(ln)
        if m is None:
            problems.append(f"line {i}: unparsable sample: {ln!r}")
            continue
        name, labels, value = m.group(1), m.group(3) or "", m.group(5)
        try:
            float(value)
        except ValueError:
            problems.append(f"line {i}: non-numeric value {value!r}")
        fam = family_of(name)
        if fam is None:
            problems.append(
                f"line {i}: sample {name!r} has no matching TYPE "
                f"declaration (or wrong suffix for its family kind)")
            continue
        if types[fam] == "histogram" and name == f"{fam}_bucket":
            le = None
            rest = []
            for pair in labels.split(","):
                if pair.startswith('le="'):
                    le = pair[4:-1]
                elif pair:
                    rest.append(pair)
            if le is None:
                problems.append(f"line {i}: histogram bucket without le")
                continue
            key = (fam, ",".join(rest))
            cum = float(value)
            if key in hist_last and cum < hist_last[key]:
                problems.append(
                    f"line {i}: histogram {fam} buckets not cumulative")
            hist_last[key] = cum
            if le == "+Inf":
                hist_last.pop(key, None)
    for key in hist_last:
        problems.append(f"histogram {key[0]} missing le=\"+Inf\" bucket")
    if require_help:
        for fam in types:
            if metric_help_for(fam) is None:
                problems.append(
                    f"family {fam} has no METRIC_HELP entry (add one — "
                    f"the schema contract scrape consumers pin)")
    return problems
