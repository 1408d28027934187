"""Continuous performance-regression sentinel.

Port of ``accl_tpu/observability/sentinel.py``, whole.  Compares the
LIVE per-(collective, dtype, size-bucket) latency histograms and derived
bandwidth in the metrics registry against a COMMITTED baseline, and when
p50/p99 or bus bandwidth drift past configurable thresholds it logs a
structured finding, bumps the ``sentinel/findings`` counter, and turns
the ``accl_health`` gauge to ``slow`` (5) through ``health.note_slow``:
correct but slow is a production state of its own, distinct from
degraded or hung.

Baselines
---------
Three on-disk shapes load into one internal table keyed
``(collective, dtype, size_bucket, lane)``, read as data:

- sentinel-native JSON (``{"version": 1, "entries": [...]}`` — what
  :meth:`Baseline.save` writes and what a captured registry snapshot
  converts to via :meth:`Baseline.from_snapshot`);
- a callrate bench record (``bench/results/callrate_*.json``): each
  bench lane's ``latency_us`` becomes that lane's p50==p99 floor for
  the allreduce signature the bench drives;
- a sweep-gate CSV (``bench/results/sweep_gate_baseline_*.csv``):
  per-(collective, bytes) best-of-repetitions duration/bandwidth rows.

Live registry signatures carry no lane, so they match lane ``"live"``
first and the wildcard lane ``"*"`` second; bench-derived entries load
under their bench lane name AND ``"*"``.

Knobs: ``ACCL_SENTINEL`` (off / ``1`` = baseline from
``ACCL_SENTINEL_BASELINE`` / a baseline path),
``ACCL_SENTINEL_INTERVAL_MS`` (default 5000), ``ACCL_SENTINEL_P50`` /
``ACCL_SENTINEL_P99`` (drift ratios, default 2.0 / 3.0),
``ACCL_SENTINEL_BW`` (bandwidth floor ratio, default 0.5),
``ACCL_SENTINEL_MIN_CALLS`` (default 20 — don't judge cold
histograms).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

from . import health as _health
from .metrics import (
    LATENCY_BUCKETS_US,
    MetricsRegistry,
    default_registry,
    size_bucket,
)


def quantile_us(hist: list, q: float) -> float:
    """Quantile estimate from a power-of-4 cumulative-count histogram
    (``_CallStats.hist`` shape: one count per LATENCY_BUCKETS_US bound
    + overflow).  Log-interpolates inside the winning bucket — coarse
    buckets make this an estimate, but a p50 drifting 2x across
    power-of-4 bounds is exactly the signal the sentinel needs."""
    total = sum(hist)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    prev_ub = 0.25  # log-floor for the first bucket (1 us upper bound)
    for i, ub in enumerate(LATENCY_BUCKETS_US):
        cum += hist[i]
        if cum >= target:
            lo = prev_ub
            frac = (target - (cum - hist[i])) / max(hist[i], 1)
            # geometric interpolation inside the bucket
            return lo * (ub / lo) ** max(min(frac, 1.0), 0.0)
        prev_ub = ub
    return float(LATENCY_BUCKETS_US[-1]) * 4  # overflow bucket


class Baseline:
    """Committed perf expectations keyed (collective, dtype,
    size_bucket, lane)."""

    VERSION = 1

    def __init__(self, entries: Optional[dict] = None, source: str = ""):
        #: (collective, dtype, size_bucket, lane) ->
        #: {"p50_us", "p99_us", "busbw_GBps"} (0.0 = don't gate that axis)
        self.entries: dict = entries or {}
        self.source = source

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_snapshot(cls, snapshot: dict, lane: str = "live",
                      source: str = "snapshot") -> "Baseline":
        """Capture a registry snapshot as the baseline (what a world
        that just passed its perf gate commits)."""
        entries = {}
        for c in snapshot.get("calls", {}).values():
            hist = [c["hist_us"][f"le_{ub}"] for ub in LATENCY_BUCKETS_US]
            hist.append(c["hist_us"]["inf"])
            key = (c["collective"], c["dtype"], c["size_bucket"], lane)
            entries[key] = {
                "p50_us": round(quantile_us(hist, 0.5), 2),
                "p99_us": round(quantile_us(hist, 0.99), 2),
                "busbw_GBps": c.get("busbw_GBps", 0.0),
            }
        return cls(entries, source)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Load any of the three committed shapes by sniffing."""
        if path.endswith(".csv"):
            return cls._load_sweep_csv(path)
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "entries" in doc:
            entries = {}
            for e in doc["entries"]:
                key = (e["collective"], e["dtype"], e["size_bucket"],
                       e.get("lane", "*"))
                entries[key] = {"p50_us": e.get("p50_us", 0.0),
                                "p99_us": e.get("p99_us", 0.0),
                                "busbw_GBps": e.get("busbw_GBps", 0.0)}
            return cls(entries, path)
        if isinstance(doc, dict) and "lanes" in doc:
            return cls._from_callrate(doc, path)
        if isinstance(doc, dict) and "calls" in doc:
            base = cls.from_snapshot(doc, source=path)
            # snapshot baselines also gate under the wildcard lane
            for (coll, dt, bucket, _lane), v in list(base.entries.items()):
                base.entries.setdefault((coll, dt, bucket, "*"), v)
            return base
        raise ValueError(
            f"unrecognized baseline format: {path} (want a sentinel "
            f"JSON, a callrate record, a registry snapshot, or a "
            f"sweep-gate CSV)")

    @classmethod
    def _from_callrate(cls, doc: dict, source: str) -> "Baseline":
        entries = {}
        count = int(doc.get("count", 0))
        nbytes = count * 4  # the callrate bench drives float32
        bucket = size_bucket(nbytes)
        for lane, row in doc.get("lanes", {}).items():
            lat = float(row.get("latency_us", 0.0))
            if lat <= 0:
                continue
            v = {"p50_us": lat, "p99_us": lat, "busbw_GBps": 0.0}
            entries[("allreduce", "float32", bucket, lane)] = v
            # best lane becomes the wildcard gate for live histograms
            wkey = ("allreduce", "float32", bucket, "*")
            if wkey not in entries or lat < entries[wkey]["p50_us"]:
                entries[wkey] = dict(v)
        return cls(entries, source)

    @classmethod
    def _load_sweep_csv(cls, path: str) -> "Baseline":
        import csv

        best: dict = {}
        with open(path) as f:
            for row in csv.DictReader(f):
                try:
                    nbytes = int(float(row["bytes"]))
                    dur = float(row["duration_us"])
                    bw = float(row.get("busbw_GBps", 0.0))
                except (KeyError, ValueError):
                    continue
                key = (row["collective"], "float32", size_bucket(nbytes),
                       "*")
                cur = best.get(key)
                if cur is None or dur < cur["p50_us"]:
                    best[key] = {"p50_us": dur, "p99_us": dur,
                                 "busbw_GBps": bw}
        return cls(best, path)

    # -- persistence ----------------------------------------------------
    def to_doc(self) -> dict:
        return {
            "version": self.VERSION,
            "source": self.source,
            "entries": [
                {"collective": k[0], "dtype": k[1], "size_bucket": k[2],
                 "lane": k[3], **v}
                for k, v in sorted(self.entries.items())],
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        return path

    def lookup(self, collective: str, dtype: str, bucket: str,
               lane: str = "live") -> Optional[dict]:
        return self.entries.get((collective, dtype, bucket, lane)) \
            or self.entries.get((collective, dtype, bucket, "*"))

    def merge(self, other: "Baseline") -> "Baseline":
        merged = dict(other.entries)
        merged.update(self.entries)  # self wins on conflicts
        return Baseline(merged, f"{self.source}+{other.source}")


class Sentinel:
    """The live drift checker; one per registry (usually the default)."""

    def __init__(self, baseline: Baseline,
                 registry: Optional[MetricsRegistry] = None,
                 p50_ratio: Optional[float] = None,
                 p99_ratio: Optional[float] = None,
                 bw_ratio: Optional[float] = None,
                 min_calls: Optional[int] = None):
        from ..constants import env_float, env_int

        self.baseline = baseline
        self._registry = registry if registry is not None \
            else default_registry()
        self.p50_ratio = p50_ratio if p50_ratio is not None \
            else env_float("ACCL_SENTINEL_P50", 2.0, minimum=1.0)
        self.p99_ratio = p99_ratio if p99_ratio is not None \
            else env_float("ACCL_SENTINEL_P99", 3.0, minimum=1.0)
        self.bw_ratio = bw_ratio if bw_ratio is not None \
            else env_float("ACCL_SENTINEL_BW", 0.5, minimum=0.0)
        self.min_calls = min_calls if min_calls is not None \
            else env_int("ACCL_SENTINEL_MIN_CALLS", 20, minimum=1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: last check's findings (callers and tests read this)
        self.findings: list = []
        #: subscriber hook: callables invoked with each check's
        #: FRESH findings list (never the repeats) — see subscribe()
        self._subscribers: list = []
        #: (collective, dtype, bucket, axis) -> drift ratio at last
        #: delivery (the WORSEN_RATIO re-delivery reference)
        self._delivered: dict = {}

    # -- the comparison ------------------------------------------------
    def compare_snapshot(self, snapshot: dict) -> list:
        """Structured drift findings for one registry snapshot."""
        findings: list = []
        for c in snapshot.get("calls", {}).values():
            good = c["calls"] - c["errors"]
            if good < self.min_calls:
                continue
            base = self.baseline.lookup(c["collective"], c["dtype"],
                                        c["size_bucket"])
            if base is None:
                continue
            hist = [c["hist_us"][f"le_{ub}"] for ub in LATENCY_BUCKETS_US]
            hist.append(c["hist_us"]["inf"])
            p50 = quantile_us(hist, 0.5)
            p99 = quantile_us(hist, 0.99)

            def finding(axis, live, ref, ratio, kind="latency"):
                findings.append({
                    "collective": c["collective"], "dtype": c["dtype"],
                    "size_bucket": c["size_bucket"], "axis": axis,
                    "live": round(live, 2), "baseline": round(ref, 2),
                    "ratio": round(ratio, 3),
                    "threshold": (self.p50_ratio if axis == "p50_us"
                                  else self.p99_ratio
                                  if axis == "p99_us" else self.bw_ratio),
                    "kind": kind,
                    "baseline_source": self.baseline.source,
                })

            if base.get("p50_us", 0) > 0 and \
                    p50 > base["p50_us"] * self.p50_ratio:
                finding("p50_us", p50, base["p50_us"],
                        p50 / base["p50_us"])
            if base.get("p99_us", 0) > 0 and \
                    p99 > base["p99_us"] * self.p99_ratio:
                finding("p99_us", p99, base["p99_us"],
                        p99 / base["p99_us"])
            live_bw = c.get("busbw_GBps", 0.0)
            ref_bw = base.get("busbw_GBps", 0.0)
            if ref_bw > 0 and live_bw > 0 and \
                    live_bw < ref_bw * self.bw_ratio:
                finding("busbw_GBps", live_bw, ref_bw, live_bw / ref_bw,
                        kind="bandwidth")
        return findings

    #: a persisting finding is RE-delivered to subscribers when its
    #: drift ratio worsens past this factor of the last delivery (a
    #: control plane's revert path depends on it: a bad install makes
    #: an already-flagged cell WORSE; a merely-persisting finding must
    #: not spam the control plane)
    WORSEN_RATIO = 1.25

    def check(self) -> list:
        """One sweep: compare, publish counters + the slow verdict, log
        each NEW (or materially worsened) finding through the
        structured logger."""
        self._registry.inc("sentinel/checks")

        def _key(f):
            return (f["collective"], f["dtype"], f["size_bucket"],
                    f["axis"])

        def _drift(f):
            # bandwidth findings drift DOWN (live/baseline < 1); fold
            # both kinds into a worsens-upward scale
            return 1.0 / f["ratio"] if f["kind"] == "bandwidth" \
                and f["ratio"] else f["ratio"]

        live_keys = set()
        self.findings = self.compare_snapshot(self._registry.snapshot())
        fresh = []
        for f in self.findings:
            live_keys.add(_key(f))
            last = self._delivered.get(_key(f))
            if last is None or _drift(f) > last * self.WORSEN_RATIO:
                fresh.append(f)
                self._delivered[_key(f)] = _drift(f)
        # a finding that cleared re-arms: if it comes back, deliver it
        for k in list(self._delivered):
            if k not in live_keys:
                del self._delivered[k]
        if fresh:
            self._registry.inc("sentinel/findings", len(fresh))
            from ..utils.logging import get_logger

            log = get_logger("accl_tpu_torch.sentinel")
            for f in fresh:
                log.warning(
                    "perf regression: %s %s %s %s drifted %.2fx past "
                    "baseline (live %.2f vs %.2f, threshold %.2fx, "
                    "baseline %s)",
                    f["collective"], f["dtype"], f["size_bucket"],
                    f["axis"], f["ratio"], f["live"], f["baseline"],
                    f["threshold"], f["baseline_source"])
        if fresh:
            # fan the fresh findings out to subscribers.  A subscriber
            # fault must never take the sentinel loop down — the loop is
            # the thing that would report it.
            for fn in list(self._subscribers):
                try:
                    fn(list(fresh))
                except Exception:
                    from ..utils.logging import get_logger

                    get_logger("accl_tpu_torch.sentinel").warning(
                        "sentinel subscriber %r raised; dropping this "
                        "delivery", fn, exc_info=True)
        _health.note_slow(self._registry, bool(self.findings))
        return self.findings

    def subscribe(self, fn) -> None:
        """Register a callback for fresh findings (called from the
        sentinel's check thread with a list of finding dicts);
        idempotent per callable."""
        if fn not in self._subscribers:
            self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        try:
            self._subscribers.remove(fn)
        except ValueError:
            pass

    # -- lifecycle ------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "Sentinel":
        if self._thread is None:
            self.interval_s = max(interval_s, 0.05)
            self._thread = threading.Thread(
                target=self._loop, name="accl-sentinel", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:  # pragma: no cover — never kill the host
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        _health.note_slow(self._registry, False)


# ---------------------------------------------------------------------------
# env-driven singleton (ACCL.initialize arms it next to the exporter)
# ---------------------------------------------------------------------------
_sentinel_lock = threading.Lock()
_sentinel: Optional[Sentinel] = None


def ensure_sentinel_from_env(
        registry: Optional[MetricsRegistry] = None) -> Optional[Sentinel]:
    """Idempotent env-driven start: ``ACCL_SENTINEL`` unset/0 = off
    (zero threads, zero per-call work); ``1`` = baseline from
    ``ACCL_SENTINEL_BASELINE``; anything else = a baseline path.  Never
    raises — a bad baseline must not take driver bring-up down."""
    global _sentinel
    raw = os.environ.get("ACCL_SENTINEL", "").strip()
    if not raw or raw == "0":
        return None
    with _sentinel_lock:
        if _sentinel is not None:
            return _sentinel
        path = os.environ.get("ACCL_SENTINEL_BASELINE", "") \
            if raw == "1" else raw
        try:
            baseline = Baseline.load(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            from ..utils.logging import get_logger

            get_logger().warning(
                "regression sentinel disabled (ACCL_SENTINEL=%s): "
                "cannot load baseline %r: %s", raw, path, e)
            return None
        from ..constants import env_int

        interval = env_int("ACCL_SENTINEL_INTERVAL_MS", 5000, minimum=1)
        _sentinel = Sentinel(baseline, registry).start(interval / 1000.0)
        return _sentinel


def stop_sentinel() -> None:
    global _sentinel
    with _sentinel_lock:
        if _sentinel is not None:
            _sentinel.stop()
            _sentinel = None
