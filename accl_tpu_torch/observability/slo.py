"""Per-tenant SLO tracker: declarative latency/bandwidth/availability
objectives with multi-window error-budget burn-rate alerting.

Port of ``accl_tpu/observability/slo.py``, whole.  The metrics registry
keeps power-of-4 latency histograms per call signature, and per
(tenant, collective, dtype, size_bucket) for calls on a tenant-labelled
communicator.  This module loads declarative SLO specs per (tenant,
collective, size-bucket) from ``ACCL_SLO=path``, keeps sliding-window
estimators over those histograms, and applies the SRE multi-window
burn-rate discipline: a FAST window (small, high threshold) that pages
quickly on a cliff, and a SLOW window (large, low threshold) that
catches sustained slow bleed without flapping, plus a cumulative error
budget whose exhaustion is the strongest verdict.

Windows are counted in ``check()`` sweeps, not wall seconds, so the
tracker is deterministic under explicitly-driven drills, like the
sentinel.  Violation counting is histogram-native: an observation
violates a ceiling when it landed in a bucket whose upper bound exceeds
the ceiling, so ceilings are best placed at (or derived from) bucket
bounds, e.g. from a healthy-phase snapshot via :func:`quantile_us`.

Burn-rate thresholds auto-clamp per objective: a p50 objective's
budget is 0.5, so its burn rate can never exceed 2 — the effective
fast/slow thresholds are ``min(threshold, 0.9/budget)`` and
``min(threshold, 0.5/budget)`` so wide-budget objectives stay
alertable while tight ones (p99) keep the classic SRE semantics.

Findings fan out through the same subscription API as the sentinel
(``subscribe(fn)`` with worsening-gated re-delivery and cleared-key
re-arm), and, when a live sentinel is armed, through that sentinel's
subscribers too, so one control plane sees both drift and SLO signals.

Knobs (clear-error per the constants contract): ``ACCL_SLO`` (spec
path; unset = off, zero threads, zero per-call work),
``ACCL_SLO_INTERVAL_MS`` (default 0 = no timer thread; drills and the
``/slo`` endpoint drive ``check()`` explicitly),
``ACCL_SLO_FAST_WINDOW`` / ``ACCL_SLO_SLOW_WINDOW`` (sweeps, default
4 / 16), ``ACCL_SLO_FAST_BURN`` / ``ACCL_SLO_SLOW_BURN`` (default
8.0 / 2.0), ``ACCL_SLO_MIN_CALLS`` (default 4).
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Optional

from . import health as _health
from .metrics import (
    LATENCY_BUCKETS_US,
    MetricsRegistry,
    busbw_factor,
    default_registry,
)
from .sentinel import quantile_us

#: report document identity — the /slo endpoint serves it and report
#: readers validate against these
SLO_REPORT_FORMAT = "accl-slo-report"
SLO_REPORT_VERSION = 1

#: spec document identity (the ACCL_SLO file)
SLO_SPEC_FORMAT = "accl-slo-spec"
SLO_SPEC_VERSION = 1

#: verdict ladder, weakest to strongest — precedence folds a tenant's
#: objective verdicts to the STRONGEST one (exhausted beats a page
#: beats a slow bleed beats ok)
VERDICT_NAMES = ("ok", "slow_burn", "fast_burn", "exhausted")
V_OK, V_SLOW_BURN, V_FAST_BURN, V_EXHAUSTED = range(4)

#: objective axes a spec can declare
OBJECTIVE_AXES = ("p50_us", "p99_us", "busbw_GBps", "availability")

#: keys every objective row in the report carries (report readers'
#: schema validation pins these)
OBJECTIVE_SCHEMA_KEYS = (
    "tenant", "collective", "size_bucket", "objective", "target",
    "budget", "calls_fast", "bad_fast", "burn_fast", "calls_slow",
    "bad_slow", "burn_slow", "budget_remaining", "verdict",
)


def load_specs(path: str) -> list:
    """Load + validate an ``ACCL_SLO`` spec file; returns normalized
    spec dicts.  Raises ``ValueError`` naming the defect (the caller
    decides whether that is fatal — driver bring-up treats it as
    disable-with-warning, a drill as fatal)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != SLO_SPEC_FORMAT:
        raise ValueError(
            f"{path}: not an {SLO_SPEC_FORMAT} document "
            f"(format={doc.get('format') if isinstance(doc, dict) else None!r})")
    if doc.get("version") != SLO_SPEC_VERSION:
        raise ValueError(
            f"{path}: spec version {doc.get('version')!r} != "
            f"{SLO_SPEC_VERSION}")
    slos = doc.get("slos")
    if not isinstance(slos, list) or not slos:
        raise ValueError(f"{path}: 'slos' must be a non-empty list")
    out = []
    for i, s in enumerate(slos):
        if not isinstance(s, dict) or not s.get("tenant"):
            raise ValueError(f"{path}: slos[{i}] needs a 'tenant'")
        spec = {
            "tenant": str(s["tenant"]),
            "collective": str(s.get("collective", "*")),
            "size_bucket": str(s.get("size_bucket", "*")),
            "availability": float(s.get("availability", 0.99)),
        }
        if not 0.0 < spec["availability"] < 1.0:
            raise ValueError(
                f"{path}: slos[{i}] availability must be in (0, 1)")
        axes = 0
        for axis in ("p50_us", "p99_us", "busbw_GBps"):
            if axis in s:
                v = float(s[axis])
                if v <= 0:
                    raise ValueError(
                        f"{path}: slos[{i}] {axis} must be > 0")
                spec[axis] = v
                axes += 1
        if s.get("track_errors"):
            spec["track_errors"] = True
            axes += 1
        if axes == 0:
            raise ValueError(
                f"{path}: slos[{i}] declares no objective (want one of "
                f"p50_us / p99_us / busbw_GBps ceilings-floors or "
                f"track_errors)")
        out.append(spec)
    return out


def _hist_from_doc(call_doc: dict) -> list:
    hist = [call_doc["hist_us"][f"le_{ub}"] for ub in LATENCY_BUCKETS_US]
    hist.append(call_doc["hist_us"]["inf"])
    return hist


def _bad_above(hist: list, ceiling_us: float) -> int:
    """Observations that violated a latency ceiling: everything in
    buckets whose upper bound exceeds it (histogram-native — an
    observation at exactly a bucket bound counts good)."""
    good = 0
    for ub, n in zip(LATENCY_BUCKETS_US, hist):
        if ub <= ceiling_us:
            good += n
        else:
            break
    return sum(hist) - good


class _WindowState:
    """Per-(tenant, collective, dtype, bucket) sliding window of
    per-sweep deltas against the cumulative registry histograms."""

    __slots__ = ("last_hist", "last_calls", "last_errors", "last_bytes",
                 "last_total_us", "window", "nranks")

    def __init__(self, slow_window: int):
        self.last_hist: Optional[list] = None
        self.last_calls = 0
        self.last_errors = 0
        self.last_bytes = 0
        self.last_total_us = 0.0
        self.nranks = 1
        #: per-sweep delta entries {"hist", "calls", "errors", "bytes",
        #: "total_us"}, newest last
        self.window: "deque" = deque(maxlen=slow_window)

    def advance(self, call_doc: dict) -> None:
        hist = _hist_from_doc(call_doc)
        calls = call_doc["calls"]
        errors = call_doc["errors"]
        nbytes = call_doc["bytes"]
        total_us = call_doc["latency_us"]["total"]
        self.nranks = call_doc.get("nranks", 1)
        if self.last_hist is None:
            delta_hist = list(hist)
            d_calls, d_errors = calls, errors
            d_bytes, d_total = nbytes, total_us
        else:
            delta_hist = [max(a - b, 0)
                          for a, b in zip(hist, self.last_hist)]
            d_calls = max(calls - self.last_calls, 0)
            d_errors = max(errors - self.last_errors, 0)
            d_bytes = max(nbytes - self.last_bytes, 0)
            d_total = max(total_us - self.last_total_us, 0.0)
        self.last_hist = hist
        self.last_calls = calls
        self.last_errors = errors
        self.last_bytes = nbytes
        self.last_total_us = total_us
        self.window.append({"hist": delta_hist, "calls": d_calls,
                            "errors": d_errors, "bytes": d_bytes,
                            "total_us": d_total})

    def idle_sweep(self) -> None:
        """No registry entry changed this sweep — the window still
        advances (an idle tenant's burn decays)."""
        self.window.append({"hist": [0] * (len(LATENCY_BUCKETS_US) + 1),
                            "calls": 0, "errors": 0, "bytes": 0,
                            "total_us": 0.0})

    def fold(self, n: int) -> dict:
        """Sum the newest ``n`` window entries."""
        entries = list(self.window)[-n:]
        hist = [0] * (len(LATENCY_BUCKETS_US) + 1)
        calls = errors = nbytes = 0
        total_us = 0.0
        for e in entries:
            for i, v in enumerate(e["hist"]):
                hist[i] += v
            calls += e["calls"]
            errors += e["errors"]
            nbytes += e["bytes"]
            total_us += e["total_us"]
        return {"hist": hist, "calls": calls, "errors": errors,
                "bytes": nbytes, "total_us": total_us}


class SLOTracker:
    """Evaluates declared SLOs against the live per-tenant histograms;
    one per registry (usually the default)."""

    #: a persisting finding re-delivers to subscribers only when its
    #: burn worsens past this factor — same anti-spam discipline as
    #: Sentinel.WORSEN_RATIO (the control-plane contract)
    WORSEN_RATIO = 1.25

    def __init__(self, specs: list,
                 registry: Optional[MetricsRegistry] = None,
                 fast_window: Optional[int] = None,
                 slow_window: Optional[int] = None,
                 fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None,
                 min_calls: Optional[int] = None,
                 source: str = ""):
        from ..constants import env_float, env_int

        self.specs = list(specs)
        self.source = source
        self._registry = registry if registry is not None \
            else default_registry()
        self.fast_window = fast_window if fast_window is not None \
            else env_int("ACCL_SLO_FAST_WINDOW", 4, minimum=1)
        self.slow_window = slow_window if slow_window is not None \
            else env_int("ACCL_SLO_SLOW_WINDOW", 16, minimum=1)
        if self.slow_window < self.fast_window:
            self.slow_window = self.fast_window
        self.fast_burn = fast_burn if fast_burn is not None \
            else env_float("ACCL_SLO_FAST_BURN", 8.0, minimum=1.0)
        self.slow_burn = slow_burn if slow_burn is not None \
            else env_float("ACCL_SLO_SLOW_BURN", 2.0, minimum=0.0)
        self.min_calls = min_calls if min_calls is not None \
            else env_int("ACCL_SLO_MIN_CALLS", 4, minimum=1)
        #: (tenant, collective, dtype, bucket) -> _WindowState
        self._windows: dict = {}
        #: cumulative (bad, total) per objective key — the error budget
        self._budget: dict = {}
        self.checks = 0
        #: last check's objective rows / findings (doc() + tests)
        self.objectives: list = []
        self.findings: list = []
        self._subscribers: list = []
        #: objective key -> burn at last delivery (re-arm on clear)
        self._delivered: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- subscription fan-out (the sentinel's API shape) ----------------
    def subscribe(self, fn) -> None:
        """Register a callback for fresh findings (list of dicts with
        ``kind="slo"``); idempotent per callable — the same contract as
        :meth:`Sentinel.subscribe`."""
        if fn not in self._subscribers:
            self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        try:
            self._subscribers.remove(fn)
        except ValueError:
            pass

    def _fanout_targets(self) -> list:
        """Own subscribers plus — when a live sentinel is armed — its
        subscribers: one control plane sees drift AND SLO signals."""
        targets = list(self._subscribers)
        from . import sentinel as _sentinel

        live = _sentinel._sentinel
        if live is not None:
            for fn in live._subscribers:
                if fn not in targets:
                    targets.append(fn)
        return targets

    # -- evaluation -----------------------------------------------------
    def _spec_keys(self, spec: dict, tenant_calls: dict) -> list:
        """Window keys a spec matches (collective/size_bucket
        wildcards fold every matching signature of the tenant)."""
        keys = []
        for doc in tenant_calls.values():
            if doc["tenant"] != spec["tenant"]:
                continue
            if spec["collective"] not in ("*", doc["collective"]):
                continue
            if spec["size_bucket"] not in ("*", doc["size_bucket"]):
                continue
            keys.append((doc["tenant"], doc["collective"], doc["dtype"],
                         doc["size_bucket"]))
        return keys

    def _thresholds(self, budget: float) -> tuple:
        """Effective (fast, slow) burn thresholds for one objective —
        clamped so wide-budget objectives (p50: budget 0.5, max burn 2)
        remain alertable."""
        return (min(self.fast_burn, 0.9 / budget),
                min(self.slow_burn, 0.5 / budget))

    def _eval_latency(self, okey: tuple, ceiling: float, budget: float,
                      fast: dict, slow: dict) -> dict:
        bad_fast = _bad_above(fast["hist"], ceiling)
        bad_slow = _bad_above(slow["hist"], ceiling)
        return self._eval_counts(okey, budget, fast["calls"], bad_fast,
                                 slow["calls"], bad_slow)

    def _eval_counts(self, okey: tuple, budget: float, calls_fast: int,
                     bad_fast: int, calls_slow: int,
                     bad_slow: int) -> dict:
        burn_fast = (bad_fast / calls_fast / budget) if calls_fast else 0.0
        burn_slow = (bad_slow / calls_slow / budget) if calls_slow else 0.0
        cum_bad, cum_total = self._budget.get(okey, (0, 0))
        # the newest sweep's contribution to the lifetime budget: the
        # fold windows overlap sweep-to-sweep, so budget accumulation
        # uses only the newest delta (fold(1))
        remaining = 1.0
        if cum_total >= self.min_calls:
            remaining = max(0.0, 1.0 - (cum_bad / cum_total) / budget)
        th_fast, th_slow = self._thresholds(budget)
        if cum_total >= self.min_calls and remaining <= 0.0:
            verdict = V_EXHAUSTED
        elif calls_fast >= self.min_calls and burn_fast >= th_fast:
            verdict = V_FAST_BURN
        elif calls_slow >= self.min_calls and burn_slow >= th_slow:
            verdict = V_SLOW_BURN
        else:
            verdict = V_OK
        return {"budget": round(budget, 6),
                "calls_fast": calls_fast, "bad_fast": bad_fast,
                "burn_fast": round(burn_fast, 3),
                "calls_slow": calls_slow, "bad_slow": bad_slow,
                "burn_slow": round(burn_slow, 3),
                "budget_remaining": round(remaining, 4),
                "verdict": VERDICT_NAMES[verdict]}

    def _accumulate_budget(self, okey: tuple, bad_new: int,
                           total_new: int) -> None:
        cum_bad, cum_total = self._budget.get(okey, (0, 0))
        self._budget[okey] = (cum_bad + bad_new, cum_total + total_new)

    def check(self) -> list:
        """One evaluation sweep: advance every tenant window by the
        registry's deltas, evaluate every spec's objectives, publish
        per-tenant verdict/budget gauges, and fan FRESH findings out to
        subscribers.  Returns the findings list (repeat findings
        included; delivery is what's gated)."""
        self._registry.inc("slo/checks")
        self.checks += 1
        snap = self._registry.snapshot()
        tenant_calls = snap.get("tenant_calls", {})
        seen = set()
        for key_str, doc in tenant_calls.items():
            key = (doc["tenant"], doc["collective"], doc["dtype"],
                   doc["size_bucket"])
            seen.add(key)
            st = self._windows.get(key)
            if st is None:
                st = self._windows[key] = _WindowState(self.slow_window)
            st.advance(doc)
        for key, st in self._windows.items():
            if key not in seen:
                st.idle_sweep()

        objectives: list = []
        findings: list = []
        tenant_verdicts: dict = {}
        tenant_budget: dict = {}
        for spec in self.specs:
            keys = self._spec_keys(spec, tenant_calls)
            states = [self._windows[k] for k in keys
                      if k in self._windows]
            tenant = spec["tenant"]
            tenant_verdicts.setdefault(tenant, V_OK)
            if not states:
                continue
            # fold the spec's matching signatures together: the spec is
            # the unit of objective, not the dtype-level signature
            fast = {"hist": [0] * (len(LATENCY_BUCKETS_US) + 1),
                    "calls": 0, "errors": 0, "bytes": 0, "total_us": 0.0}
            slow = {k: (list(v) if isinstance(v, list) else v)
                    for k, v in fast.items()}
            newest = {k: (list(v) if isinstance(v, list) else v)
                      for k, v in fast.items()}
            nranks = 1
            for st in states:
                nranks = max(nranks, st.nranks)
                for dst, n in ((fast, self.fast_window),
                               (slow, self.slow_window), (newest, 1)):
                    fold = st.fold(n)
                    for i, v in enumerate(fold["hist"]):
                        dst["hist"][i] += v
                    for fld in ("calls", "errors", "bytes", "total_us"):
                        dst[fld] += fold[fld]

            def emit(axis, target, row):
                row.update({
                    "tenant": tenant,
                    "collective": spec["collective"],
                    "size_bucket": spec["size_bucket"],
                    "objective": axis,
                    "target": target,
                    # sliding-window estimates (rendering/debugging)
                    "p50_fast_us": round(quantile_us(fast["hist"], 0.5), 2),
                    "p99_fast_us": round(quantile_us(fast["hist"], 0.99), 2),
                    "kind": "slo",
                })
                objectives.append(row)
                v = VERDICT_NAMES.index(row["verdict"])
                tenant_verdicts[tenant] = max(tenant_verdicts[tenant], v)
                if row.get("budget_remaining") is not None:
                    cur = tenant_budget.get(tenant, 1.0)
                    tenant_budget[tenant] = min(cur,
                                                row["budget_remaining"])
                if v > V_OK:
                    findings.append(dict(row))

            for axis, budget in (("p50_us", 0.5),
                                 ("p99_us", 1.0 - spec["availability"])):
                if axis not in spec:
                    continue
                ceiling = spec[axis]
                okey = (tenant, spec["collective"], spec["size_bucket"],
                        axis)
                new = self._eval_newest_latency(states, ceiling)
                self._accumulate_budget(okey, *new)
                row = self._eval_latency(okey, ceiling, budget, fast,
                                         slow)
                emit(axis, ceiling, row)
            if "busbw_GBps" in spec:
                floor = spec["busbw_GBps"]
                bw_fast = self._window_busbw(spec, fast, nranks)
                bw_slow = self._window_busbw(spec, slow, nranks)
                if bw_fast > 0 and bw_fast < floor / 2:
                    verdict = V_FAST_BURN
                elif bw_fast > 0 and bw_fast < floor:
                    verdict = V_SLOW_BURN
                else:
                    verdict = V_OK
                emit("busbw_GBps", floor, {
                    "budget": None,
                    "calls_fast": fast["calls"],
                    "bad_fast": round(bw_fast, 6),
                    "burn_fast": (round(floor / bw_fast, 3)
                                  if bw_fast > 0 else 0.0),
                    "calls_slow": slow["calls"],
                    "bad_slow": round(bw_slow, 6),
                    "burn_slow": (round(floor / bw_slow, 3)
                                  if bw_slow > 0 else 0.0),
                    "budget_remaining": None,
                    "verdict": VERDICT_NAMES[verdict]})
            if spec.get("track_errors"):
                budget = 1.0 - spec["availability"]
                okey = (tenant, spec["collective"], spec["size_bucket"],
                        "availability")
                new_bad = new_total = 0
                for st in states:
                    f1 = st.fold(1)
                    new_bad += f1["errors"]
                    new_total += f1["calls"]
                self._accumulate_budget(okey, new_bad, new_total)
                row = self._eval_counts(okey, budget, fast["calls"],
                                        fast["errors"], slow["calls"],
                                        slow["errors"])
                emit("availability", spec["availability"], row)

        self.objectives = objectives
        self.findings = findings

        # per-tenant verdict surfaces: the labeled accl_health samples
        # (tenant/<t>/health gauges) + budget gauges
        for tenant, v in tenant_verdicts.items():
            self._registry.set_gauge(f"tenant/{tenant}/health", v)
            self._registry.set_gauge(
                f"tenant/{tenant}/slo_budget_remaining",
                round(tenant_budget.get(tenant, 1.0), 4))
        _health.note_slow(self._registry, bool(findings))

        # fresh-delivery gating + cleared-key re-arm (sentinel shape)
        def _fkey(f):
            return (f["tenant"], f["collective"], f["size_bucket"],
                    f["objective"])

        def _severity(f):
            base = VERDICT_NAMES.index(f["verdict"]) * 1000.0
            return base + max(f.get("burn_fast") or 0.0,
                              f.get("burn_slow") or 0.0)

        live_keys = set()
        fresh = []
        for f in findings:
            live_keys.add(_fkey(f))
            last = self._delivered.get(_fkey(f))
            sev = _severity(f)
            if last is None or sev > last * self.WORSEN_RATIO:
                fresh.append(f)
                self._delivered[_fkey(f)] = sev
        for k in list(self._delivered):
            if k not in live_keys:
                del self._delivered[k]
        if fresh:
            self._registry.inc("slo/findings", len(fresh))
            from ..utils.logging import get_logger

            log = get_logger("accl_tpu_torch.slo")
            for f in fresh:
                log.warning(
                    "SLO %s: tenant=%s %s %s %s burn_fast=%.2f "
                    "burn_slow=%.2f budget_remaining=%s",
                    f["verdict"], f["tenant"], f["collective"],
                    f["size_bucket"], f["objective"], f["burn_fast"],
                    f["burn_slow"], f["budget_remaining"])
            for fn in self._fanout_targets():
                try:
                    fn(list(fresh))
                except Exception:
                    from ..utils.logging import get_logger

                    get_logger("accl_tpu_torch.slo").warning(
                        "SLO subscriber %r raised; dropping this "
                        "delivery", fn, exc_info=True)
        return findings

    def _eval_newest_latency(self, states: list,
                             ceiling: float) -> tuple:
        """(bad, total) of ONLY the newest sweep across a spec's
        matching windows — the budget accumulator's increment (the
        fast/slow folds overlap between sweeps and would double-count).
        """
        bad = total = 0
        for st in states:
            f1 = st.fold(1)
            bad += _bad_above(f1["hist"], ceiling)
            total += f1["calls"]
        return bad, total

    @staticmethod
    def _window_busbw(spec: dict, fold: dict, nranks: int) -> float:
        """Windowed bus bandwidth (GB/s) from a fold's byte and
        latency-sum deltas (bytes / ns, nccl-tests correction)."""
        if fold["total_us"] <= 0 or fold["bytes"] <= 0:
            return 0.0
        algbw = fold["bytes"] / (fold["total_us"] * 1e3)
        coll = spec["collective"]
        return algbw * (busbw_factor(coll, nranks)
                        if coll != "*" else 1.0)

    # -- report ---------------------------------------------------------
    def doc(self) -> dict:
        """The versioned SLO report: per-tenant verdicts + budget
        remaining + every objective row from the last check — what the
        exporter's ``/slo`` endpoint serves."""
        tenants: dict = {}
        for row in self.objectives:
            t = tenants.setdefault(row["tenant"], {
                "verdict": "ok", "budget_remaining": 1.0,
                "objectives": []})
            t["objectives"].append(
                {k: row.get(k) for k in OBJECTIVE_SCHEMA_KEYS
                 if k in row or k in ("budget", "budget_remaining")}
                | {"p50_fast_us": row.get("p50_fast_us"),
                   "p99_fast_us": row.get("p99_fast_us")})
            if VERDICT_NAMES.index(row["verdict"]) > \
                    VERDICT_NAMES.index(t["verdict"]):
                t["verdict"] = row["verdict"]
            if row.get("budget_remaining") is not None:
                t["budget_remaining"] = min(t["budget_remaining"],
                                            row["budget_remaining"])
        for spec in self.specs:
            tenants.setdefault(spec["tenant"], {
                "verdict": "ok", "budget_remaining": 1.0,
                "objectives": []})
        return {
            "format": SLO_REPORT_FORMAT,
            "version": SLO_REPORT_VERSION,
            "source": self.source,
            "checks": self.checks,
            "fast_window": self.fast_window,
            "slow_window": self.slow_window,
            "fast_burn": self.fast_burn,
            "slow_burn": self.slow_burn,
            "specs": [dict(s) for s in self.specs],
            "tenants": tenants,
            "findings_total": len(self.findings),
        }

    # -- lifecycle ------------------------------------------------------
    def start(self, interval_s: float) -> "SLOTracker":
        if self._thread is None and interval_s > 0:
            self.interval_s = max(interval_s, 0.05)
            self._thread = threading.Thread(
                target=self._loop, name="accl-slo", daemon=True)
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


# ---------------------------------------------------------------------------
# env-driven singleton (ACCL.initialize arms it next to the sentinel)
# ---------------------------------------------------------------------------
_slo_lock = threading.Lock()
_tracker: Optional[SLOTracker] = None


def tracker() -> Optional[SLOTracker]:
    """The live env-armed tracker, if any (the /slo endpoint's
    source)."""
    return _tracker


def ensure_slo_from_env(
        registry: Optional[MetricsRegistry] = None) -> Optional[SLOTracker]:
    """Idempotent env-driven start: ``ACCL_SLO`` unset/0 = off (zero
    threads, zero per-call work); otherwise a spec path.  Never raises
    — a bad spec must not take driver bring-up down (a drill validates
    specs fatally via :func:`load_specs` itself)."""
    global _tracker
    raw = os.environ.get("ACCL_SLO", "").strip()
    if not raw or raw == "0":
        return None
    with _slo_lock:
        if _tracker is not None:
            return _tracker
        try:
            specs = load_specs(raw)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            from ..utils.logging import get_logger

            get_logger().warning(
                "SLO tracker disabled (ACCL_SLO=%s): %s", raw, e)
            return None
        from ..constants import env_int

        interval = env_int("ACCL_SLO_INTERVAL_MS", 0, minimum=0)
        _tracker = SLOTracker(specs, registry, source=raw)
        if interval > 0:
            _tracker.start(interval / 1000.0)
        return _tracker


def stop_slo() -> None:
    global _tracker
    with _slo_lock:
        if _tracker is not None:
            _tracker.stop()
            _tracker = None
