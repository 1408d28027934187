"""Health surface: hang/desync watchdog + OpenMetrics exporter.

Two always-available production facilities on top of the flight
recorder (flight.py) and the metrics registry (metrics.py):

- :class:`Watchdog` — a daemon thread per engine/world that scans the
  per-rank flight recorders for gang collectives stuck in assembly or
  execution past ``ACCL_WATCHDOG_TIMEOUT`` seconds.  On fire it
  reports *which ranks arrived and which are missing*, each rank's
  last-completed seq and the head-of-queue call every absent rank is
  actually blocked on, writes the merged flight dump to
  ``ACCL_WATCHDOG_DUMP``, flips the ``accl_health`` gauge to ``hung``,
  and bumps the ``watchdog/fires`` counter.  The gang engine
  additionally feeds its live gang-assembly table through the
  ``introspect`` hook (CudaEngine.gang_assembly_snapshot), so the
  report shows the exact partial gangs inside the scheduler.

- :func:`start_exporter` — an OpenMetrics endpoint on
  ``ACCL_METRICS_PORT`` (stdlib ``http.server`` thread): ``/metrics``
  serves :meth:`MetricsRegistry.to_openmetrics`, ``/healthz`` a JSON
  health summary, ``/flight`` the merged flight dump — the scrape
  surface a production serving fleet points Prometheus at,
  ``/retunes`` the online tuner's retune history
  (``tuning/online.py`` ``history_doc``: an empty versioned document
  when no tuner ran), and ``/slo`` the per-tenant SLO report (slo.py).

Port of ``accl_tpu/observability/health.py``.

Health states (the ``accl_health`` gauge):
``0`` ok · ``1`` degraded (a collective returned a non-zero retcode in
the last minute) · ``2`` hung (watchdog found a stuck gang) · ``3``
aborted (a communicator abort finalized calls in the last minute — a
recovery action in progress, NOT a phantom hang: abort-finalized
flight records are terminal and never re-trigger the stuck-gang scan).

``ACCL_WATCHDOG_ACTION`` selects what a watchdog fire DOES: ``dump``
(default — diagnose only, the pre-r10 behavior) or ``abort`` — the
watchdog additionally aborts the hung communicator through the
backend's abort hook, turning a detected hang into fast COMM_ABORTED/
RANK_FAILED failures every waiter can recover from (shrink + re-run).
"""
from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Callable, Iterable, Optional

from . import flight as _flight
from .metrics import MetricsRegistry, default_registry
from .trace import now_ns

HEALTH_OK = 0
HEALTH_DEGRADED = 1
HEALTH_HUNG = 2
HEALTH_ABORTED = 3
#: a recovery supervisor is mid-episode (detect -> abort -> probe ->
#: shrink/grow -> agree -> resume); distinct from ``aborted`` because a
#: supervised world is actively healing, not merely revoked
HEALTH_RECOVERING = 4
#: the regression sentinel (observability/sentinel.py) found live
#: latency/bandwidth drifted past its thresholds vs the committed
#: baseline — the world is CORRECT but slow.  Reported only while every
#: stronger verdict (degraded/hung/aborted/recovering) is clear: a
#: numerically-higher code must not let "slow" mask a real failure, so
#: the aggregation special-cases it rather than relying on max().
HEALTH_SLOW = 5
HEALTH_NAMES = ("ok", "degraded", "hung", "aborted", "recovering",
                "slow")

#: window after a non-zero retcode during which health reads degraded
DEGRADED_WINDOW_NS = 60 * 10 ** 9


def watchdog_timeout_s() -> float:
    """Stuck-gang threshold in seconds; ``ACCL_WATCHDOG_TIMEOUT=0``
    disables the watchdog entirely.  Malformed values raise the naming
    ACCLError (constants.env_float) — a watchdog silently falling back
    to 300 s because of a typo is a watchdog that fires 5 minutes after
    the operator expected it."""
    from ..constants import env_float

    return env_float("ACCL_WATCHDOG_TIMEOUT", 300.0, minimum=0.0)


#: live watchdogs, for health aggregation: the accl_health gauge on a
#: registry is the MAX verdict over every live watchdog publishing into
#: it — one hung world must not be overwritten by a healthy sibling's
#: sweep, and a freshly-constructed watchdog must not clear a live hang
_watchdogs_lock = threading.Lock()
_watchdogs: "weakref.WeakSet" = weakref.WeakSet()
#: registries with at least one recovery supervisor mid-episode
#: (resilience/supervisor.py note_recovering): id(registry) -> count.
#: A supervised recovery outranks every watchdog verdict — the world
#: is actively healing, and a scrape must say so even while a sibling
#: watchdog still reads the pre-recovery hang.
_recovering: dict = {}
#: registries whose regression sentinel currently holds drift findings
#: (sentinel.py note_slow): id(registry) -> True.  Weakest verdict —
#: surfaces only while everything stronger is clear.
_slow: dict = {}


def note_recovering(registry: MetricsRegistry, active: bool) -> None:
    """Mark (or clear) an active recovery episode on a registry; the
    ``accl_health`` gauge reads ``recovering`` (4) while any episode is
    live, then falls back to the watchdog aggregation."""
    key = id(registry)
    with _watchdogs_lock:
        n = _recovering.get(key, 0) + (1 if active else -1)
        if n > 0:
            _recovering[key] = n
        else:
            _recovering.pop(key, None)
    _publish_health(registry)


def note_slow(registry: MetricsRegistry, active: bool) -> None:
    """Mark (or clear) a live perf-drift verdict on a registry (the
    regression sentinel's hook): ``accl_health`` reads ``slow`` (5)
    while active AND no stronger verdict (degraded/hung/aborted/
    recovering) is in effect — slow must never mask a real failure."""
    key = id(registry)
    with _watchdogs_lock:
        if active:
            _slow[key] = True
        else:
            _slow.pop(key, None)
    _publish_health(registry)


def _publish_health(registry: MetricsRegistry) -> None:
    with _watchdogs_lock:
        verdict = max((w._health for w in _watchdogs
                       if w._registry is registry), default=HEALTH_OK)
        if _recovering.get(id(registry), 0) > 0:
            verdict = HEALTH_RECOVERING
        elif verdict == HEALTH_OK and _slow.get(id(registry)):
            verdict = HEALTH_SLOW
    registry.set_gauge("accl_health", verdict)


class Watchdog:
    """Stuck-gang detector over a set of per-rank flight recorders."""

    def __init__(self, recorders: Iterable, timeout_s: Optional[float] = None,
                 introspect: Optional[Callable[[], list]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 on_fire: Optional[Callable[[dict], None]] = None,
                 dump_path: Optional[str] = None, name: str = "accl",
                 abort_hook: Optional[Callable[[int, dict], None]] = None,
                 action: Optional[str] = None):
        self._recorders = list(recorders)
        self.timeout_s = (watchdog_timeout_s() if timeout_s is None
                          else timeout_s)
        self._introspect = introspect
        #: fire action: "dump" (diagnose only) or "abort" (additionally
        #: abort each hung comm via abort_hook(comm_id, report))
        self.action = (action if action is not None else
                       os.environ.get("ACCL_WATCHDOG_ACTION", "dump"))
        self._abort_hook = abort_hook
        self._registry = registry if registry is not None \
            else default_registry()
        self._on_fire = on_fire
        self._dump_path = dump_path if dump_path is not None else \
            os.environ.get("ACCL_WATCHDOG_DUMP", "accl_watchdog_dump.json")
        self._name = name
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None
        #: most recent fire report (tests and doctor read this)
        self.last_report: Optional[dict] = None
        #: this watchdog's own verdict; the registry gauge aggregates
        #: (max) over every live watchdog on the same registry
        self._health = HEALTH_OK
        with _watchdogs_lock:
            _watchdogs.add(self)
        _publish_health(self._registry)

    # -- lifecycle ------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0 and bool(self._recorders) \
            and _flight.enabled()

    def start(self) -> "Watchdog":
        if self.enabled and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"{self._name}-watchdog",
                daemon=True)
            self._thread.start()
        return self

    def add_recorder(self, recorder) -> None:
        """Fold a late-joining rank's flight recorder into the scan
        (elastic membership: a replacement spawned mid-run must be
        watched too).  Append is safe against a concurrent sweep —
        CPython list iteration simply starts seeing the new tail."""
        self._recorders.append(recorder)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        with _watchdogs_lock:
            _watchdogs.discard(self)
        _publish_health(self._registry)

    # -- scan loop ------------------------------------------------------
    def _loop(self) -> None:
        interval = min(max(self.timeout_s / 4.0, 0.05), 2.0)
        while not self._stop.wait(interval):
            try:
                self.check()
            except Exception as e:  # pragma: no cover — diagnostics
                # must never take the workload down, but a silently
                # dying scan would be a watchdog that cannot bark
                try:
                    from ..utils.logging import get_logger

                    get_logger("accl_tpu_torch.watchdog").warning(
                        "watchdog scan failed: %s: %s",
                        type(e).__name__, e)
                except Exception:
                    pass

    def check(self) -> Optional[dict]:
        """One scan; returns the fire report when a hang was detected."""
        self._registry.inc("watchdog/checks")
        now = now_ns()
        budget_ns = self.timeout_s * 1e9
        stuck = [rec for r in self._recorders for rec in r.in_flight()
                 if rec.gang and (now - rec.t_submit) > budget_ns]
        if stuck:
            self._health = HEALTH_HUNG
            _publish_health(self._registry)
            if not self._fired:
                self._fired = True
                return self._fire(stuck)
            return None
        self._fired = False
        aborted = any(r.last_abort_ns
                      and now - r.last_abort_ns < DEGRADED_WINDOW_NS
                      for r in self._recorders)
        degraded = any(r.last_error_ns
                       and now - r.last_error_ns < DEGRADED_WINDOW_NS
                       for r in self._recorders)
        self._health = (HEALTH_ABORTED if aborted
                        else HEALTH_DEGRADED if degraded else HEALTH_OK)
        _publish_health(self._registry)
        return None

    def _fire(self, stuck: list) -> dict:
        self._registry.inc("watchdog/fires")
        report = _flight.merge_flight_dumps(
            [r.dump() for r in self._recorders])
        report["watchdog"] = {
            "timeout_s": self.timeout_s,
            "stuck_records": [rec.to_dict() for rec in stuck],
        }
        if self._introspect is not None:
            try:
                report["watchdog"]["engine_gangs"] = self._introspect()
            except Exception:
                report["watchdog"]["engine_gangs"] = None
        if self._dump_path:
            try:
                with open(self._dump_path, "w") as f:
                    json.dump(report, f, indent=1)
            except OSError:
                pass
        # publish AFTER the dump write: last_report is the "fire
        # happened" signal pollers key on, and a poller that saw it must
        # find the dump file already on disk (the pre-r14 order lost
        # that race on a loaded box)
        self.last_report = report
        self._log(report)
        # ACCL_WATCHDOG_ACTION=abort: turn the diagnosis into recovery —
        # abort every hung communicator so stuck waiters fail fast with
        # COMM_ABORTED|RANK_FAILED instead of hanging forever.  Runs
        # AFTER the dump: the black box records the pre-abort truth.
        if self.action == "abort" and self._abort_hook is not None:
            aborted_comms = set()
            for hang in report["analysis"]["hangs"]:
                comm = hang["comm"]
                if comm in aborted_comms:
                    continue
                aborted_comms.add(comm)
                try:
                    self._abort_hook(comm, report)
                except Exception:  # the recovery path must not kill
                    pass           # the watchdog thread
        if self._on_fire is not None:
            try:
                self._on_fire(report)
            except Exception:
                pass
        return report

    def _log(self, report: dict) -> None:
        from ..utils.logging import get_logger

        log = get_logger("accl_tpu_torch.watchdog")
        for hang in report["analysis"]["hangs"]:
            log.error(
                "watchdog: %s (comm %d, count %d, %s) stuck %.1fs — "
                "arrived ranks %s, MISSING ranks %s; missing blocked on "
                "%s; last completed seq per rank %s; dump: %s",
                hang["collective"], hang["comm"], hang["count"],
                hang["dtype"], hang["oldest_age_us"] / 1e6,
                hang["arrived"], hang["missing"],
                {r: (rec["collective"] if rec else "idle")
                 for r, rec in hang["missing_blocked_on"].items()},
                hang["last_completed_seq"], self._dump_path or "<none>")
        for d in report["analysis"]["desyncs"]:
            log.error("watchdog: collective-order DESYNC on comm %d at "
                      "gang index %d: %s", d["comm"], d["index"],
                      d["per_rank"])


# ---------------------------------------------------------------------------
# OpenMetrics / health HTTP endpoint (stdlib http.server thread)
# ---------------------------------------------------------------------------
_exporter_lock = threading.Lock()
_exporter: Optional["MetricsExporter"] = None

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


class MetricsExporter:
    """Serves /metrics (OpenMetrics), /healthz (JSON), /flight (merged
    flight dump), /retunes (online-tuner history) and /slo (per-tenant
    SLO report) from a daemon thread."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry if registry is not None else default_registry()
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler API
                try:
                    if self.path.startswith("/metrics"):
                        body = reg.to_openmetrics().encode()
                        ctype = OPENMETRICS_CONTENT_TYPE
                    elif self.path.startswith("/healthz"):
                        body = json.dumps(exporter.health()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/flight"):
                        body = json.dumps(_flight.dump_all()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/retunes"):
                        # the online tuner's bounded retune-history
                        # ring (empty doc when no tuner ran)
                        from ..tuning import online as _online

                        body = json.dumps(
                            _online.history_doc()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/slo"):
                        # the live per-tenant SLO report.  A scrape IS
                        # an evaluation sweep (check() then doc()), so a
                        # pull-only deployment — no ACCL_SLO_INTERVAL_MS
                        # thread — still gets fresh verdicts at its
                        # scrape cadence.  Empty versioned doc when no
                        # tracker is armed.
                        from . import slo as _slo

                        tr = _slo.tracker()
                        if tr is not None:
                            tr.check()
                            doc = tr.doc()
                        else:
                            doc = {"format": _slo.SLO_REPORT_FORMAT,
                                   "version": _slo.SLO_REPORT_VERSION,
                                   "checks": 0, "specs": [],
                                   "tenants": {}, "findings_total": 0}
                        body = json.dumps(doc).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # surface, don't kill the thread
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._registry = reg
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="accl-metrics-http",
            daemon=True)
        self._thread.start()

    def health(self) -> dict:
        snap = self._registry.snapshot()
        code = int(snap["gauges"].get("accl_health", HEALTH_OK))
        code = min(max(code, 0), len(HEALTH_NAMES) - 1)
        return {
            "health": HEALTH_NAMES[code],
            "accl_health": code,
            "watchdog_fires": snap["counters"].get("watchdog/fires", 0),
            "watchdog_checks": snap["counters"].get("watchdog/checks", 0),
        }

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


def start_exporter(port: Optional[int] = None,
                   registry: Optional[MetricsRegistry] = None,
                   ) -> Optional[MetricsExporter]:
    """Start (or return) the process-wide exporter.  With no explicit
    `port`, reads ``ACCL_METRICS_PORT``: unset/empty = no exporter;
    ``0`` = bind an EPHEMERAL port (parallel CI jobs sharing one env
    cannot collide — the r14 satellite; the chosen port is logged by
    the structured logger and readable via :func:`exporter_port`);
    anything else = that fixed port."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        if port is None:
            raw = os.environ.get("ACCL_METRICS_PORT", "")
            if not raw:
                return None
            from ..constants import env_int

            port = env_int("ACCL_METRICS_PORT", 0, minimum=0)
        _exporter = MetricsExporter(port, registry)
        from ..utils.logging import get_logger

        get_logger().info("OpenMetrics endpoint on http://%s:%d/metrics",
                          _exporter.host, _exporter.port)
        return _exporter


def exporter_port() -> Optional[int]:
    """The live exporter's bound port (the ephemeral-port discovery
    surface for ``ACCL_METRICS_PORT=0``), or None when no exporter is
    running in this process."""
    with _exporter_lock:
        return _exporter.port if _exporter is not None else None


def stop_exporter() -> None:
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.close()
            _exporter = None


def ensure_exporter_from_env() -> Optional[MetricsExporter]:
    """Idempotent env-driven start; called from ACCL.initialize and the
    engine bring-up paths so any entrypoint honors ACCL_METRICS_PORT.
    Never raises: a port collision (two local ranks sharing one
    ACCL_METRICS_PORT — only the first can bind) must not take driver
    bring-up down with it."""
    try:
        return start_exporter()
    except OSError as e:
        from ..utils.logging import get_logger

        get_logger().warning(
            "OpenMetrics endpoint disabled (ACCL_METRICS_PORT=%s): %s",
            os.environ.get("ACCL_METRICS_PORT", ""), e)
        return None
