"""Online tuner: the live telemetry -> tuner control plane.

Port of ``accl_tpu/tuning/online.py``.  :class:`OnlineTuner` subscribes
to a live :class:`~accl_tpu_torch.observability.sentinel.Sentinel` and to
the world's link matrix, and turns each signal into a TARGETED
hypothesis:

- a sentinel finding on one ``(collective, dtype, size_bucket)`` cell
  re-measures exactly that cell — a quick covering-lane shortlist
  (:func:`~accl_tpu_torch.tuning.autotune.cell_candidates`), then the
  interleaved best-of A/B (:func:`~accl_tpu_torch.tuning.autotune.ab_cell`)
  challenger-vs-incumbent in the live session;
- a periodic ``Fabric.from_link_matrix`` re-score whose healthiest-first
  ``axis_order`` changed re-demotes the composer's within axis.

Never a full sweep, and never-slower by construction: a challenger is
installed only when it beats the incumbent by the hysteresis margin in
the interleaved A/B.  A cooldown per cell keeps a noisy host from
thrashing, and a post-install watch auto-REVERTS any selection the
sentinel flags as a regression afterward.

Every install is fenced like abort: a
:data:`~accl_tpu_torch.observability.flight.RETUNE_EVENT` flight anchor,
``ACCL._invalidate_plans(None, ...)`` on every rank (a captured plan
never replays a stale algorithm choice — stale replay raises,
re-capture succeeds), and the backend tuning registers re-derived
through :meth:`SelectionPolicy.hot_swap`.

Observability: ``tuning/retunes/{proposed,verified,installed,rejected,
reverted}`` counters, and a bounded retune-history ring — every
episode's finding -> hypothesis -> A/B -> decision chain — served at the
metrics exporter's ``/retunes`` endpoint and rendered by
``python -m accl_tpu_torch.scripts.perf_doctor``.

Arming: ``ACCL_TUNE_ONLINE=1`` at world bring-up (``EmuWorld``,
``CudaWorld``) starts the loop; unset (the default) constructs NOTHING —
dispatch is bit-identical to the static/table behavior.  Knobs:

================================  =======================================
``ACCL_TUNE_ONLINE``              1 arms the loop (default off)
``ACCL_TUNE_ONLINE_INTERVAL_MS``  loop period (default 5000)
``ACCL_TUNE_ONLINE_COOLDOWN``     per-cell episode cooldown s (def. 30)
``ACCL_TUNE_ONLINE_HYSTERESIS``   install margin ratio (default 1.05)
``ACCL_TUNE_ONLINE_REPS``         A/B repetitions per lane (default 3)
``ACCL_TUNE_ONLINE_HISTORY``      history-ring episodes kept (def. 64)
================================  =======================================

Measurement runs through the world's gang surface, so ``step()`` (and
the background loop) assumes collective QUIESCENCE — the same contract
as running :func:`~accl_tpu_torch.tuning.autotune.tune` against a live
world.  On a ``CudaWorld`` the A/B times host-staged calls
(``bench/sweep.py`` ``_run_once``): each rep moves its operands and
results through host memory, as the offline tuner's cells do.  The drill
harnesses (tests, ``accl_tpu_torch.scripts.retune_smoke``) pause traffic
around each step and drive it themselves.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Optional

from ..constants import ACCLError, env_float, env_int
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..utils.logging import get_logger
from .autotune import (
    SelectionPolicy,
    SelectionTable,
    ab_cell,
    backend_of,
    bucket_bytes,
    cell_candidates,
    cell_key,
)
from .compose import HierarchicalComm
from .topology import Fabric

ENV_ONLINE = "ACCL_TUNE_ONLINE"
ENV_INTERVAL_MS = "ACCL_TUNE_ONLINE_INTERVAL_MS"
ENV_COOLDOWN_S = "ACCL_TUNE_ONLINE_COOLDOWN"
ENV_HYSTERESIS = "ACCL_TUNE_ONLINE_HYSTERESIS"
ENV_REPS = "ACCL_TUNE_ONLINE_REPS"
ENV_HISTORY = "ACCL_TUNE_ONLINE_HISTORY"

HISTORY_FORMAT = "accl-retune-history"
HISTORY_VERSION = 1

#: every decision an episode can end with (the history/doctor schema)
DECISIONS = ("installed", "rejected", "reverted", "cooldown", "error")


def online_enabled() -> bool:
    """One env read: is the online loop armed?  Unset/0/empty = off —
    the caller constructs nothing and dispatch stays bit-identical."""
    return os.environ.get(ENV_ONLINE, "").strip() not in ("", "0")


class RetuneHistory:
    """Bounded ring of retune episodes — the audit trail the exporter
    serves at ``/retunes`` and perf_doctor renders.  Thread-safe; the
    sentinel thread appends triggers while the loop thread closes
    episodes."""

    def __init__(self, maxlen: int = 64):
        self._ring: deque = deque(maxlen=max(int(maxlen), 1))
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0

    def append(self, episode: dict) -> dict:
        with self._lock:
            self._seq += 1
            episode = dict(episode, seq=self._seq)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(episode)
            return episode

    def episodes(self) -> list:
        with self._lock:
            return [dict(e) for e in self._ring]

    def to_doc(self) -> dict:
        with self._lock:
            return {
                "format": HISTORY_FORMAT,
                "version": HISTORY_VERSION,
                "episodes": [dict(e) for e in self._ring],
                "dropped": self.dropped,
                "total": self._seq,
            }


class OnlineTuner:
    """The control plane for one world: findings in, verified
    selections out, every step audited."""

    def __init__(self, world, *,
                 hysteresis: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 repetitions: Optional[int] = None,
                 retries: int = 2,
                 history: Optional[int] = None,
                 registry=None):
        self.world = world
        self._registry = registry if registry is not None \
            else _metrics.default_registry()
        self.hysteresis = hysteresis if hysteresis is not None \
            else env_float(ENV_HYSTERESIS, 1.05, minimum=1.0)
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else env_float(ENV_COOLDOWN_S, 30.0, minimum=0.0)
        self.repetitions = repetitions if repetitions is not None \
            else env_int(ENV_REPS, 3, minimum=1)
        self.retries = retries
        self.history = RetuneHistory(
            history if history is not None
            else env_int(ENV_HISTORY, 64, minimum=1))
        self._log = get_logger("accl_tpu_torch.tuning.online")
        self._queue: deque = deque()  # pending finding dicts
        self._queue_lock = threading.Lock()
        self._cooldown: dict = {}  # cell key -> monotonic deadline
        #: installed-cell watch list: key -> {"prev": entry|None,
        #: "installed_at": monotonic, "episode_seq": int}
        self._watch: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._measure_lock = threading.Lock()
        self._sentinel: Any = None
        # one policy per driver, all serving ONE shared table — the
        # armed ACCL_TUNE_TABLE policy when present (adopting its
        # entries as the incumbents), a fresh empty table otherwise
        armed = getattr(world.accls[0], "_tune_policy", None)
        self.table: SelectionTable = armed.table if armed is not None \
            else SelectionTable({}, {
                "nranks": world.nranks,
                "backend": backend_of(world),
                "dtype": "float32",
            })
        for a in world.accls:
            pol = getattr(a, "_tune_policy", None)
            if pol is None:
                a._tune_policy = SelectionPolicy(self.table)
            elif pol.table is not self.table:
                pol.table = self.table
                pol._memo.clear()
        # the fabric the composer serves (axis re-demotion target):
        # the table's tuned-on shape when it carries one, else the
        # same env resolution offline tune() uses (ACCL_FABRIC
        # included — Fabric() alone would silently factorize).  The
        # JAX tuner probes the TPU's device coordinates here; the
        # port's Fabric.for_world has no probe step (the ranks of a
        # CudaWorld are regions of one card), so the chain is shape >
        # ACCL_FABRIC > near-square default
        meta = self.table.world or {}
        fabric: Optional[Fabric] = None
        if meta.get("shape"):
            try:
                fabric = Fabric(
                    world.nranks, shape=meta.get("shape"),
                    axis_order=tuple(meta["axis_order"])
                    if meta.get("axis_order") else None)
            except (ACCLError, KeyError):
                fabric = None
        if fabric is None:
            fabric = Fabric.for_world(world.nranks)
        self.fabric: Fabric = fabric

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def attach_sentinel(self, sentinel) -> None:
        """Subscribe to a live sentinel's fresh findings (the check
        thread enqueues; the loop thread measures)."""
        if sentinel is not None:
            sentinel.subscribe(self.on_findings)
            self._sentinel = sentinel

    def on_findings(self, findings: list) -> None:
        """Sentinel subscriber: each fresh finding becomes one pending
        cell hypothesis — or, for a cell installed recently, a revert
        verdict (the selection made things worse: roll it back).
        Findings are stamped on arrival so a finding GENERATED before
        an install can never be mistaken for the install's fallout."""
        now = time.monotonic()
        with self._queue_lock:
            for f in findings:
                self._queue.append(dict(f, _queued_at=now))

    def pending(self) -> int:
        with self._queue_lock:
            return len(self._queue)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "OnlineTuner":
        if self._thread is None:
            self.interval_s = max(interval_s, 0.05)
            self._thread = threading.Thread(
                target=self._loop, name="accl-online-tuner", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # pragma: no cover — never kill the host
                self._log.warning("online tuner step failed",
                                  exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        if self._sentinel is not None:
            self._sentinel.unsubscribe(self.on_findings)
            self._sentinel = None

    def step(self) -> Optional[dict]:
        """One control-plane turn: drain at most one pending finding
        into a retune episode, then re-score the fabric.  Returns the
        episode dict it closed (None when idle).  Tests drive this
        directly; the background loop calls it on the interval."""
        finding = None
        with self._queue_lock:
            if self._queue:
                finding = self._queue.popleft()
        if finding is not None:
            return self._handle_finding(finding)
        return self.rescore_fabric()

    # ------------------------------------------------------------------
    # cell hypotheses
    # ------------------------------------------------------------------
    def _cell_of(self, finding: dict) -> Optional[tuple]:
        """(key, coll, dtype, count) of the table cell a finding names;
        None when the bucket cannot be inverted to a payload."""
        coll = finding.get("collective")
        dtype = finding.get("dtype", "float32")
        bucket = finding.get("size_bucket", "")
        nb = bucket_bytes(bucket)
        if not coll or nb <= 0:
            return None
        from ..bench import sweep as _sweep

        np_dtype = _sweep._resolve_dtype(dtype)
        P = self.world.nranks
        count = nb // (_sweep._payload_factor(coll, P) * np_dtype.itemsize)
        if count < 1:
            return None
        key = cell_key(coll, dtype, bucket, P)
        return key, coll, dtype, int(count)

    def _handle_finding(self, finding: dict) -> dict:
        """finding -> hypothesis -> A/B -> install/reject (or revert,
        when the finding regresses a cell this tuner just installed)."""
        base = {
            "kind": "cell",
            "trigger": {"type": "sentinel", **{
                k: finding.get(k) for k in (
                    "collective", "dtype", "size_bucket", "axis",
                    "ratio", "kind", "live", "baseline")}},
            "opened_at": time.time(),
        }
        cell = self._cell_of(finding)
        if cell is None:
            return self._close(base, "error",
                               reason="finding names no measurable cell")
        key, coll, dtype, count = cell
        base["cell"] = key
        watch = self._watch.get(key)
        if watch is not None:
            if finding.get("_queued_at", 0.0) <= watch["installed_at"]:
                # same-batch sibling of the finding that TRIGGERED the
                # install (e.g. the p50 and busbw axes of one drifted
                # cell arrive together): it predates the install, so
                # it cannot be the install's fallout — drop it
                self._registry.inc("tuning/retunes/rejected")
                return self._close(
                    base, "rejected",
                    reason="stale finding from before the install")
            # post-install regression on a cell we changed: the
            # cross-check the doctor renders — auto-revert, no A/B
            return self._revert(base, key, watch)
        now = time.monotonic()
        if self._cooldown.get(key, 0.0) > now:
            self._registry.inc("tuning/retunes/rejected")
            return self._close(base, "cooldown",
                               reason="cell inside cooldown window")
        self._registry.inc("tuning/retunes/proposed")
        self._cooldown[key] = now + self.cooldown_s
        incumbent_entry = self.table.entries.get(key)
        incumbent = incumbent_entry["algorithm"] if incumbent_entry \
            else "static"
        try:
            with self._measure_lock, self._suspended():
                hier = self._hier_for_measure()
                cands = cell_candidates(
                    self.world, coll, count, dtype,
                    repetitions=min(self.repetitions, 2),
                    hier=hier, exclude=(incumbent,))
                challenger = cands[0][0] if cands else None
                base["hypothesis"] = {
                    "incumbent": incumbent,
                    "challenger": challenger,
                    "shortlist": [
                        {"algorithm": a, "busbw_GBps": b}
                        for a, b in cands],
                }
                if challenger is None:
                    self._registry.inc("tuning/retunes/rejected")
                    return self._close(
                        base, "rejected",
                        reason="no covering challenger lane")
                inc_bw, ch_bw = ab_cell(
                    self.world, incumbent, challenger, coll, count,
                    dtype, repetitions=self.repetitions,
                    retries=self.retries, hier=hier)
        except (ACCLError, ValueError, KeyError) as e:
            self._registry.inc("tuning/retunes/rejected")
            return self._close(base, "error", reason=str(e))
        base["ab"] = {
            "incumbent_busbw_GBps": inc_bw,
            "challenger_busbw_GBps": ch_bw,
            "ratio": round(ch_bw / inc_bw, 3) if inc_bw else 0.0,
        }
        if not inc_bw or ch_bw < inc_bw * self.hysteresis:
            self._registry.inc("tuning/retunes/rejected")
            return self._close(
                base, "rejected",
                reason=f"challenger {ch_bw:.3f} GB/s did not clear "
                       f"incumbent {inc_bw:.3f} x hysteresis "
                       f"{self.hysteresis}")
        self._registry.inc("tuning/retunes/verified")
        entry = {
            "algorithm": challenger,
            "busbw_GBps": ch_bw,
            "static_busbw_GBps":
                inc_bw if incumbent == "static"
                else (incumbent_entry or {}).get("static_busbw_GBps"),
            "bytes": bucket_bytes(finding.get("size_bucket", "")),
            "overlap": None,
            "online": True,
        }
        prev = self._install(key, entry)
        self._registry.inc("tuning/retunes/installed")
        episode = self._close(
            base, "installed",
            reason=f"{challenger} beat {incumbent} "
                   f"{base['ab']['ratio']}x in the interleaved A/B",
            installed=entry)
        self._watch[key] = {"prev": prev,
                            "installed_at": time.monotonic(),
                            "episode_seq": episode.get("seq")}
        return episode

    def _revert(self, base: dict, key: str, watch: dict) -> dict:
        """Roll an installed selection back to its pre-install entry:
        the post-install sentinel window flagged the very cell we
        changed."""
        prev = watch.get("prev")
        self._apply_swap(key, prev, event=_flight.RETUNE_REVERT_EVENT)
        self._watch.pop(key, None)
        # cooldown the cell hard: the box just proved our measurement
        # unrepresentative, so don't immediately re-propose it
        self._cooldown[key] = time.monotonic() + 2 * self.cooldown_s
        self._registry.inc("tuning/retunes/reverted")
        self._log.warning(
            "online retune on %s regressed post-install; reverted to "
            "%s", key,
            (prev or {"algorithm": "static"}).get("algorithm"))
        return self._close(
            base, "reverted",
            reason="post-install sentinel regression on the installed "
                   "cell",
            reverted_to=(prev or {"algorithm": "static"})["algorithm"],
            installed_episode=watch.get("episode_seq"))

    # ------------------------------------------------------------------
    # axis hypotheses (fabric re-score)
    # ------------------------------------------------------------------
    def rescore_fabric(self) -> Optional[dict]:
        """Periodic ``Fabric.from_link_matrix`` re-score: when the
        measured healthiest-first ``axis_order`` differs from the one
        the composer serves, re-demote — update the table's world meta
        (what ``fabric_of_table`` and the transparent ``hier`` dispatch
        compose from) and fence plans + hier memos so the next
        composed call rides the new within axis."""
        if self.fabric.trivial:
            return None
        try:
            matrix = self.world.link_matrix()
            if not any(v for row in matrix["fields"]["seek_wait_ns"]
                       for v in row):
                return None
            fresh = Fabric.from_link_matrix(matrix,
                                            shape=self.fabric.shape)
        except (ACCLError, KeyError, AttributeError):
            return None
        if tuple(fresh.axis_order) == tuple(self.fabric.axis_order):
            return None
        base = {
            "kind": "axis",
            "trigger": {
                "type": "link_matrix",
                "axis_scores": getattr(fresh, "axis_scores", {}),
            },
            "opened_at": time.time(),
            "hypothesis": {
                "axis_order_from": list(self.fabric.axis_order),
                "axis_order_to": list(fresh.axis_order),
            },
        }
        self._registry.inc("tuning/retunes/proposed")
        old_within = self.fabric.within_axis()
        self.fabric = fresh
        meta = dict(self.table.world or {})
        meta["shape"] = list(fresh.shape)
        meta["axis_order"] = list(fresh.axis_order)
        self.table.world = meta
        self._fence_all(_flight.RETUNE_EVENT)
        self._registry.inc("tuning/retunes/installed")
        self._log.warning(
            "measured axis re-demotion: within axis %s -> %s (%s)",
            self.fabric.axis_names[old_within],
            fresh.axis_names[fresh.within_axis()], fresh.spec())
        return self._close(
            base, "installed",
            reason=f"axis health re-ranked: within "
                   f"{fresh.axis_names[old_within]} -> "
                   f"{fresh.axis_names[fresh.within_axis()]}")

    # ------------------------------------------------------------------
    # install plumbing
    # ------------------------------------------------------------------
    def _install(self, key: str, entry: Optional[dict]) -> Optional[dict]:
        prev = self.table.entries.get(key)
        self._apply_swap(key, entry, event=_flight.RETUNE_EVENT)
        return prev

    def _apply_swap(self, key: str, entry: Optional[dict],
                    event: str) -> None:
        """The fenced hot-swap on every rank: flight anchor ->
        plan-ring invalidation (exactly the abort fence: stale replay
        raises, re-capture succeeds) -> register re-derivation through
        the policy -> hier-memo drop."""
        for a in self.world.accls:
            _flight.mark_event(a.flight_recorder, event, -1, 0)
            a._invalidate_plans(None, f"online retune: {key}")
            inv = getattr(a._device, "invalidate_plans", None)
            if inv is not None:
                inv(-1)
            a._tune_policy.hot_swap(a, key, entry)
            a._drop_hier_comms()

    def _fence_all(self, event: str) -> None:
        """The axis-demotion fence: no table cell changed, but every
        captured plan and memoized composition now encodes a stale
        axis assignment."""
        for a in self.world.accls:
            _flight.mark_event(a.flight_recorder, event, -1, 0)
            a._invalidate_plans(None, "online retune: axis re-demotion")
            inv = getattr(a._device, "invalidate_plans", None)
            if inv is not None:
                inv(-1)
            a._tune_policy._memo.clear()
            a._drop_hier_comms()

    # ------------------------------------------------------------------
    # measurement hygiene
    # ------------------------------------------------------------------
    def _suspended(self):
        """Disarm the live policies for the duration of a measurement:
        the A/B must exercise the raw lanes, not route through the
        very policy (or compression/fused default) under test."""
        tuner = self

        class _Suspend:
            def __enter__(self):
                self._stash = [
                    (a, a._tune_policy, a._compress_policy,
                     a._fused_default)
                    for a in tuner.world.accls]
                for a, *_ in self._stash:
                    a._tune_policy = None
                    a._compress_policy = None
                    a._fused_default = False
                    a._call_memo.clear()
                return self

            def __exit__(self, *exc):
                for a, pol, comp, fused in self._stash:
                    a._tune_policy = pol
                    a._compress_policy = comp
                    a._fused_default = fused
                    a._call_memo.clear()
                    if pol is not None:
                        pol._memo.clear()
                return False

        return _Suspend()

    def _hier_for_measure(self) -> Optional[list]:
        """Per-rank composers for hierarchical-lane measurement over
        the CURRENT fabric; None on a trivial fabric (the lane is then
        excluded by cell_candidates)."""
        if self.fabric.trivial:
            return None
        try:
            return [HierarchicalComm(a, self.fabric)
                    for a in self.world.accls]
        except ACCLError:
            return None

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _close(self, base: dict, decision: str, **fields) -> dict:
        episode = dict(base, decision=decision,
                       closed_at=time.time(), **fields)
        return self.history.append(episode)


# ---------------------------------------------------------------------------
# env-driven singleton (world bring-up arms it next to the sentinel)
# ---------------------------------------------------------------------------
_tuner_lock = threading.Lock()
_tuner: Optional[OnlineTuner] = None


def ensure_online_tuner_from_env(world) -> Optional[OnlineTuner]:
    """Idempotent world-level arm: ``ACCL_TUNE_ONLINE`` unset/0 = off
    (nothing constructed, zero threads, dispatch bit-identical).
    Armed, the tuner subscribes to the env sentinel (when one is
    running) and starts its loop.  Never raises — a tuner fault must
    not take world bring-up down."""
    global _tuner
    if not online_enabled():
        return None
    with _tuner_lock:
        if _tuner is not None:
            return _tuner
        try:
            tuner = OnlineTuner(world)
            from ..observability import sentinel as _sentinel_mod

            tuner.attach_sentinel(_sentinel_mod._sentinel)
            interval = env_int(ENV_INTERVAL_MS, 5000, minimum=1)
            tuner.start(interval / 1000.0)
        except Exception:
            get_logger("accl_tpu_torch.tuning.online").warning(
                "online tuner disabled: bring-up failed", exc_info=True)
            return None
        _tuner = tuner
        return _tuner


def online_tuner() -> Optional[OnlineTuner]:
    return _tuner


def stop_online_tuner() -> None:
    global _tuner
    with _tuner_lock:
        if _tuner is not None:
            _tuner.stop()
            _tuner = None


def stop_world_tuner(world) -> None:
    """A world's ``close()``: stop its tuner (the singleton's loop when
    the world armed it, else the world's own) and clear
    ``world.online_tuner``."""
    tuner = world.online_tuner
    if tuner is None:
        return
    if online_tuner() is tuner:
        stop_online_tuner()
    else:
        tuner.stop()
    world.online_tuner = None


def history_doc() -> dict:
    """The ``/retunes`` exporter payload: the live tuner's audit ring,
    or an empty document when no tuner is (or ever was) armed."""
    t = _tuner
    if t is None:
        return {"format": HISTORY_FORMAT, "version": HISTORY_VERSION,
                "episodes": [], "dropped": 0, "total": 0}
    return t.history.to_doc()
