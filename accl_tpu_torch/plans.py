"""Persistent collective plans: capture once, validate once, replay at
ring speed.

Port of ``accl_tpu/plans.py``, whole.  A steady-state sequence of
collective calls — what a serving or training step loop issues — is

- **captured once** (``ACCL.capture_plan(fn)`` records the descriptor
  stream through the same :class:`~accl_tpu_torch.analysis.program.
  CollectiveProgram`/``RecordedCall`` machinery the sanitizer's record
  mode and shadow capture use; the calls still execute, so the capture
  iteration's results are real),
- **validated once** (the full static checker suite runs at plan-build
  time — pooled across the ranks of an in-process world when every rank
  captures concurrently, single-rank checks otherwise — so a
  desync/hazard is an ``ACCLError`` naming the finding at capture, not
  a hang at iteration 10⁶),
- **lowered once** (the engine pre-resolves every descriptor into a
  pinned slot: buffer bindings, gang pairing, the program, the operand
  views and result views — the ``_gang_plans`` work of
  ``backends/cuda.py``, paid at arm time instead of per call), and
- **replayed** through a fixed-slot submission/completion ring shared
  with the engine: a replay is a sequence counter bump — no descriptor
  build, no gang assembly, no per-call validation; the generation's
  last-arriving rank runs every slot inline on the card's stream.

Invalidation contract: a fence (``ACCL._invalidate_plans``, the
engine's ``invalidate_rings``, a bump of the engine's per-comm
generation) makes a replay **raise** (explicit plans) or transparently
**re-capture** (the ``ACCL_PLAN_AUTO`` lane); it never silently runs on
a fenced epoch.  A closed or collected plan releases its ring and
raises too.

Knobs:

- ``ACCL_PLAN=0`` — kill switch: ``capture_plan`` returns an
  :class:`EagerPlan` whose ``replay`` re-runs the captured function
  through the normal per-call driver path.  It is the only path that
  does: a failed arm raises.
- ``ACCL_PLAN_AUTO=N`` — transparent auto-capture: after ``N``
  identical resident synchronous gang calls, the world's ranks agree
  (through the gang itself — every member marks intent on the same
  instance, so no rank ever replays against an eager peer) to arm a
  one-step plan and route subsequent identical calls through the ring.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .constants import (
    GANG_OPERATIONS,
    ACCLError,
    CCLOCall,
    ErrorCode,
    Operation,
    env_int,
)
from .observability import flight as _flight
from .observability import metrics as _metrics
from .observability import trace as _trace
from .utils.logging import get_logger

# ---------------------------------------------------------------------------
# gating (same discipline as the sanitizer: module bools, env at import)
# ---------------------------------------------------------------------------
_enabled = os.environ.get("ACCL_PLAN", "1") not in ("", "0")


def enabled() -> bool:
    """False under ``ACCL_PLAN=0`` — every plan API degrades to eager."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Programmatic twin of ``ACCL_PLAN`` (tests toggle this)."""
    global _enabled
    _enabled = bool(on)


def auto_threshold() -> int:
    """``ACCL_PLAN_AUTO``: identical-iteration streak after which the
    driver transparently arms a one-step plan (0 = off, the default).
    Honors the ``ACCL_PLAN=0`` kill switch."""
    if not _enabled:
        return 0
    return env_int("ACCL_PLAN_AUTO", 0, minimum=0)


#: how long a capture waits for the sibling ranks of an in-process world
#: to reach their own capture_plan before degrading to single-rank
#: validation (the pooled cross-rank checks need every program)
_POOL_TIMEOUT_S = 10.0

_replay_ids = itertools.count(1 << 20)  # flight req ids, driver-disjoint


# ---------------------------------------------------------------------------
# captured step model
# ---------------------------------------------------------------------------
@dataclass
class PlanStep:
    """One captured call: the pre-built descriptor plus the host-side
    staging the driver would have performed around it."""

    call: CCLOCall
    desc: str
    run_async: bool
    sync_in: list = field(default_factory=list)   # [(buffer, count)]
    sync_out: list = field(default_factory=list)  # [(buffer, count)]


class PlanRecorder:
    """Installed by ``ACCL.capture_plan`` for the duration of the
    captured function: ``ACCL._execute`` feeds every outgoing call here
    (the call still executes — capture is a shadow recording, so the
    first iteration's results are real)."""

    def __init__(self, accl):
        self._accl = accl
        self.entries: list = []  # (PlanStep, Request)

    def on_call(self, call: CCLOCall, sync_in: list, sync_out: list,
                run_async: bool, desc: str, req) -> None:
        step = PlanStep(call=call, desc=desc, run_async=run_async,
                        sync_in=[(b, n) for b, n in sync_in
                                 if not b.is_dummy],
                        sync_out=[(b, n) for b, n in sync_out
                                  if not b.is_dummy])
        self.entries.append((step, req))


# ---------------------------------------------------------------------------
# pooled capture-time validation (cross-rank when the world shares the
# process; the same domain identity the runtime sanitizer exchanges on)
# ---------------------------------------------------------------------------
_pool_cv = threading.Condition()
_pools: dict = {}  # (domain, group_idx) -> pool dict


def _sweep_pools_locked() -> None:
    if len(_pools) <= 64:
        return
    horizon = time.monotonic() - 4.0 * _POOL_TIMEOUT_S
    for key in [k for k, p in _pools.items() if p["created"] < horizon]:
        del _pools[key]


def _pooled_findings(key: tuple, rank: int, program,
                     expected: frozenset, eager: int,
                     timeout_s: float):
    """Post this rank's captured program under ``key`` — (domain,
    member-set, per-member-set capture index), so every rank of one
    logical capture pairs on the identical key and disjoint concurrent
    captures never collide — and run the full cross-rank checker suite
    once every expected rank has posted; returns the shared findings
    list, or None when the pool never filled (caller degrades to
    single-rank checks)."""
    from .analysis.checks import check_programs

    with _pool_cv:
        _sweep_pools_locked()
        pool = _pools.get(key)
        if pool is None:
            pool = _pools[key] = {
                "programs": {}, "expected": set(expected),
                "eager": 1 << 62, "findings": None,
                "created": time.monotonic()}
        pool["programs"][rank] = program
        pool["expected"] |= set(expected)
        pool["eager"] = min(pool["eager"], eager)
        if set(pool["programs"]) >= pool["expected"]:
            # last poster runs the checks for the whole group
            pool["findings"] = check_programs(
                pool["programs"], eager_threshold=pool["eager"])
            _pools.pop(key, None)
            _pool_cv.notify_all()
            return pool["findings"]
        deadline = time.monotonic() + timeout_s
        while pool["findings"] is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not _pool_cv.wait(remaining):
                if pool["findings"] is not None:
                    break
                return None  # pool never filled; degrade gracefully
        return pool["findings"]


def _single_rank_findings(program) -> list:
    """The checker subset that is sound on one rank's program alone
    (cross-rank order/matching/deadlock checks need every program and
    would false-positive here)."""
    from .analysis.checks import check_buffer_hazards, check_membership

    programs = {program.rank: program}
    return check_membership(programs) + check_buffer_hazards(programs)


# ---------------------------------------------------------------------------
# plan objects
# ---------------------------------------------------------------------------
class PlanTicket:
    """Async replay handle (the plan twin of :class:`~accl_tpu_torch.request.
    Request`): ``wait()`` → ``check()`` drains one in-flight replay."""

    def __init__(self, plan: "CollectivePlan", token, rec):
        self._plan = plan
        self._token = token
        self._rec = rec
        self._error: Optional[ACCLError] = None
        self._done = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._done:
            return True
        plan = self._plan
        budget = plan._accl.call_timeout_s if timeout is None else timeout
        try:
            ok = plan._device.plan_wait(plan._handle, self._token, budget)
        except ACCLError as e:
            self._error = e
            plan._note_replay_error(e)
            ok = True
        if not ok:
            return False
        self._done = True
        if self._error is None:
            plan._finish_replay(self._rec, 0)
        elif self._rec is not None:
            self._rec.finish(getattr(self._error, "code", 0)
                             or int(ErrorCode.DMA_INTERNAL_ERROR),
                             _trace.now_ns())
        return True

    def check(self) -> None:
        if not self._done:
            raise ACCLError("plan replay still in flight — wait() first")
        if self._error is not None:
            raise self._error

    @property
    def done(self) -> bool:
        return self._done


class CollectivePlan:
    """A captured, validated, pre-lowered collective program bound to
    one rank's driver.  ``replay()`` re-executes it through the
    submission ring; see the module docstring for the full contract."""

    def __init__(self, accl, steps: list, members: frozenset,
                 comms: frozenset, handle):
        self._accl = accl
        self._device = accl._device
        self.steps = steps
        self.members = members
        self.comms = comms
        self._handle = handle
        self._invalid: Optional[str] = None
        self.stats = {"replays": 0, "invalidations": 0}
        # flight-record shape for one replay (one record per replay,
        # not per inner call: the ring's whole point is that the inner
        # calls no longer exist as per-call driver events)
        self._comm0 = min(comms) if comms else 0
        self._total_count = sum(s.call.count for s in steps)
        self._staged_in = [pair for s in steps for pair in s.sync_in]
        self._staged_out = [pair for s in steps for pair in s.sync_out]
        # release path: a dead/closed plan must not pin engine-side
        # state (compiled programs, buffer bindings, descriptor
        # storage) forever — the finalizer drops this rank's handle;
        # backends refcount shared rings and no-op after world close
        import weakref

        rel = getattr(self._device, "plan_release", None)
        self._finalizer = (weakref.finalize(self, rel, handle)
                           if rel is not None else None)

    def close(self) -> None:
        """Explicitly release this plan's engine-side resources (also
        happens automatically when the object is garbage-collected).
        A closed plan refuses to replay."""
        self._invalid = self._invalid or "plan closed"
        if self._finalizer is not None:
            self._finalizer()

    # -- lifecycle -----------------------------------------------------
    @property
    def invalidated(self) -> bool:
        return self._invalid is not None

    @property
    def is_eager(self) -> bool:
        return False

    def _invalidate(self, reason: str) -> None:
        if self._invalid is None:
            self._invalid = reason
            self.stats["invalidations"] += 1
            if _metrics.enabled():
                _metrics.default_registry().inc("plans/invalidations")

    def _note_replay_error(self, e: ACCLError) -> None:
        code = int(getattr(e, "code", 0))
        if code & int(ErrorCode.COMM_ABORTED) or "invalidated" in str(e):
            self._invalidate(str(e))

    # -- replay hot path -----------------------------------------------
    def replay(self, run_async: bool = False,
               timeout: Optional[float] = None):
        """One pass through the captured program.  Synchronous by
        default (returns when every step completed); ``run_async=True``
        returns a :class:`PlanTicket`.  Raises — never silently runs —
        when the plan was fenced, closed or collected; re-capture on
        the recovered communicator."""
        accl = self._accl
        if self._invalid is not None:
            raise ACCLError(
                f"plan replay: plan invalidated ({self._invalid}) — "
                f"re-capture the plan on the recovered communicator",
                int(ErrorCode.COMM_ABORTED))
        if accl._aborted_comms and (self.comms & accl._aborted_comms):
            self._invalidate("communicator aborted")
            raise ACCLError(
                f"plan replay: communicator(s) "
                f"{sorted(self.comms & accl._aborted_comms)} aborted "
                f"(COMM_ABORTED) — shrink/reset and re-capture",
                int(ErrorCode.COMM_ABORTED))
        for buf, count in self._staged_in:
            buf.slice(0, count).sync_to_device()
        rec = None
        if accl.flight_recorder is not None and _flight.enabled():
            rec = accl.flight_recorder.new_record(
                next(_replay_ids), "plan_replay", self._comm0, 0,
                "plan", self._total_count, 0, len(self.members), True,
                _trace.now_ns())
            rec.mark_dispatched("plan", _trace.now_ns())
        budget = accl.call_timeout_s if timeout is None else timeout
        try:
            token = self._device.plan_replay(
                self._handle, run_async=run_async, timeout_s=budget)
        except ACCLError as e:
            if rec is not None:
                rec.finish(getattr(e, "code", 0)
                           or int(ErrorCode.DMA_INTERNAL_ERROR),
                           _trace.now_ns())
            self._note_replay_error(e)
            raise
        if run_async:
            return PlanTicket(self, token, rec)
        self._finish_replay(rec, 0)
        return None

    def _finish_replay(self, rec, retcode: int) -> None:
        for buf, count in self._staged_out:
            buf.slice(0, count).sync_from_device()
        if rec is not None:
            rec.finish(retcode, _trace.now_ns())
        self.stats["replays"] += 1
        if _metrics.enabled():
            _metrics.default_registry().inc("plans/replays")


class EagerPlan:
    """The ``ACCL_PLAN=0`` fallback: same surface, no ring — ``replay``
    re-runs the captured function through the unchanged per-call driver
    path, so the kill-switch lane is bit-identical to today."""

    def __init__(self, accl, fn: Callable, args: tuple):
        self._accl = accl
        self._fn = fn
        self._args = args
        self.stats = {"replays": 0, "invalidations": 0}

    @property
    def is_eager(self) -> bool:
        return True

    @property
    def invalidated(self) -> bool:
        return False

    def replay(self, run_async: bool = False,
               timeout: Optional[float] = None):
        self._fn(self._accl, *self._args)
        self.stats["replays"] += 1
        if run_async:
            t = PlanTicket(self, None, None)
            t._done = True
            return t
        return None


# ---------------------------------------------------------------------------
# capture driver (called by ACCL.capture_plan)
# ---------------------------------------------------------------------------
def build_plan(accl, recorder: PlanRecorder, validate: bool = True,
               timeout_s: Optional[float] = None) -> CollectivePlan:
    """Validate the captured program (sanitizer checker suite) and arm
    it on the backend; the heavy lifting behind ``ACCL.capture_plan``."""
    from .analysis.sanitizer import CaptureSession
    from .analysis.findings import ERROR

    if not recorder.entries:
        raise ACCLError("capture_plan: the captured function issued no "
                        "collective calls — nothing to arm")
    unsupported = [s.desc for s, _r in recorder.entries
                   if s.call.stream_flags]
    if unsupported:
        raise ACCLError(
            f"capture_plan: stream-operand calls are not replayable "
            f"({unsupported[0]}) — plans pre-resolve memory operands "
            f"only; keep stream traffic on the eager path")

    # 1. reuse the sanitizer's record machinery: rebuild the rank's
    #    CollectiveProgram from the captured descriptor stream
    session = CaptureSession()
    for step, req in recorder.entries:
        session.record(accl, step.call, step.desc, req, step.run_async)
    world = accl.communicator(0)
    rank = world.ranks[world.local_rank].session
    program = session.programs.get(rank)

    # 2. membership: who has to arm with us (union of gang/p2p peers)
    members: set = {rank}
    comms: set = set()
    for step, _req in recorder.entries:
        op = Operation(step.call.scenario)
        comm = accl.communicator(step.call.comm)
        sessions = [r.session for r in comm.ranks]
        if op in GANG_OPERATIONS:
            members.update(sessions)
            comms.add(step.call.comm)
        elif op in (Operation.send, Operation.recv):
            members.add(sessions[step.call.root_src_dst])
            comms.add(step.call.comm)

    # 3. validation: full cross-rank suite when the world shares the
    #    process (pooled over every capturing rank), single-rank-sound
    #    checks otherwise
    if validate and program is not None:
        budget = _POOL_TIMEOUT_S if timeout_s is None else timeout_s
        domain_fn = getattr(accl._device, "sanitizer_domain", None)
        domain = domain_fn() if domain_fn is not None else None
        findings = None
        if domain is not None and len(members) > 1:
            group = (domain, frozenset(members))
            idx = accl._plan_group_seq.get(group, 0)
            accl._plan_group_seq[group] = idx + 1
            findings = _pooled_findings(
                group + (idx,), rank, program, frozenset(members),
                accl.max_eager_size, budget)
        if findings is None:
            if domain is not None and len(members) > 1:
                get_logger("accl_tpu_torch.plans", rank=rank).warning(
                    "capture_plan: sibling ranks never reached their "
                    "own capture inside %.0fs — cross-rank validation "
                    "degraded to single-rank checks", budget)
            findings = _single_rank_findings(program)
        errors = [f for f in findings if f.severity == ERROR]
        if errors:
            raise ACCLError(
                "capture_plan: sanitizer finding at capture time: "
                + errors[0].render()
                + (f" (+{len(errors) - 1} more)" if len(errors) > 1
                   else ""))

    # 4. lower + arm on the backend (pre-resolve descriptors into the
    #    pinned submission ring)
    arm = getattr(accl._device, "arm_plan", None)
    if arm is None:
        raise ACCLError(
            f"capture_plan: backend {type(accl._device).__name__} has "
            f"no plan ring — only CudaWorld's engine replays plans "
            f"(ACCL_PLAN=0 selects the eager fallback)")
    budget = accl.call_timeout_s if timeout_s is None else timeout_s
    handle = arm([s.call for s, _r in recorder.entries],
                 frozenset(members), budget)
    plan = CollectivePlan(accl, [s for s, _r in recorder.entries],
                          frozenset(members), frozenset(comms), handle)
    # lifecycle anchor: a capture event per touched comm lets the
    # dump checkers prove a post-fence replay was legitimately re-armed
    # (analysis.checks.check_fence_staleness)
    for c in sorted(comms):
        _flight.mark_event(accl.flight_recorder, _flight.PLAN_CAPTURE_EVENT,
                           int(c), lane="plan")
    if _metrics.enabled():
        _metrics.default_registry().inc("plans/captures")
    import weakref

    accl._plans.append(weakref.ref(plan))
    return plan
