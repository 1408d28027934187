"""Recovery supervisor: the automated detect -> resume state machine
(the port's own copy of ``accl_tpu/resilience/supervisor.py``).

    RUNNING --failure--> ABORT -> PROBE -> SHRINK --(grow policy)-->
       JOIN_WAIT -> GROW -> AGREE -> RESUME --> RUNNING

Policy (environment or :class:`RecoveryPolicy`):

- ``ACCL_RECOVERY`` = ``shrink`` (default) | ``grow`` | ``halt``;
- ``ACCL_JOIN_WAIT_S``: how long the grow policy waits for a
  replacement to announce itself (default 5);
- ``ACCL_RECOVERY_MAX_ROUNDS``: episodes before the supervisor halts
  (default 4);
- ``ACCL_PROBE_WINDOW_S``: the liveness probe window (default 2).

Each transition is published as a ``recovery/<phase>`` flight record
(live in the ``recovering`` state until the phase ends), the
``accl_health`` gauge's ``recovering`` value for the whole episode, and
the ``membership/*`` counters and ``recovery/latency_us`` histogram.
``ACCL.supervise()`` makes one; ``ACCL_SUPERVISE=1`` arms it at
``initialize``.  It runs at loop level: the per-call path holds none of
it.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from ..constants import ACCLError, ErrorCode, ReduceFunction, env_float, env_int
from ..observability import flight as _flight
from ..observability import health as _health
from ..observability import metrics as _metrics
from ..observability import trace as _trace
from ..utils.logging import get_logger
from .elastic import MembershipBoard, admit_pending
from .membership import probe_alive

RECOVERY_MODES = ("shrink", "grow", "halt")

S_RUNNING = "running"
S_ABORT = "abort"
S_PROBE = "probe"
S_SHRINK = "shrink"
S_JOIN_WAIT = "join_wait"
S_GROW = "grow"
S_AGREE = "agree"
S_RESUME = "resume"
S_HALTED = "halted"

#: a fresh member's vote in the restart agreement (an allreduce MAX of
#: negated first-incomplete iterations): it never raises the restart
_FRESH_MEMBER = -float(2 ** 30)

#: the retcode bits of a membership failure: abort finalizations, an
#: expired receive budget, a wedged engine, and a seqn stream broken by
#: a rank killed mid-segment
_CLASSIFIED = (int(ErrorCode.COMM_ABORTED) | int(ErrorCode.RANK_FAILED)
               | int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
               | int(ErrorCode.DMA_TIMEOUT_ERROR)
               | int(ErrorCode.PACK_SEQ_NUMBER_ERROR))


class RecoveryPolicy:
    """The resolved supervisor policy (a bad knob raises naming it)."""

    def __init__(self, mode: Optional[str] = None,
                 join_wait_s: Optional[float] = None,
                 max_rounds: Optional[int] = None,
                 probe_window_s: Optional[float] = None):
        self.mode = (mode if mode is not None
                     else os.environ.get("ACCL_RECOVERY", "shrink"))
        if self.mode not in RECOVERY_MODES:
            raise ACCLError(
                f"ACCL_RECOVERY={self.mode!r} is not a policy — pick one "
                f"of {'/'.join(RECOVERY_MODES)}")
        self.join_wait_s = (join_wait_s if join_wait_s is not None
                            else env_float("ACCL_JOIN_WAIT_S", 5.0,
                                           minimum=0.0))
        self.max_rounds = (max_rounds if max_rounds is not None
                           else env_int("ACCL_RECOVERY_MAX_ROUNDS", 4,
                                        minimum=1))
        self.probe_window_s = (probe_window_s if probe_window_s is not None
                               else env_float("ACCL_PROBE_WINDOW_S", 2.0))
        if not self.probe_window_s > 0:
            raise ACCLError(
                f"ACCL_PROBE_WINDOW_S={self.probe_window_s!r} must be "
                f"> 0 (a zero/negative probe window can never collect "
                f"a pong)")

    def __repr__(self) -> str:
        return (f"RecoveryPolicy(mode={self.mode!r}, "
                f"join_wait_s={self.join_wait_s}, "
                f"max_rounds={self.max_rounds})")


class _Phase:
    """One supervisor phase: a flight record live in the ``recovering``
    state until the block exits."""

    def __init__(self, sup: "RecoverySupervisor", name: str, comm_id: int):
        self.sup, self.name, self.comm_id = sup, name, comm_id
        self.rec = None

    def __enter__(self):
        fr = self.sup.accl.flight_recorder
        if fr is not None and _flight.enabled():
            t = _trace.now_ns()
            self.rec = fr.new_record(-1, f"recovery/{self.name}",
                                     self.comm_id, 0, "none", 0, 0, 1,
                                     False, t)
            self.rec.mark_recovering(t)
        self.sup._note(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.rec is not None:
            self.rec.finish(0 if exc_type is None
                            else int(ErrorCode.RANK_FAILED), _trace.now_ns())
        return False


class RecoverySupervisor:
    """One rank's automated recovery driver.  Wrap the step in
    :meth:`run_loop`: a classified collective failure runs the abort ->
    probe -> shrink/grow -> agree -> resume episode and hands the new
    communicator to ``step(accl, comm_id, iteration)``; any other
    exception passes through."""

    def __init__(self, accl, policy: Optional[RecoveryPolicy] = None,
                 board: Optional[MembershipBoard] = None, registry=None):
        self.accl = accl
        self.policy = policy if policy is not None else RecoveryPolicy()
        self.board = board
        self._registry = (registry if registry is not None
                          else _metrics.default_registry())
        self.state = S_RUNNING
        #: (monotonic s, state, detail) for every transition
        self.state_log: list = []
        self.rounds = 0
        self.comm_id: Optional[int] = None
        self._log = get_logger("accl_tpu_torch.supervisor",
                               rank=getattr(accl, "rank", None))
        self._note(S_RUNNING, "armed")

    def _note(self, state: str, detail: str = "") -> None:
        self.state = state
        self.state_log.append((time.monotonic(), state, detail))
        self._log.info("supervisor -> %s%s", state,
                       f" ({detail})" if detail else "")

    def _phase(self, name: str, comm_id: int) -> _Phase:
        return _Phase(self, name, comm_id)

    def run_loop(self, step: Callable, iters: int, comm_id: int = 0,
                 on_restart: Optional[Callable[[int], None]] = None,
                 start_iteration: int = 0,
                 fresh_member: bool = False) -> dict:
        """Drive ``step(accl, comm_id, it)`` for ``iters`` iterations with
        automated recovery.  ``on_restart(it)`` lets the caller drop the
        results at and after the agreed restart; ``fresh_member`` marks a
        replacement with no completed work.  Returns a summary dict."""
        self.comm_id = comm_id
        it = start_iteration
        restarts: list = []
        while it < iters:
            try:
                step(self.accl, self.comm_id, it)
                it += 1
                continue
            except ACCLError as e:
                if not int(getattr(e, "code", 0)) & _CLASSIFIED:
                    raise  # not a membership failure
                self.rounds += 1
                if self.policy.mode == "halt" \
                        or self.rounds > self.policy.max_rounds:
                    self._note(S_HALTED, f"round {self.rounds}, policy "
                                         f"{self.policy.mode}")
                    if _metrics.enabled():
                        self._registry.inc("recovery/halts")
                    raise
                it = self._recover(it, fresh_member, e)
                fresh_member = False
                restarts.append(it)
                if on_restart is not None:
                    on_restart(it)
        self._note(S_RUNNING, f"loop done at iter {iters}")
        return {"iters": iters, "rounds": self.rounds,
                "comm_id": self.comm_id, "restarts": restarts,
                "state_log": list(self.state_log)}

    def _recover(self, first_incomplete: int, fresh: bool,
                 cause: ACCLError) -> int:
        accl, pol = self.accl, self.policy
        comm_id = self.comm_id
        t0 = time.monotonic()
        if _metrics.enabled():
            self._registry.inc("recovery/rounds")
        _health.note_recovering(self._registry, True)
        # members reach each phase skewed by up to one receive budget,
        # and the grow policy waits for a joiner: raise the budgets for
        # the episode so those waits never classify as fresh failures
        saved_budget = getattr(accl, "engine_timeout_us", 1_000_000)
        saved_call_s = accl.call_timeout_s
        margin_s = 2 * pol.probe_window_s + 15.0 + (
            pol.join_wait_s + 15.0 if pol.mode == "grow" else 0.0)
        accl.set_timeout(saved_budget + int(margin_s * 1e6))
        accl.call_timeout_s = max(saved_call_s,
                                  saved_budget / 1e6 + margin_s + 10.0)
        try:
            with self._phase(S_ABORT, comm_id):
                # idempotent: re-aborting an aborted comm is a no-op
                accl.abort(comm_id, error=int(ErrorCode.RANK_FAILED))
            with self._phase(S_PROBE, comm_id):
                alive = probe_alive(accl, comm_id, pol.probe_window_s)
                deaths = alive.count(False)
                if _metrics.enabled() and deaths:
                    self._registry.inc("membership/rank_deaths", deaths)
                if sum(alive) <= 1 < len(alive):
                    # nobody else answered: this rank is the isolated one
                    # and must not shrink the world down to itself
                    self._note(S_HALTED, "isolated: no live peers")
                    if _metrics.enabled():
                        self._registry.inc("recovery/halts")
                    raise ACCLError(
                        f"supervisor(comm {comm_id}): no live peers in "
                        f"{pol.probe_window_s:.1f}s probe — this rank "
                        f"is isolated (original failure: {cause})",
                        int(ErrorCode.RANK_FAILED))
            with self._phase(S_SHRINK, comm_id):
                new_comm = accl.shrink_communicator(
                    comm_id, window_s=pol.probe_window_s)
            if pol.mode == "grow":
                if self.board is None:
                    self._log.warning(
                        "grow policy without a membership board — "
                        "falling back to shrink for this episode")
                else:
                    self._note(S_JOIN_WAIT)
                    with self._phase(S_GROW, new_comm):
                        new_comm, admitted = admit_pending(
                            accl, new_comm, self.board,
                            wait_s=pol.join_wait_s,
                            window_s=pol.probe_window_s,
                            registry=self._registry)
                        self._note(S_GROW, f"admitted {admitted} "
                                           f"joiner(s), comm {new_comm}")
            self.comm_id = new_comm
            with self._phase(S_AGREE, new_comm):
                restart = self.agree_restart(first_incomplete, fresh=fresh)
            self._note(S_RESUME, f"iter {restart} on comm {new_comm}")
            return restart
        finally:
            accl.set_timeout(saved_budget)
            accl.call_timeout_s = saved_call_s
            _health.note_recovering(self._registry, False)
            if _metrics.enabled():
                self._registry.observe_value(
                    "recovery/latency_us", (time.monotonic() - t0) * 1e6)

    def agree_restart(self, first_incomplete: int,
                      fresh: bool = False) -> int:
        """The restart point, agreed on the current comm: an allreduce
        MAX of the negated first-incomplete iterations, i.e. the MIN over
        members (nobody skips work a slower survivor never finished).
        Fresh members vote neutrally."""
        accl = self.accl
        sb = accl.create_buffer(1, np.float32)
        sb.host[0] = _FRESH_MEMBER if fresh else -float(first_incomplete)
        rb = accl.create_buffer(1, np.float32)
        accl.allreduce(sb, rb, 1, ReduceFunction.MAX, comm_id=self.comm_id)
        agreed = -float(rb.host[0])
        if agreed <= _FRESH_MEMBER or agreed >= -_FRESH_MEMBER:
            return 0  # every member is fresh: start from the top
        return max(0, int(agreed))
