"""Async request layer (reference driver/xrt/include/accl/acclrequest.hpp
:39-211).  Every call returns a handle to wait on; completion carries
the engine retcode and a duration.  ``RequestQueue`` serializes the
submission of one rank's calls, like the reference's FPGAQueue.

Each request carries its observability records (accl_tpu/request.py
:88-142): the trace span, the metrics signature and the flight record
the driver attaches, stamped at queue entry here and published at
completion by ``_observe``."""
from __future__ import annotations

import itertools
import os
import threading
from typing import Callable, Optional

from .constants import ACCLError, OperationStatus, error_code_to_str
from .observability import flight as _flight
from .observability import trace as _trace

#: distinguishes "no timeout passed" from an explicit None (block forever)
_WAIT_DEFAULT = object()


def default_wait_timeout_s() -> float:
    """Default Request.wait budget: the ``ACCL_DEFAULT_TIMEOUT`` engine
    budget (µs) plus host headroom, so a bare wait() cannot hang forever."""
    raw = os.environ.get("ACCL_DEFAULT_TIMEOUT", "1000000")
    try:
        engine_s = float(raw) / 1e6
    except ValueError:
        engine_s = 1.0
    return engine_s + 59.0


class Request:
    """Handle for one in-flight call."""

    _ids = itertools.count()

    def __init__(self, description: str = "", sync: bool = False):
        self.id = next(Request._ids)
        self.description = description
        #: True when the submitter will block on this request: the engine
        #: may then run the call inline on the waiting thread
        self.sync = sync
        self.status = OperationStatus.QUEUED
        self.retcode: int = 0
        self.duration_ns: float = 0.0
        self._done = threading.Event()
        #: run on completion (the driver syncs result buffers back here)
        self.on_complete: Optional[Callable[["Request"], None]] = None
        #: run once at the top of wait(), on the waiting thread: the
        #: engine defers leader dispatch here, out of the submission lock
        self.pre_wait: Optional[Callable[[], None]] = None
        self.callback_error: Optional[Exception] = None
        #: observability: ``trace`` is this call's TraceSpan (None when
        #: tracing is off, the no-allocation path), ``metric`` the
        #: (registry, collective, dtype, nbytes, nranks, t_submit_ns,
        #: tenant) tuple published at completion, ``flight`` the
        #: always-on flight record (None under ACCL_FLIGHT=0); all three
        #: set by ACCL._observe_call
        self.trace: Optional[_trace.TraceSpan] = None
        self.metric: Optional[tuple] = None
        self.flight: Optional[_flight.FlightRecord] = None
        self.waited = False

    def complete(self, retcode: int, duration_ns: float = 0.0) -> None:
        self.retcode = retcode
        self.duration_ns = duration_ns
        self.status = OperationStatus.COMPLETED
        try:
            if self.on_complete is not None:
                self.on_complete(self)
        except Exception as e:  # surface via check(), never lose the event
            self.callback_error = e
        finally:
            self._observe()
            self._done.set()

    def _observe(self) -> None:
        """Publish the completion to the observability layer: the flight
        record's retirement, the metrics observation and the span's
        complete stamp (after on_complete's result sync).  Observer
        failures never lose the completion event."""
        if self.metric is None and self.trace is None \
                and self.flight is None:
            return
        try:
            t_end = _trace.now_ns()
            if self.flight is not None:
                self.flight.finish(self.retcode, t_end)
            if self.metric is not None:
                reg, coll, dtype, nbytes, nranks, t0, tenant = self.metric
                reg.observe_call(coll, dtype, nbytes, t_end - t0, nranks,
                                 ok=self.retcode == 0,
                                 engine_ns=self.duration_ns, tenant=tenant)
            span = self.trace
            if span is not None:
                span.t_complete = t_end
                _trace.collector().add(span)
        except Exception:  # observability is best-effort
            pass

    def wait(self, timeout=_WAIT_DEFAULT) -> bool:
        """Block until completion; False on timeout (reference
        cclo.hpp:149-150)."""
        if timeout is _WAIT_DEFAULT:
            timeout = default_wait_timeout_s()
        thunk, self.pre_wait = self.pre_wait, None
        if thunk is not None:
            thunk()
        ok = self._done.wait(timeout)
        if ok:
            self.waited = True
        return ok

    def flight_info(self) -> str:
        """This call's flight record for error text ('' when the
        recorder is off): seq, state, lane, age."""
        rec = self.flight
        if rec is None:
            return ""
        return f" [flight: {rec.summary()}]"

    def check(self) -> None:
        """Raise on a non-zero retcode, a failed completion callback, or
        a call still in flight (reference accl.cpp:1226-1250), naming
        the call's flight record."""
        if not self.done:
            raise ACCLError(f"{self.description or 'call'} timed out: request "
                            f"id {self.id} still in flight "
                            f"(status={self.status.name}){self.flight_info()}")
        self.waited = True
        if self.retcode != 0:
            raise ACCLError(f"{self.description or 'call'} failed: "
                            f"{error_code_to_str(self.retcode)}"
                            f"{self.flight_info()}", self.retcode)
        if self.callback_error is not None:
            raise ACCLError(f"{self.description or 'call'} completion failed: "
                            f"{self.callback_error}") from self.callback_error

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def __repr__(self) -> str:
        return (f"Request(id={self.id}, {self.description!r}, "
                f"status={self.status.name})")


class RequestQueue:
    """Serializes the submission of one rank's calls onto its engine
    command stream (reference FPGAQueue, acclrequest.hpp:153-211)."""

    def __init__(self):
        self._lock = threading.Lock()

    def submit(self, request: Request,
               start_fn: Callable[[Request], None]) -> Request:
        with self._lock:
            request.status = OperationStatus.EXECUTING
            rec = request.flight
            if rec is not None:
                rec.t_queue = _trace.now_ns()
                rec.state = _flight.S_QUEUED
            if request.trace is not None:
                request.trace.t_queue = _trace.now_ns()
            start_fn(request)
        return request
