"""Async request layer (reference driver/xrt/include/accl/acclrequest.hpp
:39-211).  Every call returns a handle to wait on; completion carries
the engine retcode and a duration.  ``RequestQueue`` serializes the
submission of one rank's calls, like the reference's FPGAQueue."""
from __future__ import annotations

import itertools
import os
import threading
from typing import Callable, Optional

from .constants import ACCLError, OperationStatus, error_code_to_str

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
            self._done.set()

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

    def check(self) -> None:
        """Raise on a non-zero retcode, a failed completion callback, or
        a call still in flight (reference accl.cpp:1226-1250)."""
        if not self.done:
            raise ACCLError(f"{self.description or 'call'} timed out: request "
                            f"id {self.id} still in flight "
                            f"(status={self.status.name})")
        self.waited = True
        if self.retcode != 0:
            raise ACCLError(f"{self.description or 'call'} failed: "
                            f"{error_code_to_str(self.retcode)}", self.retcode)
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
            start_fn(request)
        return request
