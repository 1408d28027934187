"""Collective sanitizer: static desync/deadlock linting + runtime checks.

Port of ``accl_tpu/analysis/``.  Layout:

- ``program``   — :class:`CollectiveProgram` / :class:`RecordedCall`,
                  the captured per-rank call streams.
- ``record``    — :class:`LintDevice` (the no-execution ``CCLODevice``)
                  and :class:`LintWorld` (``CudaWorld``-shaped harness).
- ``checks``    — the cross-rank static checker suite
                  (:func:`check_programs`).
- ``findings``  — :class:`Finding` + severity ranking.
- ``sanitizer`` — the ``ACCL_SANITIZE=1`` runtime lane and the shadow
                  :class:`CaptureSession`.

NOTE: this ``__init__`` is import-light and lazy (PEP 562) because the
driver itself imports ``analysis.sanitizer`` — eagerly importing
``record`` here would cycle back into ``accl``.
"""
from __future__ import annotations

_EXPORTS = {
    "CollectiveProgram": "program",
    "RecordedCall": "program",
    "Finding": "findings",
    "sort_findings": "findings",
    "has_errors": "findings",
    "LintBuffer": "record",
    "LintDevice": "record",
    "LintWorld": "record",
    "record_program": "record",
    "check_programs": "checks",
    "check_flight_lifecycle": "checks",
    "check_fence_staleness": "checks",
    "check_teardown_completions": "checks",
    "check_lock_order": "checks",
    "check_stuck_progress": "checks",
    "check_subcomm_interleave": "checks",
    "CaptureSession": "sanitizer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)

