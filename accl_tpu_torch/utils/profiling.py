"""Tracing/profiling hooks.

Port of ``accl_tpu/utils/profiling.py``.  The JAX package wraps the XLA
profiler; here :func:`xla_trace` (the reference's name, kept) wraps
``torch.profiler``: a capture of the host and, where a card is present,
its CUDA kernels, written as a Chrome trace into ``logdir`` (open it in
Perfetto or ``chrome://tracing``).  The capture buffers its events in
host memory and slows every launch inside it, so it runs only when a
caller asks for it.

A trace can lack kernels that ran in the window: the profiler drops a
device record whose timestamp, mapped onto the host clock, falls outside
the window (kineto logs them as ``Out-of-range`` at
``KINETO_LOG_LEVEL=1``).  On an H100 the windows of the first seconds
after a process's first capture have kept every record, and most
windows a minute later have lost some or all of them (README, "Tools
and utilities"; ``bench/profiler_records.py``).  :func:`xla_trace`
therefore counts the kernel launches the trace records on the host that
have no device record, and warns when there are any.

The structured per-call tracing + metrics layer lives in
accl_tpu_torch/observability; its ``traced_window(label,
xla_logdir=...)`` marks a span in the ACCL trace AND captures an
:func:`xla_trace` of the same window.  The block timer ``timed`` is
utils/timing.Timer's, re-exported here for the reference's import path.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Iterator

import torch

from .timing import Timer, timed  # noqa: F401 — one implementation
from .tree import tree_leaves


@contextlib.contextmanager
def xla_trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when a card is present) and write it to
    ``<logdir>/accl_trace.<pid>.<ns>.json`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir,
                        f"accl_trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        check_kernel_records(path)


#: the runtime and driver calls that launch one kernel (a graph launch's
#: kernels share its one correlation id, so it is not counted)
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel"))


def unrecorded_launches(trace: dict) -> tuple:
    """``(missing, launched)``: how many of the kernel launches a Chrome
    trace records on the host have no device record in it."""
    def correlations(keep):
        return {e["args"]["correlation"]
                for e in trace.get("traceEvents", [])
                if keep(e) and "correlation" in e.get("args", {})}

    launched = correlations(
        lambda e: e.get("cat") in ("cuda_runtime", "cuda_driver")
        and e.get("name") in LAUNCH_CALLS)
    recorded = correlations(lambda e: e.get("cat") == "kernel")
    return len(launched - recorded), len(launched)


def check_kernel_records(path: str) -> int:
    """Warn when the trace at ``path`` lacks device records of kernels
    launched in its window; returns how many it lacks."""
    with open(path) as f:
        missing, launched = unrecorded_launches(json.load(f))
    if missing:
        warnings.warn(
            f"xla_trace: {missing} of {launched} kernel launches in the "
            f"window have no device record in {path} (a kernel still "
            f"running when the window closed, or a record the profiler "
            f"dropped as outside its window)", RuntimeWarning,
            stacklevel=2)
    return missing


def _sync(out) -> None:
    """Wait for the device work behind ``out``: one synchronize of each
    card a CUDA tensor of the result lives on (the role of
    ``jax.block_until_ready``)."""
    leaves = tree_leaves(out) if isinstance(out, (dict, list, tuple)) \
        else [out]
    for dev in {t.device for t in leaves
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2,
            pipelined: bool = False) -> float:
    """Average seconds per call with device sync (bench building block).

    Each iteration's CUDA result is synchronized, so the reported time
    is true per-call latency — kernel launches are asynchronous, and
    syncing only the last output lets earlier iterations overlap the
    loop, underreporting per-call time.  ``pipelined=True`` restores the
    overlapped measurement (throughput of a dependency-free stream: only
    the final output is synced)."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    if pipelined:
        out = None
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
    else:
        for _ in range(iters):
            _sync(fn(*args))
    return (time.perf_counter() - t0) / iters
