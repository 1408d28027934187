"""Collective benchmark sweep: busbw against size for every collective,
CSV rows out, with the nccl-tests payload and busbw factors.

Port of ``accl_tpu/bench/sweep.py`` (the reference's ACCLSweepBenchmark,
test/host/xrt/src/bench.cpp:25-61).  It drives any world that has
``accls``, ``run`` and ``nranks`` — ``CudaWorld`` on the card, or
``CudaWorld(n, device="cpu")`` — through the driver's host-staged calls
(``create_buffer_like``), as the reference does: a row's time includes
the copies between host and card, so the sweep's large rows are not the
resident driver numbers and are never compared with them.  Buffers are
freed after each call.  ``run_fused_overlap_sweep`` sets the fused lane
against the sequential schedule and reads each cell's exposed-wire
fraction with ``observability.attribution.overlap``.
"""
from __future__ import annotations

import csv
import io
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from ..constants import ACCLError, DataType, ReduceFunction
from ..observability import metrics as _metrics


def claim_platform(device: str = "cuda") -> str:
    """The device a sweep runs on: "cuda" when the card is there; "cpu"
    only when the caller asks for it.  Unlike the reference, which falls
    back to the CPU rung when the accelerator claim fails, a missing card
    raises: a CPU number must never pass for a card number."""
    dev = torch.device(device).type
    if dev == "cpu":
        return "cpu"
    if dev != "cuda":
        raise ACCLError(f"sweep: unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise ACCLError("sweep: no CUDA device is available (pass "
                        "device='cpu' to sweep the plain versions on the "
                        "CPU)")
    return "cuda"


def claim_watchdog(label: str, timeout_s: Optional[float] = None,
                   advice: str = ""):
    """A daemon timer that ends this process with exit code 3 if the
    card's claim (the first CUDA call) has not finished within
    ``ACCL_CUDA_CLAIM_TIMEOUT_S`` (default 60 s) — the caller cancels it
    (``.cancel()``) once the claim lands.  Returns the started timer, or
    None when the limit is 0."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("ACCL_CUDA_CLAIM_TIMEOUT_S", "60"))
    if timeout_s <= 0:
        return None

    def _fire():
        print(f"[{label}] CUDA claim exceeded ACCL_CUDA_CLAIM_TIMEOUT_S="
              f"{timeout_s:.0f}s — aborting the claim"
              f"{'; ' + advice if advice else ''}",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(timeout_s, _fire)
    timer.daemon = True
    timer.start()
    return timer


COLLECTIVES = ("sendrecv", "bcast", "scatter", "gather", "allgather",
               "reduce", "allreduce", "reduce_scatter", "alltoall")

#: the CSV columns of run_sweep
SWEEP_FIELDS = ("collective", "count", "bytes", "duration_us", "algbw_GBps",
                "busbw_GBps", "repetition")


@dataclass
class SweepConfig:
    collectives: tuple = COLLECTIVES
    count_pows: Iterable[int] = tuple(range(4, 20))  # 2^4 .. 2^19 elements
    dtype: str = "float32"
    repetitions: int = 3
    root: int = 0


_busbw_factor = _metrics.busbw_factor
_payload_factor = _metrics.payload_factor


def _resolve_dtype(name) -> np.dtype:
    """The host dtype of a sweep (accl_tpu/bench/sweep.py:125).  Host
    buffers are numpy arrays, and numpy has no bfloat16, which the JAX
    package takes from ml_dtypes: that name raises here."""
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ACCLError(f"sweep: dtype {name!r} has no numpy host "
                        f"representation") from e


def run_sweep(world, config: SweepConfig = SweepConfig(),
              writer: Optional[io.TextIOBase] = None) -> list:
    """Run the sweep: per collective and size one untimed warm-up call,
    then ``repetitions`` timed ones, each the slowest rank's host time.
    Returns the rows (optionally streamed as CSV) and sets the
    ``sweep/<coll>/busbw_peak_GBps`` gauges of the process registry."""
    rows: list = []
    csv_writer = None
    if writer is not None:
        csv_writer = csv.DictWriter(writer, fieldnames=list(SWEEP_FIELDS))
        # one header at the start of the stream, so several sweeps can
        # append to one CSV
        try:
            at_start = writer.tell() == 0
        except (OSError, AttributeError):
            at_start = True
        if at_start:
            csv_writer.writeheader()
    P = world.nranks
    dtype = _resolve_dtype(config.dtype)
    for coll in config.collectives:
        for pw in config.count_pows:
            count = 1 << pw
            _run_once(world, coll, count, dtype, config.root)
            for rep in range(config.repetitions):
                dur_s = _run_once(world, coll, count, dtype, config.root)
                nbytes = count * _payload_factor(coll, P) * dtype.itemsize
                algbw = nbytes / dur_s / 1e9 if dur_s > 0 else 0.0
                row = {
                    "collective": coll,
                    "count": count,
                    "bytes": nbytes,
                    "duration_us": round(dur_s * 1e6, 2),
                    "algbw_GBps": round(algbw, 4),
                    "busbw_GBps": round(algbw * _busbw_factor(coll, P), 4),
                    "repetition": rep,
                }
                rows.append(row)
                if csv_writer:
                    csv_writer.writerow(row)
    reg = _metrics.default_registry()
    best: dict = {}
    for row in rows:
        best[row["collective"]] = max(best.get(row["collective"], 0.0),
                                      row["busbw_GBps"])
    for coll, bw in best.items():
        reg.set_gauge(f"sweep/{coll}/busbw_peak_GBps", bw)
    return rows


# ---------------------------------------------------------------------------
# compression lanes: bandwidth against exactness per wire lane
# ---------------------------------------------------------------------------

#: the lossless baseline, the cast lanes, and the int8 block-scaled lane
#: without and with error feedback
COMPRESSION_LANES = ("lossless", "float16", "bfloat16", "int8", "int8_ef")


def _lane_compress_dtype(lane: str):
    return {"float16": DataType.float16, "bfloat16": DataType.bfloat16,
            "int8": DataType.int8, "int8_ef": None, "lossless": None}[lane]


def run_compression_sweep(world, collectives=("allreduce",
                                              "reduce_scatter"),
                          count_pows=range(12, 18), repetitions: int = 3,
                          writer: Optional[io.TextIOBase] = None,
                          log=None) -> list:
    """Per (lane, collective, size): best-of-reps busbw, and the error
    against the float64-accumulated sum (max abs error, max ULP
    distance).  The lanes run interleaved, every round measuring each
    lane once; ``int8_ef`` runs under an armed CompressionPolicy (error
    feedback is a policy property, not a per-call flag).  Each rank's
    operand is ``default_rng(rank).standard_normal``, as in the
    reference, drawn once per (collective, size)."""
    from ..arithconfig import CompressionPolicy

    P = world.nranks
    dtype = np.dtype(np.float32)
    rows: list = []
    csv_writer = None
    if writer is not None:
        csv_writer = csv.DictWriter(writer, fieldnames=[
            "lane", "collective", "count", "bytes", "duration_us",
            "algbw_GBps", "busbw_GBps", "max_abs_err", "max_ulp"])
        csv_writer.writeheader()

    def arm(lane):
        pol = None
        if lane == "int8_ef":
            pol = CompressionPolicy(dtype=DataType.int8, min_bytes=0,
                                    error_feedback=True)
        for a in world.accls:
            a.set_compression(pol)

    def body_factory(coll, count, lane, data):
        cd = _lane_compress_dtype(lane)

        def body(accl, rank):
            made = []
            try:
                src = accl.create_buffer_like(data[rank])
                made.append(src)
                dst = accl.create_buffer(count, dtype)
                made.append(dst)
                t0 = time.perf_counter()
                if coll == "allreduce":
                    accl.allreduce(src, dst, count, ReduceFunction.SUM,
                                   compress_dtype=cd)
                else:
                    accl.reduce_scatter(src, dst, count,
                                        ReduceFunction.SUM,
                                        compress_dtype=cd)
                dur = time.perf_counter() - t0
                dst.sync_from_device()
                return dur, dst.host.copy()
            finally:
                for buf in made:
                    buf.free()

        return body

    try:
        for coll in collectives:
            for pw in count_pows:
                count = 1 << pw
                n_in = count * (P if coll == "reduce_scatter" else 1)
                data = [np.random.default_rng(rank).standard_normal(n_in)
                        .astype(np.float32) for rank in range(P)]
                bodies = {}
                for lane in COMPRESSION_LANES:
                    arm(lane)
                    bodies[lane] = body_factory(coll, count, lane, data)
                    world.run(bodies[lane])  # warm-up
                best: dict = {}
                for _ in range(repetitions):
                    for lane in COMPRESSION_LANES:
                        arm(lane)
                        out = world.run(bodies[lane])
                        dur = max(d for d, _g in out)
                        if lane not in best or dur < best[lane][0]:
                            best[lane] = (dur, out)
                exact = np.sum(data, axis=0, dtype=np.float64).astype(
                    np.float32)
                for lane in COMPRESSION_LANES:
                    dur, out = best[lane]
                    max_err = max_ulp = 0.0
                    for rank, (_d, got) in enumerate(out):
                        exp = (exact if coll == "allreduce"
                               else exact.reshape(P, count)[rank])
                        err = np.abs(got.astype(np.float64)
                                     - exp.astype(np.float64))
                        max_err = max(max_err, float(err.max()))
                        ulp = err / np.spacing(np.abs(exp) + 1e-30)
                        max_ulp = max(max_ulp, float(ulp.max()))
                    nbytes = count * _payload_factor(coll, P) \
                        * dtype.itemsize
                    algbw = nbytes / dur / 1e9 if dur > 0 else 0.0
                    row = {
                        "lane": lane,
                        "collective": coll,
                        "count": count,
                        "bytes": nbytes,
                        "duration_us": round(dur * 1e6, 2),
                        "algbw_GBps": round(algbw, 4),
                        "busbw_GBps": round(
                            algbw * _busbw_factor(coll, P), 4),
                        "max_abs_err": float(f"{max_err:.6g}"),
                        "max_ulp": float(f"{max_ulp:.6g}"),
                    }
                    rows.append(row)
                    if csv_writer:
                        csv_writer.writerow(row)
                    if log:
                        log(f"  {lane:>9} {coll:<14} {count:>8} elems "
                            f"{row['busbw_GBps']:>8.3f} GB/s  "
                            f"err {row['max_abs_err']:.3g} "
                            f"ulp {row['max_ulp']:.3g}")
    finally:
        arm("lossless")
    return rows


# ---------------------------------------------------------------------------
# fused-overlap A/B lane: exposed wire against compute cover per cell
# ---------------------------------------------------------------------------

#: wire lanes the fused A/B measures: lossless fp32 and the int8
#: block-scaled lane fused into the chunk loop
FUSED_WIRE_LANES = ("fp32", "int8")

#: the CSV columns of run_fused_overlap_sweep
FUSED_FIELDS = ("wire", "collective", "count", "bytes", "mode",
                "duration_us", "busbw_GBps", "exposed_wire_fraction")


def _flight_marks() -> dict:
    """Per-recorder flight-ring seq watermark: records landed after this
    mark belong to the current cell."""
    from ..observability import flight as _flight

    return {id(r): (r, max((rec.seq for rec in r.records()), default=-1))
            for r in _flight.recorders()}


def _dumps_since(marks: dict) -> list:
    """Each marked recorder's dump, cut to the records landed since its
    mark."""
    docs = []
    for rec, mark in marks.values():
        d = rec.dump()
        d["records"] = [r for r in d["records"] if r["seq"] > mark]
        docs.append(d)
    return docs


def _exposed_since(marks: dict) -> Optional[float]:
    """The ``attribution.overlap`` exposed-wire fraction (exposed_us /
    wire_us summed over collectives) of the flight records landed since
    ``marks``, against the trace collector's current compute cover (host
    ``window:`` spans and device stamp slices).  None when nothing
    completed."""
    from ..observability import attribution as _attr
    from ..observability import flight as _flight
    from ..observability import trace as _trace

    docs = _dumps_since(marks)
    if not docs:
        return None
    try:
        rep = _attr.overlap(_flight.merge_flight_dumps(docs),
                            trace_doc=_trace.collector().to_perfetto())
    except (ACCLError, ValueError, KeyError):
        return None
    wire = sum(c["wire_us"] for c in rep["collectives"].values())
    exposed = sum(c["exposed_us"] for c in rep["collectives"].values())
    return round(exposed / wire, 4) if wire > 0 else None


def run_fused_overlap_sweep(world, collectives=("allreduce",
                                                "reduce_scatter"),
                            count_pows=range(14, 17),
                            repetitions: int = 3, mm_dim: int = 256,
                            mm_loops: int = 2,
                            writer: Optional[io.TextIOBase] = None,
                            log=None) -> list:
    """A/B the fused compute/communication lane against the sequential
    schedule, per (wire lane, collective, size) cell
    (accl_tpu/bench/sweep.py:429).

    Both arms run the SAME matmul workload and the SAME collective:

    - ``sequential`` — compute first, then issue the collective
      synchronously: zero cover, the wire is fully exposed;
    - ``fused`` — dispatch the chunked fused collective async
      (``fused=True, run_async=True``), run the matmul while it drains,
      then wait.

    The compute is a chain of ``mm_loops`` ``torch.matmul`` products of
    an [mm_dim, mm_dim] fp32 matrix on the world's device, followed by a
    synchronize inside the rank's ``window:mxu`` span, so the span holds
    the products and not their enqueue.  Columns per row: best-of-reps
    step time (the slowest rank's), busbw of the collective payload, and
    the measured ``attribution.overlap`` exposed-wire fraction over the
    cell's timed reps.  Sizes default to 64-256 KiB fp32 payloads.
    Tracing is turned on for the sweep and left on, as in the
    reference."""
    from ..observability import trace as _trace

    if not _trace.enabled():
        _trace.enable()
    P = world.nranks
    device = world.engine.device
    dtype = np.dtype(np.float32)
    rows: list = []
    csv_writer = None
    if writer is not None:
        csv_writer = csv.DictWriter(writer, fieldnames=list(FUSED_FIELDS))
        csv_writer.writeheader()

    def body_factory(coll, count, cd, mode):
        fused = mode == "fused"

        def compute(rank):
            # the fixed per-rank matmul chain both arms pay alike
            with _trace.traced_window("mxu", rank=rank):
                a = torch.full((mm_dim, mm_dim), (rank + 1) / mm_dim,
                               dtype=torch.float32, device=device)
                for _ in range(mm_loops):
                    a = torch.matmul(a, a) * (1.0 / mm_dim)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)

        def body(accl, rank):
            made = []

            def mk(factory, *a):
                buf = factory(*a)
                made.append(buf)
                return buf

            data = np.full(count * (P if coll == "reduce_scatter" else 1),
                           rank + 1, dtype)
            try:
                src = mk(accl.create_buffer_like, data)
                dst = mk(accl.create_buffer, count, dtype)

                def issue(run_async):
                    fn = (accl.allreduce if coll == "allreduce"
                          else accl.reduce_scatter)
                    return fn(src, dst, count, ReduceFunction.SUM,
                              compress_dtype=cd, run_async=run_async,
                              fused=fused)

                t0 = time.perf_counter()
                if mode == "sequential":
                    compute(rank)
                    issue(run_async=False)
                else:
                    req = issue(run_async=True)
                    compute(rank)
                    req.wait(60)
                return time.perf_counter() - t0
            finally:
                for buf in made:
                    buf.free()

        return body

    for coll in collectives:
        for pw in count_pows:
            count = 1 << pw
            for wire in FUSED_WIRE_LANES:
                cd = DataType.int8 if wire == "int8" else None
                for mode in ("sequential", "fused"):
                    body = body_factory(coll, count, cd, mode)
                    world.run(body)  # warm-up
                    # isolate the cell's cover windows and flight records
                    _trace.collector().clear()
                    marks = _flight_marks()
                    dur = min(max(world.run(body))
                              for _ in range(repetitions))
                    exposed = _exposed_since(marks)
                    nbytes = count * _payload_factor(coll, P) \
                        * dtype.itemsize
                    algbw = nbytes / dur / 1e9 if dur > 0 else 0.0
                    row = {
                        "wire": wire,
                        "collective": coll,
                        "count": count,
                        "bytes": nbytes,
                        "mode": mode,
                        "duration_us": round(dur * 1e6, 2),
                        "busbw_GBps": round(
                            algbw * _busbw_factor(coll, P), 4),
                        "exposed_wire_fraction": exposed,
                    }
                    rows.append(row)
                    if csv_writer:
                        csv_writer.writerow(row)
                    if log:
                        ex = "-" if exposed is None else f"{exposed:.3f}"
                        log(f"  {wire:>5} {coll:<14} {count:>8} elems "
                            f"{mode:>10} {row['duration_us']:>10.1f} us"
                            f"  exposed {ex}")
    return rows


def _run_once(world, coll: str, count: int, dtype, root: int,
              compress=None, fused=None) -> float:
    """One timed call of ``coll`` on every rank, host-staged; returns
    the slowest rank's seconds.  ``compress`` selects a wire dtype
    (DataType) where the collective takes one; ``fused`` opts allreduce,
    reduce_scatter and allgather into the chunked fused lane (None
    leaves the driver default)."""
    P = world.nranks

    def body(accl, rank):
        made = []

        def mk(factory, *a):
            buf = factory(*a)
            made.append(buf)
            return buf

        try:
            return _timed_body(accl, rank, mk)
        finally:
            for buf in made:
                buf.free()

    def _timed_body(accl, rank, mk):
        data = np.full(count, rank + 1, dtype)
        if coll == "sendrecv":
            src = mk(accl.create_buffer_like, data)
            dst = mk(accl.create_buffer, count, dtype)
            t0 = time.perf_counter()
            nxt, prv = (rank + 1) % P, (rank - 1) % P
            sreq = accl.send(src, count, nxt, tag=1, run_async=True,
                             compress_dtype=compress)
            accl.recv(dst, count, prv, tag=1, compress_dtype=compress)
            sreq.wait(60)
            return time.perf_counter() - t0
        if coll == "bcast":
            buf = mk(accl.create_buffer_like, data)
            t0 = time.perf_counter()
            accl.bcast(buf, count, root, compress_dtype=compress)
            return time.perf_counter() - t0
        if coll == "scatter":
            send = mk(accl.create_buffer_like, np.tile(data, P))
            recv = mk(accl.create_buffer, count, dtype)
            t0 = time.perf_counter()
            accl.scatter(send, recv, count, root, compress_dtype=compress)
            return time.perf_counter() - t0
        if coll == "gather":
            send = mk(accl.create_buffer_like, data)
            recv = mk(accl.create_buffer, count * P, dtype)
            t0 = time.perf_counter()
            accl.gather(send, recv, count, root, compress_dtype=compress)
            return time.perf_counter() - t0
        if coll == "allgather":
            send = mk(accl.create_buffer_like, data)
            recv = mk(accl.create_buffer, count * P, dtype)
            t0 = time.perf_counter()
            accl.allgather(send, recv, count, compress_dtype=compress,
                           fused=fused)
            return time.perf_counter() - t0
        if coll == "reduce":
            send = mk(accl.create_buffer_like, data)
            recv = mk(accl.create_buffer, count, dtype)
            t0 = time.perf_counter()
            accl.reduce(send, recv, count, root, ReduceFunction.SUM,
                        compress_dtype=compress)
            return time.perf_counter() - t0
        if coll == "allreduce":
            send = mk(accl.create_buffer_like, data)
            recv = mk(accl.create_buffer, count, dtype)
            t0 = time.perf_counter()
            accl.allreduce(send, recv, count, ReduceFunction.SUM,
                           compress_dtype=compress, fused=fused)
            return time.perf_counter() - t0
        if coll == "reduce_scatter":
            send = mk(accl.create_buffer_like, np.tile(data, P))
            recv = mk(accl.create_buffer, count, dtype)
            t0 = time.perf_counter()
            accl.reduce_scatter(send, recv, count, ReduceFunction.SUM,
                                compress_dtype=compress, fused=fused)
            return time.perf_counter() - t0
        if coll == "alltoall":
            send = mk(accl.create_buffer_like, np.tile(data, P))
            recv = mk(accl.create_buffer, count * P, dtype)
            t0 = time.perf_counter()
            accl.alltoall(send, recv, count)
            return time.perf_counter() - t0
        raise ValueError(f"unknown collective {coll!r}")

    return max(world.run(body))
