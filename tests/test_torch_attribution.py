"""The port's critical-path attribution (accl_tpu_torch.observability.
attribution) held to the JAX package's on identical inputs, exactly.

Inputs:
- synthetic per-rank flight dumps and a Perfetto doc made from a seed
  with numpy: per-rank clock offsets, a straggling rank, records that
  are not gang calls or did not complete, device windows and compute
  windows;
- one flight dump and one Perfetto doc recorded on
  ``CudaWorld(4, device="cpu")`` under ``ACCL_TRACE`` and
  ``ACCL_DEVICE_TRACE``: the ring lane (threshold 0), the fused lane,
  and per-rank ``window:`` compute spans.

Both go through both packages' ``estimate_clock_skew``, ``attribute``
(with and without the trace doc and its timeline), ``overlap``,
``device_overlap`` and ``render``.  Then one live check on the port
alone: rank 2 sleeps 20 ms before each call, and ``attribute`` names it
the dominant straggler (the assertion keeps a wide margin: the JAX
twins of such timing tests fail under load).  Each test runs under its
own SIGALRM limit.
"""
import copy
import signal
import time

import numpy as np
import pytest

from accl_tpu.observability import attribution as jattr
from accl_tpu.observability import flight as jflight
from accl_tpu_torch import CudaWorld, ReduceFunction
from accl_tpu_torch.bench import sweep as tsweep
from accl_tpu_torch.observability import attribution as tattr
from accl_tpu_torch.observability import flight as tflight
from accl_tpu_torch.observability import trace as ttrace
from accl_tpu_torch.ops import ring as tring

NR = 4
SEED = 15
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _synthetic(seed: int):
    """(per-rank dumps, Perfetto doc): 12 gang instances of two
    collectives on two comms over 4 ranks with clock offsets, rank 2 late
    in most, plus a non-gang record and an in-flight one per rank."""
    rng = np.random.default_rng(seed)
    offsets = [0, 12_345, -6_789, 40_000]
    dumps = [{"rank": r, "capacity": 256, "last_completed_seq": 0,
              "records": []} for r in range(NR)]
    events = []
    t = 1_000_000
    seqs = [0] * NR
    for i in range(12):
        coll = ("allreduce", "allgather")[i % 2]
        comm = i % 3 == 0
        count = 1024 if coll == "allreduce" else 256
        late = 2 if rng.uniform() < 0.8 else int(rng.integers(0, NR))
        arrivals = {r: t + int(rng.integers(0, 3_000)) for r in range(NR)}
        arrivals[late] += int(rng.integers(20_000, 60_000))
        ready = max(arrivals.values())
        done = ready + int(rng.integers(50_000, 90_000))
        for r in range(NR):
            off = offsets[r]
            sub = arrivals[r] - int(rng.integers(500, 2_000))
            dev0 = ready + 5_000 + int(rng.integers(0, 1_000))
            dev1 = done - 4_000
            rec = {"seq": seqs[r], "collective": coll, "comm": int(comm),
                   "tag": 0, "count": count, "dtype": "float32",
                   "nbytes": count * 4, "nranks": NR, "gang": True,
                   "state": "complete", "lane": "leader", "tenant": None,
                   "t_submit": sub + off, "t_queue": arrivals[r] + off,
                   "t_gang_ready": ready + off,
                   "t_dispatch": ready + 1_000 + off,
                   "t_complete": done + int(rng.integers(0, 500)) + off}
            seqs[r] += 1
            dumps[r]["records"].append(rec)
            ts = {"device_begin": dev0 + off, "device_end": dev1 + off}
            for tid in (1, 2):   # the same span on two tracks
                events.append({"ph": "X", "pid": r, "tid": tid,
                               "name": f"{coll} x", "ts": (sub + off) / 1e3,
                               "dur": (done - sub) / 1e3,
                               "args": {"timestamps_ns": ts}})
            # a compute window over part of the wire, a device xfer and
            # reduce slice on the rank's device track
            w0 = (ready + 2_000 + off) / 1e3
            events.append({"ph": "X", "pid": r, "tid": 3,
                           "name": "window:mxu", "ts": w0,
                           "dur": float(rng.uniform(5, 40)), "args": {}})
            x0 = (dev0 + off) / 1e3
            for phase, dt in (("xfer", 0.0), ("reduce", 3.0)):
                events.append({"ph": "X", "pid": r, "tid": 9,
                               "name": f"{coll} step",
                               "ts": x0 + dt + float(rng.uniform(0, 2)),
                               "dur": float(rng.uniform(2, 6)),
                               "args": {"device_track": True,
                                        "device_phase": phase}})
        t = done + 10_000
    for r in range(NR):
        base = {"comm": 0, "tag": 0, "count": 8, "dtype": "float32",
                "nbytes": 32, "nranks": NR, "lane": "local",
                "tenant": None, "t_queue": 0, "t_gang_ready": 0,
                "t_dispatch": 0, "age_us": 5.0}
        dumps[r]["records"].append(dict(
            base, seq=seqs[r], collective="send", gang=False,
            state="complete", t_submit=t, t_complete=t + 100))
        dumps[r]["records"].append(dict(
            base, seq=seqs[r] + 1, collective="allreduce", gang=True,
            state="dispatched", t_submit=t + 200, t_complete=0))
    events += [{"ph": "M", "name": "thread_name", "pid": r, "tid": 9,
                "args": {"name": f"device:{c}"}}
               for r in range(NR) for c in ("allreduce",)]
    return dumps, {"traceEvents": events}


def _both(fn_name, *args, **kw):
    """(port result, JAX result) of one function on deep copies."""
    got = getattr(tattr, fn_name)(*copy.deepcopy(args), **kw)
    want = getattr(jattr, fn_name)(*copy.deepcopy(args), **kw)
    return got, want


def _merged(dumps):
    return (tflight.merge_flight_dumps(copy.deepcopy(dumps)),
            jflight.merge_flight_dumps(copy.deepcopy(dumps)))


def _hold_reports(dumps, trace_doc):
    tdoc, jdoc = _merged(dumps)
    # the merge's own stamp is the only clock reading in it
    assert tdoc.pop("generated_ns") and jdoc.pop("generated_ns")
    assert tdoc == jdoc
    inst = tattr._gang_instances(tdoc)
    assert inst == jattr._gang_instances(jdoc)
    ranks = sorted(rd["rank"] for rd in tdoc["ranks"])
    assert tattr.estimate_clock_skew(inst, ranks) == \
        jattr.estimate_clock_skew(inst, ranks)
    for td in (None, trace_doc):
        for timeline in (False, True):
            got, want = _both("attribute", dumps, trace_doc=td,
                              timeline=timeline)
            assert got == want
            assert tattr.render(got) == jattr.render(want)
        got, want = _both("overlap", dumps, trace_doc=td)
        assert got == want
    got, want = _both("attribute", dumps, late_floor_us=1e9)
    assert got == want
    got, want = _both("device_overlap", trace_doc)
    assert got == want
    assert tattr.device_overlap(None) == jattr.device_overlap(None)
    return tattr.attribute(copy.deepcopy(dumps), trace_doc=trace_doc)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_synthetic_reports_match_reference(seed):
    dumps, trace_doc = _synthetic(seed)
    rep = _hold_reports(dumps, trace_doc)
    assert rep["gangs_analyzed"] == 12
    for c in rep["collectives"].values():
        assert 0.95 <= c["phase_coverage"] <= 1.05
    assert any(c["phases_us"]["reduce"] > 0
               for c in rep["collectives"].values())
    # offsets are recovered to within the completion jitter
    skew = rep["clock_skew_ns"]
    assert abs(skew["3"] - 40_000) < 1_000 and abs(skew["2"] + 6_789) < 1_000


def test_merged_doc_and_paths_are_accepted(tmp_path):
    dumps, _ = _synthetic(SEED)
    merged, _ = _merged(dumps)
    paths = []
    for d in dumps:
        p = tmp_path / f"r{d['rank']}.json"
        p.write_text(__import__("json").dumps(d))
        paths.append(str(p))
    a = tattr.attribute(merged)
    assert a == tattr.attribute(paths) == jattr.attribute(paths)
    assert tattr.attribute(copy.deepcopy(dumps[0]))["gangs_analyzed"] == 0


@pytest.fixture
def traced(monkeypatch):
    """ACCL_TRACE and ACCL_DEVICE_TRACE on for the test, the collector
    cleared before and after."""
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    tring._reset_device_trace_cache()
    col = ttrace.enable()
    col.clear()
    yield col
    ttrace.disable()
    col.clear()
    monkeypatch.delenv("ACCL_DEVICE_TRACE")
    tring._reset_device_trace_cache()


def _recorded(world, body) -> list:
    """The world's flight dumps, cut to what ``body`` recorded."""
    mine = [a.flight_recorder for a in world.accls]
    marks = {k: v for k, v in tsweep._flight_marks().items()
             if v[0] in mine}
    world.run(body, timeout=60)
    return tsweep._dumps_since(marks)


def test_world_recording_reports_match_reference(traced):
    n = 64 * NR

    def body(accl, rank):
        x = accl.create_buffer_like(
            np.arange(n, dtype=np.float32) * 0.5 + rank)
        y = accl.create_buffer(n, np.float32)
        for fused in (False, True, False):
            with ttrace.traced_window("mxu", rank=rank):
                sum(i * i for i in range(2000))
            accl.allreduce(x, y, n, ReduceFunction.SUM, fused=fused)
        accl.reduce_scatter(x, y, n // NR, ReduceFunction.SUM)
        accl.allgather(x, y, n // NR)

    with CudaWorld(NR, device="cpu") as w:
        w.engine.ring_threshold_bytes = 0
        dumps = _recorded(w, body)
    doc = traced.to_perfetto()
    assert len(dumps) == NR
    rep = _hold_reports(dumps, doc)
    assert rep["gangs_analyzed"] == 5
    for c in rep["collectives"].values():
        assert 0.95 <= c["phase_coverage"] <= 1.05
    dev = tattr.device_overlap(doc)["collectives"]
    # the sequential ring serializes every step; the fused lane's
    # overlapped clock covers all but its first transfers
    assert dev["reduce_scatter"]["exposed_fraction"] == 1.0
    assert dev["all_gather"]["exposed_fraction"] == 1.0
    assert dev["fused_allreduce"]["exposed_fraction"] < 1.0


def test_straggler_named_on_the_world():
    """Rank 2 sleeps 20 ms before each call: it arrives last by 20 ms
    against a spread of the other ranks' arrivals that is well under a
    millisecond on an idle host, so a wide margin stays under load."""
    n, calls, late_s = 64, 6, 0.02

    def body(accl, rank):
        x = accl.create_buffer_like(np.full(n, rank, np.float32))
        y = accl.create_buffer(n, np.float32)
        for _ in range(calls):
            if rank == 2:
                time.sleep(late_s)
            accl.allreduce(x, y, n, ReduceFunction.SUM)

    with CudaWorld(NR, device="cpu") as w:
        dumps = _recorded(w, body)
    rep = tattr.attribute(dumps)
    (row,) = rep["collectives"].values()
    assert row["episodes"] == calls
    assert 0.95 <= row["phase_coverage"] <= 1.05
    dom = row["dominant_straggler"]
    assert dom["rank"] == 2 and dom["share"] >= 0.5
    assert dom["mean_late_us"] >= late_s * 1e6 / 10
