"""The port's observability core (accl_tpu_torch.observability: metrics,
trace) on CudaWorld(4, device="cpu"), mirroring tests/test_observability.py,
and held to the JAX package's (accl_tpu.observability) on the same calls:
the bandwidth factors, the registry's counter keys and call and byte
counts, the link twin's bytes, the OpenMetrics text and the trace files
each side's validator and merger accept.

Tolerances: every count, key and byte total compared here is exact;
latencies and wait times are host-clock readings and are never compared
across the packages.  Each test runs under its own SIGALRM limit.
"""
import json
import signal

import numpy as np
import pytest

from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.constants import ReduceFunction as JReduce
from accl_tpu.constants import TuningKey as JTuningKey
from accl_tpu.observability import metrics as jmetrics
from accl_tpu.observability import trace as jtrace
from accl_tpu_torch import CudaWorld, DataType, ReduceFunction, TuningKey
from accl_tpu_torch.observability import flight as obs_flight
from accl_tpu_torch.observability import health as obs_health
from accl_tpu_torch.observability import metrics as obs_metrics
from accl_tpu_torch.observability import trace as obs_trace

COUNT = 64
NRANKS = 4
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


@pytest.fixture
def tracing():
    """Tracing on with a fresh collector; off again afterwards."""
    col = obs_trace.enable()
    col.clear()
    try:
        yield col
    finally:
        obs_trace.disable()
        col.clear()


def _world(nranks=NRANKS):
    return CudaWorld(nranks, device="cpu")


def _allreduce_all_ranks(world, reps=1):
    def fn(accl, rank):
        s = accl.create_buffer_like(
            np.arange(COUNT, dtype=np.float32) + rank)
        r = accl.create_buffer(COUNT, np.float32)
        for _ in range(reps):
            accl.allreduce(s, r, COUNT, ReduceFunction.SUM)
        return r.host.copy()

    return world.run(fn)


# ---------------------------------------------------------------------------
# spans on the gang engine
# ---------------------------------------------------------------------------
def test_span_ordering_invariants(tracing):
    with _world() as w:
        _allreduce_all_ranks(w, reps=2)
    spans = [s for s in tracing.spans() if s.name == "allreduce"]
    assert len(spans) == 2 * NRANKS
    for s in spans:
        ts = s.timestamps()
        for k in ("submit", "queue", "gang_ready", "dispatch",
                  "device_begin", "device_end", "complete"):
            assert ts[k] is not None, f"stage {k} missing on {s!r}"
        assert s.t_submit <= s.t_queue <= s.t_gang_ready
        assert s.t_gang_ready <= s.t_dispatch <= s.t_device_begin
        assert s.t_device_begin <= s.t_device_end <= s.t_complete
        assert s.lane in ("leader", "executor")
        assert s.dtype == "float32"
        assert s.nbytes == COUNT * 4


def test_multi_rank_gang_id_merge(tracing):
    with _world() as w:
        _allreduce_all_ranks(w, reps=3)
    by_gang = {}
    for s in tracing.spans():
        if s.name == "allreduce":
            by_gang.setdefault(s.gang_id, []).append(s)
    assert len(by_gang) == 3
    for gid, members in by_gang.items():
        assert gid is not None
        assert sorted(m.rank for m in members) == list(range(NRANKS))
        # one program per gang: the members share one device window
        assert len({(m.t_device_begin, m.t_device_end)
                    for m in members}) == 1


def test_local_and_p2p_lanes_stamped(tracing):
    with _world(2) as w:
        def fn(accl, rank):
            a = accl.create_buffer_like(np.arange(8, dtype=np.float32))
            b = accl.create_buffer(8, np.float32)
            accl.copy(a, b, 8)
            if rank == 0:
                accl.send(a, 8, dst=1)
            else:
                accl.recv(b, 8, src=0)

        w.run(fn, timeout=60)
    lanes = {s.name: s.lane for s in tracing.spans()}
    assert lanes == {"copy": "local", "send": "p2p", "recv": "p2p"}
    for s in tracing.spans():
        assert s.t_submit <= s.t_queue <= s.t_dispatch <= s.t_complete
        # an eager send completes at capture; the device window of p2p
        # ends at the recv's delivery, as in the reference
        if s.name != "send":
            assert s.t_device_begin <= s.t_device_end <= s.t_complete


def test_disabled_mode_zero_allocation(tracing):
    """Tracing, the flight recorder and the metrics off: the driver
    attaches nothing to a request and the registry sees no call."""
    obs_trace.disable()
    obs_flight.set_enabled(False)
    obs_metrics.set_enabled(False)
    reg = obs_metrics.default_registry()
    reg.reset()
    try:
        with _world() as w:
            assert all(a.flight_recorder is None for a in w.accls)

            def fn(accl, rank):
                s = accl.create_buffer_like(
                    np.arange(COUNT, dtype=np.float32))
                r = accl.create_buffer(COUNT, np.float32)
                req = accl.allreduce(s, r, COUNT, ReduceFunction.SUM)
                return (req.trace, req.flight, req.metric)

            assert w.run(fn, timeout=60) == [(None, None, None)] * NRANKS
    finally:
        obs_flight.set_enabled(True)
        obs_metrics.set_enabled(True)
    assert obs_trace.new_span("x") is None
    assert len(tracing) == 0
    assert reg.snapshot()["calls"] == {}


def test_link_twin_skipped_with_metrics_and_flight_off():
    """With the registry and the flight recorder both off the engine
    counts no gang for the link twin and no straggler wait; with either
    on, it counts again."""
    def traffic(w):
        return {k: sum(row[k] for rows in w.link_stats().values()
                       for row in rows)
                for k in ("tx_bytes", "rx_bytes", "seeks")}

    obs_flight.set_enabled(False)
    obs_metrics.set_enabled(False)
    try:
        with _world() as w:
            _allreduce_all_ranks(w, reps=2)
            assert traffic(w) == {"tx_bytes": 0, "rx_bytes": 0, "seeks": 0}
            obs_metrics.set_enabled(True)
            _allreduce_all_ranks(w)
            on = traffic(w)
    finally:
        obs_flight.set_enabled(True)
        obs_metrics.set_enabled(True)
    assert on["tx_bytes"] == on["rx_bytes"] > 0 and on["seeks"] > 0


# ---------------------------------------------------------------------------
# Perfetto export, marked windows, merge
# ---------------------------------------------------------------------------
def test_perfetto_json_schema(tracing, tmp_path):
    with _world() as w:
        _allreduce_all_ranks(w)
    path = tracing.dump(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.loads(f.read())
    events = doc["traceEvents"]
    assert events
    for ev in events:
        for key in ("ph", "ts", "pid", "tid"):
            assert key in ev, f"{key} missing from {ev}"
        assert ev["ph"] in ("X", "M")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    assert {ev["pid"] for ev in events if ev["ph"] == "X"} == \
        set(range(NRANKS))
    names = {ev["args"]["name"] for ev in events if ev["ph"] == "M"
             and ev["name"] == "thread_name"}
    assert any(n.startswith("lane:") for n in names)
    assert "queue" in names and "call" in names


def test_traced_window_and_merge_files(tracing, tmp_path):
    with obs_trace.traced_window("unit"):
        pass
    spans = [s for s in tracing.spans() if s.name == "window:unit"]
    assert len(spans) == 1 and spans[0].lane == "window"
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")

    def mk(path, ts):
        ev = {"name": "g", "ph": "X", "ts": ts, "dur": 5.0, "pid": 0,
              "tid": 0, "args": {"gang_id": 7}}
        with open(path, "w") as f:
            json.dump({"traceEvents": [ev]}, f)

    mk(p1, 100.0)
    mk(p2, 900.0)
    doc = obs_trace.merge_trace_files([p1, p2])
    assert [ev["ts"] for ev in doc["traceEvents"] if ev["ph"] == "X"] \
        == [100.0, 100.0]


def test_merge_dedupes_track_metadata(tmp_path):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"m{i}.json")
        events = [
            {"name": "process_name", "ph": "M", "ts": 0, "pid": 0,
             "tid": 0, "args": {"name": "rank 0"}},
            {"name": "thread_name", "ph": "M", "ts": 0, "pid": 0,
             "tid": 1, "args": {"name": "call"}},
            {"name": "g", "ph": "X", "ts": 10.0 + i, "dur": 2.0,
             "pid": 0, "tid": 1, "args": {"gang_id": 4}},
        ]
        with open(p, "w") as f:
            json.dump({"traceEvents": events}, f)
        paths.append(p)
    doc = obs_trace.merge_trace_files(paths)
    meta = [(ev["name"], ev["pid"], ev["tid"])
            for ev in doc["traceEvents"] if ev["ph"] == "M"]
    assert sorted(meta) == [("process_name", 0, 0), ("thread_name", 0, 1)]
    assert sum(1 for ev in doc["traceEvents"] if ev["ph"] == "X") == 3


def test_merge_salvages_a_torn_file(tmp_path):
    good = {"traceEvents": [
        {"name": "g", "ph": "X", "ts": 1.0, "dur": 1.0, "pid": 0, "tid": 0,
         "args": {"gang_id": 1}},
        {"name": "h", "ph": "X", "ts": 2.0, "dur": 1.0, "pid": 0, "tid": 0,
         "args": {}}]}
    text = json.dumps(good)
    torn = tmp_path / "torn.json"
    torn.write_text(text[:text.index('"h"') + 2])  # dies inside event 2
    doc = obs_trace.merge_trace_files([str(torn)])
    assert len(doc["traceEvents"]) == 1
    assert doc["torn_files"][0]["events_recovered"] == 1


def test_device_steps_render_as_perfetto_tracks(tracing):
    rows = [
        [0, 0, 0, 1, 2, 1, 3, 512, 512],
        [0, 1, 3, 4, 5, 1, 3, 512, 512],
        [1, 0, 0, 1, 2, 2, 0, 512, 512],
    ]
    obs_trace.record_device_steps("all_gather", np.array(rows, np.int32))
    assert len(tracing.device_records()) == 1
    assert tracing.device_link_bytes() == {(0, 1): 1024, (1, 2): 512}
    doc = tracing.to_perfetto()
    tracks = {(ev["pid"], ev["args"]["name"])
              for ev in doc["traceEvents"] if ev.get("ph") == "M"
              and str((ev.get("args") or {}).get("name", "")
                      ).startswith("device:")}
    assert {(0, "device:all_gather"), (1, "device:all_gather")} <= tracks
    dev = [ev for ev in doc["traceEvents"]
           if (ev.get("args") or {}).get("device_track")]
    assert len(dev) == 2 * len(rows)
    tracing.clear()
    assert tracing.device_records() == []


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_metrics_registry_reports_calls_hist_and_bandwidth():
    reg = obs_metrics.MetricsRegistry()
    for _ in range(10):
        reg.observe_call("allreduce", "float32", 1024, 100e3, nranks=4)
    reg.observe_call("allreduce", "float32", 1024, 100e3, nranks=4,
                     ok=False)
    snap = reg.snapshot()
    (key,) = snap["calls"].keys()
    st = snap["calls"][key]
    assert st["calls"] == 11 and st["errors"] == 1
    assert st["latency_us"]["avg"] == pytest.approx(100.0)
    assert st["hist_us"]["le_256"] == 10
    assert sum(st["hist_us"].values()) == 10
    assert st["algbw_GBps"] == pytest.approx(1024 / 100e3, abs=1e-4)
    assert st["busbw_GBps"] == pytest.approx(1024 / 100e3 * 1.5, abs=1e-4)
    assert "allreduce" in reg.to_text()
    assert json.loads(reg.to_json())["calls"][key]["calls"] == 11


def test_registry_series_cap_counts_dropped_series():
    reg = obs_metrics.MetricsRegistry(max_series=16)
    for i in range(20):
        reg.inc(f"c{i}")
    snap = reg.snapshot()
    assert len([k for k in snap["counters"] if k.startswith("c")]) == 16
    assert snap["counters"]["metrics/dropped_series"] == 4


def test_registry_and_gang_ids_under_thread_stress():
    """More threads than cores, a short switch interval: no update of the
    registry is lost, and every thread's Nth occurrence of one key gets
    one gang id (the rank threads of one world share both)."""
    import sys
    import threading

    reg = obs_metrics.MetricsRegistry()
    col = obs_trace.TraceCollector(capacity=1024)
    nthreads, per = 16, 200
    ids = [[None] * per for _ in range(nthreads)]

    def work(r):
        for i in range(per):
            reg.inc("stress")
            reg.observe_call("allreduce", "float32", 64, 10.0,
                             nranks=nthreads)
            ids[r][i] = col.gang_id_for(("allreduce", 0, 0), r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert reg.counter("stress") == nthreads * per
    (calls,) = reg.snapshot()["calls"].values()
    assert calls["calls"] == nthreads * per
    for i in range(per):
        assert len({ids[r][i] for r in range(nthreads)}) == 1
    assert len({ids[0][i] for i in range(per)}) == per


def test_driver_publishes_metrics_end_to_end():
    reg = obs_metrics.default_registry()
    reg.reset()
    with _world() as w:
        _allreduce_all_ranks(w, reps=2)
        accl = w.accls[0]
        snap = accl.metrics()
        text = accl.dump_metrics()
        js = json.loads(accl.dump_metrics(as_json=True))
    rows = [v for v in snap["calls"].values()
            if v["collective"] == "allreduce"]
    assert rows and rows[0]["calls"] == 2 * NRANKS
    assert rows[0]["dtype"] == "float32" and rows[0]["nranks"] == NRANKS
    assert rows[0]["algbw_GBps"] > 0
    assert sum(rows[0]["hist_us"].values()) == 2 * NRANKS
    assert "allreduce" in text and js["calls"]
    assert snap["counters"]["engine/leader_dispatches"] \
        + snap["counters"]["engine/executor_dispatches"] == 2
    reg.reset()


def test_engine_stats_has_the_reference_key_set():
    with TpuWorld(2) as tw, _world(2) as cw:
        jkeys = set(tw.devices[0].engine_stats())
        stats = cw.devices[0].engine_stats()
        assert set(stats) == jkeys
        before = dict(cw.engine.stats)
        _allreduce_all_ranks(cw)
        after = dict(cw.engine.stats)
    assert set(before) >= {"leader_dispatches", "executor_dispatches",
                           "batches", "batched_gangs"}
    assert (after["leader_dispatches"] + after["executor_dispatches"]) \
        == before["leader_dispatches"] + before["executor_dispatches"] + 1
    # plans and batched dispatch are not ported: their fields read 0
    for k in ("plans_live", "plan_ring_refs", "plan_ring_generation",
              "plan_ring_replays", "batches", "batched_gangs"):
        assert stats[k] == 0


def test_leader_dispatch_switch(monkeypatch):
    monkeypatch.setenv("ACCL_LEADER_DISPATCH", "0")
    with _world(2) as w:
        assert w.engine.leader_dispatch is False
        _allreduce_all_ranks(w, reps=2)
        assert w.engine.stats["leader_dispatches"] == 0
        assert w.engine.stats["executor_dispatches"] == 2
    monkeypatch.delenv("ACCL_LEADER_DISPATCH")
    with _world(2) as w:
        assert w.engine.leader_dispatch is True


# ---------------------------------------------------------------------------
# held to the JAX package
# ---------------------------------------------------------------------------
COLLS = ("sendrecv", "bcast", "scatter", "gather", "allgather", "reduce",
         "allreduce", "reduce_scatter", "alltoall")


@pytest.mark.parametrize("P", range(1, 17))
def test_factors_match_reference(P):
    for coll in COLLS:
        assert obs_metrics.payload_factor(coll, P) == \
            jmetrics.payload_factor(coll, P)
        assert obs_metrics.busbw_factor(coll, P) == \
            jmetrics.busbw_factor(coll, P)
    for nbytes in (0, 1, P, 1023, 1024, 1025, P << 20, (P << 30) + 1):
        assert obs_metrics.size_bucket(nbytes) == \
            jmetrics.size_bucket(nbytes)


def test_schema_tables_match_reference():
    assert obs_metrics.METRIC_HELP.keys() == jmetrics.METRIC_HELP.keys()
    assert obs_metrics.METRIC_HELP_PREFIXES.keys() == \
        jmetrics.METRIC_HELP_PREFIXES.keys()
    assert obs_metrics.LATENCY_BUCKETS_US == jmetrics.LATENCY_BUCKETS_US
    assert obs_trace.DEVICE_TRACE_FIELDS == jtrace.DEVICE_TRACE_FIELDS
    assert obs_health.HEALTH_NAMES == ("ok", "degraded", "hung", "aborted",
                                       "recovering", "slow")


THRESHOLD = 1024      # bytes: the ring lane from 256 fp32 elements
SIZES = (32, 512)     # one count below the threshold and one above


def _call_sequence(accl, rank, red, threshold_key):
    """allreduce, allgather, reduce_scatter and bcast at both sizes,
    synchronous and host-staged; identical on both packages."""
    accl.set_tuning(int(threshold_key), THRESHOLD)
    P = NRANKS
    for n in SIZES:
        x = accl.create_buffer_like(
            np.random.default_rng(rank + n).standard_normal(n * P)
            .astype(np.float32))
        y = accl.create_buffer(n * P, np.float32)
        accl.allreduce(x, y, n, red)
        accl.allgather(x, y, n)
        accl.reduce_scatter(x, y, n, red)
        accl.bcast(x, n, root=1)


@pytest.fixture(scope="module")
def sequence_snapshots():
    """Both packages' registry snapshots and link rows after the same
    call sequence, with the watchdogs off (their scan counters tick on
    the host clock)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ACCL_WATCHDOG_TIMEOUT", "0")
    jreg, treg = jmetrics.default_registry(), obs_metrics.default_registry()
    jreg.reset()
    treg.reset()
    try:
        with TpuWorld(NRANKS) as tw, _world() as cw:
            tw.run(lambda a, r: _call_sequence(a, r, JReduce.SUM,
                                               JTuningKey.RING_THRESHOLD_BYTES))
            cw.run(lambda a, r: _call_sequence(
                a, r, ReduceFunction.SUM, TuningKey.RING_THRESHOLD_BYTES),
                timeout=120)
            out = {"jax": (tw.accls[0].metrics(), tw.link_stats(),
                           jreg.to_openmetrics()),
                   "port": (cw.accls[0].metrics(), cw.link_stats(),
                            treg.to_openmetrics())}
    finally:
        mp.undo()
    yield out
    jreg.reset()
    treg.reset()


def test_registry_matches_reference_for_one_call_sequence(
        sequence_snapshots):
    jsnap = sequence_snapshots["jax"][0]
    tsnap = sequence_snapshots["port"][0]
    # counter keys: the engine's dispatch-lane counters on both sides;
    # no key is one side's alone
    assert set(tsnap["counters"]) == set(jsnap["counters"])
    assert set(tsnap["calls"]) == set(jsnap["calls"])
    assert len(tsnap["calls"]) == 2 * 4
    for key, j in jsnap["calls"].items():
        t = tsnap["calls"][key]
        for field in ("collective", "dtype", "size_bucket", "calls",
                      "errors", "nranks", "bytes"):
            assert t[field] == j[field], (key, field)
        assert sum(t["hist_us"].values()) == sum(j["hist_us"].values())
    # gangs dispatched: 8 collectives, by whichever lane took each
    for snap in (jsnap, tsnap):
        c = snap["counters"]
        assert c["engine/leader_dispatches"] \
            + c["engine/executor_dispatches"] \
            + c.get("engine/batched_gangs", 0) == 8


def test_link_twin_matches_reference(sequence_snapshots):
    """The same schedule bytes per (rank, comm, peer).  seeks and
    seek_wait_ns count the gang-assembly wait on the host clock (which
    rank arrives last), so they are left out."""
    jlinks = sequence_snapshots["jax"][1]
    tlinks = sequence_snapshots["port"][1]
    timing = ("seeks", "seek_wait_ns")

    def rows(links):
        return {(r, row["comm"], row["peer"]):
                {k: v for k, v in row.items() if k not in timing}
                for r, rs in links.items() for row in rs}

    j, t = rows(jlinks), rows(tlinks)
    assert {k: v for k, v in t.items() if any(v[f] for f in v
                                              if f not in ("comm", "peer"))} \
        == {k: v for k, v in j.items() if any(v[f] for f in v
                                              if f not in ("comm", "peer"))}


def test_openmetrics_cross_validates(sequence_snapshots):
    jtext = sequence_snapshots["jax"][2]
    ttext = sequence_snapshots["port"][2]
    assert jmetrics.validate_openmetrics(ttext) == []
    assert obs_metrics.validate_openmetrics(jtext) == []
    assert obs_metrics.validate_openmetrics(ttext) == []
    assert "accl_collective_calls_total" in ttext
    # both expose the same families
    fams = [{ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ")} for text in (jtext, ttext)]
    assert fams[0] == fams[1]


def test_compressed_wire_bytes_match_reference():
    mp = pytest.MonkeyPatch()
    mp.setenv("ACCL_WATCHDOG_TIMEOUT", "0")
    n = 256

    def body(accl, rank, i8):
        x = accl.create_buffer_like(np.full(n, rank + 1.0, np.float32))
        y = accl.create_buffer(n, np.float32)
        accl.allreduce(x, y, n, compress_dtype=i8)

    try:
        from accl_tpu.constants import DataType as JDataType

        with TpuWorld(NRANKS) as tw, _world() as cw:
            tw.run(lambda a, r: body(a, r, JDataType.int8))
            cw.run(lambda a, r: body(a, r, DataType.int8), timeout=60)
            jc = tw.engine.stats
            tc = cw.engine.stats
            jl, tl = tw.link_stats(), cw.link_stats()
    finally:
        mp.undo()
    for k in ("compressed_tx_bytes", "compressed_tx_logical_bytes"):
        assert tc[k] == jc[k] > 0
    # rows that carry traffic (a row of only gang-assembly wait exists
    # where a rank happened to arrive last)
    def comp(links):
        return {(r, row["peer"]): row["comp_tx_bytes"]
                for r in range(NRANKS) for row in links[r]
                if row["tx_bytes"] or row["rx_bytes"]}

    assert comp(tl) == comp(jl)
    assert sum(comp(tl).values()) > 0


def test_trace_files_cross_merge(tracing, tmp_path):
    jcol = jtrace.enable()
    jcol.clear()
    try:
        with TpuWorld(2) as tw, _world(2) as cw:
            _allreduce_all_ranks(tw)
            _allreduce_all_ranks(cw)
        jpath = jcol.dump(str(tmp_path / "jax.json"))
        tpath = tracing.dump(str(tmp_path / "port.json"))
    finally:
        jtrace.disable()
        jcol.clear()
    n_x = [sum(1 for ev in json.load(open(p))["traceEvents"]
               if ev["ph"] == "X") for p in (tpath, jpath)]
    for merge in (jtrace.merge_trace_files, obs_trace.merge_trace_files):
        doc = merge([tpath, jpath])
        xs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
        assert len(xs) == sum(n_x) and "torn_files" not in doc
        meta = [(ev["name"], ev["pid"], ev["tid"])
                for ev in doc["traceEvents"] if ev["ph"] == "M"]
        assert len(meta) == len(set(meta))
        assert {ev["args"].get("lane") for ev in xs} >= {"leader"}


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_world_close_stops_watchdog_and_exporter(monkeypatch):
    obs_health.stop_exporter()
    monkeypatch.setenv("ACCL_METRICS_PORT", "0")
    w = _world(2)
    try:
        assert obs_health.exporter_port() is not None
        wd = w.engine._watchdog
        assert wd is not None and wd._thread is not None
    finally:
        w.close()
    assert obs_health.exporter_port() is None
    assert w.engine._watchdog is None
    assert not wd._thread
