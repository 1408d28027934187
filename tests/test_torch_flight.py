"""The port's flight recorder, hang watchdog and health/OpenMetrics
surface (accl_tpu_torch.observability: flight, health) on
CudaWorld(device="cpu"), mirroring the TpuWorld and analyzer tests of
tests/test_flight_recorder.py, and held to the JAX package: the dump
schema keys, and the desync, hang and straggler analyses of the same
dumps, which must come out equal (exact comparison of the analysis
documents).  Each test runs under its own SIGALRM limit.
"""
import gc
import json
import signal
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from accl_tpu.observability import flight as jflight
from accl_tpu_torch import ACCLError, CudaWorld, ReduceFunction
from accl_tpu_torch.observability import flight as obs_flight
from accl_tpu_torch.observability import health as obs_health
from accl_tpu_torch.observability import metrics as obs_metrics
from accl_tpu_torch.observability.trace import now_ns

COUNT = 64
NRANKS = 4
TEST_LIMIT_S = 90


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _world(nranks=NRANKS):
    return CudaWorld(nranks, device="cpu")


def _allreduce_all(world, reps=1):
    def fn(accl, rank):
        s = accl.create_buffer_like(
            np.arange(COUNT, dtype=np.float32) + rank)
        r = accl.create_buffer(COUNT, np.float32)
        for _ in range(reps):
            accl.allreduce(s, r, COUNT, ReduceFunction.SUM)
        return r.host.copy()

    return world.run(fn, timeout=60)


# ---------------------------------------------------------------------------
# record lifecycle on the gang engine
# ---------------------------------------------------------------------------
def test_flight_records_gang_lifecycle():
    with _world() as w:
        _allreduce_all(w, reps=2)
        for accl in w.accls:
            recs = [r for r in accl.flight_recorder.records()
                    if r.collective == "allreduce"]
            assert len(recs) == 2
            for rec in recs:
                assert rec.gang and not rec.in_flight
                assert rec.state == obs_flight.S_COMPLETE
                assert rec.lane in ("leader", "executor")
                assert rec.dtype == "float32"
                assert rec.nbytes == COUNT * 4
                assert (rec.t_submit <= rec.t_queue <= rec.t_gang_ready
                        <= rec.t_dispatch <= rec.t_complete)
            seqs = [r.seq for r in recs]
            assert seqs == sorted(seqs)
            assert accl.flight_recorder.last_completed_seq >= seqs[-1]


def test_flight_records_local_and_p2p_lanes():
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
        lanes = {(a.rank, r.collective): (r.lane, r.gang)
                 for a in w.accls for r in a.flight_recorder.records()}
    assert lanes == {(0, "copy"): ("local", False),
                     (1, "copy"): ("local", False),
                     (0, "send"): ("p2p", False),
                     (1, "recv"): ("p2p", False)}


def test_flight_ring_is_bounded_and_disableable():
    rec = obs_flight.FlightRecorder(rank=0, capacity=4)
    for i in range(10):
        r = rec.new_record(i, "allreduce", 0, 0, "float32", 8, 32, 2,
                           True, now_ns())
        r.finish(0, now_ns())
    assert len(rec) == 4
    assert [r.seq for r in rec.records()] == [6, 7, 8, 9]
    assert rec.last_completed_seq == 9
    obs_flight.set_enabled(False)
    try:
        with _world(2) as w:
            _allreduce_all(w)
            assert all(a.flight_recorder is None for a in w.accls)
            with pytest.raises(ACCLError, match="flight recorder is off"):
                w.accls[0].dump_flight_recorder()
    finally:
        obs_flight.set_enabled(True)


def test_dump_schema_matches_reference(tmp_path):
    assert obs_flight.RECORD_SCHEMA_KEYS == jflight.RECORD_SCHEMA_KEYS
    assert obs_flight.STATE_NAMES == jflight.STATE_NAMES
    # the merged dump reads every live recorder of the process: collect
    # closed worlds of earlier tests in this worker, whose recorders wait
    # on the cycle collector, so their ranks do not mix into this world's
    gc.collect()
    with _world(2) as w:
        _allreduce_all(w)
        doc = w.accls[0].dump_flight_recorder(path=str(tmp_path / "r0.json"))
        assert doc["rank"] == 0
        for rec in doc["records"]:
            assert set(rec) == set(jflight.RECORD_SCHEMA_KEYS)
        with open(tmp_path / "r0.json") as f:
            assert json.load(f)["rank"] == 0
        merged = w.accls[0].dump_flight_recorder(merged=True)
        assert merged["nranks"] >= 2 and merged["analysis"]["ok"]
    # the reference's analyzer reads the port's dump
    assert jflight.merge_flight_dumps(
        [str(tmp_path / "r0.json")])["analysis"]["ok"]


def test_flight_forensics_sources_armed():
    with _world(2) as w:
        sources = w.accls[0].flight_recorder._forensics_sources
        assert set(sources) == {"link_rows", "engine_stats",
                                "gang_assembly"}
        for fn in sources.values():
            fn()


# ---------------------------------------------------------------------------
# timeouts name their flight record
# ---------------------------------------------------------------------------
def test_check_on_in_flight_request_embeds_flight_record():
    from accl_tpu_torch.request import Request

    recr = obs_flight.FlightRecorder(rank=3)
    req = Request("allreduce(SUM)")
    req.flight = recr.new_record(req.id, "allreduce", 0, 0, "float32",
                                 64, 256, 4, True, now_ns())
    req.flight.lane = "executor"
    with pytest.raises(ACCLError) as ei:
        req.check()
    msg = str(ei.value)
    assert "seq=0" in msg and "state=submitted" in msg \
        and "lane=executor" in msg and "age=" in msg


def test_driver_timeout_error_embeds_flight_record():
    with _world(2) as w:
        def fn(accl, rank):
            buf = accl.create_buffer(COUNT, np.float32)
            if rank == 0:
                accl.call_timeout_s = 0.2
                with pytest.raises(ACCLError) as ei:
                    accl.recv(buf, COUNT, src=1)
                accl.call_timeout_s = 60.0
                return str(ei.value)
            time.sleep(0.5)
            src = accl.create_buffer_like(np.arange(COUNT, dtype=np.float32))
            accl.send(src, COUNT, dst=0)
            return None

        msg = w.run(fn, timeout=60)[0]
    assert "timed out" in msg and "[flight:" in msg and "recv" in msg \
        and "lane=p2p" in msg


def test_wait_default_configurable_via_env(monkeypatch):
    from accl_tpu_torch import request as request_mod

    monkeypatch.setenv("ACCL_DEFAULT_TIMEOUT", "2000000")
    assert request_mod.default_wait_timeout_s() == pytest.approx(61.0)
    req = request_mod.Request("never")
    assert req.wait(timeout=0.01) is False


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def test_watchdog_fires_and_names_missing_rank(tmp_path):
    reg = obs_metrics.MetricsRegistry()
    with _world() as w:
        wd = obs_health.Watchdog(
            [a.flight_recorder for a in w.accls], timeout_s=0.3,
            introspect=w.engine.gang_assembly_snapshot, registry=reg,
            dump_path=str(tmp_path / "wd.json")).start()
        try:
            bufs = {}

            def setup(accl, rank):
                s = accl.create_buffer_like(
                    np.arange(COUNT, dtype=np.float32) + rank)
                bufs[rank] = (s, accl.create_buffer(COUNT, np.float32))

            w.run(setup, timeout=60)
            reqs = {}

            def issue(accl, rank):
                if rank == 0:
                    return None  # the withheld member
                s, r = bufs[rank]
                reqs[rank] = accl.allreduce(s, r, COUNT, ReduceFunction.SUM,
                                            run_async=True)

            w.run(issue, timeout=60)
            deadline = time.time() + 15
            while wd.last_report is None and time.time() < deadline:
                time.sleep(0.02)
            assert wd.last_report is not None, "watchdog never fired"
            (hang,) = wd.last_report["analysis"]["hangs"]
            assert hang["collective"] == "allreduce"
            assert hang["arrived"] == [1, 2, 3] and hang["missing"] == [0]
            assert hang["missing_blocked_on"]["0"] is None
            (gang,) = wd.last_report["watchdog"]["engine_gangs"]
            assert gang["arrived"] == [1, 2, 3] and gang["missing"] == [0]
            assert (tmp_path / "wd.json").exists()
            snap = reg.snapshot()
            assert snap["gauges"]["accl_health"] == obs_health.HEALTH_HUNG
            assert snap["counters"]["watchdog/fires"] >= 1

            def join(accl, rank):
                if rank == 0:
                    s, r = bufs[rank]
                    accl.allreduce(s, r, COUNT, ReduceFunction.SUM)

            w.run(join, timeout=60)
            for rank in (1, 2, 3):
                assert reqs[rank].wait(60)
                reqs[rank].check()
            deadline = time.time() + 10
            while time.time() < deadline:
                if reg.snapshot()["gauges"]["accl_health"] \
                        == obs_health.HEALTH_OK:
                    break
                time.sleep(0.05)
            assert reg.snapshot()["gauges"]["accl_health"] \
                == obs_health.HEALTH_OK
        finally:
            wd.stop()


def test_watchdog_degraded_after_engine_error():
    recr = obs_flight.FlightRecorder(rank=0)
    rec = recr.new_record(0, "allreduce", 0, 0, "float32", 8, 32, 2,
                          True, now_ns())
    rec.finish(5, now_ns())
    reg = obs_metrics.MetricsRegistry()
    wd = obs_health.Watchdog([recr], timeout_s=10, registry=reg,
                             dump_path="")
    assert wd.check() is None
    assert reg.snapshot()["gauges"]["accl_health"] \
        == obs_health.HEALTH_DEGRADED
    wd.stop()


def test_watchdog_direct_check_reports_stuck_record(tmp_path):
    recr = obs_flight.FlightRecorder(rank=1)
    recr.new_record(0, "bcast", 0, 5, "float32", 8, 32, 2, True,
                    now_ns() - int(1e9))
    reg = obs_metrics.MetricsRegistry()
    wd = obs_health.Watchdog([recr], timeout_s=0.2, registry=reg,
                             dump_path=str(tmp_path / "d.json"))
    report = wd.check()
    assert report is not None
    assert report["watchdog"]["stuck_records"][0]["collective"] == "bcast"
    assert reg.snapshot()["gauges"]["accl_health"] \
        == obs_health.HEALTH_HUNG
    assert wd.check() is None  # one fire per episode
    wd.stop()


def test_world_watchdog_follows_env(monkeypatch):
    monkeypatch.setenv("ACCL_WATCHDOG_TIMEOUT", "0")
    with _world(2) as w:
        assert not w.engine._watchdog.enabled
        assert w.engine._watchdog._thread is None
    monkeypatch.setenv("ACCL_WATCHDOG_TIMEOUT", "7")
    with _world(2) as w:
        wd = w.engine._watchdog
        assert wd.timeout_s == 7 and wd._thread.is_alive()
    assert not wd._thread


def test_gang_assembly_introspection():
    with _world(2) as w:
        s0 = w.accls[0].create_buffer_like(np.arange(COUNT, dtype=np.float32))
        r0 = w.accls[0].create_buffer(COUNT, np.float32)
        req0 = w.accls[0].allreduce(s0, r0, COUNT, ReduceFunction.SUM,
                                    run_async=True)
        snap = [g for g in w.engine.gang_assembly_snapshot()
                if g.get("kind") == "collective"]
        assert snap and snap[0]["collective"] == "allreduce"
        assert snap[0]["arrived"] == [0] and snap[0]["missing"] == [1]
        view = w.devices[1].gang_assembly_snapshot()
        assert [{k: v for k, v in g.items() if k != "oldest_age_us"}
                for g in view] == [
            {k: v for k, v in g.items() if k != "oldest_age_us"}
            for g in w.engine.gang_assembly_snapshot()]
        s1 = w.accls[1].create_buffer_like(np.arange(COUNT, dtype=np.float32))
        r1 = w.accls[1].create_buffer(COUNT, np.float32)
        w.accls[1].allreduce(s1, r1, COUNT, ReduceFunction.SUM)
        assert req0.wait(60)
        req0.check()
        assert not [g for g in w.engine.gang_assembly_snapshot()
                    if g.get("kind") == "collective"]


def test_gang_assembly_shows_unmatched_p2p():
    with _world(2) as w:
        b = w.accls[1].create_buffer(COUNT, np.float32)
        req = w.accls[1].recv(b, COUNT, src=0, run_async=True)
        (entry,) = w.engine.gang_assembly_snapshot()
        assert entry == {"kind": "recv", "comm": 0, "src": 0, "dst": 1,
                         "tag": entry["tag"]}
        a = w.accls[0].create_buffer_like(np.arange(COUNT, dtype=np.float32))
        w.accls[0].send(a, COUNT, dst=1)
        assert req.wait(60)


# ---------------------------------------------------------------------------
# the analyzers, held to the reference's
# ---------------------------------------------------------------------------
def _mk_recorder(mod, rank, calls, inflight=(), capacity=None):
    """calls: (collective, comm, tag, count) completed in order;
    inflight: the same shape, left submitted.  One fixed clock, so the
    two packages' dumps carry the same numbers."""
    recr = mod.FlightRecorder(rank=rank, capacity=capacity)
    t = 10 ** 9
    for i, (coll, comm, tag, count) in enumerate(calls):
        rec = recr.new_record(i, coll, comm, tag, "float32", count,
                              count * 4, 2, True, t)
        rec.finish(0, t + 1000)
    for coll, comm, tag, count in inflight:
        rec = recr.new_record(99, coll, comm, tag, "float32", count,
                              count * 4, 2, True, t)
        rec.t_complete = t + 5000  # freezes age_us at 5 us
    return recr


SCENARIOS = {
    "order_desync": [
        (0, [("allreduce", 0, -1, 64), ("bcast", 0, -1, 64)], ()),
        (1, [("bcast", 0, -1, 64), ("allreduce", 0, -1, 64)], ())],
    "shape_desync_after_matching_prefix": [
        (0, [("allreduce", 0, -1, 64), ("allgather", 0, -1, 32)], ()),
        (1, [("allreduce", 0, -1, 64), ("allgather", 0, -1, 16)], ())],
    "hang_with_cross_blocked_rank": [
        (0, [], [("bcast", 0, -1, 64)]),
        (1, [], [("allreduce", 0, -1, 64)]),
        (2, [], [("allreduce", 0, -1, 64)])],
    "stragglers": [
        (0, [("allreduce", 0, -1, 64)] * 3, ()),
        (1, [("allreduce", 0, -1, 64)], ())],
    "healthy": [
        (0, [("allreduce", 0, -1, 64), ("bcast", 3, 2, 8)], ()),
        (1, [("allreduce", 0, -1, 64), ("bcast", 3, 2, 8)], ())],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_analyzer_matches_reference(name):
    docs = {}
    for mod in (obs_flight, jflight):
        dumps = [_mk_recorder(mod, r, calls, inflight).dump()
                 for r, calls, inflight in SCENARIOS[name]]
        docs[mod] = mod.merge_flight_dumps(json.loads(json.dumps(dumps)))
    assert docs[obs_flight]["analysis"] == docs[jflight]["analysis"]
    assert docs[obs_flight]["ranks"] == docs[jflight]["ranks"]
    expect_ok = name in ("healthy", "stragglers")
    assert docs[obs_flight]["analysis"]["ok"] is expect_ok


def test_analyzer_skips_order_analysis_on_wrapped_rings():
    docs = {}
    for mod in (obs_flight, jflight):
        a = _mk_recorder(mod, 0, [("allreduce", 0, -1, 64),
                                  ("bcast", 0, -1, 64),
                                  ("allgather", 0, -1, 64)], capacity=2)
        b = _mk_recorder(mod, 1, [("allreduce", 0, -1, 64),
                                  ("bcast", 0, -1, 64),
                                  ("allgather", 0, -1, 64)])
        docs[mod] = mod.merge_flight_dumps([a.dump(), b.dump()])
    assert docs[obs_flight]["analysis"] == docs[jflight]["analysis"]
    assert docs[obs_flight]["analysis"]["truncated_comms"] == [0]


def test_first_divergence_matches_reference():
    seqs = {0: [1, 2, 3], 1: [1, 2, 4], 2: [1, 2]}
    assert obs_flight.first_divergence(seqs, lambda x: x) == \
        jflight.first_divergence(seqs, lambda x: x) == \
        {"index": 2, "per_rank": {0: 3, 1: 4, 2: None}}


def test_merge_accepts_paths_merged_docs_and_torn_dumps(tmp_path):
    a = _mk_recorder(obs_flight, 0, [("allreduce", 0, -1, 64)])
    b = _mk_recorder(obs_flight, 1, [("allreduce", 0, -1, 64)])
    pa = tmp_path / "a.json"
    pa.write_text(json.dumps(a.dump()))
    doc = obs_flight.merge_flight_dumps(
        [str(pa), b.dump()], out_path=str(tmp_path / "m.json"))
    assert doc["nranks"] == 2 and doc["analysis"]["ok"]
    assert obs_flight.merge_flight_dumps(
        [str(tmp_path / "m.json")])["nranks"] == 2
    text = json.dumps(b.dump())
    torn = tmp_path / "torn.json"
    torn.write_text(text[:text.index('"t_queue"')])
    doc = obs_flight.merge_flight_dumps([str(torn), str(pa)])
    assert doc["analysis"]["torn_dumps"][0]["path"] == str(torn)


def test_mark_event_publishes_zero_duration_record():
    recr = obs_flight.FlightRecorder(rank=0)
    obs_flight.mark_event(recr, obs_flight.TEARDOWN_EVENT, lane="lifecycle")
    (rec,) = recr.records()
    assert rec.collective == "engine_teardown" and rec.lane == "lifecycle"
    assert rec.state == obs_flight.S_COMPLETE and not rec.gang
    assert obs_flight.FENCE_EVENTS == jflight.FENCE_EVENTS


# ---------------------------------------------------------------------------
# OpenMetrics and the HTTP surface
# ---------------------------------------------------------------------------
def test_to_openmetrics_format():
    reg = obs_metrics.MetricsRegistry()
    reg.inc("watchdog/fires", 2)
    reg.set_gauge("accl_health", obs_health.HEALTH_OK)
    for _ in range(3):
        reg.observe_call("allreduce", "float32", 1024, 100e3, nranks=4)
    text = reg.to_openmetrics()
    assert text.endswith("# EOF\n")
    assert "accl_watchdog_fires_total 2" in text
    assert "accl_health 0" in text
    lbl = 'collective="allreduce",dtype="float32",size_bucket="<=1KiB"'
    assert f"accl_collective_calls_total{{{lbl}}} 3" in text
    assert f'accl_collective_latency_us_bucket{{{lbl},le="64"}} 0' in text
    assert f'accl_collective_latency_us_bucket{{{lbl},le="256"}} 3' in text
    assert f"accl_collective_latency_us_sum{{{lbl}}} 300.0" in text
    assert obs_metrics.validate_openmetrics(text) == []


def test_flight_record_recovering_state():
    ring = obs_flight.FlightRecorder(0, capacity=8)
    rec = ring.new_record(-1, "recovery/shrink", 0, 0, "none", 0, 0, 1,
                          False, now_ns())
    rec.mark_recovering(now_ns())
    assert obs_flight.STATE_NAMES[rec.state] == "recovering"
    assert rec.in_flight and not rec.gang and rec.lane == "supervisor"
    assert obs_flight.merge_flight_dumps([ring.dump()])["analysis"][
        "hangs"] == []
    rec.finish(0, now_ns())
    assert not rec.in_flight


def test_metrics_exporter_endpoints():
    reg = obs_metrics.MetricsRegistry()
    reg.set_gauge("accl_health", obs_health.HEALTH_OK)
    reg.inc("watchdog/checks", 7)
    exp = obs_health.MetricsExporter(0, registry=reg)
    try:
        base = f"http://{exp.host}:{exp.port}"
        resp = urllib.request.urlopen(base + "/metrics", timeout=10)
        assert resp.headers["Content-Type"] \
            == obs_health.OPENMETRICS_CONTENT_TYPE
        body = resp.read().decode()
        assert "accl_health 0" in body and body.endswith("# EOF\n")
        hz = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read())
        assert hz == {"health": "ok", "accl_health": 0,
                      "watchdog_fires": 0, "watchdog_checks": 7}
        fl = json.loads(urllib.request.urlopen(
            base + "/flight", timeout=10).read())
        assert "ranks" in fl and "analysis" in fl
        # with no SLO tracker armed /slo serves the empty report, and with
        # no online tuner /retunes the empty retune history
        slo = json.loads(urllib.request.urlopen(
            base + "/slo", timeout=10).read())
        assert slo["tenants"] == {} and slo["checks"] == 0
        retunes = json.loads(urllib.request.urlopen(
            base + "/retunes", timeout=10).read())
        assert retunes["episodes"] == [] and retunes["total"] == 0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        exp.close()


def test_start_exporter_env_gating(monkeypatch):
    monkeypatch.delenv("ACCL_METRICS_PORT", raising=False)
    obs_health.stop_exporter()
    assert obs_health.start_exporter() is None
    exp = obs_health.start_exporter(port=0)
    try:
        assert exp is obs_health.start_exporter(port=0)
        assert obs_health.exporter_port() == exp.port
    finally:
        obs_health.stop_exporter()
    assert obs_health.exporter_port() is None


def test_world_exporter_serves_the_driver_registry(monkeypatch):
    obs_health.stop_exporter()
    monkeypatch.setenv("ACCL_METRICS_PORT", "0")
    with _world(2) as w:
        _allreduce_all(w)
        port = obs_health.exporter_port()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
    assert 'accl_collective_calls_total{collective="allreduce"' in body
    assert obs_metrics.validate_openmetrics(body) == []
    assert obs_health.exporter_port() is None
