"""The port's sweep and call-rate benches (accl_tpu_torch.bench.sweep,
.callrate) on CudaWorld(4, device="cpu"), held to the JAX package's
accl_tpu.bench.sweep on TpuWorld(4): the same (collective, count, bytes)
rows, in the same order, with the same busbw factors, and positive
durations.  Times are host-clock readings and are not compared.  Each
test runs under its own SIGALRM limit.
"""
import io
import signal

import numpy as np
import pytest
import torch

from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.bench import sweep as jsweep
from accl_tpu.observability import metrics as jmetrics
from accl_tpu_torch import ACCLError, CudaWorld
from accl_tpu_torch.bench import callrate
from accl_tpu_torch.bench import sweep as tsweep
from accl_tpu_torch.observability import metrics as obs_metrics

NR = 4
TEST_LIMIT_S = 240


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def worlds():
    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as cw:
        yield tw, cw


KEY = ("collective", "count", "bytes", "repetition")


def test_sweep_rows_match_reference(worlds):
    tw, cw = worlds
    jcfg = jsweep.SweepConfig(count_pows=(4, 6), repetitions=2)
    tcfg = tsweep.SweepConfig(count_pows=(4, 6), repetitions=2)
    buf = io.StringIO()
    want = jsweep.run_sweep(tw, jcfg)
    got = tsweep.run_sweep(cw, tcfg, writer=buf)
    assert [tuple(r[k] for k in KEY) for r in got] == \
        [tuple(r[k] for k in KEY) for r in want]
    assert len(got) == len(tsweep.COLLECTIVES) * 2 * 2
    for r in got:
        assert r["duration_us"] > 0
        factor = obs_metrics.busbw_factor(r["collective"], NR)
        assert factor == jmetrics.busbw_factor(r["collective"], NR)
        assert r["busbw_GBps"] == pytest.approx(r["algbw_GBps"] * factor,
                                                abs=2e-4)
    lines = buf.getvalue().splitlines()
    assert lines[0].split(",") == list(tsweep.SWEEP_FIELDS)
    assert len(lines) == 1 + len(got)
    gauges = obs_metrics.default_registry().snapshot()["gauges"]
    for coll in tsweep.COLLECTIVES:
        assert f"sweep/{coll}/busbw_peak_GBps" in gauges


@pytest.mark.parametrize("reps", [1, 2])
def test_sweep_frees_its_buffers(worlds, reps, monkeypatch):
    _tw, cw = worlds
    calls = []
    run_once = tsweep._run_once
    monkeypatch.setattr(tsweep, "_run_once",
                        lambda *a, **k: calls.append(a[1]) or run_once(*a, **k))
    before = [len(b) for b in cw.engine._buffers]
    rows = tsweep.run_sweep(cw, tsweep.SweepConfig(
        collectives=("allreduce", "alltoall"), count_pows=(5,),
        repetitions=reps))
    assert [len(b) for b in cw.engine._buffers] == before
    # one timed call a row, and one untimed warm-up a size
    assert len(rows) == 2 * reps and len(calls) == 2 * (reps + 1)


def test_compression_sweep_rows_match_reference(worlds):
    tw, cw = worlds
    kw = dict(collectives=("allreduce", "reduce_scatter"),
              count_pows=(8,), repetitions=1)
    want = jsweep.run_compression_sweep(tw, **kw)
    got = tsweep.run_compression_sweep(cw, writer=io.StringIO(), **kw)
    key = ("lane", "collective", "count", "bytes")
    assert [tuple(r[k] for k in key) for r in got] == \
        [tuple(r[k] for k in key) for r in want]
    assert tsweep.COMPRESSION_LANES == jsweep.COMPRESSION_LANES
    for r in got:
        assert r["duration_us"] > 0
        if r["lane"] == "lossless":
            # summation-order noise only: 4 N(0, 1) terms, fp32
            assert r["max_abs_err"] <= 1e-5
        else:
            assert r["max_abs_err"] > 0  # a lossy wire loses something
    # the policy armed for int8_ef is disarmed again
    assert all(a.compression_policy is None for a in cw.accls)


def test_fused_overlap_sweep_waits_for_attribution(worlds):
    with pytest.raises(NotImplementedError, match="item 6"):
        tsweep.run_fused_overlap_sweep(worlds[1])


def test_platform_claim_never_falls_back():
    assert tsweep.claim_platform("cpu") == "cpu"
    if torch.cuda.is_available():
        assert tsweep.claim_platform() == "cuda"
    else:
        with pytest.raises(ACCLError, match="no CUDA device"):
            tsweep.claim_platform()
        with pytest.raises(ACCLError, match="no CUDA device"):
            callrate.run(nranks=2, count=16, iters=10, rounds=1)


def test_claim_watchdog_arms_and_cancels(monkeypatch):
    monkeypatch.setenv("ACCL_CUDA_CLAIM_TIMEOUT_S", "0")
    assert tsweep.claim_watchdog("t") is None
    timer = tsweep.claim_watchdog("t", timeout_s=600)
    assert timer.daemon and timer.is_alive()
    timer.cancel()


@pytest.mark.parametrize("count", [64, 1 << 20])
def test_callrate_lanes_on_the_cpu(count):
    iters = 20 if count < 4096 else 10
    out = callrate.run(nranks=2, count=count, iters=iters, device="cpu",
                       rounds=2)
    labels = {label for _lane, label in callrate.LANES}
    assert set(out["lanes"]) == labels
    for label, lane in out["lanes"].items():
        assert lane["calls_per_s"] > 0 and lane["latency_us"] > 0
        assert lane["overhead_vs_raw_x"] > 0
    assert out["ring_lane"] is (count * 4 >= 4 << 20)
    # the plan lanes replay a captured plan, under the JAX keys
    for key in ("plan_sync_overhead_x", "plan_async_overhead_x",
                "plan_vs_resident_x"):
        assert out[key] > 0
    assert out["plan_enabled"] is True
    for label in ("driver_plan_sync", "driver_plan_async"):
        d = out["lanes"][label]["dispatch"]
        assert d["plan_replays"] > 0
        assert d["leader_dispatches"] == d["executor_dispatches"] == 0
    # the async lane's batches: never on the ring lane
    d = out["lanes"]["driver_async"]["dispatch"]
    if out["ring_lane"]:
        assert d["batches"] == 0
    assert d["batched_gangs"] >= 2 * d["batches"]
    d = out["lanes"]["driver_sync_executor_path"]["dispatch"]
    assert d["leader_dispatches"] == 0 and d["executor_dispatches"] > 0
    d = out["lanes"]["driver_sync_resident"]["dispatch"]
    assert d["leader_dispatches"] > 0
    gauges = obs_metrics.default_registry().snapshot()["gauges"]
    assert gauges["callrate/raw_shardmap/calls_per_s"] > 0
    for key in ("driver_overhead_x", "resident_overhead_x",
                "async_overhead_x", "leader_vs_executor_x"):
        assert out[key] > 0
    assert np.isfinite(out["raw_latency_us"])


def test_driver_split_lanes_on_the_cpu():
    from accl_tpu_torch.bench import driver_split

    rows = driver_split.measure("t", rounds=2, device="cpu", counts=(64,))
    assert {r["lane"] for r in rows} == {"defaults", "observability_off"}
    for r in rows:
        assert r["us_per_call"] > 0 and len(r["rounds_us"]) == 2
        assert r["count"] == 64 and r["ranks"] == driver_split.P
    # the defaults are back on afterwards
    from accl_tpu_torch.observability import flight, metrics
    assert flight.enabled() and metrics.enabled()
