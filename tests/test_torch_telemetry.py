"""The port's engine telemetry (accl_tpu_torch.observability.telemetry)
held to the JAX package's (accl_tpu.observability.telemetry).

Pure functions are compared exactly on identical inputs made from a
seed with numpy: the field tables, ``decode_engine_stats`` and
``decode_link_stats`` on synthetic flat rows, ``link_matrix`` per comm,
over every comm and over a set of comms, ``slowest_link`` and
``link_imbalance``; and two samplers, one per package, polling the same
synthetic sources into their own registries publish the same counters
and gauges.  On ``CudaWorld(4, device="cpu")``: the sampler is built
only under ``ACCL_TELEMETRY_INTERVAL_MS`` (unset: no object, no thread),
publishes the ``engine/*`` and ``link/*`` families, and ``close()``
stops it.  Each test runs under its own SIGALRM limit.
"""
import signal
import threading

import numpy as np
import pytest

from accl_tpu.constants import ACCLError as JACCLError
from accl_tpu.observability import metrics as jmetrics
from accl_tpu.observability import telemetry as jtel
from accl_tpu_torch import CudaWorld, ReduceFunction
from accl_tpu_torch.constants import ACCLError
from accl_tpu_torch.observability import metrics as tmetrics
from accl_tpu_torch.observability import telemetry as ttel

TEST_LIMIT_S = 120
SEED = 15


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_field_tables_match_reference():
    for name in ("ENGINE_STATS_FIELDS_V1", "ENGINE_STATS_FIELDS_V2",
                 "ENGINE_STATS_FIELDS_V3", "ENGINE_STATS_FIELDS_BY_VERSION",
                 "LINK_STATS_FIELDS_V3", "LINK_STATS_FIELDS_V2",
                 "LINK_COUNTER_FIELDS", "COUNTER_FIELDS"):
        assert getattr(ttel, name) == getattr(jtel, name), name


def test_engine_keeps_one_link_field_table():
    from accl_tpu_torch.backends import cuda

    assert cuda.LINK_COUNTER_FIELDS is ttel.LINK_COUNTER_FIELDS


@pytest.mark.parametrize("version,n,total", [
    (1, 25, None), (1, 28, None), (2, 26, None), (3, 28, None),
    (3, 30, None), (4, 31, None), (0, 5, None), (3, 28, 20)])
def test_decode_engine_stats_matches_reference(version, n, total):
    vals = np.random.default_rng(SEED + n).integers(0, 1 << 40, n).tolist()
    assert ttel.decode_engine_stats(vals, version, total) == \
        jtel.decode_engine_stats(vals, version, total)


def _link_rows(rng, rows: int) -> np.ndarray:
    """Flat link rows: comm in 0..2, peer in -1..4 (out-of-range peers
    included), counters up to 2^30."""
    stride = len(jtel.LINK_STATS_FIELDS_V3)
    a = rng.integers(0, 1 << 30, (rows, stride))
    a[:, 0] = rng.integers(0, 3, rows)
    a[:, 1] = rng.integers(-1, 5, rows)
    return a.reshape(-1)


@pytest.mark.parametrize("rows", [0, 1, 7])
def test_decode_link_stats_matches_reference(rows):
    flat = _link_rows(np.random.default_rng(SEED + rows), rows).tolist()
    assert ttel.decode_link_stats(flat) == jtel.decode_link_stats(flat)


def test_decode_link_stats_refuses_a_torn_stride():
    flat = list(range(len(jtel.LINK_STATS_FIELDS_V3) + 3))
    with pytest.raises(JACCLError) as want:
        jtel.decode_link_stats(flat)
    with pytest.raises(ACCLError) as got:
        ttel.decode_link_stats(flat)
    assert str(got.value) == str(want.value)


def _per_rank(seed: int, P: int) -> dict:
    rng = np.random.default_rng(seed)
    return {r: jtel.decode_link_stats(_link_rows(rng, 6).tolist())
            for r in range(P)}


@pytest.mark.parametrize("kw", [
    {}, {"comm": 1}, {"comm": None}, {"comms": [1, 2]}, {"comms": []},
    {"nranks": 3}, {"nranks": 6, "comm": 2}])
def test_link_matrix_and_readers_match_reference(kw):
    per_rank = _per_rank(SEED, 4)
    want = jtel.link_matrix(per_rank, **kw)
    got = ttel.link_matrix(per_rank, **kw)
    assert got == want
    for field in jtel.LINK_COUNTER_FIELDS:
        assert ttel.slowest_link(got, field) == jtel.slowest_link(want, field)
        assert ttel.link_imbalance(got, field) == \
            jtel.link_imbalance(want, field)
    assert ttel.slowest_link({"fields": {}}) is None
    assert ttel.link_imbalance({"fields": {}}) == 1.0


def test_samplers_publish_the_same_families():
    """Two samplers, one per package, each over its own registry and the
    same synthetic per-rank sources; three polls with growing counters
    and one source that raises."""
    rng = np.random.default_rng(SEED)
    P = 4
    fields = list(jtel.ENGINE_STATS_FIELDS_V3) + ["leader_dispatches",
                                                  "ready_depth"]
    state = {"poll": 0}
    base = rng.integers(0, 1000, (P, len(fields)))
    links = _per_rank(SEED + 1, P)

    def stats_source(r):
        def src():
            if r == 3 and state["poll"] == 1:
                raise RuntimeError("a world closed mid-poll")
            row = base[r] * (state["poll"] + 1)
            return {"version": 3, **dict(zip(fields, map(int, row)))}
        return src

    def link_source(r):
        def src():
            return [{**row, "tx_bytes": row["tx_bytes"] * (state["poll"] + 1)}
                    for row in links[r]]
        return src

    regs = {"jax": jmetrics.MetricsRegistry(),
            "port": tmetrics.MetricsRegistry()}
    samplers = {
        "jax": jtel.TelemetrySampler(
            [stats_source(r) for r in range(P)], registry=regs["jax"],
            link_sources=[(r, link_source(r)) for r in range(P)]),
        "port": ttel.TelemetrySampler(
            [stats_source(r) for r in range(P)], registry=regs["port"],
            link_sources=[(r, link_source(r)) for r in range(P)])}
    for poll in range(3):
        state["poll"] = poll
        snaps = {k: s.sample() for k, s in samplers.items()}
        assert snaps["port"] == snaps["jax"]
        assert samplers["port"].last_link_matrix == \
            samplers["jax"].last_link_matrix
        assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert any(k.startswith("link/tx_bytes/r") for k in
               regs["port"].counters())


def test_sampler_from_env_gate(monkeypatch):
    monkeypatch.delenv("ACCL_TELEMETRY_INTERVAL_MS", raising=False)
    assert ttel.interval_ms() == 0
    assert ttel.sampler_from_env([dict]) is None
    monkeypatch.setenv("ACCL_TELEMETRY_INTERVAL_MS", "nope")
    with pytest.raises(ACCLError, match="ACCL_TELEMETRY_INTERVAL_MS"):
        ttel.interval_ms()
    monkeypatch.setenv("ACCL_TELEMETRY_INTERVAL_MS", "20")
    reg = tmetrics.MetricsRegistry()
    s = ttel.sampler_from_env([lambda: {"tx_msgs": 3}], registry=reg,
                              name="gate")
    try:
        assert s is not None and s.interval_s == 0.02
        assert s._thread is not None and s._thread.is_alive()
    finally:
        s.stop()
    assert s._thread is None
    assert reg.counters().get("engine/tx_msgs") == 3


def _telemetry_threads(name: str) -> list:
    return [t for t in threading.enumerate()
            if t.name == f"{name}-telemetry"]


def test_world_builds_no_sampler_when_unset(monkeypatch):
    monkeypatch.delenv("ACCL_TELEMETRY_INTERVAL_MS", raising=False)
    with CudaWorld(2, device="cpu") as w:
        assert w.telemetry is None
        assert not _telemetry_threads("accl-cuda")


def test_world_sampler_publishes_engine_and_link_families(monkeypatch):
    monkeypatch.setenv("ACCL_TELEMETRY_INTERVAL_MS", "10")
    n = 256
    with CudaWorld(4, device="cpu") as w:
        s = w.telemetry
        assert s is not None and _telemetry_threads("accl-cuda")
        reg = s._registry
        before = reg.counters().get("link/tx_bytes", 0)

        def body(accl, rank):
            x = accl.create_buffer_like(np.full(n, rank + 1, np.float32))
            y = accl.create_buffer(n, np.float32)
            accl.allreduce(x, y, n, ReduceFunction.SUM)

        w.run(body, timeout=60)
        # stop the thread, then one poll on this thread: every byte of
        # the traffic is published once, with no sleeping
        s.stop()
        s.sample()
        counters = reg.counters()
        assert counters.get("link/tx_bytes", 0) - before == \
            sum(sum(row) for row in w.link_matrix()["fields"]["tx_bytes"])
        assert counters.get("link/tx_bytes/r0->r1", 0) > 0
        gauges = reg.snapshot()["gauges"]
        assert "engine/link_rows" in gauges and "engine/plans_live" in gauges
        assert s.last_link_matrix == w.link_matrix()
    assert w.telemetry is None
    assert not _telemetry_threads("accl-cuda")
