"""Tenant labels on the port's driver (accl_tpu_torch.accl,
.communicator) held to the JAX driver's (accl_tpu/accl.py:417-469,
accl_tpu/communicator.py:50-55,116-123), and the observability bring-up
gates.

- ``create_communicator(tenant=)``, ``set_tenant`` (its name rule and
  error text) and ``tenant_comm_ids`` behave as the JAX driver's;
- a sub-communicator inherits its parent's tenant; ``repr`` and
  ``dump`` show it;
- flight records, the registry's ``tenant_calls`` families and the
  trace spans carry the tenant;
- the same tenant traffic on ``CudaWorld(4, device="cpu")`` and
  ``TpuWorld(4)`` gives equal ``tx_bytes`` and ``rx_bytes`` matrices per
  tenant (``seek_wait_ns`` is timing and is not compared);
- with ``ACCL_SENTINEL``, ``ACCL_SLO`` and ``ACCL_TELEMETRY_INTERVAL_MS``
  unset, bring-up builds no sampler, sentinel or tracker and starts no
  thread; set, it arms each.
Each test runs under its own SIGALRM limit.
"""
import json
import signal
import threading

import numpy as np
import pytest

from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.communicator import Communicator as JCommunicator
from accl_tpu.communicator import Rank as JRank
from accl_tpu.constants import ACCLError as JACCLError
from accl_tpu.constants import ReduceFunction as JReduce
from accl_tpu_torch import CudaWorld, ReduceFunction
from accl_tpu_torch.communicator import Communicator, Rank
from accl_tpu_torch.constants import ACCLError
from accl_tpu_torch.observability import metrics as tmetrics
from accl_tpu_torch.observability import sentinel as tsen
from accl_tpu_torch.observability import slo as tslo
from accl_tpu_torch.observability import trace as ttrace

NR = 4
TEST_LIMIT_S = 120
FIELDS = ("tx_bytes", "rx_bytes")


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


@pytest.mark.parametrize("name", [
    "", "a b", "x" * 65, "semi;colon", "té", 5, b"bytes"])
def test_set_tenant_refuses_what_the_reference_refuses(worlds, name):
    tw, cw = worlds
    with pytest.raises(JACCLError) as want:
        tw.accls[0].set_tenant(0, name)
    with pytest.raises(ACCLError) as got:
        cw.accls[0].set_tenant(0, name)
    assert str(got.value) == str(want.value)
    assert cw.accls[0].comm.tenant is None


@pytest.mark.parametrize("name", ["a", "serve.v2", "x-y_z", "9" * 64])
def test_set_tenant_accepts_and_clears(worlds, name):
    accl = worlds[1].accls[0]
    accl.set_tenant(0, name)
    try:
        assert accl.comm.tenant == name
        assert accl.tenant_comm_ids(name) == [0]
    finally:
        accl.set_tenant(0, None)
    assert accl.comm.tenant is None and accl.tenant_comm_ids(name) == []
    with pytest.raises(ACCLError, match="unknown communicator id 99"):
        accl.set_tenant(99, name)


def test_split_inherits_tenant_and_repr_shows_it():
    subs = []
    for C, R in ((Communicator, Rank), (JCommunicator, JRank)):
        world = C([R(session=r) for r in range(NR)], 1)
        assert world.tenant is None and C.tenant is None
        world.tenant = "serve"
        sub = world.split([0, 1], 3)
        assert sub.tenant == "serve"
        plain = C([R(session=r) for r in range(NR)], 1).split([1, 2], 4)
        assert plain.tenant is None
        subs.append(sub)
    assert "tenant='serve'" in repr(subs[0])
    assert subs[0].dump().splitlines()[0] == subs[1].dump().splitlines()[0]


def _traffic(red, n=64, iters=2):
    """Two tenants over the world and a third on a 2-rank sub-group:
    'serve' a small allreduce, 'train' a P times larger allreduce and an
    allgather, 'pair' an allreduce on the sub-communicator of ranks 0
    and 1 (ranks 2 and 3 burn its id)."""
    def body(accl, rank):
        serve = accl.create_communicator(list(range(NR)), tenant="serve")
        train = accl.create_communicator(list(range(NR)), tenant="train")
        if rank < 2:
            pair = accl.create_communicator([0, 1], tenant="pair")
        else:
            pair = accl.reserve_communicator()
        assert accl.tenant_comm_ids("serve") == [serve]
        x = accl.create_buffer_like(
            np.arange(n * NR, dtype=np.float32) * 0.25 + rank)
        y = accl.create_buffer(n * NR, np.float32)
        for _ in range(iters):
            accl.allreduce(x, y, n, red, comm_id=serve)
            accl.allreduce(x, y, n * NR, red, comm_id=train)
            accl.allgather(x, y, n, comm_id=train)
            if rank < 2:
                accl.allreduce(x, y, n, red, comm_id=pair)
        return y.host.copy()
    return body


def test_tenant_matrices_match_reference():
    with TpuWorld(NR) as tw:
        want = tw.run(_traffic(JReduce.SUM))
        jm = {t: tw.link_matrix(tenant=t) for t in ("serve", "train",
                                                   "pair", "none")}
        j0 = tw.link_matrix()
    with CudaWorld(NR, device="cpu") as cw:
        got = cw.run(_traffic(ReduceFunction.SUM), timeout=60)
        tm = {t: cw.link_matrix(tenant=t) for t in jm}
        t0 = cw.link_matrix()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for t in jm:
        assert tm[t]["tenant"] == jm[t]["tenant"] == t
        assert tm[t]["comms"] == jm[t]["comms"]
        for f in FIELDS:
            assert tm[t]["fields"][f] == jm[t]["fields"][f], (t, f)
    assert sum(map(sum, tm["train"]["fields"]["tx_bytes"])) > 0
    assert sum(map(sum, tm["none"]["fields"]["tx_bytes"])) == 0
    for f in FIELDS:
        assert t0["fields"][f] == j0["fields"][f]


def test_records_metrics_and_spans_carry_the_tenant(worlds):
    cw = worlds[1]
    reg = tmetrics.default_registry()
    col = ttrace.enable()
    col.clear()
    n = 32
    try:
        def body(accl, rank):
            c = accl.create_communicator(list(range(NR)), tenant="decode")
            x = accl.create_buffer_like(np.full(n, rank, np.float32))
            y = accl.create_buffer(n, np.float32)
            accl.allreduce(x, y, n, ReduceFunction.SUM, comm_id=c)
            accl.allreduce(x, y, n, ReduceFunction.SUM)
            return c

        before = {k: v["calls"] for k, v in
                  reg.snapshot()["tenant_calls"].items()}
        comm = cw.run(body, timeout=60)[0]
        spans = [s for s in col.spans() if s.name == "allreduce"]
        doc = col.to_perfetto()
    finally:
        ttrace.disable()
        col.clear()
    for a in cw.accls:
        recs = [r for r in a.flight_recorder.dump()["records"]
                if r["collective"] == "allreduce"][-2:]
        assert [(r["comm"], r["tenant"]) for r in recs] == \
            [(comm, "decode"), (0, None)]
    after = reg.snapshot()["tenant_calls"]
    key = "decode|allreduce|float32|" + tmetrics.size_bucket(n * 4)
    assert after[key]["calls"] - before.get(key, 0) == NR
    assert after[key]["tenant"] == "decode"
    assert sorted(s.tenant or "" for s in spans) == \
        [""] * NR + ["decode"] * NR
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "call:decode" in tracks


def _new_threads(before: set) -> list:
    """Names of the threads started since ``before`` (a set of threads)
    that belong to the observability plane; threads of other tests in
    this process (the JAX package's use the same names) are not new."""
    return sorted(t.name for t in set(threading.enumerate()) - before
                  if t.name in OBS_THREADS)


OBS_THREADS = ("accl-sentinel", "accl-slo", "accl-cuda-telemetry")


def test_bring_up_builds_nothing_when_unset(monkeypatch):
    for k in ("ACCL_SENTINEL", "ACCL_SLO", "ACCL_TELEMETRY_INTERVAL_MS"):
        monkeypatch.delenv(k, raising=False)
    tsen.stop_sentinel()
    tslo.stop_slo()
    before = set(threading.enumerate())
    with CudaWorld(2, device="cpu") as w:
        assert w.telemetry is None
        assert tsen._sentinel is None and tslo.tracker() is None
        assert not _new_threads(before)


def test_bring_up_arms_each_knob(monkeypatch, tmp_path):
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps({
        "format": "accl-slo-spec", "version": 1,
        "slos": [{"tenant": "serve", "p99_us": 1024.0}]}))
    base = tsen.Baseline({}, "empty").save(str(tmp_path / "base.json"))
    monkeypatch.setenv("ACCL_SLO", str(spec))
    monkeypatch.setenv("ACCL_SLO_INTERVAL_MS", "60000")
    monkeypatch.setenv("ACCL_SENTINEL", base)
    monkeypatch.setenv("ACCL_SENTINEL_INTERVAL_MS", "60000")
    monkeypatch.setenv("ACCL_TELEMETRY_INTERVAL_MS", "60000")
    tsen.stop_sentinel()
    tslo.stop_slo()
    before = set(threading.enumerate())
    try:
        with CudaWorld(2, device="cpu") as w:
            assert w.telemetry is not None
            assert tsen._sentinel is not None
            assert tslo.tracker() is not None
            assert tslo.tracker().specs[0]["tenant"] == "serve"
            assert _new_threads(before) == sorted(OBS_THREADS)
        assert w.telemetry is None
        assert _new_threads(before) == ["accl-sentinel", "accl-slo"]
    finally:
        tsen.stop_sentinel()
        tslo.stop_slo()
    assert not _new_threads(before)
