"""Batched gang dispatch in the port (CudaEngine._extend_batch and
_exec_gang_batch) against the JAX package's (TpuEngine): twins of
tests/test_tpu_backend.py's async-window, ring-lane, (rank, address)
guard and profile_sync tests on CudaWorld(4, device="cpu") and
TpuWorld(4), the same numpy inputs in both.

How many batches form depends on when the executor wakes, so each
window here is queued while the executor is held (``_held``: the
dispatch slot claimed, as a running gang claims it) and released whole.
The executor then drains it in one deterministic order, and the batch
sizes of both packages are compared as well as their results, bitwise.
The rules are read through the counters and a spy on each engine's
``_exec_gang_batch``: ring-lane gangs and ``profile_sync`` give
``batches == 0``, and a read-after-write pair never shares a batch.
"""
import contextlib

import numpy as np
import pytest
import torch

from accl_tpu import ReduceFunction as JReduce
from accl_tpu.backends.tpu import TpuEngine, TpuWorld
from accl_tpu_torch import ACCLError, CudaWorld, ReduceFunction
from accl_tpu_torch.backends.cuda import CudaEngine

NRANKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def spies(monkeypatch):
    """lib -> the batches each engine ran: [[(op, gang's res (rank,
    address) set, opnd set)], ...]."""
    seen = {"jax": [], "torch": []}
    for lib, cls in (("jax", TpuEngine), ("torch", CudaEngine)):
        orig = cls._exec_gang_batch

        def spy(self, items, _orig=orig, _lib=lib):
            seen[_lib].append([(op.name, plan["res_addrs"],
                                plan["opnd_addrs"])
                               for op, _c, _g, plan in items])
            return _orig(self, items)

        monkeypatch.setattr(cls, "_exec_gang_batch", spy)
    return seen


def _world(lib, n=NRANKS):
    return TpuWorld(n) if lib == "jax" else CudaWorld(n, device="cpu")


def _sum(lib):
    return JReduce.SUM if lib == "jax" else ReduceFunction.SUM


@contextlib.contextmanager
def _held(engine):
    """Park the executor while a window is queued: the dispatch slot is
    claimed as an inline gang claims it, and released on exit."""
    with engine._ready_cv:
        engine._inline_busy = True
    try:
        yield
    finally:
        with engine._ready_cv:
            engine._inline_busy = False
            engine._ready_cv.notify_all()


def _windowed(w, post, finish):
    """post(accl, rank) -> requests, queued while the executor is held;
    then finish(accl, rank, requests) after every request completed."""
    with _held(w.engine):
        reqs = w.run(post)
        with w.engine._ready_cv:
            queued = len(w.engine._ready)
    for rs in reqs:
        for q in rs:
            assert q.wait(120)
            q.check()
    outs = w.run(lambda a, r: finish(a, r, reqs[r]))
    return queued, outs


def _full(accl, n, value):
    b = accl.create_buffer_like(np.full(n, value, np.float32))
    b.sync_to_device()
    return b


def _async_window(lib):
    n = 128
    bufs = {}

    def setup(accl, rank):
        bufs[rank] = (_full(accl, n, float(rank + 1)),
                      accl.create_buffer(n, np.float32),
                      accl.create_buffer(n, np.float32))

    def chain(accl, rank):
        s, r, t = bufs[rank]
        reqs = []
        for _ in range(4):  # r = sum(s); t = sum(r): t reads r
            reqs.append(accl.allreduce(s, r, n, _sum(lib), from_fpga=True,
                                       to_fpga=True, run_async=True))
            reqs.append(accl.allreduce(r, t, n, _sum(lib), from_fpga=True,
                                       to_fpga=True, run_async=True))
        return reqs

    def window(accl, rank):
        s, r, _t = bufs[rank]
        return [accl.allreduce(s, r, n, _sum(lib), from_fpga=True,
                               to_fpga=True, run_async=True)
                for _ in range(16)]

    def read(accl, rank, reqs):
        _s, r, t = bufs[rank]
        r.sync_from_device()
        t.sync_from_device()
        return r.host.copy(), t.host.copy(), [q.duration_ns for q in reqs]

    with _world(lib) as w:
        w.run(setup)
        queued1, outs1 = _windowed(w, chain, read)
        queued2, outs2 = _windowed(w, window, read)
        stats = dict(w.engine.stats)
        records = [[(rec["collective"], rec["lane"])
                    for rec in a.dump_flight_recorder()["records"]
                    if rec["collective"] == "allreduce"] for a in w.accls]
    return queued1, outs1, queued2, outs2, stats, records


def test_async_window_batches_and_raw_guard(spies):
    """(a) Independent same-program gangs of an async window run in
    batches of up to 8; (b) a chain whose second gang reads the first's
    result never puts the reader behind the writer in one batch — its
    numerics show it saw the reduced value.  Results, batch sizes and
    flight lanes equal the JAX package's."""
    got = {lib: _async_window(lib) for lib in ("jax", "torch")}
    j, t = got["jax"], got["torch"]
    assert j[0] == t[0] == 8 and j[2] == t[2] == 16
    for k in (1, 3):
        for (rj, tj, _dj), (rt, tt, _dt) in zip(j[k], t[k]):
            np.testing.assert_array_equal(rt, rj)
            np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(t[1][0][1], 40.0)  # 4 x (1+2+3+4)
    np.testing.assert_array_equal(t[3][0][0], 10.0)
    assert [len(b) for b in spies["torch"]] == [len(b) for b in spies["jax"]]
    assert t[4]["batches"] == j[4]["batches"] > 0
    assert t[4]["batched_gangs"] == j[4]["batched_gangs"]
    assert max(len(b) for b in spies["torch"]) == CudaEngine._BATCH_CAP
    for batch in spies["torch"]:
        written = set()
        for _op, res, opnd in batch:
            assert not opnd & written, "a reader joined its writer's batch"
            written |= res
    # each call of a batch reports the batch's time / K, and is stamped
    # with the batched lane
    for _r, _t, durs in t[3]:
        assert all(d > 0 for d in durs)
    assert [lane for rank in t[5] for _c, lane in rank].count("batched") \
        == t[4]["batched_gangs"] * NRANKS
    assert t[5] == j[5]


def _ring_window(lib):
    n = 256
    bufs = {}

    def post(accl, rank):
        s = _full(accl, n, float(rank + 1))
        r = accl.create_buffer(n, np.float32)
        bufs[rank] = r
        return [accl.allreduce(s, r, n, _sum(lib), from_fpga=True,
                               to_fpga=True, run_async=True)
                for _ in range(6)]

    def read(accl, rank, reqs):
        bufs[rank].sync_from_device()
        return bufs[rank].host.copy()

    with _world(lib) as w:
        w.engine.ring_threshold_bytes = 0
        queued, outs = _windowed(w, post, read)
        return queued, outs, dict(w.engine.stats)


def test_ring_path_gangs_never_batch(spies):
    """Every payload on the ring lane: six queued same-program gangs
    still dispatch one at a time, in both packages."""
    got = {lib: _ring_window(lib) for lib in ("jax", "torch")}
    for lib, (queued, outs, stats) in got.items():
        assert queued == 6
        assert stats["batches"] == stats["batched_gangs"] == 0
        assert stats["executor_dispatches"] == 6
        assert spies[lib] == []
    for a, b in zip(got["jax"][1], got["torch"][1]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got["torch"][1][0], 10.0)


def _guard_window(lib):
    n = 64
    addrs, bufs = {}, {}

    def post(accl, rank):
        # allocation order differs per rank, so rank 0's result address
        # equals rank 1's operand address of the other chain
        if rank == 0:
            a, b, c, d = (accl.create_buffer(n, np.float32)
                          for _ in range(4))
        else:
            a, c, b, d = (accl.create_buffer(n, np.float32)
                          for _ in range(4))
        a.host[:] = float(rank + 1)
        c.host[:] = float(rank + 1) * 10
        a.sync_to_device()
        c.sync_to_device()
        addrs[rank] = {"a": a.address, "b": b.address, "c": c.address,
                       "d": d.address}
        bufs[rank] = (b, d)
        reqs = []
        for _ in range(8):
            reqs.append(accl.allreduce(a, b, n, _sum(lib), from_fpga=True,
                                       to_fpga=True, run_async=True))
            reqs.append(accl.allreduce(c, d, n, _sum(lib), from_fpga=True,
                                       to_fpga=True, run_async=True))
        return reqs

    def read(accl, rank, reqs):
        b, d = bufs[rank]
        b.sync_from_device()
        d.sync_from_device()
        return b.host.copy(), d.host.copy()

    with _world(lib, 2) as w:
        queued, outs = _windowed(w, post, read)
        plans = list(w.engine._gang_plans.values())
        stats = dict(w.engine.stats)
    return queued, outs, plans, addrs, stats


def test_raw_guard_keys_by_rank_and_address(spies):
    """The guard keys by (rank, address): the raw numbers of the a->b
    chain's results alias the c->d chain's operands across ranks, yet
    the two chains batch together, as in the JAX package."""
    got = {lib: _guard_window(lib) for lib in ("jax", "torch")}
    for lib, (queued, outs, plans, addrs, stats) in got.items():
        assert queued == 16
        assert len(plans) == 2
        p_ab = next(p for p in plans
                    if (0, addrs[0]["a"]) in p["opnd_addrs"])
        p_cd = next(p for p in plans
                    if (0, addrs[0]["c"]) in p["opnd_addrs"])
        raw_res = {ad for _g, ad in p_ab["res_addrs"]}
        raw_opnd = {ad for _g, ad in p_cd["opnd_addrs"]}
        assert raw_res & raw_opnd
        assert not (p_ab["res_addrs"] & p_cd["opnd_addrs"])
        assert max(len(b) for b in spies[lib]) == 8
        assert stats["batched_gangs"] == 16
    for (bj, dj), (bt, dt) in zip(got["jax"][1], got["torch"][1]):
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(got["torch"][1][0][0], 3.0)
    np.testing.assert_array_equal(got["torch"][1][0][1], 30.0)


def test_profile_sync_disables_batching(spies, monkeypatch):
    """ACCL_PROFILE_SYNC=1: every call's duration is its own blocking
    time, so no gang batches, in both packages."""
    monkeypatch.setenv("ACCL_PROFILE_SYNC", "1")
    n = 128
    got = {}
    for lib in ("jax", "torch"):
        bufs = {}

        def post(accl, rank, lib=lib, bufs=bufs):
            s = _full(accl, n, float(rank + 1))
            bufs[rank] = accl.create_buffer(n, np.float32)
            return [accl.allreduce(s, bufs[rank], n, _sum(lib),
                                   from_fpga=True, to_fpga=True,
                                   run_async=True) for _ in range(16)]

        def read(accl, rank, reqs, bufs=bufs):
            assert all(q.duration_ns > 0.0 for q in reqs)
            bufs[rank].sync_from_device()
            return bufs[rank].host.copy()

        with _world(lib) as w:
            assert w.engine.profile_sync
            queued, outs = _windowed(w, post, read)
            got[lib] = outs
            assert queued == 16
            assert w.engine.stats["batches"] == 0
            assert w.engine.stats["executor_dispatches"] == 16
        assert spies[lib] == []
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(b, a)


def test_failed_batch_member_keeps_earlier_members_completed(monkeypatch):
    """A member that fails mid-batch fails with its followers; the
    members that ran before it complete as they are."""
    n = 32
    calls = {"n": 0}
    orig = CudaEngine._run_plan

    def flaky(self, op, comm_id, gang, plan, *args, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected failure")
        return orig(self, op, comm_id, gang, plan, *args, **kw)

    with CudaWorld(2, device="cpu") as w:
        def post(accl, rank):
            s = _full(accl, n, 1.0)
            r = accl.create_buffer(n, np.float32)
            return [accl.allreduce(s, r, n, ReduceFunction.SUM,
                                   from_fpga=True, to_fpga=True,
                                   run_async=True) for _ in range(5)]

        monkeypatch.setattr(CudaEngine, "_run_plan", flaky)
        with _held(w.engine):
            reqs = w.run(post)
        for rs in reqs:
            for q in rs:
                assert q.wait(60)
        monkeypatch.setattr(CudaEngine, "_run_plan", orig)
        assert w.engine.stats["batches"] == 1
        for rs in reqs:
            assert [q.retcode == 0 for q in rs] == [True, True, False,
                                                    False, False]
            with pytest.raises(ACCLError, match="injected failure"):
                rs[2].check()
            assert rs[0].duration_ns > 0
