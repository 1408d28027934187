"""Persistent collective plans in the port (accl_tpu_torch.plans, the plan
ring of backends/cuda.py) against the JAX package's (accl_tpu.plans on
TpuWorld): the corpus of tests/test_plans.py on CudaWorld(4,
device="cpu") and TpuWorld(4), the same numpy-seeded inputs in both.

Every world forces the ring lane (``engine.ring_threshold_bytes = 0``),
where the port's plain ring folds in the Pallas kernels' order, so every
result — eager, captured and replayed — is held bitwise: the port's
replays to the port's eager calls, and the port to the JAX package.

The fences the abort, shrink and reset drills of tests/test_plans.py
reach are driven here directly (``ACCL._invalidate_plans``,
``device.invalidate_plans``, a bump of the engine's comm generation);
the drills themselves, through ``abort``, ``shrink_communicator``,
``grow_communicator`` and ``reset_errors``, are in
tests/test_torch_resilience.py.
"""
import gc
import os

import numpy as np
import pytest
import torch

from accl_tpu import ReduceFunction as JReduce
from accl_tpu import plans as jplans
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.observability import metrics as jmetrics
from accl_tpu_torch import ACCLError, CudaWorld, ReduceFunction
from accl_tpu_torch import plans as tplans
from accl_tpu_torch.observability import metrics as tmetrics

NRANKS = 4
COUNT = 64
SCATTER = COUNT // NRANKS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _data(rank, salt=0):
    rng = np.random.default_rng(100 + rank + 37 * salt)
    return rng.standard_normal(COUNT).astype(np.float32)


def _world(lib, n=NRANKS):
    w = TpuWorld(n) if lib == "jax" else CudaWorld(n, device="cpu")
    w.engine.ring_threshold_bytes = 0
    return w


def _sum(lib):
    return JReduce.SUM if lib == "jax" else ReduceFunction.SUM


def _stats(w):
    return w.devices[0].engine_stats()


def _both(fn, *args, n=NRANKS):
    """Run fn(accl, rank, lib, *args) on a fresh world of each package;
    returns {lib: (per-rank results, the world's engine stats)}."""
    out = {}
    for lib in ("jax", "torch"):
        with _world(lib, n) as w:
            res = w.run(lambda a, r: fn(a, r, lib, *args))
            out[lib] = (res, _stats(w))
    return out


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------------------
# the chain: allreduce + reduce_scatter + a send/recv ring hop
# ---------------------------------------------------------------------------
def _chain(accl, rank, lib, iters, planned):
    SUM = _sum(lib)
    s = accl.create_buffer_like(_data(rank))
    r = accl.create_buffer(COUNT, np.float32)
    rs = accl.create_buffer(SCATTER, np.float32)
    pr = accl.create_buffer(COUNT, np.float32)

    def body(a):
        a.allreduce(s, r, COUNT, SUM)
        a.reduce_scatter(s, rs, SCATTER, SUM)
        if rank % 2 == 0:
            a.send(s, COUNT, (rank + 1) % NRANKS)
            a.recv(pr, COUNT, (rank - 1) % NRANKS)
        else:
            a.recv(pr, COUNT, (rank - 1) % NRANKS)
            a.send(s, COUNT, (rank + 1) % NRANKS)

    outs = []
    plan = accl.capture_plan(body) if planned else None
    for it in range(iters):
        if it and planned:
            plan.replay()
        elif not planned:
            body(accl)
        outs.append([r.host.copy(), rs.host.copy(), pr.host.copy()])
        # new operands for the next iteration, staged by the replay
        s.host[:] = _data(rank, salt=it + 1)
    return outs, plan  # the plan stays alive, and its ring with it


def test_capture_replay_bitwise_equals_eager():
    """allreduce/reduce_scatter/sendrecv chains, 3 iterations with new
    operands each: the port's replays == its eager calls == the JAX
    package's eager calls and replays, bit for bit."""
    iters = 3
    eager = _both(_chain, iters, False)
    planned = _both(_chain, iters, True)
    ref = [o for o, _ in eager["jax"][0]]
    for lib in ("jax", "torch"):
        _same(ref, [o for o, _ in eager[lib][0]])
        _same(ref, [o for o, _ in planned[lib][0]])
        assert all(p.stats["replays"] == iters - 1
                   for _, p in planned[lib][0])
        stats = planned[lib][1]
        assert stats["plans_live"] == 1 and stats["plan_ring_refs"] == NRANKS
        assert stats["plan_replays"] == stats["plan_ring_replays"] \
            == iters - 1
    assert planned["torch"][1]["plan_replays"] \
        == planned["jax"][1]["plan_replays"]


def _async_replays(accl, rank, lib, n):
    SUM = _sum(lib)
    s = accl.create_buffer_like(_data(rank))
    s.sync_to_device()
    r = accl.create_buffer(COUNT, np.float32)
    plan = accl.capture_plan(lambda a: a.allreduce(
        s, r, COUNT, SUM, from_fpga=True, to_fpga=True))
    tickets = [plan.replay(run_async=True) for _ in range(n)]
    for t in tickets:
        assert t.wait(30)
        t.check()
        assert t.done
    r.sync_from_device()
    return r.host.copy()


def test_plan_async_replay_bitwise():
    """Async replay (ticket wait/check): the same results as the JAX
    package's async replay, bitwise, and as the eager sum."""
    got = _both(_async_replays, 4)
    _same(got["jax"][0], got["torch"][0])
    assert got["torch"][1]["plan_replays"] == 4


# ---------------------------------------------------------------------------
# capture-time validation
# ---------------------------------------------------------------------------
def test_capture_time_sanitizer_finding_fails_capture():
    """A partial operand overlap fails capture_plan naming the
    buffer-overlap finding, in both packages alike."""
    msgs = {}
    for lib in ("jax", "torch"):
        with _world(lib, 1) as w:
            accl = w.accls[0]
            buf = accl.create_buffer(COUNT, np.float32)
            shifted = buf.slice(8, COUNT // 2 + 8)
            with pytest.raises(Exception) as ei:
                accl.capture_plan(lambda a: a.allreduce(
                    buf, shifted, COUNT // 2, _sum(lib)))
            msgs[lib] = str(ei.value)
            assert _stats(w)["plans_live"] == 0
    assert isinstance(ei.value, ACCLError)
    for msg in msgs.values():
        assert "sanitizer finding" in msg and "buffer-overlap" in msg
    head = {lib: m.split(":", 1)[1].split("[", 1)[0] for lib, m in msgs.items()}
    assert head["jax"] == head["torch"]


def test_capture_requires_collective_calls():
    with CudaWorld(1, device="cpu") as w:
        with pytest.raises(ACCLError, match="no collective calls"):
            w.accls[0].capture_plan(lambda a: None)
        assert w.devices[0].engine_stats()["plans_live"] == 0


def test_arm_timeout_names_the_missing_ranks():
    """Rank 1 runs the allreduce eagerly while rank 0 captures it: rank
    0's arm waits out its short timeout_s and names rank 1, as the JAX
    package's does; the eager allreduce itself completed."""
    msgs = {}
    for lib in ("jax", "torch"):
        with _world(lib, 2) as w:
            def fn(accl, rank):
                s = accl.create_buffer_like(_data(rank))
                r = accl.create_buffer(COUNT, np.float32)

                def body(a):
                    a.allreduce(s, r, COUNT, _sum(lib))

                if rank == 1:
                    body(accl)
                    return r.host.copy(), None
                with pytest.raises(Exception) as ei:
                    accl.capture_plan(body, timeout_s=0.3)
                return r.host.copy(), ei.value

            (r0, err), (r1, _none) = w.run(fn)
            np.testing.assert_array_equal(r0, r1)
            msgs[lib] = str(err)
    assert isinstance(err, ACCLError)
    for msg in msgs.values():
        assert "plan arm timed out" in msg and "rank(s) [1]" in msg


# ---------------------------------------------------------------------------
# the ACCL_PLAN=0 and ACCL_PLAN_AUTO lanes
# ---------------------------------------------------------------------------
def _kill_switch(accl, rank, lib):
    s = accl.create_buffer_like(_data(rank))
    r = accl.create_buffer(COUNT, np.float32)
    plan = accl.capture_plan(lambda a: a.allreduce(s, r, COUNT, _sum(lib)))
    assert plan.is_eager and not plan.invalidated
    first = r.host.copy()
    s.host[:] = _data(rank, salt=1)
    plan.replay()
    second = r.host.copy()
    t = plan.replay(run_async=True)
    assert t.wait() and t.done
    t.check()
    assert plan.stats["replays"] == 2
    return first, second


def test_plan_kill_switch_eager_lane():
    """ACCL_PLAN=0: capture_plan returns the eager plan, whose replays
    run the captured function through the per-call path — the only path
    that does; no ring is armed, and the results are the JAX package's."""
    tplans.set_enabled(False)
    jplans.set_enabled(False)
    try:
        got = _both(_kill_switch)
    finally:
        tplans.set_enabled(True)
        jplans.set_enabled(True)
    _same(got["jax"][0], got["torch"][0])
    for lib in ("jax", "torch"):
        assert got[lib][1]["plans_live"] == 0
        assert got[lib][1]["plan_replays"] == 0
    eager = _both(_chain, 2, False)
    for rank in range(NRANKS):
        _same(eager["torch"][0][rank][0][0][0], got["torch"][0][rank][0])


def _auto_loop(accl, rank, lib, iters, rings):
    s = accl.create_buffer_like(_data(rank))
    s.sync_to_device()
    r = accl.create_buffer(COUNT, np.float32)
    outs = []
    for _ in range(iters):
        accl.allreduce(s, r, COUNT, _sum(lib), from_fpga=True, to_fpga=True)
        r.sync_from_device()
        outs.append(r.host.copy())
    rings[rank] = [ring for _call, ring in accl._auto_rings.values()]
    return outs


def test_auto_capture_lane_adopts_on_one_gang_instance():
    """ACCL_PLAN_AUTO=2: the second identical resident call carries
    intent on every rank, the engine arms one ring on that gang instance
    and every rank adopts the same ring; the later calls replay through
    it.  Results and counters equal the JAX package's."""
    iters = 6
    os.environ["ACCL_PLAN_AUTO"] = "2"
    rings = {"jax": {}, "torch": {}}
    try:
        got = {}
        for lib in ("jax", "torch"):
            with _world(lib) as w:
                res = w.run(lambda a, r: _auto_loop(a, r, lib, iters,
                                                    rings[lib]))
                got[lib] = (res, _stats(w))
    finally:
        del os.environ["ACCL_PLAN_AUTO"]
    _same(got["jax"][0], got["torch"][0])
    for lib in ("jax", "torch"):
        stats = got[lib][1]
        assert stats["plan_auto_captures"] == 1
        assert stats["plan_replays"] == iters - 2
        per_rank = [rings[lib][r] for r in range(NRANKS)]
        assert all(len(x) == 1 for x in per_rank)
        assert all(x[0] is per_rank[0][0] for x in per_rank)
    assert got["torch"][1]["plan_replays"] == got["jax"][1]["plan_replays"]


# ---------------------------------------------------------------------------
# fences and release
# ---------------------------------------------------------------------------
def _capture_all(w, lib):
    plans = {}

    def cap(accl, rank):
        s = accl.create_buffer_like(_data(rank))
        r = accl.create_buffer(COUNT, np.float32)
        plans[rank] = accl.capture_plan(lambda a: a.allreduce(
            s, r, COUNT, _sum(lib)))
        plans[rank].replay()

    w.run(cap)
    return plans


@pytest.mark.parametrize("fence", ["driver", "device", "epoch"])
def test_fenced_plan_raises_and_never_runs(fence):
    """After a fence every rank's replay raises, and nothing runs: the
    driver fence (``ACCL._invalidate_plans``) refuses before the engine;
    the engine fence (``device.invalidate_plans``) and a bump of the comm
    generation (what resilience does) fence and evict the ring."""
    with CudaWorld(NRANKS, device="cpu") as w:
        w.engine.ring_threshold_bytes = 0
        plans = _capture_all(w, "torch")
        assert w.devices[0].engine_stats()["plans_live"] == 1
        replays = w.devices[0].engine_stats()["plan_replays"]
        if fence == "driver":
            for a in w.accls:
                a._invalidate_plans(None, "test fence")
        elif fence == "device":
            w.devices[0].invalidate_plans()
        else:
            w.engine._comm_gen[0] = 1

        def rep(accl, rank):
            with pytest.raises(ACCLError) as ei:
                plans[rank].replay()
            return str(ei.value)

        msgs = w.run(rep)
        stats = w.devices[0].engine_stats()
        for rank, msg in enumerate(msgs):
            assert "plan" in msg
            assert plans[rank].invalidated
            with pytest.raises(ACCLError, match="invalidated"):
                plans[rank].replay()
        assert stats["plan_replays"] == replays
        if fence != "driver":
            assert stats["plans_live"] == 0
        else:
            assert stats["plans_live"] == 1
            assert all(p.stats["invalidations"] == 1 for p in plans.values())


def test_engine_fence_raises_in_both_packages():
    for lib in ("jax", "torch"):
        with _world(lib) as w:
            plans = _capture_all(w, lib)
            w.devices[0].invalidate_plans()

            def rep(accl, rank):
                with pytest.raises(Exception) as ei:
                    plans[rank].replay()
                assert "invalidated" in str(ei.value)

            w.run(rep)
            assert _stats(w)["plans_live"] == 0


@pytest.mark.parametrize("how", ["close", "gc"])
def test_close_and_gc_release_the_ring(how):
    """A closed plan refuses to replay; once every rank's plan is closed
    or collected, the ring is fenced, evicted and its slots dropped."""
    with CudaWorld(NRANKS, device="cpu") as w:
        w.engine.ring_threshold_bytes = 0
        plans = _capture_all(w, "torch")
        ring = w.engine._plan_rings[0]
        assert ring.refs == NRANKS and ring.slots
        if how == "close":
            plans[0].close()
            assert ring.refs == NRANKS - 1 and ring.slots
            with pytest.raises(ACCLError, match="plan closed"):
                plans[0].replay()
            for p in plans.values():
                p.close()
        else:
            plans.clear()
            gc.collect()
        assert ring.refs == 0 and ring.slots == [] and ring.invalid
        stats = w.devices[0].engine_stats()
        assert stats["plans_live"] == 0 and stats["plan_ring_refs"] == 0


def test_replay_after_world_close_raises():
    w = CudaWorld(2, device="cpu")
    w.engine.ring_threshold_bytes = 0
    plans = {}

    def cap(accl, rank):
        s = accl.create_buffer_like(_data(rank))
        r = accl.create_buffer(COUNT, np.float32)
        plans[rank] = accl.capture_plan(lambda a: a.allreduce(
            s, r, COUNT, ReduceFunction.SUM))

    w.run(cap)
    w.close()
    for plan in plans.values():
        with pytest.raises(ACCLError, match="engine shut down"):
            plan.replay(timeout=30.0)
        assert plan.invalidated


# ---------------------------------------------------------------------------
# observability: plans/* metrics and the flight records
# ---------------------------------------------------------------------------
def _plan_records(accl):
    return [(rec["collective"], rec["state"])
            for rec in accl.dump_flight_recorder()["records"]
            if rec["collective"].startswith("plan")]


def test_plan_metrics_and_flight_records():
    """plans/captures, plans/replays and plans/invalidations count in
    the registry; each rank's flight ring holds a plan_capture event per
    comm and a plan_replay record per replay — the JAX package's
    records, in the same order."""
    if not (tmetrics.enabled() and jmetrics.enabled()):
        pytest.skip("metrics disabled in this environment")
    keys = ("plans/captures", "plans/replays", "plans/invalidations")
    records, deltas = {}, {}
    for lib, reg in (("jax", jmetrics.default_registry()),
                     ("torch", tmetrics.default_registry())):
        before = {k: reg.counters().get(k, 0) for k in keys}
        with _world(lib) as w:
            plans = _capture_all(w, lib)
            w.run(lambda a, r: plans[r].replay())
            for a in w.accls:
                a._invalidate_plans(None, "test fence")
            records[lib] = [_plan_records(a) for a in w.accls]
        after = reg.counters()
        deltas[lib] = {k: after.get(k, 0) - before[k] for k in keys}
    assert deltas["torch"] == deltas["jax"] == {
        "plans/captures": NRANKS, "plans/replays": 2 * NRANKS,
        "plans/invalidations": NRANKS}
    assert records["torch"] == records["jax"]
    assert records["torch"][0] == [("plan_capture", "complete"),
                                   ("plan_replay", "complete"),
                                   ("plan_replay", "complete")]


# ---------------------------------------------------------------------------
# the stale-operand trap: operands that are copies are rebuilt per replay
# ---------------------------------------------------------------------------
def _stale_trap(accl, rank, lib, iters, planned):
    """An allreduce whose operand is an fp16 buffer (widened to the fp32
    datapath: a copy), and a bcast whose root holds a buffer shorter
    than the count (padded: a copy); both rewritten between replays."""
    SUM = _sum(lib)
    h = accl.create_buffer_like(_data(rank).astype(np.float16))
    r = accl.create_buffer(COUNT, np.float32)
    root = 1
    short = COUNT // 2
    b = accl.create_buffer(short if rank == root else COUNT, np.float32)
    b.host[:] = _data(rank)[:b.length]
    b.sync_to_device()

    def body(a):
        a.allreduce(h, r, COUNT, SUM)
        a.bcast(b, COUNT, root=root, from_fpga=True, to_fpga=True)

    outs = []
    plan = accl.capture_plan(body) if planned else None
    for it in range(iters):
        if it and planned:
            plan.replay()
        elif not planned:
            body(accl)
        b.sync_from_device()
        outs.append([r.host.copy(), b.host.copy()])
        h.host[:] = _data(rank, salt=it + 1).astype(np.float16)
        if rank == root:
            b.host[:] = _data(rank, salt=it + 1)[:short]
            b.sync_to_device()
    return outs


def test_stale_operand_trap():
    """Replays read the widened fp16 operand and the short bcast root as
    they are at each replay, not as they were at arm time: equal to the
    eager calls on the same operands and to the JAX package's replays."""
    iters = 3
    eager = _both(_stale_trap, iters, False)
    planned = _both(_stale_trap, iters, True)
    for lib in ("jax", "torch"):
        _same(eager["jax"][0], eager[lib][0])
        _same(eager["jax"][0], planned[lib][0])
    # the operands did change between iterations
    outs = planned["torch"][0][0]
    assert not np.array_equal(outs[0][0], outs[1][0])
    assert not np.array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[1][1][COUNT // 2:], 0.0)


def test_replay_ring_under_thread_stress():
    """Eight rank threads mixing blocking and async replays of one ring
    with a short switch interval: every generation runs once, in order,
    and the last result is the eager call's."""
    import sys

    n_replays = 40
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with CudaWorld(8, device="cpu") as w:
            w.engine.ring_threshold_bytes = 0

            def fn(accl, rank):
                s = accl.create_buffer_like(_data(rank))
                s.sync_to_device()
                r = accl.create_buffer(COUNT, np.float32)
                plan = accl.capture_plan(lambda a: a.allreduce(
                    s, r, COUNT, ReduceFunction.SUM, from_fpga=True,
                    to_fpga=True))
                window = []
                for i in range(n_replays):
                    if (i + rank) % 3:
                        window.append(plan.replay(run_async=True))
                    else:
                        plan.replay()
                for t in window:
                    assert t.wait(60)
                    t.check()
                r.sync_from_device()
                return r.host.copy(), plan

            outs = w.run(fn, timeout=120)
            ring = w.engine._plan_rings[0]
            assert ring.replays == ring.done_gen == n_replays
            assert w.devices[0].engine_stats()["plan_replays"] == n_replays
        with CudaWorld(8, device="cpu") as w:
            w.engine.ring_threshold_bytes = 0

            def eager(accl, rank):
                s = accl.create_buffer_like(_data(rank))
                r = accl.create_buffer(COUNT, np.float32)
                accl.allreduce(s, r, COUNT, ReduceFunction.SUM)
                return r.host.copy()

            ref = w.run(eager)
    finally:
        sys.setswitchinterval(saved)
    for (got, _plan), want in zip(outs, ref):
        np.testing.assert_array_equal(got, want)
