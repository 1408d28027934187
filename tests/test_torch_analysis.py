"""The port's collective sanitizer (accl_tpu_torch.analysis) against the
JAX package's (accl_tpu.analysis).

- Static checkers: each program of tests/test_analysis.py is recorded
  through both packages' LintWorld (the driver's descriptor stream, no
  execution); the findings must be the same — code, severity, comm,
  ranks, call index and message — and the codes those tests expect.
- Flight-lifecycle checkers: the same merged dumps through both
  packages' checkers give the same findings.
- The runtime lane (``ACCL_SANITIZE``) on CudaWorld(2, device="cpu"):
  a clean program runs, a mismatch raises on both ranks naming both
  calls, an order desync raises, a missing member is named within the
  timeout, a refused call's flight record retires with
  SANITIZER_ABORT_ERROR, and the single-rank checks refuse.
- Shadow capture (CaptureSession) over a CudaWorld run.
"""
import numpy as np
import pytest
import torch

from accl_tpu import DataType as JDataType
from accl_tpu import ReduceFunction as JReduce
from accl_tpu.analysis import LintWorld as JLintWorld
from accl_tpu.analysis import checks as jchecks
from accl_tpu_torch import ACCLError, CudaWorld, DataType, ReduceFunction
from accl_tpu_torch.analysis import CaptureSession, LintWorld, check_programs
from accl_tpu_torch.analysis import checks as tchecks
from accl_tpu_torch.analysis import sanitizer
from accl_tpu_torch.analysis.findings import ERROR, WARNING, has_errors
from accl_tpu_torch.constants import error_code_to_str


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _enums(lib):
    return (JReduce, JDataType) if lib == "jax" else (ReduceFunction,
                                                      DataType)


def _findings(fs):
    return [(f.severity, f.code, f.comm, list(f.ranks), f.index, f.message)
            for f in fs]


def _lint_both(fn, nranks):
    out = {}
    for lib, cls in (("jax", JLintWorld), ("torch", LintWorld)):
        world = cls(nranks)
        world.run(lambda a, r: fn(a, r, lib))
        out[lib] = world.check()
    return out


# ---------------------------------------------------------------------------
# the programs of tests/test_analysis.py, fn(accl, rank, lib)
# ---------------------------------------------------------------------------
def p_clean(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(512, np.float32)
    d = a.create_buffer(512, np.float32)
    g = a.create_buffer(512 * a.size, np.float32)
    a.allreduce(s, d, 512, Red.SUM)
    a.allgather(s, g, 512)
    a.bcast(s, 512, root=1)
    a.barrier()
    req = a.send(s, 512, dst=(r + 1) % a.size, tag=5, run_async=True)
    a.recv(d, 512, src=(r - 1) % a.size, tag=5)
    assert req.wait()
    req.check()
    g.free()


def p_order_desync(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    a.allreduce(s, d, 64, Red.SUM)
    if r == 0:
        a.allreduce(s, d, 64, Red.SUM)
    else:
        a.bcast(s, 64, root=0)


def p_count_mismatch(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(128, np.float32)
    d = a.create_buffer(128, np.float32)
    a.allreduce(s, d, 128 if r == 0 else 96, Red.SUM)


def p_dtype_mismatch(a, r, lib):
    Red, _ = _enums(lib)
    dt = np.float32 if r == 0 else np.float64
    s = a.create_buffer(64, dt)
    d = a.create_buffer(64, dt)
    a.allreduce(s, d, 64, Red.SUM)


def p_root_mismatch(a, r, lib):
    s = a.create_buffer(32, np.float32)
    a.bcast(s, 32, root=r)


def p_missing_call(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    a.allreduce(s, d, 64, Red.SUM)
    if r == 0:
        a.allreduce(s, d, 64, Red.SUM)


def p_head_to_head_sends(a, r, lib):
    peer = 1 - r
    s = a.create_buffer(4096, np.float32)
    d = a.create_buffer(4096, np.float32)
    a.send(s, 4096, dst=peer, tag=0)
    a.recv(d, 4096, src=peer, tag=0)


def p_eager_head_to_head(a, r, lib):
    peer = 1 - r
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    a.send(s, 64, dst=peer, tag=0)
    a.recv(d, 64, src=peer, tag=0)


def p_cross_gang_deadlock(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(4096, np.float32)
    d = a.create_buffer(4096, np.float32)
    if r == 0:
        a.allreduce(s, d, 4096, Red.SUM)
        a.send(s, 4096, dst=1, tag=1)
    else:
        a.recv(d, 4096, src=0, tag=1)
        a.allreduce(s, d, 4096, Red.SUM)


def p_unmatched_send(a, r, lib):
    s = a.create_buffer(4096, np.float32)
    if r == 0:
        a.send(s, 4096, dst=1, tag=9)


def p_unmatched_recv(a, r, lib):
    d = a.create_buffer(64, np.float32)
    if r == 1:
        a.recv(d, 64, src=0, tag=2)


def p_root_invalid(a, r, lib):
    s = a.create_buffer(16, np.float32)
    a.bcast(s, 16, root=7)


def p_peer_invalid(a, r, lib):
    s = a.create_buffer(4096, np.float32)
    if r == 0:
        a.send(s, 4096, dst=5, tag=0, run_async=True).wait()


def p_sub_comm_root(a, r, lib):
    s = a.create_buffer(32, np.float32)
    members = [0, 2]
    if r in members:
        cid = a.create_communicator(members)
        a.bcast(s, 32, root=2, comm_id=cid)


def p_buffer_overlap(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(128, np.float32)
    a.allreduce(s.slice(0, 64), s.slice(32, 96), 64, Red.SUM)


def p_buffer_alias(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    a.allreduce(s, s, 64, Red.SUM)


def p_use_after_free(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    s.free()
    a.allreduce(s, d, 64, Red.SUM)


def p_leaked_request(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    a.allreduce(s, d, 64, Red.SUM, run_async=True)


def p_waited_request(a, r, lib):
    Red, _ = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64, np.float32)
    assert a.allreduce(s, d, 64, Red.SUM, run_async=True).wait()


def p_fan_overlap(a, r, lib):
    big = a.create_buffer(64 + 64 * a.size, np.float32)
    a.allgather(big.slice(0, 64), big.slice(32, 32 + 64 * a.size), 64)


def p_compressed_rooted(a, r, lib):
    _, DT = _enums(lib)
    s = a.create_buffer(64, np.float32)
    d = a.create_buffer(64 * a.size, np.float32) if r == 0 else None
    a.gather(s, d, 64, root=0, compress_dtype=DT.float16)


def p_missing_gang_member(a, r, lib):
    if r != 2:
        a.barrier()


def _grid(row_first_ranks):
    def fn(a, rank, lib):
        row, col = divmod(rank, 2)
        rc = a.create_communicator([row * 2, row * 2 + 1])
        cc = a.create_communicator([col, col + 2])
        s = a.create_buffer(64, np.float32)
        ro = a.create_buffer(128, np.float32)
        co = a.create_buffer(128, np.float32)
        order = [(rc, ro), (cc, co)]
        if rank not in row_first_ranks:
            order.reverse()
        reqs = [a.allgather(s, out, 64, comm_id=cid, run_async=True)
                for cid, out in order]
        for req in reqs:
            req.wait()
            req.check()
    return fn


def p_interleave_cycle(a, rank, lib):
    members = [0, 1, 2]
    cids = [a.create_communicator(members) for _ in range(3)]
    s = a.create_buffer(64, np.float32)
    outs = [a.create_buffer(64 * 3, np.float32) for _ in range(3)]
    reqs = [a.allgather(s, outs[k], 64, comm_id=cids[k], run_async=True)
            for k in (rank, (rank + 1) % 3)]
    for req in reqs:
        req.wait()
        req.check()


#: name -> (program, ranks, the codes tests/test_analysis.py expects)
PROGRAMS = {
    "clean": (p_clean, 4, []),
    "order_desync": (p_order_desync, 2, ["desync-order"]),
    "count_mismatch": (p_count_mismatch, 2, ["param-mismatch"]),
    "dtype_mismatch": (p_dtype_mismatch, 2, ["param-mismatch"]),
    "root_mismatch": (p_root_mismatch, 2, ["param-mismatch"]),
    "missing_call": (p_missing_call, 2, ["desync-missing-call",
                                         "gang-missing-member"]),
    "head_to_head_sends": (p_head_to_head_sends, 2, ["deadlock-cycle"]),
    "eager_head_to_head": (p_eager_head_to_head, 2, []),
    "cross_gang_deadlock": (p_cross_gang_deadlock, 2, ["deadlock-cycle"]),
    "unmatched_send": (p_unmatched_send, 2, ["p2p-unmatched"]),
    "unmatched_recv": (p_unmatched_recv, 2, ["p2p-unmatched"]),
    "root_invalid": (p_root_invalid, 2, ["root-invalid"]),
    "peer_invalid": (p_peer_invalid, 2, ["peer-invalid"]),
    "sub_comm_root": (p_sub_comm_root, 4, ["root-invalid"]),
    "buffer_overlap": (p_buffer_overlap, 2, ["buffer-overlap"]),
    "buffer_alias": (p_buffer_alias, 2, ["buffer-alias"]),
    "use_after_free": (p_use_after_free, 2, ["use-after-free"]),
    "leaked_request": (p_leaked_request, 2, ["leaked-request"]),
    "waited_request": (p_waited_request, 2, []),
    "fan_overlap": (p_fan_overlap, 2, ["buffer-overlap"]),
    "compressed_rooted": (p_compressed_rooted, 2, []),
    "missing_gang_member": (p_missing_gang_member, 3,
                            ["gang-missing-member"]),
    "interleave_divergent": (_grid({0, 1}), 4,
                             ["subcomm-interleave-hazard"]),
    "interleave_agreed": (_grid({0, 1, 2, 3}), 4, []),
    "interleave_cycle": (p_interleave_cycle, 3,
                         ["subcomm-interleave-hazard"]),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_static_findings_equal_the_reference(name):
    fn, nranks, expected = PROGRAMS[name]
    got = _lint_both(fn, nranks)
    assert _findings(got["torch"]) == _findings(got["jax"])
    codes = {f.code for f in got["torch"]}
    assert set(expected) <= codes
    if not expected:
        assert got["torch"] == []
    elif name in ("order_desync", "count_mismatch", "dtype_mismatch",
                  "unmatched_send", "buffer_overlap", "buffer_alias",
                  "leaked_request", "interleave_divergent"):
        assert codes == set(expected)


def test_static_finding_details():
    """The fields tests/test_analysis.py pins, read off the port."""
    f = _lint_both(p_order_desync, 2)["torch"][0]
    assert f.severity == ERROR and f.index == 1 and f.comm == 0
    assert "allreduce" in f.message and "bcast" in f.message
    f = _lint_both(p_head_to_head_sends, 2)["torch"][0]
    assert sorted(f.ranks) == [0, 1] and "send" in f.message
    fs = _lint_both(p_buffer_alias, 2)["torch"]
    assert all(f.severity == WARNING for f in fs) and not has_errors(fs)
    fs = [f for f in _lint_both(p_missing_gang_member, 3)["torch"]
          if f.code == "gang-missing-member"]
    assert fs and all("missing [2]" in f.message for f in fs)
    f = _lint_both(_grid({0, 1}), 4)["torch"][0]
    assert f.ranks == [0, 2] and "divergent order" in f.message
    assert check_programs({}) == []


# ---------------------------------------------------------------------------
# flight-lifecycle checkers over merged dumps
# ---------------------------------------------------------------------------
def _rec(rank, seq, collective, comm=0, state="complete", retcode=0,
         gang=False, t_submit=0, t_complete=0, lane="emu"):
    return {"seq": seq, "req_id": seq, "rank": rank,
            "collective": collective, "comm": comm, "tag": 0,
            "dtype": "float32", "count": 16, "nbytes": 64, "nranks": 2,
            "lane": lane, "state": state, "gang": gang,
            "retcode": retcode, "age_us": 0.0, "t_submit": t_submit,
            "t_queue": 0, "t_gang_ready": 0, "t_dispatch": 0,
            "t_complete": t_complete}


def _dump(rank, records):
    return {"rank": rank, "capacity": 512, "last_completed_seq": -1,
            "records": records}


_ABORT = _rec(0, 1, "abort", retcode=1 << 27, state="aborted", lane="fence")
_HELD = dict(t_complete=0, state="dispatched")
DUMPS = {
    "fence_stale_replay": ("check_fence_staleness", _dump(0, [
        _rec(0, 0, "plan_replay", gang=True), _ABORT,
        _rec(0, 2, "plan_replay", gang=True)]), ["fence-stale-replay"]),
    "fence_recapture": ("check_fence_staleness", _dump(0, [
        dict(_ABORT, seq=0), _rec(0, 1, "plan_capture", lane="plan"),
        _rec(0, 2, "plan_replay", gang=True)]), []),
    "reset_fences_all": ("check_fence_staleness", _dump(0, [
        _rec(0, 0, "allreduce", comm=3, gang=True),
        _rec(0, 1, "reset_errors", comm=-1, lane="fence"),
        _rec(0, 2, "plan_replay", comm=3, gang=True)]),
        ["fence-stale-replay"]),
    "failed_replay_after_fence": ("check_fence_staleness", _dump(0, [
        dict(_ABORT, seq=0),
        _rec(0, 1, "plan_replay", state="aborted", retcode=1 << 27,
             gang=True)]), []),
    "completion_after_teardown": ("check_teardown_completions", _dump(0, [
        _rec(0, 0, "allreduce", gang=True, t_submit=10, t_complete=20),
        _rec(0, 1, "engine_teardown", comm=-1, t_submit=100,
             t_complete=100, lane="lifecycle"),
        _rec(0, 2, "allreduce", gang=True, t_submit=90, t_complete=150)]),
        ["completion-after-teardown"]),
    "lock_order_inversion": ("check_lock_order", {"ranks": [
        _dump(0, [_rec(0, 0, "allreduce", comm=0, gang=True, t_submit=10,
                       **_HELD),
                  _rec(0, 1, "allreduce", comm=1, gang=True, t_submit=20,
                       **_HELD)]),
        _dump(1, [_rec(1, 0, "allreduce", comm=1, gang=True, t_submit=10,
                       **_HELD),
                  _rec(1, 1, "allreduce", comm=0, gang=True, t_submit=20,
                       **_HELD)])]}, ["lock-order-inversion"]),
    "stuck_through_teardown": ("check_stuck_progress", _dump(0, [
        _rec(0, 0, "allreduce", gang=True, t_complete=20),
        _rec(0, 1, "recv", state="dispatched", comm=2, t_submit=30),
        _rec(0, 2, "engine_teardown", comm=-1, t_submit=100,
             t_complete=100, lane="lifecycle")]), ["stuck-progress"]),
    "stuck_midrun": ("check_stuck_progress", _dump(0, [
        _rec(0, 0, "allgather", gang=True, state="queued")]),
        ["stuck-progress"]),
}


@pytest.mark.parametrize("name", list(DUMPS))
def test_lifecycle_findings_equal_the_reference(name):
    checker, doc, expected = DUMPS[name]
    got_j = getattr(jchecks, checker)(doc)
    got_t = getattr(tchecks, checker)(doc)
    assert _findings(got_t) == _findings(got_j)
    assert [f.code for f in got_t] == expected


def test_lifecycle_suite_clean_on_a_replayed_plan():
    """capture -> replay on CudaWorld leaves dumps the lifecycle suite
    reads as clean, with the plan_capture anchor in them."""
    from accl_tpu_torch.observability.flight import merge_flight_dumps

    with CudaWorld(2, device="cpu") as w:
        def fn(accl, rank):
            s = accl.create_buffer_like(np.full(16, rank + 1.0, np.float32))
            d = accl.create_buffer(16, np.float32)
            plan = accl.capture_plan(lambda a: a.allreduce(s, d, 16))
            plan.replay()
            return d.host.copy()

        outs = w.run(fn)
        doc = merge_flight_dumps([a.flight_recorder.dump() for a in w.accls])
    np.testing.assert_array_equal(outs[0], 3.0)
    names = [r["collective"] for r in doc["ranks"][0]["records"]]
    assert "plan_capture" in names and "plan_replay" in names
    assert [f for f in tchecks.check_flight_lifecycle(doc)
            if f.severity == ERROR] == []


# ---------------------------------------------------------------------------
# the runtime lane on CudaWorld
# ---------------------------------------------------------------------------
@pytest.fixture
def sanitize():
    sanitizer._reset_exchange()
    sanitizer.set_enabled(True)
    try:
        yield
    finally:
        sanitizer.set_enabled(False)
        sanitizer._reset_exchange()


@pytest.fixture
def world():
    with CudaWorld(2, device="cpu") as w:
        yield w


def test_sanitize_off_by_default():
    assert not sanitizer.active()
    assert not sanitizer.enabled()


def test_sanitizer_clean_program_unaffected(sanitize, world):
    def fn(a, r):
        s = a.create_buffer_like(np.arange(64, dtype=np.float32) + r)
        d = a.create_buffer(64, np.float32)
        a.allreduce(s, d, 64, ReduceFunction.SUM)
        return d.host.copy()

    outs = world.run(fn)
    expect = np.arange(64, dtype=np.float32) * 2 + 1
    np.testing.assert_array_equal(outs[0], expect)
    np.testing.assert_array_equal(outs[1], expect)


def test_sanitizer_turns_mismatch_into_error_on_both_ranks(sanitize, world):
    """The would-hang mismatched program raises at once on EVERY rank,
    naming both divergent calls with their flight seqs, and no gang was
    left assembling in the engine."""
    def fn(a, r):
        s = a.create_buffer(64, np.float32)
        d = a.create_buffer(64, np.float32)
        with pytest.raises(ACCLError) as exc:
            a.allreduce(s, d, 64 if r == 0 else 32, ReduceFunction.SUM)
        msg = str(exc.value)
        assert "cross-rank call mismatch" in msg
        assert "count=64" in msg and "count=32" in msg
        assert "flight seq" in msg
        return msg

    world.run(fn, timeout=60)
    assert world.engine.gang_assembly_snapshot() == []


def test_sanitizer_order_desync_raises(sanitize, world):
    def fn(a, r):
        s = a.create_buffer(64, np.float32)
        d = a.create_buffer(64, np.float32)
        with pytest.raises(ACCLError, match="cross-rank call mismatch"):
            if r == 0:
                a.allreduce(s, d, 64, ReduceFunction.SUM)
            else:
                a.bcast(s, 64, root=0)

    world.run(fn, timeout=60)


def test_sanitizer_missing_member_times_out_with_names(sanitize, world,
                                                       monkeypatch):
    monkeypatch.setenv("ACCL_SANITIZE_TIMEOUT", "0.5")

    def fn(a, r):
        if r != 0:
            return None
        s = a.create_buffer(64, np.float32)
        d = a.create_buffer(64, np.float32)
        with pytest.raises(ACCLError, match=r"missing \[1\]"):
            a.allreduce(s, d, 64, ReduceFunction.SUM)
        return True

    assert world.run(fn, timeout=60)[0] is True


def test_sanitizer_single_rank_checks(sanitize, world):
    def fn(a, r):
        s = a.create_buffer(128, np.float32)
        with pytest.raises(ACCLError, match="root 9 is outside"):
            a.bcast(s, 128, root=9)
        with pytest.raises(ACCLError, match="partially overlaps"):
            a.allreduce(s.slice(0, 64), s.slice(32, 96), 64,
                        ReduceFunction.SUM)
        with pytest.raises(ACCLError, match="unknown communicator"):
            a.allreduce(s, s, 64, ReduceFunction.SUM, comm_id=4)

    world.run(fn, timeout=60)


def test_sanitizer_abort_retires_flight_record(sanitize, world):
    """A refused call leaves the watchdog's in-flight scan: its flight
    record finishes with the sanitizer's own retcode."""
    def fn(a, r):
        s = a.create_buffer(64, np.float32)
        d = a.create_buffer(64, np.float32)
        with pytest.raises(ACCLError):
            a.allreduce(s, d, 64 if r == 0 else 32, ReduceFunction.SUM)
        last = a.flight_recorder.records()[-1]
        assert not last.in_flight
        assert "SANITIZER_ABORT_ERROR" in error_code_to_str(last.retcode)

    world.run(fn, timeout=60)


def test_shadow_capture_session(world):
    with CaptureSession() as cap:
        def fn(a, r):
            s = a.create_buffer(64, np.float32)
            d = a.create_buffer(64, np.float32)
            a.allreduce(s, d, 64, ReduceFunction.SUM)

        world.run(fn)
        assert sanitizer.active()
    assert not sanitizer.active()  # uninstalled on exit
    assert sorted(cap.programs) == [0, 1]
    assert [c.op.name for c in cap.programs[0].calls] == ["allreduce"]
    assert cap.check() == []
