"""Fault tolerance in the port (accl_tpu_torch.resilience, the driver's
abort/shrink/grow/reset surface, the native emulator and CudaWorld's
engine fence): twins of tests/test_resilience.py and
tests/test_fault_injection.py on the port's EmuWorld, and of the
elastic test of tests/test_tpu_backend.py on CudaWorld(4, "cpu").

Where the result is deterministic (RetryPolicy.from_env, ChaosPlan and
RecoveryPolicy parses, probe_alive's validation) it is held to the JAX
package's.  Worlds have 2-4 ranks and close inside their test; engine
receive budgets are cut to fractions of a second so the detection drills
stay short, every wait passes a timeout of 30 s or less, and no sleep is
longer than 50 ms.
"""
import threading
import time

import numpy as np
import pytest

from accl_tpu.resilience import chaos as jchaos
from accl_tpu.resilience import membership as jmembership
from accl_tpu.resilience import retry as jretry
from accl_tpu.resilience import supervisor as jsupervisor
from accl_tpu_torch import (
    ACCLError,
    ChaosPlan,
    CudaWorld,
    ReduceFunction,
    RecoveryPolicy,
    RetryPolicy,
)
from accl_tpu_torch.backends.emu import EmuDevice, EmuWorld
from accl_tpu_torch.communicator import Communicator, Rank
from accl_tpu_torch.constants import ErrorCode
from accl_tpu_torch.observability import flight as obs_flight
from accl_tpu_torch.observability import health as obs_health
from accl_tpu_torch.observability import metrics as obs_metrics
from accl_tpu_torch.resilience import membership
from accl_tpu_torch.resilience.elastic import admit_pending

COUNT = 32
T = 30  # the wait budget of every run and request, seconds
SUM = ReduceFunction.SUM


def _data(count, salt=0):
    rng = np.random.default_rng(910 + salt)
    return rng.standard_normal(count).astype(np.float32)


def _wait_until(pred, budget_s=T):
    deadline = time.monotonic() + budget_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the policies and the grammar, held to the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env", [{}, {"ACCL_RETRY_MAX": "7",
                                      "ACCL_RETRY_BASE_US": "333"},
                                 {"ACCL_RETRY_MAX": "0"},
                                 {"ACCL_RETRY_BASE_US": "3e3"}])
def test_retry_policy_from_env_equals_reference(monkeypatch, env):
    for k in ("ACCL_RETRY_MAX", "ACCL_RETRY_BASE_US"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, ref = RetryPolicy.from_env(), jretry.RetryPolicy.from_env()
    assert (mine.max_retries, mine.base_us, mine.enabled) == \
        (ref.max_retries, ref.base_us, ref.enabled)
    for attempt in range(5):
        for rank, seqn in ((0, 0), (1, 5), (3, 1 << 20)):
            assert mine.backoff_us(attempt, rank, seqn) == \
                ref.backoff_us(attempt, rank, seqn)
    assert mine.worst_case_recovery_us() == ref.worst_case_recovery_us()


CHAOS_SPECS = ("seed=42,drop=0.01,dup=0.02,delay=0.03,delay_us=500,"
               "corrupt=0.004,slow_rank=2:750,kill_rank=3",
               "seed=5,kill_rank=2,join_rank=2",
               "seed=0x10,drop_rank=1:0.2,drop_rank=0,slow_rank=3",
               "seed=7, delay=0.5 ,", "")


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_plan_parses_as_the_reference(spec):
    mine, ref = ChaosPlan.parse(spec), jchaos.ChaosPlan.parse(spec)
    assert vars(mine) == vars(ref)
    assert mine.spec() == ref.spec()
    assert mine.probabilistic == ref.probabilistic
    assert ChaosPlan.parse(mine.spec()) == mine


@pytest.mark.parametrize("bad", ["drop", "drop=2.0", "wat=1", "slow_rank=x",
                                 "join_rank=x", "drop_rank=1:1.5"])
def test_chaos_plan_rejects_as_the_reference(bad):
    with pytest.raises(ACCLError) as mine:
        ChaosPlan.parse(bad)
    with pytest.raises(Exception) as ref:
        jchaos.ChaosPlan.parse(bad)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("env", [
    {}, {"ACCL_RECOVERY": "grow", "ACCL_JOIN_WAIT_S": "2.5"},
    {"ACCL_RECOVERY": "halt", "ACCL_RECOVERY_MAX_ROUNDS": "9",
     "ACCL_PROBE_WINDOW_S": "0.25"},
    {"ACCL_RECOVERY": "pray"}, {"ACCL_JOIN_WAIT_S": "soon"},
    {"ACCL_RECOVERY_MAX_ROUNDS": "0"}, {"ACCL_PROBE_WINDOW_S": "0"}])
def test_recovery_policy_parses_as_the_reference(monkeypatch, env):
    for k in ("ACCL_RECOVERY", "ACCL_JOIN_WAIT_S",
              "ACCL_RECOVERY_MAX_ROUNDS", "ACCL_PROBE_WINDOW_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        ref = jsupervisor.RecoveryPolicy()
    except Exception as e:  # noqa: BLE001 — the same error is expected
        with pytest.raises(ACCLError) as mine:
            RecoveryPolicy()
        assert str(mine.value) == str(e)
        return
    mine = RecoveryPolicy()
    assert vars(mine) == vars(ref) and repr(mine) == repr(ref)


def test_env_knobs_raise_naming_errors(monkeypatch):
    monkeypatch.setenv("ACCL_RETRY_MAX", "lots")
    with pytest.raises(ACCLError, match="ACCL_RETRY_MAX"):
        RetryPolicy.from_env()
    monkeypatch.setenv("ACCL_RETRY_MAX", "-3")
    with pytest.raises(ACCLError, match="ACCL_RETRY_MAX"):
        RetryPolicy.from_env()
    monkeypatch.delenv("ACCL_RETRY_MAX")
    monkeypatch.setenv("ACCL_RETRY_BASE_US", "fast")
    with pytest.raises(ACCLError, match="ACCL_RETRY_BASE_US"):
        RetryPolicy.from_env()


class _FakeAccl:
    """Just enough driver for probe_alive: one comm and a probe."""

    def __init__(self, comm_cls, rank_cls, size, local, answer):
        self._comm = comm_cls([rank_cls(session=i) for i in range(size)],
                              local)
        self.device = type("Dev", (), {"probe_liveness": staticmethod(
            lambda c, n, w: answer)})()

    def communicator(self, comm_id):
        return self._comm


@pytest.mark.parametrize("answer,window", [
    ([True, True, True, False], 0.5), ([True], 0.5), (None, 0.5),
    ([False, True, False], 0.5), ([True, True, True], 0.0),
    ([True, True, True], -1.0)])
def test_probe_alive_validation_as_the_reference(answer, window):
    from accl_tpu.communicator import Communicator as JComm
    from accl_tpu.communicator import Rank as JRank

    mine = _FakeAccl(Communicator, Rank, 3, 1, answer)
    ref = _FakeAccl(JComm, JRank, 3, 1, answer)
    try:
        want = jmembership.probe_alive(ref, 0, window_s=window)
    except Exception as e:  # noqa: BLE001 — the same error is expected
        with pytest.raises(ACCLError) as got:
            membership.probe_alive(mine, 0, window_s=window)
        assert str(got.value) == str(e)
        return
    assert membership.probe_alive(mine, 0, window_s=window) == want


# ---------------------------------------------------------------------------
# retransmission: one-shot faults heal; with retry_max=0 they classify
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", [
    EmuDevice.FAULT_DROP, EmuDevice.FAULT_DUPLICATE,
    EmuDevice.FAULT_CORRUPT_SEQ, EmuDevice.FAULT_DELAY,
], ids=["drop", "dup", "corrupt", "delay"])
def test_p2p_recovers_from_one_shot_fault(fault):
    with EmuWorld(2) as world:
        def fn(accl, rank):
            accl.set_timeout(10_000_000)
            if rank == 0:
                a = accl.create_buffer_like(_data(COUNT, salt=1))
                b = accl.create_buffer_like(_data(COUNT, salt=2))
                accl.device.inject_fault(fault)
                accl.send(a, COUNT, 1, tag=7)
                accl.send(b, COUNT, 1, tag=8)
            else:
                da = accl.create_buffer(COUNT, np.float32)
                db = accl.create_buffer(COUNT, np.float32)
                accl.recv(da, COUNT, 0, tag=7)
                accl.recv(db, COUNT, 0, tag=8)
                np.testing.assert_array_equal(da.host, _data(COUNT, salt=1))
                np.testing.assert_array_equal(db.host, _data(COUNT, salt=2))

        world.run(fn, timeout=T)
        if fault in (EmuDevice.FAULT_DROP, EmuDevice.FAULT_CORRUPT_SEQ):
            stats = world.resilience_stats()
            assert sum(s["nacks_tx"] for s in stats) >= 1
            assert sum(s["retrans_sent"] for s in stats) >= 1
            assert world.accls[0].resilience_stats() == stats[0]


@pytest.mark.parametrize("fault", [EmuDevice.FAULT_DROP,
                                   EmuDevice.FAULT_DUPLICATE],
                         ids=["drop", "dup"])
def test_allreduce_recovers_from_one_shot_fault(fault):
    with EmuWorld(2) as world:
        def fn(accl, rank):
            accl.set_timeout(10_000_000)
            s = accl.create_buffer_like(_data(COUNT, salt=rank))
            r = accl.create_buffer(COUNT, np.float32)
            if rank == 0:
                accl.device.inject_fault(fault)
            accl.allreduce(s, r, COUNT, SUM)
            return r.host.copy()

        outs = world.run(fn, timeout=T)
    want = _data(COUNT, salt=0) + _data(COUNT, salt=1)
    for out in outs:
        np.testing.assert_array_equal(out, want)


def test_wildcard_recv_recovers_dropped_tagged_send():
    with EmuWorld(2) as world:
        def fn(accl, rank):
            accl.set_timeout(10_000_000)
            if rank == 0:
                a = accl.create_buffer_like(_data(COUNT, salt=9))
                accl.device.inject_fault(EmuDevice.FAULT_DROP)
                accl.send(a, COUNT, 1, tag=5)
            else:
                da = accl.create_buffer(COUNT, np.float32)
                accl.recv(da, COUNT, 0)  # TAG_ANY
                np.testing.assert_array_equal(da.host, _data(COUNT, salt=9))

        world.run(fn, timeout=T)
        assert sum(s["retrans_sent"] for s in world.resilience_stats()) >= 1


def _detect(fault, tag, want_bit):
    def fn(accl, rank):
        accl.set_timeout(300_000)  # 0.3 s receive budget
        if rank == 0:
            src = accl.create_buffer_like(_data(COUNT))
            accl.device.inject_fault(fault)
            accl.send(src, COUNT, 1, tag=tag)
        else:
            dst = accl.create_buffer(COUNT, np.float32)
            with pytest.raises(ACCLError) as e:
                accl.recv(dst, COUNT, 0, tag=tag)
            assert e.value.code & int(want_bit)
    return fn


@pytest.mark.parametrize("fault,want", [
    (EmuDevice.FAULT_DROP, ErrorCode.RECEIVE_TIMEOUT_ERROR),
    (EmuDevice.FAULT_CORRUPT_SEQ, ErrorCode.PACK_SEQ_NUMBER_ERROR)],
    ids=["drop_times_out", "corrupt_seqn_detected"])
def test_retry_disabled_classifies_and_reset_reuses_the_world(fault, want):
    # tests/test_fault_injection.py: detection with the lane off, then
    # reset_errors hands the world back usable
    with EmuWorld(2, retry_max=0) as world:
        world.run(_detect(fault, 1, want), timeout=T)
        world.reset_errors()

        def after(accl, rank):
            s = accl.create_buffer_like(_data(COUNT, salt=rank))
            r = accl.create_buffer(COUNT, np.float32)
            accl.allreduce(s, r, COUNT, SUM)
            return r.host.copy()

        outs = world.run(after, timeout=T)
    for out in outs:
        np.testing.assert_array_equal(out, _data(COUNT, salt=0)
                                      + _data(COUNT, salt=1))


def test_retry_disabled_duplicate_and_ahead_of_sequence_survive():
    with EmuWorld(2, retry_max=0) as world:
        def fn(accl, rank):
            accl.set_timeout(5_000_000)
            if rank == 0:
                a = accl.create_buffer_like(_data(COUNT, salt=11))
                b = accl.create_buffer_like(_data(COUNT, salt=12))
                accl.device.inject_fault(EmuDevice.FAULT_DUPLICATE)
                accl.send(a, COUNT, 1, tag=3)
                accl.send(b, COUNT, 1, tag=4)
                accl.send(a, COUNT, 1, tag=21)
                accl.send(b, COUNT, 1, tag=22)
            else:
                da = accl.create_buffer(COUNT, np.float32)
                db = accl.create_buffer(COUNT, np.float32)
                accl.recv(da, COUNT, 0, tag=3)
                accl.recv(db, COUNT, 0, tag=4)
                # recvs in another tag order than the sends: a sequence
                # error that leaves the valid future message queued
                accl.set_timeout(300_000)
                with pytest.raises(ACCLError) as e:
                    accl.recv(db, COUNT, 0, tag=22)
                assert e.value.code & int(ErrorCode.PACK_SEQ_NUMBER_ERROR)
                accl.set_timeout(5_000_000)
                accl.recv(da, COUNT, 0, tag=21)
                accl.recv(db, COUNT, 0, tag=22)
                np.testing.assert_array_equal(da.host, _data(COUNT, salt=11))
                np.testing.assert_array_equal(db.host, _data(COUNT, salt=12))

        world.run(fn, timeout=T)


# ---------------------------------------------------------------------------
# the seeded chaos matrix, bitwise
# ---------------------------------------------------------------------------
def _collective_matrix(world, nranks):
    def fn(accl, rank):
        got = {}
        s = accl.create_buffer_like(_data(COUNT, salt=rank))
        r = accl.create_buffer(COUNT, np.float32)
        big_s = accl.create_buffer_like(np.concatenate(
            [_data(COUNT, salt=100 * rank + i) for i in range(nranks)]))
        big_r = accl.create_buffer(COUNT * nranks, np.float32)
        nxt, prv = (rank + 1) % nranks, (rank - 1) % nranks
        if rank % 2 == 0:
            accl.send(s, COUNT, nxt, tag=50)
            accl.recv(r, COUNT, prv, tag=50)
        else:
            accl.recv(r, COUNT, prv, tag=50)
            accl.send(s, COUNT, nxt, tag=50)
        got["sendrecv"] = r.host.copy()
        accl.bcast(s if rank == 0 else r, COUNT, root=0)
        got["bcast"] = (s if rank == 0 else r).host.copy()
        accl.allgather(s, big_r, COUNT)
        got["allgather"] = big_r.host.copy()
        accl.allreduce(s, r, COUNT, SUM)
        got["allreduce"] = r.host.copy()
        accl.reduce_scatter(big_s, r, COUNT, SUM)
        got["reduce_scatter"] = r.host.copy()
        accl.alltoall(big_s, big_r, COUNT)
        got["alltoall"] = big_r.host.copy()
        accl.barrier()
        return got

    return world.run(fn, timeout=T)


@pytest.mark.parametrize("nranks,plan", [
    (3, "seed=11,drop=0.05"), (3, "seed=12,dup=0.05"),
    (3, "seed=13,delay=0.08,delay_us=3000"),
    (3, "seed=14,drop=0.03,dup=0.03,delay=0.03,delay_us=2000"),
    (2, "seed=15,drop=0.05,dup=0.05")],
    ids=["drop", "dup", "delay", "mixed", "two_ranks"])
def test_chaos_matrix_bitwise_against_a_clean_world(nranks, plan):
    with EmuWorld(nranks, chaos=plan) as world:
        for a in world.accls:
            a.set_timeout(15_000_000)
        chaotic = _collective_matrix(world, nranks)
        retrans = sum(s["retrans_sent"] for s in world.resilience_stats())
    with EmuWorld(nranks, chaos="") as world:
        clean = _collective_matrix(world, nranks)
    for r in range(nranks):
        for key, val in clean[r].items():
            assert val.tobytes() == chaotic[r][key].tobytes(), (r, key)
        np.testing.assert_array_equal(clean[r]["sendrecv"],
                                      _data(COUNT, salt=(r - 1) % nranks))
    if "drop" in plan:
        assert retrans >= 1


# ---------------------------------------------------------------------------
# abort and epoch fencing
# ---------------------------------------------------------------------------
def test_abort_wakes_blocked_waiter():
    with EmuWorld(2) as world:
        posted = threading.Event()

        def fn(accl, rank):
            accl.set_timeout(60_000_000)  # a 60 s receive budget
            if rank == 1:
                dst = accl.create_buffer(COUNT, np.float32)
                t0 = time.monotonic()
                posted.set()
                with pytest.raises(ACCLError) as e:
                    accl.recv(dst, COUNT, 0, tag=3)  # never sent
                assert time.monotonic() - t0 < 10.0
                assert e.value.code & int(ErrorCode.COMM_ABORTED)
            else:
                assert posted.wait(T)
                time.sleep(0.05)
                accl.abort(0)

        world.run(fn, timeout=T)


def test_abort_wakes_bare_request_wait_and_retires_the_record():
    with EmuWorld(2) as world:
        reqs = {}

        def issue(accl, rank):
            if rank == 1:
                dst = accl.create_buffer(COUNT, np.float32)
                reqs[1] = accl.recv(dst, COUNT, 0, tag=4, run_async=True)

        world.run(issue, timeout=T)
        t0 = time.monotonic()
        world.accls[0].abort(0, error=int(ErrorCode.RANK_FAILED))
        assert reqs[1].wait(timeout=T)
        assert time.monotonic() - t0 < 10.0
        assert reqs[1].aborted
        assert reqs[1].retcode & int(ErrorCode.RANK_FAILED)
        with pytest.raises(ACCLError):
            reqs[1].check()
        rec = reqs[1].flight
        assert obs_flight.STATE_NAMES[rec.state] == "aborted"
        assert not rec.in_flight
        merged = obs_flight.merge_flight_dumps(
            [a.flight_recorder.dump() for a in world.accls])
        assert not [h for h in merged["analysis"]["hangs"] if h["tag"] == 4]
        world.watchdog.check()
        assert world.watchdog._health == obs_health.HEALTH_ABORTED
        # the fence event is in the aborting rank's ring
        events = [r.collective for r in world.accls[0].flight_recorder
                  .records()]
        assert "abort" in events


def test_aborted_comm_fails_fast_and_fenced_epoch_drops():
    with EmuWorld(2) as world:
        # a chaos delay holds rank 0's segment across the abort; released
        # under the dead epoch, rank 1's ingress must fence it
        world.devices[0].set_chaos(seed=1, drop_ppm=0, dup_ppm=0,
                                   delay_ppm=0, delay_us=200_000,
                                   corrupt_ppm=0, slow_us=0)

        def fn(accl, rank):
            accl.set_timeout(2_000_000)
            if rank == 0:
                src = accl.create_buffer_like(_data(COUNT))
                accl.device.inject_fault(EmuDevice.FAULT_DELAY)
                accl.send(src, COUNT, 1, tag=6)  # held for 0.2 s
                accl.abort(0)
                with pytest.raises(ACCLError) as e:
                    accl.send(src, COUNT, 1, tag=7)
                assert e.value.code & int(ErrorCode.COMM_ABORTED)
            else:
                _wait_until(lambda: accl.resilience_stats()["fenced_drops"]
                            >= 1)

        world.run(fn, timeout=T)


def test_double_abort_is_idempotent():
    with EmuWorld(2) as world:
        posted = threading.Event()

        def fn(accl, rank):
            if rank == 0:
                assert posted.wait(T)
                time.sleep(0.05)
                accl.abort(0)
                accl.abort(0)
                with pytest.raises(ACCLError):
                    accl.barrier()
            else:
                dst = accl.create_buffer(COUNT, np.float32)
                posted.set()
                with pytest.raises(ACCLError) as e:
                    accl.recv(dst, COUNT, 0, tag=9)
                assert e.value.code & int(ErrorCode.COMM_ABORTED)
                accl.abort(0)

        world.run(fn, timeout=T)
        assert world.devices[0].comm_epoch(0) >= 1
        assert world.devices[1].comm_epoch(0) >= 1


@pytest.mark.parametrize("kind", ["emu", "cuda"])
def test_watchdog_action_abort_recovers_hang(kind, monkeypatch):
    monkeypatch.setenv("ACCL_WATCHDOG_TIMEOUT", "0.5")
    monkeypatch.setenv("ACCL_WATCHDOG_ACTION", "abort")
    monkeypatch.setenv("ACCL_WATCHDOG_DUMP", "")
    world = (EmuWorld(3) if kind == "emu"
             else CudaWorld(3, device="cpu"))
    with world:
        watchdog = (world.watchdog if kind == "emu"
                    else world.engine._watchdog)
        reqs = {}

        def issue(accl, rank):
            if rank == 0:
                return  # withheld: never joins the gang
            s = accl.create_buffer_like(_data(COUNT, salt=rank))
            r = accl.create_buffer(COUNT, np.float32)
            reqs[rank] = accl.allreduce(s, r, COUNT, SUM, run_async=True)

        world.run(issue, timeout=T)
        for rank in (1, 2):
            assert reqs[rank].wait(timeout=T)
            assert reqs[rank].aborted
            assert reqs[rank].retcode & int(ErrorCode.RANK_FAILED)
        assert watchdog.last_report is not None


# ---------------------------------------------------------------------------
# liveness, shrink, grow and the supervisor
# ---------------------------------------------------------------------------
def test_probe_liveness_names_dead_rank():
    with EmuWorld(3) as world:
        world.kill_rank(2)

        def fn(accl, rank):
            if rank != 2:
                return accl.device.probe_liveness(0, 3, window_s=0.3)

        outs = world.run(fn, timeout=T)
    assert outs[0] == [True, True, False] == outs[1]


def test_kill_abort_shrink_rerun():
    nranks = 3
    with EmuWorld(nranks) as world:
        world.kill_rank(2)

        def fn(accl, rank):
            if rank == 2:
                return None
            accl.set_timeout(500_000)
            s = accl.create_buffer_like(_data(COUNT, salt=rank))
            r = accl.create_buffer(COUNT, np.float32)
            if rank == 0:  # its ring predecessor is the dead rank
                with pytest.raises(ACCLError):
                    accl.allreduce(s, r, COUNT, SUM)
            else:
                try:
                    accl.allreduce(s, r, COUNT, SUM)
                except ACCLError:
                    pass
            accl.abort(0, error=int(ErrorCode.RANK_FAILED))
            new_comm = accl.shrink_communicator(0, window_s=0.3)
            assert accl.communicator(new_comm).size == nranks - 1
            accl.set_timeout(5_000_000)
            accl.allreduce(s, r, COUNT, SUM, comm_id=new_comm)
            return r.host.copy()

        outs = world.run(fn, timeout=T)
    want = _data(COUNT, salt=0) + _data(COUNT, salt=1)
    for r in range(2):
        np.testing.assert_array_equal(outs[r], want)


@pytest.mark.parametrize("kind", ["emu", "cuda"])
def test_all_alive_shrinks_mint_identical_ids(kind):
    world = EmuWorld(3) if kind == "emu" else CudaWorld(3, device="cpu")
    with world:
        def fn(accl, rank):
            ids = [accl.shrink_communicator(0, window_s=0.2)
                   for _ in range(3)]
            assert accl.communicator(ids[-1]).size == 3
            s = accl.create_buffer_like(_data(8, salt=rank))
            r = accl.create_buffer(8, np.float32)
            accl.allreduce(s, r, 8, SUM, comm_id=ids[-1])
            return ids, r.host.copy()

        outs = world.run(fn, timeout=T)
    assert {tuple(o[0]) for o in outs} == {(1, 2, 3)}
    want = np.sum([_data(8, salt=q) for q in range(3)], axis=0)
    for _ids, out in outs:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_spawn_replacement_grows_a_healthy_world():
    with EmuWorld(2) as world:
        joiner = world.spawn_replacement()
        out = {}

        def joiner_thread():
            cid = out["comm"] = joiner.join(timeout_s=T)
            s = joiner.accl.create_buffer_like(np.full(8, 4.0, np.float32))
            r = joiner.accl.create_buffer(8, np.float32)
            joiner.accl.allreduce(s, r, 8, SUM, comm_id=cid)
            out["result"] = r.host.copy()

        jt = threading.Thread(target=joiner_thread, daemon=True)
        jt.start()

        def fn(accl, rank):
            new_comm, n = admit_pending(accl, 0, world.board, wait_s=5.0,
                                        window_s=0.3)
            assert n == 1
            s = accl.create_buffer_like(np.full(8, float(rank + 1),
                                                np.float32))
            r = accl.create_buffer(8, np.float32)
            accl.allreduce(s, r, 8, SUM, comm_id=new_comm)
            accl.barrier(comm_id=0)  # growing drained nothing
            return new_comm, r.host.copy()

        res = world.run(fn, timeout=T)
        jt.join(timeout=T)
        assert not jt.is_alive()
        assert res[0][0] == res[1][0] == out["comm"] == 1
        for got in (res[0][1], res[1][1], out["result"]):
            np.testing.assert_array_equal(got, np.full(8, 7.0, np.float32))
        assert joiner.device.join_stats()["joined"] == 1
        assert sum(world.devices[r].join_stats()["sponsored"]
                   for r in range(2)) == 1


def test_placeholder_comms_fail_fast_on_joiner():
    with EmuWorld(2) as world:
        joiner = world.spawn_replacement()
        out = {}
        jt = threading.Thread(
            target=lambda: out.update(comm=joiner.join(timeout_s=T)),
            daemon=True)
        jt.start()

        def fn(accl, rank):
            accl.create_communicator([0, 1])  # id 1, unseen by the joiner
            return admit_pending(accl, 0, world.board, wait_s=5.0,
                                 window_s=0.3)[0]

        res = world.run(fn, timeout=T)
        jt.join(timeout=T)
        assert res[0] == out["comm"] == 2
        with pytest.raises(ACCLError, match="placeholder"):
            joiner.accl.communicator(1)
        s = joiner.accl.create_buffer_like(np.ones(4, np.float32))
        r = joiner.accl.create_buffer(4, np.float32)
        with pytest.raises(ACCLError, match="placeholder"):
            joiner.accl.allreduce(s, r, 4, SUM, comm_id=1)


def test_supervisor_shrink_policy_finishes_smaller():
    nranks, iters, count = 3, 3, 16
    with EmuWorld(nranks) as world:
        for a in world.accls:
            a.set_timeout(500_000)

        def supervised(accl, rank):
            sup = accl.supervise(policy=RecoveryPolicy(
                mode="shrink", probe_window_s=0.3), board=world.board)
            outs = {}

            def step(a, comm_id, it):
                if rank == 2 and it == 1:
                    world.kill_rank(2)
                comm = a.communicator(comm_id)
                s = a.create_buffer_like(
                    _data(count, salt=comm.local_rank + 7 * it))
                r = a.create_buffer(count, np.float32)
                a.allreduce(s, r, count, SUM, comm_id=comm_id)
                outs[it] = (comm.size, r.host.copy())

            try:
                sup.run_loop(step, iters, comm_id=0,
                             on_restart=lambda i: [outs.pop(k) for k in
                                                   list(outs) if k >= i])
            except ACCLError as e:
                assert rank == 2 and "isolated" in str(e)
                return "dead", sup.state_log
            return outs, sup.state_log

        res = world.run(supervised, timeout=T)
    assert res[2][0] == "dead"
    for r in (0, 1):
        outs, log = res[r]
        assert sorted(outs) == list(range(iters))
        assert outs[iters - 1][0] == 2
        states = [s for _t, s, _d in log]
        for needed in ("abort", "probe", "shrink", "agree", "resume"):
            assert needed in states, (needed, states)


def test_supervisor_health_gauge_recovering():
    reg = obs_metrics.MetricsRegistry()
    obs_health.note_recovering(reg, True)
    assert reg.snapshot()["gauges"]["accl_health"] == \
        obs_health.HEALTH_RECOVERING
    obs_health.note_recovering(reg, False)
    assert reg.snapshot()["gauges"]["accl_health"] == obs_health.HEALTH_OK


def test_supervise_is_armed_by_the_environment(monkeypatch):
    monkeypatch.setenv("ACCL_SUPERVISE", "1")
    with CudaWorld(2, device="cpu") as world:
        assert all(a.supervisor is not None for a in world.accls)
        assert world.accls[0].supervisor.policy.mode == "shrink"
    monkeypatch.setenv("ACCL_SUPERVISE", "0")
    with CudaWorld(2, device="cpu") as world:
        assert world.accls[0].supervisor is None


# ---------------------------------------------------------------------------
# CudaWorld: the engine fence (tests/test_tpu_backend.py:1000-1092)
# ---------------------------------------------------------------------------
def _cdata(count, rank, salt=0):
    rng = np.random.default_rng(100 + rank + 37 * salt)
    return rng.standard_normal(count).astype(np.float32)


def test_cuda_world_partial_gang_rebuild_abort_join_grow():
    n = 4
    barrier = threading.Barrier(n, timeout=T)
    state = {}
    with CudaWorld(n, device="cpu") as world:
        world.engine.ring_threshold_bytes = 0  # the ring lane throughout

        def fn(accl, rank):
            if rank != 3:
                assert accl.create_communicator([0, 1, 2]) == 1
            barrier.wait()
            if rank == 1:  # a partial gang on comm 1
                s = accl.create_buffer_like(_cdata(COUNT, rank))
                r = accl.create_buffer(COUNT, np.float32)
                state["partial"] = accl.allreduce(s, r, COUNT, SUM,
                                                  comm_id=1, run_async=True)
            if rank == 2:  # a pending receive on comm 1
                d = accl.create_buffer(COUNT, np.float32)
                state["precv"] = accl.recv(d, COUNT, 0, tag=77, comm_id=1,
                                           run_async=True)
            barrier.wait()
            if rank == 0:
                st = accl.device.export_join_state(1)
                assert st["comm_count"] == 2 and st["members"] == [0, 1, 2]
                assert accl.device.rebuild_gang_tables(1) >= 2
            barrier.wait()
            if rank == 1:
                assert state["partial"].wait(T) and state["partial"].aborted
                with pytest.raises(ACCLError):
                    state["partial"].check()
            if rank == 2:
                assert state["precv"].wait(T) and state["precv"].aborted
            if rank == 0:
                accl.abort(1, error=int(ErrorCode.RANK_FAILED))
                assert accl.device.export_join_state(1)["aborted"] == {
                    1: int(ErrorCode.RANK_FAILED | ErrorCode.COMM_ABORTED)}
            barrier.wait()
            if rank in (1, 2):
                # this driver never aborted: the engine refuses the call
                s = accl.create_buffer(COUNT, np.float32)
                with pytest.raises(ACCLError) as e:
                    accl.allreduce(s, s, COUNT, SUM, comm_id=1)
                assert e.value.code & int(ErrorCode.RANK_FAILED)
            new_row = Rank(ip="127.0.0.1", port=0, session=3)
            if rank == 3:
                assert accl.device.join_sync(0) == 0
                assert accl.device.comm_count() == 2
                accl._pad_communicators(2)
                with pytest.raises(ACCLError, match="placeholder"):
                    accl.communicator(1)
            barrier.wait()
            if rank != 3:
                gid = accl.grow_communicator([new_row], comm_id=1,
                                             window_s=0.2)
            else:
                rows = [Rank(ip="127.0.0.1", port=0, session=i)
                        for i in range(3)] + [new_row]
                gid = accl._install_communicator(
                    Communicator(rows, 3, comm_id=2))
            assert gid == 2
            barrier.wait()
            s = accl.create_buffer_like(_cdata(COUNT, rank, salt=9))
            r = accl.create_buffer(COUNT, np.float32)
            accl.allreduce(s, r, COUNT, SUM, comm_id=gid)
            return r.host.copy()

        outs = world.run(fn, timeout=T)
    want = np.sum([_cdata(COUNT, q, salt=9) for q in range(n)], axis=0)
    for out in outs:
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    for out in outs[1:]:
        assert out.tobytes() == outs[0].tobytes()


def test_cuda_world_abort_without_engine_fails_only_that_comms_requests():
    # a backend without abort_comm: the driver fails its own pending
    # requests on the aborted comm, and only those
    with CudaWorld(3, device="cpu") as world:
        a = world.accls[0]
        world.devices[0].abort_comm = lambda comm_id, err: False
        ids = world.run(lambda acc, r: acc.create_communicator([0, 1])
                        if r < 2 else acc.reserve_communicator(), timeout=T)
        assert ids[0] == 1
        s = a.create_buffer_like(_cdata(COUNT, 0))
        r = a.create_buffer(COUNT, np.float32)
        on0 = a.allreduce(s, r, COUNT, SUM, run_async=True)
        on1 = a.allreduce(s, r, COUNT, SUM, comm_id=1, run_async=True)
        a.abort(1)
        assert on1.wait(T) and on1.aborted
        assert not on0.done
        world.accls[0].abort(0)
        assert on0.wait(T) and on0.aborted


@pytest.mark.parametrize("fence", ["abort", "shrink", "grow",
                                   "reset_errors"])
@pytest.mark.parametrize("kind", ["emu", "cuda"])
def test_plan_replay_after_a_fence_raises(kind, fence):
    n = 4
    world = EmuWorld(n) if kind == "emu" else CudaWorld(n, device="cpu")
    with world:
        if kind == "cuda":
            world.engine.ring_threshold_bytes = 0
        members = [0, 1, 2]
        barrier = threading.Barrier(n, timeout=T)

        def fn(accl, rank):
            if rank in members:
                assert accl.create_communicator(members) == 1
                s = accl.create_buffer_like(_cdata(COUNT, rank))
                r = accl.create_buffer(COUNT, np.float32)
                plan = accl.capture_plan(
                    lambda a: a.allreduce(s, r, COUNT, SUM, comm_id=1),
                    timeout_s=T)
                plan.replay()
                want = r.host.copy()
            barrier.wait()
            if fence == "abort" and rank == 0:
                accl.abort(1)
            elif fence == "shrink" and rank in members:
                accl.shrink_communicator(1, window_s=0.2)
            elif fence == "grow":
                row = Rank(ip="127.0.0.1", port=0, session=3)
                if rank in members:
                    accl.grow_communicator([row], comm_id=1, window_s=0.2)
            elif fence == "reset_errors":
                accl.reset_errors()
            barrier.wait()
            if rank not in members:
                return None
            if fence == "abort" and rank != 0 and kind == "emu":
                # these drivers never aborted: the engine's fence refuses
                # the replay once the propagated abort has invalidated
                # its plans (the epoch bumps a moment before)
                _wait_until(lambda: accl.device.plan_count() == 0)
            with pytest.raises(ACCLError) as e:
                plan.replay()
            assert plan.invalidated
            assert e.value.code & int(ErrorCode.COMM_ABORTED)
            return want

        outs = world.run(fn, timeout=T)
        if kind == "cuda":
            # the fenced replays ran no slot: the engine counts the one
            # replay before the fence only
            assert world.devices[0].engine_stats()["plan_replays"] == 1
    want = np.sum([_cdata(COUNT, q) for q in range(3)], axis=0)
    for r in range(3):
        np.testing.assert_allclose(outs[r], want, rtol=1e-5, atol=1e-5)
