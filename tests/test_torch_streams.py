"""Kernel streams, the session calls and p2p buffers on the port's worlds
(accl_tpu_torch), against the JAX package's.

- Mirrors of tests/test_tpu_backend.py:239-300 (stream_put, copy to and
  from a stream, the mem<->stream reduce) on CudaWorld(n, "cpu"), each
  result bitwise the same function's on TpuWorld (integer-valued float32
  data: every fold order sums it exactly).
- Mirrors of tests/test_emu_protocols.py:75-300 and
  tests/test_datagram.py:157,240 on the port's EmuWorld (inproc and
  datagram transports) and, where the engine is the card's, CudaWorld:
  the emulator pairs bitwise the JAX EmuWorld's on one seed.
- A stream->stream allreduce above a lowered ACCL_RING_THRESHOLD (the
  ring drivers' plain versions on the CPU), bitwise the buffer-sourced
  ring allreduce; the cached gang plan keys on stream_flags.
- The short-operand error, the reserved-id errors, the plan-arm refusal
  (texts word for word the JAX package's), two back-to-back stream ops
  on one rank, and the session calls over the port's EmuRankTcp pair
  (after tests/test_session_lifecycle.py).

Every world has 2-4 ranks and is closed inside its test; every wait is
30 s or less.
"""
import os
import threading
import time

import numpy as np
import pytest

from accl_tpu import ACCLError as JACCLError
from accl_tpu.backends.emu import EmuWorld as JEmuWorld
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu_torch import (
    ACCLError,
    CudaWorld,
    DataType,
    Operation,
    ReduceFunction,
    StreamFlags,
)
from accl_tpu_torch.backends.emu import EmuRankTcp, EmuWorld
from accl_tpu_torch.buffer import EmuBufferP2P
from accl_tpu_torch.device_api import ACCLCommand, ACCLData

NRANKS = 4
COUNT = 64
T = 30
OP0, RES = StreamFlags.OP0_STREAM, StreamFlags.RES_STREAM


def _data(count, rank, salt=0, ints=False):
    rng = np.random.default_rng(77 + rank + salt * 100)
    if ints:
        return rng.integers(-1000, 1000, count).astype(np.float32)
    return rng.standard_normal(count).astype(np.float32)


def _pair(kind, nranks=NRANKS):
    """(the port's world, the JAX world it is held to)."""
    if kind == "emu":
        return EmuWorld(nranks), JEmuWorld(nranks)
    return CudaWorld(nranks, device="cpu"), TpuWorld(nranks)


def _both(kind, fn, nranks=NRANKS):
    """``fn(accl, rank, ints)`` on the port's world and on the JAX world;
    the two lists of per-rank results."""
    port, ref = _pair(kind, nranks)
    ints = kind == "cuda"
    try:
        got = port.run(lambda a, r: fn(a, r, ints), timeout=T)
        want = ref.run(lambda a, r: fn(a, r, ints))
    finally:
        port.close()
        ref.close()
    return got, want


def _same(got, want):
    for g, w in zip(got, want):
        if g is None or w is None:
            assert g is None and w is None
        else:
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


KINDS = pytest.mark.parametrize("kind", ["emu", "cuda"])


# ---------------------------------------------------------------------------
# mirrors of test_tpu_backend.py:239-300 and test_emu_protocols.py:75-300
# ---------------------------------------------------------------------------
@KINDS
def test_stream_put(kind):
    strm = 9

    def fn(accl, rank, ints):
        if rank == 0:
            src = accl.create_buffer_like(_data(COUNT, 0, 3, ints))
            accl.stream_put(src, COUNT, dst=2, stream_id=strm)
        elif rank == 2:
            raw = accl.device.pop_stream(strm, COUNT * 4, T)
            return np.frombuffer(raw, dtype=np.float32).copy()
        return None

    got, want = _both(kind, fn)
    _same(got, want)
    np.testing.assert_array_equal(got[2], _data(COUNT, 0, 3, kind == "cuda"))


@KINDS
def test_copy_to_and_from_stream(kind):
    def fn(accl, rank, ints):
        data = _data(COUNT, rank, 41, ints)
        src = accl.create_buffer_like(data)
        accl.copy_to_stream(src, COUNT, stream_id=9)
        raw = accl.device.pop_stream(9, COUNT * 4, T)
        accl.device.push_krnl(np.frombuffer(raw, np.float32) * 2)
        dst = accl.create_buffer(COUNT, np.float32)
        accl.copy_from_stream(dst, COUNT)
        return np.frombuffer(raw, np.float32).copy(), dst.host.copy()

    got, want = _both(kind, fn)
    for r in range(NRANKS):
        _same(got[r], want[r])
        data = _data(COUNT, r, 41, kind == "cuda")
        np.testing.assert_array_equal(got[r][0], data)
        np.testing.assert_array_equal(got[r][1], data * 2)


@KINDS
def test_reduce_mem_stream_variants(kind):
    """The rooted reduce with a streamed operand, a streamed result, and
    both (reference test.cpp:813-910)."""
    root = 1

    def fn(accl, rank, ints):
        data = _data(COUNT, rank, 43, ints)
        accl.device.push_krnl(data)
        recv = accl.create_buffer(COUNT, np.float32)
        accl.reduce(None, recv, COUNT, root, ReduceFunction.SUM,
                    stream_flags=OP0)
        send = accl.create_buffer_like(data)
        accl.reduce(send, None, COUNT, root, ReduceFunction.SUM,
                    stream_flags=RES, stream_id=11)
        to_stream = (np.frombuffer(accl.device.pop_stream(11, COUNT * 4, T),
                                   np.float32).copy()
                     if rank == root else None)
        accl.device.push_krnl(data * 3)
        accl.reduce(None, None, COUNT, root, stream_flags=OP0 | RES,
                    stream_id=12)
        both = (np.frombuffer(accl.device.pop_stream(12, COUNT * 4, T),
                              np.float32).copy()
                if rank == root else None)
        return (recv.host.copy() if rank == root else None, to_stream, both)

    got, want = _both(kind, fn)
    ints = kind == "cuda"
    exp = sum(_data(COUNT, r, 43, ints) for r in range(NRANKS))
    _same(got[root], want[root])
    np.testing.assert_allclose(got[root][0], exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[root][1], exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[root][2], exp * 3, rtol=1e-5, atol=1e-4)


@KINDS
def test_send_from_kernel_stream(kind):
    """OP0_STREAM send: the operand comes from the compute kernel's input
    (the vadd_put kernel's data_to_cclo port)."""
    def fn(accl, rank, ints):
        if rank == 0:
            accl.device.push_krnl(_data(32, 9, 0, ints))
            dummy = accl.create_buffer(32, np.float32)
            accl.send(dummy, 32, 1, tag=11, from_fpga=True,
                      stream_flags=OP0)
        elif rank == 1:
            dst = accl.create_buffer(32, np.float32)
            accl.recv(dst, 32, 0, tag=11)
            return dst.host.copy()
        return None

    got, want = _both(kind, fn)
    _same(got, want)
    np.testing.assert_array_equal(got[1], _data(32, 9, 0, kind == "cuda"))


@KINDS
def test_recv_into_a_kernel_stream(kind):
    """RES_STREAM recv: the payload lands in the receiver's kernel stream
    ``tag`` instead of a buffer."""
    def fn(accl, rank, ints):
        if rank == 0:
            src = accl.create_buffer_like(_data(32, 5, 0, ints))
            accl.send(src, 32, 1, tag=14)
        elif rank == 1:
            dummy = accl.create_buffer(32, np.float32)
            accl.recv(dummy, 32, 0, tag=14, to_fpga=True, stream_flags=RES)
            raw = accl.device.pop_stream(14, 32 * 4, T)
            return np.frombuffer(raw, np.float32).copy()
        return None

    got, want = _both(kind, fn, nranks=2)
    _same(got, want)
    np.testing.assert_array_equal(got[1], _data(32, 5, 0, kind == "cuda"))


@KINDS
def test_copy_stream_loopback_and_copy_p2p(kind):
    """copy_to_stream out of the kernel port, fed back as the loopback
    kernel would, copy_from_stream into memory; a copy into the buffer
    create_buffer_p2p makes (the emulator's p2p variant, a plain buffer
    on the card)."""
    def fn(accl, rank, ints):
        src = accl.create_buffer_like(_data(COUNT, rank, 21, ints))
        dst = accl.create_buffer(COUNT, np.float32)
        accl.copy_to_stream(src, COUNT, stream_id=11)
        raw = accl.device.pop_stream(11, COUNT * 4, T)
        accl.device.push_krnl(np.frombuffer(raw, np.float32))
        accl.copy_from_stream(dst, COUNT)
        p2p = accl.create_buffer_p2p(COUNT, np.float32)
        accl.copy(src, p2p, COUNT)
        return dst.host.copy(), p2p.host.copy(), type(p2p).__name__

    got, want = _both(kind, fn)
    for r in range(NRANKS):
        _same(got[r][:2], want[r][:2])
        np.testing.assert_array_equal(got[r][0],
                                      _data(COUNT, r, 21, kind == "cuda"))
        np.testing.assert_array_equal(got[r][1], got[r][0])
    assert got[0][2] == ("EmuBufferP2P" if kind == "emu" else "CudaBuffer")


def test_stream_put_order_survives_reorder():
    """Stream payloads over the reordering datagram transport arrive in
    FIFO order (tests/test_datagram.py:157)."""
    n, strm, rounds = 96, 11, 6

    def fn(accl, rank):
        nxt, prv = (rank + 1) % NRANKS, (rank - 1) % NRANKS
        for i in range(rounds):
            buf = accl.create_buffer_like(
                np.full(n, float(i * 10 + rank), np.float32))
            accl.stream_put(buf, n, nxt, strm)
        got = []
        for _ in range(rounds):
            raw = accl.device.pop_stream(strm, n * 4, T)
            got.append(float(np.frombuffer(raw, np.float32)[0]))
        return got

    with EmuWorld(NRANKS, transport="dgram", mtu=256) as w:
        out = w.run(fn, timeout=T)
    for rank, got in enumerate(out):
        prv = (rank - 1) % NRANKS
        assert got == [float(i * 10 + prv) for i in range(6)]


def test_mem2stream_reduce_over_datagrams():
    """The streamed-result reduce across the reordering transport
    (tests/test_datagram.py:240), bitwise the JAX emulator's."""
    count, root, strm = 128, 0, 13

    def fn(accl, rank):
        send = accl.create_buffer_like(_data(count, rank, 10))
        accl.reduce(send, None, count, root, ReduceFunction.SUM,
                    stream_flags=RES, stream_id=strm)
        if rank == root:
            raw = accl.device.pop_stream(strm, count * 4, T)
            return np.frombuffer(raw, np.float32).copy()
        return None

    with EmuWorld(NRANKS, transport="dgram", mtu=256) as w:
        got = w.run(fn, timeout=T)
    with JEmuWorld(NRANKS, transport="dgram", mtu=256) as w:
        want = w.run(fn)
    _same(got, want)
    np.testing.assert_allclose(
        got[root], sum(_data(count, k, 10) for k in range(NRANKS)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the ring lane, the gang-plan cache, back-to-back operands
# ---------------------------------------------------------------------------
def test_stream_allreduce_rides_the_ring_lane(monkeypatch):
    """Above a lowered ACCL_RING_THRESHOLD the stream->stream allreduce
    goes through the same gang plan as the buffer-sourced one: the ring
    drivers (their plain versions on the CPU), bitwise its result."""
    monkeypatch.setenv("ACCL_RING_THRESHOLD", "1024")
    n = COUNT * 8  # 2 KiB of fp32 a rank

    def fn(accl, rank):
        data = _data(n, rank, 51)
        s = accl.create_buffer_like(data)
        o = accl.create_buffer(n, np.float32)
        accl.allreduce(s, o, n)
        d = ACCLData(accl.device)
        d.push(data)
        cmd = ACCLCommand(accl.device, arithcfg=accl._arith_ids[
            (DataType.float32, DataType.float32)])
        cmd.start_call(Operation.allreduce, n, tag=9,
                       stream_flags=OP0 | RES)
        cmd.finalize_call(timeout=T)
        return o.host.copy(), d.pull(n, np.float32, 9, timeout=T)

    with CudaWorld(NRANKS, device="cpu") as w:
        assert w.engine.ring_threshold_bytes == 1024
        out = w.run(fn, timeout=T)
        plans = list(w.engine._gang_plans.values())
    assert len(plans) == 2 and all(p["ring"] for p in plans)
    assert [bool(p["streams"]) for p in plans] == [False, True]
    for buffered, streamed in out:
        assert buffered.tobytes() == streamed.tobytes()


def test_gang_plan_keys_on_stream_flags():
    """Two stream gangs whose descriptors differ only in stream_flags
    (both address no buffer) get two plans: the first drops its result,
    the second delivers it to the stream."""
    n = COUNT * 8

    def fn(accl, rank):
        f32 = accl._arith_ids[(DataType.float32, DataType.float32)]
        d = ACCLData(accl.device)
        for flags in (OP0, OP0 | RES):
            d.push(_data(n, rank, 52))
            cmd = ACCLCommand(accl.device, arithcfg=f32)
            cmd.start_call(Operation.allreduce, n, tag=9, stream_flags=flags)
            cmd.finalize_call(timeout=T)
        return d.pull(n, np.float32, 9, timeout=T)

    with CudaWorld(NRANKS, device="cpu") as w:
        out = w.run(fn, timeout=T)
        assert len(w.engine._gang_plans) == 2
    exp = sum(_data(n, r, 52) for r in range(NRANKS))
    for got in out:
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    assert all(o.tobytes() == out[0].tobytes() for o in out)


def test_back_to_back_stream_ops_keep_call_order():
    """Rank 0 queues operands a and b, issues an async OP0_STREAM reduce
    (its gang waits for late peers), then a local copy_from_stream: the
    reduce reserved a when it was submitted, so the copy gets b and the
    reduce sums the a's (tpu.py:634-660)."""
    n, root = 256, 0
    gate = threading.Event()

    def fn(accl, rank):
        a_, b_ = _data(n, rank, 60), _data(n, rank, 61)
        recv = accl.create_buffer(n, np.float32)
        if rank == 0:
            accl.device.push_krnl(a_)
            accl.device.push_krnl(b_)
            req = accl.reduce(None, recv, n, root, stream_flags=OP0,
                              run_async=True)
            local = accl.create_buffer(n, np.float32)
            accl.copy_from_stream(local, n)
            gate.set()
            assert req.wait(T)
            req.check()
            recv.sync_from_device()
            return local.host.copy(), recv.host.copy()
        assert gate.wait(T)
        time.sleep(0.05)
        accl.device.push_krnl(a_)
        accl.reduce(None, recv, n, root, stream_flags=OP0)
        return None

    with CudaWorld(NRANKS, device="cpu") as w:
        out = w.run(fn, timeout=T)
    local, reduced = out[0]
    np.testing.assert_array_equal(local, _data(n, 0, 61))
    np.testing.assert_allclose(
        reduced, sum(_data(n, r, 60) for r in range(NRANKS)),
        rtol=1e-5, atol=1e-5)


def test_stream_delivery_loses_nothing_under_thread_churn():
    """Ten rank threads put 16 tagged messages each into every other
    rank's stream 15 while a shortened switch interval churns the
    threads; every rank pops each of the 144 messages addressed to it
    exactly once, and no message is left over."""
    import sys

    P, rounds, n = 10, 16, 4
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(accl, rank):
            for i in range(rounds):
                for dst in range(P):
                    if dst != rank:
                        buf = accl.create_buffer_like(
                            np.full(n, rank * 1000 + i, np.float32))
                        accl.stream_put(buf, n, dst, stream_id=15)
            got = []
            for _ in range(rounds * (P - 1)):
                raw = accl.device.pop_stream(15, n * 4, T)
                assert raw is not None
                got.append(int(np.frombuffer(raw, np.float32)[0]))
            return sorted(got)

        with CudaWorld(P, device="cpu") as w:
            out = w.run(fn, timeout=T)
            leftover = sum(len(q) for q in w.engine._streams.values())
    finally:
        sys.setswitchinterval(saved)
    for rank, got in enumerate(out):
        assert got == sorted(src * 1000 + i for src in range(P)
                             if src != rank for i in range(rounds))
    assert leftover == 0


# ---------------------------------------------------------------------------
# errors, word for word the JAX package's
# ---------------------------------------------------------------------------
def test_short_stream_operand_error_matches_the_reference():
    """A stream operand shorter than the collective needs completes with
    SEGMENTER_EXPECTED_BTT_ERROR, the description naming both lengths."""
    def fn(accl, rank):
        accl.device.push_krnl(np.ones(10, np.float32))
        recv = accl.create_buffer(64, np.float32)
        try:
            accl.reduce(None, recv, 64, 0, stream_flags=OP0)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return str(e).split(" [flight:")[0]  # its age is a clock read
        return None

    with CudaWorld(2, device="cpu") as w:
        got = w.run(fn, timeout=T)
    with TpuWorld(2) as w:
        want = w.run(fn)
    assert got == want
    assert "[stream operand 10 elems < required 64]" in got[0]
    assert "SEGMENTER_EXPECTED_BTT_ERROR" in got[0]


def test_reserved_stream_ids_raise_the_reference_text():
    with CudaWorld(1, device="cpu") as w, TpuWorld(1) as jw:
        for a in (w.accls[0], jw.accls[0]):
            err = ACCLError if a is w.accls[0] else JACCLError
            buf = a.create_buffer(8, np.float32)
            for call in (lambda: a.stream_put(buf, 8, 0, stream_id=8),
                         lambda: a.copy_to_stream(buf, 8, stream_id=0),
                         lambda: a.reduce(buf, None, 8, 0,
                                          stream_flags=RES, stream_id=3)):
                with pytest.raises(err) as e:
                    call()
                assert str(e.value) == "stream ids < 9 are reserved"


def test_plan_arm_refuses_stream_calls_with_the_reference_text():
    """A capture refuses a stream call at record time, and the engine's
    arm refuses one handed to it directly (tpu.py:1121-1124)."""
    def fn(accl, rank):
        src = accl.create_buffer_like(np.arange(8, dtype=np.float32))

        def body(a):
            a.copy_to_stream(src, 8, stream_id=9)
            a.device.pop_stream(9, 32, T)

        try:
            accl.capture_plan(body, validate=False, timeout_s=T)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return str(e)
        return None

    from accl_tpu_torch import CCLOCall

    def arm(world):
        call = CCLOCall(scenario=Operation.copy, count=8, tag=9,
                        stream_flags=RES)
        try:
            world.devices[0].arm_plan([call], frozenset({0}), T)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return str(e)
        return None

    with CudaWorld(1, device="cpu") as w:
        got = w.run(fn, timeout=T) + [arm(w)]
    with TpuWorld(1) as w:
        want = w.run(fn) + [arm(w)]
    assert got == want == [
        "capture_plan: stream-operand calls are not replayable "
        "(copy_to_stream(9)) — plans pre-resolve memory operands only; "
        "keep stream traffic on the eager path",
        "plan arm: stream-operand calls are not replayable — keep stream "
        "traffic eager"]


def test_descriptor_memo_keys_on_stream_flags():
    with CudaWorld(1, device="cpu") as w:
        a = w.accls[0]
        buf = a.create_buffer(8, np.float32)
        plain = a._build(Operation.copy, 8, 0, op0=buf, tag=9)
        streamed = a._build(Operation.copy, 8, 0, op0=buf, tag=9,
                            stream_flags=RES)
        assert plain is not streamed
        assert streamed.stream_flags == RES and not plain.stream_flags
        assert a._build(Operation.copy, 8, 0, op0=buf, tag=9,
                        stream_flags=RES) is streamed


# ---------------------------------------------------------------------------
# session calls, rx dump, p2p buffers
# ---------------------------------------------------------------------------
def _port(salt):
    return 24000 + (os.getpid() % 900) + salt


def _run_tcp_pair(base_port, fn):
    ranks, errs = [None, None], [None, None]

    def boot(r):
        try:
            ranks[r] = EmuRankTcp(r, 2, base_port)
            fn(ranks[r], r)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs[r] = e

    ts = [threading.Thread(target=boot, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=T)
    if any(t.is_alive() for t in ts):
        raise TimeoutError("a TCP rank thread hung (worlds left open)")
    for r in ranks:
        if r is not None:
            r.close()
    for e in errs:
        if e is not None:
            raise e


def test_tcp_session_open_close_reopen():
    barrier = threading.Barrier(2, timeout=T)

    def fn(rk, rank):
        accl = rk.accl
        accl.set_timeout(20_000_000)
        accl.open_port()
        barrier.wait()
        accl.open_con()
        accl.open_con()  # re-opening open sessions is fine
        data = np.arange(64, dtype=np.float32) + rank
        src = accl.create_buffer_like(data)
        dst = accl.create_buffer(64, np.float32)
        other = 1 - rank
        sreq = accl.send(src, 64, other, tag=5, run_async=True)
        accl.recv(dst, 64, other, tag=5)
        assert sreq.wait(T)
        sreq.check()
        np.testing.assert_array_equal(dst.host, np.arange(64) + other)
        barrier.wait()
        accl.close_con()
        barrier.wait()
        sreq = accl.send(src, 64, other, tag=6, run_async=True)
        accl.recv(dst, 64, other, tag=6)  # reconnects lazily
        assert sreq.wait(T)
        sreq.check()
        accl.close_con()
        barrier.wait()
        accl.open_con()

    _run_tcp_pair(_port(0), fn)


def test_tcp_open_con_failure_is_distinct_error():
    rk = EmuRankTcp(0, 2, _port(10))
    try:
        rk.accl.open_port()
        with pytest.raises(ACCLError, match="open_con failed.*peer 1"):
            rk.accl.open_con()
    finally:
        rk.close()


@pytest.mark.parametrize("kind", ["emu", "cuda"])
def test_connectionless_sessions_are_noops_and_unknown_comms_error(kind):
    world = (EmuWorld(2) if kind == "emu"
             else CudaWorld(2, device="cpu"))
    with world as w:
        def fn(accl, rank):
            accl.open_port()
            accl.open_con()
            accl.close_con()
            if kind == "emu":
                with pytest.raises(ACCLError, match="unknown communicator"):
                    accl.open_con(comm_id=99)
                with pytest.raises(ACCLError, match="unknown communicator"):
                    accl.close_con(comm_id=99)
            return accl.dump_rx_buffers()

        dumps = w.run(fn, timeout=T)
    if kind == "cuda":
        assert dumps == ["<backend has no rx buffer table>"] * 2
    else:
        assert all(isinstance(d, str) and d for d in dumps)
        assert dumps[0] != "<backend has no rx buffer table>"


def test_create_buffer_p2p_per_backend():
    with EmuWorld(2) as w:
        buf = w.accls[0].create_buffer_p2p(16, np.int32)
        assert isinstance(buf, EmuBufferP2P)
    with CudaWorld(1, device="cpu") as w:
        buf = w.accls[0].create_buffer_p2p(16, np.int32)
        assert buf.length == 16 and buf.dtype == np.int32
        assert w.engine.resolve(0, buf.address)[0] is buf
