"""The port's native emulator world (accl_tpu_torch.backends.emu) against
the JAX package's (accl_tpu.backends.emu) and against CudaWorld(n, "cpu").

- Descriptor words: for every collective, the port's driver emits the
  JAX driver's 15 words on a recording device (no engine involved).
- The corpus of tests/test_emu_collectives.py on the port's EmuWorld(4),
  each case held against numpy; the integer lanes also bitwise against
  CudaWorld(4, "cpu").
- The same numpy-seeded inputs through the JAX EmuWorld and the port's:
  one engine, so every result is bitwise equal, float sums included.
- EmuBuffer and EmuBufferP2P (slicing, addresses, syncs), and two
  EmuRankTcp ranks over localhost sockets.

Every world has 2-4 ranks and is closed inside its test; every wait
passes a timeout of 30 s or less.
"""
import socket
import threading
import time

import numpy as np
import pytest

import accl_tpu
from accl_tpu.backends import base as jbase
from accl_tpu.backends.emu import EmuWorld as JEmuWorld
from accl_tpu_torch import TAG_ANY, ACCL, CudaWorld, ReduceFunction
from accl_tpu_torch import DataType as TDataType
from accl_tpu_torch.backends import base as tbase
from accl_tpu_torch.backends.emu import EmuRankTcp, EmuWorld
from accl_tpu_torch.buffer import BaseBuffer, EmuBuffer, EmuBufferP2P

NRANKS = 4
COUNT = 64
T = 30  # the wait budget of every run and request, seconds


@pytest.fixture()
def world():
    with EmuWorld(NRANKS) as w:
        yield w


def _data(count, dtype, rank, salt=0):
    rng = np.random.default_rng(1234 + rank + salt * 100)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-1000, 1000, size=count).astype(dtype)
    return rng.standard_normal(count).astype(dtype)


def _fill(accl, count, dtype, rank, salt=0):
    data = _data(count, dtype, rank, salt)
    return accl.create_buffer_like(data), data


# ---------------------------------------------------------------------------
# descriptor words: the port's driver against the JAX driver
# ---------------------------------------------------------------------------
def _recording(base_mod, buffer_base):
    class RecBuffer(buffer_base):
        def sync_to_device(self):
            pass

        def sync_from_device(self):
            pass

        def slice(self, start, end):
            return RecBuffer(self._host[start:end],
                             self._address + start * self._host.itemsize)

    class Recorder(base_mod.CCLODevice):
        """Records every descriptor; completes it at once."""

        def __init__(self):
            self.words = []
            self._next = 1 << 20
            self._cfgs = 0

        def start(self, call, request):
            self.words.append(call.to_words())
            request.complete(0, 0.0)

        def create_buffer(self, length, dtype, host_only=False):
            buf = RecBuffer(np.zeros(length, dtype=dtype), self._next)
            self._next += 1 << 20
            return buf

        def setup_rx_buffers(self, n_bufs, buf_size):
            pass

        def upload_communicator(self, comm):
            return comm.id

        def upload_arithconfig(self, cfg):
            self._cfgs += 1
            return self._cfgs - 1

        def alloc_mem(self, nbytes, alignment=64):
            return 0

        def free_mem(self, address):
            pass

        def read_mem(self, address, nbytes):
            return bytes(nbytes)

        def write_mem(self, address, data):
            pass

    return Recorder


def _driver(pkg):
    if pkg == "jax":
        dev = _recording(jbase, accl_tpu.BaseBuffer)()
        accl = accl_tpu.ACCL(dev)
        Rank = accl_tpu.Rank
    else:
        dev = _recording(tbase, BaseBuffer)()
        accl = ACCL(dev)
        from accl_tpu_torch import Rank
    accl.initialize([Rank(session=r) for r in range(NRANKS)], 1)
    return accl, dev


def _issue(pkg, case):
    """Issue one call on a fresh recording driver; the words it made."""
    accl, dev = _driver(pkg)
    R = accl_tpu.ReduceFunction if pkg == "jax" else ReduceFunction
    D = accl_tpu.DataType if pkg == "jax" else TDataType
    f32, n = np.float32, 16
    a = accl.create_buffer(n * NRANKS, f32)
    b = accl.create_buffer(n * NRANKS, f32)
    c = accl.create_buffer(n * NRANKS, f32)
    i32 = accl.create_buffer(n * NRANKS, np.int32)
    h16 = accl.create_buffer(n * NRANKS, np.float16)
    start = len(dev.words)
    {
        "send": lambda: accl.send(a, n, 2, tag=7),
        "recv": lambda: accl.recv(b, n, 0, tag=TAG_ANY),
        "copy": lambda: accl.copy(a, b, n),
        "combine_max": lambda: accl.combine(n, R.MAX, a, b, c),
        "bcast_root": lambda: accl.bcast(a, n, root=1),
        "bcast_leaf": lambda: accl.bcast(a, n, root=3),
        "scatter": lambda: accl.scatter(a, b, n, root=1),
        "gather": lambda: accl.gather(a, b, n, root=0),
        "allgather": lambda: accl.allgather(a, b, n),
        "reduce": lambda: accl.reduce(a, b, n, root=1, function=R.MAX),
        "allreduce": lambda: accl.allreduce(a, b, n, R.SUM),
        "allreduce_int32": lambda: accl.allreduce(i32, i32, n, R.SUM),
        "allreduce_f16_wire": lambda: accl.allreduce(
            a, b, n, R.SUM, compress_dtype=D.float16),
        "allreduce_int8_wire": lambda: accl.allreduce(
            a, b, n, R.SUM, compress_dtype=D.int8),
        "allreduce_f16_operand": lambda: accl.allreduce(h16, b, n, R.SUM),
        "reduce_scatter": lambda: accl.reduce_scatter(a, b, n, R.SUM),
        "alltoall": lambda: accl.alltoall(a, b, n),
        "barrier": lambda: accl.barrier(),
        "subcomm_allreduce": lambda: accl.allreduce(
            a, b, n, R.SUM, comm_id=accl.create_communicator([0, 1, 3])),
    }[case]()
    return dev.words[:start], dev.words[start:]


WORD_CASES = ("send", "recv", "copy", "combine_max", "bcast_root",
              "bcast_leaf", "scatter", "gather", "allgather", "reduce",
              "allreduce", "allreduce_int32", "allreduce_f16_wire",
              "allreduce_int8_wire", "allreduce_f16_operand",
              "reduce_scatter", "alltoall", "barrier", "subcomm_allreduce")


@pytest.mark.parametrize("case", WORD_CASES)
def test_descriptor_words_equal_the_reference_driver(case):
    jinit, jwords = _issue("jax", case)
    tinit, twords = _issue("torch", case)
    assert jinit == tinit  # bring-up: the config calls
    assert len(twords) == 1 and twords == jwords


# ---------------------------------------------------------------------------
# the emulator corpus (tests/test_emu_collectives.py) on the port
# ---------------------------------------------------------------------------
def test_copy(world):
    def fn(accl, rank):
        src, data = _fill(accl, COUNT, np.float32, rank)
        dst = accl.create_buffer(COUNT, np.float32)
        accl.copy(src, dst, COUNT)
        np.testing.assert_array_equal(dst.host, data)

    world.run(fn, timeout=T)


@pytest.mark.parametrize("func", [ReduceFunction.SUM, ReduceFunction.MAX])
def test_combine(world, func):
    def fn(accl, rank):
        op0, d0 = _fill(accl, COUNT, np.float32, rank, salt=1)
        op1, d1 = _fill(accl, COUNT, np.float32, rank, salt=2)
        res = accl.create_buffer(COUNT, np.float32)
        accl.combine(COUNT, func, op0, op1, res)
        exp = d0 + d1 if func == ReduceFunction.SUM else np.maximum(d0, d1)
        np.testing.assert_array_equal(res.host, exp)

    world.run(fn, timeout=T)


@pytest.mark.parametrize("count", [16, 256, 257])  # eager, multi-seg, ragged
def test_sendrecv_pairs(world, count):
    def fn(accl, rank):
        src, _ = _fill(accl, count, np.float32, rank)
        dst = accl.create_buffer(count, np.float32)
        nxt, prv = (rank + 1) % NRANKS, (rank - 1) % NRANKS
        req = accl.send(src, count, nxt, tag=9, run_async=True)
        accl.recv(dst, count, prv, tag=9)
        assert req.wait(T)
        req.check()
        np.testing.assert_array_equal(dst.host,
                                      _data(count, np.float32, prv))

    world.run(fn, timeout=T)


def test_sendrecv_rendezvous(world):
    count = 4096  # 16 KiB: above the 1 KiB eager limit
    def fn(accl, rank):
        if rank == 0:
            src, _ = _fill(accl, count, np.float32, 0, salt=3)
            accl.send(src, count, 1, tag=11)
        elif rank == 1:
            dst = accl.create_buffer(count, np.float32)
            accl.recv(dst, count, 0, tag=11)
            np.testing.assert_array_equal(
                dst.host, _data(count, np.float32, 0, salt=3))

    world.run(fn, timeout=T)


def test_sendrecv_tag_any_and_mixed_ordering(world):
    def fn(accl, rank):
        if rank == 0:
            for tag, salt in ((21, 4), (22, 5)):
                src, _ = _fill(accl, COUNT, np.float32, 0, salt=salt)
                accl.send(src, COUNT, 1, tag=tag)
        elif rank == 1:
            a = accl.create_buffer(COUNT, np.float32)
            b = accl.create_buffer(COUNT, np.float32)
            accl.recv(a, COUNT, 0, tag=TAG_ANY)
            accl.recv(b, COUNT, 0, tag=22)
            np.testing.assert_array_equal(a.host,
                                          _data(COUNT, np.float32, 0, 4))
            np.testing.assert_array_equal(b.host,
                                          _data(COUNT, np.float32, 0, 5))

    world.run(fn, timeout=T)


@pytest.mark.parametrize("root", range(NRANKS))
def test_bcast(world, root):
    def fn(accl, rank):
        buf, _ = _fill(accl, COUNT, np.float32, rank)
        accl.bcast(buf, COUNT, root=root)
        np.testing.assert_array_equal(buf.host,
                                      _data(COUNT, np.float32, root))

    world.run(fn, timeout=T)


@pytest.mark.parametrize("root", [0, 3])
def test_scatter(world, root):
    def fn(accl, rank):
        src, full = _fill(accl, COUNT * NRANKS, np.float32, rank)
        dst = accl.create_buffer(COUNT, np.float32)
        accl.scatter(src, dst, COUNT, root=root)
        want = _data(COUNT * NRANKS, np.float32, root)
        np.testing.assert_array_equal(
            dst.host, want[rank * COUNT:(rank + 1) * COUNT])

    world.run(fn, timeout=T)


@pytest.mark.parametrize("root", [0, 2])
def test_gather(world, root):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT, np.float32, rank)
        dst = accl.create_buffer(COUNT * NRANKS, np.float32)
        accl.gather(src, dst, COUNT, root=root)
        if rank == root:
            np.testing.assert_array_equal(dst.host, np.concatenate(
                [_data(COUNT, np.float32, r) for r in range(NRANKS)]))

    world.run(fn, timeout=T)


def test_allgather(world):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT, np.float32, rank)
        dst = accl.create_buffer(COUNT * NRANKS, np.float32)
        accl.allgather(src, dst, COUNT)
        np.testing.assert_array_equal(dst.host, np.concatenate(
            [_data(COUNT, np.float32, r) for r in range(NRANKS)]))

    world.run(fn, timeout=T)


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("func", [ReduceFunction.SUM, ReduceFunction.MAX])
def test_reduce(world, root, func):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT, np.float32, rank)
        dst = accl.create_buffer(COUNT, np.float32)
        accl.reduce(src, dst, COUNT, root=root, function=func)
        if rank == root:
            xs = [_data(COUNT, np.float32, r) for r in range(NRANKS)]
            if func == ReduceFunction.SUM:
                np.testing.assert_allclose(dst.host, np.sum(xs, axis=0),
                                           rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(dst.host, np.max(xs, axis=0))

    world.run(fn, timeout=T)


@pytest.mark.parametrize("count", [COUNT, 61, NRANKS * 300 + 3])
def test_allreduce(world, count):
    def fn(accl, rank):
        src, _ = _fill(accl, count, np.float32, rank)
        dst = accl.create_buffer(count, np.float32)
        accl.allreduce(src, dst, count, ReduceFunction.SUM)
        xs = [_data(count, np.float32, r) for r in range(NRANKS)]
        np.testing.assert_allclose(dst.host, np.sum(xs, axis=0), rtol=1e-5,
                                   atol=1e-5)

    world.run(fn, timeout=T)


def test_reduce_scatter(world):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT * NRANKS, np.float32, rank)
        dst = accl.create_buffer(COUNT, np.float32)
        accl.reduce_scatter(src, dst, COUNT, ReduceFunction.SUM)
        xs = [_data(COUNT * NRANKS, np.float32, r) for r in range(NRANKS)]
        np.testing.assert_allclose(
            dst.host, np.sum(xs, axis=0)[rank * COUNT:(rank + 1) * COUNT],
            rtol=1e-5, atol=1e-5)

    world.run(fn, timeout=T)


def test_alltoall(world):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT * NRANKS, np.float32, rank)
        dst = accl.create_buffer(COUNT * NRANKS, np.float32)
        accl.alltoall(src, dst, COUNT)
        want = np.concatenate(
            [_data(COUNT * NRANKS, np.float32, r)[rank * COUNT:
                                                  (rank + 1) * COUNT]
             for r in range(NRANKS)])
        np.testing.assert_array_equal(dst.host, want)

    world.run(fn, timeout=T)


def test_barrier(world):
    def fn(accl, rank):
        accl.barrier()
        accl.barrier()
        return True

    assert all(world.run(fn, timeout=T))


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.int64,
                                   np.float16])
def test_allreduce_dtypes(world, dtype):
    def fn(accl, rank):
        src, _ = _fill(accl, COUNT, dtype, rank)
        dst = accl.create_buffer(COUNT, dtype)
        accl.allreduce(src, dst, COUNT, ReduceFunction.SUM)
        want = np.sum([_data(COUNT, dtype, r) for r in range(NRANKS)],
                      axis=0, dtype=np.float64 if dtype == np.float16
                      else dtype)
        if np.issubdtype(np.dtype(dtype), np.integer):
            np.testing.assert_array_equal(dst.host, want)
        else:
            tol = 2e-2 if dtype == np.float16 else 1e-12
            np.testing.assert_allclose(dst.host, want, rtol=tol, atol=tol)

    world.run(fn, timeout=T)


# ---------------------------------------------------------------------------
# integer lanes: the emulator bitwise against CudaWorld(4, "cpu")
# ---------------------------------------------------------------------------
def _int_lane(kind, func=ReduceFunction.SUM, root=1):
    n = 96

    def fn(accl, rank):
        big, _ = _fill(accl, n * NRANKS, np.int32, rank, salt=7)
        small, _ = _fill(accl, n, np.int32, rank, salt=8)
        out = accl.create_buffer(n * NRANKS, np.int32)
        if kind == "allreduce":
            accl.allreduce(small, out, n, func)
        elif kind == "reduce":
            accl.reduce(small, out, n, root=root, function=func)
        elif kind == "reduce_scatter":
            accl.reduce_scatter(big, out, n, func)
        elif kind == "allgather":
            accl.allgather(small, out, n)
        elif kind == "bcast":
            accl.bcast(small, n, root=root)
            return small.host.copy()
        elif kind == "scatter":
            accl.scatter(big, out, n, root=root)
        elif kind == "gather":
            accl.gather(small, out, n, root=root)
        elif kind == "alltoall":
            accl.alltoall(big, out, n)
        return out.host.copy()

    return fn


@pytest.mark.parametrize("kind,func", [
    ("allreduce", ReduceFunction.SUM), ("allreduce", ReduceFunction.MAX),
    ("reduce", ReduceFunction.SUM), ("reduce_scatter", ReduceFunction.SUM),
    ("reduce_scatter", ReduceFunction.MAX), ("allgather", None),
    ("bcast", None), ("scatter", None), ("gather", None), ("alltoall", None),
])
def test_integer_lane_bitwise_against_cuda_world(kind, func):
    fn = _int_lane(kind, func or ReduceFunction.SUM)
    with EmuWorld(NRANKS) as w:
        emu = w.run(fn, timeout=T)
    with CudaWorld(NRANKS, device="cpu") as w:
        cuda = w.run(fn, timeout=T)
    for r in range(NRANKS):
        np.testing.assert_array_equal(emu[r], cuda[r])


# ---------------------------------------------------------------------------
# one engine, two drivers: bitwise on the same seeded inputs
# ---------------------------------------------------------------------------
def _same_engine_program(R, count, kind):
    def fn(accl, rank):
        src = accl.create_buffer_like(_data(count * NRANKS, np.float32,
                                            rank, salt=9))
        out = accl.create_buffer(count * NRANKS, np.float32)
        if kind == "allreduce":
            accl.allreduce(src, out, count, R.SUM)
        elif kind == "reduce_scatter":
            accl.reduce_scatter(src, out, count, R.SUM)
        elif kind == "reduce":
            accl.reduce(src, out, count, root=2, function=R.SUM)
        elif kind == "allgather":
            accl.allgather(src, out, count)
        elif kind == "sendrecv":
            accl.send(src, count, (rank + 1) % NRANKS, tag=3,
                      run_async=True)
            accl.recv(out, count, (rank - 1) % NRANKS, tag=3)
        return out.host.copy()

    return fn


@pytest.mark.parametrize("kind,count", [
    ("allreduce", 61), ("allreduce", 2048), ("reduce_scatter", 300),
    ("reduce", 257), ("allgather", 129), ("sendrecv", 1000)])
def test_same_inputs_bitwise_with_the_reference_emulator(kind, count):
    with JEmuWorld(NRANKS) as w:
        jax_out = w.run(_same_engine_program(accl_tpu.ReduceFunction, count,
                                             kind))
    with EmuWorld(NRANKS) as w:
        port_out = w.run(_same_engine_program(ReduceFunction, count, kind),
                         timeout=T)
    for r in range(NRANKS):
        assert jax_out[r].tobytes() == port_out[r].tobytes(), (kind, r)


def test_close_while_a_call_starts_joins_its_waiter(monkeypatch):
    """close() on one thread while a rank starts a call on another: the
    waiter thread is started under the device's lifecycle lock, so the
    close's null-the-handle step waits for it and the join never meets a
    registered waiter that has not started (the reference starts it after
    releasing the lock, accl_tpu/backends/emu.py:357-383, where the join
    can raise "cannot join thread before it is started").  The engine is
    a stand-in, so the interleaving is forced, not left to load."""
    from accl_tpu_torch.backends import emu as temu

    released = threading.Event()

    class Lib:
        """start()'s two entries; every other entry answers 0."""

        def accl_start_call(self, world, rank, words):
            return 1

        def accl_wait_call(self, world, rank, call_id, timeout_ms, ret,
                           dur):
            released.wait(10)
            return 1

        def __getattr__(self, name):
            return lambda *args: 0

    class Call:
        def to_words(self):
            return [0] * 16

    done = []

    class Req:
        trace = flight = None
        description = "allreduce"

        def complete(self, ret, dur):
            done.append(ret)

        def flight_info(self):
            return ""

    entered = threading.Event()
    plain = threading.Thread

    class SlowStart(plain):
        def start(self):
            if getattr(self._target, "__name__", "") == "waiter":
                entered.set()
                time.sleep(0.1)
            super().start()

    dev = temu.EmuDevice(1, 0, Lib())
    monkeypatch.setattr(temu.threading, "Thread", SlowStart)
    caller = plain(target=dev.start, args=(Call(), Req()), daemon=True)
    caller.start()
    assert entered.wait(10)
    with dev._lifecycle:  # _teardown: null the handle, then join
        dev._w = None
    released.set()
    assert temu._join_waiters([dev]) == 0
    caller.join(10)
    assert done == [0] and not dev._waiters


# ---------------------------------------------------------------------------
# buffers
# ---------------------------------------------------------------------------
def test_emu_buffer_slices_addresses_and_syncs():
    with EmuWorld(2) as w:
        dev = w.devices[0]
        buf = w.accls[0].create_buffer(16, np.int32)
        assert isinstance(buf, EmuBuffer) and not buf.is_host_only
        buf.host[:] = np.arange(16, dtype=np.int32)
        buf.sync_to_device()
        assert dev.read_mem(buf.address, 64) == buf.host.tobytes()
        part = buf.slice(4, 8)
        assert part.address == buf.address + 16 and part.length == 4
        part.host[:] = -1  # a view of the parent's host array
        assert (buf.host[4:8] == -1).all()
        part.sync_to_device()  # writes only its own span
        want = np.arange(16, dtype=np.int32)
        want[4:8] = -1
        assert dev.read_mem(buf.address, 64) == want.tobytes()
        dev.write_mem(buf.address, np.full(16, 7, np.int32).tobytes())
        part.sync_from_device()
        np.testing.assert_array_equal(buf.host[4:8], [7] * 4)
        np.testing.assert_array_equal(buf.host[:4], [0, 1, 2, 3])
        host = w.accls[0].create_buffer(8, np.float32, host_only=True)
        assert host.is_host_only and host.slice(2, 4).is_host_only
        buf.free()
        part.free()  # a slice owns nothing


def test_emu_buffer_p2p_host_is_device_memory():
    with EmuWorld(2) as w:
        dev = w.devices[1]
        p2p = dev.create_buffer_p2p(32, np.float32)
        assert isinstance(p2p, EmuBufferP2P)
        p2p.host[:] = np.arange(32, dtype=np.float32)
        # no sync: the host array maps the engine's memory
        assert dev.read_mem(p2p.address, 128) == p2p.host.tobytes()
        dev.write_mem(p2p.address + 8, np.float32([-5.0]).tobytes())
        assert p2p.host[2] == -5.0
        part = p2p.slice(8, 16)
        assert isinstance(part, EmuBufferP2P)
        assert part.address == p2p.address + 32
        part.sync_to_device()
        part.sync_from_device()
        assert part.host[0] == 8.0
        p2p.free()


# ---------------------------------------------------------------------------
# TCP ranks
# ---------------------------------------------------------------------------
def _two_free_ports() -> int:
    """A base port whose next port is free too (the TCP rung listens on
    base_port + rank)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + 1 > 65535:
            continue
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", base + 1))
            with socket.socket() as s:
                s.bind(("127.0.0.1", base))
            return base
        except OSError:
            continue
    pytest.fail("no two adjacent free localhost ports")


def test_two_tcp_ranks_sendrecv_and_allreduce():
    base = _two_free_ports()
    results, errors, ranks = {}, [], [None, None]

    def rank_main(r):
        try:
            rk = ranks[r] = EmuRankTcp(r, 2, base, call_timeout_s=T)
            accl = rk.accl
            accl.set_timeout(20_000_000)
            src = accl.create_buffer_like(_data(COUNT, np.float32, r))
            dst = accl.create_buffer(COUNT, np.float32)
            req = accl.send(src, COUNT, 1 - r, tag=5, run_async=True)
            accl.recv(dst, COUNT, 1 - r, tag=5)
            assert req.wait(T)
            req.check()
            out = accl.create_buffer(COUNT, np.float32)
            accl.allreduce(src, out, COUNT, ReduceFunction.SUM)
            results[r] = (dst.host.copy(), out.host.copy())
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((r, e))

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert not any(t.is_alive() for t in threads)
    for rk in ranks:
        if rk is not None:
            rk.close()
    assert not errors, errors
    total = _data(COUNT, np.float32, 0) + _data(COUNT, np.float32, 1)
    for r in range(2):
        np.testing.assert_array_equal(results[r][0],
                                      _data(COUNT, np.float32, 1 - r))
        np.testing.assert_array_equal(results[r][1], total)
