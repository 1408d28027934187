"""The port's device-side caller API (accl_tpu_torch.device_api) against
the JAX package's (accl_tpu.device_api).

- Descriptors: every ACCLCommand helper posts, field for field, the
  CCLOCall the JAX helper posts (a recording device, no engine).
- Mirrors of tests/test_device_api.py (vadd_put, the kernel-issued
  allreduce, send/recv with the call/ack order) on the port's EmuWorld
  and on CudaWorld(n, "cpu"), each held bitwise to the same function on
  the JAX EmuWorld and TpuWorld from one numpy seed.  Emulator pairs run
  one native engine, so float sums agree bitwise; CudaWorld against
  TpuWorld sums integer-valued float32 data, which every fold order sums
  exactly.
- DeviceCollectives over a list of member tensors against the JAX class
  under shard_map on 4 CPU devices: bitwise on integer-valued data.

Every world has 2-4 ranks and is closed inside its test; every wait is
30 s or less.
"""
import numpy as np
import pytest
import torch

import accl_tpu
from accl_tpu import device_api as jdev
from accl_tpu.backends import base as jbase
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
from accl_tpu_torch import device_api as tdev
from accl_tpu_torch.backends import base as tbase
from accl_tpu_torch.backends.emu import EmuWorld

NRANKS = 2
COUNT = 32
T = 30
F32 = (DataType.float32, DataType.float32)


def _data(count, salt=0, ints=False):
    rng = np.random.default_rng(555 + salt)
    if ints:
        return rng.integers(-1000, 1000, count).astype(np.float32)
    return rng.standard_normal(count).astype(np.float32)


# ---------------------------------------------------------------------------
# descriptors, field for field
# ---------------------------------------------------------------------------
def _recorder(base_mod):
    class Recorder(base_mod.CCLODevice):
        """Records every descriptor and acks it at once."""

        def __init__(self):
            self.calls = []

        def start(self, call, request):
            self.calls.append(call)
            request.complete(0, 0.0)

        def create_buffer(self, length, dtype):
            raise NotImplementedError

        def setup_rx_buffers(self, n_bufs, buf_size):
            pass

        def upload_communicator(self, comm):
            return comm.id

        def upload_arithconfig(self, cfg):
            return 0

        def alloc_mem(self, nbytes, alignment=64):
            return 0

        def free_mem(self, address):
            pass

        def read_mem(self, address, nbytes):
            return bytes(nbytes)

        def write_mem(self, address, data):
            pass

    return Recorder()


HELPERS = {
    "copy": ((16, 0x1000, 0x2000), {}),
    "combine": ((16, 1, 0x1000, 0x2000, 0x3000), {}),
    "send": ((16, 5, 1), {"src_addr": 0x1000}),
    "send_stream": ((16, 5, 1), {"stream_flags": 1}),
    "recv": ((16, 5, 0), {"dst_addr": 0x2000}),
    "recv_stream": ((16, 5, 0), {"stream_flags": 2}),
    "stream_put": ((16, 9, 1), {}),
    "stream_put_mem": ((16, 12, 1), {"src_addr": 0x1000,
                                     "from_stream": False}),
    "bcast": ((16, 1, 0x1000), {}),
    "scatter": ((16, 0, 0x1000, 0x2000), {}),
    "gather": ((16, 1, 0x1000, 0x2000), {}),
    "reduce": ((16, 1, 0, 0x1000, 0x2000), {}),
    "allgather": ((16, 0x1000, 0x2000), {}),
    "allreduce": ((16, 1, 0x1000, 0x2000), {}),
    "reduce_scatter": ((16, 0, 0x1000, 0x2000), {}),
    "barrier": ((), {}),
}


def _fields(call):
    return (int(call.scenario), call.count, call.comm, call.root_src_dst,
            call.function, call.tag, call.arithcfg,
            int(call.compression_flags), int(call.stream_flags),
            int(call.host_flags), call.addr_0, call.addr_1, call.addr_2,
            bool(call.fused), tuple(call.to_words()))


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_every_helper_posts_the_reference_descriptor(helper):
    args, kw = HELPERS[helper]
    name = helper.split("_stream")[0].replace("_mem", "")
    out = []
    for mod, base in ((jdev, jbase), (tdev, tbase)):
        dev = _recorder(base)
        cmd = mod.ACCLCommand(dev, comm=3, arithcfg=7)
        getattr(cmd, name)(*args, **kw)
        (call,) = dev.calls
        out.append(_fields(call))
    assert out[0] == out[1]


def test_start_call_fields_and_ack_order_match_the_reference():
    out = []
    for mod, base in ((jdev, jbase), (tdev, tbase)):
        dev = _recorder(base)
        cmd = mod.ACCLCommand(dev, comm=1, arithcfg=2)
        req = cmd.start_call(Operation.allreduce, 64, root_src_dst=0,
                             function=1, tag=9, compression_flags=8,
                             stream_flags=3, addr_0=0x10, addr_1=0x20,
                             addr_2=0x30)
        assert req.status.name == "COMPLETED"
        with pytest.raises(RuntimeError, match="previous call not "
                           "finalized"):
            cmd.start_call(Operation.nop, 0)
        assert cmd.finalize_call() == 0
        with pytest.raises(RuntimeError, match="no call in flight"):
            cmd.finalize_call()
        out.append(_fields(dev.calls[0]))
    assert out[0] == out[1]


def test_reserved_stream_ids_and_pull_errors_match_the_reference():
    for mod, base in ((jdev, jbase), (tdev, tbase)):
        cmd = mod.ACCLCommand(_recorder(base))
        with pytest.raises(ValueError) as e:
            cmd.stream_put(16, stream_id=8, dst=1)
        assert str(e.value) == "stream ids < 9 are reserved"

    class Pops:
        def __init__(self, raw):
            self.raw = raw

        def pop_stream(self, strm, nbytes, timeout):
            return self.raw

    msgs = []
    for mod in (jdev, tdev):
        with pytest.raises(TimeoutError) as e:
            mod.ACCLData(Pops(None)).pull(4, np.float32, stream_id=10)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.ACCLData(Pops(b"\0" * 12)).pull(4, np.float32, stream_id=10)
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[0] == "no message on stream 10"


def test_data_push_and_pull_roundtrip_on_the_cpu_world():
    with CudaWorld(1, device="cpu") as w:
        a = w.accls[0]
        d = tdev.ACCLData(a.device)
        x = np.arange(10, dtype=np.int32)
        d.push(x)
        dst = a.create_buffer(10, np.int32)
        a.copy_from_stream(dst, 10)
        np.testing.assert_array_equal(dst.host, x)
        src = a.create_buffer_like(x * 3)
        a.copy_to_stream(src, 10, stream_id=13)
        np.testing.assert_array_equal(d.pull(10, np.int32, 13, timeout=5),
                                      x * 3)
        with pytest.raises(TimeoutError, match="no message on stream 14"):
            d.pull(10, np.int32, 14, timeout=0.05)


# ---------------------------------------------------------------------------
# mirrors of tests/test_device_api.py, both packages on one seed
# ---------------------------------------------------------------------------
def _worlds(kind):
    """(the port's world, the JAX world it is held to)."""
    if kind == "emu":
        return EmuWorld(NRANKS), JEmuWorld(NRANKS)
    return CudaWorld(NRANKS, device="cpu"), TpuWorld(NRANKS)


def _both(kind, make_fn):
    port, ref = _worlds(kind)
    try:
        got = port.run(make_fn(tdev, F32), timeout=T)
        want = ref.run(make_fn(jdev, (accl_tpu.DataType.float32,
                                      accl_tpu.DataType.float32)))
    finally:
        port.close()
        ref.close()
    return got, want


KINDS = pytest.mark.parametrize("kind", ["emu", "cuda"])


@KINDS
def test_vadd_put_kernel(kind):
    """The vadd_put flow (kernels/plugins/vadd_put/vadd_put.cpp:23-86):
    the kernel pushes x + 1 and issues stream_put; the peer pulls it."""
    def make(mod, f32):
        def fn(accl, rank):
            cmd = mod.ACCLCommand(accl.device, arithcfg=accl._arith_ids[f32])
            data = mod.ACCLData(accl.device)
            if rank == 0:
                data.push(_data(COUNT) + np.float32(1.0))
                cmd.stream_put(COUNT, stream_id=9, dst=1)
                return None
            return data.pull(COUNT, np.float32, stream_id=9, timeout=T)
        return fn

    got, want = _both(kind, make)
    assert got[1].tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(got[1], _data(COUNT) + np.float32(1.0))


@KINDS
def test_kernel_initiated_allreduce(kind):
    """A kernel issuing an allreduce by raw device addresses (the
    client arbiter's second client, accl_hls.h allreduce :447)."""
    ints = kind == "cuda"

    def make(mod, f32):
        def fn(accl, rank):
            src = accl.create_buffer(COUNT, np.float32)
            dst = accl.create_buffer(COUNT, np.float32)
            src.host[:] = _data(COUNT, salt=rank, ints=ints)
            src.sync_to_device()
            cmd = mod.ACCLCommand(accl.device, arithcfg=accl._arith_ids[f32])
            cmd.allreduce(COUNT, int(ReduceFunction.SUM), src.address,
                          dst.address)
            dst.sync_from_device()
            return dst.host.copy()
        return fn

    got, want = _both(kind, make)
    exp = sum(_data(COUNT, salt=r, ints=ints) for r in range(NRANKS))
    for r in range(NRANKS):
        assert got[r].tobytes() == want[r].tobytes()
        np.testing.assert_allclose(got[r], exp, rtol=1e-5)


@KINDS
def test_kernel_sendrecv_and_ack_ordering(kind):
    def make(mod, f32):
        def fn(accl, rank):
            cmd = mod.ACCLCommand(accl.device, arithcfg=accl._arith_ids[f32])
            buf = accl.create_buffer(COUNT, np.float32)
            if rank == 0:
                buf.host[:] = _data(COUNT, salt=3)
                buf.sync_to_device()
                cmd.send(COUNT, tag=5, dst=1, src_addr=buf.address)
                cmd.start_call(Operation.nop, 0)
                with pytest.raises(RuntimeError):
                    cmd.start_call(Operation.nop, 0)
                cmd.finalize_call()
                return None
            cmd.recv(COUNT, tag=5, src=0, dst_addr=buf.address)
            buf.sync_from_device()
            return buf.host.copy()
        return fn

    got, want = _both(kind, make)
    assert got[1].tobytes() == want[1].tobytes() == \
        _data(COUNT, salt=3).tobytes()


@KINDS
def test_stream_to_stream_allreduce_by_start_call(kind):
    """The device phase's call: each rank pushes its operand and issues
    start_call(allreduce, OP0_STREAM | RES_STREAM, tag 9), then pulls.
    The native engine stages a stream allreduce through device memory at
    address 0, so on the emulator both packages fail it alike
    (DMA_SIZE_ERROR); CudaWorld and TpuWorld deliver the sum."""
    ints = kind == "cuda"
    flags = int(StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM)

    def make(mod, f32):
        def fn(accl, rank):
            data = mod.ACCLData(accl.device)
            data.push(_data(COUNT, salt=10 + rank, ints=ints))
            cmd = mod.ACCLCommand(accl.device, arithcfg=accl._arith_ids[f32])
            cmd.start_call(Operation.allreduce, COUNT, function=0, tag=9,
                           stream_flags=flags)
            try:
                cmd.finalize_call(timeout=T)
            except Exception as e:  # noqa: BLE001 — compared across packages
                return f"{type(e).__name__}: {e}"
            return data.pull(COUNT, np.float32, stream_id=9, timeout=T)
        return fn

    got, want = _both(kind, make)
    for r in range(NRANKS):
        if kind == "emu":
            assert got[r] == want[r] == \
                "ACCLError: krnl:allreduce failed: DMA_SIZE_ERROR"
        else:
            assert got[r].tobytes() == want[r].tobytes()
            np.testing.assert_array_equal(
                got[r], sum(_data(COUNT, salt=10 + q, ints=True)
                            for q in range(NRANKS)))


# ---------------------------------------------------------------------------
# DeviceCollectives against the JAX class under shard_map
# ---------------------------------------------------------------------------
def test_device_collectives_match_the_reference_under_shard_map():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from accl_tpu.utils.compat import shard_map

    P_ = 4
    mesh = Mesh(np.array(jax.devices()[:P_]), ("rank",))
    jcol = jdev.DeviceCollectives("rank")
    rng = np.random.default_rng(11)
    x = rng.integers(-50, 50, (P_, P_, 6)).astype(np.float32)
    ops = {
        "allreduce": lambda v: jcol.allreduce(v),
        "allreduce_max": lambda v: jcol.allreduce(v, "max"),
        "reduce": lambda v: jcol.reduce(v, 2),
        "allgather": lambda v: jcol.allgather(v),
        "allgather_stacked": lambda v: jcol.allgather(v, tiled=False),
        "reduce_scatter": lambda v: jcol.reduce_scatter(v),
        "alltoall": lambda v: jcol.alltoall(v),
        "bcast": lambda v: jcol.bcast(v, root=1),
        "scatter": lambda v: jcol.scatter(v, root=3),
        "gather": lambda v: jcol.gather(v, root=0),
        "send_recv": lambda v: jcol.send_recv(v, 1, 2),
        "barrier": lambda v: jcol.barrier() + jnp.zeros((), v.dtype),
    }
    names = sorted(ops)

    def body(xs):
        v = xs[0]
        return tuple(ops[k](v)[None] for k in names)

    fn = shard_map(body, mesh=mesh, in_specs=JP("rank"),
                   out_specs=tuple(JP("rank") for _ in names))
    outs = jax.jit(fn)(jnp.asarray(x))
    want = {k: np.asarray(o) for k, o in zip(names, outs)}

    col = tdev.DeviceCollectives()
    xs = [torch.from_numpy(x[r]) for r in range(P_)]
    got = {
        "allreduce": col.allreduce(xs),
        "allreduce_max": col.allreduce(xs, "max"),
        "reduce": col.reduce(xs, 2),
        "allgather": col.allgather(xs),
        "allgather_stacked": col.allgather(xs, tiled=False),
        "reduce_scatter": col.reduce_scatter(xs),
        "alltoall": col.alltoall(xs),
        "bcast": col.bcast(xs, 1),
        "scatter": col.scatter(xs, 3),
        "gather": col.gather(xs, 0),
        "send_recv": col.send_recv(xs, 1, 2),
        "barrier": [b.to(torch.float32) for b in col.barrier(xs)],
    }
    for k in names:
        assert len(got[k]) == P_, k
        for r in range(P_):
            np.testing.assert_array_equal(got[k][r].numpy(), want[k][r],
                                          err_msg=k)


def test_short_stream_operand_raises_from_finalize():
    """A retcode surfaces from finalize_call as the request's ACCLError
    (accl_hls.h:204-216 reads the sts stream): here a stream operand
    shorter than the call's count."""
    with CudaWorld(2, device="cpu") as w:
        a = w.accls[0]
        cmd = tdev.ACCLCommand(a.device, arithcfg=a._arith_ids[F32])
        a.device.push_krnl(np.zeros(3, np.float32))
        with pytest.raises(ACCLError, match="SEGMENTER_EXPECTED_BTT"):
            cmd.start_call(Operation.allreduce, 8, tag=9,
                           stream_flags=StreamFlags.OP0_STREAM)
            cmd.finalize_call(timeout=T)


def test_host_only_operands_set_the_reference_host_flags():
    """The driver marks host-resident operands OP0/OP1/RES_HOST
    (reference prepare_call, accl.cpp:1259-1283) as the JAX driver
    does."""
    from accl_tpu import Operation as JOperation

    out = []
    for world, op in ((EmuWorld(1), Operation), (JEmuWorld(1), JOperation)):
        with world as w:
            a = w.accls[0]
            h = a.create_buffer(8, np.float32, host_only=True)
            d = a.create_buffer(8, np.float32)
            out.append([a._build(op.copy, 8, 0, op0=x, res=y).to_words()
                        for x, y in ((h, d), (d, h), (h, h), (d, d))])
    assert out[0] == out[1]
    assert [words[8] >> 8 for words in out[0]] == [1, 4, 5, 0]
