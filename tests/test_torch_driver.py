"""The port's driver (accl_tpu_torch: ACCL over CudaWorld on the CPU)
against the JAX package's (accl_tpu: ACCL over TpuWorld on the
4-device CPU mesh).

Each test makes per-rank inputs with numpy from a seed, creates them as
buffers in the TpuWorld, reads them back off it into a plain-data state
and loads that into the CudaWorld with ``load_world_state``; then the
same per-rank function runs on both worlds.

Tolerances:
- bitwise for the ring lane (threshold 0: the port's plain ring folds in
  the Pallas kernels' order), for MAX, and for every pure data movement
  (bcast, gather, scatter, allgather, alltoall, send/recv, copy);
- bitwise for the fused lane at any size (the chunked ring folds in the
  same order in both packages), and for the int8 lane wherever the sum
  is a ring (the quantized ring, the fused lane's quantized chunks, and
  the roundtrip model around the plain ring for MAX and ragged
  payloads);
- for int8 SUM below the threshold, where the two packages' psums may
  round to neighbouring fp32 values before the exit roundtrip: bitwise
  but for at most 2 elements per result, each exactly one quantization
  step of its own block away (``_int8_psum_parity``);
- bitwise for the f16/bf16 cast lanes around data movement and around
  the ring lane (torch and JAX both round to nearest even);
- rtol=1e-6, atol=1e-6 for fp32 SUM below the threshold, because XLA's
  psum adds in another order than the port's sum over the rank axis;
  with a cast lane around such a sum, one unit in the wire dtype's last
  place (the two f32 sums may round to neighbouring wire values).
"""
import numpy as np
import pytest
import torch

from accl_tpu import ACCLError as JACCLError
from accl_tpu import DataType as JDataType
from accl_tpu import ReduceFunction as JReduce
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.constants import TAG_ANY as JTAG_ANY
from accl_tpu_torch import (
    TAG_ANY,
    ACCLError,
    CudaWorld,
    DataType,
    Operation,
    ReduceFunction,
    StreamFlags,
    load_world_state,
)
from accl_tpu_torch.ops import fused as tfused
from accl_tpu_torch.ops import quantized as tquant
from accl_tpu_torch.ops import ring as tring

NR = 4
N = 64
PLAIN = 4 << 20  # the default ring threshold: small payloads stay plain
RING = 0         # every eligible collective rides the ring lane
LANES = {"plain": PLAIN, "ring": RING}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread is enough, and it keeps this
    # module from crowding the other test workers' CPUs
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def worlds():
    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as cw:
        yield tw, cw


def _data(n, rank, salt=0, dtype=np.float32):
    rng = np.random.default_rng(1000 + 17 * rank + 131 * salt)
    return rng.standard_normal(n).astype(dtype)


def _run_both(worlds, inputs, fn, threshold=PLAIN):
    """inputs: rank -> list of numpy arrays.  fn(accl, rank, bufs, lib)
    runs on both worlds (lib is "jax" or "torch") and returns a list of
    numpy arrays.  Returns (jax results, port results) per rank."""
    tw, cw = worlds
    tbufs = {r: [tw.accls[r].create_buffer_like(a) for a in arrs]
             for r, arrs in inputs.items()}
    for bufs in tbufs.values():
        for b in bufs:
            b.sync_to_device()
            b.sync_from_device()
    state = {"buffers": {r: [b.host.copy() for b in bufs]
                         for r, bufs in tbufs.items()},
             "ring_threshold_bytes": threshold}
    loaded = load_world_state(cw, state)
    assert cw.engine.ring_threshold_bytes == threshold
    saved = tw.engine.ring_threshold_bytes
    tw.engine.ring_threshold_bytes = threshold
    try:
        got_j = tw.run(lambda a, r: fn(a, r, tbufs[r], "jax"))
        got_t = cw.run(lambda a, r: fn(a, r, loaded["buffers"][r], "torch"))
    finally:
        tw.engine.ring_threshold_bytes = saved
        for a in cw.accls:
            a.set_tuning(6, PLAIN)
    return got_j, got_t


def _same(got_j, got_t, exact=True, rtol=1e-6, atol=1e-6):
    for rj, rt in zip(got_j, got_t):
        assert len(rj) == len(rt)
        for a, b in zip(rj, rt):
            if exact:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _enums(lib):
    if lib == "jax":
        return JReduce, JDataType
    return ReduceFunction, DataType


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("func", ["SUM", "MAX"])
def test_reducing_collectives(worlds, lane, func):
    inputs = {r: [_data(N * NR, r, 1)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        Red, _ = _enums(lib)
        f = Red[func]
        x = bufs[0]
        ar = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, ar, N * NR, function=f)
        rs = accl.create_buffer(N, np.float32)
        accl.reduce_scatter(x, rs, N, function=f)
        red = accl.create_buffer(N * NR, np.float32)
        accl.reduce(x, red, N * NR, root=1, function=f)
        out = [ar.host.copy(), rs.host.copy()]
        return out + ([red.host.copy()] if rank == 1 else [])

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    if func == "MAX":
        _same(got_j, got_t)
        return
    # allreduce and reduce_scatter ride the ring on the ring lane; reduce
    # never does (it is a psum on both lanes)
    for rj, rt in zip(got_j, got_t):
        _same([rj[:2]], [rt[:2]], exact=lane == "ring")
        _same([rj[2:]], [rt[2:]], exact=False)
    total = np.sum([inputs[r][0] for r in range(NR)], axis=0)
    np.testing.assert_allclose(got_t[0][0], total, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lane", list(LANES))
def test_data_movement(worlds, lane):
    inputs = {r: [_data(N, r, 2), _data(N * NR, r, 3)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        x, big = bufs
        out = []
        b = accl.create_buffer(N, np.float32)
        if rank == 2:
            b.host[:] = x.host
        accl.bcast(b, N, root=2)
        out.append(b.host.copy())
        part = accl.create_buffer(N, np.float32)
        accl.scatter(big, part, N, root=1)
        out.append(part.host.copy())
        back = accl.create_buffer(N * NR, np.float32)
        accl.gather(x, back, N, root=3)
        if rank == 3:
            out.append(back.host.copy())
        ag = accl.create_buffer(N * NR, np.float32)
        accl.allgather(x, ag, N)
        out.append(ag.host.copy())
        a2a = accl.create_buffer(N * NR, np.float32)
        accl.alltoall(big, a2a, N)
        out.append(a2a.host.copy())
        return out

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    _same(got_j, got_t)
    np.testing.assert_array_equal(got_t[0][0], inputs[2][0])
    np.testing.assert_array_equal(
        got_t[0][-2], np.concatenate([inputs[r][0] for r in range(NR)]))


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
@pytest.mark.parametrize("lane", list(LANES))
def test_wire_compression(worlds, wire, lane):
    inputs = {r: [_data(N * NR, r, 4)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        _, DT = _enums(lib)
        wd = DT[wire]
        x = bufs[0]
        b = accl.create_buffer(N * NR, np.float32)
        if rank == 0:
            b.host[:] = x.host
        accl.bcast(b, N * NR, root=0, compress_dtype=wd)
        ag = accl.create_buffer(N * NR * NR, np.float32)
        accl.allgather(x, ag, N * NR, compress_dtype=wd)
        ar = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, ar, N * NR, compress_dtype=wd)
        return [b.host.copy(), ag.host.copy(), ar.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    for rj, rt in zip(got_j, got_t):
        _same([rj[:2]], [rt[:2]])
        if lane == "ring":
            _same([rj[2:]], [rt[2:]])
        else:
            ulp = 2.0 ** (-10 if wire == "float16" else -7)
            _same([rj[2:]], [rt[2:]], exact=False, rtol=ulp,
                  atol=ulp * np.abs(rj[2]).max())
    # the wire hop really narrowed the payload
    assert not np.array_equal(got_t[1][0], inputs[0][0])


def test_sub_communicator(worlds):
    tw, cw = worlds
    members = [0, 2]
    inputs = {r: [_data(N, r, 5)] for r in range(NR)}
    tbufs = {r: [tw.accls[r].create_buffer_like(a) for a in arrs]
             for r, arrs in inputs.items()}
    tids = {tw.accls[r].create_communicator(members) if r in members
            else tw.accls[r].reserve_communicator() for r in range(NR)}
    loaded = load_world_state(cw, {"buffers": inputs, "comms": [members]})
    (tid,), (cid,) = tids, loaded["comms"]
    assert tid == cid

    def fn(accl, rank, bufs, comm_id):
        if rank not in members:
            return []
        ar = accl.create_buffer(N, np.float32)
        accl.allreduce(bufs[0], ar, N, comm_id=comm_id)
        ag = accl.create_buffer(N * 2, np.float32)
        accl.allgather(bufs[0], ag, N, comm_id=comm_id)
        return [ar.host.copy(), ag.host.copy()]

    got_j = tw.run(lambda a, r: fn(a, r, tbufs[r], tid))
    got_t = cw.run(lambda a, r: fn(a, r, loaded["buffers"][r], cid))
    for rj, rt in zip(got_j, got_t):
        if rj:
            _same([rj[:1]], [rt[:1]], exact=False)
            _same([rj[1:]], [rt[1:]])
    np.testing.assert_allclose(got_t[0][0], inputs[0][0] + inputs[2][0],
                               rtol=1e-6)


@pytest.mark.parametrize("lane", list(LANES))
def test_run_async_requests(worlds, lane):
    inputs = {r: [_data(N * NR, r, 6)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        ar = accl.create_buffer(N * NR, np.float32)
        ag = accl.create_buffer(N * NR * NR, np.float32)
        r1 = accl.allreduce(bufs[0], ar, N * NR, run_async=True)
        r2 = accl.allgather(bufs[0], ag, N * NR, run_async=True)
        for req in (r1, r2):
            assert req.wait(60)
            req.check()
        return [ar.host.copy(), ag.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    for rj, rt in zip(got_j, got_t):
        _same([rj[:1]], [rt[:1]], exact=lane == "ring")
        _same([rj[1:]], [rt[1:]])


def test_send_recv_tags_and_tag_any(worlds):
    inputs = {r: [_data(N, r, 7), _data(N, r, 8)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        any_tag = JTAG_ANY if lib == "jax" else TAG_ANY
        nxt, prv = (rank + 1) % NR, (rank - 1) % NR
        d1 = accl.create_buffer(N, np.float32)
        d2 = accl.create_buffer(N, np.float32)
        s1 = accl.send(bufs[0], N, nxt, tag=3, run_async=True)
        s2 = accl.send(bufs[1], N, nxt, tag=42, run_async=True)
        accl.recv(d1, N, prv, tag=3)
        accl.recv(d2, N, prv, tag=any_tag)
        for s in (s1, s2):
            assert s.wait(30)
            s.check()
        return [d1.host.copy(), d2.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    _same(got_j, got_t)
    np.testing.assert_array_equal(got_t[1][0], inputs[0][0])
    np.testing.assert_array_equal(got_t[1][1], inputs[0][1])


def test_send_recv_tag_mismatch_is_a_sequence_error(worlds):
    _, cw = worlds

    def fn(accl, rank):
        if rank >= 2:
            return None
        buf = accl.create_buffer_like(_data(N, rank, 9))
        if rank == 0:
            accl.send(buf, N, 1, tag=5)
            return None
        with pytest.raises(ACCLError, match="PACK_SEQ_NUMBER_ERROR"):
            accl.recv(buf, N, 0, tag=6)
        accl.recv(buf, N, 0, tag=5)  # the send stays queued for its tag
        return buf.host.copy()

    got = cw.run(fn)
    np.testing.assert_array_equal(got[1], _data(N, 0, 9))


@pytest.mark.parametrize("func", ["SUM", "MAX"])
def test_copy_and_combine(worlds, func):
    inputs = {r: [_data(N, r, 10), _data(N, r, 11)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        Red, _ = _enums(lib)
        dst = accl.create_buffer(N, np.float32)
        accl.copy(bufs[0], dst, N)
        res = accl.create_buffer(N, np.float32)
        accl.combine(N, Red[func], bufs[0], bufs[1], res)
        return [dst.host.copy(), res.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    _same(got_j, got_t)
    op = np.maximum if func == "MAX" else np.add
    np.testing.assert_array_equal(got_t[2][1], op(inputs[2][0], inputs[2][1]))


def test_buffer_larger_than_one_mib(worlds):
    big = 300_000  # 1.2 MB of fp32 per rank
    inputs = {r: [_data(big, r, 12)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        ar = accl.create_buffer(big, np.float32)
        accl.allreduce(bufs[0], ar, big)
        return [ar.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    _same(got_j, got_t, exact=False)


def test_addresses_resolve_past_one_mib():
    # a 3 MiB buffer followed by a small one: sub-range descriptors deep
    # inside the big buffer must resolve to it, not to its neighbour
    with CudaWorld(2, device="cpu") as w:
        n = 3 << 18  # 3 MiB of fp32
        k = n - 1000

        def fn(accl, rank):
            big = accl.create_buffer_like(_data(n, rank, 13))
            small = accl.create_buffer(1000, np.float32)
            out = accl.create_buffer(2000, np.float32)
            accl.copy(big.slice(k, n), small, 1000)
            accl.allgather(big.slice(k, n), out, 1000)
            return small.host.copy(), out.host.copy()

        got = w.run(fn)
        for rank in range(2):
            np.testing.assert_array_equal(got[rank][0], _data(n, rank, 13)[k:])
            np.testing.assert_array_equal(
                got[rank][1],
                np.concatenate([_data(n, r, 13)[k:] for r in range(2)]))


@pytest.mark.parametrize("lane", list(LANES))
def test_training_step_loop_end_to_end(worlds, lane):
    # the slice end to end: allreduce the gradient, reduce-scatter it to
    # shards, update the shard, all-gather the parameters — on the same
    # buffers, several steps
    inputs = {r: [_data(N * NR, r, 14), _data(N * NR, r, 15)]
              for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        grad, param = bufs
        summed = accl.create_buffer(N * NR, np.float32)
        shard = accl.create_buffer(N, np.float32)
        for _ in range(3):
            accl.allreduce(grad, summed, N * NR)
            accl.reduce_scatter(summed, shard, N)
            shard.host[:] = param.host[rank * N:(rank + 1) * N] \
                - np.float32(0.01) * shard.host
            accl.allgather(shard, param, N)
            grad.host[:] = summed.host * np.float32(0.5)
        return [summed.host.copy(), param.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    if lane == "ring":
        _same(got_j, got_t)
    else:
        _same(got_j, got_t, exact=False, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got_t[0][1]).all()


def test_left_out_lanes_raise(worlds):
    """Kernel streams are part of the port now: a send from the kernel
    stream with no operand queued fails on both worlds with the same
    error (the reference engine pops an empty queue, tpu.py:539-540)."""
    msgs = []
    for w, err in zip(worlds, (JACCLError, ACCLError)):
        accl = w.accls[0]
        x = accl.create_buffer_like(_data(N, 0, 16))
        with pytest.raises(err, match="pop from an empty deque") as e:
            accl.send(x, N, 1, stream_flags=StreamFlags.OP0_STREAM)
        msgs.append(str(e.value).split(" [flight:")[0])
    assert msgs[0] == msgs[1]


def _torch_inputs(inputs, i=0):
    return [torch.from_numpy(inputs[r][i]) for r in range(NR)]


@pytest.mark.parametrize("lane", list(LANES))
def test_fused_lane_bitwise(worlds, lane):
    # the fused lane takes allreduce, reduce_scatter and allgather at any
    # size: below the threshold too, where the unfused call is a psum
    inputs = {r: [_data(N * NR, r, 18)] for r in range(NR)}
    ragged = N * NR - 6  # pads to a multiple of P * C inside the lane

    def fn(accl, rank, bufs, lib):
        Red, _ = _enums(lib)
        x = bufs[0]
        ar = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, ar, N * NR, fused=True)
        mx = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, mx, N * NR, function=Red.MAX, fused=True)
        rg = accl.create_buffer(ragged, np.float32)
        accl.allreduce(x, rg, ragged, fused=True)
        rs = accl.create_buffer(N, np.float32)
        accl.reduce_scatter(x, rs, N, fused=True)
        ag = accl.create_buffer(N * NR * NR, np.float32)
        accl.allgather(x, ag, N * NR, fused=True)
        return [ar.host.copy(), mx.host.copy(), rg.host.copy(),
                rs.host.copy(), ag.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    _same(got_j, got_t)
    # N * NR divides P * C (C = 4): the fused lane equals the ring lane
    ringed = tring.ring_all_reduce(_torch_inputs(inputs))
    np.testing.assert_array_equal(got_t[1][0], ringed[1].numpy())


def test_fused_default_from_env_and_per_call_override(monkeypatch):
    # ACCL_FUSED=1 makes fused the default; fused=False on the same
    # buffers must still give the unfused lane's result (the descriptor
    # memo keys on the resolved flag)
    monkeypatch.setenv("ACCL_FUSED", "1")
    inputs = {r: [_data(N * NR, r, 19)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        y = accl.create_buffer(N * NR, np.float32)
        out = []
        for fused in (None, False, None, True):
            accl.allreduce(bufs[0], y, N * NR, fused=fused)
            out.append(y.host.copy())
        return out

    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as cw:
        got_j, got_t = _run_both((tw, cw), inputs, fn)
    for rj, rt in zip(got_j, got_t):
        _same([rj[0::2] + rj[3:]], [rt[0::2] + rt[3:]])
        _same([rj[1:2]], [rt[1:2]], exact=False)
    xs = _torch_inputs(inputs)
    fused = tfused.chunked_ring_all_reduce(xs)[0].numpy()
    plain = torch.stack(xs).sum(0).numpy()  # the port's unfused psum
    assert not np.array_equal(fused, plain)
    for rt in got_t:
        for got in (rt[0], rt[2], rt[3]):
            np.testing.assert_array_equal(got, fused)
        np.testing.assert_array_equal(rt[1], plain)


def test_descriptor_memo_keys_on_the_resolved_fused_flag(monkeypatch):
    monkeypatch.setenv("ACCL_FUSED", "1")
    with CudaWorld(2, device="cpu") as w:
        a = w.accls[0]
        x = a.create_buffer(8, np.float32)
        y = a.create_buffer(8, np.float32)
        d_default = a._build(Operation.allreduce, 8, 0, op0=x, res=y)
        d_off = a._build(Operation.allreduce, 8, 0, op0=x, res=y,
                         fused=False)
        d_on = a._build(Operation.allreduce, 8, 0, op0=x, res=y, fused=True)
        assert d_default.fused and not d_off.fused
        assert d_on is d_default and d_off is not d_default


def _int8_psum_parity(a, b, key, block=256, max_moved=2):
    """int8 SUM below the threshold: the exit roundtrip quantizes each
    package's psum, and the two psums may add in different orders.  All
    but ``max_moved`` elements must be bitwise equal, and each one that
    moved must sit exactly one quantization step of its own block away
    (a neighbouring int8 code under the same scale)."""
    moved = np.flatnonzero(a != b)
    assert moved.size <= max_moved, (key, moved.size)
    for i in moved:
        blk = a[i // block * block:(i // block + 1) * block]
        step = np.float32(np.abs(blk).max()) * np.float32(1 / 127)
        np.testing.assert_allclose(abs(float(b[i]) - float(a[i])), step,
                                   rtol=1e-5, err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("lane", list(LANES))
def test_int8_wire_lane(worlds, lane):
    # ring lane: SUM allreduce / reduce_scatter / allgather ride the
    # quantized ring; MAX and a ragged count fall back to the roundtrip
    # model around the plain ring; fused=True takes the fused lane's
    # quantized chunks at any size
    inputs = {r: [_data(N * NR, r, 20)] for r in range(NR)}
    ragged = N * NR - 2

    def fn(accl, rank, bufs, lib):
        Red, DT = _enums(lib)
        i8 = DT.int8
        x = bufs[0]
        out = {}
        for key, func, count, fused in (
                ("ar", Red.SUM, N * NR, None), ("max", Red.MAX, N * NR, None),
                ("ragged", Red.SUM, ragged, None),
                ("fused", Red.SUM, N * NR, True),
                ("fused_max", Red.MAX, N * NR, True)):
            b = accl.create_buffer(count, np.float32)
            accl.allreduce(x, b, count, function=func, compress_dtype=i8,
                           fused=fused)
            out[key] = b.host.copy()
        rs = accl.create_buffer(N, np.float32)
        accl.reduce_scatter(x, rs, N, compress_dtype=i8)
        out["rs"] = rs.host.copy()
        ag = accl.create_buffer(N * NR * NR, np.float32)
        accl.allgather(x, ag, N * NR, compress_dtype=i8)
        out["ag"] = ag.host.copy()
        b = accl.create_buffer(N * NR, np.float32)
        if rank == 1:
            b.host[:] = x.host
        accl.bcast(b, N * NR, root=1, compress_dtype=i8)
        out["bcast"] = b.host.copy()
        return [out[k] for k in sorted(out)]

    got_j, got_t = _run_both(worlds, inputs, fn, LANES[lane])
    keys = sorted(["ar", "max", "ragged", "fused", "fused_max", "rs", "ag",
                   "bcast"])
    sums = {"ar", "ragged", "rs"}
    for rj, rt in zip(got_j, got_t):
        for k, a, b in zip(keys, rj, rt):
            if lane == "plain" and k in sums:
                _int8_psum_parity(a, b, k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
    if lane == "ring":
        want = tquant.quantized_all_reduce(_torch_inputs(inputs))
        np.testing.assert_array_equal(got_t[0][keys.index("ar")],
                                      want[0].numpy())
    exact = np.sum([inputs[r][0] for r in range(NR)], axis=0)
    np.testing.assert_allclose(got_t[0][keys.index("ar")], exact,
                               atol=NR * (2 * 5 * np.sqrt(NR) / 127))


def test_int8_policy_from_env_with_error_feedback(monkeypatch):
    # ACCL_COMPRESS=int8 + ACCL_COMPRESS_EF=1 arm the policy at
    # initialize: uncompressed calls get the int8 lane's error-feedback
    # twin, on the quantized ring and in the fused lane's chunks
    monkeypatch.setenv("ACCL_COMPRESS", "int8")
    monkeypatch.setenv("ACCL_COMPRESS_EF", "1")
    monkeypatch.setenv("ACCL_COMPRESS_MIN_BYTES", "0")
    monkeypatch.setenv("ACCL_COMPRESS_BLOCK", "32")
    inputs = {r: [_data(N * NR, r, 21)] for r in range(NR)}

    def fn(accl, rank, bufs, lib):
        x = bufs[0]
        ar = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, ar, N * NR)
        fz = accl.create_buffer(N * NR, np.float32)
        accl.allreduce(x, fz, N * NR, fused=True)
        rs = accl.create_buffer(N, np.float32)
        accl.reduce_scatter(x, rs, N)
        return [ar.host.copy(), fz.host.copy(), rs.host.copy()]

    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as cw:
        pol = cw.accls[0].compression_policy
        assert pol.dtype == DataType.int8 and pol.error_feedback
        assert pol.block == 32
        got_j, got_t = _run_both((tw, cw), inputs, fn, RING)
    _same(got_j, got_t)
    xs = _torch_inputs(inputs)
    with_ef = tquant.quantized_all_reduce(xs, 32, error_feedback=True)
    without = tquant.quantized_all_reduce(xs, 32, error_feedback=False)
    np.testing.assert_array_equal(got_t[0][0], with_ef[0].numpy())
    assert not np.array_equal(got_t[0][0], without[0].numpy())


def test_compression_policy_select_matches_jax():
    from accl_tpu.arithconfig import CompressionPolicy as JPolicy
    from accl_tpu_torch.arithconfig import CompressionPolicy

    jp, tp = JPolicy(min_bytes=1024), CompressionPolicy(min_bytes=1024)
    jp.per_comm[3] = None
    tp.per_comm[3] = None
    for scen in (Operation.allreduce, Operation.send, Operation.alltoall,
                 Operation.bcast):
        for count in (0, 255, 256, 1 << 20):
            for comm in (0, 3):
                for dt in ("float32", "float64"):
                    a = jp.select(int(scen), count, comm, JDataType[dt])
                    b = tp.select(int(scen), count, comm, DataType[dt])
                    assert (a is None and b is None) or a.name == b.name
    assert tp.wants_error_feedback(0) is False


def test_int8_operand_checks_raise_like_jax(worlds):
    msgs = []
    for world, DT, Err in zip(worlds, (JDataType, DataType),
                              (JACCLError, ACCLError)):
        accl = world.accls[0]
        f64 = accl.create_buffer(N, np.float64)
        f32 = accl.create_buffer(N, np.float32)
        i8 = accl.create_buffer(N, np.int8)
        got = []
        for src, dst in ((f64, f64), (i8, f32), (f32, i8)):
            with pytest.raises(Err) as e:
                accl.allreduce(src, dst, N, compress_dtype=DT.int8)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "float32" in msgs[1][1]


def test_barrier_nop_and_duration(worlds):
    _, cw = worlds

    def fn(accl, rank):
        accl.barrier()
        accl.nop()
        x = accl.create_buffer_like(_data(N, rank, 17))
        y = accl.create_buffer(N, np.float32)
        req = accl.allreduce(x, y, N)
        return accl.get_duration(req)

    assert all(d >= 0 for d in cw.run(fn))
