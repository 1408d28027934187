"""ACCL_DEVICE_TRACE on the port: the ring's stamp rows (ops/ring.py,
csrc/ring.cu stamp mode) and the fused lane's host rows (ops/fused.py),
held to the JAX package's device-trace plane (tests/test_device_trace.py:
4 ranks, 64 elements, seg_elems=32, the Pallas kernels in interpret
mode).

What is compared, all exactly:
- the collectors' device records, as multisets of (collective, rows);
- ``device_link_bytes()``;
- nothing is recorded with the gate off;
- results are bitwise equal with the gate on and off;
- the fused lane's rows against ``_fused_stamp_rows``;
- the kernel's row-writing rule (the block of a segment's first tile
  writes rank r's row of step s), run in Python over the launch
  geometry, against the plain rows: every row written once.
Each test runs under its own SIGALRM limit.
"""
import signal
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import accl_tpu.ops.fused as jfused
import accl_tpu.ops.ring as jring
from accl_tpu.observability import trace as jtrace
from accl_tpu.parallel import make_mesh
from accl_tpu_torch import CudaWorld, ReduceFunction
from accl_tpu_torch.ops import fused as tfused
from accl_tpu_torch.ops import ring as tring
from accl_tpu_torch.observability import trace as obs_trace

try:
    from jax import shard_map
except ImportError:  # older jax spells it experimental
    from jax.experimental.shard_map import shard_map

NR = 4
TEST_LIMIT_S = 240


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def gate(monkeypatch):
    """Set the gate on both packages and clear both collectors; restore
    the cached gates afterwards."""
    def set_gate(on: bool):
        if on:
            monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
        else:
            monkeypatch.delenv("ACCL_DEVICE_TRACE", raising=False)
        jring._reset_device_trace_cache()
        tring._reset_device_trace_cache()
        jtrace.collector().clear()
        obs_trace.collector().clear()

    yield set_gate
    jring._reset_device_trace_cache()
    tring._reset_device_trace_cache()
    jtrace.collector().clear()
    obs_trace.collector().clear()


def _records(collector):
    return Counter((r["collective"], tuple(map(tuple, r["rows"])))
                   for r in collector.device_records())


def _mesh():
    if len(jax.devices()) < NR:
        pytest.skip("needs a 4-device mesh")
    return make_mesh(dp=NR)


def _smap(mesh, fn):
    try:
        return shard_map(fn, mesh=mesh, in_specs=PS("dp", None),
                         out_specs=PS("dp", None), check_vma=False)
    except TypeError:
        return shard_map(fn, mesh=mesh, in_specs=PS("dp", None),
                         out_specs=PS("dp", None), check_rep=False)


def _jax_run(body, x):
    mesh = _mesh()
    xs = jax.device_put(x, NamedSharding(mesh, PS("dp", None)))
    return np.asarray(jax.jit(_smap(mesh, body))(xs))


X64 = np.stack([np.arange(64, dtype=np.float32) + r for r in range(NR)])


def _jax_allreduce(x, seg=32):
    return _jax_run(lambda xb: jring.ring_all_reduce_segmented(
        xb[0], "dp", seg_elems=seg, interpret=True)[None], x)


def _port_allreduce(x, seg=32):
    out = tring.ring_all_reduce_segmented(
        [torch.from_numpy(x[r].copy()) for r in range(NR)], "sum",
        seg_elems=seg)
    return np.stack([o.numpy() for o in out])


# ---------------------------------------------------------------------------
# the segmented drivers, held to the reference
# ---------------------------------------------------------------------------
def test_allreduce_records_match_reference(gate):
    gate(True)
    want = _jax_allreduce(X64)
    got = _port_allreduce(X64)
    np.testing.assert_array_equal(got, want)
    jrec, trec = _records(jtrace.collector()), _records(obs_trace.collector())
    # 2 segments x (reduce-scatter + all-gather) x 4 ranks
    assert sum(jrec.values()) == 16
    assert trec == jrec
    assert obs_trace.collector().device_link_bytes() == \
        jtrace.collector().device_link_bytes()


@pytest.mark.parametrize("n,seg", [(80, 32), (64, 64), (5, 2)])
def test_gather_and_scatter_segments_match_reference(gate, n, seg):
    gate(True)
    x = np.stack([np.arange(n * NR, dtype=np.float32) * (r + 1)
                  for r in range(NR)])
    xs = [torch.from_numpy(x[r].copy()) for r in range(NR)]
    want_ag = _jax_run(lambda xb: jring.ring_all_gather_segmented(
        xb[0, :n], "dp", seg_elems=seg, interpret=True)[None], x)
    want_rs = _jax_run(lambda xb: jring.ring_reduce_scatter_segmented(
        xb[0], "dp", seg_elems=seg, interpret=True)[None], x)
    got_ag = tring.ring_all_gather_segmented([t[:n].clone() for t in xs],
                                             seg_elems=seg)
    got_rs = tring.ring_reduce_scatter_segmented(xs, "sum", seg_elems=seg)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got_ag]),
                                  want_ag)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got_rs]),
                                  want_rs)
    jrec, trec = _records(jtrace.collector()), _records(obs_trace.collector())
    nseg = -(-n // seg)
    assert sum(jrec.values()) == 2 * nseg * NR
    assert trec == jrec
    assert obs_trace.collector().device_link_bytes() == \
        jtrace.collector().device_link_bytes()


def test_device_trace_off_emits_nothing(gate):
    gate(False)
    _port_allreduce(X64)
    tfused.chunked_ring_all_reduce([torch.ones(16)] * NR)
    assert obs_trace.collector().device_records() == []


def test_on_off_results_bitwise_identical(gate):
    gate(False)
    x = np.random.default_rng(5).standard_normal((NR, 301)).astype(np.float32)
    off = _port_allreduce(x, seg=64)
    gate(True)
    on = _port_allreduce(x, seg=64)
    np.testing.assert_array_equal(off, on)
    assert obs_trace.collector().device_records()


def test_env_gate_read_once(gate, monkeypatch):
    gate(False)
    assert tring.device_trace_enabled() is False
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    assert tring.device_trace_enabled() is False  # cached
    tring._reset_device_trace_cache()
    assert tring.device_trace_enabled() is True


def test_driver_ring_lane_records_match_reference(gate):
    """The whole slice: ACCL allreduce, allgather and reduce_scatter on
    the ring lane (threshold 0) of TpuWorld(4) and CudaWorld(4, cpu),
    one segment each, with the gate on."""
    from accl_tpu.backends.tpu import TpuWorld
    from accl_tpu.constants import ReduceFunction as JReduce

    gate(True)
    n = 16

    def body(red):
        def fn(accl, rank):
            x = accl.create_buffer_like(
                np.arange(n * NR, dtype=np.float32) + rank)
            y = accl.create_buffer(n * NR, np.float32)
            accl.allreduce(x, y, n * NR, red)
            ar = y.host.copy()
            accl.allgather(x, y, n)
            ag = y.host.copy()
            accl.reduce_scatter(x, y, n, red)
            return ar, ag, y.host[:n].copy()

        return fn

    with TpuWorld(NR) as tw:
        tw.engine.ring_threshold_bytes = 0
        want = tw.run(body(JReduce.SUM))
    with CudaWorld(NR, device="cpu") as cw:
        cw.engine.ring_threshold_bytes = 0
        got = cw.run(body(ReduceFunction.SUM), timeout=120)
    for g, w_ in zip(got, want):
        for a, b in zip(g, w_):
            np.testing.assert_array_equal(a, b)
    jrec, trec = _records(jtrace.collector()), _records(obs_trace.collector())
    assert sum(jrec.values()) == 4 * NR
    assert trec == jrec


# ---------------------------------------------------------------------------
# the fused lane's host rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P,C,idx,nbytes,slot0", [
    (4, 4, 0, 256, 0), (4, 4, 3, 256, 12), (2, 1, 1, 40, 0),
    (8, 2, 5, 1 << 20, 14), (3, 1, 2, 12, 2)])
def test_fused_stamp_rows_match_reference(P, C, idx, nbytes, slot0):
    want = np.asarray(jfused._fused_stamp_rows(P, C, idx, nbytes, slot0))
    got = tfused._fused_stamp_rows(P, C, idx, nbytes, slot0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("wire", [None, (32, False)])
def test_fused_lane_records_match_reference(gate, wire):
    gate(True)
    x = np.stack([np.arange(64, dtype=np.float32) * 0.25 + r
                  for r in range(NR)])
    xs = [torch.from_numpy(x[r].copy()) for r in range(NR)]
    for name in ("all_reduce", "reduce_scatter", "all_gather"):
        jfn = getattr(jfused, f"chunked_ring_{name}")
        tfn = getattr(tfused, f"chunked_ring_{name}")
        if name == "all_gather":
            _jax_run(lambda xb: jfn(xb[0, :16], "dp", chunks=4,
                                    wire=wire)[None], x)
            tfn([t[:16].clone() for t in xs], chunks=4, wire=wire)
        else:
            _jax_run(lambda xb: jfn(xb[0], "dp", chunks=4, wire=wire)[None
                                                                       ], x)
            tfn(xs, chunks=4, wire=wire)
    jrec, trec = _records(jtrace.collector()), _records(obs_trace.collector())
    assert sum(jrec.values()) == 3 * NR
    assert trec == jrec


def test_fused_matmul_allreduce_records_match_reference(gate):
    gate(True)
    M, K, N = 20, 8, 6
    rng = np.random.default_rng(3)
    x = rng.standard_normal((NR, M * K)).astype(np.float32)
    w = rng.standard_normal((NR, K * N)).astype(np.float32)
    both = np.concatenate([x, w], axis=1)
    _jax_run(lambda xb: jfused.fused_matmul_allreduce(
        xb[0, :M * K].reshape(M, K), xb[0, M * K:].reshape(K, N), "dp",
        use_pallas=False, chunks=2).reshape(1, -1), both)
    tfused.fused_matmul_allreduce(
        [torch.from_numpy(x[r].reshape(M, K)) for r in range(NR)],
        [torch.from_numpy(w[r].reshape(K, N)) for r in range(NR)],
        use_pallas=False, chunks=2)
    jrec, trec = _records(jtrace.collector()), _records(obs_trace.collector())
    assert sum(jrec.values()) == NR
    assert trec == jrec


# ---------------------------------------------------------------------------
# the kernel's row-writing rule, emulated over the launch geometry
# ---------------------------------------------------------------------------
PART_WORDS = 12


def _emulate_stamps(parts, P, elem, resident):
    """Rows ring_kernel<T, KIND, true> writes: block (my, k) walks tiles
    k, k + S, ...; at step q >= 1 of a tile whose column offset j0 is 0
    it writes row (segment, my, q - 1).  Returns the rows and how many
    times each was written."""
    tw, ntiles, S = tring.tiling(parts, P, elem, resident)
    words = list(tring._geometry(parts, tw, ntiles, True, 16 // elem))
    part = [words[i * PART_WORDS:(i + 1) * PART_WORDS] for i in range(2)]
    nseg = sum(p.nseg for p in parts)
    rows = np.full((nseg, P, P - 1, tring.DEVICE_TRACE_COLS), -1, np.int64)
    writes = np.zeros((nseg, P, P - 1), np.int64)
    for k in range(S):
        U = (ntiles - 1 - k) // S + 1 if k < ntiles else 0
        for u in range(U):
            t = k + u * S
            second = t >= part[1][3]
            p = part[1] if second else part[0]
            _nseg, w, tps, first = p[:4]
            local = t - first
            i, j0 = local // tps, (local % tps) * tw
            seg = (part[0][0] if second else 0) + i
            for my in range(P):
                for q in range(1, P):
                    if j0 == 0:
                        st = q - 1
                        nb = w * elem
                        rows[seg, my, st] = (my, st, 3 * st, 3 * st + 1,
                                             3 * st + 2, (my + 1) % P,
                                             (my + P - 1) % P, nb, nb)
                        writes[seg, my, st] += 1
    return rows, writes


def _plain_rows(parts, P, elem):
    return np.concatenate([
        np.stack([tring.stamp_rows(P, p.w * elem).numpy()] * p.nseg)
        for p in parts])


@pytest.mark.parametrize("P", (2, 3, 4, 8))
@pytest.mark.parametrize("case", ("allreduce", "gather", "scatter"))
def test_kernel_stamp_rule_matches_plain_rows(P, case, monkeypatch):
    monkeypatch.setattr(tring, "SLOT_BYTES", 64)
    monkeypatch.setattr(tring, "SCRATCH_BYTES", 64 * 2 * P * 3)
    monkeypatch.setattr(tring, "THREADS", 4)
    for elem in (4, 8):
        for n, seg in ((40 * P + 5, 16 * P), (37, 8), (96 * P, 32 * P)):
            if case == "allreduce":
                parts = tring.allreduce_parts(n, P, seg)
            else:
                parts = tring.segment_parts(
                    n, seg, n, "ag" if case == "gather" else "rs")
            rows, writes = _emulate_stamps(parts, P, elem, 3 * P)
            assert (writes == 1).all(), (n, seg, writes)
            np.testing.assert_array_equal(rows, _plain_rows(parts, P, elem))


def test_segment_parts_follow_the_reference_segments():
    whole, tail = tring.segment_parts(80, 32, 80, "ag")
    assert (whole.nseg, whole.w, whole.x_seg, whole.x_chunk, whole.o_seg,
            whole.o_chunk) == (2, 32, 32, 0, 32, 80)
    assert (tail.nseg, tail.w, tail.x_off, tail.o_off) == (1, 16, 64, 64)
    (one,) = tring.segment_parts(64, 64, 64, "rs")
    assert one == tring.Part(1, 64, 0, 64, 64, 0, 64, 0)


def test_stamp_rows_are_the_reference_stamp_row():
    rows = tring.stamp_rows(4, 128).numpy()
    assert rows.shape == (4, 3, len(jtrace.DEVICE_TRACE_FIELDS))
    assert rows.dtype == np.int32
    assert tring.DEVICE_TRACE_COLS == jring.DEVICE_TRACE_COLS
    for r in range(4):
        for s in range(3):
            assert list(rows[r, s]) == [r, s, 3 * s, 3 * s + 1, 3 * s + 2,
                                        (r + 1) % 4, (r + 3) % 4, 128, 128]
