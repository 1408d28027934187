"""The ring kernels' self-ring mode (``ring_size``) of the port
(accl_tpu_torch/ops/ring.py) against the JAX package's Pallas ring
kernels with ``ring_size=V`` (accl_tpu/ops/ring.py:151-175, 274-294,
398-424) on a one-device mesh.

The JAX kernels run as tests/test_pallas_ops.py:226-290 runs them on the
CPU: ``shard_map`` over a one-device mesh, Pallas in interpret mode.  The
port runs its plain versions, which its wrappers take for CPU tensors,
and ``_emulate`` walks the launch geometry of ``ring_kernel`` in its
self-ring form (one rank, V hops a tile) as csrc/ring.cu does.  Inputs
are the same numpy arrays, made from a seed, at the shapes of
tests/test_pallas_ops.py:243-268.

Tolerance: bitwise everywhere.  The reduce-scatter folds x[0] + (x[1] +
(... + x[V - 1])), the Pallas body's order with my = 0, so fp32 SUM is
bit-equal; ``x.sum(0)`` is not at V = 4 and 8 (checked below, so the
order is what the test holds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

from accl_tpu.observability import trace as jtrace
from accl_tpu.ops import ring as jring
from accl_tpu_torch.observability import trace as obs_trace
from accl_tpu_torch.ops import ring as tring

ROWS, COLS = 8, 128
VS = (2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _smap1(f):
    mesh = Mesh(np.array(jax.devices()[:1]), ("r",))
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=Pspec(),
                                 out_specs=Pspec(), check_vma=False))


def _jax_ag(d, V):
    return np.asarray(_smap1(lambda v: jring.ring_all_gather_pallas(
        v, "r", ring_size=V, interpret=True))(jnp.asarray(d)))


def _jax_rs(d, V, op="sum"):
    return np.asarray(_smap1(lambda v: jring.ring_reduce_scatter_pallas(
        v, "r", op=op, ring_size=V, interpret=True))(jnp.asarray(d)))


def _jax_ar(d, V):
    return np.asarray(_smap1(lambda v: jring.ring_all_reduce_pallas(
        v, "r", ring_size=V, interpret=True))(jnp.asarray(d)))


# ---------------------------------------------------------------------------
# the three calls, bitwise against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V", VS)
def test_selfring_all_gather_matches_pallas(V):
    d = _rand((ROWS, COLS), 20 + V)
    (got,) = tring.ring_all_gather([torch.from_numpy(d.reshape(-1))],
                                   ring_size=V)
    want = _jax_ag(d, V)
    assert tuple(got.shape) == (V, ROWS * COLS)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    np.testing.assert_array_equal(want, np.broadcast_to(d, (V, ROWS, COLS)))


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("V", VS)
def test_selfring_reduce_scatter_matches_pallas(V, op):
    d = _rand((V, ROWS, COLS), 21 + V)
    (got,) = tring.ring_reduce_scatter(
        [torch.from_numpy(d.reshape(V, -1))], op, ring_size=V)
    want = _jax_rs(d, V, op)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # the closed form, in the fold's order
    acc = d[V - 1]
    for s in range(V - 1):
        acc = (np.maximum if op == "max" else np.add)(d[(-2 - s) % V], acc)
    np.testing.assert_array_equal(want, acc)


def test_selfring_fold_order_is_not_the_plain_sum():
    # at V = 4 and 8 another order gives other bits, so the bitwise checks
    # above hold the order, not only the sum
    for V in (4, 8):
        d = _rand((V, ROWS, COLS), 21 + V)
        want = _jax_rs(d, V)
        assert not np.array_equal(want, d.sum(axis=0))


@pytest.mark.parametrize("V", VS)
def test_selfring_all_reduce_matches_pallas(V):
    d = _rand((V * ROWS, COLS), 22 + V)
    (got,) = tring.ring_all_reduce([torch.from_numpy(d.reshape(-1))],
                                   ring_size=V)
    want = _jax_ar(d, V)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # the plain composition that chip_smoke.py holds the card against
    (plain,) = tring.ring_all_reduce([torch.from_numpy(d.reshape(-1))],
                                     plain=True, ring_size=V)
    np.testing.assert_array_equal(plain.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.int64])
def test_selfring_other_dtypes_match_the_closed_forms(dtype):
    V = 4
    d = (_rand((V, 96), 40) * 1000).astype(dtype)
    (rs,) = tring.ring_reduce_scatter([torch.from_numpy(d)], ring_size=V)
    np.testing.assert_array_equal(rs.numpy(), d[0] + (d[1] + (d[2] + d[3])))
    (ag,) = tring.ring_all_gather([torch.from_numpy(d[0].copy())],
                                  ring_size=V)
    np.testing.assert_array_equal(ag.numpy(), np.broadcast_to(d[0], (V, 96)))


def test_ring_size_one_returns_the_operand():
    x = torch.from_numpy(_rand((2, 16), 50))
    (ag,) = tring.ring_all_gather([x[0].clone()], ring_size=1)
    assert torch.equal(ag, x[0][None])
    (rs,) = tring.ring_reduce_scatter([x[:1]], ring_size=1)
    assert torch.equal(rs, x[0])
    (ar,) = tring.ring_all_reduce([x.reshape(-1)], ring_size=1)
    assert torch.equal(ar, x.reshape(-1))


def test_ring_size_needs_a_one_member_list():
    xs = [torch.zeros(16), torch.zeros(16)]
    with pytest.raises(ValueError, match="ring_size") as te:
        tring.ring_all_gather(xs, ring_size=4)
    with pytest.raises(ValueError, match="ring_size"):
        tring.ring_reduce_scatter([torch.zeros(4, 4)] * 2, ring_size=4)
    with pytest.raises(ValueError, match="ring_size"):
        tring.ring_all_reduce(xs, ring_size=4)
    with pytest.raises(ValueError, match="ring_size"):
        tring.ring_all_gather_plain(xs, ring_size=4)
    with pytest.raises(ValueError, match="ring_size"):
        tring.ring_reduce_scatter_plain([torch.zeros(4, 4)] * 2,
                                        ring_size=4)
    with pytest.raises(ValueError, match="ring_size"):
        tring.ring_all_gather([torch.zeros(16)], ring_size=0)
    # ring_size equal to the list's length is the plain ring, as in JAX
    got = tring.ring_all_gather(xs, ring_size=2)
    assert [tuple(g.shape) for g in got] == [(2, 16)] * 2
    # the JAX package raises with the same words
    if len(jax.devices()) < 2:
        pytest.skip("needs a 2-device mesh for the JAX side")
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    f = jax.shard_map(lambda xb: jring.ring_all_gather_pallas(
        xb[0], "dp", ring_size=4, interpret=True)[None], mesh=mesh,
        in_specs=Pspec("dp"), out_specs=Pspec("dp"), check_vma=False)
    with pytest.raises(ValueError, match="ring_size") as je:
        jax.jit(f)(jnp.zeros((2, 16)))
    assert str(te.value) == str(je.value)


def test_selfring_shapes_are_checked():
    with pytest.raises(ValueError, match=r"\[V=4, n\]"):
        tring.ring_reduce_scatter([torch.zeros(3, 8)], ring_size=4)
    with pytest.raises(ValueError, match=r"\[4, 8\]"):
        tring.ring_all_gather([torch.zeros(8)], out=[torch.zeros(3, 8)],
                              ring_size=4)


# ---------------------------------------------------------------------------
# device-trace rows, held to the JAX package's
# ---------------------------------------------------------------------------
@pytest.fixture
def gate(monkeypatch):
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    for mod in (jring, tring):
        mod._reset_device_trace_cache()
    jtrace.collector().clear()
    obs_trace.collector().clear()
    yield
    monkeypatch.delenv("ACCL_DEVICE_TRACE")
    for mod in (jring, tring):
        mod._reset_device_trace_cache()
    jtrace.collector().clear()
    obs_trace.collector().clear()


def _records(col):
    return [(r["collective"], np.asarray(r["rows"]).tolist())
            for r in col.device_records()]


@pytest.mark.parametrize("V", (2, 4))
@pytest.mark.parametrize("call", ["ag", "rs", "ar"])
def test_selfring_stamp_rows_match_pallas(gate, V, call):
    if call == "ag":
        d = _rand((ROWS, COLS), 60)
        _jax_ag(d, V)
        tring.ring_all_gather([torch.from_numpy(d.reshape(-1))], ring_size=V)
    elif call == "rs":
        d = _rand((V, ROWS, COLS), 61)
        _jax_rs(d, V)
        tring.ring_reduce_scatter([torch.from_numpy(d.reshape(V, -1))],
                                  ring_size=V)
    else:
        d = _rand((V * ROWS, COLS), 62)
        _jax_ar(d, V)
        tring.ring_all_reduce([torch.from_numpy(d.reshape(-1))], ring_size=V)
    jax.effects_barrier()
    want, got = _records(jtrace.collector()), _records(obs_trace.collector())
    assert len(want) == (2 if call == "ar" else 1)
    assert got == want
    for _name, rows in got:
        rows = np.asarray(rows)
        assert rows.shape == (V - 1, tring.DEVICE_TRACE_COLS)
        assert (rows[:, [0, 5, 6]] == 0).all()


# ---------------------------------------------------------------------------
# the kernel's self-ring walk, emulated from the launch geometry
# ---------------------------------------------------------------------------
PART_WORDS = 12


def _emulate(kind, xs, outs, parts, op, resident, V):
    """One launch of ring_kernel with P = len(xs) ranks and a ring of V
    hops a tile, run in Python from the words the wrapper passes: block
    (my, k) walks tiles k, k + S, ...; per tile, hop 0 and steps q = 1 ..
    V - 1 through double-buffered slots, every rank in step; neighbours
    mod P, chunk indices mod V.  Returns (stamp rows, tiles, stripes)."""
    P, elem = len(xs), xs[0].element_size()
    tw, ntiles, S = tring.tiling(parts, P, elem, resident)
    words = list(tring._geometry(parts, tw, ntiles, True, 16 // elem))
    part = [words[i * PART_WORDS:(i + 1) * PART_WORDS] for i in range(2)]
    fold = tring._fold(op)
    flat_x = [x.reshape(-1) for x in xs]
    flat_o = [o.view(-1) for o in outs]
    slots = torch.zeros(P, S, 2, tw, dtype=xs[0].dtype)
    nseg = sum(p.nseg for p in parts)
    stamps = np.full((nseg, P, V - 1, tring.DEVICE_TRACE_COLS), -1)
    for k in range(S):
        U = (ntiles - 1 - k) // S + 1 if k < ntiles else 0
        for u in range(U):
            t = k + u * S
            second = t >= part[1][3]
            p = part[1] if second else part[0]
            _n, w, tps, first, xo, xsg, xch, oo, osg, och, lim, _v = p
            local = t - first
            i, j0 = local // tps, (local % tps) * tw
            width = min(w - j0, tw)

            def cnt(c):
                return max(0, min(lim - c * w - j0, width))

            def X(r, c, m):
                a = xo + i * xsg + c * xch + j0
                return flat_x[r][a:a + m]

            def O(r, c, m):
                a = oo + i * osg + c * och + j0
                return flat_o[r][a:a + m]

            h0 = u * (V - 1)
            for my in range(P):
                c = my if kind == "ag" else (my - 1) % V
                m = cnt(c)
                v = X(my, c, m).clone()
                if kind == "ag":
                    O(my, my, m).copy_(v)
                slots[(my + 1) % P, k, h0 % 2, :m] = v
            for q in range(1, V):
                h = h0 + q - 1
                vals = []
                for my in range(P):
                    c = (my - q) % V if kind == "ag" else (my - 1 - q) % V
                    m = cnt(c)
                    land = slots[my, k, h % 2, :m].clone()
                    v = land if kind == "ag" else fold(X(my, c, m), land)
                    vals.append((my, c, m, v))
                for my, c, m, v in vals:
                    if kind == "ag":
                        O(my, c, m).copy_(v)
                    elif q == V - 1:
                        O(my, my, m).copy_(v)
                    if q < V - 1:
                        slots[(my + 1) % P, k, (h + 1) % 2, :m] = v
                    if j0 == 0:
                        seg = (part[0][0] if second else 0) + i
                        st, nb = q - 1, w * elem
                        stamps[seg, my, st] = (my, st, 3 * st, 3 * st + 1,
                                               3 * st + 2, (my + 1) % P,
                                               (my + P - 1) % P, nb, nb)
    return stamps, ntiles, S


@pytest.mark.parametrize("V", (2, 3, 4, 8))
@pytest.mark.parametrize("n", (5, 37, 256, 1000))
def test_kernel_selfring_walk_matches_plain(V, n, monkeypatch):
    # small slots and few resident blocks, so a launch walks many tiles
    # per stripe and the slot parity crosses tile boundaries
    monkeypatch.setattr(tring, "SLOT_BYTES", 64)
    monkeypatch.setattr(tring, "SCRATCH_BYTES", 64 * 2 * 3)
    monkeypatch.setattr(tring, "THREADS", 4)
    x = torch.from_numpy(_rand((V, n), 70 + n))
    for op in ("sum", "max"):
        out = [torch.full((n,), np.nan, dtype=torch.float32)]
        rows, ntiles, S = _emulate(
            "rs", [x], out, [tring.Part(1, n, 0, 0, n, 0, 0, 0)], op, 3, V)
        (want,) = tring.ring_reduce_scatter_plain([x], op, ring_size=V)
        assert torch.equal(out[0], want), (op, ntiles, S)
        np.testing.assert_array_equal(
            rows[0], tring.stamp_rows(1, n * 4, V).numpy())
    out = [torch.full((V, n), np.nan, dtype=torch.float32)]
    rows, _t, _s = _emulate("ag", [x[0].contiguous()], out,
                            [tring.Part(1, n, 0, 0, 0, 0, 0, n)], "sum", 3, V)
    assert torch.equal(out[0], x[0].expand(V, n))
    np.testing.assert_array_equal(rows[0],
                                  tring.stamp_rows(1, n * 4, V).numpy())


@pytest.mark.parametrize("P", (2, 4))
def test_kernel_walk_at_p_ranks_is_the_ring(P, monkeypatch):
    # V = P: the generalized walk is the ring kernel's, against the plain
    # ring, so the self-ring mode left the multi-rank launch as it was
    monkeypatch.setattr(tring, "SLOT_BYTES", 64)
    monkeypatch.setattr(tring, "SCRATCH_BYTES", 64 * 2 * P * 3)
    monkeypatch.setattr(tring, "THREADS", 4)
    n = 41
    xs = [torch.from_numpy(_rand((P, n), 80 + r)) for r in range(P)]
    out = [torch.empty(n) for _ in range(P)]
    rows, _t, _s = _emulate("rs", xs, out,
                            [tring.Part(1, n, 0, 0, n, 0, 0, 0)], "sum",
                            3 * P, P)
    for o, w in zip(out, tring.ring_reduce_scatter_plain(xs)):
        assert torch.equal(o, w)
    np.testing.assert_array_equal(rows[0], tring.stamp_rows(P, n * 4).numpy())


def test_selfring_tiling_uses_one_rank():
    # the bench shape: one rank's stripes fill every resident block
    parts = [tring.Part(1, 4096 * 128, 0, 0, 4096 * 128, 0, 0, 0)]
    tw, ntiles, S = tring.tiling(parts, 1, 4, 264)
    assert S == min(264, ntiles)
    assert tw * ntiles >= 4096 * 128


# ---------------------------------------------------------------------------
# the bench entry (twin of bench.py's _selfring_stage)
# ---------------------------------------------------------------------------
def _fake_events_ms(monkeypatch, selfring, ms: float = 0.5):
    """The stage times with CUDA events only: here a stand-in that runs
    each call once and reports ``ms``."""
    calls = []

    def timed(fn, iters):
        fn()
        calls.append(iters)
        return ms

    monkeypatch.setattr(selfring, "events_ms", timed)
    return calls


def test_selfring_bench_stage_checks_then_reports(monkeypatch):
    from accl_tpu_torch.bench import selfring

    calls = _fake_events_ms(monkeypatch, selfring)
    res = selfring.selfring_stage(device="cpu", rows=4, cols=16, iters=2)
    assert calls == [2, 2]
    assert res["ring_compiled_selfring_ok"] is True
    assert res["ag_ms"] == res["ar_ms"] == 0.5
    assert res["chunk_bytes"] == 4 * 16 * 4
    # the byte counts are the reference's: (V - 1) and 2 (V - 1) chunks
    assert res["ring_selfring_ag_gbps"] == pytest.approx(
        7 * res["chunk_bytes"] / res["ag_ms"] / 1e6)
    assert res["ring_selfring_ar_gbps"] == pytest.approx(
        14 * res["chunk_bytes"] / res["ar_ms"] / 1e6)


def test_selfring_bench_stage_raises_on_a_wrong_fold(monkeypatch):
    from accl_tpu_torch.bench import selfring

    def summed(xs, op="sum", out=None, ring_size=None):
        return [xs[0].sum(0)]

    monkeypatch.setattr(tring, "ring_reduce_scatter", summed)
    calls = _fake_events_ms(monkeypatch, selfring)
    with pytest.raises(RuntimeError, match="fold"):
        selfring.selfring_stage(device="cpu", rows=4, cols=16, iters=1)
    assert calls == []  # nothing timed before the checks pass


def test_fold_closed_form_matches_pallas():
    V = 8
    d = _rand((V, ROWS, COLS), 29)
    from accl_tpu_torch.bench.selfring import fold_closed_form

    got = fold_closed_form(torch.from_numpy(d.reshape(V, -1)))
    np.testing.assert_array_equal(got.numpy().reshape(ROWS, COLS),
                                  _jax_rs(d, V))
