"""The port's segment-walking ring (one launch per phase over every
segment of a call, accl_tpu_torch/ops/ring.py and csrc/ring.cu) on the
CPU.

- The segmented drivers on CPU tensors (the plain segment-by-segment
  composition) against the JAX package's ``ring_*_segmented`` with the
  Pallas kernels in interpret mode, as tests/test_torch_ring.py runs
  them, bitwise; and the rule for results that alias operands.
- The launch geometry emulated the way csrc/ring.cu decodes it (tiles,
  stripes, slots and hops), against the plain composition, bitwise: the
  geometry must put each element in the reference's chunk, so that it
  folds in the same order.
- A discrete-event replay of the multi-tile schedule under adversarial
  delivery (tests/test_ring_flowcontrol.py's ``_run_schedule``): no slot
  overrun, no deadlock, a balanced ACK ledger, for P = 2..8 and 1-5
  tiles; off-by-one mutations of the window predicates must be caught;
  and the predicates compiled into csrc/ring_sync.cuh must be the ones
  replayed.
- The driver's ring lane writing straight into the result buffers
  (in place, and into a sub-range), bitwise against ``TpuWorld``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import test_ring_flowcontrol as flowcontrol
from accl_tpu import ReduceFunction as JReduce
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.ops import ring as jring
from accl_tpu_torch import CudaWorld, ReduceFunction, load_world_state
from accl_tpu_torch.backends.cuda import CudaEngine
from accl_tpu_torch.ops import ring as tring

RING_SYNC = (Path(tring.__file__).resolve().parent / "csrc"
             / "ring_sync.cuh")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_per_rank(fn, d):
    P = d.shape[0]
    devs = jax.devices()[:P]
    if len(devs) < P:
        pytest.skip(f"needs a {P}-device mesh")
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None],
                              mesh=Mesh(np.array(devs), ("r",)),
                              in_specs=Pspec("r"), out_specs=Pspec("r"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(d)))


def _data(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 100
    return x.astype(dtype)


def _ranks(d):
    return [torch.from_numpy(np.ascontiguousarray(d[r]))
            for r in range(d.shape[0])]


# ---------------------------------------------------------------------------
# the segmented drivers against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", (3, 4))
@pytest.mark.parametrize("op", ("sum", "max"))
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
@pytest.mark.parametrize("N,seg", [(24, 8), (22, 8)])
def test_allreduce_segmented_bitwise_vs_pallas(P, op, dtype, N, seg):
    # N = 24 is whole segments at P = 3 and 4 with seg 8; 22 ends ragged
    # (padded in the reference and here)
    d = _data((P, N), dtype, seed=31 + P + N)
    want = _jax_per_rank(
        lambda v: jring.ring_all_reduce_segmented(v, "r", op=op,
                                                  seg_elems=seg,
                                                  interpret=True), d)
    got = tring.ring_all_reduce_segmented(_ranks(d), op, seg_elems=seg)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("P", (3, 4))
@pytest.mark.parametrize("op", ("sum", "max"))
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
def test_reduce_scatter_segmented_bitwise_vs_pallas(P, op, dtype):
    n = 21  # segments 8, 8 and a ragged 5
    d = _data((P, P * n), dtype, seed=41 + P)
    want = _jax_per_rank(
        lambda v: jring.ring_reduce_scatter_segmented(
            v, "r", op=op, seg_elems=8, interpret=True), d)
    got = tring.ring_reduce_scatter_segmented(_ranks(d), op, seg_elems=8)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("P", (3, 4))
@pytest.mark.parametrize("dtype", (np.float32, np.int32))
def test_all_gather_segmented_bitwise_vs_pallas(P, dtype):
    n = 19
    d = _data((P, n), dtype, seed=51 + P)
    want = _jax_per_rank(
        lambda v: jring.ring_all_gather_segmented(v, "r", seg_elems=8,
                                                  interpret=True), d)
    got = tring.ring_all_gather_segmented(_ranks(d), seg_elems=8)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("P", (2, 3, 5, 8))
@pytest.mark.parametrize("op", ("sum", "max"))
def test_in_place_allreduce_equals_out_of_place(P, op):
    # each result its own operand, against fresh results
    for N, seg in ((7 * P + 3, 2 * P), (P - 1, 8), (64 * P, 16 * P)):
        xs = [torch.from_numpy(_data(N, np.float32, 60 + r))
              for r in range(P)]
        want = tring.ring_all_reduce_segmented(xs, op, seg)
        same = [x.clone() for x in xs]
        got = tring.ring_all_reduce_segmented(same, op, seg, out=same)
        for r in range(P):
            assert got[r] is same[r] and torch.equal(same[r], want[r])


@pytest.mark.parametrize("P", (2, 4))
def test_results_that_alias_operands_are_refused(P):
    # a launch reads every rank's operand while it writes every rank's
    # result: only an allreduce's exact in-place result is safe
    n = 8 * P
    base = torch.zeros(P, 3 * P * n)
    xs = [base[r, :n] for r in range(P)]
    assert tring.alias_fault(xs, xs, in_place=True) is None
    assert "operand" in tring.alias_fault(xs, xs)
    shifted = [base[r, 1:n + 1] for r in range(P)]
    assert "rank 0's operand" in tring.alias_fault(xs, shifted, True)
    other = xs[1:] + xs[:1]  # each result another rank's operand
    assert "operand" in tring.alias_fault(xs, other, True)
    twice = [base[0, n:2 * n]] * P  # two ranks' results in one place
    assert "rank 0's result" in tring.alias_fault(xs, twice, True)
    apart = [base[r, n:2 * n] for r in range(P)]
    assert tring.alias_fault(xs, apart) is None
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_all_reduce_segmented(xs, "sum", out=shifted)
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_all_gather_segmented(
            xs, out=[base[r, n - 1:n - 1 + P * n] for r in range(P)])
    with pytest.raises(ValueError, match="overlaps"):
        tring.ring_reduce_scatter_segmented(
            [base[r, :P * n] for r in range(P)], "sum",
            out=[base[r, :n] for r in range(P)])


def test_allreduce_parts_follow_the_reference_segments():
    # 302 over 4 ranks at seg 128: 128, 128, then 46 padded to 48
    whole, ragged = tring.allreduce_parts(302, 4, 128)
    assert (whole.nseg, whole.w, whole.x_seg, whole.x_chunk) == (2, 32, 128,
                                                                 32)
    assert (ragged.nseg, ragged.w, ragged.x_off, ragged.lim) == (1, 12, 256,
                                                                 46)
    assert tring.allreduce_parts(3, 4, 128) == [
        tring.Part(1, 1, 0, 0, 1, 0, 0, 1, 3)]
    assert len(tring.allreduce_parts(1 << 20, 8)) == 1


# ---------------------------------------------------------------------------
# the launch geometry, decoded as csrc/ring.cu decodes it
# ---------------------------------------------------------------------------
PART_WORDS = 12


def _emulate(kind, xs, outs, parts, op, resident):
    """One launch of ring_kernel, run in Python from the words the
    wrapper passes: block (my, k) walks tiles k, k + S, ...; per tile,
    hop 0 and steps q = 1 .. P-1 through double-buffered slots, every
    rank in step.  Returns (tiles, stripes)."""
    P, elem = len(xs), xs[0].element_size()
    tw, ntiles, S = tring.tiling(parts, P, elem, resident)
    words = list(tring._geometry(parts, tw, ntiles, True, 16 // elem))
    assert words[2 * PART_WORDS:] == [tw, ntiles]  # GEOMETRY_WORDS = 26
    part = [words[i * PART_WORDS:(i + 1) * PART_WORDS] for i in range(2)]
    fold = tring._fold(op)
    flat_x = [x.view(-1) for x in xs]
    flat_o = [o.view(-1) for o in outs]
    slots = torch.zeros(P, S, 2, tw, dtype=xs[0].dtype)
    for k in range(S):
        U = (ntiles - 1 - k) // S + 1 if k < ntiles else 0
        for u in range(U):
            t = k + u * S
            p = part[1] if t >= part[1][3] else part[0]
            nseg, w, tps, first, xo, xsg, xch, oo, osg, och, lim, _v = p
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

            h0 = u * (P - 1)
            for my in range(P):
                c = my if kind == "ag" else (my - 1) % P
                m = cnt(c)
                v = X(my, c, m).clone()
                if kind == "ag":
                    O(my, my, m).copy_(v)
                slots[(my + 1) % P, k, h0 % 2, :m] = v
            for q in range(1, P):
                h = h0 + q - 1
                vals = []
                for my in range(P):
                    c = (my - q) % P if kind == "ag" else (my - 1 - q) % P
                    m = cnt(c)
                    land = slots[my, k, h % 2, :m].clone()
                    v = land if kind == "ag" else fold(X(my, c, m), land)
                    vals.append((my, c, m, v))
                for my, c, m, v in vals:
                    if kind == "ag":
                        O(my, c, m).copy_(v)
                    elif q == P - 1:
                        O(my, my, m).copy_(v)
                    if q < P - 1:
                        slots[(my + 1) % P, k, (h + 1) % 2, :m] = v
    return ntiles, S


@pytest.mark.parametrize("P", (2, 3, 4, 8))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64, torch.int32,
                                   torch.float16))
@pytest.mark.parametrize("resident", (None, 1))
def test_kernel_geometry_emulation_matches_plain(P, dtype, resident,
                                                monkeypatch):
    # small slots and scratch so that a few hundred columns make several
    # tiles per segment and several tiles per stripe
    monkeypatch.setattr(tring, "SLOT_BYTES", 64)
    monkeypatch.setattr(tring, "SCRATCH_BYTES", 64 * 2 * P * 3)
    monkeypatch.setattr(tring, "THREADS", 4)
    res = 3 * P if resident is None else resident * P
    g = torch.Generator().manual_seed(P)
    for N, seg in ((40 * P + 5, 16 * P), (37, 8), (96 * P, 32 * P)):
        xs = [(torch.randn(N, generator=g) * 100).to(dtype) for _ in range(P)]
        parts = tring.allreduce_parts(N, P, seg)
        want = tring.ring_all_reduce_segmented(xs, "sum", seg, plain=True)
        outs = [torch.full_like(x, 7) for x in xs]
        _emulate("rs", xs, outs, parts, "sum", res)
        _emulate("ag", outs, outs, parts, "sum", res)
        for r in range(P):
            assert torch.equal(outs[r], want[r]), (N, seg, r)
        # the one-segment forms: strided rows, a row-strided result
        n = 3 * N // P + 1
        flat = [torch.randn((P * (n + 3),), generator=g).to(dtype)
                for _ in range(P)]
        xs2 = [f.view(P, n + 3)[:, :n] for f in flat]
        part = tring.Part(1, n, 0, 0, n + 3, 0, 0, 0)
        outs2 = [torch.zeros(n, dtype=dtype) for _ in range(P)]
        _emulate("rs", flat, outs2, [part], "max", res)
        for r, o in enumerate(tring.ring_reduce_scatter_plain(xs2, "max")):
            assert torch.equal(outs2[r], o)
        gathered = [torch.zeros(P, n + 5, dtype=dtype) for _ in range(P)]
        _emulate("ag", [o.clone() for o in outs2],
                 [gv.view(-1) for gv in gathered],
                 [tring.Part(1, n, 0, 0, 0, 0, 0, n + 5)], "sum", res)
        for r, o in enumerate(tring.ring_all_gather_plain(outs2)):
            assert torch.equal(gathered[r][:, :n], o)


def test_tiling_spreads_columns_and_keeps_slots_small():
    resident = 132 * 3  # blocks of 256 threads co-resident on 132 SMs
    fit = resident // 8
    # the driver's 256 MiB allreduce over 8 ranks, 4-byte elements: full
    # slots, as many stripes as fit and the scratch allows
    parts = tring.allreduce_parts(64 << 20, 8)
    tw, ntiles, S = tring.tiling(parts, 8, 4, resident)
    assert tw == tring.SLOT_BYTES // 4 and ntiles == 256 * (32768 // tw)
    assert S == min(fit, tring.SCRATCH_BYTES // (8 * 2 * tw * 4))
    # one 1 MiB segment: the columns spread over every stripe that fits,
    # in whole 16-byte vectors per thread
    tw, ntiles, S = tring.tiling(tring.allreduce_parts(1 << 18, 8), 8, 4,
                                 resident)
    assert S == ntiles == -(-32768 // tw) and S <= fit
    assert tw % (tring.THREADS * 4) == 0 and (S == fit or tw == 1024)
    # a ragged one-element-per-chunk tail: one vector-width tile
    assert tring.tiling(tring.allreduce_parts(5, 8), 8, 4, resident)[:2] \
        == (4, 1)
    with pytest.raises(RuntimeError, match="co-resident"):
        tring.tiling(parts, 8, 4, resident=7)


# ---------------------------------------------------------------------------
# flow control over the long schedule
# ---------------------------------------------------------------------------
def _tile_program(U):
    """One rank's schedule in ring_kernel over U tiles, read from the
    port's window predicates: hop 0 of each tile sends; step q waits
    for the landing of hop h, reads it once (fold, or place and forward)
    and sends hop h + 1 into the other slot."""
    def program(i, P):
        H = U * (P - 1)
        ops = []
        for u in range(U):
            h0 = u * (P - 1)
            if tring.tile_waits_ack(h0, H):
                ops.append(("wait_ack", {"slot": h0 % 2}))
            ops.append(("send", {"slot": h0 % 2, "step": h0,
                                 "lands_reads": 1}))
            for q in range(1, P):
                h = h0 + q - 1
                fwd = q < P - 1
                ops.append(("recv", {"slot": h % 2, "step": h}))
                if fwd and tring.tile_waits_ack(h + 1, H):
                    ops.append(("wait_ack", {"slot": (h + 1) % 2}))
                ops.append(("read", {"slot": h % 2}))
                if fwd:
                    ops.append(("send", {"slot": (h + 1) % 2, "step": h + 1,
                                         "lands_reads": 1}))
                if tring.tile_signals_ack(h, H):
                    ops.append(("signal_ack", {"slot": h % 2}))
        return ops
    return program


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("U", range(1, 6))
def test_multi_tile_schedule_replay(P, U):
    violations = flowcontrol._run_schedule(P, _tile_program(U), n_slots=2)
    assert not violations, "\n".join(violations[:5])


@pytest.mark.parametrize("mutation", ("wait_late", "signal_extra",
                                      "signal_short"))
@pytest.mark.parametrize("P,U", [(2, 3), (3, 2), (4, 1), (8, 1), (8, 3)])
def test_multi_tile_boundary_mutations_are_caught(P, U, mutation,
                                                  monkeypatch):
    if mutation == "wait_late":
        # the first wait one hop late: hop 2 may overrun hop 0's landing
        monkeypatch.setattr(tring, "tile_waits_ack", lambda h, H: h >= 3)
    elif mutation == "signal_extra":
        # one signal past the last reuse: the ledger leaks a count
        monkeypatch.setattr(tring, "tile_signals_ack",
                            lambda h, H: h <= H - 2)
    else:
        # the last signal dropped: the sender of hop H - 1 waits forever
        monkeypatch.setattr(tring, "tile_signals_ack",
                            lambda h, H: h <= H - 4)
    violations = flowcontrol._run_schedule(P, _tile_program(U), n_slots=2)
    assert violations, f"{mutation} went undetected at P={P}, U={U}"


def _cuda_predicate(name):
    src = RING_SYNC.read_text()
    m = re.search(rf"bool {name}\(int64_t hop, int64_t H\) \{{ return "
                  r"([^;]+); \}", src)
    assert m, f"{name} not found in {RING_SYNC.name}"
    expr = m.group(1).replace("&&", " and ").replace("||", " or ")
    return lambda hop, H: eval(expr, {}, {"hop": hop, "H": H})


@pytest.mark.parametrize("name", ("tile_waits_ack", "tile_signals_ack"))
def test_compiled_predicates_are_the_replayed_ones(name):
    cuda = _cuda_predicate(name)
    for H in range(1, 40):
        for hop in range(H):
            assert cuda(hop, H) == getattr(tring, name)(hop, H)
            assert getattr(tring, name)(hop, H) == getattr(
                jring, name.replace("tile", "rs"))(hop, H + 1)


# ---------------------------------------------------------------------------
# the driver's ring lane writing into the result buffers
# ---------------------------------------------------------------------------
NR = 4


@pytest.fixture(scope="module")
def worlds():
    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as cw:
        yield tw, cw


def _run_both(worlds, inputs, fn):
    tw, cw = worlds
    tbufs = {r: [tw.accls[r].create_buffer_like(a) for a in arrs]
             for r, arrs in inputs.items()}
    for bufs in tbufs.values():
        for b in bufs:
            b.sync_to_device()
            b.sync_from_device()
    state = {"buffers": {r: [b.host.copy() for b in bufs]
                         for r, bufs in tbufs.items()},
             "ring_threshold_bytes": 0}
    loaded = load_world_state(cw, state)
    saved = tw.engine.ring_threshold_bytes
    tw.engine.ring_threshold_bytes = 0
    try:
        got_j = tw.run(lambda a, r: fn(a, r, tbufs[r], JReduce))
        got_t = cw.run(lambda a, r: fn(a, r, loaded["buffers"][r],
                                       ReduceFunction))
    finally:
        tw.engine.ring_threshold_bytes = saved
        for a in cw.accls:
            a.set_tuning(6, 4 << 20)
    return got_j, got_t


@pytest.fixture
def direct(monkeypatch):
    """Counts the collectives whose results the ring drivers wrote
    straight into the result buffers."""
    taken = []
    real = CudaEngine._direct_outs

    def spy(plan, xs):
        outs = real(plan, xs)
        taken.append(outs is not None)
        return outs

    monkeypatch.setattr(CudaEngine, "_direct_outs", staticmethod(spy))
    return taken


@pytest.mark.parametrize("func", ("SUM", "MAX"))
def test_in_place_allreduce_bitwise_vs_tpu_world(worlds, direct, func):
    n = 101 * NR + 2
    inputs = {r: [np.random.default_rng(70 + r).standard_normal(n)
                  .astype(np.float32)] for r in range(NR)}

    def fn(accl, rank, bufs, Red):
        x = bufs[0]
        accl.allreduce(x, x, n, function=Red[func])
        return [x.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    for rj, rt in zip(got_j, got_t):
        np.testing.assert_array_equal(rt[0], rj[0])
    assert direct and all(direct)


def test_sub_range_results_bitwise_vs_tpu_world(worlds, direct):
    n = 37 * NR
    pad = 5
    inputs = {r: [np.random.default_rng(80 + r).standard_normal(n)
                  .astype(np.float32)] for r in range(NR)}

    def fn(accl, rank, bufs, Red):
        x = bufs[0]
        ar = accl.create_buffer(n + 2 * pad, np.float32)
        accl.allreduce(x, ar.slice(pad, pad + n), n, function=Red.SUM)
        rs = accl.create_buffer(n // NR + 2 * pad, np.float32)
        accl.reduce_scatter(x, rs.slice(pad, pad + n // NR), n // NR,
                            function=Red.SUM)
        ag = accl.create_buffer(n * NR + 2 * pad, np.float32)
        accl.allgather(x, ag.slice(pad, pad + n * NR), n)
        return [ar.host.copy(), rs.host.copy(), ag.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    for rj, rt in zip(got_j, got_t):
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b, a)
    assert direct[-3:] == [True, True, True]
    total = np.sum([inputs[r][0] for r in range(NR)], axis=0)
    np.testing.assert_allclose(got_t[0][0][pad:pad + n], total, rtol=1e-5,
                               atol=1e-5)
    assert not got_t[0][0][:pad].any() and not got_t[0][0][-pad:].any()


def test_overlapping_result_keeps_the_copy(worlds, direct):
    # a result that overlaps its operand without being it: the drivers
    # must not write into it while they read the operand
    n = 16 * NR
    inputs = {r: [np.random.default_rng(90 + r).standard_normal(2 * n)
                  .astype(np.float32)] for r in range(NR)}

    def fn(accl, rank, bufs, Red):
        b = bufs[0]
        accl.allreduce(b.slice(0, n), b.slice(3, n + 3), n,
                       function=Red.SUM)
        return [b.host.copy()]

    got_j, got_t = _run_both(worlds, inputs, fn)
    for rj, rt in zip(got_j, got_t):
        np.testing.assert_array_equal(rt[0], rj[0])
    assert direct and not any(direct)
