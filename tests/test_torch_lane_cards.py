"""The fused and int8 lanes with ranks on several cards, on the CPU.

Across cards the fused lane (``ops/fused.py`` ``chunked_ring_*``) and the
int8 ring lane (``ops/quantized.py``) are rings, as the JAX package's
``ppermute`` lanes are: each rank folds on its own card and only one
hop's carry crosses to its right neighbour, through the move hook
``place(t, src, dst)`` (the engine's ``CudaEngine._move``,
``parallel.collectives.move`` in ``sync_gradients``).  On the CPU every
card is ``cpu``, so a lane that skipped a crossing or gathered onto one
rank would compute the same numbers; the hook's record shows it.

- Ops: the per-rank lists with a counting hook, bitwise the same call
  with no hook at P = 2, 3, 4, 5 and 8, and at P = 4 bitwise the JAX
  functions under ``shard_map`` on the conftest's CPU devices (as
  tests/test_torch_quantized.py and tests/test_torch_fused.py run them).
- The engine: ``CudaWorld(P, device="cpu", devices=["cpu"] * P)`` against
  the one-card ``CudaWorld(P, device="cpu")`` at those P and against
  ``TpuWorld(4)``; a spy on ``CudaEngine._move`` sees only neighbour
  hops, never a tensor of the operand's width, on the int8 lanes only
  int8 ``[rows, block]`` payloads and their fp32 ``[rows, 1]`` scales;
  the bytes crossed equal the fused lanes' trace rows (``_trace_fused``)
  link by link, and the link twin's ``comp_tx_bytes`` (fp32 lanes:
  ``tx_bytes``) scaled by the wire's padding (the int8 lanes pad each
  quantized chunk to whole blocks, the fused allreduce its payload to a
  multiple of P C), to within the twin's rounding of a byte a link.
- ``sync_gradients(compress="int8", devices=...)`` bitwise the one-card
  call with error feedback off and on, and stochastic, the stochastic
  result also within tests/test_torch_strategies.py's bound.

Data are integers in float32 on the engine (every fold order sums
exactly) and standard normal on the ops (the fold order is the ring's on
both sides).  Tolerance: bitwise throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.ops.fused as JF
from accl_tpu import DataType as JDataType
from accl_tpu import ReduceFunction as JReduce
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.ops import quantized as JQ
from accl_tpu_torch import CudaWorld, DataType, ReduceFunction
from accl_tpu_torch.arithconfig import DEFAULT_COMPRESS_BLOCK
from accl_tpu_torch.observability import trace as obs_trace
from accl_tpu_torch.ops import fused as TF
from accl_tpu_torch.ops import quantized as TQ
from accl_tpu_torch.ops import ring as tring
from accl_tpu_torch.parallel import strategies as TS
from accl_tpu_torch.utils.tree import tree_leaves

PS = [2, 3, 4, 5, 8]
T = 30
RING = 0          # the int8 wire spec takes the quantized ring
PLAIN = 4 << 20   # the default threshold: the fused lane runs at any size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Hook:
    """A move hook that records each crossing (src, dst, dtype, shape,
    bytes) and hands the tensor on as a copy, as a move to another card
    would."""

    def __init__(self):
        self.seen = []

    def __call__(self, t, src, dst):
        self.seen.append((src, dst, t.dtype, tuple(t.shape),
                          t.numel() * t.element_size()))
        return t.clone()


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _randn(P, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(P)]


def _ring_moves(P, tensors=1, chunks=1, phases=1):
    return P * (P - 1) * phases * chunks * tensors


def _neighbours_only(seen, P):
    """Every crossing is a hop to the right neighbour: no gather onto one
    rank."""
    assert seen and all(dst == (src + 1) % P for src, dst, *_ in seen)
    per_dst = {}
    for _s, dst, *_r in seen:
        per_dst[dst] = per_dst.get(dst, 0) + 1
    assert len(set(per_dst.values())) == 1 and len(per_dst) == P


def _wire_form(seen, block, width=None):
    """Every crossing an int8 [rows, block] payload or its fp32 [rows, 1]
    scales, and (``width`` given) none of the operand's width.  An
    all-gather passes no width: it relays each rank's whole contribution,
    in wire form, as the reference does."""
    for _s, _d, dt, shape, _b in seen:
        assert len(shape) == 2
        if dt == torch.int8:
            assert shape[1] == block
        else:
            assert dt == torch.float32 and shape[1] == 1
        assert width is None or shape[0] * shape[1] < width


def _jax_per_rank(fn, d):
    """fn(per-rank flat block) under shard_map over 4 CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("r",))
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=Pspec("r"), out_specs=Pspec("r"),
                              check_vma=False))
    return [torch.from_numpy(np.array(r))
            for r in np.asarray(f(jnp.asarray(np.stack(d))))]


# ---------------------------------------------------------------------------
# ops: the int8 ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("P", PS)
def test_quantized_ring_per_card(P, block, ef):
    n = 300  # ragged against both blocks
    xs = _randn(P, P * n, 40 + P)
    ag = [x[:n] for x in xs]
    cases = {
        "all_reduce": (lambda **k: TQ.quantized_all_reduce(xs, block, ef, **k),
                       2, P * n),
        "reduce_scatter": (lambda **k: TQ.quantized_ring_reduce_scatter(
            xs, block, ef, **k), 1, P * n),
        "all_gather": (lambda **k: TQ.quantized_ring_all_gather(
            ag, block, **k), 1, None),
    }
    for name, (call, phases, width) in cases.items():
        hook = Hook()
        got = call(place=hook)
        assert _same(got, call()), name
        assert len(hook.seen) == _ring_moves(P, 2, phases=phases), name
        _neighbours_only(hook.seen, P)
        _wire_form(hook.seen, block, width)
    if P == 4:
        d = [x.numpy() for x in xs]
        assert _same(TQ.quantized_all_reduce(xs, block, ef, place=Hook()),
                     _jax_per_rank(lambda v: JQ.quantized_all_reduce(
                         v, "r", block=block, error_feedback=ef), d))
        assert _same(TQ.quantized_ring_reduce_scatter(xs, block, ef,
                                                      place=Hook()),
                     _jax_per_rank(lambda v: JQ.quantized_ring_reduce_scatter(
                         v, "r", block=block, error_feedback=ef), d))
        assert _same(TQ.quantized_ring_all_gather(ag, block, place=Hook()),
                     _jax_per_rank(lambda v: JQ.quantized_ring_all_gather(
                         v, "r", block=block), [a.numpy() for a in ag]))


@pytest.mark.parametrize("P", PS)
def test_quantized_ring_stochastic_per_card(P):
    """Each rank's generator on its own tensor's device: the same bits
    with and without the hook, and the seed still decides them."""
    xs = _randn(P, P * 256, 70 + P)
    got = TQ.quantized_all_reduce(xs, 64, True, stochastic=True, seed=5,
                                  place=Hook())
    assert _same(got, TQ.quantized_all_reduce(xs, 64, True, stochastic=True,
                                              seed=5))
    assert not _same(got, TQ.quantized_all_reduce(xs, 64, True,
                                                  stochastic=True, seed=6,
                                                  place=Hook()))


# ---------------------------------------------------------------------------
# ops: the chunked (fused) lane
# ---------------------------------------------------------------------------
LANES = ["sum", "max", "int8", "int8_ef"]


def _wire(lane, block):
    return {"int8": (block, False), "int8_ef": (block, True)}.get(lane)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("P", PS)
def test_chunked_ring_per_card(P, C, lane):
    n = 96  # divides into C chunks, ragged against the 64 block
    block = 64
    op = "max" if lane == "max" else "sum"
    w = _wire(lane, block)
    xs = _randn(P, P * n + 5, 10 + P + C)  # the allreduce pads
    rs_in = [x[:P * n] for x in xs]
    ag_in = [x[:n] for x in xs]
    padN = -(-(P * n + 5) // (P * C)) * (P * C)
    cases = {
        "all_reduce": (lambda **k: TF.chunked_ring_all_reduce(
            xs, op, chunks=C, wire=w, **k), 2, C, padN // (P * C)),
        "reduce_scatter": (lambda **k: TF.chunked_ring_reduce_scatter(
            rs_in, op, chunks=C, wire=w, **k), 1, TF._pick_chunks(n, C),
            n // TF._pick_chunks(n, C)),
        "all_gather": (lambda **k: TF.chunked_ring_all_gather(
            ag_in, chunks=C, wire=w, **k), 1, TF._pick_chunks(n, C),
            n // TF._pick_chunks(n, C)),
    }
    for name, (call, phases, chunks, m) in cases.items():
        if lane == "max" and name == "all_gather":
            continue  # the all-gather folds nothing
        hook = Hook()
        got = call(place=hook)
        assert _same(got, call()), name
        tensors = 2 if w else 1
        assert len(hook.seen) == _ring_moves(P, tensors, chunks, phases), \
            name
        _neighbours_only(hook.seen, P)
        if w:
            _wire_form(hook.seen, block,
                       None if name == "all_gather" else P * n)
        else:  # each crossing one chunk's accumulator, m elements
            assert {shape for *_x, shape, _b in hook.seen} == {(m,)}, name
    if P == 4:
        d = [x.numpy() for x in xs]
        assert _same(TF.chunked_ring_all_reduce(xs, op, chunks=C, wire=w,
                                                place=Hook()),
                     _jax_per_rank(lambda v: JF.chunked_ring_all_reduce(
                         v, "r", op=op, chunks=C, wire=w), d))
        assert _same(TF.chunked_ring_reduce_scatter(rs_in, op, chunks=C,
                                                    wire=w, place=Hook()),
                     _jax_per_rank(lambda v: JF.chunked_ring_reduce_scatter(
                         v, "r", op=op, chunks=C, wire=w),
                         [x.numpy() for x in rs_in]))
        assert _same(TF.chunked_ring_all_gather(ag_in, chunks=C, wire=w,
                                                place=Hook()),
                     _jax_per_rank(lambda v: JF.chunked_ring_all_gather(
                         v, "r", chunks=C, wire=w),
                         [x.numpy() for x in ag_in]))


def test_fused_ring_equals_the_ring_lane_across_cards():
    """The fp32 fold stays ``local + incoming`` in the ring's order: with
    the hook the fused lane is still bitwise the ring lane where the
    payload divides P C."""
    P, C = 4, 4
    xs = _randn(P, P * C * 16, 3)
    fused = TF.chunked_ring_all_reduce(xs, "sum", chunks=C, place=Hook())
    assert _same(fused, tring.ring_all_reduce(xs, "sum"))


# ---------------------------------------------------------------------------
# the engine: CudaWorld(devices=) against one card and TpuWorld
# ---------------------------------------------------------------------------
#: lane -> (threshold, collective, call keywords)
ENGINE_LANES = {
    "fused_allreduce": (PLAIN, "allreduce", {"fused": True}),
    "fused_allreduce_max": (PLAIN, "allreduce", {"fused": True,
                                                 "function": "MAX"}),
    "fused_reduce_scatter": (PLAIN, "reduce_scatter", {"fused": True}),
    "fused_allgather": (PLAIN, "allgather", {"fused": True}),
    "fused_int8_allreduce": (PLAIN, "allreduce",
                             {"fused": True, "compress_dtype": "int8"}),
    "fused_int8_reduce_scatter": (PLAIN, "reduce_scatter",
                                  {"fused": True, "compress_dtype": "int8"}),
    "fused_int8_allgather": (PLAIN, "allgather",
                             {"fused": True, "compress_dtype": "int8"}),
    "int8_ring_allreduce": (RING, "allreduce", {"compress_dtype": "int8"}),
    "int8_ring_reduce_scatter": (RING, "reduce_scatter",
                                 {"compress_dtype": "int8"}),
    "int8_ring_allgather": (RING, "allgather", {"compress_dtype": "int8"}),
}


def _ints(n, rank, salt=0):
    rng = np.random.default_rng(900 + 17 * rank + 131 * salt)
    return rng.integers(-1000, 1000, n).astype(np.float32)


def _lane_call(lane, P, n, lib="torch"):
    """One collective a rank: n elements a rank's chunk (allreduce and
    reduce-scatter operands P n, an all-gather's n)."""
    _thr, kind, kw = ENGINE_LANES[lane]
    Red, DT = ((JReduce, JDataType) if lib == "jax"
               else (ReduceFunction, DataType))
    args = dict(kw)
    if "function" in args:
        args["function"] = Red.MAX
    if "compress_dtype" in args:
        args["compress_dtype"] = DT.int8

    def call(accl, rank):
        x = accl.create_buffer(P * n, np.float32)
        x.host[:] = _ints(P * n, rank)
        x.sync_to_device()
        if kind == "allreduce":
            out = accl.create_buffer(P * n, np.float32)
            accl.allreduce(x, out, P * n, **args)
        elif kind == "reduce_scatter":
            out = accl.create_buffer(n, np.float32)
            accl.reduce_scatter(x, out, n, **args)
        else:
            out = accl.create_buffer(P * n, np.float32)
            accl.allgather(x, out, n, **args)
        return out.host.copy()
    return call


def _run(world, lane, P, n, lib="torch"):
    thr = ENGINE_LANES[lane][0]
    saved = world.engine.ring_threshold_bytes
    world.engine.ring_threshold_bytes = thr
    try:
        if lib == "jax":
            return world.run(_lane_call(lane, P, n, lib))
        return world.run(_lane_call(lane, P, n, lib), timeout=T)
    finally:
        world.engine.ring_threshold_bytes = saved


class Spy:
    """Wraps one engine's ``_move``: records each crossing (world ranks)
    and moves it."""

    def __init__(self, engine):
        self.seen = []
        self._move = engine._move
        engine._move = self

    def __call__(self, t, src, dst):
        self.seen.append((src, dst, t.dtype, tuple(t.shape),
                          t.numel() * t.element_size()))
        return self._move(t, src, dst)


def _engine_moves(lane, P, n):
    """Crossings a call: one hop's carry a rank and hop."""
    _thr, kind, kw = ENGINE_LANES[lane]
    phases = 2 if kind == "allreduce" else 1
    tensors = 2 if kw.get("compress_dtype") == "int8" and \
        "function" not in kw else 1
    if not kw.get("fused"):
        chunks = 1
    elif kind == "allreduce":
        chunks = TF.fused_chunks()
    else:
        chunks = TF._pick_chunks(n, None)
    return _ring_moves(P, tensors, chunks, phases)


@pytest.mark.parametrize("P", PS)
def test_engine_lanes_per_card_match_one_card(P):
    n = 120
    with CudaWorld(P, device="cpu") as one, \
            CudaWorld(P, device="cpu", devices=["cpu"] * P) as cards:
        for lane in ENGINE_LANES:
            want = _run(one, lane, P, n)
            before = cards.engine.peer_moves
            got = _run(cards, lane, P, n)
            for r in range(P):
                assert got[r].tobytes() == want[r].tobytes(), (lane, r)
            assert cards.engine.peer_moves - before == \
                _engine_moves(lane, P, n), lane
        assert one.engine.peer_moves == 0


def test_engine_lanes_per_card_match_tpu_world():
    P, n = 4, 120
    with TpuWorld(P) as tw, \
            CudaWorld(P, device="cpu", devices=["cpu"] * P) as cards:
        saved = tw.engine.ring_threshold_bytes
        try:
            for lane in ENGINE_LANES:
                tw.engine.ring_threshold_bytes = ENGINE_LANES[lane][0]
                want = tw.run(_lane_call(lane, P, n, "jax"))
                got = _run(cards, lane, P, n)
                for r in range(P):
                    assert got[r].tobytes() == want[r].tobytes(), (lane, r)
        finally:
            tw.engine.ring_threshold_bytes = saved


def _twin_tx(engine, P, field):
    """The link twin's ``field`` summed over every rank's rows."""
    return sum(row[field] for r in range(P)
               for row in engine.link_stats_for(r))


def _padded(lane, P, n, block):
    """(elements of a rank's chunk the twin counts, elements that cross
    in its place): the int8 wire pads each quantized piece to whole
    blocks, the fused allreduce its payload to a multiple of P C."""
    _thr, kind, kw = ENGINE_LANES[lane]
    if kw.get("fused"):
        C = TF.fused_chunks() if kind == "allreduce" else \
            TF._pick_chunks(n, None)
        padN = -(-(P * n) // (P * C)) * (P * C) if kind == "allreduce" \
            else P * n
        m = padN // (P * C)
    else:
        C, m = 1, n
    if kw.get("compress_dtype") == "int8":
        m = -(-m // block) * block
    return n, C * m


# n divides by P (the int8 all-gather's ring takes such payloads only)
@pytest.mark.parametrize("n", [3072, 1020], ids=["whole_blocks", "ragged"])
@pytest.mark.parametrize("lane", [k for k in ENGINE_LANES
                                  if "max" not in k])
@pytest.mark.parametrize("P", [3, 4])
def test_engine_lane_crossings(P, lane, n, monkeypatch):
    """What crosses: neighbour hops of one carry, never the operand's
    width, the int8 lanes' wire form only; the bytes equal the fused
    lanes' trace rows link by link, and the link twin's counts scaled by
    the wire's padding."""
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    tring._reset_device_trace_cache()
    obs_trace.collector().clear()
    block = DEFAULT_COMPRESS_BLOCK
    int8 = ENGINE_LANES[lane][2].get("compress_dtype") == "int8"
    try:
        with CudaWorld(P, device="cpu", devices=["cpu"] * P) as cards:
            spy = Spy(cards.engine)
            _run(cards, lane, P, n)
            seen = spy.seen
            twin = _twin_tx(cards.engine, P,
                            "comp_tx_bytes" if int8 else "tx_bytes")
        links = obs_trace.collector().device_link_bytes()
    finally:
        monkeypatch.delenv("ACCL_DEVICE_TRACE")
        tring._reset_device_trace_cache()
        obs_trace.collector().clear()
    assert len(seen) == _engine_moves(lane, P, n)
    _neighbours_only(seen, P)
    if int8:
        _wire_form(seen, block, None if ENGINE_LANES[lane][1] == "allgather"
                   else P * n)
    else:
        assert all(len(s[3]) == 1 and s[3][0] < n for s in seen)
    crossed = {}
    for src, dst, _dt, _shape, nbytes in seen:
        crossed[src, dst] = crossed.get((src, dst), 0) + nbytes
    if ENGINE_LANES[lane][2].get("fused"):
        # _trace_fused's rows: hop bytes x (P - 1) C phases hops, per rank
        assert links == crossed
    else:
        assert links == {}  # the quantized ring records no stamp rows
    # the twin floors each link's bytes twice (busbw, then the wire ratio)
    counted, carried = _padded(lane, P, n, block)
    total = sum(crossed.values())
    assert abs(total - twin * carried / counted) <= 2 * P * carried / counted
    if carried == counted:
        assert abs(total - twin) <= 2 * P


# ---------------------------------------------------------------------------
# sync_gradients(compress="int8") across the members' cards
# ---------------------------------------------------------------------------
def _grads(P, seed):
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy(rng.standard_normal((8, 33)).astype(
                np.float32)),
             "b": [torch.from_numpy(rng.standard_normal(5).astype(
                 np.float32))]} for _ in range(P)]


class MoveSpy:
    """Wraps ``strategies.move`` (``collectives.move``): each crossing's
    dtype and shape."""

    def __init__(self, monkeypatch):
        self.seen = []
        self._move = TS.move
        monkeypatch.setattr(TS, "move", self)

    def __call__(self, t, device):
        self.seen.append((t.dtype, tuple(t.shape)))
        return self._move(t, device)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("P", PS)
def test_sync_gradients_int8_per_card(P, ef, monkeypatch):
    gs = _grads(P, 30 + P)
    one = TS.sync_gradients(gs, compress="int8", error_feedback=ef)
    spy = MoveSpy(monkeypatch)
    got = TS.sync_gradients(gs, compress="int8", error_feedback=ef,
                            devices=["cpu"] * P)
    for r in range(P):
        assert _same(tree_leaves(got[r]), tree_leaves(one[r]))
    # two leaves; each member receives a payload and its scales a hop
    assert len(spy.seen) == 2 * _ring_moves(P, 2, phases=2)
    for dt, shape in spy.seen:
        assert shape[1] == (TQ.DEFAULT_BLOCK if dt == torch.int8 else 1)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sync_gradients_int8_stochastic_per_card(P):
    """Stochastic: bitwise the one-card call (each member's generator on
    its own card), and within tests/test_torch_strategies.py's bound of
    the exact mean."""
    rng = np.random.default_rng(32)
    g = rng.standard_normal((P, 1000)).astype(np.float32)
    members = [torch.from_numpy(np.ascontiguousarray(x)) for x in g]
    got = TS.sync_gradients(members, compress="int8", stochastic=True,
                            seed=3, devices=["cpu"] * P)
    one = TS.sync_gradients(members, compress="int8", stochastic=True,
                            seed=3)
    assert all(torch.equal(a, b) for a, b in zip(got, one))
    bound = P * (2 * 5 * np.sqrt(P) / 127) / P
    assert np.abs(got[P - 1].numpy() - g.mean(axis=0)).max() <= bound
