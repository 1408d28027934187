"""Ranks on several cards (CudaWorld(devices=), the ring kernels'
cross-card mode, make_hybrid_mesh, initialize_multihost) on the CPU.

- ``CudaWorld(P, device="cpu", devices=["cpu"] * P)`` takes the world of
  several cards' code path: each rank's own device, every tensor that
  crosses from one rank to another through ``CudaEngine._move``.  Each
  collective and lane runs on it, on the one-card ``CudaWorld(P,
  device="cpu")`` and on the JAX ``TpuWorld(P)`` over the 8 virtual CPU
  devices.  The data are integers in float32, so every fold order sums
  exactly: the results are bitwise the JAX world's in every lane but the
  int8 wire below the ring threshold, whose exit roundtrip may move at
  most 2 elements a result by one quantization step
  (tests/test_torch_driver.py ``_int8_psum_parity``, ROADMAP.md); and
  bitwise the one-card world's in every lane.
- The moves each lane makes, counted by the engine's one move function,
  against the count stated for that lane: on the CPU every rank's device
  is ``cpu``, so a lane that skipped a move would still compute the
  same numbers, and only the count shows it.
- The per-card launch plan of ops/ring.py as pure functions of a layout.
- A replay of the cross-card mode's per-card launches under adversarial
  delivery (the schedule of tests/test_torch_ring_segments.py's replay,
  plus the entry handshake, the flags' reset at a block's end and cards
  that start their next launch as soon as their last one ends): no slot
  is overwritten before it is read, no landing is read from another
  launch, no flag count is lost, for P = 2..8 in groups of 1-4 ranks,
  eager launches alone and eager launches interleaved with the replays
  of launches captured in a CUDA graph (the handshake's count read on
  the card, wrapping at 2^32); and a broken handshake, a count fixed at
  capture by the host and a launch given up that counts are caught.
- ``make_hybrid_mesh`` and ``initialize_multihost`` against the JAX
  functions, and a two-process rendezvous on localhost.
"""
import re
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from accl_tpu import DataType as JDataType
from accl_tpu import ReduceFunction as JReduce
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.parallel.mesh import make_hybrid_mesh as jax_hybrid_mesh
from accl_tpu.utils.bringup import initialize_multihost as jax_multihost
from accl_tpu_torch import (
    ACCLError,
    CudaWorld,
    DataType,
    Operation,
    ReduceFunction,
    StreamFlags,
    load_world_state,
)
from accl_tpu_torch.device_api import ACCLCommand, ACCLData
from accl_tpu_torch.ops import fused as tfused
from accl_tpu_torch.ops import ring as tring
from accl_tpu_torch.parallel.mesh import make_hybrid_mesh
from accl_tpu_torch.utils import bringup
from accl_tpu_torch.utils.device import resolve_devices

ROOT = Path(__file__).resolve().parents[1]
RING_CU = ROOT / "accl_tpu_torch" / "ops" / "csrc" / "ring.cu"
FUSED_CU = ROOT / "accl_tpu_torch" / "ops" / "csrc" / "fused.cu"
NR = 4
N = 64
PLAIN = 4 << 20  # the default ring threshold: small payloads stay plain
RING = 0         # every eligible collective rides the ring lane
T = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def worlds():
    with TpuWorld(NR) as tw, CudaWorld(NR, device="cpu") as one, \
            CudaWorld(NR, device="cpu", devices=["cpu"] * NR) as cards:
        yield tw, one, cards


def _ints(n, rank, salt=0):
    rng = np.random.default_rng(500 + 17 * rank + 131 * salt)
    return rng.integers(-1000, 1000, n).astype(np.float32)


def _enums(lib):
    return (JReduce, JDataType) if lib == "jax" else (ReduceFunction,
                                                      DataType)


def _run_all(worlds, inputs, fn, threshold):
    """``fn(accl, rank, bufs, lib)`` on the JAX world, the one-card world
    and the world of per-rank devices, each loaded with the same per-rank
    arrays; returns the three lists of per-rank results and the moves the
    last world made."""
    tw, one, cards = worlds
    tbufs = {r: [tw.accls[r].create_buffer_like(a) for a in arrs]
             for r, arrs in inputs.items()}
    for bufs in tbufs.values():
        for b in bufs:
            b.sync_to_device()
    state = {"buffers": inputs, "ring_threshold_bytes": threshold}
    saved = tw.engine.ring_threshold_bytes
    tw.engine.ring_threshold_bytes = threshold
    try:
        got = {"jax": tw.run(lambda a, r: fn(a, r, tbufs[r], "jax"))}
        for name, w in (("one", one), ("cards", cards)):
            loaded = load_world_state(w, state)
            before = w.engine.peer_moves
            got[name] = w.run(lambda a, r: fn(a, r, loaded["buffers"][r],
                                              "torch"), timeout=T)
            moves = w.engine.peer_moves - before
    finally:
        tw.engine.ring_threshold_bytes = saved
        for w in (one, cards):
            for a in w.accls:
                a.set_tuning(6, PLAIN)
    return got["jax"], got["one"], got["cards"], moves


def _bitwise(a, b, what):
    for r, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), what
        for x, y in zip(ra, rb):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), \
                f"{what}: rank {r}"


def _int8_parity(a, b, block=256, max_moved=2):
    """At most ``max_moved`` elements a result differ, each by one
    quantization step of its own block (tests/test_torch_driver.py)."""
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            moved = np.flatnonzero(x != y)
            assert moved.size <= max_moved
            for i in moved:
                blk = x[i // block * block:(i // block + 1) * block]
                step = np.float32(np.abs(blk).max()) * np.float32(1 / 127)
                np.testing.assert_allclose(abs(float(y[i]) - float(x[i])),
                                           step, rtol=1e-5)


# ---------------------------------------------------------------------------
# every collective and lane: (name, threshold, one collective a rank,
# moves it makes at P ranks)
# ---------------------------------------------------------------------------
def _coll(kind, count, **kw):
    def call(accl, rank, bufs, lib):
        Red, DT = _enums(lib)
        x = bufs[0]
        args = dict(kw)
        if args.get("function") == "MAX":
            args["function"] = Red.MAX
        if "compress_dtype" in args:
            args["compress_dtype"] = DT[args["compress_dtype"]]
        if kind == "allreduce":
            out = accl.create_buffer(count, np.float32)
            accl.allreduce(x, out, count, **args)
        elif kind == "reduce":
            out = accl.create_buffer(count, np.float32)
            accl.reduce(x, out, count, root=1, **args)
            return [out.host.copy()] if rank == 1 else []
        elif kind == "reduce_scatter":
            out = accl.create_buffer(count, np.float32)
            accl.reduce_scatter(x, out, count, **args)
        elif kind == "allgather":
            out = accl.create_buffer(count * NR, np.float32)
            accl.allgather(x, out, count, **args)
        elif kind == "bcast":
            accl.bcast(x, count, root=2, **args)
            out = x
        elif kind == "scatter":
            out = accl.create_buffer(count, np.float32)
            accl.scatter(x, out, count, root=1, **args)
        elif kind == "gather":
            out = accl.create_buffer(count * NR, np.float32)
            accl.gather(x, out, count, root=3, **args)
            return [out.host.copy()] if rank == 3 else []
        elif kind == "alltoall":
            out = accl.create_buffer(count * NR, np.float32)
            accl.alltoall(x, out, count, **args)
        return [out.host.copy()]
    return call


def _send_recv(accl, rank, bufs, lib):
    out = accl.create_buffer(N, np.float32)
    if rank % 2:
        accl.recv(out, N, (rank - 1) % NR, tag=7)
        accl.send(bufs[0], N, (rank + 1) % NR, tag=7)
    else:
        accl.send(bufs[0], N, (rank + 1) % NR, tag=7)
        accl.recv(out, N, (rank - 1) % NR, tag=7)
    return [out.host.copy()]


def _barrier(accl, rank, bufs, lib):
    accl.barrier()
    return []


def _plan_replay(accl, rank, bufs, lib):
    """A captured small allreduce, replayed twice with new operands."""
    x = bufs[0]
    out = accl.create_buffer(N * NR, np.float32)
    plan = accl.capture_plan(lambda a: a.allreduce(x, out, N * NR))
    got = [out.host.copy()]
    for it in range(2):
        x.host[:] = _ints(N * NR, rank, 40 + it)
        plan.replay()
        got.append(out.host.copy())
    return got


def _stream_fed(accl, rank, bufs, lib):
    """A stream->stream allreduce: the operand pushed into the rank's
    kernel queue, the result pulled from its stream 9."""
    d = ACCLData(accl.device)
    d.push(bufs[0].host.copy())
    cmd = ACCLCommand(accl.device, arithcfg=accl._arith_ids[
        (_enums(lib)[1].float32, _enums(lib)[1].float32)])
    cmd.start_call(Operation.allreduce, N * NR, tag=9,
                   stream_flags=StreamFlags.OP0_STREAM
                   | StreamFlags.RES_STREAM)
    cmd.finalize_call(timeout=T)
    return [d.pull(N * NR, np.float32, 9, timeout=T)]


def _hub(P):
    return 2 * (P - 1)


def _ring(P, tensors=1, chunks=1, phases=1):
    """A ring across the cards: at each of phases (P - 1) hops every rank
    receives ``tensors`` tensors (an int8 payload and its scales: 2) of
    each of ``chunks`` chunks from its left neighbour."""
    return P * (P - 1) * phases * chunks * tensors


def _chunks(n=None):
    """The fused lane's chunks: the allreduce's, or a reduce-scatter's or
    all-gather's of n elements a rank."""
    return tfused.fused_chunks() if n is None else tfused._pick_chunks(n,
                                                                       None)


#: lane -> (threshold, function, moves at P ranks)
LANES = {
    "ring_allreduce": (RING, _coll("allreduce", N * NR), lambda P: 0),
    "ring_allreduce_max": (RING, _coll("allreduce", N * NR, function="MAX"),
                           lambda P: 0),
    "ring_reduce_scatter": (RING, _coll("reduce_scatter", N), lambda P: 0),
    "ring_allgather": (RING, _coll("allgather", N), lambda P: 0),
    "small_allreduce": (PLAIN, _coll("allreduce", N * NR), _hub),
    "small_allreduce_max": (PLAIN, _coll("allreduce", N * NR,
                                         function="MAX"), _hub),
    "small_reduce": (PLAIN, _coll("reduce", N * NR), lambda P: P - 1),
    "small_reduce_scatter": (PLAIN, _coll("reduce_scatter", N), _hub),
    "small_allgather": (PLAIN, _coll("allgather", N), _hub),
    "bcast": (PLAIN, _coll("bcast", N), lambda P: P - 1),
    "scatter": (PLAIN, _coll("scatter", N), lambda P: P - 1),
    "gather": (PLAIN, _coll("gather", N), lambda P: P - 1),
    "alltoall": (PLAIN, _coll("alltoall", N), lambda P: P * (P - 1)),
    "fused_allreduce": (PLAIN, _coll("allreduce", N * NR, fused=True),
                        lambda P: _ring(P, chunks=_chunks(), phases=2)),
    "fused_reduce_scatter": (PLAIN, _coll("reduce_scatter", N, fused=True),
                             lambda P: _ring(P, chunks=_chunks(N))),
    "fused_allgather": (PLAIN, _coll("allgather", N, fused=True),
                        lambda P: _ring(P, chunks=_chunks(N))),
    "int8_ring_allreduce": (RING, _coll("allreduce", N * NR,
                                        compress_dtype="int8"),
                            lambda P: _ring(P, tensors=2, phases=2)),
    "int8_small_allreduce": (PLAIN, _coll("allreduce", N * NR,
                                          compress_dtype="int8"), _hub),
    "fp16_ring_allreduce": (RING, _coll("allreduce", N * NR,
                                        compress_dtype="float16"),
                            lambda P: 0),
    "bf16_small_allreduce": (PLAIN, _coll("allreduce", N * NR,
                                          compress_dtype="bfloat16"), _hub),
    "send_recv": (PLAIN, _send_recv, lambda P: P),
    "barrier": (PLAIN, _barrier, lambda P: 0),
    "plan_replay": (PLAIN, _plan_replay, lambda P: 3 * _hub(P)),
    "stream_fed": (PLAIN, _stream_fed, _hub),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_matches_tpu_world_and_the_one_card_world(worlds, lane):
    threshold, fn, _moves = LANES[lane]
    inputs = {r: [_ints(N * NR, r, 1)] for r in range(NR)}
    got_j, got_one, got_cards, _m = _run_all(worlds, inputs, fn, threshold)
    _bitwise(got_one, got_cards, f"{lane}: cards vs one card")
    if lane == "int8_small_allreduce":
        _int8_parity(got_j, got_cards)
    else:
        _bitwise(got_j, got_cards, f"{lane}: cards vs TpuWorld")


@pytest.mark.parametrize("lane", list(LANES))
def test_moves_per_lane(worlds, lane):
    """One row per lane: what the lane moves from rank to rank through
    the engine's move function (none on the ring lane, whose kernels hop
    across cards themselves; one hop's carry a rank and hop on the fused
    and int8 ring lanes; two ways through a hub below the threshold)."""
    threshold, fn, moves = LANES[lane]
    inputs = {r: [_ints(N * NR, r, 2)] for r in range(NR)}
    _j, _o, _c, made = _run_all(worlds, inputs, fn, threshold)
    assert made == moves(NR), (lane, made)


def test_one_card_world_moves_nothing(worlds):
    _tw, one, _cards = worlds
    assert one.engine.rank_devices is None and one.engine.peer_moves == 0


@pytest.mark.parametrize("P", [2, 3, 5, 8])
def test_per_rank_world_matches_one_card_world_at_p(P):
    """At other ring sizes: the ring, small, fused, int8 and alltoall
    lanes and a send ring, bitwise the one-card world's, with the moves
    the rows above state."""
    def fn(accl, rank):
        x = accl.create_buffer(N * P, np.float32)
        x.host[:] = _ints(N * P, rank, 3)
        x.sync_to_device()
        y = accl.create_buffer(N * P, np.float32)
        out = []
        for kw in ({}, {"fused": True},
                   {"compress_dtype": DataType.int8}):
            accl.allreduce(x, y, N * P, **kw)
            out.append(y.host.copy())
        accl.alltoall(x, y, N)
        out.append(y.host.copy())
        accl.send(x, N, (rank + 1) % P, tag=3)
        accl.recv(y, N, (rank - 1) % P, tag=3)
        out.append(y.host[:N].copy())
        return out

    got = {}
    for name, kw in (("one", {}), ("cards", {"devices": ["cpu"] * P})):
        for thr in (PLAIN, RING):
            with CudaWorld(P, device="cpu", **kw) as w:
                w.engine.ring_threshold_bytes = thr
                got[name, thr] = w.run(fn, timeout=T)
                moves = w.engine.peer_moves
            # the allreduce and the int8 roundtrip gather to a hub below the
            # threshold, the int8 ring hops (q, scale) above it; the fused
            # lane hops each chunk; alltoall P (P - 1); a send 1
            lanes = (2 * _hub(P) if thr == PLAIN
                     else _ring(P, tensors=2, phases=2))
            assert moves == (lanes + _ring(P, chunks=_chunks(), phases=2)
                             + P * (P - 1) + P if name == "cards" else 0)
    for thr in (PLAIN, RING):
        _bitwise(got["one", thr], got["cards", thr], f"P={P}")


def test_devices_argument_is_checked_like_tpu_world():
    """Fewer devices than ranks raise as TpuEngine raises
    (tpu.py:234-237); a mix of the CPU and cards, or cards on a machine
    without one, raise too; the first nranks entries are used."""
    with pytest.raises(ACCLError, match="need 4 devices, found 2"):
        CudaWorld(4, device="cpu", devices=["cpu"] * 2)
    with pytest.raises(Exception, match="need 4 devices, found 2"):
        TpuWorld(4, devices=jax.devices()[:2])
    with pytest.raises(ACCLError, match="every rank's device"):
        resolve_devices(["cpu", "cuda:0"], 2, "w")
    if not torch.cuda.is_available():
        with pytest.raises(ACCLError, match="no CUDA device"):
            CudaWorld(2, devices=["cuda:0", "cuda:1"])
    assert resolve_devices(["cpu"] * 5, 3, "w") == [torch.device("cpu")] * 3


def test_initialize_world_passes_devices_through():
    w = bringup.initialize_world(bringup.Design.CUDA, 3, device="cpu",
                                 devices=["cpu"] * 3)
    try:
        assert w.engine.rank_devices == [torch.device("cpu")] * 3
        assert [w.engine.device_of(r) for r in range(3)] \
            == [torch.device("cpu")] * 3
    finally:
        w.close()


# ---------------------------------------------------------------------------
# the per-card launch plan (pure functions of a layout)
# ---------------------------------------------------------------------------
def _block_ranks(ranks, S):
    """The rank each block of a card's launch plays, as
    ``ring_kernel_cross`` reads it: block b plays ``ranks[b // S]`` on
    stripe ``b % S``."""
    return [ranks[b // S] for b in range(len(ranks) * S)]


def _entry_waits(my, P, base):
    """What a block of rank ``my`` waits for before its first hop, as
    ``ring_kernel_cross`` does: [(word of its own flags, count)], the
    blocks of its left neighbour (word 0) and of its right (word 1)."""
    return [(0, base), (1, base)]


def _exit_counts(my, P):
    """The handshake words a block of rank ``my`` counts itself into as it
    ends, after setting its flags back to 0: [(rank, word)], its left
    neighbour's word 1 and its right neighbour's word 0."""
    return [((my - 1) % P, 1), ((my + 1) % P, 0)]


@pytest.mark.parametrize("layout,groups", [
    ([0, 0, 1, 1], [(0, [0, 1]), (1, [2, 3])]),
    ([0, 1, 0, 1], [(0, [0, 2]), (1, [1, 3])]),
    ([0, 1, 2, 3], [(0, [0]), (1, [1]), (2, [2]), (3, [3])]),
    ([3, 3, 3, 3], [(3, [0, 1, 2, 3])]),
    ([1, 0, 0], [(1, [0]), (0, [1, 2])]),
])
def test_per_card_launch_plan(layout, groups, monkeypatch):
    """The groups and block ranks of a layout, the layout ``_check`` finds
    (None when the ranks share a card), and which form ``_launch`` takes
    with it: the one launch (.gpu) on one card unless the ``rank_tables``
    form is asked for, else the cross-card mode (.sys), given the
    layout."""
    assert tring.card_groups(layout) == groups
    for _card, ranks in groups:
        blocks = _block_ranks(ranks, 3)
        assert len(blocks) == 3 * len(ranks)
        assert blocks == [r for r in ranks for _ in range(3)]
    assert (tring.HS_DONE, tring.HS_ENDED) == (4, 5) < (tring.HS_WORDS,) * 2
    taken = []
    monkeypatch.setattr(tring, "_launch_cross",
                        lambda *a: taken.append(("tables", a[-1])))
    monkeypatch.setattr(tring, "_launch_one",
                        lambda *a: taken.append(("one", None)))
    xs = [SimpleNamespace(device=torch.device("cuda", c),
                          dtype=torch.float32) for c in layout]
    found = tring._check(xs, xs, "plan")
    assert found == (None if len(groups) == 1 else tuple(layout))
    tring._launch("rs", xs, xs, [], found)
    with tring.rank_tables():
        tring._launch("ag", xs, xs, [], found)
    tring._launch("ag", xs[:1], xs[:1], [], None, V=4)  # the self-ring
    assert taken == [("one", None) if len(groups) == 1
                     else ("tables", tuple(layout)),
                     ("tables", tuple(layout)), ("one", None)]


def test_cross_card_plan_fits_the_card_with_most_ranks(monkeypatch):
    """Every card's launch takes the same stripes, as many as the card
    holding the most ranks fits; slot bytes are one rank's; the cache
    keys on the layout."""
    monkeypatch.setattr(tring, "_resident", lambda k, c, d, s=0: 264)
    tring._plan.cache_clear()
    parts = tuple(tring.allreduce_parts(8 * 4 * (1 << 18), 8))
    one = tring._plan(parts, 8, 4, 0, 0, 0, True)
    spread = tring._plan(parts, 8, 4, 0, 0, 0, True, False,
                         (0, 1, 2, 3, 4, 5, 6, 7))
    paired = tring._plan(parts, 8, 4, 0, 0, 0, True, False,
                         (0, 0, 1, 1, 2, 2, 3, 3))
    tring._plan.cache_clear()
    tw1, _nt, S1 = tring.tiling(parts, 8, 4, 264)
    assert one[0] == S1 and one[2] == 8 * S1 * 2 * tw1 * 4
    for got, most in ((spread, 1), (paired, 2)):
        tw, _nt, S = tring.tiling(parts, most, 4, 264)
        assert got[0] == min(S, tring.MAX_STRIPES)
        assert got[2] == got[0] * 2 * tw * 4
    assert paired[0] <= spread[0]


def _body(src: str, head: str) -> str:
    got = src[src.index(head):]
    return got[:got.index("\n}\n")]


def test_kernel_source_holds_the_replayed_handshake():
    """ring_kernel_cross enters through cross_entry (the host's gate of an
    eager launch, none for a captured one; then both of its rank's
    handshake words at the rank's own count, read on the card) and, as it
    ends, counts itself into its left neighbour's word 1 and its right
    neighbour's word 0, then out of its rank's launch (count_out: the
    rank's last block advances that count by S), at .sys scope, as does
    its step; the one-launch step and fused.cu's one launch keep .gpu."""
    src = RING_CU.read_text()
    sync = (RING_CU.parent / "ring_sync.cuh").read_text()
    cross = _body(src, "ring_kernel_cross(PtrTable")
    assert "const int my = tabs.rank[blockIdx.x / S], k = blockIdx.x % S;" \
        in cross  # the block's rank: _block_ranks
    assert "int base" not in cross and "base" not in cross.split("{")[0]
    assert _entry_waits(2, 5, 7) == [(0, 7), (1, 7)]
    assert cross.index("opened = cross_entry(tabs.gate, tabs.seq, "
                       "tabs.flags[tabs.rank[0]] + 2, tabs.flags[my]);") \
        < cross.index("if (!opened) return;") \
        < cross.index("ring_step_cross<T, KIND, STAMP>")
    # the entry: the gate only for an eager launch, read by one block a
    # card (the others wait on that card's copy); then the count the
    # handshake waits for, from the rank's own flags on the card
    entry = _body(sync, "int cross_entry(")
    assert entry.index("if (gate != nullptr) {") \
        < entry.index("if (blockIdx.x == 0) {") \
        < entry.index("opened = wait_gate(gate, seq);") \
        < entry.index("opened = wait_gate(card_gate, seq);") \
        < entry.index("if (!opened) return 0;") \
        < entry.index("const int base = ld_acquire<SCOPE_GPU>(head + "
                      "HS_DONE);") \
        < entry.index("wait_reached<SCOPE_SYS>(head, base);") \
        < entry.index("wait_reached<SCOPE_SYS>(head + 1, base);")
    assert _exit_counts(2, 5) == [(1, 1), (3, 0)]
    end = cross[cross.rindex("if (threadIdx.x == 0) {"):]
    assert end.index("arrive_release<SCOPE_SYS>(tabs.flags[left] + 1);") \
        < end.index("arrive_release<SCOPE_SYS>(tabs.flags[right]);") \
        < end.index("count_out(tabs.flags[my], S);")
    out = _body(sync, "void count_out(")
    assert "atom.acq_rel.gpu.global.add.u32" in out
    assert "head + HS_ENDED" in out
    assert out.index("if (ended == S - 1) {") \
        < out.index("head[HS_ENDED] = 0;") \
        < out.index("head[HS_DONE] = (int)((unsigned)head[HS_DONE] + "
                    "(unsigned)S);")
    assert "SCOPE_GPU" not in cross
    for name, scope, other in (("ring_step(", "SCOPE_GPU", "SCOPE_SYS"),
                               ("ring_step_cross(", "SCOPE_SYS",
                                "SCOPE_GPU")):
        step = _body(src, f"void {name}")
        assert scope in step and other not in step, name
    # the flags' head is defined once, in the header both sources share
    assert '#include "ring_sync.cuh"' in src and "#define HS_WORDS" not in src
    for name in ("HS_WORDS", "HS_DONE", "HS_ENDED"):
        assert f"#define {name} {getattr(tring, name)}\n" in sync, name
    # fused.cu's one-launch kernel keeps .gpu; its cross-card mode, a
    # function of its own, is .sys throughout
    fused = FUSED_CU.read_text()
    one = _body(fused, "fused_matmul_rs_kernel(PtrTable")
    assert "SCOPE_SYS" not in one
    assert len(re.findall(r"<SCOPE_GPU>", one)) == 5
    fcross = _body(fused, "fused_matmul_rs_cross_kernel(PtrTable")
    assert "SCOPE_GPU" not in fcross
    assert len(re.findall(r"<SCOPE_GPU>", fused)) == 5


def _c_params(src: str, name: str) -> int:
    """The parameters of the C entry ``name`` in ``src``."""
    sig = re.search(rf"[\s*]{name}\(([^)]*)\)\s*{{", src).group(1)
    return len([p for p in sig.split(",") if p.strip()])


def test_c_entries_take_what_the_bindings_pass():
    """Every entry point ops/_build.py binds takes as many parameters in
    its source as the binding passes (a mismatch shows only on the card,
    as a fault)."""
    from accl_tpu_torch.ops import _build

    for lib, entries in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for name, (argtypes, _restype) in entries.items():
            assert _c_params(src, name) == len(argtypes), (lib, name)


# ---------------------------------------------------------------------------
# replay of per-card launches under adversarial delivery
# ---------------------------------------------------------------------------
def _tiles_of(ntiles, S, k):
    return (ntiles - 1 - k) // S + 1 if k < ntiles else 0


def _block_program(P, U):
    """A block of ``ring_kernel_cross`` over U tiles, read from the port's
    window predicates (one stripe's): its entry (the handshake, whose
    waits the replay inserts once the block has its count) and its
    exit."""
    ops = [("entry",)]
    H = U * (P - 1)
    for u in range(U):
        h0 = u * (P - 1)
        if tring.tile_waits_ack(h0, H):
            ops.append(("wait_ack", h0))
        ops.append(("send", h0))
        for q in range(1, P):
            h = h0 + q - 1
            last = q == P - 1
            ops.append(("wait_filled", h))
            if not last and tring.tile_waits_ack(h + 1, H):
                ops.append(("wait_ack", h + 1))
            ops.append(("read", h))
            if not last:
                ops.append(("send", h + 1))
            if tring.tile_signals_ack(h, H):
                ops.append(("signal_ack", h))
    ops.append(("exit", U, H))
    return ops


#: launches on one set of tables: (tiles, stripes); stripes change from
#: launch to launch (the flags' addresses with them), and the last one
#: has stripes with no tile
LAUNCHES = [(3, 2), (1, 1), (4, 3), (2, 4)]
#: eager launches interleaved with the replays of launches captured in a
#: CUDA graph, in the order the cards' streams run them: ("eager",
#: (tiles, stripes)); ("capture", graph, [(tiles, stripes), ...]), which
#: runs nothing; ("replay", graph); ("given_up", (tiles, stripes)), an
#: eager launch given up, whose blocks end at once
CAPTURED = [("eager", (3, 2)), ("capture", "g", [(1, 1), (4, 3)]),
            ("replay", "g"), ("eager", (2, 4)), ("replay", "g"),
            ("replay", "g"), ("given_up", (2, 3)), ("eager", (1, 1)),
            ("capture", "h", [(2, 2)]), ("replay", "g"), ("replay", "h"),
            ("eager", (3, 2)), ("replay", "h"), ("replay", "h")]
MASK = 0xFFFFFFFF


def _run_order(seq, host_count=False):
    """[(tiles, stripes, count, given_up)]: the launches the cards run for
    ``seq``, each with the count its handshake waits for: None where the
    blocks read it on the card (the kernels), else the host's running sum
    of the stripes of its earlier calls, fixed at the call (the design
    before the count moved to the card, as a mutation: a captured launch
    keeps its capture's count in every replay, and the capture itself
    counts as a launch)."""
    out, graphs, host = [], {}, 0
    for item in seq:
        if item[0] in ("eager", "given_up"):
            nt, S = item[1]
            given_up = item[0] == "given_up"
            out.append((nt, S, host if host_count else None, given_up))
            host += 0 if given_up else S
        elif item[0] == "capture":
            graphs[item[1]] = []
            for nt, S in item[2]:
                graphs[item[1]].append((nt, S, host if host_count else None,
                                        False))
                host += S
        else:
            out.extend(graphs[item[1]])
    return out


def _reached(word, target):
    """A count that wraps at 2^32 has reached ``target`` (wait_reached)."""
    return (word - target) & MASK < 1 << 31


def _replay(P, layout, seq=None, entry_waits=_entry_waits, host_count=False,
            start=0, given_up_counts=False):
    """Every card starts its next launch the moment its last one ended
    (the blocks of one launch run together); cards take turns, each as
    far as it can, from each card first and in both block orders.  Each
    rank's handshake words and its count of ended blocks (HS_DONE) start
    at ``start``.  Returns the violations."""
    HS, DONE, ENDED = tring.HS_WORDS, tring.HS_DONE, tring.HS_ENDED
    launches = _run_order([("eager", ln) for ln in LAUNCHES]
                          if seq is None else seq, host_count)
    groups = tring.card_groups(layout)
    acc = sum(S for _nt, S, _b, gone in launches if not gone)
    violations = []
    for rotation in range(len(groups)):
        for reverse in (False, True):
            words = [{0: start, 1: start, DONE: start} for _ in range(P)]
            slots = {}
            cur = {c: 0 for c, _r in groups}

            def blocks_of(card, e):
                ntiles, S, base, gone = launches[e]
                ranks = dict(groups)[card]
                if gone:  # given up: no entry, no exit
                    return [{"rank": r, "k": k, "e": e, "S": S, "pc": 0,
                             "ops": [("count_out",)] if given_up_counts
                             else []}
                            for r in ranks for k in range(S)]
                return [{"rank": r, "k": k, "e": e, "S": S, "pc": 0,
                         "base": base,
                         "ops": _block_program(P, _tiles_of(ntiles, S, k))}
                        for r in ranks for k in range(S)]

            running = {c: blocks_of(c, 0) for c, _r in groups}

            def filled(r, k, s):
                return HS + 2 * k + s

            def ack(r, k, s, S):
                return HS + 2 * S + 2 * k + s

            def count_out(w, S):
                w[ENDED] = w.get(ENDED, 0) + 1
                if w[ENDED] == S:
                    w[ENDED] = 0
                    w[DONE] = (w[DONE] + S) & MASK

            def step(b):
                if b["pc"] >= len(b["ops"]):
                    return False
                op = b["ops"][b["pc"]]
                r, k, e, S = b["rank"], b["k"], b["e"], b["S"]
                w = words[r]
                tag = f"P={P} layout={layout} rot={rotation}: launch {e} " \
                      f"rank {r} stripe {k}"
                if op[0] == "entry":
                    base = w[DONE] if b["base"] is None else b["base"] + start
                    b["ops"][b["pc"] + 1:b["pc"] + 1] = [
                        ("hs", word, target & MASK)
                        for word, target in entry_waits(r, P, base)]
                elif op[0] == "hs":
                    if not _reached(w.get(op[1], 0), op[2]):
                        return False
                elif op[0] == "wait_ack":
                    if w.get(ack(r, k, op[1] % 2, S), 0) < op[1] // 2:
                        return False
                elif op[0] == "wait_filled":
                    if w.get(filled(r, k, op[1] % 2), 0) < op[1] // 2 + 1:
                        return False
                elif op[0] == "send":
                    dst = (r + 1) % P
                    key = (dst, k, op[1] % 2)
                    old = slots.get(key)
                    if old is not None and old["reads"] > 0:
                        violations.append(
                            f"{tag} hop {op[1]} overran rank {dst}'s slot "
                            f"(launch {old['e']} hop {old['hop']} unread)")
                    slots[key] = {"e": e, "hop": op[1], "reads": 1}
                    f = filled(dst, k, op[1] % 2)
                    words[dst][f] = words[dst].get(f, 0) + 1
                elif op[0] == "read":
                    got = slots.get((r, k, op[1] % 2))
                    if got is None or (got["e"], got["hop"]) != (e, op[1]):
                        violations.append(
                            f"{tag} read hop {op[1]} but the slot holds "
                            f"{None if got is None else (got['e'], got['hop'])}")
                    else:
                        got["reads"] -= 1
                elif op[0] == "signal_ack":
                    left = (r - 1) % P
                    a = ack(left, k, op[1] % 2, S)
                    words[left][a] = words[left].get(a, 0) + 1
                elif op[0] == "exit":
                    U, H = op[1], op[2]
                    if U:
                        for s in (0, 1):
                            want_f = sum(1 for h in range(H) if h % 2 == s)
                            want_a = sum(1 for h in range(H) if h % 2 == s
                                         and tring.tile_signals_ack(h, H))
                            for name, addr, want in (
                                    ("filled", filled(r, k, s), want_f),
                                    ("ack", ack(r, k, s, S), want_a)):
                                if w.get(addr, 0) != want:
                                    violations.append(
                                        f"{tag}: {name}[{s}] reads "
                                        f"{w.get(addr, 0)} at its end, not "
                                        f"{want}: a count is lost")
                                w[addr] = 0
                    for rank, word in _exit_counts(r, P):
                        words[rank][word] = (words[rank][word] + 1) & MASK
                    count_out(w, S)
                elif op[0] == "count_out":
                    count_out(w, S)
                b["pc"] += 1
                return True

            order = [c for c, _r in groups]
            order = order[rotation:] + order[:rotation]
            for _ in range(100_000):
                progressed = False
                for c in order:
                    while True:
                        moved = False
                        blocks = running[c][::-1] if reverse else running[c]
                        for b in blocks:
                            while step(b):
                                moved = True
                        done = all(b["pc"] >= len(b["ops"])
                                   for b in running[c])
                        if done and cur[c] + 1 < len(launches):
                            cur[c] += 1
                            running[c] = blocks_of(c, cur[c])
                            moved = True
                        if not moved:
                            break
                        progressed = True
                if all(cur[c] == len(launches) - 1 and all(
                        b["pc"] >= len(b["ops"]) for b in running[c])
                       for c in cur):
                    break
                if not progressed:
                    stuck = [(c, cur[c]) for c in cur]
                    violations.append(f"P={P} layout={layout} rot="
                                      f"{rotation}: DEADLOCK at {stuck}")
                    return violations
            end = (start + acc) & MASK
            for r in range(P):
                left = {k: v for k, v in words[r].items() if k >= HS and v}
                if left:
                    violations.append(f"P={P} layout={layout}: rank {r} "
                                      f"ends with flags {left}")
                got = (words[r][0], words[r][1], words[r][DONE])
                if got != (end,) * 3 or words[r].get(ENDED, 0):
                    violations.append(f"P={P} layout={layout}: rank {r}'s "
                                      f"handshake words and count {got}, "
                                      f"{words[r].get(ENDED)} ended, not "
                                      f"{end}")
    return violations


def _contiguous(P, group):
    return [r // group for r in range(P)]


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("group", range(1, 5))
def test_per_card_schedule_replay(P, group):
    for layout in (_contiguous(P, group),
                   [r % -(-P // group) for r in range(P)]):
        violations = _replay(P, layout)
        assert not violations, "\n".join(violations[:5])


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("group", range(1, 5))
def test_per_card_replay_of_captured_launches(P, group):
    """Eager launches and the replays of captured ones (each replayed at
    least 3 times) on one set of tables, a launch given up among them,
    from counts about to wrap at 2^32: the count read on the card holds
    every launch to its predecessor."""
    for layout in (_contiguous(P, group),
                   [r % -(-P // group) for r in range(P)]):
        for start in (0, MASK - 2):
            violations = _replay(P, layout, CAPTURED, start=start)
            assert not violations, "\n".join(violations[:5])


#: a broken entry handshake, and configurations where it must show
MUTATIONS = {
    "none": lambda my, P, base: [],
    "left_only": lambda my, P, base: [(0, base)],
    "one_block_short": lambda my, P, base: [(0, base - 1), (1, base - 1)],
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
@pytest.mark.parametrize("P,group", [(3, 1), (4, 1), (4, 2), (8, 2)])
def test_per_card_replay_catches_a_broken_handshake(P, group, mutation):
    violations = _replay(P, _contiguous(P, group),
                         entry_waits=MUTATIONS[mutation])
    assert violations, f"{mutation} went undetected at P={P}, group={group}"


@pytest.mark.parametrize("P,group", [(2, 1), (3, 1), (4, 1), (4, 2),
                                     (8, 2), (8, 1)])
def test_per_card_replay_catches_the_count_fixed_at_capture(P, group):
    """The count kept by the host and fixed in a launch's arguments at
    capture (the design before): a replay waits for its capture's count,
    and the launches after a capture for one the replays never match, so
    the schedule deadlocks or overruns; eager launches alone pass."""
    layout = _contiguous(P, group)
    assert not _replay(P, layout, host_count=True)
    violations = _replay(P, layout, CAPTURED, host_count=True)
    assert violations, f"the host's count went undetected at P={P}"


@pytest.mark.parametrize("P,group", [(3, 1), (4, 2), (8, 1)])
def test_per_card_replay_catches_a_given_up_launch_that_counts(P, group):
    """A launch given up touches nothing: were its blocks counted out,
    the next launch would wait for blocks that never ran."""
    violations = _replay(P, _contiguous(P, group), CAPTURED,
                         given_up_counts=True)
    assert any("DEADLOCK" in v for v in violations), violations[:3]


@pytest.mark.parametrize("P,group", [(3, 1), (4, 2), (8, 2), (8, 1)])
def test_per_card_replay_needs_the_right_neighbours_word(P, group):
    """What the schedule needs of the handshake is the right neighbour's
    word: a rank writes into its right neighbour's slots and filled
    flags, and into its left neighbour's ack only after it has read that
    neighbour's landing of the same launch.  The kernel waits on both
    words, as the TPU kernel's barrier waits on both neighbours."""
    assert not _replay(P, _contiguous(P, group),
                       entry_waits=lambda my, P, base: [(1, base)])


def test_per_card_replay_of_the_one_card_layout_needs_no_handshake():
    """With one card, its stream orders the launches: the replay passes
    even with no handshake (the one-launch path has none)."""
    assert not _replay(4, [0, 0, 0, 0], entry_waits=MUTATIONS["none"])
    assert not _replay(4, [0, 0, 0, 0], CAPTURED,
                       entry_waits=MUTATIONS["none"])


# ---------------------------------------------------------------------------
# make_hybrid_mesh and initialize_multihost against the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ici,dcn", [
    ({"tp": 4}, {"dp": 2}),
    ({"ici": 4}, {"dcn": 2}),
    ({"tp": 2, "sp": 2}, {"dp": 2}),
    ({"tp": 8}, {"dp": 1}),
    ({"tp": 1}, {"dp": 4, "pp": 2}),
    ({}, {}),
])
def test_make_hybrid_mesh_matches_jax(ici, dcn):
    want = jax_hybrid_mesh(ici, dcn)
    got = make_hybrid_mesh(ici, dcn, devices="cpu")
    assert got.axis_names == tuple(want.axis_names)
    assert got.sizes == tuple(want.devices.shape)
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids)
    assert got.device == torch.device("cpu")
    listed = make_hybrid_mesh(ici, dcn, devices=["cpu"] * 8)
    assert listed == got


def test_make_hybrid_mesh_refuses_several_cards_and_short_lists(
        monkeypatch):
    # a list naming several cards maps slot s to devices[s], as the JAX
    # function lays its device list over the grid (the cards are
    # resolved and checked for peer access as on a host that has them)
    from accl_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "resolve_devices",
                        lambda devs, n, what: [torch.device(d)
                                               for d in list(devs)[:n]])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    for ici, dcn in (({"tp": 2}, {"dp": 1}), ({"tp": 2}, {"dp": 2}),
                     ({"tp": 4}, {"dp": 2})):
        n = int(np.prod(list(ici.values()) + list(dcn.values())))
        want = jax_hybrid_mesh(ici, dcn, devices=jax.devices()[:n])
        got = make_hybrid_mesh(ici, dcn,
                               devices=[f"cuda:{i}" for i in range(n)])
        assert got.axis_names == tuple(want.axis_names)
        cards = np.vectorize(lambda d: d.index)(got.device_grid)
        np.testing.assert_array_equal(
            cards, np.vectorize(lambda d: d.id)(want.devices))
        assert got.device == torch.device("cuda:0")
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        make_hybrid_mesh({"tp": 4}, {"dp": 2}, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        jax_hybrid_mesh({"tp": 4}, {"dp": 2}, devices=jax.devices()[:2])


def test_initialize_multihost_dry_run_matches_jax(monkeypatch):
    monkeypatch.setenv("ACCL_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("ACCL_NUM_PROCESSES", "4")
    monkeypatch.setenv("ACCL_PROCESS_ID", "2")
    for kw in ({}, {"coordinator_address": "h:1", "process_id": 0,
                    "local_device_ids": (0, 1)},
               {"num_processes": 8}):
        got = bringup.initialize_multihost(dry_run=True, **kw)
        assert got == jax_multihost(dry_run=True, **kw)
    assert got["num_processes"] == 8 and got["process_id"] == 2
    for name in ("ACCL_COORDINATOR", "ACCL_NUM_PROCESSES",
                 "ACCL_PROCESS_ID"):
        monkeypatch.delenv(name)
    assert bringup.initialize_multihost(dry_run=True) \
        == jax_multihost(dry_run=True) == {}
    with pytest.raises(ACCLError, match="no coordinator_address"):
        bringup.initialize_multihost()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_JOIN = ("import sys; sys.path.insert(0, {root!r}); "
         "from accl_tpu_torch.utils.bringup import initialize_multihost; "
         "print(initialize_multihost(coordinator_address={addr!r}, "
         "num_processes=2, process_id=int(sys.argv[1]), timeout_s={t}))")


def test_two_process_rendezvous_on_localhost():
    """Two processes join at a TCPStore on localhost and both return
    their kwargs, inside 30 s."""
    addr = f"127.0.0.1:{_free_port()}"
    code = _JOIN.format(root=str(ROOT), addr=addr, t=T)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=T) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"'process_id': {i}" in out
        assert f"'coordinator_address': '{addr}'" in out


def test_rendezvous_names_the_process_that_never_came():
    addr = f"127.0.0.1:{_free_port()}"
    with pytest.raises(ACCLError, match=r"process\(es\) \[1\] never"):
        bringup.initialize_multihost(coordinator_address=addr,
                                     num_processes=2, process_id=0,
                                     timeout_s=2)


@pytest.mark.parametrize("threshold", [PLAIN, RING])
def test_sub_comms_async_window_shrink_and_abort_on_the_per_rank_world(
        threshold):
    """A sub communicator (its local ranks placed by their world ranks'
    devices), an async window the executor may batch, a shrink with every
    rank alive and an abort: results bitwise the one-card world's, a
    call on the aborted comm refused on every rank, and moves counted on
    the per-rank world's torch-op lanes only."""
    P = 4

    def fn(accl, rank):
        x = accl.create_buffer(N * P, np.float32)
        x.host[:] = _ints(N * P, rank, 8)
        x.sync_to_device()
        ys = [accl.create_buffer(N * P, np.float32) for _ in range(3)]
        out = []
        sub = (accl.create_communicator([1, 3]) if rank in (1, 3)
               else accl.reserve_communicator())
        if rank in (1, 3):
            accl.allreduce(x, ys[0], N * P, comm_id=sub)
            accl.allgather(x, ys[1], N, comm_id=sub)
            out += [ys[0].host.copy(), ys[1].host[:2 * N].copy()]
        reqs = [accl.allreduce(x, y, N * P, run_async=True,
                               function=ReduceFunction.MAX if i else
                               ReduceFunction.SUM)
                for i, y in enumerate(ys)]
        for req in reqs:
            assert req.wait(T)
            req.check()
        out += [y.host.copy() for y in ys]
        new = accl.shrink_communicator(0, window_s=0.2)
        accl.allreduce(x, ys[0], N * P, comm_id=new)
        out.append(ys[0].host.copy())
        if rank == 1:
            accl.abort(sub)
        accl.barrier()
        if rank in (1, 3):
            with pytest.raises(ACCLError, match="COMM_ABORTED"):
                accl.allreduce(x, ys[0], N * P, comm_id=sub)
        return out

    got = {}
    for name, kw in (("one", {}), ("cards", {"devices": ["cpu"] * P})):
        with CudaWorld(P, device="cpu", **kw) as w:
            w.engine.ring_threshold_bytes = threshold
            got[name] = w.run(fn, timeout=T)
            # every collective here rides the ring at threshold 0
            assert (w.engine.peer_moves > 0) == (name == "cards"
                                                 and threshold == PLAIN)
    _bitwise(got["one"], got["cards"], "sub comm, async, shrink")
