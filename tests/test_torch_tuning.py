"""The port's offline tuning (accl_tpu_torch.tuning, utils/topology.py
and the driver's table route) against the JAX package's.

- Fabric: shapes, groups, labels, env errors and link-matrix demotion
  equal to the JAX Fabric's; a measured matrix from a CudaWorld demotes
  the slowed axis.
- SelectionTable: round trip, the corruption errors word for word, and a
  table written by either package read by the other (the committed
  cuda_h100_p8.json too).
- lane_covers and algorithms_for: the port's emu lanes the JAX emu
  lanes, the port's cuda lanes the JAX tpu lanes, cell for cell.
- SelectionPolicy.install and hot_swap program the ring threshold and the
  compression policy TpuWorld does from one table; ACCL_TUNE=0 restores
  the static registers bit for bit.
- The table route: a cell won by fused arms the descriptor; a cell won by
  hierarchical routes through a composer, bitwise the flat call on
  integer data, with the reference's exclusions.
- HierarchicalComm's six collectives bitwise against flat on EmuWorld
  and CudaWorld(n, "cpu"); a composition captured as a plan replays
  bitwise and is fenced by abort and reset_errors.
- tune then compare on small worlds never ships a slower cell; the CLI;
  the ACCL_TUNE_ONLINE refusal.

Every world has 2-6 ranks and is closed inside its test; every wait is
30 s or less.
"""
import json
import os
import pathlib
import time

import numpy as np
import pytest

from accl_tpu import ACCLError as JACCLError
from accl_tpu.backends.emu import EmuWorld as JEmuWorld
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.tuning import Fabric as JFabric
from accl_tpu.tuning import SelectionTable as JTable
from accl_tpu.tuning import autotune as jauto
from accl_tpu.utils import topology as jtopo
from accl_tpu_torch import ACCLError, CudaWorld, ReduceFunction, TuningKey
from accl_tpu_torch.backends.emu import EmuWorld
from accl_tpu_torch.tuning import (
    Fabric,
    HierarchicalComm,
    SelectionPolicy,
    SelectionTable,
    TuneConfig,
    autotune,
    cli,
)
from accl_tpu_torch.utils import topology as ttopo

T = 30
TABLE = (pathlib.Path(__file__).resolve().parents[1] / "accl_tpu_torch"
         / "tuning" / "tables" / "cuda_h100_p8.json")
KINDS = pytest.mark.parametrize("kind", ["emu", "cuda"])


def _world(kind, nranks):
    if kind == "emu":
        # retry_max=0: on a loaded host the native engine's NACK
        # retransmission lane can stall two disjoint sub-comms' traffic
        # (both egress queues held for seconds under a NACK storm; the
        # same engine as the JAX package's, ROADMAP Queue 3), which the
        # composer's stages run side by side; these tests hold the
        # composer's results, not the retransmission lane
        return EmuWorld(nranks, devmem_bytes=128 << 20, n_egr_rx_bufs=32,
                        max_eager_size=16384, max_rendezvous_size=16 << 20,
                        retry_max=0)
    return CudaWorld(nranks, device="cpu")


def _hier(world, shape):
    fab = Fabric.for_world(world.nranks, shape=shape)
    return [HierarchicalComm(a, fab) for a in world.accls]


# ---------------------------------------------------------------------------
# the fabric model
# ---------------------------------------------------------------------------
FABRICS = [(8, (4, 2)), (8, (2, 4)), (6, (3, 2)), (8, (2, 2, 2)),
           (4, (1, 4)), (7, None), (8, None)]


def _fabric_view(f):
    return (f.nranks, f.shape, f.coords, f.axis_names, f.axis_order,
            f.trivial, f.within_axis(), f.spec(), repr(f),
            [f.groups(a) for a in range(len(f.shape))],
            [f.groups_complement(a) for a in range(len(f.shape))],
            f.within_groups(), f.across_groups(),
            [[f.link_axis(s, d) for d in range(f.nranks)]
             for s in range(f.nranks)],
            [[f.axis_of_link(s, d) for d in range(f.nranks)]
             for s in range(f.nranks)])


@pytest.mark.parametrize("nranks,shape", FABRICS)
def test_fabric_matches_the_reference(nranks, shape):
    assert _fabric_view(Fabric(nranks, shape)) == \
        _fabric_view(JFabric(nranks, shape))


def test_topology_helpers_match_the_reference():
    for n, shape in ((4, (2, 2)), (8, (4, 2)), (6, (3, 2)), (8, (2, 2, 2))):
        assert ttopo.grid_coords(n, shape) == jtopo.grid_coords(n, shape)
        for s in range(n):
            for d in range(n):
                for kw in ({"nranks": n, "shape": shape}, {"nranks": n},
                           {"coords": jtopo.grid_coords(n, shape)}, {}):
                    assert ttopo.link_axis(s, d, **kw) == \
                        jtopo.link_axis(s, d, **kw)
    for spec in ("4x2", "2X2x2", "8"):
        assert ttopo.parse_shape(spec) == jtopo.parse_shape(spec)
    for bad in ("4x-2", "bogus", "", "0x4"):
        with pytest.raises(ValueError) as e1:
            ttopo.parse_shape(bad)
        with pytest.raises(ValueError) as e2:
            jtopo.parse_shape(bad)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError) as e1:
        ttopo.grid_coords(9, (2, 4))
    with pytest.raises(ValueError) as e2:
        jtopo.grid_coords(9, (2, 4))
    assert str(e1.value) == str(e2.value)


def test_fabric_env_and_errors_match_the_reference(monkeypatch):
    monkeypatch.setenv("ACCL_FABRIC", "2x2")
    assert Fabric.for_world(4).shape == (2, 2)
    for spec, n in (("3x2", 4), ("bogus", 4)):
        monkeypatch.setenv("ACCL_FABRIC", spec)
        with pytest.raises(ACCLError) as e1:
            Fabric.for_world(n)
        with pytest.raises(JACCLError) as e2:
            JFabric.for_world(n, probe=False)
        assert str(e1.value) == str(e2.value)
    monkeypatch.delenv("ACCL_FABRIC")
    assert Fabric.for_world(8).shape == (2, 4)  # near-square default
    assert Fabric.for_world(7).trivial          # prime -> single axis
    for args, kw in (((0,), {}), ((4,), {"axis_names": ("x",)}),
                     ((4,), {"axis_order": (0, 0)})):
        with pytest.raises(ACCLError) as e1:
            Fabric(*args, shape=(2, 2) if args[0] else None, **kw)
        with pytest.raises(JACCLError) as e2:
            JFabric(*args, shape=(2, 2) if args[0] else None, **kw)
        assert str(e1.value) == str(e2.value)


def _matrix(P, waits=(), retrans=()):
    fields = {f: [[0] * P for _ in range(P)]
              for f in ("seek_wait_ns", "retrans_sent", "tx_bytes")}
    for s, d in waits:
        fields["seek_wait_ns"][s][d] = 5_000_000
    for s, d in retrans:
        fields["retrans_sent"][s][d] = 50
    return {"nranks": P, "comm": 0, "fields": fields}


@pytest.mark.parametrize("matrix", [
    _matrix(4, waits=((0, 1), (1, 0), (2, 3), (3, 2))),
    _matrix(4, retrans=((0, 2),)),
    _matrix(4),
    _matrix(8, waits=((0, 4), (5, 1))),
], ids=["slow_y", "lossy_x", "clean", "slow_x_2x4"])
def test_link_matrix_demotion_matches_the_reference(matrix):
    shape = (2, 2) if matrix["nranks"] == 4 else (2, 4)
    fab = Fabric.from_link_matrix(matrix, shape=shape)
    ref = JFabric.from_link_matrix(matrix, shape=shape, probe=False)
    assert _fabric_view(fab) == _fabric_view(ref)
    assert fab.axis_scores == ref.axis_scores
    with pytest.raises(ACCLError) as e1:
        Fabric.from_link_matrix({"nranks": 0})
    with pytest.raises(JACCLError) as e2:
        JFabric.from_link_matrix({"nranks": 0}, probe=False)
    assert str(e1.value) == str(e2.value)


def test_a_cuda_world_link_matrix_demotes_the_slowed_axis():
    """The measured pipeline on CudaWorld(4, "cpu"): pair communicators
    along y (0-1, 2-3), tenant-labelled, whose odd rank arrives late at
    each allreduce; the gang-assembly waits land on the y links, and the
    fabric built from the tenant's matrix moves the within role to x."""
    with CudaWorld(4, device="cpu") as w:
        def body(accl, rank):
            # the shared table gives each pair its own id: 1 and 2
            ids = [accl.create_communicator(pair, tenant="pairs")
                   if rank in pair else accl.reserve_communicator()
                   for pair in ([0, 1], [2, 3])]
            cid = ids[rank // 2]
            s = accl.create_buffer_like(np.ones(64, np.float32))
            r = accl.create_buffer(64, np.float32)
            for _ in range(3):
                if rank & 1:
                    time.sleep(0.02)
                accl.allreduce(s, r, 64, comm_id=cid)

        w.run(body, timeout=T)
        matrix = w.link_matrix(tenant="pairs")
    fab = Fabric.from_link_matrix(matrix, shape=(2, 2))
    assert fab.within_axis() == 0, (fab.axis_order, fab.axis_scores)
    assert fab.axis_scores["y"] > fab.axis_scores["x"] == 0
    assert _fabric_view(fab) == _fabric_view(
        JFabric.from_link_matrix(matrix, shape=(2, 2), probe=False))


# ---------------------------------------------------------------------------
# the selection table
# ---------------------------------------------------------------------------
def _toy_entries(nranks=4):
    return {
        f"allreduce|float32|<=64KiB|{nranks}": {
            "algorithm": "ring", "busbw_GBps": 1.0,
            "static_busbw_GBps": 0.5, "bytes": 65536},
        f"reduce|float32|<=64KiB|{nranks}": {
            "algorithm": "tree", "busbw_GBps": 1.0,
            "static_busbw_GBps": 0.5, "bytes": 65536},
        f"reduce|float32|<=1KiB|{nranks}": {
            "algorithm": "flat", "busbw_GBps": 1.0,
            "static_busbw_GBps": 0.9, "bytes": 1024},
    }


def _toy_table(nranks=4, backend="emu"):
    return SelectionTable(_toy_entries(nranks),
                          {"nranks": nranks, "backend": backend,
                           "dtype": "float32"})


def test_selection_table_round_trip_and_lookup(tmp_path):
    path = str(tmp_path / "t.json")
    table = _toy_table()
    table.save(path)
    loaded = SelectionTable.load(path)
    ref = JTable.load(path)
    assert loaded.entries == table.entries == ref.entries
    assert loaded.world == ref.world
    for coll, dtype, nbytes, n in (("allreduce", "float32", 40000, 4),
                                   ("allreduce", "float32", 40000, 8),
                                   ("allreduce", "float16", 40000, 4),
                                   ("reduce", "int32", 1000, 4),
                                   ("reduce", "float32", 1 << 20, 4)):
        assert loaded.lookup(coll, dtype, nbytes, n) == \
            ref.lookup(coll, dtype, nbytes, n)
    assert loaded.to_doc() == ref.to_doc()


def _corrupt_cases(tmp_path):
    bad = tmp_path / "bad.json"
    yield str(tmp_path / "missing.json")
    bad.write_text("{ not json")
    yield str(bad)
    for edit in ({"version": 99}, {"format": "something-else"},
                 {"entries": []},
                 {"entries": {"reduce|float32|<=1KiB|4":
                              {"algorithm": "warp"}}},
                 {"entries": {"reduce|float32|4": {"algorithm": "flat"}}}):
        doc = _toy_table().to_doc()
        doc.update(edit)
        bad.write_text(json.dumps(doc))
        yield str(bad)
    bad.write_text(json.dumps([1, 2]))
    yield str(bad)


def test_selection_table_corruption_errors_word_for_word(tmp_path):
    n = 0
    for path in _corrupt_cases(tmp_path):
        with pytest.raises(ACCLError) as e1:
            SelectionTable.load(path)
        with pytest.raises(JACCLError) as e2:
            JTable.load(path)
        assert str(e1.value) == str(e2.value)
        n += 1
    assert n == 8


def test_tables_cross_read_between_packages(tmp_path):
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    _toy_table(8, "cuda").save(ours)
    JTable(_toy_entries(8), {"nranks": 8, "backend": "tpu",
                             "dtype": "float32"}).save(theirs)
    assert JTable.load(ours).entries == _toy_entries(8)
    assert SelectionTable.load(theirs).entries == _toy_entries(8)
    assert pathlib.Path(ours).read_text() == \
        pathlib.Path(theirs).read_text().replace('"tpu"', '"cuda"')


def test_committed_card_table_reads_in_both_packages():
    ours, ref = SelectionTable.load(str(TABLE)), JTable.load(str(TABLE))
    assert ours.entries == ref.entries and ours.world == ref.world
    w = ours.world
    assert w["backend"] == "cuda" and w["nranks"] == 8
    assert "H100" in w["card"]["name"] and w["card"]["power_limit"].endswith(
        "W")
    colls = {k.split("|")[0] for k in ours.entries}
    assert colls == {"allreduce", "reduce_scatter", "allgather"}
    buckets = {k.split("|")[2] for k in ours.entries}
    assert buckets == {"<=1MiB", "<=4MiB", "<=16MiB", "<=64MiB"}
    cuda_lanes = {"static", "flat", "ring", "hierarchical", "fused",
                  *autotune.COMPRESSION_ALGS}
    for e in ours.entries.values():
        assert e["algorithm"] in cuda_lanes


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------
COLLS = ("allreduce", "reduce_scatter", "allgather", "bcast", "scatter",
         "gather", "reduce", "alltoall", "sendrecv")


def test_lane_covers_and_algorithms_match_the_reference():
    with EmuWorld(4) as ew, JEmuWorld(4) as jw:
        regs = ew.accls[0].static_tuning()
        assert regs == jw.accls[0].static_tuning()
        for dt in ("float32", "int32"):
            assert autotune.algorithms_for(ew, dt) == \
                jauto.algorithms_for(jw, dt)
    with CudaWorld(4, device="cpu") as cw, TpuWorld(4) as tw:
        assert autotune.backend_of(cw) == "cuda"
        assert autotune.backend_of(cw.accls[0]) == "cuda"
        assert jauto.backend_of(tw) == "tpu"
        for dt in ("float32", "int32"):
            assert autotune.algorithms_for(cw, dt) == \
                jauto.algorithms_for(tw, dt)
    checked = 0
    for alg in autotune.ALGORITHMS:
        for coll in COLLS:
            for P in (None, 4, 8):
                for pw in range(6, 27, 2):
                    nbytes = None if P is None else 1 << pw
                    assert autotune.lane_covers(
                        "emu", alg, coll, P, nbytes, regs) == \
                        jauto.lane_covers("emu", alg, coll, P, nbytes, regs)
                    assert autotune.lane_covers(
                        "cuda", alg, coll, P, nbytes) == \
                        jauto.lane_covers("tpu", alg, coll, P, nbytes)
                    checked += 1
    assert checked == len(autotune.ALGORITHMS) * len(COLLS) * 3 * 11
    assert autotune.ALGORITHMS == jauto.ALGORITHMS


# ---------------------------------------------------------------------------
# install, hot_swap, ACCL_TUNE=0
# ---------------------------------------------------------------------------
def _compression_view(pol):
    if pol is None:
        return None
    return (int(pol.dtype), pol.min_bytes, sorted(int(c) for c in
                                                  pol.collectives))


TABLES = {
    "ring": _toy_entries(4),
    "allgather_deflated": {**_toy_entries(4),
                           "allgather|float32|<=16KiB|4": {
                               "algorithm": "ring", "busbw_GBps": 1.0,
                               "static_busbw_GBps": 0.5, "bytes": 16384}},
    "compress": {
        "allreduce|float32|<=1MiB|4": {"algorithm": "compress_int8",
                                       "busbw_GBps": 1.0, "bytes": 1 << 20,
                                       "static_busbw_GBps": 0.5},
        "allgather|float32|<=4MiB|4": {"algorithm": "compress_int8",
                                       "busbw_GBps": 1.0, "bytes": 4 << 20,
                                       "static_busbw_GBps": 0.5},
        "reduce|float32|<=1MiB|4": {"algorithm": "compress_fp16",
                                    "busbw_GBps": 1.0, "bytes": 1 << 20,
                                    "static_busbw_GBps": 0.5}},
    "static": {"allreduce|float32|<=1MiB|4": {
        "algorithm": "static", "busbw_GBps": 1.0, "bytes": 1 << 20,
        "static_busbw_GBps": 1.0}},
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_install_programs_what_tpu_world_programs(name, tmp_path,
                                                  monkeypatch):
    path = str(tmp_path / "t.json")
    SelectionTable(TABLES[name], {"nranks": 4, "backend": "cuda",
                                  "dtype": "float32"}).save(path)
    monkeypatch.setenv("ACCL_TUNE_TABLE", path)
    with CudaWorld(4, device="cpu") as cw, TpuWorld(4) as tw:
        assert all(a._tune_policy is not None for a in cw.accls)
        assert cw.engine.ring_threshold_bytes == \
            tw.engine.ring_threshold_bytes
        assert cw.engine.tuning_registers == tw.engine.tuning_registers
        assert _compression_view(cw.accls[0].compression_policy) == \
            _compression_view(tw.accls[0].compression_policy)
        # hot_swap: drop each cell, then restore it, on both worlds
        for key in sorted(TABLES[name]):
            prevs = [a._tune_policy.hot_swap(a, key, None)
                     for a in (cw.accls[0], tw.accls[0])]
            assert prevs[0] == prevs[1] == TABLES[name][key]
            assert cw.engine.ring_threshold_bytes == \
                tw.engine.ring_threshold_bytes
            assert _compression_view(cw.accls[0].compression_policy) == \
                _compression_view(tw.accls[0].compression_policy)
            for a in (cw.accls[0], tw.accls[0]):
                a._tune_policy.hot_swap(a, key, prevs[0])
            assert cw.engine.ring_threshold_bytes == \
                tw.engine.ring_threshold_bytes


def test_explicit_compress_env_wins_over_the_table(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    SelectionTable(TABLES["compress"], {"nranks": 4}).save(path)
    monkeypatch.setenv("ACCL_TUNE_TABLE", path)
    monkeypatch.setenv("ACCL_COMPRESS", "0")
    with CudaWorld(4, device="cpu") as cw:
        assert cw.accls[0].compression_policy is None
        assert cw.accls[0]._tune_policy is not None


@KINDS
def test_tune_zero_restores_the_static_registers(kind, tmp_path,
                                                 monkeypatch):
    def registers(w):
        if kind == "cuda":
            return (w.engine.ring_threshold_bytes,
                    dict(w.engine.tuning_registers),
                    w.accls[0].compression_policy)
        return (w.accls[0].static_tuning(), w.accls[0].compression_policy)

    with _world(kind, 4) as w:
        static = registers(w)
    path = str(tmp_path / "t.json")
    SelectionTable({**TABLES["ring"], **TABLES["compress"]},
                   {"nranks": 4}).save(path)
    monkeypatch.setenv("ACCL_TUNE_TABLE", path)
    with _world(kind, 4) as w:
        assert registers(w) != static
    monkeypatch.setenv("ACCL_TUNE", "0")
    with _world(kind, 4) as w:
        assert all(a._tune_policy is None for a in w.accls)
        assert registers(w) == static


@KINDS
def test_policy_records_selections(kind, tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    _toy_table().save(path)
    monkeypatch.setenv("ACCL_TUNE_TABLE", path)
    with _world(kind, 4) as w:
        def body(accl, rank):
            s = accl.create_buffer_like(np.ones(256, np.float32))
            r = accl.create_buffer(256, np.float32)
            accl.reduce(s, r, 256, 0)
            return r.host[0] if rank == 0 else 0.0

        assert w.run(body, timeout=T)[0] == 4.0
        counters = w.accls[0].metrics()["counters"]
    assert counters.get("tuning/selected/flat", 0) >= 1


@KINDS
def test_missing_table_raises_the_reference_text(kind, monkeypatch):
    monkeypatch.setenv("ACCL_TUNE_TABLE", "/nonexistent/table.json")
    with pytest.raises(ACCLError) as e1:
        _world(kind, 2)
    with pytest.raises(JACCLError) as e2:
        jauto.policy_from_env()
    assert str(e1.value) == str(e2.value)
    assert "ACCL_TUNE_TABLE" in str(e1.value)


# ---------------------------------------------------------------------------
# the table route
# ---------------------------------------------------------------------------
def test_a_fused_cell_arms_the_descriptor():
    count = 256  # 1 KiB of fp32
    tab = SelectionTable(
        {autotune.cell_key("allreduce", "float32", "<=1KiB", 4): {
            "algorithm": "fused", "busbw_GBps": 1.0,
            "static_busbw_GBps": 0.5, "bytes": count * 4}},
        {"backend": "cuda", "nranks": 4, "dtype": "float32"})

    def run(fused):
        def fn(accl, rank):
            s = accl.create_buffer_like(
                np.arange(count, dtype=np.float32) * 0.25 + rank)
            r = accl.create_buffer(count, np.float32)
            accl.allreduce(s, r, count, fused=fused)
            return r.host.copy()
        return fn

    with CudaWorld(4, device="cpu") as w:
        for a in w.accls:
            a._tune_policy = SelectionPolicy(tab)
        served = w.run(run(None), timeout=T)
        plans = list(w.engine._gang_plans.values())
    assert plans and all(p["fn_key"][-1] for p in plans)  # the fused bit
    with CudaWorld(4, device="cpu") as w:
        forced = w.run(run(True), timeout=T)
    for a, b in zip(served, forced):
        assert a.tobytes() == b.tobytes()


def _hier_table(nranks=4, shape=(2, 2), order=None, count=24):
    """Every cell of _routed_program's calls (count elements of 4 bytes,
    the payload factor included) won by the hierarchical lane."""
    from accl_tpu_torch.observability.metrics import size_bucket

    entries = {autotune.cell_key(c, "float32", size_bucket(
        count * 4 * (nranks if c != "allreduce" else 1)), nranks): {
        "algorithm": "hierarchical", "busbw_GBps": 1.0,
        "static_busbw_GBps": 0.5, "bytes": count * 4}
        for c in ("allreduce", "reduce_scatter", "allgather")}
    world = {"nranks": nranks, "shape": list(shape), "dtype": "float32"}
    if order is not None:
        world["axis_order"] = list(order)
    return entries, world


def _routed_program(count, P):
    def fn(accl, rank):
        out = {}
        data = (np.arange(count * P) % 17 + rank * 3).astype(np.int32)
        s = accl.create_buffer_like(data)
        for coll in ("allreduce", "reduce_scatter", "allgather"):
            n_out = count * (P if coll == "allgather" else 1)
            r = accl.create_buffer(n_out, np.int32)
            if coll == "allgather":
                accl.allgather(s, r, count)
            else:
                getattr(accl, coll)(s, r, count, ReduceFunction.SUM)
            out[coll] = r.host.copy()
        return out
    return fn


@pytest.mark.parametrize("kind,order", [("emu", None), ("cuda", None),
                                        ("cuda", (0, 1))],
                         ids=["emu", "cuda", "cuda-demoted"])
def test_hierarchical_cells_route_through_a_composer(kind, order):
    count, P = 24, 4
    entries, meta = _hier_table(order=order)
    with _world(kind, P) as w:
        flat = w.run(_routed_program(count, P), timeout=T)
        for a in w.accls:
            a._tune_policy = SelectionPolicy(SelectionTable(entries, meta))
        routed = w.run(_routed_program(count, P), timeout=T)
        comps = [a._hier_comms for a in w.accls]
        assert all(len(c) == 1 and isinstance(next(iter(c.values())),
                                              HierarchicalComm)
                   for c in comps)
        # a fence retires the composers (accl_tpu/accl.py:741-746)
        w.run(lambda a, r: a.reset_errors(), timeout=T)
        assert not any(a._hier_comms for a in w.accls)
    for f, h in zip(flat, routed):
        for coll in f:
            assert f[coll].tobytes() == h[coll].tobytes(), coll


def test_the_route_keeps_the_reference_exclusions():
    """Async, device-resident and sub-communicator calls ride the flat
    path even in a hierarchical cell; so does a trivial fabric."""
    count, P = 24, 4
    entries, meta = _hier_table()
    with CudaWorld(P, device="cpu") as w:
        for a in w.accls:
            a._tune_policy = SelectionPolicy(SelectionTable(entries, meta))

        def fn(accl, rank):
            s = accl.create_buffer_like(np.full(count, rank, np.int32))
            r = accl.create_buffer(count, np.int32)
            accl.allreduce(s, r, count, run_async=True).wait(T)
            accl.allreduce(s, r, count, from_fpga=True)
            accl.allreduce(s, r, count, to_fpga=True)
            sub = accl.create_communicator(list(range(P)))
            accl.allreduce(s, r, count, comm_id=sub)
            return dict(accl._hier_comms)

        assert w.run(fn, timeout=T) == [{}] * P
    entries, meta = _hier_table(shape=(1, 4))
    with CudaWorld(P, device="cpu") as w:
        for a in w.accls:
            a._tune_policy = SelectionPolicy(SelectionTable(entries, meta))
        out = w.run(_routed_program(count, P), timeout=T)
        assert all(list(a._hier_comms.values()) == [False]
                   for a in w.accls)
    assert out[0]["allgather"].shape == (count * P,)


# ---------------------------------------------------------------------------
# HierarchicalComm against flat
# ---------------------------------------------------------------------------
@KINDS
@pytest.mark.parametrize("nranks,shape", [(4, (2, 2)), (6, (3, 2))],
                         ids=["2x2", "3x2"])
@pytest.mark.parametrize("count", [64, 7], ids=["divisible", "ragged"])
def test_hier_allreduce_bitwise_vs_flat(kind, nranks, shape, count):
    with _world(kind, nranks) as w:
        hier = _hier(w, shape)

        def body(accl, rank):
            data = (np.arange(count) % 13 + rank).astype(np.int32)
            s = accl.create_buffer_like(data)
            out = []
            for func in (ReduceFunction.SUM, ReduceFunction.MAX):
                h = accl.create_buffer(count, np.int32)
                f = accl.create_buffer(count, np.int32)
                hier[rank].allreduce(s, h, count, func)
                accl.allreduce(s, f, count, func)
                out.append((h.host.copy(), f.host.copy()))
            return out

        for pairs in w.run(body, timeout=T):
            for h, f in pairs:
                np.testing.assert_array_equal(h, f)


@KINDS
def test_hier_reduce_scatter_bitwise_vs_flat(kind):
    with _world(kind, 4) as w:
        hier = _hier(w, (2, 2))
        count = 5

        def body(accl, rank):
            data = (np.arange(count * 4) + rank * 100).astype(np.int32)
            s = accl.create_buffer_like(data)
            h = accl.create_buffer(count, np.int32)
            f = accl.create_buffer(count, np.int32)
            hier[rank].reduce_scatter(s, h, count)
            accl.reduce_scatter(s, f, count)
            return h.host.copy(), f.host.copy()

        for h, f in w.run(body, timeout=T):
            np.testing.assert_array_equal(h, f)


@KINDS
@pytest.mark.parametrize("order", [None, (0, 1)], ids=["default", "demoted"])
def test_hier_bcast_allgather_scatter_gather_bitwise(kind, order):
    with _world(kind, 4) as w:
        fab = Fabric(4, (2, 2), axis_order=order)
        hier = [HierarchicalComm(a, fab) for a in w.accls]
        assert all(h.swapped == (order is not None) for h in hier)
        count, root = 9, 2

        def body(accl, rank):
            out = {}
            b = accl.create_buffer_like(
                np.arange(count, dtype=np.float32)
                + (1000 if rank == root else 0))
            hier[rank].bcast(b, count, root)
            out["bcast"] = b.host.copy()
            s = accl.create_buffer_like(
                np.arange(count, dtype=np.float32) + rank * 10)
            g = accl.create_buffer(count * 4, np.float32)
            hier[rank].allgather(s, g, count)
            out["allgather"] = g.host.copy()
            sd = accl.create_buffer_like(
                np.arange(count * 4, dtype=np.float32)
                * (1 if rank == root else 0))
            sr = accl.create_buffer(count, np.float32)
            hier[rank].scatter(sd, sr, count, root)
            out["scatter"] = sr.host.copy()
            gr = (accl.create_buffer(count * 4, np.float32)
                  if rank == root else None)
            hier[rank].gather(s, gr, count, root)
            out["gather"] = gr.host.copy() if gr is not None else None
            return out

        res = w.run(body, timeout=T)
    agexp = np.concatenate([np.arange(count, dtype=np.float32) + rk * 10
                            for rk in range(4)])
    for rk in range(4):
        np.testing.assert_array_equal(
            res[rk]["bcast"], np.arange(count, dtype=np.float32) + 1000)
        np.testing.assert_array_equal(res[rk]["allgather"], agexp)
        np.testing.assert_array_equal(
            res[rk]["scatter"],
            np.arange(count * 4, dtype=np.float32)[rk * count:
                                                   (rk + 1) * count])
    np.testing.assert_array_equal(res[root]["gather"], agexp)


@KINDS
def test_hier_trivial_fabric_falls_back_flat(kind):
    with _world(kind, 2) as w:
        fab = Fabric.for_world(2, shape=(1, 2))
        hier = [HierarchicalComm(a, fab) for a in w.accls]
        assert fab.trivial and all(h.flat for h in hier)

        def body(accl, rank):
            s = accl.create_buffer_like(np.full(8, rank + 1.0, np.float32))
            r = accl.create_buffer(8, np.float32)
            hier[rank].allreduce(s, r, 8)
            return r.host.copy()

        for out in w.run(body, timeout=T):
            np.testing.assert_array_equal(out, np.full(8, 3.0))
    with pytest.raises(ACCLError, match="fabric covers 4 ranks"):
        with CudaWorld(2, device="cpu") as w:
            HierarchicalComm(w.accls[0], Fabric(4, (2, 2)))


def test_hier_composition_captured_as_plan_replays_and_is_fenced():
    """On the emulator (per-rank engines) a captured composition replays
    bitwise and is fenced by an abort of its inner communicator and by
    reset_errors, as in tests/test_tuning.py."""
    with _world("emu", 4) as w:
        hier = _hier(w, (2, 2))
        count = 48
        plans = [None] * 4

        def captured(accl, rank):
            s = accl.create_buffer_like(
                (np.arange(count) + rank).astype(np.int32))
            r = accl.create_buffer(count, np.int32)
            # validate=False: each rank's stages run on its own pair of
            # sub-comms, so no two ranks capture the same member set and
            # pooled validation would wait out its timeout (in the JAX
            # package too) before it checks each rank alone
            plans[rank] = accl.capture_plan(
                lambda a: hier[rank].allreduce(s, r, count), validate=False)
            first = r.host.copy()
            r.host[:] = 0
            plans[rank].replay()
            return first, r.host.copy()

        for first, replayed in w.run(captured, timeout=T):
            np.testing.assert_array_equal(first, replayed)
            np.testing.assert_array_equal(
                first, sum((np.arange(count) + q).astype(np.int32)
                           for q in range(4)))

        def abort_then_replay(accl, rank):
            # the first member of each inner group aborts it; its peer
            # waits for the propagated abort to land (its plans fenced)
            # before replaying, so no abort is still in flight when
            # reset_errors clears the flags
            inner = hier[rank]._inner_comm
            if rank == hier[rank]._inner_group[0]:
                accl.abort(inner)
            else:
                deadline = time.monotonic() + T
                while accl.device.plan_count() or \
                        accl.device.comm_epoch(inner) < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            with pytest.raises(ACCLError):
                plans[rank].replay()
            return True

        assert all(w.run(abort_then_replay, timeout=T))
        w.reset_errors()
        w.run(captured, timeout=T)
        w.reset_errors()

        def replay_after_reset(accl, rank):
            with pytest.raises(ACCLError):
                plans[rank].replay()
            return True

        assert all(w.run(replay_after_reset, timeout=T))


def test_hier_composition_capture_times_out_on_the_shared_engine():
    """On the shared-engine worlds the arm board pairs ranks by identical
    member unions (tpu.py:1016-1063), and each rank of a composition
    captures another union: the arm times out on CudaWorld with the text
    TpuWorld raises, naming the same missing ranks."""
    count = 48

    def run(world, fabric_cls, comm_cls):
        fab = fabric_cls(4, (2, 2))
        hier = [comm_cls(a, fab) for a in world.accls]

        def fn(accl, rank):
            s = accl.create_buffer_like(
                (np.arange(count) + rank).astype(np.int32))
            r = accl.create_buffer(count, np.int32)
            try:
                accl.capture_plan(lambda a: hier[rank].allreduce(s, r, count),
                                  validate=False, timeout_s=1)
            except Exception as e:  # noqa: BLE001 — compared across packages
                return str(e)
            return None

        return fn

    from accl_tpu.tuning import HierarchicalComm as JHier

    with CudaWorld(4, device="cpu") as w:
        got = w.run(run(w, Fabric, HierarchicalComm), timeout=T)
    with TpuWorld(4) as w:
        want = w.run(run(w, JFabric, JHier))
    assert got == want
    assert all(m.startswith("plan arm timed out after 1s waiting for "
                            "rank(s) [") for m in got)


# ---------------------------------------------------------------------------
# tune, compare, the CLI, the online knob
# ---------------------------------------------------------------------------
@KINDS
def test_tune_then_compare_never_ships_a_slower_cell(kind):
    with _world(kind, 4) as w:
        # cells of 4 and 16 KiB: compare rounds busbw to 4 decimals, so a
        # 256 B cell slower than ~8 ms on a loaded host reads 0 GB/s and
        # a ratio of 0 (as in the JAX package)
        cfg = TuneConfig(collectives=("allreduce", "reduce"),
                         count_pows=(10, 12), repetitions=1, shape=(2, 2),
                         measured_demotion=False)
        table = autotune.tune(w, cfg)
        assert table.world["backend"] == kind
        assert table.world["shape"] == [2, 2]
        assert table.entries
        for e in table.entries.values():
            assert e["algorithm"] in autotune.algorithms_for(w)
        rows = autotune.compare(w, table, cfg)
        assert len(rows) == len(table.entries)
        assert all(r["ratio"] >= 1.0 / 1.05 for r in rows), rows
        # the static registers stand after the sweep
        if kind == "cuda":
            assert w.engine.ring_threshold_bytes == int(
                os.environ.get("ACCL_RING_THRESHOLD", str(4 << 20)))
    fab = autotune.fabric_of_table(table, 4)
    assert fab.shape == (2, 2)


def test_fabric_of_table_matches_the_reference():
    for world in ({"shape": [2, 2], "axis_order": [0, 1]}, {"shape": [4, 2]},
                  {}, {"shape": [3, 3]}):
        tab = SelectionTable({}, dict(world))
        jtab = JTable({}, dict(world))
        for n in (4, 8):
            assert _fabric_view(autotune.fabric_of_table(tab, n)) == \
                _fabric_view(jauto.fabric_of_table(jtab, n))


def test_cli_writes_a_table_both_packages_read(tmp_path, monkeypatch):
    # the CLI widens an unset receive budget in os.environ; set it here,
    # so the change goes with the test
    monkeypatch.setenv("ACCL_DEFAULT_TIMEOUT", "30000000")
    out, rec = str(tmp_path / "t.json"), str(tmp_path / "rec")
    rc = cli.main(["--backend", "emu", "--ranks", "4", "--shape", "2x2",
                   "--collectives", "allreduce", "--pows", "12",
                   "--reps", "1", "--no-demotion", "--out", out,
                   "--record", rec])
    assert rc == 0
    ours, ref = SelectionTable.load(out), JTable.load(out)
    assert ours.entries == ref.entries and ours.entries
    assert ours.world["backend"] == "emu" and ours.world["dtypes"] == [
        "float32"]
    assert pathlib.Path(rec + ".csv").read_text().startswith("collective,")
    assert "gate: must be 0" in pathlib.Path(rec + ".md").read_text()


def test_cli_sizes_cells_by_payload_bytes():
    assert cli.pows_for("allreduce", [1, 64], 8, 4) == (18, 24)
    assert cli.pows_for("allgather", [1, 64], 8, 4) == (15, 21)
    assert cli.pows_for("reduce_scatter", [4], 8, 4) == (17,)
    with pytest.raises(SystemExit, match="not a power of two"):
        cli.pows_for("allgather", [1], 6, 4)


def test_cli_cuda_backend_needs_the_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("ACCL_DEFAULT_TIMEOUT", "30000000")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ACCLError, match="no CUDA device"):
        cli.main(["--backend", "cuda", "--ranks", "2",
                  "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


@KINDS
@pytest.mark.parametrize("value", ["1", "yes"])
def test_online_tuner_knob_is_refused(kind, value, monkeypatch):
    monkeypatch.setenv("ACCL_TUNE_ONLINE", value)
    with pytest.raises(ACCLError, match="Queue 1 item 9"):
        _world(kind, 2)
    for off in ("0", ""):
        monkeypatch.setenv("ACCL_TUNE_ONLINE", off)
        _world(kind, 2).close()


def test_tuning_register_twin_on_the_cpu_world():
    with CudaWorld(2, device="cpu") as w:
        a = w.accls[0]
        with pytest.raises(ACCLError, match="unknown tuning key 42"):
            a.set_tuning(42, 1)
        a.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES), 777)
        assert w.engine.ring_threshold_bytes == 777
        autotune.apply_algorithm(w, "flat")
        assert w.engine.ring_threshold_bytes == 0x7FFFFFFF
        autotune.apply_algorithm(w, "ring")
        assert w.engine.ring_threshold_bytes == 0
        autotune.apply_algorithm(w, "static")
        assert w.engine.ring_threshold_bytes == int(
            os.environ.get("ACCL_RING_THRESHOLD", str(4 << 20)))
