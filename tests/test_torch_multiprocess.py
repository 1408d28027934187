"""The port over several processes of one host (CPU only, no card).

Two OS processes run ``accl_tpu_torch/scripts/run_multihost_rank.py``
(the twin of ``scripts/run_multihost_rank.py``): each joins through
``initialize_multihost``, builds ``make_hybrid_mesh({"ici": 4}, {"dcn":
2}, devices=["cpu"] * 4)`` (the dcn axis over the processes) and runs the
collectives on integer-valued float32 rows from a numpy seed, writing its
own members' results to an npz.  They are held bitwise to the JAX
functions under ``shard_map`` over this process's 8 virtual CPU devices,
slot s on device s, as the JAX package's multi-host test lays its mesh.
A second launch runs the dp 2 x tp 2 step with dp over the two
processes, SGD and AdamW, held bitwise to the port's one-process
``make_mesh(dp=2, tp=2, devices=["cpu"] * 4)`` step (itself held to JAX
in ``tests/test_torch_model_cards.py``).  A third kills one process in
the middle of an all-reduce: the other must raise ``ACCLError`` naming
it, and no shared file of the run may stay under ``/dev/shm``.  Three
launches in all; every child has 60 s.
"""
import glob
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.parallel.collectives as JC
from accl_tpu.parallel.mesh import make_hybrid_mesh as j_hybrid
from accl_tpu_torch import ACCLError
from accl_tpu_torch import models as M
from accl_tpu_torch.parallel import collectives as TC
from accl_tpu_torch.parallel import mesh as TM
from accl_tpu_torch.scripts import run_multihost_rank as RUN
from accl_tpu_torch.utils import bringup, ipc

ROOT = Path(__file__).resolve().parents[1]
T = 60
P, R = 8, 4
NAMES = ("hierarchical_all_reduce", "all_reduce", "ring_all_reduce",
         "all_gather", "reduce_scatter", "ppermute", "all_to_all",
         "broadcast", "scatter", "barrier")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out_dir, *args):
    """Two processes of the twin script on the CPU; their return codes,
    outputs and results (the MULTIHOST_RESULT objects)."""
    port = _free_port()
    env = {**os.environ, "ACCL_COORDINATOR": f"127.0.0.1:{port}",
           "ACCL_NUM_PROCESSES": "2", "ACCL_IPC_TIMEOUT": str(T - 10)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "accl_tpu_torch.scripts.run_multihost_rank",
         "--device", "cpu", "--out", str(out_dir), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "ACCL_PROCESS_ID": str(p)}) for p in range(2)]
    try:
        outs = [p.communicate(timeout=T)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for out in outs:
        got = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
               if line.startswith("MULTIHOST_RESULT ")]
        results.append(got[-1] if got else None)
    return [p.returncode for p in procs], outs, results


@pytest.fixture(scope="module")
def collectives_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    rcs, outs, results = _launch(out, "--mode", "collectives")
    for p in range(2):
        assert rcs[p] == 0, outs[p][-3000:]
        assert f"MULTIHOST_OK process={p}" in outs[p]
    arrays = [dict(np.load(out / f"proc{p}.npz")) for p in range(2)]
    return results, arrays


def _glob():
    return np.random.default_rng(RUN.SEED).integers(
        -64, 64, size=(P, RUN.ROW)).astype(np.float32)


def _jax_members(fn, x, axes=("rank",), shape=(P,)):
    """fn(member block) on each of P devices, slot s on device s (axes
    blocked row-major) -> [P, ...]."""
    mesh = Mesh(np.array(jax.devices()[:P]).reshape(shape), axes)
    spec = Pspec(axes if len(axes) > 1 else axes[0])
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=spec, out_specs=spec,
                              check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


JAX_FNS = {
    "hierarchical_all_reduce": lambda x: _jax_members(
        lambda v: JC.hierarchical_all_reduce(v, "ici", "dcn"), x,
        ("dcn", "ici"), (2, R)),
    "all_reduce": lambda x: _jax_members(
        lambda v: jax.lax.psum(v, ("dcn", "ici")), x, ("dcn", "ici"),
        (2, R)),
    "ring_all_reduce": lambda x: _jax_members(
        lambda v: JC.ring_all_reduce(v, "rank"), x),
    "all_gather": lambda x: _jax_members(
        lambda v: JC.all_gather(v, "rank"), x),
    "reduce_scatter": lambda x: _jax_members(
        lambda v: JC.reduce_scatter(v, "rank"), x),
    "ppermute": lambda x: _jax_members(
        lambda v: JC.ppermute(v, [(s, (s + 1) % P) for s in range(P)],
                              "rank"), x),
    "all_to_all": lambda x: _jax_members(
        lambda v: JC.all_to_all(v, "rank"), x),
    "broadcast": lambda x: _jax_members(
        lambda v: JC.broadcast(v, RUN.BCAST_ROOT, "rank"), x),
    "scatter": lambda x: _jax_members(
        lambda v: JC.scatter(v, RUN.SCATTER_ROOT, "rank"),
        x.reshape(P, P, -1)),
    "barrier": lambda x: _jax_members(lambda v: JC.barrier("rank"), x),
}


@pytest.mark.parametrize("name", NAMES)
def test_collective_across_processes_is_the_jax_function(collectives_run,
                                                         name):
    """Each member's result, from the process that holds it, bitwise the
    JAX function's on that member's device."""
    _results, arrays = collectives_run
    want = JAX_FNS[name](_glob())
    for s in range(P):
        proc = s // R
        got = arrays[proc][f"{name}/{s}"]
        assert got.dtype == want[s].dtype and np.array_equal(got, want[s]), \
            (name, s)
        assert f"{name}/{s}" not in arrays[1 - proc]


def _one_process_moves(name) -> int:
    """The port's one-process count of :func:`moves` for one call."""
    devs = [torch.device("cpu")] * P
    xs = [torch.from_numpy(row) for row in _glob()]
    calls = {
        "hierarchical_all_reduce": lambda: TC.hierarchical_all_reduce(
            [xs[:R], xs[R:]], devices=[devs[:R], devs[R:]]),
        "all_reduce": lambda: TC.all_reduce(xs, devices=devs),
        "ring_all_reduce": lambda: TC.ring_all_reduce(xs, devices=devs),
        "all_gather": lambda: TC.all_gather(xs, devices=devs),
        "reduce_scatter": lambda: TC.reduce_scatter(xs, devices=devs),
        "ppermute": lambda: TC.ppermute(
            xs, [(s, (s + 1) % P) for s in range(P)], devices=devs),
        "all_to_all": lambda: TC.all_to_all(xs, devices=devs),
        "broadcast": lambda: TC.broadcast(xs, RUN.BCAST_ROOT, devices=devs),
        "scatter": lambda: TC.scatter([x.view(P, -1) for x in xs],
                                      RUN.SCATTER_ROOT, devices=devs),
        "barrier": lambda: TC.barrier(xs, devices=devs),
    }
    TC.reset_moves()
    calls[name]()
    return TC.moves()


#: the crossings between the two processes each function makes, as the
#: docstrings of parallel/collectives.py count them: k = 4 members outside
#: member 0's (the root's) process, 4 x 4 pairs of members in two
#: processes
WANT_PROCESS_MOVES = {"hierarchical_all_reduce": R * 2 * 1,
                      "all_reduce": 2 * R, "ring_all_reduce": 0,
                      "all_gather": 2 * R * R, "reduce_scatter": 2 * R * R,
                      "ppermute": 2, "all_to_all": 2 * R * R,
                      "broadcast": R, "scatter": R, "barrier": 2 * R}


@pytest.mark.parametrize("name", NAMES)
def test_moves_across_processes_are_the_docstrings_counts(collectives_run,
                                                          name):
    """Every crossing between the processes is counted by both of them;
    the processes' moves add up to the one-process count plus those
    crossings (each of them counted twice)."""
    results, _arrays = collectives_run
    counts = [r["collectives"]["moves"][name] for r in results]
    for c in counts:
        assert c["process_moves"] == WANT_PROCESS_MOVES[name], (name, c)
    assert sum(c["moves"] for c in counts) == (
        _one_process_moves(name) + WANT_PROCESS_MOVES[name]), (name, counts)


def test_the_plain_ring_crosses_as_transport_messages(collectives_run):
    """Each process's transport took part in every crossing: the moves of
    the five move-based functions and, for the plain ring allreduce, one
    message a step and direction at each of the ring's two edges between
    the processes, P - 1 steps a phase, two phases."""
    results, _arrays = collectives_run
    ring = 2 * 2 * (P - 1)
    for r in results:
        assert r["process_crossings"] == ring + sum(
            WANT_PROCESS_MOVES.values())


def test_each_process_holds_its_own_slots(collectives_run):
    """Each process's slots, and the process functions' answers there
    (``jax.process_index``, ``jax.local_devices``, ``jax.devices``)."""
    results, _arrays = collectives_run
    for p, r in enumerate(results):
        assert r["process"] == p
        assert r["local_devices"] == ["cpu"]
        assert r["devices"] == ["cpu@process0", "cpu@process1"]
        assert r["local_slots"] == list(range(p * R, (p + 1) * R))
        assert r["device_grid"] == [
            "cpu" if s // R == p else f"cpu@process{s // R}"
            for s in range(P)]
    assert results[0]["session"] == results[1]["session"]


# ---------------------------------------------------------------------------
# the dp x tp step with dp over the processes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("step")
    rcs, outs, results = _launch(out, "--mode", "step", "--ranks", "2",
                                 "--config", "tiny")
    for p in range(2):
        assert rcs[p] == 0, outs[p][-3000:]
    arrays = [dict(np.load(out / f"proc{p}.npz")) for p in range(2)]
    cfg = RUN.step_config(M, "tiny", 2)
    params, tokens = RUN.step_inputs(M, cfg, "tiny", "cpu")
    mesh = TM.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    ref = RUN.run_steps(M, mesh, cfg, params, tokens, 2)
    return results, arrays, cfg, ref


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_dp_step_across_processes_is_the_one_process_step(step_run, opt):
    """Losses, every updated leaf and (AdamW) both moments of each dp
    member, bitwise the one-process mesh's same member."""
    results, arrays, cfg, ref = step_run
    want_bits = [int(v.view(torch.int32)) for v in ref[opt]["losses"]]
    for p in range(2):
        got = results[p]["step"][opt]
        assert got["member"] == p
        assert got["loss_bits"] == want_bits
        tree = ref[opt]["trees"][p]
        state = None if ref[opt]["state"] is None else ref[opt]["state"][p]
        leaves = RUN.step_leaves(M, cfg, tree, state)
        assert len(leaves) == len([k for k in arrays[p]
                                   if k.startswith(f"step/{opt}/")])
        for k, t in leaves.items():
            a = arrays[p][f"step/{opt}/{k}"]
            assert np.array_equal(a, t.detach().numpy()), (opt, p, k)
    # the step did move the parameters
    assert not np.array_equal(arrays[0][f"step/{opt}/p0"],
                              RUN.step_inputs(M, cfg, "tiny", "cpu")[0][
                                  "embed"].numpy())


# ---------------------------------------------------------------------------
# a peer lost in the middle of a collective
# ---------------------------------------------------------------------------
def test_a_killed_peer_is_named_and_leaves_no_shared_file(tmp_path):
    rcs, outs, results = _launch(tmp_path, "--mode", "die")
    assert rcs[1] == -9, outs[1][-2000:]
    assert rcs[0] == 3, outs[0][-3000:]
    assert "MULTIHOST_PEER_LOST process=0" in outs[0]
    died = results[0]
    assert "process 1" in died["died"] and "died" in died["died"]
    assert died["seconds"] < T - 10
    assert glob.glob(os.path.join(ipc.SHM_DIR, died["session"] + "*")) == []


# ---------------------------------------------------------------------------
# pure functions: the slots of a mesh over processes, against JAX
# ---------------------------------------------------------------------------
class _Peers:
    """A transport whose exchange returns every process's list: this
    process's, and ``k`` CPU devices for each other one."""

    def __init__(self, counts, me):
        self.counts, self.me = counts, me

    def exchange(self, key, value):
        return [value if q == self.me else json.dumps(["cpu"] * k).encode()
                for q, k in enumerate(self.counts)]


@pytest.mark.parametrize("ici,dcn,me", [
    ({"ici": 4}, {"dcn": 2}, 0), ({"ici": 4}, {"dcn": 2}, 1),
    ({"tp": 2, "sp": 2}, {"dp": 2}, 1), ({"tp": 2}, {"dp": 4}, 2),
    ({"ici": 8}, {"dcn": 1}, 0)], ids=str)
def test_slot_processes_are_jax_row_major_blocking(monkeypatch, ici, dcn, me):
    """Each slot's process, and this process's slots, where JAX's
    make_hybrid_mesh blocks a process-ordered device list row-major
    (device i of P devices held by process i // k)."""
    need = int(np.prod(list(ici.values()) + list(dcn.values())))
    nproc = max(2, dcn.get("dcn", dcn.get("dp", 1)))
    k = need // nproc
    monkeypatch.setitem(bringup._PROCESS, "id", me)
    monkeypatch.setitem(bringup._PROCESS, "count", nproc)
    monkeypatch.setattr(ipc, "_transport", _Peers([k] * nproc, me))
    mesh = TM.make_hybrid_mesh(ici, dcn, devices=["cpu"] * k)
    jmesh = j_hybrid(ici, dcn, devices=jax.devices()[:need])
    assert mesh.shape == dict(jmesh.shape)
    want = np.vectorize(lambda d: d.id // k)(jmesh.devices)
    assert np.array_equal(np.array(mesh.processes).reshape(mesh.sizes), want)
    assert mesh.local_slots == tuple(int(s) for s in np.flatnonzero(
        want.reshape(-1) == me))
    for s in range(need):
        d = mesh.slot_device(s)
        assert mesh.is_local(s) == (s // k == me)
        assert str(d) == ("cpu" if s // k == me else f"cpu@process{s // k}")


def test_one_process_without_initialize_multihost(monkeypatch):
    """Without initialize_multihost the process functions describe one
    process, as JAX's do, and a mesh holds every slot."""
    monkeypatch.setitem(bringup._PROCESS, "local", None)
    monkeypatch.setitem(bringup._PROCESS, "all", None)
    monkeypatch.setattr(bringup, "_STORE", None)
    assert (bringup.process_index(), bringup.process_count()) == (0, 1)
    assert bringup.local_devices() == [torch.device("cpu")]
    assert bringup.devices() == [bringup.ProcessDevice(0,
                                                       torch.device("cpu"))]
    mesh = TM.make_hybrid_mesh({"ici": 4}, {"dcn": 2}, devices=["cpu"] * 8)
    assert mesh.processes is None and mesh.local_slots == tuple(range(8))
    assert mesh.group_processes("dcn") == []


def test_tp_over_processes_raises_naming_the_axis(monkeypatch):
    """Only dp may cross processes: a tp group over two processes is
    refused by the step and by the placement."""
    monkeypatch.setitem(bringup._PROCESS, "id", 0)
    monkeypatch.setitem(bringup._PROCESS, "count", 2)
    monkeypatch.setattr(ipc, "_transport", _Peers([2, 2], 0))
    mesh = TM.make_mesh(tp=4, devices=["cpu"] * 2)
    assert mesh.group_processes("tp") == [(0, 1, 2, 3)]
    cfg = RUN.step_config(M, "tiny", 2)
    with pytest.raises(ACCLError, match="the tp axis spans several"):
        M.make_train_step(mesh, cfg)
    params, _tokens = RUN.step_inputs(M, cfg, "tiny", "cpu")
    with pytest.raises(ACCLError, match="the tp axis spans several"):
        M.place_params(params, cfg, mesh)
    dp_mesh = TM.make_mesh(dp=2, tp=2, devices=["cpu"] * 2)
    assert dp_mesh.group_processes("tp") == []
    assert dp_mesh.group_processes("dp") == [(0, 2), (1, 3)]


def test_a_member_of_another_process_needs_its_device():
    """``None`` stands for another process's member only with devices=
    naming it; a local member given as None is refused."""
    xs = [torch.ones(3), None]
    with pytest.raises(ValueError, match="devices="):
        TC.all_reduce(xs)
    with pytest.raises(ValueError, match="member 1 on cpu: None"):
        TC.all_reduce(xs, devices=["cpu", "cpu"])
    remote = bringup.ProcessDevice(1, torch.device("cpu"))
    assert TC.move(None, remote, src=remote) is None
    assert ipc.is_remote(remote) and not ipc.is_remote("cpu")
    assert str(remote) == "cpu@process1"


# ---------------------------------------------------------------------------
# the ring kernels' tables across processes (their bookkeeping; the
# launches run on the card only)
# ---------------------------------------------------------------------------
class _Tables:
    """Process 0's view of a transport to process 1, whose buffers have
    handles of their own (``"p1:<key>:<rank>"``)."""

    process = 0

    def __init__(self):
        self.next, self.keys, self.unmapped = 1 << 20, [], []

    def malloc(self, nbytes, card):
        self.next += nbytes
        return self.next - nbytes

    def export(self, ptr, card):
        return ptr.to_bytes(8, "little")

    def exchange(self, key, value):
        self.keys.append(key)
        theirs = {str(r): f"p1:{key}:{r}".encode().hex() for r in (2, 3)}
        return [value, json.dumps(theirs).encode()]

    def open(self, handle, card):
        return hash(handle) & 0xFFFFFFF

    def unmap(self, handle, card):
        self.unmapped.append(handle.decode())


class _Lib:
    @staticmethod
    def accl_ring_gate_new(out):
        out._obj.value = 4096
        return 0


def test_cross_process_tables_keep_the_flags_when_the_slots_grow(
        monkeypatch):
    """Each rank's flags are exchanged once; slots that a larger call
    outgrows are exchanged anew under the next generation, and only the
    other process's old slots are unmapped (its flags stay mapped: the
    kernels' handshake counts live there)."""
    from accl_tpu_torch.ops import ring

    monkeypatch.setattr(ring._build, "load", lambda name: _Lib)
    monkeypatch.setattr(ring, "_proc_tables", {})
    monkeypatch.setattr(ring, "_proc_table_ids", {})
    cuda0 = torch.device("cuda", 0)
    layout = ((0, cuda0), (0, cuda0), (1, cuda0), (1, cuda0))
    streams = {0: type("S", (), {"cuda_stream": 7})()}
    tr = _Tables()
    t1 = ring._proc_tables_for(tr, layout, streams, 1000)
    flags, slots = list(t1.flags), list(t1.slots)
    assert all(flags) and all(slots) and len(set(flags + slots)) == 8
    assert ring._proc_tables_for(tr, layout, streams, 800) is t1
    assert tr.keys == ["ring/0/flags", "ring/0/slots/0"]
    t2 = ring._proc_tables_for(tr, layout, streams, 4000)
    assert t2 is t1 and t2.flags == flags and t2.slot_bytes == 4000
    assert tr.keys == ["ring/0/flags", "ring/0/slots/0", "ring/0/slots/1"]
    assert tr.unmapped == ["p1:ring/0/slots/0:2", "p1:ring/0/slots/0:3"]
    assert t2.slots[:2] != slots[:2] and t2.slots[2:] != slots[2:]
    # another set of streams is another table set, numbered alike in
    # every process
    other = {0: type("S", (), {"cuda_stream": 9})()}
    assert ring._proc_tables_for(tr, layout, other, 1000).tid == 1


# ---------------------------------------------------------------------------
# an SPMD mismatch: two transports of one store, in two threads
# ---------------------------------------------------------------------------
def _transport_pair(monkeypatch):
    """Processes 0 and 1's transports over one localhost store, each made
    in its own thread (as two processes would make them)."""
    from datetime import timedelta

    from torch.distributed import TCPStore

    port = _free_port()
    monkeypatch.setitem(bringup._PROCESS, "address", f"127.0.0.1:{port}")
    monkeypatch.setenv("ACCL_IPC_TIMEOUT", "20")
    stores = [TCPStore("127.0.0.1", port, 2, p == 0, timedelta(seconds=20),
                       wait_for_workers=False) for p in range(2)]
    return _both_threads(lambda p: ipc.Transport(stores[p], p, 2))


def _both_threads(fn) -> list:
    """fn(0) and fn(1) in two threads: each one's result or exception."""
    import threading

    out = [None, None]

    def run(p):
        try:
            out[p] = fn(p)
        except Exception as e:  # noqa: BLE001 - returned to the test
            out[p] = e

    threads = [threading.Thread(target=run, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("case", ["launch", "messages"])
def test_an_spmd_mismatch_raises_at_its_first_crossing(monkeypatch, case):
    """Two processes that make different calls raise ``ACCLError`` naming
    each other at their first crossing, well inside the timeout: ring
    launches of different signatures, or each waiting for a message the
    other never sends.  Closing leaves no file of the session."""
    trs = _transport_pair(monkeypatch)
    try:
        assert all(isinstance(t, ipc.Transport) for t in trs), trs
        if case == "launch":
            got = _both_threads(lambda p: trs[p].arrive(1, 0x10 + p, True,
                                                        "ring_all_gather"))
            want = "made another call at launch 1"
        else:
            got = _both_threads(lambda p: trs[p].recv(1 - p, "cpu"))
            want = "the processes made different calls"
        # the first to see it names the mismatch; the other may see that
        # one give up first, and names it
        for p, e in enumerate(got):
            assert isinstance(e, ACCLError), (p, e)
            assert f"process {1 - p}" in str(e), str(e)
        assert any(want in str(e) for e in got), got
    finally:
        for t in trs:
            if isinstance(t, ipc.Transport):
                t.close()
    assert glob.glob(os.path.join(ipc.SHM_DIR, trs[0].session + "*")) == []
