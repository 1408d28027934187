"""accl_tpu_torch.utils (timing, profiling, checkpoint, bringup, wire,
compile_cache) and the graft entry, against the JAX package's utils.

The timer, the rank tables, the wire codec's bytes, the checkpoint files
(both ways: each package loads the other's) with the ``treedef`` text
held to ``jax.tree_util``'s own, and the error texts of the ported
checks are held to the reference; the profiler capture, the build cache,
the world bring-up, the resumed train and the dry run are run on the
CPU.
"""
import glob
import json
import os
import pathlib
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from accl_tpu.utils import bringup as jax_bringup
from accl_tpu.utils import checkpoint as jax_ckpt
from accl_tpu.utils import timing as jax_timing
from accl_tpu.utils import wire as jax_wire
from accl_tpu_torch import CudaWorld, ReduceFunction
from accl_tpu_torch.utils import Timer, get_logger, timed
from accl_tpu_torch.utils import bringup, checkpoint, compile_cache, wire
from accl_tpu_torch.utils.profiling import time_fn, xla_trace

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# timing and profiling
# ---------------------------------------------------------------------------

def test_timer_shape():
    t = Timer()
    t.start()
    time.sleep(0.01)
    t.end()
    us = t.durationUs()
    assert 5_000 <= us <= 5_000_000
    assert abs(t.duration_ns() - us * 1000) < 1e3
    assert t.duration_us() == us
    with Timer() as t2:
        time.sleep(0.002)
    assert t2.durationUs() >= 1_000
    public = {n for n in dir(jax_timing.Timer) if not n.startswith("_")}
    assert public <= {n for n in dir(Timer) if not n.startswith("_")}
    assert get_logger().name == "accl_tpu_torch"


def test_timed_and_time_fn():
    from accl_tpu_torch.utils import profiling

    results = {}
    with timed("block", results) as t:
        sum(range(1000))
    assert len(results["block"]) == 1 and results["block"][0] > 0
    assert results["block"][0] == t.duration_ns()
    assert profiling.timed is timed

    calls = []

    def f(x):
        calls.append(1)
        return {"y": [x * 2 + 1]}

    dt = time_fn(f, torch.ones(128), iters=3, warmup=1)
    assert dt > 0 and len(calls) == 4
    assert time_fn(f, torch.ones(8), iters=2, warmup=0, pipelined=True) > 0
    assert len(calls) == 6


def test_traced_window_captures_a_torch_profiler_trace(tmp_path,
                                                       monkeypatch):
    """traced_window(label, xla_logdir=) marks the window in the ACCL
    trace and writes a Chrome trace of it (the reference's names, a
    torch.profiler capture); ACCL_XLA_TRACE is the env form."""
    from accl_tpu_torch.observability import trace

    trace.enable()
    try:
        with trace.traced_window("mm", xla_logdir=str(tmp_path / "a")):
            torch.ones(64, 64) @ torch.ones(64, 64)
        monkeypatch.setenv("ACCL_XLA_TRACE", str(tmp_path / "b"))
        with trace.traced_window("mm2"):
            torch.ones(8) + 1
        monkeypatch.delenv("ACCL_XLA_TRACE")
        with trace.traced_window("off"):
            pass
        spans = [s.name for s in trace.collector().spans()]
    finally:
        trace.disable()
        trace.collector().clear()
    assert {"window:mm", "window:mm2", "window:off"} <= set(spans)
    for sub in ("a", "b"):
        (path,) = glob.glob(str(tmp_path / sub / "*.json"))
        doc = json.load(open(path))
        assert doc["traceEvents"], sub
    names = {e.get("name") for e in json.load(open(glob.glob(
        str(tmp_path / "a" / "*.json"))[0]))["traceEvents"]}
    assert any("mm" in str(n) or "matmul" in str(n) for n in names)
    with xla_trace(str(tmp_path / "c")):
        pass
    assert glob.glob(str(tmp_path / "c" / "accl_trace.*.json"))


def _launch(corr, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name,
            "args": {"correlation": corr}}


def _kernel(corr):
    return {"cat": "kernel", "name": "void k()",
            "args": {"correlation": corr}}


@pytest.mark.parametrize("events,want", [
    ([], (0, 0)),
    ([_launch(1), _kernel(1), _launch(2, "cudaLaunchCooperativeKernel"),
      _kernel(2)], (0, 2)),
    ([_launch(1), _kernel(1), _launch(2, "cudaLaunchCooperativeKernel")],
     (1, 2)),
    ([_launch(1, "cuLaunchKernel"), _launch(2, "cudaGraphLaunch"),
      {"cat": "cpu_op", "name": "aten::add", "args": {}}], (1, 1)),
])
def test_unrecorded_launches_counts_launches_without_a_kernel(events, want):
    from accl_tpu_torch.utils.profiling import unrecorded_launches

    assert unrecorded_launches({"traceEvents": events}) == want


def test_profiler_records_needs_a_card():
    """bench/profiler_records measures the card's profiler: with no card
    it exits before building a world."""
    from accl_tpu_torch.bench import profiler_records

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiler_records.main()


def test_check_kernel_records_warns_on_a_lossy_trace(tmp_path):
    """A trace whose host launches lack device records warns, naming the
    count and the file; a whole one does not."""
    import warnings

    from accl_tpu_torch.utils.profiling import check_kernel_records

    lossy, whole = tmp_path / "lossy.json", tmp_path / "whole.json"
    lossy.write_text(json.dumps({"traceEvents": [
        _launch(1), _kernel(1), _launch(2), _launch(3)]}))
    whole.write_text(json.dumps({"traceEvents": [_launch(1), _kernel(1)]}))
    with pytest.warns(RuntimeWarning, match=r"2 of 3 kernel launches"):
        assert check_kernel_records(str(lossy)) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert check_kernel_records(str(whole)) == 0


# ---------------------------------------------------------------------------
# compile cache: where the kernels build
# ---------------------------------------------------------------------------

@pytest.fixture
def _restore_build_dir():
    from accl_tpu_torch.ops import _build

    prev = _build.BUILD_DIR
    yield _build
    _build.BUILD_DIR = prev


def test_compile_cache_enable(tmp_path, _restore_build_dir):
    _build = _restore_build_dir
    d = compile_cache.enable(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache") and os.path.isdir(d)
    assert _build.BUILD_DIR == pathlib.Path(d)
    assert _build._target("ring").parent == pathlib.Path(d)


def test_compile_cache_env_override(tmp_path, monkeypatch,
                                    _restore_build_dir):
    target = str(tmp_path / "envcache")
    monkeypatch.setenv("ACCL_COMPILE_CACHE", target)
    assert compile_cache.enable() == target
    assert _restore_build_dir.BUILD_DIR == pathlib.Path(target)


def test_compile_cache_default_dir_is_per_user(monkeypatch,
                                               _restore_build_dir):
    import getpass

    d = compile_cache._default_dir()
    assert getpass.getuser() in os.path.basename(d)
    monkeypatch.delenv("ACCL_COMPILE_CACHE", raising=False)
    assert compile_cache.enable() == d


def test_compile_cache_unusable_dir_keeps_the_build(tmp_path,
                                                    _restore_build_dir):
    _build = _restore_build_dir
    prev = _build.BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert compile_cache.enable(str(blocker / "sub")) is None
    assert _build.BUILD_DIR == prev


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def _rank_rows(ranks):
    return [(r.ip, r.port, r.session, r.max_segment_size) for r in ranks]


def test_generate_ranks_equals_the_reference(tmp_path):
    for kw in ({}, {"base_port": 6000}, {"ips": ["10.0.0.1", "10.0.0.2"]},
               {"max_segment_size": 4096}):
        assert _rank_rows(bringup.generate_ranks(4, **kw)) == \
            _rank_rows(jax_bringup.generate_ranks(4, **kw))
    spec = tmp_path / "ranks.json"
    spec.write_text(json.dumps({"ranks": [
        {"ip": "10.1.0.1", "port": 7000}, {"session": 5},
        {"ip": "10.1.0.3", "max_segment_size": 2048}]}))
    assert _rank_rows(bringup.generate_ranks(0, rank_file=str(spec))) == \
        _rank_rows(jax_bringup.generate_ranks(0, rank_file=str(spec)))
    assert [d.value for d in bringup.Design] == [
        "emu-inproc", "emu-tcp", "cuda"]


def _allreduce_ones(accl, rank):
    a = accl.create_buffer_like(np.ones(8, np.float32))
    b = accl.create_buffer(8, np.float32)
    accl.allreduce(a, b, 8, ReduceFunction.SUM)
    return float(b.host[0])


def test_initialize_world_inproc_and_cuda():
    from accl_tpu_torch.backends.emu import EmuWorld

    with bringup.initialize_world(bringup.Design.EMU_INPROC, 2) as world:
        assert isinstance(world, EmuWorld)
        assert world.run(_allreduce_ones) == [2.0, 2.0]
    with bringup.initialize_world("cuda", 2, device="cpu") as world:
        assert isinstance(world, CudaWorld)
        assert world.engine.device.type == "cpu"
        assert world.run(_allreduce_ones) == [2.0, 2.0]
    if not torch.cuda.is_available():
        from accl_tpu_torch import ACCLError

        with pytest.raises(ACCLError, match="no CUDA device"):
            bringup.initialize_world(bringup.Design.CUDA, 2)
    with pytest.raises(ValueError):
        bringup.initialize_world("tpu", 2)


def _two_free_ports() -> int:
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            with socket.socket() as a, socket.socket() as b:
                a.bind(("127.0.0.1", base))
                b.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    pytest.fail("no two adjacent free localhost ports")


def test_initialize_world_tcp():
    from accl_tpu_torch.backends.emu import EmuRankTcp

    base = _two_free_ports()
    results, errors, nodes = {}, [], [None, None]

    def rank_main(r):
        try:
            node = nodes[r] = bringup.initialize_world(
                bringup.Design.EMU_TCP, 2, rank=r, base_port=base,
                call_timeout_s=30)
            assert isinstance(node, EmuRankTcp)
            node.accl.set_timeout(20_000_000)
            results[r] = _allreduce_ones(node.accl, r)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((r, e))

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for node in nodes:
        if node is not None:
            node.close()
    assert not errors, errors
    assert results == {0: 2.0, 1: 2.0}


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

FIELDS = [("count", 32), ("tag", 32), ("src", 32), ("seqn", 32),
          ("strm", 32), ("dst_session", 16), ("msg_type", 8), ("host", 8),
          ("vaddr", 64), ("comm_id", 32), ("compressed", 32), ("epoch", 32)]


def test_wire_codec_packs_byte_for_byte_as_the_reference():
    assert wire.HEADER_FMT == jax_wire.HEADER_FMT
    assert wire.HEADER_SIZE == jax_wire.HEADER_SIZE == 64
    assert wire.MSG_TYPES == jax_wire.MSG_TYPES
    rng = np.random.default_rng(11)
    for i in range(200):
        # in range, and (every 4th frame) past each field's width: both
        # codecs mask the same way
        kw = {name: int(rng.integers(0, 1 << (bits + (8 if i % 4 == 0
                                                      else 0)),
                                     dtype=np.uint64)
                        if bits + 8 < 64 else rng.integers(0, 1 << 62))
              for name, bits in FIELDS}
        payload = rng.bytes(int(rng.integers(0, 64)))
        got = wire.WireFrame(**kw, payload=payload).pack()
        want = jax_wire.WireFrame(**kw, payload=payload).pack()
        assert got == want
        back = wire.WireFrame.unpack(got)
        ref = jax_wire.WireFrame.unpack(want)
        assert vars(back) == vars(ref)
        assert back.type_name == ref.type_name
    with pytest.raises(ValueError) as e:
        wire.WireFrame.unpack(b"\x00" * 10)
    with pytest.raises(ValueError) as r:
        jax_wire.WireFrame.unpack(b"\x00" * 10)
    assert str(e.value) == str(r.value)


@pytest.mark.parametrize("name,build", [
    ("truncated_header", lambda: b"\x00" * (wire.HEADER_SIZE - 10)),
    ("unknown_msg_type", lambda: wire.WireFrame(msg_type=77).pack()),
])
def test_malformed_frame_rejected_engine_stays_live(name, build):
    """A malformed frame is rejected and counted, and the engine still
    runs an allreduce.  retry_max=0: under a loaded host the native
    engine's NACK lane can stall even a plain 2-rank allreduce on a fresh
    world, with or without the injected frame (ROADMAP.md Queue 3)."""
    from accl_tpu_torch.backends.emu import EmuWorld

    with EmuWorld(2, retry_max=0) as world:
        dev = world.devices[0]
        before = dev.frame_stats(publish=False)["rejected_frames"]
        assert dev.ingest_bytes(build()) == 1, name
        after = dev.frame_stats(publish=False)["rejected_frames"]
        assert after == before + 1, name
        # a well-formed control frame is consumed, not rejected
        hb = wire.WireFrame(msg_type=wire.MSG_TYPES["heartbeat"], src=1)
        assert dev.ingest_bytes(hb.pack()) == 0
        assert world.run(_allreduce_ones, timeout=30) == [2.0, 2.0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

TREES = [
    np.ones(2),
    {"b": [1.0, 2.0], "a": {"x": 1.0, "y": (2.0, 3.0)}},
    [None, 1.0, (), [], {}],
    {"z": None, "w": [np.zeros(3)]},
    (1.0,),
    {"a": [{"c": 1.0, "b": 2.0}]},
    None,
    {"A": 1.0, "a1": 2.0, "b_": 3.0, "blocks": [{"ln": 1.0}] * 2},
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_treedef_text_is_jax_tree_structure(i):
    tree = TREES[i]
    assert checkpoint.treedef_text(tree) == \
        str(jax.tree_util.tree_structure(tree))
    assert len(checkpoint._flatten(tree)) == \
        len(jax.tree_util.tree_leaves(tree))


def _cfgs():
    from accl_tpu.models import ModelConfig as JaxConfig
    from accl_tpu_torch.models import ModelConfig

    kw = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, d_head=8,
              d_ff=64)
    return JaxConfig(**kw), ModelConfig(**kw)


def _jax_params():
    from accl_tpu.models import init_params

    jcfg, _ = _cfgs()
    return init_params(np.random.default_rng(0), jcfg)


def _as_torch(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), tree)


def test_checkpoints_cross_over_both_ways(tmp_path):
    jparams = _jax_params()
    tparams = _as_torch(jparams)
    # the port writes, the JAX package reads
    checkpoint.save_pytree(str(tmp_path / "port"), tparams)
    got = jax_ckpt.load_pytree(str(tmp_path / "port"), jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the JAX package writes, the port reads (onto like's devices)
    jax_ckpt.save_pytree(str(tmp_path / "jax"), jparams)
    back = checkpoint.load_pytree(str(tmp_path / "jax"), tparams)
    for a, b in zip(checkpoint._flatten(tparams),
                    checkpoint._flatten(back)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)
    assert json.load(open(tmp_path / "port.json")) == \
        json.load(open(tmp_path / "jax.json"))


def test_bf16_checkpoints_store_the_reference_words(tmp_path):
    """A bfloat16 leaf is stored as the JAX package stores it (raw 2-byte
    words, dtype |V2): the port's file holds the same bytes as JAX's, and
    the port loads either file back as bfloat16, bitwise.  A float32
    `like` refuses the words with the reference's words."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, dtype=jnp.bfloat16),
             "b": jnp.asarray(x[0])}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "b": torch.from_numpy(x[0].copy())}
    jax_ckpt.save_pytree(str(tmp_path / "jax"), jtree)
    checkpoint.save_pytree(str(tmp_path / "port"), ttree)
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as p:
        assert j.files == p.files
        for k in j.files:
            assert j[k].dtype == p[k].dtype
            assert j[k].tobytes() == p[k].tobytes()
    assert json.load(open(tmp_path / "port.json")) == \
        json.load(open(tmp_path / "jax.json"))
    for tag in ("jax", "port"):
        back = checkpoint.load_pytree(str(tmp_path / tag), ttree)
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"].view(torch.int16),
                           ttree["w"].view(torch.int16))
        assert torch.equal(back["b"], ttree["b"])
    like32 = {"w": torch.from_numpy(x), "b": ttree["b"]}
    with pytest.raises(ValueError) as e:
        checkpoint.load_pytree(str(tmp_path / "port"), like32)
    assert str(e.value) == "checkpoint leaf 1 dtype |V2 != expected float32"


def test_port_model_params_roundtrip(tmp_path):
    """The port's split layout (tp=2: each split leaf a list of per-rank
    tensors) through save_pytree/load_pytree, bitwise, with ints and
    a None node beside."""
    from accl_tpu_torch.models import init_params

    _, cfg = _cfgs()
    params = init_params(np.random.default_rng(0), cfg, tp=2,
                         device="cpu")
    state = {"params": params, "step": torch.tensor(3), "ema": None}
    checkpoint.save_pytree(str(tmp_path / "p"), state)
    back = checkpoint.load_pytree(str(tmp_path / "p"), state)
    assert back["ema"] is None and int(back["step"]) == 3
    assert isinstance(back["params"]["blocks"][0]["wq"], list)
    for a, b in zip(checkpoint._flatten(state), checkpoint._flatten(back)):
        assert torch.equal(a, b)


def _errors(save, load, saved, like, tmp_path, tag):
    path = str(tmp_path / tag)
    save(path, saved)
    with pytest.raises(ValueError) as e:
        load(path, like)
    return str(e.value)


@pytest.mark.parametrize("case", ["n_leaves", "treedef", "shape", "dtype"])
def test_load_errors_keep_the_reference_words(tmp_path, case):
    a = {"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}
    like = {
        "n_leaves": {"w": np.ones((2, 3), np.float32)},
        "treedef": {"w": np.ones((2, 3), np.float32),
                    "c": np.zeros(3, np.float32)},
        "shape": {"w": np.ones((3, 2), np.float32),
                  "b": np.zeros(3, np.float32)},
        "dtype": {"w": np.ones((2, 3), np.float64),
                  "b": np.zeros(3, np.float32)},
    }[case]
    want = _errors(jax_ckpt.save_pytree, jax_ckpt.load_pytree, a, like,
                   tmp_path, "jax")
    got = _errors(checkpoint.save_pytree, checkpoint.load_pytree,
                  _as_torch(a), _as_torch(like), tmp_path, "port")
    assert got == want


def test_sharded_refusals_keep_the_reference_words(tmp_path):
    tree = {"w": torch.ones(4)}
    jtree = {"w": np.ones(4, np.float32)}
    for save, t in ((checkpoint.save_sharded, tree),
                    (jax_ckpt.save_sharded, jtree)):
        with pytest.raises(ValueError) as e:
            save("relative/ckpt", t)
        assert str(e.value) == \
            "sharded checkpoint path must be absolute: 'relative/ckpt'"
    path = os.path.join(str(tmp_path), "step_0")
    checkpoint.save_sharded(path, tree)
    msgs = []
    for save, t in ((checkpoint.save_sharded, tree),
                    (jax_ckpt.save_sharded, jtree)):
        with pytest.raises(ValueError) as e:
            save(path, t)  # an existing path is the recovery point
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "checkpoint path exists" in msgs[0]
    with pytest.raises(ValueError, match="must be absolute"):
        checkpoint.load_sharded("relative/ckpt", tree)
    assert not glob.glob(path + ".tmp-*")


def test_sharded_scalar_leaves(tmp_path):
    from accl_tpu_torch.models import init_params

    _, cfg = _cfgs()
    state = {"params": init_params(np.random.default_rng(0), cfg, tp=2,
                                   device="cpu"),
             "step": 7}
    path = os.path.join(str(tmp_path), "with_step")
    checkpoint.save_sharded(path, state)
    restored = checkpoint.load_sharded(path, state)
    assert int(restored["step"]) == 7
    for a, b in zip(checkpoint._flatten(state["params"]),
                    checkpoint._flatten(restored["params"])):
        assert torch.equal(a, b)


def test_resume_training_matches_uninterrupted(tmp_path):
    """Two steps, a checkpoint, two more: bitwise the same parameters and
    losses as four uninterrupted steps (save at step 2, restore onto the
    split layout, continue)."""
    from accl_tpu_torch.models import init_params, make_train_step
    from accl_tpu_torch.parallel import make_mesh

    _, cfg = _cfgs()
    mesh = make_mesh(dp=2, tp=2, device="cpu")
    params = init_params(np.random.default_rng(0), cfg, tp=2,
                         device="cpu")
    step, _ = make_train_step(mesh, cfg)
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)))
    for _ in range(2):
        params, _ = step(params, tokens)
    path = os.path.join(str(tmp_path), "resume")
    checkpoint.save_sharded(path, params)
    direct = []
    for _ in range(2):
        params, loss = step(params, tokens)  # in place
        direct.append(float(loss))
    resumed_params = checkpoint.load_sharded(path, params)
    resumed = []
    for _ in range(2):
        resumed_params, loss = step(resumed_params, tokens)
        resumed.append(float(loss))
    assert direct == resumed
    for a, b in zip(checkpoint._flatten(params),
                    checkpoint._flatten(resumed_params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the graft entry
# ---------------------------------------------------------------------------

def test_graft_entry_forward_matches_the_reference():
    import __graft_entry__ as jax_graft

    from accl_tpu_torch.scripts import graft_entry

    jfn, jargs = jax_graft.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape == (2, 64, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert graft_entry._pick_axes(8) == jax_graft._pick_axes(8)
    for n in (1, 2, 4, 6, 12, 30, 7, 8):
        assert graft_entry._pick_axes(n) == jax_graft._pick_axes(n)


def test_graft_entry_dryrun_on_the_cpu(capsys):
    from accl_tpu_torch.scripts import graft_entry

    out = graft_entry.dryrun_multichip(8, device="cpu")
    assert np.isfinite(out["loss"]) and np.isfinite(out["moe_loss"])
    text = capsys.readouterr().out
    for what in ("mesh={'dp': 2, 'tp': 2, 'sp': 2}", "moe dp=1 ep=8",
                 "pipeline dp=4 pp=2", "zigzag SP ring attention OK",
                 "windowed SP attention OK", "driver collectives"):
        assert what in text, what
