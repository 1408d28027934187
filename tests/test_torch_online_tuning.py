"""The online tuner of accl_tpu_torch (tuning/online.py) against the JAX
package's (accl_tpu/tuning/online.py).

Mirrors every case of tests/test_online_tuning.py on the port's
``EmuWorld`` and on ``CudaWorld(..., device="cpu")`` (the JAX package's
``TpuWorld`` rung), and holds the port to the reference where both can
run the same input: ``bucket_bytes`` on every size-bucket label, the
lanes ``cell_candidates`` considers, and — with ``ab_cell`` and
``cell_candidates`` scripted to the same busbw in both packages — the
episode documents the same findings close (install, the stale sibling,
the genuine revert, cooldown, the hysteresis reject, the error and the
empty shortlist), field for field apart from their times.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import accl_tpu.tuning.autotune as jax_autotune
import accl_tpu.tuning.online as jax_online
import accl_tpu_torch.tuning.autotune as autotune
import accl_tpu_torch.tuning.online as online
from accl_tpu.backends.emu import EmuWorld as JaxEmuWorld
from accl_tpu.backends.tpu import TpuWorld
from accl_tpu.observability import metrics as jax_metrics
from accl_tpu_torch import ACCLError, CudaWorld, ReduceFunction
from accl_tpu_torch.backends.emu import EmuWorld
from accl_tpu_torch.observability import health as obs_health
from accl_tpu_torch.observability import metrics as _metrics
from accl_tpu_torch.observability.sentinel import Baseline, Sentinel
from accl_tpu_torch.tuning.autotune import SelectionTable, cell_key
from accl_tpu_torch.tuning.online import (
    DECISIONS,
    HISTORY_FORMAT,
    HISTORY_VERSION,
    OnlineTuner,
    RetuneHistory,
    history_doc,
    online_enabled,
    online_tuner,
)

PORT_WORLDS = {"emu": lambda n, **kw: EmuWorld(n, **kw),
               "cuda-cpu": lambda n, **kw: CudaWorld(n, device="cpu")}
#: the JAX world each port world is held to
JAX_WORLDS = {"emu": JaxEmuWorld, "cuda-cpu": TpuWorld}


def _finding(coll="allreduce", dtype="float32", bucket="<=16KiB",
             axis="p50_us", ratio=2.0, kind="latency"):
    return {"collective": coll, "dtype": dtype, "size_bucket": bucket,
            "axis": axis, "ratio": ratio, "kind": kind,
            "live": 100.0, "baseline": 50.0, "threshold": 1.5,
            "baseline_source": "test"}


def _tuner_threads():
    return [t for t in threading.enumerate()
            if t.name == "accl-online-tuner"]


# ---------------------------------------------------------------------------
# the off switch: unset = nothing constructed, dispatch untouched
# ---------------------------------------------------------------------------

def test_online_enabled_parsing(monkeypatch):
    for off in (None, "", "0", " 0 "):
        if off is None:
            monkeypatch.delenv("ACCL_TUNE_ONLINE", raising=False)
        else:
            monkeypatch.setenv("ACCL_TUNE_ONLINE", off)
        assert not online_enabled()
        assert not jax_online.online_enabled()
    monkeypatch.setenv("ACCL_TUNE_ONLINE", "1")
    assert online_enabled() and jax_online.online_enabled()


def test_knobs_and_schema_are_the_reference_ones():
    for name in ("ENV_ONLINE", "ENV_INTERVAL_MS", "ENV_COOLDOWN_S",
                 "ENV_HYSTERESIS", "ENV_REPS", "ENV_HISTORY",
                 "HISTORY_FORMAT", "HISTORY_VERSION", "DECISIONS"):
        assert getattr(online, name) == getattr(jax_online, name), name


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_unset_env_constructs_nothing(monkeypatch, kind):
    """Without the env knob there is no tuner object, no loop thread and
    no policy injected, and a collective's result is bitwise the same
    call with ACCL_TUNE_ONLINE=0."""
    monkeypatch.delenv("ACCL_TUNE_ONLINE", raising=False)
    monkeypatch.delenv("ACCL_TUNE_TABLE", raising=False)

    def fn(accl, rank):
        s = accl.create_buffer_like(
            np.random.default_rng(rank).standard_normal(64)
            .astype(np.float32))
        d = accl.create_buffer(64, np.float32)
        accl.allreduce(s, d, 64, ReduceFunction.SUM)
        return d.host.copy()

    with PORT_WORLDS[kind](2) as w:
        assert w.online_tuner is None
        assert online_tuner() is None
        assert all(getattr(a, "_tune_policy", None) is None
                   for a in w.accls)
        assert not _tuner_threads()
        unset = w.run(fn)
    monkeypatch.setenv("ACCL_TUNE_ONLINE", "0")
    with PORT_WORLDS[kind](2) as w:
        assert w.online_tuner is None
        zero = w.run(fn)
    for a, b in zip(unset, zero):
        assert a.tobytes() == b.tobytes()
    assert history_doc() == {"format": HISTORY_FORMAT,
                             "version": HISTORY_VERSION, "episodes": [],
                             "dropped": 0, "total": 0}


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_env_gate_arms_and_close_stops(monkeypatch, kind):
    """Armed with a 50 ms loop on an idle world: the loop turns, and
    close() stops it promptly."""
    monkeypatch.setenv("ACCL_TUNE_ONLINE", "1")
    monkeypatch.setenv("ACCL_TUNE_ONLINE_INTERVAL_MS", "50")
    w = PORT_WORLDS[kind](2)
    try:
        tuner = w.online_tuner
        assert tuner is not None and online_tuner() is tuner
        assert any(t.daemon for t in _tuner_threads())
        # every driver serves the ONE shared table through its policy
        assert all(a._tune_policy.table is tuner.table for a in w.accls)
        time.sleep(0.3)  # a few idle loop turns
    finally:
        t0 = time.monotonic()
        w.close()
        assert time.monotonic() - t0 < 10.0
    assert online_tuner() is None and w.online_tuner is None
    time.sleep(0.2)
    assert not _tuner_threads()


# ---------------------------------------------------------------------------
# audit ring + counters schema
# ---------------------------------------------------------------------------

def test_history_ring_bounded_with_stable_seq():
    h = RetuneHistory(maxlen=3)
    ref = jax_online.RetuneHistory(maxlen=3)
    for i in range(5):
        ep = h.append({"decision": "rejected", "i": i})
        assert ep == ref.append({"decision": "rejected", "i": i})
        assert ep["seq"] == i + 1
    doc = h.to_doc()
    assert doc == ref.to_doc()
    assert [e["i"] for e in doc["episodes"]] == [2, 3, 4]
    assert doc["dropped"] == 2 and doc["total"] == 5
    # seq survives the drop: the audit trail names evicted episodes
    assert [e["seq"] for e in doc["episodes"]] == [3, 4, 5]


def test_retune_counter_families_have_help():
    for fam in ("proposed", "verified", "installed", "rejected",
                "reverted"):
        name = f"accl_tuning_retunes_{fam}"
        assert _metrics.METRIC_HELP[name] == jax_metrics.METRIC_HELP[name]


def test_retunes_endpoint_serves_history(monkeypatch):
    obs_health.stop_exporter()
    monkeypatch.setenv("ACCL_METRICS_PORT", "0")
    try:
        exporter = obs_health.ensure_exporter_from_env()
        assert exporter is not None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/retunes",
                timeout=10) as resp:
            doc = json.loads(resp.read())
        assert doc == history_doc()
        assert doc["format"] == HISTORY_FORMAT
        assert doc["version"] == HISTORY_VERSION
        assert isinstance(doc["episodes"], list)
    finally:
        obs_health.stop_exporter()


# ---------------------------------------------------------------------------
# sentinel re-delivery (the revert path's signal)
# ---------------------------------------------------------------------------

def test_sentinel_worsen_ratio_redelivery():
    """A persisting finding is delivered once; re-delivered only when
    its drift worsens past WORSEN_RATIO; a cleared finding re-arms."""
    reg = _metrics.MetricsRegistry()
    s = Sentinel(Baseline({}, "test"), registry=reg, min_calls=1)
    deliveries = []
    s.subscribe(lambda fresh: deliveries.append(list(fresh)))
    script = [
        ([_finding(ratio=2.0)], 1),   # new -> delivered
        ([_finding(ratio=2.2)], 1),   # 2.2 < 2.0*1.25 -> suppressed
        ([_finding(ratio=2.6)], 2),   # worsened past 2.5 -> delivered
        ([], 2),                      # cleared -> key re-arms
        ([_finding(ratio=2.0)], 3),   # back -> delivered again
        # bandwidth drifts DOWNWARD; the fold must still re-deliver
        ([_finding(axis="busbw_GBps", ratio=0.5, kind="bandwidth")], 4),
        ([_finding(axis="busbw_GBps", ratio=0.45, kind="bandwidth")], 4),
        ([_finding(axis="busbw_GBps", ratio=0.3, kind="bandwidth")], 5),
    ]
    for findings, want in script:
        s.compare_snapshot = lambda snap, f=findings: list(f)
        s.check()
        assert len(deliveries) == want, (findings, deliveries)


def test_sentinel_subscriber_fault_never_kills_the_check():
    reg = _metrics.MetricsRegistry()
    s = Sentinel(Baseline({}, "test"), registry=reg, min_calls=1)
    seen = []
    s.subscribe(lambda fresh: (_ for _ in ()).throw(RuntimeError("boom")))
    s.subscribe(lambda fresh: seen.extend(fresh))
    s.compare_snapshot = lambda snap: [_finding()]
    s.check()
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the single-cell helpers, held to the reference
# ---------------------------------------------------------------------------

def test_bucket_bytes_equals_the_reference_on_every_label():
    labels = {_metrics.size_bucket(n) for n in
              [0, 1, 2, 3, 1000, 1024, 1025] + [1 << k for k in range(41)]
              + [(1 << k) + 1 for k in range(40)]}
    labels |= {"", "0B", "<=3XB", "16KiB", "<=16KiB ", "<=1PiB"}
    for label in sorted(labels):
        assert autotune.bucket_bytes(label) == \
            jax_autotune.bucket_bytes(label), label
    assert autotune.bucket_bytes("<=16KiB") == 16 << 10


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_cell_candidates_consider_the_reference_lanes(monkeypatch, kind):
    """Every lane cell_candidates measures, in order, with run_cell_lane
    scripted in both packages: the port's emu lanes are the JAX emu
    lanes, and cuda's are tpu's; the shortlist is sorted the same."""
    monkeypatch.setenv("ACCL_FABRIC", "4")
    cases = [("allreduce", 256), ("allreduce", 1 << 20),
             ("allgather", 4096), ("reduce_scatter", 1 << 18),
             ("bcast", 512)]
    seen = {"port": [], "jax": []}

    def scripted(side):
        def run(world, alg, coll, count, dtype, root=0, hier=None):
            seen[side].append((alg, coll, count))
            return 1e-3 * (1 + sum(map(ord, alg)) % 7)
        return run

    monkeypatch.setattr(autotune, "run_cell_lane", scripted("port"))
    monkeypatch.setattr(jax_autotune, "run_cell_lane", scripted("jax"))
    with PORT_WORLDS[kind](4) as pw, JAX_WORLDS[kind](4) as jw:
        for coll, count in cases:
            for excl in ((), ("static",)):
                got = autotune.cell_candidates(pw, coll, count,
                                               exclude=excl)
                want = jax_autotune.cell_candidates(jw, coll, count,
                                                    exclude=excl)
                assert got == want, (coll, count, excl)
    assert seen["port"] == seen["jax"] and seen["port"]


# ---------------------------------------------------------------------------
# episode state machine: cooldown / stale rejection / revert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_cooldown_and_stale_then_genuine_revert(kind):
    reg = _metrics.MetricsRegistry()
    with PORT_WORLDS[kind](2) as w:
        tuner = OnlineTuner(w, registry=reg, cooldown_s=60.0)
        key = cell_key("allreduce", "float32", "<=16KiB", 2)

        # (a) cell inside its cooldown window -> "cooldown" episode
        tuner._cooldown[key] = time.monotonic() + 60.0
        tuner.on_findings([_finding()])
        ep = tuner.step()
        assert ep["decision"] == "cooldown" and ep["cell"] == key
        assert reg.snapshot()["counters"].get(
            "tuning/retunes/rejected") == 1
        tuner._cooldown.pop(key)

        # (b) a finding queued BEFORE the install is the install
        # trigger's same-batch sibling, never its fallout -> rejected
        tuner.table.entries[key] = {"algorithm": "flat",
                                    "busbw_GBps": 1.0, "online": True}
        for a in w.accls:
            a._tune_policy._memo.clear()
        tuner.on_findings([_finding()])
        tuner._watch[key] = {"prev": None,
                             "installed_at": time.monotonic(),
                             "episode_seq": 7}
        ep = tuner.step()
        assert ep["decision"] == "rejected"
        assert "stale" in ep["reason"]
        assert key in tuner._watch  # the watch survives a stale hit

        # (c) a finding that arrives AFTER the install is the install's
        # fallout -> auto-revert to the pre-install entry
        tuner.on_findings([_finding()])
        ep = tuner.step()
        assert ep["decision"] == "reverted"
        assert ep["reverted_to"] == "static"
        assert ep["installed_episode"] == 7
        assert key not in tuner._watch
        assert key not in tuner.table.entries  # prev=None -> dropped
        assert tuner._cooldown[key] > time.monotonic()  # hard cooldown
        assert reg.snapshot()["counters"].get(
            "tuning/retunes/reverted") == 1


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_tuner_adopts_armed_table_and_fabric_meta(kind):
    """A tuner over a world armed with a tuned table serves THAT table
    (the incumbents) and composes over the table's recorded fabric."""
    with PORT_WORLDS[kind](4) as w:
        table = SelectionTable(
            {cell_key("allreduce", "float32", "<=1KiB", 4):
             {"algorithm": "flat", "busbw_GBps": 1.0}},
            {"nranks": 4, "backend": autotune.backend_of(w),
             "dtype": "float32", "shape": [2, 2], "axis_order": [0, 1]})
        for a in w.accls:
            a._tune_policy = autotune.SelectionPolicy(table)
        tuner = OnlineTuner(w, registry=_metrics.MetricsRegistry())
        assert tuner.table is table
        assert tuple(tuner.fabric.shape) == (2, 2)
        assert not tuner.fabric.trivial


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_fresh_tuner_fabric_follows_the_env(monkeypatch, kind):
    """No armed table: the fabric is Fabric.for_world's (ACCL_FABRIC,
    else the near-square default), the JAX tuner's without its device
    probe."""
    monkeypatch.setenv("ACCL_FABRIC", "4")
    with PORT_WORLDS[kind](4) as w:
        assert OnlineTuner(w, registry=_metrics.MetricsRegistry()) \
            .fabric.trivial
    monkeypatch.delenv("ACCL_FABRIC")
    with PORT_WORLDS[kind](4) as w:
        assert tuple(OnlineTuner(
            w, registry=_metrics.MetricsRegistry()).fabric.shape) == (2, 2)


def test_dtype_fallback_serves_float32_row():
    """Per-dtype tables: an unswept dtype borrows the float32 row; a
    swept dtype's genuinely-untuned cell stays None."""
    key32 = cell_key("allreduce", "float32", "<=16KiB", 4)
    t = SelectionTable({key32: {"algorithm": "flat"}},
                       {"nranks": 4, "backend": "emu"})
    assert t.lookup("allreduce", "bfloat16", 16384, 4)["algorithm"] \
        == "flat"
    assert t.lookup("allreduce", "float32", 1 << 20, 4) is None
    t.entries[cell_key("allreduce", "bfloat16", "<=1KiB", 4)] = {
        "algorithm": "tree"}
    t._dtypes = None
    # bfloat16 is now a SWEPT dtype: no borrowing for its other cells
    assert t.lookup("allreduce", "bfloat16", 16384, 4) is None


# ---------------------------------------------------------------------------
# held to the reference: the same scripted A/B closes the same episodes
# ---------------------------------------------------------------------------

#: (collective, bucket) -> (shortlist, (incumbent busbw, challenger busbw))
SCRIPT = {
    ("allreduce", "<=16KiB"): ([("flat", 2.0), ("tree", 1.5)],
                               (1.0, 2.0)),
    ("allgather", "<=64KiB"): ([("tree", 1.2)], (1.0, 1.02)),
    ("reduce_scatter", "<=4KiB"): ([], (0.0, 0.0)),
}


def _scripted(side, calls):
    from accl_tpu_torch.observability.metrics import size_bucket

    def nbytes(world, coll, count):
        return count * _metrics.payload_factor(coll, world.nranks) * 4

    def candidates(world, coll, count, dtype_name="float32", **kw):
        calls[side].append(("candidates", coll, count, kw["exclude"]))
        return list(SCRIPT[(coll, size_bucket(nbytes(world, coll,
                                                      count)))][0])

    def ab(world, incumbent, challenger, coll, count, dtype_name="float32",
           **kw):
        calls[side].append(("ab", incumbent, challenger, coll, count,
                            kw["repetitions"], kw["retries"]))
        return SCRIPT[(coll, size_bucket(nbytes(world, coll, count)))][1]

    return candidates, ab


def _episodes(tuner):
    f16 = _finding()
    f16_bw = _finding(axis="busbw_GBps", ratio=0.4, kind="bandwidth")
    out = []

    def step_all():
        while tuner.pending():
            out.append(tuner.step())

    tuner.on_findings([f16, f16_bw])     # install, then its stale sibling
    step_all()
    tuner.on_findings([f16])             # the install's fallout: revert
    step_all()
    tuner.on_findings([f16])             # hard cooldown after the revert
    step_all()
    tuner.on_findings([_finding(coll="allgather", bucket="<=64KiB")])
    step_all()                           # below the hysteresis: reject
    tuner.on_findings([_finding(coll="reduce_scatter", bucket="<=4KiB")])
    step_all()                           # no covering challenger
    tuner.on_findings([_finding(bucket="0B")])
    step_all()                           # names no measurable cell
    for ep in out:
        ep.pop("opened_at")
        ep.pop("closed_at")
    return out


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_scripted_episodes_equal_the_reference(monkeypatch, kind):
    calls = {"port": [], "jax": []}
    for side, mod in (("port", online), ("jax", jax_online)):
        cands, ab = _scripted(side, calls)
        monkeypatch.setattr(mod, "cell_candidates", cands)
        monkeypatch.setattr(mod, "ab_cell", ab)
    monkeypatch.setenv("ACCL_FABRIC", "2")
    docs, counters = {}, {}
    with PORT_WORLDS[kind](2) as pw, JAX_WORLDS[kind](2) as jw:
        for side, mod, reg_mod, w in (
                ("port", online, _metrics, pw),
                ("jax", jax_online, jax_metrics, jw)):
            reg = reg_mod.MetricsRegistry()
            tuner = mod.OnlineTuner(w, registry=reg, cooldown_s=60.0,
                                    hysteresis=1.05, repetitions=3)
            docs[side] = _episodes(tuner)
            counters[side] = {k: v for k, v in
                              reg.snapshot()["counters"].items()
                              if k.startswith("tuning/retunes/")}
            # the install was fenced on every rank, and reverted
            assert all(a._tune_policy.table is tuner.table
                       for a in w.accls)
            assert not tuner.table.entries
    assert [ep["decision"] for ep in docs["port"]] == [
        "installed", "rejected", "reverted", "cooldown", "rejected",
        "rejected", "error"]
    assert docs["port"] == docs["jax"]
    assert counters["port"] == counters["jax"]
    assert calls["port"] == calls["jax"]


@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_install_fences_captured_plans(monkeypatch, kind):
    """An install is fenced like abort: a plan captured before it raises
    on replay and launches nothing; a plan captured after it replays
    bitwise the eager call."""
    cands, ab = _scripted("port", {"port": []})
    monkeypatch.setattr(online, "cell_candidates", cands)
    monkeypatch.setattr(online, "ab_cell", ab)
    n = 64
    with PORT_WORLDS[kind](2) as w:
        tuner = OnlineTuner(w, registry=_metrics.MetricsRegistry())
        bufs, plans = {}, {}

        def capture(accl, rank):
            s = accl.create_buffer_like(np.full(n, rank + 1.0, np.float32))
            d = accl.create_buffer(n, np.float32)
            bufs[rank] = (s, d)
            plans[rank] = accl.capture_plan(
                lambda a: a.allreduce(s, d, n, ReduceFunction.SUM),
                timeout_s=20)
            return d.host.copy()

        w.run(capture)
        tuner.on_findings([_finding()])
        ep = tuner.step()
        assert ep["decision"] == "installed"

        def stale(accl, rank):
            with pytest.raises(ACCLError):
                plans[rank].replay()
            return True

        assert all(w.run(stale))
        eager = w.run(capture)

        def replay(accl, rank):
            plans[rank].replay()
            return bufs[rank][1].host.copy()

        for a, b in zip(eager, w.run(replay)):
            assert a.tobytes() == b.tobytes()
            np.testing.assert_array_equal(a, np.full(n, 3.0, np.float32))


# ---------------------------------------------------------------------------
# the drill: drift -> finding -> hypothesis -> A/B -> decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PORT_WORLDS))
def test_retune_drill_end_to_end(monkeypatch, kind):
    """The compressed retune_smoke drill on each world: the drift (seeded
    chaos on EmuWorld, a sleeping rank on CudaWorld) makes the sentinel
    fire, the tuner closes measured episodes, the post-decision dispatch
    is never-slower than the degraded state, and an install is fenced on
    every rank."""
    from accl_tpu_torch.observability import flight as _flight
    from accl_tpu_torch.scripts import retune_smoke

    # isolate the drill's call metrics from the rest of the suite
    reg = _metrics.MetricsRegistry()
    monkeypatch.setattr(_metrics, "_default", reg)
    monkeypatch.setenv("ACCL_DEFAULT_TIMEOUT", "30000000")
    # single-axis fabric: the drill verifies the control plane on the
    # register/compression lanes
    monkeypatch.setenv("ACCL_FABRIC", "4")
    # the engine's NACK lane stalls on a loaded host (ROADMAP.md Queue 3)
    monkeypatch.setenv("ACCL_RETRY_MAX", "0")
    backend = "emu" if kind == "emu" else "cuda"
    w = CudaWorld(4, device="cpu") if backend == "cuda" \
        else retune_smoke.make_world(backend, 4)
    try:
        out = retune_smoke.drill(
            w, backend, count=4096, warm=8, degraded=10, seed=42,
            chaos="seed=42,slow_rank=1:1000", registry=reg,
            log=lambda *_: None)
        episodes = out["episodes"]
        assert episodes
        for ep in episodes:
            assert ep["decision"] in DECISIONS
            assert ep["trigger"]["type"] == "sentinel"
            assert isinstance(ep["opened_at"], float)
            assert isinstance(ep["closed_at"], float)
            assert ep["cell"].startswith("allreduce|float32|")
        decisions = {ep["decision"] for ep in episodes}
        assert decisions & {"installed", "rejected"}, episodes
        assert out["p50_post_us"] <= out["p50_degraded_us"] * 1.5
        counters = reg.snapshot()["counters"]
        assert counters.get("tuning/retunes/proposed", 0) >= 1
        if "installed" in decisions:
            assert counters.get("tuning/retunes/installed", 0) >= 1
            assert counters.get("tuning/retunes/verified", 0) >= 1
            for a in w.accls:
                kinds = [r.collective for r in
                         a.flight_recorder.records()]
                assert _flight.RETUNE_EVENT in kinds
        doc = out["tuner"].history.to_doc()
        assert doc["format"] == HISTORY_FORMAT
        assert doc["version"] == HISTORY_VERSION
        assert len(doc["episodes"]) == len(episodes)
    finally:
        w.close()


def test_cuda_drill_without_a_card_fails(tmp_path):
    """--backend cuda on a machine with no card fails; it never runs the
    emulator instead."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.scripts.retune_smoke",
         "--backend", "cuda", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "retune_history.json").exists()
