"""The port's regression sentinel and per-tenant SLO tracker
(accl_tpu_torch.observability.sentinel, .slo) held to the JAX package's
on identical inputs, exactly.

One ``observe_call`` stream, made from a seed with numpy (a healthy
phase, a latency cliff on one tenant, a burst of errors on another, a
bandwidth sag, and a recovery), is fed into each package's
``MetricsRegistry``; after every sweep both packages' ``SLOTracker.check``
return the same objectives, findings and report, deliver the same fresh
findings, and both ``Sentinel`` instances, armed on a
``Baseline.from_snapshot`` of the healthy phase, the same findings and
health verdict.  Also: ``quantile_us``, ``Baseline.load`` on the
committed bench records, the ``load_specs`` validation cases
(tests/test_slo.py:302), the env gates (unset: no object, no thread),
and the exporter's ``/slo`` endpoint.  No test reads a clock.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

from accl_tpu.observability import health as jhealth
from accl_tpu.observability import metrics as jmetrics
from accl_tpu.observability import sentinel as jsen
from accl_tpu.observability import slo as jslo
from accl_tpu_torch.observability import health as thealth
from accl_tpu_torch.observability import metrics as tmetrics
from accl_tpu_torch.observability import sentinel as tsen
from accl_tpu_torch.observability import slo as tslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 15

SPECS = [
    {"tenant": "decode", "collective": "allreduce", "size_bucket": "*",
     "availability": 0.99, "p50_us": 256.0, "p99_us": 1024.0},
    {"tenant": "prefill", "collective": "*", "size_bucket": "*",
     "availability": 0.95, "track_errors": True, "p99_us": 4096.0},
    {"tenant": "train", "collective": "allreduce", "size_bucket": "*",
     "availability": 0.99, "busbw_GBps": 2.0},
]

#: (sweeps, decode latency us, prefill error share, train latency us)
PHASES = ((5, 100.0, 0.0, 2000.0),     # healthy
          (4, 3000.0, 0.0, 2000.0),    # decode cliff
          (3, 100.0, 0.3, 2000.0),     # prefill errors
          (3, 100.0, 0.0, 40000.0),    # train bandwidth sag
          (5, 100.0, 0.0, 2000.0))     # recovery


def _stream(seed: int = SEED) -> list:
    """Per sweep, the list of observe_call argument tuples."""
    rng = np.random.default_rng(seed)
    sweeps = []
    for n, dec_us, err, train_us in PHASES:
        for _ in range(n):
            calls = []
            for _ in range(int(rng.integers(8, 16))):
                jitter = float(rng.uniform(0.8, 1.25))
                calls.append(("allreduce", "float32",
                              int(rng.choice([4096, 65536])),
                              dec_us * jitter * 1e3, 8, True, "decode"))
                calls.append(("allgather", "float32", 1 << 20,
                              300.0 * jitter * 1e3, 8,
                              bool(rng.uniform() >= err), "prefill"))
            for _ in range(4):
                calls.append(("allreduce", "float32", 64 << 20,
                              train_us * float(rng.uniform(0.9, 1.1)) * 1e3,
                              8, True, "train"))
            sweeps.append(calls)
    return sweeps


def _feed(reg, calls) -> None:
    for coll, dt, nbytes, ns, nranks, ok, tenant in calls:
        reg.observe_call(coll, dt, nbytes, ns, nranks, ok=ok, tenant=tenant)


HEALTHY = PHASES[0][0]


def test_slo_tracker_and_sentinel_match_reference_sweep_by_sweep():
    regs = {"jax": jmetrics.MetricsRegistry(),
            "port": tmetrics.MetricsRegistry()}
    kw = dict(fast_window=2, slow_window=6, fast_burn=8.0, slow_burn=2.0,
              min_calls=4, source="stream")
    trackers = {"jax": jslo.SLOTracker([dict(s) for s in SPECS],
                                       registry=regs["jax"], **kw),
                "port": tslo.SLOTracker([dict(s) for s in SPECS],
                                        registry=regs["port"], **kw)}
    delivered = {k: [] for k in trackers}
    for k, tr in trackers.items():
        tr.subscribe(delivered[k].append)
    sentinels = {}
    sen_delivered = {k: [] for k in trackers}
    verdicts = set()
    drift = False
    for i, calls in enumerate(_stream()):
        for reg in regs.values():
            _feed(reg, calls)
        got = {k: tr.check() for k, tr in trackers.items()}
        assert got["port"] == got["jax"], i
        assert trackers["port"].objectives == trackers["jax"].objectives
        assert trackers["port"].doc() == trackers["jax"].doc()
        verdicts.update(o["verdict"] for o in trackers["port"].objectives)
        if i + 1 == HEALTHY:
            bases = {
                "jax": jsen.Baseline.from_snapshot(regs["jax"].snapshot()),
                "port": tsen.Baseline.from_snapshot(regs["port"].snapshot())}
            assert bases["port"].entries == bases["jax"].entries
            sentinels = {
                "jax": jsen.Sentinel(bases["jax"], regs["jax"],
                                     p50_ratio=2.0, p99_ratio=3.0,
                                     bw_ratio=0.5, min_calls=20),
                "port": tsen.Sentinel(bases["port"], regs["port"],
                                      p50_ratio=2.0, p99_ratio=3.0,
                                      bw_ratio=0.5, min_calls=20)}
            for k, s in sentinels.items():
                s.subscribe(sen_delivered[k].append)
        elif sentinels:
            found = {k: s.check() for k, s in sentinels.items()}
            assert found["port"] == found["jax"], i
            drift = drift or bool(found["port"])
        assert regs["port"].snapshot()["gauges"] == \
            regs["jax"].snapshot()["gauges"], i
    assert delivered["port"] == delivered["jax"]
    assert sen_delivered["port"] == sen_delivered["jax"]
    # the stream walks the verdict ladder and trips the sentinel
    assert {"ok", "fast_burn", "exhausted"} <= verdicts
    assert drift
    assert regs["port"].snapshot()["counters"] == \
        regs["jax"].snapshot()["counters"]
    for k, s in sentinels.items():
        s.stop()
    assert regs["port"].snapshot()["gauges"]["accl_health"] == \
        thealth.HEALTH_OK


def test_sentinel_turns_health_slow_and_back():
    reg = tmetrics.MetricsRegistry()
    _feed(reg, [("allreduce", "float32", 4096, 100e3, 8, True, None)] * 30)
    sen = tsen.Sentinel(tsen.Baseline.from_snapshot(reg.snapshot()), reg,
                        min_calls=20)
    assert sen.check() == []
    assert reg.snapshot()["gauges"]["accl_health"] == thealth.HEALTH_OK
    _feed(reg, [("allreduce", "float32", 4096, 9000e3, 8, True, None)] * 60)
    assert {f["axis"] for f in sen.check()} >= {"p50_us", "p99_us"}
    assert reg.snapshot()["gauges"]["accl_health"] == thealth.HEALTH_SLOW
    assert reg.snapshot()["counters"]["sentinel/findings"] >= 2
    sen.stop()
    assert reg.snapshot()["gauges"]["accl_health"] == thealth.HEALTH_OK


@pytest.mark.parametrize("seed", range(4))
def test_quantile_us_matches_reference(seed):
    rng = np.random.default_rng(SEED + seed)
    hist = rng.integers(0, 50, len(tmetrics.LATENCY_BUCKETS_US) + 1).tolist()
    if seed == 0:
        hist = [0] * len(hist)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert tsen.quantile_us(hist, q) == jsen.quantile_us(hist, q)


@pytest.mark.parametrize("name", [
    "callrate_r12_plan_on.json", "callrate_r14_telemetry_on.json",
    "sweep_gate_baseline_r12.csv", "sweep_gate_baseline_r05.csv"])
def test_baseline_load_matches_reference(name, tmp_path):
    path = os.path.join(REPO, "bench", "results", name)
    want, got = jsen.Baseline.load(path), tsen.Baseline.load(path)
    assert got.entries == want.entries and got.source == want.source
    assert got.entries
    # the native form round-trips, and loads alike on both sides
    saved = got.save(str(tmp_path / "base.json"))
    assert tsen.Baseline.load(saved).entries == \
        jsen.Baseline.load(saved).entries == got.entries
    assert got.to_doc() == want.to_doc()


def test_baseline_load_reads_a_registry_snapshot(tmp_path):
    reg = tmetrics.MetricsRegistry()
    _feed(reg, _stream()[0])
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(reg.snapshot()))
    assert tsen.Baseline.load(str(path)).entries == \
        jsen.Baseline.load(str(path)).entries
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    with pytest.raises(ValueError, match="unrecognized baseline format"):
        tsen.Baseline.load(str(bad))


def _write_spec(tmp_path, doc, name="slo.json"):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def _valid_spec_doc():
    return {"format": "accl-slo-spec", "version": 1,
            "slos": [{"tenant": "decode", "collective": "allreduce",
                      "p50_us": 256.0},
                     {"tenant": "prefill", "availability": 0.9,
                      "track_errors": True}]}


def test_load_specs_round_trip_matches_reference(tmp_path):
    path = _write_spec(tmp_path, _valid_spec_doc())
    assert tslo.load_specs(path) == jslo.load_specs(path)


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d.update(format="nope"), "not an accl-slo-spec"),
    (lambda d: d.update(version=99), "version"),
    (lambda d: d.update(slos=[]), "non-empty"),
    (lambda d: d["slos"][0].pop("tenant"), "tenant"),
    (lambda d: d["slos"][0].update(availability=1.5), r"\(0, 1\)"),
    (lambda d: d["slos"][0].update(p50_us=-1.0), "must be > 0"),
    (lambda d: d["slos"][0].update({"p50_us": None}) or
     d["slos"][0].pop("p50_us"), "no objective"),
])
def test_load_specs_validation_errors_match_reference(tmp_path, mutate,
                                                      match):
    doc = _valid_spec_doc()
    doc["slos"] = doc["slos"][:1]
    mutate(doc)
    path = _write_spec(tmp_path, doc)
    with pytest.raises(ValueError, match=match) as got:
        tslo.load_specs(path)
    with pytest.raises(ValueError) as want:
        jslo.load_specs(path)
    assert str(got.value) == str(want.value)


def test_sentinel_env_gate(monkeypatch, tmp_path):
    tsen.stop_sentinel()
    try:
        monkeypatch.delenv("ACCL_SENTINEL", raising=False)
        assert tsen.ensure_sentinel_from_env() is None
        monkeypatch.setenv("ACCL_SENTINEL", "0")
        assert tsen.ensure_sentinel_from_env() is None
        # a baseline that does not load disables, never raises
        monkeypatch.setenv("ACCL_SENTINEL", str(tmp_path / "missing.json"))
        assert tsen.ensure_sentinel_from_env() is None
        assert tsen._sentinel is None
        base = tsen.Baseline({("allreduce", "float32", "4KiB", "*"):
                              {"p50_us": 10.0, "p99_us": 10.0,
                               "busbw_GBps": 0.0}}, "t")
        monkeypatch.setenv("ACCL_SENTINEL", "1")
        monkeypatch.setenv("ACCL_SENTINEL_BASELINE",
                           base.save(str(tmp_path / "b.json")))
        monkeypatch.setenv("ACCL_SENTINEL_INTERVAL_MS", "60000")
        reg = tmetrics.MetricsRegistry()
        s = tsen.ensure_sentinel_from_env(reg)
        assert s is not None and tsen.ensure_sentinel_from_env(reg) is s
        assert s.baseline.entries == base.entries
        thread = s._thread
        assert thread.name == "accl-sentinel" and thread.is_alive()
    finally:
        tsen.stop_sentinel()
    assert tsen._sentinel is None and not thread.is_alive()


def test_slo_env_gate(monkeypatch, tmp_path):
    tslo.stop_slo()
    try:
        monkeypatch.delenv("ACCL_SLO", raising=False)
        assert tslo.ensure_slo_from_env() is None
        monkeypatch.setenv("ACCL_SLO", "0")
        assert tslo.ensure_slo_from_env() is None
        monkeypatch.setenv("ACCL_SLO", str(tmp_path / "missing.json"))
        assert tslo.ensure_slo_from_env() is None
        reg = tmetrics.MetricsRegistry()
        monkeypatch.setenv("ACCL_SLO",
                           _write_spec(tmp_path, _valid_spec_doc()))
        monkeypatch.delenv("ACCL_SLO_INTERVAL_MS", raising=False)
        tr = tslo.ensure_slo_from_env(reg)
        assert tr is not None and tslo.tracker() is tr
        assert tslo.ensure_slo_from_env(reg) is tr
        assert tr._thread is None       # ACCL_SLO_INTERVAL_MS=0: no timer
    finally:
        tslo.stop_slo()
    assert tslo.tracker() is None


def _get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read())


def test_exporter_slo_endpoint(tmp_path, monkeypatch):
    tslo.stop_slo()
    thealth.stop_exporter()
    reg = tmetrics.MetricsRegistry()
    monkeypatch.setenv("ACCL_SLO", _write_spec(tmp_path, _valid_spec_doc()))
    monkeypatch.delenv("ACCL_SLO_INTERVAL_MS", raising=False)
    try:
        tr = tslo.ensure_slo_from_env(reg)
        _feed(reg, [("allreduce", "float32", 4096, 100e3, 4, True,
                     "decode")] * 10)
        exp = thealth.start_exporter(port=0, registry=reg)
        doc = _get_json(exp.port, "/slo")
        assert doc["format"] == jslo.SLO_REPORT_FORMAT
        assert doc["version"] == jslo.SLO_REPORT_VERSION
        assert doc["checks"] == 1          # the scrape drove a sweep
        assert doc["tenants"]["decode"]["verdict"] == "ok"
        assert set(doc["tenants"]) == {"decode", "prefill"}
        assert doc == tr.doc()
    finally:
        thealth.stop_exporter()
        tslo.stop_slo()
    # with no tracker armed the endpoint serves the empty document, and
    # /retunes the empty retune history (no tuner armed)
    try:
        exp = thealth.start_exporter(port=0, registry=reg)
        doc = _get_json(exp.port, "/slo")
        assert doc == {"format": jslo.SLO_REPORT_FORMAT,
                       "version": jslo.SLO_REPORT_VERSION, "checks": 0,
                       "specs": [], "tenants": {}, "findings_total": 0}
        assert _get_json(exp.port, "/retunes") == {
            "format": "accl-retune-history", "version": 1, "episodes": [],
            "dropped": 0, "total": 0}
    finally:
        thealth.stop_exporter()


def test_report_constants_match_reference():
    for name in ("SLO_REPORT_FORMAT", "SLO_REPORT_VERSION", "SLO_SPEC_FORMAT",
                 "SLO_SPEC_VERSION", "VERDICT_NAMES", "OBJECTIVE_AXES",
                 "OBJECTIVE_SCHEMA_KEYS"):
        assert getattr(tslo, name) == getattr(jslo, name), name
    assert tsen.Sentinel.WORSEN_RATIO == jsen.Sentinel.WORSEN_RATIO
    assert thealth.HEALTH_SLOW == jhealth.HEALTH_SLOW
