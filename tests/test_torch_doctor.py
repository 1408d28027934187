"""accl_tpu_torch.scripts.perf_doctor against scripts/perf_doctor.py, and
the port's retune drill (accl_tpu_torch.scripts.retune_smoke).

One input set made by the port — a metrics snapshot with link families,
merged flight dumps of a straggled EmuWorld, a retune history and an SLO
report with tenant link slices — goes through both doctors: the ``--out``
reports are equal, key for key, and so is the text they print.  The
``--ci`` schema gates fail malformed documents with the same words and
exit codes.  The drill, ``--backend emu``, exits 0.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from accl_tpu_torch import ReduceFunction
from accl_tpu_torch.scripts import perf_doctor

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = str(REPO / "bench" / "results" / "callrate_r12_plan_on.json")


def _jax_doctor():
    spec = importlib.util.spec_from_file_location(
        "_jax_perf_doctor", REPO / "scripts" / "perf_doctor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_DOCTOR = _jax_doctor()


def _run(mod, monkeypatch, *args) -> tuple:
    """``mod.main()`` with ``args``: (rc, stdout, stderr)."""
    monkeypatch.setattr(sys, "argv", ["perf_doctor", *map(str, args)])
    mod._FABRIC_CACHE.clear()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main()
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The port's artifacts: snapshot, flight dump, retunes, SLO."""
    from accl_tpu_torch.backends.emu import EmuWorld
    from accl_tpu_torch.observability import flight
    from accl_tpu_torch.observability import metrics as _metrics
    from accl_tpu_torch.observability import telemetry
    from accl_tpu_torch.observability.slo import SLOTracker
    from accl_tpu_torch.tuning.online import RetuneHistory

    d = tmp_path_factory.mktemp("doctor")
    saved = _metrics._default
    reg = _metrics._default = _metrics.MetricsRegistry()
    try:
        with EmuWorld(2, retry_max=0) as world:
            tenant = world.run(lambda a, r: a.create_communicator(
                [0, 1], tenant="decode"))[0]
            tracker = SLOTracker(
                [{"tenant": "decode", "collective": "allreduce",
                  "size_bucket": "*", "p50_us": 64.0, "p99_us": 1024.0,
                  "availability": 0.9, "track_errors": True}],
                registry=reg, fast_window=2, slow_window=4, min_calls=2)

            def body(accl, rank):
                send = accl.create_buffer_like(
                    np.arange(64, dtype=np.float32) + rank)
                recv = accl.create_buffer(64, np.float32)
                for _ in range(6):
                    if rank == 1:
                        time.sleep(0.002)
                    accl.allreduce(send, recv, 64, ReduceFunction.SUM,
                                   from_fpga=True, to_fpga=True)
                    accl.allreduce(send, recv, 64, ReduceFunction.SUM,
                                   comm_id=tenant)

            for _ in range(2):
                world.run(body)
                tracker.check()
            sampler = telemetry.TelemetrySampler(
                [dv.engine_stats for dv in world.devices], registry=reg,
                interval_s=30.0,
                link_sources=[(r, dv.link_stats)
                              for r, dv in enumerate(world.devices)])
            sampler.sample()
            fdump = d / "flight.json"
            fdump.write_text(json.dumps(flight.merge_flight_dumps(
                [a.flight_recorder.dump() for a in world.accls])))
            slo = tracker.doc()
            slo["link_matrices"] = {"decode": world.link_matrix(
                tenant="decode")}
        mdump = d / "metrics.json"
        mdump.write_text(json.dumps(reg.snapshot()))
    finally:
        _metrics._default = saved
    hist = RetuneHistory(8)
    trig = {"type": "sentinel", "collective": "allreduce",
            "dtype": "float32", "size_bucket": "<=256B", "axis": "p50_us",
            "ratio": 2.5, "kind": "latency", "live": 50.0,
            "baseline": 20.0}
    cell = "allreduce|float32|<=256B|2"
    hist.append({"kind": "cell", "trigger": trig, "opened_at": 1.0,
                 "cell": cell, "decision": "installed", "closed_at": 2.0,
                 "hypothesis": {"incumbent": "static",
                                "challenger": "flat", "shortlist": []},
                 "ab": {"incumbent_busbw_GBps": 1.0,
                        "challenger_busbw_GBps": 1.2, "ratio": 1.2},
                 "installed": {"algorithm": "flat"},
                 "reason": "flat beat static 1.2x in the interleaved A/B"})
    hist.append({"kind": "cell", "trigger": trig, "opened_at": 3.0,
                 "cell": cell, "decision": "rejected", "closed_at": 4.0,
                 "reason": "stale finding from before the install"})
    hist.append({"kind": "axis", "trigger": {"type": "link_matrix",
                                             "axis_scores": {}},
                 "opened_at": 5.0, "closed_at": 6.0,
                 "decision": "installed",
                 "hypothesis": {"axis_order_from": [0, 1],
                                "axis_order_to": [1, 0]},
                 "reason": "axis health re-ranked"})
    rdump = d / "retunes.json"
    rdump.write_text(json.dumps(hist.to_doc()))
    sdump = d / "slo.json"
    sdump.write_text(json.dumps(slo))
    return {"dir": d, "metrics": mdump, "flight": fdump, "retunes": rdump,
            "slo": sdump}


def test_report_equals_the_reference(inputs, monkeypatch, tmp_path):
    monkeypatch.delenv("ACCL_FABRIC", raising=False)
    reports, texts = {}, {}
    for side, mod in (("port", perf_doctor), ("jax", JAX_DOCTOR)):
        out = tmp_path / f"{side}.json"
        rc, text, err = _run(
            mod, monkeypatch, "--metrics", inputs["metrics"], "--flight",
            inputs["flight"], "--baseline", BASELINE, "--retunes",
            inputs["retunes"], "--slo", inputs["slo"], "--timeline",
            "--ci", "--out", out)
        assert rc == 0, (side, text, err)
        reports[side] = json.loads(out.read_text())
        texts[side] = text.replace(str(out), "<out>")
    report = reports["port"]
    assert report == reports["jax"]
    assert texts["port"] == texts["jax"]
    assert report["schema_errors"] == []
    for section in ("attribution", "overlap", "engine_telemetry",
                    "link_matrix", "sentinel", "retunes", "slo"):
        assert section in report, section
    d = next(iter(report["attribution"]["collectives"].values()))
    assert d["dominant_straggler"]["rank"] == 1
    assert "retune history" in texts["port"]
    assert "tenant decode" in texts["port"]


def _bad_retunes():
    ok = {"kind": "cell", "seq": 1, "decision": "installed",
          "trigger": {"type": "sentinel"}, "opened_at": 1.0,
          "closed_at": 2.0, "cell": "x"}
    return [
        {"format": "accl-retune-history", "version": 9, "episodes": []},
        {"format": "accl-retune-history", "version": 1, "episodes": {}},
        {"format": "accl-retune-history", "version": 1, "episodes": [
            dict(ok, seq="1"), dict(ok, kind="lane"),
            dict(ok, decision="maybe"), dict(ok, trigger={}),
            dict(ok, closed_at=None), dict(ok, cell=None)]},
        {"format": "something-else"},
        ["not", "a", "doc"],
    ]


def _bad_slos(good):
    a = json.loads(json.dumps(good))
    a["tenants"]["decode"]["verdict"] = "bogus"
    a["tenants"]["decode"]["budget_remaining"] = 7.5
    b = json.loads(json.dumps(good))
    b["version"] = 3
    b["tenants"]["decode"]["objectives"][0].pop("burn_fast")
    c = json.loads(json.dumps(good))
    c["link_matrices"]["decode"]["fields"]["fenced_drops"][0][0] = -1
    return [a, b, c, {"format": "accl-slo-report", "tenants": []}, {}]


@pytest.mark.parametrize("section", ["retunes", "slo"])
def test_ci_schema_drift_fails_with_the_reference_words(
        inputs, monkeypatch, tmp_path, section):
    docs = _bad_retunes() if section == "retunes" else \
        _bad_slos(json.loads(inputs["slo"].read_text()))
    for i, doc in enumerate(docs):
        path = tmp_path / f"bad{i}.json"
        path.write_text(json.dumps(doc))
        got = {}
        for side, mod in (("port", perf_doctor), ("jax", JAX_DOCTOR)):
            out = tmp_path / f"{side}{i}.json"
            rc, _, err = _run(mod, monkeypatch, f"--{section}", path,
                              "--ci", "--out", out)
            got[side] = (rc, json.loads(out.read_text())["schema_errors"],
                         err)
        assert got["port"][0] == got["jax"][0] == 2, (i, got)
        assert got["port"][1] == got["jax"][1] and got["port"][1], i
        assert got["port"][2] == got["jax"][2] and "Traceback" not in \
            got["port"][2]


def test_malformed_snapshot_and_no_inputs(monkeypatch, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"not": "a snapshot"}))
    rc, _, err = _run(perf_doctor, monkeypatch, "--ci", "--metrics", bad)
    assert rc == 2 and "SCHEMA ERROR" in err
    rc_j, _, err_j = _run(JAX_DOCTOR, monkeypatch, "--ci", "--metrics", bad)
    assert (rc, err) == (rc_j, err_j)
    with pytest.raises(SystemExit) as e:
        _run(perf_doctor, monkeypatch, "--ci")
    assert e.value.code == 2


def test_fail_on_findings_exits_one(inputs, monkeypatch):
    rc, _, _ = _run(perf_doctor, monkeypatch, "--slo", inputs["slo"],
                    "--retunes", inputs["retunes"], "--fail-on-findings")
    rc_j, _, _ = _run(JAX_DOCTOR, monkeypatch, "--slo", inputs["slo"],
                      "--retunes", inputs["retunes"], "--fail-on-findings")
    assert rc == rc_j


def test_retune_drill_emu_exits_zero(tmp_path):
    """The drill at its defaults.  The engine's NACK retransmission lane
    stalls on a loaded host (ROADMAP.md Queue 3), so the emulator runs
    with ACCL_RETRY_MAX=0 here, as the port's other emulator drives do."""
    import os

    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.scripts.retune_smoke",
         "--backend", "emu", "--ranks", "4", "--seed", "42",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**os.environ, "ACCL_RETRY_MAX": "0"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "retune_smoke: OK" in proc.stdout
    report = json.loads(
        (tmp_path / "retune_doctor_report.json").read_text())
    assert report["schema_errors"] == [] and "retunes" in report
    hist = json.loads((tmp_path / "retune_history.json").read_text())
    assert hist["format"] == "accl-retune-history" and hist["episodes"]
