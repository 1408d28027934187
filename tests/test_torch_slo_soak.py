"""The port's per-tenant SLO soak (accl_tpu_torch.scripts.slo_soak, the
twin of scripts/slo_soak.py) on its EmuWorld(4): spike, kill, shrink,
join and grow inside budget, the starved control exhausts, and the
report round-trips through the port's perf_doctor --slo --ci."""
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_slo_soak_exits_zero_at_its_defaults(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.scripts.slo_soak",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "slo_soak: OK" in proc.stdout
    summary = json.loads((tmp_path / "slo_summary.json").read_text())
    assert "exhausted" not in summary["verdicts"].values()
    assert summary["control_verdict"] == "exhausted"
    report = json.loads((tmp_path / "slo_doctor_report.json").read_text())
    assert report["schema_errors"] == [] and "slo" in report
    for t in ("decode", "prefill"):
        assert f"tenant {t}" in proc.stdout
