"""accl_tpu_torch.scripts.accl_lint against scripts/accl_lint.py.

Record mode: the port's linter on ``tests/fixtures/lint_torch/`` (copies
of the JAX fixtures that import accl_tpu_torch) finds what the JAX
linter finds on ``tests/fixtures/lint/``: the same rule ids, severities,
ranks, call counts and exit codes.  Shadow mode: the clean program run
for real on the port's ``EmuWorld`` and a leaked async request run on a
CPU ``CudaWorld``, against the same programs run under the JAX linter on
the JAX package's ``EmuWorld``.  ``--strict``, ``--fail-on`` and
``--max-findings`` behave as the reference's.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import pytest

from accl_tpu_torch.scripts import accl_lint

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "tests" / "fixtures" / "lint"
FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
RECORD = ["clean_fixture", "desync_fixture", "deadlock_fixture",
          "param_mismatch_fixture", "subcomm_interleave_fixture",
          "leak_shadow_fixture"]


def _jax_lint():
    spec = importlib.util.spec_from_file_location(
        "_jax_accl_lint", REPO / "scripts" / "accl_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LINT = _jax_lint()


def _lint(mod, monkeypatch, tmp_path, script, *args) -> tuple:
    """(rc, findings as (code, severity, ranks), json doc, stdout)."""
    out = tmp_path / f"{mod.__name__}.{pathlib.Path(script).stem}.json"
    monkeypatch.setattr(sys, "argv", ["accl_lint", str(script),
                                      "--json", str(out), *args])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = mod.main()
    doc = json.loads(out.read_text())
    return (rc, [(f["code"], f["severity"], f["ranks"])
                 for f in doc["findings"]], doc, text.getvalue())


def _jax_twin(tmp_path, name) -> pathlib.Path:
    """The JAX package's copy of a port fixture: the JAX fixture itself,
    or (for the programs only the port's fixtures hold) the port file
    with accl_tpu_torch swapped for accl_tpu and CudaWorld for the JAX
    EmuWorld."""
    if (JAX_FIXTURES / f"{name}.py").exists():
        return JAX_FIXTURES / f"{name}.py"
    src = (FIXTURES / f"{name}.py").read_text()
    src = src.replace("from accl_tpu_torch import CudaWorld, ReduceFunction",
                      "from accl_tpu import ReduceFunction\n"
                      "from accl_tpu.backends.emu import EmuWorld")
    src = src.replace('CudaWorld(2, device="cpu")', "EmuWorld(2)")
    src = src.replace("accl_tpu_torch", "accl_tpu")
    src = src.replace("sys.path.insert(0, os.path.dirname(os.path."
                      "abspath(__file__)))",
                      f"sys.path.insert(0, {str(JAX_FIXTURES)!r})")
    path = tmp_path / f"{name}.py"
    path.write_text(src)
    return path


@pytest.mark.parametrize("name", RECORD)
def test_record_mode_equals_the_reference(name, monkeypatch, tmp_path):
    got = _lint(accl_lint, monkeypatch, tmp_path, FIXTURES / f"{name}.py")
    want = _lint(JAX_LINT, monkeypatch, tmp_path, _jax_twin(tmp_path, name))
    assert got[0] == want[0]
    assert got[1] == want[1]
    for key in ("mode", "ranks", "calls"):
        assert got[2][key] == want[2][key], key
    assert got[2]["mode"] == "record"
    expect = {"clean_fixture": [], "desync_fixture": ["desync-order"],
              "deadlock_fixture": ["deadlock-cycle"],
              "param_mismatch_fixture": ["param-mismatch"],
              "subcomm_interleave_fixture": ["subcomm-interleave-hazard"],
              "leak_shadow_fixture": ["leaked-request"] * 2}[name]
    assert [c for c, _, _ in got[1]] == expect
    assert got[0] == (1 if name not in ("clean_fixture",
                                        "leak_shadow_fixture") else 0)


@pytest.mark.parametrize("name", ["clean_shadow_fixture",
                                  "leak_shadow_fixture"])
def test_shadow_mode_equals_the_reference(name, monkeypatch, tmp_path):
    got = _lint(accl_lint, monkeypatch, tmp_path, FIXTURES / f"{name}.py",
                "--mode", "shadow")
    want = _lint(JAX_LINT, monkeypatch, tmp_path,
                 _jax_twin(tmp_path, name), "--mode", "shadow")
    assert got[2]["mode"] == want[2]["mode"] == "shadow"
    assert got[2]["ranks"] == want[2]["ranks"]
    assert got[2]["calls"] == want[2]["calls"] and got[2]["calls"]
    assert got[:2] == want[:2]
    if name == "clean_shadow_fixture":
        assert got[1] == [] and "no findings" in got[3]
    else:
        assert {c for c, _, _ in got[1]} == {"leaked-request"}


@pytest.mark.parametrize("args", [("--strict",), ("--fail-on", "warning"),
                                  ("--fail-on", "error"),
                                  ("--max-findings", "1")])
def test_gates_equal_the_reference(args, monkeypatch, tmp_path):
    name = "leak_shadow_fixture"
    got = _lint(accl_lint, monkeypatch, tmp_path, FIXTURES / f"{name}.py",
                *args)
    want = _lint(JAX_LINT, monkeypatch, tmp_path,
                 _jax_twin(tmp_path, name), *args)
    assert got[0] == want[0] == (0 if args[-1] in ("error", "1") else 1)
    assert got[1] == want[1]
    assert got[3].replace(str(FIXTURES / f"{name}.py"), "X") == \
        want[3].replace(str(_jax_twin(tmp_path, name)), "X")


def test_missing_accl_main_in_record_mode(monkeypatch, tmp_path):
    script = tmp_path / "no_main.py"
    script.write_text("x = 1\n")
    for mod in (accl_lint, JAX_LINT):
        monkeypatch.setattr(sys, "argv", ["accl_lint", str(script),
                                          "--mode", "record"])
        with pytest.raises(SystemExit, match="has no accl_main"):
            mod.main()
