"""accl_lint: static desync/deadlock/hazard linter for collective programs.

Port of ``scripts/accl_lint.py``.  Runs a user script under N simulated
ranks, captures every rank's collective program (op, comm, root, counts,
dtype pair, operand address ranges, async-ness), and prints the
severity-ranked findings of the cross-rank checker suite
(accl_tpu_torch/analysis/checks.py): issue-order desyncs, parameter
mismatches, send/recv deadlock cycles, invalid roots/peers, buffer
overlap and use-after-free, leaked async requests.  Exits 1 when any
ERROR survives (warnings too under ``--strict``).

Two capture modes (``--mode auto`` picks per script):

- **record** — the script exposes ``accl_main(accl, rank)``; it runs
  under a :class:`~accl_tpu_torch.analysis.record.LintWorld` (the
  no-execution LintDevice backend): microsecond-fast, no backend
  needed, but buffers stay zero — don't assert on payloads.  An
  optional module-level ``LINT_RANKS`` overrides ``--ranks``.
- **shadow** — any other script runs UNMODIFIED as ``__main__`` on its
  real backend (a port ``EmuWorld``, or a ``CudaWorld``) while a
  CaptureSession records the same facts.

Exit codes: 0 = clean at the selected gate; 1 = findings at or above
``--fail-on`` (errors always fail; ``--fail-on warning`` — or its
alias ``--strict`` — fails on warnings too; info never fails).

Usage:
    python -m accl_tpu_torch.scripts.accl_lint program.py [--ranks N]
        [--mode auto|record|shadow] [--json out.json]
        [--fail-on error|warning] [--strict]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import runpy
import sys


def _load_module(path: str):
    spec = importlib.util.spec_from_file_location("_accl_lint_target",
                                                  path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"accl_lint: cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_record(path: str, nranks: int):
    from ..analysis.record import LintWorld

    mod = _load_module(path)
    entry = getattr(mod, "accl_main", None)
    if entry is None:
        raise SystemExit(
            f"accl_lint: {path} has no accl_main(accl, rank) — use "
            f"--mode shadow for scripts with their own __main__")
    nranks = getattr(mod, "LINT_RANKS", nranks)
    world = LintWorld(nranks)
    world.run(entry)
    meta = {"mode": "record", "ranks": nranks,
            "calls": {str(r): len(p.calls)
                      for r, p in world.programs.items()},
            "programs": {str(r): p.to_dict()
                         for r, p in world.programs.items()}}
    return world.check(), meta


def run_shadow(path: str):
    from ..analysis.sanitizer import CaptureSession

    argv = sys.argv
    sys.argv = [path]
    try:
        with CaptureSession() as cap:
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    meta = {"mode": "shadow", "ranks": len(cap.programs),
            "calls": {str(r): len(p.calls)
                      for r, p in cap.programs.items()},
            "programs": {str(r): p.to_dict()
                         for r, p in cap.programs.items()}}
    return cap.check(), meta


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="accl_lint",
        description="static desync/deadlock linter for ACCL collective "
                    "programs",
        epilog="exit codes: 0 = no finding at or above the --fail-on "
               "severity (info-level findings never fail); 1 = at "
               "least one ERROR (always), or at least one WARNING "
               "with --fail-on warning / --strict; 2 = usage error "
               "(argparse).  A crash while importing or running the "
               "target script propagates as a nonzero exit with the "
               "traceback — that is a broken script, not a lint "
               "verdict.")
    ap.add_argument("script", help="python file to lint")
    ap.add_argument("--ranks", type=int, default=2,
                    help="simulated world size for record mode "
                         "(module LINT_RANKS overrides; default 2)")
    ap.add_argument("--mode", choices=("auto", "record", "shadow"),
                    default="auto",
                    help="auto: record when the script defines "
                         "accl_main, else shadow (run under a real "
                         "backend with capture)")
    ap.add_argument("--json", default="",
                    help="write findings + captured programs as JSON")
    ap.add_argument("--fail-on", choices=("error", "warning"),
                    default="error",
                    help="lowest severity that fails the run: 'error' "
                         "(default) exits 1 only on errors; 'warning' "
                         "also fails on warnings (CI gate mode)")
    ap.add_argument("--strict", action="store_true",
                    help="alias for --fail-on warning (kept for "
                         "existing CI invocations)")
    ap.add_argument("--max-findings", type=int, default=50,
                    help="print at most N findings (default 50)")
    args = ap.parse_args()
    if args.strict:
        args.fail_on = "warning"

    mode = args.mode
    if mode == "auto":
        with open(args.script) as f:
            src = f.read()
        mode = "record" if "def accl_main" in src else "shadow"

    if mode == "record":
        findings, meta = run_record(args.script, args.ranks)
    else:
        findings, meta = run_shadow(args.script)

    from ..analysis.findings import ERROR, WARNING

    n_err = sum(1 for f in findings if f.severity == ERROR)
    n_warn = sum(1 for f in findings if f.severity == WARNING)
    print(f"accl_lint: {args.script} — {meta['ranks']} rank(s), "
          f"mode={meta['mode']}, "
          f"{sum(int(n) for n in meta['calls'].values())} call(s)")
    for f in findings[:args.max_findings]:
        print(f.render())
    if len(findings) > args.max_findings:
        print(f"... {len(findings) - args.max_findings} more finding(s) "
              f"suppressed (--max-findings)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"script": args.script, **meta,
                       "findings": [x.to_dict() for x in findings]},
                      f, indent=1)

    if not findings:
        print("accl_lint: clean — no findings")
    else:
        print(f"accl_lint: {n_err} error(s), {n_warn} warning(s)")
    if n_err or (args.fail_on == "warning" and n_warn):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
