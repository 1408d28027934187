"""retune_smoke: drill of the online-retune control plane.

Port of ``scripts/retune_smoke.py``.  One command proves the live
telemetry -> tuner loop end to end, deterministically (no timer threads:
the drill drives ``sentinel.check()`` and ``tuner.step()`` itself, so a
failing run replays from ``--seed``):

1. healthy allreduce traffic; the registry snapshot becomes the
   sentinel baseline;
2. one rank is slowed MID-RUN — the next ``sentinel.check()`` fires
   fresh findings into the subscribed
   :class:`~accl_tpu_torch.tuning.online.OnlineTuner`;
3. the tuner turns one finding into one cell hypothesis, re-measures
   with the interleaved best-of A/B, and closes an episode —
   never-slower: only a verified winner installs, and the drill checks
   that the post-decision p50 did not regress;
4. artifacts (``retune_history.json`` — the exporter's ``/retunes``
   body — plus the metrics snapshot and a summary) are round-tripped
   through ``python -m accl_tpu_torch.scripts.perf_doctor --ci
   --retunes`` in a subprocess.

Two backends:

- ``--backend emu`` (default): the reference drill on the port's
  ``EmuWorld`` (4 ranks): a SEEDED chaos plan (the ``ACCL_CHAOS``
  grammar; default ``slow_rank``) degrades one rank's egress.
- ``--backend cuda``: the same control plane on ``CudaWorld`` (8 ranks,
  4 MiB fp32 allreduces, on the card).  ``CudaWorld`` has no chaos
  hook, so rank 2 sleeps before each of its allreduces (3 x the warm
  p50, at least 5 ms); the
  straggler stays on through the A/B and the post-decision calls, as
  the emulator's chaos does.  The A/B times host-staged calls
  (``bench/sweep.py`` ``_run_once``), as the offline tuner does.  With
  no card the drill fails; it never runs the emulator instead.

Both pin ``ACCL_FABRIC`` to one axis, so the challenger shortlist holds
the register, fused and compression lanes and no composed hierarchical
lane (which deadlocks under per-message slow_rank chaos on the
emulator, ROADMAP.md Queue 3).

Usage:
  python -m accl_tpu_torch.scripts.retune_smoke --ranks 4 --seed 42 \\
      --out-dir .
  python -m accl_tpu_torch.scripts.retune_smoke --backend cuda --out-dir d
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class DrillFailed(Exception):
    """A drill phase's check failed; the message says which."""


def straggle(world, rank: int, seconds: float) -> None:
    """Rank ``rank`` sleeps ``seconds`` before each allreduce it issues
    (the ``CudaWorld`` drift: it has no chaos hook): the driver's
    ``allreduce`` is wrapped on that rank's ``ACCL`` object for the
    world's life."""
    accl = world.accls[rank]
    call = accl.allreduce

    def late(*args, **kwargs):
        time.sleep(seconds)
        return call(*args, **kwargs)

    accl.allreduce = late


def make_world(backend: str, ranks: int):
    if backend == "cuda":
        from ..backends.cuda import CudaWorld

        return CudaWorld(ranks)
    from ..backends.emu import EmuWorld

    return EmuWorld(ranks, devmem_bytes=256 << 20, n_egr_rx_bufs=64,
                    max_eager_size=16384, max_rendezvous_size=64 << 20)


def drill(world, backend: str, *, count: int, warm: int, degraded: int,
          seed: int, chaos: str = "",
          hysteresis: float = 1.05, registry=None, tuner=None,
          log=print) -> dict:
    """Phases 1-3 on ``world``: returns ``{"summary", "episodes",
    "tuner", "p50_warm_us", "p50_degraded_us", "p50_post_us"}``, raises
    :class:`DrillFailed` on a failed check.  ``tuner``: the world's own
    (armed by ``ACCL_TUNE_ONLINE`` with a loop interval longer than the
    drill, so only the drill steps it), else a fresh ``OnlineTuner``.
    The drift (chaos or straggler) is left applied; the caller closes
    the world."""
    import numpy as np

    from ..bench import sweep as _sweep
    from ..observability import metrics as _metrics
    from ..observability.sentinel import Baseline, Sentinel
    from ..resilience.chaos import ChaosPlan
    from ..tuning.online import DECISIONS, OnlineTuner

    dtype = np.dtype(np.float32)
    registry = registry if registry is not None \
        else _metrics.default_registry()

    def drive(n: int) -> float:
        """n timed allreduces; returns the p50 call duration in us."""
        durs = [_sweep._run_once(world, "allreduce", count, dtype, 0)
                for _ in range(n)]
        return statistics.median(durs) * 1e6

    summary: dict = {"seed": seed, "backend": backend, "count": count}
    # -- 1: healthy phase -> baseline ---------------------------------
    p50_warm = drive(warm)
    summary["p50_warm_us"] = round(p50_warm, 1)
    baseline = Baseline.from_snapshot(
        registry.snapshot(), source=f"retune_smoke warm phase "
                                    f"(seed {seed})")
    if not baseline.entries:
        raise DrillFailed("warm traffic published no call metrics")
    sentinel = Sentinel(baseline, registry, p50_ratio=1.5,
                        p99_ratio=2.0, bw_ratio=0.6, min_calls=8)
    if tuner is None:
        tuner = OnlineTuner(world, hysteresis=hysteresis, repetitions=2,
                            registry=registry)
    tuner.attach_sentinel(sentinel)
    log(f"retune_smoke: warm p50 {p50_warm:.0f}us over {warm} calls; "
        f"baseline has {len(baseline.entries)} entr(ies)")

    # -- 2: drift mid-run ---------------------------------------------
    if backend == "cuda":
        # 3 x the warm p50: the sentinel reads p50s from power-of-4
        # latency buckets, so a 2 x drift can stay inside one bucket
        slow_s = max(5e-3, 3 * p50_warm / 1e6)
        straggle(world, 2 % world.nranks, slow_s)
        drift = f"rank {2 % world.nranks} sleeps {slow_s * 1e3:.1f} ms " \
                f"before each call"
    else:
        plan = ChaosPlan.parse(chaos)
        for r, d in enumerate(world.devices):
            plan.apply(d, r)
        drift = f"chaos [{chaos}]"
    summary["drift"] = drift
    p50_degraded = drive(degraded)
    summary["p50_degraded_us"] = round(p50_degraded, 1)
    log(f"retune_smoke: {drift} -> degraded p50 {p50_degraded:.0f}us "
        f"({p50_degraded / p50_warm:.2f}x warm)")

    findings = sentinel.check()
    if not findings:
        raise DrillFailed(
            f"sentinel saw no drift after the chaos phase (p50 "
            f"{p50_degraded:.0f}us vs warm {p50_warm:.0f}us)")
    log(f"retune_smoke: sentinel fired {len(findings)} finding(s); "
        f"{tuner.pending()} queued to the tuner")

    # -- 3: drain the control plane -----------------------------------
    episodes = []
    while tuner.pending():
        ep = tuner.step()
        if ep is not None:
            episodes.append(ep)
    if not episodes:
        raise DrillFailed("findings queued but no episode closed")
    for ep in episodes:
        if ep["decision"] not in DECISIONS:
            raise DrillFailed(f"episode decision outside DECISIONS: {ep}")
        log(f"retune_smoke: episode #{ep['seq']} {ep.get('cell')}: "
            f"{ep['decision']} ({ep.get('reason', '')})")
    decisions = {ep["decision"] for ep in episodes}
    if not decisions & {"installed", "rejected"}:
        raise DrillFailed(f"no episode reached a measured decision (got "
                          f"{sorted(decisions)})")

    # never-slower, measured: the live dispatch after the control plane
    # ran must not be worse than the degraded state it was reacting to
    # (generous slack: shared CI cores)
    p50_post = drive(warm)
    summary["p50_post_us"] = round(p50_post, 1)
    summary["recovery_ratio"] = round(p50_degraded / p50_post, 3) \
        if p50_post else 0.0
    log(f"retune_smoke: post-decision p50 {p50_post:.0f}us "
        f"({summary['recovery_ratio']}x recovery vs degraded)")
    if p50_post > p50_degraded * 1.5:
        raise DrillFailed(
            f"dispatch after the retune is {p50_post / p50_degraded:.2f}x "
            f"SLOWER than the degraded state (never-slower broken)")

    # retune counter families must have moved (schema'd telemetry)
    counters = registry.snapshot()["counters"]
    retunes = {k: v for k, v in counters.items()
               if k.startswith("tuning/retunes/")}
    if retunes.get("tuning/retunes/proposed", 0) < 1:
        raise DrillFailed(f"no retune was proposed: {retunes}")
    summary["retune_counters"] = retunes
    summary["episodes"] = len(episodes)
    summary["decisions"] = sorted(decisions)
    log(f"retune_smoke: counters {retunes}")
    return {"summary": summary, "episodes": episodes, "tuner": tuner,
            "p50_warm_us": p50_warm, "p50_degraded_us": p50_degraded,
            "p50_post_us": p50_post}


def doctor(hist_path: str, snap_path: str, report_path: str,
           log=print) -> dict:
    """Phase 4's round trip: ``perf_doctor --ci --retunes`` in a
    subprocess must exit 0 and report the retunes section with no
    schema error.  Returns the report; raises :class:`DrillFailed`."""
    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.scripts.perf_doctor",
         "--retunes", hist_path, "--metrics", snap_path,
         "--ci", "--out", report_path],
        capture_output=True, text=True, cwd=ROOT)
    log(proc.stdout.rstrip())
    if proc.stderr:
        print(proc.stderr, end="", file=sys.stderr)
    if proc.returncode != 0:
        raise DrillFailed(f"perf_doctor --ci rejected the retune "
                          f"artifacts (rc={proc.returncode})")
    with open(report_path) as f:
        report = json.load(f)
    if "retunes" not in report or report["schema_errors"]:
        raise DrillFailed(f"perf_doctor report lacks a clean retunes "
                          f"section: {report.get('schema_errors')}")
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("emu", "cuda"), default="emu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="world size (default 4 emu, 8 cuda)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--count", type=int, default=None,
                    help="elements per allreduce (float32; default 4096 "
                         "emu, 1048576 = 4 MiB cuda)")
    ap.add_argument("--warm", type=int, default=12,
                    help="healthy calls before the baseline snapshot")
    ap.add_argument("--degraded", type=int, default=16,
                    help="calls under the drift before the sentinel check")
    ap.add_argument("--chaos", default="",
                    help="emu: ACCL_CHAOS-grammar plan injected mid-run "
                         "(default: seed=<seed>,slow_rank=1:1000)")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()
    cuda = args.backend == "cuda"
    ranks = args.ranks or (8 if cuda else 4)
    count = args.count or ((1 << 20) if cuda else 4096)
    chaos = args.chaos or f"seed={args.seed},slow_rank=1:1000"

    # same receive-budget widening as tests/conftest.py: a loaded CI
    # core can stall a rank past the reference 1 s default
    os.environ.setdefault("ACCL_DEFAULT_TIMEOUT", "30000000")
    # single-axis fabric: this drill verifies the CONTROL PLANE
    # (finding -> hypothesis -> A/B -> install), so the challenger
    # shortlist stays on the register/compression lanes (the composed
    # hierarchical lane deadlocks under per-message slow_rank chaos on
    # the emulator, ROADMAP.md Queue 3)
    os.environ.setdefault("ACCL_FABRIC", str(ranks))

    from ..observability import metrics as _metrics

    registry = _metrics.default_registry()
    world = make_world(args.backend, ranks)
    try:
        try:
            out = drill(world, args.backend, count=count, warm=args.warm,
                        degraded=args.degraded, seed=args.seed,
                        chaos=chaos, registry=registry)
        except DrillFailed as e:
            print(f"retune_smoke: FAIL — {e}", file=sys.stderr)
            return 1
        # -- 4: artifacts ----------------------------------------------
        os.makedirs(args.out_dir, exist_ok=True)
        hist_path = os.path.join(args.out_dir, "retune_history.json")
        with open(hist_path, "w") as f:
            json.dump(out["tuner"].history.to_doc(), f, indent=1,
                      sort_keys=True)
        snap_path = os.path.join(args.out_dir, "retune_metrics.json")
        with open(snap_path, "w") as f:
            json.dump(registry.snapshot(), f, indent=1, sort_keys=True)
        with open(os.path.join(args.out_dir,
                               "retune_summary.json"), "w") as f:
            json.dump(out["summary"], f, indent=1, sort_keys=True)
    finally:
        world.close()

    try:
        doctor(hist_path, snap_path,
               os.path.join(args.out_dir, "retune_doctor_report.json"))
    except DrillFailed as e:
        print(f"retune_smoke: FAIL — {e}", file=sys.stderr)
        return 1
    print("retune_smoke: OK — artifact round-trip through "
          "perf_doctor --ci validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
