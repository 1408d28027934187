#!/usr/bin/env python
"""slo_soak: CI drill for the per-tenant SLO observatory.

Port of ``scripts/slo_soak.py``, on the port's ``EmuWorld``.  A 2-tenant
world on one 4-rank emu fabric — ``decode`` (small
latency-critical allreduces on its own labeled communicator) and
``prefill`` (bulk allgather traffic) — driven through kill + join +
traffic-spike chaos with a :class:`~accl_tpu_torch.observability.
slo.SLOTracker` enforcing per-tenant latency SLOs the whole way.  The
drill FAILS ON BUDGET EXHAUSTION, not just on wrong bits: correctness
drills (chaos_smoke) already pin bitwise recovery; this one pins that
recovery is fast enough to keep a latency-critical tenant inside its
error budget.

Deterministic shape (no timer threads — the harness drives
``tracker.check()`` explicitly, one sweep per traffic round):

1. **healthy phase** — warm traffic on both tenant communicators;
   the observed per-tenant histograms derive the SLO spec (ceilings
   two power-of-4 buckets above the healthy quantiles), written to
   ``slo_spec.json`` and round-tripped through
   :func:`~accl_tpu_torch.observability.slo.load_specs` — the exact
   ``ACCL_SLO`` file format;
2. **traffic spike** — prefill multiplies its bulk volume while
   decode keeps its small calls: contention burns decode budget, the
   tracker's fast/slow windows watch;
3. **kill + shrink** — one rank dies mid-sweep; survivors classify,
   abort the tenant communicators, and remint decode on the survivor
   set (the latency-critical tenant stays on stable membership);
4. **join + grow** — a replacement announces on the membership board,
   survivors shrink the world comm and admit it
   (:func:`~accl_tpu_torch.resilience.elastic.admit_pending`); the grown
   communicator becomes the prefill tenant's new lane, the joiner
   fully participating;
5. **the gate** — the healthy run must end with NO tenant's budget
   exhausted; then a DELIBERATELY-STARVED control tracker (a decode
   p99 ceiling below the first histogram bucket) replays real traffic
   and MUST exhaust — proving the gate actually fails when an SLO
   cannot be met, not only that it passes when one can;
6. artifacts (``slo_report.json`` — the exporter's ``/slo`` body with
   the per-tenant link-matrix slices merged in — plus the spec, the
   control report, the merged flight dump and a metrics snapshot) are
   round-tripped through ``python -m accl_tpu_torch.scripts.perf_doctor
   --slo --ci`` in a subprocess: the doctor must schema-validate and render both
   tenants' matrices.

Usage: python -m accl_tpu_torch.scripts.slo_soak [--ranks 4] [--seed 7]
       [--out-dir .]
"""
import argparse
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bucket_ceiling(us: float, up: int = 2) -> float:
    """The smallest power-of-4 bucket bound >= ``us``, raised ``up``
    more buckets — histogram-native headroom (violation counting is
    per-bucket, so ceilings live on bucket bounds)."""
    from ..observability.metrics import LATENCY_BUCKETS_US

    idx = len(LATENCY_BUCKETS_US) - 1
    for i, ub in enumerate(LATENCY_BUCKETS_US):
        if ub >= us:
            idx = i
            break
    return float(LATENCY_BUCKETS_US[min(idx + up,
                                        len(LATENCY_BUCKETS_US) - 1)])


def _tenant_hist(snap: dict, tenant: str, collective: str) -> list:
    from ..observability.metrics import LATENCY_BUCKETS_US

    hist = [0] * (len(LATENCY_BUCKETS_US) + 1)
    for doc in snap.get("tenant_calls", {}).values():
        if doc["tenant"] == tenant and doc["collective"] == collective:
            for i, ub in enumerate(LATENCY_BUCKETS_US):
                hist[i] += doc["hist_us"][f"le_{ub}"]
            hist[-1] += doc["hist_us"]["inf"]
    return hist


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--decode-count", type=int, default=256,
                    help="elements per latency-critical allreduce")
    ap.add_argument("--prefill-count", type=int, default=8192,
                    help="elements per bulk allgather contribution")
    ap.add_argument("--warm", type=int, default=8,
                    help="healthy sweeps before the spec is derived")
    ap.add_argument("--spike", type=int, default=4,
                    help="traffic-spike sweeps (prefill volume x4)")
    ap.add_argument("--post", type=int, default=3,
                    help="sweeps after the join/grow")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()

    # same receive-budget widening as tests/conftest.py; the kill
    # phase rides the 3 s classification clock set below, never this
    os.environ.setdefault("ACCL_DEFAULT_TIMEOUT", "30000000")

    import numpy as np

    from .. import ACCLError, ErrorCode, ReduceFunction
    from ..backends.emu import EmuWorld
    from ..observability import flight as obs_flight
    from ..observability import metrics as _metrics
    from ..observability.slo import SLOTracker, load_specs
    from ..resilience.elastic import admit_pending

    nranks = args.ranks
    victim = nranks - 1
    survivors = [r for r in range(nranks) if r != victim]
    registry = _metrics.default_registry()
    os.makedirs(args.out_dir, exist_ok=True)
    summary: dict = {"seed": args.seed, "ranks": nranks}

    world = EmuWorld(nranks, devmem_bytes=256 << 20, n_egr_rx_bufs=64,
                     max_eager_size=16384,
                     max_rendezvous_size=64 << 20)
    try:
        for a in world.accls:
            a.set_timeout(3_000_000)  # 3 s classification clock

        # -- tenant communicators over the shared fabric ---------------
        ids = world.run(lambda a, r: (
            a.create_communicator(list(range(nranks)), tenant="decode"),
            a.create_communicator(list(range(nranks)), tenant="prefill")))
        decode_id, prefill_id = ids[0]
        assert all(i == ids[0] for i in ids), ids

        def traffic(accl, rank, d_id, p_id, decode_calls=4,
                    prefill_calls=1, check_bits=False):
            d_size = accl.communicator(d_id).size
            for _ in range(decode_calls):
                s = accl.create_buffer(args.decode_count, np.float32)
                s.host[:] = float(rank + 1)
                r = accl.create_buffer(args.decode_count, np.float32)
                accl.allreduce(s, r, args.decode_count,
                               ReduceFunction.SUM, comm_id=d_id)
                if check_bits:
                    ranks = [rk.session for rk in
                             accl.communicator(d_id).ranks]
                    want = float(sum(x + 1 for x in ranks))
                    assert np.all(r.host == want), \
                        f"decode allreduce wrong bits on rank {rank}"
            if p_id is not None:
                p_size = accl.communicator(p_id).size
                for _ in range(prefill_calls):
                    s = accl.create_buffer(args.prefill_count,
                                           np.float32)
                    s.host[:] = float(rank)
                    r = accl.create_buffer(
                        args.prefill_count * p_size, np.float32)
                    accl.allgather(s, r, args.prefill_count,
                                   comm_id=p_id)
            return d_size

        # -- phase 1: healthy traffic -> derived SLO spec --------------
        for _ in range(args.warm):
            world.run(traffic, decode_id, prefill_id, 4, 1, True)
        snap = registry.snapshot()
        from ..observability.sentinel import quantile_us

        d_hist = _tenant_hist(snap, "decode", "allreduce")
        assert sum(d_hist), "warm phase published no decode histograms"
        p50_ceil = _bucket_ceiling(quantile_us(d_hist, 0.5))
        p99_ceil = _bucket_ceiling(quantile_us(d_hist, 0.99))
        spec_doc = {
            "format": "accl-slo-spec", "version": 1,
            "slos": [
                # latency objectives see SUCCESSFUL calls only
                # (histogram semantics); track_errors makes the kill
                # phase's classified failures burn the availability
                # budget — visibly, without exhausting it: exhaustion
                # is reserved for recovery that is SLOW
                {"tenant": "decode", "collective": "allreduce",
                 "size_bucket": "*", "p50_us": p50_ceil,
                 "p99_us": p99_ceil,
                 "availability": 0.75, "track_errors": True},
                {"tenant": "prefill", "collective": "allgather",
                 "size_bucket": "*",
                 "p99_us": _bucket_ceiling(
                     quantile_us(_tenant_hist(snap, "prefill",
                                              "allgather"), 0.99)),
                 "availability": 0.75, "track_errors": True},
            ],
        }
        spec_path = os.path.join(args.out_dir, "slo_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec_doc, f, indent=1)
        specs = load_specs(spec_path)  # the ACCL_SLO file round-trip
        summary["spec"] = {"decode_p50_us": p50_ceil,
                           "decode_p99_us": p99_ceil}
        print(f"slo_soak: derived spec from {args.warm} healthy "
              f"sweeps — decode p50<={p50_ceil:.0f}us "
              f"p99<={p99_ceil:.0f}us")

        tracker = SLOTracker(specs, registry=registry, fast_window=2,
                             slow_window=8, fast_burn=8.0,
                             slow_burn=2.0, min_calls=8)
        tracker.check()  # absorb the pre-tracker cumulative history

        # -- phase 2: prefill traffic spike ----------------------------
        for _ in range(args.spike):
            world.run(traffic, decode_id, prefill_id, 4, 4)
            tracker.check()
        spike_doc = tracker.doc()
        summary["after_spike"] = {
            t: d["verdict"] for t, d in spike_doc["tenants"].items()}
        print(f"slo_soak: spike phase verdicts {summary['after_spike']}")

        # -- phase 3: kill -> classify -> abort -> remint decode -------
        state: dict = {}

        def kill_sweep(accl, rank):
            if rank == victim:
                world.kill_rank(victim)  # the engine goes silent
            try:
                traffic(accl, rank, decode_id, prefill_id, 4, 1)
                return ("clean", None)
            except ACCLError as e:
                if rank == victim:
                    return ("dead", int(getattr(e, "code", 0)))
                for cid in (decode_id, prefill_id, 0):
                    try:
                        accl.abort(cid,
                                   error=int(ErrorCode.RANK_FAILED))
                    except ACCLError:
                        pass
                new_decode = accl.create_communicator(
                    survivors, tenant="decode")
                # the latency-critical tenant is back: prove it inside
                # the same sweep
                traffic(accl, rank, new_decode, None, 4)
                return ("recovered", new_decode)

        results = world.run(kill_sweep)
        tracker.check()
        assert results[victim][0] == "dead", results[victim]
        new_decodes = {results[r][1] for r in survivors}
        assert len(new_decodes) == 1 and results[survivors[0]][0] == \
            "recovered", results
        decode_id = new_decodes.pop()
        print(f"slo_soak: rank {victim} killed; survivors reminted "
              f"decode as comm {decode_id}")

        # -- phase 4: join + grow; the grown comm is prefill's lane ----
        joiner = world.spawn_replacement()
        join_out: dict = {}

        def joined():
            cid = joiner.join(timeout_s=40.0)
            joiner.accl.set_timeout(40_000_000)
            joiner.accl.set_tenant(cid, "prefill")
            for _ in range(args.post):
                size = joiner.accl.communicator(cid).size
                s = joiner.accl.create_buffer(args.prefill_count,
                                              np.float32)
                s.host[:] = float(joiner.rank)
                r = joiner.accl.create_buffer(
                    args.prefill_count * size, np.float32)
                joiner.accl.allgather(s, r, args.prefill_count,
                                      comm_id=cid)
            join_out["comm"] = cid

        jt = threading.Thread(target=joined, daemon=True)
        jt.start()

        def grow_sweep(accl, rank):
            if rank == victim:
                return None
            shrunk = accl.shrink_communicator(0, window_s=2.0)
            grown, admitted = admit_pending(accl, shrunk, world.board,
                                            wait_s=15.0)
            assert admitted == 1, f"admitted {admitted} joiner(s)"
            accl.set_tenant(grown, "prefill")
            for _ in range(args.post):
                traffic(accl, rank, decode_id, grown, 4, 1)
            return grown

        grow_results = world.run(grow_sweep)
        jt.join(timeout=60)
        assert not jt.is_alive() and "comm" in join_out, \
            "replacement never finished its prefill loop"
        growns = {grow_results[r] for r in survivors}
        assert len(growns) == 1, grow_results
        tracker.check()
        tracker.check()  # idle sweep: burn decays on quiet windows
        print(f"slo_soak: replacement session {joiner.rank} joined; "
              f"prefill rides grown comm {growns.pop()}")

        # -- phase 5a: the healthy gate --------------------------------
        report = tracker.doc()
        matrices = {t: world.link_matrix(tenant=t)
                    for t in ("decode", "prefill")}
        for t, m in matrices.items():
            moved = sum(v for row in m["fields"]["tx_bytes"]
                        for v in row)
            assert moved > 0, f"tenant {t} link slice saw no traffic"
        report["link_matrices"] = matrices
        report_path = os.path.join(args.out_dir, "slo_report.json")
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        verdicts = {t: d["verdict"]
                    for t, d in report["tenants"].items()}
        budgets = {t: d["budget_remaining"]
                   for t, d in report["tenants"].items()}
        summary["verdicts"] = verdicts
        summary["budgets"] = budgets
        print(f"slo_soak: healthy-run verdicts {verdicts}, budget "
              f"remaining {budgets}")
        if "exhausted" in verdicts.values():
            print(f"slo_soak: FAIL — a tenant exhausted its error "
                  f"budget during the soak: {verdicts} (recovery too "
                  f"slow for the declared SLO)", file=sys.stderr)
            return 1

        # -- phase 5b: starved control — the gate MUST fail ------------
        control = SLOTracker(
            [{"tenant": "decode", "collective": "allreduce",
              "size_bucket": "*", "p50_us": 4.0, "p99_us": 4.0,
              "availability": 0.99}],
            registry=registry, fast_window=2, slow_window=8,
            fast_burn=8.0, slow_burn=2.0, min_calls=8)
        control.check()  # absorb history; budget starts clean

        def control_sweep(accl, rank):
            if rank != victim:  # the dead rank has no decode comm
                traffic(accl, rank, decode_id, None, 4)

        for _ in range(3):
            world.run(control_sweep)
            control.check()
        control_doc = control.doc()
        control_path = os.path.join(args.out_dir,
                                    "slo_control_report.json")
        with open(control_path, "w") as f:
            json.dump(control_doc, f, indent=1, sort_keys=True)
        cv = control_doc["tenants"]["decode"]["verdict"]
        summary["control_verdict"] = cv
        if cv != "exhausted":
            print(f"slo_soak: FAIL — the deliberately-starved control "
                  f"run ended {cv!r}, not 'exhausted': the gate cannot "
                  f"be trusted to fail", file=sys.stderr)
            return 1
        print(f"slo_soak: control run exhausted its budget as "
              f"designed (budget_remaining "
              f"{control_doc['tenants']['decode']['budget_remaining']})")

        # -- artifacts -------------------------------------------------
        dump_path = os.path.join(args.out_dir, "slo_flight_dump.json")
        obs_flight.merge_flight_dumps(
            [a.flight_recorder.dump() for a in world.accls]
            + [j.accl.flight_recorder.dump() for j in world.joiners],
            out_path=dump_path)
        snap_path = os.path.join(args.out_dir, "slo_metrics.json")
        with open(snap_path, "w") as f:
            json.dump(registry.snapshot(), f, indent=1, sort_keys=True)
        with open(os.path.join(args.out_dir,
                               "slo_summary.json"), "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
    finally:
        world.close()

    # -- phase 6: the perf_doctor --slo --ci round-trip ----------------
    doctor_path = os.path.join(args.out_dir, "slo_doctor_report.json")
    proc = subprocess.run(
        [sys.executable, "-m", "accl_tpu_torch.scripts.perf_doctor",
         "--slo", report_path, "--ci", "--out", doctor_path],
        capture_output=True, text=True, cwd=ROOT)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        print(f"slo_soak: FAIL — perf_doctor --slo --ci rejected the "
              f"report (rc={proc.returncode})", file=sys.stderr)
        return 1
    with open(doctor_path) as f:
        doctor = json.load(f)
    assert "slo" in doctor and not doctor["schema_errors"], doctor
    for t in ("decode", "prefill"):
        if f"tenant {t}" not in proc.stdout:
            print(f"slo_soak: FAIL — perf_doctor never rendered the "
                  f"{t} tenant's link-matrix slice", file=sys.stderr)
            return 1
    print("slo_soak: OK — 2-tenant soak survived kill + join + spike "
          "inside budget; starved control exhausted; doctor round-trip "
          "validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
