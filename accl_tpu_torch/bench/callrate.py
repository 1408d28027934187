"""Driver call rate: how many allreduce calls a second the driver path
sustains (descriptor -> gang engine -> program -> results in the rank
buffers), against the raw rate of the same device work without the
driver.

Port of ``accl_tpu/bench/callrate.py``.  Lanes:

- staged: host-staged operands, copied in and out every call;
- resident: device-resident operands (from_fpga/to_fpga), blocking
  calls served by leader dispatch (the last-arriving rank runs the gang
  inline);
- resident_exec: the same calls with leader dispatch off
  (``CudaEngine.leader_dispatch = False``, the ``ACCL_LEADER_DISPATCH=0``
  lane): every gang goes through the executor thread;
- async: resident calls with ``run_async`` and at most 8 outstanding,
  every request waited and checked.  The port has no batched dispatch
  yet, so the executor runs these gangs one at a time: this is not the
  reference's async lane, whose executor fuses queued gangs;
- raw: the program the engine runs for this gang (the same
  ``_collective_program``: the torch sum below ``ACCL_RING_THRESHOLD``,
  the ring kernels at or above it), called in a loop over the same rank
  tensors with one synchronize at the end.  Its key keeps the
  reference's name, ``raw_shardmap``.

The plan lanes (``plan_sync``, ``plan_async``) replay a captured
persistent plan, which the port has no ``capture_plan`` for yet
(ROADMAP Queue 1 item 2), so their keys are absent.

Methodology as in the reference: the lanes are measured interleaved in
rounds, each lane's best round is kept, and ratios are taken within a
round.

Usage: python -m accl_tpu_torch.bench.callrate [--ranks N] [--count N]
       [--iters N] [--rounds N] [--device cuda|cpu] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import time

#: lane -> result label (the reference's labels)
LANES = (("staged", "driver_staged"),
         ("resident", "driver_sync_resident"),
         ("resident_exec", "driver_sync_executor_path"),
         ("async", "driver_async"),
         ("raw", "raw_shardmap"))


def run(nranks: int = 4, count: int = 1024, iters: int = 300,
        device: str = "cuda", rounds: int = 4) -> dict:
    import numpy as np
    import torch

    from ..backends.cuda import CudaWorld, _collective_program
    from ..constants import Operation, ReduceFunction
    from ..observability import metrics as _metrics
    from .sweep import claim_platform

    claim_platform(device)
    out: dict = {"nranks": nranks, "count": count, "iters": iters,
                 "rounds": rounds, "device": device}
    si = max(10, iters // rounds)  # iterations per lane slice
    out["slice_iters"] = si

    with CudaWorld(nranks, device=device) as w:
        dev = w.engine.device
        bufs: dict = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def setup(accl, rank):
            rng = np.random.default_rng(rank)
            s = accl.create_buffer_like(
                rng.standard_normal(count).astype(np.float32))
            s.sync_to_device()
            r = accl.create_buffer(count, np.float32)
            bufs[rank] = (s, r)
            for _ in range(3):  # warm the gang plans and the kernels
                accl.allreduce(s, r, count, ReduceFunction.SUM)

        w.run(setup)

        def staged(accl, rank):
            s, r = bufs[rank]
            t0 = time.perf_counter()
            for _ in range(si):
                accl.allreduce(s, r, count, ReduceFunction.SUM)
            return time.perf_counter() - t0

        def resident(accl, rank):
            s, r = bufs[rank]
            t0 = time.perf_counter()
            for _ in range(si):
                accl.allreduce(s, r, count, ReduceFunction.SUM,
                               from_fpga=True, to_fpga=True)
            sync()  # completion is the enqueue: time the device work too
            return time.perf_counter() - t0

        def resident_async(accl, rank):
            s, r = bufs[rank]
            window: list = []
            t0 = time.perf_counter()
            for _ in range(si):
                window.append(accl.allreduce(
                    s, r, count, ReduceFunction.SUM, from_fpga=True,
                    to_fpga=True, run_async=True))
                if len(window) >= 8:
                    head = window.pop(0)
                    head.wait()
                    head.check()
            for req in window:
                req.wait()
                req.check()
            sync()
            return time.perf_counter() - t0

        # raw: the engine's own program for this gang, without the driver
        ring = count * 4 >= w.engine.ring_threshold_bytes and nranks > 1
        prog = _collective_program(Operation.allreduce, nranks, count, 0,
                                   int(ReduceFunction.SUM), "", ring, False)
        xs = [bufs[r][0].dev for r in range(nranks)]
        outs = [bufs[r][1].dev for r in range(nranks)]
        direct = outs if ring else None

        def raw():
            t0 = time.perf_counter()
            for _ in range(si):
                ys = prog(xs, direct)
                for o, y in zip(outs, ys):
                    if y is not o:
                        o.copy_(y)
            sync()
            return time.perf_counter() - t0

        raw()  # warm-up
        times: dict = {lane: [] for lane, _label in LANES}
        lane_stats: dict = {}

        def snap():
            return dict(w.engine.stats)

        def delta(before, after):
            return {k: after[k] - before[k] for k in after}

        for _ in range(rounds):
            times["raw"].append(raw())
            s0 = snap()
            times["staged"].append(max(w.run(staged)))
            lane_stats["staged"] = delta(s0, snap())
            s0 = snap()
            times["resident"].append(max(w.run(resident)))
            lane_stats["resident"] = delta(s0, snap())
            w.engine.leader_dispatch = False
            try:
                s0 = snap()
                times["resident_exec"].append(max(w.run(resident)))
                lane_stats["resident_exec"] = delta(s0, snap())
            finally:
                w.engine.leader_dispatch = True
            s0 = snap()
            times["async"].append(max(w.run(resident_async)))
            lane_stats["async"] = delta(s0, snap())

        best = {lane: min(ts) for lane, ts in times.items()}

        def round_ratio(a, b):
            """Best same-round a/b ratio (window to window)."""
            return min(x / y for x, y in zip(times[a], times[b]))

        out["round_latencies_us"] = {
            lane: [round(t / si * 1e6, 1) for t in ts]
            for lane, ts in times.items()}
        out["ring_lane"] = ring

    out["lanes"] = {}
    for lane, label in LANES:
        out["lanes"][label] = {
            "calls_per_s": round(si / best[lane], 1),
            "latency_us": round(best[lane] / si * 1e6, 1),
            "overhead_vs_raw_x": round(round_ratio(lane, "raw"), 2),
        }
        if lane in lane_stats:
            out["lanes"][label]["dispatch"] = lane_stats[lane]

    # the reference's flat keys
    out["driver_calls_per_s"] = round(si / best["staged"], 1)
    out["driver_latency_us"] = round(best["staged"] / si * 1e6, 1)
    out["driver_resident_calls_per_s"] = round(si / best["resident"], 1)
    out["driver_resident_latency_us"] = round(
        best["resident"] / si * 1e6, 1)
    out["driver_async_calls_per_s"] = round(si / best["async"], 1)
    out["driver_async_latency_us"] = round(best["async"] / si * 1e6, 1)
    out["raw_shardmap_calls_per_s"] = round(si / best["raw"], 1)
    out["raw_latency_us"] = round(best["raw"] / si * 1e6, 1)
    out["driver_overhead_x"] = round(round_ratio("staged", "raw"), 2)
    out["resident_overhead_x"] = round(round_ratio("resident", "raw"), 2)
    out["async_overhead_x"] = round(round_ratio("async", "raw"), 2)
    out["resident_vs_async_x"] = round(round_ratio("resident", "async"), 2)
    out["leader_vs_executor_x"] = round(
        round_ratio("resident", "resident_exec"), 2)

    reg = _metrics.default_registry()
    for label, lane in out["lanes"].items():
        reg.set_gauge(f"callrate/{label}/calls_per_s", lane["calls_per_s"])
        reg.set_gauge(f"callrate/{label}/latency_us", lane["latency_us"])
        reg.set_gauge(f"callrate/{label}/overhead_vs_raw_x",
                      lane["overhead_vs_raw_x"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--count", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--json", type=str, default="")
    args = ap.parse_args()
    res = run(args.ranks, args.count, args.iters, args.device, args.rounds)
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
