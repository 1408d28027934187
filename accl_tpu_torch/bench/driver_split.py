"""Host time of a tree's driver call, to set two trees side by side.

    python -m accl_tpu_torch.bench.driver_split [--out FILE] [--tag NAME]

It times the driver's resident fp32 SUM allreduce (from_fpga/to_fpga) on
CudaWorld(8) at 1024 elements and at 4 and 256 MiB per rank: each rank
thread makes ``iters`` calls in a row and the card is synchronized at
the end, as the call-rate bench's resident lane does; microseconds per
call, the median of five rounds.  In a tree with the observability core
it also times the same calls with the flight recorder and metrics off
(as under ACCL_METRICS=0 ACCL_FLIGHT=0), in the same rounds; chip_smoke's
observed_path phase times its on/off rows with :func:`measure`.  It uses
only the driver API the port has offered since it began, so one chip
call can run it on an earlier tree too, with this file copied there.
It prints one JSON line per measurement and, last, the card's name and
power limit.  It runs on the card; ``measure(device="cpu")`` exists for
the tests only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

P = 8
MIB = 1 << 20
#: elements per rank: below the ring threshold, and two ring-lane sizes
COUNTS = (1024, 4 * MIB // 4, 256 * MIB // 4)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def measure(tag: str, rounds: int = 5, device: str = "cuda",
            counts=COUNTS, world=None) -> list:
    """Rows of microseconds per call, one per (count, lane), on ``world``
    (a new CudaWorld(P) when None).  The lanes alternate in the rounds,
    on, off, off, on, ..., so a drift of the host touches both alike."""
    from accl_tpu_torch import CudaWorld, ReduceFunction

    if world is None:
        with CudaWorld(P, device=device) as w:
            return measure(tag, rounds, device, counts, w)
    try:
        from accl_tpu_torch.observability import flight as OF
        from accl_tpu_torch.observability import metrics as OM
    except ImportError:  # a tree from before the observability core
        OF = OM = None
    rows = []
    nranks = world.nranks

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    recorders = [getattr(a, "flight_recorder", None) for a in world.accls]

    def defaults(on):
        OM.set_enabled(on)
        OF.set_enabled(on)
        for a, r in zip(world.accls, recorders):
            a.flight_recorder = r if on else None

    for count in counts:
        bufs = [(world.accls[r].create_buffer(count, np.float32),
                 world.accls[r].create_buffer(count, np.float32))
                for r in range(nranks)]
        for s, _r in bufs:
            s.dev.normal_()
        iters = 200 if count * 4 < MIB else (50 if count * 4 <= 4 * MIB
                                             else 10)

        def calls(accl, rank, n):
            s, r = bufs[rank]
            for _ in range(n):
                accl.allreduce(s, r, count, ReduceFunction.SUM,
                               from_fpga=True, to_fpga=True)

        def timed():
            t = time.perf_counter()
            world.run(calls, iters)
            sync()
            return (time.perf_counter() - t) / iters * 1e6

        world.run(calls, 3)
        sync()
        lanes = ["defaults"] + (["observability_off"] if OF else [])
        us = {lane: [] for lane in lanes}
        try:
            for i in range(rounds):
                for lane in (lanes if i % 2 == 0 else lanes[::-1]):
                    if OF is not None:
                        defaults(lane == "defaults")
                    us[lane].append(timed())
        finally:
            if OF is not None:
                defaults(True)
        for lane in lanes:
            row = {"tag": tag, "lane": lane, "count": count,
                   "mib_per_rank": count * 4 / MIB, "ranks": nranks,
                   "iters": iters, "us_per_call": statistics.median(us[lane]),
                   "rounds_us": us[lane]}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del bufs
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("driver_split: no CUDA device")
    rows = measure(args.tag)
    card = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    print(card, flush=True)


if __name__ == "__main__":
    main()
