"""The noise of the online tuner drill's never-slower gate, on the card.

    python -m accl_tpu_torch.bench.online_spread [--reps 8] [--out FILE]

``chip_smoke.py``'s ``online_tuning`` phase holds the p50 of the drill's
allreduce after the tuner's decisions to within 1.05 x (the tuner's
hysteresis) of the degraded p50 before them.  When no episode installs,
the dispatch is the same on both sides and the ratio is noise.  Here
nothing changes the dispatch, so every ratio is that noise.  Each
repetition builds a fresh ``CudaWorld(8)``, times a warm p50 of the
host-staged 4 MiB fp32 allreduce (``bench.sweep._run_once``, the drill's
call), makes rank 2 sleep 3 x that (at least 5 ms) before each call, as
the drill's straggler does, and reads two ratios of the same dispatch:

- ``sequential``: the p50 over ``--calls`` calls, then over ``--calls``
  more, the second over the first (the gate's form before the repair);
- ``interleaved``: ``--rounds`` alternating rounds of ``--calls /
  --rounds`` calls a side, the p50 of each side's calls, b over a (the
  gate's form since, :func:`interleaved_p50s`).

It prints one JSON line a repetition, the spread of each ratio, and last
the card's name and power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Callable, Optional

import numpy as np

#: the drill's call: a 4 MiB fp32 allreduce a rank (the static ring
#: threshold)
COUNT = 1 << 20
#: calls behind each side's p50 (the drill's ONLINE_CALLS)
CALLS = 48
#: alternating rounds the calls of a side are spread over
ROUNDS = 6


def call_s(world, count: int = COUNT) -> float:
    """One host-staged fp32 allreduce of ``count`` elements a rank on
    every rank, the drill's timed call: the slowest rank's seconds."""
    from . import sweep

    return sweep._run_once(world, "allreduce", count, np.dtype(np.float32),
                           0)


def p50_us(world, n: int, count: int = COUNT) -> float:
    """The p50 of ``n`` calls, in µs."""
    return statistics.median(call_s(world, count) for _ in range(n)) * 1e6


def interleaved_p50s(world, calls: int, rounds: int,
                     set_a: Optional[Callable] = None,
                     set_b: Optional[Callable] = None,
                     count: int = COUNT) -> tuple:
    """(p50 a, p50 b) in µs over ``rounds`` alternating rounds of
    ``calls // rounds`` calls a side: ``set_a()`` before each round of
    side a, ``set_b()`` before each of side b (None: nothing to set, the
    same dispatch on both sides).  Drift over the run falls on both
    sides alike, where two p50s taken one after the other each get their
    own."""
    a, b = [], []
    per = max(1, calls // rounds)
    for _ in range(rounds):
        for side, setter in ((a, set_a), (b, set_b)):
            if setter is not None:
                setter()
            side.extend(call_s(world, count) for _ in range(per))
    return statistics.median(a) * 1e6, statistics.median(b) * 1e6


def repetition(calls: int, rounds: int, count: int = COUNT,
               device=None) -> dict:
    """One repetition on a fresh ``CudaWorld(8)`` (on ``device``; None:
    the card): the warm p50, the straggler, the sequential and the
    interleaved ratio of one dispatch."""
    from ..backends.cuda import CudaWorld
    from ..scripts.retune_smoke import straggle

    with (CudaWorld(8) if device is None
          else CudaWorld(8, device=device)) as world:
        warm = p50_us(world, 16, count)
        slow_s = max(5e-3, 3 * warm / 1e6)
        straggle(world, 2, slow_s)
        first = p50_us(world, calls, count)
        second = p50_us(world, calls, count)
        ia, ib = interleaved_p50s(world, calls, rounds, count=count)
    return {"warm_p50_us": warm, "sleep_ms": slow_s * 1e3,
            "sequential_p50s_us": [first, second],
            "sequential_ratio": second / first,
            "interleaved_p50s_us": [ia, ib], "interleaved_ratio": ib / ia}


def spread(vals: list) -> dict:
    return {"min": min(vals), "max": max(vals),
            "median": statistics.median(vals),
            "max_abs_dev_from_1": max(abs(v - 1.0) for v in vals)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--calls", type=int, default=CALLS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("online_spread: no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    from .multicard import card_line

    card = card_line()
    rows = []
    for i in range(args.reps):
        rows.append({"rep": i, **repetition(args.calls, args.rounds)})
        print(json.dumps(rows[-1]), flush=True)
    out = {"calls": args.calls, "rounds": args.rounds,
           "sequential": spread([r["sequential_ratio"] for r in rows]),
           "interleaved": spread([r["interleaved_ratio"] for r in rows])}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "spread": out}, f,
                      indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
