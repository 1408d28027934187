"""Device time and host enqueue time of a tree's ring kernels, kept apart.

    python -m accl_tpu_torch.bench.ring_split [--out FILE] [--tag NAME]

It times the ring wrappers of ``accl_tpu_torch.ops.ring`` at 8 ranks
with ``bench.timing.split_ms`` (and ``events_ms`` beside it): one launch
at [8, 32768] per rank (the driver's 1 MiB segment), at [8, 256] (the
handshake floor) and the tensor-parallel all-gather of 2,097,152
elements per rank; then the segmented allreduce at 4, 64 and 256 MiB
per rank, whole calls.  It calls only what the ring wrappers have
offered since the port began (no ``out=`` on the segmented driver), so
one chip call can run it on two trees, an earlier one and this one, with
this file and ``bench/timing.py`` copied into the earlier tree.
``chip_smoke.py`` reports the same split for the tree it ships with.
It prints one JSON line per measurement and, last, the card's name and
power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .timing import events_ms, split_ms

P = 8
MIB = 1 << 20
TP_GATHER_N = 4096 // P * 4096


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def measure(tag: str) -> list:
    from accl_tpu_torch.ops import ring

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = []

    def row(name, shape, fn, iters, runs=5):
        before = (ring.ring_reduce_scatter.launches,
                  ring.ring_all_gather.launches)
        fn()
        torch.cuda.synchronize()
        launched = [ring.ring_reduce_scatter.launches - before[0],
                    ring.ring_all_gather.launches - before[1]]
        r = {"tag": tag, "name": name, "shape": shape,
             "launches_per_call": launched, **split_ms(fn, iters, runs),
             "events_ms": events_ms(fn, iters, runs)}
        print(json.dumps(r), flush=True)
        rows.append(r)

    for n, label, iters in ((ring.DEFAULT_SEG_ELEMS // P, "segment", 50),
                            (256, "n256", 50), (TP_GATHER_N, "tp", 5)):
        if label != "tp":
            xs = [rand((P, n)) for _ in range(P)]
            outs = [torch.empty(n, device="cuda") for _ in range(P)]
            row("ring_reduce_scatter", f"{P} x [{P}, {n}] fp32",
                lambda: ring.ring_reduce_scatter(xs, out=outs), iters)
            del xs, outs
        ag_in = [rand((n,)) for _ in range(P)]
        ag_out = [torch.empty(P, n, device="cuda") for _ in range(P)]
        row("ring_all_gather", f"{P} x [{n}] fp32",
            lambda: ring.ring_all_gather(ag_in, out=ag_out), iters)
        del ag_in, ag_out
    for mib, iters in ((4, 10), (64, 3), (256, 2)):
        count = mib * MIB // 4
        xs = [rand((count,)) for _ in range(P)]
        row("ring_all_reduce_segmented",
            f"{P} x [{count}] fp32 ({mib} MiB per rank)",
            lambda: ring.ring_all_reduce_segmented(xs, "sum"), iters, 3)
        del xs
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--tag", default="tree", help="label on every row")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_split: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = card_line()
    rows = measure(args.tag)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
