"""Eager ms a launch of the ring kernels' cross-card mode, to set a tree
beside an earlier one in one call.

    python -m accl_tpu_torch.bench.cross_launch --tag T [--out FILE]

Run it from the root of each tree (copy this file into an earlier tree
that lacks it: it uses only ``bench/multicard.py``'s
``ring_launch_rows``).  It prints one JSON line per row:
``ring_reduce_scatter`` and ``ring_all_gather`` at [P, 32768] and [P,
2097152] fp32 a rank, one rank a card over every card (with two or more
cards; ms the slowest card's, CUDA events around 50 calls), and the
per-rank-table form of 8 ranks on card 0 (``ring.rank_tables``); every
result bitwise its plain version or not; then the card's name and power
limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .multicard import card_line, ring_launch_rows

#: elements a rank's chunk: the driver's 1 MiB segment, and 8 MiB
CHUNKS = (32768, 2097152)
ITERS = 50


def rows(tag: str) -> list:
    C = torch.cuda.device_count()
    forms = [(["cuda:0"] * 8, True)]
    if C > 1:
        forms.insert(0, ([f"cuda:{c}" for c in range(C)], False))
    out = []
    for devices, tables in forms:
        for n in CHUNKS:
            for r in ring_launch_rows(devices, n, ITERS, tables):
                out.append({"tag": tag, "n": n, "tables": tables,
                            "name": r["name"], "ms": r["ms"],
                            "ms_per_card": r["ms_per_card"],
                            "bitwise": r["bitwise"]})
                print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cross_launch: no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    got = rows(args.tag)
    card = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": got}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
