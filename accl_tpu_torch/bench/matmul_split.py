"""Device time and host enqueue time of a tree's matmul kernels, kept apart.

    python -m accl_tpu_torch.bench.matmul_split [--out FILE] [--tag NAME]

It times, fp32, at Llama-3-8B's TP=8 MLP-down widths (hidden 4096,
intermediate 14336 / 8 = 1792, 4096 tokens):

- ``pallas_matmul`` (the ``accl_matmul`` kernel) on [128, 1792] @
  [1792, 4096], the blocks of ``fused_matmul_allreduce(chunks=4)``, and on
  [4096, 1792] @ [1792, 4096], with ``bench.timing.split_ms`` (device
  time with the stream held, host enqueue apart) and ``events_ms``;
- ``fused_matmul_reduce_scatter`` (the ``accl_fused_matmul_rs`` kernel)
  at P = 8 x [8, 512, 1792] @ [1792, 4096] the same way;
- the two tensor-parallel contractions over 8 rank lists of [4096, 1792]
  @ [1792, 4096], whole calls between CUDA events:
  ``fused_matmul_allreduce(chunks=4)`` and ``fused_matmul_allreduce_pallas``;
- ``torch.matmul`` at the two matmul shapes, the yardstick.

It calls only what these wrappers have offered since the port began, so
it can time two trees on one card in turns, an earlier one and this
one, with this file and ``bench/timing.py`` copied into the earlier
tree.  It prints one JSON line per measurement and, last, the card's
name and power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .timing import events_ms, split_ms

P = 8
M, K, N = 4096, 14336 // P, 4096
CHUNKS = 4


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def measure(tag: str) -> list:
    from accl_tpu_torch.ops import fused as F

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = []

    def row(name, shape, fn, iters, runs=5, split=True):
        fn()
        torch.cuda.synchronize()
        r = {"tag": tag, "name": name, "shape": shape,
             "events_ms": events_ms(fn, iters, runs)}
        if split:
            r.update(split_ms(fn, iters, runs))
        print(json.dumps(r), flush=True)
        rows.append(r)

    w = rand((K, N))
    for rows_, iters in ((M // (P * CHUNKS), 50), (M, 10)):
        x = rand((rows_, K))
        out = torch.empty(rows_, N, device="cuda")
        row("pallas_matmul", f"[{rows_},{K}] @ [{K},{N}] fp32",
            lambda: F.pallas_matmul(x, w, out=out), iters)
        row("torch.matmul", f"[{rows_},{K}] @ [{K},{N}] fp32",
            lambda: torch.matmul(x, w), iters, split=False)
        del x, out
    m = M // P
    xs = [rand((P, m, K)) for _ in range(P)]
    ws = [rand((K, N)) for _ in range(P)]
    outs = [torch.empty(m, N, device="cuda") for _ in range(P)]
    row("fused_matmul_reduce_scatter", f"P={P} x [{P},{m},{K}] @ [{K},{N}] "
        f"fp32", lambda: F.fused_matmul_reduce_scatter(xs, ws, outs), 2, 3)
    del xs, outs
    xs = [rand((M, K)) for _ in range(P)]
    row(f"fused_matmul_allreduce_chunks{CHUNKS}",
        f"P={P} x [{M},{K}] @ [{K},{N}] fp32",
        lambda: F.fused_matmul_allreduce(xs, ws, use_pallas=True,
                                         chunks=CHUNKS), 1, 3, split=False)
    row("fused_matmul_allreduce_pallas", f"P={P} x [{M},{K}] @ [{K},{N}] fp32",
        lambda: F.fused_matmul_allreduce_pallas(xs, ws), 1, 3, split=False)
    del xs, ws
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--tag", default="tree", help="label on every row")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_split: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    rows = measure(args.tag)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
