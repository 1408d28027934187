"""Ring attention with several sp members on one card, timed.

    python accl_tpu_torch/bench/ring_shared.py [--root DIR] [--iters 5]

The flash ring (``parallel.ring_attention``, causal) with every member's
shards on card 0, given as per-card lists (``devices=["cuda:0"] * P``)
and as one card's lists (no ``devices``), at two shapes of the model's
sp mesh on one card:

- ``model_cards``: P = 4 members of a 32768-token sequence, q [1, 8192,
  32, 128] and K/V [1, 8192, 8, 128] bf16 a member (``chip_smoke.py``'s
  ``model_cards`` ring rows);
- ``sp_step``: P = 2 members of 8192 tokens, q [1, 4096, 16, 128] and
  K/V [1, 4096, 4, 128] fp32 a member (one tp rank's ring in the tp 2 x
  sp 2 AdamW step of ``model_cards_sp``).

For each, contiguous and zigzag: the forward without autograd and the
forward and backward (a fixed cotangent), ms per call, median of
``--iters`` after one warm call, each call synchronised; and the flash
launches of one call (``ops.flash``'s counters).  ``--root`` names the
checkout whose ``accl_tpu_torch`` is imported (default: the one holding
this file), so that two checkouts run the same measurement in one call.
It prints one JSON line a row and last the card's name and power limit.
It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: name -> (members, tokens, q heads, kv heads, dtype name)
SHAPES = {"model_cards": (4, 32768, 32, 8, "bfloat16"),
          "sp_step": (2, 8192, 16, 4, "float32")}
D_HEAD = 128


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def rows(iters: int, device: str = "cuda:0", shapes=None) -> list:
    """The rows at ``shapes`` (default SHAPES) on ``device``."""
    import importlib

    import torch
    from accl_tpu_torch.ops import flash as FL

    RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")

    counters = (FL.flash_fwd_resident, FL.flash_fwd_grid, FL.flash_bwd_dq,
                FL.flash_bwd_dkv)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    out = []
    gen = torch.Generator(device=device).manual_seed(5)
    for name, (P, T, H, G, dt) in (shapes or SHAPES).items():
        dtype = getattr(torch, dt)
        full = [torch.randn(1, T, h, D_HEAD, generator=gen, device=device
                            ).to(dtype) for h in (H, G, G)]
        cot = torch.randn(1, T, H, D_HEAD, generator=gen, device=device
                          ).to(dtype)
        for schedule in ("contiguous", "zigzag"):
            perm = (RA.zigzag_indices(T, P).to(device)
                    if schedule == "zigzag"
                    else torch.arange(T, device=device))
            laid = [t[:, perm] for t in full]
            gs = list(cot.chunk(P, dim=1))
            for lists, devs in (("per_card", [device] * P),
                                ("one_card", None)):
                def fwd():
                    with torch.no_grad():
                        return RA.ring_attention(
                            *(list(t.chunk(P, dim=1)) for t in laid),
                            causal=True, schedule=schedule, devices=devs)

                def fwd_bwd():
                    qkv = [[c.clone().requires_grad_() for c in t.chunk(
                        P, dim=1)] for t in laid]
                    o = RA.ring_attention(*qkv, causal=True,
                                          schedule=schedule, devices=devs)
                    torch.autograd.backward(o, gs)
                    return o

                row = {"shape": name, "members": P, "tokens": T,
                       "q": [1, T // P, H, D_HEAD], "kv": [1, T // P, G,
                                                          D_HEAD],
                       "dtype": dt, "schedule": schedule, "lists": lists}
                for what, fn in (("forward", fwd), ("fwd_bwd", fwd_bwd)):
                    fn()
                    sync()
                    for c in counters:
                        c.launches = 0
                    ms = []
                    for _ in range(iters):
                        t0 = time.perf_counter()
                        fn()
                        sync()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    row[what + "_ms"] = statistics.median(ms)
                    row[what + "_ms_samples"] = ms
                    row[what + "_launches"] = {
                        c.__name__: c.launches // iters for c in counters
                        if c.launches}
                out.append(row)
                print(json.dumps(row), flush=True)
        del full, cot
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose accl_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("ring_shared: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import accl_tpu_torch

    print(json.dumps({"root": os.path.abspath(args.root),
                      "package": os.path.dirname(accl_tpu_torch.__file__)}),
          flush=True)
    rows(args.iters)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
