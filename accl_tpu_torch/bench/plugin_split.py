"""Device time and host enqueue time of a tree's plugin-lane kernels, kept
apart.

    python -m accl_tpu_torch.bench.plugin_split [--out FILE] [--tag NAME]
                                                [--iters N]

It times, with ``bench.timing.split_ms`` (device time with the stream
held, host enqueue apart) and ``events_ms``:

- ``_pallas_combine_2d`` (the ``accl_combine`` kernel) at [524288, 128]:
  fp32 sum and max, bf16 sum and fp64 sum, at block_rows 512 and 2048,
  beside ``torch.add(out=)`` and ``torch.maximum(out=)``;
- ``_cast_2d`` (the ``accl_cast`` kernel) at [131072, 512], block_rows
  1024: fp32 -> bf16 and fp16 to nearest even; bf16, fp16, e5m2 and
  e4m3fn -> fp32; fp32 -> bf16, e5m2 and e4m3fn stochastically; beside
  ``Tensor.to`` (stochastic rounding has no PyTorch call).

Each row carries the bytes the function must move (each input read
once, each output written once), its bound at 3.35 TB/s, GB/s and the
share of the bound that the device time reaches.  It calls only
``_pallas_combine_2d(a, b, is_max, block_rows, donate)`` and
``_cast_2d(x, seed, dtype, stochastic, block_rows)``, the wrappers'
signatures since the plugin lanes were ported, so it can time two trees
on one card in turns, an earlier one and this one, with this file
copied into the earlier tree (which needs ``bench/timing.py``).  It
prints one JSON line per measurement and, last, the card's name and
power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .timing import events_ms, split_ms

#: the bench shapes: 64 Mi elements as the reduce lane's [rows, 128] and
#: the compression lane's [rows, 512]
N = 64 << 20
COMBINE_SHAPE = (N // 128, 128)
CAST_SHAPE = (N // 512, 512)
CAST_BLOCK_ROWS = 1024
COMBINE_BLOCK_ROWS = (512, 2048)
#: (dtype, is_max) of the combine rows
COMBINE_LANES = ((torch.float32, False), (torch.float32, True),
                 (torch.bfloat16, False), (torch.float64, False))
#: (source, target, stochastic) of the cast rows
CAST_PAIRS = ((torch.float32, torch.bfloat16, False),
              (torch.float32, torch.float16, False),
              (torch.bfloat16, torch.float32, False),
              (torch.float16, torch.float32, False),
              (torch.float8_e5m2, torch.float32, False),
              (torch.float8_e4m3fn, torch.float32, False),
              (torch.float32, torch.bfloat16, True),
              (torch.float32, torch.float8_e5m2, True),
              (torch.float32, torch.float8_e4m3fn, True))
#: H100 SXM memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
SEED = 7


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def short(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def measure(tag: str, iters: int) -> list:
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops import reduce_ops as R

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []

    def row(name, lane, shape, nbytes, fn, runs=5):
        fn()
        torch.cuda.synchronize()
        r = {"tag": tag, "name": name, "lane": lane, "shape": shape,
             "bytes": nbytes, "bound_ms": bound_ms(nbytes),
             "events_ms": events_ms(fn, iters, runs)}
        r.update(split_ms(fn, iters, runs))
        ms = r["device_ms"] or r["events_ms"]
        r["GBps"] = nbytes / ms / 1e6
        r["share_of_bound"] = r["bound_ms"] / ms
        print(json.dumps(r), flush=True)
        rows.append(r)

    shape = f"[{COMBINE_SHAPE[0]}, {COMBINE_SHAPE[1]}]"
    for dt, is_max in COMBINE_LANES:
        a = torch.randn(COMBINE_SHAPE, generator=gen, device="cuda").to(dt)
        b = torch.randn(COMBINE_SHAPE, generator=gen, device="cuda").to(dt)
        out = torch.empty_like(a)
        nbytes = 3 * a.numel() * a.element_size()
        lane = f"{short(dt)} {'max' if is_max else 'sum'}"
        for br in COMBINE_BLOCK_ROWS:
            row("combine_2d", lane, f"{shape} block_rows {br}", nbytes,
                lambda br=br: R._pallas_combine_2d(a, b, is_max, br, False))
        lib = torch.maximum if is_max else torch.add
        row(f"torch.{lib.__name__}(out=)", lane, shape, nbytes,
            lambda: lib(a, b, out=out))
        del a, b, out
    x = torch.randn(CAST_SHAPE, generator=gen, device="cuda") * 4
    srcs = {torch.float32: x}
    shape = f"[{CAST_SHAPE[0]}, {CAST_SHAPE[1]}]"
    for src, dst, stochastic in CAST_PAIRS:
        if src not in srcs:
            srcs[src] = x.to(src)
        xs = srcs[src]
        nbytes = xs.numel() * (xs.element_size() + dst.itemsize)
        lane = (f"{short(src)} -> {short(dst)} "
                f"{'stochastic' if stochastic else 'nearest'}")
        row("cast_2d", lane, f"{shape} block_rows {CAST_BLOCK_ROWS}", nbytes,
            lambda: C._cast_2d(xs, SEED, dst, stochastic, CAST_BLOCK_ROWS))
        if not stochastic:
            row("Tensor.to", lane, shape, nbytes, lambda: xs.to(dst))
    del x, srcs
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--tag", default="tree", help="label on every row")
    ap.add_argument("--iters", type=int, default=30,
                    help="launches in each timed window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plugin_split: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = card_line()
    rows = measure(args.tag, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
