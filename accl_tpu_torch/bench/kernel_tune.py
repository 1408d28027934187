"""Tuning sweeps for the flash-attention and compression kernels, on the
card:

    python -m accl_tpu_torch.bench.kernel_tune flash
    python -m accl_tpu_torch.bench.kernel_tune compress

Port of ``scripts/kernel_tune.py``, timed by ``bench/timing.py`` (chained
calls, CUDA events, best of interleaved rounds).

- ``flash``: ``flash_attention`` on [4, 2048, 8, 64] causal float32 over
  the resident and grid schedules and seven (block_q, block_k) pairs.
  The CUDA kernels walk their own 64-row tiles, so the pairs of one
  schedule are one kernel: each schedule is timed once and its pairs are
  reported as aliases of that timing.
- ``compress``: the float32 -> bfloat16 -> float32 roundtrip of 64 Mi
  elements through ``_cast_2d`` (the ``accl_cast`` kernel) over
  ``cols`` x ``block_rows`` geometries, [n / cols, cols] in block_rows-row
  tiles: the TPU script's ``cast2d`` copy of the cast kernel, here the
  same kernel with its geometry as launch parameters.  The ``Tensor.to``
  pair is timed in the same rounds as the yardstick.  GB/s counts 12
  bytes an element (4 + 2 down, 2 + 4 up).

Prints one line per candidate, fastest first, and the result as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import flash as FL
from ..ops.compression import _cast_2d
from .flash_sweep import collapse, make_variant
from .timing import make_harness

FLASH_SHAPE = (4, 2048, 8, 64)  # B, T, H, D
FLASH_KERNELS = ("resident", "grid")
FLASH_BLOCKS = ((128, 512), (256, 256), (256, 512), (256, 1024), (512, 512),
                (512, 1024), (1024, 512))
COMPRESS_N = 64 << 20
COMPRESS_COLS = (128, 512, 1024, 4096)
COMPRESS_BLOCK_ROWS = (256, 1024, 4096, 16384)
SEED = 3


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _randn(shape, device, seed):
    if torch.device(device).type == "cpu":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu (host clock: not a device time)"


def tune_flash(device="cuda", shape=FLASH_SHAPE, kernels=FLASH_KERNELS,
               blocks=FLASH_BLOCKS, rounds=6, iters=64, log=_log) -> dict:
    """Best seconds per (kernel, block_q, block_k), one timing per card
    kernel; returns {device, results: [{kernel, bq, bk, s, tflops,
    alias_of}]} fastest first (a pair the resolver refuses comes last,
    with its error)."""
    _chain, timed_chain_ab = make_harness(device)
    b, t, h, d = shape
    q = _randn((b, t, h, d), device, SEED)
    k = _randn((b, t, h, d), device, SEED + 1)
    v = _randn((b, t, h, d), device, SEED + 2)
    flops = 4 * b * h * t * t * d / 2
    cands = {(kernel, bq, bk): make_variant(bq, bk, qt=None, kernel=kernel)
             for kernel in kernels for bq, bk in blocks}
    groups, refused = collapse(cands, d, t)

    def variant(kernel, bq, bk):
        def fa(x, kk, vv):
            return FL.flash_attention(x, kk, vv, causal=True, block_q=bq,
                                      block_k=bk, kernel=kernel)
        return fa

    best = timed_chain_ab({rep: variant(*rep) for rep in groups}, q, iters,
                          trials=rounds, consts=(k, v))
    rows = sorted(({"kernel": key[0], "bq": key[1], "bk": key[2],
                    "s": best[rep], "tflops": flops / best[rep] / 1e12,
                    **({"alias_of": list(rep)} if rep != key else {})}
                   for rep, names in groups.items() for key in names),
                  key=lambda r: r["s"])
    for r in rows:
        log(f"{r['kernel']:9s} bq={r['bq']:5d} bk={r['bk']:5d}  "
            f"{r['tflops']:8.3f} TFLOP/s"
            + (f"  (alias of {r['alias_of']})" if "alias_of" in r else ""))
    rows += [{"kernel": key[0], "bq": key[1], "bk": key[2], "error": err}
             for key, err in refused.items()]
    return {"device": _device_name(device), "shape_bthd": list(shape),
            "results": rows}


def tune_compress(device="cuda", n=COMPRESS_N, cols=COMPRESS_COLS,
                  block_rows=COMPRESS_BLOCK_ROWS, rounds=6, iters=24,
                  log=_log) -> dict:
    """Best seconds per roundtrip for each (cols, block_rows) geometry of
    the cast kernel and for the Tensor.to pair; returns {device, n,
    results: [{cols, block_rows, s, GBps}], best}, fastest first."""
    _chain, timed_chain_ab = make_harness(device)
    x = _randn((n // 512, 512), device, SEED)

    def roundtrip(c, br):
        def rt(v):
            h = _cast_2d(v.view(-1, c), 0, torch.bfloat16, False, br)
            return _cast_2d(h, 0, torch.float32, False, br).view(v.shape)
        return rt

    fns = {(c, br): roundtrip(c, br) for c in cols for br in block_rows
           if n // c >= br}

    def to_pair(v):
        return v.to(torch.bfloat16).to(torch.float32)

    fns[("Tensor.to", 0)] = to_pair
    best = timed_chain_ab(fns, x, iters, trials=rounds)
    rows = sorted(({"cols": c, "block_rows": br, "s": s,
                    "GBps": n * 12 / s / 1e9}
                   for (c, br), s in best.items()), key=lambda r: r["s"])
    for r in rows:
        log(f"cols={r['cols']!s:>9} block_rows={r['block_rows']:6d}  "
            f"{r['GBps']:8.2f} GB/s")
    kernel_rows = [r for r in rows if r["cols"] != "Tensor.to"]
    return {"device": _device_name(device), "n": n, "results": rows,
            "best": kernel_rows[0] if kernel_rows else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="flash",
                    choices=("flash", "compress"))
    args = ap.parse_args(argv)
    res = (tune_flash if args.which == "flash" else tune_compress)()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
