"""Device time and host enqueue time of a tree's flash forward kernels.

    python -m accl_tpu_torch.bench.flash_fwd_split [--out FILE] [--tag NAME]

It times ``flash_fwd_resident``, ``flash_fwd_grid`` and
``flash_fwd_resident_skew`` at the serving path's per-rank launches
(Llama-3-8B width at TP=8: q [8, 4096, 128] over K/V [2, 4096, 128] on 2 x
4096 tokens, ``FLASH_RESIDENT``; q [4, 8192, 128] over K/V [1, 8192, 128]
on 1 x 8192, ``FLASH_GRID``), causal, in the three (input, MXU) dtype
pairs (float32, float32), (float32, bfloat16) and (bfloat16, bfloat16),
each with ``bench.timing.split_ms`` (device time with the stream held,
host enqueue apart) and ``events_ms``; and, as the yardstick,
``torch.nn.functional.scaled_dot_product_attention`` (GQA, causal) in
float32 and bfloat16 at the same shapes.  Each row carries the bound
(the attention's operations over the card's peak for the MXU dtype, 67
TFLOP/s fp32 or 989 bf16, or its bytes over 3.35 TB/s, whichever is
larger) and the TFLOP/s the device time gives.

It calls only what the flash wrappers have offered since the forward
kernels were ported (``_resolve_schedule``, ``flash_fwd_resident``,
``flash_fwd_grid``, ``flash_fwd_resident_skew``), so it can time two
trees on one card in turns, an earlier one and this one, with this file
copied into the earlier tree (it needs ``bench/timing.py`` and
``bench/matmul_split.py`` there).  It prints one JSON line per
measurement and, last, the card's name and power limit.  It runs on the
card only.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .matmul_split import card_line
from .timing import events_ms, split_ms

#: one rank's launch: (N q heads, Nk K/V heads, T, D)
SHAPES = {"FLASH_RESIDENT": (8, 2, 4096, 128), "FLASH_GRID": (4, 1, 8192, 128)}
KERNELS = ("resident", "grid", "resident_skew")
DTYPES = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16))
#: H100 SXM data sheet: fp32 FMA and dense bf16 tensor-core peaks, HBM
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12


def _name(dt) -> str:
    return str(dt).replace("torch.", "")


def bound(shape, dt, mxu) -> dict:
    """The causal forward's work at ``shape``: QK^T and PV over the T (T +
    1) / 2 kept cells per q head, 2 operations per multiply-add; q, k, v
    read and out, lse written once.  The bound is the larger of the
    operations over the MXU dtype's peak and the bytes over the memory
    rate."""
    N, Nk, T, D = shape
    ops = 2 * 2 * D * (T * (T + 1) // 2) * N
    el = torch.finfo(dt).bits // 8
    nbytes = (2 * N * T * D + 2 * Nk * T * D) * el + N * T * 4
    t_ops, t_bytes = ops / PEAK_FLOPS[mxu], nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def operands(FL, shape, dt, mxu, kernel, gen):
    """N(0, 1) q, k, v on the generator's device in the input dtype and
    the resolved schedule the packed entry hands the kernels."""
    N, Nk, T, D = shape
    dev = gen.device

    def rand(*s):
        return torch.randn(s, generator=gen, device=dev).to(dt)

    cfg = FL._resolve_schedule(T, T, D, dt, True, 256, 512, mxu, kernel,
                               None, False, None, None) + (N // Nk,)
    return (rand(N, T, D), rand(Nk, T, D), rand(Nk, T, D)), cfg


def measure(tag: str, iters: int = 10, runs: int = 5) -> list:
    import torch.nn.functional as tnf

    from accl_tpu_torch.ops import flash as FL

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []

    def emit(r):
        print(json.dumps(r), flush=True)
        rows.append(r)

    for sname, shape in SHAPES.items():
        N, Nk, T, D = shape
        for dt, mxu in DTYPES:
            for kernel in KERNELS:
                fn = getattr(FL, f"flash_fwd_{kernel}")
                ops, cfg = operands(FL, shape, dt, mxu, kernel, gen)
                r = {"tag": tag, "name": f"flash_fwd_{kernel}",
                     "shape": sname, "dtype": _name(dt), "mxu": _name(mxu),
                     "q": [N, T, D], "kv": [Nk, T, D], "causal": True,
                     "events_ms": events_ms(lambda: fn(*ops, cfg), iters,
                                            runs)}
                r.update(split_ms(lambda: fn(*ops, cfg), iters, runs))
                r.update(bound(shape, dt, mxu))
                if r["device_ms"]:
                    r["tflops"] = r["ops"] / (r["device_ms"] * 1e-3) / 1e12
                emit(r)
                del ops
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
                       for s in ((Nk, N // Nk, T, D), (Nk, 1, T, D),
                                 (Nk, 1, T, D)))

            def sdpa():
                return tnf.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)

            r = {"tag": tag, "name": "sdpa", "shape": sname,
                 "dtype": _name(dt), "q": [N, T, D], "kv": [Nk, T, D],
                 "causal": True, "events_ms": events_ms(sdpa, iters, runs)}
            r.update(bound(shape, dt, dt))
            emit(r)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--tag", default="tree", help="label on every row")
    ap.add_argument("--iters", type=int, default=10,
                    help="launches per timed window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_fwd_split: no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    rows = measure(args.tag, args.iters)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
