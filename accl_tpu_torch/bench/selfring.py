"""The ring kernels run as a self-ring of V virtual ranks on one card.

    python -m accl_tpu_torch.bench.selfring [--out FILE]

Twin of the JAX package's self-ring stage (bench.py:790-862), the
reference's execute-the-compiled-artifact rung: the ring kernels'
``ring_size`` mode (``ops/ring.py``) with V = 8 and chunks of 4096 x 128
float32 (2 MiB), every hop through the kernel's landing slots and flag
handshake.  Correctness comes first, against the closed forms, before
any number is reported: the all-gather is its operand tiled V times,
bitwise; the reduce-scatter is the fold x[0] + (x[1] + (... + x[V - 1])),
bitwise, and within the fp32 summation bound (V - 1) 2^-24 sum_c |x[c]|
of the float64 sum (the reference holds it to 1e-3 relative, which an
element whose sum cancels to near 0 breaks: 2e-2 on the card's data);
the allreduce is that fold tiled V times, bitwise.  Then

- ``ring_selfring_ag_gbps``: (V - 1) chunks over the all-gather's time;
- ``ring_selfring_ar_gbps``: 2 (V - 1) chunks over the allreduce's time,

the reference's byte counts, timed with ``bench.timing.events_ms``.  An
error propagates: nothing is recorded in its place.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .timing import events_ms

V = 8
ROWS, COLS = 4096, 128


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"self-ring: {what}")


def fold_closed_form(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The self-ring reduce-scatter of [V, n]: x[0] + (x[1] + (... +
    x[V - 1])), or the max in that order."""
    fold = torch.maximum if op == "max" else torch.add
    acc = x[-1].clone()
    for c in range(x.shape[0] - 2, -1, -1):
        acc = fold(x[c], acc)
    return acc


def selfring_stage(device="cuda", ring_size: int = V, rows: int = ROWS,
                   cols: int = COLS, iters: int = 48, seed: int = 11) -> dict:
    """Check the three self-ring calls against their closed forms, then
    time the all-gather and the allreduce.  Returns the reference's keys
    and the ms per call beside them."""
    from ..ops import ring

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = rows * cols
    x = torch.randn(n, generator=gen, device=dev)
    xs = torch.randn((ring_size, n), generator=gen, device=dev)
    arx = torch.randn(ring_size * n, generator=gen, device=dev)

    (ag,) = ring.ring_all_gather([x], ring_size=ring_size)
    _require(torch.equal(ag, x.expand(ring_size, n)),
             "the all-gather is not its operand tiled ring_size times")
    (rs,) = ring.ring_reduce_scatter([xs], ring_size=ring_size)
    _require(torch.equal(rs, fold_closed_form(xs)),
             "the reduce-scatter is not the fold of its chunks")
    over = (rs.double() - xs.double().sum(0)).abs() - (
        (ring_size - 1) * 2.0 ** -24 * xs.double().abs().sum(0))
    _require(float(over.max()) <= 0,
             "the reduce-scatter is off the float64 sum by more than the "
             "fp32 summation bound")
    (ar,) = ring.ring_all_reduce([arx], ring_size=ring_size)
    _require(torch.equal(ar.view(ring_size, n), fold_closed_form(
        arx.view(ring_size, n)).expand(ring_size, n)),
        "the allreduce is not the fold tiled ring_size times")
    del ag, rs, ar

    ag_out = [torch.empty((ring_size, n), device=dev)]
    ar_out = [torch.empty(ring_size * n, device=dev)]

    def ag_call():
        ring.ring_all_gather([x], out=ag_out, ring_size=ring_size)

    def ar_call():
        ring.ring_all_reduce([arx], out=ar_out, ring_size=ring_size)

    ag_ms, ar_ms = events_ms(ag_call, iters), events_ms(ar_call, iters)
    chunk = n * x.element_size()
    return {"ring_compiled_selfring_ok": True,
            "ring_selfring_ag_gbps": (ring_size - 1) * chunk / ag_ms / 1e6,
            "ring_selfring_ar_gbps": 2 * (ring_size - 1) * chunk / ar_ms
            / 1e6,
            "ag_ms": ag_ms, "ar_ms": ar_ms, "ring_size": ring_size,
            "chunk_shape": [rows, cols], "chunk_bytes": chunk}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("selfring: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from .ring_split import card_line

    res = {"card": card_line(), **selfring_stage()}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
