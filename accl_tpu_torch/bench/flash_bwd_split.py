"""Device time and host enqueue time of a tree's flash backward kernels.

    python -m accl_tpu_torch.bench.flash_bwd_split [--out FILE] [--tag NAME]

It times ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the training path's
per-rank launch (dp 2 x tp 4 at Llama-3-8B width, 4096 tokens: q and dO
[8, 4096, 128], K/V [2, 4096, 128], causal), in float32 with the float32
MXU dtype and in bfloat16 with the bfloat16 MXU dtype, each with
``bench.timing.split_ms`` (device time with the stream held, host
enqueue apart) and ``events_ms``; and, as the yardstick, the backward of
``torch.nn.functional.scaled_dot_product_attention`` (GQA, causal) by
autograd, its forward time subtracted, at the same shape and dtypes.

It calls only what the flash wrappers have offered since the backward
kernels were ported (``_resolve_schedule``, ``_flash_forward_impl``,
``flash_bwd_dq``, ``flash_bwd_dkv``), so it can time two trees on one
card in turns, an earlier one and this one, with this file copied into
the earlier tree.  It prints one JSON line per measurement and, last,
the card's name and power limit.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .matmul_split import card_line
from .timing import events_ms, split_ms

#: one rank's training launch: (N q heads, Nk K/V heads, T, D)
SHAPE = (8, 2, 4096, 128)
DTYPES = ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))


def operands(FL, dt, gen, shape=SHAPE):
    """The backward kernels' operands as the autograd backward prepares
    them: a forward through the kernels on N(0, 1) q, k, v and an N(0,
    1) dO, with the MXU dtype equal to the input dtype."""
    N, Nk, T, D = shape
    dev = gen.device

    def rand(*s):
        return torch.randn(s, generator=gen, device=dev).to(dt)

    q, k, v = rand(N, T, D), rand(Nk, T, D), rand(Nk, T, D)
    cfg = FL._resolve_schedule(T, T, D, dt, True, 256, 512, dt, "auto",
                               None, False, None, None) + (N // Nk,)
    out, lse = FL._flash_forward_impl(q, k, v, cfg)
    do = rand(N, T, D)
    q2 = (q.float() * (FL._LOG2E / D ** 0.5)).to(dt)
    dvec = (do.float() * out.float()).sum(-1).contiguous()
    return (q2, k, v, do, (lse * FL._LOG2E).contiguous(), dvec), cfg


def sdpa_backward_ms(dt, gen, iters, runs, shape=SHAPE) -> float:
    """SDPA's backward (dq, dk and dv together) by autograd: forward and
    backward minus the forward, ms per call."""
    import torch.nn.functional as tnf

    N, Nk, T, D = shape
    dev = gen.device

    def rand(*s):
        return torch.randn(s, generator=gen, device=dev).to(dt)

    q = rand(Nk, N // Nk, T, D).requires_grad_(True)
    k = rand(Nk, 1, T, D).requires_grad_(True)
    v = rand(Nk, 1, T, D).requires_grad_(True)
    do = rand(Nk, N // Nk, T, D)

    def fwd():
        return tnf.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                enable_gqa=True)

    def fwd_only():
        with torch.no_grad():
            fwd()

    return (events_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do),
                      iters, runs) - events_ms(fwd_only, iters, runs))


def measure(tag: str, iters: int = 10, runs: int = 5) -> list:
    from accl_tpu_torch.ops import flash as FL

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for dt, name in DTYPES:
        ops, cfg = operands(FL, dt, gen)
        for kern in ("flash_bwd_dq", "flash_bwd_dkv"):
            fn = getattr(FL, kern)
            r = {"tag": tag, "name": kern, "dtype": name,
                 "shape": f"q, dO {list(ops[0].shape)} k/v "
                          f"{list(ops[1].shape)} causal mxu {name}",
                 "events_ms": events_ms(lambda: fn(*ops, cfg), iters, runs)}
            r.update(split_ms(lambda: fn(*ops, cfg), iters, runs))
            print(json.dumps(r), flush=True)
            rows.append(r)
        del ops
        r = {"tag": tag, "name": "sdpa_backward", "dtype": name,
             "events_ms": sdpa_backward_ms(dt, gen, iters, runs)}
        print(json.dumps(r), flush=True)
        rows.append(r)
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--tag", default="tree", help="label on every row")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_split: no CUDA device; nothing to run",
              file=sys.stderr)
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
