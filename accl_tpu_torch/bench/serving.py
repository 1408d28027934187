"""Prefill and eager decode at the serving path's shape, timed on the card.

    python -m accl_tpu_torch.bench.serving [--out FILE]

The shape of ``chip_smoke.py``'s serving path: Llama-3-8B width
(meta-llama/Meta-Llama-3-8B config.json) cut to 4 layers, float32,
tensor-parallel 8 over rank lists, weights from a seed, 4 requests of
128-token prompts.  Reports

- ``prefill_tokens_per_s``: the prompt tokens over one ``prefill``;
- ``ms_per_decode_step``: one eager ``decode_step`` (``graph=False``'s
  step) after the prompt,

both timed with ``bench.timing.events_ms`` on a cache whose position is
reset before each call.  The script imports the package by its absolute
name, so that run by path with ``PYTHONPATH`` naming another checkout it
times that checkout's code: an A/B of two commits on one card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

LLAMA3_8B = dict(vocab=128256, d_model=4096, n_layers=4, n_heads=32,
                 n_kv_heads=8, d_head=128, d_ff=14336, mlp="swiglu",
                 rope=True, rope_theta=500000.0, attn="flash",
                 dtype="float32")
TP, BATCH, PROMPT = 8, 4, 128


def serving_stage(iters: int = 5, seed: int = 8) -> dict:
    from accl_tpu_torch.bench.timing import events_ms
    from accl_tpu_torch.models import decode as D
    from accl_tpu_torch.models import transformer as M

    cfg = M.ModelConfig(**LLAMA3_8B)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.shard_params(M.init_params(gen, cfg, tp=1), cfg, TP)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    token = prompt[:, -1].clone()
    layers = D.init_kv_cache(cfg, BATCH, PROMPT + 1, tp=TP)["layers"]
    prefill_ms = events_ms(lambda: D.prefill(
        params, prompt, {"pos": 0, "layers": layers}, cfg), iters)
    step_ms = events_ms(lambda: D.decode_step(
        params, token, {"pos": PROMPT, "layers": layers}, cfg), iters)
    return {"config": "Llama-3-8B width, n_layers 32 -> 4, fp32",
            "tp": TP, "batch": BATCH, "prompt": PROMPT,
            "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
            "ms_per_decode_step": step_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from accl_tpu_torch.bench.ring_split import card_line

    res = {"card": card_line(), **serving_stage()}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
