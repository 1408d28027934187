"""Flash-attention schedule sweep on the card.

Port of ``accl_tpu/bench/flash_sweep.py``: the shape of record (head-packed
[B*H, T, D] causal attention, float32 inputs, bfloat16 MXU dtype; the D=64
twin keeps H*D), the candidate closures over ``flash_attention_packed``,
an interleaved best-of-rounds sweep with a bfloat16 ``torch.matmul``
timed in the same windows as context, and the report.

On the card a candidate is what the kernels honour: the schedule
(``resident``, ``resident_skew``, ``grid``), ``static_max``, and the
input and MXU dtypes.  The CUDA kernels walk their own 64-row tiles, so
``block_q``, ``block_k``, ``chunk_k``, ``q_tiles``, ``fuse_denom`` and
``kv_cast_scratch`` change nothing there: candidates that differ only in
those are collapsed, timed once, and reported as aliases of one timing
(``alias_of``).  A candidate the resolver refuses is reported with its
error, as the JAX sweep reports a candidate that fails to compile.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import flash as FL

#: the bench shape of record: B, T, H, D (D=64 sweeps use H=8)
B, T, H, D = 4, 2048, 4, 128
MM_N = 4096
SEED = 2

#: the JAX package's candidate sets (scripts/chip_session.py), plus the
#: two the card adds: the grid kernel and bfloat16 inputs
D128_SPECS = {
    "bq256_bk512": dict(bq=256, bk=512),
    "bq512_bk512": dict(bq=512, bk=512),
    "bq512_bk512_qt2": dict(bq=512, bk=512, qt=2),
    "bq256_bk512_qt2": dict(bq=256, bk=512, qt=2),
    "bq512_bk1024": dict(bq=512, bk=1024),
    "bq512_bk1024_qt2": dict(bq=512, bk=1024, qt=2),
    "bq256_bk1024": dict(bq=256, bk=1024),
    "bq512_bk512_cast": dict(bq=512, bk=512, cast=True),
    "bq256_bk512_skew": dict(bq=256, bk=512, kernel="resident_skew"),
    "bq512_bk512_qt2_ck256": dict(bq=512, bk=512, ck=256, qt=2),
    "bq256_bk512_sm40": dict(bq=256, bk=512, sm=40.0),
    "bq512_bk512_sm40": dict(bq=512, bk=512, sm=40.0),
    "bq256_bk512_sm40_qt2": dict(bq=256, bk=512, sm=40.0, qt=2),
    "bq256_bk512_grid": dict(bq=256, bk=512, kernel="grid"),
    "bq256_bk512_bf16in": dict(bq=256, bk=512, dtype=torch.bfloat16),
}
D64_SPECS = {
    "d64_resident": dict(bq=256, bk=512),
    "d64_resident_fd": dict(bq=256, bk=512, fd=True),
    "d64_bq512_fd": dict(bq=512, bk=512, fd=True),
    "d64_resident_qt2_fd": dict(bq=256, bk=512, qt=2, fd=True),
    "d64_resident_fd_sm40": dict(bq=256, bk=512, fd=True, sm=40.0),
}

#: the CUDA kernel each schedule runs
KERNEL_OF = {"resident": "flash_fwd_resident",
              "resident_skew": "flash_fwd_resident_skew",
              "grid": "flash_fwd_grid", "grid_resident": "flash_fwd_grid"}


def causal_flops(b=B, t=T, h=H, d=D) -> float:
    """Matmul flops of the sweep shape (causal halves the score work);
    invariant under the D=64 twin (H doubles as D halves)."""
    return 4 * b * h * t * t * d / 2


def make_inputs(d=D, device="cuda", dtype=torch.float32, b=B, t=T):
    """(q, k, v) head-packed [B*h, T, d] from SEED, h = H*D/d: drawn with
    numpy on the CPU and with a torch.Generator on the card."""
    n = b * ((H * D) // d)
    if torch.device(device).type == "cpu":
        rng = np.random.default_rng(SEED)
        return tuple(torch.from_numpy(rng.standard_normal(
            (n, t, d)).astype(np.float32)).to(dtype) for _ in range(3))
    gen = torch.Generator(device=device).manual_seed(SEED)
    return tuple(torch.randn((n, t, d), generator=gen, device=device).to(dtype)
                 for _ in range(3))


def matmul_context(device="cuda", n=MM_N):
    """(fn, a, b): the bfloat16 matmul whose rate is the sweep's context."""
    gen = torch.Generator(device=device).manual_seed(7)
    ma = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    mb = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)

    def mm(x, y):
        return torch.matmul(x, y)

    return mm, ma, mb


def make_variant(bq, bk, ck=None, qt=1, fd=False, cast=False,
                 kernel="resident", sm=None, dtype=torch.float32):
    """A schedule candidate: a closure over ``flash_attention_packed``
    (causal, bfloat16 MXU dtype) on inputs of ``dtype``; ``sm`` pins
    static_max.  The closure carries its options as ``.opts``."""
    def fn(x, kk, vv):
        return FL.flash_attention_packed(
            x, kk, vv, causal=True, kernel=kernel, block_q=bq, block_k=bk,
            chunk_k=ck, q_tiles=qt, fuse_denom=fd, kv_cast_scratch=cast,
            static_max=sm)

    fn.opts = dict(bq=bq, bk=bk, ck=ck, qt=qt, fd=fd, cast=cast,
                   kernel=kernel, sm=sm, dtype=dtype)
    return fn


def build(specs: dict) -> dict:
    """Candidates from a spec table like D128_SPECS."""
    return {name: make_variant(sp["bq"], sp["bk"], ck=sp.get("ck"),
                               qt=sp.get("qt", 1), fd=sp.get("fd", False),
                               cast=sp.get("cast", False),
                               kernel=sp.get("kernel", "resident"),
                               sm=sp.get("sm"),
                               dtype=sp.get("dtype", torch.float32))
            for name, sp in specs.items()}


def schedule(fn, d=D, t=T) -> tuple:
    """The resolved schedule a candidate hands the kernels at the sweep
    shape (one q head per K/V head).  Raises the resolver's ValueError for
    a refused candidate."""
    o = fn.opts
    return FL._resolve_schedule(t, t, d, o["dtype"], True, o["bq"], o["bk"],
                                torch.bfloat16, o["kernel"], o["ck"],
                                o["cast"], o["qt"], o["fd"], None,
                                o["sm"]) + (1,)


def card_key(fn, d=D, t=T) -> tuple:
    """What the card runs for a candidate: (kernel, static_max, input
    dtype, MXU dtype).  Raises the resolver's ValueError for a refused
    candidate."""
    cfg = schedule(fn, d, t)
    return (KERNEL_OF[cfg[5]], cfg[10], str(fn.opts["dtype"]), str(cfg[4]))


def collapse(cands: dict, d=D, t=T):
    """(groups, refused): groups maps each representative (the first
    candidate of its card key) to every candidate of that key; refused
    maps a refused candidate to its error."""
    groups, by_key, refused = {}, {}, {}
    for name, fn in cands.items():
        try:
            key = card_key(fn, d, t)
        except ValueError as e:
            refused[name] = f"{type(e).__name__}: {e}"
            continue
        rep = by_key.setdefault(key, name)
        groups.setdefault(rep, []).append(name)
    return groups, refused


def run_sweep(timed_chain, cands, rounds=3, log=None, d=D, device="cuda",
              b=B, t=T, iters=64, mm_n=MM_N, mm_iters=48):
    """Interleaved best-of-rounds sweep over the distinct card candidates.

    Returns (best, best_mm, aliases): best maps every candidate name to
    the best seconds of its representative (or an error string), best_mm
    is the matmul's best seconds in the same windows, aliases maps each
    name to its representative."""
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)
    groups, refused = collapse(cands, d, t)
    inputs = {}
    for rep in groups:
        dt = cands[rep].opts["dtype"]
        if dt not in inputs:
            inputs[dt] = make_inputs(d, device, dt, b, t)
    mm, ma, mb = matmul_context(device, mm_n)

    rep_best = dict.fromkeys(groups)
    best_mm = None
    for r in range(rounds):
        dmm = timed_chain(mm, ma, iters=mm_iters, trials=1, consts=(mb,))
        best_mm = dmm if best_mm is None else min(best_mm, dmm)
        for rep in groups:
            if isinstance(rep_best[rep], str):
                continue
            q, k, v = inputs[cands[rep].opts["dtype"]]
            try:
                dv = timed_chain(cands[rep], q, iters=iters, trials=1,
                                 consts=(k, v))
            except (RuntimeError, ValueError) as e:  # one candidate dying
                rep_best[rep] = f"{type(e).__name__}: {e}"  # must not end
                log(f"  {rep}: DEAD {e}")                   # the sweep
                continue
            log(f"  [r{r}] {rep} (x{len(groups[rep])}): {dv * 1e3:.3f} ms")
            prev = rep_best[rep]
            rep_best[rep] = dv if prev is None else min(prev, dv)
    best, aliases = dict(refused), {}
    for rep, names in groups.items():
        for name in names:
            best[name] = rep_best[rep]
            aliases[name] = rep
    return best, best_mm, aliases


def report(best, best_mm, aliases=None, flops=None, mm_n=MM_N) -> dict:
    """{matmul_bf16_tflops, schedules: {name: {tflops, matmul_frac,
    alias_of}}}, with the bf16 matmul's rate as context."""
    flops = causal_flops() if flops is None else flops
    mm_tf = 2 * mm_n ** 3 / best_mm / 1e12
    res = {"matmul_bf16_tflops": mm_tf, "schedules": {}}
    for name, dt in best.items():
        if isinstance(dt, float):
            tf = flops / dt / 1e12
            row = {"s": dt, "tflops": tf, "matmul_frac": tf / mm_tf}
            if aliases and aliases.get(name, name) != name:
                row["alias_of"] = aliases[name]
            res["schedules"][name] = row
        else:
            res["schedules"][name] = {"error": dt}
    return res
