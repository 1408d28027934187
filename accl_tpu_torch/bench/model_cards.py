"""Model meshes over several cards and the fused kernel's cross-card
mode, timed.

    python -m accl_tpu_torch.bench.model_cards [--iters 10] [--layers 32]
        [--sp-layers 8] [--rows fused,model,sp,steps,decode] [--out FILE]

It prints one JSON line per measurement and, last, the card's name and
power limit:

- ``fused_launch``: ms per launch of ``fused_matmul_reduce_scatter``'s
  cross-card mode (csrc/fused.cu ``fused_matmul_rs_cross_kernel``) at
  Llama-3-8B's row-parallel shapes at TP = P and 4096 tokens (MLP-down:
  x_r [P, 4096 / P, 14336 / P] @ [14336 / P, 4096]; attention-out: K =
  4096 / P), fp32 and bf16 operands, one rank a card over the cards (CUDA
  events on every card's stream around the same calls): each card's ms,
  the plain version's ms, the bound, the greater of the card's FMAs over
  67 TFLOP/s fp32 (989 bf16) and its P - 1 hops of an [m, N] fp32 block
  over 450 GB/s of NVLink, and as a yardstick only (the port never calls
  it) ``torch.matmul`` per rank followed by
  ``torch.cuda.nccl.reduce_scatter``; the result bitwise the one-launch
  form on one card and, on integer data, the plain version; on one card
  the one-launch kernel's ms on the same operands beside;
- ``model``: the crossings of one row-parallel combine at [2 x 4096,
  4096] bf16, ms (``card_sums``: every rank's partial to every card by
  the ring all-gather's cross-card mode and summed there in rank order;
  a block's forward makes two); Llama-3-8B
  at full width and
  ``--layers`` layers, bf16, tp = 4 over the cards (one shard a card on
  four): s per 2 x 4096 forward
  against the same mesh with every slot on card 0, logits bitwise;
- ``model_sp``: the model's sp axis over the cards: Llama-3-8B at full
  width and ``--sp-layers`` layers, bf16, attn="dense" (the ring's flash
  hops), sp = 4 over 1 x 32768 tokens (one sp member a card on four,
  each holding a replica of the weights): s per forward over the cards
  against the same mesh with every slot on card 0, logits bitwise;
- ``model_step``: the train steps (``step_rows``), STEPS of each, s a
  step, each card's peak allocated GiB and, in one more step under
  torch.profiler, each card's device-busy share: the dp 2 x tp 2 AdamW step
  at Llama-3-8B width, 2 layers, fp32, 1 x 2048 tokens a member; the tp
  2 x sp 2 AdamW step, attn="dense", 1 x 8192 tokens; the Switch-Base-8
  dp 2 x ep 8 SGD step, fp32, 16 x 1024 tokens.  Over the cards and
  with every slot on card 0; the updated parameters bitwise the card-0
  mesh's;
- ``decode``: Llama-3-8B at full width and ``--layers`` layers, bf16,
  tp = 4 over the cards (with every slot on card 0 beside): ms per
  decode step of 2 requests after MC_PROMPT-token prompts, teacher-forced
  over DECODE_STEPS tokens, replayed from one ``DecodeGraph`` (its
  capture over every card of the mesh) and eager (``decode_step``); the
  replayed logits bitwise the eager ones, and over the cards bitwise the
  card-0 mesh's (``decode_steps``).
The file runs unchanged in an earlier tree (copy it there) to set two
trees side by side in one call; the decode rows need a tree whose
``DecodeGraph`` captures over cards.

With one card it times the per-rank-table form (``ring.rank_tables``)
of 4 ranks on that card, and the model rows with the one-card mesh in
place of the cards, and says that the cross-card rows did not run.  It
runs on the card only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import sys
import time

import torch

from .multicard import NVLINK_BYTES_PER_S, card_line, per_card_ms

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
TOKENS = 4096
#: Llama-3-8B (Meta's config.json for meta-llama/Meta-Llama-3-8B)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                 n_kv_heads=8, d_head=128, d_ff=14336, mlp="swiglu",
                 rope=True, rope_theta=500000.0, attn="flash",
                 dtype="float32")


def tp_shapes(P: int) -> dict:
    """(m, K, N) a rank of the two row-parallel projections at TP = P and
    TOKENS tokens."""
    return {"mlp_down": (TOKENS // P, 14336 // P, 4096),
            "attn_out": (TOKENS // P, 32 * 128 // P, 4096)}


def fused_bound(P: int, m: int, K: int, N: int, dt, ranks_a_card: int,
                cards: int) -> tuple:
    """(ms, by) a card can do no better than: its ranks' P matmuls of
    [m, K] @ [K, N] over the FMA (or tensor-core) rate; and the bytes:
    across cards the P - 1 hops of an [m, N] fp32 block each rank sends
    over NVLink, on one card every operand read and every result written
    once over HBM."""
    ops = 2 * ranks_a_card * P * m * K * N
    flop_s = ops / (BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)
    el = torch.finfo(dt).bits // 8
    if cards > 1:
        byte_s = (P - 1) * m * N * 4 / NVLINK_BYTES_PER_S
    else:
        byte_s = ranks_a_card * ((P * m * K + K * N) * el
                                 + m * N * 4) / HBM_BYTES_PER_S
    t, by = (flop_s, "operations") if flop_s >= byte_s else (byte_s, "bytes")
    return t * 1e3, by


def _nccl_yardstick(xs, ws, cards, iters):
    """torch.matmul per rank (its P blocks in one product) followed by
    torch.cuda.nccl.reduce_scatter over the products, ms a call on each
    card, or (None, reason)."""
    try:
        import torch.cuda.nccl as nccl

        P = len(xs)
        m, K = xs[0].shape[1], xs[0].shape[2]
        N = ws[0].shape[1]
        outs = [torch.empty(m * N, device=x.device) for x in xs]
        if not nccl.is_available(outs):
            return None, "torch.cuda.nccl not available for these tensors"

        def call():
            prods = [torch.matmul(x.view(P * m, K), w).float().view(-1)
                     for x, w in zip(xs, ws)]
            nccl.reduce_scatter(prods, outs)

        return per_card_ms(call, cards, iters), None
    except Exception as e:  # noqa: BLE001 — a yardstick, reported as absent
        return None, f"{type(e).__name__}: {e}"


def fused_rows(devices: list, shape: str, dt, iters: int) -> dict:
    """One row of the cross-card mode over ``devices`` (one rank each;
    all on one card: the per-rank-table form)."""
    from accl_tpu_torch.ops import fused as F
    from accl_tpu_torch.ops import ring

    P = len(devices)
    m, K, N = tp_shapes(P)[shape]
    cards = sorted({torch.device(d).index or 0 for d in devices})
    form = ring.rank_tables if len(cards) == 1 else contextlib.nullcontext
    gen = torch.Generator().manual_seed(20)
    ints = [torch.randint(-3, 4, (P, m, K), generator=gen) for _ in devices]
    wints = [torch.randint(-3, 4, (K, N), generator=gen) for _ in devices]
    xs = [x.to(dt).to(d) for x, d in zip(ints, devices)]
    ws = [w.to(dt).to(d) for w, d in zip(wints, devices)]
    with form():
        got = [t.clone() for t in F.fused_matmul_reduce_scatter(xs, ws)]
    exact = all(torch.equal(a, b) for a, b in zip(
        got, F.fused_matmul_reduce_scatter_plain(xs, ws)))
    xs = [(torch.randn(P, m, K, generator=gen) * 0.5).to(dt).to(d)
          for d in devices]
    ws = [(torch.randn(K, N, generator=gen) * 0.05).to(dt).to(d)
          for d in devices]
    outs = [torch.empty(m, N, device=d) for d in devices]
    with form():
        got = [t.clone() for t in F.fused_matmul_reduce_scatter(xs, ws)]
    one = F.fused_matmul_reduce_scatter([x.to("cuda:0") for x in xs],
                                        [w.to("cuda:0") for w in ws])
    plain = F.fused_matmul_reduce_scatter_plain(xs, ws)
    bitwise_one = all(torch.equal(a.to("cuda:0"), b)
                      for a, b in zip(got, one))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, plain))
    del one, plain, got

    def kern():
        with form():
            F.fused_matmul_reduce_scatter(xs, ws, outs)

    ms = per_card_ms(kern, cards, iters)
    one_ms = None
    if len(cards) == 1:  # the one-launch kernel on the same operands
        one_ms = max(per_card_ms(lambda: F.fused_matmul_reduce_scatter(
            xs, ws, outs), cards, iters).values())
    plain_ms = per_card_ms(lambda: F.fused_matmul_reduce_scatter_plain(
        xs, ws), cards, max(1, iters // 2))
    if len(cards) > 1:
        lib, why = _nccl_yardstick(xs, ws, cards, iters)
        lib_call = "torch.matmul per rank + torch.cuda.nccl.reduce_scatter"
    else:
        def library():
            parts = torch.stack([torch.matmul(x.view(P * m, K), w).float()
                                 for x, w in zip(xs, ws)])
            return torch.sum(parts, dim=0)

        lib, why = per_card_ms(library, cards, iters), None
        lib_call = "torch.matmul per rank + torch.sum over ranks"
    b_ms, b_by = fused_bound(P, m, K, N, dt, P // len(cards), len(cards))
    return {"name": "fused_matmul_reduce_scatter", "shape": shape,
            "dtype": str(dt).split(".")[-1], "ranks": P,
            "cards": len(cards), "m": m, "K": K, "N": N,
            "form": "tables" if len(cards) == 1 else "cross",
            "ms_per_card": {f"cuda:{c}": v for c, v in ms.items()},
            "ms": max(ms.values()), "one_launch_ms": one_ms,
            "plain_ms": max(plain_ms.values()),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else max(lib.values()),
            "library_call": lib_call, "library_note": why,
            "max_abs_err": err, "bitwise_integers": exact,
            "bitwise_one_launch": bitwise_one}


def llama_bf16(M, cfg, gen):
    """Llama weights drawn on card 0 a block at a time (fp32 draws of one
    block, cast to bf16), the full model never held in fp32."""
    from accl_tpu_torch.utils.tree import tree_map

    one = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    blocks, head = [], None
    for _ in range(cfg.n_layers):
        p = M.init_params(gen, one, tp=1)
        blocks.append(tree_map(lambda t: t.to(torch.bfloat16),
                               p["blocks"][0]))
        if head is None:
            head = {k: p[k].to(torch.bfloat16) for k in ("embed", "ln_f")}
        del p
    return {"embed": head["embed"], "blocks": blocks, "ln_f": head["ln_f"]}


def _wall(fn, cards, runs=3) -> tuple:
    """(median s, samples) of fn() to every card's synchronize, after a
    warm-up."""
    out = fn()
    for c in cards:
        torch.cuda.synchronize(c)
    samples = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        for c in cards:
            torch.cuda.synchronize(c)
        samples.append(time.perf_counter() - t)
    return statistics.median(samples), samples, out


def _slots(C: int, n: int) -> list:
    """n mesh slots over C cards, in contiguous groups (all on card 0
    with one card)."""
    return [f"cuda:{r * C // n}" for r in range(n)]


def model_rows(C: int, layers: int) -> list:
    """The Llama-3-8B forward at tp = 4 over the C cards against the same
    mesh with every slot on card 0 (with one card: the per-card list on
    card 0 against the one-card mesh), and one row-parallel combine's
    crossings."""
    from accl_tpu_torch import models as M
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.models.transformer import Places, _sum_on_cards

    cards = list(range(C))
    devs = _slots(C, 4)
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": layers,
                           "dtype": "bfloat16"})
    gen = torch.Generator(device="cuda:0").manual_seed(20)
    full = llama_bf16(M, cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (2, TOKENS), generator=gen,
                           device="cuda:0")
    res = {}
    for label, d in (("cards", devs), ("card0", ["cuda:0"] * 4)):
        if label == "card0" or C > 1:
            params = M.place_params(full, cfg, make_mesh(tp=4, devices=d))
        else:
            params = M.shard_params(full, cfg, 4)
        with torch.no_grad():
            s, samples, lg = _wall(lambda: M.forward(params, tokens, cfg),
                                   cards)
        res[label] = (s, samples, lg)
        del params
        torch.cuda.empty_cache()
    # the crossings of one row-parallel combine at [2 x 4096, 4096] bf16:
    # each rank's partial to every card and summed there
    h = torch.randn(2 * TOKENS, cfg.d_model, generator=gen,
                    device="cuda:0").to(torch.bfloat16)
    parts = [h.to(d) for d in devs]
    places = Places(tuple(torch.device(d) for d in devs), tuple(range(4)))
    sums = per_card_ms(lambda: _sum_on_cards(parts, places), cards, 10)
    rows = [{"what": "card_sums", "tp": 4, "devices": devs,
             "shape": [2 * TOKENS, cfg.d_model], "dtype": "bfloat16",
             "ms_per_combine": max(sums.values()),
             "ms_each_card": sums,
             "note": "every rank's partial to every card (the ring "
                     "all-gather), summed there; a block makes two"}]
    rows.append({"what": "forward", "config": "Llama-3-8B", "layers": layers,
             "dtype": "bfloat16", "tp": 4, "tokens": [2, TOKENS],
             "devices": devs if C > 1 else "one-card mesh",
             "s_cards": res["cards"][0], "s_cards_samples": res["cards"][1],
             "s_card0": res["card0"][0], "s_card0_samples": res["card0"][1],
             "bitwise": torch.equal(res["cards"][2], res["card0"][2])})
    del full, res, h, parts
    torch.cuda.empty_cache()
    return rows


#: the sp rows: the forward's sp extent and tokens, the step's mesh and
#: tokens
SP_FORWARD = (4, 32768)
SP_STEP = ({"tp": 2, "sp": 2}, 8192)


def sp_rows(C: int, layers: int) -> list:
    """The Llama-3-8B forward at sp = 4 over the C cards and the tp 2 x
    sp 2 AdamW step over them, each against the same mesh with every
    slot on card 0 (with one card the two are the same mesh)."""
    from accl_tpu_torch import models as M
    from accl_tpu_torch import optim
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.utils.tree import tree_leaves

    cards = list(range(C))
    sp, T = SP_FORWARD
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": layers,
                           "attn": "dense", "dtype": "bfloat16"})
    gen = torch.Generator(device="cuda:0").manual_seed(23)
    full = llama_bf16(M, cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (1, T), generator=gen,
                           device="cuda:0")
    res = {}
    for label, d in (("cards", _slots(C, sp)), ("card0", ["cuda:0"] * sp)):
        params = M.place_params(full, cfg, make_mesh(sp=sp, devices=d))
        with torch.no_grad():
            s, samples, lg = _wall(lambda: M.forward(params, tokens, cfg,
                                                     sp=sp), cards)
        res[label] = (s, samples, lg)
        del params, lg
        torch.cuda.empty_cache()
    rows = [{"what": "sp_forward", "config": "Llama-3-8B", "layers": layers,
             "dtype": "bfloat16", "sp": sp, "tokens": [1, T],
             "devices": _slots(C, sp), "s_cards": res["cards"][0],
             "s_cards_samples": res["cards"][1], "s_card0": res["card0"][0],
             "s_card0_samples": res["card0"][1],
             "bitwise": torch.equal(res["cards"][2], res["card0"][2])}]
    del full, res
    torch.cuda.empty_cache()
    return rows


#: Switch-Base-8 (google/switch-base-8's config.json: d_model 768, 12
#: heads of 64, d_ff 3072, 8 experts, capacity factor 1.25), as
#: chip_smoke.py's moe_path runs it; the step's dp x ep mesh and tokens
SWITCH_BASE_8 = dict(vocab=32128, d_model=768, n_layers=4, n_heads=12,
                     d_head=64, d_ff=3072, n_experts=8,
                     capacity_factor=1.25, dtype="float32")
MOE_STEP = ({"dp": 2, "ep": 8}, (16, 1024))
#: the steps' repetitions (the first includes the kernels' first calls)
STEPS = 3


def _busy(run, cards) -> tuple:
    """One more call of ``run`` under torch.profiler: its result, and its
    s with each card's device-busy s (the summed times of the kernels and
    copies the profiler saw on it; a card's work runs on one stream, so
    they do not overlap) as a share of that s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run()
        for c in cards:
            torch.cuda.synchronize(c)
        wall = time.perf_counter() - t
    busy = {f"cuda:{c}": 0.0 for c in cards}
    for e in prof.events():
        key = f"cuda:{e.device_index}"
        if e.device_type == DeviceType.CUDA and key in busy:
            busy[key] += e.time_range.elapsed_us() * 1e-6
    return out, {"s_profiled": wall, "busy_s": busy,
                 "busy_share": {k: v / wall for k, v in busy.items()}}


def _timed_steps(make, devs, cards) -> tuple:
    """The mesh ``make(devs)`` builds, then STEPS calls of its step, each
    to every card's synchronize, and one more under the profiler
    (``_busy``): (s a step, each card's peak allocated GiB from before
    the mesh was built to the last timed step's end, less what the card
    held before: the mesh's parameters, state and steps; the profiled
    step's device-busy shares; the last loss, the mesh's updated
    leaves)."""
    gc.collect()  # the meshes before: their reference cycles go now
    base = {}
    for c in cards:
        torch.cuda.synchronize(c)
        base[c] = torch.cuda.memory_allocated(c)
        torch.cuda.reset_peak_memory_stats(c)
    run, leaves = make(devs)
    times = []
    for _ in range(STEPS):
        t = time.perf_counter()
        run()
        for c in cards:
            torch.cuda.synchronize(c)
        times.append(time.perf_counter() - t)
    peak = {f"cuda:{c}": (torch.cuda.max_memory_allocated(c) - base[c])
            / 2 ** 30 for c in cards}
    loss, busy = _busy(run, cards)
    return times, peak, busy, float(loss), leaves()


def step_rows(C: int) -> list:
    """The train steps over the C cards against the same mesh with every
    slot on card 0: the dp 2 x tp 2 AdamW step at Llama-3-8B width, 2
    layers, fp32, 1 x 2048 tokens a member; the tp 2 x sp 2 AdamW step,
    attn="dense", 1 x 8192 tokens; the Switch-Base-8 dp 2 x ep 8 SGD
    step, fp32, 16 x 1024 tokens (four ep members a card on four).
    The card-0 mesh first, then over the cards, STEPS steps each, with
    each card's peak allocated memory (``_timed_steps``); the loss and
    updated parameters over the cards bitwise the card-0 mesh's or
    not."""
    from accl_tpu_torch import models as M
    from accl_tpu_torch import optim
    from accl_tpu_torch.models import moe as MM
    from accl_tpu_torch.parallel import make_mesh
    from accl_tpu_torch.utils.tree import tree_leaves

    cards = list(range(C))
    rows = []

    def dense(axes, T, seed, attn):
        scfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": 2, "attn": attn})
        base = M.init_params(torch.Generator(device="cuda:0").manual_seed(
            seed), scfg, tp=1)
        n_dp = axes.get("dp", 1)
        toks = torch.randint(0, scfg.vocab, (n_dp, T),
                             generator=torch.Generator(device="cuda:0")
                             .manual_seed(seed + 1), device="cuda:0")

        def make(devs):
            mesh = make_mesh(devices=devs, **axes)
            reps = M.place_params(base, scfg, mesh)
            step, _specs, init = M.make_train_step(
                mesh, scfg, optimizer=optim.adamw(1e-4), params=reps)
            state = [init(reps)]

            def run():
                _p, state[0], loss = step(reps, state[0], toks)
                return loss

            def leaves():
                return [x.to("cuda:0") for x in tree_leaves(
                    M.shard_params(M.placed_trees(reps)[-1], scfg, 2))]

            return run, leaves

        return make

    def moe():
        axes, shape = MOE_STEP
        cfg = MM.MoEConfig(**SWITCH_BASE_8)
        full = MM.init_params(torch.Generator(device="cuda:0").manual_seed(
            26), cfg, ep=1)
        toks = torch.randint(0, cfg.vocab, shape,
                             generator=torch.Generator(device="cuda:0")
                             .manual_seed(27), device="cuda:0")

        def make(devs):
            mesh = make_mesh(devices=devs, **axes)
            reps = MM.place_params(full, cfg, mesh)
            step, _ = MM.make_train_step(mesh, cfg, lr=1e-4)

            def run():
                return step(reps, toks)[1]

            def leaves():
                return [x.to("cuda:0") for x in tree_leaves(
                    MM.shard_params(reps[-1], cfg, axes["ep"]))]

            return run, leaves

        return make

    specs = {"adamw_step": ({"dp": 2, "tp": 2}, 4,
                            lambda: dense({"dp": 2, "tp": 2}, 2048, 21,
                                          "flash"),
                            {"config": "Llama-3-8B", "layers": 2,
                             "dtype": "float32", "optimizer": "adamw",
                             "tokens_a_member": [1, 2048]}),
             "sp_adamw_step": (SP_STEP[0], 4,
                               lambda: dense(SP_STEP[0], SP_STEP[1], 24,
                                             "dense"),
                               {"config": "Llama-3-8B", "layers": 2,
                                "dtype": "float32", "optimizer": "adamw",
                                "tokens": [1, SP_STEP[1]]}),
             "moe_step": (MOE_STEP[0], 16, moe,
                          {"config": "Switch-Base-8",
                           "layers": SWITCH_BASE_8["n_layers"],
                           "dtype": "float32", "optimizer": "sgd",
                           "tokens": list(MOE_STEP[1])})}
    for kind, (axes, slots, build, about) in specs.items():
        make = build()
        row = {"what": kind, **about, "mesh": axes,
               "devices": _slots(C, slots)}
        # the card-0 mesh first: its leaves stay for the bitwise checks
        times, peak, busy, want_loss, want = _timed_steps(
            make, ["cuda:0"] * slots, cards)
        row.update(s_steps_card0=times, peak_gib_card0=peak, busy_card0=busy)
        torch.cuda.empty_cache()
        times, peak, busy, loss, got = _timed_steps(make, _slots(C, slots),
                                                    cards)
        row.update(s_steps_cards=times, peak_gib_cards=peak,
                   busy_cards=busy, loss=loss,
                   bitwise=loss == want_loss and all(
                       torch.equal(a, b) for a, b in zip(got, want)))
        del got
        torch.cuda.empty_cache()
        rows.append(row)
        del make, want
        torch.cuda.empty_cache()
    return rows


#: the decode rows: the prompt's tokens, and the teacher-forced steps
MC_PROMPT = 128
DECODE_STEPS = 8


def _sync(cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def decode_steps(M, params, cfg, prompt, cont, graph: bool, cards,
                 profile: bool = False) -> tuple:
    """(median ms, every step's ms, the steps' logits [steps, B, vocab],
    extras) of the decode steps of ``params`` after ``prompt``'s prefill
    [B, Tp], teacher-forced with the tokens ``cont`` [B, steps]: each
    step replayed from one ``DecodeGraph`` captured after the prefill
    (``graph``), or an eager ``decode_step``; each step timed to every
    card's synchronize.  extras: with the graph, the ring all-gather's
    cross-card launches a step (counted at the capture); with
    ``profile``, one more step under torch.profiler (``_busy``)."""
    from accl_tpu_torch.ops import ring

    places = getattr(params, "places", None)
    B, Tp = prompt.shape
    steps = cont.shape[1]
    cache = M.init_kv_cache(cfg, B, Tp + steps + int(profile),
                            len(params["blocks"][0]["wq"]),
                            devices=None if places is None else places.devices)
    _lg, cache = M.prefill(params, prompt, cache, cfg)
    extras = {}
    stepper = None
    if graph:
        before = ring.ring_all_gather.launches_cross
        stepper = M.DecodeGraph(params, cache, cfg, cont[:, 0]).capture()
        # the warm-up step and the captured one count alike
        extras["captured_all_gather_cross_launches"] = (
            ring.ring_all_gather.launches_cross - before) // 2
    times, logits = [], []

    def one(t):
        nonlocal cache
        if graph:
            stepper.token.copy_(cont[:, t])
            return stepper.replay()
        lg, cache = M.decode_step(params, cont[:, t], cache, cfg)
        return lg

    for t in range(steps):
        _sync(cards)
        t0 = time.perf_counter()
        lg = one(t)
        _sync(cards)
        times.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.clone())
    if profile:
        _lg, extras["profiled"] = _busy(lambda: one(steps - 1), cards)
    return statistics.median(times), times, torch.stack(logits), extras


def decode_rows(C: int, layers: int) -> list:
    """The decode step of Llama-3-8B at tp = 4 over the C cards (with one
    card: the per-card lists on card 0) and with every slot on card 0,
    replayed and eager (``decode_steps``)."""
    from accl_tpu_torch import models as M
    from accl_tpu_torch.parallel import make_mesh

    cards = list(range(C))
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": layers,
                           "dtype": "bfloat16"})
    gen = torch.Generator(device="cuda:0").manual_seed(23)
    full = llama_bf16(M, cfg, gen)
    prompt = torch.randint(0, cfg.vocab, (2, MC_PROMPT), generator=gen,
                           device="cuda:0")
    cont = torch.randint(0, cfg.vocab, (2, DECODE_STEPS), generator=gen,
                         device="cuda:0")
    got = {}
    for label, d in (("cards", _slots(C, 4)), ("card0", ["cuda:0"] * 4)):
        params = M.place_params(full, cfg, make_mesh(tp=4, devices=d))
        with torch.no_grad():
            for graph in (True, False):
                got[label, graph] = decode_steps(M, params, cfg, prompt,
                                                 cont, graph, cards,
                                                 profile=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    row = {"what": "decode", "config": "Llama-3-8B", "layers": layers,
           "dtype": "bfloat16", "tp": 4, "batch": 2, "prompt": MC_PROMPT,
           "steps": DECODE_STEPS,
           "devices": _slots(C, 4) if C > 1 else "per-card lists on card 0"}
    for label in ("cards", "card0"):
        for graph, key in ((True, "replayed"), (False, "eager")):
            ms, samples, _lg, extras = got[label, graph]
            row[f"ms_{key}_{label}"] = ms
            row[f"ms_{key}_{label}_samples"] = samples
            row[f"profiled_{key}_{label}"] = extras["profiled"]
        row[f"all_gather_cross_launches_a_step_{label}"] = got[
            label, True][3]["captured_all_gather_cross_launches"]
        row[f"bitwise_replayed_eager_{label}"] = torch.equal(
            got[label, True][2], got[label, False][2])
    row["bitwise_cards_card0"] = torch.equal(got["cards", True][2],
                                             got["card0", True][2])
    return [row]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--sp-layers", type=int, default=8,
                    help="depth of the sp = 4 forward (every card, and "
                         "card 0 four times over, holds the weights)")
    ap.add_argument("--rows", default="fused,model,sp,steps,decode",
                    help="which rows: fused, model, sp, steps, decode "
                         "(comma separated)")
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args()
    want = set(args.rows.split(","))
    if not torch.cuda.is_available():
        print("model_cards: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    C = min(4, torch.cuda.device_count())
    rows = []
    devices = [f"cuda:{c}" for c in range(C)] if C > 1 else _slots(1, 4)
    for dt in (torch.float32, torch.bfloat16) if "fused" in want else ():
        for shape in ("mlp_down", "attn_out"):
            rows.append({"phase": "fused_launch",
                         **fused_rows(devices, shape, dt, args.iters)})
            print(json.dumps(rows[-1]), flush=True)
    for row in model_rows(C, args.layers) if "model" in want else ():
        rows.append({"phase": "model", **row})
        print(json.dumps(rows[-1]), flush=True)
    for row in sp_rows(C, args.sp_layers) if "sp" in want else ():
        rows.append({"phase": "model_sp", **row})
        print(json.dumps(rows[-1]), flush=True)
    for row in step_rows(C) if "steps" in want else ():
        rows.append({"phase": "model_step", **row})
        print(json.dumps(rows[-1]), flush=True)
    for row in decode_rows(C, args.layers) if "decode" in want else ():
        rows.append({"phase": "model_decode", **row})
        print(json.dumps(rows[-1]), flush=True)
    if C == 1:
        rows.append({"phase": "cross_card", "ran": False,
                     "reason": "one card: the cross-card rows need two or "
                               "more"})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
