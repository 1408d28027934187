"""Run the PyTorch/CUDA port (accl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from accl_tpu_torch/ops/csrc with nvcc, one
     nvcc per source, all started together; the build line carries
     ptxas's register and spill lines, each matmul kernel's registers,
     spill bytes, shared memory and blocks per SM as the runtime reports
     them, and the tensor-core instructions in the matmul kernels' SASS
     (must be 0) and in each flash backward kernel's (0 in every fp32
     instantiation, more than 0 in every bf16-MXU one); the flash
     backward kernels' registers, shared memory and CTAs per SM;
  3. each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it:
     - the ring kernels at one 1 MiB segment (P=8 ranks, n =
       DEFAULT_SEG_ELEMS / 8) and at a ragged size: fp32 SUM and MAX,
       int32 SUM and fp32 all-gather bitwise, fp16 SUM within one ulp;
       the segmented allreduce (one launch per phase over every segment)
       at whole segments of many tiles, odd N with a ragged tail, many
       small segments and fewer elements than ranks, in all five kernel
       dtypes, SUM and MAX with NaN present, out of place and in place,
       bitwise against the plain composition; both kernels at one tile
       and many in all five dtypes, bitwise; the all-gather also at the
       tensor-parallel path's n = (M / 8) N;
     - the matmul kernel (accl_matmul, at M and M / (8 CHUNKS) rows) and
       the fused matmul reduce-scatter kernel (accl_fused_matmul_rs, P=8,
       m = M / 8) on f32 and bf16 at Llama-3-8B's TP=8 MLP-down and
       attention-out shapes and at a ragged shape: bitwise on
       integer-valued inputs; on N(0, 1) inputs within the dot-product
       bound |err| <= 2 K 2^-24 (|x| @ |w|) of a float64 product, and
       within the fp32 spread sqrt(K) 2^-24 (|x| @ |w|) of the plain
       version (K = P * K for the fused kernel, whose sum runs over P
       ranks' partials).  A control computes the plain version on
       bf16-rounded operands, which must fall outside the spread, and on
       TF32, printed beside;
     - the flash-attention kernels (flash_fwd_resident, flash_fwd_grid)
       at the serving path's per-rank shapes, a windowed, two
       cross-length and two ragged calls, in f32 with f32 and bf16 MXU
       dtypes and in bf16: out and lse within FLASH_BOUND of the plain
       version, and a bf16-operand control outside the f32 bound;
     - the flash backward kernels (flash_bwd_dq, flash_bwd_dkv) at the
       training path's per-rank shape (q and dO [8, 4096, 128], K/V
       [2, 4096, 128], causal) with the lse cotangent zero and nonzero,
       and at a windowed, a cross-length and a ragged call with halved
       blocks, in f32 with f32 and bf16 MXU dtypes and in bf16: dq, dk
       and dv within BWD_BOUND of the plain version and bitwise equal
       over two launches, and a bf16-operand control outside the f32
       bound; each call's launch plan (dq CTAs, dK/dV items, the heaviest
       item against the average work per SM, which must stay within
       BWD_ITEM_SHARE_MAX at the training shape, CTAs per SM);
     - the plugin kernels: the combine kernel (accl_combine) on all
       12 lanes (fp32, fp64, int32, int64, fp16, bf16 by sum and by max)
       at the bench shape (64 Mi elements) and at 4099, with donate,
       bitwise against a + b and torch.maximum; the cast kernel
       (accl_cast) both ways for fp16 and bf16, at the bench shape and at
       a ragged length holding NaN, inf, overflow and fp16 subnormals,
       bitwise against Tensor.to, and at every geometry of phase 4f's
       tuning grid (4 cols x 2 block_rows) the same way; its stochastic
       rounding to bf16, e5m2 and e4m3fn bitwise against the plain
       version, and unbiased at 1 + 2^-12;
     - flash_fwd_resident_skew at the serving path's per-rank shape in
       the three flash dtype pairs: bitwise equal to flash_fwd_resident,
       and within FLASH_BOUND of its plain version;
  4. the main path, in six parts, each driven with every launch count
     set to 0 just before it and read just after:
     a. the driver: CudaWorld(8) on the card, ACCL calls on 8 rank
        threads — fp32 SUM allreduce at 4, 16, 64 and 256 MiB per rank,
        MAX allreduce, allgather and reduce-scatter at 64 MiB per rank,
        and bcast / gather / scatter / alltoall / a small allreduce below
        the ring threshold.  Every result is held against the plain
        composition on the card (bitwise on the ring lane) and a float64
        reference (rtol 1e-5, atol 1e-5); each ring call must launch
        one kernel per phase (an allreduce one reduce-scatter and one
        all-gather, at every size);
     b. the fused tensor-parallel matmul at Llama-3-8B's widths (hidden
        4096, intermediate 14336, 32 query heads of 128; Meta's
        config.json for meta-llama/Meta-Llama-3-8B) at TP=8 and 4096
        tokens: fused_matmul_allreduce_pallas and
        fused_matmul_allreduce(chunks=CHUNKS, use_pallas=True) over 8
        rank lists at the MLP-down and attention-out shapes, each held to
        the float64 sum_r x_r @ w_r within the dot-product bound and to
        the same form built from the plain versions within the fp32
        spread; the matmul, fused and ring all-gather kernels must launch;
     c. the fused and int8 driver lanes on the same CudaWorld(8) at 64
        MiB per rank: fused=True allreduce, reduce_scatter and allgather
        (bitwise equal to the ring lane: its driver results for
        reduce_scatter and allgather, its fold at one segment for
        allreduce, whose driver run folds per 1 MiB segment), and fp32
        allreduce with compress_dtype=DataType.int8 without and with
        error feedback (bitwise equal to the plain int8 composition, its
        error against float64 printed beside the bound P (2 5 sqrt(P) /
        127) of tests/test_quantized.py);
     d. the model's serving path (accl_tpu_torch.models) at Llama-3-8B
        width, cut to 4 layers, TP=8 over rank lists, fp32, random
        weights from a seed (LLAMA3_8B): the scoring forward on 2 x 4096
        tokens (flash_fwd_resident must launch), with fused=True, with
        attn="dense" and at TP=1, each held to it within LOGIT_BOUND; the
        forward on 1 x 8192 tokens (flash_fwd_grid must launch); generate
        for 4 requests of 128-token prompts and 32 new tokens, greedy,
        held to forward's argmax; teacher-forced prefill and decode held
        to forward's logits.  Prints first-call seconds, launches,
        prefill tokens/s, ms per decode step and peak memory;
     e. the model's training path at the same width and depth, fp32:
        make_train_step on make_mesh(dp=2, tp=4) (8 rank slots), 1 x 4096
        tokens per dp member, 3 SGD steps at TRAIN_LR on a repeated
        batch; the loss must be finite and fall, and flash_fwd_resident,
        flash_bwd_dq and flash_bwd_dkv must each launch 32 times a step.
        The first step is held three ways: to the same step with
        attn="dense" and remat (loss within TRAIN_LOSS_BOUND, each
        leaf's gradient, recovered as (p - p') / lr, within
        TRAIN_GRAD_BOUND plus the update's fp32 rounding floor), to the
        same step with remat (within REMAT_BOUND), and to one step
        synced by sync_gradients(compress="int8", error_feedback=True)
        over the dp list (the loss after it within TRACK_TOL of the
        fp32 run's).  Prints seconds per step, tokens/s and peak memory;
     f. the plugin lanes, as bench.py and the tuning tools run
        them, in four parts: the reduce lane (pallas_add with donate on
        [524288, 128] fp32, block_rows 512 and 2048, chained, beside
        torch.add in place, GB/s = 3 x bytes / time); the bf16
        compression roundtrip of 64 Mi fp32 (nearest, and stochastic with
        the seed stepped per call) beside the Tensor.to pair (12 bytes an
        element); a short tune_compress grid (4 cols x 2 block_rows) and
        its best geometry; the flash schedule sweep's distinct card
        candidates at [16, 2048, 128] causal (resident, resident_skew,
        grid, static_max, bf16 inputs; the other candidates are aliases),
        each held within FLASH_BOUND of the plain version of its kernel
        before it is timed (outside the counted parts).
        The combine kernel, the cast kernel (in the lanes and in the
        tuning grid) and the skew kernel must each launch;
  5. times with CUDA events after warm-up (median of 5 runs): each kernel
     per launch, at the shape the main path launches it most, beside its
     plain version, a library yardstick and its bound (bytes read once +
     written once over 3.35 TB/s, or operations over the peak for their
     type, 67 TFLOP/s fp32 or 989 TFLOP/s bf16, whichever is larger),
     with its times at the path's other shape as an extra field (the
     flash backward kernels beside SDPA's backward by autograd, its
     forward time subtracted; the plugin kernels at the bench shapes,
     the cast kernel also at phase 4f's tuned geometry; the skew beside
     flash_fwd_resident and SDPA); the
     driver's allreduce algbw / busbw per size; the ring and matmul
     kernels (with each matmul shape's launch plan) also with the stream
     held behind torch.cuda._sleep until every launch is enqueued
     (device time) and on the host clock around the enqueues
     (accl_tpu_torch/bench/timing.py, split_ms), and the segmented
     allreduce's two launches at each driver size the same way; and at
     64 MiB per rank
     the busbw of the fused and int8 lanes beside the lossless ring's.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 = False):
the plain versions and yardsticks multiply in full fp32, as the kernels
do.  It prints one JSON line per measurement, a {"kernels": [...]}
line, the card's name and power limit, and last {"ok": true, "device":
{...}}.  Without CUDA it exits 2 and prints no result.
"""
import argparse
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from accl_tpu_torch.bench.timing import events_ms as cuda_ms, split_ms

P = 8
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
SEED = 1234
#: Llama-3-8B at TP=8 and 4096 tokens: (M, K per rank, N) of the two
#: row-parallel projections.  MLP-down: intermediate 14336 / 8 = 1792;
#: attention-out: 32 heads x 128 / 8 = 512; hidden 4096.
TOKENS = 4096
TP_SHAPES = {"mlp_down": (TOKENS, 14336 // P, 4096),
             "attn_out": (TOKENS, 32 * 128 // P, 4096)}
RAGGED_MKN = (1000, 333, 777)
#: the flash kernels' wrappers in accl_tpu_torch/ops/flash.py
FLASH_KERNELS = ("flash_fwd_resident", "flash_fwd_grid", "flash_bwd_dq",
                 "flash_bwd_dkv", "flash_fwd_resident_skew")
#: chunks of the pipelined form fused_matmul_allreduce(chunks=...): its
#: matmuls run on M / (P CHUNKS)-row blocks
CHUNKS = 4
#: elements per rank of the ring all-gather in fused_matmul_allreduce_pallas
#: (a [M / P, N] block; N = 4096 at both shapes)
TP_GATHER_N = TOKENS // P * 4096
#: payload per rank of the fused and int8 driver lanes
LANE_MIB = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(shape, dtype, gen) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    if dtype in (torch.int32, torch.int64):
        return (x * 1000).to(dtype)
    return x.to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_kernels(ring) -> dict:
    """Phase 3: each kernel against its plain version, bitwise (fp16
    within 1 ulp).  Returns the largest error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"ring_reduce_scatter": 0.0, "ring_all_gather": 0.0}
    n_main = ring.DEFAULT_SEG_ELEMS // P
    for n in (n_main, 4099):
        for dtype, op in ((torch.float32, "sum"), (torch.float32, "max"),
                          (torch.float16, "sum"), (torch.int32, "sum")):
            xs = [rand((P, n), dtype, gen) for _ in range(P)]
            got = ring.ring_reduce_scatter(xs, op)
            torch.cuda.synchronize()
            want = ring.ring_reduce_scatter_plain(xs, op)
            for g, w in zip(got, want):
                e = max_err(g, w)
                errs["ring_reduce_scatter"] = max(errs["ring_reduce_scatter"],
                                                  e)
                if dtype == torch.float16:
                    ulp = (w.float().abs() * 2.0 ** -10).clamp_min(2.0 ** -24)
                    if ((g.float() - w.float()).abs() > ulp).any():
                        fail(f"ring_reduce_scatter fp16 {op} n={n}: more than "
                             f"1 ulp off (max abs err {e})")
                elif not torch.equal(g, w):
                    fail(f"ring_reduce_scatter {dtype} {op} n={n}: not "
                         f"bitwise equal to the plain version "
                         f"(max abs err {e})")
        for dt in (torch.float32, torch.float16, torch.int32):
            src = [rand((n,), dt, gen) for _ in range(P)]
            got_ag = ring.ring_all_gather(src)
            torch.cuda.synchronize()
            for g, w in zip(got_ag, ring.ring_all_gather_plain(src)):
                if not torch.equal(g, w):
                    fail(f"ring_all_gather {dt} n={n}: not bitwise equal "
                         f"to the plain version")
                errs["ring_all_gather"] = max(errs["ring_all_gather"],
                                              max_err(g, w))
    errs_walk = check_segment_walk(ring)
    for k in errs:
        errs[k] = max(errs[k], errs_walk)
    # the tensor-parallel path's all-gather: one reduced [M / P, N] f32
    # block per rank
    src = [rand((TP_GATHER_N,), torch.float32, gen) for _ in range(P)]
    got_ag = ring.ring_all_gather(src)
    torch.cuda.synchronize()
    for g, w in zip(got_ag, ring.ring_all_gather_plain(src)):
        if not torch.equal(g, w):
            fail(f"ring_all_gather fp32 n={TP_GATHER_N}: not bitwise equal "
                 f"to the plain version")
    del src, got_ag
    emit({"phase": "kernel_vs_plain", "ok": True, "max_abs_err": errs})
    return errs


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality that holds NaN to its payload."""
    if a.dtype.is_floating_point:
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


#: (N per rank, seg_elems) of the segment-walking checks: whole segments
#: of many tiles; a ragged tail at odd N; a ragged tail of chunk width 1;
#: and fewer elements than ranks
WALK_SHAPES = ((8 * 4 * 32768, 8 * 32768), (3 * 8 * 4099 + 13, 8 * 4099),
               (8 * 1000 + 5, 8 * 1000), (5, 1 << 18))


def check_segment_walk(ring) -> float:
    """Phase 3: the segment-walking launches (one per phase over every
    segment of an allreduce) against the plain composition, bitwise, in
    every kernel dtype, SUM and MAX (MAX with NaN present), out of place
    and in place; and the one-segment forms at 1 and many tiles."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for (N, seg), dtype, op in itertools.product(
            WALK_SHAPES, ring.KERNEL_DTYPES, ("sum", "max")):
        xs = [rand((N,), dtype, gen) for _ in range(P)]
        if op == "max" and dtype.is_floating_point:
            for r, x in enumerate(xs):
                x[r::97] = float("nan")
        want = ring.ring_all_reduce_segmented(xs, op, seg, plain=True)
        got = ring.ring_all_reduce_segmented(xs, op, seg)
        same = [x.clone() for x in xs]
        ring.ring_all_reduce_segmented(same, op, seg, out=same)
        torch.cuda.synchronize()
        for r in range(P):
            for what, g in (("out of place", got[r]), ("in place", same[r])):
                if not same_bits(g, want[r]):
                    fail(f"segment walk {dtype} {op} N={N} seg={seg} "
                         f"{what} rank {r}: not bitwise equal to the plain "
                         f"composition")
            if op == "sum":
                worst = max(worst, max_err(got[r], want[r]))
    for n, dtype in itertools.product((256, 4099, 3 * 32768 + 7),
                                      ring.KERNEL_DTYPES):
        xs = [rand((P, n), dtype, gen) for _ in range(P)]
        got = ring.ring_reduce_scatter(xs, "sum")
        gathered = ring.ring_all_gather(got)
        torch.cuda.synchronize()
        for g, w in zip(got, ring.ring_reduce_scatter_plain(xs, "sum")):
            if not same_bits(g, w):
                fail(f"ring_reduce_scatter {dtype} n={n}: not bitwise equal "
                     f"to the plain version")
        for g, w in zip(gathered, ring.ring_all_gather_plain(got)):
            if not same_bits(g, w):
                fail(f"ring_all_gather {dtype} n={n}: not bitwise equal to "
                     f"the plain version")
    emit({"phase": "segment_walk_vs_plain", "ok": True,
          "shapes": [list(s) for s in WALK_SHAPES],
          "dtypes": [str(d) for d in ring.KERNEL_DTYPES]})
    return worst


def ints(shape, dtype, gen) -> torch.Tensor:
    """Integer values in [-3, 3]: every product and partial sum of the
    matmuls here is exact in fp32 (and in bf16 inputs)."""
    return torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)


def ref64(xs, ws):
    """float64 sum_r xs[r] @ ws[r] and two bounds on an fp32 result's
    error, from a = sum_r |xs[r]| @ |ws[r]| and K_total, the length of
    the whole sum:
    - worst case: 2 K_total 2^-24 a, which no fp32 order can exceed;
    - spread: sqrt(K_total) 2^-24 a, the reach of rounding errors that
      add as a random walk.  An fp32 product stays far inside it, one
      that rounds its operands to TF32 or bf16 does not (the controls
      of check_fused_kernels measure both).
    xs[r] may carry leading batch dimensions."""
    ref = absref = None
    for x, w in zip(xs, ws):
        xd, wd = x.double(), w.double()
        p, a = xd @ wd, xd.abs() @ wd.abs()
        ref = p if ref is None else ref + p
        absref = a if absref is None else absref + a
    k_total = len(xs) * xs[0].shape[-1]
    return (ref, 2 * k_total * 2.0 ** -24 * absref,
            np.sqrt(k_total) * 2.0 ** -24 * absref)


def within_bound(got, ref, bound) -> bool:
    return bool(((got.double() - ref).abs() <= bound).all())


def spread_ratio(got, want, spread) -> float:
    """max |got - want| / spread, elementwise."""
    return float(((got.double() - want.double()).abs() / spread).max())


def hold(what, got, plain, ref, worst, spread) -> float:
    """An fp32-accumulating result on N(0, 1) inputs: within the worst
    case of float64, and within the fp32 spread of its plain version.
    Returns max |got - plain|."""
    if not within_bound(got, ref, worst):
        fail(f"{what}: outside the dot-product bound of float64 (max abs "
             f"err {max_err(got, ref)})")
    if not within_bound(got, plain.double(), spread):
        fail(f"{what}: off its plain version by more than the fp32 spread "
             f"sqrt(K) 2^-24 (|x|@|w|) (max abs err {max_err(got, plain)}, "
             f"{spread_ratio(got, plain, spread)} of the spread): does it "
             f"round its operands?")
    return max_err(got, plain)


def controls(plain_fn, xs, ws, plain, spread) -> dict:
    """What the spread check reads on the plain version computed with
    reduced-precision operands, the faults it is there to catch: bf16
    operands, which must read above 1 (outside the spread) or the check
    proves nothing, and TF32 (cuBLAS with allow_tf32), printed beside."""
    got = {}
    bf = plain_fn([x.bfloat16() for x in xs], [w.bfloat16() for w in ws])
    got["bf16_operands"] = max(spread_ratio(b, p, s)
                               for b, p, s in zip(bf, plain, spread))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = plain_fn(xs, ws)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got["tf32"] = max(spread_ratio(t, p, s)
                      for t, p, s in zip(tf, plain, spread))
    if not got["bf16_operands"] > 1:
        fail(f"the spread check does not catch bf16 operands: they read "
             f"{got['bf16_operands']} of the spread")
    return got


def check_fused_kernels(F) -> dict:
    """Phase 3, matmul kernels: accl_matmul and accl_fused_matmul_rs
    against their plain versions at every shape the tensor-parallel path
    gives them (A: M and M / (P C) rows; B: m = M / P) and a ragged one,
    f32 and bf16: bitwise on integer-valued inputs; on N(0, 1) inputs
    within the worst case of float64 and the fp32 spread of the plain
    version (``hold``).  Returns the largest |kernel - plain| per kernel
    on the random inputs, the spread ratios per kernel and those of the
    reduced-precision controls."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs = {"pallas_matmul": 0.0, "fused_matmul_reduce_scatter": 0.0}
    ratios = {"pallas_matmul": 0.0, "fused_matmul_reduce_scatter": 0.0}
    ctl = {}

    def a_plain(xs, ws):
        return [F.pallas_matmul_plain(xs[0], ws[0])]

    for M, K, N in (*TP_SHAPES.values(), RAGGED_MKN):
        a_rows = (M, M // (P * CHUNKS)) if (M, K, N) != RAGGED_MKN else (M,)
        m = M // P
        for dt in (torch.float32, torch.bfloat16):
            for rows in a_rows:
                tag = f"pallas_matmul [{rows},{K}]@[{K},{N}] {dt}"
                x, w = ints((rows, K), dt, gen), ints((K, N), dt, gen)
                got = F.pallas_matmul(x, w)
                torch.cuda.synchronize()
                if not torch.equal(got, F.pallas_matmul_plain(x, w)):
                    fail(f"{tag}: integer inputs not bitwise equal to the "
                         f"plain version")
                x, w = rand((rows, K), dt, gen), rand((K, N), dt, gen)
                got = F.pallas_matmul(x, w)
                torch.cuda.synchronize()
                plain = F.pallas_matmul_plain(x, w)
                ref, worst, spread = ref64([x], [w])
                errs["pallas_matmul"] = max(errs["pallas_matmul"], hold(
                    tag, got, plain, ref, worst, spread))
                ratios["pallas_matmul"] = max(ratios["pallas_matmul"],
                                              spread_ratio(got, plain, spread))
                if dt == torch.float32 and rows == M:
                    ctl[f"pallas_matmul [{M},{K}]@[{K},{N}]"] = controls(
                        a_plain, [x], [w], [plain], [spread])
                del x, w, got, plain, ref, worst, spread

            tag = (f"fused_matmul_reduce_scatter P={P} x [{P},{m},{K}] @ "
                   f"[{K},{N}] {dt}")
            xs = [ints((P, m, K), dt, gen) for _ in range(P)]
            ws = [ints((K, N), dt, gen) for _ in range(P)]
            got = F.fused_matmul_reduce_scatter(xs, ws)
            torch.cuda.synchronize()
            want = F.fused_matmul_reduce_scatter_plain(xs, ws)
            if not all(torch.equal(g, v) for g, v in zip(got, want)):
                fail(f"{tag}: integer inputs not bitwise equal to the plain "
                     f"version")
            xs = [rand((P, m, K), dt, gen) for _ in range(P)]
            ws = [rand((K, N), dt, gen) for _ in range(P)]
            got = F.fused_matmul_reduce_scatter(xs, ws)
            torch.cuda.synchronize()
            want = F.fused_matmul_reduce_scatter_plain(xs, ws)
            ref, worst, spread = ref64(xs, ws)  # [P, m, N]: block r is rank r's
            for r in range(P):
                errs["fused_matmul_reduce_scatter"] = max(
                    errs["fused_matmul_reduce_scatter"],
                    hold(f"{tag} rank {r}", got[r], want[r], ref[r], worst[r],
                         spread[r]))
                ratios["fused_matmul_reduce_scatter"] = max(
                    ratios["fused_matmul_reduce_scatter"],
                    spread_ratio(got[r], want[r], spread[r]))
            if dt == torch.float32 and (M, K, N) != RAGGED_MKN:
                ctl[f"fused_matmul_reduce_scatter [{P},{m},{K}]@[{K},{N}]"] = \
                    controls(F.fused_matmul_reduce_scatter_plain, xs, ws,
                             want, list(spread))
            del xs, ws, got, want, ref, worst, spread
    torch.cuda.empty_cache()
    emit({"phase": "matmul_kernels_vs_plain", "ok": True,
          "max_abs_err_vs_plain": errs, "max_spread_ratio": ratios,
          "control_spread_ratios": ctl})
    return errs


def tensor_core_ops(lib_path) -> int:
    """Tensor-core instructions (HMMA, HGMMA, IMMA) in a built library's
    SASS: the matmul kernels must multiply in full fp32."""
    from accl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "Function" not in out.stdout:
        fail(f"cuobjdump -sass {lib_path}: {out.stderr.strip()[:500]}")
    return len(re.findall(r"\b(?:HMMA|HGMMA|IMMA)\b", out.stdout))


#: a flash backward kernel's mangled symbol: name, element type, D
BWD_KERNEL_SYMBOL = r"(flash_bwd_(?:dq|dkv)_[fm]ma)I(f|13__nv_bfloat16)Li(\d+)E"


def tensor_core_ops_by_function(lib_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA, IMMA) per kernel of a built
    library's SASS, by the kernel's name as it appears in the mangled
    symbol, with its template arguments: flash_bwd_dq_mma<float, 128>."""
    from accl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "Function" not in out.stdout:
        fail(f"cuobjdump -sass {lib_path}: {out.stderr.strip()[:500]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.search(BWD_KERNEL_SYMBOL, part.split()[0])
        name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                f"{m.group(3)}>") if m else part.split()[0]
        counts[name] = len(re.findall(r"\b(?:HMMA|HGMMA|IMMA)\b", part))
    return counts


def check_flash_bwd_sass(lib_path) -> dict:
    """The flash backward kernels' tensor-core instructions per
    instantiation: the fp32 mainloop (``*_fma``, the float32 MXU dtype)
    must hold none, the bf16 one (``*_mma``) some."""
    counts = {k: v for k, v in tensor_core_ops_by_function(lib_path).items()
              if k.startswith("flash_bwd_")}
    fma = {k: v for k, v in counts.items() if "_fma<" in k}
    mma = {k: v for k, v in counts.items() if "_mma<" in k}
    if len(fma) != 12 or len(mma) != 12:
        fail(f"flash_bwd SASS: expected 12 fp32 and 12 bf16-MXU kernels, "
             f"found {sorted(counts)}")
    if any(fma.values()) or not all(mma.values()):
        fail(f"flash_bwd SASS: the fp32 kernels must hold no tensor-core "
             f"instruction and the bf16-MXU ones some: {counts}")
    return counts


#: the kernels of csrc/fused.cu in the order accl_fused_kernel_info numbers
#: them
FUSED_KERNEL_NAMES = ("matmul_kernel<float, 128>", "matmul_kernel<float, 64>",
                      "matmul_kernel<bf16, 128>", "matmul_kernel<bf16, 64>",
                      "fused_matmul_rs_kernel<float>",
                      "fused_matmul_rs_kernel<bf16>")


def fused_kernel_info(F) -> dict:
    """Registers, spill (local) bytes, static and dynamic shared memory and
    resident blocks per SM of each matmul kernel, as the runtime reports
    them at the footprint it is launched with."""
    import ctypes

    from accl_tpu_torch.ops import _build

    lib = _build.load("fused")
    info = {}
    for which, name in enumerate(FUSED_KERNEL_NAMES):
        out = (ctypes.c_int * 5)()
        rc = lib.accl_fused_kernel_info(which, torch.cuda.current_device(),
                                        out)
        if rc:
            F._raise_on(lib, rc, f"accl_fused_kernel_info {name}")
        info[name] = dict(zip(("registers", "local_bytes", "static_smem",
                               "dynamic_smem", "blocks_per_sm"), out))
        if info[name]["blocks_per_sm"] < 1:
            fail(f"{name} does not fit on an SM: {info[name]}")
    return info


def reset_counts(ring, F, FL=None, PL=None) -> None:
    """Every launch count to 0: the ring and matmul wrappers, the flash
    wrappers (FL) and the plugin wrappers (PL, name -> wrapper)."""
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather,
               F.pallas_matmul, F.fused_matmul_reduce_scatter):
        fn.launches = 0
    if FL is not None:
        for fn in FLASH_KERNELS:
            getattr(FL, fn).launches = 0
    for fn in (PL or {}).values():
        fn.launches = 0


def read_counts(ring, F, FL=None, PL=None) -> dict:
    counts = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
              "ring_all_gather": ring.ring_all_gather.launches,
              "pallas_matmul": F.pallas_matmul.launches,
              "fused_matmul_reduce_scatter":
                  F.fused_matmul_reduce_scatter.launches}
    if FL is not None:
        counts.update({fn: getattr(FL, fn).launches for fn in FLASH_KERNELS})
    counts.update({name: fn.launches for name, fn in (PL or {}).items()})
    return counts


def tp_path(ring, F) -> dict:
    """Phase 4b: the fused tensor-parallel matmul at Llama-3-8B's TP=8
    widths, 8 rank lists.  Each form's result is held to the float64 sum
    and to the same form built from the plain versions (``hold``).
    Returns the launches of the run and those of one
    fused_matmul_allreduce_pallas call at the MLP-down shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    inputs = {}
    for name, (M, K, N) in TP_SHAPES.items():
        inputs[name] = ([rand((M, K), torch.float32, gen) for _ in range(P)],
                        [rand((K, N), torch.float32, gen) for _ in range(P)])
    torch.cuda.synchronize()

    def pallas_plain(xs, ws):
        M, K = xs[0].shape
        mine = F.fused_matmul_reduce_scatter_plain(
            [x.view(P, M // P, K) for x in xs], ws)
        return [g.view(M, -1) for g in
                ring.ring_all_gather_plain([b.view(-1) for b in mine])]

    forms = {
        "fused_matmul_allreduce_pallas": (
            F.fused_matmul_allreduce_pallas, pallas_plain),
        f"fused_matmul_allreduce_chunks{CHUNKS}": (
            lambda xs, ws: F.fused_matmul_allreduce(
                xs, ws, use_pallas=True, chunks=CHUNKS),
            lambda xs, ws: F.fused_matmul_allreduce(
                xs, ws, use_pallas=False, chunks=CHUNKS))}
    per_call = {}
    reset_counts(ring, F)
    for name, (xs, ws) in inputs.items():
        ref, worst, spread = ref64(xs, ws)
        for form, (run, run_plain) in forms.items():
            before = read_counts(ring, F)
            t0 = time.perf_counter()
            outs = run(xs, ws)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            after = read_counts(ring, F)
            launched = {k: after[k] - before[k] for k in after}
            if name == "mlp_down" and form == "fused_matmul_allreduce_pallas":
                per_call = launched
            plain = run_plain(xs, ws)
            err_plain = 0.0
            for r, o in enumerate(outs):
                if tuple(o.shape) != tuple(ref.shape) or \
                        not torch.isfinite(o).all():
                    fail(f"{form} {name} rank {r}: shape {tuple(o.shape)} or "
                         f"non-finite values")
                err_plain = max(err_plain, hold(f"{form} {name} rank {r}", o,
                                                plain[r], ref, worst, spread))
                if not torch.equal(o, outs[0]):
                    fail(f"{form} {name}: rank {r} differs from rank 0")
            emit({"phase": "tp_path", "shape": name, "form": form,
                  "M_K_N_per_rank": list(TP_SHAPES[name]), "ranks": P,
                  "max_abs_err_vs_f64": max_err(outs[0], ref),
                  "max_abs_err_vs_plain": err_plain,
                  "max_spread_ratio_vs_plain": spread_ratio(outs[0], plain[0],
                                                            spread),
                  "launches": launched, "first_call_s": first_s, "ok": True})
            del outs, plain
        del ref, worst, spread
    launches = read_counts(ring, F)
    for k in ("pallas_matmul", "fused_matmul_reduce_scatter",
              "ring_all_gather"):
        if launches[k] < 1:
            fail(f"the tensor-parallel path did not launch {k}: {launches}")
    del inputs
    torch.cuda.empty_cache()
    return {"launches": launches, "per_call_mlp_down": per_call}


def lane_bufs(world, in_len, out_len, gen):
    sends = [world.accls[r].create_buffer(in_len, np.float32)
             for r in range(P)]
    recvs = [world.accls[r].create_buffer(out_len, np.float32)
             for r in range(P)]
    fill(sends, gen)
    return sends, recvs


def driver_lanes(world, ring, F, q_ops, DataType, CompressionPolicy) -> dict:
    """Phase 4c: the fused and int8 driver lanes at LANE_MIB per rank on
    the same world, each checked against the lossless ring lane (fused)
    or the plain int8 composition (int8).  Returns, per lane, the call
    that runs it and its busbw factor, for phase 5."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    count = LANE_MIB * MIB // 4
    n = count // P
    ar_s, ar_r = lane_bufs(world, count, count, gen)
    rs_s, rs_r = lane_bufs(world, count, n, gen)
    ag_s, ag_r = lane_bufs(world, n, count, gen)
    outs = {}
    torch.cuda.synchronize()
    reset_counts(ring, F)

    def caller(kind, sends, recvs, cnt, **kw):
        def call(accl, rank):
            getattr(accl, kind)(sends[rank], recvs[rank], cnt,
                                from_fpga=True, to_fpga=True, **kw)
        return call

    def ef_policy(on):
        pol = CompressionPolicy(dtype=DataType.int8, error_feedback=True)
        for a in world.accls:
            a.set_compression(pol if on else None)

    i8 = DataType.int8
    lanes = {
        "ring_allreduce": (caller("allreduce", ar_s, ar_r, count), ar_r,
                           2 * (P - 1) / P, False),
        "fused_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                   fused=True), ar_r, 2 * (P - 1) / P, False),
        "int8_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                  compress_dtype=i8), ar_r, 2 * (P - 1) / P,
                           False),
        "int8_ef_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                     compress_dtype=i8), ar_r,
                              2 * (P - 1) / P, True),
        "ring_reduce_scatter": (caller("reduce_scatter", rs_s, rs_r, n),
                                rs_r, (P - 1) / P, False),
        "fused_reduce_scatter": (caller("reduce_scatter", rs_s, rs_r, n,
                                        fused=True), rs_r, (P - 1) / P, False),
        "ring_allgather": (caller("allgather", ag_s, ag_r, n), ag_r,
                           (P - 1) / P, False),
        "fused_allgather": (caller("allgather", ag_s, ag_r, n, fused=True),
                            ag_r, (P - 1) / P, False),
    }
    for name, (call, recvs, _bus, ef) in lanes.items():
        ef_policy(ef)
        before = read_counts(ring, F)
        t0 = time.perf_counter()
        world.run(call)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        after = read_counts(ring, F)
        ef_policy(False)
        outs[name] = [r.dev.clone() for r in recvs]
        emit({"phase": "driver_lane_run", "lane": name,
              "mib_per_rank": LANE_MIB, "first_call_s": first_s,
              "launches": {k: after[k] - before[k] for k in after}})
    launches = read_counts(ring, F)

    xs = [b.dev for b in ar_s]
    one_segment = ring.ring_all_reduce_segmented(xs, "sum",
                                                 seg_elems=count, plain=True)
    full = torch.stack([x.double() for x in xs]).sum(0)
    checks = (("fused_allreduce", one_segment),
              ("fused_reduce_scatter", outs["ring_reduce_scatter"]),
              ("fused_allgather", outs["ring_allgather"]))
    for name, want in checks:
        for r in range(P):
            if not torch.equal(outs[name][r], want[r]):
                fail(f"{name} rank {r}: not bitwise equal to the ring lane "
                     f"(max abs err {max_err(outs[name][r], want[r])})")
    for r in range(P):
        if not torch.allclose(outs["fused_allreduce"][r].double(), full,
                              rtol=1e-5, atol=1e-5):
            fail(f"fused_allreduce rank {r}: off the float64 reference")
    del one_segment
    bound = P * (2 * 5 * np.sqrt(P) / 127)
    errs = {}
    for name, ef in (("int8_allreduce", False), ("int8_ef_allreduce", True)):
        want = q_ops.quantized_all_reduce(xs, q_ops.DEFAULT_BLOCK, ef)
        for r in range(P):
            if not torch.equal(outs[name][r], want[r]):
                fail(f"{name} rank {r}: not bitwise equal to the plain int8 "
                     f"composition")
        errs[name] = max_err(outs[name][0], full)
        if errs[name] > bound or not torch.isfinite(outs[name][0]).all():
            fail(f"{name}: max abs err {errs[name]} against float64 over "
                 f"the bound {bound}")
        del want
    if torch.equal(outs["int8_allreduce"][0], outs["int8_ef_allreduce"][0]):
        fail("error feedback left the int8 result unchanged")
    emit({"phase": "driver_lanes", "mib_per_rank": LANE_MIB, "ranks": P,
          "int8_max_abs_err_vs_f64": errs, "int8_err_bound": bound,
          "launches": launches, "ok": True})
    del outs, full
    torch.cuda.empty_cache()
    return {"lanes": {k: (v[0], v[2], v[3]) for k, v in lanes.items()},
            "set_ef": ef_policy, "launches": launches}


def time_lanes(world, lanes, set_ef) -> list:
    """Phase 5c: seconds per call and busbw of each lane at LANE_MIB per
    rank, host clock around calls that end in a synchronize."""
    rows = []
    for name, (call, bus, ef) in lanes.items():
        set_ef(ef)
        world.run(call)
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(3):
                world.run(call)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) / 3)
        set_ef(False)
        s = statistics.median(samples)
        algbw = LANE_MIB * MIB / s / 1e9
        row = {"phase": "driver_lane_time", "lane": name,
               "mib_per_rank": LANE_MIB, "ranks": P, "s_per_call": s,
               "algbw_GBps": algbw, "busbw_GBps": algbw * bus}
        emit(row)
        rows.append(row)
    return rows


def matmul_bound(ops, nbytes, dt) -> tuple:
    """(bound ms, "operations" or "bytes") for ops on dt inputs moving
    nbytes."""
    peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
    ops_ms = ops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def time_matmul(F, rows, K, N, dt, gen, iters) -> dict:
    """accl_matmul on [rows, K] @ [K, N] per launch, interleaved with its
    plain version (kernel, plain, plain, kernel), beside torch.matmul and
    the bound."""
    x, w = rand((rows, K), dt, gen), rand((K, N), dt, gen)
    out = torch.empty(rows, N, device="cuda")
    ms = [cuda_ms(lambda: F.pallas_matmul(x, w, out=out), iters)]
    plain = [cuda_ms(lambda: F.pallas_matmul_plain(x, w), iters)]
    plain.append(cuda_ms(lambda: F.pallas_matmul_plain(x, w), iters))
    ms.append(cuda_ms(lambda: F.pallas_matmul(x, w, out=out), iters))
    # device time with the stream held, apart from the host's enqueue
    split = split_ms(lambda: F.pallas_matmul(x, w, out=out), iters)
    lib = cuda_ms(lambda: torch.matmul(x, w), iters)
    el = torch.finfo(dt).bits // 8
    ops = 2 * rows * K * N
    bound, by = matmul_bound(ops, (rows * K + K * N) * el + rows * N * 4, dt)
    return {"shape": f"[{rows},{K}] @ [{K},{N}] {dt}",
            "ms": statistics.median(ms), "plain_ms": statistics.median(plain),
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "tflops": ops / (statistics.median(ms) * 1e-3) / 1e12,
            "device_ms": split["device_ms"],
            "host_enqueue_ms": split["host_enqueue_ms"],
            "plan": list(F._plan(rows, N, K, torch.cuda.current_device()))}


def time_fused_kernels(ring, F, errs, launches, per_call) -> list:
    """Phase 5b: the matmul kernels per launch at the MLP-down shapes the
    tensor-parallel path launches them at, f32 as there: accl_matmul on
    M / (P CHUNKS) = 128-row blocks (fused_matmul_allreduce(chunks=...)),
    with its time at M rows beside; accl_fused_matmul_rs at m = M / P.
    Each beside its plain version, its library yardstick and its bound;
    bf16 times are printed beside."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    M, K, N = TP_SHAPES["mlp_down"]
    m = M // P
    counts0 = read_counts(ring, F)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        el = torch.finfo(dt).bits // 8
        a_row = time_matmul(F, M // (P * CHUNKS), K, N, dt, gen, 20)
        a_full = time_matmul(F, M, K, N, dt, gen, 5)
        xs = [rand((P, m, K), dt, gen) for _ in range(P)]
        ws = [rand((K, N), dt, gen) for _ in range(P)]
        outs = [torch.empty(m, N, device="cuda") for _ in range(P)]
        # interleaved: kernel, plain, plain, kernel
        b_ms = [cuda_ms(lambda: F.fused_matmul_reduce_scatter(xs, ws, outs),
                        2, runs=3)]
        b_plain = [cuda_ms(lambda: F.fused_matmul_reduce_scatter_plain(
            xs, ws), 2, runs=3)]
        b_plain.append(cuda_ms(lambda: F.fused_matmul_reduce_scatter_plain(
            xs, ws), 2, runs=3))
        b_ms.append(cuda_ms(lambda: F.fused_matmul_reduce_scatter(
            xs, ws, outs), 2, runs=3))
        b_split = split_ms(lambda: F.fused_matmul_reduce_scatter(
            xs, ws, outs), 2, runs=3)

        def library_b():
            # each rank's P partials in one matmul, then the sum over ranks
            parts = torch.stack([torch.matmul(x.view(P * m, K), w)
                                 for x, w in zip(xs, ws)])
            return torch.sum(parts, dim=0).view(P, m, N)

        b_lib = cuda_ms(library_b, 2, runs=3)
        del xs, ws, outs
        torch.cuda.empty_cache()
        b_ops = 2 * P * P * m * K * N
        b_bound, b_by = matmul_bound(
            b_ops, (P * P * m * K + P * K * N) * el + P * m * N * 4, dt)
        lib_tag = " (bf16 out, tensor cores)" if dt == torch.bfloat16 else ""
        a_extra = {f"at_M{M}": {k: a_full[k] for k in
                                ("shape", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "tflops", "device_ms",
                                 "host_enqueue_ms", "plan")},
                   "device_ms": a_row["device_ms"],
                   "host_enqueue_ms": a_row["host_enqueue_ms"],
                   "plan": a_row["plan"]}
        b_row = {"shape": f"P={P} x [{P},{m},{K}] @ [{K},{N}] {dt}",
                 "ms": statistics.median(b_ms),
                 "plain_ms": statistics.median(b_plain), "library_ms": b_lib,
                 "bound_ms": b_bound, "bound_by": b_by,
                 "tflops": b_ops / (statistics.median(b_ms) * 1e-3) / 1e12}
        b_extra = {k: b_split[k] for k in ("device_ms", "host_enqueue_ms")}
        for name, t, kernel, fn_line, lib_call, extra in (
                ("pallas_matmul", a_row, "accl_matmul",
                 "accl_tpu/ops/fused.py:341", "torch.matmul", a_extra),
                ("fused_matmul_reduce_scatter", b_row,
                 "accl_fused_matmul_rs", "accl_tpu/ops/fused.py:476",
                 "torch.matmul per rank + torch.sum over ranks", b_extra)):
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/fused.cu",
                   "kernel": kernel, "replaces": fn_line,
                   "launches": launches[name],
                   "max_abs_err": errs[name], "ms": t["ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                   "library_call": lib_call + lib_tag, "checked": True,
                   "shape": t["shape"], "tflops": t["tflops"],
                   "launches_per_fused_matmul_allreduce_pallas_mlp_down":
                       per_call.get(name, 0), **extra}
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
    for fn, k in ((ring.ring_reduce_scatter, "ring_reduce_scatter"),
                  (ring.ring_all_gather, "ring_all_gather"),
                  (F.pallas_matmul, "pallas_matmul"),
                  (F.fused_matmul_reduce_scatter,
                   "fused_matmul_reduce_scatter")):
        fn.launches = counts0[k]  # the timing launches are not main-path
    return rows


def fill(bufs, gen):
    for b in bufs:
        b.dev.copy_(torch.randn(b.dev.shape[0], generator=gen, device="cuda"))


def main_path(ring, F, CudaWorld, ReduceFunction, sizes) -> dict:
    """Phase 4a: the driver's main path through ACCL on 8 rank threads."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    world = CudaWorld(P)  # the card, by default
    reset_counts(ring, F)
    per_size = {}
    try:
        # -- below the ring threshold: host-synced calls -----------------
        n = 4096
        host_in = [np.random.default_rng(SEED + r).standard_normal(
            n * P).astype(np.float32) for r in range(P)]

        def small(accl, rank):
            x = accl.create_buffer_like(host_in[rank])
            out = {}
            b = accl.create_buffer(n, np.float32)
            if rank == 3:
                b.host[:] = x.host[:n]
            accl.bcast(b, n, root=3)
            out["bcast"] = b.host.copy()
            g = accl.create_buffer(n * P, np.float32)
            accl.gather(x, g, n, root=0)
            out["gather"] = g.host.copy()
            s = accl.create_buffer(n, np.float32)
            accl.scatter(x, s, n, root=5)
            out["scatter"] = s.host.copy()
            a2a = accl.create_buffer(n * P, np.float32)
            accl.alltoall(x, a2a, n)
            out["alltoall"] = a2a.host.copy()
            ar = accl.create_buffer(n * P, np.float32)
            accl.allreduce(x, ar, n * P)
            out["allreduce"] = ar.host.copy()
            return out

        res = world.run(small)
        total = np.sum(np.stack(host_in).astype(np.float64), axis=0)
        for r in range(P):
            ok = (np.array_equal(res[r]["bcast"], host_in[3][:n])
                  and np.array_equal(res[r]["scatter"],
                                     host_in[5][r * n:(r + 1) * n])
                  and np.array_equal(res[r]["alltoall"], np.concatenate(
                      [host_in[s][r * n:(r + 1) * n] for s in range(P)]))
                  and np.allclose(res[r]["allreduce"], total, rtol=1e-5,
                                  atol=1e-5))
            if not ok:
                fail(f"small collectives: rank {r} result wrong")
        if not np.array_equal(res[0]["gather"], np.concatenate(
                [host_in[s][:n] for s in range(P)])):
            fail("small collectives: gather result wrong")
        small_launches = (ring.ring_reduce_scatter.launches,
                          ring.ring_all_gather.launches)
        if small_launches != (0, 0):
            fail(f"a payload below the threshold launched ring kernels "
                 f"{small_launches}")
        emit({"phase": "below_threshold", "ok": True})

        # -- the ring lane: device-resident calls ------------------------
        def ring_case(kind, nbytes, func=ReduceFunction.SUM):
            count = nbytes // 4
            m = count // P
            in_len = count
            out_len = count if kind == "allreduce" else (
                count * P if kind == "allgather" else m)
            cnt = m if kind == "reduce_scatter" else count
            sends = [world.accls[r].create_buffer(in_len, np.float32)
                     for r in range(P)]
            recvs = [world.accls[r].create_buffer(out_len, np.float32)
                     for r in range(P)]
            fill(sends, gen)
            torch.cuda.synchronize()
            before = (ring.ring_reduce_scatter.launches,
                      ring.ring_all_gather.launches)

            def call(accl, rank):
                fn = getattr(accl, kind)
                kw = {"from_fpga": True, "to_fpga": True}
                if kind != "allgather":
                    kw["function"] = func
                fn(sends[rank], recvs[rank], cnt, **kw)

            t0 = time.perf_counter()
            world.run(call)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launched = (ring.ring_reduce_scatter.launches - before[0],
                        ring.ring_all_gather.launches - before[1])
            # one launch per phase per call, whatever the segment count
            expect = {"allreduce": (1, 1), "allgather": (0, 1),
                      "reduce_scatter": (1, 0)}[kind]
            if launched != expect:
                fail(f"{kind} {nbytes // MIB} MiB launched (reduce-scatter, "
                     f"all-gather) = {launched}, not {expect}")
            xs = [b.dev for b in sends]
            red = "max" if func == ReduceFunction.MAX else "sum"
            if kind == "allreduce":
                want = ring.ring_all_reduce_segmented(xs, red, plain=True)
                stacked = torch.stack([x.double() for x in xs])
                ref = [stacked.amax(0) if red == "max" else stacked.sum(0)] * P
            elif kind == "allgather":
                want = ring.ring_all_gather_segmented(xs, plain=True)
                ref = [torch.cat(xs).double()] * P
            else:
                want = ring.ring_reduce_scatter_segmented(xs, red, plain=True)
                full = torch.stack([x.double() for x in xs]).sum(0)
                ref = [full[r * m:(r + 1) * m] for r in range(P)]
            for r in range(P):
                got = recvs[r].dev
                if not torch.equal(got, want[r]):
                    fail(f"{kind} {nbytes // MIB} MiB rank {r}: not bitwise "
                         f"equal to the plain composition "
                         f"(max abs err {max_err(got, want[r])})")
                if not torch.allclose(got.double(), ref[r], rtol=1e-5,
                                      atol=1e-5):
                    fail(f"{kind} {nbytes // MIB} MiB rank {r}: off the "
                         f"float64 reference")
                if not torch.isfinite(got).all():
                    fail(f"{kind}: non-finite output")
            del want, ref
            emit({"phase": "main_path", "collective": kind,
                  "func": red, "mib_per_rank": nbytes // MIB,
                  "launches": {"ring_reduce_scatter": launched[0],
                               "ring_all_gather": launched[1]},
                  "first_call_s": first_s, "ok": True})
            return sends, recvs, call, launched

        for mib in sizes:
            per_size[mib] = ring_case("allreduce", mib * MIB)
        other = 64 if 64 in sizes else sizes[0]
        ring_case("allreduce", other * MIB, ReduceFunction.MAX)
        ring_case("allgather", other * MIB)
        ring_case("reduce_scatter", other * MIB)
        launches = read_counts(ring, F)
        if min(launches["ring_reduce_scatter"],
               launches["ring_all_gather"]) < 1:
            fail(f"the main path did not launch every kernel: {launches}")
        return {"world": world, "launches": launches, "per_size": per_size}
    except BaseException:
        world.close()
        raise


def time_kernels(ring, errs, launches, per_big, big_mib, sizes) -> tuple:
    """Phase 5a: each ring kernel per launch at the main path's shapes,
    three ways: ``ms``, CUDA events around back-to-back launches (the
    slower of the device and the host); ``device_ms``, the same with the
    stream held until every launch is enqueued; ``host_enqueue_ms``, the
    host clock around the enqueues.  Then the device time of the
    segmented allreduce (one launch per phase) at each driver size.
    Returns (rows, allreduce device ms by MiB per rank)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = ring.DEFAULT_SEG_ELEMS // P
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    outs = [torch.empty(n, device="cuda") for _ in range(P)]
    stacked = torch.stack(xs)  # [rank, chunk, n]
    ag_in = [rand((n,), torch.float32, gen) for _ in range(P)]
    ag_out = [torch.empty(P, n, device="cuda") for _ in range(P)]
    rs_count0 = ring.ring_reduce_scatter.launches
    ag_count0 = ring.ring_all_gather.launches

    def gather_all(src, dst):
        # the all-gather of every rank: P gathers of the P blocks
        for r in range(P):
            torch.cat(src, out=dst[r].view(-1))

    def rs_call():
        ring.ring_reduce_scatter(xs, out=outs)

    def ag_call():
        ring.ring_all_gather(ag_in, out=ag_out)

    # interleaved: kernel, plain, plain, kernel
    rs_ms = [cuda_ms(rs_call, 50)]
    rs_plain = [cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20)]
    rs_plain.append(cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20))
    rs_ms.append(cuda_ms(rs_call, 50))
    rs_lib = cuda_ms(lambda: torch.sum(stacked, dim=0), 50)
    ag_ms = [cuda_ms(ag_call, 50)]
    ag_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20)]
    ag_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20))
    ag_ms.append(cuda_ms(ag_call, 50))
    ag_lib = cuda_ms(lambda: gather_all(ag_in, ag_out), 50)
    ag_lib_one = cuda_ms(lambda: torch.cat(ag_in), 50)
    split = {"ring_reduce_scatter": split_ms(rs_call, 50),
             "ring_all_gather": split_ms(ag_call, 50)}
    # the per-launch floor: the same hops at 256 elements per chunk, where
    # the bytes are negligible and the flag handshakes are all that is left
    tiny = [rand((P, 256), torch.float32, gen) for _ in range(P)]
    tiny_ag = [rand((256,), torch.float32, gen) for _ in range(P)]
    floor_fns = {"ring_reduce_scatter": lambda: ring.ring_reduce_scatter(tiny),
                 "ring_all_gather": lambda: ring.ring_all_gather(tiny_ag)}
    floor = {k: {"ms": cuda_ms(fn, 50), **split_ms(fn, 50)}
             for k, fn in floor_fns.items()}
    # the all-gather of fused_matmul_allreduce_pallas: [M / P, N] per rank
    tp_in = [rand((TP_GATHER_N,), torch.float32, gen) for _ in range(P)]
    tp_out = [torch.empty(P, TP_GATHER_N, device="cuda") for _ in range(P)]

    def tp_call():
        ring.ring_all_gather(tp_in, out=tp_out)

    tp_ms = [cuda_ms(tp_call, 5)]
    tp_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5)]
    tp_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5))
    tp_ms.append(cuda_ms(tp_call, 5))
    tp_lib = cuda_ms(lambda: gather_all(tp_in, tp_out), 5)
    tp_lib_one = cuda_ms(lambda: torch.cat(tp_in), 5)
    tp_split = split_ms(tp_call, 5)
    tp_bytes = (P + P * P) * TP_GATHER_N * 4
    at_tp = {"ring_reduce_scatter": {}, "ring_all_gather": {
        f"at_n{TP_GATHER_N}": {
            "shape": f"P={P} x [{TP_GATHER_N}] fp32 per launch",
            "ms": statistics.median(tp_ms),
            "device_ms": tp_split["device_ms"],
            "host_enqueue_ms": tp_split["host_enqueue_ms"],
            "plain_ms": statistics.median(tp_plain), "library_ms": tp_lib,
            "library_ms_one_rank": tp_lib_one,
            "bound_ms": tp_bytes / HBM_BYTES_PER_S * 1e3}}}
    del tp_in, tp_out
    # the driver's allreduce, kernels alone: both launches of one call
    ar_device = {}
    for mib in sizes:
        count = mib * MIB // 4
        ar_in = [rand((count,), torch.float32, gen) for _ in range(P)]
        ar_out = [torch.empty_like(x) for x in ar_in]

        def ar_call():
            ring.ring_all_reduce_segmented(ar_in, "sum", out=ar_out)

        before = (ring.ring_reduce_scatter.launches,
                  ring.ring_all_gather.launches)
        ar_call()
        per_call = [ring.ring_reduce_scatter.launches - before[0],
                    ring.ring_all_gather.launches - before[1]]
        t = split_ms(ar_call, 3, 3)
        ar_device[mib] = t["device_ms"]
        emit({"phase": "allreduce_kernels", "mib_per_rank": mib, "ranks": P,
              "launches_per_call": per_call,
              "device_ms": t["device_ms"],
              "host_enqueue_ms": t["host_enqueue_ms"],
              "bound_ms": 2 * (P + 1) * count * 4 / HBM_BYTES_PER_S * 1e3})
        del ar_in, ar_out
        torch.cuda.empty_cache()
    # the timing launches are not main-path launches
    ring.ring_reduce_scatter.launches = rs_count0
    ring.ring_all_gather.launches = ag_count0
    el = 4
    rs_bytes = P * P * n * el + P * n * el      # read operands, write chunks
    ag_bytes = P * n * el + P * P * n * el      # read blocks, write gathers
    rows = []
    for name, ms, plain, lib, lib_one, nbytes, src_line, lib_call in (
            ("ring_reduce_scatter", rs_ms, rs_plain, rs_lib, None, rs_bytes,
             "accl_tpu/ops/ring.py:274",
             "torch.sum(stack, dim=0): every rank's chunk"),
            ("ring_all_gather", ag_ms, ag_plain, ag_lib, ag_lib_one, ag_bytes,
             "accl_tpu/ops/ring.py:151",
             f"torch.cat(blocks, out=gather[r]) for each of the {P} ranks")):
        row = {"name": name, "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/ring.cu",
               "replaces": src_line, "launches": launches[name],
               "max_abs_err": errs[name], "ms": statistics.median(ms),
               "device_ms": split[name]["device_ms"],
               "host_enqueue_ms": split[name]["host_enqueue_ms"],
               "plain_ms": statistics.median(plain),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": lib,
               "library_call": lib_call, "checked": True,
               "shape": f"P={P} x [{P},{n}] fp32 per launch",
               "floor_at_n256": floor[name],
               f"launches_per_{big_mib}MiB_allreduce": per_big[name],
               **at_tp[name]}
        if lib_one is not None:
            row["library_ms_one_rank"] = lib_one
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    return rows, ar_device


#: Llama-3-8B at full width (Meta's config.json for meta-llama/Meta-Llama-3-8B:
#: hidden 4096, intermediate 14336, 32 query and 8 K/V heads of 128,
#: vocabulary 128256, RoPE theta 500000), depth cut from 32 layers to 4
#: (no kernel shape depends on depth; 5.6 GB of fp32 weights)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_layers=4, n_heads=32,
                 n_kv_heads=8, d_head=128, d_ff=14336, mlp="swiglu",
                 rope=True, rope_theta=500000.0, attn="flash",
                 dtype="float32")
#: one rank's flash launch at TP=8 (4 q heads over 1 K/V head): (q rows
#: N, K/V rows Nk, T) on 2 x 4096 tokens (resident) and 1 x 8192 (grid)
FLASH_RESIDENT = (8, 2, 4096)
FLASH_GRID = (4, 1, 8192)
D_HEAD = 128
#: (input dtype, MXU dtype) of the flash checks
FLASH_DTYPES = ((torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16))
#: max |kernel - plain| allowed on out and on lse, per MXU dtype, set from
#: the readings of the first card run (NVIDIA H100 80GB HBM3, 700 W): the
#: two fold in different orders and rescale their running max at other
#: columns (64 against the resolver's block_k).  float32: readings up to
#: 6.9e-7 (out) and 9.5e-7 (lse); the bf16-operand control read 9.0e-3
#: and above.  bfloat16: readings up to 3.9e-3 (one bf16 ulp of a bf16
#: output), the bound two ulps at |out| < 2
FLASH_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
#: max |logits - TP=8 flash forward's| of the serving path's other runs
#: (fused, dense, TP=1, teacher-forced prefill and decode), fp32 at
#: Llama-3-8B width (|logits| ~ 1), set from the first card run's
#: readings (2.7e-5 to 7.2e-5; NVIDIA H100 80GB HBM3, 700 W): the runs
#: sum the same products in other orders (per-rank partials, chunked
#: ring, other cuBLAS kernels at other row counts)
LOGIT_BOUND = 4e-4


def flash_cfg(FL, N, Nk, T, Tk, dt, mxu, kernel, causal, window=None):
    """The resolved schedule the packed entry would hand the kernels."""
    return FL._resolve_schedule(T, Tk, D_HEAD, dt, causal, 256, 512, mxu,
                                kernel, None, False, None, None,
                                window) + (N // Nk,)


def check_flash_kernels(FL) -> dict:
    """Phase 3c: flash_fwd_resident and flash_fwd_grid against their plain
    versions at the model path's per-rank shapes (resident: q [8, 4096,
    128], k/v [2, 4096, 128]; grid: q [4, 8192, 128], k/v [1, 8192, 128]),
    a windowed grid call, non-causal cross-length calls and a ragged call
    (T = 1200: the resolver's blocks halve to 16, the kernel's last 64-row
    tile is partial), in float32 with float32 and bfloat16 MXU dtypes and
    in bfloat16.  out and lse within FLASH_BOUND of the plain version; a
    control (the plain version with bf16-rounded operands against the
    float32 one) must fall outside the float32 bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    errs = {"flash_fwd_resident": 0.0, "flash_fwd_grid": 0.0}
    readings, controls_ = [], {}
    calls = (("model_resident", *FLASH_RESIDENT, FLASH_RESIDENT[2], True,
              None, "resident", FLASH_DTYPES),
             ("model_grid", *FLASH_GRID, FLASH_GRID[2], True, None, "grid",
              FLASH_DTYPES),
             ("window_1000", 4, 1, 2048, 2048, True, 1000, "grid",
              FLASH_DTYPES[::2]),
             ("cross_length", 8, 2, 1024, 1536, False, None, "resident",
              FLASH_DTYPES[::2]),
             ("cross_length", 8, 2, 1024, 1536, False, None, "grid",
              FLASH_DTYPES[::2]),
             ("ragged_1200", 8, 2, 1200, 1200, True, None, "resident",
              FLASH_DTYPES[:1]),
             ("ragged_1200", 8, 2, 1200, 1200, True, None, "grid",
              FLASH_DTYPES[:1]))
    for tag, N, Nk, T, Tk, causal, window, kernel, dtypes in calls:
        name = f"flash_fwd_{kernel}"
        fn, plain = getattr(FL, name), getattr(FL, name + "_plain")
        for dt, mxu in dtypes:
            q = rand((N, T, D_HEAD), dt, gen)
            k, v = rand((Nk, Tk, D_HEAD), dt, gen), rand((Nk, Tk, D_HEAD), dt,
                                                          gen)
            cfg = flash_cfg(FL, N, Nk, T, Tk, dt, mxu, kernel, causal, window)
            out, lse = fn(q, k, v, cfg)
            torch.cuda.synchronize()
            want, want_lse = plain(q, k, v, cfg)
            e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            row = {"call": tag, "kernel": name, "q": [N, T, D_HEAD],
                   "kv": [Nk, Tk, D_HEAD], "causal": causal,
                   "window": window, "dtype": str(dt), "mxu": str(mxu),
                   "blocks": list(cfg[1:4]), "ctas": FL.kernel_ctas(N, T),
                   "max_abs_err_out": e_out, "max_abs_err_lse": e_lse}
            readings.append(row)
            bound = FLASH_BOUND[mxu]
            if not finite or e_out > bound or e_lse > bound:
                fail(f"{name} {tag} {dt}/{mxu}: off its plain version "
                     f"(out {e_out}, lse {e_lse}, bound {bound}, finite "
                     f"{finite})")
            errs[name] = max(errs[name], e_out)
            if tag.startswith("model") and mxu == torch.float32:
                ctl_cfg = flash_cfg(FL, N, Nk, T, Tk, dt, torch.bfloat16,
                                    kernel, causal, window)
                c_out, c_lse = plain(q, k, v, ctl_cfg)
                controls_[f"{name} {tag}"] = {
                    "out": max_err(c_out, want), "lse": max_err(c_lse,
                                                                want_lse)}
                if not controls_[f"{name} {tag}"]["out"] > bound:
                    fail(f"the float32 bound {bound} does not catch bf16 "
                         f"operands: {controls_[f'{name} {tag}']}")
                del c_out, c_lse
            del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    emit({"phase": "flash_kernels_vs_plain", "ok": True, "bound": {
        str(k): b for k, b in FLASH_BOUND.items()}, "readings": readings,
          "bf16_operand_control": controls_})
    return errs


#: one rank's flash backward launch on the training path (dp 2 x tp 4,
#: 1 x 4096 tokens per dp member: 8 q heads over 2 K/V heads): (N, Nk, T)
FLASH_TRAIN = (8, 2, 4096)
#: max |kernel - plain| / max |plain| allowed on dq, dk and dv, per MXU
#: dtype.  float32: both sum the same fp32 products in other orders
#: (64-row tiles with FMAs against the plain version's blocks through
#: cuBLAS).  dk and dv sum G T = 16384 terms per element at the training
#: shape, whose rounding errors add as a random walk to ~sqrt(16384)
#: 2^-24 = 7.6e-6 of the largest partial sum; the bound is 4 times that,
#: 3e-5 (readings up to 6.7e-6 on the first card run, NVIDIA H100 80GB
#: HBM3, 700 W; the bf16-operand control read 2.5e-3 and above).
#: bfloat16: a P or dS entry whose fp32 value rounds to the other bf16
#: neighbour moves by one bf16 ulp (2^-8), and bf16 outputs round once
#: more: two bf16 ulps of the largest value, as FLASH_BOUND (readings up
#: to 2.7e-3)
BWD_BOUND = {torch.float32: 3e-5, torch.bfloat16: 1.6e-2}


#: the most a dK/dV item may hold of one SM's average work at FLASH_TRAIN
BWD_ITEM_SHARE_MAX = 1 / 3


def bwd_plan_reading(FL, N, Nk, T, Tk, causal, window, dt, mxu) -> dict:
    """What one backward launch pair runs: dq's CTAs, dK/dV's plan items,
    the heaviest item's steps against the average per SM, the split
    tiles, and the resident CTAs per SM of both kernels."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = FL.bwd_plan(N, Nk, T, Tk, causal, window or 0, sms, mxu)
    info = FL.bwd_kernel_info(D_HEAD, dt, mxu)
    per_sm = {k: v["ctas_per_sm"] for k, v in info.items()}
    return {"dq_ctas": plan.dq_ctas, "dkv_items": len(plan.items),
            "heaviest_item_steps": plan.heaviest,
            "steps_per_sm": plan.per_sm,
            "heaviest_share": plan.heaviest / plan.per_sm,
            "split_tiles": sum(p > 1 for p, _ in plan.tiles),
            "tiles": len(plan.tiles), "ctas_per_sm": per_sm,
            "dkv_waves": len(plan.items) / (sms * per_sm["flash_bwd_dkv"])}


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def bwd_operands(FL, N, Nk, T, Tk, dt, mxu, causal, window, g_lse, gen):
    """The backward kernels' operands as _FlashPacked.backward prepares
    them: a forward through the kernels on N(0, 1) q, k, v, an N(0, 1)
    dO and, with g_lse, an N(0, 1) lse cotangent."""
    q = rand((N, T, D_HEAD), dt, gen)
    k, v = rand((Nk, Tk, D_HEAD), dt, gen), rand((Nk, Tk, D_HEAD), dt, gen)
    cfg = flash_cfg(FL, N, Nk, T, Tk, dt, mxu, "auto", causal, window)
    out, lse = FL._flash_forward_impl(q, k, v, cfg)
    do = rand((N, T, D_HEAD), dt, gen)
    a = 1.0 / D_HEAD ** 0.5
    q2 = (q.float() * (a * FL._LOG2E)).to(dt)
    dvec = torch.sum(do.float() * out.float(), dim=-1)
    if g_lse:
        dvec = dvec - rand((N, T), torch.float32, gen)
    return (q2, k, v, do, (lse * FL._LOG2E).contiguous(),
            dvec.contiguous()), cfg


def check_flash_bwd_kernels(FL) -> dict:
    """Phase 3d: flash_bwd_dq and flash_bwd_dkv against their plain
    versions at the training path's per-rank shape (FLASH_TRAIN, causal,
    GQA group 4) with the lse cotangent zero and nonzero, a windowed call,
    a non-causal cross-length call and a ragged call (T = 1200: the
    resolver's blocks halve to 16, the kernels' last 64-row tile is
    partial), in float32 with float32 and bfloat16 MXU dtypes and in
    bfloat16.  dq, dk and dv finite and within BWD_BOUND of the plain
    version; a control (the plain version with bf16-rounded operands
    against the float32 one) must fall outside the float32 bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    errs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    readings, controls_ = [], {}
    N, Nk, T = FLASH_TRAIN
    calls = [("train", N, Nk, T, T, True, None, g, FLASH_DTYPES)
             for g in (False, True)]
    calls += [("window_1000", 4, 1, 2048, 2048, True, 1000, True,
               FLASH_DTYPES[::2]),
              ("cross_length", 8, 2, 1024, 1536, False, None, True,
               FLASH_DTYPES[::2]),
              ("ragged_1200", 8, 2, 1200, 1200, True, None, True,
               FLASH_DTYPES[:1])]
    for tag, N, Nk, T, Tk, causal, window, g_lse, dtypes in calls:
        for dt, mxu in dtypes:
            ops, cfg = bwd_operands(FL, N, Nk, T, Tk, dt, mxu, causal,
                                    window, g_lse, gen)
            plan = bwd_plan_reading(FL, N, Nk, T, Tk, causal, window, dt,
                                    mxu)
            if tag == "train" and plan["heaviest_share"] > BWD_ITEM_SHARE_MAX:
                fail(f"flash_bwd_dkv plan at {FLASH_TRAIN}: the heaviest "
                     f"item holds {plan['heaviest_share']:.3f} of an SM's "
                     f"average work (at most {BWD_ITEM_SHARE_MAX:.3f})")
            dq = FL.flash_bwd_dq(*ops, cfg)
            dk, dv = FL.flash_bwd_dkv(*ops, cfg)
            again = (FL.flash_bwd_dq(*ops, cfg), *FL.flash_bwd_dkv(*ops, cfg))
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip((dq, dk, dv), again)):
                fail(f"flash backward {tag} {dt}/{mxu}: two launches differ")
            del again
            want_dq = FL.flash_bwd_dq_plain(*ops, cfg)
            want_dk, want_dv = FL.flash_bwd_dkv_plain(*ops, cfg)
            e = {"dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk),
                 "dv": rel_err(dv, want_dv)}
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            readings.append({"call": tag, "q": [N, T, D_HEAD],
                             "kv": [Nk, Tk, D_HEAD], "causal": causal,
                             "window": window, "g_lse": g_lse,
                             "dtype": str(dt), "mxu": str(mxu),
                             "blocks": list(cfg[1:4]),
                             "plan": plan, "bitwise_repeat": True,
                             "rel_err": e,
                             "max_abs": {"dq": float(want_dq.abs().max()),
                                         "dk": float(want_dk.abs().max()),
                                         "dv": float(want_dv.abs().max())}})
            bound = BWD_BOUND[mxu]
            if not finite or max(e.values()) > bound:
                fail(f"flash backward {tag} {dt}/{mxu} g_lse={g_lse}: off "
                     f"the plain version ({e}, bound {bound}, finite "
                     f"{finite})")
            errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"],
                                       max_err(dq, want_dq))
            errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"],
                                        max_err(dk, want_dk),
                                        max_err(dv, want_dv))
            if tag == "train" and mxu == torch.float32:
                ctl_cfg = cfg[:4] + (torch.bfloat16,) + cfg[5:]
                c_dq = FL.flash_bwd_dq_plain(*ops, ctl_cfg)
                c_dk, c_dv = FL.flash_bwd_dkv_plain(*ops, ctl_cfg)
                ctl = {"dq": rel_err(c_dq, want_dq),
                       "dk": rel_err(c_dk, want_dk),
                       "dv": rel_err(c_dv, want_dv)}
                controls_[f"{tag} g_lse={g_lse}"] = ctl
                if not min(ctl.values()) > bound:
                    fail(f"the float32 bound {bound} does not catch bf16 "
                         f"operands: {ctl}")
                del c_dq, c_dk, c_dv
            del ops, dq, dk, dv, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()
    emit({"phase": "flash_bwd_kernels_vs_plain", "ok": True,
          "bound_rel_to_max": {str(k): b for k, b in BWD_BOUND.items()},
          "readings": readings, "bf16_operand_control": controls_})
    return errs


def serving_path(ring, F, FL, M) -> dict:
    """Phase 4d: the model's serving path at Llama-3-8B width (LLAMA3_8B,
    4 layers), TP=8 over rank lists, fp32, weights from a seed on the
    card.  Runs, each with every launch count set to 0 just before and
    read just after: the scoring forward on 2 x 4096 tokens (resident
    kernel), again with fused=True, with attn="dense", and at TP=1 on the
    same weights; the forward on 1 x 8192 tokens (grid kernel); and
    serving: generate for 4 requests of 128-token prompts, 32 new tokens,
    greedy, with prefill and decode_step timed alone.  Logits must be
    finite and within LOGIT_BOUND of the TP=8 flash forward (fused, dense,
    TP=1), teacher-forced decode within it of forward's, and every
    generated token the argmax of forward's logits where the top-2 margin
    exceeds it."""
    cfg = M.ModelConfig(**LLAMA3_8B)
    dense_cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p1 = M.init_params(gen, cfg, tp=1)
    p8 = M.shard_params(p1, cfg, P)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok4k = torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                          device="cuda")
    tok8k = torch.randint(0, cfg.vocab, (1, 8192), generator=gen,
                          device="cuda")
    total = {}
    runs = {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"first_call_s": secs, "launches": counts}
        return out

    def logit_err(got, ref):
        # float32 difference: a float64 copy of 4 GB logits would set the
        # phase's peak memory
        return float((got - ref).abs().max())

    def check(name, got, ref, bound):
        e = logit_err(got, ref)
        runs[name]["max_abs_err_vs_tp8_flash"] = e
        if tuple(got.shape) != tuple(ref.shape) or \
                not torch.isfinite(got).all() or e > bound:
            fail(f"{name}: logits {tuple(got.shape)} off the TP=8 flash "
                 f"forward by {e} (bound {bound}) or not finite")

    ref = run("forward_4096_tp8", lambda: M.forward(p8, tok4k, cfg))
    if not torch.isfinite(ref).all() or \
            tuple(ref.shape) != (*tok4k.shape, cfg.vocab):
        fail(f"forward_4096_tp8: logits {tuple(ref.shape)} not finite")
    check("forward_4096_tp8_fused", run(
        "forward_4096_tp8_fused", lambda: M.forward(p8, tok4k, cfg,
                                                    fused=True)),
          ref, LOGIT_BOUND)
    check("forward_4096_tp8_dense", run(
        "forward_4096_tp8_dense", lambda: M.forward(p8, tok4k, dense_cfg)),
          ref, LOGIT_BOUND)
    check("forward_4096_tp1", run(
        "forward_4096_tp1", lambda: M.forward(p1, tok4k, cfg)),
          ref, LOGIT_BOUND)
    del ref
    torch.cuda.empty_cache()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lg8k = run("forward_8192_tp8", lambda: M.forward(p8, tok8k, cfg))
    fwd_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    if not torch.isfinite(lg8k).all() or \
            tuple(lg8k.shape) != (*tok8k.shape, cfg.vocab):
        fail("forward_8192_tp8: logits not finite or of the wrong shape")
    del lg8k
    torch.cuda.empty_cache()
    per_forward = {"flash_fwd_resident":
                   runs["forward_4096_tp8"]["launches"]["flash_fwd_resident"],
                   "flash_fwd_grid":
                   runs["forward_8192_tp8"]["launches"]["flash_fwd_grid"]}
    if per_forward != {"flash_fwd_resident": cfg.n_layers * P,
                       "flash_fwd_grid": cfg.n_layers * P}:
        fail(f"the 4096-token forward must launch flash_fwd_resident and "
             f"the 8192-token one flash_fwd_grid once per layer and rank: "
             f"{per_forward}")
    if runs["forward_4096_tp8"]["launches"]["flash_fwd_grid"] or \
            runs["forward_8192_tp8"]["launches"]["flash_fwd_resident"]:
        fail(f"a forward launched the other flash kernel: {runs}")

    # -- serving: 4 requests, 128-token prompts, 32 new tokens ------------
    B, Tp, new = 4, 128, 32
    prompt = torch.randint(0, cfg.vocab, (B, Tp), generator=gen,
                           device="cuda")
    Tp = prompt.shape[1]
    cont = torch.randint(0, cfg.vocab, (B, 8), generator=gen, device="cuda")
    generated = run("generate", lambda: M.generate(p8, prompt, cfg, new))
    if tuple(generated.shape) != (B, new) or int(generated.min()) < 0 or \
            int(generated.max()) >= cfg.vocab:
        fail(f"generate: tokens {tuple(generated.shape)} out of range")

    def serve_prefill():
        cache = M.init_kv_cache(cfg, B, Tp + cont.shape[1], tp=P)
        return M.prefill(p8, prompt, cache, cfg)

    lg_pre, cache = run("prefill", serve_prefill)
    steps = []
    for t in range(cont.shape[1]):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        lg, cache = M.decode_step(p8, cont[:, t], cache, cfg)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step, lg))
    teacher = torch.cat([prompt, cont], dim=1)
    want = run("forward_teacher", lambda: M.forward(p8, teacher, cfg))
    e_pre = logit_err(lg_pre, want[:, :Tp])
    e_dec = max(logit_err(lg, want[:, Tp + t]) for t, (_s, lg) in
                enumerate(steps))
    if e_pre > LOGIT_BOUND or e_dec > LOGIT_BOUND:
        fail(f"teacher-forced prefill/decode off forward's logits: "
             f"{e_pre}, {e_dec} (bound {LOGIT_BOUND})")
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
    lg_seq = run("forward_generated", lambda: M.forward(p8, seq, cfg))[
        :, Tp - 1:]
    top2 = torch.topk(lg_seq, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > LOGIT_BOUND
    agree = lg_seq.argmax(-1) == generated
    if not bool(agree[decided].all()):
        fail("generate: a greedy token differs from forward's argmax where "
             "the top-2 margin exceeds the logit bound")
    ms_step = statistics.median(s for s, _lg in steps) * 1e3
    emit({"phase": "serving_path", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "tp": P, "init_s": init_s,
          "runs": runs, "launches": total, "per_forward": per_forward,
          "prefill_tokens_per_s": B * Tp / runs["prefill"]["first_call_s"],
          "ms_per_decode_step": ms_step,
          "generate_s": runs["generate"]["first_call_s"],
          "teacher_forced_max_abs_err": {"prefill": e_pre, "decode": e_dec},
          "greedy_tokens_checked": int(decided.sum()),
          "weights_gb": sum(t.numel() * 4 for t in (
              p1["embed"], *(w for blk in p1["blocks"] for leaf in
                             blk.values() for w in (leaf if isinstance(
                                 leaf, list) else [leaf])))) / 1e9,
          "forward_8192_peak_gb_above_held": fwd_peak,
          "peak_mem_gb": max(peak_before,
                             torch.cuda.max_memory_allocated()) / 1e9})
    del p1, p8, want, lg_seq, steps, cache
    torch.cuda.empty_cache()
    return {"launches": total, "per_forward": per_forward}


#: the training path's learning rate: large enough that each leaf's
#: update stands well above the fp32 rounding of the parameter it is
#: added to (so the gradient can be recovered from it), small enough that
#: plain SGD on a repeated batch still descends
TRAIN_LR = 1.0
TRAIN_STEPS = 3
#: relative bound on the first step's loss against the same step with
#: attn="dense" (fp32 both; the two sum the attention in other orders)
TRAIN_LOSS_BOUND = 1e-5
#: relative L2 bound on each leaf's gradient against the dense step's,
#: recovered as (p - p') / lr; a wrong dQ or dK/dV gives O(1) there.  The
#: fp32 rounding of each update p - lr g is added on top per leaf:
#: 2 ||ulp(p) / 2|| / ||p - p'|| (two independent roundings)
TRAIN_GRAD_BOUND = 1e-3
#: the same step with remat=True: the same kernels on the same values
REMAT_BOUND = 1e-6


def train_path(ring, F, FL, M, S, TE, T_) -> dict:
    """Phase 4e: the model's training path at Llama-3-8B width (LLAMA3_8B,
    4 layers), make_train_step on make_mesh(dp=2, tp=4), fp32, 1 x 4096
    tokens per dp member, weights from a seed on the card.  Runs, each
    with every launch count set to 0 just before and read just after:
    TRAIN_STEPS flash steps on one repeated batch, the first of them also
    as a dense + remat step, a flash + remat step and an int8 + EF synced
    step from the same weights."""
    cfg = M.ModelConfig(**LLAMA3_8B)
    mesh = S.make_mesh(dp=2, tp=4)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    torch.cuda.empty_cache()
    p0 = M.init_params(gen, cfg, tp=tp)
    tokens = torch.randint(0, cfg.vocab, (dp, 4096), generator=gen,
                           device="cuda")
    n_tok = tokens.numel()
    torch.cuda.synchronize()
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"s": secs, "launches": counts}
        return out

    def stepper(c):
        return M.make_train_step(mesh, c, lr=TRAIN_LR)[0]

    # -- the first flash step, from a copy of p0 -------------------------
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = T_.tree_map(torch.clone, p0)
    step = stepper(cfg)
    params, loss = run("step_1", lambda: step(params, tokens))
    peak_step = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = [float(loss)]

    def compare(p_other):
        """Per leaf (d, floor, ||Delta||): d = ||Delta - Delta'|| /
        ||Delta||, Delta = p0 - p after the flash step and Delta' the
        other step's, both exact fp32 differences of nearby values; floor
        = 2 ||ulp(p0) / 2|| / ||Delta||.  Squares are summed in float64
        over chunks, so no float64 copy of a 2 GB leaf is made."""
        out = []
        for a, b, z in zip(T_.tree_leaves(params), T_.tree_leaves(p_other),
                           T_.tree_leaves(p0)):
            a, b, z = a.reshape(-1), b.reshape(-1), z.reshape(-1)
            sums = np.zeros(3)
            for i in range(0, z.numel(), 1 << 26):
                za, aa, bb = (t[i:i + (1 << 26)] for t in (z, a, b))
                ulp = torch.nextafter(za, torch.full_like(za, np.inf)) - za
                sums += [float(((za - aa).double() ** 2).sum()),
                         float(((aa - bb).double() ** 2).sum()),
                         float(((ulp / 2).double() ** 2).sum())]
            nd, diff, half_ulp = np.sqrt(sums)
            out.append((diff / max(nd, 1e-300), 2 * half_ulp / max(nd, 1e-300),
                        nd))
        return out

    # -- the same step with attn="dense" and remat -----------------------
    dense_cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense",
                                 "remat": True})
    other = T_.tree_map(torch.clone, p0)
    dstep = stepper(dense_cfg)
    other, dloss = run("step_1_dense_remat", lambda: dstep(other, tokens))
    dense_cmp = compare(other)
    loss_err = abs(float(dloss) - losses[0]) / abs(losses[0])
    worst = max(d - (TRAIN_GRAD_BOUND + f) for d, f, _n in dense_cmp)
    if loss_err > TRAIN_LOSS_BOUND or worst > 0:
        fail(f"the flash train step is off the dense one: loss {loss_err} "
             f"(bound {TRAIN_LOSS_BOUND}), per-leaf gradient "
             f"{[(d, TRAIN_GRAD_BOUND + f) for d, f, _n in dense_cmp]}")
    del other
    torch.cuda.empty_cache()

    # -- the same step with remat ----------------------------------------
    remat_cfg = M.ModelConfig(**{**LLAMA3_8B, "remat": True})
    other = T_.tree_map(torch.clone, p0)
    rstep = stepper(remat_cfg)
    other, rloss = run("step_1_remat", lambda: rstep(other, tokens))
    remat_cmp = compare(other)
    remat_loss_err = abs(float(rloss) - losses[0]) / abs(losses[0])
    if remat_loss_err > REMAT_BOUND or \
            max(d for d, _f, _n in remat_cmp) > REMAT_BOUND:
        fail(f"the remat train step is off the plain one: loss "
             f"{remat_loss_err}, per-leaf {[d for d, _f, _n in remat_cmp]} "
             f"(bound {REMAT_BOUND})")
    del other
    torch.cuda.empty_cache()

    # -- one int8 + EF synced step ---------------------------------------
    other = T_.tree_map(torch.clone, p0)
    qstep = TE._make_step(cfg, "int8_ef", TRAIN_LR, dp)
    other, qloss0 = run("step_1_int8_ef",
                        lambda: qstep(other, tokens.view(dp, 1, -1)))
    with torch.no_grad():
        s_, c_ = M.loss_fn(other, tokens, cfg)
    int8_loss_after = float(s_ / c_)
    del other, s_, c_
    torch.cuda.empty_cache()

    # -- the rest of the run ---------------------------------------------
    for i in range(2, TRAIN_STEPS + 1):
        params, loss = run(f"step_{i}", lambda: step(params, tokens))
        losses.append(float(loss))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    if not all(np.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"training: losses {losses} not finite or not falling")
    int8_dev = abs(int8_loss_after - losses[1])
    if abs(float(qloss0) - losses[0]) > TE.TRACK_TOL or \
            int8_dev > TE.TRACK_TOL:
        fail(f"the int8 + EF step: loss after it {int8_loss_after} against "
             f"the fp32 run's {losses[1]} (TRACK_TOL {TE.TRACK_TOL})")
    per_step = {k: runs["step_1"]["launches"][k] for k in
                ("flash_fwd_resident", "flash_bwd_dq", "flash_bwd_dkv")}
    want = cfg.n_layers * dp * tp
    for i in range(1, TRAIN_STEPS + 1):
        got = {k: runs[f"step_{i}"]["launches"][k] for k in per_step}
        if got != dict.fromkeys(per_step, want):
            fail(f"training step {i} must launch each flash kernel {want} "
                 f"times (layers x dp x tp): {got}")
    step_s = [runs[f"step_{i}"]["s"] for i in range(1, TRAIN_STEPS + 1)]
    emit({"phase": "train_path", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "mesh": mesh.shape,
          "tokens_per_step": n_tok, "lr": TRAIN_LR, "losses": losses,
          "s_per_step": step_s,
          "tokens_per_s": n_tok / statistics.median(step_s[1:]),
          "launches_per_step": per_step, "runs": runs, "launches": total,
          "dense_remat": {"loss_rel_err": loss_err,
                          "grad_rel_l2_max": max(d for d, _f, _n in
                                                 dense_cmp),
                          "rounding_floor_max": max(f for _d, f, _n in
                                                    dense_cmp),
                          "per_leaf": [[d, f] for d, f, _n in dense_cmp],
                          "bound": TRAIN_GRAD_BOUND},
          "remat": {"loss_rel_err": remat_loss_err,
                    "grad_rel_l2_max": max(d for d, _f, _n in remat_cmp),
                    "bound": REMAT_BOUND},
          "int8_ef": {"loss_after": int8_loss_after,
                      "fp32_loss_after": losses[1], "abs_dev": int8_dev,
                      "track_tol": TE.TRACK_TOL},
          "first_step_peak_gb_above_held": peak_step,
          "phase_peak_gb_above_held": peak, "held_gb": held / 1e9,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, p0
    torch.cuda.empty_cache()
    return {"launches": total, "per_step": per_step}


def attention_bound(N, T, Tk, causal, dt) -> tuple:
    """(bound ms, "operations" or "bytes") of one forward: QK^T and PV over
    the cells the mask keeps (T (T + 1) / 2 per head when causal), 2
    operations per multiply-add; q, k, v read and out, lse written once."""
    cells = T * (T + 1) // 2 if causal else T * Tk
    el = torch.finfo(dt).bits // 8
    ops = 2 * 2 * D_HEAD * cells * N
    nbytes = (2 * N * T * D_HEAD + 2 * N * Tk * D_HEAD) * el + N * T * 4
    return matmul_bound(ops, nbytes, dt) + (ops,)


def time_flash_kernels(FL, errs, launches, per_forward) -> list:
    """Phase 5d: each flash kernel per launch at the model path's per-rank
    shape, fp32 with the fp32 MXU dtype as there, interleaved with its
    plain version (kernel, plain, plain, kernel), beside SDPA with GQA
    (torch.nn.functional.scaled_dot_product_attention, a yardstick only)
    and the bound; bf16 inputs are printed beside."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for name, (N, Nk, T), kernel in (("flash_fwd_resident", FLASH_RESIDENT,
                                      "resident"),
                                     ("flash_fwd_grid", FLASH_GRID, "grid")):
        fn, plain = getattr(FL, name), getattr(FL, name + "_plain")
        for dt in (torch.float32, torch.bfloat16):
            q = rand((N, T, D_HEAD), dt, gen)
            k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt,
                                                         gen)
            cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, kernel, True)
            ms = [cuda_ms(lambda: fn(q, k, v, cfg), 5, runs=3)]
            p_ms = [cuda_ms(lambda: plain(q, k, v, cfg), 1, runs=3)]
            p_ms.append(cuda_ms(lambda: plain(q, k, v, cfg), 1, runs=3))
            ms.append(cuda_ms(lambda: fn(q, k, v, cfg), 5, runs=3))
            qs = q.view(Nk, N // Nk, T, D_HEAD)
            ks, vs = k.view(Nk, 1, T, D_HEAD), v.view(Nk, 1, T, D_HEAD)
            lib = cuda_ms(lambda: tnf.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 5, runs=3)
            bound, by, ops = attention_bound(N, T, T, True, dt)
            t = statistics.median(ms)
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/flash.cu",
                   "kernel": name, "replaces": (
                       "accl_tpu/ops/flash.py:288" if kernel == "resident"
                       else "accl_tpu/ops/flash.py:188"),
                   "launches": launches[name], "max_abs_err": errs[name],
                   "ms": t, "plain_ms": statistics.median(p_ms),
                   "bound_ms": bound, "bound_by": by, "library_ms": lib,
                   "library_call": "scaled_dot_product_attention(is_causal, "
                                   "enable_gqa)", "checked": True,
                   "shape": f"q [{N},{T},{D_HEAD}] k/v [{Nk},{T},{D_HEAD}] "
                            f"causal {dt} mxu {dt}",
                   "ctas": FL.kernel_ctas(N, T),
                   "tflops": ops / (t * 1e-3) / 1e12,
                   "launches_per_forward": per_forward[name]}
            del q, k, v, qs, ks, vs
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
    torch.cuda.empty_cache()
    FL.flash_fwd_resident.launches = launches["flash_fwd_resident"]
    FL.flash_fwd_grid.launches = launches["flash_fwd_grid"]
    return rows


def bwd_bound(which, N, Nk, T, dt) -> tuple:
    """(bound ms, "operations" or "bytes", operations) of one causal
    backward launch: dq's three products (S, dP, dS K) or dkv's four (S,
    dP, P^T dO, dS^T q) over the T (T + 1) / 2 kept cells per q head, 2
    operations per multiply-add; q2, dO, K, V, l2 and dvec read once, the
    gradients written once."""
    cells = T * (T + 1) // 2
    el = torch.finfo(dt).bits // 8
    ops = (3 if which == "dq" else 4) * 2 * D_HEAD * cells * N
    reads = (2 * N * T * D_HEAD + 2 * Nk * T * D_HEAD) * el + 2 * N * T * 4
    writes = (N if which == "dq" else 2 * Nk) * T * D_HEAD * el
    return matmul_bound(ops, reads + writes, dt) + (ops,)


def time_flash_bwd_kernels(FL, errs, launches, per_step) -> list:
    """Phase 5e: each flash backward kernel per launch at the training
    path's per-rank shape (FLASH_TRAIN, causal), fp32 with the fp32 MXU
    dtype as there, interleaved with its plain version (kernel, plain,
    plain, kernel), beside SDPA's backward by autograd with GQA
    (torch.nn.functional.scaled_dot_product_attention, a yardstick only;
    its forward time subtracted; it computes dq, dk and dv in one) and the
    bound; bf16 inputs are printed beside."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    N, Nk, T = FLASH_TRAIN
    counts0 = {k: getattr(FL, k).launches for k in FLASH_KERNELS}
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        ops, cfg = bwd_operands(FL, N, Nk, T, T, dt, dt, True, None, False,
                                gen)
        q = rand((Nk, N // Nk, T, D_HEAD), dt, gen).requires_grad_(True)
        k = rand((Nk, 1, T, D_HEAD), dt, gen).requires_grad_(True)
        v = rand((Nk, 1, T, D_HEAD), dt, gen).requires_grad_(True)
        do = rand((Nk, N // Nk, T, D_HEAD), dt, gen)

        def sdpa():
            return tnf.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True)

        def sdpa_fwd():
            with torch.no_grad():
                sdpa()

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (q, k, v), do)

        lib = (cuda_ms(sdpa_fwd_bwd, 3, runs=3)
               - cuda_ms(sdpa_fwd, 3, runs=3))
        for name, fn, plain in (
                ("flash_bwd_dq", FL.flash_bwd_dq, FL.flash_bwd_dq_plain),
                ("flash_bwd_dkv", FL.flash_bwd_dkv, FL.flash_bwd_dkv_plain)):
            ms = [cuda_ms(lambda: fn(*ops, cfg), 3, runs=3)]
            p_ms = [cuda_ms(lambda: plain(*ops, cfg), 1, runs=3)]
            p_ms.append(cuda_ms(lambda: plain(*ops, cfg), 1, runs=3))
            ms.append(cuda_ms(lambda: fn(*ops, cfg), 3, runs=3))
            which = name.split("_")[-1]
            bound, by, n_ops = bwd_bound(which, N, Nk, T, dt)
            t = statistics.median(ms)
            sp = split_ms(lambda: fn(*ops, cfg), 10, runs=3)
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/flash_bwd.cu",
                   "device_ms": sp["device_ms"],
                   "host_enqueue_ms": sp["host_enqueue_ms"],
                   "kernel": name, "replaces": (
                       "accl_tpu/ops/flash.py:873" if which == "dq"
                       else "accl_tpu/ops/flash.py:939"),
                   "launches": launches[name], "max_abs_err": errs[name],
                   "ms": t, "plain_ms": statistics.median(p_ms),
                   "bound_ms": bound, "bound_by": by, "library_ms": lib,
                   "library_call": "scaled_dot_product_attention(is_causal, "
                                   "enable_gqa) backward by autograd (dq, "
                                   "dk and dv together), forward time "
                                   "subtracted", "checked": True,
                   "shape": f"q, dO [{N},{T},{D_HEAD}] k/v "
                            f"[{Nk},{T},{D_HEAD}] causal {dt} mxu {dt}",
                   "plan": bwd_plan_reading(FL, N, Nk, T, T, True, None,
                                            dt, dt),
                   "tflops": n_ops / (t * 1e-3) / 1e12,
                   "launches_per_train_step": per_step[name]}
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
        del ops, q, k, v, do
    torch.cuda.empty_cache()
    for key, val in counts0.items():  # the timing launches are not main-path
        getattr(FL, key).launches = val
    return rows


#: the plugin lanes' bench shapes (bench.py): the reduce lane on 64 Mi
#: fp32 elements as [524288, 128] over the block_rows ladder, the
#: compression roundtrip on 64 Mi fp32 elements as [131072, 512]
PLUGIN_N = 64 << 20
COMBINE_LADDER = (512, 2048)
#: the combine kernel's dtypes: with sum and max, the 12 ARITH_LANE lanes
COMBINE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
                  torch.float16, torch.bfloat16)
#: phase 4f's short tuning grid: the 4 column counts x 2 tile depths
TUNE_COLS = (128, 512, 1024, 4096)
TUNE_BLOCK_ROWS = (256, 1024)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, for comparisons that see -0.0 and NaN payloads."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_plugin_kernels(R, C) -> dict:
    """Phase 3e: the combine kernel on all 12 lanes (6 dtypes x sum, max)
    at the bench shape (PLUGIN_N elements) and at 4099, bitwise against
    its plain version (a + b, torch.maximum), and with donate; the cast
    kernel both ways for both half types at the bench shape and at a
    ragged length holding NaN, inf, overflow and fp16 subnormals, bitwise
    against its plain version, which is Tensor.to; the same kernel at every
    geometry of phase 4f's tuning grid (TUNE_COLS x TUNE_BLOCK_ROWS), both
    ways for both half types, bitwise against Tensor.to; the stochastic
    cast to bf16, e5m2 and e4m3fn bitwise against its plain version (the
    same hash and rounding in integer torch ops) at two tile depths, and
    unbiased at 1 + 2^-12.  Returns the largest |kernel - plain| read per
    kernel-line row on the bench-shape inputs (finite by construction)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    errs = {"combine_2d": 0.0, "cast_2d": 0.0, "cast2d": 0.0}
    for n in (PLUGIN_N, 4099):
        for dt in COMBINE_DTYPES:
            a, b = rand((n,), dt, gen), rand((n,), dt, gen)
            b[:7] = a[:7]  # ties
            for op in ("sum", "max"):
                got = R.reduce_lane(a, b, op)
                torch.cuda.synchronize()
                want = R._combine_2d_plain(a, b, op == "max")
                if not torch.equal(bits(got), bits(want)):
                    fail(f"combine {dt} {op} n={n}: not bitwise equal to the "
                         f"plain version")
                errs["combine_2d"] = max(errs["combine_2d"],
                                         max_err(got, want))
                del got, want
            want = a + b
            got = R.pallas_add(a, b, donate=True)
            torch.cuda.synchronize()
            if got is not a or not torch.equal(bits(a), bits(want)):
                fail(f"combine {dt} donate n={n}: not a + b in a's storage")
            del a, b, got, want
    torch.cuda.empty_cache()
    ragged = rand((3 * 512 * 7 + 5,), torch.float32, gen) * 4
    ragged[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                               70000.0, -0.0, 1e-6, 3e-8, 6e-5, 65520.0],
                              device="cuda")
    big = rand((PLUGIN_N,), torch.float32, gen) * 4
    for x in (big, ragged):
        for dt in (torch.float16, torch.bfloat16):
            y = C.compress_cast(x, dt)
            z = C.decompress_cast(y)
            torch.cuda.synchronize()
            want_y, want_z = x.to(dt), y.float()
            if not torch.equal(bits(y), bits(want_y)):
                fail(f"compress_cast {dt} n={x.numel()}: not bitwise equal "
                     f"to Tensor.to")
            if not torch.equal(bits(z), bits(want_z)):
                fail(f"decompress_cast {dt} n={x.numel()}: not bitwise "
                     f"equal to Tensor.to")
            if x is big:
                errs["cast_2d"] = max(errs["cast_2d"], max_err(y, want_y),
                                      max_err(z, want_z))
            del y, z, want_y, want_z
    geometries = []
    for cols in TUNE_COLS:
        for br in TUNE_BLOCK_ROWS:
            xv = big.view(-1, cols)
            for dt in (torch.float16, torch.bfloat16):
                y = C._cast_2d(xv, 0, dt, False, br)
                z = C._cast_2d(y, 0, torch.float32, False, br)
                torch.cuda.synchronize()
                want_y, want_z = xv.to(dt), y.float()
                if not (torch.equal(bits(y), bits(want_y))
                        and torch.equal(bits(z), bits(want_z))):
                    fail(f"cast at [{xv.shape[0]}, {cols}] block_rows {br} "
                         f"{dt}: not bitwise equal to Tensor.to")
                errs["cast2d"] = max(errs["cast2d"], max_err(y, want_y),
                                     max_err(z, want_z))
                del y, z, want_y, want_z
            geometries.append([cols, br])
    del big, ragged, xv
    xs = rand((PLUGIN_N // 512, 512), torch.float32, gen) * 30
    xs[0, :6] = torch.tensor([float("inf"), -float("inf"), 1e6, -1e6, 1e-30,
                              -0.0], device="cuda")
    sr = {}
    for dt in C.STOCHASTIC_TARGETS:
        for x, br in ((xs, C._BLOCK_ROWS), (xs[:40], 3)):
            got = C._cast_2d(x, SEED, dt, True, br)
            torch.cuda.synchronize()
            want = C._cast_2d_plain(x, SEED, dt, True, br)
            if not torch.equal(bits(got), bits(want)):
                fail(f"stochastic cast {dt} block_rows {br}: not bitwise "
                     f"equal to the plain version ("
                     f"{int((bits(got) != bits(want)).sum())} differ)")
            if not torch.equal(C.decompress_cast(got), got.float()):
                fail(f"decompress_cast {dt}: not Tensor.to")
            del got, want
    x0 = 1 + 2.0 ** -12
    one = torch.full((1 << 20,), x0, device="cuda")
    y = C.compress_cast(one, torch.bfloat16, stochastic=True, seed=SEED)
    frac = float((y.float() > 1).double().mean())
    sigma = np.sqrt((1 / 32) * (31 / 32) / one.numel())
    sr["bf16_1+2^-12"] = {"frac_up": frac, "want": 1 / 32, "sigma": sigma,
                          "values": torch.unique(y.float()).tolist()}
    if abs(frac - 1 / 32) > 4 * sigma or \
            sr["bf16_1+2^-12"]["values"] != [1.0, 1.0 + 2.0 ** -7]:
        fail(f"stochastic rounding of 1 + 2^-12 is biased: {sr}")
    del xs, one, y
    torch.cuda.empty_cache()
    emit({"phase": "plugin_kernels_vs_plain", "ok": True,
          "combine_lanes": 2 * len(COMBINE_DTYPES), "bitwise": True,
          "cast_geometries": geometries, "max_abs_err": errs,
          "stochastic": sr})
    return errs


def check_skew_kernel(FL) -> dict:
    """Phase 3f: flash_fwd_resident_skew at the serving path's per-rank
    shape (FLASH_RESIDENT, causal) in float32 with float32 and bfloat16
    MXU dtypes and in bfloat16: out and lse bitwise equal to
    flash_fwd_resident's, and within FLASH_BOUND of its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    N, Nk, T = FLASH_RESIDENT
    err, readings = 0.0, []
    for dt, mxu in FLASH_DTYPES:
        q = rand((N, T, D_HEAD), dt, gen)
        k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt, gen)
        cfg = flash_cfg(FL, N, Nk, T, T, dt, mxu, "resident_skew", True)
        out, lse = FL.flash_fwd_resident_skew(q, k, v, cfg)
        r_out, r_lse = FL.flash_fwd_resident(
            q, k, v, flash_cfg(FL, N, Nk, T, T, dt, mxu, "resident", True))
        torch.cuda.synchronize()
        if not (torch.equal(bits(out), bits(r_out))
                and torch.equal(bits(lse), bits(r_lse))):
            fail(f"flash_fwd_resident_skew {dt}/{mxu}: not bitwise equal to "
                 f"flash_fwd_resident (out {max_err(out, r_out)}, lse "
                 f"{max_err(lse, r_lse)})")
        want, want_lse = FL.flash_fwd_resident_skew_plain(q, k, v, cfg)
        e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
        bound = FLASH_BOUND[mxu]
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        if not finite or e_out > bound or e_lse > bound:
            fail(f"flash_fwd_resident_skew {dt}/{mxu}: off its plain version "
                 f"(out {e_out}, lse {e_lse}, bound {bound})")
        readings.append({"dtype": str(dt), "mxu": str(mxu),
                         "max_abs_err_out": e_out, "max_abs_err_lse": e_lse})
        err = max(err, e_out)
        del q, k, v, out, lse, r_out, r_lse, want, want_lse
    torch.cuda.empty_cache()
    emit({"phase": "flash_skew_vs_resident_and_plain", "ok": True,
          "q": [N, T, D_HEAD], "kv": [Nk, T, D_HEAD], "causal": True,
          "bitwise_vs_flash_fwd_resident": True, "readings": readings})
    return {"flash_fwd_resident_skew": err}


def plugin_path(ring, F, FL, R, C, PL) -> dict:
    """Phase 4f: the plugin lanes as the bench of record and the tuning
    tools run them, in four parts, each with every launch count set to 0
    just before it and read just after: the reduce lane (pallas_add with
    donate on [524288, 128] fp32 over the block_rows ladder, chained,
    beside torch.add in place, 3 x bytes / time); the bf16 compression
    roundtrip on 64 Mi fp32 (nearest even, and stochastic with the seed
    stepped per call) beside the Tensor.to pair, 12 bytes an element; the
    short tune_compress grid (TUNE_COLS x TUNE_BLOCK_ROWS) and its best
    geometry; and the flash schedule sweep's distinct card candidates at
    the shape of record (resident, resident_skew, grid, static_max, bf16
    inputs), each held to the plain version of its kernel before it is
    timed."""
    from accl_tpu_torch.bench import flash_sweep as FS
    from accl_tpu_torch.bench import kernel_tune as KT
    from accl_tpu_torch.bench import timing

    timed_chain, timed_chain_ab = timing.make_harness()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    parts, total = {}, {}

    def part(name, fn):
        reset_counts(ring, F, FL, PL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts(ring, F, FL, PL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        parts[name] = {"s": time.perf_counter() - t,
                       "launches": {k: v for k, v in counts.items() if v}}
        return out

    def reduce_lane():
        a = rand((PLUGIN_N // 128, 128), torch.float32, gen)
        b = rand((PLUGIN_N // 128, 128), torch.float32, gen)
        if not torch.equal(R.pallas_add(a, b), a + b):
            fail("the reduce lane's sum is not a + b")
        fns = {f"pallas_add_block_rows{br}": (
            lambda v, w, br=br: R.pallas_add(v, w, block_rows=br,
                                             donate=True))
            for br in COMBINE_LADDER}
        fns["torch.add"] = lambda v, w: torch.add(v, w, out=v)
        best = timed_chain_ab(fns, a, iters=20, trials=3, consts=(b,))
        if not torch.isfinite(a).all():
            fail("the chained reduce lane left non-finite values")
        return {k: {"s": t, "GBps": 3 * PLUGIN_N * 4 / t / 1e9}
                for k, t in best.items()}

    def compression():
        x = rand((PLUGIN_N,), torch.float32, gen)
        bf = torch.bfloat16
        if not torch.equal(C.decompress_cast(C.compress_cast(x, bf)),
                           x.to(bf).float()):
            fail("the compression roundtrip is not the Tensor.to pair")
        seeds = iter(range(1 << 30))
        fns = {"cast_roundtrip": lambda v: C.decompress_cast(
                   C.compress_cast(v, bf)),
               "cast_roundtrip_stochastic": lambda v: C.decompress_cast(
                   C.compress_cast(v, bf, stochastic=True, seed=next(seeds))),
               "Tensor.to": lambda v: v.to(bf).to(torch.float32)}
        best = timed_chain_ab(fns, x, iters=20, trials=3)
        return {k: {"s": t, "GBps": 12 * PLUGIN_N / t / 1e9}
                for k, t in best.items()}

    def sweep_checks(cands, groups):
        """Each distinct card candidate at the sweep shape against the
        plain version of the kernel it runs, within FLASH_BOUND of its
        MXU dtype, before it is timed (outside the counted parts: these
        launches are comparisons)."""
        q, k, v = FS.make_inputs()
        readings = {}
        for rep in groups:
            dt = cands[rep].opts["dtype"]
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            cfg = FS.schedule(cands[rep])
            out = cands[rep](qd, kd, vd)
            plain = getattr(FL, FS.KERNEL_OF[cfg[5]] + "_plain")
            want, _lse = plain(qd, kd, vd, cfg)
            err, bound = max_err(out, want), FLASH_BOUND[cfg[4]]
            if not (torch.isfinite(out).all() and out.shape == q.shape
                    and err <= bound):
                fail(f"flash sweep candidate {rep} ({FS.KERNEL_OF[cfg[5]]}"
                     f"): off its plain version ({err}, bound {bound})")
            readings[rep] = {"kernel": FS.KERNEL_OF[cfg[5]],
                             "max_abs_err": err, "bound": bound}
            del qd, kd, vd, out, want, _lse
        del q, k, v
        return readings

    def sweep(cands, groups):
        best, best_mm, aliases = FS.run_sweep(timed_chain, cands, rounds=2,
                                              iters=16, log=lambda m: None)
        rep = FS.report(best, best_mm, aliases)
        dead = {n: r for n, r in rep["schedules"].items() if "error" in r}
        if dead:
            fail(f"flash sweep candidates failed: {dead}")
        rep["distinct"] = {r: groups[r] for r in groups}
        return rep

    lanes = {"reduce_lane": part("reduce_lane", reduce_lane),
             "compression": part("compression", compression)}
    tune = part("tune_compress", lambda: KT.tune_compress(
        n=PLUGIN_N, cols=TUNE_COLS, block_rows=TUNE_BLOCK_ROWS, rounds=2,
        iters=8, log=lambda m: None))
    cands = FS.build(FS.D128_SPECS)
    groups, _refused = FS.collapse(cands)
    sweep_errs = sweep_checks(cands, groups)
    rep = part("flash_sweep", lambda: sweep(cands, groups))
    rep["vs_plain"] = sweep_errs
    torch.cuda.empty_cache()
    for name, key in (("reduce_lane", "combine_2d"),
                      ("compression", "cast_2d"), ("tune_compress", "cast_2d"),
                      ("flash_sweep", "flash_fwd_resident_skew")):
        if parts[name]["launches"].get(key, 0) < 1:
            fail(f"the plugin path's {name} did not launch {key}: {parts}")
    best = tune["best"]
    emit({"phase": "plugin_path", "ok": True, "n": PLUGIN_N,
          "lanes": lanes, "tune_compress": tune,
          "tuned_geometry": [best["cols"], best["block_rows"]],
          "flash_sweep": rep, "parts": parts, "launches": total})
    return {"launches": total, "parts": parts,
            "tuned": (best["cols"], best["block_rows"])}


def time_plugin_kernels(R, C, FL, errs, plugin, PL) -> list:
    """Phase 5f: the plugin kernels per launch at the bench shapes,
    interleaved with their plain versions (kernel, plain, plain, kernel),
    beside one PyTorch call computing the same function and the byte
    bound: combine_2d (fp32 sum, block_rows 512; 2048 and max beside);
    cast_2d (f32 -> bf16 nearest at [131072, 512], block_rows 1024;
    decompress and stochastic beside); cast2d, the same kernel at the
    tuned geometry of phase 4f; flash_fwd_resident_skew at the serving
    shape, fp32 with the fp32 MXU dtype, beside flash_fwd_resident and
    SDPA."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    counts0 = {k: fn.launches for k, fn in PL.items()}
    skew0 = FL.flash_fwd_resident_skew.launches
    launches, parts = plugin["launches"], plugin["parts"]

    def interleaved(kernel, plain, iters, plain_iters=None):
        p_it = plain_iters or iters
        ms = [cuda_ms(kernel, iters)]
        p_ms = [cuda_ms(plain, p_it, runs=3), cuda_ms(plain, p_it, runs=3)]
        ms.append(cuda_ms(kernel, iters))
        return statistics.median(ms), statistics.median(p_ms)

    rows = []
    a = rand((PLUGIN_N // 128, 128), torch.float32, gen)
    b = rand((PLUGIN_N // 128, 128), torch.float32, gen)
    out = torch.empty_like(a)
    ms, p_ms = interleaved(lambda: R._pallas_combine_2d(a, b),
                           lambda: R._combine_2d_plain(a, b, False), 20)
    lib = cuda_ms(lambda: torch.add(a, b, out=out), 20)
    bound = 3 * PLUGIN_N * 4 / HBM_BYTES_PER_S * 1e3
    extra = {"at_block_rows2048_ms": cuda_ms(
                 lambda: R._pallas_combine_2d(a, b, block_rows=2048), 20),
             "max": {"ms": cuda_ms(lambda: R._pallas_combine_2d(a, b, True),
                                   20),
                     "library_ms": cuda_ms(
                         lambda: torch.maximum(a, b, out=out), 20)}}
    rows.append({"name": "combine_2d", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/reduce_ops.cu",
                 "kernel": "accl_combine",
                 "replaces": "accl_tpu/ops/reduce_ops.py:39",
                 "launches": launches["combine_2d"],
                 "max_abs_err": errs["combine_2d"], "ms": ms,
                 "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
                 "library_ms": lib, "library_call": "torch.add(a, b, out=)",
                 "checked": True, "shape": "[524288, 128] fp32 sum, "
                                           "block_rows 512",
                 "GBps": 3 * PLUGIN_N * 4 / ms / 1e6,
                 "launches_per_pallas_add": 1, **extra})
    del a, b, out
    x = rand((PLUGIN_N // 512, 512), torch.float32, gen)
    h = x.to(torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    bound = 6 * PLUGIN_N / HBM_BYTES_PER_S * 1e3  # 4 + 2 bytes an element
    ms, p_ms = interleaved(lambda: C._cast_2d(x, 0, bf, False),
                           lambda: C._cast_2d_plain(x, 0, bf, False, 1024), 20)
    lib = cuda_ms(lambda: x.to(bf), 20)
    d_ms, d_p = interleaved(lambda: C._cast_2d(h, 0, f32, False),
                            lambda: C._cast_2d_plain(h, 0, f32, False, 1024),
                            20)
    d_lib = cuda_ms(lambda: h.to(f32), 20)
    s_ms, s_p = interleaved(lambda: C._cast_2d(x, 7, bf, True),
                            lambda: C._cast_2d_plain(x, 7, bf, True, 1024),
                            20, plain_iters=2)
    rows.append({"name": "cast_2d", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/compression.cu",
                 "kernel": "accl_cast",
                 "replaces": "accl_tpu/ops/compression.py:54",
                 "launches": parts["compression"]["launches"]["cast_2d"],
                 "max_abs_err": errs["cast_2d"], "ms": ms, "plain_ms": p_ms,
                 "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
                 "library_call": "Tensor.to(torch.bfloat16)", "checked": True,
                 "shape": "[131072, 512] fp32 -> bf16 nearest, block_rows "
                          "1024",
                 "GBps": 6 * PLUGIN_N / ms / 1e6,
                 "launches_per_roundtrip": 2,
                 "decompress": {"ms": d_ms, "plain_ms": d_p,
                                "library_ms": d_lib, "bound_ms": bound,
                                "shape": "[131072, 512] bf16 -> fp32"},
                 "stochastic": {"ms": s_ms, "plain_ms": s_p,
                                "library_ms": None, "bound_ms": bound,
                                "shape": "[131072, 512] fp32 -> bf16 "
                                         "stochastic"}})
    cols, br = plugin["tuned"]
    xv, hv = x.view(-1, cols), h.view(-1, cols)
    t_ms, t_p = interleaved(lambda: C._cast_2d(xv, 0, bf, False, br),
                            lambda: C._cast_2d_plain(xv, 0, bf, False, br),
                            20)
    t_lib = cuda_ms(lambda: xv.to(bf), 20)
    t_d = cuda_ms(lambda: C._cast_2d(hv, 0, f32, False, br), 20)
    rows.append({"name": "cast2d", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/compression.cu",
                 "kernel": "accl_cast (tuned geometry)",
                 "replaces": "scripts/kernel_tune.py:96",
                 "launches": parts["tune_compress"]["launches"]["cast_2d"],
                 "max_abs_err": errs["cast2d"], "ms": t_ms, "plain_ms": t_p,
                 "bound_ms": bound, "bound_by": "bytes", "library_ms": t_lib,
                 "library_call": "Tensor.to(torch.bfloat16)", "checked": True,
                 "shape": f"[{PLUGIN_N // cols}, {cols}] fp32 -> bf16 "
                          f"nearest, block_rows {br}",
                 "geometry": [cols, br], "decompress_ms": t_d,
                 "launches_per_roundtrip": 2})
    del x, h, xv, hv
    torch.cuda.empty_cache()
    N, Nk, T = FLASH_RESIDENT
    dt = torch.float32
    q = rand((N, T, D_HEAD), dt, gen)
    k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt, gen)
    cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, "resident_skew", True)
    r_cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, "resident", True)
    ms, p_ms = interleaved(
        lambda: FL.flash_fwd_resident_skew(q, k, v, cfg),
        lambda: FL.flash_fwd_resident_skew_plain(q, k, v, cfg), 5,
        plain_iters=1)
    res_ms = cuda_ms(lambda: FL.flash_fwd_resident(q, k, v, r_cfg), 5,
                     runs=3)
    qs = q.view(Nk, N // Nk, T, D_HEAD)
    ks, vs = k.view(Nk, 1, T, D_HEAD), v.view(Nk, 1, T, D_HEAD)
    lib = cuda_ms(lambda: tnf.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 5, runs=3)
    bound, by, ops = attention_bound(N, T, T, True, dt)
    rows.append({"name": "flash_fwd_resident_skew", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/flash.cu",
                 "kernel": "flash_fwd_resident_skew",
                 "replaces": "accl_tpu/ops/flash.py:403",
                 "launches": launches["flash_fwd_resident_skew"],
                 "max_abs_err": errs["flash_fwd_resident_skew"], "ms": ms,
                 "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                 "library_ms": lib,
                 "library_call": "scaled_dot_product_attention(is_causal, "
                                 "enable_gqa)", "checked": True,
                 "shape": f"q [{N},{T},{D_HEAD}] k/v [{Nk},{T},{D_HEAD}] "
                          f"causal {dt} mxu {dt}",
                 "flash_fwd_resident_ms": res_ms,
                 "tflops": ops / (ms * 1e-3) / 1e12,
                 "launches_per_forward": 1})
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    for row in rows:
        emit({"phase": "kernel_time", **row})
    for key, n in counts0.items():  # the timing launches are not main-path
        PL[key].launches = n
    FL.flash_fwd_resident_skew.launches = skew0
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="4,16,64,256",
                    help="allreduce MiB per rank, comma-separated; the "
                         "largest is the one whose launches are counted")
    ap.add_argument("--no-timing", action="store_true",
                    help="build, check and drive the main path only")
    args = ap.parse_args()
    sizes = sorted(int(v) for v in args.sizes.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accl_tpu_torch import CudaWorld, DataType, ReduceFunction
    from accl_tpu_torch.arithconfig import CompressionPolicy
    from accl_tpu_torch.ops import _build
    from accl_tpu_torch import models as M
    from accl_tpu_torch import parallel as S
    from accl_tpu_torch.bench import ef_convergence as TE
    from accl_tpu_torch.utils import tree as T_
    from accl_tpu_torch.ops import flash as FL
    from accl_tpu_torch.ops import fused as F
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops import quantized as q_ops
    from accl_tpu_torch.ops import reduce_ops as R
    from accl_tpu_torch.ops import ring
    PL = {"combine_2d": R._pallas_combine_2d, "cast_2d": C._cast_2d}

    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    tc_ops = tensor_core_ops(_build._target("fused"))
    if tc_ops:
        fail(f"the matmul kernels' SASS holds {tc_ops} tensor-core "
             f"instructions: the fp32 path must not use TF32")
    bwd_tc = check_flash_bwd_sass(_build._target("flash_bwd"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": _build.build_seconds,
          "fused_sass_tensor_core_ops": tc_ops,
          "flash_bwd_sass_tensor_core_ops": bwd_tc,
          "fused_kernels": fused_kernel_info(F),
          "flash_bwd_kernels": {
              f"{dt} in, {mxu} MXU": FL.bwd_kernel_info(D_HEAD, dt, mxu)
              for dt, mxu in FLASH_DTYPES},
          "ptxas": [ln.strip() for log in _build.build_log.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    errs = check_kernels(ring)
    errs.update(check_fused_kernels(F))
    errs.update(check_flash_kernels(FL))
    errs.update(check_flash_bwd_kernels(FL))
    errs.update(check_plugin_kernels(R, C))
    errs.update(check_skew_kernel(FL))
    mp = main_path(ring, F, CudaWorld, ReduceFunction, sizes)
    world = mp["world"]
    try:
        tp = tp_path(ring, F)
        lanes = driver_lanes(world, ring, F, q_ops, DataType,
                             CompressionPolicy)
        serve = serving_path(ring, F, FL, M)
        train = train_path(ring, F, FL, M, S, TE, T_)
        plugin = plugin_path(ring, F, FL, R, C, PL)
        # the main path's launches: the sum over its six parts
        launches = {k: mp["launches"][k] + tp["launches"][k]
                    + lanes["launches"][k] + serve["launches"][k]
                    + train["launches"][k] + plugin["launches"][k]
                    for k in mp["launches"]}
        launches.update({k: serve["launches"][k] + train["launches"][k]
                         + plugin["launches"][k] for k in FLASH_KERNELS})
        launches.update({k: plugin["launches"][k] for k in PL})
        if args.no_timing:
            emit({"phase": "main_path_done", "launches": launches})
            return 0
        per_big = dict(zip(("ring_reduce_scatter", "ring_all_gather"),
                           mp["per_size"][sizes[-1]][3]))
        rows, ar_device = time_kernels(ring, errs, launches, per_big,
                                       sizes[-1], sizes)
        rows += time_fused_kernels(ring, F, errs, launches,
                                   tp["per_call_mlp_down"])
        rows += time_flash_kernels(FL, errs, launches, serve["per_forward"])
        rows += time_flash_bwd_kernels(FL, errs, launches, train["per_step"])
        rows += time_plugin_kernels(R, C, FL, errs, {**plugin,
                                                     "launches": launches},
                                    PL)
        for mib, (_s, _r, call, launched) in sorted(mp["per_size"].items()):
            iters = 5
            world.run(call)
            torch.cuda.synchronize()
            samples = []
            for _ in range(3):
                t = time.perf_counter()
                for _ in range(iters):
                    world.run(call)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t) / iters)
            s = statistics.median(samples)
            algbw = mib * MIB / s / 1e9
            # device share of the call: the device time of its two
            # launches (phase 5a, stream held), over the call's wall time
            kern_s = ar_device[mib] / 1e3
            emit({"phase": "driver_allreduce", "mib_per_rank": mib,
                  "ranks": P, "s_per_call": s, "algbw_GBps": algbw,
                  "busbw_GBps": algbw * 2 * (P - 1) / P,
                  "launches": list(launched),
                  "kernel_s_est": kern_s, "kernel_share_est": kern_s / s})
        time_lanes(world, lanes["lanes"], lanes["set_ef"])
    finally:
        world.close()
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    # the run drives one card, whatever else the host holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
