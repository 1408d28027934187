"""Run the PyTorch/CUDA port (accl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from accl_tpu_torch/ops/csrc with nvcc, one
     nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it:
     - the ring kernels at the driver's per-launch shape (P=8 ranks,
       n = DEFAULT_SEG_ELEMS / 8) and at a ragged size: fp32 SUM and MAX,
       int32 SUM and fp32 all-gather bitwise, fp16 SUM within one ulp;
       the all-gather also at the tensor-parallel path's n = (M / 8) N;
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
  4. the main path, in four parts, each driven with every launch count
     set to 0 just before it and read just after:
     a. the driver: CudaWorld(8) on the card, ACCL calls on 8 rank
        threads — fp32 SUM allreduce at 4, 16, 64 and 256 MiB per rank,
        MAX allreduce, allgather and reduce-scatter at 64 MiB per rank,
        and bcast / gather / scatter / alltoall / a small allreduce below
        the ring threshold.  Every result is held against the plain
        composition on the card (bitwise on the ring lane) and a float64
        reference (rtol 1e-5, atol 1e-5); both ring kernels must launch;
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
  5. times with CUDA events after warm-up (median of 5 runs): each kernel
     per launch, at the shape the main path launches it most, beside its
     plain version, a library yardstick and its bound (bytes read once +
     written once over 3.35 TB/s, or operations over the peak for their
     type, 67 TFLOP/s fp32 or 989 TFLOP/s bf16, whichever is larger),
     with its times at the path's other shape as an extra field; the
     driver's allreduce algbw / busbw per size; and at 64 MiB per rank
     the busbw of the fused and int8 lanes beside the lossless ring's.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 = False):
the plain versions and yardsticks multiply in full fp32, as the kernels
do.  It prints one JSON line per measurement, a {"kernels": [...]}
line, the card's name and power limit, and last {"ok": true, "device":
{...}}.  Without CUDA it exits 2 and prints no result.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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


def cuda_ms(fn, iters: int, runs: int = 5) -> float:
    """Median over ``runs`` of the per-call time of ``iters`` calls,
    timed with CUDA events after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


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


def reset_counts(ring, F, FL=None) -> None:
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather,
               F.pallas_matmul, F.fused_matmul_reduce_scatter):
        fn.launches = 0
    if FL is not None:
        FL.flash_fwd_resident.launches = 0
        FL.flash_fwd_grid.launches = 0


def read_counts(ring, F, FL=None) -> dict:
    counts = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
              "ring_all_gather": ring.ring_all_gather.launches,
              "pallas_matmul": F.pallas_matmul.launches,
              "fused_matmul_reduce_scatter":
                  F.fused_matmul_reduce_scatter.launches}
    if FL is not None:
        counts["flash_fwd_resident"] = FL.flash_fwd_resident.launches
        counts["flash_fwd_grid"] = FL.flash_fwd_grid.launches
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
    lib = cuda_ms(lambda: torch.matmul(x, w), iters)
    el = torch.finfo(dt).bits // 8
    ops = 2 * rows * K * N
    bound, by = matmul_bound(ops, (rows * K + K * N) * el + rows * N * 4, dt)
    return {"shape": f"[{rows},{K}] @ [{K},{N}] {dt}",
            "ms": statistics.median(ms), "plain_ms": statistics.median(plain),
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "tflops": ops / (statistics.median(ms) * 1e-3) / 1e12}


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
                                 "bound_ms", "tflops")}}
        b_row = {"shape": f"P={P} x [{P},{m},{K}] @ [{K},{N}] {dt}",
                 "ms": statistics.median(b_ms),
                 "plain_ms": statistics.median(b_plain), "library_ms": b_lib,
                 "bound_ms": b_bound, "bound_by": b_by,
                 "tflops": b_ops / (statistics.median(b_ms) * 1e-3) / 1e12}
        for name, t, kernel, fn_line, lib_call, extra in (
                ("pallas_matmul", a_row, "accl_matmul",
                 "accl_tpu/ops/fused.py:341", "torch.matmul", a_extra),
                ("fused_matmul_reduce_scatter", b_row,
                 "accl_fused_matmul_rs", "accl_tpu/ops/fused.py:476",
                 "torch.matmul per rank + torch.sum over ranks", {})):
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


def time_kernels(ring, errs, launches, per_big, big_mib) -> list:
    """Phase 5a: each kernel per launch at the main path's shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = ring.DEFAULT_SEG_ELEMS // P
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    outs = [torch.empty(n, device="cuda") for _ in range(P)]
    stacked = torch.stack(xs)  # [rank, chunk, n]
    ag_in = [rand((n,), torch.float32, gen) for _ in range(P)]
    ag_out = [torch.empty(P, n, device="cuda") for _ in range(P)]
    rs_count0 = ring.ring_reduce_scatter.launches
    ag_count0 = ring.ring_all_gather.launches
    # interleaved: kernel, plain, plain, kernel
    rs_ms = [cuda_ms(lambda: ring.ring_reduce_scatter(xs, out=outs), 50)]
    rs_plain = [cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20)]
    rs_plain.append(cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20))
    rs_ms.append(cuda_ms(lambda: ring.ring_reduce_scatter(xs, out=outs), 50))
    rs_lib = cuda_ms(lambda: torch.sum(stacked, dim=0), 50)
    ag_ms = [cuda_ms(lambda: ring.ring_all_gather(ag_in, out=ag_out), 50)]
    ag_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20)]
    ag_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20))
    ag_ms.append(cuda_ms(lambda: ring.ring_all_gather(ag_in, out=ag_out), 50))
    ag_lib = cuda_ms(lambda: torch.cat(ag_in), 50)
    # the per-launch floor: the same hops at 256 elements per chunk, where
    # the bytes are negligible and the flag handshakes are all that is left
    tiny = [rand((P, 256), torch.float32, gen) for _ in range(P)]
    tiny_ag = [rand((256,), torch.float32, gen) for _ in range(P)]
    floor = {"ring_reduce_scatter":
             cuda_ms(lambda: ring.ring_reduce_scatter(tiny), 50),
             "ring_all_gather":
             cuda_ms(lambda: ring.ring_all_gather(tiny_ag), 50)}
    # the all-gather of fused_matmul_allreduce_pallas: [M / P, N] per rank
    tp_in = [rand((TP_GATHER_N,), torch.float32, gen) for _ in range(P)]
    tp_out = [torch.empty(P, TP_GATHER_N, device="cuda") for _ in range(P)]
    tp_ms = [cuda_ms(lambda: ring.ring_all_gather(tp_in, out=tp_out), 5)]
    tp_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5)]
    tp_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5))
    tp_ms.append(cuda_ms(lambda: ring.ring_all_gather(tp_in, out=tp_out), 5))
    tp_lib = cuda_ms(lambda: torch.cat(tp_in), 5)
    tp_bytes = (P + P * P) * TP_GATHER_N * 4
    at_tp = {"ring_reduce_scatter": {}, "ring_all_gather": {
        f"at_n{TP_GATHER_N}": {
            "shape": f"P={P} x [{TP_GATHER_N}] fp32 per launch",
            "ms": statistics.median(tp_ms),
            "plain_ms": statistics.median(tp_plain), "library_ms": tp_lib,
            "bound_ms": tp_bytes / HBM_BYTES_PER_S * 1e3}}}
    del tp_in, tp_out
    # the timing launches are not main-path launches
    ring.ring_reduce_scatter.launches = rs_count0
    ring.ring_all_gather.launches = ag_count0
    el = 4
    rs_bytes = P * P * n * el + P * n * el      # read operands, write chunks
    ag_bytes = P * n * el + P * P * n * el      # read blocks, write gathers
    rows = []
    for name, ms, plain, lib, nbytes, src_line, lib_call in (
            ("ring_reduce_scatter", rs_ms, rs_plain, rs_lib, rs_bytes,
             "accl_tpu/ops/ring.py:274", "torch.sum(stack, dim=0)"),
            ("ring_all_gather", ag_ms, ag_plain, ag_lib, ag_bytes,
             "accl_tpu/ops/ring.py:151", "torch.cat")):
        row = {"name": name, "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/ring.cu",
               "replaces": src_line, "launches": launches[name],
               "max_abs_err": errs[name], "ms": statistics.median(ms),
               "plain_ms": statistics.median(plain),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": lib,
               "library_call": lib_call, "checked": True,
               "shape": f"P={P} x [{P},{n}] fp32 per launch",
               "floor_ms_at_n256": floor[name],
               f"launches_per_{big_mib}MiB_allreduce": per_big[name],
               **at_tp[name]}
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    return rows


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
    from accl_tpu_torch.ops import flash as FL
    from accl_tpu_torch.ops import fused as F
    from accl_tpu_torch.ops import quantized as q_ops
    from accl_tpu_torch.ops import ring

    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    tc_ops = tensor_core_ops(_build._target("fused"))
    if tc_ops:
        fail(f"the matmul kernels' SASS holds {tc_ops} tensor-core "
             f"instructions: the fp32 path must not use TF32")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": _build.build_seconds,
          "fused_sass_tensor_core_ops": tc_ops,
          "ptxas": [ln.strip() for log in _build.build_log.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    errs = check_kernels(ring)
    errs.update(check_fused_kernels(F))
    errs.update(check_flash_kernels(FL))
    mp = main_path(ring, F, CudaWorld, ReduceFunction, sizes)
    world = mp["world"]
    try:
        tp = tp_path(ring, F)
        lanes = driver_lanes(world, ring, F, q_ops, DataType,
                             CompressionPolicy)
        serve = serving_path(ring, F, FL, M)
        # the main path's launches: the sum over its four parts
        launches = {k: mp["launches"][k] + tp["launches"][k]
                    + lanes["launches"][k] + serve["launches"][k]
                    for k in mp["launches"]}
        launches.update({k: serve["launches"][k] for k in
                         ("flash_fwd_resident", "flash_fwd_grid")})
        if args.no_timing:
            emit({"phase": "main_path_done", "launches": launches})
            return 0
        per_big = dict(zip(("ring_reduce_scatter", "ring_all_gather"),
                           mp["per_size"][sizes[-1]][3]))
        rows = time_kernels(ring, errs, launches, per_big, sizes[-1])
        rows += time_fused_kernels(ring, F, errs, launches,
                                   tp["per_call_mlp_down"])
        rows += time_flash_kernels(FL, errs, launches, serve["per_forward"])
        by_name = {row["name"]: row["ms"] for row in rows}
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
            # device share of the call: its launches times the measured
            # per-launch kernel time (the segment shape is the same at
            # every size), over the call's wall time
            kern_s = sum(cnt * by_name[k] / 1e3
                         for k, cnt in zip(("ring_reduce_scatter",
                                            "ring_all_gather"), launched))
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
