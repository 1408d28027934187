"""Run the PyTorch/CUDA port (accl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from accl_tpu_torch/ops/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's per-launch shape (P=8 ranks, n = DEFAULT_SEG_ELEMS / 8)
     and at a ragged size: fp32 SUM and MAX, int32 SUM and fp32
     all-gather bitwise, fp16 SUM within one fp16 ulp;
  4. the main path: CudaWorld(8) on the card, ACCL calls on 8 rank
     threads — fp32 SUM allreduce at 4, 16, 64 and 256 MiB per rank, MAX
     allreduce, allgather and reduce-scatter at 64 MiB per rank, and
     bcast / gather / scatter / alltoall / a small allreduce below the
     ring threshold.  Every result is held against the plain composition
     on the card (bitwise on the ring lane) and a float64 reference
     (rtol 1e-5, atol 1e-5); both kernels' launch counts must rise;
  5. times with CUDA events after warm-up (median of 5 runs): each kernel
     per launch beside its plain version, a one-call library yardstick
     and its bound (bytes read once + written once over 3.35 TB/s), and
     the driver's allreduce algbw / busbw per size.

It prints one JSON line per measurement, a {"kernels": [...]} line, the
card's name and power limit, and last {"ok": true, "device": {...}}.
Without CUDA it exits 2 and prints no result.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

P = 8
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 1234


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
    emit({"phase": "kernel_vs_plain", "ok": True, "max_abs_err": errs})
    return errs


def fill(bufs, gen):
    for b in bufs:
        b.dev.copy_(torch.randn(b.dev.shape[0], generator=gen, device="cuda"))


def main_path(ring, CudaWorld, ReduceFunction, sizes) -> dict:
    """Phase 4: the driver's main path through ACCL on 8 rank threads."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    world = CudaWorld(P)  # the card, by default
    ring.ring_reduce_scatter.launches = 0
    ring.ring_all_gather.launches = 0
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
        launches = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
                    "ring_all_gather": ring.ring_all_gather.launches}
        if min(launches.values()) < 1:
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
               f"launches_per_{big_mib}MiB_allreduce": per_big[name]}
        emit({"phase": "kernel_time", **row})
        rows.append(row)
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
    from accl_tpu_torch import CudaWorld, ReduceFunction
    from accl_tpu_torch.ops import _build
    from accl_tpu_torch.ops import ring

    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": _build.build_seconds,
          "ptxas": [ln.strip() for log in _build.build_log.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    errs = check_kernels(ring)
    mp = main_path(ring, CudaWorld, ReduceFunction, sizes)
    world = mp["world"]
    try:
        if args.no_timing:
            emit({"phase": "main_path_done", "launches": mp["launches"]})
            return 0
        per_big = dict(zip(("ring_reduce_scatter", "ring_all_gather"),
                           mp["per_size"][sizes[-1]][3]))
        rows = time_kernels(ring, errs, mp["launches"], per_big,
                            sizes[-1])
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
    finally:
        world.close()
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
