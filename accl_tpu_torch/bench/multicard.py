"""The ring kernels' cross-card mode and the driver over several cards,
timed.

    python -m accl_tpu_torch.bench.multicard [--sizes 4,16,64,256]
        [--iters 20] [--lanes ring,fused,int8,fused_int8] [--driver-only]
        [--out FILE]

It prints one JSON line per measurement and, last, the card's name and
power limit:

- ``cards``: every card's name, the peer-access matrix
  (``torch.cuda.can_device_access_peer``) and ``nvidia-smi topo -m``;
- ``ring_launch``: ms per launch of ``ring_reduce_scatter`` and
  ``ring_all_gather`` at [P, 32768] fp32 per rank (the driver's 1 MiB
  segment) and at [P, 2097152] (8 MiB a chunk), on each card (CUDA
  events on every card's stream around the same calls), in the
  cross-card mode with one rank a card and with two; the plain
  composition's ms; the bound, the greater of the bytes each card moves
  (each operand read once, each result written once) over 3.35 TB/s and
  the hop bytes that cross from each card to the next over 450 GB/s
  (NVLink 4, each way); and as a yardstick only (the port never calls
  it), ``torch.cuda.nccl.reduce_scatter`` and ``all_gather`` over the
  same per-card tensors, where the build has them;
- ``driver_allreduce``: the driver's fp32 SUM allreduce on
  ``CudaWorld(C, devices=...)``, one rank a card, at each size in MiB per
  rank and in each lane of ``--lanes`` (``ring``, ``fused``, ``int8``,
  ``fused_int8``: ``fused=True``, ``compress_dtype=int8``, both): s a
  call (median of 3 runs of 5 calls), busbw (nccl-tests: algbw x 2 (P -
  1) / P), the crossings a call through the engine's ``_move`` and the
  bytes of them between two cards (MiB too; the ring lane's kernels hop
  across the cards themselves), the link twin's bytes a call (compressed
  on the int8 lanes), and every rank's result bitwise: the ring lane's
  the plain composition's, the others' the same calls' on
  ``CudaWorld(C)`` on one card.  ``--driver-only`` skips the launch rows.

With one card it times the per-rank-table form (``ring.rank_tables``) of
8 ranks on that card beside the one-launch form, and says that the
cross-card rows did not run.  It runs on the card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

MIB = 1 << 20
#: the card's memory rate and one direction of its NVLink 4 (18 links of
#: 25 GB/s each way), bytes a second (the H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
SEG_N = 32768
BIG_N = 2097152


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def card_report() -> dict:
    """The cards, their peer-access matrix and the topology table."""
    n = torch.cuda.device_count()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    return {"count": n,
            "names": [torch.cuda.get_device_name(i) for i in range(n)],
            "peer": [[i == j or torch.cuda.can_device_access_peer(i, j)
                      for j in range(n)] for i in range(n)],
            "topo": topo.stdout if topo.returncode == 0 else topo.stderr}


def per_card_ms(fn, cards, iters: int, runs: int = 3) -> dict:
    """ms a call on each card: CUDA events recorded on every card's
    current stream before and after ``iters`` calls, after one warm-up
    call; the minimum over ``runs``."""
    fn()
    for c in cards:
        torch.cuda.synchronize(c)
    best = {c: float("inf") for c in cards}
    for _ in range(runs):
        ev = {c: (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for c in cards}
        for c in cards:
            ev[c][0].record(torch.cuda.current_stream(c))
        for _ in range(iters):
            fn()
        for c in cards:
            ev[c][1].record(torch.cuda.current_stream(c))
        for c in cards:
            ev[c][1].synchronize()
            best[c] = min(best[c], ev[c][0].elapsed_time(ev[c][1]) / iters)
    return best


def bound_ms(P: int, n: int, ranks_a_card: int, cards: int,
             elem: int = 4) -> tuple:
    """(ms, "bytes") the card can do no better than, for one launch of
    either kernel with ``ranks_a_card`` ranks of a ring of P on each of
    ``cards`` cards: each operand read and each result written once over
    HBM ([P, n] and [n] a rank, one way or the other), and, across cards,
    the hop bytes that leave each card for the next over NVLink (one rank
    of each card sends across: its P - 1 chunks)."""
    hbm = ranks_a_card * (P * n + n) * elem / HBM_BYTES_PER_S
    link = (P - 1) * n * elem / NVLINK_BYTES_PER_S if cards > 1 else 0.0
    return (max(hbm, link) * 1e3, "bytes")


def nccl_ms(kind: str, xs, outs, cards, iters: int):
    """The yardstick: torch.cuda.nccl's single-process collective over the
    same per-card tensors (one a card), or None with the reason."""
    try:
        import torch.cuda.nccl as nccl

        if not nccl.is_available(xs):
            return None, "torch.cuda.nccl not available for these tensors"
        if kind == "rs":
            flat = [x.reshape(-1) for x in xs]
            fn = lambda: nccl.reduce_scatter(flat, outs)  # noqa: E731
        else:
            fn = lambda: nccl.all_gather(xs, [o.reshape(-1)  # noqa: E731
                                              for o in outs])
        return per_card_ms(fn, cards, iters), None
    except Exception as e:  # noqa: BLE001 — a yardstick, reported as absent
        return None, f"{type(e).__name__}: {e}"


def ring_launch_rows(devices: list, n: int, iters: int,
                     tables_on_one_card: bool = False) -> list:
    """One row per kernel: ms per launch on each card, plain ms, bound,
    the nccl yardstick (one rank a card only), max |kernel - plain|."""
    from accl_tpu_torch.ops import ring

    P = len(devices)
    cards = sorted({torch.device(d).index or 0 for d in devices})
    per = P // len(cards)
    gen = torch.Generator().manual_seed(19)
    xs = [torch.randn(P, n, generator=gen).to(d) for d in devices]
    rs_out = [torch.empty(n, device=d) for d in devices]
    ag_in = [x[0].contiguous() for x in xs]
    ag_out = [torch.empty(P, n, device=d) for d in devices]
    rows = []
    form = ring.rank_tables if tables_on_one_card else contextlib.nullcontext
    for kind, kern, plain in (
            ("rs", lambda: ring.ring_reduce_scatter(xs, out=rs_out),
             lambda: ring.ring_reduce_scatter_plain(xs)),
            ("ag", lambda: ring.ring_all_gather(ag_in, out=ag_out),
             lambda: ring.ring_all_gather_plain(ag_in))):
        with form():
            got = [t.clone() for t in kern()]
            want = plain()
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
            bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = per_card_ms(kern, cards, iters)
        plain_ms = per_card_ms(plain, cards, max(1, iters // 10))
        if len(cards) == 1:
            lib, why = per_card_ms(_one_card_library(kind, xs, ag_in, ag_out),
                                   cards, iters), None
        elif per == 1:
            lib, why = nccl_ms(kind, xs if kind == "rs" else ag_in,
                               rs_out if kind == "rs" else ag_out, cards,
                               iters)
        else:
            lib, why = None, "torch.cuda.nccl takes one rank a card"
        b_ms, b_by = bound_ms(P, n, per, len(cards))
        name = ("ring_reduce_scatter" if kind == "rs" else
                "ring_all_gather")
        rows.append({"name": name, "ranks": P, "cards": len(cards),
                     "ranks_a_card": per, "n": n,
                     "form": ("tables" if tables_on_one_card
                              or len(cards) > 1 else "one"),
                     "ms_per_card": {f"cuda:{c}": v for c, v in ms.items()},
                     "ms": max(ms.values()),
                     "plain_ms": max(plain_ms.values()),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None if lib is None else max(lib.values()),
                     "library_call": _library_call(kind, len(cards), P),
                     "library_note": why,
                     "max_abs_err": err, "bitwise": bitwise})
    return rows


def _one_card_library(kind: str, xs, ag_in, ag_out):
    """The library call of rows 1-2 (chip_smoke.py ``time_kernels``) on
    one card: torch.sum over the rank stack (every rank's chunk), or one
    torch.cat(out=) per rank."""
    if kind == "rs":
        stacked = torch.stack(xs)
        return lambda: torch.sum(stacked, dim=0)
    return lambda: [torch.cat(ag_in, out=o.view(-1)) for o in ag_out]


def _library_call(kind: str, cards: int, P: int) -> str:
    if cards == 1:
        return ("torch.sum(stack, dim=0): every rank's chunk" if kind == "rs"
                else f"torch.cat(blocks, out=gather[r]) for each of the {P} "
                     f"ranks")
    return ("torch.cuda.nccl.reduce_scatter" if kind == "rs"
            else "torch.cuda.nccl.all_gather")


#: driver lane -> the allreduce's keywords
DRIVER_LANES = {"ring": {}, "fused": {"fused": True},
                "int8": {"compress": True},
                "fused_int8": {"fused": True, "compress": True}}


class MoveCount:
    """Wraps one engine's ``_move`` (the one point where a tensor goes
    from rank to rank): the crossings, their bytes, and the bytes of
    those between two cards."""

    def __init__(self, engine):
        self.engine, self.inner = engine, engine._move
        self.crossings = self.bytes = self.card_bytes = 0
        engine._move = self

    def __call__(self, t, src, dst):
        nbytes = t.numel() * t.element_size()
        self.crossings += 1
        self.bytes += nbytes
        if t.device != self.engine.rank_devices[dst]:
            self.card_bytes += nbytes
        return self.inner(t, src, dst)


def _link_bytes(engine, P: int, field: str) -> int:
    """The link twin's ``field`` summed over every rank's rows."""
    return sum(row[field] for r in range(P)
               for row in engine.link_stats_for(r))


def driver_rows(devices: list, sizes: list, check: bool = True,
                lane: str = "ring") -> list:
    """The driver's allreduce on CudaWorld(devices=) in one lane
    (``DRIVER_LANES``): s a call, busbw, the crossings a call through the
    engine's ``_move`` and the bytes of them between two cards (the ring
    lane's kernels hop across the cards themselves: none), the link
    twin's bytes a call, and (``check``) every result bitwise: the ring
    lane's against the plain composition, the others' against the same
    calls on CudaWorld(P) on one card."""
    import numpy as np

    from accl_tpu_torch import CudaWorld, DataType
    from accl_tpu_torch.ops import ring

    P = len(devices)
    kw = dict(DRIVER_LANES[lane])
    if kw.pop("compress", False):
        kw["compress_dtype"] = DataType.int8
    field = "comp_tx_bytes" if "compress_dtype" in kw else "tx_bytes"
    rows = []
    with CudaWorld(P, devices=devices) as world:
        spy = MoveCount(world.engine)
        for mib in sizes:
            count = mib * MIB // 4
            bufs = [world.accls[r].create_buffer(count, np.float32)
                    for r in range(P)]
            outs = [world.accls[r].create_buffer(count, np.float32)
                    for r in range(P)]
            gen = torch.Generator().manual_seed(mib)
            for b in bufs:
                b.dev.copy_(torch.randn(count, generator=gen))

            def call(accl, r):
                accl.allreduce(bufs[r], outs[r], count, from_fpga=True,
                               to_fpga=True, **kw)

            before = (ring.ring_reduce_scatter.launches_cross,
                      ring.ring_all_gather.launches_cross)
            moved = (spy.crossings, spy.bytes, spy.card_bytes,
                     _link_bytes(world.engine, P, field))
            world.run(call)
            for d in world.engine.cards():
                torch.cuda.synchronize(d)
            launched = [ring.ring_reduce_scatter.launches_cross - before[0],
                        ring.ring_all_gather.launches_cross - before[1]]
            crossings = spy.crossings - moved[0]
            moved_bytes = spy.bytes - moved[1]
            card_bytes = spy.card_bytes - moved[2]
            twin = _link_bytes(world.engine, P, field) - moved[3]
            bitwise = None
            if check and lane == "ring":
                want = ring.ring_all_reduce_segmented(
                    [b.dev for b in bufs], "sum", plain=True)
                bitwise = all(torch.equal(o.dev, w)
                              for o, w in zip(outs, want))
                del want
            elif check:
                bitwise = _one_card_same(P, bufs, outs, count, kw)
            samples = []
            for _ in range(3):
                t = time.perf_counter()
                for _ in range(5):
                    world.run(call)
                for d in world.engine.cards():
                    torch.cuda.synchronize(d)
                samples.append((time.perf_counter() - t) / 5)
            s = statistics.median(samples)
            algbw = mib * MIB / s / 1e9
            rows.append({"lane": lane, "mib_per_rank": mib, "ranks": P,
                         "devices": [str(d) for d in devices],
                         "s_per_call": s, "s_samples": samples,
                         "algbw_GBps": algbw,
                         "busbw_GBps": algbw * 2 * (P - 1) / P,
                         "cross_launches_per_call": launched,
                         "moves_per_call": crossings,
                         "moved_bytes_per_call": moved_bytes,
                         "card_bytes_per_call": card_bytes,
                         "card_MiB_per_call": card_bytes / MIB,
                         "link_twin_bytes_per_call": twin,
                         "bitwise": bitwise})
            for b in bufs + outs:
                b.free()
            del bufs, outs
    return rows


def _one_card_same(P: int, bufs, outs, count: int, kw: dict) -> bool:
    """The same allreduce on CudaWorld(P) on one card, from the same
    operands: is every rank's result bitwise ``outs``'?"""
    import numpy as np

    from accl_tpu_torch import CudaWorld

    with CudaWorld(P) as one:
        src = [one.accls[r].create_buffer(count, np.float32)
               for r in range(P)]
        dst = [one.accls[r].create_buffer(count, np.float32)
               for r in range(P)]
        for a, b in zip(src, bufs):
            a.dev.copy_(b.dev)
        one.run(lambda accl, r: accl.allreduce(src[r], dst[r], count,
                                               from_fpga=True, to_fpga=True,
                                               **kw))
        same = all(torch.equal(d.dev, o.dev.to(d.dev.device))
                   for d, o in zip(dst, outs))
        for b in src + dst:
            b.free()
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="4,16,64,256")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--lanes", default="ring",
                    help="the driver rows' lanes, comma-separated, of "
                         + ", ".join(DRIVER_LANES))
    ap.add_argument("--driver-only", action="store_true",
                    help="only the driver rows (no ring_launch rows)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multicard: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = card_line()
    report = card_report()
    rows = [{"phase": "cards", **report}]
    print(json.dumps(rows[-1]), flush=True)
    C = report["count"]
    layouts = ([("one_a_card", [f"cuda:{c}" for c in range(C)]),
                ("two_a_card", [f"cuda:{c}" for c in range(C)
                                for _ in range(2)])] if C > 1 else [])
    for n in (() if args.driver_only else (SEG_N, BIG_N)):
        if C == 1:
            for tables in (False, True):
                for row in ring_launch_rows(["cuda:0"] * 8, n, args.iters,
                                            tables):
                    rows.append({"phase": "ring_launch", **row})
                    print(json.dumps(rows[-1]), flush=True)
        for label, devices in layouts:
            for row in ring_launch_rows(devices, n, args.iters):
                rows.append({"phase": "ring_launch", "layout": label, **row})
                print(json.dumps(rows[-1]), flush=True)
    if C > 1:
        sizes = [int(v) for v in args.sizes.split(",")]
        for lane in args.lanes.split(","):
            for row in driver_rows([f"cuda:{c}" for c in range(C)], sizes,
                                   lane=lane):
                rows.append({"phase": "driver_allreduce", **row})
                print(json.dumps(rows[-1]), flush=True)
    else:
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
