"""Measure, persist and verify a collective selection table.

Port of ``scripts/accl_tune.py``: sweeps (collective, dtype, size
bucket, algorithm) lanes through the bench sweep harness on a
``CudaWorld`` (the card) or an ``EmuWorld`` (the native emulator), writes
the versioned JSON selection table that ``ACCL.initialize`` arms through
``ACCL_TUNE_TABLE``, and with ``--record`` re-measures static against
tuned per cell — interleaved, best-of, unreproducible selections pruned
back to static — into a CSV and an MD file under the prefix given.

Usage:
  python -m accl_tpu_torch.tuning.cli --backend cuda --ranks 8 \\
      --mib 1,4,16,64 --out table.json --record out/tuned_vs_static
  python -m accl_tpu_torch.tuning.cli --backend emu --ranks 4 \\
      --shape 2x2 --out table.json

``--backend cuda`` (the default) needs the card and fails without one:
unlike the JAX script, it never falls back to another backend.
``--mib`` sizes each collective's cells by the table's payload bytes
(the nccl-tests payload factor included, so an allgather's cell of 64 MiB
moves 64 MiB in all), in place of ``--pows``' element counts.
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import subprocess
import sys
import time
from dataclasses import replace


def card_of() -> dict:
    """The card's name and power limit as nvidia-smi reports them (name
    from torch where nvidia-smi cannot be run)."""
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        line = ""
    name, _, limit = line.partition(",")
    return {"name": name.strip() or torch.cuda.get_device_name(0),
            "power_limit": limit.strip() or "not read"}


def pows_for(coll: str, mib: list, nranks: int, itemsize: int) -> tuple:
    """log2 element counts whose payload bytes (the nccl-tests factor
    included) are ``mib`` MiB for ``coll`` at ``nranks`` ranks."""
    from ..observability import metrics as _metrics

    per = _metrics.payload_factor(coll, nranks) * itemsize
    pows = []
    for m in mib:
        count = m * (1 << 20) / per
        pw = int(round(math.log2(count))) if count >= 1 else -1
        if pw < 0 or (1 << pw) != count:
            raise SystemExit(
                f"--mib {m}: {coll} at {nranks} ranks needs {count:g} "
                f"elements, not a power of two")
        pows.append(pw)
    return tuple(pows)


def tune_sizes(world, config, mib: list, log=print):
    """:func:`autotune.tune` with each collective's cells sized by
    payload bytes (``mib``): one fabric, one sweep per collective, one
    table."""
    from . import autotune

    fabric = autotune.tune_fabric(world, config, log)
    itemsize = autotune._sweep._resolve_dtype(config.dtype).itemsize
    rows = []
    for coll in config.collectives:
        rows += autotune.measure(
            world, replace(config, collectives=(coll,),
                           count_pows=pows_for(coll, mib, world.nranks,
                                               itemsize)),
            fabric=fabric, log=log)
    return autotune.build_table(
        rows, autotune.table_meta(world, fabric, config))


def write_record(prefix: str, rows: list, table, args, dtypes) -> int:
    """The tuned-vs-static record (``prefix``.csv and .md); returns the
    cells still more than 1.05x slower than static."""
    with open(f"{prefix}.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "collective", "dtype", "size_bucket", "count", "bytes",
            "algorithm", "static_busbw_GBps", "tuned_busbw_GBps", "ratio"])
        w.writeheader()
        w.writerows(rows)
    wins = sum(1 for r in rows if r["ratio"] >= 1.15)
    slow = [r for r in rows if r["ratio"] < 1.0 / 1.05]
    tuned_cells = sum(1 for r in rows if r["algorithm"] != "static")
    card = table.world.get("card")
    with open(f"{prefix}.md", "w") as f:
        f.write(
            f"# Tuned vs static sweep record\n\n"
            f"- world: {args.ranks} ranks, {args.backend} backend, "
            f"fabric {table.world.get('shape')}, dtypes "
            f"{','.join(dtypes)}\n"
            + (f"- card: {card['name']}, power limit "
               f"{card['power_limit']}\n" if card else "")
            + f"- table: {os.path.basename(args.out)} "
            f"({len(table.entries)} cells, "
            f"{tuned_cells} non-static selections after "
            f"verification pruning)\n"
            f"- wins >= 1.15x busbw vs static: {wins} cells\n"
            f"- cells > 1.05x slower than static: {len(slow)} "
            f"(gate: must be 0)\n\n"
            f"| collective | dtype | bucket | algorithm | "
            f"static GB/s | tuned GB/s | ratio |\n"
            f"|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['collective']} | {r['dtype']} | "
                    f"{r['size_bucket']} | {r['algorithm']} | "
                    f"{r['static_busbw_GBps']} | {r['tuned_busbw_GBps']} | "
                    f"{r['ratio']}x |\n")
    print(f"[accl_tune] record: {prefix}.csv ({wins} wins >= 1.15x, "
          f"{len(slow)} cells slower than 1/1.05)")
    return len(slow)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m accl_tpu_torch.tuning.cli")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=("cuda", "emu"), default="cuda")
    ap.add_argument("--shape", default="",
                    help="fabric axis layout, e.g. 2x4 (default: "
                         "ACCL_FABRIC env / near-square factorization)")
    ap.add_argument("--collectives", default="",
                    help="comma list (default: the composable set + "
                         "reduce)")
    ap.add_argument("--pows", default="",
                    help="comma list of log2 element counts "
                         "(default 6,8,10,12,14,16)")
    ap.add_argument("--mib", default="",
                    help="comma list of payload sizes in MiB, each "
                         "collective's element counts derived from them "
                         "(overrides --pows)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--dtypes", default="",
                    help="comma list of dtypes swept into ONE table "
                         "(default: just --dtype; unswept dtypes are "
                         "served the float32 row at dispatch)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="tune_table.json",
                    help="selection-table JSON path")
    ap.add_argument("--record", default="",
                    help="path PREFIX for the tuned-vs-static "
                         "verification record (.csv + .md written)")
    ap.add_argument("--no-demotion", action="store_true",
                    help="skip measured link-matrix axis demotion")
    args = ap.parse_args(argv)

    # a many-rank cell on a loaded host can stall a rank past the
    # reference 1 s receive budget (an explicit env still wins)
    os.environ.setdefault("ACCL_DEFAULT_TIMEOUT", "30000000")

    from . import TuneConfig, autotune
    from ..utils.topology import parse_shape

    shape = parse_shape(args.shape) if args.shape else None
    kwargs = {}
    if args.collectives:
        kwargs["collectives"] = tuple(args.collectives.split(","))
    pows = (tuple(int(p) for p in args.pows.split(","))
            if args.pows else (6, 8, 10, 12, 14, 16))
    mib = [int(m) for m in args.mib.split(",")] if args.mib else []
    dtypes = (tuple(d.strip() for d in args.dtypes.split(",") if d.strip())
              if args.dtypes else (args.dtype,))
    cfg = TuneConfig(count_pows=pows, dtype=dtypes[0],
                     repetitions=args.reps, shape=shape,
                     measured_demotion=not args.no_demotion, **kwargs)

    card = None
    if args.backend == "cuda":
        from ..backends.cuda import CudaWorld
        from ..bench.sweep import claim_platform

        claim_platform("cuda")  # raises without a card: no fallback
        world = CudaWorld(args.ranks)
        card = card_of()
    else:
        from ..backends.emu import EmuWorld

        world = EmuWorld(args.ranks, devmem_bytes=256 << 20,
                         n_egr_rx_bufs=64, max_eager_size=16384,
                         max_rendezvous_size=64 << 20)

    t0 = time.perf_counter()
    try:
        sizes = f"{len(mib)} payload sizes" if mib else f"{len(pows)} sizes"
        print(f"[accl_tune] tuning {args.ranks} ranks on {args.backend} "
              f"({sizes} x {len(cfg.collectives)} collectives x "
              f"{len(dtypes)} dtypes)"
              + (f" on {card['name']}, {card['power_limit']}"
                 if card else ""))
        table = None
        for d in dtypes:
            cfg_d = replace(cfg, dtype=d)
            if len(dtypes) > 1:
                print(f"[accl_tune] dtype lane: {d}")
            t = (tune_sizes(world, cfg_d, mib) if mib
                 else autotune.tune(world, cfg_d, log=print))
            if table is None:
                table = t
            else:
                # one table, one cell per (collective, dtype, bucket)
                table.entries.update(t.entries)
                table._dtypes = None
        table.world["dtypes"] = list(dtypes)
        if card is not None:
            table.world["card"] = card
        rows = []
        if args.record:
            print("[accl_tune] verifying tuned vs static (interleaved, "
                  "pruning unreproducible selections)")
            for d in dtypes:
                rows.extend(autotune.compare(
                    world, table, replace(cfg, dtype=d), log=print))
    finally:
        world.close()

    table.save(args.out)
    print(f"[accl_tune] table: {args.out} ({len(table.entries)} cells, "
          f"{time.perf_counter() - t0:.0f}s)")
    if args.record and write_record(args.record, rows, table, args, dtypes):
        print("[accl_tune] FAIL: the verified record still has "
              "slower-than-static cells", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
