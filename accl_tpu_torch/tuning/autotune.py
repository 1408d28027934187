"""Persistent autotuner: measured algorithm selection over the fabric.

Port of ``accl_tpu/tuning/autotune.py``.  Sweeps (collective, dtype,
size-bucket, world-shape, algorithm) through the bench sweep harness
(:mod:`accl_tpu_torch.bench.sweep` timing/bandwidth conventions: host-
staged calls), persists the winners as a versioned JSON
:class:`SelectionTable` (the ``accl-tune-table`` v1 format both packages
read), and serves them back through a :class:`SelectionPolicy`:

- ``install(accl)`` derives the backend's threshold registers from the
  learned table — ``Engine::set_tuning`` flat/tree crossovers on the
  emulator engine (``EmuWorld``, backend ``emu``), the ring/plain
  crossover (``TuningKey.RING_THRESHOLD_BYTES``) on the card's engine
  (``CudaWorld``, backend ``cuda``, the JAX package's ``tpu`` lanes) — so
  the static firmware-ported constants become the backend of a measured
  policy;
- ``on_call`` is the driver's per-call consult in ``ACCL._execute``:
  one memoized dict probe per descriptor signature, publishing the
  decision as the ``tuning/selected/<algorithm>`` metric family.

Knobs: ``ACCL_TUNE_TABLE=path`` arms the policy at ``initialize``;
``ACCL_TUNE=0`` disarms it (with both unset nothing is loaded, no
register differs, and dispatch is bit-identical to the static
thresholds).  The ``hierarchical`` lane is served by
:class:`~accl_tpu_torch.tuning.compose.HierarchicalComm` — the composer
entry points, a captured plan of them, or the driver's table route; the
flat/tree/ring lanes are register-backed and apply to plain driver calls
transparently.
"""
from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from ..bench import sweep as _sweep
from ..constants import ACCLError, ReduceFunction, TuningKey
from ..observability import metrics as _metrics
from ..utils.logging import get_logger
from .compose import HierarchicalComm
from .topology import Fabric

TABLE_FORMAT = "accl-tune-table"
TABLE_VERSION = 1

#: every algorithm a table may name; per backend only a subset is
#: measurable (see :func:`algorithms_for`).  The compress_* lanes
#: are the quantized wire widths: the schedule is static's, the
#: payload crosses the wire block-scaled int8 or cast-fp16 — a win in
#: a cell arms the driver's CompressionPolicy at install.
ALGORITHMS = ("static", "flat", "tree", "ring", "hierarchical",
              "compress_int8", "compress_fp16", "fused")

#: collectives the fused (pipelined compute/communication) lane
#: reshapes — the descriptor opt-in routed by backends/cuda.py; a win in
#: a cell means SelectionPolicy should serve ``fused`` for that size
#: bucket under the same never-slower prune as every other lane
FUSED_COLLECTIVES = frozenset(("allreduce", "reduce_scatter"))

#: the measurable compression lanes and their wire dtypes (per-dtype
#: tables: these lanes only cover float32 cells — cell keys already
#: carry the dtype, so the never-slower compare() prune is per dtype
#: by construction)
COMPRESSION_ALGS = ("compress_int8", "compress_fp16")

#: collectives the compression lanes can touch (the CompressionPolicy
#: default set minus p2p; alltoall has no compress_dtype)
COMPRESS_COLLECTIVES = frozenset((
    "allreduce", "reduce_scatter", "allgather", "reduce", "bcast"))


def _compress_dtype_of(alg: str):
    from ..constants import DataType

    return {"compress_int8": DataType.int8,
            "compress_fp16": DataType.float16}[alg]

ENV_TABLE = "ACCL_TUNE_TABLE"
ENV_TUNE = "ACCL_TUNE"

_HUGE = 0x7FFFFFFF

#: overlap objective: lanes within this busbw fraction of the
#: cell's fastest are a TIE, resolved toward the lane that recovered
#: the most compute time (lowest ``attribution.overlap`` exposed-wire
#: fraction).  2% sits inside best-of-reps measurement noise, so the
#: tie-break never overrules a real bandwidth win.
OVERLAP_TIE_BAND = 0.02

_BUCKET_UNITS = {"B": 1, "KiB": 1 << 10, "MiB": 1 << 20,
                 "GiB": 1 << 30, "TiB": 1 << 40}
_BUCKET_RE = re.compile(r"<=(\d+)(B|KiB|MiB|GiB|TiB)$")


def bucket_bytes(bucket: str) -> int:
    """Invert :func:`metrics.size_bucket`: the bucket label's
    upper-bound payload in bytes — the representative size a targeted
    online re-measure probes.  0 for the degenerate ``0B`` bucket (and
    anything unparseable: the caller skips those cells)."""
    m = _BUCKET_RE.match(bucket)
    return int(m.group(1)) * _BUCKET_UNITS[m.group(2)] if m else 0


@dataclass
class TuneConfig:
    """One tuning run's sweep space (defaults sized for the emu rung)."""

    collectives: tuple = ("allreduce", "reduce_scatter", "allgather",
                          "bcast", "scatter", "gather", "reduce")
    count_pows: Iterable[int] = tuple(range(6, 17, 2))  # 2^6..2^16 elems
    dtype: str = "float32"
    repetitions: int = 3
    root: int = 0
    shape: Optional[tuple] = None  # fabric layout; None = env/probe
    #: demote axes from a measured link matrix before composing
    measured_demotion: bool = True
    algorithms: Optional[tuple] = None  # None = algorithms_for(world)
    extra: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# selection table (the persisted artifact)
# ---------------------------------------------------------------------------

def cell_key(coll: str, dtype: str, bucket: str, nranks: int) -> str:
    return f"{coll}|{dtype}|{bucket}|{nranks}"


class SelectionTable:
    """The versioned, machine-specific (collective, dtype, size-bucket,
    world-shape) -> algorithm map the policy serves."""

    def __init__(self, entries: dict, world: dict):
        self.entries = entries
        self.world = world
        self._dtypes: Optional[frozenset] = None
        self._fallback_logged: set = set()

    def dtypes(self) -> frozenset:
        """The dtypes this table has swept cells for (cached; any
        entry mutation must clear ``_dtypes``)."""
        if self._dtypes is None:
            self._dtypes = frozenset(
                k.split("|")[1] for k in self.entries)
        return self._dtypes

    def lookup(self, coll: str, dtype: str, nbytes: int,
               nranks: int) -> Optional[dict]:
        bucket = _metrics.size_bucket(nbytes)
        entry = self.entries.get(cell_key(coll, dtype, bucket, nranks))
        if entry is not None or dtype == "float32":
            return entry
        # per-dtype tables: a dtype the sweep never covered is
        # served the float32 row — the schedule crossovers are shaped
        # by payload bytes, not element type — and logged once so an
        # operator knows the selection is borrowed, not measured
        if dtype in self.dtypes():
            return None  # swept dtype, genuinely untuned cell
        entry = self.entries.get(
            cell_key(coll, "float32", bucket, nranks))
        if entry is not None and dtype not in self._fallback_logged:
            self._fallback_logged.add(dtype)
            get_logger("accl_tpu_torch.tuning").info(
                "selection table has no %s cells; serving the float32 "
                "row (sweep it: python -m accl_tpu_torch.tuning.cli "
                "--dtype %s)", dtype, dtype)
        return entry

    def to_doc(self) -> dict:
        return {
            "format": TABLE_FORMAT,
            "version": TABLE_VERSION,
            "world": self.world,
            "entries": self.entries,
        }

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def from_doc(cls, doc: dict, source: str = "<doc>") -> "SelectionTable":
        if not isinstance(doc, dict) or doc.get("format") != TABLE_FORMAT:
            raise ACCLError(
                f"{source}: not a selection table (format="
                f"{doc.get('format') if isinstance(doc, dict) else doc!r};"
                f" want {TABLE_FORMAT!r})")
        version = doc.get("version")
        if version != TABLE_VERSION:
            raise ACCLError(
                f"{source}: selection-table version {version!r} is not "
                f"supported (this build reads version {TABLE_VERSION}; "
                f"re-run scripts/accl_tune.py to regenerate)")
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            raise ACCLError(f"{source}: corrupt selection table — "
                            f"'entries' is {type(entries).__name__}, "
                            f"not a dict")
        for key, e in entries.items():
            if (not isinstance(e, dict)
                    or e.get("algorithm") not in ALGORITHMS
                    or len(key.split("|")) != 4):
                raise ACCLError(
                    f"{source}: corrupt selection-table entry {key!r}: "
                    f"{e!r} (want collective|dtype|bucket|nranks -> "
                    f"{{algorithm in {ALGORITHMS}}})")
        return cls(entries, doc.get("world", {}))

    @classmethod
    def load(cls, path: str) -> "SelectionTable":
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as e:
            raise ACCLError(
                f"{ENV_TABLE}={path}: cannot read selection table "
                f"({e})") from e
        except ValueError as e:
            raise ACCLError(
                f"{ENV_TABLE}={path}: corrupt selection table (not "
                f"JSON: {e})") from e
        return cls.from_doc(doc, source=path)


# ---------------------------------------------------------------------------
# algorithm lanes (world-level knob application)
# ---------------------------------------------------------------------------

def backend_of(obj) -> str:
    """'cuda' for the shared-comm-table backend (a ``CudaWorld``, where
    the JAX package answers 'tpu' for a ``TpuWorld``), 'emu' otherwise;
    works for worlds (devices[0]) and drivers (device)."""
    dev = obj.devices[0] if hasattr(obj, "devices") else obj.device
    return "cuda" if getattr(dev, "comm_table_is_shared", False) else "emu"


def algorithms_for(world, dtype: str = "float32") -> tuple:
    """The measurable lanes per backend: the emulator engine's flat vs
    binomial-tree schedule registers (its rendezvous allreduce is
    already ring-based), the card engine's ring/plain crossover and its
    fused lane (the JAX package's TPU lanes), the composer on both, and
    — for float32 cells — the compression lanes (other dtypes have no
    compressed pair registered)."""
    comp = COMPRESSION_ALGS if dtype == "float32" else ()
    if backend_of(world) == "cuda":
        return ("static", "flat", "ring", "hierarchical", "fused") + comp
    return ("static", "flat", "tree", "hierarchical") + comp


#: which collectives each REGISTER lane can touch at all.  The emu
#: engine consults the flat-tree registers only in bcast / gather /
#: reduce dispatch (engine.cpp tree_bcast/fanin/tree_reduce switches);
#: the card's ring threshold reshapes only allreduce / allgather /
#: reduce_scatter gang plans.
LANE_COLLECTIVES = {
    ("emu", "flat"): frozenset(("bcast", "gather", "reduce")),
    ("emu", "tree"): frozenset(("bcast", "gather", "reduce")),
    ("cuda", "flat"): frozenset(("allreduce", "allgather",
                                 "reduce_scatter")),
    ("cuda", "ring"): frozenset(("allreduce", "allgather",
                                 "reduce_scatter")),
}


def _emu_static_decision(coll: str, P: int, wire_bytes: int,
                         regs: dict) -> bool:
    """The emu engine's flat-or-not decision under the given register
    values (mirrors engine.cpp: bcast flat iff P <= max_ranks; reduce
    flat iff P <= max_ranks or bytes <= max_count; gather fan-in
    capped iff bytes > max_count)."""
    if coll == "bcast":
        return P <= regs[int(TuningKey.BCAST_FLAT_TREE_MAX_RANKS)]
    if coll == "reduce":
        return (P <= regs[int(TuningKey.REDUCE_FLAT_TREE_MAX_RANKS)]
                or wire_bytes
                <= regs[int(TuningKey.REDUCE_FLAT_TREE_MAX_COUNT)])
    if coll == "gather":
        # "flat" here = fan-in UNcapped
        return wire_bytes <= regs[
            int(TuningKey.GATHER_FLAT_TREE_MAX_COUNT)]
    return True


def lane_covers(backend: str, alg: str, coll: str,
                nranks: Optional[int] = None,
                nbytes: Optional[int] = None,
                static_regs: Optional[dict] = None) -> bool:
    """True when measuring (alg, coll) — at this world size and cell
    payload, when given — exercises a genuinely DIFFERENT dispatch
    than static.  A lane that resolves to the same schedule as the
    static registers (e.g. the tree lane for bcast at P=4, where
    static's max_ranks=3 already picks the tree) is excluded: the
    argmax would otherwise select between bit-identical code paths on
    timing noise and ship phantom wins."""
    if alg == "static":
        return True
    if alg == "hierarchical":
        return coll in HierarchicalComm.COMPOSABLE
    if alg in COMPRESSION_ALGS:
        # a compressed wire is a genuinely different datapath than
        # static at every size; coverage is by collective only
        return coll in COMPRESS_COLLECTIVES
    if alg == "fused":
        # the chunked pipelined ring is a per-descriptor opt-in (no
        # register resolves to it), so it is a different dispatch than
        # static at every size; only the card's engine routes it
        return backend == "cuda" and coll in FUSED_COLLECTIVES
    covered = LANE_COLLECTIVES.get((backend, alg))
    if covered is not None and coll not in covered:
        return False
    if nranks is None or nbytes is None:
        return True  # no cell info: keep the coarse answer
    if backend == "cuda":
        # per-rank operand bytes the gang planner compares (table/
        # sweep bytes carry the nccl payload factor: P for allgather)
        per_rank = nbytes // nranks if coll == "allgather" else nbytes
        static_thr = int(os.environ.get("ACCL_RING_THRESHOLD",
                                        str(4 << 20)))
        static_ring = per_rank >= static_thr
        return static_ring != (alg == "ring")
    if static_regs is None:
        return True
    # emu wire bytes: bcast/reduce/gather payload factors are all 1
    # (metrics._XP_COLLECTIVES covers allgather/reduce_scatter/
    # alltoall only), so table/sweep bytes == the per-rank elems*eb
    # the engine's register compares see
    static_flat = _emu_static_decision(coll, nranks, nbytes, static_regs)
    return static_flat != (alg == "flat")


def apply_algorithm(world, alg: str) -> None:
    """Program every rank's registers for one lane.  ``static``
    restores exactly the initialize-time values
    (:meth:`ACCL.static_tuning` / the env ring threshold)."""
    cuda = backend_of(world) == "cuda"
    for a in world.accls:
        if cuda:
            if alg == "flat":
                a.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES), _HUGE)
            elif alg == "ring":
                a.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES), 0)
            else:  # static / hierarchical / fused ride the env default
                # (the fused lane is a per-CALL descriptor opt-in, not
                # a register: _run_once passes fused=True instead)
                a.set_tuning(
                    int(TuningKey.RING_THRESHOLD_BYTES),
                    int(os.environ.get("ACCL_RING_THRESHOLD",
                                       str(4 << 20))))
            continue
        if alg == "flat":
            for key in (TuningKey.BCAST_FLAT_TREE_MAX_RANKS,
                        TuningKey.REDUCE_FLAT_TREE_MAX_RANKS,
                        TuningKey.GATHER_FLAT_TREE_MAX_FANIN,
                        TuningKey.GATHER_FLAT_TREE_MAX_COUNT,
                        TuningKey.REDUCE_FLAT_TREE_MAX_COUNT):
                a.set_tuning(int(key), _HUGE)
        elif alg == "tree":
            for key in (TuningKey.BCAST_FLAT_TREE_MAX_RANKS,
                        TuningKey.REDUCE_FLAT_TREE_MAX_RANKS,
                        TuningKey.REDUCE_FLAT_TREE_MAX_COUNT,
                        TuningKey.GATHER_FLAT_TREE_MAX_COUNT):
                a.set_tuning(int(key), 0)
            a.set_tuning(int(TuningKey.GATHER_FLAT_TREE_MAX_FANIN), 2)
        else:  # static / hierarchical / compress_* measure against the
            a.apply_static_tuning()  # static registers


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _overlap_marks() -> dict:
    """Per-recorder flight-ring seq watermark, taken before a cell's
    timed reps so the overlap column accounts ONLY that cell's calls."""
    from ..observability import flight as _flight

    return {id(r): (r, max((rec.seq for rec in r.records()),
                           default=-1))
            for r in _flight.recorders()}


def _cell_overlap(marks: dict) -> Optional[float]:
    """The measured ``attribution.overlap`` exposed-wire fraction of
    the flight records landed since ``marks`` (one sweep cell), with
    the trace collector's device stamp slices as compute windows when
    ``ACCL_DEVICE_TRACE`` armed them.  None when nothing completed
    (flight recorder off / single-rank view)."""
    from ..observability import attribution as _attr
    from ..observability import flight as _flight
    from ..observability import trace as _trace

    docs = []
    for rec, mark in marks.values():
        d = rec.dump()
        d["records"] = [r for r in d["records"] if r["seq"] > mark]
        docs.append(d)
    if not docs:
        return None
    trace_doc = (_trace.collector().to_perfetto()
                 if _trace.collector().device_records() else None)
    try:
        rep = _attr.overlap(_flight.merge_flight_dumps(docs),
                            trace_doc=trace_doc)
    except (ACCLError, ValueError, KeyError):
        return None
    wire = sum(c["wire_us"] for c in rep["collectives"].values())
    exposed = sum(c["exposed_us"] for c in rep["collectives"].values())
    return round(exposed / wire, 4) if wire > 0 else None


def _run_once_hier(world, hier, coll: str, count: int, dtype,
                   root: int) -> float:
    """One timed hierarchical collective across all ranks (the
    composer twin of bench.sweep._run_once; same buffer discipline and
    max-duration convention)."""
    P = world.nranks

    def body(accl, rank):
        h = hier[rank]
        made = []

        def mk(factory, *args):
            buf = factory(*args)
            made.append(buf)
            return buf

        data = np.full(count, rank + 1, dtype)
        try:
            if coll == "allreduce":
                send = mk(accl.create_buffer_like, data)
                recv = mk(accl.create_buffer, count, dtype)
                t0 = time.perf_counter()
                h.allreduce(send, recv, count, ReduceFunction.SUM)
                return time.perf_counter() - t0
            if coll == "reduce_scatter":
                send = mk(accl.create_buffer_like, np.tile(data, P))
                recv = mk(accl.create_buffer, count, dtype)
                t0 = time.perf_counter()
                h.reduce_scatter(send, recv, count, ReduceFunction.SUM)
                return time.perf_counter() - t0
            if coll == "allgather":
                send = mk(accl.create_buffer_like, data)
                recv = mk(accl.create_buffer, count * P, dtype)
                t0 = time.perf_counter()
                h.allgather(send, recv, count)
                return time.perf_counter() - t0
            if coll == "bcast":
                buf = mk(accl.create_buffer_like, data)
                t0 = time.perf_counter()
                h.bcast(buf, count, root)
                return time.perf_counter() - t0
            if coll == "scatter":
                send = mk(accl.create_buffer_like, np.tile(data, P))
                recv = mk(accl.create_buffer, count, dtype)
                t0 = time.perf_counter()
                h.scatter(send, recv, count, root)
                return time.perf_counter() - t0
            if coll == "gather":
                send = mk(accl.create_buffer_like, data)
                recv = mk(accl.create_buffer, count * P, dtype)
                t0 = time.perf_counter()
                h.gather(send, recv, count, root)
                return time.perf_counter() - t0
            raise ACCLError(f"hierarchical lane has no {coll!r}")
        finally:
            for buf in made:
                free = getattr(buf, "free", None)
                if free is not None:
                    free()

    return max(world.run(body))


def measure(world, config: TuneConfig = TuneConfig(),
            fabric: Optional[Fabric] = None,
            hier: Optional[list] = None,
            log=None) -> list:
    """Sweep every lane x cell; returns rows with the bench sweep's
    bandwidth conventions plus an ``algorithm`` column (best-of-reps:
    shared-core noise would otherwise thrash the argmax)."""
    P = world.nranks
    dtype = _sweep._resolve_dtype(config.dtype)
    algs = config.algorithms or algorithms_for(world, config.dtype)
    own_hier = False
    if "hierarchical" in algs and hier is None:
        fabric = fabric or Fabric.for_world(P, shape=config.shape)
        hier = ([HierarchicalComm(a, fabric) for a in world.accls]
                if not fabric.trivial else None)
        own_hier = hier is not None
    backend = backend_of(world)
    static_regs = world.accls[0].static_tuning()
    rows = []
    try:
        for alg in algs:
            apply_algorithm(world, alg)
            for coll in config.collectives:
                if alg == "hierarchical" and hier is None:
                    continue
                for pw in config.count_pows:
                    count = 1 << pw
                    nbytes = (count * _sweep._payload_factor(coll, P)
                              * dtype.itemsize)
                    if not lane_covers(backend, alg, coll, nranks=P,
                                       nbytes=nbytes,
                                       static_regs=static_regs):
                        continue

                    def run(coll=coll, count=count):
                        return run_cell_lane(world, alg, coll, count,
                                             dtype, config.root, hier)

                    run()  # untimed warmup (kernel builds, path setup)
                    marks = _overlap_marks()
                    dur = min(run() for _ in range(config.repetitions))
                    algbw = nbytes / dur / 1e9 if dur > 0 else 0.0
                    rows.append({
                        "algorithm": alg,
                        "collective": coll,
                        # per-dtype tables: rows carry their own
                        # dtype so one table can merge multiple sweeps
                        "dtype": config.dtype,
                        "count": count,
                        "bytes": nbytes,
                        "size_bucket": _metrics.size_bucket(nbytes),
                        "duration_us": round(dur * 1e6, 2),
                        "busbw_GBps": round(
                            algbw * _sweep._busbw_factor(coll, P), 4),
                        # measured exposed-wire fraction of this
                        # cell's reps (attribution.overlap)
                        "overlap": _cell_overlap(marks),
                    })
                    if log:
                        r = rows[-1]
                        log(f"  {alg:>12} {coll:<14} {count:>8} elems "
                            f"{r['duration_us']:>10.1f} us "
                            f"{r['busbw_GBps']:>8.3f} GB/s")
    finally:
        apply_algorithm(world, "static")
        if own_hier and hier is not None:
            for h in hier:
                h.close()  # drop cached scratch; sub-comms stay (ids
                # are burned either way — the create-order discipline)
    return rows


def _tie_rank(r: dict) -> tuple:
    """Ordering within a busbw tie band: most recovered compute fraction
    (1 - overlap) first, then raw busbw, then static (ties on a box
    with no flight coverage keep the plain argmax winner)."""
    ov = r.get("overlap")
    recovered = (1.0 - ov) if ov is not None else -1.0
    return (recovered, r["busbw_GBps"], r["algorithm"] == "static")


def build_table(rows: list, world_meta: dict) -> SelectionTable:
    """Per-cell argmax busbw over the measured lanes.  ``static`` is
    always a candidate, so a tuned world is never knowingly worse than
    the static thresholds on any measured cell.  Lanes within
    ``OVERLAP_TIE_BAND`` of the fastest are tie-broken toward the one
    with the lowest measured exposed-wire fraction
    (``attribution.overlap`` folded into the objective): equal wire
    speed, more compute time recovered."""
    cells: dict = {}
    for r in rows:
        key = cell_key(r["collective"],
                       r.get("dtype")
                       or world_meta.get("dtype", "float32"),
                       r["size_bucket"], world_meta["nranks"])
        cells.setdefault(key, []).append(r)
    entries = {}
    for key, cands in cells.items():
        top = max(cands, key=lambda r: r["busbw_GBps"])
        band = [r for r in cands if r["busbw_GBps"]
                >= top["busbw_GBps"] * (1.0 - OVERLAP_TIE_BAND)]
        best = max(band, key=_tie_rank) if len(band) > 1 else top
        static = next((r for r in cands if r["algorithm"] == "static"),
                      None)
        entries[key] = {
            "algorithm": best["algorithm"],
            "busbw_GBps": best["busbw_GBps"],
            "static_busbw_GBps":
                static["busbw_GBps"] if static else None,
            "bytes": best["bytes"],
            # the winner's measured exposed-wire fraction (None
            # when the cell had no flight coverage)
            "overlap": best.get("overlap"),
        }
    return SelectionTable(entries, world_meta)


def tune(world, config: TuneConfig = TuneConfig(), log=None,
         ) -> SelectionTable:
    """The full pipeline: fabric (with measured demotion when the world
    has link counters) -> lane sweep -> argmax table."""
    fabric = tune_fabric(world, config, log)
    rows = measure(world, config, fabric=fabric, log=log)
    return build_table(rows, table_meta(world, fabric, config))


def tune_fabric(world, config: TuneConfig, log=None) -> Fabric:
    """The fabric :func:`tune` measures on: the world's measured link
    matrix (with ``measured_demotion``) where it has blocked time, else
    the config's shape or the default chain."""
    fabric = None
    if config.measured_demotion:
        try:
            matrix = world.link_matrix()
            if any(v for row in matrix["fields"]["seek_wait_ns"]
                   for v in row):
                fabric = Fabric.from_link_matrix(matrix,
                                                 shape=config.shape)
                if log:
                    log(f"fabric from measured links: {fabric.spec()}")
        except (ACCLError, KeyError, AttributeError):
            fabric = None
    if fabric is None:
        fabric = Fabric.for_world(world.nranks, shape=config.shape)
        if log:
            log(f"fabric: {fabric.spec()}")
    return fabric


def table_meta(world, fabric: Fabric, config: TuneConfig) -> dict:
    """A table's ``world`` block: what :func:`fabric_of_table` rebuilds
    the fabric from, and the backend and dtype it was measured on."""
    return {
        "nranks": world.nranks,
        "shape": list(fabric.shape),
        "axis_order": list(fabric.axis_order),
        "backend": backend_of(world),
        "dtype": config.dtype,
    }


def fabric_of_table(table: SelectionTable, nranks: int,
                    fallback_shape=None) -> Fabric:
    """Rebuild the fabric a table was tuned on from its persisted world
    meta (shape + axis_order), so verification and serving compose the
    SAME way tune() measured — including measured axis demotion."""
    meta = table.world or {}
    shape = meta.get("shape") or fallback_shape
    order = meta.get("axis_order")
    try:
        return Fabric(nranks, shape=shape,
                      axis_order=tuple(order) if order else None)
    except ACCLError:
        # a table that failed to carry its own shape: the default chain
        return Fabric.for_world(nranks, shape=fallback_shape)


def compare(world, table: SelectionTable,
            config: TuneConfig = TuneConfig(), log=None,
            prune: bool = True, retries: int = 2,
            fabric: Optional[Fabric] = None,
            hier: Optional[list] = None) -> list:
    """Static vs tuned verification rows (the committed
    ``sweep_rNN_tuned_vs_static`` record): re-measures each table cell
    under the static registers and under the table's chosen lane —
    INTERLEAVED rep pairs in the same session, best-of per lane, so
    box drift hits both lanes alike — and reports the busbw ratio.

    With ``prune`` (the default), a selection that cannot reproduce
    its win within ``retries`` fresh measurement rounds is DEMOTED to
    ``static`` in the table itself: the tuner refuses to ship a
    selection it cannot verify, so a verified table is never slower
    than static on any measured cell by construction."""
    P = world.nranks
    if fabric is None:
        # the fabric the table was MEASURED on (incl. demotion), not a
        # fresh default — verifying a different composition would prune
        # every demoted-fabric win as unreproducible
        fabric = fabric_of_table(table, P, fallback_shape=config.shape)
    own_hier = False
    if hier is None and not fabric.trivial:
        hier = [HierarchicalComm(a, fabric) for a in world.accls]
        own_hier = True
    dtype = _sweep._resolve_dtype(config.dtype)
    out = []
    for key, entry in sorted(table.entries.items()):
        coll, dt, bucket, nranks = key.split("|")
        if int(nranks) != P or dt != config.dtype:
            continue
        count = int(entry["bytes"] // (_sweep._payload_factor(coll, P)
                                       * dtype.itemsize))
        alg = entry["algorithm"]
        nbytes = (count * _sweep._payload_factor(coll, P)
                  * dtype.itemsize)
        if (alg == "hierarchical" and hier is None) or not lane_covers(
                backend_of(world), alg, coll, nranks=P, nbytes=nbytes,
                static_regs=world.accls[0].static_tuning()):
            alg = "static"
        bwf = _sweep._busbw_factor(coll, P)

        def run_lane(lane):
            return run_cell_lane(world, lane, coll, count, dtype,
                                 config.root, hier)

        def to_bw(dur):
            return round(nbytes / dur / 1e9 * bwf, 4) if dur > 0 else 0.0

        def measure_pair():
            run_lane("static"), run_lane(alg)  # warm both lanes
            ds, dt_ = [], []
            for _ in range(config.repetitions):
                ds.append(run_lane("static"))
                dt_.append(run_lane(alg))
            return to_bw(min(ds)), to_bw(min(dt_))

        if alg == "static":
            static_bw = tuned_bw = measure_pair()[0]
        else:
            static_bw, tuned_bw = measure_pair()
            attempts = retries
            while tuned_bw < static_bw and attempts > 0:
                attempts -= 1
                s2, t2 = measure_pair()
                # symmetric best-of across rounds: both lanes keep
                # their best showing, so retrying cannot bias the
                # ratio toward either side
                static_bw = max(static_bw, s2)
                tuned_bw = max(tuned_bw, t2)
            if prune and tuned_bw < static_bw:
                # unreproducible win: ship static for this cell
                table.entries[key] = dict(
                    entry, algorithm="static",
                    busbw_GBps=entry.get("static_busbw_GBps")
                    or static_bw, pruned_from=alg)
                alg, tuned_bw = "static", static_bw
        ratio = round(tuned_bw / static_bw, 3) if static_bw else 0.0
        out.append({
            "collective": coll,
            "dtype": dt,
            "size_bucket": bucket,
            "count": count,
            "bytes": nbytes,
            "algorithm": alg,
            "static_busbw_GBps": static_bw,
            "tuned_busbw_GBps": tuned_bw,
            "ratio": ratio,
        })
        if log:
            log(f"  {coll:<14} {bucket:>9} {alg:>12}: static "
                f"{static_bw:8.3f} tuned {tuned_bw:8.3f} GB/s "
                f"({ratio}x)")
    apply_algorithm(world, "static")
    if own_hier and hier is not None:
        for h in hier:
            h.close()
    return out


# ---------------------------------------------------------------------------
# single-cell measurement (the online tuner's unit of work)
# ---------------------------------------------------------------------------

def run_cell_lane(world, alg: str, coll: str, count: int, dtype,
                  root: int = 0, hier: Optional[list] = None) -> float:
    """One timed rep of one lane on one cell: the one lane dispatch that
    ``tune``, ``compare`` and the online tuner all measure through."""
    if alg == "hierarchical":
        apply_algorithm(world, "static")
        return _run_once_hier(world, hier, coll, count, dtype, root)
    if alg in COMPRESSION_ALGS:
        apply_algorithm(world, "static")
        return _sweep._run_once(world, coll, count, dtype, root,
                                compress=_compress_dtype_of(alg))
    if alg == "fused":
        apply_algorithm(world, "static")
        return _sweep._run_once(world, coll, count, dtype, root,
                                fused=True)
    apply_algorithm(world, alg)
    return _sweep._run_once(world, coll, count, dtype, root)


def cell_candidates(world, coll: str, count: int,
                    dtype_name: str = "float32", *,
                    repetitions: int = 2, root: int = 0,
                    hier: Optional[list] = None,
                    exclude: tuple = ()) -> list:
    """Quick best-of sweep of every covering lane on ONE cell — the
    online tuner's challenger shortlist (a targeted hypothesis, never
    a full sweep).  Returns ``[(algorithm, busbw_GBps)]`` fastest
    first; registers are restored to static."""
    P = world.nranks
    dtype = _sweep._resolve_dtype(dtype_name)
    nbytes = count * _sweep._payload_factor(coll, P) * dtype.itemsize
    bwf = _sweep._busbw_factor(coll, P)
    static_regs = world.accls[0].static_tuning()
    backend = backend_of(world)
    out = []
    try:
        for alg in algorithms_for(world, dtype_name):
            if alg in exclude:
                continue
            if alg == "hierarchical" and hier is None:
                continue
            if not lane_covers(backend, alg, coll, nranks=P,
                               nbytes=nbytes, static_regs=static_regs):
                continue
            run_cell_lane(world, alg, coll, count, dtype, root, hier)
            dur = min(run_cell_lane(world, alg, coll, count, dtype,
                                    root, hier)
                      for _ in range(repetitions))
            bw = round(nbytes / dur / 1e9 * bwf, 4) if dur > 0 else 0.0
            out.append((alg, bw))
    finally:
        apply_algorithm(world, "static")
    return sorted(out, key=lambda t: -t[1])


def ab_cell(world, incumbent: str, challenger: str, coll: str,
            count: int, dtype_name: str = "float32", *,
            repetitions: int = 3, retries: int = 2, root: int = 0,
            hier: Optional[list] = None) -> tuple:
    """The interleaved best-of A/B on ONE cell: warm both lanes,
    interleave rep pairs in the same session so box drift hits both
    alike, symmetric best-of across retry rounds (retrying cannot bias
    the ratio toward either side).  Returns ``(incumbent_busbw,
    challenger_busbw)`` in GB/s; registers end restored to static."""
    P = world.nranks
    dtype = _sweep._resolve_dtype(dtype_name)
    nbytes = count * _sweep._payload_factor(coll, P) * dtype.itemsize
    bwf = _sweep._busbw_factor(coll, P)

    def to_bw(dur):
        return round(nbytes / dur / 1e9 * bwf, 4) if dur > 0 else 0.0

    def pair():
        run_cell_lane(world, incumbent, coll, count, dtype, root, hier)
        run_cell_lane(world, challenger, coll, count, dtype, root, hier)
        di, dc = [], []
        for _ in range(repetitions):
            di.append(run_cell_lane(world, incumbent, coll, count,
                                    dtype, root, hier))
            dc.append(run_cell_lane(world, challenger, coll, count,
                                    dtype, root, hier))
        return to_bw(min(di)), to_bw(min(dc))

    try:
        inc_bw, ch_bw = pair()
        attempts = retries
        while ch_bw <= inc_bw and attempts > 0:
            attempts -= 1
            i2, c2 = pair()
            inc_bw = max(inc_bw, i2)
            ch_bw = max(ch_bw, c2)
    finally:
        apply_algorithm(world, "static")
    return inc_bw, ch_bw


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the driver-facing policy
# ---------------------------------------------------------------------------

class SelectionPolicy:
    """Serves a loaded table to one driver: threshold derivation at
    install, a memoized per-descriptor consult on the hot path."""

    _MISS = object()

    def __init__(self, table: SelectionTable):
        self.table = table
        self._memo: dict = {}

    def algorithm_for(self, coll: str, dtype: str, nbytes: int,
                      nranks: int) -> Optional[str]:
        entry = self.table.lookup(coll, dtype, nbytes, nranks)
        return entry["algorithm"] if entry else None

    def _cells(self, coll: str, nranks: int) -> list:
        out = []
        for key, e in self.table.entries.items():
            c, _dt, _b, n = key.split("|")
            if c == coll and int(n) == nranks:
                out.append(e)
        return out

    def install(self, accl) -> None:
        """Program the learned crossovers over the static registers —
        ``Engine::set_tuning`` (emu flat/tree) and the card's ring
        threshold become the backend of the measured policy.  Cells
        the registers cannot express (``hierarchical``) are served by
        the composer entry points and only recorded here; cells won by
        a compress_* lane arm the driver's CompressionPolicy (the wire
        dtype with the most winning cells, thresholded at the smallest
        winning payload, scoped to the winning collectives).  An
        explicit ACCL_COMPRESS env knob overrides this (the driver
        arms it after the table install)."""
        self._install_compression(accl)
        nranks = accl.size
        if backend_of(accl) == "cuda":
            # convert table payload bytes to the units the gang planner
            # compares (in_len * itemsize): table bytes carry the
            # nccl-tests payload factor — P for allgather (whose ring
            # decision sees the PER-RANK operand), 1-equivalent for
            # allreduce/reduce_scatter (factor 1 / in_len already x P)
            ring_bytes = []
            for coll, div in (("allreduce", 1), ("reduce_scatter", 1),
                              ("allgather", nranks)):
                ring_bytes += [e["bytes"] // div
                               for e in self._cells(coll, nranks)
                               if e["algorithm"] == "ring"]
            if ring_bytes:
                accl.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES),
                                int(min(ring_bytes)))
            return
        regs = {
            "reduce": (TuningKey.REDUCE_FLAT_TREE_MAX_RANKS,
                       TuningKey.REDUCE_FLAT_TREE_MAX_COUNT),
            "gather": (None, TuningKey.GATHER_FLAT_TREE_MAX_COUNT),
            "bcast": (TuningKey.BCAST_FLAT_TREE_MAX_RANKS, None),
        }
        for coll, (ranks_key, count_key) in regs.items():
            cells = self._cells(coll, nranks)
            flat = [e["bytes"] for e in cells
                    if e["algorithm"] == "flat"]
            tree = [e["bytes"] for e in cells
                    if e["algorithm"] == "tree"]
            if not flat and not tree:
                continue  # static/hierarchical everywhere: regs stand
            if count_key is not None:
                # flat at or below the largest flat-winning payload,
                # tree above it; the ranks register defers to the
                # size crossover
                accl.set_tuning(int(count_key),
                                int(max(flat)) if flat else 0)
                if ranks_key is not None:
                    accl.set_tuning(int(ranks_key),
                                    _HUGE if (flat and not tree) else 0)
            elif ranks_key is not None:
                # no size register (bcast): majority vote
                accl.set_tuning(int(ranks_key),
                                _HUGE if len(flat) >= len(tree) else 0)

    def _install_compression(self, accl) -> None:
        from ..arithconfig import CompressionPolicy
        from ..constants import Operation

        nranks = accl.size
        wins: dict = {}
        for key, e in self.table.entries.items():
            coll, dt, _b, n = key.split("|")
            if int(n) != nranks or e.get("algorithm") \
                    not in COMPRESSION_ALGS or dt != "float32":
                continue
            wins.setdefault(e["algorithm"], []).append((coll, e))
        if not wins:
            return
        alg = max(wins, key=lambda a: len(wins[a]))
        cells = wins[alg]
        # table bytes carry the nccl payload factor (P x for allgather
        # AND reduce_scatter/alltoall); the policy thresholds on the
        # DESCRIPTOR payload (count x elem size), so divide it back out
        accl.set_compression(CompressionPolicy(
            dtype=_compress_dtype_of(alg),
            min_bytes=int(min(
                e["bytes"] // _metrics.payload_factor(c, nranks)
                for c, e in cells)),
            collectives=frozenset(int(Operation[c]) for c, _e in cells),
        ))

    def on_call(self, accl, call) -> Optional[str]:
        """The ``_execute`` consult: one memoized dict probe per
        descriptor signature.  First sight of a signature resolves the
        table cell and publishes ``tuning/selected/<algorithm>``."""
        key = (call.scenario, call.arithcfg, call.count, call.comm)
        alg = self._memo.get(key, self._MISS)
        if alg is not self._MISS:
            return alg
        try:
            # the driver's one descriptor-signature derivation — the
            # table is trained on metrics keyed exactly this way
            op, nranks, _rank, dtype, nbytes = \
                accl.resolve_call_signature(call)
            alg = self.algorithm_for(op.name, dtype, nbytes, nranks)
        except (ACCLError, ValueError, KeyError):
            alg = None
        if alg and _metrics.enabled():
            _metrics.default_registry().inc(f"tuning/selected/{alg}")
        self._memo[key] = alg
        return alg

    def hot_swap(self, accl, key: str,
                 entry: Optional[dict]) -> Optional[dict]:
        """The online tuner's install primitive: replace (or drop,
        ``entry=None``) ONE table cell, clear the dispatch memo, and
        re-derive the backend registers from scratch.  Returns the
        previous entry — the caller's revert token.  Registers are
        rebuilt from the static values first because ``install`` only
        writes thresholds it has wins for: a revert that removes the
        last ring/flat win must fall back to static, not keep a stale
        tuned threshold."""
        prev = self.table.entries.get(key)
        if entry is None:
            self.table.entries.pop(key, None)
        else:
            self.table.entries[key] = dict(entry)
        self.table._dtypes = None
        self._memo.clear()
        accl.apply_static_tuning()
        had_compression = accl.compression_policy
        self.install(accl)
        if os.environ.get("ACCL_COMPRESS", "").strip():
            # the env knob outranks table-derived compression at
            # initialize; keep that precedence across an online swap
            accl.set_compression(had_compression)
        elif accl.compression_policy is had_compression and not any(
                e.get("algorithm") in COMPRESSION_ALGS
                for e in self.table.entries.values()):
            # _install_compression leaves an armed policy standing
            # when the swap removed the last compress win — disarm it
            accl.set_compression(None)
        return prev


def policy_from_env() -> Optional[SelectionPolicy]:
    """The initialize-time arm: ``ACCL_TUNE_TABLE`` names a table and
    ``ACCL_TUNE`` != 0.  Both unset -> None (static behavior,
    bit-for-bit); a named-but-unreadable/corrupt table raises the
    naming ACCLError instead of silently running static."""
    if os.environ.get(ENV_TUNE, "1") == "0":
        return None
    path = os.environ.get(ENV_TABLE, "")
    if not path:
        return None
    return SelectionPolicy(SelectionTable.load(path))

