"""perf_doctor: offline collective-performance observatory report.

Port of ``scripts/perf_doctor.py``, over the port's observability and
tuning modules.  One command turns dump files into the report a running
world exposes through /metrics + the sentinel:

- **critical-path attribution** (observability/attribution.py): merged
  flight dumps (+ optionally a Perfetto trace) -> per-collective phase
  breakdown (queue / gang-wait / dispatch / wire / reduce), per-rank
  clock skew, and straggler attribution naming the rank that arrives
  last, how often, by how much;
- **engine telemetry**: the ``engine/*`` counter/gauge families from a
  metrics snapshot (``ACCL.metrics()`` JSON), rendered next to the
  wire/membership counters;
- **regression sentinel** (observability/sentinel.py): the snapshot's
  latency histograms + bandwidth compared against committed baselines
  per (collective, dtype, size-bucket, lane) with the same thresholds
  as the live sentinel;
- **link matrix**: the ``link/*`` families of the snapshot reassembled
  into the world-level P×P per-link traffic matrix, rendered against
  the topology axes of the SAME Fabric the autotuner builds
  (accl_tpu_torch/tuning/topology.Fabric.for_world — ACCL_FABRIC /
  near-square default) with slowest-link and imbalance findings;
- **overlap accounting** (needs --trace + --flight): wire-exposed vs
  compute-overlapped time per collective;
- **retune history** (``--retunes``): the online tuner's audit ring
  (the ``/retunes`` exporter endpoint / retune_smoke artifact) rendered
  as finding -> hypothesis -> A/B -> decision chains, with a
  post-install cross-check against the sentinel section — an installed
  cell the sentinel still flags (and the tuner has not auto-reverted)
  is a finding;
- **per-tenant SLO report** (``--slo``): an ``accl-slo-report`` document
  (the ``/slo`` exporter body / slo_soak artifact) rendered as
  budget-remaining + fast/slow burn rates per tenant objective, with any
  embedded per-tenant link-matrix slices — a tenant whose verdict is
  not ``ok`` is a finding.

File-loaded sections go through ONE report-section registry
(:data:`SECTIONS`: loader -> schema validator -> renderer), so ``--ci``
schema validation covers every section uniformly.

``--ci`` is the perf-gate mode: the REPORT SCHEMA is hard-validated (a
malformed dump or snapshot fails the job) but threshold findings are
advisory — shared CI cores swing 3x, so drift there is a warning in the
artifact, not a red build.  ``--fail-on-findings`` makes drift fatal
for local/dedicated-box use.

Usage:
  python -m accl_tpu_torch.scripts.perf_doctor --metrics metrics.json \\
      --flight flight_dump.json [--trace trace.json] \\
      --baseline baseline.json [--retunes retune_history.json] \\
      [--slo slo_report.json] [--out report.json] \\
      [--ci | --fail-on-findings]
"""
import argparse
import json
import re
import sys

from ..observability import attribution, telemetry
from ..observability import slo as _slo
from ..observability.flight import merge_flight_dumps
from ..observability.sentinel import Baseline, Sentinel
from ..tuning import online as _online
from ..tuning.topology import Fabric
from ..utils.topology import link_axis as _ring_link_axis


_FABRIC_CACHE: dict = {}


def _world_fabric(P: int):
    """(fabric_or_None, link_axis_fn) for a P-rank snapshot — the
    SAME Fabric the tuner builds, but a snapshot must still render
    when this analyst's ACCL_FABRIC does not fit the snapshot's world:
    fall back to the ring labels rather than aborting the whole
    report.  Memoized per P so the findings and
    the rendering always label a link identically (and the fallback
    note prints once)."""
    if P in _FABRIC_CACHE:
        return _FABRIC_CACHE[P]
    try:
        fab = Fabric.for_world(P)
        out = (fab, fab.link_axis)
    except Exception as e:  # noqa: BLE001 — a report must still render
        print(f"note: no fabric for a {P}-rank snapshot ({e}); "
              f"falling back to ring link labels", file=sys.stderr)
        out = (None, (lambda s, d: _ring_link_axis(s, d, nranks=P)))
    _FABRIC_CACHE[P] = out
    return out

SNAPSHOT_KEYS = ("counters", "gauges", "calls")

#: link/<field>/r<src>->r<dst> — the per-cell counter names the
#: telemetry sampler publishes (observability/telemetry.py)
_LINK_CELL = re.compile(r"^link/([a-z_]+)/r(\d+)->r(\d+)$")

#: imbalance past this max/mean ratio over nonzero tx_bytes cells is
#: flagged (shared CI cores swing schedules, so stay conservative)
IMBALANCE_RATIO = 4.0


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        snap = json.load(f)
    missing = [k for k in SNAPSHOT_KEYS if k not in snap]
    if missing:
        raise ValueError(
            f"{path} is not a metrics snapshot (missing {missing}; want "
            f"ACCL.dump_metrics(as_json=True) / metrics_smoke.json)")
    return snap


def engine_section(snap: dict) -> dict:
    """The engine/* + wire/* + membership counter families."""
    out = {"counters": {}, "gauges": {}}
    for k, v in sorted(snap.get("counters", {}).items()):
        if k.startswith(("engine/", "wire/", "membership/", "watchdog/",
                         "plans/", "recovery/", "sentinel/")):
            out["counters"][k] = v
    for k, v in sorted(snap.get("gauges", {}).items()):
        if k.startswith("engine/") or k == "accl_health":
            out["gauges"][k] = v
    return out


def link_matrix_section(snap: dict) -> dict:
    """Reassemble the snapshot's ``link/*`` cell counters into the
    world-level matrix document + findings.  Empty dict when the
    snapshot carries no link families (a world without a sampler, or the sampler
    never ran)."""
    cells: dict = {}
    nranks = 0
    for name, v in snap.get("counters", {}).items():
        m = _LINK_CELL.match(name)
        if not m:
            continue
        field, s, d = m.group(1), int(m.group(2)), int(m.group(3))
        cells[(field, s, d)] = int(v)
        nranks = max(nranks, s + 1, d + 1)
    if not cells:
        return {}
    fields = {f: [[0] * nranks for _ in range(nranks)]
              for f in telemetry.LINK_COUNTER_FIELDS}
    for (field, s, d), v in cells.items():
        if field in fields:
            fields[field][s][d] = v
    matrix = {"nranks": nranks, "comm": 0, "fields": fields}
    return {"matrix": matrix, "findings": link_findings(matrix)}


def link_findings(matrix: dict) -> dict:
    """Slowest-link + imbalance findings over one link_matrix doc —
    the shape the topology autotuner (accl_tpu_torch/tuning) consumes.
    Axis names come from the SAME Fabric the tuner builds
    (Fabric.for_world honors ACCL_FABRIC / device coords), so the
    report and the tuner can never disagree about which axis a link
    belongs to."""
    P = matrix["nranks"]
    _, link_axis = _world_fabric(P)
    out: dict = {}
    slow = telemetry.slowest_link(matrix, "seek_wait_ns")
    if slow is not None:
        s, d = slow
        out["slowest_link"] = {
            "observer": s, "peer": d,
            "axis": link_axis(s, d),
            "seek_wait_ms": round(
                matrix["fields"]["seek_wait_ns"][s][d] / 1e6, 3)}
    busiest = telemetry.slowest_link(matrix, "tx_bytes")
    if busiest is not None:
        s, d = busiest
        out["busiest_link"] = {
            "src": s, "dst": d, "axis": link_axis(s, d),
            "tx_bytes": matrix["fields"]["tx_bytes"][s][d]}
    ratio = telemetry.link_imbalance(matrix, "tx_bytes")
    out["tx_imbalance_ratio"] = round(ratio, 2)
    out["imbalanced"] = ratio > IMBALANCE_RATIO
    retrans = telemetry.slowest_link(matrix, "retrans_sent")
    if retrans is not None:
        s, d = retrans
        total = sum(v for row in matrix["fields"]["retrans_sent"]
                    for v in row)
        out["lossiest_link"] = {
            "src": s, "dst": d, "axis": link_axis(s, d),
            "retransmits": matrix["fields"]["retrans_sent"][s][d],
            "share": round(
                matrix["fields"]["retrans_sent"][s][d] / total, 3)
            if total else 0.0}
    return out


def validate_link_section(section: dict) -> list:
    """--ci schema gate for the link_matrix report section: square
    matrices over every counter field, integer cells."""
    errors = []
    matrix = section.get("matrix", {})
    P = matrix.get("nranks", 0)
    fields = matrix.get("fields", {})
    for f in telemetry.LINK_COUNTER_FIELDS:
        cells = fields.get(f)
        if cells is None:
            errors.append(f"link_matrix: missing field {f}")
            continue
        if len(cells) != P or any(len(row) != P for row in cells):
            errors.append(f"link_matrix: field {f} is not {P}x{P}")
        elif any(not isinstance(v, int) or v < 0
                 for row in cells for v in row):
            errors.append(f"link_matrix: field {f} has non-counter "
                          f"cells")
    if "findings" not in section:
        errors.append("link_matrix: missing findings")
    return errors


def render_link_matrix(section: dict, out) -> None:
    matrix = section["matrix"]
    P = matrix["nranks"]
    fabric, axis_fn = _world_fabric(P)
    f = section["findings"]
    spec = f", fabric {fabric.spec()}" if fabric is not None else ""
    scope = (f"tenant {matrix['tenant']}" if matrix.get("tenant")
             else f"comm {matrix.get('comm') or 0}")
    out.write(f"\nlink matrix ({P}x{P}, {scope}{spec}):\n")
    tx = matrix["fields"]["tx_bytes"]
    wait = matrix["fields"]["seek_wait_ns"]
    for s in range(P):
        for d in range(P):
            if tx[s][d] == 0 and wait[s][d] == 0:
                continue
            axis = axis_fn(s, d)
            out.write(
                f"  r{s}->r{d} [{axis:>7}] tx {tx[s][d]:>12} B  "
                f"wait {wait[s][d] / 1e6:9.3f} ms  "
                f"retrans {matrix['fields']['retrans_sent'][s][d]}  "
                f"nacks {matrix['fields']['nacks_tx'][s][d]}\n")
    if "slowest_link" in f:
        sl = f["slowest_link"]
        out.write(f"  SLOWEST link: r{sl['observer']} blocked on "
                  f"r{sl['peer']} [{sl['axis']}] for "
                  f"{sl['seek_wait_ms']:.3f} ms\n")
    out.write(f"  tx imbalance max/mean: {f['tx_imbalance_ratio']}x"
              f"{'  (IMBALANCED)' if f['imbalanced'] else ''}\n")


def load_retunes(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) \
            or doc.get("format") != _online.HISTORY_FORMAT:
        raise ValueError(
            f"{path} is not a retune history (format="
            f"{doc.get('format') if isinstance(doc, dict) else doc!r}; "
            f"want {_online.HISTORY_FORMAT!r} — the exporter's /retunes "
            f"body or retune_smoke's artifact)")
    return doc


def validate_retune_section(doc: dict) -> list:
    """--ci schema gate for the retune-history section: versioned
    format, every episode a closed decision chain."""
    errors = []
    if doc.get("version") != _online.HISTORY_VERSION:
        errors.append(f"retunes: unsupported history version "
                      f"{doc.get('version')!r}")
    episodes = doc.get("episodes")
    if not isinstance(episodes, list):
        errors.append("retunes: 'episodes' is not a list")
        return errors
    for ep in episodes:
        seq = ep.get("seq") if isinstance(ep, dict) else None
        tag = f"retunes: episode {seq!r}"
        if not isinstance(ep, dict) or not isinstance(seq, int):
            errors.append(f"{tag}: not a sequenced episode dict")
            continue
        if ep.get("kind") not in ("cell", "axis"):
            errors.append(f"{tag}: kind {ep.get('kind')!r}")
        if ep.get("decision") not in _online.DECISIONS:
            errors.append(f"{tag}: decision {ep.get('decision')!r} not "
                          f"in {_online.DECISIONS}")
        trigger = ep.get("trigger")
        if not isinstance(trigger, dict) or "type" not in trigger:
            errors.append(f"{tag}: trigger is not a typed dict")
        if not isinstance(ep.get("opened_at"), (int, float)) \
                or not isinstance(ep.get("closed_at"), (int, float)):
            errors.append(f"{tag}: missing opened_at/closed_at stamps")
        if ep.get("kind") == "cell" \
                and ep.get("decision") in ("installed", "rejected",
                                           "reverted") \
                and not isinstance(ep.get("cell"), str):
            errors.append(f"{tag}: cell decision without a cell key")
    return errors


def retune_cross_check(doc: dict, sentinel_findings: list) -> list:
    """Installed cells the sentinel STILL flags: the tuner's own
    post-install watch auto-reverts these when it sees the finding, so
    one surviving in a report means the regression outlived the loop
    (or the loop is stopped) — surface it as a finding."""
    reverted = {ep.get("installed_episode")
                for ep in doc.get("episodes", [])
                if ep.get("decision") == "reverted"}
    live_installs = {}
    for ep in doc.get("episodes", []):
        if ep.get("decision") == "installed" \
                and ep.get("kind") == "cell" \
                and ep.get("seq") not in reverted:
            live_installs[ep["cell"]] = ep
    out = []
    for f in sentinel_findings:
        key = "|".join(str(f.get(k, "")) for k in
                       ("collective", "dtype", "size_bucket"))
        for cell, ep in live_installs.items():
            if cell.startswith(key + "|"):
                out.append({
                    "cell": cell, "episode": ep["seq"],
                    "installed":
                        (ep.get("installed") or {}).get("algorithm"),
                    "sentinel_ratio": f.get("ratio"),
                })
    return out


def render_retunes(doc: dict, cross: list, out) -> None:
    episodes = doc.get("episodes", [])
    out.write(f"\nretune history (r19): {len(episodes)} episode(s) "
              f"kept of {doc.get('total', len(episodes))} "
              f"({doc.get('dropped', 0)} dropped from the ring)\n")
    for ep in episodes:
        trig = ep.get("trigger", {})
        if ep.get("kind") == "axis":
            hyp = ep.get("hypothesis", {})
            chain = (f"link_matrix re-score -> axis_order "
                     f"{hyp.get('axis_order_from')} -> "
                     f"{hyp.get('axis_order_to')}")
        else:
            parts = [f"sentinel {trig.get('kind', 'drift')} "
                     f"{trig.get('ratio')}x on {ep.get('cell')}"]
            hyp = ep.get("hypothesis")
            if hyp:
                parts.append(f"challenger {hyp.get('challenger')} vs "
                             f"{hyp.get('incumbent')}")
            ab = ep.get("ab")
            if ab:
                parts.append(f"A/B {ab.get('ratio')}x")
            chain = " -> ".join(parts)
        out.write(f"  #{ep.get('seq'):<3} [{ep.get('kind')}] {chain} "
                  f"-> {str(ep.get('decision', '?')).upper()}"
                  f"{': ' + ep['reason'] if ep.get('reason') else ''}\n")
    for c in cross:
        out.write(f"  CROSS-CHECK: installed cell {c['cell']} "
                  f"(episode #{c['episode']}, {c['installed']}) is "
                  f"still flagged by the sentinel at "
                  f"{c['sentinel_ratio']}x and has NOT been "
                  f"auto-reverted\n")


def _retunes_section(doc: dict, report: dict, out) -> int:
    cross = retune_cross_check(
        doc, report.get("sentinel", {}).get("findings", []))
    report["retunes"] = {"history": doc, "cross_check": cross}
    render_retunes(doc, cross, out)
    return len(cross)


def load_slo(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) \
            or doc.get("format") != _slo.SLO_REPORT_FORMAT:
        raise ValueError(
            f"{path} is not an SLO report (format="
            f"{doc.get('format') if isinstance(doc, dict) else doc!r}; "
            f"want {_slo.SLO_REPORT_FORMAT!r} — the exporter's /slo "
            f"body or slo_soak's artifact)")
    return doc


def validate_slo_section(doc: dict) -> list:
    """--ci schema gate for the SLO report: versioned format, every
    objective row complete with a known verdict and a sane budget,
    every embedded per-tenant link-matrix slice square."""
    errors = []
    if doc.get("version") != _slo.SLO_REPORT_VERSION:
        errors.append(f"slo: unsupported report version "
                      f"{doc.get('version')!r}")
    tenants = doc.get("tenants")
    if not isinstance(tenants, dict):
        errors.append("slo: 'tenants' is not a dict")
        return errors
    for tenant, t in tenants.items():
        tag = f"slo: tenant {tenant!r}"
        if not isinstance(t, dict):
            errors.append(f"{tag}: not a dict")
            continue
        if t.get("verdict") not in _slo.VERDICT_NAMES:
            errors.append(f"{tag}: verdict {t.get('verdict')!r} not in "
                          f"{_slo.VERDICT_NAMES}")
        br = t.get("budget_remaining")
        if not isinstance(br, (int, float)) or not 0.0 <= br <= 1.0:
            errors.append(f"{tag}: budget_remaining {br!r} not in "
                          f"[0, 1]")
        rows = t.get("objectives")
        if not isinstance(rows, list):
            errors.append(f"{tag}: 'objectives' is not a list")
            continue
        for row in rows:
            missing = [k for k in _slo.OBJECTIVE_SCHEMA_KEYS
                       if k not in row]
            if missing:
                errors.append(f"{tag}: objective row missing {missing}")
                continue
            if row["verdict"] not in _slo.VERDICT_NAMES:
                errors.append(f"{tag}: objective {row['objective']} "
                              f"verdict {row['verdict']!r}")
    for tenant, m in (doc.get("link_matrices") or {}).items():
        errors.extend(
            f"slo[{tenant}]: {e}" for e in
            validate_link_section({"matrix": m, "findings": {}}))
    return errors


def render_slo(doc: dict, out) -> int:
    """Render the per-tenant report; returns the finding count (one
    per not-ok tenant, plus imbalanced tenant link slices)."""
    findings = 0
    tenants = doc.get("tenants", {})
    out.write(f"\nSLO report (r20): {len(doc.get('specs', []))} "
              f"spec(s), {len(tenants)} tenant(s), "
              f"{doc.get('checks', 0)} check sweep(s), windows "
              f"fast={doc.get('fast_window')}/"
              f"slow={doc.get('slow_window')} sweeps\n")
    for tenant in sorted(tenants):
        t = tenants[tenant]
        verdict = t.get("verdict", "?")
        if verdict != "ok":
            findings += 1
        out.write(f"  tenant {tenant}: {str(verdict).upper()}  "
                  f"budget remaining "
                  f"{t.get('budget_remaining', 1.0) * 100:.1f}%\n")
        for row in t.get("objectives", []):
            budget = (f"budget {row['budget_remaining'] * 100:.1f}%"
                      if row.get("budget_remaining") is not None
                      else "no budget (floor)")
            out.write(
                f"    {row['collective']}/{row['size_bucket']} "
                f"{row['objective']:<12} target {row['target']:<10} "
                f"burn fast {row['burn_fast']:>7.2f} / slow "
                f"{row['burn_slow']:>7.2f}  {budget}  "
                f"-> {row['verdict']}\n")
    for tenant in sorted(doc.get("link_matrices", {}) or {}):
        matrix = doc["link_matrices"][tenant]
        section = {"matrix": matrix, "findings": link_findings(matrix)}
        render_link_matrix(section, out)
        if section["findings"].get("imbalanced"):
            findings += 1
    return findings


def _slo_section(doc: dict, report: dict, out) -> int:
    report["slo"] = doc
    return render_slo(doc, out)


#: the report-section registry: every file-loaded
#: section declares loader -> --ci schema validator -> renderer in one
#: place, so schema validation is uniform across sections by
#: construction.  The renderer returns the section's finding count;
#: validators for sections assembled in-process (link_matrix) are
#: registered too so main() resolves EVERY validator through here.
SECTIONS = {
    "retunes": {"load": load_retunes, "validate": validate_retune_section,
                "render": _retunes_section},
    "slo": {"load": load_slo, "validate": validate_slo_section,
            "render": _slo_section},
    "link_matrix": {"load": None, "validate": validate_link_section,
                    "render": None},
}


def run_section(name: str, path: str, report: dict,
                schema_errors: list, out) -> int:
    """Load + validate + render one registered file-backed section;
    loader/validator failures become schema errors (fatal under --ci),
    never tracebacks."""
    sec = SECTIONS[name]
    try:
        doc = sec["load"](path)
        schema_errors.extend(sec["validate"](doc))
        return sec["render"](doc, report, out)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        schema_errors.append(f"{name}: {type(e).__name__}: {e}")
        return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics", default="",
                    help="metrics snapshot JSON (dump_metrics as_json)")
    ap.add_argument("--flight", nargs="*", default=[],
                    help="flight dump file(s): per-rank, merged, or a "
                         "watchdog dump (torn crash dumps are salvaged)")
    ap.add_argument("--trace", default="",
                    help="Perfetto trace JSON to refine the wire/reduce "
                         "split from device windows")
    ap.add_argument("--baseline", action="append", default=[],
                    help="committed baseline (sentinel JSON, callrate "
                         "record, registry snapshot, or sweep CSV); "
                         "repeatable — later files fill gaps")
    ap.add_argument("--retunes", default="",
                    help="retune-history JSON (the exporter's /retunes "
                         "body / retune_smoke artifact) — rendered as "
                         "decision chains + sentinel cross-check")
    ap.add_argument("--slo", default="",
                    help="SLO report JSON (the exporter's /slo body / "
                         "slo_soak artifact) — rendered as per-tenant "
                         "budget-remaining + burn rates, with embedded "
                         "per-tenant link-matrix slices")
    ap.add_argument("--out", default="",
                    help="write the full JSON report here (CI artifact)")
    ap.add_argument("--ci", action="store_true",
                    help="perf-gate mode: schema failures are fatal, "
                         "threshold findings advisory")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 on any straggler dominance or sentinel "
                         "drift finding (dedicated-box mode)")
    ap.add_argument("--timeline", action="store_true",
                    help="include the per-gang timeline in the report")
    args = ap.parse_args()
    if not args.metrics and not args.flight and not args.retunes \
            and not args.slo:
        ap.error("pass --metrics, --flight, --retunes and/or --slo "
                 "input files")

    report: dict = {"version": 1}
    schema_errors: list = []
    findings = 0

    # -- attribution over flight dumps ---------------------------------
    if args.flight:
        try:
            merged = merge_flight_dumps(list(args.flight))
            trace_doc = None
            if args.trace:
                with open(args.trace) as f:
                    trace_doc = json.load(f)
            attr = attribution.attribute(merged, trace_doc=trace_doc,
                                         timeline=args.timeline)
            report["attribution"] = attr
            attribution.render(attr, sys.stdout)
            # overlap accounting: wire-exposed vs compute-
            # overlapped per collective (device windows from --trace)
            ovl = attribution.overlap(merged, trace_doc=trace_doc)
            report["overlap"] = ovl
            print(f"\noverlap accounting ({ovl['compute_windows']} "
                  f"compute window(s)):")
            for key, c in sorted(ovl["collectives"].items()):
                print(f"  {key}: wire {c['wire_us']:.1f}us, exposed "
                      f"{c['exposed_us']:.1f}us "
                      f"({c['exposed_fraction'] * 100:.1f}% of span), "
                      f"recovered-compute "
                      f"{c['recovered_compute_fraction'] * 100:.1f}%")
            # device overlap: the stamp-clock timeline's own
            # xfer-vs-reduce accounting — the recovered-MXU fraction
            # the fused lanes exist to raise (1.0 recovered = every
            # wire hop hidden under the matmul accumulator)
            if trace_doc is not None:
                dev = attribution.device_overlap(trace_doc)
                report["device_overlap"] = dev
                if dev["collectives"]:
                    print(f"\ndevice overlap (r18, "
                          f"{dev['tracks']} stamp track(s)):")
                    for coll, c in sorted(dev["collectives"].items()):
                        print(f"  {coll}: xfer {c['xfer_us']:.1f}us "
                              f"over {c['ranks']} rank(s), exposed "
                              f"{c['exposed_fraction'] * 100:.1f}%, "
                              f"recovered-MXU "
                              f"{c['recovered_mxu_fraction'] * 100:.1f}%")
            for c in attr["collectives"].values():
                d = c["dominant_straggler"]
                if d is not None and d["share"] >= 0.5:
                    findings += 1
            torn = merged["analysis"].get("torn_dumps", [])
            if torn:
                print(f"note: {len(torn)} torn dump file(s) salvaged "
                      f"(crash-time truncation) — "
                      f"{[t['path'] for t in torn]}")
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            schema_errors.append(f"flight/attribution: "
                                 f"{type(e).__name__}: {e}")

    # -- engine telemetry + sentinel over the metrics snapshot ---------
    if args.metrics:
        try:
            snap = load_snapshot(args.metrics)
            report["engine_telemetry"] = engine_section(snap)
            print("\nengine telemetry:")
            for k, v in report["engine_telemetry"]["counters"].items():
                print(f"  {k:<40} {v}")
            for k, v in report["engine_telemetry"]["gauges"].items():
                print(f"  {k:<40} {v}")
            # link matrix: reassembled from the link/* families
            links = link_matrix_section(snap)
            if links:
                report["link_matrix"] = links
                schema_errors.extend(
                    SECTIONS["link_matrix"]["validate"](links))
                render_link_matrix(links, sys.stdout)
                # the recovered-MXU fraction belongs next to the
                # link traffic it hides — how much of those bytes'
                # wire time the device timeline shows covered by MXU
                dev = report.get("device_overlap", {}).get(
                    "collectives", {})
                if dev:
                    mean_rec = sum(c["recovered_mxu_fraction"]
                                   for c in dev.values()) / len(dev)
                    print(f"  recovered-MXU (device stamp clock): "
                          f"mean {mean_rec * 100:.1f}% over "
                          f"{len(dev)} collective(s)")
                if links["findings"].get("imbalanced"):
                    findings += 1
            if args.baseline:
                base = None
                for path in args.baseline:
                    b = Baseline.load(path)
                    base = b if base is None else base.merge(b)
                sen = Sentinel(base)
                drift = sen.compare_snapshot(snap)
                report["sentinel"] = {
                    "baselines": args.baseline,
                    "thresholds": {"p50_ratio": sen.p50_ratio,
                                   "p99_ratio": sen.p99_ratio,
                                   "bw_ratio": sen.bw_ratio,
                                   "min_calls": sen.min_calls},
                    "findings": drift,
                }
                findings += len(drift)
                print(f"\nregression sentinel: {len(drift)} drift "
                      f"finding(s) vs {len(base.entries)} baseline "
                      f"entr(ies)")
                for f in drift:
                    print(f"  {f['collective']} {f['dtype']} "
                          f"{f['size_bucket']} {f['axis']}: live "
                          f"{f['live']} vs baseline {f['baseline']} "
                          f"({f['ratio']}x, threshold "
                          f"{f['threshold']}x)")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            schema_errors.append(f"metrics/sentinel: "
                                 f"{type(e).__name__}: {e}")

    # -- registry-driven file sections: retunes, slo -------
    for name, path in (("retunes", args.retunes), ("slo", args.slo)):
        if path:
            findings += run_section(name, path, report, schema_errors,
                                    sys.stdout)

    report["schema_errors"] = schema_errors
    report["findings_total"] = findings
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"\nreport written to {args.out}")

    if schema_errors:
        for e in schema_errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        return 2  # malformed inputs fail even (especially) in --ci
    if args.fail_on_findings and findings:
        return 1
    if args.ci and findings:
        print(f"\n--ci: {findings} finding(s) are ADVISORY on shared "
              f"cores (see the report artifact)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
