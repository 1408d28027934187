"""Cross-rank critical-path attribution over merged observability dumps.

Port of ``accl_tpu/observability/attribution.py``, whole.  The trace
spans and flight records say what happened; this module answers which
rank made a collective slow, and where the time went: queued on the
host, waiting for the gang to assemble, dispatching, or on the
wire/reduce path.

Method
------
1. **Gang pairing** — per communicator, rank R's Nth *completed* gang
   record with signature (collective, tag, count, dtype) belongs to the
   same gang instance as every other rank's Nth record with that
   signature: the FIFO-per-key discipline the engine's own gang
   assembly implements (and trace.TraceCollector.gang_id_for mirrors).
2. **Clock-skew estimation** — per-rank timestamps are monotonic and
   *rank-local* (distinct processes = distinct clocks).  Every member
   of a gang instance shares a synchronization point: the instance's
   completion, so per-rank offsets are estimated as the MEDIAN over
   shared gang instances of (rank's completion − reference rank's
   completion) and subtracted before any cross-rank comparison.
   In-process worlds share one clock and the estimate collapses to the
   (small) completion-publication jitter; attribution subtracts it
   anyway so the same code serves merged multi-process dumps.
3. **Phase decomposition** — consecutive intervals partitioning each
   record's submit→complete span (they sum to the span by
   construction): ``queue`` (submit→queue: descriptor staging + request
   queue), ``gang_wait`` (own arrival → the LAST member's skew-corrected
   arrival — zero for the straggler itself), ``dispatch`` (gang-ready →
   dispatch where the backend stamps it), and ``wire`` (everything
   after the gang assembled: transport + reduction).  When a Perfetto
   trace doc is supplied, the device window splits ``wire`` into
   ``wire`` (pre-device) and ``reduce`` (device-begin→device-end).
4. **Straggler attribution** — per gang instance the last-arriving
   rank, its lateness vs the first arrival, aggregated per
   (collective, comm, size-bucket): episode counts, share, mean/max
   lateness, and the dominant straggler when one rank owns the
   majority of episodes.

Inputs are merged flight docs (:func:`flight.merge_flight_dumps`
output), per-rank dump dicts/paths, or anything ``merge_flight_dumps``
accepts, including crash-truncated dumps.
"""
from __future__ import annotations

from typing import Optional

from .metrics import size_bucket

#: arrival must trail the first rank by at least this to count as a
#: straggler episode (below it, arrival order is scheduler noise)
DEFAULT_LATE_FLOOR_US = 5.0

#: phases, in span order (reduce only materializes with a trace doc)
PHASES = ("queue", "gang_wait", "dispatch", "wire", "reduce")


def _median(vals: list) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _ensure_merged(dumps) -> dict:
    """Accept a merged doc, one dump dict, or an iterable of dump
    dicts/paths; always return the merged+analyzed document."""
    from .flight import merge_flight_dumps

    if isinstance(dumps, dict):
        if "ranks" in dumps:
            return dumps
        return merge_flight_dumps([dumps])
    return merge_flight_dumps(list(dumps))


def _gang_instances(doc: dict) -> dict:
    """(comm, collective, tag, count, dtype, occurrence) -> {rank: rec}
    over COMPLETED gang records, per the FIFO-per-key pairing."""
    instances: dict = {}
    for rd in doc["ranks"]:
        rank = rd["rank"]
        occurrence: dict = {}
        for rec in sorted(rd["records"], key=lambda x: x["seq"]):
            if not rec.get("gang") or rec["state"] != "complete":
                continue
            key = (rec["comm"], rec["collective"], rec["tag"],
                   rec["count"], rec["dtype"])
            n = occurrence.get(key, 0)
            occurrence[key] = n + 1
            instances.setdefault(key + (n,), {})[rank] = rec
    return instances


def estimate_clock_skew(instances: dict, ranks: list) -> dict:
    """Per-rank clock offset (ns, relative to the lowest rank present)
    from gang-rendezvous completion anchors: median over shared gang
    instances of (rank's t_complete − reference's t_complete).  Ranks
    sharing no gang with the reference keep offset 0 (nothing to align
    on — their comparisons are flagged by the caller via coverage)."""
    if not ranks:
        return {}
    ref = ranks[0]
    skew = {ref: 0.0}
    for r in ranks[1:]:
        deltas = [members[r]["t_complete"] - members[ref]["t_complete"]
                  for members in instances.values()
                  if r in members and ref in members
                  and members[r]["t_complete"]
                  and members[ref]["t_complete"]]
        skew[r] = _median(deltas)
    return skew


def _arrival_ns(rec: dict) -> Optional[int]:
    """A record's gang-arrival anchor: the queue stamp (descriptor
    entering the gang scheduler / engine), falling back to dispatch
    then submit for records whose earlier stamps predate bring-up."""
    for k in ("t_queue", "t_dispatch", "t_submit"):
        t = rec.get(k)
        if t:
            return int(t)
    return None


def _device_windows(trace_doc: Optional[dict]) -> dict:
    """(rank, collective, occurrence) -> (device_begin, device_end)
    from a Perfetto doc's lane slices (trace.TraceCollector schema)."""
    if not trace_doc:
        return {}
    # multiple tracks (call / queue / lane) carry the SAME span, so the
    # same device window repeats across consecutive events: collapse
    # identical repeats per (rank, collective) and number the distinct
    # windows — occurrence i is the i-th real device execution
    per: dict = {}
    for ev in trace_doc.get("traceEvents", []):
        args = ev.get("args") or {}
        ts = (args.get("timestamps_ns") or {})
        if ev.get("ph") != "X" or not ts.get("device_begin") \
                or not ts.get("device_end"):
            continue
        rank = ev.get("pid", -1)
        coll = ev.get("name", "").split(" ")[0]
        win = (ts["device_begin"], ts["device_end"])
        lst = per.setdefault((rank, coll), [])
        if win not in lst:
            lst.append(win)
    return {(r, c, i): w
            for (r, c), lst in per.items() for i, w in enumerate(lst)}


def attribute(dumps, trace_doc: Optional[dict] = None,
              late_floor_us: float = DEFAULT_LATE_FLOOR_US,
              timeline: bool = False) -> dict:
    """Full critical-path attribution report over merged dumps.

    Returns::

        {"nranks", "reference_rank", "clock_skew_ns": {rank: ns},
         "gangs_analyzed": N,
         "collectives": {"<coll>|comm<k>|<bucket>": {
             "collective", "comm", "size_bucket", "episodes",
             "span_us", "phases_us": {phase: mean}, "phase_coverage",
             "stragglers": {rank: {"episodes", "share",
                                   "mean_late_us", "max_late_us"}},
             "dominant_straggler": {...} | None}},
         "timeline": [...]}      # per-gang detail when timeline=True
    """
    doc = _ensure_merged(dumps)
    ranks = sorted(rd["rank"] for rd in doc["ranks"])
    instances = _gang_instances(doc)
    skew = estimate_clock_skew(instances, ranks)
    windows = _device_windows(trace_doc)
    win_seen: dict = {}

    groups: dict = {}
    gang_rows: list = []
    for key, members in sorted(instances.items()):
        comm, coll, tag, count, dtype, occ = key
        if len(members) < 2:
            continue  # single-rank view: no cross-rank attribution
        # skew-corrected arrivals -> last/first arrival of the instance
        arrivals = {}
        for r, rec in members.items():
            t = _arrival_ns(rec)
            if t is not None:
                arrivals[r] = t - skew.get(r, 0.0)
        if len(arrivals) < 2:
            continue
        first_t = min(arrivals.values())
        last_rank, last_t = max(arrivals.items(), key=lambda kv: kv[1])
        late_us = (last_t - first_t) / 1e3

        nbytes = max(rec.get("nbytes", 0) for rec in members.values())
        gkey = (coll, comm, size_bucket(nbytes))
        g = groups.setdefault(gkey, {
            "episodes": 0, "span_us": 0.0,
            "phases_us": dict.fromkeys(PHASES, 0.0),
            "phase_samples": 0,
            "late": {}, "late_total": 0})
        g["episodes"] += 1

        # per-rank phase decomposition: consecutive intervals over
        # submit→complete (clamped monotonic so they PARTITION the span)
        for r, rec in members.items():
            t_sub = rec.get("t_submit") or 0
            t_cmp = rec.get("t_complete") or 0
            if not t_sub or not t_cmp or t_cmp <= t_sub:
                continue
            own_arrival = arrivals.get(r)
            # the last arrival in this rank's clock domain
            last_local = (last_t + skew.get(r, 0.0)
                          if own_arrival is not None else None)
            cuts = [t_sub]

            def cut(t):
                cuts.append(min(max(int(t), cuts[-1]), t_cmp))

            cut(rec.get("t_queue") or t_sub)             # -> queue
            cut(last_local if last_local is not None      # -> gang_wait
                else (rec.get("t_gang_ready") or cuts[-1]))
            cut(max(rec.get("t_dispatch") or 0, cuts[-1]))  # -> dispatch
            wkey = (r, coll, win_seen.get((r, coll, "n"), 0))
            dev = windows.get(wkey)
            if dev:
                cut(dev[0])                               # -> wire
                cut(dev[1])                               # -> reduce
            else:
                cut(t_cmp)                                # wire = rest
                cut(t_cmp)                                # reduce = 0
            cuts.append(t_cmp)
            # intervals: queue, gang_wait, dispatch, wire, reduce, tail
            ivals = [cuts[i + 1] - cuts[i] for i in range(len(cuts) - 1)]
            # fold the post-device tail into wire (completion callback)
            phases = {
                "queue": ivals[0],
                "gang_wait": ivals[1],
                "dispatch": ivals[2],
                "wire": ivals[3] + ivals[5],
                "reduce": ivals[4],
            }
            span = t_cmp - t_sub
            g["span_us"] += span / 1e3
            g["phase_samples"] += 1
            for p, v in phases.items():
                g["phases_us"][p] += v / 1e3
        if windows:
            for r in members:
                win_seen[(r, coll, "n")] = \
                    win_seen.get((r, coll, "n"), 0) + 1

        # straggler episode
        if late_us >= late_floor_us:
            st = g["late"].setdefault(last_rank,
                                      {"episodes": 0, "total_us": 0.0,
                                       "max_us": 0.0})
            st["episodes"] += 1
            st["total_us"] += late_us
            st["max_us"] = max(st["max_us"], late_us)
            g["late_total"] += 1
        if timeline:
            gang_rows.append({
                "collective": coll, "comm": comm, "tag": tag,
                "count": count, "dtype": dtype, "occurrence": occ,
                "arrival_rel_us": {str(r): round((t - first_t) / 1e3, 2)
                                   for r, t in sorted(arrivals.items())},
                "last_rank": last_rank,
                "lateness_us": round(late_us, 2),
            })

    collectives: dict = {}
    for (coll, comm, bucket), g in sorted(groups.items()):
        n = max(g["phase_samples"], 1)
        span = g["span_us"] / n
        phases = {p: round(v / n, 2) for p, v in g["phases_us"].items()}
        stragglers = {}
        dominant = None
        for r, st in sorted(g["late"].items()):
            share = st["episodes"] / g["late_total"] if g["late_total"] \
                else 0.0
            row = {"episodes": st["episodes"], "share": round(share, 3),
                   "mean_late_us": round(st["total_us"] / st["episodes"],
                                         2),
                   "max_late_us": round(st["max_us"], 2)}
            stragglers[str(r)] = row
            if dominant is None or share > dominant["share"]:
                dominant = {"rank": r, **row}
        collectives[f"{coll}|comm{comm}|{bucket}"] = {
            "collective": coll, "comm": comm, "size_bucket": bucket,
            "episodes": g["episodes"],
            "span_us": round(span, 2),
            "phases_us": phases,
            # phases partition submit->complete by construction; the
            # ratio is the self-check the acceptance test pins (>=0.95)
            "phase_coverage": round(sum(phases.values()) / span, 4)
            if span > 0 else 1.0,
            "straggler_episodes": g["late_total"],
            "stragglers": stragglers,
            "dominant_straggler": dominant,
        }

    report = {
        "nranks": len(ranks),
        "reference_rank": ranks[0] if ranks else -1,
        "clock_skew_ns": {str(r): round(skew.get(r, 0.0), 1)
                          for r in ranks},
        "gangs_analyzed": sum(g["episodes"] for g in groups.values()),
        "collectives": collectives,
    }
    if timeline:
        report["timeline"] = gang_rows
    return report


def _compute_windows(trace_doc: Optional[dict]) -> dict:
    """rank -> sorted, MERGED [t0_ns, t1_ns) intervals of compute
    activity from a Perfetto doc: the ``device:*`` stamp-buffer
    COMPUTE slices (``device_phase`` = reduce — the xfer slices are
    the collective's own communication and must never count as cover
    it hides behind) plus host-marked ``window:*`` compute spans."""
    per: dict = {}
    if not trace_doc:
        return per
    for ev in trace_doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        is_device_compute = args.get("device_track") \
            and args.get("device_phase") != "xfer"
        if not (is_device_compute
                or str(ev.get("name", "")).startswith("window:")):
            continue
        t0 = ev.get("ts", 0) * 1e3
        t1 = t0 + ev.get("dur", 0) * 1e3
        if t1 > t0:
            per.setdefault(ev.get("pid", -1), []).append((t0, t1))
    # merge overlapping/adjacent intervals per rank: _overlap_ns sums
    # the wire interval's intersection with EACH window, so unmerged
    # overlap (a host window: span containing device stamp slices)
    # would double-count cover and let recovered_compute exceed 1.0
    for r, wins in per.items():
        wins.sort()
        merged = [wins[0]]
        for w0, w1 in wins[1:]:
            if w0 <= merged[-1][1]:
                if w1 > merged[-1][1]:
                    merged[-1] = (merged[-1][0], w1)
            else:
                merged.append((w0, w1))
        per[r] = merged
    return per


def _overlap_ns(t0: float, t1: float, windows: list) -> float:
    """Total intersection of [t0, t1) with a sorted interval list."""
    total = 0.0
    for w0, w1 in windows:
        if w0 >= t1:
            break
        lo, hi = max(t0, w0), min(t1, w1)
        if hi > lo:
            total += hi - lo
    return total


def overlap(dumps, trace_doc: Optional[dict] = None) -> dict:
    """Wire-exposed vs compute-overlapped time per collective — the
    overlap accountant (the recovered-compute fraction of a fused
    compute/communication lane).

    Per gang-instance member, the WIRE interval is everything after the
    gang assembled (dispatch → completion).  The part of it intersecting
    a compute window on the same rank (device stamp tracks, host
    ``window:`` spans) is *overlapped* — communication the rank hid
    behind compute; the rest is *exposed* — wall time the wire alone
    cost.  Fusion work shrinks ``exposed_fraction`` toward zero;
    ``recovered_compute_fraction`` is how much of the wire time compute
    already covers.

    Returns ``{"nranks", "compute_windows", "collectives": {key: {
    "wire_us", "overlapped_us", "exposed_us", "exposed_fraction",
    "recovered_compute_fraction", "episodes"}}}``."""
    doc = _ensure_merged(dumps)
    ranks = sorted(rd["rank"] for rd in doc["ranks"])
    instances = _gang_instances(doc)
    windows = _compute_windows(trace_doc)

    groups: dict = {}
    for key, members in sorted(instances.items()):
        comm, coll, tag, count, dtype, occ = key
        if len(members) < 2:
            continue
        nbytes = max(rec.get("nbytes", 0) for rec in members.values())
        gkey = f"{coll}|comm{comm}|{size_bucket(nbytes)}"
        g = groups.setdefault(gkey, {
            "collective": coll, "comm": comm,
            "size_bucket": size_bucket(nbytes), "episodes": 0,
            "wire_ns": 0.0, "overlapped_ns": 0.0, "span_ns": 0.0})
        g["episodes"] += 1
        for r, rec in members.items():
            t_sub = rec.get("t_submit") or 0
            t_cmp = rec.get("t_complete") or 0
            if not t_sub or not t_cmp or t_cmp <= t_sub:
                continue
            # wire = after the gang assembled: dispatch (or the best
            # earlier stamp) to completion — matches attribute()'s
            # wire+reduce tail
            t_wire = rec.get("t_dispatch") or rec.get("t_gang_ready") \
                or rec.get("t_queue") or t_sub
            t_wire = min(max(int(t_wire), t_sub), t_cmp)
            wire = t_cmp - t_wire
            g["span_ns"] += t_cmp - t_sub
            g["wire_ns"] += wire
            g["overlapped_ns"] += _overlap_ns(t_wire, t_cmp,
                                              windows.get(r, []))

    collectives: dict = {}
    for gkey, g in sorted(groups.items()):
        wire, ovl, span = g["wire_ns"], g["overlapped_ns"], g["span_ns"]
        exposed = max(wire - ovl, 0.0)
        collectives[gkey] = {
            "collective": g["collective"], "comm": g["comm"],
            "size_bucket": g["size_bucket"], "episodes": g["episodes"],
            "wire_us": round(wire / 1e3, 2),
            "overlapped_us": round(ovl / 1e3, 2),
            "exposed_us": round(exposed / 1e3, 2),
            # exposed wire as a fraction of total span: the wall-clock
            # share the wire alone cost (drops when a slow peer heals
            # OR when fusion hides the wire behind compute)
            "exposed_fraction": round(exposed / span, 4) if span else 0.0,
            "recovered_compute_fraction": round(ovl / wire, 4)
            if wire else 0.0,
        }
    return {
        "nranks": len(ranks),
        "compute_windows": sum(len(v) for v in windows.values()),
        "collectives": collectives,
    }


def device_overlap(trace_doc: Optional[dict]) -> dict:
    """Overlap accounting from the DEVICE stamp timeline alone.

    For every ``device:<collective>`` track in a Perfetto doc, measure
    how much of the transfer (``device_phase`` = xfer) time runs
    concurrently with reduce/compute slices on the *same rank and
    collective* — the device-side twin of :func:`overlap`, which
    accounts host flight records against host compute windows.

    The sequential ring's stamp clock serializes every step
    (xfer [3s, 3s+1] then reduce [3s+1, 3s+2]) so its xfer∩reduce is
    zero and ``exposed_fraction`` is 1.0.  The fused lanes stamp the
    overlapped clock — chunk k+1's xfer spans chunk k's reduce — so
    all but the first transfer are covered and the exposed fraction
    falls to ~1/slots.  ``recovered_mxu_fraction`` (the reference's
    key name) is the share of wire time the reduce/compute phase
    already hides.

    Returns::

        {"tracks": N,
         "collectives": {"<coll>": {"xfer_us", "overlapped_us",
             "exposed_us", "exposed_fraction",
             "recovered_mxu_fraction", "slices", "ranks"}}}
    """
    if not trace_doc:
        return {"tracks": 0, "collectives": {}}
    # (pid, tid) -> track label, from the thread_name metadata events
    labels: dict = {}
    for ev in trace_doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            labels[(ev.get("pid"), ev.get("tid"))] = \
                (ev.get("args") or {}).get("name", "")

    xfers: dict = {}    # (coll, pid) -> [(t0_ns, t1_ns)]
    reduces: dict = {}
    for ev in trace_doc.get("traceEvents", []):
        args = ev.get("args") or {}
        if ev.get("ph") != "X" or not args.get("device_track"):
            continue
        label = labels.get((ev.get("pid"), ev.get("tid")), "")
        coll = label[len("device:"):] if label.startswith("device:") \
            else label
        t0 = ev.get("ts", 0) * 1e3
        t1 = t0 + ev.get("dur", 0) * 1e3
        if t1 <= t0:
            continue
        key = (coll, ev.get("pid", -1))
        if args.get("device_phase") == "xfer":
            xfers.setdefault(key, []).append((t0, t1))
        else:
            reduces.setdefault(key, []).append((t0, t1))

    def _merge(wins: list) -> list:
        wins = sorted(wins)
        out = [wins[0]]
        for w0, w1 in wins[1:]:
            if w0 <= out[-1][1]:
                if w1 > out[-1][1]:
                    out[-1] = (out[-1][0], w1)
            else:
                out.append((w0, w1))
        return out

    agg: dict = {}
    for (coll, pid), xs in sorted(xfers.items()):
        cover = _merge(reduces.get((coll, pid), [])) \
            if (coll, pid) in reduces else []
        a = agg.setdefault(coll, {"xfer_ns": 0.0, "ovl_ns": 0.0,
                                  "slices": 0, "ranks": set()})
        a["ranks"].add(pid)
        for t0, t1 in xs:
            a["slices"] += 1
            a["xfer_ns"] += t1 - t0
            a["ovl_ns"] += _overlap_ns(t0, t1, cover)

    collectives: dict = {}
    for coll, a in sorted(agg.items()):
        xfer, ovl = a["xfer_ns"], a["ovl_ns"]
        exposed = max(xfer - ovl, 0.0)
        collectives[coll] = {
            "xfer_us": round(xfer / 1e3, 2),
            "overlapped_us": round(ovl / 1e3, 2),
            "exposed_us": round(exposed / 1e3, 2),
            "exposed_fraction": round(exposed / xfer, 4) if xfer else 0.0,
            "recovered_mxu_fraction": round(ovl / xfer, 4) if xfer
            else 0.0,
            "slices": a["slices"],
            "ranks": len(a["ranks"]),
        }
    return {"tracks": len({k for k in xfers} | {k for k in reduces}),
            "collectives": collectives}


def render(report: dict, out=None) -> str:
    """Human rendering of an attribution report."""
    lines = [
        f"critical-path attribution: {report['nranks']} rank(s), "
        f"{report['gangs_analyzed']} gang instance(s) analyzed",
        "  clock skew vs rank "
        f"{report['reference_rank']} (ns): {report['clock_skew_ns']}",
    ]
    for key, c in sorted(report["collectives"].items()):
        lines.append(
            f"\n{c['collective']} comm {c['comm']} {c['size_bucket']}: "
            f"{c['episodes']} episode(s), mean span "
            f"{c['span_us']:.1f}us (phase coverage "
            f"{c['phase_coverage'] * 100:.1f}%)")
        ph = c["phases_us"]
        span = max(c["span_us"], 1e-9)
        lines.append("  " + "  ".join(
            f"{p}={ph[p]:.1f}us ({ph[p] / span * 100:.0f}%)"
            for p in PHASES if ph.get(p)))
        for r, st in c["stragglers"].items():
            lines.append(
                f"  straggler rank {r}: {st['episodes']} episode(s) "
                f"({st['share'] * 100:.0f}%), mean late "
                f"{st['mean_late_us']:.1f}us, max {st['max_late_us']:.1f}us")
        d = c["dominant_straggler"]
        if d is not None and d["share"] >= 0.5:
            lines.append(
                f"  DOMINANT straggler: rank {d['rank']} arrives last "
                f"in {d['share'] * 100:.0f}% of late episodes "
                f"(mean +{d['mean_late_us']:.1f}us)")
    text = "\n".join(lines) + "\n"
    if out is not None:
        out.write(text)
    return text
