"""Cross-rank static checkers over captured collective programs.

Port of ``accl_tpu/analysis/checks.py``, whole: it reads the flight
recorder's names from the port's ``observability/flight.py``.

Each checker takes ``programs: dict[rank -> CollectiveProgram]`` and
returns :class:`~accl_tpu_torch.analysis.findings.Finding` objects;
:func:`check_programs` runs the whole suite.  The bug classes are the
ones the flight-recorder/watchdog layer (observability/flight.py)
diagnoses *after* a gang wedges — here they are caught before any
dispatch:

- ``desync-order`` / ``param-mismatch`` — ranks disagree on the Nth
  gang collective of a communicator (op identity, or count/dtype/root/
  function of an agreeing op).  Shares the first-divergent-seq scan
  with :func:`~accl_tpu_torch.observability.flight.merge_flight_dumps`.
- ``desync-missing-call`` — a member issues fewer gang calls than its
  peers: the trailing collectives can never complete.
- ``subcomm-interleave-hazard`` — ranks shared by two overlapping
  sub-communicators issue their collectives in divergent comm order:
  blocking calls deadlock outright, and even async/chunked ones pin
  the shared rx pool against each other (the 8-rank sub-comm
  allgather wedge class — see docs/static_analysis.md).
- ``deadlock-cycle`` / ``p2p-unmatched`` / ``gang-missing-member`` —
  a send/recv matching simulation with a wait-for graph: blocking
  rendezvous sends, blocking recvs and gang barriers advance only when
  their peers arrive; a stuck fixpoint yields the cycle.
- ``root-invalid`` / ``peer-invalid`` — root or src/dst outside the
  communicator.
- ``buffer-overlap`` / ``buffer-alias`` / ``use-after-free`` — operand
  address-range hazards within a call, and calls touching freed
  allocations.
- ``leaked-request`` — async calls whose Request is never waited.
"""
from __future__ import annotations

from typing import Optional

from ..constants import Operation
from ..observability.flight import (
    FENCE_EVENTS,
    PLAN_CAPTURE_EVENT,
    TEARDOWN_EVENT,
    TERMINAL_STATE_NAMES,
    first_divergence,
)
from .findings import ERROR, WARNING, Finding, sort_findings
from .program import CollectiveProgram, RecordedCall, tags_match

#: rooted collectives whose root_src_dst is a comm-local root
_ROOTED = frozenset((Operation.bcast, Operation.scatter,
                     Operation.gather, Operation.reduce))


def _comm_members(programs: dict, comm_id: int) -> list:
    for prog in programs.values():
        if comm_id in prog.comms:
            return prog.comms[comm_id]
    any_prog = next(iter(programs.values()))
    return list(range(any_prog.nranks))


def _gang_by_comm(programs: dict) -> dict:
    """comm id -> {global rank -> ordered gang RecordedCalls}."""
    by_comm: dict = {}
    for r, prog in programs.items():
        for call in prog.calls:
            if call.is_gang:
                by_comm.setdefault(call.comm, {}).setdefault(
                    r, []).append(call)
    return by_comm


# ---------------------------------------------------------------------------
# issue order + parameter agreement
# ---------------------------------------------------------------------------
def check_order_and_params(programs: dict) -> list:
    findings: list = []
    for comm, seqs in sorted(_gang_by_comm(programs).items()):
        members = [m for m in _comm_members(programs, comm)
                   if m in programs]
        if len(members) < 2:
            continue
        per_rank = {r: seqs.get(r, []) for r in members}

        # 1. op-identity divergence: the classic mismatched-order bug
        div = first_divergence(per_rank, lambda c: c.op.name)
        if div is not None:
            i = div["index"]
            detail = ", ".join(
                f"rank {r}: " + (per_rank[r][i].describe()
                                 if i < len(per_rank[r]) else "<nothing>")
                for r in members)
            findings.append(Finding(
                ERROR, "desync-order",
                f"ranks disagree on gang collective #{i} of comm {comm}:"
                f" {detail}",
                hint="every member of a communicator must issue the "
                     "same collectives in the same order; reorder the "
                     "calls or split the groups onto distinct "
                     "communicators",
                comm=comm, ranks=list(members), index=i))
            continue  # later positions cascade from the first slip

        # 2. same op, divergent parameters (count/dtype/root/function/
        #    tag/compression — every field the engines key protocol
        #    decisions on)
        div = first_divergence(per_rank, RecordedCall.signature)
        if div is not None:
            i = div["index"]
            detail = ", ".join(
                f"rank {r}: " + (per_rank[r][i].describe()
                                 if i < len(per_rank[r]) else "<nothing>")
                for r in members)
            findings.append(Finding(
                ERROR, "param-mismatch",
                f"gang collective #{i} of comm {comm} has mismatched "
                f"parameters across ranks: {detail}",
                hint="count, dtype, root, reduce function and "
                     "compression must agree on every rank (each engine "
                     "derives the wire format from its own descriptor)",
                comm=comm, ranks=list(members), index=i))
            continue

        # 3. agreeing prefix but uneven depth: the short rank's peers
        #    hang in the trailing instances
        depths = {r: len(per_rank[r]) for r in members}
        if len(set(depths.values())) > 1:
            lead = max(depths.values())
            behind = {r: n for r, n in depths.items() if n < lead}
            findings.append(Finding(
                ERROR, "desync-missing-call",
                f"uneven gang call counts on comm {comm}: "
                + ", ".join(f"rank {r} issued {n}"
                            for r, n in sorted(depths.items()))
                + f" — the last {lead - min(depths.values())} "
                f"instance(s) can never complete",
                hint="ranks "
                     f"{sorted(behind)} return early (conditional "
                     "collective?); every member must issue the call",
                comm=comm, ranks=sorted(behind), index=min(depths.values())))
    return findings


# ---------------------------------------------------------------------------
# cross-communicator issue order on overlapping sub-communicators
# ---------------------------------------------------------------------------
def check_subcomm_interleave(programs: dict) -> list:
    """Ranks on overlapping communicators must enter them in one
    agreed global order.

    A gang collective in flight holds engine resources (rx-pool
    buffers, lane credits) until every member arrives, so "rank r
    enters comm x before comm y" is an acquisition edge x -> y.  A
    cycle in the cross-rank comm-order graph is the multi-communicator
    ABBA: with blocking calls it deadlocks outright, and with
    async/chunked calls each side's first collective pins the shared
    rx pool against the peer's — the hazard class behind the 8-rank
    concurrent sub-comm allgather wedge (RECEIVE_TIMEOUT with the
    expected segment parked in staging).  Two ranks entering a shared
    comm pair in opposite orders is the 2-cycle; a 2D grid whose rows
    and columns alternate which axis goes first closes longer cycles
    through comms that share only one rank each.  Per-comm order
    agreement is ``desync-order``'s job; this checker compares order
    ACROSS communicators.
    """
    findings: list = []
    # rank -> comm -> index of the rank's first gang call on that comm
    # (position within the rank's gang-call stream: first-issue order,
    # so a trailing world barrier does not fabricate a back edge)
    first_pos: dict = {}
    for r, prog in sorted(programs.items()):
        pos: dict = {}
        k = 0
        for call in prog.calls:
            if not call.is_gang:
                continue
            pos.setdefault(call.comm, k)
            k += 1
        first_pos[r] = pos
    # acquisition edges with one witness rank per edge; a rank only
    # contributes edges between comms it is a member of (it issued on
    # both), so every edge crosses an overlap by construction
    edge_why: dict = {}  # (x, y) -> (rank, gang-pos of x, gang-pos of y)
    for r in sorted(first_pos):
        pos = first_pos[r]
        cs = sorted(pos, key=lambda c: pos[c])
        for i, x in enumerate(cs):
            for y in cs[i + 1:]:
                edge_why.setdefault((x, y), (r, pos[x], pos[y]))

    # 2-cycles first: pairwise divergence on a shared comm pair is the
    # common bug and deserves one precise finding per pair
    flagged: set = set()
    for (x, y), (ra, ax, ay) in sorted(edge_why.items()):
        if x >= y or (y, x) not in edge_why:
            continue
        rb, by, bx = edge_why[(y, x)]
        flagged.update(((x, y), (y, x)))
        findings.append(Finding(
            ERROR, "subcomm-interleave-hazard",
            f"overlapping comms {x} and {y} are entered in divergent "
            f"order: rank {ra} issues comm {x} first (gang call #{ax}, "
            f"then comm {y} at #{ay}), rank {rb} issues comm {y} first "
            f"(gang call #{by}, then comm {x} at #{bx}) — blocking "
            f"calls deadlock, async ones pin the shared rx pool "
            f"against each other (the sub-comm allgather wedge class)",
            hint="issue collectives on overlapping sub-communicators "
                 "in one global order on every rank (e.g. sort by comm "
                 "id, or row-comms before col-comms everywhere)",
            comm=x, ranks=sorted({ra, rb})))
    if findings:
        return findings  # longer cycles through a flagged pair cascade

    # no pairwise divergence: look for a longer cycle (grid shapes
    # whose comm pairs share only one rank each)
    edges: dict = {}
    for (x, y) in edge_why:
        edges.setdefault(x, []).append(y)
        edges.setdefault(y, [])
    cycle = _find_cycle(edges)
    if cycle:
        chain = "; ".join(
            "comm {} before comm {} (rank {}, gang calls #{} -> #{})"
            .format(x, cycle[(k + 1) % len(cycle)],
                    *edge_why[(x, cycle[(k + 1) % len(cycle)])])
            for k, x in enumerate(cycle))
        findings.append(Finding(
            ERROR, "subcomm-interleave-hazard",
            f"communicators {sorted(cycle)} form an acquisition cycle "
            f"across ranks: {chain} — no global comm order exists, so "
            f"the gang windows can interlock (deadlock when blocking, "
            f"rx-pool pinning when chunked/async)",
            hint="pick one global order for overlapping "
                 "sub-communicators (e.g. all row comms before all col "
                 "comms on every rank) so the acquisition graph is "
                 "acyclic",
            comm=min(cycle),
            ranks=sorted({edge_why[(x, cycle[(k + 1) % len(cycle)])][0]
                          for k, x in enumerate(cycle)})))
    return findings


# ---------------------------------------------------------------------------
# root / peer validity
# ---------------------------------------------------------------------------
def check_membership(programs: dict) -> list:
    findings: list = []
    for r, prog in sorted(programs.items()):
        for call in prog.calls:
            P = len(prog.comm_members(call.comm))
            if call.op in _ROOTED and not 0 <= call.root < P:
                findings.append(Finding(
                    ERROR, "root-invalid",
                    f"rank {r} {call.describe()}: root {call.root} is "
                    f"not a member of comm {call.comm} (size {P})",
                    hint="roots are comm-LOCAL ranks: for a "
                         "sub-communicator pass the index within the "
                         "group, not the global rank",
                    comm=call.comm, ranks=[r], index=call.index))
            elif call.is_p2p and not 0 <= call.root < P:
                role = "dst" if call.op == Operation.send else "src"
                findings.append(Finding(
                    ERROR, "peer-invalid",
                    f"rank {r} {call.describe()}: {role} {call.root} "
                    f"outside comm {call.comm} (size {P})",
                    hint="peer ranks are comm-local; check the rank "
                         "arithmetic around world size",
                    comm=call.comm, ranks=[r], index=call.index))
    return findings


# ---------------------------------------------------------------------------
# buffer hazards
# ---------------------------------------------------------------------------
def _overlap(a0: int, n0: int, a1: int, n1: int) -> bool:
    return a0 < a1 + n1 and a1 < a0 + n0


def check_buffer_hazards(programs: dict) -> list:
    findings: list = []
    for r, prog in sorted(programs.items()):
        freed = [(addr, prog.allocs.get(addr, (0, 0))[0], idx)
                 for addr, idx in prog.frees.items()]
        for call in prog.calls:
            ext = call.operand_extents(len(prog.comm_members(call.comm)))
            for i in range(len(ext)):
                for j in range(i + 1, len(ext)):
                    ra, aa, na = ext[i]
                    rb, ab, nb = ext[j]
                    if aa == ab and na == nb:
                        findings.append(Finding(
                            WARNING, "buffer-alias",
                            f"rank {r} {call.describe()}: {ra} and {rb} "
                            f"are the same buffer "
                            f"[{aa:#x}, +{na}) — in-place collectives "
                            f"are backend-dependent",
                            hint="use a distinct result buffer, or "
                                 "verify the backend documents in-place "
                                 "support for this op",
                            comm=call.comm, ranks=[r], index=call.index))
                    elif _overlap(aa, na, ab, nb):
                        findings.append(Finding(
                            ERROR, "buffer-overlap",
                            f"rank {r} {call.describe()}: {ra} "
                            f"[{aa:#x}, +{na}) partially overlaps {rb} "
                            f"[{ab:#x}, +{nb}) — the engine streams "
                            f"both concurrently and will corrupt them",
                            hint="allocate disjoint buffers (watch "
                                 "slice() offsets: the extent is "
                                 "count x elem x fan, not count alone)",
                            comm=call.comm, ranks=[r], index=call.index))
            for _role, addr, nbytes in ext:
                for faddr, fbytes, fidx in freed:
                    if fidx <= call.index and _overlap(addr, nbytes,
                                                       faddr, fbytes):
                        findings.append(Finding(
                            ERROR, "use-after-free",
                            f"rank {r} {call.describe()} reads/writes "
                            f"[{addr:#x}, +{nbytes}) inside buffer "
                            f"[{faddr:#x}, +{fbytes}) freed before "
                            f"call #{call.index}",
                            hint="keep the buffer alive until every "
                                 "call using it (including async ones) "
                                 "has completed",
                            comm=call.comm, ranks=[r], index=call.index))
    return findings


# ---------------------------------------------------------------------------
# leaked async requests
# ---------------------------------------------------------------------------
def check_leaked_requests(programs: dict) -> list:
    findings: list = []
    for r, prog in sorted(programs.items()):
        leaked = [c for c in prog.calls
                  if c.run_async and c.request is not None
                  and not getattr(c.request, "waited", True)]
        for call in leaked:
            seq = (f" (flight seq {call.flight_seq})"
                   if call.flight_seq >= 0 else "")
            findings.append(Finding(
                WARNING, "leaked-request",
                f"rank {r} {call.describe()} was issued run_async but "
                f"its Request is never waited{seq} — errors and "
                f"completion are silently dropped",
                hint="call req.wait() + req.check() (or keep the "
                     "handle and drain it before deinit)",
                comm=call.comm, ranks=[r], index=call.index))
    return findings


# ---------------------------------------------------------------------------
# send/recv matching + wait-for-graph deadlock detection
# ---------------------------------------------------------------------------
class _SimRank:
    __slots__ = ("rank", "calls", "pos", "gang_pos")

    def __init__(self, rank: int, calls: list):
        self.rank = rank
        self.calls = calls
        self.pos = 0
        self.gang_pos: dict = {}  # comm -> next gang instance index

    @property
    def head(self) -> Optional[RecordedCall]:
        return self.calls[self.pos] if self.pos < len(self.calls) else None


def _global_peer(prog: CollectiveProgram, call: RecordedCall) -> int:
    """Translate the comm-local src/dst of a p2p call to a global rank."""
    members = prog.comm_members(call.comm)
    if 0 <= call.root < len(members):
        return members[call.root]
    return -1  # out of range: reported by check_membership


def check_deadlocks(programs: dict, eager_threshold: int = 0) -> list:
    """Simulate p2p matching + gang barriers to a fixpoint.

    Blocking semantics mirror the protocols: a sync send blocks only
    when its payload rides RENDEZVOUS (larger than the recorded eager
    threshold — a buffered eager send completes without the peer); a
    sync recv always blocks on the matching send being posted; a sync
    gang call blocks on every comm member arriving at the same
    instance.  Async calls post and continue.
    """
    findings: list = []
    sims = {r: _SimRank(r, list(prog.calls))
            for r, prog in programs.items()}
    # posted-but-unmatched p2p endpoints: (global_src, global_dst, tag,
    # comm, call) in FIFO order
    pending_sends: list = []
    pending_recvs: list = []
    gang_arrivals: dict = {}  # (comm, instance) -> set of global ranks
    matched_gangs: set = set()

    def match_send(src: int, dst: int, tag: int, comm: int) -> bool:
        for k, (ps, pd, pt, pc, _call) in enumerate(pending_recvs):
            if pc == comm and pd == dst and ps == src \
                    and tags_match(tag, pt):
                pending_recvs.pop(k)
                return True
        return False

    def match_recv(src: int, dst: int, tag: int, comm: int) -> bool:
        for k, (ps, pd, pt, pc, _call) in enumerate(pending_sends):
            if pc == comm and ps == src and pd == dst \
                    and tags_match(pt, tag):
                pending_sends.pop(k)
                return True
        return False

    def post_p2p(sim: _SimRank, call: RecordedCall) -> None:
        prog = programs[sim.rank]
        peer = _global_peer(prog, call)
        if call.op == Operation.send:
            if not match_send(sim.rank, peer, call.tag, call.comm):
                pending_sends.append(
                    (sim.rank, peer, call.tag, call.comm, call))
        else:
            if not match_recv(peer, sim.rank, call.tag, call.comm):
                pending_recvs.append(
                    (peer, sim.rank, call.tag, call.comm, call))

    def blocking(call: RecordedCall, prog: CollectiveProgram) -> bool:
        if call.run_async:
            return False
        if call.is_gang:
            return len(prog.comm_members(call.comm)) > 1
        if call.op == Operation.recv:
            return True
        if call.op == Operation.send:
            # eager sends are buffered by the rx pool; only rendezvous
            # payloads wait for the peer's landing address
            return call.count * call.elem_bytes > eager_threshold
        return False  # local ops never wait on a peer

    def step(sim: _SimRank) -> bool:
        """Advance this rank past every non-blocking head."""
        moved = False
        while True:
            call = sim.head
            if call is None:
                return moved
            prog = programs[sim.rank]
            if blocking(call, prog):
                return moved
            if call.is_p2p:
                post_p2p(sim, call)
            elif call.is_gang:
                i = sim.gang_pos.get(call.comm, 0)
                sim.gang_pos[call.comm] = i + 1
                if len(prog.comm_members(call.comm)) > 1:
                    gang_arrivals.setdefault(
                        (call.comm, i), set()).add(sim.rank)
            sim.pos += 1
            moved = True

    def try_unblock(sim: _SimRank) -> bool:
        call = sim.head
        if call is None:
            return False
        prog = programs[sim.rank]
        if not blocking(call, prog):
            return False
        if call.op == Operation.send:
            peer = _global_peer(prog, call)
            if match_send(sim.rank, peer, call.tag, call.comm):
                sim.pos += 1
                return True
            # peer blocked on the matching recv right now: rendezvous
            psim = sims.get(peer)
            ph = psim.head if psim is not None else None
            if ph is not None and ph.op == Operation.recv \
                    and ph.comm == call.comm \
                    and _global_peer(programs[peer], ph) == sim.rank \
                    and tags_match(call.tag, ph.tag):
                sim.pos += 1
                psim.pos += 1
                return True
            return False
        if call.op == Operation.recv:
            peer = _global_peer(prog, call)
            if match_recv(peer, sim.rank, call.tag, call.comm):
                sim.pos += 1
                return True
            psim = sims.get(peer)
            ph = psim.head if psim is not None else None
            if ph is not None and ph.op == Operation.send \
                    and ph.comm == call.comm \
                    and _global_peer(programs[peer], ph) == sim.rank \
                    and tags_match(ph.tag, call.tag):
                sim.pos += 1
                psim.pos += 1
                return True
            return False
        # gang: all members arrived at this instance?
        members = prog.comm_members(call.comm)
        i = sim.gang_pos.get(call.comm, 0)
        ready = []
        for m in members:
            msim = sims.get(m)
            if msim is None:
                return False  # member has no program: cannot decide
            if m in gang_arrivals.get((call.comm, i), ()):
                continue
            mh = msim.head
            if mh is not None and mh.is_gang and mh.comm == call.comm \
                    and msim.gang_pos.get(call.comm, 0) == i \
                    and not mh.run_async:
                ready.append(msim)
            else:
                return False
        for msim in ready:  # fire: every blocked member advances
            msim.gang_pos[call.comm] = i + 1
            msim.pos += 1
        gang_arrivals.pop((call.comm, i), None)
        matched_gangs.add((call.comm, i))
        return True

    # fixpoint
    progressed = True
    while progressed:
        progressed = False
        for sim in sims.values():
            if step(sim):
                progressed = True
        for sim in sims.values():
            if try_unblock(sim):
                progressed = True

    # -- diagnose the stuck state --------------------------------------
    blocked: dict = {}
    for r, sim in sims.items():
        head = sim.head
        if head is not None:
            blocked[r] = head
    if blocked:
        # ranks co-blocked on the SAME gang instance wait together, not
        # on each other — the wait-for edges must point only at the
        # members who never arrived, or a missing-member hang would be
        # misread as a deadlock cycle among the arrived ranks
        waiting_at: dict = {}
        for r, call in blocked.items():
            if call.is_gang:
                i = sims[r].gang_pos.get(call.comm, 0)
                waiting_at.setdefault((call.comm, i), set()).add(r)

        def gang_arrived(comm: int, i: int) -> set:
            return (gang_arrivals.get((comm, i), set())
                    | waiting_at.get((comm, i), set()))

        # wait-for edges
        edges: dict = {}
        for r, call in blocked.items():
            prog = programs[r]
            if call.is_p2p:
                edges[r] = [_global_peer(prog, call)]
            else:
                i = sims[r].gang_pos.get(call.comm, 0)
                arrived = gang_arrived(call.comm, i)
                edges[r] = [m for m in prog.comm_members(call.comm)
                            if m != r and m not in arrived]
        cycle = _find_cycle(edges)
        if cycle:
            chain = "; ".join(
                f"rank {r} blocked in {blocked[r].describe()} "
                f"(call #{blocked[r].index}) waiting on rank "
                f"{cycle[(k + 1) % len(cycle)]}"
                for k, r in enumerate(cycle))
            findings.append(Finding(
                ERROR, "deadlock-cycle",
                f"circular wait between ranks {cycle}: {chain}",
                hint="break the cycle: make one side async "
                     "(run_async=True) or invert the send/recv order "
                     "on one rank (the classic head-to-head exchange "
                     "fix)",
                ranks=list(cycle)))
        for r, call in sorted(blocked.items()):
            if cycle and r in cycle:
                continue
            if call.is_p2p:
                findings.append(Finding(
                    ERROR, "p2p-unmatched",
                    f"rank {r} blocks forever in {call.describe()} "
                    f"(call #{call.index}): no matching "
                    f"{'recv' if call.op == Operation.send else 'send'}"
                    f" in rank {_global_peer(programs[r], call)}'s "
                    f"program",
                    hint="add the matching call on the peer, or check "
                         "tag/comm values on both sides",
                    comm=call.comm, ranks=[r], index=call.index))
            else:
                i = sims[r].gang_pos.get(call.comm, 0)
                arrived = sorted(gang_arrived(call.comm, i) | {r})
                missing = [m for m in programs[r].comm_members(call.comm)
                           if m not in arrived]
                findings.append(Finding(
                    ERROR, "gang-missing-member",
                    f"rank {r} blocks forever in {call.describe()} "
                    f"(gang instance #{i}): arrived {arrived}, "
                    f"missing {missing}",
                    hint="the missing ranks never issue this "
                         "collective — see the desync findings for "
                         "where their programs diverge",
                    comm=call.comm, ranks=[r], index=call.index))

    # async p2p endpoints nothing ever matched
    for src, dst, _tag, comm, call in pending_sends:
        findings.append(Finding(
            ERROR, "p2p-unmatched",
            f"rank {src} {call.describe()} (call #{call.index}) is "
            f"never received by rank {dst} — the transfer cannot "
            f"complete",
            hint="add the matching recv on the destination rank",
            comm=comm, ranks=[src], index=call.index))
    for src, dst, _tag, comm, call in pending_recvs:
        findings.append(Finding(
            ERROR, "p2p-unmatched",
            f"rank {dst} {call.describe()} (call #{call.index}) has no "
            f"matching send in rank {src}'s program — the recv can "
            f"never be satisfied",
            hint="add the matching send on the source rank, or check "
                 "the src/tag values",
            comm=comm, ranks=[dst], index=call.index))
    return findings


def _find_cycle(edges: dict) -> Optional[list]:
    """One cycle in the wait-for graph, as an ordered rank list."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {r: WHITE for r in edges}
    stack: list = []

    def dfs(r: int) -> Optional[list]:
        color[r] = GREY
        stack.append(r)
        for nxt in edges.get(r, ()):
            if color.get(nxt, BLACK) == GREY:
                return stack[stack.index(nxt):]
            if color.get(nxt) == WHITE:
                found = dfs(nxt)
                if found:
                    return found
        stack.pop()
        color[r] = BLACK
        return None

    for r in sorted(edges):
        if color[r] == WHITE:
            found = dfs(r)
            if found:
                return found
    return None


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------
def check_programs(programs: dict,
                   eager_threshold: int = 0) -> list:
    """Run every checker; returns severity-ranked findings.

    ``eager_threshold``: payload bytes below which a blocking send is
    treated as buffered (non-blocking) by the deadlock simulation —
    pass the world's ``max_eager_size`` for protocol-accurate results;
    the default 0 is the conservative all-sends-block reading.
    """
    programs = {r: p for r, p in programs.items() if p is not None}
    if not programs:
        return []
    findings: list = []
    findings += check_order_and_params(programs)
    findings += check_subcomm_interleave(programs)
    findings += check_membership(programs)
    findings += check_buffer_hazards(programs)
    findings += check_leaked_requests(programs)
    findings += check_deadlocks(programs, eager_threshold)
    return sort_findings(findings)


# ---------------------------------------------------------------------------
# happens-before lifecycle checkers over merged flight dumps (r13)
#
# The checkers above reason over captured CollectivePrograms BEFORE
# dispatch; these reason over flight-recorder dumps AFTER the fact —
# production post-mortems.  The driver publishes zero-duration
# lifecycle anchors into the ring (observability.flight.mark_event):
# fences (abort/shrink/grow/reset_errors), plan_capture, and
# engine_teardown — and the checkers verify the happens-before
# invariants whose in-process violations are exactly the races the
# TSan lane catches live:
#
# - ``fence-stale-replay`` — a plan replay COMPLETED successfully on a
#   communicator after its last fence with no re-capture in between:
#   the replay ran against a dead generation (the invalidation
#   contract chaos drill 4 gates in-process, checked from dumps).
# - ``completion-after-teardown`` — a call published a SUCCESSFUL
#   completion after its rank's engine teardown record: some thread
#   was still completing work into a world being destroyed (the r13
#   suite-exit segfault class, as a dump invariant).
# - ``lock-order-inversion`` — two ranks acquired the same pair of
#   communicators (gang collectives held concurrently = locks) in
#   opposite orders: the cross-rank ABBA pattern that deadlocks
#   hierarchical/multi-comm schedules.
# - ``stuck-progress`` — a record parked in a non-terminal state:
#   a submitted call that never finalized (liveness; ERROR when the
#   rank's dump shows engine teardown happened around it).
# ---------------------------------------------------------------------------
def _flight_per_rank(merged) -> dict:
    """rank -> seq-ordered record dicts.  Accepts a merged dump doc
    (``merge_flight_dumps`` output), a single-rank dump, or a path to
    the JSON of either."""
    import json

    if isinstance(merged, str):
        with open(merged) as f:
            merged = json.load(f)
    ranks = merged["ranks"] if "ranks" in merged else [merged]
    return {rd["rank"]: sorted(rd["records"], key=lambda x: x["seq"])
            for rd in ranks}


def check_fence_staleness(merged) -> list:
    """A successful ``plan_replay`` on a comm whose last fence has no
    intervening ``plan_capture``: the replay ran on a generation older
    than the comm's last fence."""
    findings: list = []
    for rank, recs in _flight_per_rank(merged).items():
        fence_seq: dict = {}   # comm -> seq of its last fence
        recaptured: dict = {}  # comm -> a capture happened since
        seen: set = set()
        for rec in recs:
            comm = rec.get("comm", -1)
            name = rec.get("collective", "")
            if comm >= 0:
                seen.add(comm)
            if name in FENCE_EVENTS:
                # comm -1 (reset_errors/teardown) fences every comm
                # that existed at that point; later-minted comms are
                # born clean
                for c in ([comm] if comm >= 0 else sorted(seen)):
                    fence_seq[c] = rec["seq"]
                    recaptured[c] = False
            elif name == PLAN_CAPTURE_EVENT:
                recaptured[comm] = True
            elif (name == "plan_replay" and rec.get("state") == "complete"
                  and rec.get("retcode", 0) == 0
                  and comm in fence_seq and not recaptured.get(comm, True)):
                findings.append(Finding(
                    ERROR, "fence-stale-replay",
                    f"rank {rank}: plan replay (seq {rec['seq']}) "
                    f"completed successfully on comm {comm} after its "
                    f"fence at seq {fence_seq[comm]} with no re-capture "
                    f"in between — the replay ran on a dead generation",
                    hint="every abort/shrink/grow/reset must invalidate "
                         "armed plans; re-capture before replaying "
                         "(CollectivePlan fencing contract)",
                    comm=comm, ranks=[rank], index=rec["seq"]))
    return findings


def check_teardown_completions(merged) -> list:
    """A SUCCESSFUL completion published after the rank's
    ``engine_teardown`` record: a thread was still finishing calls
    into a world being destroyed.  Teardown-finalized calls carry
    COMM_ABORTED (state ``aborted``) and are the sanctioned path."""
    findings: list = []
    for rank, recs in _flight_per_rank(merged).items():
        teardown_t = None
        teardown_seq = None
        for rec in recs:
            if rec.get("collective") == TEARDOWN_EVENT:
                if teardown_t is None or rec["t_complete"] < teardown_t:
                    teardown_t = rec["t_complete"]
                    teardown_seq = rec["seq"]
        if teardown_t is None:
            continue
        for rec in recs:
            if rec.get("collective") == TEARDOWN_EVENT:
                continue
            if (rec.get("state") == "complete"
                    and rec.get("retcode", 0) == 0
                    and rec.get("t_complete", 0) > teardown_t):
                findings.append(Finding(
                    ERROR, "completion-after-teardown",
                    f"rank {rank}: {rec.get('collective')} (seq "
                    f"{rec['seq']}) published a successful completion "
                    f"AFTER the engine teardown record (seq "
                    f"{teardown_seq}) — a completion publisher outlived "
                    f"its engine",
                    hint="teardown must shutdown the engine, join the "
                         "completion publishers, then free (the r13 "
                         "close() ordering); a success after teardown "
                         "means that ordering was violated",
                    comm=rec.get("comm", -1), ranks=[rank],
                    index=rec["seq"]))
    return findings


def check_lock_order(merged) -> list:
    """Cross-rank communicator acquisition order: a gang collective in
    flight is a held lock; a second gang submitted on another comm
    while the first is unfinished is a nested acquisition.  Two ranks
    nesting the same comm pair in OPPOSITE orders is the ABBA pattern
    that deadlocks multi-communicator schedules."""
    findings: list = []
    edges: dict = {}  # (held_comm, wanted_comm) -> {rank: example seq}
    for rank, recs in _flight_per_rank(merged).items():
        gangs = [r for r in recs if r.get("gang")]
        for i, a in enumerate(gangs):
            a_end = a.get("t_complete") or float("inf")
            for b in gangs[i + 1:]:
                if b.get("comm") == a.get("comm"):
                    continue
                if b.get("t_submit", 0) < a_end:  # nested under a
                    edges.setdefault(
                        (a["comm"], b["comm"]), {}).setdefault(
                        rank, (a["seq"], b["seq"]))
    for (x, y), holders in sorted(edges.items()):
        if x >= y or (y, x) not in edges:
            continue
        inverse = edges[(y, x)]
        fwd_only = set(holders) - set(inverse)
        inv_only = set(inverse) - set(holders)
        if fwd_only and inv_only:
            ra = sorted(fwd_only)[0]
            rb = sorted(inv_only)[0]
            findings.append(Finding(
                WARNING, "lock-order-inversion",
                f"rank {ra} holds comm {x} while acquiring comm {y} "
                f"(seqs {holders[ra]}), but rank {rb} nests them in "
                f"the OPPOSITE order (seqs {inverse[rb]}) — the "
                f"cross-rank ABBA pattern that deadlocks when the "
                f"windows overlap",
                hint="acquire communicators in one global order on "
                     "every rank (sort multi-comm gang issue order, "
                     "e.g. by comm id) or barrier between the phases",
                comm=x, ranks=sorted(set(list(fwd_only) + list(inv_only)))))
    return findings


def check_stuck_progress(merged) -> list:
    """Liveness over dumps: every submitted call must finalize.

    A record parked in a non-terminal state (submitted/queued/
    gang_ready/dispatched/recovering — anything outside
    ``TERMINAL_STATE_NAMES``) never published a completion.  In a
    post-mortem dump whose rank carries an ``engine_teardown`` anchor
    that is an ERROR: the world tore down around a call that never
    finalized (the detsched liveness invariant, as a dump check —
    teardown-finalized calls carry COMM_ABORTED and retire
    ``aborted``, so they do NOT trip this).  Without a teardown anchor
    the dump may be a mid-run snapshot, so the finding downgrades to a
    WARNING carrying the in-flight age.
    """
    findings: list = []
    for rank, recs in _flight_per_rank(merged).items():
        has_teardown = any(
            rec.get("collective") == TEARDOWN_EVENT for rec in recs)
        for rec in recs:
            if rec.get("collective") == TEARDOWN_EVENT:
                continue
            state = rec.get("state")
            if state in TERMINAL_STATE_NAMES:
                continue
            age = rec.get("age_us", 0)
            findings.append(Finding(
                ERROR if has_teardown else WARNING, "stuck-progress",
                f"rank {rank}: {rec.get('collective')} (seq "
                f"{rec['seq']}, comm {rec.get('comm', -1)}) never "
                f"finalized — parked in state {state!r} "
                + (f"through engine teardown"
                   if has_teardown else f"for {age} us at dump time")
                + " — a submitted call must retire complete, failed "
                  "or aborted",
                hint="a dispatched-but-never-completed recv whose "
                     "peer made progress is the cross-comm rx-pool "
                     "pinning signature (staged segment, expired "
                     "budget); replay the schedule under "
                     "scripts/model_check.py and check "
                     "engine_wedged_timeouts in the link forensics",
                comm=rec.get("comm", -1), ranks=[rank],
                index=rec["seq"]))
    return findings


def check_flight_lifecycle(merged) -> list:
    """The post-mortem lifecycle suite over merged flight dumps:
    fence-stale replays, completions after teardown, cross-rank
    lock-order inversions, and stuck-progress liveness.  Accepts what
    :func:`~accl_tpu_torch.observability.flight.merge_flight_dumps` produces
    (dict or path) or a single-rank dump."""
    findings: list = []
    findings += check_fence_staleness(merged)
    findings += check_teardown_completions(merged)
    findings += check_lock_order(merged)
    findings += check_stuck_progress(merged)
    return sort_findings(findings)
