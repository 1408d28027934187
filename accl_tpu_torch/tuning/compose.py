"""Two-level hierarchical collectives composed from driver primitives.

Port of ``accl_tpu/tuning/compose.py``.  :class:`HierarchicalComm`
assembles topology-aware collectives from the per-call driver surface —
reduce_scatter-within-group → allreduce-across-groups →
allgather-within-group for allreduce, and the reduce_scatter /
allgather / bcast / scatter / gather analogues — over per-axis
sub-communicators minted from a :class:`~accl_tpu_torch.tuning.topology.
Fabric`.  Every stage is an ordinary ``ACCL`` call, so a composition is
capturable with ``ACCL.capture_plan`` (the decomposition is then paid
once per plan, replays ride the plan ring) and observable through the
flight recorder, metrics and trace.  On a ``CudaWorld`` each stage at
or above the ring threshold runs the ring kernels.

Layout contract: the stage pairing is chosen so results are element-
for-element identical to the flat collective.  For SUM reductions on
floating dtypes the two-level reduction ORDER differs from the flat
engine's, so float results are bitwise-equal only when the additions
are exact (integer-valued data, or integer/MAX lanes — the lossless
cases tests/test_torch_tuning.py pins bitwise on both worlds).

Sub-communicator discipline: the group family is iterated in the same
deterministic global order on every rank; a rank reserves (burns) the
comm ids of groups it is not a member of via ``ACCL.reserve_
communicator``, so the id spaces stay aligned world-wide — the
``create_communicator`` ordering contract applied to disjoint group
families.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import ACCLError, ReduceFunction
from .topology import Fabric


class HierarchicalComm:
    """Two-level collectives for one driver over one fabric.

    Construction mints the per-axis sub-communicators (inner = groups
    along the last, rank-contiguous axis; outer = the complementary
    partition) and is therefore collective in the create-order sense:
    every rank of the world must construct its ``HierarchicalComm``
    with the SAME fabric before any composed call, exactly like
    ``create_communicator``.  Scratch buffers are allocated lazily and
    cached, so a captured composition replays against stable
    addresses.

    Role assignment: the layout-sensitive collectives (reduce_scatter,
    allgather, scatter, gather) always stage their within-group phase
    on the inner (contiguous) axis — that is what makes the composed
    result element-identical to the flat call.  allreduce and bcast
    are layout-free, so their within role follows the fabric's
    measured axis health (``Fabric.within_axis``): a demoted (slow)
    inner axis swaps the heavy reduce_scatter+allgather traffic onto
    the healthier outer partition.
    """

    def __init__(self, accl, fabric: Optional[Fabric] = None):
        self.accl = accl
        self.fabric = fabric or Fabric.for_world(accl.size)
        if self.fabric.nranks != accl.size:
            raise ACCLError(
                f"HierarchicalComm: fabric covers {self.fabric.nranks} "
                f"ranks but the world has {accl.size}")
        self.flat = self.fabric.trivial
        self._scratch: dict = {}
        if self.flat:
            return
        # the inner axis is the LAST non-trivial one: its rank stride is
        # the product of the (extent-1) axes behind it, i.e. 1 — inner
        # groups are rank-contiguous, which is what makes the staged
        # slab layouts element-identical to the flat collectives
        self._inner_axis = max(
            i for i, a in enumerate(self.fabric.shape) if a > 1)
        #: True when measured demotion moved the heavy within role off
        #: the inner axis (allreduce/bcast swap stage comms)
        self.swapped = self.fabric.within_axis() != self._inner_axis
        rank = accl.rank
        inner_group: Optional[list] = None
        outer_group: Optional[list] = None
        inner_comm = outer_comm = -1
        # deterministic global order: inner groups first, then outer —
        # every rank iterates the same list and burns the ids of the
        # groups it is not in, so group G gets ONE world-wide comm id
        inner_groups = self.fabric.groups(self._inner_axis)
        outer_groups = self.fabric.groups_complement(self._inner_axis)
        for group in inner_groups:
            if rank in group:
                inner_group = group
                inner_comm = accl.create_communicator(group)
            else:
                accl.reserve_communicator()
        for group in outer_groups:
            if rank in group:
                outer_group = group
                outer_comm = accl.create_communicator(group)
            else:
                accl.reserve_communicator()
        if inner_group is None or outer_group is None:
            raise ACCLError(
                f"HierarchicalComm: rank {rank} is in no fabric group "
                f"(fabric {self.fabric.spec()})")
        self._inner_group: list = inner_group
        self._outer_group: list = outer_group
        self._inner_comm: int = inner_comm
        self._outer_comm: int = outer_comm

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _within(self) -> tuple:
        """(comm_id, group) of the heavy within stage for the
        layout-free collectives — honors measured demotion."""
        if self.swapped:
            return self._outer_comm, self._outer_group
        return self._inner_comm, self._inner_group

    def _across(self) -> tuple:
        if self.swapped:
            return self._inner_comm, self._inner_group
        return self._outer_comm, self._outer_group

    def _buf(self, tag: str, count: int, dtype):
        """Cached zero-initialized scratch: stable addresses across
        calls, so captured compositions replay against the same
        descriptor stream."""
        key = (tag, count, np.dtype(dtype).str)
        buf = self._scratch.get(key)
        if buf is None:
            buf = self.accl.create_buffer(count, np.dtype(dtype))
            buf.host[:] = 0
            buf.sync_to_device()
            self._scratch[key] = buf
        return buf

    def close(self) -> None:
        """Free the cached scratch (sub-communicators live with the
        driver, like every create_communicator result)."""
        for buf in self._scratch.values():
            free = getattr(buf, "free", None)
            if free is not None:
                free()
        self._scratch.clear()

    # ------------------------------------------------------------------
    # layout-free collectives: within role follows measured axis health
    # ------------------------------------------------------------------
    def allreduce(self, sendbuf, recvbuf, count: int,
                  function: ReduceFunction = ReduceFunction.SUM) -> None:
        """reduce_scatter(within) -> allreduce(across) -> allgather
        (within).  Non-divisible counts stage through padded scratch;
        the pad occupies the last chunk's tail beyond ``count`` and is
        DISCARDED by the truncating copy-out, so its content (zero at
        first use, possibly a prior larger call's stale elements on
        reuse) never reaches the result."""
        if self.flat:
            self.accl.allreduce(sendbuf, recvbuf, count, function)
            return
        w_comm, w_group = self._within()
        a_comm, _ = self._across()
        B = len(w_group)
        dtype = sendbuf.dtype
        chunk = -(-count // B)
        padded = chunk * B
        if padded == count:
            rs_in, ag_out = sendbuf, recvbuf
        else:
            rs_in = self._buf("ar_in", padded, dtype)
            ag_out = self._buf("ar_out", padded, dtype)
            # pad-tail invariant: everything past [0, count) is
            # DISCARDED — the final copy truncates to count — so the
            # tail's content (zero on first use; a smaller later count
            # may see a prior call's stale elements there) never
            # reaches a result.  Nothing may ever read ag_out's tail.
            self.accl.copy(sendbuf, rs_in, count)
        mid = self._buf("ar_mid", chunk, dtype)
        mid2 = self._buf("ar_mid2", chunk, dtype)
        self.accl.reduce_scatter(rs_in, mid, chunk, function,
                                 comm_id=w_comm)
        self.accl.allreduce(mid, mid2, chunk, function, comm_id=a_comm)
        self.accl.allgather(mid2, ag_out, chunk, comm_id=w_comm)
        if padded != count:
            self.accl.copy(ag_out, recvbuf, count)

    def bcast(self, buf, count: int, root: int) -> None:
        """bcast along the root's across-group, then within every
        within-group from the member aligned with the root."""
        if self.flat:
            self.accl.bcast(buf, count, root)
            return
        w_comm, w_group = self._within()
        a_comm, a_group = self._across()
        # stage 1: the across-group CONTAINING the root fans the data
        # to one delegate per within-group; ranks of the other across-
        # groups skip it (their across comm holds no data yet)
        if root in a_group:
            self.accl.bcast(buf, count, a_group.index(root),
                            comm_id=a_comm)
        # stage 2: within-group bcast from the delegate — the member
        # sharing the root's across-group (its within-group slot)
        delegate = next(m for m in w_group
                        if self._same_across_slot(m, root))
        self.accl.bcast(buf, count, w_group.index(delegate),
                        comm_id=w_comm)

    def _same_across_slot(self, a: int, b: int) -> bool:
        """True when ranks a and b share an across-group (occupy the
        same slot of their respective within-groups)."""
        if not self.swapped:
            # across groups share the inner coordinate
            return (self.fabric.coords[a][self._inner_axis]
                    == self.fabric.coords[b][self._inner_axis])
        # swapped: across groups are the inner (contiguous) lines —
        # shared slot means equal coords on every non-inner axis
        ca = tuple(c for i, c in enumerate(self.fabric.coords[a])
                   if i != self._inner_axis)
        cb = tuple(c for i, c in enumerate(self.fabric.coords[b])
                   if i != self._inner_axis)
        return ca == cb

    # ------------------------------------------------------------------
    # layout-sensitive collectives: within stage pinned to the inner
    # (rank-contiguous) axis so the result is element-identical to flat
    # ------------------------------------------------------------------
    def reduce_scatter(self, sendbuf, recvbuf, count: int,
                       function: ReduceFunction = ReduceFunction.SUM,
                       ) -> None:
        """RS across the outer partition (slab = count x inner-extent),
        then RS within the inner group — each rank ends owning exactly
        its flat-semantics chunk, no padding needed (the global input
        is count x P by construction)."""
        if self.flat:
            self.accl.reduce_scatter(sendbuf, recvbuf, count, function)
            return
        B = len(self._inner_group)
        slab = count * B
        mid = self._buf("rs_mid", slab, sendbuf.dtype)
        self.accl.reduce_scatter(sendbuf, mid, slab, function,
                                 comm_id=self._outer_comm)
        self.accl.reduce_scatter(mid, recvbuf, count, function,
                                 comm_id=self._inner_comm)

    def allgather(self, sendbuf, recvbuf, count: int) -> None:
        """AG within the inner group (count -> count x B), then AG
        across the outer partition (-> count x P, flat layout)."""
        if self.flat:
            self.accl.allgather(sendbuf, recvbuf, count)
            return
        B = len(self._inner_group)
        mid = self._buf("ag_mid", count * B, sendbuf.dtype)
        self.accl.allgather(sendbuf, mid, count, comm_id=self._inner_comm)
        self.accl.allgather(mid, recvbuf, count * B,
                            comm_id=self._outer_comm)

    def scatter(self, sendbuf, recvbuf, count: int, root: int) -> None:
        """scatter slabs along the root's outer group, then scatter
        within each inner group from the delegate."""
        if self.flat:
            self.accl.scatter(sendbuf, recvbuf, count, root)
            return
        B = len(self._inner_group)
        me = self.accl.rank
        slab = count * B
        if root in self._outer_group:  # me is one of root's delegates
            mid = self._buf("sc_mid", slab, recvbuf.dtype)
            self.accl.scatter(sendbuf if me == root else None, mid, slab,
                              self._outer_group.index(root),
                              comm_id=self._outer_comm)
        else:
            mid = None
        delegate = next(m for m in self._inner_group
                        if self._same_inner_slot(m, root))
        self.accl.scatter(mid, recvbuf, count,
                          self._inner_group.index(delegate),
                          comm_id=self._inner_comm)

    def gather(self, sendbuf, recvbuf, count: int, root: int) -> None:
        """gather within each inner group to the delegate, then gather
        slabs along the root's outer group."""
        if self.flat:
            self.accl.gather(sendbuf, recvbuf, count, root)
            return
        B = len(self._inner_group)
        me = self.accl.rank
        delegate = next(m for m in self._inner_group
                        if self._same_inner_slot(m, root))
        is_delegate = me == delegate
        mid = (self._buf("ga_mid", count * B, sendbuf.dtype)
               if is_delegate else None)
        self.accl.gather(sendbuf, mid, count,
                         self._inner_group.index(delegate),
                         comm_id=self._inner_comm)
        if root in self._outer_group:  # me is one of root's delegates
            self.accl.gather(mid, recvbuf if me == root else None,
                             count * B, self._outer_group.index(root),
                             comm_id=self._outer_comm)

    def _same_inner_slot(self, a: int, b: int) -> bool:
        """True when a and b hold the same inner-axis coordinate (share
        an outer group)."""
        return (self.fabric.coords[a][self._inner_axis]
                == self.fabric.coords[b][self._inner_axis])

    #: collectives this composer can stand in for (the autotuner's
    #: hierarchical lane covers exactly these)
    COMPOSABLE = ("allreduce", "reduce_scatter", "allgather", "bcast",
                  "scatter", "gather")
