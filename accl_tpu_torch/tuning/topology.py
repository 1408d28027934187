"""Fabric: the topology model the tuner and composer select against.

Port of ``accl_tpu/tuning/topology.py``.  A :class:`Fabric` is an axis
decomposition of one world's ranks: a row-major grid (``ACCL_FABRIC=4x2``
or an explicit shape), the near-square factorization of the world size
by default, or a plain ring (one axis) for a prime size.  The JAX class
also reads a TPU's ICI coordinates; the ranks of a ``CudaWorld`` share
one card and have none, so a fabric here is logical: on one card every
"link" is a copy within the card's memory, whatever axis it lies on.
It is the one source of axis names: ``Fabric.link_axis`` delegates to
:func:`accl_tpu_torch.utils.topology.link_axis` with the fabric's own
coords, so a link-matrix rendering and the tuner's per-axis grouping
cannot disagree.

``from_link_matrix`` ingests a measured link snapshot
(``world.link_matrix()`` of a ``CudaWorld`` or an ``EmuWorld``) and
scores each axis by the mean ``seek_wait_ns`` + retransmit load of its
links: a measured slow link DEMOTES its axis out of the heavy-traffic
"within" role the hierarchical composer assigns (HiCCL's topology
model role, arxiv 2408.05962).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from ..constants import ACCLError
from ..utils import topology as _topo

#: env knob: explicit axis layout, e.g. ``ACCL_FABRIC=4x2``; malformed
#: values raise a naming error at Fabric construction
FABRIC_ENV = "ACCL_FABRIC"


def _near_square(n: int) -> tuple:
    """Default 2-axis factorization of a world size: the largest factor
    pair (a, b) with a*b == n and a <= b — 8 -> (2, 4), 4 -> (2, 2),
    primes -> (1, n) which is a trivial (single-axis) fabric."""
    best = (1, n)
    a = 1
    while a * a <= n:
        if n % a == 0:
            best = (a, n // a)
        a += 1
    return best


class Fabric:
    """Axis decomposition of ``nranks`` ranks.

    ``shape`` is row-major: rank r has coordinate ``coords[r]`` with
    the LAST axis contiguous in rank order.  ``axis_order`` ranks the
    axes healthiest-first — ``axis_order[0]`` is the axis the composer
    gives the heavy "within" traffic (reduce_scatter + allgather
    stages); measured demotion (:meth:`from_link_matrix`) reorders it.
    """

    def __init__(self, nranks: int, shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None,
                 axis_order: Optional[Sequence[int]] = None):
        if nranks < 1:
            raise ACCLError(f"Fabric: nranks must be >= 1, got {nranks}")
        if shape is None:
            shape = _near_square(nranks)
        shape = tuple(int(a) for a in shape)
        total = 1
        for a in shape:
            total *= a
        if total != nranks:
            raise ACCLError(
                f"Fabric: axis layout {'x'.join(map(str, shape))} holds "
                f"{total} ranks but the world has {nranks} (set "
                f"{FABRIC_ENV} to a layout whose product is the world "
                f"size)")
        self.nranks = nranks
        self.shape = shape
        self.coords = _topo.grid_coords(nranks, shape)
        names = tuple(axis_names) if axis_names else tuple(
            "xyz"[i] if i < 3 else f"axis{i}" for i in range(len(shape)))
        if len(names) != len(shape):
            raise ACCLError(
                f"Fabric: {len(names)} axis names for {len(shape)} axes")
        self.axis_names = names
        #: healthiest-first; default prefers the LAST (rank-contiguous)
        #: axis for the within role: the neighbour links of the grid
        self.axis_order = (tuple(axis_order) if axis_order is not None
                           else tuple(reversed(range(len(shape)))))
        if sorted(self.axis_order) != list(range(len(shape))):
            raise ACCLError(
                f"Fabric: axis_order {self.axis_order} is not a "
                f"permutation of the {len(shape)} axes")
        #: axis name -> measured blocked-time score; populated only by
        #: :meth:`from_link_matrix` (empty on unmeasured fabrics)
        self.axis_scores: dict = {}

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def for_world(cls, nranks: int,
                  shape: Optional[Sequence[int]] = None) -> "Fabric":
        """The standard constructor chain: explicit ``shape`` >
        ``ACCL_FABRIC`` env layout > near-square default factorization.
        The JAX chain has a device-coordinate step between the last two
        (``probe``); the ranks of one card have no coordinates."""
        if shape is not None:
            return cls(nranks, shape)
        spec = os.environ.get(FABRIC_ENV, "")
        if spec:
            try:
                return cls(nranks, _topo.parse_shape(spec))
            except ValueError as e:
                raise ACCLError(f"{FABRIC_ENV}={spec!r}: {e}") from e
        return cls(nranks)

    @classmethod
    def from_coords(cls, nranks: int, coords: Sequence[tuple]) -> "Fabric":
        """Build from explicit per-rank mesh coordinates.  The shape is
        the per-axis extent; a rank order that is not row-major keeps the
        explicit coords (the grouping needs only coord equality)."""
        ndim = len(coords[0])
        shape = tuple(max(c[i] for c in coords) + 1 for i in range(ndim))
        fab = cls(nranks, shape)
        if list(map(tuple, coords)) != fab.coords:
            # non-row-major enumeration: keep the explicit coords (the
            # grouping below only needs coord equality, not order)
            fab.coords = [tuple(c) for c in coords]
        return fab

    @classmethod
    def from_link_matrix(cls, matrix: dict,
                         shape: Optional[Sequence[int]] = None) -> "Fabric":
        """Build from a measured link snapshot
        (``world.link_matrix()`` schema: ``nranks`` + ``fields`` of P×P
        counter matrices).  Axes are scored by the mean per-link
        ``seek_wait_ns`` (observer-side blocked time) plus a retransmit
        penalty over the links the axis owns; ``axis_order`` lists them
        healthiest-first, so a chaos-slowed or lossy link demotes its
        axis out of the composer's heavy-traffic "within" role."""
        P = int(matrix.get("nranks", 0))
        if P < 1 or "fields" not in matrix:
            raise ACCLError(
                "from_link_matrix: not a link_matrix document (want "
                "the world.link_matrix() / perf_doctor schema with "
                "nranks + fields)")
        fab = cls.for_world(P, shape=shape)
        wait = matrix["fields"].get("seek_wait_ns", [])
        retrans = matrix["fields"].get("retrans_sent", [])
        scores = []
        for axis in range(len(fab.shape)):
            waits, n = 0.0, 0
            for s in range(P):
                for d in range(P):
                    if s == d or fab.axis_of_link(s, d) != axis:
                        continue
                    n += 1
                    if s < len(wait) and d < len(wait[s]):
                        waits += float(wait[s][d])
                    if s < len(retrans) and d < len(retrans[s]):
                        # a retransmit costs at least one RTO round:
                        # weigh it like a millisecond of blocked time
                        waits += 1e6 * float(retrans[s][d])
            scores.append((waits / n if n else 0.0, axis))
        # healthiest (lowest blocked-time) axis first; stable on ties so
        # an unmeasured world keeps the default preference order
        default_pos = {a: i for i, a in enumerate(fab.axis_order)}
        fab.axis_order = tuple(a for _, a in sorted(
            scores, key=lambda sa: (sa[0], default_pos[sa[1]])))
        fab.axis_scores = {fab.axis_names[a]: s for s, a in scores}
        return fab

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    @property
    def trivial(self) -> bool:
        """True when there is no second axis to compose across (a
        1-axis fabric or any extent-1 decomposition): the composer
        falls back to the flat driver call."""
        return sum(1 for a in self.shape if a > 1) < 2

    def axis_of_link(self, src: int, dst: int) -> Optional[int]:
        """Index of the single axis src and dst differ on, or None for
        self/multi-axis links."""
        if not (0 <= src < self.nranks and 0 <= dst < self.nranks):
            return None
        diffs = [i for i, (a, b) in
                 enumerate(zip(self.coords[src], self.coords[dst]))
                 if a != b]
        return diffs[0] if len(diffs) == 1 else None

    def link_axis(self, src: int, dst: int) -> str:
        """Axis label of a link — the same names
        :func:`accl_tpu_torch.utils.topology.link_axis` mints from these
        coords (a rendering and the tuner's grouping: one source, never
        two)."""
        return _topo.link_axis(src, dst, coords=self.coords,
                               nranks=self.nranks)

    def groups(self, axis: int) -> list:
        """Partition of the ranks into lines along ``axis``: each group
        varies only the ``axis`` coordinate, sorted by rank, groups
        sorted by their fixed coordinates — the deterministic global
        order every rank iterates when minting sub-communicators."""
        by_key: dict = {}
        for r in range(self.nranks):
            key = tuple(c for i, c in enumerate(self.coords[r])
                        if i != axis)
            by_key.setdefault(key, []).append(r)
        return [sorted(by_key[k]) for k in sorted(by_key)]

    def within_axis(self) -> int:
        """The axis carrying the composer's heavy within-group traffic:
        the healthiest axis with extent > 1."""
        for a in self.axis_order:
            if self.shape[a] > 1:
                return a
        return self.axis_order[0]

    def within_groups(self) -> list:
        """Groups along the within axis (measured demotion moves a slow
        axis out of this role)."""
        return self.groups(self.within_axis())

    def groups_complement(self, axis: int) -> list:
        """The complementary partition of :meth:`groups`: for each
        ``axis`` coordinate, every rank holding it (all other axes
        collapse into one super-group — the two-level composition's
        across stage).  Groups sorted by coordinate, ranks sorted —
        the SAME deterministic order :meth:`groups` uses, because this
        ordering assigns world-wide communicator ids (compose.py)."""
        by_key: dict = {}
        for r in range(self.nranks):
            by_key.setdefault(self.coords[r][axis], []).append(r)
        return [sorted(by_key[k]) for k in sorted(by_key)]

    def across_groups(self) -> list:
        """The complementary partition of the within axis — the groups
        the middle (across) stage reduces over."""
        return self.groups_complement(self.within_axis())

    def spec(self) -> str:
        order = ">".join(self.axis_names[a] for a in self.axis_order)
        return (f"{'x'.join(map(str, self.shape))} "
                f"(axes {','.join(self.axis_names)}; health {order})")

    def __repr__(self) -> str:
        return f"Fabric({self.spec()})"
