"""Axis layouts and link labels of a world.

The part of ``accl_tpu/utils/topology.py`` that the fabric model
(``tuning/topology.py``) uses: ``parse_shape``, ``grid_coords`` and
``link_axis``.  The JAX module's device probe (``probe``, ``dump``)
reads a TPU's ICI coordinates; the ranks of a ``CudaWorld`` are regions
of one card's memory and have none, so it has no counterpart here.
"""
from __future__ import annotations


def parse_shape(spec: str) -> tuple:
    """Parse an axis-layout spec like ``"4x2"`` / ``"2x2x2"`` into a
    shape tuple.  Raises a naming error on malformed specs (the env
    clear-error contract for ``ACCL_FABRIC``)."""
    try:
        shape = tuple(int(tok) for tok in str(spec).lower().split("x"))
    except ValueError:
        shape = ()
    if not shape or any(a < 1 for a in shape):
        raise ValueError(
            f"axis layout {spec!r} is not AxBxC... with positive "
            f"extents (e.g. ACCL_FABRIC=4x2)")
    return shape


def grid_coords(nranks: int, shape) -> list:
    """Row-major grid coordinates of a world's axis layout: rank r ->
    (c0, c1, ...) over ``shape``.  The product of the extents must cover
    the world; surplus positions are never minted."""
    shape = tuple(int(a) for a in shape)
    total = 1
    for a in shape:
        total *= a
    if total < nranks:
        raise ValueError(
            f"axis layout {'x'.join(map(str, shape))} holds {total} "
            f"ranks but the world has {nranks}")
    coords = []
    for r in range(nranks):
        c, rem = [], r
        for a in reversed(shape):
            c.append(rem % a)
            rem //= a
        coords.append(tuple(reversed(c)))
    return coords


def link_axis(src: int, dst: int, coords=None,
              nranks: int | None = None, shape=None) -> str:
    """Classify a src->dst link against the world's axes: the label the
    tuner groups by and a link-matrix rendering shows.

    With per-rank ``coords`` (or a ``shape`` whose row-major grid gives
    them) the label is the axis the two ranks differ on (``x``/``y``/``z``
    single-axis, ``multi-axis`` otherwise).  With neither it is the ring
    distance: ``ring+1``/``ring-1`` for the two neighbour directions,
    ``hop<k>`` for longer chords."""
    if coords is None and shape is not None and nranks:
        coords = grid_coords(nranks, shape)
    if coords is not None and 0 <= src < len(coords) \
            and 0 <= dst < len(coords) \
            and coords[src] is not None and coords[dst] is not None:
        diffs = [i for i, (a, b) in
                 enumerate(zip(coords[src], coords[dst])) if a != b]
        if len(diffs) == 1:
            return "xyz"[diffs[0]] if diffs[0] < 3 else f"axis{diffs[0]}"
        return "multi-axis" if diffs else "self"
    if nranks and nranks > 1:
        d = (dst - src) % nranks
        if d == 0:
            return "self"
        if d == 1:
            return "ring+1"
        if d == nranks - 1:
            return "ring-1"
        return f"hop{min(d, nranks - d)}"
    return "unknown"
