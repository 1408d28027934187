"""The launch plan and the arithmetic of the port's streaming kernels
(accl_tpu_torch/ops/reduce_ops.py ``stream_plan``, ``stream_share``;
csrc/reduce_ops.cu ``accl_combine``, csrc/compression.cu ``accl_cast``),
on the CPU.

- The plan gives one CTA per block of STREAM_THREADS x (vectors per
  thread) units, and the grid-stride walk covers every vector exactly
  once, over ragged lengths, lengths below one CTA, 2^26 elements and
  more than 2^31, and when the grid is capped.
- The geometry the wrappers plan with is the one compiled into the two
  sources.
- The cast kernel's walk emulated thread by thread (each vector's tile
  and index by one division of its flat index, rolled over into the next
  tile inside the vector; the last CTA's tail; the element path of
  unaligned pointers): its random bits are ``_random_bits``'s, for tiles
  whose size is not a multiple of the vector width and for blocks that
  cross tile boundaries.
- The kernel's stochastic rounding in 32-bit steps (bf16: add and shift
  on the bit pattern; fp8 in its normal range: add, shift and mask;
  below it: n 2^(EMIN - M); the 64-bit add only where k > 31), written
  in integer torch ops, bit for bit against ``_stochastic_round`` for
  bf16, e5m2 and e4m3fn on random patterns of every exponent class and
  the range edges.  NaN is routed apart in the kernel
  (``__float2bfloat16_rn`` and the encoders) and is left out.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from accl_tpu_torch.ops import compression as TC
from accl_tpu_torch.ops import reduce_ops as TR

CSRC = Path(TR.__file__).resolve().parent / "csrc"
M32 = 0xFFFFFFFF


def _constexprs(name):
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}


COMBINE = _constexprs("reduce_ops.cu")
CAST = _constexprs("compression.cu")


def test_geometry_matches_the_kernel_sources():
    assert COMBINE["THREADS"] == CAST["THREADS"] == TR.STREAM_THREADS
    assert COMBINE["VEC_BYTES"] == TR.VEC_BYTES
    assert COMBINE["LANES"] == TR._LANES
    assert CAST["CHUNK"] == TC.CHUNK
    assert CAST["UNROLL"] == TC.UNROLL and CAST["SR_UNROLL"] == TC.SR_UNROLL
    # 16 bytes of fp32 a vector: every warp-wide access is contiguous
    assert TC.CHUNK * 4 == TR.VEC_BYTES
    # both kernels walk as stream_share does: CTA c from block c, stepping
    # by the grid (the combine kernel one unit a thread)
    cast = (CSRC / "compression.cu").read_text()
    assert cast.count("int64_t j = (int64_t)blockIdx.x * STEP + "
                      "threadIdx.x;") == 1
    assert cast.count("j += (int64_t)gridDim.x * STEP)") == 1
    assert cast.count("= (int64_t)blockIdx.x * THREADS + threadIdx.x;") == 1
    combine = (CSRC / "reduce_ops.cu").read_text()
    assert combine.count("int64_t j = (int64_t)blockIdx.x * THREADS + "
                         "threadIdx.x;") == 1
    assert combine.count("j += (int64_t)gridDim.x * THREADS)") == 1


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
#: element counts: ragged, below one CTA's threads, the bench shapes (2^26),
#: and past 2^31
LENGTHS = [1, 3, 4, 5, 255, 256, 257, 1000, 4099 * 128, 12345, 65536 + 3,
           132 * 256 * 8 - 1, 1 << 20, (1 << 20) + 17, 3 * 5 * 7 * 11 * 13,
           1 << 26, (1 << 26) + 5, (1 << 31) + 3, 3 << 31, (1 << 33) + 7]


def _covers(plan):
    """Every unit in exactly one block of one CTA."""
    seen = np.zeros(plan.units, np.int64)
    for c in range(plan.grid):
        for lo, hi in TR.stream_share(plan, c):
            assert 0 <= lo < hi <= plan.units
            seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_gives_one_cta_per_block_and_covers_every_vector(n):
    # (units per element, vectors per thread): combine fp32 / bf16 / fp64,
    # the cast's nearest and stochastic vectors, the element path
    for per_vec, per_thread in ((4, 1), (8, 1), (2, 1), (TC.CHUNK, TC.UNROLL),
                                (TC.CHUNK, TC.SR_UNROLL), (1, 1)):
        units = n // per_vec
        plan = TR.stream_plan(units, per_thread)
        assert plan.units == units
        assert plan.block == TR.STREAM_THREADS * per_thread
        assert plan.grid == max(1, -(-units // plan.block))
        if units:
            # all blocks full but the last, each CTA one block
            assert (plan.grid - 1) * plan.block < units <= \
                plan.grid * plan.block
            last = TR.stream_share(plan, plan.grid - 1)
            assert last == [((plan.grid - 1) * plan.block, units)]
        if units <= 1 << 20:
            assert _covers(plan)


def test_plan_walks_blocks_grid_stride_when_the_grid_is_capped(monkeypatch):
    monkeypatch.setattr(TR, "MAX_GRID", 3)
    plan = TR.stream_plan(10 * TR.STREAM_THREADS + 5)
    assert plan.grid == 3
    b = plan.block
    assert TR.stream_share(plan, 0) == [(0, b), (3 * b, 4 * b),
                                        (6 * b, 7 * b), (9 * b, 10 * b)]
    assert TR.stream_share(plan, 1) == [(b, 2 * b), (4 * b, 5 * b),
                                        (7 * b, 8 * b),
                                        (10 * b, 10 * b + 5)]
    assert _covers(plan)


def test_plan_at_the_bench_shapes():
    """[524288, 128] fp32 is 2^24 vectors; [131072, 512] is 2^24 cast
    vectors: one CTA of 256 threads per 256 vectors, 1024 when stochastic."""
    assert TR.stream_plan(1 << 24).grid == 1 << 16
    assert TR.stream_plan(1 << 24, TC.UNROLL).grid == 1 << 16
    assert TR.stream_plan(1 << 24, TC.SR_UNROLL).grid == 1 << 14
    assert TR.stream_plan(0).grid == 1


# ---------------------------------------------------------------------------
# the cast kernel's walk of the stochastic tiles
# ---------------------------------------------------------------------------
def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _find(f, tile):
    """Tiles.find: one division of the flat index."""
    return f // tile, f % tile


def _bits_of_vector(f, tile, seed):
    """convert_sr's random bits for the CHUNK elements from flat f."""
    t, i = _find(f, tile)
    key = _fmix32((seed + t) & M32)
    out = []
    if i + TC.CHUNK <= tile:
        h0 = (i & M32) * 0x9E3779B1 & M32
        for e in range(TC.CHUNK):
            out.append(_fmix32(key ^ ((h0 + e * 0x9E3779B1) & M32)))
        return out
    for _ in range(TC.CHUNK):
        if i == tile:
            i, t = 0, t + 1
            key = _fmix32((seed + t) & M32)
        out.append(_fmix32(key ^ ((i & M32) * 0x9E3779B1 & M32)))
        i += 1
    return out


def _one_bits(f, tile, seed):
    """cast_one's random bits for element f."""
    t, i = _find(f, tile)
    return _fmix32(_fmix32((seed + t) & M32) ^ ((i & M32) * 0x9E3779B1 & M32))


def _emulate_walk(n, tile, seed, grid=None, vec=True):
    """The random bits cast_kernel draws for every element, CTA by CTA,
    round by round, thread by thread, as the kernel walks; ``grid``
    (default: the plan's) may be smaller than the plan's."""
    threads, chunk = CAST["THREADS"], CAST["CHUNK"]
    per = CAST["SR_UNROLL"] if vec else 1
    got = np.full(n, -1, np.int64)
    units = n // chunk if vec else n
    step = threads * per
    plan = TR.stream_plan(units, per)
    grid = grid or plan.grid
    for c in range(grid):
        for base in range(c * step, units, grid * step):
            for tid in range(threads):
                for u in range(per):
                    j = base + u * threads + tid
                    if j >= units:
                        continue
                    if vec:
                        sl = slice(j * chunk, (j + 1) * chunk)
                        assert (got[sl] == -1).all()
                        got[sl] = _bits_of_vector(j * chunk, tile, seed)
                    else:
                        assert got[j] == -1
                        got[j] = _one_bits(j, tile, seed)
        if vec and c == grid - 1:
            for f in range(units * chunk, n):
                got[f] = _one_bits(f, tile, seed)
    assert (got >= 0).all()
    return got


@pytest.mark.parametrize("rows,cols,block_rows", [
    (40, 5, 3),      # a tile of 15 elements: not a multiple of the vector
    (40, 5, 1),      # tiles of 5: every vector crosses one or two
    (13, 1, 1),      # tiles of 1 element, a ragged tail
    (37, 24, 5),     # tiles of 120, rows not a multiple of block_rows
    (9, 512, 4),     # the lane's width, a short last tile
    (3, 7, 100),     # block_rows past the rows: one tile
    (64, 140, 7),    # several CTAs' blocks crossing tile boundaries
])
@pytest.mark.parametrize("seed", [0, 12345, M32])
def test_cast_walk_draws_the_plain_random_bits(rows, cols, block_rows, seed):
    br = min(block_rows, rows)
    want = TC._random_bits(seed, rows, cols, br, "cpu").flatten().numpy()
    n = rows * cols
    for vec in (True, False):
        for grid in (None, 1, 2):  # the plan's grid, and grid-stride
            got = _emulate_walk(n, br * cols, seed, grid, vec)
            np.testing.assert_array_equal(got, want)


def test_cast_walk_index_is_taken_mod_2_32():
    """A tile past 2^32 elements: the hash takes i mod 2^32, as
    _random_bits does with its mask, on the vector and the element
    paths."""
    tile = (1 << 32) + 24
    for f in (0, (1 << 32) - 8, (1 << 32) - 3, 1 << 32, tile - 8, tile - 5,
              tile + 3):
        vec = _bits_of_vector(f, tile, 7)
        for e in range(TC.CHUNK):
            t, i = divmod(f + e, tile)
            want = _fmix32(_fmix32((7 + t) & M32) ^
                           ((i & M32) * 0x9E3779B1 & M32))
            assert vec[e] == want == _one_bits(f + e, tile, 7)


# ---------------------------------------------------------------------------
# stochastic rounding in 32-bit steps
# ---------------------------------------------------------------------------
def _u32(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & M32


def _stochastic_bf16_bits(u, r):
    """stochastic_bf16: ((|u| + (r & 0xffff)) >> 16) | sign."""
    mag = u & 0x7FFFFFFF
    return ((mag + (r & 0xFFFF)) >> 16) | ((u >> 16) & 0x8000)


def _stochastic_value(u, r, mant, emin):
    """stochastic_value<M, EMIN> as fp32 bits (int64)."""
    k_norm = 23 - mant
    mag, sign = u & 0x7FFFFFFF, u & 0x80000000
    normal = (((mag + (r & ((1 << k_norm) - 1))) >> k_norm) << k_norm) | sign
    big_e = mag >> 23
    e = torch.clamp_min(big_e, 1) - 127
    m = (mag & 0x7FFFFF) | torch.where(big_e > 0, 0x800000, 0)
    k = k_norm + emin - e
    k31 = torch.clamp(k, 1, 31)
    n32 = (m + (r & (torch.bitwise_left_shift(torch.ones_like(k31), k31) - 1))) >> k31
    # k > 31: R = r << (k - 32) in 64 bits (k = 32: r itself)
    kk = torch.clamp(k, 32, 63)
    n64 = (m + (r << (kk - 32))) >> kk
    n = torch.where(k <= 31, n32, torch.where(k <= 63, n64, 0))
    assert int(n.max()) < 1 << 24  # (float)n is exact
    low = (n.float() * 2.0 ** (emin - mant)).view(torch.int32)
    low = (low.to(torch.int64) & M32) | sign
    out = torch.where(mag >= (emin + 127) << 23, normal, low)
    return torch.where(mag >= 0x7F800000, u, out)


def _encode(v_bits, dtype):
    """encode_e5m2 / encode_e4m3 of the exact values (NaN left out)."""
    v = (v_bits & M32).to(torch.int32).view(torch.float32)
    if dtype == torch.float8_e5m2:
        v = torch.where(v.abs() >= 65536.0, v.sign() * float("inf"), v)
    else:
        v = torch.clamp(v, -448.0, 448.0)
    return v.to(dtype)


def _patterns(seed, count):
    """Random fp32 bit patterns of every exponent class, random bits, and
    the edges, crossed with random and extreme bits."""
    rng = np.random.default_rng(seed)
    uniform = rng.integers(0, 1 << 32, count, dtype=np.int64)
    expo = (rng.integers(0, 256, count, dtype=np.int64) << 23) | \
        rng.integers(0, 1 << 23, count, dtype=np.int64) | \
        (rng.integers(0, 2, count, dtype=np.int64) << 31)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 1.17549421e-38,
                      3.4028235e38, -3.4028235e38, np.inf, -np.inf,
                      65504.0, 65520.0, 57344.0, 61440.0, 65535.0, 65536.0,
                      -65536.0, 448.0, 464.0, 479.0, 480.0, -480.0, 2.0 ** -24,
                      2.0 ** -25, 3e-8, 2.0 ** -17, 2.0 ** -18, 1e-6, 1e-10,
                      1e-30, 2.0 ** -14, 2.0 ** -15, 2.0 ** -6, 2.0 ** -7,
                      2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 1.0, 1 + 2.0 ** -12],
                     np.float32)
    edge_bits = edges.view(np.uint32).astype(np.int64)
    rb = np.concatenate([[0, 1, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x1FFFFF,
                          0x200000, 0x7FFFFFFF, 0x80000000, M32],
                         rng.integers(0, 1 << 32, 21, dtype=np.int64)])
    u = np.concatenate([uniform, expo, np.repeat(edge_bits, rb.size)])
    r = np.concatenate([rng.integers(0, 1 << 32, 2 * count, dtype=np.int64),
                        np.tile(rb, edge_bits.size)])
    u, r = torch.from_numpy(u), torch.from_numpy(r)
    x = (u & M32).to(torch.int32).view(torch.float32)
    keep = ~torch.isnan(x)
    return x[keep], u[keep], r[keep]


@pytest.mark.parametrize("dtype", list(TC.STOCHASTIC_TARGETS))
def test_stochastic_rounding_in_32_bit_steps_is_the_plain_rounding(dtype):
    x, u, r = _patterns(int(TC._CODES[dtype]), 1 << 18)
    assert torch.equal(_u32(x), u)
    want = TC._stochastic_round(x, r, dtype)
    if dtype == torch.bfloat16:
        got = _stochastic_bf16_bits(u, r)
        assert torch.equal(got, want.view(torch.int16).to(torch.int64) &
                           0xFFFF)
        return
    mant, emin = TC.STOCHASTIC_TARGETS[dtype]
    got = _encode(_stochastic_value(u, r, mant, emin), dtype)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # every path was taken: the normal range, below it with k <= 31, the
    # 64-bit add (31 < k <= 63) and k > 63
    mag = u & 0x7FFFFFFF
    big_e = mag >> 23
    k = (23 - mant) + emin - (torch.clamp_min(big_e, 1) - 127)
    finite = mag < 0x7F800000
    below = finite & (big_e < emin + 127)
    assert bool((finite & ~below).any())
    for lo, hi in ((24 - mant, 31), (32, 63), (64, 1000)):
        assert bool((below & (k >= lo) & (k <= hi)).any()), (lo, hi)
