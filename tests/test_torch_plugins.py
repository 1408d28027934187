"""The port's plugin lanes (accl_tpu_torch/ops/reduce_ops.py and
compression.py) against the JAX package's (accl_tpu/ops/reduce_ops.py and
compression.py).

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_reduce_ops.py does; the port runs its plain PyTorch versions,
which the wrappers take for CPU tensors.  Inputs are the same numpy
arrays, made from a seed.  Every comparison is bitwise: both sides add,
take the max or round to nearest even once per element in the same type.
(JAX without x64 has no float64 or int64 lane; those are held to numpy.)

Stochastic rounding has no interpret rule in JAX ("MLIR translation rule
for primitive 'prng_seed' not found for platform cpu"), so the port's is
checked on its own: both neighbours are reached, every output is one of
the two, the mean is within 4 sigma of the input, and the bits depend on
the seed and on nothing else.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import accl_tpu.ops.compression as JC
import accl_tpu.ops.reduce_ops as JR
from accl_tpu_torch import ops as top
from accl_tpu_torch.ops import compression as TC
from accl_tpu_torch.ops import reduce_ops as TR

# bfloat16 crosses to numpy as ml_dtypes' type
NP = {"float32": np.float32, "int32": np.int32, "float16": np.float16,
      "bfloat16": ml_dtypes.bfloat16, "float64": np.float64,
      "int64": np.int64}
TDT = {"float32": torch.float32, "int32": torch.int32,
       "float16": torch.float16, "bfloat16": torch.bfloat16,
       "float64": torch.float64, "int64": torch.int64}


def _operands(seed, n, dt):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal(n) * 100 for _ in range(2))
    if dt in ("int32", "int64"):
        return a.astype(NP[dt]), b.astype(NP[dt])
    a, b = a.astype(np.float32).astype(NP[dt]), b.astype(np.float32).astype(
        NP[dt])
    a[:4] = b[:4]  # ties: max must keep a's value
    return a, b


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _bits(t):
    """A torch tensor's bits as a numpy integer array."""
    iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
          8: torch.int64}[t.element_size()]
    return t.contiguous().view(iv).numpy()


def _jbits(x):
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32,
                   8: np.int64}[x.dtype.itemsize])


@pytest.mark.parametrize("dt", ["float32", "int32", "float16", "bfloat16"])
@pytest.mark.parametrize("n,block_rows", [(1031, 8), (4096, 16), (1031, 0),
                                          (40000, 0)])
def test_combine_matches_jax_bitwise(dt, n, block_rows):
    a, b = _operands(n + block_rows, n, dt)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want_add = JR.pallas_add(ja, jb, interpret=True, block_rows=block_rows)
    want_max = JR.pallas_max(ja, jb, interpret=True)
    got_add = TR.pallas_add(_torch(a), _torch(b), block_rows=block_rows)
    got_max = TR.pallas_max(_torch(a), _torch(b))
    assert got_add.dtype == TDT[dt] and got_add.shape == (n,)
    np.testing.assert_array_equal(_bits(got_add), _jbits(want_add))
    np.testing.assert_array_equal(_bits(got_max), _jbits(want_max))


@pytest.mark.parametrize("dt", ["float64", "int64"])
def test_combine_wide_lanes(dt):
    a, b = _operands(3, 1031, dt)
    np.testing.assert_array_equal(
        TR.pallas_add(_torch(a), _torch(b), block_rows=8).numpy(), a + b)
    np.testing.assert_array_equal(TR.pallas_max(_torch(a), _torch(b)).numpy(),
                                  np.maximum(a, b))


def test_combine_keeps_shape_and_covers_every_arith_lane():
    from accl_tpu_torch.arithconfig import ARITH_LANE
    from accl_tpu_torch.constants import DataType

    names = {DataType.float32: "float32", DataType.float64: "float64",
             DataType.int32: "int32", DataType.int64: "int64",
             DataType.float16: "float16", DataType.bfloat16: "bfloat16"}
    assert len(ARITH_LANE) == 12
    for (dtype, fn) in ARITH_LANE:
        dt = TDT[names[dtype]]
        assert dt in TR.KERNEL_DTYPES
        a = torch.arange(35, dtype=dt).reshape(5, 7)
        b = torch.flip(a, [1])
        got = TR.reduce_lane(a, b, fn)
        want = a + b if fn == "sum" else torch.maximum(a, b)
        assert got.shape == (5, 7) and torch.equal(got, want)


def test_reduce_lane_dispatch_and_error():
    a, b = (_torch(x) for x in _operands(9, 300, "float32"))
    assert torch.equal(TR.reduce_lane(a, b, "sum"), TR.pallas_add(a, b))
    assert torch.equal(TR.reduce_lane(a, b, "max"), TR.pallas_max(a, b))
    assert torch.equal(TR.reduce_lane(a, b, "sum", use_pallas=False), a + b)
    assert torch.equal(TR.reduce_lane(a, b, "max", use_pallas=False),
                       torch.maximum(a, b))
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="unknown reduce op 'min'"):
            mod.reduce_lane(a if mod is TR else jnp.asarray(a.numpy()),
                            b if mod is TR else jnp.asarray(b.numpy()), "min")
    # the package exports, as accl_tpu.ops does
    assert top.pallas_add is TR.pallas_add and top.reduce_lane is \
        TR.reduce_lane and top.pallas_max is TR.pallas_max


@pytest.mark.parametrize("n", [4096, 1031])
def test_donate_writes_into_a(n):
    a, b = (_torch(x) for x in _operands(n, n, "float32"))
    want = a + b
    before = a.clone()
    got = TR.pallas_add(a, b, donate=True)
    assert got is a and torch.equal(a, want)
    # without donate the operand is untouched
    out = TR.pallas_add(before, b)
    assert torch.equal(out, want) and not torch.equal(before, want)
    # the 2-d core aliases operand 0 when asked
    a2, _ = TR._to_tiles(before.clone())
    b2, _ = TR._to_tiles(b)
    res = TR._pallas_combine_2d(a2, b2, donate=True)
    assert res is a2


def test_combine_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="one dtype"):
        TR._pallas_combine_2d(a, a.double())
    with pytest.raises(ValueError, match="rows, 128"):
        TR._pallas_combine_2d(a.view(8, 64), a.view(8, 64))
    with pytest.raises(ValueError, match="one dtype"):
        TR.pallas_add(a.to(torch.int8), a.to(torch.int8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TR._pallas_combine_2d(a.to("meta"), a.to("meta"))


def _cast_input(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    # overflow, inf, signed zero, fp16 subnormals and their rounding edge
    x[:9] = [70000.0, -np.inf, np.inf, -0.0, 1e-6, 3e-8, 6e-5, 65520.0,
             -2.0 ** -25]
    return x


@pytest.mark.parametrize("dt", ["float16", "bfloat16"])
@pytest.mark.parametrize("n", [1031, 2 * 512 * 3 + 7])
def test_casts_match_jax_bitwise(dt, n):
    x = _cast_input(n, n)
    jdt = jnp.float16 if dt == "float16" else jnp.bfloat16
    want = JC.compress_cast(jnp.asarray(x), jdt, interpret=True)
    got = TC.compress_cast(torch.from_numpy(x), TDT[dt])
    assert got.dtype == TDT[dt] and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _jbits(want))
    back_j = JC.decompress_cast(want, interpret=True)
    back_t = TC.decompress_cast(got)
    assert back_t.dtype == torch.float32
    np.testing.assert_array_equal(_bits(back_t), _jbits(back_j))
    # Tensor.to is the same rounding (and the package exports the lanes)
    assert torch.equal(got, torch.from_numpy(x).to(TDT[dt]))
    assert top.compress_cast is TC.compress_cast and \
        top.decompress_cast is TC.decompress_cast


def test_cast_block_rows_only_tiles():
    x = torch.from_numpy(_cast_input(8 * 512, 4)).view(8, 512)
    want = x.to(torch.bfloat16)
    for br in (1, 3, 8, 100):
        assert torch.equal(TC._cast_2d(x, 0, torch.bfloat16, False, br), want)
    # the tuning copy's geometries: any column count
    assert torch.equal(TC._cast_2d(x.view(32, 128), 0, torch.float16, False,
                                   16), x.view(32, 128).to(torch.float16))


def test_cast_pairs_and_stochastic_targets():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="stochastic_round"):
        TC.compress_cast(x, torch.float16, stochastic=True)
    with pytest.raises(ValueError, match="the lanes cast"):
        TC.compress_cast(x, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="the lanes cast"):
        TC.decompress_cast(x.double())
    for dt in TC.STOCHASTIC_TARGETS:
        y = TC.compress_cast(x, dt, stochastic=True, seed=1)
        assert y.dtype == dt and torch.equal(TC.decompress_cast(y), x)


@pytest.mark.parametrize("dt,x0", [(torch.bfloat16, 1 + 2.0 ** -12),
                                   (torch.float8_e5m2, 1 + 2.0 ** -4),
                                   (torch.float8_e4m3fn, 1 + 2.0 ** -5)])
def test_stochastic_rounding_is_unbiased_between_neighbours(dt, x0):
    ulp = 2.0 ** -TC.STOCHASTIC_TARGETS[dt][0]
    x = torch.full((4096,), x0)
    y = TC.compress_cast(x, dt, stochastic=True, seed=5).float()
    # both ways, and nothing else
    assert set(torch.unique(y).tolist()) == {1.0, 1.0 + ulp}
    p = (x0 - 1) / ulp
    sigma = ulp * np.sqrt(p * (1 - p) / x.numel())
    assert abs(float(y.double().mean()) - x0) <= 4 * sigma


def test_stochastic_rounding_stays_between_neighbours_and_follows_seed():
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal(3 * 512 + 5) * 10).astype(
        np.float32))
    a = TC.compress_cast(x, torch.bfloat16, stochastic=True, seed=3)
    # the two bf16 neighbours of each input: truncated toward zero, and
    # one bf16 step further from zero
    down = x.view(torch.int32) & ~0xFFFF
    got = a.float().view(torch.int32)
    assert bool(((got == down) | (got == down + 0x10000)).all())
    assert bool((got == down + 0x10000).any() and (got == down).any())
    assert torch.equal(a, TC.compress_cast(x, torch.bfloat16, stochastic=True,
                                           seed=3))
    b = TC.compress_cast(x, torch.bfloat16, stochastic=True, seed=4)
    assert not torch.equal(a, b)
    # the seed is taken mod 2^32, as the kernel's unsigned argument
    assert torch.equal(a, TC.compress_cast(x, torch.bfloat16,
                                           stochastic=True, seed=3 + 2 ** 32))
    # tile t draws with seed + t: seed 4's first tile is seed 3's second
    bits3 = TC._random_bits(3, 4, 8, 2, "cpu")
    bits4 = TC._random_bits(4, 4, 8, 2, "cpu")
    assert torch.equal(bits3[2:4], bits4[0:2])
    assert int(bits3.min()) >= 0 and int(bits3.max()) < 2 ** 32
    assert len(set(bits3.flatten().tolist())) == 32


def test_stochastic_rounding_range_edges():
    x = torch.tensor([1e6, -1e6, np.inf, -np.inf, 1e-30, -1e-30, 0.0, -0.0,
                      3.0e38, 2.0 ** -130])
    e4 = TC.compress_cast(x, torch.float8_e4m3fn, stochastic=True).float()
    assert e4[:4].tolist() == [448.0, -448.0, 448.0, -448.0]
    e5 = TC.compress_cast(x, torch.float8_e5m2, stochastic=True).float()
    assert e5[:4].tolist() == [np.inf, -np.inf, np.inf, -np.inf]
    bf = TC.compress_cast(x, torch.bfloat16, stochastic=True).float()
    assert bf[2:4].tolist() == [np.inf, -np.inf]
    for y in (e4, e5, bf):
        # tiny values round to 0 or to the least step, with their sign
        assert bool((y[4] >= 0) & (y[5] <= 0))
        assert torch.equal(torch.signbit(y[6:8]), torch.tensor([False, True]))
    # an fp32 subnormal exact in bf16 (2^-130 = 8 2^-133) stays exact
    assert bf[9].item() == 2.0 ** -130
