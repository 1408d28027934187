"""The port's int8 block-scaled quantized collectives
(accl_tpu_torch/ops/quantized.py) against the JAX package's
(accl_tpu/ops/quantized.py).

The JAX ring entries run as tests/test_quantized.py runs them:
``shard_map`` over a 4-device CPU mesh.  Inputs are the same numpy
arrays, made from a seed.

Tolerance: bitwise for deterministic rounding against the compiled JAX
functions (jit), which is how the JAX engine and ``shard_map`` run them:
the scale absmax * f32(1/127) (XLA's rewrite of ``amax / 127.0``),
x / scale, round half to even, clip and the int8 cast are the same
float32 operations in torch and XLA, the ring folds in the same order,
and the fold ``dequantize + chunk`` and the error-feedback residual
round once, as the FMAs XLA contracts them into.  Against eager jnp, which divides by 127, the scale is within one
ulp (ROADMAP.md Queue 3).
Stochastic rounding draws from a torch.Generator, not JAX's PRNG, so it
is held to the error bound and unbiasedness of
tests/test_quantized.py, not to bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

from accl_tpu.ops import quantized as jq
from accl_tpu_torch.ops import quantized as tq

NR = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(n, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _jax_per_rank(fn, d):
    """Run fn(per-rank flat block) under shard_map; d is [NR, n]."""
    mesh = Mesh(np.array(jax.devices()[:NR]), ("r",))
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=Pspec("r"), out_specs=Pspec("r"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(d)))


def _ranks(d):
    return [torch.from_numpy(np.ascontiguousarray(d[r])) for r in range(NR)]


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("n", [1, 31, 256, 300, 1000])
def test_quantize_dequantize_bitwise_vs_jax(block, n):
    x = _rand(n, seed=n + block, scale=3.0)
    x[: min(n, block)] = 0.0  # an all-zero block (scale 1)
    if n > 2 * block:
        x[-5:] = 1e-30  # tiny values in the ragged last block
    qj, sj = jax.jit(lambda v: jq.quantize_blockwise(v, block)[:2])(
        jnp.asarray(x))
    qt, st, nt = tq.quantize_blockwise(torch.from_numpy(x), block)
    assert nt == n
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = np.asarray(jax.jit(lambda q, s: jq.dequantize_blockwise(q, s, n))(
        qj, sj))
    dt = tq.dequantize_blockwise(qt, st, n).numpy()
    np.testing.assert_array_equal(dt, dj)
    # a second roundtrip (the engine's entry and exit hops) stays equal
    rt = jax.jit(lambda v: jq.dequantize_blockwise(
        *jq.quantize_blockwise(v, block)[:2], n))
    q2, s2, _ = tq.quantize_blockwise(torch.from_numpy(dt), block)
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(q2, s2, n).numpy(), np.asarray(rt(dj)))


def test_scale_within_one_ulp_of_eager_jnp():
    x = _rand(4096, seed=1, scale=3.0)
    _, sj, _ = jq.quantize_blockwise(jnp.asarray(x), 32)  # eager: divides
    _, st, _ = tq.quantize_blockwise(torch.from_numpy(x), 32)
    sj = np.asarray(sj)
    np.testing.assert_array_less(np.abs(st.numpy() - sj),
                                 np.spacing(sj) * 1.0001)


def test_round_half_to_even_like_jnp_round():
    # r = x / scale lands exactly on .5 ties: 127 sets the scale to 1
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                 np.float32)
    qj, _, _ = jq.quantize_blockwise(jnp.asarray(x), 8)
    qt, _, _ = tq.quantize_blockwise(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.numpy().reshape(-1).tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("block", [32, 256])
def test_quantized_ring_entries_bitwise_vs_jax(ef, block):
    n = 200  # per-rank chunk, ragged against both blocks
    d = np.stack([_rand(NR * n, seed=40 + r) for r in range(NR)])
    ts = _ranks(d)

    want = _jax_per_rank(lambda v: jq.quantized_all_reduce(
        v, "r", block=block, error_feedback=ef), d)
    got = tq.quantized_all_reduce(ts, block, ef)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])

    want = _jax_per_rank(lambda v: jq.quantized_ring_reduce_scatter(
        v, "r", block=block, error_feedback=ef), d)
    got = tq.quantized_ring_reduce_scatter(ts, block, ef)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])

    ag = d[:, :n]
    want = _jax_per_rank(lambda v: jq.quantized_ring_all_gather(
        v, "r", block=block), ag)
    got = tq.quantized_ring_all_gather(_ranks(ag), block)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_error_feedback_changes_the_bits_within_the_bound():
    n = 256
    d = np.stack([_rand(NR * n, seed=60 + r) for r in range(NR)])
    exact = d.sum(axis=0)
    atol = NR * (2 * 5 * np.sqrt(NR) / 127)
    got_ef = tq.quantized_all_reduce(_ranks(d), error_feedback=True)
    got = tq.quantized_all_reduce(_ranks(d), error_feedback=False)
    for r in range(NR):
        np.testing.assert_allclose(got_ef[r].numpy(), exact, atol=atol)
    assert not np.array_equal(got_ef[0].numpy(), got[0].numpy())


def test_ragged_payload_raises():
    with pytest.raises(ValueError, match="divisible"):
        tq.quantized_ring_reduce_scatter(
            [torch.ones(NR * 8 + 1) for _ in range(NR)])


def test_stochastic_rounding_within_one_step_and_unbiased():
    x = torch.from_numpy(_rand(512, seed=9))
    g = tq.hop_generator(0, 0, 0, x.device)
    q, sc, n = tq.quantize_blockwise(x, generator=g)
    y = tq.dequantize_blockwise(q, sc, n)
    step = float(sc.max())
    assert torch.all((y - x).abs() <= step + 1e-6)
    q2, _, _ = tq.quantize_blockwise(
        x, generator=tq.hop_generator(1, 0, 0, x.device))
    assert not torch.equal(q, q2)
    # unbiased: the mean of many draws approaches x (each draw's error is
    # in [-step, step] with mean 0; 400 draws shrink it ~20x)
    draws = torch.stack([tq.dequantize_blockwise(*tq.quantize_blockwise(
        x, generator=tq.hop_generator(s, 0, 0, x.device))) for s in
        range(400)])
    assert float((draws.mean(0) - x).abs().max()) < 0.25 * step
    # the deterministic lane has no such freedom: its bias stays put
    det = tq.dequantize_blockwise(*tq.quantize_blockwise(x))
    assert float((det - x).abs().max()) <= 0.5 * step + 1e-6


@pytest.mark.parametrize("ef", [False, True])
def test_stochastic_ring_within_the_bound_and_seeded(ef):
    n = 256
    d = np.stack([_rand(NR * n, seed=80 + r) for r in range(NR)])
    exact = d.sum(axis=0)
    # one full step per hop instead of half: twice the deterministic bound
    atol = 2 * NR * (2 * 5 * np.sqrt(NR) / 127)
    a = tq.quantized_all_reduce(_ranks(d), error_feedback=ef,
                                stochastic=True, seed=3)
    b = tq.quantized_all_reduce(_ranks(d), error_feedback=ef,
                                stochastic=True, seed=3)
    c = tq.quantized_all_reduce(_ranks(d), error_feedback=ef,
                                stochastic=True, seed=4)
    for r in range(NR):
        np.testing.assert_allclose(a[r].numpy(), exact, atol=atol)
        np.testing.assert_array_equal(a[r].numpy(), b[r].numpy())
    assert not np.array_equal(a[0].numpy(), c[0].numpy())
    ag = tq.quantized_ring_all_gather(_ranks(d[:, :n]), stochastic=True,
                                      seed=5)
    np.testing.assert_allclose(ag[1].numpy(), d[:, :n].reshape(-1),
                               atol=2 * 5 / 127)
