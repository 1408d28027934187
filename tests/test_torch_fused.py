"""The port's fused compute/communication (accl_tpu_torch/ops/fused.py)
against the JAX package's (accl_tpu/ops/fused.py).

The JAX functions run as tests/test_fused_overlap.py and
tests/test_pallas_ops.py run them on the CPU: ``shard_map`` over a
4-device CPU mesh, the Pallas kernels in interpret mode.  The port runs
its plain PyTorch versions, which its kernel wrappers take for CPU
tensors.  Inputs are the same numpy arrays, made from a seed.

Tolerances:
- bitwise for the chunked ring lanes (fp32 SUM folds ``local +
  incoming`` in the ring's order; MAX and data movement are exact; the
  int8 wire lane shares ops/quantized.py's arithmetic, bitwise against
  the compiled JAX program);
- bitwise for the matmuls on integer-valued inputs small enough that
  every product and partial sum is exact in fp32;
- rtol=1e-5, atol=1e-5 on standard-normal inputs (K <= 128): both sides
  accumulate in fp32, in different orders (XLA's dot against torch's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.ops.fused as JF
from accl_tpu.models.transformer import ModelConfig, param_specs
from accl_tpu_torch import ACCLError, tp_weight_shards
from accl_tpu_torch.ops import fused as TF
from accl_tpu_torch.ops import ring as tring

NR = 4
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mesh():
    return Mesh(np.array(jax.devices()[:NR]), ("r",))


def _jax_per_rank(fn, *arrays):
    """Run fn(*per-rank blocks) under shard_map; each array is [NR, ...]
    and so is the result."""
    spec = Pspec("r")
    f = jax.jit(jax.shard_map(
        lambda *vs: fn(*(v[0] for v in vs))[None], mesh=_mesh(),
        in_specs=(spec,) * len(arrays), out_specs=spec, check_vma=False))
    return np.asarray(f(*(jnp.asarray(a) for a in arrays)))


def _ranks(d):
    return [torch.from_numpy(np.ascontiguousarray(d[r])) for r in range(NR)]


def _rand(shape, seed, ints=False):
    rng = np.random.default_rng(seed)
    if ints:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _assert_ranks(got, want, exact=True):
    for r in range(NR):
        g = got[r].numpy()
        if exact:
            np.testing.assert_array_equal(g, want[r])
        else:
            np.testing.assert_allclose(g, want[r], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# tier 1: the chunked ring lane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_chunked_ring_bitwise_vs_jax(op, C):
    # ragged: 4 * 93 elements — 93 is prime to 4, so the all-reduce pads
    # and the reduce-scatter/all-gather pick a smaller chunk count
    n = 93
    d = _rand((NR, NR * n), seed=10 + C)
    want = _jax_per_rank(lambda v: JF.chunked_ring_all_reduce(
        v, "r", op=op, chunks=C), d)
    _assert_ranks(TF.chunked_ring_all_reduce(_ranks(d), op, chunks=C), want)
    want = _jax_per_rank(lambda v: JF.chunked_ring_reduce_scatter(
        v, "r", op=op, chunks=C), d)
    _assert_ranks(TF.chunked_ring_reduce_scatter(_ranks(d), op, chunks=C),
                  want)
    ag = d[:, :n]
    want = _jax_per_rank(lambda v: JF.chunked_ring_all_gather(
        v, "r", chunks=C), ag)
    _assert_ranks(TF.chunked_ring_all_gather(_ranks(ag), chunks=C), want)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_chunked_ring_equals_the_ring_lane_when_the_payload_divides(op, C):
    N = NR * C * 16
    d = _rand((NR, N), seed=20 + C)
    fused = TF.chunked_ring_all_reduce(_ranks(d), op, chunks=C)
    ringed = tring.ring_all_reduce(_ranks(d), op)
    for a, b in zip(fused, ringed):
        assert torch.equal(a, b)
    rs = TF.chunked_ring_reduce_scatter(_ranks(d), op, chunks=C)
    rr = tring.ring_reduce_scatter([x.view(NR, -1) for x in _ranks(d)], op)
    for a, b in zip(rs, rr):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("C,block", [(1, 256), (3, 32), (4, 32), (4, 256)])
def test_chunked_ring_int8_wire_bitwise_vs_jax(ef, C, block):
    n = 96 if C != 3 else 90  # divides into C chunks of a ragged block
    d = _rand((NR, NR * n), seed=30 + C)
    w = (block, ef)
    want = _jax_per_rank(lambda v: JF.chunked_ring_all_reduce(
        v, "r", chunks=C, wire=w), d)
    _assert_ranks(TF.chunked_ring_all_reduce(_ranks(d), chunks=C, wire=w),
                  want)
    want = _jax_per_rank(lambda v: JF.chunked_ring_reduce_scatter(
        v, "r", chunks=C, wire=w), d)
    _assert_ranks(TF.chunked_ring_reduce_scatter(_ranks(d), chunks=C,
                                                 wire=w), want)
    ag = d[:, :n]
    want = _jax_per_rank(lambda v: JF.chunked_ring_all_gather(
        v, "r", chunks=C, wire=w), ag)
    _assert_ranks(TF.chunked_ring_all_gather(_ranks(ag), chunks=C, wire=w),
                  want)


def test_int8_wire_refuses_max():
    xs = [torch.ones(NR * 8) for _ in range(NR)]
    with pytest.raises(ValueError, match="max"):
        TF.chunked_ring_all_reduce(xs, "max", wire=(32, False))


def test_chunk_helpers_match_jax(monkeypatch):
    assert TF.DEFAULT_FUSED_CHUNKS == JF.DEFAULT_FUSED_CHUNKS
    for n in (0, 1, 7, 12, 96, 97):
        for req in (1, 3, 4, 8):
            assert TF._pick_chunks(n, req) == JF._pick_chunks(n, req)
    monkeypatch.setenv("ACCL_FUSED_CHUNKS", "6")
    TF._reset_fused_chunks_cache()
    try:
        assert TF.fused_chunks() == 6
        monkeypatch.setenv("ACCL_FUSED_CHUNKS", "2")
        assert TF.fused_chunks() == 6  # read once
        monkeypatch.delenv("ACCL_FUSED_CHUNKS")
        TF._reset_fused_chunks_cache()
        assert TF.fused_chunks() == TF.DEFAULT_FUSED_CHUNKS
    finally:
        TF._reset_fused_chunks_cache()


# ---------------------------------------------------------------------------
# tier 2: pallas_matmul and fused_matmul_allreduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("shape", [(64, 128, 256), (37, 45, 70)])
def test_pallas_matmul_vs_jax(ints, shape):
    m, k, n = shape
    x, w = _rand((m, k), 1, ints), _rand((k, n), 2, ints)
    want = np.asarray(JF.pallas_matmul(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = TF.pallas_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    if ints:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pallas_matmul_bf16_vs_jax():
    xt = torch.from_numpy(_rand((64, 96), 3)).to(torch.bfloat16)
    wt = torch.from_numpy(_rand((96, 128), 4)).to(torch.bfloat16)
    # the same bf16 values on both sides
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    wj = jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(JF.pallas_matmul(xj, wj, interpret=True))
    got = TF.pallas_matmul(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("chunks", [None, 4])
@pytest.mark.parametrize("ints", [True, False])
def test_fused_matmul_allreduce_vs_jax(use_pallas, chunks, ints):
    M, K, N = 40, 32, 64  # M ragged against P * chunks = 16
    x, w = _rand((NR, M, K), 5, ints), _rand((NR, K, N), 6, ints)
    want = _jax_per_rank(lambda a, b: JF.fused_matmul_allreduce(
        a, b, axis="r", use_pallas=use_pallas, interpret=True,
        chunks=chunks), x, w)
    got = TF.fused_matmul_allreduce(_ranks(x), _ranks(w),
                                    use_pallas=use_pallas, chunks=chunks)
    _assert_ranks(got, want, exact=ints)
    ref = np.einsum("rmk,rkn->mn", x.astype(np.float64), w)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# tier 3: fused matmul reduce-scatter and its allreduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ints", [True, False])
def test_fused_matmul_reduce_scatter_vs_pallas(ints):
    m, K, N = 32, 48, 128
    x, w = _rand((NR, NR, m, K), 7, ints), _rand((NR, K, N), 8, ints)
    want = _jax_per_rank(lambda a, b: JF.fused_matmul_reduce_scatter_pallas(
        a, b, axis="r", interpret=True), x, w)
    got = TF.fused_matmul_reduce_scatter(_ranks(x), _ranks(w))
    _assert_ranks(got, want, exact=ints)


@pytest.mark.parametrize("ints", [True, False])
def test_fused_matmul_allreduce_pallas_vs_pallas(ints):
    M, K, N = 128, 32, 128
    x, w = _rand((NR, M, K), 9, ints), _rand((NR, K, N), 10, ints)
    want = _jax_per_rank(lambda a, b: JF.fused_matmul_allreduce_pallas(
        a, b, axis="r", interpret=True), x, w)
    got = TF.fused_matmul_allreduce_pallas(_ranks(x), _ranks(w))
    _assert_ranks(got, want, exact=ints)
    ref = np.einsum("rmk,rkn->mn", x.astype(np.float64), w)
    np.testing.assert_allclose(got[2].numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fused_wrappers_refuse_bad_operands():
    x = [torch.ones(NR, 4, 8) for _ in range(NR)]
    w = [torch.ones(8, 16) for _ in range(NR)]
    with pytest.raises(ValueError, match=r"\[P=4"):
        TF.fused_matmul_reduce_scatter([t[:3] for t in x], w)
    with pytest.raises(ValueError, match="share device"):
        TF.fused_matmul_reduce_scatter(x, [t.double() for t in w])
    with pytest.raises(ValueError, match="chain"):
        TF.pallas_matmul(torch.ones(4, 8), torch.ones(7, 2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TF.pallas_matmul(torch.ones(4, 8, device="meta"),
                         torch.ones(8, 2, device="meta"))
    with pytest.raises(ValueError, match="divide"):
        TF.fused_matmul_allreduce_pallas([torch.ones(6, 8)] * NR, w)
    with pytest.raises(ACCLError, match="fused_expert_ffn"):
        TF.fused_expert_ffn(None, None, None)


def test_cpu_tensors_take_plain_versions_without_launch():
    before = (TF.pallas_matmul.launches,
              TF.fused_matmul_reduce_scatter.launches,
              tring.ring_all_gather.launches)
    x = _ranks(_rand((NR, 16, 8), 11, ints=True))
    w = _ranks(_rand((NR, 8, 12), 12, ints=True))
    TF.fused_matmul_allreduce_pallas(x, w)
    TF.fused_matmul_allreduce(x, w, chunks=4)
    TF.fused_matmul_allreduce(x, w)
    assert (TF.pallas_matmul.launches,
            TF.fused_matmul_reduce_scatter.launches,
            tring.ring_all_gather.launches) == before == (0, 0, 0)


# ---------------------------------------------------------------------------
# weight shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,shape", [("w2", (64, 24)),
                                        ("wo", (8, 16, 24))])
def test_tp_weight_shards_match_param_specs(name, shape):
    spec = param_specs(ModelConfig(n_layers=1))["blocks"][0][name]
    mesh = Mesh(np.array(jax.devices()[:NR]), ("tp",))
    w = _rand(shape, 13)
    arr = jax.device_put(jnp.asarray(w), NamedSharding(mesh, spec))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    shards = tp_weight_shards(w, NR, device="cpu")
    for r, dev in enumerate(mesh.devices):
        want = by_dev[dev].reshape(-1, shape[-1])
        np.testing.assert_array_equal(shards[r].numpy(), want)
        assert shards[r].is_contiguous()


def test_tp_weight_shards_refuse_uneven_k():
    with pytest.raises(ValueError, match="divide"):
        tp_weight_shards(np.zeros((10, 3), np.float32), NR, device="cpu")
