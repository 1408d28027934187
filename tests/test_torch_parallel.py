"""The port's SPMD layer (accl_tpu_torch/parallel) against the JAX
package's (accl_tpu/parallel).

The JAX collectives run inside ``shard_map`` over 4 CPU devices (a 2 x 2
mesh for the hierarchical all-reduce), one member's block per device; the
port's take the same blocks as a rank list.  Values are small integers in
float32, so every sum is exact and the comparisons are bitwise.  The
dense attention reference is compared at rtol = atol = 1e-6 (float32,
different summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.parallel.collectives as JC
from accl_tpu.parallel.ring_attention import _dense_attention as j_dense
from accl_tpu.parallel.ring_attention import expand_gqa_kv as j_expand
from accl_tpu_torch import ACCLError
from accl_tpu_torch.parallel import collectives as TC
from accl_tpu_torch.parallel import mesh as TM
from accl_tpu_torch.parallel import ring_attention as TRA

NR = 4


def _blocks(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=(NR,) + shape).astype(np.float32)


def _jax_members(fn, x):
    """fn(member block) on each of NR devices (axis "rank") -> [NR, ...]."""
    mesh = Mesh(np.array(jax.devices()[:NR]), ("rank",))
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=Pspec("rank"), out_specs=Pspec("rank"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


CASES = {
    "all_reduce_sum": (lambda v: JC.all_reduce(v, "rank", "sum"),
                       lambda xs: TC.all_reduce(xs, "sum"), (6, 5)),
    "all_reduce_max": (lambda v: JC.all_reduce(v, "rank", "max"),
                       lambda xs: TC.all_reduce(xs, "max"), (6, 5)),
    "all_reduce_min": (lambda v: JC.all_reduce(v, "rank", "min"),
                       lambda xs: TC.all_reduce(xs, "min"), (6, 5)),
    "all_reduce_mean": (lambda v: JC.all_reduce(v, "rank", "mean"),
                        lambda xs: TC.all_reduce(xs, "mean"), (6, 5)),
    "reduce": (lambda v: JC.reduce(v, 2, "rank"),
               lambda xs: TC.reduce(xs, 2), (6, 5)),
    "all_gather_tiled_axis1": (lambda v: JC.all_gather(v, "rank", True, 1),
                               lambda xs: TC.all_gather(xs, True, 1), (6, 5)),
    "all_gather_untiled": (lambda v: JC.all_gather(v, "rank", False, 0),
                           lambda xs: TC.all_gather(xs, False, 0), (6, 5)),
    "reduce_scatter": (lambda v: JC.reduce_scatter(v, "rank", 0),
                       lambda xs: TC.reduce_scatter(xs, 0), (8, 5)),
    "reduce_scatter_axis1": (lambda v: JC.reduce_scatter(v, "rank", 1),
                             lambda xs: TC.reduce_scatter(xs, 1), (3, 8)),
    "all_to_all_tiled": (lambda v: JC.all_to_all(v, "rank", 0, 1, True),
                         lambda xs: TC.all_to_all(xs, 0, 1, True), (8, 3)),
    "all_to_all_untiled": (lambda v: JC.all_to_all(v, "rank", 1, 0, False),
                           lambda xs: TC.all_to_all(xs, 1, 0, False),
                           (3, NR, 2)),
    "broadcast": (lambda v: JC.broadcast(v, 1, "rank"),
                  lambda xs: TC.broadcast(xs, 1), (6, 5)),
    "scatter": (lambda v: JC.scatter(v, 3, "rank"),
                lambda xs: TC.scatter(xs, 3), (NR, 5)),
    "gather": (lambda v: JC.gather(v, 0, "rank"),
               lambda xs: TC.gather(xs, 0), (6, 5)),
    "ppermute": (lambda v: JC.ppermute(v, [(0, 2), (2, 1), (1, 0)], "rank"),
                 lambda xs: TC.ppermute(xs, [(0, 2), (2, 1), (1, 0)]),
                 (6, 5)),
    "send_recv": (lambda v: JC.send_recv(v, 3, 1, "rank"),
                  lambda xs: TC.send_recv(xs, 3, 1), (6, 5)),
    "ring_reduce_scatter": (lambda v: JC.ring_reduce_scatter(v, "rank"),
                            TC.ring_reduce_scatter, (NR * 3, 5)),
    "ring_all_gather": (lambda v: JC.ring_all_gather(v, "rank"),
                        TC.ring_all_gather, (3, 5)),
    "ring_all_reduce": (lambda v: JC.ring_all_reduce(v, "rank"),
                        TC.ring_all_reduce, (NR * 2, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_jax(name):
    jfn, tfn, shape = CASES[name]
    x = _blocks(shape, seed=len(name))
    want = _jax_members(jfn, x)
    got = tfn([torch.from_numpy(b) for b in x])
    assert len(got) == NR
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_barrier_and_hierarchical_all_reduce_match_jax():
    got = TC.barrier([torch.zeros(2)] * NR)
    want = _jax_members(lambda v: JC.barrier("rank"), _blocks((1,)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    x = _blocks((8, 3), seed=9).reshape(2, 2, 8, 3)  # [dcn, ici, ...]
    mesh = Mesh(np.array(jax.devices()[:NR]).reshape(2, 2), ("dcn", "ici"))
    f = jax.jit(jax.shard_map(
        lambda v: JC.hierarchical_all_reduce(v[0, 0], "ici", "dcn")[None,
                                                                     None],
        mesh=mesh, in_specs=Pspec("dcn", "ici"), out_specs=Pspec("dcn", "ici"),
        check_vma=False))
    want = np.asarray(f(jnp.asarray(x)))
    got = TC.hierarchical_all_reduce(
        [[torch.from_numpy(b) for b in row] for row in x])
    np.testing.assert_array_equal(
        np.stack([np.stack([g.numpy() for g in row]) for row in got]), want)


def test_mesh_config_and_make_mesh():
    cfg = TM.MeshConfig(dp=2, tp=4)
    assert cfg.axes() == {"dp": 2, "tp": 4} and cfg.num_devices == 8
    mesh = TM.make_mesh(dp=2, tp=4, device="cpu")
    assert mesh.axis_names == ("dp", "tp") and mesh.size == 8
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert TM.make_mesh(device="cpu").shape == {"dp": 1}
    assert TM.make_mesh(TM.MeshConfig(sp=2, tp=2), device="cpu").axis_names \
        == ("tp", "sp")
    with pytest.raises(ACCLError, match="make_hybrid_mesh"):
        TM.make_hybrid_mesh({"tp": 2}, {"dp": 2})


@pytest.mark.parametrize("causal,window,groups", [(False, None, 1),
                                                  (True, None, 2),
                                                  (True, 3, 4)])
def test_dense_attention_and_gqa_expansion_match_jax(causal, window, groups):
    rng = np.random.default_rng(21)
    B, T, H, D = 2, 12, 4, 8
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H // groups, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H // groups, D)).astype(np.float32)
    jk, jv = j_expand(jnp.asarray(k), jnp.asarray(v), H)
    tk, tv = TRA.expand_gqa_kv(torch.from_numpy(k), torch.from_numpy(v), H)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = j_dense(jnp.asarray(q), jk, jv, causal=causal, window=window)
    got = TRA._dense_attention(torch.from_numpy(q), tk, tv, causal=causal,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sequence_parallel_attention_raises():
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ACCLError, match="ring_attention"):
        TRA.ring_attention(x, x, x)
    with pytest.raises(ACCLError, match="ulysses_attention"):
        TRA.ulysses_attention(x, x, x)
