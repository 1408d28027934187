"""The port's parallelism strategies (accl_tpu_torch/parallel/strategies.py)
and EF-convergence lane (accl_tpu_torch/bench/ef_convergence.py) against
the JAX package's (accl_tpu/parallel/strategies.py,
accl_tpu/bench/ef_convergence.py).

The JAX side runs each function under ``shard_map`` over the virtual CPU
devices of tests/conftest.py, as tests/test_parallel_strategies.py and
tests/test_quantized.py do; the port takes the same numpy inputs as one
tensor per member.  Tolerances: 1e-6 on float32 sums over the members
(XLA's psum adds in another order), rtol 1e-5 / atol 1e-4 on the
tensor-parallel products (float32 dot products whose outputs reach ~60),
bitwise where no sum is reordered (the expert routing and the
deterministic int8 lane, which mirrors the compiled JAX arithmetic;
ROADMAP.md Queue 3).  The
stochastic int8 lane draws other random numbers than JAX's and is held
to the int8 error bound of tests/test_quantized.py.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import accl_tpu.parallel.strategies as JS
from accl_tpu.bench import ef_convergence as JE
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch.bench import ef_convergence as TE
from accl_tpu_torch.parallel import strategies as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _smap(body, axis, n, in_specs, out_specs):
    return jax.jit(jax.shard_map(body, mesh=jax_make_mesh(**{axis: n}),
                                 in_specs=in_specs, out_specs=out_specs))


def _members(a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


@pytest.mark.parametrize("compress,mean,ef", [
    (None, True, False), (None, False, False), ("bf16", True, False),
    ("f16", True, False), ("int8", True, False), ("int8", True, True)])
def test_sync_gradients_matches_jax(compress, mean, ef):
    DP = 8
    w, b = _rand((DP, 8, 33), 30), _rand((DP, 5), 31)

    def body(wb, bb):
        out = JS.sync_gradients({"w": wb[0], "b": bb[0]}, "dp",
                                compress=compress, mean=mean,
                                error_feedback=ef)
        return out["w"][None], out["b"][None]

    jw, jb = _smap(body, "dp", DP, (P("dp", None, None), P("dp", None)),
                   (P("dp", None, None), P("dp", None)))(w, b)
    got = TS.sync_gradients([{"w": x, "b": y} for x, y in
                             zip(_members(w), _members(b))],
                            compress=compress, mean=mean, error_feedback=ef)
    assert len(got) == DP
    for r in range(DP):
        for key, want in (("w", np.asarray(jw)[r]), ("b", np.asarray(jb)[r])):
            if compress == "int8":
                np.testing.assert_array_equal(got[r][key].numpy(), want)
            else:
                np.testing.assert_allclose(got[r][key].numpy(), want,
                                           rtol=1e-6, atol=1e-6)


def test_sync_gradients_stochastic_int8_within_bound():
    DP, n = 4, 1000
    g = _rand((DP, n), 32)
    exact = g.mean(axis=0)
    got = TS.sync_gradients(_members(g), compress="int8", stochastic=True,
                            seed=3)
    det = TS.sync_gradients(_members(g), compress="int8")
    # tests/test_quantized.py's ring bound, on the mean
    bound = DP * (2 * 5 * np.sqrt(DP) / 127) / DP
    assert np.abs(got[0].numpy() - exact).max() <= bound
    assert not torch.equal(got[0], det[0])
    again = TS.sync_gradients(_members(g), compress="int8", stochastic=True,
                              seed=3)
    assert torch.equal(got[0], again[0])


def test_zero_shard_roundtrip_matches_jax():
    DP = 4
    g = _rand((DP, 30), 8)  # 30 is not a multiple of 4: the padding path

    def body(gb):
        shards = JS.zero_shard_gradients({"w": gb[0]}, "dp")
        full = JS.zero_unshard_params(shards, {"w": (30,)}, "dp")
        return shards["w"][None], full["w"][None]

    js, jf = _smap(body, "dp", DP, P("dp", None),
                   (P("dp", None), P("dp", None)))(g)
    shards = TS.zero_shard_gradients([{"w": x} for x in _members(g)])
    full = TS.zero_unshard_params(shards, {"w": (30,)})
    for r in range(DP):
        np.testing.assert_allclose(shards[r]["w"].numpy(), np.asarray(js)[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(full[r]["w"].numpy(),
                                      np.concatenate([s["w"].numpy()
                                                      for s in shards])[:30])
        np.testing.assert_allclose(full[r]["w"].numpy(), np.asarray(jf)[r],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gather", [False, True])
def test_tp_column_then_row_matches_jax(gather):
    TP, B, Din, Dmid, Dout = 4, 8, 32, 64, 16
    x = _rand((B, Din), 9)
    w1s = np.stack(np.split(_rand((Din, Dmid), 10), TP, axis=1))
    w2s = np.stack(np.split(_rand((Dmid, Dout), 11), TP, axis=0))

    def body(w1b, w2b):
        h = JS.column_parallel(jnp.asarray(x), w1b[0], axis="tp",
                               gather_output=gather)
        if gather:
            return h[None]
        return JS.row_parallel(jax.nn.relu(h), w2b[0], axis="tp")[None]

    want = np.asarray(_smap(body, "tp", TP, (P("tp", None, None),) * 2,
                            P("tp", None, None))(w1s, w2s))
    hs = TS.column_parallel([torch.from_numpy(x)] * TP, _members(w1s),
                            gather_output=gather)
    got = hs if gather else TS.row_parallel([torch.relu(h) for h in hs],
                                            _members(w2s))
    for r in range(TP):
        # float32 dot products of length 32 and 64 with |y| up to ~60
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-5,
                                   atol=1e-4)


def test_pipeline_matches_jax():
    PP, M, B, D = 4, 6, 4, 8
    ws = _rand((PP, D, D), 12) * 0.5
    xs = _rand((M, B, D), 13)

    def body(wb):
        return JS.pipeline_apply(lambda w, x: jnp.tanh(x @ w), wb[0],
                                 jnp.asarray(xs), axis="pp")[None]

    want = np.asarray(_smap(body, "pp", PP, P("pp", None, None),
                            P("pp", None, None, None))(ws))
    got = TS.pipeline_apply(lambda w, x: torch.tanh(x @ w), _members(ws),
                            torch.from_numpy(xs))
    for r in range(PP):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-6,
                                   atol=1e-6)
    assert not got[0].any() and got[PP - 1].any()


@pytest.mark.parametrize("capacity", [0, 3])
def test_moe_dispatch_combine_matches_jax(capacity):
    EP, N, D = 4, 16, 8
    xs = _rand((EP, N, D), 14)
    assign = np.random.default_rng(15).integers(0, EP, (EP, N)).astype(
        np.int32)

    def body(xb, ab):
        inp, info = JS.expert_dispatch(xb[0], ab[0], axis="ep",
                                       capacity=capacity)
        rank = jax.lax.axis_index("ep").astype(jnp.float32)
        out = JS.expert_combine(inp * (rank + 1), info, axis="ep")
        return inp[None], out[None]

    j_in, j_out = _smap(body, "ep", EP, (P("ep", None, None), P("ep", None)),
                        (P("ep", None, None), P("ep", None, None)))(xs, assign)
    inp, infos = TS.expert_dispatch(_members(xs), _members(assign),
                                    capacity=capacity)
    out = TS.expert_combine([y * (r + 1) for r, y in enumerate(inp)], infos)
    for r in range(EP):
        np.testing.assert_array_equal(inp[r].numpy(), np.asarray(j_in)[r])
        np.testing.assert_array_equal(out[r].numpy(), np.asarray(j_out)[r])


def test_ef_convergence_tracks_jax_and_fp32(tmp_path):
    """Four steps at dp = 4: the port's fp32 trajectory within 1e-5 of the
    JAX package's, and every quantized lane within TRACK_TOL of fp32.  The
    JAX side runs its fp32 lane only: its int8 lanes' ppermute rings
    inside fori_loop can stall XLA's CPU collectives (ROADMAP.md Queue
    3)."""
    want = JE.run_ef_convergence(io.StringIO(), steps=4, dp=4,
                                 lanes=("fp32",))
    buf = io.StringIO()
    got = TE.run_ef_convergence(buf, steps=4, dp=4, device="cpu")
    assert TE.TRACK_TOL == JE.TRACK_TOL
    np.testing.assert_allclose(got["final"]["fp32"], want["final"]["fp32"],
                               rtol=1e-5)
    traj = got["trajectories"]
    assert traj["fp32"][-1] < traj["fp32"][0]
    for lane in ("int8", "int8_ef"):
        assert got[f"{lane}_mean_abs_dev"] <= TE.TRACK_TOL, got
    assert buf.getvalue().splitlines()[0] == "step,fp32,int8,int8_ef"
    path = tmp_path / "ef.md"
    TE.write_summary_md(str(path), got, "ef.csv")
    assert "gate (PASS)" in path.read_text()
