"""The port's Mixture-of-Experts family (accl_tpu_torch/models/moe.py,
moe_decode.py, ops/fused.py ``fused_expert_ffn``) against the JAX
package's (accl_tpu/models/moe.py, moe_decode.py, ops/fused.py), case for
case with tests/test_model_moe.py and tests/test_decode.py's MoE cases:
the dense forward, the expert-parallel forward (unfused and fused), the
train step over dp x ep and its gradient against the dense full-batch
step, the ep-extent check, and teacher-forced decode, dense and ep.

The JAX side runs as those tests run it: ``shard_map`` over the virtual
CPU devices of tests/conftest.py.  The port runs on CPU tensors with the
ep members as lists.  Parameters and tokens come from numpy seeds (the
seeds of the JAX tests, which avoid router ties).

Tolerances: logits rtol = atol = 2e-4 (tests/test_model_moe.py) and
decode 3e-5 (tests/test_decode.py); updated parameters rtol 2e-4 / atol
2e-5 (tests/test_model_moe.py); the routing (experts, slots, capacity
drops), the fused lane against dispatch -> FFN -> combine and the trace
rows exact.
"""
import functools
import signal
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as Pspec

import accl_tpu.models.moe as JM
import accl_tpu.models.moe_decode as JMD
import accl_tpu.ops.fused as jfused
import accl_tpu.ops.ring as jring
from accl_tpu.observability import trace as jtrace
from accl_tpu.parallel import expert_combine as jax_combine
from accl_tpu.parallel import expert_dispatch as jax_dispatch
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import moe_params_from_jax, moe_params_to_numpy
from accl_tpu_torch.models import moe as TM
from accl_tpu_torch.models import moe_decode as TMD
from accl_tpu_torch.observability import trace as obs_trace
from accl_tpu_torch.ops import fused as tfused
from accl_tpu_torch.ops import ring as tring
from accl_tpu_torch.parallel import expert_combine, expert_dispatch, \
    make_mesh

BASE = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, d_head=16,
            d_ff=64, n_experts=4, capacity_factor=4.0)
DECODE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64, n_experts=4)
FWD_TOL = 2e-4
DECODE_TOL = 3e-5
B_DEC, T_DEC = 2, 16
TEST_LIMIT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _limit():
    def expire(_signum, _frame):
        raise TimeoutError(f"test exceeded {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _cfgs(**kw):
    return JM.MoEConfig(**kw), TM.MoEConfig(**kw)


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], (b, t))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(jparams, tcfg, ep):
    return moe_params_from_jax(_np(jparams), tcfg, ep, device="cpu")


def _jax_ep_forward(params, tokens, cfg, fused=False):
    mesh = jax_make_mesh(ep=4)
    fn = jax.jit(jax.shard_map(
        lambda p, t: JM.forward(p, t, cfg, ep_axis="ep", fused=fused)[0],
        mesh=mesh, in_specs=(JM.param_specs(cfg, "ep"), Pspec("ep")),
        out_specs=Pspec("ep")))
    return np.asarray(fn(JM.shard_params(params, mesh, cfg),
                         jnp.asarray(tokens)))


def test_init_and_state_roundtrip_match_jax():
    jcfg, tcfg = _cfgs(**BASE)
    jparams = _np(JM.init_params(np.random.default_rng(0), jcfg))
    for ep in (1, 2, 4):
        tp = TM.init_params(np.random.default_rng(0), tcfg, ep=ep,
                            device="cpu")
        assert TM.ep_size(tp) == ep
        assert all(len(blk["we1"]) == ep for blk in tp["blocks"])
        back = moe_params_to_numpy(tp, tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(a, b)
        again = moe_params_to_numpy(_port_params(jparams, tcfg, ep), tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(again),
                        jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        TM.shard_params(tp, tcfg, 3)


def test_dense_forward_matches_jax():
    jcfg, tcfg = _cfgs(**BASE)
    jparams = JM.init_params(np.random.default_rng(0), jcfg)
    tokens = _tokens(2, 16, 0)
    want, want_aux = JM.forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = TM.forward(_port_params(jparams, tcfg, 1),
                          torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 16, tcfg.vocab) and np.isfinite(float(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_routing_matches_jax():
    # the router's expert choice and gate on the same inputs: the expert
    # indices exact (argmax ties break to the first in both)
    jcfg, tcfg = _cfgs(**BASE)
    jparams = JM.init_params(np.random.default_rng(0), jcfg)
    blk = _port_params(jparams, tcfg, 1)["blocks"][0]
    x = np.random.default_rng(9).standard_normal((64, 32)).astype(np.float32)
    idx, gate, aux, _onehot = TM._route(torch.from_numpy(x), blk, tcfg)
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x),
                        jparams["blocks"][0]["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jnp.argmax(probs, axis=-1)))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jnp.max(probs, -1)),
                               rtol=1e-6)


@pytest.mark.parametrize("capacity", [16, 5])
def test_expert_dispatch_slotting_matches_jax(capacity):
    # the one-hot cumsum slotting and the capacity drops, bitwise: each
    # expert scales its tokens by (e + 1)
    EP, N, D = 4, 16, 8
    xs = np.random.default_rng(14).standard_normal((EP, N, D)).astype(
        np.float32)
    assign = np.random.default_rng(15).integers(0, EP, (EP, N))
    mesh = jax_make_mesh(ep=EP)

    def body(xb, ab):
        r = jax.lax.axis_index("ep")
        inp, info = jax_dispatch(xb[0], ab[0], axis="ep", capacity=capacity)
        return inp[None], jax_combine(inp * (r + 1).astype(jnp.float32),
                                      info, axis="ep")[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(Pspec("ep"), Pspec("ep")),
                              out_specs=(Pspec("ep"), Pspec("ep"))))
    j_inp, j_out = (np.asarray(a) for a in f(jnp.asarray(xs),
                                              jnp.asarray(assign)))
    t_xs = [torch.from_numpy(x) for x in xs]
    t_idx = [torch.from_numpy(a) for a in assign]
    inp, info = expert_dispatch(t_xs, t_idx, capacity=capacity)
    out = expert_combine([t * (r + 1) for r, t in enumerate(inp)], info)
    np.testing.assert_array_equal(np.stack([t.numpy() for t in inp]), j_inp)
    np.testing.assert_array_equal(np.stack([t.numpy() for t in out]), j_out)
    fused = tfused.fused_expert_ffn(
        t_xs, t_idx, [functools.partial(torch.mul, other=float(r + 1))
                      for r in range(EP)], capacity=capacity, chunks=2)
    for a, b in zip(fused, out):
        assert torch.equal(a, b)


def _expert_ffns(EP, D, F, seed):
    g = np.random.default_rng(seed)
    w1 = g.standard_normal((EP, D, F)).astype(np.float32) * 0.3
    w2 = g.standard_normal((EP, F, D)).astype(np.float32) * 0.3
    ffns = [functools.partial(TM._expert, w1=torch.from_numpy(w1[r]),
                              w2=torch.from_numpy(w2[r])) for r in range(EP)]
    return w1, w2, ffns


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("capacity", [0, 3])
def test_fused_expert_ffn_bitwise_and_matches_jax(chunks, capacity):
    # the chunked lane is dispatch -> FFN -> combine bit for bit, and the
    # JAX package's fused_expert_ffn within the logit bound
    EP, N, D, F = 4, 12, 8, 16
    xs = np.random.default_rng(21).standard_normal((EP, N, D)).astype(
        np.float32)
    assign = np.random.default_rng(22).integers(0, EP, (EP, N))
    w1, w2, ffns = _expert_ffns(EP, D, F, 23)
    t_xs = [torch.from_numpy(x) for x in xs]
    t_idx = [torch.from_numpy(a) for a in assign]
    got = tfused.fused_expert_ffn(t_xs, t_idx, ffns, capacity=capacity,
                                  chunks=chunks)
    inp, info = expert_dispatch(t_xs, t_idx, capacity=capacity)
    want = expert_combine([f(t) for f, t in zip(ffns, inp)], info)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    mesh = jax_make_mesh(ep=EP)

    def body(xb, ab, w1b, w2b):
        ffn = (lambda t: jnp.einsum("nf,fd->nd", jax.nn.gelu(jnp.einsum(
            "nd,df->nf", t, w1b[0])), w2b[0]))
        return jfused.fused_expert_ffn(xb[0], ab[0], ffn, "ep",
                                       capacity=capacity,
                                       chunks=chunks)[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(Pspec("ep"),) * 4,
                              out_specs=Pspec("ep")))
    jout = np.asarray(f(*map(jnp.asarray, (xs, assign, w1, w2))))
    np.testing.assert_allclose(np.stack([t.numpy() for t in got]), jout,
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_expert_ffn_trace_rows_match_jax(monkeypatch):
    # ACCL_DEVICE_TRACE: one stamp row per (step, chunk) slot and member,
    # the JAX package's records exactly
    monkeypatch.setenv("ACCL_DEVICE_TRACE", "1")
    jring._reset_device_trace_cache()
    tring._reset_device_trace_cache()
    jtrace.collector().clear()
    obs_trace.collector().clear()
    try:
        EP, N, D = 4, 8, 8
        xs = np.random.default_rng(31).standard_normal((EP, N, D)).astype(
            np.float32)
        assign = np.random.default_rng(32).integers(0, EP, (EP, N))
        f = jax.jit(jax.shard_map(
            lambda xb, ab: jfused.fused_expert_ffn(
                xb[0], ab[0], lambda t: t * 2.0, "ep", chunks=2)[None],
            mesh=jax_make_mesh(ep=EP), in_specs=(Pspec("ep"),) * 2,
            out_specs=Pspec("ep"), check_vma=False))
        # wait for the result, then for the stamp rows' debug callbacks,
        # which can land after the result is ready
        jax.block_until_ready(f(jnp.asarray(xs), jnp.asarray(assign)))
        jax.effects_barrier()
        tfused.fused_expert_ffn([torch.from_numpy(x) for x in xs],
                                [torch.from_numpy(a) for a in assign],
                                lambda t: t * 2.0, chunks=2)

        def records(col):
            return Counter((r["collective"], tuple(map(tuple, r["rows"])))
                           for r in col.device_records())

        jrec, trec = records(jtrace.collector()), records(obs_trace.collector())
        assert sum(jrec.values()) == EP
        assert trec == jrec
    finally:
        monkeypatch.delenv("ACCL_DEVICE_TRACE")
        jring._reset_device_trace_cache()
        tring._reset_device_trace_cache()
        jtrace.collector().clear()
        obs_trace.collector().clear()


@pytest.mark.parametrize("fused", [False, True])
def test_ep_matches_dense_and_jax(fused):
    # the ep-routed FFN (all-to-all dispatch and combine, or the fused
    # lane) agrees with the run-every-expert reference given the
    # capacity, and with the JAX package's ep forward
    jcfg, tcfg = _cfgs(**BASE)
    jparams = JM.init_params(np.random.default_rng(0), jcfg)
    tokens = _tokens(4, 16, 2)
    dense, _aux = TM.forward(_port_params(jparams, tcfg, 1),
                             torch.from_numpy(tokens), tcfg)
    got, aux = TM.forward(_port_params(jparams, tcfg, 4),
                          torch.from_numpy(tokens), tcfg, ep=4, fused=fused)
    assert len(aux) == 4
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _jax_ep_forward(jparams, tokens, jcfg, fused),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_forward_bitwise_equals_unfused():
    _, tcfg = _cfgs(**{**BASE, "capacity_factor": 1.25})
    params = TM.init_params(np.random.default_rng(5), tcfg, ep=4,
                            device="cpu")
    tokens = torch.from_numpy(_tokens(8, 16, 6))
    a, aux_a = TM.forward(params, tokens, tcfg, ep=4)
    b, aux_b = TM.forward(params, tokens, tcfg, ep=4, fused=True)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(aux_a, aux_b))


def test_moe_train_step_loss_decreases():
    _, tcfg = _cfgs(**BASE)
    params = TM.init_params(np.random.default_rng(0), tcfg, ep=4,
                            device="cpu")
    step, (specs, tok_spec) = TM.make_train_step(
        make_mesh(dp=2, ep=4, device="cpu"), tcfg, lr=1e-2)
    assert tok_spec == (("dp", "ep"),) and specs == TM.param_specs(tcfg)
    tokens = torch.from_numpy(_tokens(8, 16, 3))
    losses = []
    for _ in range(5):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("fused", [False, True])
def test_moe_grad_matches_dense_full_batch(fused):
    # the distributed step's gradient equals the dense single-device
    # full-batch gradient (not the mesh size times it), and the JAX
    # package's dp x ep step
    lr = 1e-2
    jcfg, tcfg = _cfgs(**BASE)
    jparams = JM.init_params(np.random.default_rng(0), jcfg)
    tokens = _tokens(8, 16, 4)
    (_ls, cnt), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jnp.asarray(tokens), jcfg, None),
        has_aux=True)(jparams)
    ref = _np(jax.tree_util.tree_map(lambda p, g: p - (lr / cnt) * g,
                                     jparams, grads))
    mesh = jax_make_mesh(dp=2, ep=4)
    jstep, (_s, jtok) = JM.make_train_step(mesh, jcfg, lr=lr)
    jnew, jloss = jstep(JM.shard_params(jparams, mesh, jcfg),
                        jax.device_put(jnp.asarray(tokens),
                                       NamedSharding(mesh, jtok)))
    step, _ = TM.make_train_step(make_mesh(dp=2, ep=4, device="cpu"), tcfg,
                                 lr=lr, fused=fused)
    new, loss = step(_port_params(jparams, tcfg, 4), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = moe_params_to_numpy(new, tcfg)
    for want in (ref, _np(jnew)):
        for (path, a), (_p, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                       err_msg=str(path))


def test_moe_ep_size_mismatch_raises():
    jcfg, tcfg = _cfgs(**BASE)
    with pytest.raises(ValueError) as te:
        TM.make_train_step(make_mesh(ep=2, device="cpu"), tcfg)
    with pytest.raises(ValueError) as je:
        JM.make_train_step(jax_make_mesh(ep=2), jcfg)
    assert str(te.value) == str(je.value)
    step, _ = TM.make_train_step(make_mesh(ep=4, device="cpu"), tcfg)
    params = TM.init_params(np.random.default_rng(0), tcfg, ep=2,
                            device="cpu")
    with pytest.raises(ValueError, match="split over 2"):
        step(params, torch.zeros((4, 8), dtype=torch.long))


def test_moe_teacher_forced_decode_matches_forward():
    # cached decode reproduces forward position by position, router
    # decisions included; both held to the JAX package's forward
    jcfg, tcfg = _cfgs(**DECODE)
    jparams = JM.init_params(np.random.default_rng(11), jcfg)
    tokens = np.random.default_rng(12).integers(
        0, jcfg.vocab, size=(B_DEC, T_DEC), dtype=np.int32)
    want = np.asarray(JM.forward(jparams, jnp.asarray(tokens), jcfg)[0])
    params = _port_params(jparams, tcfg, 1)
    toks = torch.from_numpy(tokens).long()
    mine = TM.forward(params, toks, tcfg)[0].numpy()
    np.testing.assert_allclose(mine, want, rtol=DECODE_TOL, atol=DECODE_TOL)
    cache = TMD.init_kv_cache(tcfg, B_DEC, T_DEC, device="cpu")
    lg, _aux, cache = TMD.prefill(params, toks[:, :8], cache, tcfg)
    np.testing.assert_allclose(lg.numpy(), want[:, :8], rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    for t in range(8, T_DEC):
        lg, cache = TMD.decode_step(params, toks[:, t], cache, tcfg)
        np.testing.assert_allclose(lg.numpy(), want[:, t], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"t={t}")
    assert cache["pos"] == T_DEC
    jcache = JMD.init_kv_cache(jcfg, B_DEC, T_DEC)
    _jl, _ja, jcache = JMD.prefill(jparams, jnp.asarray(tokens), jcache,
                                   jcfg)
    for jl, tl in zip(jcache["layers"], cache["layers"]):
        np.testing.assert_allclose(tl["k"].numpy(), np.asarray(jl["k"]),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    with pytest.raises(ValueError, match="past cache capacity"):
        TMD.prefill(params, toks[:, :1], cache, tcfg)


def test_moe_decode_expert_parallel_matches_dense():
    # decode under ep (the tokens split over the members) matches
    # the dense reference: the serving capacity makes the dispatch
    # drop-free where the training formula would zero tokens out
    jcfg, tcfg = _cfgs(**DECODE)
    jparams = JM.init_params(np.random.default_rng(13), jcfg)
    tokens = np.random.default_rng(14).integers(
        0, jcfg.vocab, size=(B_DEC, 12), dtype=np.int32)
    want = np.asarray(JM.forward(jparams, jnp.asarray(tokens), jcfg)[0])
    params = _port_params(jparams, tcfg, 4)
    toks = torch.from_numpy(tokens).long()
    cache = TMD.init_kv_cache(tcfg, B_DEC, 12, device="cpu")
    lg, aux, cache = TMD.prefill(params, toks[:, :6], cache, tcfg, ep=4)
    assert np.isfinite(float(aux))
    # the aux is the whole batch's, as the dense prefill reports it
    _lg, aux_dense, _c = TMD.prefill(
        _port_params(jparams, tcfg, 1), toks[:, :6],
        TMD.init_kv_cache(tcfg, B_DEC, 12, device="cpu"), tcfg)
    np.testing.assert_allclose(float(aux), float(aux_dense), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    np.testing.assert_allclose(lg.numpy(), want[:, :6], rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    for t in range(6, 12):
        lg, cache = TMD.decode_step(params, toks[:, t], cache, tcfg, ep=4)
        np.testing.assert_allclose(lg.numpy(), want[:, t], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"t={t}")
