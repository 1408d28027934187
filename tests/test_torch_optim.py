"""The port's AdamW (accl_tpu_torch/optim.py) and the optimizer path of
its ``make_train_step`` against ``optax.adamw`` and the JAX package's
optax path (accl_tpu/models/transformer.py:450-537).

AdamW: the same random trees and gradients through ``optax.adamw`` and
the port's, three updates.  optax runs under jit, where XLA's CPU
compiler fuses (1 - b1) g + b1 mu into one FMA; the port rounds the two
products apart, as optax's formula reads.  So each moment is held to
within 4 ulp of the running scale of its terms, S_mu = |(1 - b1) g| + b1
S_mu' (S_mu' the last step's; for nu the same with g^2): the rounding of
a two-term sum, carried over three steps.  Each update is held to within
8 ulp of lr (S_mu / (1 - b1^t) / (sqrt(nu_hat) + eps) + wd |p|): the
error of mu, as the update divides it.  The gradients shrink tenfold a
step, so an error carried from a larger step shows against a smaller
one.  Readings: mu 2, nu 1-2, updates 3-4 ulp.

The train step: both packages start from the same mid-run state, the
JAX package's parameters and ``optax.adamw`` state after one
single-device step, carried across by ``model_params_from_jax`` and
``adamw_state_from_optax``.  One more step over dp 2 x tp 2 is held to
JAX's optax mesh step and to JAX's single-device step at
tests/test_model.py:168-208's tolerances: loss rtol 1e-5, parameters
rtol 2e-4 / atol 2e-5; the moments at the same tolerances; a second
port step lowers the loss.  Attention is dense, as the JAX mesh step's
reference on the CPU (tests/test_torch_train.py says why); the flash
configuration is held to the single-device step only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

import accl_tpu.models.transformer as JT
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import (adamw_state_from_optax, adamw_state_to_numpy,
                            model_params_from_jax, model_params_to_numpy)
from accl_tpu_torch import optim
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.parallel import make_mesh
from accl_tpu_torch.utils.tree import tree_leaves, tree_map

LR = 1e-2
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
FLASH = dict(attn="flash", n_kv_heads=2, mlp="swiglu", rope=True)
MOMENT_ULP, UPDATE_ULP = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# AdamW against optax.adamw
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "blocks": [{"a": (rng.standard_normal(100) * scale).astype(
                np.float32)} for _ in range(2)]}


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  tree)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.numpy() for t in tree_leaves(tree)]


def _ulps(got, want, scale):
    return float(np.max(np.abs(got.astype(np.float64) - want)
                        / np.spacing(np.float32(scale).astype(np.float32))))


@pytest.mark.parametrize("kw", [{}, dict(b1=0.8, b2=0.99, eps=1e-6,
                                         weight_decay=0.05, eps_root=1e-9)],
                         ids=["defaults", "custom"])
def test_adamw_matches_optax_over_three_updates(kw):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jopt = optax.adamw(LR, **kw)
    topt = optim.adamw(LR, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jst = jopt.init(jp)
    tp = _torch_tree(p0)
    tst = topt.init(tp)
    assert int(tst.count) == 0 and tst.count.dtype == torch.int32
    b1, b2 = topt.b1, topt.b2
    jupdate = jax.jit(jopt.update)
    worst = {"mu": 0.0, "nu": 0.0, "update": 0.0}
    s_mu = s_nu = [0.0] * len(_leaves(jp))
    for step in range(1, 4):
        g = _tree(rng, scale=10.0 ** -step)
        pj = _leaves(jp)
        s_mu = [np.abs((1 - b1) * gi) + b1 * s for gi, s in
                zip(_leaves(g), s_mu)]
        s_nu = [(1 - b2) * gi * gi + b2 * s for gi, s in
                zip(_leaves(g), s_nu)]
        jup, jst = jupdate(jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tst = topt.update(_torch_tree(g), tst, tp)
        optim.apply_updates(tp, tup)
        assert int(tst.count) == step == int(jst[0].count)
        bc1, bc2 = 1 - np.float32(b1) ** step, 1 - np.float32(b2) ** step
        for sm, sn, p, mu, nu, jm, jn, ju, tu in zip(
                s_mu, s_nu, pj, _tleaves(tst.mu), _tleaves(tst.nu),
                _leaves(jst[0].mu), _leaves(jst[0].nu), _leaves(jup),
                _tleaves(tup)):
            worst["mu"] = max(worst["mu"], _ulps(mu, jm, sm))
            worst["nu"] = max(worst["nu"], _ulps(nu, jn, sn))
            nu_hat = jn / bc2
            s_u = LR * (sm / bc1 / (np.sqrt(nu_hat + topt.eps_root)
                                    + topt.eps)
                        + topt.weight_decay * np.abs(p))
            worst["update"] = max(worst["update"], _ulps(tu, ju, s_u))
    assert worst["mu"] <= MOMENT_ULP and worst["nu"] <= MOMENT_ULP, worst
    assert worst["update"] <= UPDATE_ULP, worst
    for a, b in zip(_leaves(jp), _tleaves(tp)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_apply_updates_is_in_place():
    p = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    got = optim.apply_updates(p, {"a": torch.full((3,), 2.0),
                                  "b": [torch.ones(2)]})
    assert got is p
    assert p["a"].tolist() == [3.0] * 3 and p["b"][0].tolist() == [1.0] * 2


# ---------------------------------------------------------------------------
# the carried state
# ---------------------------------------------------------------------------
def _cfgs(**kw):
    return JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)


def _setup(jcfg, seed=1):
    params = JT.init_params(np.random.default_rng(seed), jcfg)
    tokens = np.random.default_rng(seed + 1).integers(
        0, BASE["vocab"], size=(B, T)).astype(np.int32)
    return params, tokens


def _jax_single(params, state, tokens, cfg, opt):
    """tests/test_model.py's single-device optax step."""
    def stp(p, s, t):
        (ls, c), g = jax.value_and_grad(
            lambda pp: JT.loss_fn(pp, t, cfg), has_aux=True)(p)
        gm = jax.tree_util.tree_map(lambda x: x / jnp.maximum(c, 1.0), g)
        up, s2 = opt.update(gm, s, p)
        return optax.apply_updates(p, up), s2, ls / jnp.maximum(c, 1.0)

    return jax.jit(stp)(params, state, jnp.asarray(tokens))


_MID = {}


def _mid(name, **kw):
    """The JAX package's parameters and optax.adamw state after one
    single-device step from the seeded weights (cached)."""
    if name not in _MID:
        jcfg, _ = _cfgs(**kw)
        params, tokens = _setup(jcfg)
        opt = optax.adamw(LR)
        p1, s1, _loss = _jax_single(params, opt.init(params), tokens, jcfg,
                                    opt)
        _MID[name] = (_np(p1), _np(s1), tokens)
    return _MID[name]


def test_adamw_state_round_trips_from_optax():
    jcfg, tcfg = _cfgs()
    p1, s1, _ = _mid("dense")
    for tp in (1, 2):
        st = adamw_state_from_optax(s1, tcfg, tp=tp, device="cpu")
        assert isinstance(st, optim.AdamWState)
        assert st.count.dtype == torch.int32 and int(st.count) == 1
        assert TT.tp_size(st.mu) == tp
        back = adamw_state_to_numpy(st, tcfg)
        assert back["count"] == 1
        for name in ("mu", "nu"):
            for a, b in zip(jax.tree_util.tree_leaves(getattr(s1[0], name)),
                            jax.tree_util.tree_leaves(back[name])):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="count, mu and nu"):
        adamw_state_from_optax((optax.EmptyState(),), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# make_train_step(optimizer=...)
# ---------------------------------------------------------------------------
def _port_opt_step(p_np, s_np, tokens, cfg, axes, steps=1):
    mesh = make_mesh(**axes, device="cpu")
    tp = axes.get("tp", 1)
    p = model_params_from_jax(p_np, cfg, tp, device="cpu")
    st = adamw_state_from_optax(s_np, cfg, tp=tp, device="cpu")
    step, (specs, st_specs, tok_spec), init_opt = TT.make_train_step(
        mesh, cfg, optimizer=optim.adamw(LR), params=p)
    assert specs == TT.param_specs(cfg)
    assert st_specs == optim.AdamWState(None, specs, specs)
    assert tok_spec == ("dp" if "dp" in axes else None, None)
    fresh = init_opt(p)
    assert int(fresh.count) == 0 and TT.tp_size(fresh.mu) == tp
    losses = []
    for _ in range(steps):
        new_p, st, loss = step(p, st, torch.from_numpy(tokens))
        assert new_p is p  # updated in place
        losses.append(float(loss))
    return (model_params_to_numpy(p, cfg), adamw_state_to_numpy(st, cfg),
            losses)


def _hold(got, want_p, want_s, want_loss, what):
    gp, gs, losses = got
    np.testing.assert_allclose(losses[0], want_loss, rtol=1e-5,
                               err_msg=f"{what} loss")
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(gp),
                                   jax.tree_util.tree_leaves(want_p))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{what} leaf {i}")
    assert gs["count"] == int(want_s[0].count)
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(gs[name]),
                        jax.tree_util.tree_leaves(getattr(want_s[0], name))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{what} {name}")


def test_adamw_train_step_matches_jax_mesh_and_single_device():
    jcfg, tcfg = _cfgs()
    p1, s1, tokens = _mid("dense")
    axes = dict(dp=2, tp=2)
    got = _port_opt_step(p1, s1, tokens, tcfg, axes, steps=2)
    assert got[2][1] < got[2][0], got[2]  # a second step lowers the loss
    # JAX's optax path over the same mesh, from the same state
    opt = optax.adamw(LR)
    mesh = jax_make_mesh(**axes)
    step, (_specs, _st_specs, tok_spec), _init = JT.make_train_step(
        mesh, jcfg, optimizer=opt, params=p1)
    ps = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, p1), mesh,
                         jcfg)
    jst = jax.tree_util.tree_map(jnp.asarray, s1)
    mp, ms, mloss = step(ps, jst, jax.device_put(
        jnp.asarray(tokens), NamedSharding(mesh, tok_spec)))
    # the port's first step, held to both references
    one = _port_opt_step(p1, s1, tokens, tcfg, axes)
    _hold(one, _np(mp), _np(ms), float(mloss), "mesh")
    sp, ss, sloss = _jax_single(jax.tree_util.tree_map(jnp.asarray, p1),
                                jst, tokens, jcfg, opt)
    _hold(one, _np(sp), _np(ss), float(sloss), "single")


@pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2)], ids=str)
def test_adamw_train_step_matches_jax_on_one_axis(axes):
    jcfg, tcfg = _cfgs()
    p1, s1, tokens = _mid("dense")
    opt = optax.adamw(LR)
    sp, ss, sloss = _jax_single(jax.tree_util.tree_map(jnp.asarray, p1),
                                jax.tree_util.tree_map(jnp.asarray, s1),
                                tokens, jcfg, opt)
    _hold(_port_opt_step(p1, s1, tokens, tcfg, axes), _np(sp), _np(ss),
          float(sloss), str(axes))


def test_flash_adamw_train_step_matches_jax_single_device():
    jcfg, tcfg = _cfgs(**FLASH)
    p1, s1, tokens = _mid("flash", **FLASH)
    opt = optax.adamw(LR)
    sp, ss, sloss = _jax_single(jax.tree_util.tree_map(jnp.asarray, p1),
                                jax.tree_util.tree_map(jnp.asarray, s1),
                                tokens, jcfg, opt)
    _hold(_port_opt_step(p1, s1, tokens, tcfg, dict(dp=2, tp=2)), _np(sp),
          _np(ss), float(sloss), "flash")


def test_optimizer_without_params_raises_as_jax():
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError) as te:
        TT.make_train_step(make_mesh(dp=2, device="cpu"), tcfg,
                           optimizer=optim.adamw(LR))
    with pytest.raises(ValueError) as je:
        JT.make_train_step(jax_make_mesh(dp=2), jcfg,
                           optimizer=optax.adamw(LR))
    assert str(te.value) == str(je.value)
    assert "optimizer path needs `params`" in str(te.value)


def test_opt_state_specs_follow_any_optimizer():
    # any object with init/update: parameter-shaped nodes take the
    # parameters' specs, the rest is replicated
    _, tcfg = _cfgs()
    p = TT.init_params(np.random.default_rng(0), tcfg, tp=2, device="cpu")

    class Momentum:
        def init(self, params):
            return {"step": torch.zeros(()),
                    "trace": tree_map(torch.zeros_like, params)}

        def update(self, grads, state, params):
            return tree_map(lambda g: -0.1 * g, grads), state

    specs = TT.param_specs(tcfg)
    got = TT.opt_state_specs(Momentum(), p, specs)
    assert got == {"step": None, "trace": specs}
    step, (_s, st_specs, _t), init_opt = TT.make_train_step(
        make_mesh(tp=2, device="cpu"), tcfg, optimizer=Momentum(), params=p)
    assert st_specs == got
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, BASE["vocab"], (2, 8)))
    before = p["blocks"][0]["w1"][0].clone()
    p2, st, loss = step(p, init_opt(p), tokens)
    assert np.isfinite(float(loss))
    assert not torch.equal(p2["blocks"][0]["w1"][0], before)
    # and the dp/tp checks of the SGD step hold on this path too
    with pytest.raises(ValueError, match="does not split"):
        TT.make_train_step(make_mesh(dp=2, tp=2, device="cpu"), tcfg,
                           optimizer=Momentum(), params=p)[0](
            p, st, tokens[:1])
    zig = dataclasses.replace(tcfg, sp_schedule="zigzag")
    with pytest.raises(ValueError, match="zigzag"):
        TT.make_train_step(make_mesh(dp=2, device="cpu"), zig,
                           optimizer=Momentum(), params=p)
