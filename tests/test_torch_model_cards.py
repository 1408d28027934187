"""Model meshes over several cards on the CPU: ``make_mesh(devices=)``,
the collectives, strategies, models, serving path, ring attention and
MoE with their members on per-card lists, and the cross-card mode of
the fused matmul reduce-scatter kernel.

- ``devices=["cpu"] * P`` takes the several-cards code path on the CPU
  (the convention of tests/test_torch_multicard.py): every crossing from
  one member to another goes through ``parallel.collectives.move``.  On
  the CPU every member's device is ``cpu``, so a function that skipped a
  move would still compute the same numbers: each test also holds the
  count of moves to the count it states.
- Every function of the per-card form is held bitwise to the port's
  one-card form (the same function with every member on one device and
  no ``devices``), and the models and the fused kernel's plain version
  to the JAX package: the transformer's forward and serving path within
  tests/test_torch_model.py's 3e-5, its SGD and AdamW steps within
  tests/test_torch_train.py's and tests/test_torch_optim.py's
  tolerances against the JAX single-device step (the JAX CPU mesh step
  is unsound for the flash steps, ROADMAP Queue 3), the MoE forward
  within tests/test_torch_moe.py's 2e-4 against the JAX ep mesh, ring
  attention within tests/test_torch_ring_attention.py's 2e-4 against
  the JAX rings under ``shard_map``, the fused reduce-scatter exactly
  (integer data) against the Pallas kernel in interpret mode.
- The JAX grid: ``make_mesh(devices=)`` lays its slots over the device
  list as ``accl_tpu/parallel/mesh.py`` does.
- A replay of the cross-card fused kernel's per-card stripe schedule
  under adversarial delivery (csrc/fused.cu
  ``fused_matmul_rs_cross_kernel``): cards start their next launch the
  moment their last one ended; no landing slot is overwritten before it
  is read, no landing is read from another launch, no flag count is
  lost; a dropped or one-sided entry handshake is caught.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as Pspec

import accl_tpu.models.decode as JD
import accl_tpu.models.moe as JM
import accl_tpu.models.transformer as JT
import accl_tpu.ops.fused as JF
from accl_tpu.parallel import ring_attention as jax_ring
from accl_tpu.parallel import ulysses_attention as jax_ulysses
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import (
    ACCLError,
    model_params_from_jax,
    model_params_to_numpy,
    moe_params_from_jax,
    moe_params_to_numpy,
)
from accl_tpu_torch import optim as TO
from accl_tpu_torch.models import decode as TD
from accl_tpu_torch.models import moe as TMO
from accl_tpu_torch.models import moe_decode as TMD
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.ops import fused as TF
from accl_tpu_torch.ops import ring as tring
from accl_tpu_torch.parallel import collectives as TC
from accl_tpu_torch.parallel import mesh as tmesh
from accl_tpu_torch.parallel import strategies as TS
from accl_tpu_torch.parallel import make_hybrid_mesh, make_mesh
from accl_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ulysses_attention,
                                                     zigzag_indices)
from accl_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FUSED_CU = ROOT / "accl_tpu_torch" / "ops" / "csrc" / "fused.cu"
LR = 0.05
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
FLASH = dict(attn="flash", n_kv_heads=2, mlp="swiglu", rope=True)
MODEL_TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpus(n):
    return ["cpu"] * n


def _counted(fn):
    """fn()'s result and the moves it made."""
    TC.reset_moves()
    out = fn()
    return out, TC.moves()


def _same(a, b):
    """Bitwise equal: tensors, or lists / tuples of them."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ints(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -3, 4, shape).astype(np.float32))


def _fake_cards(monkeypatch):
    """Cards resolved and peer-checked as on a host that has them."""
    monkeypatch.setattr(tmesh, "resolve_devices",
                        lambda devs, n, what: [torch.device(d)
                                               for d in list(devs)[:n]])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axes", [dict(tp=4), dict(dp=2, tp=4),
                                  dict(dp=2, tp=2, sp=2), dict(ep=4),
                                  dict(dp=2, ep=4)], ids=str)
def test_make_mesh_lays_slots_over_the_list_like_jax(axes, monkeypatch):
    _fake_cards(monkeypatch)
    n = int(np.prod(list(axes.values())))
    want = jax_make_mesh(devices=jax.devices()[:n], **axes)
    got = make_mesh(devices=[f"cuda:{i}" for i in range(n)], **axes)
    assert got.axis_names == tuple(want.axis_names)
    assert got.sizes == tuple(want.devices.shape)
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.index)(got.device_grid),
        np.vectorize(lambda d: d.id)(want.devices))
    for s in range(n):
        coords = dict(zip(got.axis_names, np.unravel_index(s, got.sizes)))
        assert got.slot(**coords) == s
        assert got.slot_device(s) == torch.device(f"cuda:{s}")


def test_make_mesh_on_cpu_lists_and_its_refusals(monkeypatch):
    cpu = make_mesh(dp=2, tp=2, devices=_cpus(5))
    assert cpu.devices == (torch.device("cpu"),) * 4
    assert cpu.device == torch.device("cpu")
    assert cpu.device_grid.shape == (2, 2)
    one = make_mesh(dp=2, tp=2, device="cpu")
    assert one.devices is None and one.slot_device(3) == one.device
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 2"):
        make_mesh(dp=2, tp=4, devices=_cpus(2))
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 2"):
        jax_make_mesh(dp=2, tp=4, devices=jax.devices()[:2])
    with pytest.raises(ACCLError, match="every rank's device must be"):
        make_mesh(tp=2, devices=["cpu", "cuda:0"])
    monkeypatch.setattr(tmesh, "resolve_devices",
                        lambda devs, n, what: [torch.device(d)
                                               for d in list(devs)[:n]])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {0, 1})
    with pytest.raises(ACCLError, match="cuda:0 has no peer access to "
                                        "cuda:1"):
        make_mesh(tp=4, devices=["cuda:2", "cuda:0", "cuda:1", "cuda:3"])
    with pytest.raises(ACCLError, match="no peer access"):
        make_hybrid_mesh({"tp": 2}, {"dp": 1}, devices=["cuda:0", "cuda:1"])
    # one card may hold several slots
    assert make_mesh(tp=2, devices=["cuda:0"] * 2).devices == \
        (torch.device("cuda:0"),) * 2


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _members(P, seed=0, shape=(8, 6)):
    return [_ints((P * shape[0],) + shape[1:], seed + r) for r in range(P)]


#: name -> (call on members xs, moves at P members)
COLLECTIVES = {
    "all_reduce_sum": (lambda xs, **kw: TC.all_reduce(xs, **kw),
                       lambda P: 2 * (P - 1)),
    "all_reduce_max": (lambda xs, **kw: TC.all_reduce(xs, "max", **kw),
                       lambda P: 2 * (P - 1)),
    "all_reduce_mean": (lambda xs, **kw: TC.all_reduce(xs, "mean", **kw),
                        lambda P: 2 * (P - 1)),
    "reduce": (lambda xs, **kw: TC.reduce(xs, 1, **kw),
               lambda P: 2 * (P - 1)),
    "all_gather": (lambda xs, **kw: TC.all_gather(xs, **kw),
                   lambda P: P * (P - 1)),
    "all_gather_stacked": (lambda xs, **kw: TC.all_gather(
        xs, tiled=False, gather_axis=1, **kw), lambda P: P * (P - 1)),
    "reduce_scatter": (lambda xs, **kw: TC.reduce_scatter(xs, **kw),
                       lambda P: P * (P - 1)),
    "all_to_all": (lambda xs, **kw: TC.all_to_all(xs, **kw),
                   lambda P: P * (P - 1)),
    "all_to_all_stacked": (lambda xs, **kw: TC.all_to_all(
        [x.reshape(len(xs), -1) for x in xs], tiled=False, **kw),
        lambda P: P * (P - 1)),
    "broadcast": (lambda xs, **kw: TC.broadcast(xs, 1, **kw),
                  lambda P: P - 1),
    "scatter": (lambda xs, **kw: TC.scatter(
        [x.reshape(len(xs), -1) for x in xs], 0, **kw), lambda P: P - 1),
    "gather": (lambda xs, **kw: TC.gather(xs, 0, **kw),
               lambda P: P * (P - 1)),
    "ppermute": (lambda xs, **kw: TC.ppermute(
        xs, [(i, (i + 1) % len(xs)) for i in range(len(xs))], **kw),
        lambda P: P),
    "send_recv": (lambda xs, **kw: TC.send_recv(xs, 0, len(xs) - 1, **kw),
                  lambda P: 1),
    "barrier": (lambda xs, **kw: TC.barrier(xs, **kw),
                lambda P: 2 * (P - 1)),
    "ring_all_reduce": (lambda xs, **kw: TC.ring_all_reduce(xs),
                        lambda P: 0),
}


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_per_card_is_the_one_card_form(name, P):
    fn, moves = COLLECTIVES[name]
    xs = _members(P)
    one = fn(xs)
    got, n = _counted(lambda: fn(xs, devices=_cpus(P)))
    assert _same(got, one), name
    assert n == moves(P), (name, n)
    assert all(g.device == torch.device("cpu") for g in got)


def test_hierarchical_all_reduce_per_card():
    xs = [[_ints((8, 3), 10 * d + i) for i in range(2)] for d in range(3)]
    one = TC.hierarchical_all_reduce(xs)
    got, n = _counted(lambda: TC.hierarchical_all_reduce(
        xs, devices=[_cpus(2)] * 3))
    assert _same(got, one)
    # reduce-scatters 3 x 2, all-reduces 2 x 4, all-gathers 3 x 2
    assert n == 3 * 2 + 2 * 4 + 3 * 2


def _jax_members(fn, x):
    P = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:P]), ("r",))
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=Pspec("r"), out_specs=Pspec("r")))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("name,jfn", [
    ("all_reduce_sum", lambda v: jax.lax.psum(v, "r")),
    ("all_gather", lambda v: jax.lax.all_gather(v, "r", tiled=True)),
    ("reduce_scatter", lambda v: jax.lax.psum_scatter(
        v, "r", scatter_dimension=0, tiled=True)),
    ("all_to_all", lambda v: jax.lax.all_to_all(v, "r", 0, 0, tiled=True)),
])
def test_collective_per_card_matches_jax(name, jfn):
    P = 4
    xs = _members(P, seed=5)
    got = COLLECTIVES[name][0](xs, devices=_cpus(P))
    want = _jax_members(jfn, torch.stack(xs).numpy())
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def _chain_moves(P, cards=None):
    """fan_out's backward crossings ("chain"): the fold crosses wherever
    the next rank (walking down from the last) lies on another card, then
    the fold goes back along the distinct cards, one move a card after
    the first.  ``cards[r]``: rank r's card (default: its own)."""
    cards = list(range(P)) if cards is None else cards
    return (sum(cards[r] != cards[r - 1] for r in range(1, P))
            + len(set(cards)) - 1)


def test_fan_out_and_fan_in_fold_in_fixed_order():
    """fan_out's backward folds every use's gradient, the last use of the
    last member first, along the cards, and every member's copy gets the
    fold; fan_in sums in member order; both count."""
    x = torch.arange(6.0)
    copies = [x.clone().requires_grad_(True) for _ in range(3)]
    outs, n = _counted(lambda: TC.fan_out(copies, uses=2))
    assert n == 0 and len(outs) == 6
    assert all(o.data_ptr() == copies[i // 2].data_ptr()
               for i, o in enumerate(outs))
    loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
    TC.reset_moves()
    loss.backward()
    # the fold crosses to members 1 and 0, then goes back to 1 and 2
    assert TC.moves() == _chain_moves(3) == 4
    assert all(torch.equal(c.grad, torch.full((6,), 21.0)) for c in copies)
    parts = [_ints((4,), s) for s in range(3)]
    got, n = _counted(lambda: TC.fan_in(parts, "cpu"))
    assert n == 2 and torch.equal(got, TC.all_reduce(parts)[0])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gather_sum_is_fan_in_on_every_card(dt):
    """gather_sum: every member's part on the cards of ``at`` by the ring
    all-gather, each sum fan_in's bits; every sum carries a gradient, and
    each part takes that of the sum on its own card (``homes``), with no
    crossing: a psum's backward."""
    g = torch.Generator().manual_seed(5)
    base = [torch.randn(3, 8, generator=g).to(dt) for _ in range(4)]
    want = TC.fan_in(base, "cpu")
    parts = [b.clone().requires_grad_(True) for b in base]
    homes = (0, 0, 1, 2)  # members 0 and 1 share the first card
    sums, n = _counted(lambda: TC.gather_sum(parts, (0, 2, 3), homes))
    assert n == 0 and len(sums) == 3
    assert all(_same(s_, want) for s_ in sums)
    assert all(s_.requires_grad for s_ in sums)
    ups = [torch.randn(3, 8, generator=g).to(dt) for _ in sums]
    TC.reset_moves()
    sum((s_ * u).sum() for s_, u in zip(sums, ups)).backward()
    assert TC.moves() == 0
    assert all(torch.equal(p_.grad, ups[h]) for p_, h in zip(parts, homes))


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------
def _grads(P, seed=0):
    return [{"a": _ints((6, 4), seed + r), "b": [_ints((5,), seed + 9 + r)]}
            for r in range(P)]


@pytest.mark.parametrize("compress", [None, "bf16", "f16", "int8"])
@pytest.mark.parametrize("P", [2, 4])
def test_sync_gradients_per_card(compress, P):
    gs = _grads(P)
    one = TS.sync_gradients(gs, compress=compress)
    got, n = _counted(lambda: TS.sync_gradients(gs, compress=compress,
                                                devices=_cpus(P)))
    for r in range(P):
        assert _same(tree_leaves(got[r]), tree_leaves(one[r]))
    # two leaves, each folded on member 0 and sent back; the int8 lane is
    # a ring across the members' cards: 2 (P - 1) hops, each member
    # receiving an int8 payload and its scales a hop
    assert n == 2 * (4 * P * (P - 1) if compress == "int8" else 2 * (P - 1))


def test_zero_shard_and_unshard_per_card():
    P = 4
    gs = _grads(P, 3)
    one = TS.zero_shard_gradients(gs)
    got, n = _counted(lambda: TS.zero_shard_gradients(gs,
                                                      devices=_cpus(P)))
    assert all(_same(tree_leaves(a), tree_leaves(b))
               for a, b in zip(got, one))
    assert n == 2 * P * (P - 1)
    shapes = {"a": (6, 4), "b": [(5,)]}
    back_one = TS.zero_unshard_params(one, shapes)
    back, n = _counted(lambda: TS.zero_unshard_params(got, shapes,
                                                      devices=_cpus(P)))
    assert all(_same(tree_leaves(a), tree_leaves(b))
               for a, b in zip(back, back_one))
    assert n == 2 * P * (P - 1)


def test_column_row_pipeline_and_experts_per_card():
    P = 4
    xs = [_ints((3, 8), r) for r in range(P)]
    ws = [_ints((8, 5), 10 + r) for r in range(P)]
    for fn, moves in (
            (lambda **kw: TS.column_parallel(xs, ws, gather_output=True,
                                             **kw), P * (P - 1)),
            (lambda **kw: TS.row_parallel(xs, ws, **kw), 2 * (P - 1))):
        got, n = _counted(lambda: fn(devices=_cpus(P)))
        assert _same(got, fn()) and n == moves
    stage_ws = [_ints((6, 6), 20 + i) for i in range(P)]
    mb = _ints((5, 2, 6), 30)

    def stage(w, x):
        return torch.tanh(x @ w)

    got, n = _counted(lambda: TS.pipeline_apply(stage, stage_ws, mb,
                                                devices=_cpus(P)))
    assert _same(got, TS.pipeline_apply(stage, stage_ws, mb))
    assert n == (5 + P - 1) * (P - 1)
    toks = [_ints((8, 4), 40 + r) for r in range(P)]
    idxs = [torch.from_numpy(np.random.default_rng(50 + r).integers(
        0, P, 8)) for r in range(P)]
    (ins, info), n = _counted(lambda: TS.expert_dispatch(
        toks, idxs, capacity=3, devices=_cpus(P)))
    one_ins, one_info = TS.expert_dispatch(toks, idxs, capacity=3)
    assert _same(ins, one_ins) and n == P * (P - 1)
    back, n = _counted(lambda: TS.expert_combine(
        [t * 2 for t in ins], info, devices=_cpus(P)))
    assert _same(back, TS.expert_combine([t * 2 for t in one_ins],
                                         one_info))
    assert n == P * (P - 1)


# ---------------------------------------------------------------------------
# the transformer: placement, forward, train steps
# ---------------------------------------------------------------------------
def _cfgs(**kw):
    return JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)


def _setup(jcfg, seed=1, b=B):
    params = _np(JT.init_params(np.random.default_rng(seed), jcfg))
    tokens = np.random.default_rng(seed + 1).integers(
        0, BASE["vocab"], size=(b, T)).astype(np.int32)
    return params, tokens


def test_place_params_puts_each_shard_on_its_slot(monkeypatch):
    _jcfg, tcfg = _cfgs()
    one = TT.init_params(np.random.default_rng(0), tcfg, tp=2, device="cpu")
    mesh = make_mesh(dp=2, tp=2, devices=_cpus(4))
    reps = TT.place_params(one, tcfg, mesh)
    assert isinstance(reps, TT.Replicas) and len(reps) == 2
    for d, rep in enumerate(reps):
        assert rep.places.slots == (2 * d, 2 * d + 1)
        for a, b in zip(tree_leaves(TT.shard_params(rep, tcfg, 2)),
                        tree_leaves(one)):
            assert torch.equal(a, b)
            assert a.data_ptr() != b.data_ptr()  # its own storage
    single = TT.init_params(np.random.default_rng(0), tcfg, tp=2,
                            mesh=make_mesh(tp=2, devices=_cpus(2)))
    assert isinstance(single, TT.PlacedParams)
    assert _same(tree_leaves(single), tree_leaves(one))
    # tree_map keeps the placement
    from accl_tpu_torch.utils.tree import tree_map
    assert tree_map(lambda t: t, single).places == single.places
    # an sp axis is placed (tests/test_torch_sp_cards.py); an axis the
    # model does not place keeps its refusal
    assert isinstance(TT.place_params(one, tcfg, make_mesh(
        tp=2, sp=2, devices=_cpus(4))), TT.SpReplicas)
    with pytest.raises(ACCLError, match="not part of accl_tpu_torch yet"):
        TT.place_params(one, tcfg, make_mesh(fsdp=2, tp=2, devices=_cpus(4)))
    with pytest.raises(ValueError, match="every slot on one device"):
        TT.place_params(one, tcfg, make_mesh(tp=2, device="cpu"))


@pytest.mark.parametrize("kw,fused", [
    ({}, False), ({}, True), (FLASH, False), (FLASH, True),
    (dict(mlp="swiglu", remat=True), False)], ids=str)
@pytest.mark.parametrize("tp", [2, 4])
def test_forward_over_cards_is_the_one_card_forward_and_jax(kw, fused, tp):
    jcfg, tcfg = _cfgs(n_kv_heads=4, **{k: v for k, v in kw.items()
                                        if k != "n_kv_heads"})
    params, tokens = _setup(jcfg)
    one = model_params_from_jax(params, tcfg, tp, device="cpu")
    placed = model_params_from_jax(params, tcfg, tp,
                                   mesh=make_mesh(tp=tp, devices=_cpus(tp)))
    want = TT.forward(one, torch.from_numpy(tokens), tcfg, fused=fused)
    got, n = _counted(lambda: TT.forward(placed, torch.from_numpy(tokens),
                                         tcfg, fused=fused))
    assert torch.equal(got, want)
    if not fused:
        assert n == _forward_moves(tp)
    ref = np.asarray(JT.forward(params, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def _forward_moves(tp):
    """A forward's counted crossings over tp cards: the embedded stream
    to every other card (each rank's partials reach every card by the
    ring all-gather, which moves nothing through ``move``)."""
    return tp - 1


def _stream_back_moves(cards, layers):
    """A backward's counted crossings of the residual stream's gradient
    over one tp group's cards (every rank its own card): each block's two
    ``fan_out`` folds along the cards and back (``_chain_moves``; the
    row-parallel sums' partials take their own card's gradient, no
    crossing), and the exit's gradient from the hub to every other card
    once (``collect``)."""
    return 2 * layers * _chain_moves(cards) + (cards - 1)


def _jax_single_step(params, tokens, cfg):
    (loss_sum, count), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(tokens), cfg), has_aux=True)(
            params)
    new = jax.tree_util.tree_map(lambda p, g: p - LR * (g / count), params,
                                 grads)
    return _np(new), float(loss_sum / count)


def _jax_adamw_step(params, state, tokens, cfg, opt):
    """tests/test_torch_optim.py's single-device optax step."""
    def stp(p, s, t):
        (ls, c), g = jax.value_and_grad(
            lambda pp: JT.loss_fn(pp, t, cfg), has_aux=True)(p)
        gm = jax.tree_util.tree_map(lambda x: x / jnp.maximum(c, 1.0), g)
        up, s2 = opt.update(gm, s, p)
        return optax.apply_updates(p, up), s2, ls / jnp.maximum(c, 1.0)

    return jax.jit(stp)(params, state, jnp.asarray(tokens))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("kw", [{}, FLASH], ids=["dense", "flash"])
@pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2), dict(dp=2, tp=2),
                                  dict(dp=4, tp=2)], ids=str)
def test_sgd_step_over_cards_is_the_one_card_step_and_jax(axes, kw):
    jcfg, tcfg = _cfgs(**kw)
    n_dp, n_tp = axes.get("dp", 1), axes.get("tp", 1)
    params, tokens = _setup(jcfg, b=2 * n_dp)
    one = model_params_from_jax(params, tcfg, n_tp, device="cpu")
    mesh = make_mesh(devices=_cpus(n_dp * n_tp), **axes)
    placed = model_params_from_jax(params, tcfg, n_tp, mesh=mesh)
    step1, _ = TT.make_train_step(make_mesh(device="cpu", **axes), tcfg,
                                  lr=LR)
    stepc, (specs, tok_spec) = TT.make_train_step(mesh, tcfg, lr=LR)
    assert specs == TT.param_specs(tcfg)
    _, l1 = step1(one, torch.from_numpy(tokens))
    (new, lc), n = _counted(lambda: stepc(placed, torch.from_numpy(tokens)))
    assert new is placed
    assert torch.equal(lc, l1)
    reps = placed if isinstance(placed, TT.Replicas) else [placed]
    for rep in reps:  # every replica bitwise the one-card step
        assert _same(tree_leaves(TT.shard_params(rep, tcfg, n_tp)),
                     tree_leaves(one))
    leaves = len(tree_leaves(one))
    if kw == {}:
        # forward and backward crossings of every member (the forward's;
        # back, the stream's, _stream_back_moves), then the fold: counts
        # and losses (2 (dp - 1)), the total count to member 0's other
        # cards (tp - 1), each leaf 2 (dp - 1)
        per_member = _forward_moves(n_tp) + _stream_back_moves(
            n_tp, BASE["n_layers"])
        want = n_dp * per_member + 2 * (n_dp - 1) + (n_tp - 1) \
            + leaves * 2 * (n_dp - 1)
        assert n == want, (n, want)
    wp, wl = _jax_single_step(params, tokens, jcfg)
    np.testing.assert_allclose(float(lc), wl, rtol=1e-5)
    for a, b in zip(_flat(model_params_to_numpy(reps[-1], tcfg)), _flat(wp)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2), dict(dp=2, tp=2)],
                         ids=str)
def test_adamw_step_over_cards_is_the_one_card_step_and_optax(axes):
    jcfg, tcfg = _cfgs(**FLASH)
    n_dp, n_tp = axes.get("dp", 1), axes.get("tp", 1)
    params, tokens = _setup(jcfg, b=2 * n_dp)
    one = model_params_from_jax(params, tcfg, n_tp, device="cpu")
    mesh = make_mesh(devices=_cpus(n_dp * n_tp), **axes)
    placed = model_params_from_jax(params, tcfg, n_tp, mesh=mesh)
    opt = TO.adamw(1e-2)
    s1, _, i1 = TT.make_train_step(make_mesh(device="cpu", **axes), tcfg,
                                   optimizer=opt, params=one)
    sc, (_specs, state_specs, _tok), ic = TT.make_train_step(
        mesh, tcfg, optimizer=opt, params=placed)
    assert state_specs == TT.opt_state_specs(opt, one, TT.param_specs(tcfg))
    st1, stc = i1(one), ic(placed)
    losses = []
    for _ in range(2):
        _, st1, l1 = s1(one, st1, torch.from_numpy(tokens))
        _, stc, lc = sc(placed, stc, torch.from_numpy(tokens))
        assert torch.equal(lc, l1)
        losses.append(float(lc))
    reps = placed if isinstance(placed, TT.Replicas) else [placed]
    states = stc if isinstance(placed, TT.Replicas) else [stc]
    for rep, st in zip(reps, states):
        assert _same(tree_leaves(TT.shard_params(rep, tcfg, n_tp)),
                     tree_leaves(one))
        assert _same(tree_leaves(TT.shard_params(st.mu, tcfg, n_tp)),
                     tree_leaves(st1.mu))
        assert int(st.count) == int(st1.count) == 2
    # the JAX package's single-device step under optax.adamw, twice, at
    # tests/test_torch_optim.py's tolerances for the flash configuration
    jopt = optax.adamw(1e-2)
    jp, js = params, jopt.init(params)
    for want in losses:
        jp, js, jl = _jax_adamw_step(jp, js, tokens, jcfg, jopt)
        np.testing.assert_allclose(want, float(jl), rtol=1e-5)
    for a, b in zip(_flat(model_params_to_numpy(reps[-1], tcfg)), _flat(jp)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_norm_copies_follow_the_optimizer_step(monkeypatch):
    """Every card's copy of the norms is made again after a step changes
    them in place, and only then: here a move is a real copy (on the CPU
    it would alias the hub's leaf and hide a stale copy)."""
    made = []

    def copying_move(t, device):
        made.append(t.data_ptr())
        return t.clone()

    jcfg, tcfg = _cfgs(**FLASH)
    params, tokens = _setup(jcfg, b=4)
    one = model_params_from_jax(params, tcfg, 2, device="cpu")
    mesh = make_mesh(dp=2, tp=2, devices=_cpus(4))
    placed = model_params_from_jax(params, tcfg, 2, mesh=mesh)
    monkeypatch.setattr(TT, "move", copying_move)
    opt = TO.adamw(1e-2)
    s1, _, i1 = TT.make_train_step(make_mesh(device="cpu", dp=2, tp=2),
                                   tcfg, optimizer=opt, params=one)
    sc, _, ic = TT.make_train_step(mesh, tcfg, optimizer=opt, params=placed)
    st1, stc = i1(one), ic(placed)
    norms = {blk[k].data_ptr() for rep in placed for blk in rep["blocks"]
             for k in ("ln1", "ln2")}
    for step in range(2):
        made.clear()
        _, st1, l1 = s1(one, st1, torch.from_numpy(tokens))
        _, stc, lc = sc(placed, stc, torch.from_numpy(tokens))
        assert torch.equal(lc, l1)
        # the first step reads the copies made at placement; the second
        # makes each member's copies again, once
        copies = [m for m in made if m in norms]
        assert len(copies) == (0 if step == 0 else len(norms))
        assert len(set(copies)) == len(copies)
    for rep in placed:
        assert _same(tree_leaves(TT.shard_params(rep, tcfg, 2)),
                     tree_leaves(one))
    # a forward after the step makes them again; the next one reads them
    for again in (True, False):
        made.clear()
        TT.forward(placed[0], torch.from_numpy(tokens[:2]), tcfg)
        assert any(m in norms for m in made) == again


def test_train_step_over_cards_checks_the_placement():
    _jcfg, tcfg = _cfgs()
    one = TT.init_params(np.random.default_rng(0), tcfg, tp=2, device="cpu")
    mesh = make_mesh(dp=2, tp=2, devices=_cpus(4))
    step, _ = TT.make_train_step(mesh, tcfg)
    toks = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="1 parameter replicas"):
        step(TT.place_params(one, tcfg, make_mesh(tp=2, devices=_cpus(2))),
             toks)
    other = TT.place_params(one, tcfg, make_mesh(dp=2, tp=2,
                                                 devices=_cpus(4)))
    other[1].places = TT.Places(other[1].places.devices, (0, 1))
    with pytest.raises(ValueError, match="replica 1 is not placed"):
        step(other, toks)
    # the sp axis over cards runs (tests/test_torch_sp_cards.py); its
    # step takes the sp placement
    sp_mesh = make_mesh(tp=2, sp=2, devices=_cpus(4))
    sp_step, _ = TT.make_train_step(sp_mesh, tcfg)
    _p, loss = sp_step(TT.place_params(one, tcfg, sp_mesh), toks)
    assert torch.isfinite(loss)
    with pytest.raises(ACCLError, match="not part of accl_tpu_torch yet"):
        TT.place_params(one, tcfg, make_mesh(ep=2, tp=2, devices=_cpus(4)))
    with pytest.raises(ValueError, match="pass one member's tree"):
        TT.forward(other, toks, tcfg)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
def _gen_setup(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = _np(JT.init_params(np.random.default_rng(11), jcfg))
    jp = jax.tree_util.tree_map(lambda a: a * 8 if a.ndim > 1 else a, jp)
    prompt = np.random.default_rng(12).integers(0, BASE["vocab"],
                                                (2, 6)).astype(np.int32)
    return jcfg, tcfg, jp, prompt


@pytest.mark.parametrize("kw", [{}, FLASH], ids=["dense", "flash"])
@pytest.mark.parametrize("tp", [2, 4])
def test_generate_over_cards_is_the_one_card_generate_and_jax(kw, tp):
    jcfg, tcfg, jp, prompt = _gen_setup(
        dict(kw, n_kv_heads=4) if kw else kw)
    one = model_params_from_jax(jp, tcfg, tp, device="cpu")
    placed = model_params_from_jax(jp, tcfg, tp,
                                   mesh=make_mesh(tp=tp, devices=_cpus(tp)))
    want = TD.generate(one, torch.from_numpy(prompt), tcfg, 5)
    got, n = _counted(lambda: TD.generate(placed, torch.from_numpy(prompt),
                                          tcfg, 5))
    assert torch.equal(got, want)
    # prefill and four steps, each a forward's crossings
    assert n == 5 * _forward_moves(tp)
    ref = np.asarray(JD.generate(jp, jnp.asarray(prompt), jcfg, max_new=5))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_and_decode_over_cards_bank_on_each_card(tp):
    jcfg, tcfg, jp, prompt = _gen_setup(dict(FLASH, n_kv_heads=4))
    one = model_params_from_jax(jp, tcfg, tp, device="cpu")
    placed = model_params_from_jax(jp, tcfg, tp,
                                   mesh=make_mesh(tp=tp, devices=_cpus(tp)))
    c1 = TD.init_kv_cache(tcfg, 2, 10, tp, "cpu")
    c2 = TD.init_kv_cache(tcfg, 2, 10, tp, devices=placed.places.devices)
    l1, c1 = TD.prefill(one, torch.from_numpy(prompt), c1, tcfg)
    l2, c2 = TD.prefill(placed, torch.from_numpy(prompt), c2, tcfg)
    assert torch.equal(l1, l2)
    for _ in range(3):
        nxt = l1[:, -1].argmax(-1) if l1.dim() == 3 else l1.argmax(-1)
        l1, c1 = TD.decode_step(one, nxt, c1, tcfg)
        l2, c2 = TD.decode_step(placed, nxt, c2, tcfg)
        assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(c1["layers"]), tree_leaves(c2["layers"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="2 devices for 4 ranks"):
        TD.init_kv_cache(tcfg, 2, 10, 4, devices=_cpus(2))


def _greedy_steps(params, tcfg, prompt, n, devices=None):
    """Prefill, then n ``DecodeGraph`` static steps run eagerly: (every
    step's logits, the greedy tokens, prefill's first)."""
    tp = len(params["blocks"][0]["wq"])
    cache = TD.init_kv_cache(tcfg, 2, 6 + n + 1, tp, "cpu", devices=devices)
    lg, cache = TD.prefill(params, torch.from_numpy(prompt), cache, tcfg)
    first = lg[:, -1].argmax(-1)
    g = TD.DecodeGraph(params, cache, tcfg, first)
    logits, toks = [], [first]
    for _ in range(n):
        logits.append(g.step().clone())
        toks.append(g.token.clone())
    return g, logits, torch.stack(toks, dim=1)


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_graph_over_cards_captures_on_a_card_only(tp):
    """A placed tree's ``DecodeGraph.capture`` no longer refuses the
    cards: on the CPU it reaches the device check.  Its static step, run
    eagerly, is bitwise the one-card static step, and its greedy tokens
    are the JAX ``generate``'s."""
    jcfg, tcfg, jp, prompt = _gen_setup({})
    placed = model_params_from_jax(jp, tcfg, tp,
                                   mesh=make_mesh(tp=tp, devices=_cpus(tp)))
    one = model_params_from_jax(jp, tcfg, tp, device="cpu")
    g, got, toks = _greedy_steps(placed, tcfg, prompt, 4,
                                 placed.places.devices)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        g.capture()
    _g, want, want_toks = _greedy_steps(one, tcfg, prompt, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(toks, want_toks)
    ref = np.asarray(JD.generate(jp, jnp.asarray(prompt), jcfg, max_new=5))
    np.testing.assert_array_equal(toks.numpy(), ref)


@pytest.mark.parametrize("tp", [1, 2])
def test_generate_takes_the_graph_for_placed_parameters_on_cuda(
        monkeypatch, tp):
    """On a CUDA device ``generate`` captures its decode step whether or
    not the parameters are placed on several cards (a spy on
    ``DecodeGraph.capture``, the device type faked; the spy captures
    nothing, so the steps run eagerly and still give JAX's tokens)."""
    jcfg, tcfg, jp, prompt = _gen_setup({})
    params = (model_params_from_jax(jp, tcfg, tp, mesh=make_mesh(
        tp=tp, devices=_cpus(tp))) if tp > 1 else
        model_params_from_jax(jp, tcfg, 1, device="cpu"))
    captured = []

    def spy(self):
        captured.append(self.params)
        return self

    monkeypatch.setattr(TD, "_captures", lambda dev: dev.type == "cpu")
    monkeypatch.setattr(TD.DecodeGraph, "capture", spy)
    got = TD.generate(params, torch.from_numpy(prompt), tcfg, 5)
    assert len(captured) == 1 and captured[0] is params
    ref = np.asarray(JD.generate(jp, jnp.asarray(prompt), jcfg, max_new=5))
    np.testing.assert_array_equal(got.numpy(), ref)
    monkeypatch.undo()
    assert not TD._captures(torch.device("cpu"))
    assert TD._captures(torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# the fused matmul reduce-scatter: plain per-card form and the kernel's
# cross-card schedule
# ---------------------------------------------------------------------------
def _jax_per_rank(fn, *arrays):
    P = arrays[0].shape[0]
    mesh = Mesh(np.array(jax.devices()[:P]), ("r",))
    spec = Pspec("r")
    f = jax.jit(jax.shard_map(
        lambda *vs: fn(*(v[0] for v in vs))[None], mesh=mesh,
        in_specs=(spec,) * len(arrays), out_specs=spec, check_vma=False))
    return np.asarray(f(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("P", [2, 3, 4])
def test_fused_reduce_scatter_per_card_plain_matches_pallas(P):
    m, K, N = 16, 24, 128
    x = np.stack([_ints((P, m, K), 60 + r).numpy() for r in range(P)])
    w = np.stack([_ints((K, N), 70 + r).numpy() for r in range(P)])
    xs = [torch.from_numpy(x[r]) for r in range(P)]
    ws = [torch.from_numpy(w[r]) for r in range(P)]
    got, n = _counted(lambda: TF.fused_matmul_reduce_scatter_plain(
        xs, ws, devices=_cpus(P)))
    assert _same(got, TF.fused_matmul_reduce_scatter(xs, ws))
    assert n == P * (P - 1)  # every hop's arrival, every rank
    want = _jax_per_rank(lambda a, b: JF.fused_matmul_reduce_scatter_pallas(
        a, b, axis="r", interpret=True), x, w)
    for r in range(P):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    full = [torch.from_numpy(x[r].reshape(P * m, K)) for r in range(P)]
    ag = TF.fused_matmul_allreduce_pallas(full, ws)
    assert _same(ag, [torch.cat(got)] * P)


@pytest.mark.parametrize("chunks", [None, 1, 3])
@pytest.mark.parametrize("P", [2, 4])
def test_fused_matmul_allreduce_per_card(chunks, P):
    xs = [_ints((20, 12), 80 + r) for r in range(P)]
    ws = [_ints((12, 9), 90 + r) for r in range(P)]
    one = TF.fused_matmul_allreduce(xs, ws, use_pallas=False, chunks=chunks)
    got, n = _counted(lambda: TF.fused_matmul_allreduce(
        xs, ws, use_pallas=False, chunks=chunks, devices=_cpus(P)))
    assert _same(got, one)
    C = chunks or 1
    assert n == (2 * (P - 1) if C == 1 else 2 * P * (P - 1) * C)


def test_fused_wrappers_take_ranks_on_their_own_devices():
    x = [torch.ones(2, 4, 8) for _ in range(2)]
    w = [torch.ones(8, 16) for _ in range(2)]
    assert TF._check_rank_operands(x, w, "t") is None
    with pytest.raises(ValueError, match="share device"):
        TF.fused_matmul_reduce_scatter(x, [w[0], w[1].double()])
    with pytest.raises(ValueError, match="on their rank's device"):
        TF.fused_matmul_reduce_scatter(
            x, w, out=[torch.zeros(4, 16), torch.zeros(4, 16,
                                                       device="meta")])


def test_fused_kernel_source_holds_the_replayed_handshake():
    """fused_matmul_rs_cross_kernel: its entry (ring_sync.cuh cross_entry:
    the host's gate of an eager launch, then both handshake words of its
    rank at the rank's count of its ended blocks, read on the card), its
    flags at .sys scope on the per-rank tables, and its exit (own flags
    to 0, counted into the left neighbour's word 1 and the right's word
    0, then out of its rank's launch, count_out): what the replay below
    runs."""
    src = FUSED_CU.read_text()
    cross = src[src.index("fused_matmul_rs_cross_kernel(PtrTable"):]
    cross = cross[:cross.index("\n}\n")]
    assert "const int my = tabs.rank[blockIdx.x / S], st = blockIdx.x % S;" \
        in cross
    assert "FusedTables tabs) {" in cross and "int base" not in cross
    assert cross.index("opened = cross_entry(tabs.gate, tabs.seq, "
                       "tabs.flags[tabs.rank[0]] + 2, tabs.flags[my]);") \
        < cross.index("if (!opened) return;") \
        < cross.index("tile_mainloop")
    end = cross[cross.rindex("*F(0, 0) = *F(0, 1) = *A(0, 0) = *A(0, 1) = 0;"):]
    assert end.index("arrive_release<SCOPE_SYS>(tabs.flags[left] + 1);") \
        < end.index("arrive_release<SCOPE_SYS>(tabs.flags[right]);") \
        < end.index("count_out(tabs.flags[my], S);")
    assert "SCOPE_GPU" not in cross
    assert "wait_geq<SCOPE_SYS>(F(0, slot), s / 2 + 1);" in cross
    assert "rs_waits_ack(ns, P)) wait_geq<SCOPE_SYS>(A(0, ns & 1), " \
        "ns / 2);" in cross
    assert "if (rs_signals_ack(s, P)) arrive_release<SCOPE_SYS>(A(2, " \
        "slot));" in cross
    # the handshake head, entry and exit are the ring kernels' (one
    # definition, shared)
    sync = (ROOT / "accl_tpu_torch" / "ops" / "csrc"
            / "ring_sync.cuh").read_text()
    assert re.search(r"#define HS_WORDS %d\b" % tring.HS_WORDS, sync)
    assert "int cross_entry(" in sync and "void count_out(" in sync
    assert "cross_entry(" not in src.replace(
        "opened = cross_entry(", "", 1)


def test_c_entries_restore_the_callers_device():
    """Every C entry that makes a card current gives the caller's current
    device back (csrc/current_device.cuh), so no Python wrapper sets one:
    no source sets the device outside a CurrentDevice, and a loop over
    several cards runs under one that restores the first."""
    csrc = FUSED_CU.parent
    for cu in sorted(csrc.glob("*.cu")):
        src = cu.read_text()
        assert '#include "current_device.cuh"' in src, cu.name
        assert "cudaSetDevice(device)" not in src, cu.name
        assert "cudaSetDevice(prev)" not in src, cu.name
        for m in re.finditer(r"cudaSetDevice\(devices\[i\]\)", src):
            fn = src[src.rindex("\nint ", 0, m.start()):m.start()]
            assert "const CurrentDevice keep(devices[0]);" in fn, cu.name
    guard = (csrc / "current_device.cuh").read_text()
    assert "cudaGetDevice(&prev)" in guard and "cudaSetDevice(prev)" in guard
    for mod in ("ring", "fused", "flash", "compression", "reduce_ops"):
        src = (ROOT / "accl_tpu_torch" / "ops" / f"{mod}.py").read_text()
        assert "with torch.cuda.device(dev)" not in src, mod


def _entry_waits(my, P, base):
    return [(0, base), (1, base)]


def _stripe_program(P):
    """One block (one stripe) of the cross-card fused kernel, from the
    port's ACK-window predicates: its entry (the handshake's waits, which
    the replay inserts once the block has its count), then hop label
    s + 1 into the right neighbour's slot (s + 1) % 2 at iteration s."""
    ops = [("entry",), ("send", 0)]                # s = -1
    for s in range(P - 1):
        last = s == P - 2
        ns = s + 1
        ops.append(("wait_filled", s))
        if not last and tring.rs_waits_ack(ns, P):
            ops.append(("wait_ack", ns))
        ops.append(("read", s))
        if not last:
            ops.append(("send", ns))
        if tring.rs_signals_ack(s, P):
            ops.append(("signal_ack", s))
    ops.append(("exit",))
    return ops


#: stripes of the launches on one set of tables (they change from launch
#: to launch, and the flags' addresses with them)
FUSED_LAUNCHES = [2, 1, 3, 2]
#: eager launches interleaved with the replays of captured ones (as
#: tests/test_torch_multicard.py CAPTURED, in stripes): ("eager", S),
#: ("capture", graph, [S, ...]), ("replay", graph), ("given_up", S)
FUSED_CAPTURED = [("eager", 2), ("capture", "g", [1, 3]), ("replay", "g"),
                  ("eager", 2), ("replay", "g"), ("replay", "g"),
                  ("given_up", 3), ("eager", 1), ("capture", "h", [2]),
                  ("replay", "g"), ("replay", "h"), ("eager", 3),
                  ("replay", "h"), ("replay", "h")]
MASK = 0xFFFFFFFF


def _fused_order(seq, host_count):
    """[(stripes, count, given_up)] the cards run for ``seq``: count None
    where the blocks read it on the card, else the host's running sum
    fixed at the call (the design before, as a mutation)."""
    out, graphs, host = [], {}, 0
    for item in seq:
        if item[0] in ("eager", "given_up"):
            gone = item[0] == "given_up"
            out.append((item[1], host if host_count else None, gone))
            host += 0 if gone else item[1]
        elif item[0] == "capture":
            graphs[item[1]] = []
            for S in item[2]:
                graphs[item[1]].append((S, host if host_count else None,
                                        False))
                host += S
        else:
            out.extend(graphs[item[1]])
    return out


def _fused_replay(P, layout, seq=None, entry_waits=_entry_waits,
                  host_count=False, start=0):
    """Every card starts its next launch the moment its last one ended;
    cards take turns, each as far as it can, from each card first and in
    both block orders.  Each rank's handshake words and its count of
    ended blocks start at ``start``.  Returns the violations."""
    HS, DONE, ENDED = tring.HS_WORDS, tring.HS_DONE, tring.HS_ENDED
    launches = _fused_order([("eager", S) for S in FUSED_LAUNCHES]
                            if seq is None else seq, host_count)
    groups = tring.card_groups(layout)
    acc = sum(S for S, _b, gone in launches if not gone)
    violations = []
    for rotation in range(len(groups)):
        for reverse in (False, True):
            words = [{0: start, 1: start, DONE: start} for _ in range(P)]
            slots = {}
            cur = {c: 0 for c, _r in groups}

            def blocks_of(card, e):
                S, base, gone = launches[e]
                return [{"rank": r, "k": k, "e": e, "S": S, "pc": 0,
                         "base": base,
                         "ops": [] if gone else _stripe_program(P)}
                        for r in dict(groups)[card] for k in range(S)]

            running = {c: blocks_of(c, 0) for c, _r in groups}

            def filled(k, s):
                return HS + 2 * k + s

            def ack(k, s, S):
                return HS + 2 * S + 2 * k + s

            def step(b):
                if b["pc"] >= len(b["ops"]):
                    return False
                op = b["ops"][b["pc"]]
                r, k, e, S = b["rank"], b["k"], b["e"], b["S"]
                w = words[r]
                tag = f"P={P} layout={layout}: launch {e} rank {r} stripe {k}"
                if op[0] == "entry":
                    base = w[DONE] if b["base"] is None else b["base"] + start
                    b["ops"][b["pc"] + 1:b["pc"] + 1] = [
                        ("hs", word, target & MASK)
                        for word, target in entry_waits(r, P, base)]
                elif op[0] == "hs":
                    if (w.get(op[1], 0) - op[2]) & MASK >= 1 << 31:
                        return False
                elif op[0] == "wait_ack":
                    if w.get(ack(k, op[1] % 2, S), 0) < op[1] // 2:
                        return False
                elif op[0] == "wait_filled":
                    if w.get(filled(k, op[1] % 2), 0) < op[1] // 2 + 1:
                        return False
                elif op[0] == "send":
                    dst = (r + 1) % P
                    key = (dst, k, op[1] % 2)
                    old = slots.get(key)
                    if old is not None and old["reads"] > 0:
                        violations.append(
                            f"{tag} hop {op[1]} overran rank {dst}'s slot "
                            f"(launch {old['e']} hop {old['hop']} unread)")
                    slots[key] = {"e": e, "hop": op[1], "reads": 1}
                    f = filled(k, op[1] % 2)
                    words[dst][f] = words[dst].get(f, 0) + 1
                elif op[0] == "read":
                    got = slots.get((r, k, op[1] % 2))
                    if got is None or (got["e"], got["hop"]) != (e, op[1]):
                        violations.append(
                            f"{tag} read hop {op[1]} but the slot holds "
                            f"{None if got is None else (got['e'], got['hop'])}")
                    else:
                        got["reads"] -= 1
                elif op[0] == "signal_ack":
                    left = (r - 1) % P
                    a = ack(k, op[1] % 2, S)
                    words[left][a] = words[left].get(a, 0) + 1
                elif op[0] == "exit":
                    for s in (0, 1):
                        want_f = sum(1 for h in range(P - 1) if h % 2 == s)
                        want_a = sum(1 for h in range(P - 1) if h % 2 == s
                                     and tring.rs_signals_ack(h, P))
                        for name, addr, want in (
                                ("filled", filled(k, s), want_f),
                                ("ack", ack(k, s, S), want_a)):
                            if w.get(addr, 0) != want:
                                violations.append(
                                    f"{tag}: {name}[{s}] reads "
                                    f"{w.get(addr, 0)} at its end, not "
                                    f"{want}: a count is lost")
                            w[addr] = 0
                    for q, word in (((r - 1) % P, 1), ((r + 1) % P, 0)):
                        words[q][word] = (words[q][word] + 1) & MASK
                    # count_out: the rank's last block advances its count
                    w[ENDED] = w.get(ENDED, 0) + 1
                    if w[ENDED] == S:
                        w[ENDED] = 0
                        w[DONE] = (w[DONE] + S) & MASK
                b["pc"] += 1
                return True

            order = [c for c, _r in groups]
            order = order[rotation:] + order[:rotation]
            for _ in range(100_000):
                progressed = False
                for c in order:
                    while True:
                        moved = False
                        blocks = running[c][::-1] if reverse else running[c]
                        for b in blocks:
                            while step(b):
                                moved = True
                        done = all(b["pc"] >= len(b["ops"])
                                   for b in running[c])
                        if done and cur[c] + 1 < len(launches):
                            cur[c] += 1
                            running[c] = blocks_of(c, cur[c])
                            moved = True
                        if not moved:
                            break
                        progressed = True
                if all(cur[c] == len(launches) - 1 and all(
                        b["pc"] >= len(b["ops"]) for b in running[c])
                       for c in cur):
                    break
                if not progressed:
                    violations.append(f"P={P} layout={layout}: DEADLOCK at "
                                      f"{[(c, cur[c]) for c in cur]}")
                    return violations
            end = (start + acc) & MASK
            for r in range(P):
                left = {k: v for k, v in words[r].items() if k >= HS and v}
                if left:
                    violations.append(f"P={P} layout={layout}: rank {r} "
                                      f"ends with flags {left}")
                got = (words[r][0], words[r][1], words[r][DONE])
                if got != (end,) * 3 or words[r].get(ENDED, 0):
                    violations.append(f"P={P} layout={layout}: rank {r}'s "
                                      f"handshake words and count {got}, "
                                      f"not {end}")
    return violations


def _contiguous(P, group):
    return [r // group for r in range(P)]


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("group", [1, 2, 4])
def test_fused_cross_card_schedule_replay(P, group):
    for layout in (_contiguous(P, group),
                   [r % -(-P // group) for r in range(P)]):
        violations = _fused_replay(P, layout)
        assert not violations, "\n".join(violations[:5])


FUSED_MUTATIONS = {
    "dropped": lambda my, P, base: [],
    "left_only": lambda my, P, base: [(0, base)],
    "one_block_short": lambda my, P, base: [(0, base - 1), (1, base - 1)],
}


@pytest.mark.parametrize("mutation", list(FUSED_MUTATIONS))
@pytest.mark.parametrize("P,group", [(3, 1), (4, 1), (4, 2), (8, 2)])
def test_fused_cross_card_replay_catches_a_broken_handshake(P, group,
                                                            mutation):
    violations = _fused_replay(P, _contiguous(P, group),
                               entry_waits=FUSED_MUTATIONS[mutation])
    assert violations, f"{mutation} went undetected at P={P}, group={group}"


@pytest.mark.parametrize("P", range(2, 9))
@pytest.mark.parametrize("group", [1, 2, 4])
def test_fused_cross_card_replay_of_captured_launches(P, group):
    """Eager launches interleaved with the replays of captured ones (each
    at least 3 times), a launch given up among them, from counts about
    to wrap at 2^32: the count read on the card holds each launch to its
    predecessor."""
    for layout in (_contiguous(P, group),
                   [r % -(-P // group) for r in range(P)]):
        for start in (0, MASK - 2):
            violations = _fused_replay(P, layout, FUSED_CAPTURED,
                                       start=start)
            assert not violations, "\n".join(violations[:5])


@pytest.mark.parametrize("P,group", [(2, 1), (3, 1), (4, 1), (4, 2),
                                     (8, 2)])
def test_fused_cross_card_replay_catches_the_count_fixed_at_capture(P,
                                                                    group):
    """The host's count fixed in the arguments at capture (the design
    before) overruns or deadlocks once launches are replayed; eager
    launches alone pass with it."""
    layout = _contiguous(P, group)
    assert not _fused_replay(P, layout, host_count=True)
    assert _fused_replay(P, layout, FUSED_CAPTURED, host_count=True)


def test_fused_one_card_layout_needs_no_handshake():
    """With one card its stream orders the launches: the replay passes
    with no handshake (the one-launch kernel has none)."""
    assert not _fused_replay(4, [0, 0, 0, 0],
                             entry_waits=FUSED_MUTATIONS["dropped"])


# ---------------------------------------------------------------------------
# ring attention and Ulysses
# ---------------------------------------------------------------------------
def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _shards(x, P):
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(P, dim=1))


RING_CASES = [("contiguous", None, True), ("contiguous", None, False),
              ("zigzag", None, True), ("windowed", 5, True)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("schedule,window,causal", RING_CASES,
                         ids=[c[0] + str(c[2]) for c in RING_CASES])
def test_ring_attention_over_cards_is_the_one_card_ring_and_jax(
        schedule, window, causal, impl):
    P, Bq, Tl, H, D = 4, 1, 8, 2, 8
    q, k, v = (_rand((Bq, P * Tl, H, D), s) for s in (1, 2, 3))
    if schedule == "zigzag":
        perm = np.asarray(zigzag_indices(P * Tl, P))
        q, k, v = q[:, perm], k[:, perm], v[:, perm]
    kw = dict(causal=causal, impl=impl, window=window,
              schedule="zigzag" if schedule == "zigzag" else "contiguous")
    args = [_shards(t, P) for t in (q, k, v)]
    one = ring_attention(*args, **kw)
    got, n = _counted(lambda: ring_attention(*args, devices=_cpus(P), **kw))
    assert _same(got, one)
    # K and V each rotate P - 1 times (the windowed ring once, its tails)
    assert n == (2 * P if schedule == "windowed" else 2 * P * (P - 1))
    spec = Pspec(None, "sp")
    jkw = {k_: v_ for k_, v_ in kw.items() if v_ is not None}
    f = jax.jit(jax.shard_map(
        lambda a, b, c: jax_ring(a, b, c, axis="sp", **jkw),
        mesh=jax_make_mesh(sp=P), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=impl != "flash"))
    want = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("G", [4, 2])
def test_ulysses_over_cards_is_the_one_card_form(G):
    P, Bq, Tl, H, D = 2, 1, 8, 4, 8
    qs = _shards(_rand((Bq, P * Tl, H, D), 5), P)
    ks = _shards(_rand((Bq, P * Tl, G, D), 6), P)
    vs = _shards(_rand((Bq, P * Tl, G, D), 7), P)
    one = ulysses_attention(qs, ks, vs, causal=True)
    got, n = _counted(lambda: ulysses_attention(qs, ks, vs, causal=True,
                                                devices=_cpus(P)))
    assert _same(got, one)
    assert n == 4 * P * (P - 1)  # q, k, v there and the output back
    spec = Pspec(None, "sp")
    f = jax.jit(jax.shard_map(
        lambda a, b, c: jax_ulysses(a, b, c, axis="sp", causal=True),
        mesh=jax_make_mesh(sp=P), in_specs=(spec,) * 3, out_specs=spec))
    want = np.asarray(f(*(jnp.asarray(torch.cat(t, 1).numpy())
                          for t in (qs, ks, vs))))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=2e-4,
                               atol=2e-4)


def test_ring_attention_grads_over_cards_are_the_one_card_grads():
    P, Tl, H, D = 4, 8, 2, 8
    base = [_rand((1, P * Tl, H, D), s) for s in (11, 12, 13)]

    def grads(devices):
        ts = [torch.from_numpy(b).requires_grad_(True) for b in base]
        outs = ring_attention(*[list(t.chunk(P, 1)) for t in ts],
                              causal=True, impl="flash", devices=devices)
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        return [t.grad for t in ts]

    assert _same(grads(_cpus(P)), grads(None))


# ---------------------------------------------------------------------------
# MoE: ep over cards
# ---------------------------------------------------------------------------
MOE = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, d_head=16, d_ff=64,
           n_experts=4, capacity_factor=4.0)


def _moe_setup(seed=0, b=8):
    jcfg, tcfg = JM.MoEConfig(**MOE), TMO.MoEConfig(**MOE)
    jp = _np(JM.init_params(np.random.default_rng(seed), jcfg))
    tokens = np.random.default_rng(seed + 3).integers(0, MOE["vocab"],
                                                      (b, 8))
    return jcfg, tcfg, jp, tokens


#: the MoE step over cards against the one-card ep step: each ep member
#: multiplies its own rows, so the replicated leaves' gradients fold per
#: member (a different summation from one product over the B rows): the
#: loss within rtol MOE_LOSS_TOL, each replicated leaf's mean gradient
#: within a relative L2 error of MOE_GRAD_TOL (read on the CPU: 1.1e-7
#: and 1.6e-7), its update within tests/test_torch_sp_cards.py's
#: UPDATE_TOL (the update p' - p of float32 parameters carries their
#: rounding, up to 2.3e-5 here); the expert banks bitwise (their rows are
#: the one-card step's).
MOE_LOSS_TOL = 1e-6
MOE_GRAD_TOL = 1e-6
MOE_UPDATE_TOL = 2e-4


def _moe_replicated(cfg):
    """Each leaf of a MoE tree (``tree_leaves`` order): replicated (True)
    or an entry of an expert bank's rank list (False)."""
    specs = TMO.param_specs(cfg)
    return [v for v in tree_leaves({
        "embed": True, "ln_f": True,
        "blocks": [{k: (True if spec is None else [False] * cfg.n_experts)
                    for k, spec in blk.items()} for blk in specs["blocks"]]})]


def _moe_forward_moves(P, layers):
    """A MoE forward's counted crossings over P ep cards: a layer's two
    all-to-alls, P (P - 1) each (every member on its card from the
    embedding to the logits); the logits of members 1.. to the hub."""
    return layers * 2 * P * (P - 1) + (P - 1)


def _moe_step_moves(n_dp, P, layers, again):
    """A MoE SGD step's counted crossings: every data member's all-to-alls
    forward and back (no logits gathered: each member's loss stays on its
    card) and, with ``again``, each member's own copy of every replicated
    leaf made again after the last step (P - 1 a leaf); then the fold:
    the n = dp P members' counts and losses to the first hub (2 (n - 1)),
    the total count to the first tree's other cards (P - 1), every
    replicated leaf's fold over its tree's members' copies along their
    cards (P - 1 a leaf and tree, every member a card of its own) and, in
    the first tree, back to the hub (1 a leaf), every leaf over the dp
    trees and the mean back (2 (dp - 1) a leaf)."""
    R = 2 + 7 * layers
    leaves = R + 2 * layers * P
    per = 2 * layers * 2 * P * (P - 1) + (R * (P - 1) if again else 0)
    n = n_dp * P
    return (n_dp * per + 2 * (n - 1) + (P - 1) + n_dp * R * (P - 1) + R
            + leaves * 2 * (n_dp - 1))


@pytest.mark.parametrize("fused", [False, True])
def test_moe_forward_over_cards_is_the_one_card_forward_and_jax(fused):
    """Each ep member's rows on its card from the embedding to the
    logits: bitwise the one-card ep forward on the CPU (the products of
    a member's rows are the rows of the product over every member's),
    its aux one scalar a member."""
    jcfg, tcfg, jp, tokens = _moe_setup()
    one = moe_params_from_jax(jp, tcfg, 4, device="cpu")
    placed = moe_params_from_jax(jp, tcfg, 4,
                                 mesh=make_mesh(ep=4, devices=_cpus(4)))
    lg1, aux1 = TMO.forward(one, torch.from_numpy(tokens), tcfg, 4,
                            fused=fused)
    (lg, aux), n = _counted(lambda: TMO.forward(
        placed, torch.from_numpy(tokens), tcfg, 4, fused=fused))
    assert torch.equal(lg, lg1) and _same(aux, aux1)
    if not fused:
        assert n == _moe_forward_moves(4, MOE["n_layers"])
    # every member's replicated leaves are its own copies
    for e in range(1, 4):
        tree = TMO._member_tree(placed, placed.places, e)
        for a, b, rep in zip(tree_leaves(tree), tree_leaves(placed),
                             _moe_replicated(tcfg)):
            assert (a is not b) == rep and torch.equal(a, b)
    mesh = jax_make_mesh(ep=4)
    fn = jax.jit(jax.shard_map(
        lambda p, t: JM.forward(p, t, jcfg, ep_axis="ep", fused=fused)[0],
        mesh=mesh, in_specs=(JM.param_specs(jcfg, "ep"), Pspec("ep")),
        out_specs=Pspec("ep")))
    want = np.asarray(fn(JM.shard_params(jp, mesh, jcfg),
                         jnp.asarray(tokens)))
    np.testing.assert_allclose(lg.numpy(), want, rtol=2e-4, atol=2e-4)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


@pytest.mark.parametrize("dp", [1, 2])
def test_moe_gradients_over_cards_fold_in_member_order(dp):
    """The step's mean gradients: each member's on its card, the
    replicated leaves' folded over the members' own copies in member
    order on the hub, then over the dp trees; against the one-card ep
    step's, the banks bitwise and every replicated leaf within
    MOE_GRAD_TOL."""
    _jcfg, tcfg, jp, tokens = _moe_setup(b=8 * dp)
    one = moe_params_from_jax(jp, tcfg, 4, device="cpu")
    mesh = make_mesh(dp=dp, ep=4, devices=_cpus(4 * dp))
    reps = TT.placed_replicas(moe_params_from_jax(jp, tcfg, 4, mesh=mesh),
                              mesh, "ep", dp)
    toks = torch.from_numpy(tokens)
    g1, l1 = TT._mean_grads(
        [lambda p, t=toks[d * 8:(d + 1) * 8]: TMO.loss_fn(p, t, tcfg, 4)
         for d in range(dp)], one)
    gc, lc = TT._mean_grads_cards(TT.card_closures(
        reps, toks, dp, lambda p, t: TMO._loss_members(p, t, tcfg)), reps)
    np.testing.assert_allclose(float(lc), float(l1), rtol=MOE_LOSS_TOL)
    for tree in gc[1:]:
        assert _same(tree_leaves(tree), tree_leaves(gc[0]))
    for i, (a, b, rep) in enumerate(zip(tree_leaves(gc[0]), tree_leaves(g1),
                                        _moe_replicated(tcfg))):
        if rep:
            assert _rel(a, b) <= MOE_GRAD_TOL, (i, _rel(a, b))
        else:
            assert torch.equal(a, b), f"bank leaf {i}"
    # the members' copies were left without gradients
    for tree in reps:
        assert all(c.grad is None and not c.requires_grad
                   for c in tree.places.owned())


def test_moe_members_sharing_a_card_share_its_copy(monkeypatch):
    """Members that share a card (faked: members 0 and 1 on the hub's
    card, 2 and 3 on another) hold one copy of each replicated leaf a
    card: member 1 a tensor of its own over the hub's leaf, member 3 one
    over member 2's copy, made with one counted move a leaf; the step's
    fold of their gradients crosses once to the second card and once
    back to the hub.  Against every member on a card of its own (3 copies
    a leaf, a fold of 3 crossings and 1 back), 4 fewer moves a replicated
    leaf, and the mean gradients and loss bitwise the same."""
    _jcfg, tcfg, jp, tokens = _moe_setup()
    toks = torch.from_numpy(tokens)
    mesh = make_mesh(ep=4, devices=_cpus(4))

    def run():
        placed = moe_params_from_jax(jp, tcfg, 4, mesh=mesh)
        reps = TT.placed_replicas(placed, mesh, "ep", 1)
        return placed, TT._mean_grads_cards(TT.card_closures(
            reps, toks, 1, lambda p, t: TMO._loss_members(p, t, tcfg)),
            reps)

    (_, (g_own, l_own)), n_own = _counted(run)
    monkeypatch.setattr(TT, "card_homes", lambda devs: [0, 0, 2, 2])
    (placed, (g_sh, l_sh)), n_sh = _counted(run)
    R = sum(_moe_replicated(tcfg))
    assert n_own - n_sh == 4 * R, (n_own, n_sh)
    assert torch.equal(l_own, l_sh)
    assert _same(tree_leaves(g_own[0]), tree_leaves(g_sh[0]))
    pl = placed.places
    assert pl.homes == (0, 0, 2, 2)
    for leaf, rep in zip(tree_leaves(placed), _moe_replicated(tcfg)):
        if rep:
            t1, t2, t3 = (pl.own(leaf, r) for r in (1, 2, 3))
            assert t1 is not leaf and t1.data_ptr() == leaf.data_ptr()
            assert t3 is not t2 and t3.data_ptr() == t2.data_ptr()


@pytest.mark.parametrize("dp", [1, 2])
def test_moe_train_step_over_cards_is_the_one_card_step_and_jax(dp):
    """Each member's loss and gradients on its card, folded in member
    order on the hub: against the one-card ep step the loss within
    MOE_LOSS_TOL, each replicated leaf's update within MOE_UPDATE_TOL by
    relative L2, the expert banks bitwise (first step; the second starts
    from the first's slightly different replicated leaves, every leaf
    then within MOE_UPDATE_TOL); the members' copies made again from the
    updated leaves; every replica bitwise the others; the
    JAX package's dp x ep mesh step at tests/test_torch_moe.py's
    tolerances; the moves as ``_moe_step_moves``."""
    jcfg, tcfg, jp, tokens = _moe_setup(b=8 * dp)
    one = moe_params_from_jax(jp, tcfg, 4, device="cpu")
    mesh = make_mesh(dp=dp, ep=4, devices=_cpus(4 * dp))
    placed = moe_params_from_jax(jp, tcfg, 4, mesh=mesh)
    s1, _ = TMO.make_train_step(make_mesh(dp=dp, ep=4, device="cpu"), tcfg,
                                lr=LR)
    sc, _ = TMO.make_train_step(mesh, tcfg, lr=LR)
    jmesh = jax_make_mesh(dp=dp, ep=4)
    jstep, (_s, jtok) = JM.make_train_step(jmesh, jcfg, lr=LR)
    jnew = JM.shard_params(jp, jmesh, jcfg)
    jtokens = jax.device_put(jnp.asarray(tokens), NamedSharding(jmesh, jtok))
    reps = placed if isinstance(placed, TT.Replicas) else [placed]
    replicated = _moe_replicated(tcfg)
    for step in range(2):
        before = [t.clone() for t in tree_leaves(one)]
        mine = [t.clone() for t in tree_leaves(
            TMO.shard_params(reps[0], tcfg, 4))]
        _, l1 = s1(one, torch.from_numpy(tokens))
        (_, lc), n = _counted(lambda: sc(placed, torch.from_numpy(tokens)))
        np.testing.assert_allclose(float(lc), float(l1), rtol=MOE_LOSS_TOL)
        assert n == _moe_step_moves(dp, 4, MOE["n_layers"], step > 0), n
        got = tree_leaves(TMO.shard_params(reps[0], tcfg, 4))
        for i, (a, b, a0, b0, rep) in enumerate(zip(
                got, tree_leaves(one), mine, before, replicated)):
            if step == 0 and not rep:
                assert torch.equal(a, b), f"bank leaf {i}"
            else:
                rel = _rel(a - a0, b - b0)
                assert rel <= MOE_UPDATE_TOL, (step, i, rel)
        for rep in reps[1:]:
            assert _same(tree_leaves(rep), tree_leaves(reps[0]))
        jnew, jloss = jstep(jnew, jtokens)
        np.testing.assert_allclose(float(lc), float(jloss), rtol=1e-5)
    for rep in reps:  # each member's copies read the updated leaves
        for e in range(1, 4):
            assert _same(tree_leaves(TMO._member_tree(rep, rep.places, e)),
                         tree_leaves(rep))
    for a, b in zip(_flat(moe_params_to_numpy(reps[-1], tcfg)),
                    _flat(_np(jnew))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_moe_decode_over_cards_is_the_one_card_decode_and_jax():
    jcfg, tcfg, jp, tokens = _moe_setup()
    one = moe_params_from_jax(jp, tcfg, 4, device="cpu")
    placed = moe_params_from_jax(jp, tcfg, 4,
                                 mesh=make_mesh(ep=4, devices=_cpus(4)))
    c1 = TMD.init_kv_cache(tcfg, 2, 10, "cpu")
    c2 = TMD.init_kv_cache(tcfg, 2, 10, "cpu")
    tok = torch.from_numpy(tokens[:2])
    # teacher-forced, each position's logits are the JAX package's
    # forward's (tests/test_torch_moe.py's decode tolerance)
    want = np.asarray(JM.forward(jp, jnp.asarray(tokens[:2, :8]), jcfg)[0])
    l1, a1, c1 = TMD.prefill(one, tok[:, :5], c1, tcfg, ep=4)
    (l2, a2, c2), n = _counted(lambda: TMD.prefill(placed, tok[:, :5], c2,
                                                   tcfg, ep=4))
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    # the cache and attention on the hub: each member's share of the
    # tokens to its card and back, the two all-to-alls between
    assert n == MOE["n_layers"] * (2 * 3 + 2 * 4 * 3)
    np.testing.assert_allclose(l2.numpy(), want[:, :5], rtol=3e-5,
                               atol=3e-5)
    for t in range(5, 8):
        l1, c1 = TMD.decode_step(one, tok[:, t], c1, tcfg, ep=4)
        l2, c2 = TMD.decode_step(placed, tok[:, t], c2, tcfg, ep=4)
        assert torch.equal(l1, l2)
        np.testing.assert_allclose(l2.numpy(), want[:, t], rtol=3e-5,
                                   atol=3e-5)


def test_moe_placement_refusals():
    _jcfg, tcfg, jp, _tokens = _moe_setup()
    one = moe_params_from_jax(jp, tcfg, 4, device="cpu")
    with pytest.raises(ACCLError, match="dp x ep"):
        TMO.place_params(one, tcfg, make_mesh(ep=4, tp=2, devices=_cpus(8)))
    step, _ = TMO.make_train_step(make_mesh(ep=4, devices=_cpus(4)), tcfg)
    with pytest.raises(ValueError, match="not placed on this mesh"):
        step(one, torch.zeros((4, 8), dtype=torch.long))

