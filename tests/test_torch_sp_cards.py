"""The transformer's sequence-parallel axis over several cards on the CPU:
``place_params``, ``model_params_from_jax(mesh=)``, ``forward``,
``loss_fn`` and ``make_train_step`` (SGD and AdamW) on dp x tp x sp
meshes of cards (accl_tpu_torch/models/transformer.py ``SpReplicas``),
at tests/test_torch_sp_model.py's size.

- ``devices=["cpu"] * P`` takes the several-cards code path on the CPU
  (tests/test_torch_model_cards.py's convention): every crossing from
  one member to another is a counted ``collectives.move``, and the tests
  hold the count of a forward and of a step to the count they state.
- Each case is held to the port's one-card sp form (the same function
  with the one-card parameters, ``forward(sp=)`` or ``make_train_step``
  on ``make_mesh(..., device="cpu")``) and to the JAX package: its dense
  sp mesh step (``make_train_step`` under ``shard_map``), its
  single-device step and forward, optax's AdamW.
- Bitwise where the arithmetic is the same: the forward (each shard's
  token-wise layers compute the same rows, the ring over cards is the
  one-card ring), the counts, and every tree of a mesh against the
  others after a step.  Not bitwise: the loss (per-shard sums folded in
  member order, against one sum over [B, T]) and the gradients of the
  replicated and tp-sharded weights (per-shard products folded over the
  sp trees, against one product over the full sequence); those are held
  to tests/test_torch_sp_model.py's tolerances: loss rtol 1e-5,
  parameters rtol 5e-4 / atol 5e-5, each leaf's update within a relative
  L2 error of 2e-4, logits rtol = atol = 3e-5 (and the AdamW step at
  tests/test_torch_optim.py's rtol 2e-4 / atol 2e-5).
- The ring runs its dense impl (the CPU default) and its flash hops on
  the plain versions of the port's kernels (the card's default, forced
  here as tests/test_torch_sp_model.py forces it).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

import accl_tpu.models.transformer as JT
from accl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from accl_tpu_torch import (
    ACCLError,
    adamw_state_from_optax,
    model_params_from_jax,
    model_params_to_numpy,
)
from accl_tpu_torch import optim as TO
from accl_tpu_torch.models import transformer as TT
from accl_tpu_torch.parallel import collectives as TC
from accl_tpu_torch.parallel import mesh as tmesh
from accl_tpu_torch.parallel import make_mesh
from accl_tpu_torch.utils.tree import tree_leaves, tree_map

RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")

LR = 0.05
B, T = 4, 16
BASE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_head=8, d_ff=64)
UPDATE_TOL = 2e-4
LOGIT_TOL = 3e-5
#: tests/test_torch_sp_model.py's AXES and ROPE_AXES (tests/test_model.py)
AXES = [(dict(dp=2), "contiguous"), (dict(tp=2), "contiguous"),
        (dict(sp=2), "contiguous"), (dict(dp=2, tp=2, sp=2), "contiguous"),
        (dict(sp=2), "zigzag"), (dict(sp=4), "zigzag")]
ROPE_AXES = [(dict(sp=2), "contiguous"), (dict(sp=2), "zigzag"),
             (dict(sp=4), "zigzag"), (dict(dp=2, tp=2, sp=2), "contiguous")]
ROPE = dict(rope=True, n_kv_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(params=["dense", "flash"])
def ring_impl(request, monkeypatch):
    """The ring's impl: "dense" (the CPU default) or "flash" (the card's
    default, its hops on the plain versions here)."""
    if request.param == "flash":
        real = RA._flash_defaults
        monkeypatch.setattr(RA, "_flash_defaults",
                            lambda q: (True, real(q)[1]))
    return request.param


def _cpus(n):
    return ["cpu"] * n


def _n(axes):
    return axes.get("dp", 1), axes.get("tp", 1), axes.get("sp", 1)


def _cards(axes):
    return make_mesh(devices=_cpus(int(np.prod(list(axes.values())))),
                     **axes)


def _counted(fn):
    TC.reset_moves()
    out = fn()
    return out, TC.moves()


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tokens(seed, b=B):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], size=(b, T)).astype(np.int32)


def _laid(tokens, axes, schedule):
    """The tokens in the schedule's layout (zigzag: permuted, as
    tests/test_model.py feeds them)."""
    if schedule != "zigzag":
        return tokens
    return tokens[:, RA.zigzag_indices(T, axes["sp"]).numpy()]


def _rotations(n_sp, window=False):
    """A forward's K (or V) crossings around the sp ring, a tp rank and
    layer: P - 1 rotations of P shards (the windowed ring moves the
    tails once)."""
    if n_sp == 1:
        return 0
    return n_sp if window else n_sp * (n_sp - 1)


def _rotations_back(n_sp, schedule, impl, window=False):
    """Those of :func:`_rotations` whose gradient crosses back: a shard
    moved to a member that reads it (or hands it on to one that does).
    The dense ring reads every arrival (masked blocks too); the causal
    contiguous flash ring launches no hop on a shard from the future, so
    shard src's moves past the ring's end (P - 1 - src of its P - 1
    live) carry none; zigzag reads every arrival; the windowed ring's
    tail for member 0 is read by nobody."""
    if n_sp == 1:
        return 0
    if window:
        return n_sp - 1
    if impl == "flash" and schedule == "contiguous":
        return n_sp * (n_sp - 1) // 2
    return n_sp * (n_sp - 1)


def _forward_moves(n_tp, n_sp, layers, window=False):
    """A forward's counted crossings over one data member's cards: each sp
    member's stream to its tp group's other cards, K and V around the sp
    ring for every tp rank and layer, the logits of members 1.. to member
    0's hub.  The tp combines' ring all-gathers move nothing through
    ``move``."""
    return (n_sp * (n_tp - 1) + layers * n_tp * 2 * _rotations(n_sp, window)
            + (n_sp - 1))


def _stream_back(n_tp, layers):
    """A backward's crossings of one sp member's stream gradient over its
    tp group's cards: each block's two ``fan_out`` folds down the cards
    and back up (2 (tp - 1) each), and the exit's gradient from the hub
    to the group's other cards (tp - 1); the row-parallel sums' partials
    take their own card's gradient and the spread passes the hub's alone
    (no crossing)."""
    return (2 * layers * 2 + 1) * (n_tp - 1)


def _step_moves(axes, schedule, impl, layers, leaves, window=False):
    """An SGD step's counted crossings.  Every data member: its forward
    less the logits' gather (each sp member's loss stays on its hub, its
    labels split from the sequence's as its tokens are); back, the ring's
    crossings that carry a gradient and each sp member's stream gradient
    over its tp group (:func:`_stream_back`, whatever the MLP's uses).
    Then the fold over the n = dp sp trees: their counts and losses to
    the first hub (2 (n - 1)), the total count to the first tree's other
    cards (tp - 1), every leaf to the first tree's card and the mean back
    (2 (n - 1) a leaf)."""
    n_dp, n_tp, n_sp = _n(axes)
    fwd = _forward_moves(n_tp, n_sp, layers, window) - (n_sp - 1)
    back = (layers * n_tp * 2 * _rotations_back(n_sp, schedule, impl, window)
            + n_sp * _stream_back(n_tp, layers))
    n = n_dp * n_sp
    return (n_dp * (fwd + back)
            + 2 * (n - 1) + (n_tp - 1) + leaves * 2 * (n - 1))


def _hold(got, want, params0, what, rtol=5e-4, atol=5e-5):
    (gp, gl), (wp, wl) = got, want
    np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{what} loss")
    flat0 = _flat(params0)
    for i, (a, b, p0) in enumerate(zip(_flat(gp), _flat(wp), flat0)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")
        du, dw = a.astype(np.float64) - p0, b.astype(np.float64) - p0
        rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        assert rel <= UPDATE_TOL, f"{what} leaf {i}: update off by {rel}"


# ---------------------------------------------------------------------------
# the mesh's groups and the placement
# ---------------------------------------------------------------------------
def test_mesh_groups_are_the_jax_grid_rows(monkeypatch):
    """``group("tp", dp=d, sp=s)`` and ``group("sp", dp=d, tp=t)``: the
    devices of the JAX mesh's ``devices[d, :, s]`` and ``devices[d, t,
    :]`` (the sp group in ring order)."""
    monkeypatch.setattr(tmesh, "resolve_devices",
                        lambda devs, n, what: [torch.device(d)
                                               for d in list(devs)[:n]])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    want = jax_make_mesh(devices=jax.devices()[:8], dp=2, tp=2, sp=2)
    got = make_mesh(devices=[f"cuda:{i}" for i in range(8)], dp=2, tp=2,
                    sp=2)
    for d in range(2):
        for i in range(2):
            tpg = [got.slot_device(x).index
                   for x in got.group("tp", dp=d, sp=i)]
            spg = [got.slot_device(x).index
                   for x in got.group("sp", dp=d, tp=i)]
            assert tpg == [x.id for x in want.devices[d, :, i]]
            assert spg == [x.id for x in want.devices[d, i, :]]
    assert got.group("tp", dp=1, sp=1) == (5, 7)
    assert got.group("ep") == (0,)  # an axis not in the mesh
    one = make_mesh(sp=4, device="cpu")
    assert one.group("sp") == (0, 1, 2, 3)


def test_place_params_on_dp_tp_sp_puts_each_tree_on_its_slots():
    cfg = TT.ModelConfig(**BASE)
    one = TT.init_params(np.random.default_rng(0), cfg, tp=2, device="cpu")
    mesh = make_mesh(dp=2, tp=2, sp=2, devices=_cpus(8))
    reps = TT.place_params(one, cfg, mesh)
    assert isinstance(reps, TT.Replicas) and len(reps) == 2
    ptrs = set()
    for d, rep in enumerate(reps):
        assert isinstance(rep, TT.SpReplicas) and len(rep) == 2
        for s, tree in enumerate(rep):
            assert isinstance(tree, TT.PlacedParams)
            assert tree.places.slots == mesh.group("tp", dp=d, sp=s) == \
                (4 * d + s, 4 * d + 2 + s)
            assert _same(tree_leaves(TT.shard_params(tree, cfg, 2)),
                         tree_leaves(one))
            for t in tree_leaves(tree):  # its own storage
                assert t.data_ptr() not in ptrs
                ptrs.add(t.data_ptr())
            # the norms' copies on the tp group's other card
            assert len(tree.places._copies) == 2 * BASE["n_layers"]
    # a placed container stands for its first tree
    assert _same(tree_leaves(TT.shard_params(reps, cfg, 2)),
                 tree_leaves(one))
    sp_only = TT.place_params(one, cfg, make_mesh(sp=4, devices=_cpus(4)))
    assert isinstance(sp_only, TT.SpReplicas) and len(sp_only) == 4
    assert [t.places.slots for t in sp_only] == [(0,), (1,), (2,), (3,)]
    # an axis the model does not place keeps its refusal
    for axes in (dict(fsdp=2, tp=2), dict(tp=2, ep=2), dict(sp=2, pp=2)):
        with pytest.raises(ACCLError,
                           match=r"not part of accl_tpu_torch yet "
                                 r"\(ROADMAP item 13\); the model places "
                                 r"dp x tp x sp"):
            TT.place_params(one, cfg, _cards(axes))


def test_model_params_from_jax_onto_an_sp_mesh_and_back():
    jcfg = JT.ModelConfig(**BASE, **ROPE)
    tcfg = TT.ModelConfig(**BASE, **ROPE)
    params = _np(JT.init_params(np.random.default_rng(4), jcfg))
    mesh = make_mesh(dp=2, tp=2, sp=2, devices=_cpus(8))
    placed = model_params_from_jax(params, tcfg, 2, mesh=mesh)
    assert isinstance(placed, TT.Replicas)
    for tree in TT.placed_trees(placed):
        back = model_params_to_numpy(tree, tcfg)
        for a, b in zip(_flat(back), _flat(params)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_flat(model_params_to_numpy(placed, tcfg)),
                    _flat(params)):
        np.testing.assert_array_equal(a, b)
    # optax's AdamW state beside the trees, one a tree, nested as they are
    opt = optax.adamw(1e-2)
    state = adamw_state_from_optax(opt.init(params), tcfg, 2, mesh=mesh)
    assert len(state) == 2 and all(len(s) == 2 for s in state)
    for d, rep in enumerate(placed):
        for s, tree in enumerate(rep):
            st = state[d][s]
            assert st.mu.places.slots == tree.places.slots
            assert st.count.device == tree.places.devices[0]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
FWD_CASES = [(dict(sp=2), "contiguous", {}),
             (dict(sp=2), "zigzag", dict(mlp="swiglu")),
             (dict(tp=2, sp=2), "contiguous", dict(ROPE, mlp="swiglu")),
             (dict(tp=2, sp=2), "zigzag", ROPE),
             (dict(tp=2, sp=4), "zigzag", dict(ROPE, remat=True)),
             (dict(tp=2, sp=2), "contiguous", dict(ROPE, fused=True))]


@pytest.mark.parametrize("axes,schedule,kw", FWD_CASES,
                         ids=[f"{a}-{s}-{sorted(k)}" for a, s, k in FWD_CASES])
def test_forward_over_sp_cards_is_the_one_card_sp_forward_and_jax(
        axes, schedule, kw, ring_impl):
    kw = dict(kw)
    fused = kw.pop("fused", False)
    jcfg = JT.ModelConfig(**BASE, **{k: v for k, v in kw.items()
                                     if k != "remat"})
    tcfg = TT.ModelConfig(**BASE, **kw, sp_schedule=schedule)
    _n_dp, n_tp, n_sp = _n(axes)
    params = _np(JT.init_params(np.random.default_rng(3), jcfg))
    tokens = _tokens(4, b=2)
    laid = torch.from_numpy(_laid(tokens, axes, schedule))
    one = model_params_from_jax(params, tcfg, n_tp, device="cpu")
    placed = model_params_from_jax(params, tcfg, n_tp, mesh=_cards(axes))
    want = TT.forward(one, laid, tcfg, fused=fused, sp=n_sp)
    got, n = _counted(lambda: TT.forward(placed, laid, tcfg, fused=fused,
                                         sp=n_sp))
    # each shard's token-wise layers compute the one-card stream's rows,
    # and the ring over cards is the one-card ring: bitwise
    assert torch.equal(got, want)
    if not fused:
        assert n == _forward_moves(n_tp, n_sp, BASE["n_layers"]), n
    if schedule == "zigzag":
        got = got[:, RA.zigzag_indices_inverse(T, n_sp)]
    ref = np.asarray(JT.forward(params, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_windowed_forward_over_sp_cards(ring_impl):
    """The local windowed block and one neighbour hop of the tails, each
    member on its card: bitwise the one-card windowed sp forward, and the
    JAX single-device windowed forward within the logits' bound."""
    kw = dict(attn_window=5, **ROPE)
    jcfg, tcfg = JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)
    params = _np(JT.init_params(np.random.default_rng(5), jcfg))
    tokens = _tokens(6, b=2)
    one = model_params_from_jax(params, tcfg, 2, device="cpu")
    placed = model_params_from_jax(params, tcfg, 2,
                                   mesh=_cards(dict(tp=2, sp=2)))
    want = TT.forward(one, torch.from_numpy(tokens), tcfg, sp=2)
    got, n = _counted(lambda: TT.forward(placed, torch.from_numpy(tokens),
                                         tcfg, sp=2))
    assert torch.equal(got, want)
    assert n == _forward_moves(2, 2, BASE["n_layers"], window=True)
    ref = np.asarray(JT.forward(params, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_loss_over_sp_cards_gathers_no_logits(ring_impl):
    """Each member's loss on its own hub, its labels split from the
    sequence's as its tokens are: the one-card sp loss within rtol 1e-5
    (a different summation), the count exact."""
    tcfg = TT.ModelConfig(**BASE, sp_schedule="zigzag")
    one = TT.init_params(np.random.default_rng(0), tcfg, device="cpu")
    placed = TT.place_params(one, tcfg, _cards(dict(sp=4)))
    laid = torch.from_numpy(_laid(_tokens(7, b=2), dict(sp=4), "zigzag"))
    ls1, c1 = TT.loss_fn(one, laid, tcfg, sp=4)
    (ls, c), n = _counted(lambda: TT.loss_fn(placed, laid, tcfg, sp=4))
    assert torch.equal(c, c1) and float(c) == 2 * (T - 1)
    np.testing.assert_allclose(float(ls), float(ls1), rtol=1e-5)
    # the forward less its logits' gather, the sums and counts
    assert n == _forward_moves(1, 4, BASE["n_layers"]) - 3 + 2 * 3
    with pytest.raises(ValueError, match="placed over 4 sp members; sp=2"):
        TT.forward(placed, laid, tcfg, sp=2)


# ---------------------------------------------------------------------------
# the SGD step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_refs(kw_items, axes_items, schedule, seed):
    """The JAX single-device step and dense sp mesh step of a case (one
    pair for both ring impls)."""
    kw, axes = dict(kw_items), dict(axes_items)
    jcfg = JT.ModelConfig(**BASE, **kw)
    params = JT.init_params(np.random.default_rng(seed), jcfg)
    tokens = _tokens(seed + 1)
    (loss_sum, count), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jnp.asarray(tokens), jcfg), has_aux=True)(
            params)
    single = (_np(jax.tree_util.tree_map(lambda p, g: p - LR * (g / count),
                                         params, grads)),
              float(loss_sum / count))
    mesh = jax_make_mesh(**axes)
    step, (_specs, tok_spec) = JT.make_train_step(
        mesh, dataclasses.replace(jcfg, sp_schedule=schedule), lr=LR)
    new, loss = step(JT.shard_params(params, mesh, jcfg),
                     jax.device_put(jnp.asarray(_laid(tokens, axes,
                                                      schedule)),
                                    NamedSharding(mesh, tok_spec)))
    return _np(params), tokens, single, (_np(new), float(loss))


def _sgd_case(kw, axes, schedule, seed, impl):
    params, tokens, single, jmesh = _jax_refs(
        tuple(sorted(kw.items())), tuple(sorted(axes.items())), schedule,
        seed)
    tcfg = TT.ModelConfig(**BASE, **kw, sp_schedule=schedule)
    n_dp, n_tp, n_sp = _n(axes)
    laid = torch.from_numpy(_laid(tokens, axes, schedule))
    one = model_params_from_jax(params, tcfg, n_tp, device="cpu")
    mesh = _cards(axes)
    placed = model_params_from_jax(params, tcfg, n_tp, mesh=mesh)
    step1, _ = TT.make_train_step(make_mesh(device="cpu", **axes), tcfg,
                                  lr=LR)
    stepc, (specs, tok_spec) = TT.make_train_step(mesh, tcfg, lr=LR)
    assert specs == TT.param_specs(tcfg)
    assert tok_spec == ("dp" if n_dp > 1 else None,
                        "sp" if n_sp > 1 else None)
    _, l1 = step1(one, laid)
    (new, lc), n = _counted(lambda: stepc(placed, laid))
    assert new is placed
    trees = TT.placed_trees(placed)
    assert len(trees) == n_dp * n_sp
    for tree in trees[1:]:  # every tree takes the same update
        assert _same(tree_leaves(tree), tree_leaves(trees[0]))
    leaves = len(tree_leaves(one))
    assert n == _step_moves(axes, schedule, impl, BASE["n_layers"], leaves,
                            window=kw.get("attn_window") is not None), n
    got = (model_params_to_numpy(placed, tcfg), float(lc))
    if n_sp == 1:
        # the dp x tp step over cards: bitwise the one-card step
        assert torch.equal(lc, l1)
        assert _same(tree_leaves(TT.shard_params(placed, tcfg, n_tp)),
                     tree_leaves(one))
    else:
        # the sp trees fold per-shard gradients: a different summation
        _hold(got, (model_params_to_numpy(one, tcfg), float(l1)), params,
              "vs the one-card sp step")
    _hold(got, single, params, "vs the JAX single-device step")
    _hold(got, jmesh, params, "vs the JAX dense sp mesh step")


@pytest.mark.parametrize("axes,schedule", AXES, ids=str)
def test_sgd_step_over_sp_cards_matches_one_card_and_jax(axes, schedule,
                                                          ring_impl):
    _sgd_case({}, axes, schedule, 1, ring_impl)


@pytest.mark.parametrize("axes,schedule", ROPE_AXES, ids=str)
def test_rope_sgd_step_over_sp_cards_matches_one_card_and_jax(
        axes, schedule, ring_impl):
    _sgd_case(ROPE, axes, schedule, 1, ring_impl)


def test_swiglu_sgd_step_over_dp_tp_sp_cards(ring_impl):
    _sgd_case(dict(mlp="swiglu"), dict(dp=2, tp=2, sp=2), "contiguous", 17,
              ring_impl)


def test_windowed_sgd_step_over_sp_cards(ring_impl):
    _sgd_case(dict(attn_window=5, **ROPE), dict(dp=2, sp=2), "contiguous", 5,
              ring_impl)


def test_remat_sgd_step_over_sp_cards_is_the_plain_step():
    """A checkpointed block over all sp members recomputes the same
    numbers: bitwise the step without remat."""
    out = []
    for remat in (False, True):
        tcfg = TT.ModelConfig(**BASE, **ROPE, remat=remat,
                              sp_schedule="zigzag")
        one = TT.init_params(np.random.default_rng(8), tcfg, tp=2,
                             device="cpu")
        mesh = _cards(dict(tp=2, sp=2))
        placed = TT.place_params(one, tcfg, mesh)
        step, _ = TT.make_train_step(mesh, tcfg, lr=LR)
        laid = _laid(_tokens(9, b=2), dict(sp=2), "zigzag")
        _, loss = step(placed, torch.from_numpy(laid))
        out.append((loss, tree_leaves(placed)))
    assert torch.equal(out[0][0], out[1][0])
    assert _same(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the AdamW step
# ---------------------------------------------------------------------------
def test_adamw_step_over_tp_sp_cards_matches_one_card_and_optax():
    kw = dict(mlp="swiglu", **ROPE)
    jcfg, tcfg = JT.ModelConfig(**BASE, **kw), TT.ModelConfig(**BASE, **kw)
    params = _np(JT.init_params(np.random.default_rng(11), jcfg))
    tokens = _tokens(12, b=2)
    axes = dict(tp=2, sp=2)
    one = model_params_from_jax(params, tcfg, 2, device="cpu")
    mesh = _cards(axes)
    placed = model_params_from_jax(params, tcfg, 2, mesh=mesh)
    opt = TO.adamw(1e-2)
    s1, _, i1 = TT.make_train_step(make_mesh(device="cpu", **axes), tcfg,
                                   optimizer=opt, params=one)
    sc, (_specs, state_specs, tok_spec), ic = TT.make_train_step(
        mesh, tcfg, optimizer=opt, params=placed)
    assert state_specs == TT.opt_state_specs(opt, one, TT.param_specs(tcfg))
    assert tok_spec == (None, "sp")
    st1, stc = i1(one), ic(placed)
    assert isinstance(stc, list) and len(stc) == 2
    losses = []
    for _ in range(2):
        _, st1, l1 = s1(one, st1, torch.from_numpy(tokens))
        _, stc, lc = sc(placed, stc, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(lc), float(l1), rtol=1e-5)
        losses.append(float(lc))
    for tree, st in zip(placed[1:], stc[1:]):
        assert _same(tree_leaves(tree), tree_leaves(placed[0]))
        assert _same(tree_leaves(st.mu), tree_leaves(stc[0].mu))
        assert _same(tree_leaves(st.nu), tree_leaves(stc[0].nu))
    assert [int(s.count) for s in stc] == [2, 2] and int(st1.count) == 2
    for a, b in zip(_flat(model_params_to_numpy(placed, tcfg)),
                    _flat(model_params_to_numpy(one, tcfg))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    # optax's AdamW on the JAX single-device step, twice
    jopt = optax.adamw(1e-2)

    def jstep(p, s, t):
        (ls, c), g = jax.value_and_grad(
            lambda pp: JT.loss_fn(pp, t, jcfg), has_aux=True)(p)
        gm = jax.tree_util.tree_map(lambda x: x / jnp.maximum(c, 1.0), g)
        up, s2 = jopt.update(gm, s, p)
        return optax.apply_updates(p, up), s2, ls / jnp.maximum(c, 1.0)

    jp, js = params, jopt.init(params)
    for want in losses:
        jp, js, jl = jax.jit(jstep)(jp, js, jnp.asarray(tokens))
        np.testing.assert_allclose(want, float(jl), rtol=1e-5)
    for a, b in zip(_flat(model_params_to_numpy(placed, tcfg)), _flat(jp)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def _rel_l2(got, want):
    return [float((a.double() - b.double()).norm()
                  / max(float(b.double().norm()), 1e-300))
            for a, b in zip(tree_leaves(got), tree_leaves(want))]


def test_adamw_moments_see_a_dropped_sp_tree(monkeypatch):
    """A first AdamW step moves every element by about lr whatever the
    gradient's size, so the parameters of two first steps are within
    about 2 lr of each other however wrong one gradient is; the first
    moment (1 - b1) g is the gradient.  Held as chip_smoke.py's
    model_cards_sp holds the card's step (adamw_readings): at lr 1e-4 the
    tp 2 x sp 2 step's mu is within 1e-3 relative L2 per leaf of the
    one-card sp step's; with sp tree 1's gradients dropped before the
    fold (planted here) some leaf's mu is more than 0.1 off, while the
    parameters stay within 2.5 lr (two updates of lr each, and the
    weight decay's)."""
    tcfg = TT.ModelConfig(**BASE)
    base = TT.init_params(np.random.default_rng(13), tcfg, tp=1,
                          device="cpu")
    tokens = torch.from_numpy(_tokens(14, b=1))
    lr = 1e-4
    mesh = _cards(dict(tp=2, sp=2))

    def step(m, params):
        run, _specs, init = TT.make_train_step(
            m, tcfg, optimizer=TO.adamw(lr), params=params)
        _p, state, _loss = run(params, init(params), tokens)
        return TT.placed_trees(state)[0]

    ref = TT.shard_params(tree_map(torch.clone, base), tcfg, 2)
    rstate = step(make_mesh(device="cpu", tp=2, sp=2), ref)
    real = torch.autograd.backward
    readings = {}
    for planted in (False, True):
        placed = TT.place_params(base, tcfg, mesh)

        def dropped(*args, **kw):
            real(*args, **kw)
            for p in tree_leaves(TT.placed_trees(placed)[1]):
                p.grad = None

        if planted:
            monkeypatch.setattr(torch.autograd, "backward", dropped)
        st = step(mesh, placed)
        monkeypatch.undo()
        readings[planted] = (
            max(_rel_l2(TT.shard_params(st.mu, tcfg, 2), rstate.mu)),
            max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(TT.shard_params(placed, tcfg, 2)),
                tree_leaves(ref))))
    assert readings[False][0] < 1e-3 and readings[True][0] > 0.1, readings
    assert max(readings[False][1], readings[True][1]) < 2.5 * lr, readings


# ---------------------------------------------------------------------------
# checks and refusals
# ---------------------------------------------------------------------------
def test_sp_refusals_over_cards_match_jax():
    """attn="flash" under sp and a window under zigzag raise the JAX
    package's errors over cards too; a zigzag schedule without an sp
    axis raises as on one card; the step checks the placement."""
    one = TT.init_params(np.random.default_rng(0), TT.ModelConfig(**BASE),
                         tp=2, device="cpu")
    jparams = JT.init_params(np.random.default_rng(0),
                             JT.ModelConfig(**BASE))
    jmesh = jax_make_mesh(sp=2)
    tokens = _tokens(0, b=2)
    mesh = _cards(dict(tp=2, sp=2))
    placed = TT.place_params(one, TT.ModelConfig(**BASE), mesh)
    for kw in (dict(attn="flash"),
               dict(attn_window=4, sp_schedule="zigzag")):
        with pytest.raises(ValueError) as te:
            TT.forward(placed, torch.from_numpy(tokens),
                       TT.ModelConfig(**BASE, **kw), sp=2)
        step, (_s, tok_spec) = JT.make_train_step(
            jmesh, JT.ModelConfig(**BASE, **kw))
        with pytest.raises(ValueError) as je:
            step(JT.shard_params(jparams, jmesh, JT.ModelConfig(**BASE)),
                 jax.device_put(jnp.asarray(tokens),
                                NamedSharding(jmesh, tok_spec)))
        assert str(te.value) == str(je.value), kw
    zz = TT.ModelConfig(**BASE, sp_schedule="zigzag")
    tp_only = TT.place_params(one, zz, _cards(dict(tp=2)))
    with pytest.raises(ValueError, match="requires an sp axis"):
        TT.forward(tp_only, torch.from_numpy(tokens), zz)
    with pytest.raises(ValueError, match="needs an 'sp' axis"):
        TT.make_train_step(_cards(dict(tp=2)), zz)
    step, _ = TT.make_train_step(mesh, TT.ModelConfig(**BASE))
    with pytest.raises(ValueError, match="replica 0 holds 1 sp trees"):
        step(tp_only, torch.from_numpy(tokens))
    other = TT.place_params(one, TT.ModelConfig(**BASE), mesh)
    other[1].places = TT.Places(other[1].places.devices, (0, 2))
    with pytest.raises(ValueError, match="sp member 1, is not placed"):
        step(other, torch.from_numpy(tokens))
    with pytest.raises(ValueError, match="does not split over 2 sp"):
        TT.forward(placed, torch.zeros((1, 9), dtype=torch.long),
                   TT.ModelConfig(**BASE), sp=2)


def test_sp_over_a_tp_placement_runs_the_ring_on_each_card():
    """``forward(sp=)`` on parameters placed over tp cards alone (no sp
    axis in the placement): each card's ring over its own shards, bitwise
    the one-card sp forward."""
    tcfg = TT.ModelConfig(**BASE, sp_schedule="zigzag")
    one = TT.init_params(np.random.default_rng(2), tcfg, tp=2, device="cpu")
    placed = TT.place_params(one, tcfg, _cards(dict(tp=2)))
    laid = torch.from_numpy(_laid(_tokens(3, b=2), dict(sp=4), "zigzag"))
    assert torch.equal(TT.forward(placed, laid, tcfg, sp=4),
                       TT.forward(one, laid, tcfg, sp=4))


def test_flash_hops_over_cards_launch_per_card_or_member(monkeypatch):
    """On per-card lists a hop stacks each card's live members into one
    launch, as on one card's lists; where autograd records the hop each
    live member's hop is a launch of its own (the backward's plan cuts a
    launch by its size, so a member's gradients keep their bits whichever
    members share its card).  The outputs are bitwise the one-card ring's
    either way."""
    from accl_tpu_torch.ops import flash as TFL

    real = TFL.flash_attention_lse
    batches = []

    def counting(q, k, v, **kw):
        batches.append(q.shape[0])
        return real(q, k, v, **kw)

    monkeypatch.setattr(TFL, "flash_attention_lse", counting)
    g = torch.Generator().manual_seed(3)
    P = 4
    q, k, v = (list(torch.randn(1, P * 8, h, 8, generator=g).chunk(P, 1))
               for h in (2, 1, 1))
    qg = [t.clone().requires_grad_() for t in q]
    for sched, window in (("contiguous", None), ("zigzag", None),
                          ("contiguous", 3)):
        kw = dict(causal=True, impl="flash", schedule=sched, window=window)
        batches.clear()
        one = RA.ring_attention(q, k, v, **kw)
        stacked = list(batches)
        batches.clear()
        got = RA.ring_attention(q, k, v, devices=_cpus(P), **kw)
        assert _same(got, one) and batches == stacked
        batches.clear()
        got = RA.ring_attention(qg, k, v, devices=_cpus(P), **kw)
        assert _same([t.detach() for t in got], one)
        if window is not None:  # the local block, one launch a member
            assert stacked == [P] and batches == [1] * P
        elif sched == "contiguous":  # hop h: the P - h live members
            assert stacked == [P - h for h in range(P)]
            assert batches == [1] * (P * (P + 1) // 2)
        else:  # zigzag: each member's pairs in one launch a hop
            assert sum(batches) == sum(stacked)
            assert len(batches) == P + P * P and len(stacked) == P + 1
