"""The port's ring collectives (accl_tpu_torch/ops/ring.py) against the
JAX package's Pallas ring kernels (accl_tpu/ops/ring.py).

The JAX kernels run as tests/test_pallas_ops.py runs them on the CPU:
``shard_map`` over a 4-device CPU mesh, Pallas in interpret mode.  The
port runs its plain PyTorch versions, which its wrappers take for CPU
tensors.  Inputs are the same numpy arrays, made from a seed.

Tolerance: bitwise everywhere.  The port folds each output chunk in the
same nested order as the Pallas kernel (acc = x[(my-2-step) % P] +
arrival), so fp32 SUM is bit-equal; MAX and int32 are exact anyway.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as Pspec

import test_ring_flowcontrol as flowcontrol
from accl_tpu.ops import ring as jring
from accl_tpu_torch.ops import _build
from accl_tpu_torch.ops import ring as tring

NR = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread is enough, and it keeps this
    # module from crowding the other test workers' CPUs
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _mesh():
    devs = jax.devices()[:NR]
    if len(devs) < NR:
        pytest.skip(f"needs a {NR}-device mesh")
    return Mesh(np.array(devs), ("r",))


def _rand(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 100
    return x.astype(dtype)


def _jax_per_rank(fn, d):
    """Run fn(per-rank block) under shard_map; d is [NR, ...]."""
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=_mesh(),
                              in_specs=Pspec("r"), out_specs=Pspec("r"),
                              check_vma=False))
    return np.asarray(f(jnp.asarray(d)))


def _torch_ranks(d):
    return [torch.from_numpy(np.ascontiguousarray(d[r])) for r in range(NR)]


@pytest.mark.parametrize("P", range(2, 17))
def test_flow_control_algebra_matches_reference(P):
    for step in range(P):
        assert tring.ag_waits_ack(step, P) == jring.ag_waits_ack(step, P)
        assert tring.ag_signals_ack(step, P) == jring.ag_signals_ack(step, P)
        assert tring.rs_waits_ack(step, P) == jring.rs_waits_ack(step, P)
        assert tring.rs_signals_ack(step, P) == jring.rs_signals_ack(step, P)


@pytest.mark.parametrize("P", range(2, 9))
def test_port_algebra_passes_discrete_event_replay(P, monkeypatch):
    # the replay's schedules read the window predicates from its module
    # globals: point them at the port's and replay under adversarial
    # delivery (no overrun, no deadlock, balanced ACK ledger)
    for name in ("ag_waits_ack", "ag_signals_ack", "rs_waits_ack",
                 "rs_signals_ack"):
        monkeypatch.setattr(flowcontrol, name, getattr(tring, name))
    for program in (flowcontrol._ag_program, flowcontrol._rs_program):
        violations = flowcontrol._run_schedule(P, program, n_slots=2)
        assert not violations, "\n".join(violations[:5])


@pytest.mark.parametrize("dtype,op", [(np.float32, "sum"),
                                      (np.float32, "max"),
                                      (np.int32, "sum"),
                                      (np.int32, "max")])
def test_reduce_scatter_bitwise_vs_pallas(dtype, op):
    d = _rand((NR, NR, 256), dtype, seed=21)
    want = _jax_per_rank(
        lambda v: jring.ring_reduce_scatter_pallas(v, "r", op=op,
                                                   interpret=True), d)
    got = tring.ring_reduce_scatter(_torch_ranks(d), op)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_all_gather_bitwise_vs_pallas(dtype):
    d = _rand((NR, 256), dtype, seed=22)
    want = _jax_per_rank(
        lambda v: jring.ring_all_gather_pallas(v, "r", interpret=True), d)
    got = tring.ring_all_gather(_torch_ranks(d))
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


@pytest.mark.parametrize("dtype,op", [(np.float32, "sum"),
                                      (np.float32, "max"),
                                      (np.int32, "sum")])
def test_all_reduce_bitwise_vs_pallas(dtype, op):
    d = _rand((NR, NR * 128), dtype, seed=23)
    want = _jax_per_rank(
        lambda v: jring.ring_all_reduce_pallas(v, "r", op=op,
                                               interpret=True), d)
    got = tring.ring_all_reduce(_torch_ranks(d), op)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_all_reduce_segmented_ragged_bitwise():
    # N = 302 with seg 128: segments 128, 128, 46 (padded to 48)
    d = _rand((NR, 302), np.float32, seed=24)
    want = _jax_per_rank(
        lambda v: jring.ring_all_reduce_segmented(v, "r", seg_elems=128,
                                                  interpret=True), d)
    got = tring.ring_all_reduce_segmented(_torch_ranks(d), "sum",
                                          seg_elems=128)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_all_gather_and_reduce_scatter_segmented_ragged_bitwise():
    d = _rand((NR, 50), np.float32, seed=25)  # segments 32 + ragged 18
    want = _jax_per_rank(
        lambda v: jring.ring_all_gather_segmented(v, "r", seg_elems=32,
                                                  interpret=True), d)
    got = tring.ring_all_gather_segmented(_torch_ranks(d), seg_elems=32)
    for r in range(NR):
        np.testing.assert_array_equal(got[r].numpy(), want[r])

    d2 = _rand((NR, NR * 50), np.float32, seed=26)
    want2 = _jax_per_rank(
        lambda v: jring.ring_reduce_scatter_segmented(v, "r", seg_elems=32,
                                                      interpret=True), d2)
    got2 = tring.ring_reduce_scatter_segmented(_torch_ranks(d2), "sum",
                                               seg_elems=32)
    for r in range(NR):
        np.testing.assert_array_equal(got2[r].numpy(), want2[r])


def test_all_reduce_segmented_three_ranks_bitwise():
    # a ring size that divides neither the payload nor the segment: the
    # port's segment lengths and tail padding decide which rank owns which
    # element, hence the fold order — the same as accl_tpu/ops/ring.py:461
    P3 = 3
    devs = jax.devices()[:P3]
    mesh = Mesh(np.array(devs), ("r",))
    d = _rand((P3, 22), np.float32, seed=27)  # seg 6: 6, 6, 6, 4 (pad 6)
    f = jax.jit(jax.shard_map(
        lambda v: jring.ring_all_reduce_segmented(
            v[0], "r", seg_elems=8, interpret=True)[None],
        mesh=mesh, in_specs=Pspec("r"), out_specs=Pspec("r"),
        check_vma=False))
    want = np.asarray(f(jnp.asarray(d)))
    got = tring.ring_all_reduce_segmented(
        [torch.from_numpy(d[r].copy()) for r in range(P3)], "sum",
        seg_elems=8)
    for r in range(P3):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    assert tring.DEFAULT_SEG_ELEMS == jring.DEFAULT_SEG_ELEMS


def test_cpu_tensors_take_plain_version_without_launch():
    before = (tring.ring_reduce_scatter.launches,
              tring.ring_all_gather.launches)
    xs = [torch.ones(NR, 64) * r for r in range(NR)]
    out = tring.ring_reduce_scatter(xs)
    tring.ring_all_gather(out)
    assert (tring.ring_reduce_scatter.launches,
            tring.ring_all_gather.launches) == before
    assert torch.equal(out[0], torch.full((64,), 6.0))


def test_wrapper_refuses_other_devices_and_dtypes():
    meta = [torch.empty(NR, 8, device="meta") for _ in range(NR)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tring.ring_reduce_scatter(meta)
    with pytest.raises(ValueError, match="share device"):
        tring.ring_all_gather([torch.ones(8), torch.ones(8, dtype=torch.int32)])
    with pytest.raises(ValueError, match=r"\[P=2, n\]"):
        tring.ring_reduce_scatter([torch.ones(3, 8), torch.ones(3, 8)])


def test_kernel_build_raises_without_toolkit():
    # where there is no CUDA toolkit the kernels cannot be built: asking
    # for them raises instead of falling back to the plain versions
    if shutil.which("nvcc") is not None or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present here")
    saved = dict(_build._libs)
    _build._libs.clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("ring")
    finally:
        _build._libs.update(saved)
