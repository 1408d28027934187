"""The port's bench tools (accl_tpu_torch/bench/timing.py, flash_sweep.py,
kernel_tune.py and flash_bwd_split.py) on the CPU at tiny shapes, with device="cpu": the
harness chains and interleaves, the sweep collapses candidates that
differ only in options the card ignores into aliases of one timing, and
the tuning sweeps cover their grids.  No time from here is a device
time; these check the control flow and what is counted.
"""
import pytest
import torch

from accl_tpu_torch import ACCLError
from accl_tpu_torch.bench import flash_bwd_split as FBS
from accl_tpu_torch.bench import flash_sweep as FS
from accl_tpu_torch.bench import kernel_tune as KT
from accl_tpu_torch.bench import timing


def test_harness_chains_and_interleaves():
    timed_chain, timed_chain_ab = timing.make_harness("cpu")
    seen = []

    def step(v, c):
        seen.append(float(v[0]))
        return v + c

    s = timed_chain(step, torch.zeros(3), iters=4, trials=2,
                    consts=(torch.ones(3),))
    assert s > 0
    # one warm-up call, then each trial chains from x0: 0, 1, 2, 3
    assert seen == [0.0] + [0.0, 1.0, 2.0, 3.0] * 2
    order = []

    def tagged(tag):
        def fn(v):
            order.append(tag)
            return v
        return fn

    best = timed_chain_ab({"a": tagged("a"), "b": tagged("b")},
                          torch.zeros(1), iters=1, trials=3)
    assert set(best) == {"a", "b"} and all(v > 0 for v in best.values())
    # a and b alternate round by round (each: warm-up + one timed call)
    assert order == ["a", "a", "b", "b"] * 3


def test_harness_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ACCLError, match="no CUDA device"):
        timing.make_harness()


def test_sweep_collapses_what_the_card_ignores():
    cands = FS.build(FS.D128_SPECS)
    groups, refused = FS.collapse(cands, d=128, t=2048)
    assert refused == {}
    # the card honours the schedule, static_max and the input dtype only
    assert sorted(groups) == ["bq256_bk512", "bq256_bk512_bf16in",
                              "bq256_bk512_grid", "bq256_bk512_skew",
                              "bq256_bk512_sm40"]
    assert set(groups["bq256_bk512"]) == {
        "bq256_bk512", "bq512_bk512", "bq512_bk512_qt2", "bq256_bk512_qt2",
        "bq512_bk1024", "bq512_bk1024_qt2", "bq256_bk1024",
        "bq512_bk512_cast", "bq512_bk512_qt2_ck256"}
    assert set(groups["bq256_bk512_sm40"]) == {
        "bq256_bk512_sm40", "bq512_bk512_sm40", "bq256_bk512_sm40_qt2"}
    assert FS.card_key(cands["bq256_bk512_skew"])[0] == \
        "flash_fwd_resident_skew"
    # the D=64 twin: fuse_denom is ignored on the card, static_max is not
    groups64, _ = FS.collapse(FS.build(FS.D64_SPECS), d=64, t=2048)
    assert sorted(groups64) == ["d64_resident", "d64_resident_fd_sm40"]
    # a refused candidate carries the resolver's error
    bad = {"skew_qt2": FS.make_variant(256, 512, qt=2,
                                       kernel="resident_skew")}
    _, refused = FS.collapse(bad)
    assert "single-chain" in refused["skew_qt2"]


def test_sweep_times_each_card_candidate_once():
    timed_chain, _ab = timing.make_harness("cpu")
    cands = FS.build(FS.D128_SPECS)
    calls = {}

    def counting(name, fn):
        def wrapped(x, kk, vv):
            calls[name] = calls.get(name, 0) + 1
            return fn(x, kk, vv)
        wrapped.opts = fn.opts
        return wrapped

    cands = {n: counting(n, f) for n, f in cands.items()}
    cands["skew_qt2"] = FS.make_variant(256, 512, qt=2,
                                        kernel="resident_skew")
    best, best_mm, aliases = FS.run_sweep(
        timed_chain, cands, rounds=2, device="cpu", b=1, t=64, d=32,
        iters=1, mm_n=32, mm_iters=1, log=lambda m: None)
    # representatives only: per round one warm-up and one timed call
    assert sorted(calls) == ["bq256_bk512", "bq256_bk512_bf16in",
                             "bq256_bk512_grid", "bq256_bk512_skew",
                             "bq256_bk512_sm40"]
    assert set(calls.values()) == {4}
    assert best["bq512_bk1024"] == best["bq256_bk512"]
    assert aliases["bq512_bk1024"] == "bq256_bk512"
    assert "single-chain" in best["skew_qt2"]
    rep = FS.report(best, best_mm, aliases,
                    flops=FS.causal_flops(1, 64, 16, 32), mm_n=32)
    sched = rep["schedules"]
    assert sched["bq512_bk1024"]["alias_of"] == "bq256_bk512"
    assert "alias_of" not in sched["bq256_bk512"]
    assert sched["bq256_bk512"]["tflops"] > 0 and "error" in sched[
        "skew_qt2"]
    assert len(sched) == len(cands)


def test_sweep_inputs_follow_the_shape_of_record():
    q, k, v = FS.make_inputs(d=64, device="cpu", b=1, t=16)
    assert q.shape == (8, 16, 64) and q.dtype == torch.float32
    q2, _, _ = FS.make_inputs(d=128, device="cpu", b=1, t=16)
    assert q2.shape == (4, 16, 128)
    assert torch.equal(q, FS.make_inputs(d=64, device="cpu", b=1, t=16)[0])
    assert FS.causal_flops() == FS.causal_flops(h=8, d=64)


def test_tune_flash_times_one_kernel_per_schedule():
    res = KT.tune_flash("cpu", shape=(1, 64, 2, 32), rounds=1, iters=1,
                        log=lambda m: None)
    rows = res["results"]
    assert len(rows) == len(KT.FLASH_KERNELS) * len(KT.FLASH_BLOCKS)
    timed = [r for r in rows if "alias_of" not in r]
    assert sorted(r["kernel"] for r in timed) == ["grid", "resident"]
    for r in rows:
        if "alias_of" in r:
            assert r["alias_of"][0] == r["kernel"]
            assert r["s"] == next(t["s"] for t in timed
                                  if t["kernel"] == r["kernel"])


def test_tune_compress_covers_its_grid_beside_tensor_to():
    from accl_tpu_torch.ops import compression as TC

    before = TC._cast_2d.launches
    res = KT.tune_compress("cpu", n=1 << 14, cols=(128, 512, 4096),
                           block_rows=(4, 16, 64), rounds=2, iters=1,
                           log=lambda m: None)
    keys = {(r["cols"], r["block_rows"]) for r in res["results"]}
    # every geometry with at least block_rows rows, and the Tensor.to pair
    assert keys == {(128, 4), (128, 16), (128, 64), (512, 4), (512, 16),
                    (4096, 4), ("Tensor.to", 0)}
    assert res["best"]["cols"] != "Tensor.to"
    assert all(r["GBps"] > 0 for r in res["results"])
    assert "not a device time" in res["device"]
    assert TC._cast_2d.launches == before  # the CPU runs no kernel


def test_kernel_tune_cli_parses():
    with pytest.raises(SystemExit):
        KT.main(["bogus"])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_bwd_split_operands_are_the_backward_prep(dt):
    """The split tool's operands at a tiny shape are what the autograd
    backward hands the kernels: dq, dk and dv through the wrappers (the
    plain versions on the CPU) equal the packed entry's gradients."""
    from accl_tpu_torch.ops import flash as TFL

    shape = (4, 2, 64, 32)
    gen = torch.Generator().manual_seed(5)
    ops, cfg = FBS.operands(TFL, dt, gen, shape)
    q2, k, v, do, l2, dvec = ops
    assert q2.shape == do.shape == (4, 64, 32) and k.shape == (2, 64, 32)
    assert q2.dtype == dt and l2.dtype == dvec.dtype == torch.float32
    assert cfg[4] == dt and cfg[0] and cfg[-1] == 2
    before = (TFL.flash_bwd_dq.launches, TFL.flash_bwd_dkv.launches)
    dq = TFL.flash_bwd_dq(*ops, cfg)
    dk, dv = TFL.flash_bwd_dkv(*ops, cfg)
    assert (TFL.flash_bwd_dq.launches, TFL.flash_bwd_dkv.launches) == before
    gen = torch.Generator().manual_seed(5)
    q, kk, vv = (torch.randn(s, generator=gen).to(dt).requires_grad_(True)
                 for s in ((4, 64, 32), (2, 64, 32), (2, 64, 32)))
    g_out = torch.randn((4, 64, 32), generator=gen).to(dt)
    out, _lse = TFL.flash_attention_packed_lse(q, kk, vv, causal=True,
                                               mxu_dtype=dt)
    out.backward(g_out)
    # q2 is rounded to the input dtype: dq = dS K a, the same products
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for got, want in ((dq, q.grad), (dk, kk.grad), (dv, vv.grad)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_flash_bwd_split_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["flash_bwd_split"])
    assert FBS.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
