"""accl_tpu_torch/bench/online_spread.py on the CPU: the interleaved
reading of the online tuner drill's never-slower gate (the two sides
alternate round by round, each side's p50 over its own calls), and one
repetition of the bench on ``CudaWorld(8, device="cpu")``."""
import numpy as np
import pytest

from accl_tpu_torch.bench import online_spread as OSP


def test_interleaved_p50s_alternate_the_sides(monkeypatch):
    order, durs = [], iter(np.arange(1, 13) * 1e-6)
    state = {"side": None}

    def fake_call(world, count=OSP.COUNT):
        order.append(state["side"])
        return next(durs)

    monkeypatch.setattr(OSP, "call_s", fake_call)
    a, b = OSP.interleaved_p50s(
        None, calls=6, rounds=3,
        set_a=lambda: state.update(side="a"),
        set_b=lambda: state.update(side="b"))
    assert order == ["a", "a", "b", "b"] * 3
    # a: 1, 2, 5, 6, 9, 10 µs; b: 3, 4, 7, 8, 11, 12 µs
    assert a == pytest.approx(5.5) and b == pytest.approx(7.5)
    # nothing to set: one dispatch, the calls still split by round
    order.clear()
    durs = iter(np.arange(1, 13) * 1e-6)
    monkeypatch.setattr(OSP, "call_s",
                        lambda world, count=OSP.COUNT: next(durs))
    assert OSP.interleaved_p50s(None, 6, 3) == pytest.approx((5.5, 7.5))


def test_a_repetition_on_a_cpu_world(monkeypatch):
    """The bench's repetition, shrunk: the drill's straggler, then two
    sequential p50s and the interleaved pair of one dispatch."""
    row = OSP.repetition(calls=4, rounds=2, count=256, device="cpu")
    assert row["sleep_ms"] >= 5.0
    for key in ("sequential_p50s_us", "interleaved_p50s_us"):
        assert all(v >= row["sleep_ms"] * 1e3 for v in row[key])
    assert row["sequential_ratio"] > 0 and row["interleaved_ratio"] > 0
    spread = OSP.spread([row["sequential_ratio"], 1.0])
    assert spread["max_abs_dev_from_1"] >= 0
