"""The public names of accl_tpu and of its ops, parallel, models,
observability, bench, analysis, plans, tuning, backends, utils and
resilience subpackages, against accl_tpu_torch's.

Every public name of the JAX package is in the port under the same name,
under the name ``RENAMED`` gives it, or in ``MISSING`` with the ROADMAP.md
Queue 1 item that brings it, and ROADMAP.md names it.  A name that is
neither fails, so a gap cannot slip through unlisted; a name in MISSING
that the port has since gained fails too, so the table stays current.
Names only the port has are allowed.
"""
import importlib
import pathlib
import types

import pytest

ROADMAP = (pathlib.Path(__file__).resolve().parents[1]
           / "ROADMAP.md").read_text()

SUBPACKAGES = ("", ".ops", ".parallel", ".models", ".observability",
               ".bench", ".analysis", ".plans", ".tuning", ".backends",
               ".utils", ".resilience")

#: (subpackage, JAX name) -> the port's name for it
RENAMED = {
    (".ops", "ring_all_gather_pallas"): "ring_all_gather",
    (".ops", "ring_reduce_scatter_pallas"): "ring_reduce_scatter",
    (".ops", "ring_all_reduce_pallas"): "ring_all_reduce",
}

#: (subpackage, JAX name) -> the Queue 1 item of ROADMAP.md that ports it
MISSING: dict = {}


def public_names(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


def queue1_item(number: int) -> str:
    """The text of ROADMAP.md's Queue 1 item ``number``."""
    queue = ROADMAP.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    start = queue.index(f"\n{number}. ")
    nxt = queue.find(f"\n{number + 1}. ", start + 1)
    return queue[start:nxt if nxt > 0 else len(queue)]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_name_is_ported_renamed_or_queued(sub):
    jax_names = public_names(importlib.import_module("accl_tpu" + sub))
    port = importlib.import_module("accl_tpu_torch" + sub)
    port_names = public_names(port)
    unlisted = []
    for name in sorted(jax_names):
        key = (sub, name)
        if key in RENAMED:
            assert RENAMED[key] in port_names, (key, RENAMED[key])
        elif key in MISSING:
            assert name not in port_names, \
                f"{key} is ported now: drop it from MISSING"
            assert name in queue1_item(MISSING[key]), \
                f"ROADMAP.md Queue 1 item {MISSING[key]} does not name {name}"
        elif name not in port_names:
            unlisted.append(name)
    assert not unlisted, f"accl_tpu{sub} names the port lacks, unlisted: " \
        f"{unlisted}"


def test_tables_name_only_reference_names():
    for (sub, name) in (*RENAMED, *MISSING):
        assert name in public_names(importlib.import_module("accl_tpu" + sub))


def test_renamed_ring_entries_are_the_ring_module_functions():
    from accl_tpu_torch import ops
    from accl_tpu_torch.ops import ring

    for name in ("ring_all_gather", "ring_reduce_scatter", "ring_all_reduce",
                 "ring_all_gather_segmented", "ring_reduce_scatter_segmented",
                 "ring_all_reduce_segmented"):
        assert getattr(ops, name) is getattr(ring, name)


def test_analysis_exports_every_reference_export():
    """accl_tpu.analysis exports lazily (PEP 562 ``__all__``), so its
    names are compared through ``__all__`` and resolved one by one."""
    jax_all = importlib.import_module("accl_tpu.analysis").__all__
    port = importlib.import_module("accl_tpu_torch.analysis")
    assert list(port.__all__) == list(jax_all)
    for name in jax_all:
        obj = getattr(port, name)
        assert obj.__module__.startswith("accl_tpu_torch.analysis."), name
