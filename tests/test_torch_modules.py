"""Every module of the JAX package has a twin at the same path in
accl_tpu_torch, or stands in ``NO_TWIN`` with its reason; and every
entry of the table names a module that exists."""
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "accl_tpu"
PKG = ROOT / "accl_tpu_torch"

#: JAX module (path under accl_tpu/) -> why the port has no file there
NO_TWIN = {
    "backends/tpu.py": "its twin is backends/cuda.py (CudaWorld, the gang "
                       "engine on one card)",
    "utils/compat.py": "a JAX version shim (shard_map, lax.axis_size, "
                       "Pallas compiler params); PyTorch has nothing for "
                       "it to shim",
    "utils/platform.py": "an XLA_FLAGS host-device-count shim; PyTorch "
                         "has nothing for it to shim",
}
#: public functions of a twinned JAX module the port leaves out, and why
NOT_PORTED = {
    ("utils/bringup.py", "initialize_multihost"):
        "jax.distributed over TPU hosts: comes with multi-card worlds, "
        "ROADMAP.md Queue 1 item 13",
}


def _modules(pkg) -> list:
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py"))


@pytest.mark.parametrize("path", _modules(JAX_PKG))
def test_every_reference_module_has_a_twin_or_a_reason(path):
    if path in NO_TWIN:
        assert not (PKG / path).exists(), \
            f"{path} has a twin now: drop it from NO_TWIN"
    else:
        assert (PKG / path).exists(), \
            f"accl_tpu/{path} has no twin in accl_tpu_torch/ and no reason"


def test_table_names_reference_modules():
    for path in NO_TWIN:
        assert (JAX_PKG / path).exists(), path
    assert (PKG / "backends" / "cuda.py").exists()


@pytest.mark.parametrize("module,name", sorted(NOT_PORTED))
def test_not_ported_functions_are_named_and_absent(module, name):
    import ast

    def functions(path):
        return {n.name for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef)}

    assert name in functions(JAX_PKG / module)
    assert name not in functions(PKG / module)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert name in roadmap
