"""accl_tpu_torch stands alone: it imports torch, numpy and the standard
library, never JAX, ml_dtypes or the JAX package; and its entry points
run on the card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "accl_tpu_torch"
SUBMODULES = ["accl", "arithconfig", "buffer", "communicator", "constants",
              "request", "state", "backends.base", "backends.cuda",
              "ops.ring", "ops.quantized", "ops.fused", "ops.flash",
              "ops.reduce_ops", "ops.compression", "ops._build", "parallel",
              "parallel.collectives", "parallel.mesh",
              "parallel.ring_attention", "parallel.strategies", "models",
              "models.transformer", "models.decode", "bench",
              "bench.ef_convergence", "bench.timing", "bench.flash_sweep",
              "bench.kernel_tune", "bench.flash_bwd_split", "utils.device",
              "utils.logging", "utils.tree"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "accl_tpu")


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import accl_tpu_torch\n"
        + "".join(f"import accl_tpu_torch.{m}\n" for m in SUBMODULES)
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PKG))
                                        for p in PKG.rglob("*.py")))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def test_cuda_world_defaults_to_the_card_and_raises_without_one():
    from accl_tpu_torch import ACCLError, CudaWorld

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ACCLError, match="no CUDA device"):
        CudaWorld(2)
    with pytest.raises(ACCLError, match="no CUDA device"):
        CudaWorld(2, device="cuda")


def test_cuda_world_on_the_cpu_when_asked():
    from accl_tpu_torch import CudaWorld

    with CudaWorld(2, device="cpu") as w:
        assert w.engine.device.type == "cpu"
        assert w.accls[1].rank == 1 and w.accls[0].size == 2


def test_model_entry_points_default_to_the_card_and_raise_without_one():
    import io

    import numpy as np

    from accl_tpu_torch import ACCLError, model_params_from_jax
    from accl_tpu_torch.bench.ef_convergence import run_ef_convergence
    from accl_tpu_torch.models import ModelConfig, init_kv_cache, init_params
    from accl_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ModelConfig(vocab=8, d_model=4, n_layers=1, n_heads=2, d_head=2,
                      d_ff=4)
    rng = np.random.default_rng(0)
    calls = [lambda: init_params(rng, cfg),
             lambda: init_kv_cache(cfg, 1, 4),
             lambda: make_mesh(tp=2),
             lambda: model_params_from_jax({}, cfg),
             lambda: run_ef_convergence(io.StringIO(), steps=1)]
    for call in calls:
        with pytest.raises(ACCLError, match="no CUDA device"):
            call()
    params = init_params(rng, cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert make_mesh(tp=2, device="cpu").shape == {"tp": 2}
