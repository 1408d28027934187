"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into the
git-ignored ``build/accl_tpu_torch/`` directory beside the package, and
loaded with ``ctypes``.  The library name carries a hash of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source is
rebuilt and a current one is reused.  Nothing here runs at import time: a machine without ``nvcc``
imports the package and fails only when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "accl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_f32, _u32, _ll = ctypes.c_float, ctypes.c_uint, ctypes.c_longlong
#: C signatures of each library's entry points: name -> (argtypes, restype)
SIGNATURES = {
    "ring": {
        "accl_ring_error_string": ([_i32], ctypes.c_char_p),
        "accl_ring_resident": ([_i32, _i32, _i32], _i32),
        "accl_ring_launch": ([_i32, _i32, _vp, _vp, _i32, _i32, _vp, _vp, _vp,
                              _i32, _vp], _i32),
    },
    "fused": {
        "accl_fused_error_string": ([_i32], ctypes.c_char_p),
        "accl_fused_kernel_info": ([_i32, _i32, _vp], _i32),
        "accl_matmul": ([_vp, _vp, _vp, _i64, _i64, _i64, _i32, _i32, _i32,
                         _i64, _i32, _vp, _vp, _i32, _vp], _i32),
        "accl_fused_resident": ([_i32, _i32], _i32),
        "accl_fused_matmul_rs": ([_vp, _vp, _vp, _i64, _i64, _i64, _i32,
                                  _i32, _i32, _i32, _vp, _vp, _i32, _vp],
                                 _i32),
    },
    "flash": {
        "accl_flash_error_string": ([_i32], ctypes.c_char_p),
        "accl_flash_ctas": ([_i32, _i32], ctypes.c_longlong),
        "accl_flash_fwd_resident": ([_vp] * 5 + [_i32] * 9 + [_f32, _f32, _i32,
                                                               _vp], _i32),
        "accl_flash_fwd_grid": ([_vp] * 5 + [_i32] * 10 + [_f32, _f32, _i32,
                                                            _vp], _i32),
        "accl_flash_fwd_resident_skew": ([_vp] * 5 + [_i32] * 9
                                         + [_f32, _f32, _i32, _vp], _i32),
    },
    "flash_bwd": {
        "accl_flash_bwd_error_string": ([_i32], ctypes.c_char_p),
        "accl_flash_bwd_kernel_info": ([_i32] * 5 + [_vp], _i32),
        "accl_flash_bwd_dq": ([_vp] * 7 + [_i32] * 9 + [_f32, _i32, _vp],
                              _i32),
        "accl_flash_bwd_dkv": ([_vp] * 12 + [_i32] * 10 + [_i32, _vp], _i32),
    },
    "reduce_ops": {
        "accl_reduce_ops_error_string": ([_i32], ctypes.c_char_p),
        "accl_combine": ([_vp, _vp, _vp, _ll, _ll, _i32, _i32, _i32, _vp],
                         _i32),
    },
    "compression": {
        "accl_compression_error_string": ([_i32], ctypes.c_char_p),
        "accl_cast": ([_vp, _vp, _ll, _ll, _ll, _i32, _i32, _i32, _u32, _i32,
                       _vp], _i32),
    },
}

_lock = threading.Lock()
_libs: dict = {}
#: seconds each library took to build in this process (0.0 when reused)
build_seconds: dict = {}
#: what nvcc printed for each library built in this process (-Xptxas -v)
build_log: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin``, else the CUDA
    toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of accl_tpu_torch "
                       "are built at first use and need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    """The library path for one source: its name carries a hash of the
    source, every shared header in csrc/ and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        build_seconds[name] = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stderr
    return out


def build_all() -> dict:
    """Compile every library not yet built, one ``nvcc`` per source, all
    started together.  Returns the bound libraries by name."""
    with _lock:
        todo = [n for n in SIGNATURES if n not in _libs]
        with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
            paths = dict(zip(todo, pool.map(_compile, todo)))
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return dict(_libs)


def load(name: str):
    """The bound library ``name``, building it first if needed."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]
