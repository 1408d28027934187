"""Where the port's CUDA kernels are built: a persistent build cache.

Port of ``accl_tpu/utils/compile_cache.py``.  The JAX package points
JAX's persistent compilation cache at a directory; the port's kernels are
``nvcc`` builds (``ops/_build.py``), each named by a hash of its sources
and flags, so a directory that outlives the process lets every later run
and tool reuse the libraries an earlier one built instead of paying the
compile again.  By default they build into the checkout's git-ignored
``build/accl_tpu_torch/``.

Best-effort by design: a directory that cannot be made leaves the build
where it was (with a warning); it never disables a kernel.
"""
from __future__ import annotations

import getpass
import os
import tempfile
from pathlib import Path


def _default_dir() -> str:
    # per-user path: a world-shared fixed dir would be created by the
    # first user and silently reject every other user's cache writes
    # (and is a library-poisoning surface on a shared host)
    try:
        user = getpass.getuser()
    except Exception:  # noqa: BLE001 — no passwd entry in a container
        user = f"uid{os.getuid()}" if hasattr(os, "getuid") else "user"
    return os.path.join(tempfile.gettempdir(), f"accl-torch-cache-{user}")


def enable(path: str | None = None) -> str | None:
    """Point the kernel build directory (``ops/_build.BUILD_DIR``) at
    `path` (default: $ACCL_COMPILE_CACHE or a per-user tmpdir
    location).  Returns the directory, or None when it could not be
    made (the build directory is then left as it was).  Call before the
    first kernel build."""
    from ..ops import _build

    path = path or os.environ.get("ACCL_COMPILE_CACHE", _default_dir())
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        from .logging import get_logger

        get_logger().warning("compile-cache disabled: %s: %s",
                             type(e).__name__, e)
        return None
    _build.BUILD_DIR = Path(path)
    return path
