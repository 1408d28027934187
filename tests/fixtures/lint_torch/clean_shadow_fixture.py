"""The clean program of clean_fixture.py, run for real on the port's
native emulator world (``EmuWorld``) as ``__main__``: accl_lint's shadow
mode captures it and every checker must come back empty."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from clean_fixture import LINT_RANKS, accl_main  # noqa: E402

from accl_tpu_torch.backends.emu import EmuWorld  # noqa: E402

if __name__ == "__main__":
    with EmuWorld(LINT_RANKS) as world:
        world.run(accl_main)
