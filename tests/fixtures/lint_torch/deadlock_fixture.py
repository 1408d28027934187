"""Seeded send/recv deadlock: a head-to-head exchange where both ranks
issue a blocking rendezvous-sized send before their recv.  Neither
send can complete until the peer posts its landing address — a
circular wait.  accl_lint must flag the cycle (``deadlock-cycle``)
and exit nonzero.
"""
import numpy as np

from accl_tpu_torch.constants import TAG_ANY  # noqa: F401 — doc pointer

LINT_RANKS = 2

# 4096 fp32 = 16 KB: far above the 1 KB eager threshold, so the send
# rides RENDEZVOUS and genuinely blocks on the matching recv
COUNT = 4096


def accl_main(accl, rank):
    peer = 1 - rank
    src = accl.create_buffer(COUNT, np.float32)
    dst = accl.create_buffer(COUNT, np.float32)
    accl.send(src, COUNT, dst=peer, tag=3)
    accl.recv(dst, COUNT, src=peer, tag=3)
