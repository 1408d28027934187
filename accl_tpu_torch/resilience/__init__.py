"""Fault-tolerant collectives: the detect -> recover bridge (the port's
own copy of ``accl_tpu/resilience/``).

1. Retransmission (:mod:`.retry`): the native engine's NACK lane heals
   a dropped, duplicated or seqn-corrupted eager segment inside the
   receive budget (``ACCL_RETRY_MAX`` / ``ACCL_RETRY_BASE_US``).
2. Abort and epoch fencing (``ACCL.abort``): every pending request on
   the communicator fails fast with ``COMM_ABORTED``; on ``CudaWorld``
   the abort also drains the engine's partial gangs and pending
   receives and fences the ring plans (``CudaEngine._comm_gen``).
3. Shrink (:mod:`.membership`): the survivors agree on who lives and
   build a fresh communicator without the dead.
4. Elastic membership (:mod:`.elastic`): a replacement joins a live
   world and the survivors mint a grown communicator.
5. The recovery supervisor (:mod:`.supervisor`, ``ACCL.supervise()``,
   ``ACCL_SUPERVISE=1``): the automated episode.

A seeded chaos injector (:mod:`.chaos`, ``ACCL_CHAOS``) drives it on the
native emulator (``backends/emu.py``).
"""
from .chaos import ChaosPlan
from .elastic import MembershipBoard, grow, join_grown_world
from .membership import probe_alive, shrink
from .retry import DEFAULT_RETRY_BASE_US, DEFAULT_RETRY_MAX, RetryPolicy
from .supervisor import RecoveryPolicy, RecoverySupervisor

__all__ = [
    "ChaosPlan",
    "MembershipBoard",
    "RecoveryPolicy",
    "RecoverySupervisor",
    "RetryPolicy",
    "DEFAULT_RETRY_MAX",
    "DEFAULT_RETRY_BASE_US",
    "grow",
    "join_grown_world",
    "probe_alive",
    "shrink",
]
