"""AFT zones — automatic fault tolerance (paper §3, Listings 8/9).

The paper wraps the protected region in ``AFT_BEGIN(comm)``/``AFT_END()``
macros that expand to a while-loop around a try/catch: a process failure
raises, the catch block repairs the communicator (revoke → shrink → agree,
then spawn+merge for non-shrinking recovery), and the body re-enters —
re-reading the latest checkpoint through ``restartIfNeeded()``.

Python has no macros, so the primary API is the functional zone::

    def body(comm):
        cp = Checkpoint("state", comm)        # INSIDE the zone, like Listing 9
        it = Box(0); cp.add("it", it); ...; cp.commit()
        cp.restart_if_needed()
        while it.value < n:
            ...
            cp.update_and_write(it.value, freq)
        return result

    result = aft_zone(comm, body)

Semantics preserved from the paper:
  * any member may detect the failure; ``revoke()`` makes it global,
  * recovery policy: SHRINKING or NON-SHRINKING (CRAFT_COMM_RECOVERY_POLICY),
  * spawned replacements execute the *same program* from the top and land
    directly in the zone body with the repaired communicator,
  * checkpoints must be (re-)defined inside the zone so every retry re-reads
    the latest consistent version.

A lower-level ``AftZone`` with explicit ``begin()/failed()/end()`` is also
provided for code that cannot be expressed as a callable body.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional, TypeVar

from repro_torch.core.comm import CommError, FTComm, ProcFailedError, RevokedError
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.env import CraftEnv

log = logging.getLogger("craft.aft")
T = TypeVar("T")


class AftAbortedError(RuntimeError):
    """The zone exceeded ``max_recoveries`` and gave up."""


def _drop_failed_memory(stats: dict) -> None:
    """Tell the memory tier which ranks' RAM died with this recovery.

    The zone body re-created after recovery restores through
    ``restart_if_needed()``; with the memory tier chained first, survivors
    then reconstruct the failed ranks' shards from the peer replicas that
    are still resident — no disk read.  Idempotent with the simulator's
    fault-domain kill hooks.
    """
    failed = stats.get("failed")
    if failed:
        from repro_torch.core.mem_level import notify_rank_failures

        notify_rank_failures(failed)


def _reprotect_memory(comm: FTComm, env: CraftEnv) -> int:
    """Re-establish full RAM-fabric replica placement after a NON-SHRINKING
    recovery: replacement ranks take over the failed ranks' holder slots, so
    the fabric again tolerates ``CRAFT_MEM_REPLICAS`` failures (the spawned
    ranks themselves hydrate their *own* slices lazily via
    ``restart_if_needed()`` → ``MemStore.rehydrate``).  Returns slots seeded.
    """
    from repro_torch.core.mem_level import MemFabric

    return MemFabric.instance().reprotect(comm.size, env.mem_replicas)


def _notify_scheduler(stats: dict) -> None:
    """Bump the process-wide recovery epoch: every live checkpoint policy
    resets its write-cost estimators (the survivor layout changed) and
    forces its next write to be a full, self-contained one."""
    from repro_torch.core import scheduler

    scheduler.notify_recovery(stats)


def aft_zone(
    comm: FTComm,
    body: Callable[[FTComm], T],
    *,
    policy: Optional[str] = None,
    max_recoveries: int = 16,
    env: Optional[CraftEnv] = None,
    on_recovery: Optional[Callable[[FTComm, dict], None]] = None,
) -> T:
    """Run ``body(comm)`` with automatic failure recovery; returns its value."""
    env = env if env is not None else CraftEnv.capture()
    policy = (policy or comm.default_recovery_policy
              or env.comm_recovery_policy).upper()
    recoveries = 0
    while True:
        try:
            result = body(comm)
            # ULFM recipe: agree on collective success before leaving the
            # zone, so no member exits while another is about to fail over.
            if not comm.agree(True):
                raise ProcFailedError("exit agreement failed")
            return result
        except (ProcFailedError, RevokedError, CheckpointError) as exc:
            # a peer's failure met on the async writer thread surfaces as
            # the cause of a CheckpointError; the synchronous write path
            # raises the same failure bare
            if isinstance(exc, CheckpointError) and not isinstance(
                    exc.__cause__, (ProcFailedError, RevokedError)):
                raise
            recoveries += 1
            if recoveries > max_recoveries:
                raise AftAbortedError(
                    f"gave up after {max_recoveries} recoveries"
                ) from exc
            t0 = time.perf_counter()
            try:
                comm.revoke()            # asymmetric: make the failure global
            except CommError:
                pass
            comm = comm.recover(policy=policy)
            stats = comm.last_recovery_stats()
            _drop_failed_memory(stats)
            if policy == "NON-SHRINKING":
                stats["mem_reseeded"] = _reprotect_memory(comm, env)
            _notify_scheduler(stats)
            log.warning(
                "AFT recovery #%d (%s): failed=%s, %.3fs",
                recoveries, policy, stats.get("failed"),
                time.perf_counter() - t0,
            )
            if on_recovery is not None:
                on_recovery(comm, stats)


class AftZone:
    """Explicit begin/end form (the AFT_BEGIN/AFT_END macros).

        zone = AftZone(comm)
        while zone.active():
            try:
                with zone:
                    ... body using zone.comm ...
            except zone.FAILURES:
                zone.failed()
    """

    FAILURES = (ProcFailedError, RevokedError)

    def __init__(self, comm: FTComm, policy: Optional[str] = None,
                 max_recoveries: int = 16, env: Optional[CraftEnv] = None):
        env = env if env is not None else CraftEnv.capture()
        self.comm = comm
        self.env = env
        self.policy = (policy or comm.default_recovery_policy
                       or env.comm_recovery_policy).upper()
        self.max_recoveries = max_recoveries
        self.recoveries = 0
        self._done = False

    def active(self) -> bool:
        return not self._done

    def __enter__(self) -> "AftZone":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is None:
            if not self.comm.agree(True):
                self.failed()
                return True
            self._done = True
            return False
        return False  # propagate; caller's except zone.FAILURES handles it

    def failed(self) -> None:
        self.recoveries += 1
        if self.recoveries > self.max_recoveries:
            raise AftAbortedError(f"gave up after {self.max_recoveries} recoveries")
        try:
            self.comm.revoke()
        except CommError:
            pass
        self.comm = self.comm.recover(policy=self.policy)
        stats = self.comm.last_recovery_stats()
        _drop_failed_memory(stats)
        if self.policy == "NON-SHRINKING":
            stats["mem_reseeded"] = _reprotect_memory(self.comm, self.env)
        _notify_scheduler(stats)
