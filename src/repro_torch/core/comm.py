"""FTComm — fault-tolerant communicator with ULFM semantics (paper §3.1).

ULFM-MPI gives CRAFT three primitives on top of plain MPI:

  * ``MPIX_Comm_revoke``  — any single member can invalidate the communicator
    (asymmetric call; everyone else learns at their next operation),
  * ``MPIX_Comm_shrink``  — collective consensus producing a healthy
    communicator without the failed members,
  * ``MPIX_Comm_agree``   — fault-tolerant agreement among survivors,

plus the error codes ``MPIX_ERR_PROC_FAILED`` / ``MPIX_ERR_REVOKED``.

TPU/JAX adaptation (DESIGN.md §2): there is no fault-tolerant runtime inside
a jitted program — a failed host kills that process.  Failure *detection*
therefore lives at the runtime layer (connection EOF / heartbeat timeout /
collective deadlines — straggler mitigation), and the ULFM *semantics*
(revoke → shrink → agree ordering, shrinking vs non-shrinking recovery,
spawn with REUSE / NO-REUSE node policies) are preserved exactly in two
backends:

  * :mod:`repro_torch.core.comm_sim` — deterministic in-process simulator
    (threads), used by unit tests and large-scale recovery benchmarks,
  * :mod:`repro_torch.runtime` — a real multi-process cluster where ``kill -9`` of
    a worker is the paper's fail-stop fault model.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, List, Optional


class CommError(RuntimeError):
    """Base class of communicator errors."""


class ProcFailedError(CommError):
    """A peer process failed (ULFM: MPIX_ERR_PROC_FAILED)."""

    def __init__(self, msg: str = "", failed: Optional[List[int]] = None):
        super().__init__(msg or f"process failure detected (failed={failed})")
        self.failed = list(failed or [])


class RevokedError(CommError):
    """The communicator was revoked (ULFM: MPIX_ERR_REVOKED)."""


class KilledError(BaseException):
    """Raised inside a simulated rank that was killed (not catchable as
    Exception so user code cannot accidentally swallow its own death)."""


class FTComm(abc.ABC):
    """Protocol shared by the simulator and the multiprocessing backend."""

    # --- identity -----------------------------------------------------------
    @property
    @abc.abstractmethod
    def rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def size(self) -> int: ...

    @abc.abstractmethod
    def node_id(self) -> int: ...

    @abc.abstractmethod
    def procs_per_node(self) -> int: ...

    @property
    def epoch(self) -> int:
        return 0

    # --- collectives ----------------------------------------------------------
    @abc.abstractmethod
    def barrier(self, channel: str = "main") -> None: ...

    @abc.abstractmethod
    def allreduce(self, value, op: str = "sum", channel: str = "main"): ...

    def allreduce_min(self, value):
        return self.allreduce(value, op="min")

    def allreduce_sum(self, value):
        return self.allreduce(value, op="sum")

    def allreduce_max(self, value):
        return self.allreduce(value, op="max")

    @abc.abstractmethod
    def bcast(self, value, root: int = 0, channel: str = "main"): ...

    # --- ULFM extensions --------------------------------------------------------
    @abc.abstractmethod
    def revoke(self) -> None:
        """Invalidate the current epoch (asymmetric, any member may call)."""

    @abc.abstractmethod
    def agree(self, flag: bool = True) -> bool:
        """Fault-tolerant agreement among live members (logical AND)."""

    @abc.abstractmethod
    def recover(self, policy: Optional[str] = None) -> "FTComm":
        """Repair the communicator after failure; returns the healthy comm.

        ``policy``: SHRINKING or NON-SHRINKING (default: the environment's
        CRAFT_COMM_RECOVERY_POLICY).  Collective over the surviving members;
        newly spawned replacements join during the call (non-shrinking).
        """

    # --- introspection -----------------------------------------------------------
    def failed_ranks(self) -> List[int]:
        return []

    def last_recovery_stats(self) -> dict:
        """Per-phase timing of the most recent recovery (paper Table 3)."""
        return {}

    @property
    def default_recovery_policy(self) -> Optional[str]:
        """Backend-configured recovery policy, if any (overrides env)."""
        return None

    def is_replacement(self) -> bool:
        """True if this process was spawned to replace a failed rank."""
        return False

    def fault_domain(self) -> Optional[Any]:
        """Backend object observing rank deaths, if any.

        A fault domain exposes ``add_kill_hook(fn)``; ``fn(rank)`` fires when
        a rank is fail-stopped, *before* peers detect the failure.  The
        memory tier uses it to model RAM loss (a dead process's shards and
        the replicas it held vanish).  Backends without in-process fault
        injection (real clusters — the OS reclaims the RAM for us) return
        None.
        """
        return None


class ChannelComm:
    """Proxy routing every collective onto a fixed named channel.

    Collectives are matched per (epoch, channel, sequence); giving each
    ``Checkpoint`` its own channel lets the asynchronous writer thread
    barrier concurrently with the application's own collectives on "main"
    without sequence interleaving (which would deadlock an SPMD program).
    """

    def __init__(self, comm: FTComm, channel: str):
        self._comm = comm
        self._channel = channel

    def __getattr__(self, name: str) -> Any:
        return getattr(self._comm, name)

    @property
    def rank(self) -> int:
        return self._comm.rank

    @property
    def size(self) -> int:
        return self._comm.size

    def barrier(self, channel: Optional[str] = None) -> None:
        self._comm.barrier(channel=channel or self._channel)

    def allreduce(self, value, op: str = "sum", channel: Optional[str] = None):
        return self._comm.allreduce(value, op=op, channel=channel or self._channel)

    def allreduce_min(self, value):
        return self.allreduce(value, op="min")

    def allreduce_sum(self, value):
        return self.allreduce(value, op="sum")

    def allreduce_max(self, value):
        return self.allreduce(value, op="max")

    def bcast(self, value, root: int = 0, channel: Optional[str] = None):
        return self._comm.bcast(value, root=root, channel=channel or self._channel)


class NullComm(FTComm):
    """Single-process communicator (rank 0 of 1); every op is a no-op."""

    @property
    def rank(self) -> int:
        return 0

    @property
    def size(self) -> int:
        return 1

    def node_id(self) -> int:
        return 0

    def procs_per_node(self) -> int:
        return 1

    def barrier(self, channel: str = "main") -> None:
        pass

    def allreduce(self, value, op: str = "sum", channel: str = "main"):
        return value

    def bcast(self, value, root: int = 0, channel: str = "main"):
        return value

    def revoke(self) -> None:
        pass

    def agree(self, flag: bool = True) -> bool:
        return bool(flag)

    def recover(self, policy: Optional[str] = None) -> "NullComm":
        return self
