"""SimComm — deterministic in-process FTComm backend (threads as ranks).

Purpose (DESIGN.md §2): unit-test the ULFM semantics (revoke / shrink /
agree / spawn ordering, AFT-zone retry) without real processes, and run
recovery *bookkeeping* scaling benchmarks far past what one CPU can host as
real processes.  The fault model is ``world.kill(rank)``: the rank is marked
fail-stop dead (its thread raises an uncatchable ``KilledError`` at its next
communicator call), and every peer discovers the failure at its next
operation — exactly ULFM's detection contract.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from repro_torch.core import trace
from repro_torch.core.comm import FTComm, KilledError
from repro_torch.core.env import CraftEnv
from repro_torch.core.ftengine import CollectiveEngine, NodePool


class SimWorld:
    """Holds the engine, the rank threads, and the fault-injection API."""

    def __init__(
        self,
        n_procs: int,
        procs_per_node: int = 1,
        spare_nodes: int = 0,
        env: Optional[CraftEnv] = None,
    ):
        self.n_procs = n_procs
        self.ppn = max(1, procs_per_node)
        self.env = env if env is not None else CraftEnv.capture({})
        n_nodes = (n_procs + self.ppn - 1) // self.ppn
        members = {r: r // self.ppn for r in range(n_procs)}
        self.engine = CollectiveEngine(members)
        for r in range(n_procs):
            self.engine.set_occupant(0, r, f"u{r}")
        self.engine.set_spawn_policy(self.env.comm_spawn_policy)
        self.pool = NodePool(n_nodes, spare_nodes)
        self._lock = threading.Lock()
        self._dead: set = set()
        self._threads: List[threading.Thread] = []
        self._results: Dict[int, object] = {}
        self._errors: Dict[int, BaseException] = {}
        self._fn: Optional[Callable] = None
        self._uid = 0
        # fault-domain observers: fn(rank) fires inside kill() so RAM-tier
        # state vanishes atomically with the fail-stop (see FTComm.fault_domain)
        self._kill_hooks: List[Callable[[int], None]] = []

    # ---------------------------------------------------------------- launch
    def run(self, fn: Callable[["SimComm"], object], timeout: float = 120.0):
        """Run ``fn(comm)`` on every rank; returns {token: result} of every
        incarnation that returned (dead incarnations are absent)."""
        self._fn = fn
        for r in range(self.n_procs):
            self._start_thread(r, eid=0, replacement=False, uid=f"u{r}")
        import time as _time
        deadline = _time.monotonic() + timeout
        i = 0
        while True:
            with self._lock:
                threads = list(self._threads)
            if i >= len(threads):
                break
            t = threads[i]
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
            if t.is_alive():
                raise TimeoutError(f"sim thread {t.name} did not finish")
            i += 1
        if self._errors:
            rank, err = next(iter(self._errors.items()))
            raise RuntimeError(f"sim rank {rank} crashed: {err!r}") from err
        return dict(self._results)

    def _start_thread(self, rank: int, eid: int, replacement: bool,
                      uid: Optional[str] = None) -> None:
        if uid is None:
            with self._lock:
                self._uid += 1
                uid = f"spawn{self._uid}"

        def runner():
            comm = SimComm(self, rank, eid, replacement=replacement, uid=uid)
            if replacement:
                self.engine.register_member(eid, rank, token=uid)
            try:
                result = self._fn(comm)
                with self._lock:
                    self._results[uid] = result
            except KilledError:
                pass                      # this rank was the fault-injection target
            except BaseException as exc:  # surfaced to run()
                with self._lock:
                    self._errors[rank] = exc

        t = threading.Thread(target=runner, name=f"sim-{uid}-r{rank}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    # ----------------------------------------------------------------- faults
    def kill(self, rank: int, eid: Optional[int] = None) -> None:
        """Fail-stop the incarnation holding ``rank`` (pkill -9 analog).

        ``eid`` defaults to the newest epoch containing that rank.
        """
        if eid is None:
            eid = max(
                e for e, ep in self.engine._epochs.items() if rank in ep.members
            )
        token = self.engine.epoch(eid).occupants.get(rank)
        if token is None:
            raise RuntimeError(f"no live incarnation at (epoch {eid}, rank {rank})")
        trace.TRACER.emit("kill", rank=int(rank))
        with self._lock:
            self._dead.add(token)
            hooks = list(self._kill_hooks)
        for hook in hooks:
            hook(rank)
        self.engine.mark_dead(token)

    def add_kill_hook(self, fn: Callable[[int], None]) -> None:
        """Register an observer called with the rank id on every kill()."""
        with self._lock:
            if fn not in self._kill_hooks:
                self._kill_hooks.append(fn)

    def is_dead_token(self, token) -> bool:
        with self._lock:
            return token in self._dead

    # ---------------------------------------------------------------- spawner
    def spawner(self, rank: int, node: int, eid: int) -> None:
        self._start_thread(rank, eid=eid, replacement=True)


class SimComm(FTComm):
    def __init__(self, world: SimWorld, rank: int, eid: int,
                 replacement: bool = False, uid: Optional[str] = None):
        self._world = world
        self._rank = rank
        self._eid = eid
        self._uid = uid
        self._replacement = replacement
        self._seq: Dict[tuple, int] = defaultdict(int)
        self._last_recovery: dict = {}
        ep = world.engine.epoch(eid)
        self._size = ep.size
        self._node = ep.members[rank]

    # --- liveness guard -------------------------------------------------------
    def _check_alive(self) -> None:
        if self._uid is not None and self._world.is_dead_token(self._uid):
            raise KilledError()

    def _next_seq(self, channel: str) -> int:
        key = (self._eid, channel)
        s = self._seq[key]
        self._seq[key] = s + 1
        return s

    # --- identity ---------------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def epoch(self) -> int:
        return self._eid

    def node_id(self) -> int:
        return self._node

    def procs_per_node(self) -> int:
        return self._world.ppn

    # --- collectives ---------------------------------------------------------------
    def barrier(self, channel: str = "main") -> None:
        self._check_alive()
        self._world.engine.collective(
            self._eid, channel, self._next_seq(channel), "barrier", self._rank,
            timeout=self._deadline(),
        )

    def allreduce(self, value, op: str = "sum", channel: str = "main"):
        self._check_alive()
        return self._world.engine.collective(
            self._eid, channel, self._next_seq(channel), op, self._rank,
            value=value, timeout=self._deadline(),
        )

    def bcast(self, value, root: int = 0, channel: str = "main"):
        self._check_alive()
        return self._world.engine.collective(
            self._eid, channel, self._next_seq(channel), "bcast", self._rank,
            value=value, root=root, timeout=self._deadline(),
        )

    def _deadline(self) -> Optional[float]:
        return None

    # --- ULFM ---------------------------------------------------------------
    def revoke(self) -> None:
        self._check_alive()
        self._world.engine.revoke(self._eid)

    def agree(self, flag: bool = True) -> bool:
        self._check_alive()
        return self._world.engine.collective(
            self._eid, "__agree", self._next_seq("__agree"), "and", self._rank,
            value=bool(flag), fault_tolerant=True,
        )

    def recover(self, policy: Optional[str] = None) -> "SimComm":
        self._check_alive()
        policy = (policy or self._world.env.comm_recovery_policy).upper()
        view = self._world.engine.recover(
            self._eid, self._rank, policy, self._world.pool,
            spawner=self._world.spawner,
        )
        self._last_recovery = view["stats"]
        new = SimComm(self._world, view["rank"], view["eid"], uid=self._uid)
        new._last_recovery = view["stats"]
        return new

    def failed_ranks(self) -> List[int]:
        return self._world.engine.failed_ranks(self._eid)

    def empirical_mtbf(self) -> Optional[float]:
        """Observed MTBF from the engine's failure log (None until the first
        kill) — feeds the checkpoint scheduler's Daly intervals."""
        return self._world.engine.empirical_mtbf()

    def last_recovery_stats(self) -> dict:
        return dict(self._last_recovery)

    @property
    def default_recovery_policy(self):
        return self._world.env.comm_recovery_policy

    def is_replacement(self) -> bool:
        return self._replacement

    def fault_domain(self):
        return self._world
