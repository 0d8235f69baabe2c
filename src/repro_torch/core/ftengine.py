"""Collective-matching + recovery engine shared by the FTComm backends.

Both the in-process simulator (:mod:`repro_torch.core.comm_sim`) and the
real multiprocessing coordinator (:mod:`repro_torch.runtime.coordinator`)
need the same bookkeeping:

  * **epochs** — one generation of the communicator (ULFM: a communicator
    object); failure breaks an epoch, recovery registers the next one;
  * **collective matching** — ops are keyed by (epoch, channel, seq, op);
    every live member must arrive with the same key (SPMD ordering per
    channel), then all are released with the reduced result;
  * **failure semantics** — a dead member breaks the epoch: normal
    collectives raise ``ProcFailedError``; ``revoke`` poisons the epoch so
    *every* member learns (``RevokedError``); ``agree`` keeps working among
    survivors (ULFM's fault-tolerant agreement), which is what recovery is
    built on;
  * **recovery** — the ULFM recipe (paper §3.2) with per-phase timings
    (paper Table 3): ① revoke+shrink consensus, ② spawn-info generation,
    ③ spawn+merge, ④ rank redistribution, ⑤ resource (spare-node)
    management.  Spawning itself is backend-specific and injected as a
    callback.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace
from repro_torch.core.comm import ProcFailedError, RevokedError

_REDUCERS = {
    "sum": lambda vals: sum(vals),
    "min": lambda vals: min(vals),
    "max": lambda vals: max(vals),
    "and": lambda vals: all(vals),
    "or": lambda vals: any(vals),
    "list": lambda vals: list(vals),
}


@dataclass
class EpochState:
    eid: int
    members: Dict[int, int]                  # rank -> node id
    live: Optional[set] = None
    revoked: bool = False
    replacements: set = field(default_factory=set)   # ranks that are respawns
    occupants: Dict[int, object] = field(default_factory=dict)  # rank -> token
    pending_join: set = field(default_factory=set)   # respawns not yet joined

    def __post_init__(self):
        if self.live is None:
            self.live = set(self.members)

    @property
    def broken(self) -> bool:
        # a rank that never joined yet (replacement still booting) is not a
        # failure; a rank that joined and left (died) is.
        return bool(set(self.members) - self.live - self.pending_join)

    @property
    def size(self) -> int:
        return len(self.members)


class NodePool:
    """Bookkeeping of active / failed / spare nodes (paper Table 3 phase ⑤)."""

    def __init__(self, n_nodes: int, spare_nodes: int = 0):
        self.active = list(range(n_nodes))
        self.spares = list(range(n_nodes, n_nodes + spare_nodes))
        self.failed: List[int] = []

    def allocate_replacements(
        self, failed_nodes: List[int], policy: str
    ) -> Dict[int, int]:
        """old node -> node for the replacement procs (REUSE / NO-REUSE).

        NO-REUSE draws from the spare pool ("once a node has a hard failure
        it is likely to fail again"); an exhausted pool falls back to REUSE.
        """
        mapping: Dict[int, int] = {}
        for node in dict.fromkeys(failed_nodes):  # stable-unique
            if policy == "NO-REUSE" and self.spares:
                new = self.spares.pop(0)
                self.failed.append(node)
                if node in self.active:
                    self.active.remove(node)
                self.active.append(new)
            else:  # REUSE (or spare pool exhausted)
                new = node
            mapping[node] = new
        return mapping


class CollectiveEngine:
    def __init__(self, members: Dict[int, int]):
        self._cv = threading.Condition()
        self._epochs: Dict[int, EpochState] = {0: EpochState(0, dict(members))}
        self._next_eid = 1
        self._spawn_policy = "REUSE"
        # key -> {"arrived": {rank: value}, "done": bool, "result": ...}
        self._pending: Dict[Tuple, dict] = {}
        # failure log feeding the checkpoint scheduler's empirical MTBF
        self._t_birth = time.monotonic()
        self._failure_times: List[float] = []

    def _log_failure(self) -> None:
        """Record one observed fail-stop (caller holds ``self._cv``).

        Callers must only log on an actual live→dead transition — a stale
        report of an already-dead rank double-counted would inflate the
        failure rate and shrink every Daly interval derived from it.
        """
        trace.TRACER.emit("failure", count=len(self._failure_times) + 1)
        self._failure_times.append(time.monotonic())

    def empirical_mtbf(self) -> Optional[float]:
        """Observed mean time between failures over this engine's lifetime
        (``None`` until the first failure) — the Daly-formula input when
        ``CRAFT_MTBF_SECONDS`` is unset."""
        with self._cv:
            n = len(self._failure_times)
            if n == 0:
                return None
            return max(time.monotonic() - self._t_birth, 1e-9) / n

    def failure_count(self) -> int:
        with self._cv:
            return len(self._failure_times)

    def set_spawn_policy(self, policy: str) -> None:
        self._spawn_policy = policy

    # ------------------------------------------------------------ membership
    def epoch(self, eid: int) -> EpochState:
        return self._epochs[eid]

    def current_members(self, eid: int) -> Dict[int, int]:
        return dict(self._epochs[eid].members)

    def set_occupant(self, eid: int, rank: int, token) -> None:
        """Record which process incarnation currently holds (eid, rank).

        Ranks are re-numbered by shrinking recovery and re-used by
        non-shrinking respawns, so failure must be tracked per *incarnation*
        (token), never per bare rank id.
        """
        with self._cv:
            self._epochs[eid].occupants[rank] = token

    def mark_dead(self, token) -> None:
        """Fail-stop of one incarnation: breaks every (epoch, rank) slot it
        occupies."""
        with self._cv:
            transitioned = False
            for ep in self._epochs.values():
                for rank, occ in ep.occupants.items():
                    if occ == token and rank in ep.live:
                        ep.live.discard(rank)
                        transitioned = True
            if transitioned:     # one incarnation death = one failure event
                self._log_failure()
            self._cv.notify_all()

    def mark_rank_dead(self, eid: int, rank: int) -> None:
        """Launcher-level death report for an incarnation that never joined
        (died before its first hello — no connection exists to EOF).  Only
        epochs ≤ ``eid`` are touched so a replacement that re-uses the rank
        id in a newer epoch is never hit by a stale report."""
        with self._cv:
            transitioned = False
            for e, ep in self._epochs.items():
                if e <= eid and rank in ep.members:
                    if rank in ep.live or rank in ep.pending_join:
                        transitioned = True
                    ep.live.discard(rank)
                    ep.pending_join.discard(rank)
            if transitioned:     # ignore stale reports of already-dead ranks
                self._log_failure()
            self._cv.notify_all()

    def revoke(self, eid: int) -> None:
        with self._cv:
            self._epochs[eid].revoked = True
            self._cv.notify_all()

    def is_revoked(self, eid: int) -> bool:
        with self._cv:
            return self._epochs[eid].revoked

    def failed_ranks(self, eid: int) -> List[int]:
        with self._cv:
            ep = self._epochs[eid]
            return sorted(set(ep.members) - ep.live - ep.pending_join)

    # ------------------------------------------------------------ collectives
    def collective(
        self,
        eid: int,
        channel: str,
        seq: int,
        op: str,
        rank: int,
        value=None,
        root: int = 0,
        fault_tolerant: bool = False,
        timeout: Optional[float] = None,
    ):
        """Blocking entry of one member into a matched collective.

        ``fault_tolerant=True`` (agree / recovery internals) completes over
        the live set even on a broken or revoked epoch; otherwise failure or
        revocation raises.  ``timeout`` implements the straggler deadline:
        members missing past the deadline are declared failed.
        """
        key = (eid, channel, seq, op, root if op == "bcast" else None)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            ep = self._epochs[eid]
            st = self._pending.setdefault(key, {"arrived": {}, "done": False})
            st["arrived"][rank] = value
            self._cv.notify_all()
            while True:
                if st["done"]:
                    return st["result"]
                if not fault_tolerant:
                    if ep.revoked:
                        raise RevokedError(f"epoch {eid} revoked")
                    if ep.broken:
                        raise ProcFailedError(failed=self.failed_ranks(eid))
                needed = set(ep.live) if fault_tolerant else set(ep.members)
                if needed and needed <= set(st["arrived"]):
                    st["result"] = self._reduce(op, st, needed, root)
                    st["done"] = True
                    self._cv.notify_all()
                    return st["result"]
                if deadline is not None and time.monotonic() > deadline:
                    missing = sorted(needed - set(st["arrived"]))
                    for r in missing:
                        was_live = r in ep.live or r in ep.pending_join
                        token = ep.occupants.get(r)
                        if token is not None:
                            for e in self._epochs.values():
                                for rk, occ in e.occupants.items():
                                    if occ == token:
                                        e.live.discard(rk)
                                        e.pending_join.discard(rk)
                        ep.live.discard(r)
                        ep.pending_join.discard(r)
                        if was_live:
                            self._log_failure()
                    self._cv.notify_all()
                    raise ProcFailedError(
                        f"collective deadline exceeded, stragglers={missing}",
                        failed=missing,
                    )
                self._cv.wait(timeout=0.05)

    def _reduce(self, op: str, st: dict, needed: set, root: int):
        vals = [st["arrived"][r] for r in sorted(needed & set(st["arrived"]))]
        if op == "barrier":
            return None
        if op == "bcast":
            return st["arrived"].get(root, vals[0] if vals else None)
        if op in _REDUCERS:
            return _REDUCERS[op](vals)
        raise ValueError(f"unknown collective op {op!r}")

    # ---------------------------------------------------------- registration
    def register_epoch(self, eid: int, members: Dict[int, int],
                       live: set, replacements: set,
                       occupants: Optional[Dict[int, object]] = None) -> None:
        with self._cv:
            self._epochs[eid] = EpochState(
                eid, members, live=set(live), replacements=set(replacements),
                occupants=dict(occupants or {}),
                pending_join=set(replacements) - set(live),
            )
            self._cv.notify_all()

    def register_member(self, eid: int, rank: int, token=None) -> None:
        """A spawned replacement announces itself alive in ``eid``."""
        with self._cv:
            ep = self._epochs[eid]
            ep.live.add(rank)
            ep.pending_join.discard(rank)
            if token is not None:
                ep.occupants[rank] = token
            self._cv.notify_all()

    def wait_members_live(self, eid: int, ranks: List[int], timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                ep = self._epochs.get(eid)
                if ep is not None and set(ranks) <= ep.live:
                    return
                if time.monotonic() > deadline:
                    raise ProcFailedError(
                        f"replacements {ranks} failed to register in epoch {eid}"
                    )
                self._cv.wait(timeout=0.05)

    # ------------------------------------------------------------ recovery
    def recover(
        self,
        eid: int,
        rank: int,
        policy: str,
        node_pool: NodePool,
        spawner: Optional[Callable[[int, int, int], None]] = None,
    ) -> dict:
        """ULFM recovery recipe; returns the member's view of the new epoch.

        The lowest-ranked survivor executes the heavy steps (spawn-info,
        spawning, epoch registration); everyone else blocks until the plan
        is published.  ``spawner(new_rank, node, new_eid)`` must start a
        replacement that eventually calls ``register_member(new_eid, rank)``.
        """
        t0 = time.perf_counter()
        # ① revoke + shrink consensus over survivors -------------------------
        self.revoke(eid)
        survivors = self.collective(
            eid, "__recover", eid, "list", rank, value=rank, fault_tolerant=True
        )
        t1 = time.perf_counter()
        leader = rank == min(survivors)
        plan_key = (eid, "__plan", eid)
        with self._cv:
            plan_st = self._pending.setdefault(plan_key, {"done": False})
        if leader:
            ep = self.epoch(eid)
            failed = sorted(set(ep.members) - set(survivors))
            new_eid = self._next_eid
            self._next_eid += 1
            if policy == "NON-SHRINKING":
                # ② generate spawn info (nodes per spawn policy) -------------
                members = dict(ep.members)
                failed_nodes = [ep.members[r] for r in failed]
                node_map = node_pool.allocate_replacements(
                    failed_nodes, policy=self._spawn_policy
                )
                for r in failed:
                    members[r] = node_map[ep.members[r]]
                occupants = {
                    r: ep.occupants.get(r) for r in survivors
                    if ep.occupants.get(r) is not None
                }
                self.register_epoch(
                    new_eid, members, live=set(survivors),
                    replacements=set(failed), occupants=occupants,
                )
                t2 = time.perf_counter()
                # ③ spawn + merge --------------------------------------------
                if spawner is not None:
                    for r in failed:
                        spawner(r, members[r], new_eid)
                    self.wait_members_live(new_eid, failed)
                t3 = time.perf_counter()
                rank_map = {r: r for r in survivors}
            else:  # SHRINKING
                t2 = time.perf_counter()
                t3 = t2
                ordered = sorted(survivors)
                members = {i: ep.members[r] for i, r in enumerate(ordered)}
                rank_map = {r: i for i, r in enumerate(ordered)}
                occupants = {
                    i: ep.occupants.get(r) for i, r in enumerate(ordered)
                    if ep.occupants.get(r) is not None
                }
                self.register_epoch(
                    new_eid, members, live=set(members), replacements=set(),
                    occupants=occupants,
                )
            # ④ rank redistribution = publishing the rank map ----------------
            t4 = time.perf_counter()
            # ⑤ resource management happened inside allocate_replacements ----
            t5 = time.perf_counter()
            stats = {
                "policy": policy,
                "spawn_policy": self._spawn_policy,
                "failed": failed,
                "n_survivors": len(survivors),
                "revoke_shrink_s": t1 - t0,
                "spawn_info_s": t2 - t1,
                "spawn_merge_s": t3 - t2,
                "redistribute_s": t4 - t3,
                "resource_mgmt_s": t5 - t4,
                "total_s": t5 - t0,
            }
            with self._cv:
                plan_st["result"] = {"new_eid": new_eid, "rank_map": rank_map,
                                     "stats": stats}
                plan_st["done"] = True
                self._cv.notify_all()
        with self._cv:
            while not plan_st["done"]:
                self._cv.wait(timeout=0.05)
            plan = plan_st["result"]
        new_eid = plan["new_eid"]
        new_rank = plan["rank_map"][rank]
        new_ep = self.epoch(new_eid)
        return {
            "eid": new_eid,
            "rank": new_rank,
            "size": new_ep.size,
            "node": new_ep.members[new_rank],
            "stats": plan["stats"],
        }
