"""Cluster — user-facing launcher for the fault-tolerant runtime.

    def work(comm):
        ...  # AFT zone body, Checkpoints, collectives
        return value

    cluster = Cluster(n_procs=8, procs_per_node=2, spare_nodes=2)
    cluster.start(work)
    cluster.kill(3)              # paper fault model: SIGKILL a process
    results = cluster.join()

The worker function must be a module-level (picklable) callable — workers
are spawned with the ``spawn`` start method, which CUDA needs: a forked
child cannot use its parent's CUDA context.  Each worker initialises its
own.  On a machine with a CUDA card, :meth:`Cluster.start` builds the
hand-written kernels in the parent first, so the workers only load them.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.runtime.coordinator import Coordinator
from repro_torch.runtime.worker import worker_entry


class Cluster:
    def __init__(
        self,
        n_procs: int,
        procs_per_node: int = 1,
        spare_nodes: int = 0,
        recovery_policy: str = "NON-SHRINKING",
        spawn_policy: str = "NO-REUSE",
        collective_deadline: Optional[float] = None,
        hb_timeout: Optional[float] = None,
        env_overrides: Optional[dict] = None,
    ):
        self.n_procs = n_procs
        self.ppn = max(1, procs_per_node)
        self.recovery_policy = recovery_policy.upper()
        self.env_overrides = dict(env_overrides or {})
        self.env_overrides.setdefault(
            "CRAFT_COMM_RECOVERY_POLICY", self.recovery_policy
        )
        self.env_overrides.setdefault(
            "CRAFT_COMM_SPAWN_POLICY", spawn_policy.upper()
        )
        self.coord = Coordinator(
            n_procs,
            procs_per_node=procs_per_node,
            spare_nodes=spare_nodes,
            spawn_policy=spawn_policy.upper(),
            collective_deadline=collective_deadline,
            hb_timeout=hb_timeout,
        )
        self.coord.set_spawner(self._spawn_replacement)
        self._ctx = mp.get_context("spawn")
        self._procs: Dict[int, List] = {}      # rank -> [(Process, eid), ...]
        self._fn: Optional[Callable] = None
        self._args: tuple = ()
        self._reaped: set = set()
        self._stop_reaper = threading.Event()

    # ------------------------------------------------------------------ start
    def start(self, fn: Callable, *args) -> None:
        import torch

        if torch.cuda.is_available():
            # once here, not in N workers running nvcc on one library
            from repro_torch.kernels import _build

            _build.build_all(_build.KERNELS)
        self._fn = fn
        self._args = args
        for rank in range(self.n_procs):
            node = rank // self.ppn
            self._launch(rank, node, eid=0, replacement=False)
        threading.Thread(target=self._reaper, name="craft-reaper",
                         daemon=True).start()

    def _config(self) -> dict:
        return {
            "n_procs": self.n_procs,
            "recovery_policy": self.recovery_policy,
            "hb_interval": 0.2,
        }

    def _launch(self, rank: int, node: int, eid: int, replacement: bool) -> None:
        p = self._ctx.Process(
            target=worker_entry,
            args=(self.coord.address, rank, node, eid, replacement,
                  self._fn, self._args, self.env_overrides, self._config()),
            name=f"craft-worker-{rank}",
            daemon=True,
        )
        p.start()
        self._procs.setdefault(rank, []).append((p, eid))

    def _spawn_replacement(self, rank: int, node: int, eid: int) -> None:
        """Engine spawner callback (paper Table 3 phase ③)."""
        self._launch(rank, node, eid, replacement=True)

    # ------------------------------------------------------------------ faults
    def kill(self, rank: int) -> None:
        """SIGKILL the current incarnation of ``rank`` (pkill -9 analog)."""
        procs = self._procs.get(rank, [])
        for p, _eid in reversed(procs):
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
                return
        raise RuntimeError(f"no live process for rank {rank}")

    # ------------------------------------------------------------------ reaper
    def _reaper(self) -> None:
        """Launcher-level supervision (Borg/Pathways style): a worker that
        dies *before its first hello* has no coordinator connection to EOF,
        so only its parent can report the death.  Workers that did connect
        are handled by the connection-EOF path; the hello count per rank
        (coordinator ``_conn_gen``) tells the two cases apart."""
        while not self._stop_reaper.is_set():
            for rank, procs in list(self._procs.items()):
                for idx, (p, eid) in enumerate(procs):
                    key = (rank, idx)
                    if key in self._reaped or p.is_alive():
                        continue
                    self._reaped.add(key)
                    hellos = self.coord._conn_gen.get(rank, 0)
                    if hellos <= idx:     # died before ever connecting
                        self.coord.engine.mark_rank_dead(eid, rank)
            self._stop_reaper.wait(0.1)

    def kill_node(self, node: int) -> List[int]:
        """SIGKILL every live rank currently placed on ``node``."""
        eids = sorted(self.coord.engine._epochs)
        members = self.coord.engine.current_members(eids[-1])
        ranks = [r for r, n in members.items() if n == node]
        killed = []
        for r in ranks:
            try:
                self.kill(r)
                killed.append(r)
            except RuntimeError:
                pass
        return killed

    # ------------------------------------------------------------------ join
    def join(self, timeout: float = 300.0) -> Dict[int, object]:
        """Wait for every live worker to exit; returns {rank: result}."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [
                p for procs in self._procs.values()
                for p, _eid in procs if p.is_alive()
            ]
            if not alive:
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"cluster did not drain: {[p.name for p in alive]}"
            )
        if self.coord.worker_errors:
            raise RuntimeError(
                "worker errors:\n" + "\n\n".join(self.coord.worker_errors)
            )
        return dict(self.coord.results)

    def shutdown(self) -> None:
        self._stop_reaper.set()
        for procs in self._procs.values():
            for p, _eid in procs:
                if p.is_alive():
                    p.terminate()
        for procs in self._procs.values():
            for p, _eid in procs:
                p.join(timeout=5)
        self.coord.close()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
