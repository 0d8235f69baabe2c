"""Coordinator: accepts worker connections, serves RPCs, drives recovery.

Runs as threads inside the launching process.  Every worker connection gets
a receiver thread; blocking collective RPCs are answered from short-lived
handler threads so one blocked collective never stalls the connection's
other traffic (heartbeats, the checkpoint writer thread's barriers, ...).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Listener
from typing import Dict, List, Optional

from repro_torch.core.comm import ProcFailedError, RevokedError

import logging
log = logging.getLogger("craft.coord")
from repro_torch.core.ftengine import CollectiveEngine, NodePool

_AUTHKEY = b"craft-cluster"


class Coordinator:
    def __init__(
        self,
        n_procs: int,
        procs_per_node: int = 1,
        spare_nodes: int = 0,
        spawn_policy: str = "NO-REUSE",
        collective_deadline: Optional[float] = None,
        hb_timeout: Optional[float] = None,
    ):
        self.n_procs = n_procs
        self.ppn = max(1, procs_per_node)
        n_nodes = (n_procs + self.ppn - 1) // self.ppn
        members = {r: r // self.ppn for r in range(n_procs)}
        self.engine = CollectiveEngine(members)
        self.engine.set_spawn_policy(spawn_policy)
        self.pool = NodePool(n_nodes, spare_nodes)
        self.collective_deadline = collective_deadline
        self.hb_timeout = hb_timeout
        self._lock = threading.Lock()
        self._conns: Dict[int, object] = {}        # rank -> live connection
        self._conn_gen: Dict[int, int] = {}        # rank -> incarnation count
        self._last_seen: Dict[int, float] = {}
        self.results: Dict[int, object] = {}
        self.worker_errors: List[str] = []
        self.last_recovery: dict = {}
        self._spawn_cb = None                      # set by Cluster
        self._stop = threading.Event()
        self._dir = tempfile.mkdtemp(prefix="craft-coord-")
        self.address = os.path.join(self._dir, "sock")
        self._listener = Listener(self.address, family="AF_UNIX", authkey=_AUTHKEY)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="coord-accept", daemon=True
        )
        self._accept_thread.start()
        if hb_timeout:
            threading.Thread(
                target=self._hb_monitor, name="coord-hb", daemon=True
            ).start()

    def set_spawner(self, cb) -> None:
        self._spawn_cb = cb

    # ------------------------------------------------------------- accept/serve
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn) -> None:
        rank = None
        gen = None
        try:
            hello = conn.recv()
            assert hello["op"] == "hello", hello
            rank = hello["rank"]
            eid = hello["eid"]
            log.debug("serve: hello rank=%s eid=%s repl=%s", rank, eid,
                      hello.get("replacement"))
            with self._lock:
                self._conn_gen[rank] = self._conn_gen.get(rank, 0) + 1
                gen = self._conn_gen[rank]
                self._conns[rank] = conn
                self._last_seen[rank] = time.monotonic()
            token = f"{rank}:{gen}"
            if hello.get("replacement"):
                self.engine.register_member(eid, rank, token=token)
            else:
                self.engine.set_occupant(eid, rank, token)
            self._reply(conn, hello, {"ok": {"ppn": self.ppn}})
            while not self._stop.is_set():
                msg = conn.recv()
                with self._lock:
                    self._last_seen[rank] = time.monotonic()
                if msg["op"] == "hb":
                    continue
                if msg["op"] in ("barrier", "allreduce", "bcast", "agree",
                                 "recover"):
                    threading.Thread(
                        target=self._handle_blocking,
                        args=(conn, rank, msg),
                        daemon=True,
                    ).start()
                else:
                    self._handle_fast(conn, rank, msg)
        except (EOFError, OSError, BrokenPipeError):
            log.debug("serve: connection lost rank=%s gen=%s", rank, gen)
        finally:
            if rank is not None and gen is not None:
                with self._lock:
                    current = self._conn_gen.get(rank) == gen
                    if current:
                        self._conns.pop(rank, None)
                if current and not self._stop.is_set():
                    # fail-stop detection: the paper's "nonresponsive to any
                    # communication request"
                    self.engine.mark_dead(f"{rank}:{gen}")

    # ------------------------------------------------------------- dispatch
    def _handle_fast(self, conn, rank: int, msg: dict) -> None:
        op = msg["op"]
        try:
            if op == "revoke":
                self.engine.revoke(msg["eid"])
                self._reply(conn, msg, {"ok": None})
            elif op == "failed_ranks":
                self._reply(conn, msg, {"ok": self.engine.failed_ranks(msg["eid"])})
            elif op == "result":
                with self._lock:
                    self.results[rank] = msg["value"]
                self._reply(conn, msg, {"ok": None})
            elif op == "error":
                with self._lock:
                    self.worker_errors.append(f"rank {rank}: {msg['text']}")
                self._reply(conn, msg, {"ok": None})
            else:
                self._reply(conn, msg, {"err": ("bad_op", op)})
        except (OSError, BrokenPipeError):
            pass

    def _handle_blocking(self, conn, rank: int, msg: dict) -> None:
        op = msg["op"]
        # collectives are matched by the worker's *current* rank (ranks are
        # remapped by shrinking recovery), not its connection's hello rank
        rank = msg.get("rank", rank)
        try:
            if op == "recover":
                view = self.engine.recover(
                    msg["eid"], rank, msg["policy"], self.pool,
                    spawner=self._spawn_cb,
                )
                with self._lock:
                    self.last_recovery = view["stats"]
                self._reply(conn, msg, {"ok": view})
            elif op == "agree":
                result = self.engine.collective(
                    msg["eid"], "__agree", msg["seq"], "and", rank,
                    value=msg["value"], fault_tolerant=True,
                )
                self._reply(conn, msg, {"ok": result})
            else:
                engine_op = msg["reduce"] if op == "allreduce" else op
                result = self.engine.collective(
                    msg["eid"], msg["channel"], msg["seq"], engine_op,
                    rank, value=msg.get("value"), root=msg.get("root", 0),
                    timeout=self.collective_deadline,
                )
                self._reply(conn, msg, {"ok": result})
        except ProcFailedError as exc:
            self._reply(conn, msg, {"err": ("proc_failed", exc.failed)})
        except RevokedError:
            self._reply(conn, msg, {"err": ("revoked", None)})
        except Exception:  # pragma: no cover - defensive
            self._reply(conn, msg, {"err": ("internal", traceback.format_exc())})

    def _reply(self, conn, msg: dict, payload: dict) -> None:
        out = {"id": msg.get("id"), **payload}
        try:
            with self._lock:
                conn.send(out)
        except (OSError, BrokenPipeError):
            pass

    # ------------------------------------------------------------- hb monitor
    def _hb_monitor(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.hb_timeout / 4)
            now = time.monotonic()
            with self._lock:
                stale = [
                    r for r, ts in self._last_seen.items()
                    if r in self._conns and now - ts > self.hb_timeout
                ]
            with self._lock:
                tokens = [f"{r}:{self._conn_gen.get(r)}" for r in stale]
            for tok in tokens:
                self.engine.mark_dead(tok)

    # ------------------------------------------------------------- shutdown
    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
