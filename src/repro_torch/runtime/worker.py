"""Worker process bootstrap + ProcComm (the worker-side FTComm).

Each worker connects to the coordinator socket, announces itself (rank,
epoch, replacement flag), and then runs the user function ``fn(comm)``.
``ProcComm`` is thread-safe: a receiver thread demultiplexes replies by
request id so the application's main thread and the checkpoint writer
thread can have RPCs in flight concurrently; a heartbeat thread keeps the
coordinator's staleness monitor fed.

Only host values cross the connection.  ``Connection.send`` pickles with
``ForkingPickler``, on which ``import torch`` registers tensor reductions:
a CUDA tensor would cross as an IPC handle that dies with its process, a
CPU tensor as a shared-memory descriptor.  So :meth:`ProcComm._rpc` refuses
a tensor anywhere in a value, and results carry numpy arrays or lists.
The worker process sets nothing on the device: a worker function that
runs on a CUDA card calls ``torch.cuda.set_device`` itself.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import traceback
from collections import defaultdict
from multiprocessing.connection import Client
from typing import Dict, List, Optional

import torch

from repro_torch.core.comm import FTComm, ProcFailedError, RevokedError

_AUTHKEY = b"craft-cluster"


def _holds_tensor(value) -> bool:
    """Whether ``value`` is, or holds in a dict, list, tuple or set, a
    ``torch.Tensor``."""
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        return any(_holds_tensor(k) or _holds_tensor(v)
                   for k, v in value.items())
    if isinstance(value, (list, tuple, set, frozenset)):
        return any(_holds_tensor(v) for v in value)
    return False


class CoordinatorLostError(RuntimeError):
    """The coordinator connection died — the job is over for this worker."""


class ProcComm(FTComm):
    def __init__(self, address: str, rank: int, node: int, eid: int,
                 replacement: bool, recovery_policy: str = "NON-SHRINKING",
                 size: Optional[int] = None, hb_interval: float = 0.2):
        self._conn = Client(address, family="AF_UNIX", authkey=_AUTHKEY)
        self._send_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._waiters: Dict[int, "queue.Queue"] = {}
        self._waiters_lock = threading.Lock()
        self._closed = threading.Event()
        self._rank = rank
        self._node = node
        self._eid = eid
        self._size = size
        self._replacement = replacement
        self._recovery_policy = recovery_policy
        self._seq = defaultdict(int)
        self._last_recovery: dict = {}
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="craft-rpc-recv", daemon=True
        )
        self._recv_thread.start()
        hello = self._rpc(
            {"op": "hello", "rank": rank, "eid": eid, "replacement": replacement}
        )
        self._ppn = hello["ppn"]
        if hb_interval:
            threading.Thread(
                target=self._hb_loop, args=(hb_interval,),
                name="craft-hb", daemon=True,
            ).start()

    # -------------------------------------------------------------- transport
    def _recv_loop(self) -> None:
        try:
            while not self._closed.is_set():
                msg = self._conn.recv()
                with self._waiters_lock:
                    q = self._waiters.pop(msg.get("id"), None)
                if q is not None:
                    q.put(msg)
        except (EOFError, OSError):
            self._closed.set()
            with self._waiters_lock:
                for q in self._waiters.values():
                    q.put({"err": ("coordinator_lost", None)})
                self._waiters.clear()

    def _hb_loop(self, interval: float) -> None:
        while not self._closed.is_set():
            try:
                with self._send_lock:
                    self._conn.send({"op": "hb"})
            except (OSError, BrokenPipeError):
                return
            self._closed.wait(interval)

    def _rpc(self, msg: dict):
        if _holds_tensor(msg):
            raise TypeError(
                f"{msg['op']}: a torch.Tensor cannot cross to the "
                "coordinator; send host values (numpy arrays, lists)")
        if self._closed.is_set():
            raise CoordinatorLostError()
        mid = next(self._ids)
        msg["id"] = mid
        q: "queue.Queue" = queue.Queue()
        with self._waiters_lock:
            self._waiters[mid] = q
        with self._send_lock:
            self._conn.send(msg)
        reply = q.get()
        if "ok" in reply:
            return reply["ok"]
        kind, info = reply["err"]
        if kind == "proc_failed":
            raise ProcFailedError(failed=info)
        if kind == "revoked":
            raise RevokedError()
        if kind == "coordinator_lost":
            raise CoordinatorLostError()
        raise RuntimeError(f"coordinator error: {kind}: {info}")

    def _next_seq(self, channel: str) -> int:
        key = (self._eid, channel)
        s = self._seq[key]
        self._seq[key] = s + 1
        return s

    # -------------------------------------------------------------- identity
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
        return self._ppn

    # ------------------------------------------------------------ collectives
    def barrier(self, channel: str = "main") -> None:
        self._rpc({"op": "barrier", "rank": self._rank, "eid": self._eid,
                   "channel": channel, "seq": self._next_seq(channel)})

    def allreduce(self, value, op: str = "sum", channel: str = "main"):
        return self._rpc({"op": "allreduce", "reduce": op, "value": value,
                          "rank": self._rank, "eid": self._eid,
                          "channel": channel, "seq": self._next_seq(channel)})

    def bcast(self, value, root: int = 0, channel: str = "main"):
        return self._rpc({"op": "bcast", "value": value, "root": root,
                          "rank": self._rank, "eid": self._eid,
                          "channel": channel, "seq": self._next_seq(channel)})

    # ------------------------------------------------------------ ULFM calls
    def revoke(self) -> None:
        self._rpc({"op": "revoke", "eid": self._eid})

    def agree(self, flag: bool = True) -> bool:
        return self._rpc({"op": "agree", "value": bool(flag),
                          "rank": self._rank, "eid": self._eid,
                          "seq": self._next_seq("__agree")})

    def recover(self, policy: Optional[str] = None) -> "ProcComm":
        policy = (policy or self._recovery_policy).upper()
        view = self._rpc({"op": "recover", "rank": self._rank,
                          "eid": self._eid, "policy": policy})
        self._eid = view["eid"]
        self._rank = view["rank"]
        self._size = view["size"]
        self._node = view["node"]
        self._seq = defaultdict(int)
        self._last_recovery = view["stats"]
        self._replacement = False
        return self

    def failed_ranks(self) -> List[int]:
        return self._rpc({"op": "failed_ranks", "eid": self._eid})

    def last_recovery_stats(self) -> dict:
        return dict(self._last_recovery)

    @property
    def default_recovery_policy(self):
        return self._recovery_policy

    def is_replacement(self) -> bool:
        return self._replacement

    # ------------------------------------------------------------ lifecycle
    def send_result(self, value) -> None:
        self._rpc({"op": "result", "value": value})

    def send_error(self, text: str) -> None:
        try:
            self._rpc({"op": "error", "text": text})
        except Exception:
            pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._conn.close()
        except OSError:
            pass


def worker_entry(address: str, rank: int, node: int, eid: int,
                 replacement: bool, fn, args: tuple,
                 env_overrides: dict, config: dict) -> None:
    """Entry point of every worker process (initial and respawned)."""
    os.environ.update(env_overrides or {})
    if "OMP_NUM_THREADS" in (env_overrides or {}):
        # torch reads the variable when it is imported, which happened
        # before the overrides applied (this module imports it)
        torch.set_num_threads(int(env_overrides["OMP_NUM_THREADS"]))
    size = config["n_procs"]
    comm = ProcComm(
        address, rank, node, eid, replacement,
        recovery_policy=config.get("recovery_policy", "NON-SHRINKING"),
        size=size,
        hb_interval=config.get("hb_interval", 0.2),
    )
    try:
        result = fn(comm, *args)
        comm.send_result(result)
    except CoordinatorLostError:
        os._exit(1)
    except BaseException:
        comm.send_error(traceback.format_exc())
        comm.close()
        os._exit(1)
    finally:
        comm.close()
