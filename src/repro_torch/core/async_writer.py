"""Asynchronous checkpoint writing (paper §2.4) — sequencer + worker pool.

The paper dedicates one writer thread per process (``std::async``) with two
modes:

* **copy-based** (``CRAFT_WRITE_ASYNC=1``): ``update()`` snapshots each
  checkpointable into a private buffer, then file IO runs on the writer
  thread while the application keeps computing.
* **zero-copy** (``CRAFT_WRITE_ASYNC_ZERO_COPY=1``): no snapshot; the writer
  thread serializes the *live* data, and the application must call
  ``Checkpoint.wait()`` before mutating it.

Beyond the paper, the writer is now a two-lane construct:

* the **sequencer** — a single dedicated thread executing ``submit()`` jobs
  strictly in submission order.  ``Checkpoint`` submits one job per version,
  so version K is always fully published before K+1 starts (ordering per
  checkpoint version is a durability invariant: ``meta.json`` must never
  point at a version newer than the directories on disk).
* a **bounded worker pool** of ``workers`` threads serving
  :meth:`run_parallel` — independent jobs (per-array file writes, per-chunk
  encodes) fan out across it.  The *calling* thread always participates in
  draining its own job list, so ``run_parallel`` never deadlocks even when
  every pool worker is busy or the pool is saturated, and nested fanout
  (arrays → chunks) degrades gracefully to inline execution.

``CRAFT_ASYNC_THREAD_PIN_CPULIST`` pins all writer threads (paper: maximize
async gain by keeping the writer off the compute cores).  On Linux we honor it
via ``os.sched_setaffinity``; elsewhere it is a documented no-op.
"""
from __future__ import annotations

import os
import threading
import time
import queue
from collections import deque
from typing import Callable, List, Optional, Sequence

from . import metrics, trace


class AsyncWriter:
    """Ordered writer lane + bounded worker pool for checkpoint IO jobs."""

    def __init__(
        self,
        workers: int = 1,
        pin_cpulist: Sequence[int] = (),
        name: str = "craft-writer",
    ):
        self.workers = max(1, int(workers))
        self._name = name
        self._pin = tuple(pin_cpulist)
        self._error: Optional[BaseException] = None
        self._error_label: Optional[str] = None
        self._failstopped = False
        self._pending = 0
        self._cv = threading.Condition()
        # ordered lane (sequencer)
        self._queue: "queue.Queue" = queue.Queue()
        self._seq_thread = threading.Thread(
            target=self._seq_loop, name=name, daemon=True
        )
        self._seq_started = False
        # worker pool (fanout lane); bounded so a burst of fanouts cannot
        # enqueue unbounded helper entries
        self._pool_queue: "queue.Queue" = queue.Queue(maxsize=4 * self.workers)
        self._pool_threads: List[threading.Thread] = []
        self._pool_lock = threading.Lock()
        self._closed = False
        # timing taps consumed by the checkpoint scheduler: per-job wall time
        # on the ordered lane, and the high-water mark of the queue depth
        # StatsView mirrors into the registry as async_* series per writer
        self.stats = metrics.StatsView(name, {
            "jobs": 0, "job_seconds": 0.0,
            "last_job_seconds": 0.0, "max_pending": 0,
            "stall_warnings": 0,
        }, prefix="async_", label="writer")
        # stall watchdog state: submit times of in-flight ordered-lane jobs
        # (the sequencer completes them in order, so the head is the oldest),
        # and the id of the job we already warned about (one warning per job)
        self._inflight: "deque" = deque()
        self._job_seq = 0
        self._stall_warned = -1

    # -- lifecycle -----------------------------------------------------------
    def _apply_pin(self) -> None:
        if self._pin and hasattr(os, "sched_setaffinity"):
            try:
                os.sched_setaffinity(0, set(self._pin))
            except OSError:
                pass  # CPU list not available on this host — documented no-op

    def _ensure_seq_started(self) -> None:
        if not self._seq_started:
            self._seq_thread.start()
            self._seq_started = True

    def _ensure_pool_started(self) -> None:
        with self._pool_lock:
            if self._closed or self._pool_threads:
                return
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._pool_loop,
                    name=f"{self._name}-pool-{i}",
                    daemon=True,
                )
                t.start()
                self._pool_threads.append(t)

    def _seq_loop(self) -> None:
        self._apply_pin()
        while True:
            item = self._queue.get()
            if item is None:
                return
            job, label = item
            t0 = time.perf_counter()
            try:
                if not self._failstopped:
                    job()
            except BaseException as exc:  # surfaced at next wait()/submit()
                with self._cv:
                    self._error = exc
                    self._error_label = label
                    # a dead process runs nothing more: the jobs queued
                    # behind a fail-stop are dropped, not written late
                    self._failstopped = not isinstance(exc, Exception)
            finally:
                dt = time.perf_counter() - t0
                with self._cv:
                    self._pending -= 1
                    pending = self._pending
                    if self._inflight:
                        self._inflight.popleft()
                    self.stats["jobs"] += 1
                    self.stats["job_seconds"] += dt
                    self.stats["last_job_seconds"] = dt
                    self._cv.notify_all()
                metrics.observe("async_job_seconds", dt)
                metrics.set_gauge("async_pending", pending)

    def _pool_loop(self) -> None:
        self._apply_pin()
        while True:
            task = self._pool_queue.get()
            if task is None:
                return
            task()  # drain-helpers never raise (errors collected per group)

    # -- ordered lane ----------------------------------------------------------
    def submit(self, job: Callable[[], None],
               label: Optional[str] = None) -> None:
        """Enqueue a job on the ordered lane (strict submission order).

        ``label`` names the job in the error surfaced at a later
        ``wait()``/``submit()`` — without it an async failure reports only
        the exception, with no hint which version/tier it came from.
        """
        self._raise_pending_error()
        self._ensure_seq_started()
        with self._cv:
            self._pending += 1
            pending = self._pending
            self._job_seq += 1
            self._inflight.append((self._job_seq, time.monotonic(), label))
            if self._pending > self.stats["max_pending"]:
                self.stats["max_pending"] = self._pending
        metrics.set_gauge("async_pending", pending)
        self._queue.put((job, label))

    def wait(self) -> None:
        """Block until all submitted jobs finished; re-raise writer errors."""
        with trace.TRACER.timed("craft::cp.fence") as sp:
            with self._cv:
                while self._pending > 0:
                    self._cv.wait()
        metrics.observe("async_fence_seconds", sp.seconds)
        self._raise_pending_error()

    # -- stall watchdog --------------------------------------------------------
    def oldest_pending_s(self, now: Optional[float] = None) -> float:
        """Age in seconds of the oldest in-flight ordered-lane job (0 when
        the lane is drained) — the ``async_oldest_pending_s`` heartbeat."""
        with self._cv:
            if not self._inflight:
                return 0.0
            t0 = self._inflight[0][1]
        return max(0.0, (time.monotonic() if now is None else now) - t0)

    def check_stall(self, deadline_s: float = 0.0) -> float:
        """Publish the heartbeat gauge and warn (once per job, through both
        metrics and trace) when the oldest pending write has outlived
        ``CRAFT_IO_DEADLINE_S``.  Called from ``Checkpoint._decide`` every
        step — cheap: one lock, one clock read."""
        with self._cv:
            if self._inflight:
                seq, t0, label = self._inflight[0]
                age = time.monotonic() - t0
            else:
                seq, label, age = -1, None, 0.0
            pending = self._pending
        metrics.set_gauge("async_oldest_pending_s", age)
        if deadline_s > 0 and seq >= 0 and age > deadline_s \
                and seq != self._stall_warned:
            self._stall_warned = seq
            self.stats["stall_warnings"] += 1
            metrics.inc("async_stall_warnings")
            trace.emit("async_stall", label=label, age_s=round(age, 3),
                       deadline_s=deadline_s, pending=pending)
        return age

    # -- fanout lane -----------------------------------------------------------
    def run_parallel(self, jobs: Sequence[Callable[[], object]]) -> list:
        """Run independent jobs across the pool; return results in order.

        The calling thread participates in draining the job list, pool
        workers help as capacity allows; the first raised exception cancels
        all not-yet-started jobs and is re-raised after in-flight jobs drain.
        """
        jobs = list(jobs)
        if not jobs:
            return []
        if len(jobs) == 1 or self.workers == 1:
            return [job() for job in jobs]
        self._ensure_pool_started()
        results: list = [None] * len(jobs)
        errors: List[BaseException] = []
        pending = deque(enumerate(jobs))
        lock = threading.Lock()
        done = threading.Event()
        remaining = [len(jobs)]

        def drain() -> None:
            while True:
                with lock:
                    if errors and pending:  # cancel unstarted work
                        remaining[0] -= len(pending)
                        pending.clear()
                        if remaining[0] == 0:
                            done.set()
                    if not pending:
                        return
                    i, job = pending.popleft()
                try:
                    r = job()
                except BaseException as exc:
                    with lock:
                        errors.append(exc)
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()
                else:
                    with lock:
                        results[i] = r
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()

        for _ in range(min(self.workers, len(jobs) - 1)):
            try:
                self._pool_queue.put_nowait(drain)
            except queue.Full:
                break  # pool saturated — caller (and busy workers) drain it
        drain()      # caller participates; returns when no job is unclaimed
        done.wait()  # helpers may still be finishing their last job
        if errors:
            raise errors[0]
        return results

    # -- teardown --------------------------------------------------------------
    def close(self) -> None:
        if self._seq_started:
            self.wait()
            self._queue.put(None)
            self._seq_thread.join(timeout=30)
            self._seq_started = False
        with self._pool_lock:
            self._closed = True
            threads, self._pool_threads = self._pool_threads, []
        for _ in threads:
            self._pool_queue.put(None)
        for t in threads:
            t.join(timeout=30)

    @property
    def busy(self) -> bool:
        with self._cv:
            return self._pending > 0

    @property
    def pending(self) -> int:
        """Ordered-lane jobs submitted but not yet finished — the scheduler's
        backpressure signal: a saturated queue stretches checkpoint
        intervals instead of stacking versions behind a slow tier."""
        with self._cv:
            return self._pending

    def _raise_pending_error(self) -> None:
        with self._cv:
            err, self._error = self._error, None
            label, self._error_label = self._error_label, None
        if err is not None:
            # Deferred surfacing loses the call-site context, so attach the
            # job's identity.  OSErrors propagate unwrapped — callers match
            # on their type/errno, and the storage layer already embedded
            # tier/version/array context in the message at the fault site.
            # A fail-stop (a BaseException that is not an Exception: a
            # simulated rank's KilledError, KeyboardInterrupt, SystemExit)
            # propagates unwrapped too, so the process dies as it would
            # have on its own thread (the reference wraps it).
            if label and isinstance(err, Exception) \
                    and not isinstance(err, OSError):
                from repro_torch.core.cpbase import CheckpointError

                raise CheckpointError(
                    f"async checkpoint write failed ({label}): {err}"
                ) from err
            raise err
