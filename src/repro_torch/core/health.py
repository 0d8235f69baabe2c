"""Tier health: retries, circuit breakers, and write deadlines.

Three small primitives that turn "an OSError anywhere aborts the job" into
the degraded-mode story ``Checkpoint`` implements on top:

* :func:`retry_call` — bounded retry with exponential backoff + jitter for
  *transient* OS errors (``EIO``/``EAGAIN``/``EINTR``/``ETIMEDOUT``).
  Persistent faults (``EROFS``, ``ENOSPC``) are not retried here — they
  need a different response (breaker trip / emergency retire), decided by
  the caller.
* :class:`CircuitBreaker` / :class:`TierHealth` — per-tier
  CLOSED → OPEN → HALF_OPEN state.  After ``threshold`` consecutive
  failures the tier is tripped (OPEN): `Checkpoint` stops writing to it
  and routes its payload to the next chain level.  After ``cooldown_s``
  the breaker admits exactly one probe (HALF_OPEN, driven from the
  scrubber's idle windows); a successful probe re-closes it, a failed one
  re-opens it for another cooldown.
* :func:`call_with_deadline` — run a write on a helper thread and abandon
  it (``WriteDeadlineExceeded``) if it exceeds ``CRAFT_IO_DEADLINE_S``, so
  a hung tier wedges neither the AsyncWriter sequencer nor a sync commit.
  The abandoned thread is daemonized; a chaos ``hang`` parks it on an
  event the engine releases at close.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from typing import Callable, Optional

from repro_torch.core import metrics
from repro_torch.core.cpbase import CheckpointError

#: errno values treated as transient (worth retrying in place).
TRANSIENT_ERRNOS = frozenset(
    {errno.EIO, errno.EAGAIN, errno.EINTR, errno.ETIMEDOUT})

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class WriteDeadlineExceeded(CheckpointError):
    """A tier write exceeded ``CRAFT_IO_DEADLINE_S`` and was abandoned."""


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def retry_call(fn: Callable, retries: int, backoff_ms: float,
               on_retry: Optional[Callable[[], None]] = None,
               sleep=time.sleep):
    """Call ``fn()``; on a transient OSError retry up to ``retries`` times.

    Delay before attempt *k* (1-based retry) is
    ``backoff_ms * 2**(k-1) * uniform(0.5, 1.5)`` — exponential with
    jitter, so a fleet of ranks hammering a recovering filesystem doesn't
    retry in lockstep.  Non-transient errors propagate immediately.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as exc:
            if attempt >= retries or not is_transient(exc):
                raise
            attempt += 1
            if on_retry is not None:
                on_retry()
            delay = (backoff_ms / 1000.0) * (2 ** (attempt - 1))
            delay *= 0.5 + random.random()
            if delay > 0:
                sleep(delay)


class CircuitBreaker:
    """CLOSED → OPEN (after ``threshold`` consecutive failures) →
    HALF_OPEN (one probe after ``cooldown_s``) → CLOSED/OPEN.

    Thread-safe; ``clock`` is injectable so tests and `Checkpoint`'s
    virtual clock drive cooldowns deterministically.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._probing = False

    def allow(self) -> bool:
        """May the caller attempt an operation on this tier right now?

        OPEN past its cooldown transitions to HALF_OPEN and admits exactly
        one caller (the probe); everyone else is refused until the probe
        reports back.
        """
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self.state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: only the single in-flight probe is admitted
            if not self._probing:
                self._probing = True
                return True
            return False

    def probe_due(self) -> bool:
        """True when a half-open probe should be attempted (no side effects
        beyond the OPEN→HALF_OPEN cooldown check)."""
        with self._lock:
            if self.state == OPEN:
                return self._clock() - self._opened_at >= self.cooldown_s
            return self.state == HALF_OPEN and not self._probing

    def record_success(self) -> None:
        with self._lock:
            self.state = CLOSED
            self.failures = 0
            self._probing = False

    def record_failure(self) -> bool:
        """Record one failure; returns True when this call *trips* the
        breaker (CLOSED→OPEN or a failed half-open probe re-opening it)."""
        with self._lock:
            self.failures += 1
            self._probing = False
            if self.state == HALF_OPEN or (
                    self.state == CLOSED and self.failures >= self.threshold):
                self.state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                return True
            if self.state == OPEN:
                self._opened_at = self._clock()
            return False


class TierHealth:
    """One tier's breaker plus bookkeeping `Checkpoint` reads for stats."""

    def __init__(self, slot: str, threshold: int = 3,
                 cooldown_s: float = 30.0, clock=time.monotonic):
        self.slot = slot
        self.breaker = CircuitBreaker(threshold, cooldown_s, clock=clock)
        self.last_error: Optional[str] = None

    #: breaker state as a scrapable level (worst-case-wins across ranks)
    _STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def _publish_state(self) -> None:
        metrics.set_gauge("breaker_state",
                          self._STATE_CODE.get(self.breaker.state, -1.0),
                          slot=self.slot)

    def allow(self) -> bool:
        ok = self.breaker.allow()   # may transition OPEN → HALF_OPEN
        self._publish_state()
        return ok

    def probe_due(self) -> bool:
        return self.breaker.probe_due()

    def record_success(self) -> None:
        self.last_error = None
        self.breaker.record_success()
        self._publish_state()

    def record_failure(self, exc: BaseException) -> bool:
        self.last_error = f"{type(exc).__name__}: {exc}"
        tripped = self.breaker.record_failure()
        if tripped:
            metrics.inc("breaker_trips", slot=self.slot)
        self._publish_state()
        return tripped

    @property
    def state(self) -> str:
        return self.breaker.state


def call_with_deadline(fn: Callable, seconds: float, name: str = "io"):
    """Run ``fn()`` with a wall-clock deadline.

    ``seconds <= 0`` calls inline (deadline disabled).  Otherwise ``fn``
    runs on a daemon helper thread; if it does not finish in time,
    :class:`WriteDeadlineExceeded` is raised and the thread is abandoned —
    the caller must treat the write as failed (abort staging, never
    publish).  The helper's own exception, if any, is re-raised in the
    caller.
    """
    if seconds <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - relayed to caller
            box["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=_run, name=f"deadline-{name}",
                              daemon=True)
    worker.start()
    if not done.wait(timeout=seconds):
        raise WriteDeadlineExceeded(
            f"write deadline ({seconds:g}s) exceeded: {name}")
    if "error" in box:
        raise box["error"]
    return box.get("result")
