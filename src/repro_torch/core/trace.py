"""Low-overhead JSONL run tracing (``CRAFT_TRACE``) — the *record* third of
the record → replay → tune loop (paper §V measures CR overhead by hand; we
measure it by instrumenting the real code paths).

Every load-bearing event on the CR path emits one JSON line:

=================  =======================================================
kind               fields (beyond ``t``, seconds since trace start)
=================  =======================================================
``config``         snapshot of the scheduling-relevant ``CRAFT_*`` knobs +
                   the checkpoint's payload size (emitted at ``commit()``)
``decision``       the policy verdict for one step: ``it``, ``pending``
                   (writer backpressure seen), ``write``, ``tiers``,
                   ``full``, ``sync``, ``reason``, plus the caller's
                   ``cp_freq``/``next_version`` gate inputs
``scheduled``      ``record_written`` fired for ``version`` (cadence state
                   advanced — on async runs this precedes the tier writes)
``step``           one measured application step (``seconds``)
``tier_write``     a tier write *landed*: ``slot``, ``version``,
                   ``seconds``, ``nbytes`` (logical payload),
                   ``phys_bytes``/``chunks``/``ref_chunks`` (codec IO),
                   ``full`` (self-contained vs delta)
``degraded``       a scheduled write did not land on ``slot`` (fault or
                   open breaker) and was routed down the chain
``breaker``        a circuit breaker tripped: ``slot``
``restore``        a restore completed: ``version``, ``tier`` (label),
                   ``slot``, ``seconds``, ``read_bytes``
``failure``        the collective engine observed one fail-stop
``kill``           a fault injector killed ``rank`` (SimWorld)
``recovery``       an AFT recovery reset live policies (epoch bump)
=================  =======================================================

Spans: ``with TRACER.span("craft::cp.restore", cp=..., version=...):``
times a region on ``time.perf_counter_ns`` (the clock the benchmark's
device trace is placed by) and records ``(name, start_ns, end_ns, parent,
fields)``, ``parent`` the id of the enclosing span on the same thread, so
a span's self time is its duration less its children's.
``TRACER.timed(...)`` is the same span for a place that reads its own
duration anyway (``.stop()`` or ``.seconds``, idempotent): disarmed, it
still reads the clock, once at each end, and records nothing.  The span
names, their fields and the metrics that read them are listed in
``PERF.md``.  A span of an asynchronous CUDA launch times the enqueue; no
span synchronises the card.

Recorders: :func:`install` writes the events above as JSONL
(``CRAFT_TRACE``) and keeps no spans: the events already carry the
durations the replayer reads.  :func:`install_memory` keeps the newest
spans and events in memory up to a cap, counting the older ones it drops,
with nothing written to disk; :func:`kept` reads them in the process and
:func:`drain` hands them back.  ``CRAFT_METRICS`` arms it beside the
metrics registry when no trace file is armed
(:func:`repro_torch.core.metrics.maybe_install_from_env`).

Overhead contract: when ``CRAFT_TRACE`` is unset the module-level
:data:`TRACER` stays the no-op :class:`_NullTracer` — every hook is a
single dynamic call that immediately returns, no branching, no string
formatting, no clock reads (``span`` hands back one shared no-op object:
no clock, no lock, no list) (``benchmarks/cr_overhead.py trace_overhead``
keeps the armed-vs-off delta on the scoreboard).  Hooks must therefore
pass only cheap, already-computed values.

The recorder is process-global (one trace file interleaves every
checkpoint, scheduler and communicator in the process — a total order of
events is exactly what the replayer needs) and append-only, so a
restarted job extends its predecessor's trace.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

__all__ = [
    "TRACER", "emit", "enabled", "install", "install_memory", "kept",
    "drain", "uninstall", "env_snapshot", "SpanRecord", "EventRecord",
]

_now_ns = time.perf_counter_ns
_span_ids = itertools.count(1)


class SpanRecord(NamedTuple):
    """One finished span: ``parent`` is the id of the span that enclosed
    it on its thread (None at the top)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    fields: dict
    id: int


class EventRecord(NamedTuple):
    """One :func:`emit` kept by the memory recorder."""
    kind: str
    t_ns: int
    fields: dict


class _NullSpan:
    """The disarmed tracer's span: one shared object; it reads no clock,
    takes no lock and keeps nothing."""

    __slots__ = ()
    armed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **fields) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Clock:
    """The disarmed tracer's ``timed``: the caller's own timer, read once at
    each end; nothing is recorded."""

    __slots__ = ("t0", "t1")
    armed = False

    def __enter__(self):
        self.t1 = None
        self.t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self) -> float:
        """End the span (once; later calls change nothing) and return its
        seconds."""
        if self.t1 is None:
            self.t1 = _now_ns()
        return (self.t1 - self.t0) * 1e-9

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def set(self, **fields) -> None:
        return None


class _Span(_Clock):
    """A span of an armed recorder: on its thread's stack from enter to
    stop, handed to the recorder when it stops."""

    __slots__ = ("_rec", "_on", "name", "fields", "id", "parent")
    armed = True

    def __init__(self, rec, name: str, fields: dict):
        self._rec = rec
        self.name = name
        self.fields = fields

    def __enter__(self):
        self._on = stack = self._rec._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_span_ids)
        stack.append(self)
        self.t1 = None
        self.t0 = _now_ns()
        return self

    def stop(self) -> float:
        if self.t1 is None:
            self.t1 = _now_ns()
            stack = self._on
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            # a plain tuple here; drain() makes it a SpanRecord
            self._rec._keep((self.name, self.t0, self.t1, self.parent,
                             self.fields, self.id))
        return (self.t1 - self.t0) * 1e-9

    def set(self, **fields) -> None:
        self.fields.update(fields)


class _NullTracer:
    """The ``CRAFT_TRACE``-unset tracer: every emit is a no-op."""

    enabled = False
    path = None

    def emit(self, kind: str, **fields) -> None:  # pragma: no cover - trivial
        return None

    def span(self, name: str, **fields) -> _NullSpan:
        return _NULL_SPAN

    def timed(self, name: str, **fields) -> _Clock:
        return _Clock()

    def carry(self, jobs: list) -> list:
        return jobs

    def close(self) -> None:  # pragma: no cover - trivial
        return None


class MemoryTracer:
    """Keeps the newest ``cap`` spans and events, on ``perf_counter_ns``,
    in the order they ended; ``dropped`` counts the older ones pushed out.
    A thread's open spans are on a stack of its own."""

    enabled = True
    path = None

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.records: collections.deque = collections.deque(maxlen=self.cap)
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **fields) -> _Span:
        return _Span(self, name, fields)

    timed = span

    def carry(self, jobs: list) -> list:
        """``jobs`` made to open their spans under this thread's current
        span, whichever thread of a pool runs them."""
        stack = self._stack()
        if not stack:
            return jobs
        parent = stack[-1]

        def under(job):
            def run():
                mine = self._stack()
                mine.append(parent)
                try:
                    return job()
                finally:
                    mine.remove(parent)
            return run

        return [under(job) for job in jobs]

    def _keep(self, rec: tuple) -> None:
        with self._lock:
            if len(self.records) == self.cap:
                self.dropped += 1
            self.records.append(rec)

    def emit(self, kind: str, **fields) -> None:
        self._keep(EventRecord(kind, _now_ns(), fields))

    def kept(self) -> list:
        with self._lock:
            out = list(self.records)
        return [r if isinstance(r, EventRecord) else SpanRecord._make(r)
                for r in out]

    def drain(self) -> Tuple[list, int]:
        with self._lock:
            out, dropped = list(self.records), self.dropped
            self.records.clear()
            self.dropped = 0
        return [r if isinstance(r, EventRecord) else SpanRecord._make(r)
                for r in out], dropped

    def close(self) -> None:
        return None


class JsonlTracer:
    """Append-only JSONL writer; thread-safe, line-at-a-time.

    ``t`` is seconds since the tracer was installed on the shared monotonic
    clock, so events from every thread (main loop, async writer, sim ranks)
    land on one comparable timeline.  Its spans are the disarmed ones.
    """

    enabled = True
    span = _NullTracer.span
    timed = _NullTracer.timed
    carry = _NullTracer.carry

    def __init__(self, path: str, clock=time.monotonic):
        self.path = str(path)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._closed = False
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1, encoding="utf-8")

    def emit(self, kind: str, **fields) -> None:
        rec = {"t": round(self._clock() - self._t0, 6), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            # Re-check liveness *under the lock*: a concurrent uninstall()
            # (telemetry shutdown hook, test teardown) may have closed the
            # writer between the module-level TRACER read and here — without
            # this a mid-emit close could tear the final line or raise on a
            # closed file.
            if self._closed or self._fh.closed:
                return
            try:
                self._fh.write(line + "\n")
            except ValueError:       # closed out from under us (interp exit)
                self._closed = True

    def close(self) -> None:
        # Idempotent and thread-safe: emit() holds the same lock, so a close
        # always lands between whole lines, never inside one.
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


#: The process-wide tracer.  Hooks call ``trace.TRACER.emit(...)`` (or the
#: module-level :func:`emit` alias); both stay no-ops until :func:`install`.
TRACER = _NullTracer()


def emit(kind: str, **fields) -> None:
    """Module-level emit alias (reads :data:`TRACER` at call time, so hooks
    that imported the function still see a later install)."""
    TRACER.emit(kind, **fields)


def enabled() -> bool:
    return TRACER.enabled


def install(path: str) -> None:
    """Arm the recorder (idempotent for the same path: the existing writer
    keeps appending; a different path swaps writers)."""
    global TRACER
    if TRACER.enabled and TRACER.path == str(path):
        return
    old, TRACER = TRACER, JsonlTracer(path)
    old.close()


def install_memory(cap: int = 1 << 18) -> None:
    """Arm the memory recorder: the newest ``cap`` spans and events kept,
    written nowhere (:func:`kept` reads them, :func:`drain` hands them
    back).  A Lanczos iteration leaves three records, so the default holds
    some 87,000 iterations: a 51 s window at 1,700 iterations a second."""
    global TRACER
    old, TRACER = TRACER, MemoryTracer(cap)
    old.close()


def kept() -> List[object]:
    """What the memory recorder holds, in the order it ended, left in
    place; [] when it is not the tracer armed."""
    if isinstance(TRACER, MemoryTracer):
        return TRACER.kept()
    return []


def drain() -> Tuple[List[object], int]:
    """(records, dropped): what the memory recorder held since it was armed
    or last drained, in the order they ended, and how many older ones it
    dropped to stay within its cap; ([], 0) when it is not the tracer
    armed."""
    if isinstance(TRACER, MemoryTracer):
        return TRACER.drain()
    return [], 0


def uninstall() -> None:
    """Back to the no-op recorder (tests; end of a traced benchmark)."""
    global TRACER
    old, TRACER = TRACER, _NullTracer()
    old.close()


def maybe_install_from_env(env) -> None:
    """Arm the recorder when the captured env names a trace file
    (``Checkpoint.commit()`` calls this — the paper's read-once contract)."""
    if getattr(env, "trace_path", None):
        install(env.trace_path)


def env_snapshot(env, payload_bytes: int = 0,
                 comm_size: Optional[int] = None) -> dict:
    """The scheduling-relevant knobs as a re-capturable ``{CRAFT_*: str}``
    map — what the replayer feeds back into ``CraftEnv.capture`` so the
    simulated policy is configured exactly like the recorded one."""
    tier_every = ",".join(
        f"{slot}:{spec}" if slot != "*" else str(spec)
        for slot, spec in env.tier_every
    )
    snap = {
        "CRAFT_TIER_CHAIN": ",".join(env.tier_chain),
        "CRAFT_TIER_EVERY": tier_every,
        "CRAFT_PFS_EVERY": str(env.pfs_every),
        "CRAFT_MTBF_SECONDS": repr(env.mtbf_seconds),
        "CRAFT_DELTA": "1" if env.delta else "0",
        "CRAFT_DELTA_MAX_CHAIN": str(env.delta_max_chain),
        "CRAFT_KEEP_VERSIONS": str(env.keep_versions),
        "CRAFT_NODE_REDUNDANCY": env.node_redundancy,
        "CRAFT_XOR_GROUP_SIZE": str(env.xor_group_size),
        "CRAFT_RS_PARITY": str(env.rs_parity),
        "CRAFT_MEM_REPLICAS": str(env.mem_replicas),
        "CRAFT_WALLTIME_SECONDS": repr(env.walltime_seconds),
        "CRAFT_WALLTIME_MARGIN_SECONDS": repr(env.walltime_margin_seconds),
        "CRAFT_WRITE_ASYNC": "1" if env.write_async else "0",
        "CRAFT_CODEC_VERSION": str(env.codec_version),
    }
    out = {"env": snap, "payload_bytes": int(payload_bytes)}
    if comm_size is not None:
        out["comm_size"] = int(comm_size)
    return out
