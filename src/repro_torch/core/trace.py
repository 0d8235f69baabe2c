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
``retune``         online re-tuning replaced cadences: ``cadence`` map
=================  =======================================================

Overhead contract: when ``CRAFT_TRACE`` is unset the module-level
:data:`TRACER` stays the no-op :class:`_NullTracer` — every hook is a
single dynamic call that immediately returns, no branching, no string
formatting, no clock reads (``benchmarks/cr_overhead.py trace_overhead``
keeps the armed-vs-off delta on the scoreboard).  Hooks must therefore
pass only cheap, already-computed values.

The recorder is process-global (one trace file interleaves every
checkpoint, scheduler and communicator in the process — a total order of
events is exactly what the replayer needs) and append-only, so a
restarted job extends its predecessor's trace.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = [
    "TRACER", "emit", "enabled", "install", "uninstall", "env_snapshot",
]


class _NullTracer:
    """The ``CRAFT_TRACE``-unset tracer: every emit is a no-op."""

    enabled = False
    path = None

    def emit(self, kind: str, **fields) -> None:  # pragma: no cover - trivial
        return None

    def close(self) -> None:  # pragma: no cover - trivial
        return None


class JsonlTracer:
    """Append-only JSONL writer; thread-safe, line-at-a-time.

    ``t`` is seconds since the tracer was installed on the shared monotonic
    clock, so events from every thread (main loop, async writer, sim ranks)
    land on one comparable timeline.
    """

    enabled = True

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
