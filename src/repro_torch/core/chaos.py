"""Seeded, deterministic storage-fault injection (``CRAFT_CHAOS``).

Multi-level checkpointing is only as good as its behavior when a level
*misbehaves* — yet the only faults the harness could historically inject
were rank death (``comm_sim`` kill hooks) and at-rest corruption
(``scrubber.corrupt_file``).  The chaos engine closes the gap: every fault
class a storage tier can throw at the library is injectable *in band*, on
the live IO paths, and replays bit-identically from a seed.

Fault classes
-------------

============  ==============================================================
``eio``       transient ``OSError(EIO)`` — the retry layer's bread and butter
``erofs``     persistent ``OSError(EROFS)`` — a tier gone read-only (breaker)
``enospc``    ``OSError(ENOSPC)`` — out of space (triggers emergency retire)
``stall``     latency injection: sleep ``ms`` before the operation proceeds
``hang``      indefinite hang (until :meth:`ChaosEngine.release` / a safety
              cap) — what ``CRAFT_IO_DEADLINE_S`` exists to abandon
``torn``      partial write: only a prefix of the file's bytes reach the
              ``.tmp`` file, then ``OSError(EIO)`` — the crash-consistency
              protocol must never let such a file become visible
``crash``     :class:`ChaosCrash` (a ``BaseException``) at an exact
              operation index — simulated process death; staging is *not*
              aborted, exactly like a real crash, so the next start's
              ``sweep_tmp_dirs`` and the atomic-rename protocol are what
              keep the previous version restorable
============  ==============================================================

Spec grammar (``CRAFT_CHAOS``)
------------------------------

Comma-separated rules, each ``slot:fault[:param=value[+param=value...]]``::

    CRAFT_CHAOS="pfs:eio:p=0.05,node:stall:ms=500"
    CRAFT_CHAOS="pfs:erofs:p=1+after=40"
    CRAFT_CHAOS="node:crash:at=17"
    CRAFT_CHAOS="on"                  # engine armed, no rules (tests add
                                      # rules mid-run via ChaosEngine.add)

``slot`` is a chain slot (``mem``/``node``/``pfs``) or ``*``.  Params:

* ``p``      — injection probability per matching operation (default 1.0)
* ``ms``     — stall duration (``stall`` only)
* ``after``  — skip the first N matching operations (fault starts mid-run)
* ``count``  — inject at most N times, then the rule goes inert
* ``at``     — inject exactly at matching-operation index N (``crash``)
* ``op``     — restrict to one operation kind (``read``/``write``/
  ``publish``/``replicate``/``fabric``)

Determinism
-----------

Every IO call site asks its :class:`ChaosScope` (one per tier slot) whether
to inject.  The engine keys a per-``(slot, op)`` operation counter, and the
injection draw for operation *i* uses an RNG seeded from
``(seed, slot, op, i)`` — so the same spec + seed + operation sequence
injects the same faults at the same points, bit-identically, regardless of
wall-clock time or thread scheduling *within* one operation stream.  (With
probabilistic rules across *concurrently racing* streams the interleaving
itself must be deterministic for full replay — the tests drive deterministic
sequences; ``count``/``at``/``after`` rules are replay-safe even under
concurrency per stream.)

The engine records every injection in :attr:`ChaosEngine.log` (bounded) —
the replay-determinism test simply compares two runs' logs.
"""
from __future__ import annotations

import errno
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

_OPS = ("read", "write", "publish", "replicate", "fabric")
_FAULTS = ("eio", "erofs", "enospc", "stall", "hang", "torn", "crash")
#: Which fault classes apply to read operations too (the rest are
#: write-side: a read-only filesystem still serves reads).
_READ_FAULTS = ("eio", "stall", "hang", "crash")
_LOG_CAP = 8192
#: Safety cap on an un-released ``hang`` so an abandoned writer thread can
#: never outlive a test session.
_HANG_CAP_S = 600.0


class ChaosCrash(BaseException):
    """Simulated process death at an injection point.

    Deliberately a ``BaseException``: nothing on the write path may catch
    it, clean up staging, or degrade around it — a real crash would not
    have either.  Recovery is the *next* process's job (tmp sweep + the
    atomic-rename protocol).
    """


class ChaosRule:
    """One parsed ``slot:fault:params`` rule."""

    __slots__ = ("slot", "fault", "p", "ms", "after", "count", "at", "op",
                 "injected")

    def __init__(self, slot: str, fault: str, params: Dict[str, str]):
        if fault not in _FAULTS:
            raise ValueError(
                f"CRAFT_CHAOS fault {fault!r}: expected one of {_FAULTS}")
        if slot != "*" and slot not in ("mem", "node", "pfs"):
            raise ValueError(
                f"CRAFT_CHAOS slot {slot!r}: expected mem|node|pfs|*")
        self.slot = slot
        self.fault = fault
        self.p = 1.0
        self.ms = 0.0
        self.after = 0
        self.count: Optional[int] = None
        self.at: Optional[int] = None
        self.op: Optional[str] = None
        self.injected = 0
        for key, val in params.items():
            if key == "p":
                self.p = float(val)
                if not 0.0 <= self.p <= 1.0:
                    raise ValueError(f"CRAFT_CHAOS p={val!r}: expected 0..1")
            elif key == "ms":
                self.ms = float(val)
                if self.ms < 0:
                    raise ValueError(f"CRAFT_CHAOS ms={val!r}")
            elif key == "after":
                self.after = int(val)
            elif key == "count":
                self.count = int(val)
            elif key == "at":
                self.at = int(val)
            elif key == "op":
                if val not in _OPS:
                    raise ValueError(
                        f"CRAFT_CHAOS op={val!r}: expected one of {_OPS}")
                self.op = val
            else:
                raise ValueError(f"CRAFT_CHAOS: unknown param {key!r}")
        if fault == "stall" and self.ms <= 0:
            raise ValueError("CRAFT_CHAOS stall needs ms=<duration>")

    def matches(self, slot: str, op: str, index: int, draw: float) -> bool:
        """Should this rule inject on matching-op ``index`` with RNG ``draw``?"""
        if self.slot != "*" and self.slot != slot:
            return False
        if self.op is not None and self.op != op:
            return False
        if op == "read" and self.fault not in _READ_FAULTS:
            return False
        if self.count is not None and self.injected >= self.count:
            return False
        if self.at is not None:
            return index == self.at
        if index < self.after:
            return False
        return draw < self.p

    def spec(self) -> str:
        parts = [self.slot, self.fault]
        params = []
        if self.p != 1.0:
            params.append(f"p={self.p}")
        if self.ms:
            params.append(f"ms={self.ms:g}")
        if self.after:
            params.append(f"after={self.after}")
        if self.count is not None:
            params.append(f"count={self.count}")
        if self.at is not None:
            params.append(f"at={self.at}")
        if self.op is not None:
            params.append(f"op={self.op}")
        if params:
            parts.append("+".join(params))
        return ":".join(parts)


def parse_chaos_spec(raw: str) -> List[ChaosRule]:
    """``CRAFT_CHAOS`` string → rule list (raises ``ValueError`` on typos)."""
    raw = (raw or "").strip()
    if not raw or raw.lower() in ("on", "1", "true"):
        return []
    rules = []
    for tok in raw.replace(";", ",").split(","):
        tok = tok.strip()
        if not tok:
            continue
        fields = tok.split(":")
        if len(fields) < 2 or len(fields) > 3:
            raise ValueError(
                f"CRAFT_CHAOS rule {tok!r}: expected slot:fault[:k=v[+k=v]]")
        slot, fault = fields[0].strip().lower(), fields[1].strip().lower()
        params: Dict[str, str] = {}
        if len(fields) == 3:
            for kv in fields[2].split("+"):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(
                        f"CRAFT_CHAOS rule {tok!r}: param {kv!r} is not k=v")
                k, v = kv.split("=", 1)
                params[k.strip().lower()] = v.strip()
        rules.append(ChaosRule(slot, fault, params))
    return rules


def _draw(seed: int, slot: str, op: str, index: int) -> float:
    """Deterministic uniform [0, 1) draw for one operation — a pure function
    of (seed, slot, op, index), so replays are bit-identical."""
    key = f"{seed}:{slot}:{op}:{index}".encode()
    return (zlib.crc32(key) & 0xFFFFFFFF) / 4294967296.0


class ChaosEngine:
    """Process-local fault injector shared by every tier of one checkpoint.

    Thread-safe: IO call sites run on the sequencer, the worker pool, and
    deadline helper threads concurrently.  ``clear()`` lifts faults at
    runtime (the "outage ends" event); ``release()`` unblocks in-flight
    ``hang`` faults so abandoned writer threads can die.
    """

    def __init__(self, spec: str = "", seed: int = 0,
                 sleep=time.sleep):
        self.rules: List[ChaosRule] = parse_chaos_spec(spec)
        self.seed = int(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._released = threading.Event()
        self.log: List[str] = []          # "slot:op:index:fault" per injection
        self.stats: Dict[str, int] = {f: 0 for f in _FAULTS}
        self.stats["ops"] = 0

    # -- rule management ----------------------------------------------------
    def add(self, spec: str) -> None:
        """Arm additional rules mid-run (soak schedules, outage tests)."""
        fresh = parse_chaos_spec(spec)
        with self._lock:
            self.rules.extend(fresh)

    def clear(self, slot: Optional[str] = None,
              fault: Optional[str] = None) -> int:
        """Lift matching rules (``None`` matches everything); returns the
        number removed.  This is the "fault cleared" event the breaker's
        half-open probe discovers."""
        with self._lock:
            keep, dropped = [], 0
            for r in self.rules:
                if (slot is None or r.slot == slot) and \
                        (fault is None or r.fault == fault):
                    dropped += 1
                else:
                    keep.append(r)
            self.rules = keep
        return dropped

    def release(self) -> None:
        """Unblock every in-flight (and future) ``hang`` — hung operations
        then fail with ``EIO`` instead of publishing stale state late."""
        self._released.set()

    def op_count(self, slot: str, op: str) -> int:
        """Operations observed so far for (slot, op) — lets tests aim an
        ``at=N`` crash rule at a precise future operation."""
        with self._lock:
            return self._counters.get((slot, op), 0)

    def scope(self, slot: str) -> "ChaosScope":
        return ChaosScope(self, slot)

    # -- injection ----------------------------------------------------------
    def check(self, slot: str, op: str, nbytes: int = 0, path=None) -> None:
        """Fault gate for one IO operation; raises / stalls per the rules."""
        fault, rule, index = self._pick(slot, op)
        if fault is None:
            return
        where = f"{slot}:{op}" + (f" {path}" if path is not None else "")
        if fault == "stall":
            self._sleep(min(rule.ms, 60_000.0) / 1000.0)
            return
        if fault == "hang":
            # park until release() or the safety cap, then fail the op —
            # a hung write must never complete late and publish stale state
            self._released.wait(timeout=_HANG_CAP_S)
            raise OSError(errno.EIO, f"chaos: hung io abandoned ({where})")
        if fault == "crash":
            raise ChaosCrash(f"chaos: crash-at-point ({where}, op {index})")
        if fault == "eio":
            raise OSError(errno.EIO, f"chaos: transient EIO ({where})")
        if fault == "erofs":
            raise OSError(errno.EROFS, f"chaos: read-only tier ({where})")
        if fault == "enospc":
            raise OSError(errno.ENOSPC, f"chaos: no space left ({where})")

    def torn_limit(self, slot: str, total: int) -> Optional[int]:
        """Byte prefix a ``torn`` rule allows for this write, else None.

        Counted on the dedicated ``(slot, "torn")`` stream so torn draws
        never perturb the ``write`` stream's indices."""
        fault, rule, index = self._pick(slot, "torn", faults=("torn",))
        if fault is None:
            return None
        # deterministic tear point: at least 1 byte short, at most half gone
        frac = 0.5 + _draw(self.seed ^ 0x7EA2, slot, "torn", index) / 2.0
        return max(0, min(total - 1, int(total * frac)))

    def _pick(self, slot: str, op: str, faults=None):
        with self._lock:
            key = (slot, op)
            index = self._counters.get(key, 0)
            self._counters[key] = index + 1
            self.stats["ops"] += 1
            draw = _draw(self.seed, slot, op, index)
            for rule in self.rules:
                if faults is not None and rule.fault not in faults:
                    continue
                if faults is None and rule.fault == "torn":
                    continue          # torn is drawn via torn_limit()
                if rule.matches(slot, op, index, draw):
                    rule.injected += 1
                    self.stats[rule.fault] += 1
                    if len(self.log) < _LOG_CAP:
                        self.log.append(f"{slot}:{op}:{index}:{rule.fault}")
                    return rule.fault, rule, index
        return None, None, index


class ChaosScope:
    """A :class:`ChaosEngine` bound to one tier slot — what the IO paths
    carry (via ``IOContext.chaos`` / ``StorageTier.chaos_scope``)."""

    __slots__ = ("engine", "slot")

    def __init__(self, engine: ChaosEngine, slot: str):
        self.engine = engine
        self.slot = slot

    def check(self, op: str, nbytes: int = 0, path=None) -> None:
        self.engine.check(self.slot, op, nbytes=nbytes, path=path)

    def torn_limit(self, total: int) -> Optional[int]:
        return self.engine.torn_limit(self.slot, total)
