"""Live telemetry plane: a dependency-free metrics registry (``CRAFT_METRICS``).

Where :mod:`repro_torch.core.trace` records a *post-hoc* event log for the
record → replay → tune loop, this module keeps *live* aggregates — the
counters, gauges and histograms a fleet operator scrapes while the job is
running (served by :mod:`repro_torch.core.telemetry` at ``/metrics``; rendered
interactively by ``python -m repro.top``).

Design mirrors ``trace.py`` exactly:

* a module-global :data:`REGISTRY` that stays the no-op
  :class:`_NullRegistry` until :func:`install` — when ``CRAFT_METRICS`` is
  unset every hook is a single dynamic call that immediately returns (no
  branching, no locking, no string formatting; ``benchmarks/cr_overhead.py
  metrics_overhead`` keeps the armed-vs-off delta on the scoreboard);
* process-global, because one process may run several ``Checkpoint``
  objects plus an async writer plus a scrubber thread, and the exporter
  needs one coherent scrape of all of them;
* thread-safe via one cheap lock (instruments are plain floats; the lock
  is held for a dict update only).

Instrument model (a deliberately tiny Prometheus subset):

=============  ==========================================================
counter        monotonically increasing float (``inc``); cross-rank merge
               is a **sum**
gauge          last-written float (``set_gauge``); cross-rank merge keeps
               the **max** (worst-case semantics: oldest pending write,
               most-open breaker, deepest queue)
histogram      fixed-bucket cumulative counts + sum + count (``observe``);
               cross-rank merge sums bucket-wise
=============  ==========================================================

Series are keyed by ``(name, sorted(labels))`` just like Prometheus, so
``craft_tier_write_seconds_sum{slot="pfs"}`` and ``...{slot="mem"}`` are
independent series of one metric.

Cross-rank aggregation rides the existing comm fabric: :func:`aggregate`
allgathers each rank's :func:`snapshot` (``op="list"`` — the same
mechanism ``MemStore.publish`` uses) and merges, so rank 0 sees fleet
totals.  Collectives run over *live* members only, which makes the merge
tolerant of dead ranks after an AFT recovery for free.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "REGISTRY", "inc", "set_gauge", "observe", "enabled",
    "install", "uninstall", "maybe_install_from_env",
    "snapshot", "merge", "render_prometheus", "aggregate",
    "MetricsRegistry", "StatsView", "DEFAULT_BUCKETS",
]

#: Fixed histogram buckets (seconds): IO latencies on the CR path span
#: sub-millisecond RAM publishes to multi-second degraded PFS writes.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, str]) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class _NullRegistry:
    """The ``CRAFT_METRICS``-unset registry: every hook is a no-op."""

    enabled = False

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        return None

    def set_gauge(self, name: str, value: float, **labels) -> None:
        return None

    def observe(self, name: str, value: float, **labels) -> None:
        return None

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


class MetricsRegistry:
    """Lock-cheap in-process store of counters/gauges/histograms."""

    enabled = True

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        # histogram value: [bucket_counts..., +Inf_count] , sum, count
        self._hists: Dict[_Key, Tuple[List[int], float, int]] = {}

    # ------------------------------------------------------------ writes
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        v = float(value)
        with self._lock:
            ent = self._hists.get(k)
            if ent is None:
                ent = ([0] * (len(self.buckets) + 1), 0.0, 0)
            counts, total, n = ent
            counts = list(counts)
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._hists[k] = (counts, total + v, n + 1)

    # ------------------------------------------------------------- reads
    def snapshot(self) -> dict:
        """A plain-dict copy safe to merge/serialize (keys re-encoded as
        ``name|k=v|k=v`` strings so the snapshot survives JSON)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (list(c), s, n) for k, (c, s, n) in self._hists.items()}
        return {
            "buckets": list(self.buckets),
            "counters": {_flat(k): v for k, v in counters.items()},
            "gauges": {_flat(k): v for k, v in gauges.items()},
            "histograms": {
                _flat(k): {"counts": c, "sum": s, "count": n}
                for k, (c, s, n) in hists.items()
            },
        }


def _flat(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "|" + "|".join(f"{k}={v}" for k, v in labels)


def _unflat(flat: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    parts = flat.split("|")
    labels = tuple(tuple(p.split("=", 1)) for p in parts[1:])
    return parts[0], labels  # type: ignore[return-value]


#: The process-wide registry.  Hooks call the module-level helpers (which
#: read :data:`REGISTRY` at call time, so early importers see later installs).
REGISTRY = _NullRegistry()


def inc(name: str, value: float = 1.0, **labels) -> None:
    REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    REGISTRY.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    REGISTRY.observe(name, value, **labels)


def enabled() -> bool:
    return REGISTRY.enabled


@contextlib.contextmanager
def timed(name: str, **labels):
    """Add the wall seconds of the ``with`` block to counter ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        REGISTRY.inc(name, time.perf_counter() - t0, **labels)


def install() -> "MetricsRegistry":
    """Arm the registry (idempotent: an armed registry keeps its series)."""
    global REGISTRY
    if not REGISTRY.enabled:
        REGISTRY = MetricsRegistry()
    return REGISTRY  # type: ignore[return-value]


def uninstall() -> None:
    """Back to the no-op registry (tests; end of a metered benchmark)."""
    global REGISTRY
    REGISTRY = _NullRegistry()


def maybe_install_from_env(env) -> None:
    """Arm the registry when the captured env asks for it
    (``Checkpoint.commit()`` calls this — the read-once contract)."""
    if getattr(env, "metrics", False):
        install()


def snapshot() -> dict:
    return REGISTRY.snapshot()


# --------------------------------------------------------------------- merge
def merge(snapshots: Iterable[dict]) -> dict:
    """Merge per-rank snapshots into fleet totals: counters and histogram
    buckets **sum**; gauges keep the **max** (worst-case-wins semantics)."""
    out = {"buckets": None, "counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not snap:
            continue
        if out["buckets"] is None:
            out["buckets"] = snap.get("buckets")
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in snap.get("gauges", {}).items():
            prev = out["gauges"].get(k)
            out["gauges"][k] = v if prev is None else max(prev, v)
        for k, h in snap.get("histograms", {}).items():
            prev = out["histograms"].get(k)
            if prev is None:
                out["histograms"][k] = {
                    "counts": list(h["counts"]),
                    "sum": h["sum"], "count": h["count"],
                }
            else:
                prev["counts"] = [a + b for a, b
                                  in zip(prev["counts"], h["counts"])]
                prev["sum"] += h["sum"]
                prev["count"] += h["count"]
    if out["buckets"] is None:
        out["buckets"] = list(DEFAULT_BUCKETS)
    return out


def aggregate(comm, snap: Optional[dict] = None) -> dict:
    """Allgather every live rank's snapshot over ``comm`` and merge.

    Uses ``op="list"`` (the MemStore.publish mechanism); post-AFT the
    collective only spans surviving members, so dead ranks simply drop out
    of the fleet totals.  Falls back to the local snapshot if the fabric
    is broken mid-recovery.
    """
    if snap is None:
        snap = snapshot()
    if comm is None or getattr(comm, "size", 1) <= 1:
        return merge([snap])
    try:
        gathered = comm.allreduce(snap, op="list")
    except Exception:
        return merge([snap])
    if not isinstance(gathered, list):
        gathered = [gathered]
    return merge(g for g in gathered if isinstance(g, dict))


# ---------------------------------------------------------------- rendering
def render_prometheus(snap: dict, prefix: str = "craft_") -> str:
    """Render a snapshot (local or merged) in Prometheus text exposition
    format, stdlib only."""
    lines: List[str] = []
    buckets = snap.get("buckets") or list(DEFAULT_BUCKETS)

    def series(flat: str) -> Tuple[str, str]:
        name, labels = _unflat(flat)
        lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels)
        return prefix + name, ("{" + lab + "}") if lab else ""

    seen_type: Dict[str, str] = {}

    def header(full_name: str, typ: str) -> None:
        if seen_type.get(full_name) != typ:
            seen_type[full_name] = typ
            lines.append(f"# TYPE {full_name} {typ}")

    for flat in sorted(snap.get("counters", {})):
        full, lab = series(flat)
        header(full + "_total", "counter")
        lines.append(f"{full}_total{lab} {_fmt(snap['counters'][flat])}")
    for flat in sorted(snap.get("gauges", {})):
        full, lab = series(flat)
        header(full, "gauge")
        lines.append(f"{full}{lab} {_fmt(snap['gauges'][flat])}")
    for flat in sorted(snap.get("histograms", {})):
        full, lab = series(flat)
        h = snap["histograms"][flat]
        header(full, "histogram")
        base = lab[1:-1] if lab else ""
        cum = 0
        for i, ub in enumerate(buckets):
            cum += h["counts"][i]
            le = _fmt(ub)
            extra = f'{base},le="{le}"' if base else f'le="{le}"'
            lines.append(f"{full}_bucket{{{extra}}} {cum}")
        cum += h["counts"][len(buckets)]
        extra = f'{base},le="+Inf"' if base else 'le="+Inf"'
        lines.append(f"{full}_bucket{{{extra}}} {cum}")
        lines.append(f"{full}_sum{lab} {_fmt(h['sum'])}")
        lines.append(f"{full}_count{lab} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Parse Prometheus text back into ``{metric: {label_str: value}}`` —
    the scrape round-trip used by tests and ``repro.top``."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, val = line.rsplit(" ", 1)
            if "{" in series:
                name, rest = series.split("{", 1)
                labels = rest.rstrip("}")
            else:
                name, labels = series, ""
            out.setdefault(name, {})[labels] = float(val)
        except ValueError:
            continue
    return out


# -------------------------------------------------------------- StatsView
class StatsView(dict):
    """``Checkpoint.stats``: a real dict (full back-compat for tests and
    callers that iterate/copy it) whose numeric writes are mirrored into
    the global registry as ``cp_<key>`` counters/gauges.

    The mirror is one dynamic no-op call when ``CRAFT_METRICS`` is unset —
    same overhead contract as a bare ``trace.emit``.  Non-numeric values
    (``restore_tier``, the nested ``tier_reads`` dict) stay local-only.
    Monotone growth (``writes`` going 3 → 4) mirrors as a counter *delta*
    so the cross-rank merge sums to true fleet totals; a shrink or a fresh
    non-monotone set (``restore_read_bytes``) mirrors as a gauge.
    """

    def __init__(self, name: str, *args, prefix: str = "cp_",
                 label: str = "cp", **kw):
        super().__init__(*args, **kw)
        self._name = name
        self._prefix = prefix
        self._label = label

    def __setitem__(self, key, value):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            prev = super().get(key, 0)
            if (isinstance(prev, (int, float)) and not isinstance(prev, bool)
                    and value >= prev):
                if value > prev:
                    REGISTRY.inc(self._prefix + key, value - prev,
                                 **{self._label: self._name})
            else:
                REGISTRY.set_gauge(self._prefix + key, value,
                                   **{self._label: self._name})
        super().__setitem__(key, value)

    def inc(self, key, delta=1):
        """``stats.inc("writes")`` — the one-liner replacing scattered
        ``stats[k] += 1``; routes through ``__setitem__`` so the registry
        mirror sees the delta exactly once."""
        self[key] = self.get(key, 0) + delta
