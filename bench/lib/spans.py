"""The program's own spans, read in the process once a run is over.

A traced run sets ``CRAFT_METRICS``, and with it the program keeps its
newest spans in memory (``repro_torch.core.trace.kept``).  They are host
``perf_counter_ns`` ranges ({"name", "start_ns", "end_ns", "id", "parent",
"fields"}, parents linked by id).  The run's window is told apart from its
set-up by count: the runner's record counts the window's restores and
solves, and nothing of the program runs after the window, so the window's
are the last of them.  A program that keeps no spans (an untraced run, or
a checkout from before the recorder) gives none, and the metrics read from
them are left out of the line.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


def program() -> List[dict]:
    """The spans the program's memory recorder holds, in the order they
    ended; [] when it holds none."""
    from repro_torch.core import trace

    kept = getattr(trace, "kept", None)
    if kept is None:
        return []
    return [{"name": r.name, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "id": r.id, "parent": r.parent, "fields": dict(r.fields)}
            for r in kept() if isinstance(r, trace.SpanRecord)]


def seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def last(spans: List[dict], name: str, n) -> List[dict]:
    """The last ``n`` spans called ``name`` by start; [] when fewer were
    kept (or ``n`` is not a count)."""
    got = sorted((s for s in spans if s["name"] == name),
                 key=lambda s: s["start_ns"])
    n = int(n or 0)
    return got[-n:] if n and len(got) >= n else []


def children(spans: List[dict]) -> Dict[int, List[dict]]:
    """{span id: the spans it encloses directly}."""
    out: Dict[int, List[dict]] = defaultdict(list)
    for s in spans:
        if s["parent"] is not None:
            out[s["parent"]].append(s)
    return out


def under(kids: Dict[int, List[dict]], root: dict, name: str) -> List[dict]:
    """The spans called ``name`` anywhere below ``root`` (not below one of
    their own kind)."""
    found, todo = [], list(kids.get(root["id"], ()))
    while todo:
        s = todo.pop()
        if s["name"] == name:
            found.append(s)
        else:
            todo.extend(kids.get(s["id"], ()))
    return found


def covered_s(spans: List[dict]) -> float:
    """Seconds covered by the union of ``spans`` (items restored on two
    threads at once overlap)."""
    total, end = 0, None
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        lo, hi = s["start_ns"], s["end_ns"]
        if end is not None and lo < end:
            lo = end
        if hi > lo:
            total += hi - lo
        end = hi if end is None else max(end, hi)
    return total * 1e-9


def restores(spans: List[dict], rec) -> List[dict]:
    """The window's ``craft::cp.restart`` spans that read a version: the
    last as many restarts as the record counts restores."""
    return [s for s in last(spans, "craft::cp.restart",
                            rec.counts.get("restores"))
            if s["fields"].get("restored")]


def solves(spans: List[dict], rec) -> List[dict]:
    """The window's ``craft::lanczos.solve`` spans: the last as many as the
    record counts solves."""
    return last(spans, "craft::lanczos.solve", rec.counts.get("solves"))


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
