"""``python -m repro_torch.top`` — a curses-free refreshing terminal dashboard
for the live telemetry plane.

Two sources, one view:

* ``--url http://host:PORT`` — scrape a running job's exporter
  (``CRAFT_METRICS_PORT``): ``/metrics`` Prometheus text for the series,
  ``/healthz`` JSON for breaker states and checkpoint age.
* ``--trace run.jsonl`` — aggregate a ``CRAFT_TRACE`` file into the same
  panels (post-hoc ``top`` over a finished or still-appending run).

The screen redraws with plain ANSI (clear + home) every ``--interval``
seconds; ``--once`` prints a single frame and exits (tests, piping).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

from repro_torch.core.metrics import parse_prometheus

_CLEAR = "\x1b[2J\x1b[H"
_BOLD, _DIM, _RED, _GREEN, _YELLOW, _RESET = (
    "\x1b[1m", "\x1b[2m", "\x1b[31m", "\x1b[32m", "\x1b[33m", "\x1b[0m")


# ----------------------------------------------------------------- model
def _blank_model() -> dict:
    return {
        "source": "", "status": None, "version": None, "age_s": None,
        "tiers": {},        # slot -> {writes, bytes, seconds}
        "decisions": {},    # reason -> count
        "breakers": {},     # slot -> state string
        "degraded": {},     # slot -> count
        "restores": {},     # slot -> count
        "async": {},        # pending / oldest_pending_s / stalls
        "scrub": {},        # scrubber counters
        "counters": {},     # headline cp_* totals
    }


def _labels(label_str: str) -> Dict[str, str]:
    out = {}
    for part in label_str.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def model_from_url(url: str, timeout: float = 5.0) -> dict:
    m = _blank_model()
    m["source"] = url
    with urllib.request.urlopen(url.rstrip("/") + "/metrics",
                                timeout=timeout) as resp:
        series = parse_prometheus(resp.read().decode("utf-8"))
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                    timeout=timeout) as resp:
            health = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as exc:   # 503 == unhealthy, body is JSON
        health = json.loads(exc.read().decode("utf-8"))
    m["status"] = health.get("status")
    for name, cp in health.get("checkpoints", {}).items():
        m["version"] = cp.get("version")
        m["age_s"] = cp.get("last_write_age_s")
        for slot, b in cp.get("breakers", {}).items():
            m["breakers"][slot] = b.get("state", "?")
        m["async"].setdefault("pending", cp.get("async_backlog", 0))
        m["async"].setdefault("oldest_pending_s",
                              cp.get("async_oldest_pending_s", 0.0))
        if "scrubber" in cp:
            m["scrub"].update(cp["scrubber"])
    for lab, v in series.get("craft_tier_writes_total", {}).items():
        slot = _labels(lab).get("tier", "?")
        m["tiers"].setdefault(slot, {})["writes"] = int(v)
    for lab, v in series.get("craft_tier_write_bytes_total", {}).items():
        slot = _labels(lab).get("tier", "?")
        m["tiers"].setdefault(slot, {})["bytes"] = v
    for lab, v in series.get("craft_tier_write_seconds_sum", {}).items():
        slot = _labels(lab).get("tier", "?")
        m["tiers"].setdefault(slot, {})["seconds"] = v
    for lab, v in series.get("craft_policy_decisions_total", {}).items():
        m["decisions"][_labels(lab).get("reason", "?")] = int(v)
    for lab, v in series.get("craft_restores_total", {}).items():
        m["restores"][_labels(lab).get("slot", "?")] = int(v)
    for metric, key in (("craft_async_stall_warnings_total", "stalls"),
                        ("craft_async_pending", "pending"),
                        ("craft_async_oldest_pending_s", "oldest_pending_s")):
        for _, v in series.get(metric, {}).items():
            m["async"][key] = v
    for metric, vals in series.items():
        if metric.startswith("craft_cp_") and metric.endswith("_total"):
            key = metric[len("craft_cp_"):-len("_total")]
            m["counters"][key] = sum(vals.values())
        if metric.startswith("craft_scrub_"):
            key = metric[len("craft_scrub_"):].replace("_total", "")
            m["scrub"][key] = sum(vals.values())
    return m


def model_from_trace(path: str) -> dict:
    m = _blank_model()
    m["source"] = path
    counters = m["counters"]
    last_t = 0.0
    last_write_t = None
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:     # torn tail of a live file
                continue
            kind = ev.get("kind")
            last_t = max(last_t, float(ev.get("t", 0.0)))
            if kind == "tier_write":
                slot = ev.get("slot", "?")
                t = m["tiers"].setdefault(
                    slot, {"writes": 0, "bytes": 0, "seconds": 0.0})
                t["writes"] = t.get("writes", 0) + 1
                t["bytes"] = t.get("bytes", 0) + ev.get("nbytes", 0)
                t["seconds"] = t.get("seconds", 0.0) + ev.get("seconds", 0.0)
                counters["writes"] = counters.get("writes", 0) + 1
                last_write_t = ev.get("t", last_t)
            elif kind == "decision":
                reason = ev.get("reason") or "skip"
                m["decisions"][reason] = m["decisions"].get(reason, 0) + 1
            elif kind == "breaker":
                slot = ev.get("slot", "?")
                m["breakers"][slot] = "open"
                counters["breaker_trips"] = \
                    counters.get("breaker_trips", 0) + 1
            elif kind == "degraded":
                slot = ev.get("slot", "?")
                m["degraded"][slot] = m["degraded"].get(slot, 0) + 1
                counters["degraded_writes"] = \
                    counters.get("degraded_writes", 0) + 1
            elif kind == "restore":
                slot = ev.get("slot", ev.get("tier", "?"))
                m["restores"][slot] = m["restores"].get(slot, 0) + 1
            elif kind == "async_stall":
                m["async"]["stalls"] = m["async"].get("stalls", 0) + 1
                m["async"]["oldest_pending_s"] = ev.get("age_s", 0.0)
            elif kind == "scheduled":
                m["version"] = ev.get("version", m["version"])
    m["status"] = "trace"
    if last_write_t is not None:
        m["age_s"] = round(last_t - last_write_t, 3)
    return m


# ------------------------------------------------------------------ view
def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def render(m: dict, color: bool = True) -> str:
    def c(code: str, s: str) -> str:
        return f"{code}{s}{_RESET}" if color else s

    status = m.get("status") or "?"
    scol = {_GREEN: ("ok", "trace"), _RED: ("unhealthy",)}
    col = next((k for k, v in scol.items() if status in v), _YELLOW)
    lines = [
        c(_BOLD, "craft top") + f"  —  {m.get('source', '')}",
        f"status: {c(col, status)}"
        + (f"   version: v-{m['version']}" if m.get("version") is not None
           else "")
        + (f"   last write: {m['age_s']:.1f}s ago"
           if m.get("age_s") is not None else ""),
        "",
        c(_BOLD, f"{'TIER':<8}{'WRITES':>8}{'BYTES':>14}{'SECONDS':>10}"
                 f"{'BREAKER':>11}{'DEGRADED':>10}{'RESTORES':>10}"),
    ]
    slots = sorted(set(m["tiers"]) | set(m["breakers"])
                   | set(m["degraded"]) | set(m["restores"]))
    for slot in slots:
        t = m["tiers"].get(slot, {})
        state = m["breakers"].get(slot, "-")
        bcol = {"closed": _GREEN, "open": _RED,
                "half_open": _YELLOW}.get(state, _DIM)
        lines.append(
            f"{slot:<8}{t.get('writes', 0):>8}"
            f"{_fmt_bytes(t.get('bytes', 0)):>14}"
            f"{t.get('seconds', 0.0):>10.3f}"
            + c(bcol, f"{state:>11}")
            + f"{m['degraded'].get(slot, 0):>10}"
            f"{m['restores'].get(slot, 0):>10}")
    if not slots:
        lines.append(c(_DIM, "  (no tier activity yet)"))
    lines.append("")
    if m["decisions"]:
        total = sum(m["decisions"].values())
        lines.append(c(_BOLD, "DECISIONS") + f"  ({total} total)")
        for reason, n in sorted(m["decisions"].items(),
                                key=lambda kv: -kv[1]):
            bar = "#" * max(1, int(30 * n / max(1, total)))
            lines.append(f"  {reason:<12}{n:>8}  {c(_DIM, bar)}")
        lines.append("")
    a = m["async"]
    if a:
        stall = int(a.get("stalls", 0))
        lines.append(
            c(_BOLD, "ASYNC") + f"   pending: {int(a.get('pending', 0))}"
            f"   oldest: {float(a.get('oldest_pending_s', 0.0)):.2f}s"
            f"   stalls: " + (c(_RED, str(stall)) if stall else "0"))
    if m["scrub"]:
        s = m["scrub"]
        lines.append(
            c(_BOLD, "SCRUB") + "   "
            + "   ".join(f"{k}: {int(v)}" for k, v in sorted(s.items())
                         if v))
    hl = {k: v for k, v in m["counters"].items()
          if k in ("writes", "degraded_writes", "breaker_trips", "retries",
                   "read_repairs", "abandoned_writes") and v}
    if hl:
        lines.append(
            c(_BOLD, "TOTALS") + "  "
            + "   ".join(f"{k}: {int(v)}" for k, v in sorted(hl.items())))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.top",
        description="Live (or trace-replay) dashboard for the CRAFT "
                    "telemetry plane.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", help="exporter base URL, e.g. "
                                   "http://localhost:9109")
    src.add_argument("--trace", help="CRAFT_TRACE JSONL file to aggregate")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--no-color", action="store_true",
                    help="plain text (no ANSI colors)")
    args = ap.parse_args(argv)
    color = not args.no_color and sys.stdout.isatty()

    def frame() -> str:
        if args.url:
            return render(model_from_url(args.url), color=color)
        return render(model_from_trace(args.trace), color=color)

    if args.once:
        sys.stdout.write(frame())
        return 0
    try:
        while True:
            out = frame()
            sys.stdout.write(_CLEAR + out)
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
