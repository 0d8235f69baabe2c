"""The program's spans in the benchmark, on the CPU: idle gaps labelled by
them, the five readers of them against hand-made spans, a traced run's
readings of its window alone, and untraced runs left with the program's
no-op tracer.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import devtrace, harness, paths, spec  # noqa: E402
from bench.lib import spans as sp  # noqa: E402
from bench.lib.record import Ctx, Record  # noqa: E402

MS = 1_000_000


def _span(i, name, t0_ms, t1_ms, parent=None, **fields):
    return {"name": name, "start_ns": int(t0_ms * MS),
            "end_ns": int(t1_ms * MS), "id": i, "parent": parent,
            "fields": fields}


def test_an_idle_gap_takes_the_innermost_program_span():
    dev = [("k", 0, 10 * MS), ("k", 30 * MS, 100 * MS)]
    spans = [(0, 100 * MS, "bench::solve"),
             (1 * MS, 99 * MS, "craft::lanczos.solve"),
             (12 * MS, 28 * MS, "craft::lanczos.open")]
    red = devtrace.reduce_events(dev, (0, 100 * MS), spans)
    assert red["breakdown"]["idle_gaps"] == [
        ["craft::lanczos.open", pytest.approx(0.020)]]
    red = devtrace.reduce_events(dev, (0, 100 * MS), spans[:2])
    assert red["breakdown"]["idle_gaps"][0][0] == "craft::lanczos.solve"


def _resume_spans():
    """A set-up restore, then two restore cycles of the window: a solve
    whose open holds two adds (one copying to the host), and a restart
    whose two item copies onto the card overlap."""
    s = []
    for c, base in enumerate((-5000, 0, 1000)):
        k = 100 * c
        s += [
            _span(k, "craft::lanczos.solve", base, base + 900),
            _span(k + 1, "craft::lanczos.open", base, base + 60, k,
                  cp="aftlan"),
            _span(k + 2, "craft::cp.add", base + 5, base + 35, k + 1),
            _span(k + 3, "craft::cp.d2h", base + 10, base + 30 + 50 * (c == 0),
                  k + 2, bytes=8),
            _span(k + 4, "craft::cp.add", base + 40, base + 41, k + 1),
            _span(k + 5, "craft::cp.restart", base + 61, base + 261, k,
                  restored=True),
            _span(k + 7, "craft::cp.restore", base + 64, base + 250, k + 5),
            _span(k + 8, "craft::cp.h2d", base + 100, base + 200, k + 7),
            _span(k + 9, "craft::cp.h2d", base + 150, base + 240, k + 7),
        ]
    return s


def _lanczos_spans():
    """A set-up solve, then two solves of the window."""
    return [_span(90, "craft::lanczos.solve", -900, -1),
            _span(91, "craft::lanczos.iterate", -800, -700, 90),
            _span(92, "craft::lanczos.step", -800, -700, 91),
            _span(1, "craft::lanczos.solve", 0, 500),
            _span(2, "craft::lanczos.open", 1, 20, 1),
            _span(3, "craft::lanczos.iterate", 100, 400, 1),
            _span(4, "craft::lanczos.step", 100, 110, 3),
            _span(6, "craft::lanczos.read", 102, 110, 4),
            _span(7, "craft::lanczos.step", 110, 120, 3),
            _span(8, "craft::lanczos.read", 114, 120, 7),
            _span(9, "craft::lanczos.solve", 600, 900),
            _span(10, "craft::lanczos.iterate", 650, 850, 9)]


@pytest.mark.parametrize("metric,spans,counts,want", [
    ("add_d2h_s.resume", _resume_spans, {"restores": 2}, 0.020),
    ("restore_h2d_s.resume", _resume_spans, {"restores": 2}, 0.140),
    ("restore_host_s.resume", _resume_spans, {"restores": 2}, 0.200 - 0.140),
    ("solve_edges_s.lanczos", _lanczos_spans, {"solves": 2},
     (0.200 + 0.100) / 2),
    ("step_enqueue_ms.lanczos", _lanczos_spans, {"solves": 2},
     (2.0 + 4.0) / 2),
])
def test_each_span_reader_reads_the_windows_hand_made_spans(
        monkeypatch, metric, spans, counts, want):
    reader = spec.reader(metric)
    assert reader.SOURCE == "program_span"
    monkeypatch.setattr(sp, "program", spans)
    assert reader.read(Record(counts=dict(counts))) == pytest.approx(want)
    # no count of the window, or more than the recorder kept: no reading
    assert reader.read(Record()) is None
    assert reader.read(Record(counts={k: 9 for k in counts})) is None
    monkeypatch.setattr(sp, "program", list)
    assert reader.read(Record(counts=dict(counts))) is None


def test_covered_seconds_count_an_overlap_once():
    a = _span(1, "x", 0, 10)
    b = _span(2, "x", 5, 20)
    c = _span(3, "x", 30, 31)
    assert sp.covered_s([b, c, a]) == pytest.approx(0.021)
    assert sp.covered_s([]) == 0.0


def test_the_programs_spans_are_read_in_place_and_not_without_a_recorder(
        monkeypatch):
    from repro_torch.core import trace

    trace.install_memory()
    try:
        with trace.TRACER.span("craft::cp.h2d", bytes=4):
            pass
        trace.emit("restore", seconds=0.1)
        assert [s["name"] for s in sp.program()] == ["craft::cp.h2d"]
        assert sp.program()[0]["fields"] == {"bytes": 4}
        monkeypatch.delattr(trace, "kept")
        assert sp.program() == []
    finally:
        trace.uninstall()
    monkeypatch.undo()
    assert sp.program() == []


def _tiny(name):
    c = copy.deepcopy(spec.cell(name))
    c.config["lattice"].update(nx=16, ny=16)
    c.traffic["problems"] = 1
    if "n_iter" in c.traffic:
        c.traffic["n_iter"] = 20
    return c


def _execute(c, trace_on, seconds):
    return harness.execute(Ctx(cell=c, seed=2 ** 31 + 5, seconds=seconds,
                               trace=trace_on, device="cpu",
                               workdir=str(paths.workdir("spans")),
                               t0=time.perf_counter()))


@pytest.mark.parametrize("name,metrics", [
    ("graphene-8192.resume-mem", ["add_d2h_s.resume", "restore_h2d_s.resume",
                                  "restore_host_s.resume"]),
    ("graphene-8192.lanczos", ["solve_edges_s.lanczos",
                               "step_enqueue_ms.lanczos"]),
])
def test_a_traced_run_reports_the_span_metrics_of_its_window(name, metrics):
    from repro_torch.core import metrics as craft_metrics
    from repro_torch.core import trace

    c = _tiny(name)
    try:
        rec = _execute(c, True, 0.5)
        line = harness.result(c, rec, True, {"platform": "cpu"})
        spans = sp.program()
    finally:
        craft_metrics.uninstall()
    assert line["correct"] is True
    for m in metrics:
        assert line["metrics"][m]["value"] >= 0, m
    assert not trace.enabled()
    # the recorder is armed at the set-up's first commit: the set-up's
    # later restores are kept too, and left out
    if "restores" in rec.counts:
        window = sp.restores(spans, rec)
        assert len(window) == rec.counts["restores"] > 0
        assert sum(s["name"] == "craft::cp.restart" for s in spans) \
            > len(window)
    else:
        assert len(sp.solves(spans, rec)) == rec.counts["solves"] > 0


@pytest.mark.parametrize("name", ["graphene-8192.resume-mem",
                                  "graphene-8192.lanczos"])
def test_an_untraced_run_keeps_the_programs_no_op_tracer(monkeypatch, name):
    import repro_torch.apps.lanczos as lz
    from repro_torch.core import trace

    seen = []
    orig = lz._iterate

    def watched(*a, **kw):
        seen.append(type(trace.TRACER).__name__)
        return orig(*a, **kw)

    monkeypatch.setattr(lz, "_iterate", watched)
    c = _tiny(name)
    rec = _execute(c, False, 0.3)
    line = harness.result(c, rec, False, {"platform": "cpu"})
    assert line["correct"] is True
    assert seen and set(seen) == {"_NullTracer"}
    assert type(trace.TRACER).__name__ == "_NullTracer"
