"""Spans of the port's tracer (``repro_torch.core.trace``) on the CPU: their
nesting and self time, the disarmed tracer's cost (no clock, nothing kept),
the memory recorder's cap and its arming by ``CRAFT_METRICS``, the spans a
restore through the memory tier leaves, and JSONL traces, which keep
their events and no spans.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.apps.lanczos import GrapheneConfig, run_with_hook
from repro_torch.core import Box, Checkpoint, MemFabric, trace
from repro_torch.core.comm import NullComm
from repro_torch.core.env import CraftEnv
from repro_torch.core.simulate import load_trace, replay, summarize


@pytest.fixture(autouse=True)
def _isolation():
    MemFabric.instance().reset()
    yield
    trace.uninstall()
    MemFabric.instance().reset()


def _spans(records):
    return [r for r in records if isinstance(r, trace.SpanRecord)]


def _self_ns(span, spans):
    return (span.end_ns - span.start_ns) - sum(
        c.end_ns - c.start_ns for c in spans if c.parent == span.id)


def test_spans_nest_with_parents_and_self_time():
    trace.install_memory()
    with trace.TRACER.span("outer", cp="a") as outer:
        with trace.TRACER.span("inner", key="x"):
            time.sleep(0.002)
        with trace.TRACER.timed("second") as second:
            time.sleep(0.001)
        outer.set(version=3)
    with trace.TRACER.span("after"):
        pass
    spans = _spans(trace.drain()[0])
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "second", "outer", "after"]
    assert by["outer"].parent is None and by["after"].parent is None
    assert by["inner"].parent == by["second"].parent == by["outer"].id
    assert by["outer"].fields == {"cp": "a", "version": 3}
    assert by["inner"].fields == {"key": "x"}
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert by["outer"].start_ns <= by["inner"].start_ns
    assert by["second"].end_ns <= by["outer"].end_ns
    assert second.seconds == pytest.approx(
        (by["second"].end_ns - by["second"].start_ns) * 1e-9)
    own = _self_ns(by["outer"], spans)
    assert 0 <= own < by["outer"].end_ns - by["outer"].start_ns - 3e6


def test_a_span_stopped_early_keeps_its_end_and_leaves_the_stack():
    trace.install_memory()
    with trace.TRACER.timed("restore") as sp:
        first = sp.stop()
        with trace.TRACER.span("later"):
            pass
    assert sp.stop() == first == sp.seconds
    spans = {s.name: s for s in _spans(trace.drain()[0])}
    assert spans["later"].parent is None
    assert spans["later"].start_ns >= spans["restore"].end_ns


def test_spans_of_other_threads_keep_their_own_parents():
    trace.install_memory()
    seen = []

    def worker():
        with trace.TRACER.span("on_thread"):
            pass
        seen.append(True)

    with trace.TRACER.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        jobs = trace.TRACER.carry([lambda: trace.TRACER.span("carried")
                                   .__enter__().stop()])
        t = threading.Thread(target=jobs[0])
        t.start()
        t.join()
    spans = {s.name: s for s in _spans(trace.drain()[0])}
    assert seen and spans["on_thread"].parent is None
    assert spans["carried"].parent == spans["main"].id


def test_the_disarmed_span_reads_no_clock_and_keeps_nothing(monkeypatch):
    calls = []
    real = time.perf_counter_ns

    def counting():
        calls.append(1)
        return real()

    monkeypatch.setattr(time, "perf_counter_ns", counting)
    monkeypatch.setattr(trace, "_now_ns", counting)
    assert not trace.enabled()
    a = trace.TRACER.span("craft::cp.add", cp="x", key="v")
    b = trace.TRACER.span("craft::cp.h2d", bytes=8)
    assert a is b and not a.armed
    with a as sp:
        sp.set(bytes=3)
        with b:
            pass
    assert calls == []
    assert trace.TRACER.carry([len]) == [len]
    # the disarmed ``timed`` is the caller's own timer: two reads, no record
    with trace.TRACER.timed("craft::lanczos.step") as step:
        pass
    assert len(calls) == 2 and step.seconds >= 0
    trace.install_memory()
    assert trace.drain() == ([], 0)


def test_the_memory_recorder_keeps_its_newest_and_counts_the_rest():
    trace.install_memory(cap=3)
    for i in range(5):
        with trace.TRACER.span("s", i=i):
            pass
    trace.emit("restore", seconds=1.0)
    assert [r.fields.get("i") for r in trace.kept()] == [3, 4, None]
    assert len(trace.kept()) == 3          # kept() leaves them in place
    records, dropped = trace.drain()
    assert [r.fields.get("i") for r in records] == [3, 4, None]
    assert records[-1].kind == "restore" and dropped == 3
    trace.emit("step", seconds=0.5)
    records, dropped = trace.drain()
    assert dropped == 0 and len(records) == 1
    ev = records[0]
    assert isinstance(ev, trace.EventRecord) and ev.kind == "step"
    assert ev.fields == {"seconds": 0.5} and ev.t_ns > 0
    trace.uninstall()
    assert trace.drain() == ([], 0) and trace.kept() == []
    assert not trace.enabled()


def _restore_env(tmp_path, **extra):
    return CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                             "CRAFT_TIER_CHAIN": "mem",
                             "CRAFT_USE_SCR": "0", **extra})


def _committed(tmp_path, **extra):
    cp = Checkpoint("armed", env=_restore_env(tmp_path, **extra),
                    device="cpu")
    cp.add("v", Box(torch.zeros(4)))
    cp.commit()
    cp.close()


def test_craft_metrics_arms_the_memory_recorder_until_metrics_go(tmp_path):
    from repro_torch.core import metrics

    try:
        _committed(tmp_path)
        assert not trace.enabled() and not metrics.enabled()
        _committed(tmp_path, CRAFT_METRICS="1")
        assert isinstance(trace.TRACER, trace.MemoryTracer)
        assert metrics.enabled()
        assert [r.kind for r in trace.kept()
                if isinstance(r, trace.EventRecord)] == ["config"]
        metrics.uninstall()
        assert not trace.enabled()
        # a trace file wins: the recorder stays the JSONL writer
        _committed(tmp_path, CRAFT_METRICS="1",
                   CRAFT_TRACE=str(tmp_path / "t.jsonl"))
        assert isinstance(trace.TRACER, trace.JsonlTracer)
        metrics.uninstall()
        assert isinstance(trace.TRACER, trace.JsonlTracer)
    finally:
        metrics.uninstall()


def _chain(span, by_id):
    names = []
    while span is not None:
        names.append(span.name)
        span = by_id.get(span.parent)
    return names


def test_a_restore_through_the_memory_tier_records_its_spans(tmp_path):
    cfg = GrapheneConfig(nx=8, ny=8, disorder=0.3)
    env = _restore_env(tmp_path)
    run_with_hook(cfg, 11, 10, NullComm(), env, lambda it, cp: None,
                  device="cpu")
    trace.install_memory()
    out = run_with_hook(cfg, 11, 10 ** 9, NullComm(), env,
                        lambda it, cp: None, device="cpu")
    spans = _spans(trace.drain()[0])
    trace.uninstall()
    assert out["resumed_from"] == 10
    by_id = {s.id: s for s in spans}
    vector_bytes = 2 * cfg.n * 4
    d2h = [s for s in spans if s.name == "craft::cp.d2h"]
    assert {tuple(_chain(s, by_id)) for s in d2h} == {
        ("craft::cp.d2h", "craft::cp.add", "craft::lanczos.open",
         "craft::lanczos.solve")}
    assert sum(s.fields["bytes"] for s in d2h) == vector_bytes
    adds = [s for s in spans if s.name == "craft::cp.add"]
    assert sorted(s.fields["key"] for s in adds) == sorted(
        ["v_prev", "v_cur", "alphas", "betas", "it"])
    h2d = [s for s in spans if s.name == "craft::cp.h2d"]
    assert {tuple(_chain(s, by_id)) for s in h2d} == {
        ("craft::cp.h2d", "craft::cp.restore", "craft::cp.restart",
         "craft::lanczos.solve")}
    assert sum(s.fields["bytes"] for s in h2d) == vector_bytes
    (restart,) = [s for s in spans if s.name == "craft::cp.restart"]
    (restore,) = [s for s in spans if s.name == "craft::cp.restore"]
    assert restart.fields == {"cp": "aftlan", "restored": True}
    assert restore.fields["version"] == 1 and restore.fields["slot"] == "mem"
    steps = [s for s in spans if s.name == "craft::lanczos.step"]
    assert len(steps) == 1 and len(out["iter_s"]) == 1
    assert out["iter_s"][0] == pytest.approx(
        (steps[0].end_ns - steps[0].start_ns) * 1e-9)
    for name, parent in [("craft::lanczos.read", "craft::lanczos.step"),
                         ("craft::lanczos.step", "craft::lanczos.iterate"),
                         ("craft::lanczos.iterate", "craft::lanczos.solve"),
                         ("craft::lanczos.open", "craft::lanczos.solve")]:
        assert [by_id[s.parent].name for s in spans
                if s.name == name] == [parent], name
    assert {s.name for s in spans} == {
        "craft::lanczos.solve", "craft::lanczos.open", "craft::cp.add",
        "craft::cp.d2h", "craft::cp.restart", "craft::cp.restore",
        "craft::cp.h2d", "craft::lanczos.iterate", "craft::lanczos.step",
        "craft::lanczos.read", "craft::cp.fence"}


def test_the_restore_span_is_the_restore_seconds_clock(tmp_path):
    from repro_torch.core import metrics

    cfg = GrapheneConfig(nx=8, ny=8)
    env = _restore_env(tmp_path, CRAFT_METRICS="1")
    try:
        run_with_hook(cfg, 3, 2, NullComm(), env, lambda it, cp: None,
                      device="cpu")
        trace.drain()
        run_with_hook(cfg, 3, 10 ** 9, NullComm(), env, lambda it, cp: None,
                      device="cpu")
        hist = metrics.snapshot()["histograms"]["restore_seconds|slot=mem"]
        (restore,) = [s for s in _spans(trace.drain()[0])
                      if s.name == "craft::cp.restore"]
    finally:
        metrics.uninstall()
    assert hist["count"] == 1
    assert hist["sum"] == (restore.end_ns - restore.start_ns) * 1e-9


def _traced_run(tmp_path, n_iter=12):
    tpath = tmp_path / "trace.jsonl"
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                            "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
                            "CRAFT_TIER_EVERY": "node:2,pfs:5",
                            "CRAFT_TRACE": str(tpath)})
    arr = torch.arange(512, dtype=torch.float32)
    cp = Checkpoint("spans", env=env, device="cpu")
    cp.add("v", Box(arr))
    cp.add("n", np.zeros(4))
    cp.commit()
    cp.restart_if_needed()
    try:
        for it in range(n_iter):
            arr += 1.0
            if cp.need_checkpoint(it):
                cp.update_and_write(it)
        cp.wait()
    finally:
        cp.close()
        trace.uninstall()
    return load_trace(tpath)


def test_a_jsonl_trace_keeps_its_events_and_no_span_lines(tmp_path):
    events = _traced_run(tmp_path)
    assert not [e for e in events if e["kind"] == "span"]
    # the timed sites still give the events their seconds
    landed = [e for e in events if e["kind"] == "tier_write"]
    assert landed and all(e["seconds"] > 0 for e in landed)
    assert {e["slot"] for e in landed} == {"node", "pfs"}
    # a foreign kind of line (a span from another writer) is skipped
    spans = [{"t": e["t"], "kind": "span", "name": "craft::cp.tier_write",
              "seconds": e["seconds"], "id": i, "parent": None}
             for i, e in enumerate(landed, 1)]
    mixed = sorted(events + spans, key=lambda e: e["t"])
    plain, with_spans = replay(events), replay(mixed)
    assert plain.decisions_match and not plain.mismatches
    assert with_spans.sim_decisions == plain.sim_decisions
    assert with_spans.tier_landed == plain.tier_landed
    assert with_spans.tier_landed_bytes == plain.tier_landed_bytes
    assert summarize(mixed) == summarize(events)
