"""The live telemetry plane on the port: the reference's
``tests/test_metrics.py`` run against ``repro_torch`` on the CPU —
registry semantics, the unset no-op fast path, cross-rank aggregation
(dead-rank tolerant), the /metrics + /healthz exporter, and
``python -m repro_torch.top`` — plus the port's own ``metrics.timed``."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import MemFabric, metrics, telemetry
from repro_torch.core.comm import ProcFailedError, RevokedError
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.env import CraftEnv
from repro_torch.core.metrics import (MetricsRegistry, StatsView, merge,
                                      parse_prometheus, render_prometheus)


def Checkpoint(*args, **kwargs):
    """The port's Checkpoint on the CPU (the tests run without a card)."""
    kwargs.setdefault("device", "cpu")
    return _Checkpoint(*args, **kwargs)


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    """The port's RAM fabric is process-global like the reference's (which
    conftest resets): wipe it around every test."""
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


@pytest.fixture(autouse=True)
def _telemetry_isolation():
    """Process-global registry/exporter must never leak across tests."""
    yield
    telemetry.stop()
    metrics.uninstall()


def _env(tmp_path, **extra):
    envmap = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_IO_BACKOFF_MS": "1",
        **{k: str(v) for k, v in extra.items()},
    }
    return CraftEnv.capture(envmap)


def _mk(tmp_path, arr, name="mx", **extra):
    cp = Checkpoint(name, env=_env(tmp_path, **extra))
    cp.add("arr", arr)
    cp.commit()
    return cp


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


# ------------------------------------------------------- registry semantics
class TestRegistry:
    def test_counters_gauges_histograms(self):
        reg = MetricsRegistry(buckets=(0.1, 1.0))
        reg.inc("writes")
        reg.inc("writes", 2.0)
        reg.inc("writes", 1.0, slot="pfs")
        reg.set_gauge("pending", 3)
        reg.set_gauge("pending", 1)           # last write wins
        reg.observe("lat", 0.05)
        reg.observe("lat", 0.5)
        reg.observe("lat", 99.0)              # lands in +Inf
        snap = reg.snapshot()
        assert snap["counters"]["writes"] == 3.0
        assert snap["counters"]["writes|slot=pfs"] == 1.0
        assert snap["gauges"]["pending"] == 1.0
        h = snap["histograms"]["lat"]
        assert h["counts"] == [1, 1, 1] and h["count"] == 3
        assert h["sum"] == pytest.approx(99.55)

    def test_label_order_is_canonical(self):
        reg = MetricsRegistry()
        reg.inc("x", 1, b="2", a="1")
        reg.inc("x", 1, a="1", b="2")
        assert reg.snapshot()["counters"]["x|a=1|b=2"] == 2.0

    def test_merge_sums_counters_and_maxes_gauges(self):
        a = MetricsRegistry(buckets=(1.0,))
        b = MetricsRegistry(buckets=(1.0,))
        a.inc("writes", 2); b.inc("writes", 3)
        a.set_gauge("oldest", 0.5); b.set_gauge("oldest", 4.5)
        a.observe("lat", 0.1); b.observe("lat", 2.0)
        m = merge([a.snapshot(), b.snapshot()])
        assert m["counters"]["writes"] == 5.0
        assert m["gauges"]["oldest"] == 4.5   # worst-case wins
        assert m["histograms"]["lat"]["counts"] == [1, 1]
        assert m["histograms"]["lat"]["count"] == 2

    def test_thread_safety_under_contention(self):
        reg = MetricsRegistry()

        def spin():
            for _ in range(500):
                reg.inc("n")
                reg.observe("h", 0.01)

        threads = [threading.Thread(target=spin) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = reg.snapshot()
        assert snap["counters"]["n"] == 2000.0
        assert snap["histograms"]["h"]["count"] == 2000


# ------------------------------------------------------------ no-op fast path
class TestNoOpFastPath:
    def test_unset_env_leaves_null_registry(self, tmp_path):
        env = _env(tmp_path)
        assert env.metrics is False and env.metrics_port == -1
        metrics.maybe_install_from_env(env)
        assert not metrics.enabled()
        metrics.inc("writes")                 # all no-ops, no state
        metrics.set_gauge("g", 1)
        metrics.observe("h", 1.0)
        assert metrics.snapshot()["counters"] == {}

    def test_port_implies_metrics(self):
        env = CraftEnv.capture({"CRAFT_METRICS_PORT": "0"})
        assert env.metrics is True and env.metrics_port == 0

    def test_statsview_is_a_plain_dict_when_off(self):
        sv = StatsView("cp", {"writes": 0, "tier_reads": {}})
        sv.inc("writes")
        sv["writes"] += 1
        sv["tier_reads"]["pfs"] = 3           # nested non-numeric untouched
        assert dict(sv) == {"writes": 2, "tier_reads": {"pfs": 3}}

    def test_statsview_mirrors_when_armed(self):
        reg = metrics.install()
        sv = StatsView("mycp", {"writes": 0, "restore_read_bytes": 0})
        sv.inc("writes")
        sv["writes"] += 2                     # bare += mirrors the delta too
        sv["restore_read_bytes"] = 100
        sv["restore_read_bytes"] = 40         # shrink → gauge semantics
        snap = reg.snapshot()
        assert snap["counters"]["cp_writes|cp=mycp"] == 3.0
        assert snap["gauges"]["cp_restore_read_bytes|cp=mycp"] == 40.0

    def test_checkpoint_stats_dict_back_compat(self, tmp_path):
        arr = np.arange(64, dtype=np.float64)
        cp = _mk(tmp_path, arr)
        assert cp.update_and_write()
        st = dict(cp.stats)                   # copyable, iterable, plain
        assert st["writes"] == 1 and st["restore_tier"] is None
        cp.close()


# -------------------------------------------------------- cross-rank merge
class TestAggregate:
    def test_single_rank_aggregate_is_local(self):
        reg = MetricsRegistry()
        reg.inc("writes", 7)
        m = metrics.aggregate(None, reg.snapshot())
        assert m["counters"]["writes"] == 7.0

    def test_simworld_merge_with_dead_rank(self):
        env = CraftEnv.capture({"CRAFT_COMM_RECOVERY_POLICY": "SHRINKING"})
        world = SimWorld(3, env=env)

        def fn(c):
            reg = MetricsRegistry()
            reg.inc("writes", c.rank + 1)     # ranks contribute 1, 2, 3
            reg.set_gauge("oldest", float(c.rank))
            while True:
                try:
                    if c.rank == 0 and c.epoch == 0:
                        world.kill(2)
                        time.sleep(0.02)
                    c.barrier()
                    return metrics.aggregate(c, reg.snapshot())
                except (ProcFailedError, RevokedError):
                    try:
                        c.revoke()
                    except Exception:
                        pass
                    c = c.recover(policy="SHRINKING")

        out = world.run(fn, timeout=60)
        assert len(out) == 2                  # rank 2 died
        for m in out.values():
            # fleet totals span the survivors only: 1 + 2, max gauge 1.0
            assert m["counters"]["writes"] == 3.0
            assert m["gauges"]["oldest"] == 1.0


# ------------------------------------------------------------- exporter
class TestExporter:
    def test_scrape_round_trip(self, tmp_path):
        arr = np.arange(256, dtype=np.float64)
        cp = _mk(tmp_path, arr, CRAFT_METRICS_PORT=0,
                 CRAFT_TIER_EVERY="pfs:1")
        for it in range(4):
            arr += 1.0
            cp.update_and_write(it)
        cp.wait()
        port = telemetry.port()
        assert port is not None
        status, text = _get(f"http://localhost:{port}/metrics")
        assert status == 200
        parsed = parse_prometheus(text)
        assert parsed["craft_cp_writes_total"]['cp="mx"'] == 4.0
        # histogram exposition: bucket counts are cumulative and end at +Inf
        buckets = [(lab, v) for lab, v in
                   parsed["craft_tier_write_seconds_bucket"].items()]
        assert any('le="+Inf"' in lab for lab, _ in buckets)
        # the parsed scrape must agree with the in-process registry
        snap = metrics.snapshot()
        assert parsed["craft_cp_writes_total"]['cp="mx"'] == \
            snap["counters"]["cp_writes|cp=mx"]
        cp.close()

    def test_render_parse_identity(self):
        reg = MetricsRegistry(buckets=(0.5, 1.0))
        reg.inc("a", 2, slot="pfs")
        reg.set_gauge("b", 1.5)
        reg.observe("c", 0.2)
        text = render_prometheus(reg.snapshot())
        parsed = parse_prometheus(text)
        assert parsed["craft_a_total"]['slot="pfs"'] == 2.0
        assert parsed["craft_b"][""] == 1.5
        assert parsed["craft_c_count"][""] == 1.0
        assert parsed["craft_c_sum"][""] == 0.2

    def test_unknown_path_404(self):
        telemetry.start(0)
        port = telemetry.port()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://localhost:{port}/nope")
        assert ei.value.code == 404

    def test_healthz_degraded_then_healthy_under_chaos(self, tmp_path):
        """The acceptance transition: a PFS outage opens the breaker and
        /healthz flips to 503; clearing the fault re-admits the tier and
        /healthz flips back to 200."""
        arr = np.arange(512, dtype=np.float64)
        cp = _mk(tmp_path, arr, CRAFT_METRICS_PORT=0, CRAFT_CHAOS="on",
                 CRAFT_BREAKER_THRESHOLD=1, CRAFT_BREAKER_COOLDOWN_S=0,
                 CRAFT_IO_RETRIES=0)
        port = telemetry.port()
        arr[...] = 1.0
        assert cp.update_and_write()
        status, body = _get(f"http://localhost:{port}/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["status"] == "ok"
        assert doc["checkpoints"]["mx"]["breakers"]["pfs"]["state"] == \
            "closed"
        assert doc["checkpoints"]["mx"]["version"] == 1
        assert doc["checkpoints"]["mx"]["last_write_age_s"] is not None

        cp.chaos.add("pfs:erofs:p=1")         # persistent outage
        for val in (2.0, 3.0):
            arr[...] = val
            assert cp.update_and_write()      # degrades to the node tier
        assert cp.health["pfs"].state == "open"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://localhost:{port}/healthz")
        assert ei.value.code == 503
        doc = json.loads(ei.value.read().decode("utf-8"))
        assert doc["status"] == "unhealthy"
        assert doc["checkpoints"]["mx"]["breakers"]["pfs"]["state"] == "open"
        assert doc["checkpoints"]["mx"]["degraded_writes"] >= 2

        # scrape agrees with the stats the chaos run accumulated
        _, text = _get(f"http://localhost:{port}/metrics")
        parsed = parse_prometheus(text)
        assert parsed["craft_cp_breaker_trips_total"]['cp="mx"'] == \
            cp.stats["breaker_trips"]
        assert parsed["craft_cp_degraded_writes_total"]['cp="mx"'] == \
            cp.stats["degraded_writes"]

        cp.chaos.clear("pfs")                 # outage ends; re-admission
        arr[...] = 4.0
        assert cp.update_and_write()
        assert cp.health["pfs"].state == "closed"
        status, body = _get(f"http://localhost:{port}/healthz")
        assert status == 200
        assert json.loads(body)["status"] == "ok"
        cp.close()

    def test_breaker_state_gauge(self, tmp_path):
        arr = np.arange(128, dtype=np.float64)
        cp = _mk(tmp_path, arr, CRAFT_METRICS=1, CRAFT_CHAOS="on",
                 CRAFT_BREAKER_THRESHOLD=1, CRAFT_BREAKER_COOLDOWN_S=3600,
                 CRAFT_IO_RETRIES=0)
        cp.chaos.add("pfs:eio:p=1")
        arr[...] = 1.0
        assert cp.update_and_write()
        snap = metrics.snapshot()
        assert snap["gauges"]["breaker_state|slot=pfs"] == 2.0   # open
        assert snap["counters"]["breaker_trips|slot=pfs"] == 1.0
        cp.close()


# ----------------------------------------------------------------- craft top
class TestTop:
    def test_renders_from_trace_file(self, tmp_path):
        from repro_torch import top

        trace_path = tmp_path / "run.jsonl"
        events = [
            {"t": 0.0, "kind": "config"},
            {"t": 0.1, "kind": "decision", "write": False, "reason": None},
            {"t": 0.2, "kind": "decision", "write": True,
             "reason": "cadence"},
            {"t": 0.3, "kind": "tier_write", "slot": "pfs", "version": 1,
             "seconds": 0.02, "nbytes": 4096},
            {"t": 0.35, "kind": "scheduled", "version": 1},
            {"t": 0.4, "kind": "breaker", "slot": "pfs"},
            {"t": 0.5, "kind": "degraded", "slot": "pfs"},
            {"t": 0.6, "kind": "restore", "slot": "node", "version": 1,
             "seconds": 0.01, "read_bytes": 4096},
            {"t": 0.7, "kind": "async_stall", "age_s": 2.5,
             "deadline_s": 1.0},
        ]
        trace_path.write_text(
            "\n".join(json.dumps(e) for e in events) + "\n"
            + '{"torn line'  # a live file's torn tail must not crash top
        )
        m = top.model_from_trace(str(trace_path))
        assert m["tiers"]["pfs"]["writes"] == 1
        assert m["decisions"] == {"skip": 1, "cadence": 1}
        assert m["breakers"]["pfs"] == "open"
        assert m["restores"]["node"] == 1
        assert m["async"]["stalls"] == 1
        out = top.render(m, color=False)
        assert "pfs" in out and "cadence" in out and "4.0 KiB" in out
        assert top.main(["--trace", str(trace_path), "--once",
                         "--no-color"]) == 0

    def test_renders_from_live_endpoint(self, tmp_path):
        from repro_torch import top

        arr = np.arange(128, dtype=np.float64)
        cp = _mk(tmp_path, arr, CRAFT_METRICS_PORT=0,
                 CRAFT_TIER_EVERY="pfs:1")
        for it in range(3):
            arr += 1.0
            cp.update_and_write(it)
        cp.wait()
        url = f"http://localhost:{telemetry.port()}"
        m = top.model_from_url(url)
        assert m["status"] == "ok"
        assert m["tiers"]["pfs"]["writes"] == 3
        out = top.render(m, color=False)
        assert "status: ok" in out and "pfs" in out
        cp.close()


# ----------------------------------------------------- trace close race fix
class TestTraceRace:
    def test_emit_during_uninstall_never_tears(self, tmp_path):
        from repro_torch.core import trace

        path = tmp_path / "race.jsonl"
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                trace.emit("step", seconds=0.001)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(20):                   # install/uninstall churn
            trace.install(str(path))
            time.sleep(0.001)
            trace.uninstall()
        stop.set()
        for t in threads:
            t.join()
        for line in path.read_text().splitlines():
            json.loads(line)                  # every line is whole JSON

    def test_close_is_idempotent(self, tmp_path):
        from repro_torch.core.trace import JsonlTracer

        tr = JsonlTracer(str(tmp_path / "t.jsonl"))
        tr.emit("a")
        tr.close()
        tr.close()                            # second close: no raise
        tr.emit("b")                          # post-close emit: swallowed
        assert len((tmp_path / "t.jsonl").read_text().splitlines()) == 1


# ----------------------------------------------------- async stall watchdog
class TestStallWatchdog:
    def test_oldest_pending_and_warning(self):
        from repro_torch.core.async_writer import AsyncWriter

        reg = metrics.install()
        w = AsyncWriter(workers=1, name="wd")
        gate = threading.Event()
        w.submit(gate.wait, label="slow v-1")
        time.sleep(0.05)
        assert w.oldest_pending_s() >= 0.04
        age = w.check_stall(deadline_s=0.01)
        assert age > 0.01
        assert w.stats["stall_warnings"] == 1
        w.check_stall(deadline_s=0.01)        # same job: warn exactly once
        assert w.stats["stall_warnings"] == 1
        snap = reg.snapshot()
        assert snap["counters"]["async_stall_warnings"] == 1.0
        assert snap["gauges"]["async_oldest_pending_s"] > 0.01
        gate.set()
        w.wait()
        assert w.oldest_pending_s() == 0.0
        w.close()

    def test_drained_lane_reports_zero(self):
        from repro_torch.core.async_writer import AsyncWriter

        w = AsyncWriter(workers=1, name="wd2")
        w.submit(lambda: None)
        w.wait()
        assert w.check_stall(deadline_s=0.001) == 0.0
        assert w.stats["stall_warnings"] == 0
        w.close()


# ------------------------------------------------- the port's timed helper
class TestTimed:
    """``metrics.timed`` exists only in the port (the reference has no such
    helper): the parity path adds its stage seconds through it."""

    def test_adds_block_seconds_when_armed(self):
        reg = metrics.install()
        with metrics.timed("parity_seconds", stage="pad"):
            time.sleep(0.01)
        with pytest.raises(ValueError):
            with metrics.timed("parity_seconds", stage="pad"):
                raise ValueError("the block's error still propagates")
        snap = reg.snapshot()
        assert snap["counters"]["parity_seconds|stage=pad"] >= 0.01

    def test_is_a_no_op_when_off(self):
        assert not metrics.enabled()
        with metrics.timed("parity_seconds", stage="pad"):
            pass
        assert metrics.snapshot()["counters"] == {}

    def test_parity_stages_reach_the_scrape(self):
        """An XOR parity encode shows its stages as
        ``craft_parity_seconds_total{stage=...}``; the reference's encode of
        the same buffers adds no series of that name."""
        from repro.core import metrics as ref_metrics
        from repro.kernels.xor_parity import ops as ref_xor_ops
        from repro_torch.kernels.xor_parity import ops as xor_ops

        bufs = [b"abcd" * 16, b"efgh" * 16]
        metrics.install()
        parity = xor_ops.parity_of_buffers(bufs, device="cpu")
        parsed = parse_prometheus(render_prometheus(metrics.snapshot()))
        stages = parsed["craft_parity_seconds_total"]
        assert {'stage="pad"', 'stage="h2d"', 'stage="kernel"',
                'stage="d2h"'} <= set(stages)
        ref_reg = ref_metrics.install()
        try:
            assert ref_xor_ops.parity_of_buffers(bufs) == parity
            assert not any(k.startswith("parity_seconds")
                           for k in ref_reg.snapshot()["counters"])
        finally:
            ref_metrics.uninstall()
