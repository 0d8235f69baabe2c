"""The benchmark's shape on the CPU: names, files found by name, cells,
traffic mixes and metrics added as files only, the result line's keys, the
counts against hand counts, and what the harness and the reference
import.

    python -m pytest -q bench/tests
"""
from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness, spec  # noqa: E402
from bench.lib.record import Check, Record  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_and_units_are_made_of_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
    for c in bench["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert _one_line(w["why"])
    for c in bench["configs"]:
        assert _one_line(c["why"]) and _one_line(c["source"])
    for m in bench["per_layer"]:
        assert _one_line(m["layer"])
    for word in bench["command"]:
        assert _one_line(word)


def test_the_file_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and p != "benchmarks"
    assert len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    cfgs = {c["name"] for c in bench["configs"]}
    assert 1 <= len(cfgs) <= 24 and len(cfgs) == len(bench["configs"])
    cells = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(cells) <= 24 and len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in bench["workloads"]} == cfgs
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        moved_in = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved_in)) <= moved_in
        layers.setdefault(m["layer"], []).append(m["name"])
    for cname in cells:
        c = spec.cell(cname, bench)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, cname
        assert c.per_layer, cname


def test_every_file_is_found_by_name(bench):
    for what, path in spec.named_files(bench).items():
        assert path.is_file(), (what, path)
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert spec.runner(c.traffic["kind"]).run
        ref = c.config["reference"]
        assert (spec.BENCH / "reference" / f"{ref}.py").is_file()
        assert c.limits


def test_each_reader_names_its_entry(bench):
    for m in bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["source"], m["layer"], m["moves"]), m["name"]


def _tree_hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_added_as_files_only(tmp_path, bench):
    """A later cell, traffic mix and per-layer metric come as new files and
    new entries; no file already there is edited."""
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path / "bench")
    nb = json.loads(json.dumps(bench))
    mix = json.loads((spec.BENCH / "traffic" / "lanczos-solves.json"
                      ).read_text())
    mix["n_iter"] = 400
    (tmp_path / "bench" / "traffic" / "lanczos-solves-400.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "limits" / "graphene-8192.lanczos-400.json"
     ).write_text(json.dumps({"alpha_gap_half": 1, "beta_gap_half": 1,
                              "ritz_gap": 1}))
    (tmp_path / "bench" / "metrics" / "solves_in_window.py").write_text(
        'UNIT = "solves"\nSOURCE = "host_clock"\nLAYER = "driver"\n'
        'MOVES = "lanczos_iters_per_s"\n\n\ndef read(rec):\n'
        '    return rec.counts.get("solves")\n')
    nb["workloads"].append({
        "name": "graphene-8192.lanczos-400", "config": "graphene-8192-w0.3",
        "traffic": "lanczos-solves-400", "chips": 1, "why": "longer solves"})
    for m in nb["end_to_end"]:
        if m["name"] == "lanczos_iters_per_s":
            m["workloads"].append("graphene-8192.lanczos-400")
    nb["per_layer"].append({
        "name": "solves_in_window", "unit": "solves", "better": "higher",
        "source": "host_clock", "layer": "driver",
        "moves": "lanczos_iters_per_s",
        "workloads": ["graphene-8192.lanczos-400"]})
    c = spec.cell("graphene-8192.lanczos-400", nb,
                  bench_dir=tmp_path / "bench")
    assert c.traffic["n_iter"] == 400 and c.config["name"] == \
        "graphene-8192-w0.3"
    assert "solves_in_window" in {m["name"] for m in c.per_layer}
    sys.path.insert(0, str(tmp_path))
    saved = {k: v for k, v in sys.modules.items()
             if k == "bench" or k.startswith("bench.")}
    for k in saved:
        del sys.modules[k]
    try:
        from bench.lib import harness as h2

        rec = Record(window_s=10.0, counts={"solves": 3})
        got = h2.per_layer(c, rec)
        assert got["solves_in_window"] == {"value": 3.0, "unit": "solves"}
    finally:
        sys.path.remove(str(tmp_path))
        for k in [k for k in sys.modules
                  if k == "bench" or k.startswith("bench.")]:
            del sys.modules[k]
        sys.modules.update(saved)
    after = _tree_hashes(tmp_path / "bench")
    assert all(after[k] == v for k, v in before.items())


def test_the_last_line_has_the_contract_keys(bench):
    c = spec.cell("graphene-8192.lanczos", bench)
    rec = Record(setup_s=12.5, window_s=10.2, memory_peak_bytes=123,
                 e2e={"lanczos_iters_per_s": 88.0},
                 checks=[Check("ritz_gap", 1e-8, 4e-6)], attempted=5)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = harness.result(c, rec, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"lanczos_iters_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True
    rec.busy_s, rec.trace_window_s = 9.0, 10.0
    rec.breakdown = {"device_ops": [["k", 1.0]], "idle_gaps": [["s", 0.1]]}
    rec.counts.update(iters=900, iter_bytes=2.15e9, device_s=9.0)
    line = harness.result(c, rec, True, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["metrics"]["device_idle.lanczos"]["value"] == \
        pytest.approx(10.0)
    assert line["metrics"]["lanczos_hbm_roofline"]["value"] == \
        pytest.approx(100.0 * 900 * 2.15e9 / 3.35e12 / 9.0)
    json.dumps(line)
    rec.checks.append(Check("beta_gap_half", float("nan"), 1.0))
    assert harness.result(c, rec, False, dev)["correct"] is False


def test_counts_match_hand_counts():
    from bench.counts import lanczos as lc
    from bench.reference import lanczos as ref

    lat = {"nx": 4, "ny": 3, "t": 1.0, "disorder": 0.3}
    assert lc.sites(lat) == 24
    # read: the current and the previous vector and the on-site term;
    # written: the new vector; 4 bytes a site each
    assert lc.iteration_bytes(lat) == 4 * 4 * 24
    eps, v0 = ref.problem(7, lat, "cpu")
    assert lc.version_bytes(lat) == 2 * v0.numel() * v0.element_size()
    assert eps.numel() == v0.numel() == lc.sites(lat)
    # the cells' lattice: two 8192 x 8192 x 2 float32 vectors, 1.07 GB
    assert lc.version_bytes({"nx": 8192, "ny": 8192}) == 2 * 4 * 2 ** 27


def test_foreign_modules_compare_whole_names():
    assert harness.foreign_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "reproduce"]) == []
    assert harness.foreign_modules(["repro.core", "jax.numpy", "flax",
                                    "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                   "repro"]


_PROBE = r"""
import sys
sys.path[:0] = [{root!r}, {src!r}]
import bench.reference.lanczos
ref_mods = sorted({{m.split(".")[0] for m in sys.modules}})
import bench.lib.harness, bench.lib.spec, bench.lib.paths, bench.lib.host
from bench.lib import spec
for w in spec.benchmark()["workloads"]:
    c = spec.cell(w["name"])
    spec.runner(c.traffic["kind"])
    for m in c.per_layer:
        spec.reader(m["name"])
import repro_torch.apps.lanczos
import repro_torch.core.mem_level, repro_torch.core.comm
print(" ".join(ref_mods))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_neither_harness_nor_reference_imports_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                             src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"}).stdout.splitlines()
    ref_mods, all_mods = set(out[-2].split()), set(out[-1].split())
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    assert not ref_mods & (forbidden | {"repro_torch"})
    assert not all_mods & forbidden
    assert "repro_torch" in all_mods


def test_run_exits_without_a_result_where_the_program_is_missing(tmp_path):
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "graphene-8192.lanczos", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_exits_without_a_result_where_there_is_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "graphene-8192.lanczos", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_bounds_fit_the_check_budget(bench):
    rs = bench["run_seconds"]
    total = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert math.isfinite(total)
