"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration, traffic mix and limits files, its runner and the
readers of its per-layer metrics.  Nothing here names a cell: a cell added
as files and entries is taken up as it is."""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<mix>.json
    limits: dict            # limits/<cell>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell in ws


def cell(name: str, bench: Optional[dict] = None,
         bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json``), with
    every file it names read."""
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{', '.join(sorted(by_name))}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], traffic_name=w["traffic"],
        config=load_json(bench_dir.parent / cfg_entry["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer)


def runner(kind: str):
    """``runners/<kind>.py``: the module that drives a traffic mix of this
    kind (its ``run(ctx)``)."""
    return importlib.import_module(f"bench.runners.{kind}")


def reader(metric: str):
    """``metrics/<metric>.py``: the reader of one per-layer metric (dots in
    the name become underscores in the module's name)."""
    return importlib.import_module(
        f"bench.metrics.{metric.replace('.', '_').replace('-', '_')}")


def named_files(bench: dict, bench_dir: Path = BENCH) -> Dict[str, Path]:
    """Every file the entries of ``bench`` name, by what names it."""
    out: Dict[str, Path] = {}
    for c in bench["configs"]:
        out[f"config {c['name']}"] = bench_dir.parent / c["file"]
    for w in bench["workloads"]:
        out[f"traffic {w['traffic']}"] = \
            bench_dir / "traffic" / f"{w['traffic']}.json"
        out[f"limits {w['name']}"] = bench_dir / "limits" / f"{w['name']}.json"
    for m in bench["per_layer"]:
        mod = m["name"].replace(".", "_").replace("-", "_")
        out[f"metric {m['name']}"] = bench_dir / "metrics" / f"{mod}.py"
    return out
