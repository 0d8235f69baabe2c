"""The zamba2 restore cell on the CPU at a small size (the published
widths cut to a test's, the layers and the layer pattern kept), the chip's
look skipped: a sound run is ``correct``, and each of these faults of the
program comes out not correct: the adapter left out of the MLP, the gated
norm taken over the whole width instead of each group, the shared block
fed x instead of concat(x, embeddings), a restore that reads nothing, and
a restore that brings back the weights but leaves AdamW's state as built.
Then the state's digest, a traced run's restore readers, and the
version's bytes against the state the program builds.  Run serially:

    python -m pytest -q bench/tests/test_bench_zamba2.py
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness, paths, spec  # noqa: E402
from bench.lib.record import Ctx  # noqa: E402

CELL = "zamba2-7b-d12.resume-mem"

#: the published widths cut to a test's (every other key as the cell's)
SMALL = dict(hidden_size=64, vocab_size=512, num_attention_heads=4,
             num_key_value_heads=4, num_query_groups=4,
             attention_head_dim=32, attention_hidden_size=128,
             kv_channels=16, intermediate_size=128, ffn_hidden_size=128,
             mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8,
             chunk_size=16, adapter_rank=8)


def small() -> spec.Cell:
    c = copy.deepcopy(spec.cell(CELL))
    c.config.update(SMALL)
    # 512 positions: the loss's bfloat16 rounding averages out to well
    # under its limit (at 48 positions one seed read 1.4e-3)
    c.traffic.update(global_batch=2, seq_len=256, check_positions=16)
    return c


def drive(seed: int = 2 ** 31 + 11, seconds: float = 1.0,
          trace: bool = False):
    c = small()
    rec = harness.execute(Ctx(cell=c, seed=seed, seconds=seconds,
                              trace=trace, device="cpu",
                              workdir=str(paths.workdir("zamba2-faults")),
                              t0=time.perf_counter()))
    return harness.result(c, rec, trace, {"platform": "cpu"})


# ---------------------------------------------------------------- faults
def _no_adapter(monkeypatch):
    from repro_torch.models import blocks

    orig = blocks.mlp_apply

    def mlp(params, x, act="silu", adapter=None):
        return orig(params, x, act)

    monkeypatch.setattr(blocks, "mlp_apply", mlp)


def _whole_width_norm(monkeypatch):
    from repro_torch.models import ssm

    orig = ssm.gated_norm

    def norm(y, z, w, groups, eps):
        return orig(y, z, w, 1, eps)

    monkeypatch.setattr(ssm, "gated_norm", norm)


def _shared_block_fed_x(monkeypatch):
    from repro_torch.models import blocks

    orig = blocks.shared_apply

    def shared(params, app, x, emb, cfg, positions):
        return orig(params, app, x, x, cfg, positions)

    monkeypatch.setattr(blocks, "shared_apply", shared)


def _restore_reads_nothing(monkeypatch):
    from repro_torch.core.checkpoint import Checkpoint

    monkeypatch.setattr(Checkpoint, "_read_version",
                        lambda self, version: None)


def _opt_left_as_built(monkeypatch):
    """The weights come back; AdamW's moments and count keep the values
    the state was built with (the step's loss and gradient norm, taken
    before the update, do not see it)."""
    import torch.utils._pytree as pytree

    from repro_torch.core.checkpoint import Checkpoint

    orig_add, orig_restart = Checkpoint.add, Checkpoint.restart_if_needed

    def add(self, key, obj, **kw):
        if key == "state":
            self._fault_state = obj
        return orig_add(self, key, obj, **kw)

    def restart(self, *a, **kw):
        box = self._fault_state
        built = pytree.tree_map(lambda x: x.clone(), box.value["opt"])
        ok = orig_restart(self, *a, **kw)
        box.value = {"params": box.value["params"], "opt": built}
        return ok

    monkeypatch.setattr(Checkpoint, "add", add)
    monkeypatch.setattr(Checkpoint, "restart_if_needed", restart)


FAULTS = [_no_adapter, _whole_width_norm, _shared_block_fed_x,
          _restore_reads_nothing, _opt_left_as_built]


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 7])
def test_a_sound_run_is_correct(seed):
    line = drive(seed)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_run_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = drive()
    assert line["correct"] is False, line["checks"]


def test_the_digest_tells_states_apart():
    """Equal bits give equal digests; one word changed, or two swapped,
    do not."""
    import torch

    from bench.runners.train_resume import digest

    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(3, 5, generator=gen).bfloat16(),
             "m": torch.randn(70, generator=gen),
             "count": torch.tensor(3, dtype=torch.int32)}
    want = digest(state)
    assert len(want) == 3
    assert digest({k: state[k].clone() for k in reversed(state)}) == want
    flipped = state["m"].clone()
    flipped.view(torch.int32)[17] ^= 1
    assert digest({**state, "m": flipped}) != want
    swapped = state["m"].clone()
    swapped[[2, 40]] = swapped[[40, 2]]
    assert digest({**state, "m": swapped}) != want
    assert digest({**state, "count": torch.tensor(
        0, dtype=torch.int32)}) != want


def test_a_traced_run_reports_the_restore_readers_of_its_window():
    """The checkpoint path's readers listed on the cell find the window's
    restores: the check's own restore runs before the window, so the
    window's are the last ones."""
    from bench.lib import spans as sp
    from repro_torch.core import metrics as craft_metrics

    try:
        line = drive(trace=True)
        spans = sp.program()
    finally:
        craft_metrics.uninstall()
    assert line["correct"] is True, line["checks"]
    for m in ("restore_tier_s", "add_d2h_s.resume", "restore_h2d_s.resume",
              "restore_host_s.resume", "restore_host_ms_per_leaf.zamba2"):
        assert line["metrics"][m]["value"] > 0, m
    restarts = [s for s in spans if s["name"] == "craft::cp.restart"]
    assert restarts[-1]["fields"]["restored"]
    assert sum(s["fields"].get("restored", False) for s in restarts) \
        == line["attempted"] + 2           # the warm cycle, the check's


def test_the_version_bytes_are_the_states():
    """``counts.zamba2.version_bytes`` against the bytes of the state the
    training loop builds (bf16 weights, float32 per-head scalars and
    AdamW moments)."""
    import torch.utils._pytree as pytree

    from bench.counts import zamba2 as counts
    from bench.runners.train_resume import model_config
    from repro_torch.launch.train import init_state, optim_config
    from repro_torch.launch.train import TrainConfig

    c = small()
    cfg = model_config(c)
    params, opt = init_state(cfg, optim_config(TrainConfig()), 0, "cpu")
    nbytes = sum(x.numel() * x.element_size()
                 for x in pytree.tree_leaves((params, opt["m"], opt["v"])))
    assert counts.version_bytes(c.config) == nbytes
    # the cell's own: 17.6 GB
    full = spec.cell(CELL).config
    assert 17.5e9 < counts.version_bytes(full) < 17.7e9
    assert counts.version_bytes(full) == \
        10 * 1_757_853_120 + 2 * 12 * 3 * 112


def test_the_config_file_keeps_the_published_numbers():
    """Every key of the released config is in the cell's file with its
    published value, but those the entry's ``reduced`` names."""
    from repro_torch.configs import zamba2_7b

    bench = spec.benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == "zamba2-7b-d12"]
    c = spec.cell(CELL)
    for k, v in zamba2_7b.PUBLISHED.items():
        if k not in entry["reduced"]:
            assert c.config[k] == v, k
    assert c.config["num_hidden_layers"] == 12
    assert c.config["hybrid_layer_ids"] == [6, 11]
    assert [i for i, t in enumerate(c.config["layers_block_type"])
            if t == "hybrid"] == [6, 11]
    cfg = zamba2_7b.from_hf_config(c.config, arch_id="zamba2-7b-d12")
    assert cfg == zamba2_7b.CONFIG.replace(
        arch_id="zamba2-7b-d12", n_layers=12, hybrid_layer_ids=(6, 11))
