"""The port's dry-run (``repro_torch.launch.{specs,dryrun}``) on the CPU.

- ``TestTinyDryRun`` (marked ``slow``, as the reference's): a TINY cell
  (zamba2, danube, and deepseek-v3 with 8-bit moments too) on a (4, 2)
  fake mesh (a fake process group of 8 ranks, in a subprocess:
  none starts in the pytest process), kinds train, prefill and decode,
  through the stand-ins, the trace and the roofline: FLOPs > 0, HBM bytes
  > 0, the step's arguments and temporaries > 0 bytes a device; and the
  command line on a TINY 16×16 cell.
- The traced FLOPs of the mesh-free TINY train step equal the reference's
  ``analyze`` of the same step compiled on one device within 10%: the
  models' products are the same, but the backwards of the scans and of
  attention are written differently (the port's plain backward against
  the VJP XLA derives for the reference's jnp code), so their products
  differ (measured +1.7% danube, +7.9% zamba2, +3.1% falcon-mamba).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.analysis import roofline as R
from repro_torch.configs import get_config
from repro_torch.optim import adamw as A
from repro_torch.train import steps as S

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.path.insert(0, "src")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_step
from repro_torch.analysis import roofline as R

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
for kind, name in (("train", "tiny_train"), ("prefill", "tiny_prefill"),
                   ("decode", "tiny_decode")):
    # batch 8: the train profile splits it over both mesh dims
    shape = ShapeSpec(name, seq_len=64, global_batch=8, kind=kind)
    built = build_step("{arch}", shape, mesh, tiny=True)
    lowered = built.lower(mesh)
    rep = R.analyze(lowered.counter)
    assert rep.flops > 0, (kind, rep.as_dict())
    assert rep.hbm_bytes > 0, (kind, rep.as_dict())
    assert lowered.arg_bytes > 0 and lowered.counter.peak_bytes > 0, kind
    assert rep.collective_bytes > 0, (kind, rep.as_dict())
if {bits8}:
    # 8-bit moments ({{"q", "scale"}} leaves) on the mesh: the policy the
    # full-size > 100 B configs take, which a TINY config never reaches
    from repro_torch.launch.specs import arch_config, build_train
    from repro_torch.optim.adamw import OptimConfig
    shape = ShapeSpec("tiny_train", seq_len=64, global_batch=8, kind="train")
    built = build_train(arch_config("{arch}", mesh, tiny=True), shape, mesh,
                        ocfg=OptimConfig(state_bits=8, master_fp32=False))
    rep = R.analyze(built.lower(mesh).counter)
    assert rep.flops > 0 and rep.collective_bytes > 0, rep.as_dict()
print("OK")
"""


def _run(script_text, tmp_path, name="probe.py", timeout=560):
    script = tmp_path / name
    script.write_text(script_text)
    return subprocess.run([sys.executable, str(script)], cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.slow
class TestTinyDryRun:
    """A reduced-config dry-run on an 8-rank fake mesh: the specs, the
    trace and the roofline, end to end."""

    # deepseek-v3: MLA, the MoE's expert-parallel path and the MTP head on
    # the tp2d profile, and AdamW's 8-bit moments on the mesh
    @pytest.mark.parametrize("arch", ["zamba2-2.7b", "h2o-danube-1.8b",
                                      "deepseek-v3-671b"])
    def test_tiny_cell_traces(self, tmp_path, arch):
        r = _run(_PROBE.format(arch=arch, bits8=arch.startswith("deepseek")),
                 tmp_path)
        assert "OK" in r.stdout, (r.stdout[-800:], r.stderr[-2500:])

    def test_command_line_writes_the_record(self, tmp_path):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "h2o-danube-1.8b", "--shape", "decode_32k", "--tiny",
             "--json-dir", str(tmp_path)],
            cwd=str(REPO), capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": "src"})
        assert r.returncode == 0, r.stderr[-2500:]
        assert "fits 80 GB" in r.stdout and "compute term" in r.stdout
        rec = json.loads((tmp_path / "16x16" /
                          "h2o-danube-1.8b__decode_32k.json").read_text())
        assert rec["n_chips"] == 256 and rec["kind"] == "decode"
        assert rec["memory"]["fits_80GB"]
        assert rec["roofline"]["flops"] > 0


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-2.7b",
                                  "falcon-mamba-7b"])
def test_traced_train_flops_match_reference(arch):
    import jax
    import jax.numpy as jnp

    from repro.analysis import roofline as RR
    from repro.configs import get_config as ref_config
    from repro.models import model as RM
    from repro.optim import adamw as RA
    from repro.train import steps as RS

    rcfg, cfg = ref_config(arch, tiny=True), get_config(arch, tiny=True)
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 64),
                                               dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    rstep = RS.make_train_step(rcfg, RA.OptimConfig(master_fp32=False),
                               RS.TrainStepConfig(loss_chunk=32))
    text = jax.jit(rstep).lower(
        rparams, RA.adamw_init(rparams, RA.OptimConfig(master_fp32=False)),
        {k: jnp.asarray(v) for k, v in batch.items()}).compile().as_text()
    want = RR.analyze(text).flops
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, "cpu")
    ocfg = A.OptimConfig(master_fp32=False)
    step = S.make_train_step(cfg, ocfg, S.TrainStepConfig(loss_chunk=32))
    _, counter = R.trace(step, params, A.adamw_init(params, ocfg), batch)
    assert 1.0 <= counter.flops / want <= 1.10, (counter.flops, want)
    assert torch.isfinite(params["final_ln"]).all()
