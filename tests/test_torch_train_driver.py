"""The port's training driver (``repro_torch.launch.train``) on the CPU.

It mirrors ``tests/test_drivers.py::TestTrainDriver`` on ``device="cpu"``
with TINY h2o-danube-1.8b: the loss goes down with two checkpoint writes;
an interrupted and resumed run equals the uninterrupted one bit for bit
(losses, parameters and optimizer state); an AFT zone on the simulated
communicator recovers an injected rank failure and ends on every rank.
The reference's own driver fails on this tree under a mesh
(``repro/models/layers.py:56``), so the port is held to these invariants
and to the file format: a train checkpoint (parameters, 32-bit or 8-bit
AdamW state, step, data cursor) written by either package restores bit
for bit in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as ref_config
from repro.core import Box as RefBox
from repro.core import Checkpoint as RefCheckpoint
from repro.core.env import CraftEnv as RefEnv
from repro.data.pipeline import DataCursor as RefCursor
from repro.launch import train as ref_train
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import Box, Checkpoint, CraftEnv
from repro_torch.core.comm_sim import SimWorld
from repro_torch.data.pipeline import DataCursor
from repro_torch.launch import train
from repro_torch.optim import adamw as A

ARCH = "h2o-danube-1.8b"


def _env(root, **extra):
    return CraftEnv.capture({"CRAFT_CP_PATH": str(root),
                             "CRAFT_USE_SCR": "0", **extra})


def _tc(**kw):
    return train.TrainConfig(arch=ARCH, device="cpu", global_batch=4,
                             seq_len=32, **kw)


def _flat(tree):
    return {pytree.keystr(k): v
            for k, v in pytree.tree_flatten_with_path(tree)[0]}


def test_loss_goes_down(tmp_path):
    out = train.run(_tc(steps=16, cp_freq=8), env=_env(tmp_path / "pfs"))
    assert out["final_step"] == 16 and out["start_step"] == 0
    first, last = np.mean(out["losses"][:4]), np.mean(out["losses"][-4:])
    assert np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()
    assert last < first
    assert out["stats"]["writes"] == 2
    assert [s for s, _ in out["cp_writes"]] == [8, 16]


@pytest.mark.parametrize("arch", ["musicgen-medium", "llava-next-34b"])
def test_frontend_models_train_on_tokens(arch, tmp_path):
    """The reference's ``launch.train`` feeds the audio and vlm models no
    embeds: they train on tokens alone, as here, where the loss goes
    down."""
    tc = train.TrainConfig(arch=arch, device="cpu", global_batch=4,
                           seq_len=32, steps=12, cp_freq=6, lr=1e-3)
    out = train.run(tc, env=_env(tmp_path / "pfs"))
    assert out["final_step"] == 12 and np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    assert [s for s, _ in out["cp_writes"]] == [6, 12]


def test_restart_resumes_and_matches(tmp_path):
    """Interrupted at step 12 (after the version of step 10) and resumed:
    the resumed run restarts at 10 and ends bit for bit where the
    uninterrupted run did."""
    kw = dict(steps=20, cp_freq=5)
    ref = train.run(_tc(**kw), env=_env(tmp_path / "ref"))
    env = _env(tmp_path / "pfs")

    def boom(step, metrics):
        if step == 12:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        train.run(_tc(**kw), env=env, on_step=boom)
    resumed = train.run(_tc(**kw), env=env)
    assert resumed["start_step"] == 10 and resumed["final_step"] == 20
    assert resumed["losses"] == ref["losses"][10:]
    assert resumed["grad_norms"] == ref["grad_norms"][10:]
    got, want = _flat(resumed["state"]), _flat(ref["state"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_aft_zone_with_sim_comm(tmp_path):
    """An injected rank failure at step 5: the AFT zone recovers and every
    rank ends at step 10."""
    env = _env(tmp_path / "pfs", CRAFT_COMM_RECOVERY_POLICY="NON-SHRINKING")
    world = SimWorld(2, spare_nodes=1, env=env)
    tc = _tc(steps=10, cp_freq=2, fail_at_step=5)
    results = world.run(lambda comm: train.run(tc, comm=comm, env=env),
                        timeout=500)
    assert [r["final_step"] for r in results.values()] == [10, 10]


def test_sequence_parallel_waits_for_the_sharding_slice(tmp_path):
    """``sequence_parallel`` runs (it waited for the sharding layer, which
    is here now).  Without a mesh it changes nothing, as in the reference,
    whose one-device mesh has no ``model`` axis: the run equals the one
    without it bit for bit (the mesh runs with it on are
    ``tests/test_torch_mesh_train.py``)."""
    sp = train.run(_tc(steps=2, cp_freq=10, sequence_parallel=True),
                   env=_env(tmp_path / "sp"))
    plain = train.run(_tc(steps=2, cp_freq=10), env=_env(tmp_path / "plain"))
    assert sp["losses"] == plain["losses"] and sp["final_step"] == 2
    got, want = _flat(sp["state"]), _flat(plain["state"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------ train checkpoints across packages
def _ref_tree(bits: int, seed: int):
    """The reference's (params, AdamW state) after two updates with
    random gradients, so every moment (and int8 block) is non-zero."""
    cfg = ref_config(ARCH, tiny=True)
    ocfg = RA.OptimConfig(state_bits=bits, master_fp32=False, lr=1e-2,
                          warmup_steps=1)
    params = RM.init_params(jax.random.PRNGKey(seed), cfg)
    state = RA.adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            params)
        params, state, _ = RA.adamw_update(grads, state, params, ocfg)
    return params, state


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_template(bits: int):
    cfg = ref_config(ARCH, tiny=True)
    params = jax.tree_util.tree_map(
        jnp.zeros_like, RM.init_params(jax.random.PRNGKey(0), cfg))
    return params, RA.adamw_init(params, RA.OptimConfig(
        state_bits=bits, master_fp32=False))


def _port_template(bits: int):
    cfg = get_config(ARCH, tiny=True)
    params = convert.params_from_numpy(
        _np_tree(_ref_template(bits)[0]), cfg, "cpu")
    return params, A.adamw_init(params, A.OptimConfig(
        state_bits=bits, master_fp32=False))


def _port_cp(root, params, opt, step, cursor):
    cp = Checkpoint("train", env=_env(root), device="cpu")
    cp.add("state", Box({"params": params, "opt": opt}))
    step_box = Box(step)
    cp.add("step", step_box)
    cp.add("cursor", train.FuncBox(cursor))
    cp.commit()
    return cp, step_box


def _ref_cp(root, params, opt, step, cursor):
    env = RefEnv.capture({"CRAFT_CP_PATH": str(root), "CRAFT_USE_SCR": "0"})
    cp = RefCheckpoint("train", env=env)
    box = RefBox({"params": params, "opt": opt})
    cp.add("state", box)
    step_box = RefBox(step)
    cp.add("step", step_box)
    cp.add("cursor", ref_train.FuncBox(cursor))
    cp.commit()
    return cp, box, step_box


def _assert_same(port_tree, ref_tree):
    got = _flat(port_tree)
    want = {"".join(f"[{k.key!r}]" for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if g.dtype == torch.bfloat16:
            g = g.view(torch.uint16).numpy()
            w = w.view(np.uint16)
        else:
            g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_train_checkpoint_restores_in_the_reference(bits, tmp_path):
    r_params, r_state = _ref_tree(bits, 1)
    cfg = get_config(ARCH, tiny=True)
    params = convert.params_from_numpy(_np_tree(r_params), cfg, "cpu")
    opt = convert.opt_state_from_numpy(_np_tree(r_state), cfg, "cpu")
    cp, _ = _port_cp(tmp_path, params, opt, 7, DataCursor(7))
    cp.update_and_write(7)
    cp.wait()
    cp.close()
    t_params, t_opt = _ref_template(bits)
    cursor = RefCursor(0)
    ref, box, step_box = _ref_cp(tmp_path, t_params, t_opt, 0, cursor)
    assert ref.restart_if_needed()
    ref.close()
    assert step_box.value == 7 and cursor.step == 7
    _assert_same({"params": params, "opt": opt}, box.value)


@pytest.mark.parametrize("bits", [32, 8])
def test_reference_train_checkpoint_restores_in_the_port(bits, tmp_path):
    r_params, r_state = _ref_tree(bits, 2)
    ref, _, _ = _ref_cp(tmp_path, r_params, r_state, 9, RefCursor(9))
    ref.update_and_write(9)
    ref.wait()
    ref.close()
    params, opt = _port_template(bits)
    cursor = DataCursor(0)
    cp, step_box = _port_cp(tmp_path, params, opt, 0, cursor)
    assert cp.restart_if_needed()
    cp.close()
    assert step_box.value == 9 and cursor.step == 9
    restored = cp._map["state"].box.value
    _assert_same(restored, {"params": r_params, "opt": r_state})


def test_opt_state_from_numpy_checks_the_layout():
    r_params, r_state = _ref_tree(8, 3)
    cfg = get_config(ARCH, tiny=True)
    np_state = _np_tree(r_state)
    opt = convert.opt_state_from_numpy(np_state, cfg, "cpu")
    assert opt["count"].device.type == "cpu" and int(opt["count"]) == 2
    np_state["m"]["final_ln"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_ln"):
        convert.opt_state_from_numpy(np_state, cfg, "cpu")


def test_train_command_line(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CRAFT_CP_PATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--steps", "4", "--cp-freq", "2", "--global-batch", "2",
         "--seq-len", "16"], capture_output=True, text=True, env=env,
        timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "done: 4 steps" in out.stdout
