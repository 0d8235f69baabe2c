"""The port's training on a mesh: TINY h2o-danube-1.8b (dense) and
zamba2-2.7b (hybrid) sharded over 4 gloo worker processes on a (2, 2)
("data", "model") mesh, with ``sequence_parallel`` off and on (and
falcon-mamba-7b, mamba1, with it off; deepseek-v3-671b, MLA and the MoE,
with it off and on), against the
reference's mesh-free step and the port's own mesh-free path, on the CPU.

- The loss and the gradients of one batch (float32 weights, the
  reference's ``init_params``): within ``tests/test_torch_train.py``'s
  tolerances of ``jax.value_and_grad(repro.train.steps._loss_fn)`` (1e-5
  on the loss, 1e-4 of each gradient leaf's largest magnitude: the same
  sums taken in another order, here split over ranks), and of the port's
  own mesh-free step.
- One ``make_train_step`` step on the mesh (AdamW on each rank's shards,
  the global norm's partial sums all-reduced) against the reference's
  step, with ``test_torch_train.py``'s criteria.
- The driver on the mesh (``launch.train.run(mesh=...)``, sequence
  parallel, bf16): a run cut after 2 steps and resumed from its DTensor
  checkpoint ends bit for bit where the uninterrupted 4-step run does.

The reference's own mesh path raises ``DuplicateSpecError``
(``repro/models/layers.py:56``); the port's does not.  Worker processes
(``runtime.Cluster``) start the process group: none starts in the pytest
process.  The worker functions are module level and this module imports
no JAX at its top.
"""
import functools

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.optim import adamw as A
from repro_torch.train import steps as S

pytestmark = pytest.mark.slow

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b"]
# falcon-mamba-7b (mamba1) too: its B and C are whole where the channels
# are split, so their gradients come back partial over "model"
CASES = [(a, sp) for a in ARCHS for sp in (False, True)] + [
    ("falcon-mamba-7b", False)] + [
    # deepseek-v3 (MLA, the expert-parallel MoE on the tp2d rules, MTP)
    ("deepseek-v3-671b", sp) for sp in (False, True)]
KW = dict(lr=1e-3, warmup_steps=1, total_steps=10, master_fp32=False)


def _paths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in pytree.tree_flatten_with_path(tree)[0]}


def _whole(t):
    """A DTensor's (or tensor's) whole value as float32 numpy."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _mesh(comm, port):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=comm.rank, world_size=comm.size)
    return make_mesh((2, 2), ("data", "model"), device_type="cpu")


def _step_worker(comm, port, cases):
    """Each case (arch, sp, numpy params, batch): the loss and gradients
    of the batch on the mesh, then one train step; host values back."""
    import torch.distributed as dist

    from repro_torch.launch.train import _mesh_rules, shard_batch, shard_tree
    from repro_torch.models import model as M
    from repro_torch.sharding.activations import mesh_context

    mesh = _mesh(comm, port)
    try:
        out = {}
        for arch, sp, np_params, batch in cases:
            cfg = get_config(arch, tiny=True).replace(param_dtype="float32")
            rules = _mesh_rules(mesh, sp)
            params = shard_tree(
                convert.params_from_numpy(np_params, cfg, "cpu"),
                M.param_logical(cfg), rules)
            dbatch = shard_batch(batch, rules, "cpu")
            leaves, spec = pytree.tree_flatten(params)
            alias = [p.detach().requires_grad_() for p in leaves]
            with mesh_context(rules):
                total, parts = S._loss_fn(
                    pytree.tree_unflatten(alias, spec), cfg,
                    S.TrainStepConfig(loss_chunk=16), dbatch)
                total = S._whole(total)
                grads = torch.autograd.grad(total, alias)
                ocfg = A.OptimConfig(**KW)
                step = S.make_train_step(cfg, ocfg,
                                         S.TrainStepConfig(loss_chunk=16))
                p1, o1, m1 = step(params, A.adamw_init(params, ocfg), dbatch)
            out[(arch, sp)] = {
                "total": float(_whole(total)),
                "loss": float(_whole(parts["loss"])),
                "grads": {k: _whole(v) for k, v in _paths(
                    pytree.tree_unflatten(list(grads), spec)).items()},
                "grad_placements": sorted({str(tuple(g.placements))
                                           for g in grads}),
                "metrics": {k: float(_whole(torch.as_tensor(v)))
                            for k, v in m1.items()},
                "params": {k: _whole(v) for k, v in _paths(p1).items()},
                "opt": {k: _whole(v) for k, v in _paths(o1).items()},
            }
        return out
    finally:
        dist.destroy_process_group()


def _driver_worker(comm, port, base):
    """The driver on the mesh: cut at 2 and resumed to 4, and
    uninterrupted to 4; the final parameters and losses of both."""
    import torch.distributed as dist

    from repro_torch.core.env import CraftEnv
    from repro_torch.launch import train

    mesh = _mesh(comm, port)
    try:
        def run(name, steps):
            env = CraftEnv.capture({"CRAFT_CP_PATH": f"{base}/{name}",
                                    "CRAFT_USE_SCR": "0"})
            tc = train.TrainConfig(arch="h2o-danube-1.8b", steps=steps,
                                   global_batch=4, seq_len=32, cp_freq=2,
                                   device="cpu", sequence_parallel=True)
            return train.run(tc, comm=comm, mesh=mesh, env=env)

        cut = run("cut", 2)
        resumed = run("cut", 4)
        whole = run("whole", 4)
        return {
            "cut": cut["losses"], "start": resumed["start_step"],
            "resumed": resumed["losses"], "whole": whole["losses"],
            "resumed_state": {k: _whole(v) for k, v in
                              _paths(resumed["state"]).items()},
            "whole_state": {k: _whole(v) for k, v in
                            _paths(whole["state"]).items()},
            "placements": sorted({str(tuple(v.placements)) for v in
                                  pytree.tree_leaves(whole["state"]["params"])}),
        }
    finally:
        dist.destroy_process_group()


def _cluster(fn, *args):
    from repro_torch.examples.elastic_restore import free_port
    from repro_torch.runtime import Cluster

    with Cluster(n_procs=4, env_overrides={"OMP_NUM_THREADS": "1"}) as c:
        c.start(fn, free_port(), *args)
        res = c.join(timeout=500)
    return [res[r] for r in sorted(res)]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import model as RM
    from repro.train import steps as RS

    rcfg = ref_config(arch, tiny=True).replace(param_dtype="float32")
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    tokens = np.random.default_rng(4).integers(0, rcfg.vocab, (4, 40),
                                               dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -3:] = RS.IGNORE
    return rcfg, np_params, {"tokens": tokens, "labels": labels}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's mesh-free loss, gradients and one train step."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as RA
    from repro.train import steps as RS

    rcfg, np_params, batch = _setup(arch)
    rparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, parts), grads = jax.value_and_grad(RS._loss_fn, has_aux=True)(
        rparams, rcfg, RS.TrainStepConfig(loss_chunk=16), jbatch)
    step = RS.make_train_step(rcfg, RA.OptimConfig(**KW),
                              RS.TrainStepConfig(loss_chunk=16))
    rp, ro, rm = jax.jit(step)(rparams,
                               RA.adamw_init(rparams, RA.OptimConfig(**KW)),
                               jbatch)
    flat = lambda t: {  # noqa: E731
        "/".join(str(k.key) for k in p): np.asarray(v, np.float32)
        for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return {"total": float(total), "loss": float(parts["loss"]),
            "grads": flat(grads), "params": flat(rp), "opt": flat(ro),
            "metrics": {k: float(v) for k, v in rm.items()}}


def _port_plain(arch):
    """The port's own mesh-free loss and gradients."""
    rcfg, np_params, batch = _setup(arch)
    cfg = get_config(arch, tiny=True).replace(param_dtype="float32")
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    leaves, spec = pytree.tree_flatten(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    total, _ = S._loss_fn(pytree.tree_unflatten(alias, spec), cfg,
                          S.TrainStepConfig(loss_chunk=16),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(total, alias)
    return float(total.detach()), {k: _whole(v) for k, v in _paths(
        pytree.tree_unflatten(list(grads), spec)).items()}


@pytest.fixture(scope="module")
def mesh_steps():
    cases = [(a, sp, _setup(a)[1], _setup(a)[2]) for a, sp in CASES]
    results = _cluster(_step_worker, cases)
    return results


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    return _cluster(_driver_worker, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("arch,sp", CASES)
def test_sharded_loss_and_grads_match_reference(mesh_steps, arch, sp):
    ref = _reference(arch)
    for r in mesh_steps:
        got = r[(arch, sp)]
        assert abs(got["total"] - ref["total"]) <= 1e-5 * abs(ref["total"])
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert set(got["grads"]) == set(ref["grads"])
        for k, w in ref["grads"].items():
            assert np.abs(got["grads"][k] - w).max() <= 1e-4 * max(
                np.abs(w).max(), 1e-30), k
    # the mesh really split the work: some gradient lies in shards
    assert any("Shard" in p for p in mesh_steps[0][(arch, sp)]
               ["grad_placements"])


@pytest.mark.parametrize("arch,sp", CASES)
def test_sharded_grads_match_the_mesh_free_path(mesh_steps, arch, sp):
    total, grads = _port_plain(arch)
    got = mesh_steps[0][(arch, sp)]
    assert abs(got["total"] - total) <= 1e-5 * abs(total)
    for k, w in grads.items():
        assert np.abs(got["grads"][k] - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-30), k


@pytest.mark.parametrize("arch,sp", CASES)
def test_sharded_train_step_matches_reference(mesh_steps, arch, sp):
    """One step (lr 1e-3): metrics within 1e-5 relative; the moments within
    1e-4 of each leaf's largest magnitude; every parameter within 2 lr of
    the reference's, and all but 1e-3 of them within lr / 100."""
    ref = _reference(arch)
    got = mesh_steps[0][(arch, sp)]
    for k in ("loss", "aux", "grad_norm", "lr"):
        assert abs(got["metrics"][k] - ref["metrics"][k]) <= 1e-5 * max(
            abs(ref["metrics"][k]), 1e-6), k
    for k, w in ref["opt"].items():
        assert np.abs(got["opt"][k] - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-30), k
    lr, far, total = 1e-3, 0, 0
    for k, w in ref["params"].items():
        d = np.abs(got["params"][k] - w)
        assert d.max() <= 2 * lr + 1e-6, k
        far += int((d > lr / 100).sum())
        total += d.size
    assert far <= 1e-3 * total
    # every rank holds the same whole values
    for r in mesh_steps[1:]:
        for k, v in r[(arch, sp)]["params"].items():
            np.testing.assert_array_equal(v, got["params"][k])


def test_driver_resume_on_the_mesh_equals_uninterrupted(driver):
    for r in driver:
        assert r["start"] == 2
        assert r["cut"] + r["resumed"] == r["whole"]
        assert set(r["resumed_state"]) == set(r["whole_state"])
        for k, w in r["whole_state"].items():
            np.testing.assert_array_equal(r["resumed_state"][k], w, k)
        assert np.isfinite(r["whole"]).all()
        assert any("Shard" in p for p in r["placements"])


def _one_rank_worker(comm, port, base, arch):
    """A one-rank (1, 1) mesh: a run cut at 2 and resumed to 4 on the mesh,
    and the mesh-free 4-step run; the final states as host values."""
    import torch.distributed as dist

    from repro_torch.core.env import CraftEnv
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")

        def run(name, steps, mesh=None):
            env = CraftEnv.capture({"CRAFT_CP_PATH": f"{base}/{name}",
                                    "CRAFT_USE_SCR": "0"})
            tc = train.TrainConfig(arch=arch, steps=steps, global_batch=2,
                                   seq_len=32, cp_freq=2, device="cpu")
            return train.run(tc, comm=comm, mesh=mesh, env=env)

        run("mesh", 2, mesh)
        resumed = run("mesh", 4, mesh)
        clean = run("plain", 4)
        return {"start": resumed["start_step"],
                "resumed": resumed["losses"], "clean": clean["losses"],
                "resumed_state": {k: _whole(v) for k, v in
                                  _paths(resumed["state"]).items()},
                "clean_state": {k: _whole(v) for k, v in
                                _paths(clean["state"]).items()}}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_resume_equals_mesh_free_run(arch, tmp_path):
    """What the smoke's train phase holds on the card: a one-rank mesh
    reduces nothing, so its cut and resumed run ends bit for bit where the
    mesh-free uninterrupted run does."""
    from repro_torch.examples.elastic_restore import free_port
    from repro_torch.runtime import Cluster

    with Cluster(n_procs=1, env_overrides={"OMP_NUM_THREADS": "1"}) as c:
        c.start(_one_rank_worker, free_port(), str(tmp_path), arch)
        r = c.join(timeout=300)[0]
    assert r["start"] == 2 and r["resumed"] == r["clean"][2:]
    assert set(r["resumed_state"]) == set(r["clean_state"])
    for k, w in r["clean_state"].items():
        np.testing.assert_array_equal(r["resumed_state"][k], w, k)
