"""The port's multi-process runtime (``repro_torch.runtime``) on the CPU:
real worker processes killed with SIGKILL and repaired by the ULFM recipe.

- The reference's ``tests/test_runtime.py`` run on the port's ``Cluster``.
- One scenario on both packages' ``Cluster``s: rank 1 of 3 killed under
  NON-SHRINKING with a spare node must recover alike.
- Only host values cross the coordinator connection: a tensor in a
  collective value or a result raises ``TypeError``.
- Paper Fig. 8 across processes (``apps.lanczos.cluster_lanczos``), killed
  by itself or from outside, against an uninterrupted ``run_lanczos``
  (bit for bit) and the reference's on the same problem (1.3e-6).

Worker functions are module level (the spawn start method pickles them by
name, so a worker imports this module).  The module imports neither JAX
nor the reference at its top, so the port's workers import neither: the
reference is imported inside the tests that use it.  Every ``join`` has a
timeout and every ``Cluster`` is shut down in a ``finally``.  Workers run
one torch thread each (``OMP_NUM_THREADS`` through ``env_overrides``):
several test processes, each with 3-4 workers, share the cores.
"""
import importlib
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.apps import lanczos as L
from repro_torch.convert import lanczos_init_from_numpy
from repro_torch.runtime import Cluster

pytestmark = pytest.mark.slow

ONE_THREAD = {"OMP_NUM_THREADS": "1"}


# --------------------------------------------------------- worker functions
def _sum_ranks(comm):
    """The allreduce of the ranks, and the JAX or reference modules this
    worker process has imported (none for the port's)."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return {"sum": comm.allreduce(comm.rank, op="sum"), "foreign": foreign}


def _resilient_barriers(comm, pkg="repro_torch"):
    comm_mod = importlib.import_module(f"{pkg}.core.comm")
    recovered = False
    while True:
        try:
            for _ in range(40):
                comm.barrier()
                time.sleep(0.01)
            return ("recovered" if recovered else "fresh", comm.size)
        except (comm_mod.ProcFailedError, comm_mod.RevokedError):
            try:
                comm.revoke()
            except Exception:
                pass
            comm = comm.recover()
            recovered = True


def _aft_counting(comm):
    from repro_torch.core.aft import aft_zone

    def body(c):
        for _ in range(30):
            c.barrier()
            time.sleep(0.01)
        return c.size

    return aft_zone(comm, body)


def _tensor_values(comm):
    """Rank 0 offers a collective a tensor and returns the error; rank 1
    returns a tensor inside a result."""
    if comm.rank == 0:
        try:
            comm.allreduce({"x": [torch.ones(2)]})
        except TypeError as exc:
            return str(exc)
        return "sent"
    return {"alphas": (np.zeros(2), torch.zeros(2))}


# ------------------------------------------------------------------ helpers
def _until_connected(cluster, n, timeout=60.0):
    """Wait until all ``n`` first incarnations said hello, so a kill lands
    in the run (every worker's loop waits for the last hello) and not
    before a worker connected."""
    deadline = time.monotonic() + timeout
    while len(cluster.coord._conn_gen) < n:
        assert time.monotonic() < deadline, "workers did not connect"
        time.sleep(0.02)


def _run(cluster, fn, *args, n=None, kill=None, timeout=120):
    try:
        cluster.start(fn, *args)
        if kill is not None:
            _until_connected(cluster, n)
            cluster.kill(kill)
        return cluster.join(timeout=timeout)
    finally:
        cluster.shutdown()


# ------------------------------------------------------------------- tests
def test_collectives_across_processes():
    results = _run(Cluster(n_procs=3, env_overrides=ONE_THREAD), _sum_ranks)
    assert len(results) == 3
    assert {r["sum"] for r in results.values()} == {3}
    assert all(r["foreign"] == [] for r in results.values())


def test_kill9_nonshrinking_recovery():
    cluster = Cluster(n_procs=3, procs_per_node=1, spare_nodes=1,
                      recovery_policy="NON-SHRINKING",
                      env_overrides=ONE_THREAD)
    results = _run(cluster, _resilient_barriers, n=3, kill=1)
    assert len(results) == 3
    assert {v[1] for v in results.values()} == {3}
    assert any(v[0] == "recovered" for v in results.values())
    assert cluster.coord.last_recovery.get("failed") == [1]


def test_kill9_shrinking_recovery():
    cluster = Cluster(n_procs=4, recovery_policy="SHRINKING",
                      env_overrides=ONE_THREAD)
    results = _run(cluster, _resilient_barriers, n=4, kill=2)
    assert {v[1] for v in results.values()} == {3}


def test_aft_zone_survives_kill9():
    cluster = Cluster(n_procs=3, spare_nodes=1,
                      recovery_policy="NON-SHRINKING",
                      env_overrides=ONE_THREAD)
    results = _run(cluster, _aft_counting, n=3, kill=0)   # even rank 0
    assert set(results.values()) == {3}


def test_port_and_reference_recover_alike():
    """Rank 1 of 3 killed under NON-SHRINKING with a spare node, once on
    each package's Cluster: the same failed ranks, sizes after recovery and
    recovery-stat keys."""
    from repro.runtime.cluster import Cluster as RefCluster

    seen = {}
    for pkg, cls in (("repro_torch", Cluster), ("repro", RefCluster)):
        cluster = cls(n_procs=3, spare_nodes=1,
                      recovery_policy="NON-SHRINKING",
                      env_overrides=ONE_THREAD)
        results = _run(cluster, _resilient_barriers, pkg, n=3, kill=1)
        stats = cluster.coord.last_recovery
        seen[pkg] = (stats["failed"], sorted(v[1] for v in results.values()),
                     sorted(stats))
    assert seen["repro_torch"] == seen["repro"]
    assert seen["repro_torch"][:2] == ([1], [3, 3, 3])


def test_a_tensor_never_crosses_the_connection():
    cluster = Cluster(n_procs=2, env_overrides=ONE_THREAD)
    with pytest.raises(RuntimeError, match="TypeError: result: a torch"):
        _run(cluster, _tensor_values)
    assert cluster.coord.results[0].startswith(
        "allreduce: a torch.Tensor cannot cross")


def _late_rank_zero(comm, base):
    """Rank 0 opens its checkpoint a second after rank 1, which writes at
    once: rank 1's staged files must outlive rank 0's sweep of torn
    staging dirs.  Both restore in a fresh Checkpoint."""
    from repro_torch.core import Box, Checkpoint, CraftEnv

    env = CraftEnv.capture({"CRAFT_CP_PATH": base, "CRAFT_USE_SCR": "0"})
    x = torch.arange(1024, dtype=torch.float32) + comm.rank
    if comm.rank == 0:
        time.sleep(1.0)
    with Checkpoint("late", comm, env=env, device="cpu") as cp:
        cp.add(f"x-{comm.rank}", Box(x))
        cp.commit()
        cp.update_and_write(1)
    live = Box(torch.zeros_like(x))
    with Checkpoint("late", comm, env=env, device="cpu") as cp:
        cp.add(f"x-{comm.rank}", live)
        cp.commit()
        restored = cp.restart_if_needed()
    return {"restored": bool(restored),
            "equal": bool(torch.equal(live.value, x))}


def test_a_late_rank_zero_sweeps_no_peer_files(tmp_path):
    """Opening a PFS store barriers after rank 0's sweep (the reference's
    does not: there a peer that stages first loses its files)."""
    results = _run(Cluster(n_procs=2, env_overrides=ONE_THREAD),
                   _late_rank_zero, str(tmp_path))
    assert sorted(results) == [0, 1]
    assert all(r["restored"] and r["equal"] for r in results.values())


def _ref_problem(rcfg):
    """The reference's on-site term and start vector as numpy (the draws
    ``repro.apps.lanczos.run_lanczos`` makes), and its alphas and betas."""
    import jax
    import jax.numpy as jnp

    import repro.apps.lanczos as R

    eps = np.array(R.onsite(rcfg))
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(rcfg.seed + 1),
                                    (rcfg.nx, rcfg.ny, 2), jnp.float32))
    return eps, v0, R.run_lanczos(rcfg, n_iter=12)


@pytest.mark.parametrize("kill_by,policy,n_procs,fail_rank", [
    ("self", "NON-SHRINKING", 2, 0),
    ("parent", "SHRINKING", 3, 2),
])
def test_cluster_lanczos_equals_the_uninterrupted_run(tmp_path, kill_by,
                                                      policy, n_procs,
                                                      fail_rank):
    """64², 12 iterations, a version every 4, rank ``fail_rank`` SIGKILLed
    at 6: by itself (NON-SHRINKING, a replacement hydrates from 4) or from
    outside (SHRINKING, 3 -> 2).  Every member ends on the uninterrupted
    run's alphas and betas, which hold the reference's."""
    import repro.apps.lanczos as R

    eps, v0, ref = _ref_problem(R.GrapheneConfig(nx=64, ny=64, disorder=0.3))
    cfg = L.GrapheneConfig(nx=64, ny=64, disorder=0.3)
    clean = L.run_lanczos(cfg, n_iter=12, device="cpu",
                          init=lanczos_init_from_numpy(eps, v0, "cpu"))
    np.testing.assert_allclose(clean.alphas, ref.alphas, rtol=0, atol=1.3e-6)
    np.testing.assert_allclose(clean.betas, ref.betas, rtol=0, atol=1.3e-6)
    out = L.cluster_lanczos(tmp_path, cfg, 12, 4, 6, n_procs, device="cpu",
                            policy=policy, kill_by=kill_by,
                            fail_rank=fail_rank, envmap=ONE_THREAD,
                            init=(eps, v0), timeout=120)
    members = out["members"]
    assert [m["rank"] for m in members] == [0, 1]
    for m in members:
        assert m["size"] == 2
        assert np.array_equal(m["alphas"], clean.alphas)
        assert np.array_equal(m["betas"], clean.betas)
    assert [s["failed"] for s in out["recoveries"]] == [[fail_rank]]
    assert out["min_free_bytes"] is None
    if kill_by == "self":
        assert [m["resumed_from"] for m in members] == [4, 4]
        assert members[0]["hydrated"] == {"restored": True, "tier": "pfs",
                                          "reseeded": 0}
        assert members[1]["hydrated"] is None
        # the survivor redid steps 4 .. 7: its version at 8 never landed
        assert out["hook_calls"] == {0: 8, 1: 16}
    else:
        assert members[0]["resumed_from"] == members[1]["resumed_from"] >= 4
        assert all(m["hydrated"] is None for m in members)
