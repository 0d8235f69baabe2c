"""The port's Lanczos app (``repro_torch.apps.lanczos``, paper §5.1 and
Fig. 8) against the reference's (``repro.apps.lanczos``) on the CPU.

The reference's on-site term and start vector (JAX PRNG draws) are carried
into the port by ``convert.lanczos_init_from_numpy``, so both packages
solve the same problem; the on-site term is not part of the checkpoint, so
a version resumes in the other package only with the same problem.
Tolerances: the matvec and one step at 1e-6, alphas and betas over 100
iterations at 64² at 1e-5 (measured 1.3e-6: XLA and PyTorch sum the dot
products in different orders), the smallest Ritz value at 1e-6 (measured
3.3e-9).  The port's own crash-and-rerun and its AFT runs are bit-exact.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.lanczos as R
from repro.core.env import CraftEnv as RefEnv

from repro_torch.apps import lanczos as L
from repro_torch.convert import lanczos_init_from_numpy
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemFabric
from repro_torch.kernels.lanczos import ref as fused_ref
from repro_torch.kernels.lanczos.kernel import lanczos_step_cuda


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


def _cfgs(nx, disorder):
    return (R.GrapheneConfig(nx=nx, ny=nx, disorder=disorder),
            L.GrapheneConfig(nx=nx, ny=nx, disorder=disorder))


def _ref_problem(cfg):
    """The reference's on-site term and start vector as numpy (the draws
    ``repro.apps.lanczos.run_lanczos`` makes)."""
    eps = np.array(R.onsite(cfg))
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(cfg.seed + 1),
                                    (cfg.nx, cfg.ny, 2), jnp.float32))
    return eps, v0


def _ref_step(cfg, eps, v_prev, v_cur, beta):
    """The reference's three-term step (``run_lanczos``'s inner ``step``)."""
    w = R.matvec(cfg, eps, v_cur)
    alpha = jnp.sum(w * v_cur)
    w = w - alpha * v_cur - beta * v_prev
    beta_new = jnp.sqrt(jnp.sum(w * w))
    return alpha, beta_new, w / jnp.where(beta_new == 0, 1.0, beta_new)


def _env(path, mod=CraftEnv):
    return mod.capture({"CRAFT_CP_PATH": str(path), "CRAFT_USE_SCR": "0"})


@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_matvec_matches_reference(disorder):
    rcfg, pcfg = _cfgs(32, disorder)
    eps, _ = _ref_problem(rcfg)
    psi = np.random.default_rng(7).standard_normal(
        (32, 32, 2)).astype(np.float32)
    want = np.asarray(R.matvec(rcfg, jnp.asarray(eps), jnp.asarray(psi)))
    got = L.matvec(pcfg, torch.from_numpy(eps), torch.from_numpy(psi))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_one_step_matches_reference(disorder):
    rcfg, pcfg = _cfgs(32, disorder)
    eps, v0 = _ref_problem(rcfg)
    rng = np.random.default_rng(11)
    v_prev = rng.standard_normal((32, 32, 2)).astype(np.float32)
    v_prev /= np.linalg.norm(v_prev)
    v_cur = (v0 / np.linalg.norm(v0)).astype(np.float32)
    beta = 0.8125
    a, b, v_new = _ref_step(rcfg, jnp.asarray(eps), jnp.asarray(v_prev),
                            jnp.asarray(v_cur), jnp.float32(beta))
    ga, gb, gv, gnew = L.lanczos_step(
        pcfg, torch.from_numpy(eps), torch.from_numpy(v_prev),
        torch.from_numpy(v_cur), beta)
    assert abs(float(ga) - float(a)) < 1e-6
    assert abs(float(gb) - float(b)) < 1e-6
    assert torch.equal(gv, torch.from_numpy(v_cur))
    np.testing.assert_allclose(gnew.numpy(), np.asarray(v_new), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_100_iterations_hold_the_reference(disorder):
    rcfg, pcfg = _cfgs(64, disorder)
    ref = R.run_lanczos(rcfg, n_iter=100)
    got = L.run_lanczos(pcfg, n_iter=100, device="cpu",
                        init=lanczos_init_from_numpy(*_ref_problem(rcfg),
                                                     device="cpu"))
    assert got.iterations == ref.iterations == 100
    np.testing.assert_allclose(got.alphas, ref.alphas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.betas, ref.betas, rtol=0, atol=1e-5)
    assert abs(got.eigenvalue - ref.eigenvalue) < 1e-6
    assert len(got.iter_s) == 100


@pytest.mark.parametrize("nx", [4, 6])
@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_reference_eigenvalue_holds_the_reference(nx, disorder):
    rcfg, pcfg = _cfgs(nx, disorder)
    eps, _ = _ref_problem(rcfg)
    want = R.reference_eigenvalue(rcfg)
    got = L.reference_eigenvalue(pcfg, eps=torch.from_numpy(eps))
    assert abs(got - want) < 1e-5
    if disorder == 0.0:
        assert abs(L.reference_eigenvalue(pcfg) - (-3.0)) < 1e-5
    # the port's own problem: Lanczos reaches the dense answer
    lz = L.run_lanczos(pcfg, n_iter=pcfg.n, device="cpu")
    assert abs(lz.eigenvalue - L.reference_eigenvalue(pcfg)) < 1e-5


def test_start_vector_and_onsite_are_seeded():
    cfg = L.GrapheneConfig(nx=8, ny=8, disorder=0.3, seed=5)
    assert torch.equal(L.onsite(cfg, "cpu"), L.onsite(cfg, "cpu"))
    assert torch.equal(L.start_vector(cfg, "cpu"), L.start_vector(cfg, "cpu"))
    eps = L.onsite(cfg, "cpu")
    assert eps.shape == (8, 8, 2) and eps.dtype == torch.float32
    assert float(eps.abs().max()) <= 0.3
    assert not torch.equal(L.onsite(cfg, "cpu"),
                           L.onsite(L.GrapheneConfig(8, 8, disorder=0.3,
                                                     seed=6), "cpu"))
    assert not torch.any(L.onsite(L.GrapheneConfig(8, 8), "cpu"))


def test_init_from_numpy_checks_the_shapes():
    eps = np.zeros((4, 4, 2), np.float32)
    with pytest.raises(ValueError):
        lanczos_init_from_numpy(eps, np.zeros((4, 4), np.float32), "cpu")
    e, v = lanczos_init_from_numpy(eps, np.ones((4, 4, 2)), "cpu")
    assert e.dtype == v.dtype == torch.float32 and v.shape == (4, 4, 2)


def test_crash_and_rerun_is_bit_exact(tmp_path):
    cfg = L.GrapheneConfig(nx=32, ny=32, disorder=0.3)
    clean = L.run_lanczos(cfg, n_iter=80, device="cpu")
    env = _env(tmp_path / "pfs")
    with pytest.raises(RuntimeError, match="injected failure at iteration 45"):
        L.run_lanczos(cfg, n_iter=80, cp_freq=20, env=env, fail_at=45,
                      device="cpu")
    res = L.run_lanczos(cfg, n_iter=80, cp_freq=20, env=env, device="cpu")
    assert res.restarted_at == 40 and res.iterations == 80
    assert np.array_equal(res.alphas, clean.alphas)
    assert np.array_equal(res.betas, clean.betas)
    assert res.eigenvalue == clean.eigenvalue
    assert res.cp_stats["restore_tier"] == "pfs"


def test_reference_version_resumes_in_the_port(tmp_path):
    rcfg, pcfg = _cfgs(32, 0.3)
    clean = R.run_lanczos(rcfg, n_iter=80)
    with pytest.raises(RuntimeError):
        R.run_lanczos(rcfg, n_iter=80, cp_freq=20, fail_at=45,
                      env=_env(tmp_path, RefEnv))
    got = L.run_lanczos(pcfg, n_iter=80, cp_freq=20, env=_env(tmp_path),
                        device="cpu",
                        init=lanczos_init_from_numpy(*_ref_problem(rcfg),
                                                     device="cpu"))
    assert got.restarted_at == 40
    # the first 40 alphas are the reference's own, read from its version
    assert np.array_equal(got.alphas[:40], clean.alphas[:40])
    assert abs(got.eigenvalue - clean.eigenvalue) < 1e-6


def test_port_version_resumes_in_the_reference(tmp_path):
    rcfg, pcfg = _cfgs(32, 0.3)
    init = lanczos_init_from_numpy(*_ref_problem(rcfg), device="cpu")
    clean = L.run_lanczos(pcfg, n_iter=80, device="cpu", init=init)
    with pytest.raises(RuntimeError):
        L.run_lanczos(pcfg, n_iter=80, cp_freq=20, fail_at=45,
                      env=_env(tmp_path), device="cpu", init=init)
    got = R.run_lanczos(rcfg, n_iter=80, cp_freq=20,
                        env=_env(tmp_path, RefEnv))
    assert got.restarted_at == 40
    assert np.array_equal(got.alphas[:40], clean.alphas[:40])
    assert abs(got.eigenvalue - clean.eigenvalue) < 1e-6
    assert abs(got.eigenvalue - R.run_lanczos(rcfg, n_iter=80).eigenvalue) \
        < 1e-6


@pytest.mark.parametrize("write_async", ["0", "1"])
@pytest.mark.parametrize("kill", [False, True], ids=["raise", "kill"])
def test_aft_lanczos_equals_the_failure_free_run(tmp_path, kill, write_async):
    """Rank 0 fails at iteration 30 (cp_freq 20): by a raised
    ProcFailedError (the reference example's form) or fail-stopped by
    ``SimWorld.kill`` — with async writes it then dies on its writer
    thread, at the barrier inside the next version's publish.  Every
    member resumes from 20 and ends on the failure-free run's numbers."""
    cfg = L.GrapheneConfig(nx=32, ny=32, disorder=0.3)
    clean = L.run_lanczos(cfg, n_iter=80, device="cpu")
    out = L.aft_lanczos(tmp_path, cfg, 80, 20, 30, device="cpu", kill=kill,
                        envmap={"CRAFT_WRITE_ASYNC": write_async},
                        timeout=120)
    members = out["members"]
    assert [m["rank"] for m in members] == [0, 1]
    for m in members:
        assert m["resumed_from"] == 20
        assert np.array_equal(m["alphas"], clean.alphas)
        assert np.array_equal(m["betas"], clean.betas)
        assert m["eig"] == clean.eigenvalue
    assert out["recoveries"]
    failed = {tuple(s["failed"]) for s in out["recoveries"]}
    assert failed == ({(0,)} if kill else {()})
    # each rank began steps 20..29 twice (before and after the failure)
    assert all(n >= 90 for n in out["hook_calls"].values())
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- the fused step's plain mirror (kernels/lanczos/ref.py) ----------------
@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_fused_mirror_step_matches_reference(disorder):
    """The kernel's three passes, as the plain mirror runs them, against
    the reference's step at 32²: α, β and v_new within 1e-6."""
    rcfg, _ = _cfgs(32, disorder)
    eps, v0 = _ref_problem(rcfg)
    rng = np.random.default_rng(11)
    v_prev = rng.standard_normal((32, 32, 2)).astype(np.float32)
    v_prev /= np.linalg.norm(v_prev)
    v_cur = (v0 / np.linalg.norm(v0)).astype(np.float32)
    beta = 0.8125
    a, b, v_new = _ref_step(rcfg, jnp.asarray(eps), jnp.asarray(v_prev),
                            jnp.asarray(v_cur), jnp.float32(beta))
    ga, gb, gnew = fused_ref.lanczos_step_ref(
        1.0, torch.from_numpy(eps), torch.from_numpy(v_prev),
        torch.from_numpy(v_cur), beta)
    assert abs(float(ga) - float(a)) < 1e-6
    assert abs(float(gb) - float(b)) < 1e-6
    np.testing.assert_allclose(gnew.numpy(), np.asarray(v_new), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("disorder", [0.0, 0.3])
def test_fused_mirror_100_iterations_hold_the_reference(disorder):
    """100 iterations of the mirror at 64² on the reference's problem:
    alphas and betas within 1e-5 of ``repro.apps.lanczos.run_lanczos``."""
    rcfg, _ = _cfgs(64, disorder)
    ref = R.run_lanczos(rcfg, n_iter=100)
    eps, v0 = (torch.from_numpy(x) for x in _ref_problem(rcfg))
    v_cur = v0 / torch.sqrt(torch.sum(v0 * v0))
    v_prev = torch.zeros_like(v_cur)
    alphas, betas = np.zeros(100), np.zeros(101)
    for it in range(100):
        a, b, v_new = fused_ref.lanczos_step_ref(
            1.0, eps, v_prev, v_cur, float(np.float32(betas[it])))
        alphas[it], betas[it + 1] = float(a), float(b)
        v_prev, v_cur = v_cur, v_new
    np.testing.assert_allclose(alphas, ref.alphas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(betas[:100], ref.betas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 4), (5, 8), (48, 24), (4300, 6),
                                   (3, 1030)])
def test_fused_mirror_groups_like_the_plain_step(shape):
    """The mirror's grouping (a block walking several rows at (4300, 6),
    several strips across a row at (3, 1030), odd nx at (5, 8)) against
    the application's plain step: α, β and v_new within 1e-6, v_new's
    elementwise arithmetic bit for bit where β_new agrees."""
    nx, ny = shape
    geo = fused_ref.geometry(nx, ny)
    assert geo.groups * geo.rows >= nx > (geo.groups - 1) * geo.rows
    assert geo.strips * fused_ref.STRIP >= ny
    g = torch.Generator().manual_seed(nx * 1000 + ny)
    eps = 0.3 * torch.rand(shape + (2,), generator=g)
    v_prev, v_cur = (torch.randn(shape + (2,), generator=g)
                     for _ in range(2))
    v_prev, v_cur = v_prev / v_prev.norm(), v_cur / v_cur.norm()
    cfg = L.GrapheneConfig(nx=nx, ny=ny)
    a, b, _, v_new = L.lanczos_step(cfg, eps, v_prev, v_cur, 0.5)
    ma, mb, m_new = fused_ref.lanczos_step_ref(1.0, eps, v_prev, v_cur, 0.5)
    assert abs(float(ma) - float(a)) < 1e-6
    assert abs(float(mb) - float(b)) < 1e-6
    torch.testing.assert_close(m_new, v_new, rtol=0, atol=1e-6)
    if float(ma) == float(a) and float(mb) == float(b):
        assert torch.equal(m_new, v_new)


def test_cpu_steps_take_the_plain_route():
    """CPU vectors never reach the kernel, whose wrapper refuses them
    before it builds anything: a CPU solve launches it not once."""
    launches = lanczos_step_cuda.launches
    res = L.run_lanczos(L.GrapheneConfig(nx=8, ny=8, disorder=0.3),
                        n_iter=12, device="cpu")
    assert res.iterations == 12
    assert lanczos_step_cuda.launches == launches
    v = torch.zeros(8, 8, 2)
    with pytest.raises(ValueError, match="lanczos_step_cuda"):
        lanczos_step_cuda(1.0, v, v, v, 0.0)
    assert lanczos_step_cuda.launches == launches
