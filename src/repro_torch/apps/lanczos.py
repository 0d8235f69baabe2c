"""Lanczos eigensolver on a matrix-free graphene Hamiltonian (paper §5.1),
ported from ``repro/apps/lanczos.py``.

The paper's showcase application finds extremal eigenvalues of a sparse
matrix from the quantum-mechanical description of electron transport in
graphene, generated on the fly (never read from disk).  As in the
reference, the matvec is a matrix-free stencil: the nearest-neighbour
tight-binding Hamiltonian of the honeycomb lattice acting on a state laid
out as an (nx, ny, 2) grid (2 = the A/B sublattices):

    (H ψ)_A(x, y) = t · [ψ_B(x, y) + ψ_B(x-1, y) + ψ_B(x, y-1)]
    (H ψ)_B(x, y) = t · [ψ_A(x, y) + ψ_A(x+1, y) + ψ_A(x, y+1)]

(periodic boundaries via ``torch.roll``) + an optional on-site disorder
term.  H is Hermitian, spectrum ⊂ [-3|t|-W, 3|t|+W].  The matvec and the
dot products are plain PyTorch, as they are plain jnp in the reference.

The problem is generated on the device: the on-site term and the start
vector come from ``torch.Generator``s seeded with ``cfg.seed`` and
``cfg.seed + 1``.  ``init=`` takes another pair instead
(``convert.lanczos_init_from_numpy`` carries the reference's across), so
both packages can solve the same problem.

The loop is CRAFT-checkpointed exactly like the paper's benchmark and the
reference: the two live Lanczos vectors, the α/β arrays and the iteration
counter, under the reference's item names, so a version written by either
package resumes in the other.  :func:`run_with_hook` and
:func:`aft_lanczos` are the per-iteration failure hook and the 2-rank AFT
zone with one spare node of paper Fig. 8 (the reference keeps them in
``benchmarks/lanczos_aft.py``); :func:`cluster_lanczos` runs the same
scenario on real worker processes killed with SIGKILL.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Box, Checkpoint, trace
from repro_torch.core.elastic import hydrate_replacement


@dataclasses.dataclass(frozen=True)
class GrapheneConfig:
    nx: int = 64
    ny: int = 64
    t: float = 1.0           # hopping
    disorder: float = 0.0    # on-site disorder amplitude W
    seed: int = 0

    @property
    def n(self) -> int:
        return self.nx * self.ny * 2

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, 2)


def onsite(cfg: GrapheneConfig, device="cuda") -> torch.Tensor:
    """The on-site term: W · uniform[-1, 1) from a generator seeded with
    ``cfg.seed`` on ``device`` (zeros without disorder)."""
    if cfg.disorder == 0.0:
        return torch.zeros(cfg.shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    u = torch.empty(cfg.shape, dtype=torch.float32, device=device)
    return cfg.disorder * u.uniform_(-1.0, 1.0, generator=gen)


def start_vector(cfg: GrapheneConfig, device="cuda") -> torch.Tensor:
    """The unnormalized start vector: a standard normal draw from a
    generator seeded with ``cfg.seed + 1`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    return torch.randn(cfg.shape, generator=gen, dtype=torch.float32,
                       device=device)


def matvec(cfg: GrapheneConfig, eps: torch.Tensor,
           psi: torch.Tensor) -> torch.Tensor:
    """H @ psi for psi of shape (nx, ny, 2) — generated on the fly."""
    a, b = psi[..., 0], psi[..., 1]
    hb = cfg.t * (a + torch.roll(a, -1, 0) + torch.roll(a, -1, 1))
    ha = cfg.t * (b + torch.roll(b, 1, 0) + torch.roll(b, 1, 1))
    out = torch.stack([ha, hb], dim=-1)
    return out + eps * psi


def _normalize(v: torch.Tensor):
    nrm = torch.sqrt(torch.sum(v * v))
    return v / nrm, nrm


def lanczos_step(cfg: GrapheneConfig, eps: torch.Tensor,
                 v_prev: torch.Tensor, v_cur: torch.Tensor, beta: float):
    """One three-term step; returns (α, β_new, v_cur, v_new), α and β_new
    as 0-d tensors on the vectors' device.  ``beta`` is rounded to float32
    first, as the reference passes ``jnp.float32(beta)``."""
    beta = float(np.float32(beta))
    w = matvec(cfg, eps, v_cur)
    alpha = torch.sum(w * v_cur)
    w = w - alpha * v_cur - beta * v_prev
    beta_new = torch.sqrt(torch.sum(w * w))
    v_new = w / torch.where(beta_new == 0, 1.0, beta_new)
    return alpha, beta_new, v_cur, v_new


@dataclasses.dataclass
class LanczosResult:
    eigenvalue: float
    alphas: np.ndarray
    betas: np.ndarray
    iterations: int
    wall_s: float
    cp_stats: Dict
    restarted_at: int
    # beyond the reference: each step's seconds (host clock, span
    # ``craft::lanczos.step``: the step ends in a device-to-host read of α
    # and β) and the final fence's seconds (``craft::lanczos.close``)
    iter_s: List[float] = dataclasses.field(default_factory=list)
    fence_s: float = 0.0


def _initial_state(cfg, n_iter, device, init):
    """(eps, state): the reference's checkpointed items, item for item."""
    if init is None:
        eps, v0 = onsite(cfg, device), start_vector(cfg, device)
    else:
        eps, v0 = init
    v_cur, _ = _normalize(v0)
    return eps, {
        "v_prev": Box(torch.zeros_like(v_cur)),
        "v_cur": Box(v_cur),
        "alphas": np.zeros(n_iter, np.float64),
        "betas": np.zeros(n_iter + 1, np.float64),
        "it": Box(0),
    }


def _open_checkpoint(name, comm, env, device, state):
    with trace.TRACER.span("craft::lanczos.open", cp=name):
        cp = Checkpoint(name, comm, env=env, device=device)
        for k, v in state.items():
            cp.add(k, v)
        cp.commit()
    return cp


def _iterate(cfg, eps, state, n_iter, cp, cp_freq, hook=None, stop_at=None,
             extra_work_s=0.0):
    """The Lanczos loop from ``state["it"]`` on; returns (each step's
    seconds, whether it stopped at ``stop_at``).  The callers hold it in
    span ``craft::lanczos.iterate``."""
    iter_s: List[float] = []
    it = state["it"].value
    while it < n_iter:
        if hook is not None:
            hook(it, cp)
        with trace.TRACER.timed("craft::lanczos.step") as step:
            alpha, beta, vp, vc = lanczos_step(
                cfg, eps, state["v_prev"].value, state["v_cur"].value,
                state["betas"][it])
            with trace.TRACER.span("craft::lanczos.read"):
                state["alphas"][it] = float(alpha)
                state["betas"][it + 1] = float(beta)
        iter_s.append(step.seconds)
        state["v_prev"].value = vp
        state["v_cur"].value = vc
        it += 1
        state["it"].value = it
        if extra_work_s:
            time.sleep(extra_work_s)
        if cp is not None:
            cp.update_and_write(it, cp_freq)
        if stop_at is not None and it == stop_at:
            return iter_s, True
    return iter_s, False


def _ritz_min(alphas: np.ndarray, betas: np.ndarray, k: int) -> float:
    """Smallest eigenvalue of the k×k tridiagonal (α on the diagonal,
    β[1:k] beside it)."""
    if not k:
        return float("nan")
    tri = np.diag(alphas[:k])
    if k > 1:
        off = betas[1:k]
        tri += np.diag(off, 1) + np.diag(off, -1)
    return float(np.min(np.linalg.eigvalsh(tri)))


def run_lanczos(
    cfg: GrapheneConfig,
    n_iter: int = 300,
    cp_freq: int = 0,               # 0 = no checkpointing
    cp_name: str = "lanczos",
    comm=None,
    env=None,
    fail_at: Optional[int] = None,  # raise after this iteration (tests)
    extra_work_s: float = 0.0,      # pad per-iteration compute (benchmarks)
    device="cuda",
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> LanczosResult:
    """Plain 3-term Lanczos for the extremal eigenvalue of H.

    With ``cp_freq`` > 0, the Lanczos state (v_prev, v_cur, α, β, iter) is a
    CRAFT checkpoint — exactly the paper's benchmark setup.  ``init`` is an
    (on-site term, unnormalized start vector) pair on ``device`` in place
    of the seeded draws.
    """
    with trace.TRACER.span("craft::lanczos.solve"):
        eps, state = _initial_state(cfg, n_iter, device, init)
        cp = None
        restarted_at = 0
        if cp_freq:
            cp = _open_checkpoint(cp_name, comm, env, device, state)
            if cp.restart_if_needed():
                restarted_at = state["it"].value

        with trace.TRACER.timed("craft::lanczos.iterate") as loop:
            iter_s, failed = _iterate(cfg, eps, state, n_iter, cp, cp_freq,
                                      stop_at=fail_at,
                                      extra_work_s=extra_work_s)
        stats = {}
        with trace.TRACER.timed("craft::lanczos.close") as fence:
            if cp is not None:
                cp.wait()
                stats = dict(cp.stats)
                cp.close()
    if failed:
        raise RuntimeError(f"injected failure at iteration {fail_at}")

    k = state["it"].value
    return LanczosResult(
        eigenvalue=_ritz_min(state["alphas"], state["betas"], k),
        alphas=state["alphas"][:k], betas=state["betas"][:k],
        iterations=k, wall_s=loop.seconds, cp_stats=stats,
        restarted_at=restarted_at, iter_s=iter_s, fence_s=fence.seconds)


def reference_eigenvalue(cfg: GrapheneConfig, device="cpu",
                         eps: Optional[torch.Tensor] = None) -> float:
    """Dense reference for small lattices (tests): H column by column from
    the matvec of each basis vector, then its smallest eigenvalue.  ``eps``
    is the on-site term (default: :func:`onsite`)."""
    if eps is None:
        eps = onsite(cfg, device)
    basis = torch.eye(cfg.n, dtype=torch.float32, device=device)
    H = np.zeros((cfg.n, cfg.n), np.float64)
    for j in range(cfg.n):
        col = matvec(cfg, eps, basis[j].reshape(cfg.shape))
        H[:, j] = col.reshape(-1).cpu().numpy()
    return float(np.min(np.linalg.eigvalsh(H)))


def run_with_hook(cfg: GrapheneConfig, n_iter: int, cp_freq: int, comm, env,
                  hook: Callable[[int, Checkpoint], None], *,
                  device="cuda",
                  init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Dict:
    """The :func:`run_lanczos` loop with ``hook(it, cp)`` called before
    every step (the failure hook of paper Fig. 8; ``cp`` is the open
    checkpoint, so a hook can fence its writes), checkpointed as
    ``aftlan`` on ``comm``; ``init`` as in :func:`run_lanczos`.  A rank
    spawned by NON-SHRINKING recovery restores through
    :func:`~repro_torch.core.elastic.hydrate_replacement`.  Returns the
    reference's {"eig", "wall_s", "stats", "resumed_from"} plus "rank",
    "alphas", "betas", "iter_s" and "hydrated" (the replacement's
    {"restored", "tier", "reseeded"}, else None)."""
    with trace.TRACER.span("craft::lanczos.solve"):
        eps, state = _initial_state(cfg, n_iter, device, init)
        cp = _open_checkpoint("aftlan", comm, env, device, state)
        hydrated = hydrate_replacement(cp) if comm.is_replacement() else None
        restarted = (hydrated["restored"] if hydrated is not None
                     else cp.restart_if_needed())
        t0 = time.perf_counter()
        redo_iters = state["it"].value if restarted else 0
        try:
            with trace.TRACER.span("craft::lanczos.iterate"):
                iter_s, _ = _iterate(cfg, eps, state, n_iter, cp, cp_freq,
                                     hook=hook)
            cp.wait()
        finally:
            cp.close()
    k = state["it"].value
    return {
        "eig": _ritz_min(state["alphas"], state["betas"], k),
        "wall_s": time.perf_counter() - t0,
        "stats": dict(cp.stats),
        "resumed_from": redo_iters,
        "rank": comm.rank,
        "alphas": state["alphas"][:k].copy(),
        "betas": state["betas"][:k].copy(),
        "iter_s": iter_s,
        "hydrated": hydrated,
    }


def aft_lanczos(base, cfg: GrapheneConfig, n_iter: int, cp_freq: int,
                fail_at: Optional[int], n_procs: int = 2, *, device="cuda",
                kill: bool = False, envmap: Optional[dict] = None,
                timeout: float = 600.0) -> Dict:
    """Paper Fig. 8's failure scenario: ``n_procs`` simulated ranks (one
    spare node, NON-SHRINKING recovery) each run :func:`run_with_hook` in an
    AFT zone, checkpointing to ``base``/pfs.  At iteration ``fail_at`` of
    the first incarnation rank 0 fails: it raises ``ProcFailedError`` (the
    reference's form), or with ``kill`` it is fail-stopped by
    ``SimWorld.kill`` once its last version has landed, and dies at its
    next communicator call — with ``CRAFT_WRITE_ASYNC=1`` in ``envmap``
    that is a barrier inside its writer thread's publish.  The zone
    repairs the communicator and every member resumes from the latest
    version.

    Returns {"members": each finishing incarnation's result, by rank;
    "recoveries": the zone's recovery stats; "hook_calls": steps begun per
    rank, killed incarnations included; "wall_s"}.
    """
    from repro_torch.core.aft import aft_zone
    from repro_torch.core.comm import ProcFailedError
    from repro_torch.core.comm_sim import SimWorld
    from repro_torch.core.env import CraftEnv

    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(Path(base) / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING",
        **(envmap or {}),
    })
    world = SimWorld(n_procs, spare_nodes=1, env=env)
    fired = threading.Event()
    lock = threading.Lock()
    calls: Dict[int, int] = collections.Counter()
    recoveries: List[dict] = []

    def worker(comm):
        def body(c):
            def maybe_fail(it, cp):
                with lock:
                    calls[c.rank] += 1
                if (fail_at is not None and it == fail_at and c.rank == 0
                        and not fired.is_set()):
                    fired.set()
                    if kill:
                        # the failure strikes after the last version landed
                        # (an async write may still be in flight at fail_at)
                        cp.wait()
                        world.kill(c.rank)
                    else:
                        raise ProcFailedError("injected", failed=[c.rank])

            return run_with_hook(cfg, n_iter, cp_freq, c, env, maybe_fail,
                                 device=device)

        def on_recovery(c, stats):
            with lock:
                recoveries.append(stats)

        return aft_zone(comm, body, env=env, on_recovery=on_recovery)

    t0 = time.perf_counter()
    out = world.run(worker, timeout=timeout)
    return {"members": sorted(out.values(), key=lambda r: r["rank"]),
            "recoveries": recoveries, "hook_calls": dict(calls),
            "wall_s": time.perf_counter() - t0}


def _cluster_member(comm, base: str, cfg: GrapheneConfig, n_iter: int,
                    cp_freq: int, fail_at: Optional[int], fail_rank: int,
                    kill_by: str, device: str, envmap: dict,
                    deterministic: bool, init) -> Dict:
    """One worker process of :func:`cluster_lanczos` (module level, so the
    spawn start method can pickle it): :func:`run_with_hook` in an AFT
    zone on the process's ``ProcComm``.  Returns host values only."""
    started = time.time()
    import os
    import signal

    from repro_torch.convert import lanczos_init_from_numpy
    from repro_torch.core.aft import aft_zone
    from repro_torch.core.env import CraftEnv
    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if deterministic:
        # a spawned process inherits none of its parent's torch flags
        torch.use_deterministic_algorithms(True)
    env = CraftEnv.capture(envmap)
    if init is not None:
        init = lanczos_init_from_numpy(*init, device=dev)
    hook_calls = 0
    marked = threading.Event()

    def body(c):
        def maybe_fail(it, cp):
            nonlocal hook_calls
            hook_calls += 1
            if it == fail_at and c.rank == fail_rank and c.epoch == 0:
                if kill_by == "self":
                    cp.wait()    # the version before fail_at has landed
                    os.kill(os.getpid(), signal.SIGKILL)
                # the parent kills this process at a point it does not
                # choose, possibly inside an async publish
                (Path(base) / f"reached-{fail_rank}").touch()
                marked.set()
            if marked.is_set() and it == n_iter - 1:
                # the SIGKILL lands before the last step at the latest, so
                # the survivors meet it at a collective, not after the
                # zone's exit agreement (which completes over the living)
                threading.Event().wait()

        return run_with_hook(cfg, n_iter, cp_freq, c, env, maybe_fail,
                             device=dev, init=init)

    t0 = time.perf_counter()
    out = aft_zone(comm, body, env=env)
    out["zone_s"] = time.perf_counter() - t0
    out["size"] = comm.size
    out["hook_calls"] = hook_calls
    out["started"] = started
    out["launches"] = {"checksum": checksum_rows.launches,
                       "snapshot": snapshot_chunks_cuda.launches}
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)
    return out


def cluster_lanczos(base, cfg: GrapheneConfig, n_iter: int, cp_freq: int,
                    fail_at: Optional[int], n_procs: int = 2, *,
                    device="cuda", policy: str = "NON-SHRINKING",
                    kill_by: str = "self", fail_rank: int = 0,
                    envmap: Optional[dict] = None,
                    init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    timeout: float = 600.0) -> Dict:
    """Paper Fig. 8's failure scenario on real worker processes
    (:class:`repro_torch.runtime.Cluster`, one process a rank, each with
    its own CUDA context on a card): every rank runs
    :func:`run_with_hook` in an AFT zone, checkpointing to ``base``/pfs.
    At iteration ``fail_at`` of its first incarnation rank ``fail_rank``
    is fail-stopped by SIGKILL: ``kill_by="self"`` fences its writes and
    kills itself there (a fixed point); ``kill_by="parent"`` touches a
    marker file and runs on until this process, polling for the marker,
    kills it (the paper's ``pkill -9``); such a rank waits for its death
    before its last step at the latest.  ``policy`` is the recovery:
    NON-SHRINKING spawns a replacement on the one spare node, SHRINKING
    carries on with the survivors.  Deterministic algorithms are turned on
    in the workers when they are on here.  ``envmap`` is the workers'
    CRAFT environment and their ``env_overrides``.  ``init`` is the
    problem as numpy (on-site term, start vector), as
    ``convert.lanczos_init_from_numpy`` takes it; by default each worker
    draws the seeded one.

    Returns {"members": each finishing process's result (host values:
    :func:`run_with_hook`'s, plus its zone's seconds, size, steps begun,
    kernel launches, peak device bytes and "start_s", the seconds from
    this call to the worker function's start), by rank; "recoveries": the coordinator's recovery stats (Table 3's
    phases); "hook_calls": steps begun, by member; "wall_s";
    "min_free_bytes": the card's least free memory seen from here while
    the cluster ran (None off the card)}.
    """
    from repro_torch.runtime import Cluster

    if kill_by not in ("self", "parent"):
        raise ValueError(
            f"kill_by must be 'self' or 'parent', not {kill_by!r}")
    policy = policy.upper()
    base = Path(base)
    base.mkdir(parents=True, exist_ok=True)
    envmap = {"CRAFT_CP_PATH": str(base / "pfs"), "CRAFT_USE_SCR": "0",
              **(envmap or {}), "CRAFT_COMM_RECOVERY_POLICY": policy}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cluster = Cluster(n_procs, spare_nodes=int(policy == "NON-SHRINKING"),
                      recovery_policy=policy, env_overrides=envmap)
    marker = base / f"reached-{fail_rank}"
    armed = kill_by == "parent" and fail_at is not None
    min_free = None
    t0, t0_wall = time.perf_counter(), time.time()
    try:
        cluster.start(_cluster_member, str(base), cfg, n_iter, cp_freq,
                      fail_at, fail_rank, kill_by, str(dev), envmap,
                      torch.are_deterministic_algorithms_enabled(), init)
        while True:
            if on_card:
                free = torch.cuda.mem_get_info(dev)[0]
                min_free = free if min_free is None else min(min_free, free)
            if armed and marker.exists():
                cluster.kill(fail_rank)
                armed = False
            try:
                results = cluster.join(timeout=0.05)
                break
            except TimeoutError:
                if time.perf_counter() - t0 > timeout:
                    raise
    finally:
        cluster.shutdown()
    members = sorted(results.values(), key=lambda r: r["rank"])
    for m in members:
        m["start_s"] = m.pop("started") - t0_wall
    last = cluster.coord.last_recovery
    return {"members": members, "recoveries": [dict(last)] if last else [],
            "hook_calls": {m["rank"]: m["hook_calls"] for m in members},
            "wall_s": time.perf_counter() - t0, "min_free_bytes": min_free}
