"""End-to-end training driver: model + optimizer + data + CRAFT CR/AFT.

The port of ``repro/launch/train.py``: the paper's Listing 2/9 pattern at
framework scale,

    state = init (params, opt_state, step, data cursor)
    cp = Checkpoint("train", comm); cp.add("state", ...); cp.commit()
    cp.restart_if_needed()
    while step < total:
        batch = data.batch(cursor.step)
        state = train_step(state, batch)
        cp.update_and_write(step, cp_freq)

wrapped in an AFT zone when a fault-tolerant communicator is supplied, so
process failures re-enter the loop from the latest checkpoint.  The
checkpoint holds the same items under the same names as the reference's
(``state`` = {"params", "opt"}, ``step``, ``cursor``), so a train
checkpoint written by either package restores in the other.

Without a mesh the state lives on one device, as plain tensors.  With
``mesh`` (a ``DeviceMesh`` with ``data`` and ``model`` dimensions, over
the processes of a ``torch.distributed`` group) the state is DTensors
placed by the reference's rules (``_mesh_rules``: the default 2-D rules,
``sequence_parallel`` splitting the residual stream's d_model over
``model``), each rank draws the same seeded parameters and keeps its
shards, the global batch is split by the rules, and every step runs under
the rules (``sharding.activations.mesh_context``); the checkpoint writes
each rank's shards, so a checkpoint taken on one mesh restores on another.
A mesh run is held to the mesh-free one.  ``sequence_parallel`` without a
mesh changes nothing, as in the reference (its one-device mesh has no
``model`` axis).  ``TrainConfig.device`` (default ``"cuda"``) places the
state; ``--device cpu`` runs the plain versions of the kernels.  For a bit-exact resume on the card the caller turns on
``torch.use_deterministic_algorithms`` (with ``CUBLAS_WORKSPACE_CONFIG``
set before cuBLAS starts), as ``main`` does: the embedding's backward
(``index_put`` with accumulation) is otherwise nondeterministic there.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from repro_torch.configs import get_config
from repro_torch.core import Box, Checkpoint
from repro_torch.core import metrics as craft_metrics
from repro_torch.core.aft import aft_zone
from repro_torch.core.checkpointables import FuncCp, register_adapter
from repro_torch.data.pipeline import DataCursor, SyntheticTokens
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import OptimConfig, adamw_init
from repro_torch.sharding.activations import mesh_context
from repro_torch.sharding.logical import LogicalRules, placements, shard_specs
from repro_torch.train.steps import StepTimer, TrainStepConfig, make_train_step

log = logging.getLogger("craft.train")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "h2o-danube-1.8b"
    tiny: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 64
    cp_freq: int = 10
    cp_name: str = "train"
    seed: int = 0
    microbatches: int = 1
    lr: float = 3e-4
    sequence_parallel: bool = False      # a mesh option (Megatron-SP)
    fail_at_step: Optional[int] = None   # in-process fault injection (tests)
    device: str = "cuda"


def optim_config(tc: TrainConfig) -> OptimConfig:
    """The reference driver's optimizer settings."""
    return OptimConfig(lr=tc.lr, master_fp32=False, warmup_steps=5,
                       total_steps=max(tc.steps, 10))


def _mesh_rules(mesh, sequence_parallel: bool) -> LogicalRules:
    rules = LogicalRules(mesh)
    if sequence_parallel:
        rules.rules["embed_act"] = "model"
    return rules


def shard_tree(tree, logical_tree, rules: LogicalRules):
    """Each leaf of ``tree`` (the same full tensor on every rank) as a
    DTensor on ``rules``' mesh, placed by its logical dims: every rank
    keeps its own shards, and nothing crosses ranks."""
    from torch.distributed.tensor import distribute_tensor

    specs = shard_specs(rules, logical_tree, tree)
    return pytree.tree_map(
        lambda x, spec: distribute_tensor(
            x, rules.mesh, placements(spec, rules.mesh), src_data_rank=None),
        tree, specs, is_leaf=lambda x: isinstance(x, torch.Tensor))


def init_state(cfg: ModelConfig, ocfg: OptimConfig, seed: int,
               device="cuda", rules: Optional[LogicalRules] = None):
    """(params, opt_state) on ``device``: parameters from a
    ``torch.Generator`` seeded with ``seed``, then ``adamw_init``.  With
    ``rules`` the parameters are DTensors on the rules' mesh (each rank
    draws the whole tree and keeps its shards, one leaf at a time), and
    the optimizer state takes their placements."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg, device)
    if rules is not None:
        params = shard_tree(params, M.param_logical(cfg), rules)
    return params, adamw_init(params, ocfg)


def shard_batch(batch: dict, rules: LogicalRules, device) -> dict:
    """The global batch split over the mesh by ("batch", "seq")."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device)
        out[k] = distribute_tensor(
            t, rules.mesh, rules.placements("batch", "seq",
                                            shape=tuple(t.shape)),
            src_data_rank=None)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(tc: TrainConfig, comm=None, mesh=None,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        env=None) -> Dict:
    """Train; returns {"losses", "final_step", "wall_s", "step_seconds",
    "stats"} as the reference does, plus "start_step" (the step the loop
    began at, after any restore), "grad_norms", "step_s" (each step's
    compute seconds, checkpoint writes excluded), "restore_s" (seconds of
    ``restart_if_needed``), "cp_writes" ([(step, seconds)] of each version
    written) and "state" (the final {"params", "opt"} tree itself).

    With ``comm`` (an FTComm), the whole loop runs inside an AFT zone: the
    checkpoint is (re)opened inside the zone body (paper Listing 9) so every
    recovery re-reads the latest consistent version.  With ``mesh`` the
    state is sharded over it (module note); ``comm`` then names each
    process's rank to the checkpoint (one process needs none).
    """
    cfg = get_config(tc.arch, tiny=tc.tiny)
    rules = (None if mesh is None
             else _mesh_rules(mesh, tc.sequence_parallel))
    device = torch.device(tc.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ocfg = optim_config(tc)
    scfg = TrainStepConfig(microbatches=tc.microbatches, loss_chunk=32)
    step_fn = make_train_step(cfg, ocfg, scfg)
    data = SyntheticTokens(
        vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
        seed=tc.seed, n_shards=1, shard=0)   # deterministic global batch

    def body(comm_inner):
        params, opt_state = init_state(cfg, ocfg, tc.seed, device, rules)
        state_box = Box({"params": params, "opt": opt_state})
        step_box = Box(0)
        cursor = DataCursor(0)

        cp = Checkpoint(tc.cp_name, comm_inner, env=env, device=device)
        cp.add("state", state_box)
        cp.add("step", step_box)
        cp.add("cursor", FuncBox(cursor))
        cp.commit()
        t0 = time.perf_counter()
        cp.restart_if_needed()
        _sync(device)
        restore_s = time.perf_counter() - t0
        start_step = step_box.value

        losses: List[float] = []
        grad_norms: List[float] = []
        step_s: List[float] = []
        cp_writes = []
        timer = StepTimer()
        t0 = time.perf_counter()
        try:
            while step_box.value < tc.steps:
                step_t0 = time.perf_counter()
                batch = data.batch(cursor.step)
                if rules is None:
                    p, o, metrics = step_fn(state_box.value["params"],
                                            state_box.value["opt"], batch)
                else:
                    with mesh_context(rules):
                        p, o, metrics = step_fn(
                            state_box.value["params"], state_box.value["opt"],
                            shard_batch(batch, rules, device))
                state_box.value = {"params": p, "opt": o}
                cursor.step += 1
                step_box.value += 1
                loss = float(metrics["loss"])
                losses.append(loss)
                grad_norms.append(float(metrics["grad_norm"]))
                # compute-only step time (checkpoint writes excluded) feeds
                # the scheduler's rework model and the result stats
                timer.observe(time.perf_counter() - step_t0)
                step_s.append(timer.last)
                if cp.policy is not None and timer.last is not None:
                    cp.policy.observe_step_seconds(timer.last)
                # live telemetry: step cadence + loss on the scoreboard
                if craft_metrics.REGISTRY.enabled:
                    craft_metrics.observe("train_step_seconds", timer.last)
                    craft_metrics.set_gauge("train_loss", loss)
                    craft_metrics.set_gauge("train_step", step_box.value)
                if on_step is not None:
                    on_step(step_box.value, metrics)
                if (tc.fail_at_step is not None
                        and step_box.value == tc.fail_at_step
                        and comm_inner is not None
                        and getattr(comm_inner, "rank", 0) == 0
                        and getattr(comm_inner, "epoch", 0) == 0):
                    # deterministic in-process fault injection (paper §5.3);
                    # epoch-0 guard: fire once, not on every AFT retry
                    raise_fault(comm_inner)
                version, tw = cp.version, time.perf_counter()
                cp.update_and_write(step_box.value, tc.cp_freq)
                if cp.version != version:
                    _sync(device)
                    cp_writes.append((step_box.value,
                                      time.perf_counter() - tw))
                if cp.should_stop:
                    # preemption flush landed or the walltime guard wrote its
                    # final checkpoint: the next job resumes from it
                    break
            cp.wait()
            return {
                "losses": losses,
                "final_step": step_box.value,
                "wall_s": time.perf_counter() - t0,
                "step_seconds": timer.ewma,
                "stats": dict(cp.stats),
                "start_step": start_step,
                "grad_norms": grad_norms,
                "step_s": step_s,
                "restore_s": restore_s,
                "cp_writes": cp_writes,
                "state": state_box.value,
            }
        finally:
            cp.close()

    if comm is None:
        return body(None)
    return aft_zone(comm, body)


def raise_fault(comm) -> None:
    """Deterministic fail-stop of this rank (the paper's in-program
    injection variant)."""
    from repro_torch.core.comm import ProcFailedError

    raise ProcFailedError(f"injected fault at rank {comm.rank}",
                          failed=[comm.rank])


class FuncBox:
    """Adapter exposing a DataCursor as a checkpointable POD box."""

    def __init__(self, cursor: DataCursor):
        self.cursor = cursor

    @property
    def value(self) -> int:
        return self.cursor.step

    @value.setter
    def value(self, v: int) -> None:
        self.cursor.step = int(v)


# Box duck-typing: Checkpoint.add() wraps Box instances via isinstance, so
# register FuncBox through the adapter registry instead.
register_adapter(
    lambda obj: isinstance(obj, FuncBox),
    lambda obj: FuncCp(lambda: obj.value, lambda v: setattr(obj, "value", v)),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--cp-freq", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        # deterministic kernels: a resumed run repeats the uninterrupted one
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    tc = TrainConfig(arch=args.arch, tiny=args.tiny, steps=args.steps,
                     global_batch=args.global_batch, seq_len=args.seq_len,
                     cp_freq=args.cp_freq, device=args.device)
    logging.basicConfig(level=logging.INFO)
    out = run(tc, on_step=lambda s, m: print(
        f"step {s:4d} loss {float(m['loss']):.4f} "
        f"gnorm {float(m['grad_norm']):.3f}"))
    print(f"done: {out['final_step']} steps in {out['wall_s']:.1f}s; "
          f"checkpoint stats {out['stats']}")


if __name__ == "__main__":
    main()
