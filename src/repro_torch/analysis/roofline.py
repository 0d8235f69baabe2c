"""Three-term roofline of a traced step (the reference's
``repro/analysis/roofline.py`` on PyTorch).

The reference parses XLA's compiled, partitioned HLO.  The port emits no
HLO, so it has no parser: a step is traced once, eagerly (on fake tensors
for a full-size cell, ``launch.specs``), under :class:`Counter`, a
``torch_dispatch`` mode that sees every op each rank runs on its local
tensors.  DTensor ops desugar into those local ops and their collectives
before the counter sees them (the counter is a ``CommDebugMode``, which
lets DTensor run first), so every count is per device, as the
reference's per-device HLO counts are.  An eager trace runs a loop's body
as often as the loop runs, so nothing needs a trip count.

    FLOPs       — ``FlopCounterMode``'s formulas (``torch.utils.
                  flop_counter.flop_registry``: matmuls, convolutions,
                  attention) on each op's local shapes, plus the formulas
                  the hand kernels' custom ops register
                  (``craft::flash_attention*``: 2 B Hq Lq Lk (Dqk + Dv);
                  ``craft::selective_scan*``: 2 B L' S), each the
                  reference's dot count for the same op.  Elementwise
                  FLOPs are ignored, as there.
    HBM bytes   — operand + output bytes of every op that is not a view
                  (``hbm_bytes_unfused``), and a fused estimate
                  (``hbm_bytes``): a chain of pointwise ops reads its
                  outside inputs and writes what leaves the chain (an
                  output another kind of op reads, or that outlives the
                  trace), as one fused kernel would.  A custom op (a hand
                  kernel) is charged its inputs and outputs only.
    collective  — per-op *wire* bytes with the reference's ring formulas:
                      all-gather       out − in        (received bytes)
                      reduce-scatter   in − out        (sent bytes)
                      all-reduce       2 × in × (g−1)/g
                      all-to-all       in × (g−1)/g
                  g = the process group's size.  DTensor's move of a
                  shard to another dim is the card's all-to-all on fake
                  tensors (a CPU mesh would fall back to an all-gather).

Terms (seconds, per device):

    compute_s    = flops / PEAK_FLOPS
    memory_s     = hbm_bytes / HBM_BW
    collective_s = wire_bytes / LINK_BW

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet
at its full 700 W power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives "NVIDIA H100 80GB HBM3, 700.00 W"): 989
TFLOP/s bf16 dense, 3.35 TB/s HBM, NVLink 900 GB/s all to all, 450 GB/s
each way.  A card set below 700 W runs slower than these.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor.debug import CommDebugMode

# --------------------------------------------------------------------- HW
DEVICE = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # bf16 dense, one NVIDIA H100 80GB HBM3
HBM_BW = 3.35e12             # bytes/s, one NVIDIA H100 80GB HBM3
LINK_BW = 450e9              # bytes/s each way, NVLink of one H100
HBM_BYTES = 80e9             # device memory of one NVIDIA H100 80GB HBM3

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast_": "broadcast",
}
# ops that move no bytes of their own
_FREE = {"detach", "lift_fresh", "empty", "empty_like", "empty_strided",
         "wait_tensor", "_local_scalar_dense", "copy_", "set_", "alias"}


def _tensors(x) -> list:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _group_size(args) -> int:
    """The process group's size, from a functional collective's group name
    or a c10d op's ProcessGroup argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str) and a not in ("sum", "avg", "max", "min",
                                           "product", "premul_sum"):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if type(a).__name__ == "ScriptObject":
            try:
                return int(torch.distributed.ProcessGroup.unbox(a).size())
            except (AttributeError, RuntimeError, TypeError):
                continue
    return 1


def _wire_bytes(kind: str, in_bytes: int, out_bytes: int, g: int) -> int:
    if g <= 1:
        return 0
    if kind == "all-gather":
        return max(0, out_bytes - in_bytes)
    if kind == "reduce-scatter":
        return max(0, in_bytes - out_bytes)
    if kind == "all-reduce":
        return int(2 * in_bytes * (g - 1) / g)
    if kind == "all-to-all":
        return int(in_bytes * (g - 1) / g)
    return in_bytes          # broadcast, permute


def _use_card_alltoall() -> list:
    """Route DTensor's move of a shard from one dim to another on fake
    tensors through its all-to-all op, as on the card (NCCL): on a CPU
    mesh DTensor falls back to an all-gather and a chunk, which would count
    the whole gathered tensor.  The all-to-all op's fake function gives the
    shape.  Returns (module, name, original) to put back."""
    import torch.distributed.tensor._collective_utils as cu
    from torch._subclasses.fake_tensor import FakeTensor

    op = getattr(getattr(torch.ops, "_dtensor", None), "shard_dim_alltoall",
                 None)
    orig = getattr(cu, "shard_dim_alltoall", None)
    if op is None or orig is None:
        return []

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if not isinstance(input, FakeTensor):
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    saved = []
    users = (cu, sys.modules.get("torch.distributed.tensor.placement_types"))
    for mod in users:
        if getattr(mod, "shard_dim_alltoall", None) is orig:
            saved.append((mod, "shard_dim_alltoall", orig))
            mod.shard_dim_alltoall = alltoall
    return saved


class Counter(CommDebugMode):
    """Counts a trace's per-device FLOPs, HBM bytes (fused estimate and
    raw), collective wire bytes and peak live bytes of the tensors it
    makes.  A ``CommDebugMode``: DTensor ops run first and their local ops
    and collectives come here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.flops = 0
        self.hbm_unfused = 0
        self.hbm = 0
        self.coll_total = 0
        self.coll_kind: Dict[str, float] = defaultdict(float)
        self.coll_list: List[Tuple[str, float]] = []
        self.n_coll = 0
        self._pending: Dict[int, Tuple[object, int]] = {}
        self._live: Dict[int, List[int]] = {}     # storage -> [refs, bytes]
        self.live_bytes = 0
        self.peak_bytes = 0
        self._shadow = 0
        self._saved = None
        self._a2a: list = []

    # -- DTensor's sharding propagation runs each new op once on fake
    # tensors of the GLOBAL shapes to learn its output's shape; those ops
    # are not the rank's work, so they are not counted
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        fn = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                     None)
        if fn is not None:
            counter = self

            def shadowed(prop, *a, **k):
                counter._shadow += 1
                try:
                    return fn(prop, *a, **k)
                finally:
                    counter._shadow -= 1

            self._saved = fn
            ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
        self._a2a = _use_card_alltoall()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for mod, name, fn in self._a2a:
                setattr(mod, name, fn)
            self._a2a = []
            if self._saved is not None:
                from torch.distributed.tensor._sharding_prop import (
                    ShardingPropagator,
                )

                ShardingPropagator._propagate_tensor_meta_non_cached = \
                    self._saved
                self._saved = None

    # -- live bytes of the tensors the trace makes
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [0, t.untyped_storage().nbytes()]
            self.live_bytes += ent[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] <= 0:
            self.live_bytes -= ent[1]
            del self._live[key]
            self._pending.pop(key, None)

    # -- fused bytes: pointwise chains
    def _read(self, t: torch.Tensor, fused: bool) -> int:
        key = _storage_key(t)
        if key in self._pending:
            if fused:
                return 0                   # inside the chain: on chip
            _, wb = self._pending.pop(key)  # leaves the chain: written
            return wb + _nbytes(t)
        return _nbytes(t)

    def finish(self) -> None:
        """Charge the chain outputs still alive (they outlive the trace)."""
        for ref, wb in list(self._pending.values()):
            if ref() is not None:
                self.hbm += wb
        self._pending.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                t is DTensor for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self._shadow:
            return out
        name = func._overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in outs:
            self._track(t)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            ib = sum(_nbytes(t) for t in _tensors(args[:1]))
            ob = sum(_nbytes(t) for t in outs) or ib
            wire = _wire_bytes(kind, ib, ob, _group_size(args))
            self.coll_total += wire
            self.coll_kind[kind] += wire
            self.coll_list.append((f"{kind} {tuple(outs[0].shape) if outs else ''}",
                                   wire))
            self.n_coll += 1
            return out
        packet = func._overloadpacket
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if func.is_view or name in _FREE:
            return out
        self.hbm_unfused += sum(_nbytes(t) for t in ins + outs)
        fused = torch.Tag.pointwise in func.tags
        self.hbm += sum(self._read(t, fused) for t in ins)
        for t in outs:
            if fused:
                self._pending[_storage_key(t)] = (weakref.ref(t), _nbytes(t))
            else:
                self.hbm += _nbytes(t)
        return out


@dataclasses.dataclass
class RooflineReport:
    flops: float                      # per device
    hbm_bytes: float                  # per device, fused estimate
    hbm_bytes_unfused: float          # per device, every op's operands
    collective_bytes: float           # per device, wire-effective
    collective_by_kind: Dict[str, float]
    top_collectives: List[Tuple[str, float]]   # (description, bytes)
    n_collective_ops: int

    # ---- derived terms (seconds) ----
    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_unfused": self.hbm_bytes_unfused,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": self.collective_by_kind,
            "top_collectives": self.top_collectives[:10],
            "n_collective_ops": self.n_collective_ops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def trace(fn, *args, **kwargs) -> Tuple[object, Counter]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Counter`; returns
    (its result, the counter)."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    c.finish()
    return out, c


def analyze(counted) -> RooflineReport:
    """The report of a traced step: a :class:`Counter` (``trace``'s
    second value, or ``launch.specs.BuiltStep.lower``'s ``counter``), or a
    zero-argument callable, which is traced here."""
    c = counted if isinstance(counted, Counter) else trace(counted)[1]
    coll = sorted(c.coll_list, key=lambda kv: -kv[1])
    return RooflineReport(
        flops=float(c.flops), hbm_bytes=float(c.hbm),
        hbm_bytes_unfused=float(c.hbm_unfused),
        collective_bytes=float(c.coll_total),
        collective_by_kind=dict(c.coll_kind), top_collectives=coll,
        n_collective_ops=c.n_coll)


# ------------------------------------------------------------- MODEL_FLOPS
def model_flops(cfg, seq_len: int, global_batch: int, kind: str,
                n_chips: int) -> float:
    """Per-chip useful model FLOPs: 6·N_active·D train, 2·N_active·D fwd."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = seq_len * global_batch
        total = 6.0 * n_active * tokens
    elif kind == "prefill":
        tokens = seq_len * global_batch
        total = 2.0 * n_active * tokens
    else:  # decode: one new token per sequence
        total = 2.0 * n_active * global_batch
    return total / n_chips


def format_report(rep: RooflineReport, model_fl_per_chip: float = 0.0) -> str:
    lines = [
        f"  flops/device          {rep.flops:.4e}",
        f"  hbm bytes/device      {rep.hbm_bytes:.4e} "
        f"(unfused {rep.hbm_bytes_unfused:.3e})",
        f"  collective bytes/dev  {rep.collective_bytes:.4e}",
        f"  compute term          {rep.compute_s * 1e3:10.3f} ms",
        f"  memory term           {rep.memory_s * 1e3:10.3f} ms",
        f"  collective term       {rep.collective_s * 1e3:10.3f} ms",
        f"  dominant              {rep.dominant}",
    ]
    if model_fl_per_chip:
        ratio = model_fl_per_chip / max(rep.flops, 1.0)
        lines.append(f"  MODEL/traced flops    {ratio:10.3f}")
    if rep.collective_by_kind:
        kinds = ", ".join(f"{k}={v:.3e}"
                          for k, v in sorted(rep.collective_by_kind.items()))
        lines.append(f"  collectives by kind   {kinds}")
    return "\n".join(lines)


def save_json(path, payload: dict) -> None:
    from pathlib import Path

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=2, default=float))
