"""Activation sharding constraints via an ambient LogicalRules context (the
reference's ``repro/sharding/activations.py``).

Model code pins the handful of tensors that matter (block inputs/outputs,
attention q/k/v, scan inputs, MoE dispatch buffers, CE logit chunks) with
``constrain(x, *logical_dims)``.  The rules are ambient (a context var
installed by the step builders and drivers around a step), so model code
stays mesh-agnostic.  Outside any context, or on a plain tensor,
``constrain`` is an exact no-op: single-device runs never see it.  On a
DTensor it redistributes to the rules' placements, with the same
shape-aware divisibility fallback as parameter specs.
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import Optional

import torch.utils._pytree as pytree

from repro_torch.sharding.logical import LogicalRules, is_dims

_RULES: contextvars.ContextVar[Optional[LogicalRules]] = \
    contextvars.ContextVar("craft_activation_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[LogicalRules]:
    return _RULES.get()


@contextlib.contextmanager
def mesh_context(rules: Optional[LogicalRules]):
    """What a step on DTensors runs under: the ambient ``rules``, and
    DTensor's implicit replication (a plain tensor the model makes, such
    as the positions or a zero initial state, joins a DTensor op as
    replicated)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with use_rules(rules), implicit_replication():
        yield rules


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (importing nothing: a DTensor exists only
    once ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _pin(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor taken as replicated) on
    ``placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, placements)
    return x


def gather_rows(table, ids):
    """``table[ids]`` for a DTensor ``table`` (an embedding): the table made
    whole on every rank, then each rank's own ids gathered locally
    (``local_map``; the same index op as on one device), the output split
    as the ids are; the table's gradient comes back partial over the mesh
    dimensions that split the ids.  DTensor's own sharding of the gather
    refuses ids split over two mesh dimensions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    whole = (Replicate(),) * mesh.ndim
    ids = _pin(ids, mesh, ids.placements if is_dtensor(ids) else whole)
    ip = tuple(ids.placements)
    grad = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                 for pl in ip)
    fn = local_map(lambda t, i: t[i.long()], out_placements=list(ip),
                   in_placements=(whole, ip), in_grad_placements=(grad, ip),
                   device_mesh=mesh)
    return fn(_pin(table, mesh, whole), ids)


def rows_reduce(fn, x, ids):
    """``fn(x, ids)`` -> (sum, count) over the rows of a DTensor ``x``
    (B, L, V) and its ids (B, L): ``x`` split as the ids are over (B, L)
    and whole over V, ``fn`` on each rank's rows (``local_map``), the two
    sums partial over the mesh dimensions that split the rows (the
    cross entropy's sums; the same ops as on one device)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    ids = _pin(ids, mesh, ids.placements if is_dtensor(ids)
               else (Replicate(),) * mesh.ndim)
    ip = tuple(Shard(pl.dim) if isinstance(pl, Shard) and pl.dim < 2
               else Replicate() for pl in ids.placements)
    ids = _pin(ids, mesh, ip)
    part = [Partial() if isinstance(pl, Shard) else Replicate() for pl in ip]
    f = local_map(fn, out_placements=(part, part), in_placements=(ip, ip),
                  in_grad_placements=(ip, ip), device_mesh=mesh)
    return f(_pin(x, mesh, ip), ids)


def constrain(x, *dims):
    """Pin ``x``'s placement to the logical ``dims`` (no-op without rules
    or on a plain tensor)."""
    rules = _RULES.get()
    if rules is None or not is_dtensor(x):
        return x
    if len(dims) != x.dim():
        raise ValueError(
            f"constrain: {len(dims)} dims for rank-{x.dim()} tensor")
    want = rules.placements(*dims, shape=tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_tree(tree, logical_tree):
    """Pin a tree's placements to its logical dims (no-op without rules)."""
    if _RULES.get() is None:
        return tree

    def apply(dims, leaf):
        if not hasattr(leaf, "dim") or leaf.dim() != len(dims):
            return leaf
        return constrain(leaf, *dims)

    return pytree.tree_map(apply, logical_tree, tree, is_leaf=is_dims)
