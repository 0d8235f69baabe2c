"""Elastic remesh and helpers, ported from ``repro.core.elastic``.

The paper's shrinking recovery leaves domain redistribution to the user.
Here the checkpoint manifest is topology-independent (shard files + global
indices), so after a shrink the framework itself rebuilds a smaller mesh
and restores the same global state resharded.

The data-parallel axis absorbs the shrink (every DP slice holds a full
model replica group, so dropping DP slices never strands a weight shard);
the model axis is preserved.  :func:`shrink_mesh` builds the largest valid
``DeviceMesh`` for the surviving process count; :func:`reshard` moves a
live tree onto it.  A restore from a checkpoint needs no special code:
build the state on the new mesh (DTensors placed by the same logical
rules) and ``Checkpoint.restart_if_needed()`` — each rank reads only its
own extents from the shard files (``core.checkpointables``).

Host-side domain decomposition: each rank owns the block
:func:`block_index` gives it (``ShardCp`` + ``reshard.overlap_runs`` map
the blocks across topologies), and a rank spawned by NON-SHRINKING
recovery restores its slice through :func:`hydrate_replacement`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.sharding.logical import LogicalRules, placements, shard_specs


def shrink_mesh(n_devices: int, model_parallel: int,
                axis_names: Tuple[str, ...] = ("data", "model"),
                device_type: str = "cuda"):
    """Largest (data, model) mesh with the given TP degree that fits
    ``n_devices`` devices: the first ``data * model_parallel`` ranks of
    the default process group (every rank of the group calls it).  Raises
    if fewer than one model group survives."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot hold one {model_parallel}-way "
            "model-parallel group — shrink recovery impossible; use "
            "non-shrinking recovery with spare nodes instead")
    from torch.distributed.device_mesh import DeviceMesh

    data = n_devices // model_parallel
    ranks = torch.arange(data * model_parallel).reshape(data, model_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def reshard(tree, logical_tree, new_mesh,
            rules: Optional[LogicalRules] = None):
    """Move a live tree onto ``new_mesh`` under the same logical rules;
    returns (tree, specs).  A DTensor already on ``new_mesh`` is
    redistributed; a plain tensor (the same on every rank) or a DTensor
    of another mesh (gathered there first) is split, each rank keeping
    its own shards."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    rules = rules or LogicalRules(new_mesh)
    specs = shard_specs(rules, logical_tree, tree)

    def move(x, spec):
        pls = placements(spec, new_mesh)
        if isinstance(x, DTensor):
            if x.device_mesh == new_mesh:
                return x.redistribute(new_mesh, pls)
            x = x.full_tensor()
        return distribute_tensor(x, new_mesh, pls, src_data_rank=None)

    return pytree.tree_map(move, tree, specs,
                           is_leaf=lambda x: isinstance(x, torch.Tensor)), \
        specs


def dp_degree(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return sizes.get("data", 1) * sizes.get("pod", 1)


def block_index(global_shape, rank: int, size: int, axis: int = 0):
    """Balanced contiguous block decomposition of a global array over
    ``size`` ranks along ``axis`` — the extent ``rank`` owns, as a tuple of
    slices (``()`` for 0-d arrays, which every rank replicates whole).

    The first ``shape[axis] % size`` ranks get one extra row, so any N→M
    pair of decompositions tiles the array without gaps — the geometry
    :func:`repro_torch.core.reshard.overlap_runs` maps across topologies.
    """
    global_shape = tuple(int(s) for s in global_shape)
    if not global_shape:
        return ()
    if not 0 <= axis < len(global_shape):
        raise ValueError(f"axis {axis} out of range for {global_shape}")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    base, rem = divmod(global_shape[axis], size)
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return tuple(
        slice(lo, hi) if d == axis else slice(0, s)
        for d, s in enumerate(global_shape)
    )


def hydrate_replacement(cp) -> dict:
    """Restore a spawned replacement rank's slice from the tier chain.

    Called in the zone body a replacement re-enters after NON-SHRINKING
    recovery: the checkpoint restores through the normal chain — with the
    memory tier chained first, the slice comes out of surviving peers'
    RAM-fabric replicas (or an RS group rebuild on the node tier) without
    touching the PFS — and the rank's own fabric slots are re-seeded
    (``CRAFT_ELASTIC_HYDRATE``).  Returns what happened, for recovery
    telemetry::

        {"restored": bool, "tier": label|None, "reseeded": int}
    """
    restored = cp.restart_if_needed()
    return {
        "restored": bool(restored),
        "tier": cp.stats.get("restore_tier"),
        "reseeded": int(cp.stats.get("mem_rehydrations", 0)),
    }
