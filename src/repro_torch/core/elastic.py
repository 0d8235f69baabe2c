"""Elastic helpers: balanced block decomposition and replacement-rank
hydration, ported from ``repro.core.elastic``.

The checkpoint manifest is topology-independent (shard files + global
indices), so a checkpoint written on N ranks restores onto M: each rank
owns the block :func:`block_index` gives it (``ShardCp`` +
``reshard.overlap_runs`` map the blocks across topologies), and a rank
spawned by NON-SHRINKING recovery restores its slice through
:func:`hydrate_replacement`.

The reference's mesh half (``shrink_mesh``, ``reshard``, ``dp_degree``)
builds JAX meshes from its sharding rules; it comes with the port of the
sharding layer.
"""
from __future__ import annotations


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
