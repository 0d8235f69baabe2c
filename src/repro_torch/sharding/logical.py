"""Logical-axis sharding rules (DP / FSDP / TP / EP over a device mesh),
the reference's ``repro/sharding/logical.py`` on a
``torch.distributed.device_mesh.DeviceMesh``.

Every parameter and activation declares *logical* dimension names; a rule
table maps them onto mesh dimensions.  The production mesh is
``("data", "model")`` single-pod and ``("pod", "data", "model")``
multi-pod (``launch/mesh.py``).

Default placement (MaxText-style 2-D sharding):

  * ``batch``   → ("pod", "data")   — data parallelism across pods + hosts
  * ``embed``   → "data"            — FSDP: weights sharded over the DP axis
  * ``heads`` / ``mlp`` / ``vocab`` / ``kv_heads`` / ``ssm_inner`` → "model"
                                     — tensor parallelism (Megatron split)
  * ``experts`` → "model"           — expert parallelism for MoE
  * everything else (seq, head_dim, ssm_state, layers, ...) replicated.

:meth:`LogicalRules.spec` returns a plain tuple, one entry a tensor
dimension (None, a mesh dimension's name, or a tuple of names), equal to
``tuple(PartitionSpec(...))`` of the reference's spec.  :func:`placements`
turns it into DTensor placements: for each mesh dimension, ``Shard(d)``
where tensor dimension ``d`` maps to it, else ``Replicate()``.  A tuple
entry such as ``("pod", "data")`` shards one tensor dimension over two
mesh dimensions; DTensor splits it by mesh dimension, outer first, which
is GSPMD's order when the names come in the mesh's order (the rules'
tuples do; another order raises).  With ``shape`` given every kept mesh
dimension divides the tensor dimension, so each device's extent is the
one GSPMD gives.  Without it a dimension may divide unevenly: GSPMD pads,
DTensor gives the last devices less.

``LogicalRules`` reads only the mesh's dimension names and sizes
(``mesh_dim_names``, ``shape``), so a stub stands in for a mesh of any
size.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch.utils._pytree as pytree

Axis = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",          # FSDP axis for weights
    "embed_act": None,        # activations keep d_model replicated
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "latent": "model",        # MLA compressed-KV dim
    "dt_rank": None,
    "capacity": None,
    "patches": None,
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh dimension name: size}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class LogicalRules:
    """A rule table bound to a mesh; filters axes the mesh doesn't have."""

    def __init__(self, mesh, rules: Optional[Dict[str, Axis]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES if rules is None else rules)

    def physical(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        ax = self.rules[logical]
        names = set(self.mesh.mesh_dim_names)
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        filtered = tuple(a for a in ax if a in names)
        return filtered if filtered else None

    def spec(self, *logical_dims: Optional[str],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """The spec of a tensor whose dims carry these logical names.

        With ``shape`` given, every candidate mesh axis must divide the dim
        size; non-dividing axes are dropped (prefix-wise for tuple rules)
        and the dim degrades toward replication.  An axis appears at most
        once in a spec.
        """
        used: set = set()
        axis_sizes = mesh_sizes(self.mesh)
        phys = []
        for i, dim in enumerate(logical_dims):
            ax = self.physical(dim)
            if ax is None:
                phys.append(None)
                continue
            axs = (ax,) if isinstance(ax, str) else ax
            axs = tuple(a for a in axs if a not in used)
            if shape is not None:
                kept, prod = [], 1
                for a in axs:
                    if shape[i] % (prod * axis_sizes[a]) == 0:
                        kept.append(a)
                        prod *= axis_sizes[a]
                    else:
                        break  # keep a contiguous prefix so sizes stay exact
                axs = tuple(kept)
            used.update(axs)
            if not axs:
                phys.append(None)
            elif len(axs) == 1:
                phys.append(axs[0])
            else:
                phys.append(axs)
        return tuple(phys)

    def placements(self, *logical_dims: Optional[str],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        return placements(self.spec(*logical_dims, shape=shape), self.mesh)


def placements(spec: Sequence[Axis], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension
    ``Shard(d)`` where tensor dimension ``d`` maps to it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axs} is not in the mesh's "
                             f"dimension order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def dtensor_of(shape, mesh, pls, make):
    """A DTensor of global ``shape`` on placements ``pls`` whose local
    shard is ``make(local_shape)``: each rank makes only its own."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape = torch.Size(shape)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pls)
    return DTensor.from_local(make(local), mesh, pls, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def sharded_zeros(shape, dtype, spec, mesh, device):
    """Zeros of global ``shape`` as a DTensor placed by ``spec``."""
    import torch

    return dtensor_of(shape, mesh, placements(spec, mesh),
                      lambda s: torch.zeros(s, dtype=dtype, device=device))


def spec_for(rules: LogicalRules, logical_dims: Sequence[Optional[str]]):
    return rules.spec(*logical_dims)


def is_dims(x) -> bool:
    """A leaf of a logical tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(
        isinstance(d, (str, type(None))) for d in x)


def shard_specs(rules: LogicalRules, logical_tree, shapes=None):
    """Map a tree whose leaves are tuples of logical dim names to specs.
    ``shapes``: a matching tree of anything with ``.shape`` (tensors on
    any device, the meta device included), enabling the divisibility
    fallback of ``spec``."""
    if shapes is None:
        return pytree.tree_map(lambda dims: rules.spec(*dims), logical_tree,
                               is_leaf=is_dims)
    return pytree.tree_map(
        lambda dims, arr: rules.spec(*dims, shape=tuple(arr.shape)),
        logical_tree, shapes, is_leaf=is_dims)
