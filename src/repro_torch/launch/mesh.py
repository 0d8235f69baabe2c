"""Production mesh definitions (single-pod 16×16, multi-pod 2×16×16) on
``torch.distributed``'s ``DeviceMesh`` (the reference's
``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION, not a module-level constant, so
importing this module touches no process-group state.  A mesh needs a
default process group of its world size: a real one across processes
(``torch.distributed.init_process_group``), or a fake one for the dry-run
(``launch.dryrun``).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, device_type="cuda"):
    """Arbitrary mesh for tests and small runs (e.g. ((1,), ("data",)))."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
