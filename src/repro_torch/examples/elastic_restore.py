"""Elastic restore — shrinking recovery with automatic resharding, on
worker processes (the reference's ``examples/elastic_restore.py``).

The paper's shrinking recovery leaves 'redistributing the domain' to the
user; CRAFT's checkpoint manifest is topology-independent, so the same
training state written on a 4×2 mesh restores onto the 2×2 mesh that
remains after two hosts fail — every rank reads back only its own shards
of every leaf.

The reference runs one process with 8 placeholder devices.  Here each mesh
position is a process (``runtime.Cluster``) in a ``gloo`` group
(``torch.distributed``, ``tcp://localhost``): 8 writers hold the
parameters as DTensors on a (4, 2) ``("data", "model")`` mesh and write a
version; 4 fresh processes build the same tree on ``shrink_mesh(4,
model_parallel=2)``, restore it, and compare every local shard with the
matching slice of the seeded global state (``torch.equal``).  No
collective runs: each rank writes and reads its own extents.  With
``--device cuda`` every process keeps its shards on the one card (gloo:
NCCL refuses two ranks on one device).

    PYTHONPATH=src python -m repro_torch.examples.elastic_restore --device cpu
"""
import argparse
import socket
import time
from pathlib import Path

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _state(cfg, seed: int, device):
    """The seeded global parameter tree (the same on every rank)."""
    from repro_torch.models import model as M

    gen = torch.Generator(device=device).manual_seed(seed)
    return M.init_params(gen, cfg, device)


def _join(comm, port: int, mesh_shape, device):
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=comm.rank, world_size=comm.size)
    return dev


def _launches() -> dict:
    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda

    return {"checksum": checksum_rows.launches,
            "snapshot": snapshot_chunks_cuda.launches}


def _writer(comm, port, base, arch, tiny, seed, mesh_shape, device,
            snapshot):
    """One writer: the seeded tree as DTensors on ``mesh_shape``, one
    version written to ``base``/pfs."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import Box, Checkpoint
    from repro_torch.core.elastic import dp_degree
    from repro_torch.core.env import CraftEnv
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import shard_tree
    from repro_torch.models import model as M
    from repro_torch.sharding.logical import LogicalRules

    dev = _join(comm, port, mesh_shape, device)
    try:
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         device_type=dev.type)
        cfg = get_config(arch, tiny=tiny)
        params = shard_tree(_state(cfg, seed, dev), M.param_logical(cfg),
                            LogicalRules(mesh))
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": str(Path(base) / "pfs"), "CRAFT_USE_SCR": "0",
            "CRAFT_DEVICE_SNAPSHOT": "1" if snapshot else "0"})
        cp = Checkpoint("elastic", comm, env=env, device=dev)
        cp.add("params", Box(params))
        cp.commit()
        t0 = time.perf_counter()
        cp.update_and_write()
        cp.wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        write_s = time.perf_counter() - t0
        cp.close()
        return {"rank": comm.rank, "dp": dp_degree(mesh),
                "write_s": write_s, "launches": _launches()}
    finally:
        dist.destroy_process_group()


def _reader(comm, port, base, arch, tiny, seed, model_parallel, device):
    """One survivor: the tree's zeros on ``shrink_mesh``, restored, and
    every local shard held to the seeded global state's slice."""
    import torch.distributed as dist
    import torch.utils._pytree as pytree
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    from repro_torch.configs import get_config
    from repro_torch.core import Box, Checkpoint
    from repro_torch.core.elastic import dp_degree, shrink_mesh
    from repro_torch.core.env import CraftEnv
    from repro_torch.models import model as M
    from repro_torch.sharding.logical import (
        LogicalRules, shard_specs, sharded_zeros,
    )

    dev = _join(comm, port, None, device)
    try:
        mesh = shrink_mesh(comm.size, model_parallel, device_type=dev.type)
        cfg = get_config(arch, tiny=tiny)
        shapes = M.init_params(None, cfg, "meta")
        specs = shard_specs(LogicalRules(mesh), M.param_logical(cfg), shapes)
        live = pytree.tree_map(
            lambda s, sp: sharded_zeros(s.shape, s.dtype, sp, mesh, dev),
            shapes, specs, is_leaf=lambda x: isinstance(x, torch.Tensor))
        env = CraftEnv.capture({"CRAFT_CP_PATH": str(Path(base) / "pfs"),
                                "CRAFT_USE_SCR": "0"})
        box = Box(live)
        cp = Checkpoint("elastic", comm, env=env, device=dev)
        cp.add("params", box)
        cp.commit()
        t0 = time.perf_counter()
        restored = cp.restart_if_needed()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        cp.close()
        want = dict(pytree.tree_flatten_with_path(_state(cfg, seed, dev))[0])
        equal, n_bytes = True, 0
        for path, got in pytree.tree_flatten_with_path(box.value)[0]:
            w = want[path]
            shape, off = compute_local_shape_and_global_offset(
                got.shape, got.device_mesh, got.placements)
            sl = tuple(slice(o, o + s) for o, s in zip(off, shape))
            local = got.to_local()
            equal &= bool(torch.equal(local, w[sl]))
            n_bytes += local.numel() * local.element_size()
        return {"rank": comm.rank, "restored": bool(restored),
                "equal": equal, "local_bytes": n_bytes,
                "mesh": tuple(mesh.shape), "dp": dp_degree(mesh),
                "restore_s": restore_s, "launches": _launches()}
    finally:
        dist.destroy_process_group()


def _cluster(n: int, fn, *args, timeout: float):
    from repro_torch.runtime import Cluster

    with Cluster(n_procs=n, env_overrides={"OMP_NUM_THREADS": "1"}) as c:
        c.start(fn, *args)
        res = c.join(timeout=timeout)
    return [res[r] for r in sorted(res)]


def elastic_restore(base, arch: str = "h2o-danube-1.8b", tiny: bool = True,
                    device="cuda", write_mesh=(4, 2), survivors: int = 4,
                    model_parallel: int = 2, seed: int = 0,
                    snapshot: bool = False, timeout: float = 600.0) -> dict:
    """Write the seeded tree on ``write_mesh`` (one process a position),
    restore it on ``shrink_mesh(survivors, model_parallel)`` over fresh
    processes.  Returns {"writers": [...], "readers": [...], "equal": all
    shards equal, "wall_s"}: each process's result, by rank."""
    t0 = time.perf_counter()
    n_write = write_mesh[0] * write_mesh[1]
    writers = _cluster(n_write, _writer, free_port(), str(base), arch, tiny,
                       seed, tuple(write_mesh), str(device), snapshot,
                       timeout=timeout)
    readers = _cluster(survivors, _reader, free_port(), str(base), arch,
                       tiny, seed, model_parallel, str(device),
                       timeout=timeout)
    return {"writers": writers, "readers": readers,
            "equal": all(r["equal"] and r["restored"] for r in readers),
            "wall_s": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default="craft-elastic")
    args = ap.parse_args()
    out = elastic_restore(args.dir, device=args.device)
    w, r = out["writers"][0], out["readers"][0]
    print(f"wrote state on mesh (4, 2) (DP degree {w['dp']}) from "
          f"{len(out['writers'])} processes")
    print(f"shrunk to mesh {r['mesh']} (DP degree {r['dp']}): "
          f"{len(out['readers'])} processes restored their shards")
    if not out["equal"]:
        raise SystemExit("elastic restore FAILED: a shard differs")
    print("elastic restore OK")


if __name__ == "__main__":
    main()
