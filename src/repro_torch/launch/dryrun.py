"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake
devices (the reference's ``repro/launch/dryrun.py``).

For each cell this:
  1. starts a fake process group of the production mesh's size (256 for
     16×16, 512 for 2×16×16; rank 0; ``FakeStore``) in this process only,
     and builds the mesh on it (``launch.mesh``),
  2. builds the step function and its sharded stand-ins
     (``launch.specs``): DTensors over fake tensors, so no memory is
     allocated,
  3. traces the step once (``BuiltStep.lower``): a placement DTensor
     cannot propagate, a collective it cannot run, or a shape error here
     is a bug in the framework, not in the arch,
  4. prints the per-device bytes (the local shards of the arguments plus
     the peak of the tensors the trace holds at once), whether they fit
     the card (``fits_80GB``, one NVIDIA H100 80GB HBM3), and the
     three-term roofline on the H100's constants (``analysis.roofline``),
  5. optionally writes a JSON record under ``experiments/dryrun/``.

The reference compiles each cell with XLA and reads its memory analysis;
the port runs no compiler, so its bytes are the trace's: a compiler's
buffer reuse and fusion would hold less.  The fake tensors lie on the
CPU but take the card's route through the kernels' ops (dtypes, chunk
states), so the trace is the program the card runs.  The record also
sums the collectives by kind and shape (``collectives_by_shape``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
        --shape train_4k [--multipod] [--json-dir experiments/dryrun] [--tiny]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all    # whole matrix
"""
import argparse
import subprocess
import sys
import time
import traceback
from pathlib import Path


def fake_world(n: int) -> None:
    """A fake default process group of ``n`` ranks, this process rank 0
    (no other process exists; collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the cell needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def collectives_by_shape(counter, top: int = 12) -> list:
    """The trace's collectives summed by kind and output shape, largest
    first: ``[description, count, wire bytes]`` (which tensors the
    collective term is made of)."""
    agg: dict = {}
    for desc, wire in counter.coll_list:
        n, b = agg.get(desc, (0, 0.0))
        agg[desc] = (n + 1, b + wire)
    return [[d, n, b] for d, (n, b) in
            sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]]


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             json_dir, verbose: bool = True, tiny: bool = False) -> dict:
    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES, cell_supported, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_step

    shape = SHAPES[shape_name]
    ok, reason = cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    t0 = time.time()
    built = build_step(arch, shape, mesh, tiny=tiny)
    t_build = time.time() - t0
    t0 = time.time()
    lowered = built.lower(mesh)
    t_trace = time.time() - t0
    rep = roofline.analyze(lowered.counter)
    mfl = roofline.model_flops(
        get_config(arch, tiny=tiny), shape.seq_len, shape.global_batch,
        shape.kind, n_chips)
    per_dev = lowered.peak_per_device_bytes
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "kind": shape.kind,
        "tiny": tiny,
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_bytes": lowered.arg_bytes,
            "temp_bytes": lowered.counter.peak_bytes,
            "peak_per_device_bytes": per_dev,
            "fits_80GB": per_dev < roofline.HBM_BYTES,
        },
        "device": roofline.DEVICE,
        "roofline": rep.as_dict(),
        "model_flops_per_chip": mfl,
        "model_traced_ratio": mfl / max(rep.flops, 1.0),
        "collectives_by_shape": collectives_by_shape(lowered.counter),
    }
    if verbose:
        print(f"== {arch} × {shape_name} × {record['mesh']} "
              f"(build {t_build:.1f}s, trace {t_trace:.1f}s)")
        print(f"  peak bytes/device     {per_dev:.3e} "
              f"({'fits' if record['memory']['fits_80GB'] else 'EXCEEDS'} "
              f"80 GB, {roofline.DEVICE})")
        print(roofline.format_report(rep, mfl))
    if json_dir is not None:
        out = Path(json_dir) / record["mesh"] / f"{arch}__{shape_name}.json"
        roofline.save_json(out, record)
    return record


def run_matrix(json_dir: Path, multipod_only: bool = False,
               archs=None, shapes=None) -> int:
    """Run every cell in a subprocess (each its own fake process group).

    Returns the number of failed cells."""
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported

    failures = 0
    meshes = [True] if multipod_only else [False, True]
    for multi_pod in meshes:
        for arch in (archs or ARCH_IDS):
            for shape in (shapes or SHAPES):
                ok, reason = cell_supported(arch, shape)
                mesh_name = "2x16x16" if multi_pod else "16x16"
                if not ok:
                    print(f"-- skip {arch} × {shape} × {mesh_name}: {reason}")
                    continue
                out = Path(json_dir) / mesh_name / f"{arch}__{shape}.json"
                if out.exists():
                    print(f"-- cached {arch} × {shape} × {mesh_name}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--json-dir", str(json_dir)]
                if multi_pod:
                    cmd.append("--multipod")
                r = subprocess.run(cmd, capture_output=True, text=True)
                sys.stdout.write(r.stdout)
                if r.returncode != 0:
                    failures += 1
                    print(f"!! FAILED {arch} × {shape} × {mesh_name}")
                    sys.stdout.write(r.stderr[-3000:])
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run the whole cell × 2-mesh matrix (subprocesses)")
    ap.add_argument("--json-dir", default="experiments/dryrun")
    ap.add_argument("--tiny", action="store_true",
                    help="the arch's TINY config (a quick check of the path)")
    args = ap.parse_args()
    json_dir = Path(args.json_dir)
    if args.all:
        failures = run_matrix(json_dir)
        sys.exit(1 if failures else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        rec = run_cell(args.arch, args.shape, args.multipod, json_dir,
                       tiny=args.tiny)
        if rec.get("skipped"):
            print(f"-- skip {args.arch} × {args.shape}: {rec['skipped']}")
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
