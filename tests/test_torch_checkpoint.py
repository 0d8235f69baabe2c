"""The port's Checkpoint: the paper's Listing-2 loop on CPU tensors, restart
and resume, versions that cross between the port and the reference package
on the default node,pfs PARTNER chain, the fault-tolerance settings on one
rank, and a package that never loads JAX."""
import shutil
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as T
from repro_torch.convert import state_from_numpy, tensor_from_numpy

CHUNK = 512


def _envd(tmp_path, **extra):
    d = {"CRAFT_CP_PATH": str(tmp_path / "pfs"),
         "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
         "CRAFT_CHUNK_BYTES": str(CHUNK)}
    d.update({k: str(v) for k, v in extra.items()})
    return d


def _tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((40, 33)).astype(ml_dtypes.bfloat16),
        "b": rng.standard_normal(300).astype(np.float32),
        "step": np.array(7, np.int32),
        "mask": rng.integers(0, 2, 21).astype(bool),
        "none": None,
        "nested": [rng.standard_normal(5).astype(np.float32),
                   (np.arange(6, dtype=np.uint8),)],
    }


def _same(a, b) -> bool:
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.asarray(a).tobytes() == np.asarray(b).tobytes())


# ------------------------------------------------------------- Listing 2
def _listing2(env, state, it, crash_at=None, until=10):
    """The quickstart loop: add → commit → restart_if_needed → the policy's
    need_checkpoint/update_and_write; returns the iteration it resumed at."""
    with T.Checkpoint("qs", env=env, device="cpu") as cp:
        cp.add("iteration", it)
        cp.add("state", T.Box(state))
        cp.commit()
        cp.restart_if_needed()
        start = it.value
        while it.value < until:
            it.value += 1
            state["x"].add_(1)
            if crash_at is not None and it.value == crash_at:
                return start
            if cp.need_checkpoint(it.value):
                cp.update_and_write(it.value)
    return start


@pytest.mark.parametrize("delta", ["0", "1"])
def test_listing2_crash_and_resume(tmp_path, delta):
    env = T.CraftEnv.capture(_envd(tmp_path, CRAFT_DELTA=delta))
    state, it = {"x": torch.zeros(1000)}, T.Box(0)
    assert _listing2(env, state, it, crash_at=6) == 0
    state2, it2 = {"x": torch.zeros(1000)}, T.Box(0)
    assert _listing2(env, state2, it2) == 5       # resumed from v-5
    assert it2.value == 10
    assert torch.equal(state2["x"], torch.full((1000,), 10.0))


def test_restart_primes_delta_state(tmp_path):
    env = T.CraftEnv.capture(_envd(tmp_path, CRAFT_DELTA=1))
    state = {"x": torch.arange(4096, dtype=torch.float32)}
    with T.Checkpoint("d", env=env, device="cpu") as cp:
        cp.add("s", T.Box(state))
        cp.commit()
        cp.update_and_write(1)
    live = {"x": torch.zeros(4096)}
    with T.Checkpoint("d", env=env, device="cpu") as cp:
        cp.add("s", T.Box(live))
        cp.commit()
        assert cp.restart_if_needed()
        live["x"][0] = -1                   # one dirty chunk of 32
        cp.update_and_write(2)
        assert cp.stats["delta_chunks_skipped"] > 0


def test_restore_into_live_tensors_in_place(tmp_path):
    env = T.CraftEnv.capture(_envd(tmp_path))
    state = state_from_numpy(_tree(), "cpu")
    with T.Checkpoint("p", env=env, device="cpu") as cp:
        cp.add("s", T.Box(state))
        cp.commit()
        cp.update_and_write(1)
    live = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}
    live["nested"] = [torch.zeros(5), (torch.zeros(6, dtype=torch.uint8),)]
    w_before = live["w"]
    box = T.Box(live)
    with T.Checkpoint("p", env=env, device="cpu") as cp:
        cp.add("s", box)
        cp.commit()
        assert cp.restart_if_needed()
    assert box.value["w"] is w_before
    for k in ("w", "b", "step", "mask"):
        assert torch.equal(box.value[k], state[k]), k
    assert box.value["none"] is None
    assert torch.equal(box.value["nested"][1][0], state["nested"][1][0])


# ------------------------------------------------------- cross-package
def _write_port(env_d, kind, data):
    env = T.CraftEnv.capture(env_d)
    with T.Checkpoint("x", env=env, device="cpu") as cp:
        if kind == "ndarray":
            cp.add("a", data.copy())
        elif kind == "tensor":
            cp.add("a", T.Box(tensor_from_numpy(data, "cpu")))
        else:
            tree = state_from_numpy(data, "cpu")
            # a numpy leaf, as the reference writer below keeps it
            tree["nested"][1] = (data["nested"][1][0].copy(),)
            cp.add("a", T.Box(tree))
        cp.add("it", T.Box(3))
        cp.commit()
        cp.update_and_write(1)
        return cp.stats


def _write_ref(env_d, kind, data):
    env = R.CraftEnv.capture(env_d)
    with R.Checkpoint("x", env=env) as cp:
        if kind == "ndarray":
            cp.add("a", data.copy())
        elif kind == "tensor":
            cp.add("a", R.Box(jnp.asarray(data)))
        else:
            cp.add("a", R.Box({k: (jnp.asarray(v) if k != "nested" else
                                   [jnp.asarray(v[0]), (v[1][0],)])
                               if isinstance(v, (np.ndarray, list)) else v
                               for k, v in data.items()}))
        cp.add("it", R.Box(3))
        cp.commit()
        cp.update_and_write(1)


def _read_port(env_d, kind, data):
    env = T.CraftEnv.capture(env_d)
    with T.Checkpoint("x", env=env, device="cpu") as cp:
        it = T.Box(0)
        if kind == "ndarray":
            live = np.zeros_like(data)
            cp.add("a", live)
        elif kind == "tensor":
            box = T.Box(torch.zeros_like(tensor_from_numpy(data, "cpu")))
            cp.add("a", box)
        else:
            box = T.Box(state_from_numpy(
                {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else v)
                 for k, v in data.items()}, "cpu"))
            cp.add("a", box)
        cp.add("it", it)
        cp.commit()
        assert cp.restart_if_needed() and it.value == 3
        tier = cp.stats["restore_tier"]
    if kind == "ndarray":
        assert _same(live, data)
    elif kind == "tensor":
        assert torch.equal(box.value, tensor_from_numpy(data, "cpu"))
    else:
        want = state_from_numpy(data, "cpu")
        for k in ("w", "b", "step", "mask"):
            assert torch.equal(box.value[k], want[k]), k
        assert torch.equal(box.value["nested"][0], want["nested"][0])
        got = box.value["nested"][1][0]     # a numpy leaf where the writer
        if isinstance(got, torch.Tensor):   # stored one ("np" kind)
            got = got.numpy()
        assert _same(got, data["nested"][1][0])
    return tier


def _read_ref(env_d, kind, data):
    env = R.CraftEnv.capture(env_d)
    with R.Checkpoint("x", env=env) as cp:
        it = R.Box(0)
        if kind == "ndarray":
            live = np.zeros_like(data)
            cp.add("a", live)
        elif kind == "tensor":
            box = R.Box(jnp.zeros(data.shape, data.dtype))
            cp.add("a", box)
        else:
            box = R.Box({k: (jnp.zeros(v.shape, v.dtype)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in data.items() if k != "nested"}
                        | {"nested": [jnp.zeros(5, jnp.float32),
                                      (np.zeros(6, np.uint8),)]})
            cp.add("a", box)
        cp.add("it", it)
        cp.commit()
        assert cp.restart_if_needed() and it.value == 3
        tier = cp.stats["restore_tier"]
    if kind == "ndarray":
        assert _same(live, data)
    elif kind == "tensor":
        assert _same(np.asarray(box.value), data)
    else:
        for k in ("w", "b", "step", "mask"):
            assert _same(np.asarray(box.value[k]), data[k]), k
        assert _same(np.asarray(box.value["nested"][0]), data["nested"][0])
        assert _same(box.value["nested"][1][0], data["nested"][1][0])
    return tier


KIND_DATA = {
    "ndarray": np.random.default_rng(1).standard_normal((30, 20)).astype(
        np.float32),
    "tensor": np.random.default_rng(2).standard_normal((50, 41)).astype(
        ml_dtypes.bfloat16),
    "tree": _tree(),
}


@pytest.mark.parametrize("codec", ["0", "1", "2"])
@pytest.mark.parametrize("kind", sorted(KIND_DATA))
@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_versions_cross_packages(tmp_path, codec, kind, direction):
    env_d = _envd(tmp_path, CRAFT_CODEC_VERSION=codec)
    data = KIND_DATA[kind]
    if direction == "port->ref":
        _write_port(env_d, kind, data)
        tier = _read_ref(env_d, kind, data)
    else:
        _write_ref(env_d, kind, data)
        tier = _read_port(env_d, kind, data)
    assert tier == "node"


def test_version_files_identical_across_packages(tmp_path):
    for who, write in (("ref", _write_ref), ("port", _write_port)):
        write(_envd(tmp_path / who), "tree", KIND_DATA["tree"])
    ref_dir = tmp_path / "ref" / "pfs" / "x" / "v-1"
    port_dir = tmp_path / "port" / "pfs" / "x" / "v-1"
    ref_files = sorted(p.relative_to(ref_dir) for p in ref_dir.rglob("*")
                       if p.is_file())
    port_files = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")
                        if p.is_file())
    assert port_files == ref_files
    for rel in ref_files:
        assert (port_dir / rel).read_bytes() == (ref_dir / rel).read_bytes(), rel


def test_partner_mirror_serves_a_lost_node_copy(tmp_path):
    """Two simulated nodes: the PARTNER mirror written by the port restores
    a node whose local copy is gone, and the reference reads it too."""
    class TwoNodes(T.NullComm):
        def procs_per_node(self):
            return 1

        @property
        def size(self):
            return 2

    env_d = _envd(tmp_path)
    env = T.CraftEnv.capture(env_d)
    data = KIND_DATA["tensor"]
    with T.Checkpoint("x", comm=TwoNodes(), env=env, device="cpu") as cp:
        cp.add("a", T.Box(tensor_from_numpy(data, "cpu")))
        cp.commit()
        cp.update_and_write(1)
    mirror = tmp_path / "node" / "node-1" / "mirror-of-0" / "x" / "v-1"
    assert mirror.is_dir()
    shutil.rmtree(tmp_path / "node" / "node-0" / "x" / "v-1")
    box = T.Box(torch.zeros_like(tensor_from_numpy(data, "cpu")))
    with T.Checkpoint("x", comm=TwoNodes(), env=env, device="cpu") as cp:
        cp.add("a", box)
        cp.commit()
        assert cp.restart_if_needed()
        assert cp.stats["restore_tier"] == "node"
    assert torch.equal(box.value, tensor_from_numpy(data, "cpu"))


# ------------------------------------------------ fault-tolerance settings
@pytest.mark.parametrize("extra,what", [
    ({"CRAFT_NODE_REDUNDANCY": "XOR"}, "XOR"),
    ({"CRAFT_NODE_REDUNDANCY": "RS"}, "RS"),
    ({"CRAFT_TIER_CHAIN": "mem,node,pfs"}, "memory tier"),
    ({"CRAFT_SCRUB_EVERY": "1"}, "scrubber"),
])
def test_later_slices_are_refused(tmp_path, extra, what):
    """The settings that the port's first slice refused with a
    CheckpointError (node XOR/RS redundancy, the memory tier, the background
    scrubber) now commit, write and restore bit-exactly."""
    T.MemFabric.instance().reset()
    env = T.CraftEnv.capture(_envd(tmp_path, **extra))
    x = torch.arange(300, dtype=torch.float32)
    with T.Checkpoint("r", env=env, device="cpu") as cp:
        cp.add("a", T.Box(x.clone()))
        cp.commit()
        assert cp.scrubber is not None
        cp.update_and_write(1)
    box = T.Box(torch.zeros(300))
    with T.Checkpoint("r", env=env, device="cpu") as cp:
        cp.add("a", box)
        cp.commit()
        assert cp.restart_if_needed()
        tier = cp.stats["restore_tier"]
        scan = cp.scrubber.scan_once()
    T.MemFabric.instance().reset()
    assert torch.equal(box.value, x)
    assert scan["corrupt_found"] == 0 and scan["files_scanned"] > 0
    assert tier == ("mem" if what == "memory tier" else "node")
    side = {"XOR": "xor-group-0", "RS": "rs-group-0"}.get(what)
    if side is not None:
        assert (tmp_path / "node" / "node-0" / side / "r" / "v-1").is_dir()


def test_cuda_is_the_default_device(tmp_path):
    cp = T.Checkpoint("c", env=T.CraftEnv.capture(_envd(tmp_path)))
    assert cp.device == "cuda" and T.IOContext().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default path runs there")
    cp.add("a", np.ones(100, np.float32))
    cp.commit()
    # no silent CPU path: the digests were asked of a card that is absent
    with pytest.raises((RuntimeError, AssertionError)):
        cp.update_and_write(1)
    cp.close()


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the package, found by walking it, imports; the walk
    must find the training slice's modules, the Lanczos app, the examples,
    the multi-process runtime, the elastic helpers, the record → replay →
    tune tooling and the sharding layer (rules, constraints, meshes, the
    dry-run's specs and CLI, the roofline, the elastic-restore example)
    among them (``tests/test_torch_examples.py`` runs each example and
    checks the same of the run)."""
    code = ("import importlib, pkgutil, sys, repro_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "need = {'repro_torch.data.pipeline', 'repro_torch.optim.adamw', "
            "'repro_torch.train.steps', 'repro_torch.launch.train', "
            "'repro_torch.kernels.flash_attention.blocked', "
            "'repro_torch.kernels.ssm_scan.backward', "
            "'repro_torch.apps.lanczos', 'repro_torch.examples.quickstart', "
            "'repro_torch.examples.nested_checkpoints', "
            "'repro_torch.examples.lanczos_aft', "
            "'repro_torch.examples.train_with_failures', "
            "'repro_torch.runtime.cluster', "
            "'repro_torch.runtime.coordinator', "
            "'repro_torch.runtime.worker', 'repro_torch.core.elastic', "
            "'repro_torch.core.simulate', 'repro_torch.core.tune', "
            "'repro_torch.top', 'repro_torch.tune', "
            "'repro_torch.sharding.logical', "
            "'repro_torch.sharding.activations', "
            "'repro_torch.launch.mesh', 'repro_torch.launch.specs', "
            "'repro_torch.launch.dryrun', 'repro_torch.analysis.roofline', "
            "'repro_torch.examples.elastic_restore'}; "
            "missing = sorted(need - set(mods)); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(len(mods), bad, missing); "
            "sys.exit(1 if bad or missing or len(mods) < 98 else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
