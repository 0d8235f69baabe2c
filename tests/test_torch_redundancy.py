"""The port's node-tier XOR and RS redundancy against the reference package.

The scenarios of the reference's ``test_node_level.py`` (XOR) and
``test_rs_erasure.py`` (RS node tier) run against ``repro_torch`` on the
CPU, and the two packages are held against each other: the same member
trees give byte-identical parity and manifest files, and a group written
by either package, with members deleted, rebuilds bit-identically in the
other (1 lost member under XOR, 2 under RS).
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.comm_sim import SimWorld as RefSimWorld

import repro_torch.core as T
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.node_level import NodeStore
from repro_torch.core.scrubber import corrupt_file

from test_node_level import FakeComm

PKG = {"ref": (R, RefSimWorld), "port": (T, SimWorld)}


def _env(mod, tmp_path, redundancy, m=2, pfs_every=100, **extra):
    return mod.CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_NODE_REDUNDANCY": redundancy,
        "CRAFT_XOR_GROUP_SIZE": "4",
        "CRAFT_RS_PARITY": str(m),
        "CRAFT_PFS_EVERY": str(pfs_every),
        **{k: str(v) for k, v in extra.items()},
    })


def _cp(mod, name, comm, env):
    if mod is T:
        return T.Checkpoint(name, comm, env=env, device="cpu")
    return R.Checkpoint(name, comm, env=env)


def _member(rank, version=1):
    """Rank r's array: unequal lengths, so the parity zero-pads."""
    rng = np.random.default_rng(10 * rank + version)
    return rng.standard_normal(200 + 37 * rank).astype(np.float32)


def _write_group(pkg, tmp_path, redundancy, versions=1, n=4, **extra):
    """Every rank writes through the package's SimWorld, so the publish
    barriers are real and every parity holder encodes the whole group."""
    mod, world_cls = PKG[pkg]
    env = _env(mod, tmp_path, redundancy, **extra)
    world = world_cls(n, procs_per_node=1, env=env)

    def fn(comm):
        arr = _member(comm.rank).copy()
        cp = _cp(mod, "st", comm, env)
        cp.add("arr", arr)
        cp.commit()
        for v in range(1, versions + 1):
            arr[...] = _member(comm.rank, v)
            cp.update_and_write()
        cp.close()

    world.run(fn, timeout=120)
    return env


def _read(pkg, tmp_path, redundancy, rank, version=1, n=4, **extra):
    mod, _ = PKG[pkg]
    env = _env(mod, tmp_path, redundancy, **extra)
    arr = np.zeros_like(_member(rank))
    cp = _cp(mod, "st", FakeComm(rank, n), env)
    cp.add("arr", arr)
    cp.commit()
    assert cp.restart_if_needed()
    tier = cp.stats["restore_tier"]
    cp.close()
    return arr, tier


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------- the two packages
@pytest.mark.parametrize("redundancy,side", [("XOR", "xor-group-0"),
                                             ("RS", "rs-group-0")])
def test_parity_and_manifest_files_byte_identical(tmp_path, redundancy, side):
    for pkg in PKG:
        _write_group(pkg, tmp_path / pkg, redundancy, versions=2,
                     CRAFT_KEEP_VERSIONS=2)
    ref = _tree(tmp_path / "ref" / "node")
    port = _tree(tmp_path / "port" / "node")
    parity = [k for k in ref if f"/{side}/" in k]
    assert len(parity) >= 4 and any(k.endswith("manifest.json")
                                    for k in parity)
    assert sorted(port) == sorted(ref)
    for rel in ref:
        assert port[rel] == ref[rel], rel


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("redundancy,lost", [("XOR", (1,)), ("RS", (0, 3))])
def test_group_rebuilds_in_the_other_package(tmp_path, writer, reader,
                                             redundancy, lost):
    _write_group(writer, tmp_path, redundancy)
    for n in lost:
        shutil.rmtree(tmp_path / "node" / f"node-{n}" / "st")
    for n in lost:
        arr, tier = _read(reader, tmp_path, redundancy, n)
        assert tier == "node"
        assert arr.tobytes() == _member(n).tobytes()
        rebuilt = tmp_path / "node" / f"node-{n}" / "st" / "v-1"
        assert rebuilt.is_dir()


@pytest.mark.parametrize("redundancy,lost", [("XOR", (2,)), ("RS", (1, 2))])
def test_rebuilt_member_tree_equals_the_lost_one(tmp_path, redundancy, lost):
    _write_group("port", tmp_path, redundancy)
    before = {n: _tree(tmp_path / "node" / f"node-{n}" / "st" / "v-1")
              for n in lost}
    for n in lost:
        shutil.rmtree(tmp_path / "node" / f"node-{n}" / "st")
    env = _env(T, tmp_path, redundancy)
    for n in lost:
        store = NodeStore(base=env.node_cp_path, name="st",
                          comm=FakeComm(n, 4), env=env, device="cpu")
        vdir = store.materialize(1)
        assert _tree(vdir) == before[n]


# ------------------------------------------------------- XOR (node_level)
@pytest.mark.parametrize("redundancy", ["LOCAL", "PARTNER", "XOR"])
def test_node_tier_roundtrip(tmp_path, redundancy):
    _write_group("port", tmp_path, redundancy)
    for rank in range(4):
        arr, tier = _read("port", tmp_path, redundancy, rank)
        assert tier == "node" and np.array_equal(arr, _member(rank))


def test_xor_two_losses_in_group_fail_over_to_pfs(tmp_path):
    env = _env(T, tmp_path, "XOR", pfs_every=1)
    for rank in range(4):
        cp = _cp(T, "st", FakeComm(rank, 4), env)
        cp.add("arr", np.full((8,), 5.0))       # rank-replicated on the pfs
        cp.commit()
        cp.update_and_write()
        cp.close()
    for n in (0, 1):
        shutil.rmtree(tmp_path / "node" / f"node-{n}" / "st")
    arr = np.zeros((8,))
    cp = _cp(T, "st", FakeComm(0, 4), env)
    cp.add("arr", arr)
    cp.commit()
    assert cp.restart_if_needed()
    assert cp.stats["restore_tier"] == "pfs" and np.all(arr == 5.0)


def test_xor_stale_survivor_refuses_to_rebuild(tmp_path):
    _write_group("port", tmp_path, "XOR")
    corrupt_file(tmp_path / "node" / "node-2" / "st" / "v-1" / "arr"
                 / "array.bin")
    shutil.rmtree(tmp_path / "node" / "node-1" / "st")
    env = _env(T, tmp_path, "XOR")
    store = NodeStore(base=env.node_cp_path, name="st", comm=FakeComm(1, 4),
                      env=env, device="cpu")
    with pytest.raises(T.CheckpointError, match="survivor"):
        store.materialize(1)


def test_xor_latest_version_from_parity_manifest(tmp_path):
    _write_group("port", tmp_path, "XOR", versions=2, CRAFT_KEEP_VERSIONS=2)
    shutil.rmtree(tmp_path / "node" / "node-3" / "st")
    env = _env(T, tmp_path, "XOR", CRAFT_KEEP_VERSIONS=2)
    store = NodeStore(base=env.node_cp_path, name="st", comm=FakeComm(3, 4),
                      env=env, device="cpu")
    assert store.latest_version() == 2
    arr, tier = _read("port", tmp_path, "XOR", 3, CRAFT_KEEP_VERSIONS=2)
    assert arr.tobytes() == _member(3, 2).tobytes()


# ------------------------------------------------------- RS node tier
def test_rs_rotating_parity_placement(tmp_path):
    _write_group("port", tmp_path, "RS", versions=2, CRAFT_KEEP_VERSIONS=3)
    holders = {
        v: sorted(int(p.parents[3].name.split("-")[1])
                  for p in (tmp_path / "node").glob(
                      f"node-*/rs-group-0/st/v-{v}/parity-*.bin"))
        for v in (1, 2)
    }
    assert holders == {1: [1, 2], 2: [2, 3]}


def test_rs_losses_beyond_m_raise_without_pfs(tmp_path):
    _write_group("port", tmp_path, "RS")
    for n in (0, 1, 2):
        shutil.rmtree(tmp_path / "node" / f"node-{n}" / "st")
    env = _env(T, tmp_path, "RS")
    arr = np.zeros_like(_member(0))
    cp = _cp(T, "st", FakeComm(0, 4), env)
    cp.add("arr", arr)
    cp.commit()
    with pytest.raises(T.CheckpointError, match="parity"):
        cp.restart_if_needed()
    assert not arr.any()                       # never partially overwritten


def test_rs_stale_survivor_counts_as_lost(tmp_path):
    _write_group("port", tmp_path, "RS")
    corrupt_file(tmp_path / "node" / "node-1" / "st" / "v-1" / "arr"
                 / "array.bin")
    shutil.rmtree(tmp_path / "node" / "node-2" / "st")
    arr, _ = _read("port", tmp_path, "RS", 2)
    assert arr.tobytes() == _member(2).tobytes()


def test_rs_rotted_parity_shard_not_used(tmp_path):
    """A parity shard that fails its manifest digest is lost, not solved
    with: one good row still rebuilds one lost member."""
    _write_group("port", tmp_path, "RS")
    shard = next((tmp_path / "node").glob("node-*/rs-group-0/st/v-1/"
                                          "parity-0.bin"))
    corrupt_file(shard, offset=3)
    shutil.rmtree(tmp_path / "node" / "node-0" / "st")
    arr, _ = _read("port", tmp_path, "RS", 0)
    assert arr.tobytes() == _member(0).tobytes()


def test_rs_invalidate_drops_parity_trees(tmp_path):
    env = _write_group("port", tmp_path, "RS")
    cp = _cp(T, "st", FakeComm(0, 4), env)
    cp.add("arr", np.zeros(4))
    cp.commit()
    cp.invalidate()
    assert not list((tmp_path / "node").glob("node-*/rs-group-0/st/v-*"))


def test_bf16_tensor_state_rebuilds_through_rs(tmp_path):
    """Rank-private bf16 state dicts (a pipeline stage each) lose two nodes
    and come back through the RS rebuild bit for bit."""
    env = _env(T, tmp_path, "RS")

    def state(rank):
        g = torch.Generator().manual_seed(rank)
        return {f"layer{rank}.{k}": torch.randn(
            (17 + rank, 9), generator=g).to(torch.bfloat16)
            for k in ("w", "b")}

    def fn(comm):
        cp = T.Checkpoint("bf", comm, env=env, device="cpu")
        cp.add(f"stage-{comm.rank}", T.Box(state(comm.rank)))
        cp.commit()
        cp.update_and_write()
        cp.close()

    SimWorld(4, procs_per_node=1, env=env).run(fn, timeout=120)
    for n in (0, 3):        # v-1's parity rows live on nodes 1 and 2
        shutil.rmtree(tmp_path / "node" / f"node-{n}")
    for n in (0, 3):
        live = {k: torch.zeros_like(v) for k, v in state(n).items()}
        cp = T.Checkpoint("bf", FakeComm(n, 4), env=env, device="cpu")
        cp.add(f"stage-{n}", T.Box(live))
        cp.commit()
        assert cp.restart_if_needed()
        assert cp.stats["restore_tier"] == "node"
        cp.close()
        assert all(torch.equal(live[k], v) for k, v in state(n).items())
