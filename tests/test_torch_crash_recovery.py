"""Crash-during-stage recovery on the port: the reference's
``tests/test_crash_recovery.py`` run against ``repro_torch`` on the CPU,
plus crashed writes swept and restored by the other package.

A torn write never loses the previous version.  Covers the atomicity
protocol (paper Fig. 4 / §2.6) across the matrix of {PFS tier, node tier}
× {codec v0, codec v1}:

* a failure raised mid-write aborts the staged directory and the previous
  complete version stays restorable;
* a hard crash (process death — staged ``.tmp-*`` dir simply abandoned) is
  swept on the next start and the previous version restores;
* ``meta.json`` never points at an incomplete version.
"""
import numpy as np
import pytest

import repro.core as ref_core
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import CpBase, MemFabric
from repro_torch.core.env import CraftEnv


def Checkpoint(*args, **kwargs):
    """The port's Checkpoint on the CPU (the tests run without a card)."""
    kwargs.setdefault("device", "cpu")
    return _Checkpoint(*args, **kwargs)


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    """The port's RAM fabric is process-global like the reference's (which
    conftest resets): wipe it around every test."""
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


def _env(tmp_path, tier, codec):
    envmap = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_CODEC_VERSION": str(codec),
    }
    if tier == "node":
        envmap["CRAFT_NODE_CP_PATH"] = str(tmp_path / "node")
    else:
        envmap["CRAFT_USE_SCR"] = "0"
    return CraftEnv.capture(envmap)


class FlakyCp(CpBase):
    """Array checkpointable that raises mid-write when armed."""

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self._buf = arr.copy()
        self.fail_next_write = False

    def update(self):
        np.copyto(self._buf, self.arr)

    def write(self, dir_path, ctx):
        from repro_torch.core import storage
        storage.write_array(dir_path / "part1.bin", self._buf[:8], ctx)
        if self.fail_next_write:
            raise OSError("injected crash mid-stage")
        storage.write_array(dir_path / "part2.bin", self._buf[8:], ctx)

    def read(self, dir_path, ctx):
        from repro_torch.core import storage
        a = storage.read_array(dir_path / "part1.bin", ctx)
        b = storage.read_array(dir_path / "part2.bin", ctx)
        self.arr[...] = np.concatenate([a, b])

    def nbytes(self):
        return self._buf.nbytes


def _write_v1(tmp_path, tier, codec, value):
    env = _env(tmp_path, tier, codec)
    arr = np.full((32,), value)
    cp = Checkpoint("cr", env=env)
    cp.add("arr", arr)
    cp.commit()
    cp.update_and_write()
    cp.close()
    return env


TIERS_CODECS = [("pfs", 0), ("pfs", 1), ("node", 0), ("node", 1)]


@pytest.mark.parametrize("tier,codec", TIERS_CODECS)
class TestInjectedFailure:
    def test_abort_keeps_previous_version(self, tmp_path, tier, codec):
        env = _env(tmp_path, tier, codec)
        arr = np.full((32,), 1.0)
        flaky = FlakyCp(arr)
        cp = Checkpoint("cr", env=env)
        cp.add("arr", flaky)
        cp.commit()
        cp.update_and_write()                      # v1 lands cleanly

        arr[...] = 2.0
        flaky.fail_next_write = True
        with pytest.raises(OSError, match="injected"):
            cp.update_and_write()                  # v2 dies mid-stage
        cp.close()

        # staged dirs were aborted — no .tmp-* garbage survives the failure
        roots = [env.cp_path / "cr"]
        if tier == "node":
            roots.append(env.node_cp_path / "node-0" / "cr")
        for root in roots:
            if root.is_dir():
                assert not list(root.glob(".tmp-*")), root

        # a fresh process restores the last complete version (v1)
        arr2 = np.zeros((32,))
        flaky2 = FlakyCp(arr2)
        cp2 = Checkpoint("cr", env=_env(tmp_path, tier, codec))
        cp2.add("arr", flaky2)
        cp2.commit()
        assert cp2.restart_if_needed()
        assert cp2.version == 1
        np.testing.assert_array_equal(arr2, np.full((32,), 1.0))

    def test_hard_crash_tmp_swept_and_previous_restored(self, tmp_path, tier,
                                                        codec):
        env = _write_v1(tmp_path, tier, codec, value=7.0)

        # simulate a process dying mid-stage: abandoned .tmp-v-2 + junk files
        if tier == "node":
            root = env.node_cp_path / "node-0" / "cr"
        else:
            root = env.cp_path / "cr"
        torn = root / ".tmp-v-2"
        torn.mkdir(parents=True)
        (torn / "arr").mkdir()
        (torn / "arr" / "array.bin").write_bytes(b"CRFT\x00garbage")

        arr = np.zeros((32,))
        cp = Checkpoint("cr", env=_env(tmp_path, tier, codec))
        cp.add("arr", arr)
        cp.commit()
        assert cp.restart_if_needed()
        assert cp.version == 1
        np.testing.assert_array_equal(arr, np.full((32,), 7.0))
        assert not torn.exists()                   # swept on start

    def test_meta_never_points_at_torn_version(self, tmp_path, tier, codec):
        env = _write_v1(tmp_path, tier, codec, value=3.0)
        from repro_torch.core import storage
        if tier == "node":
            store = storage.VersionStore(env.node_cp_path / "node-0", "cr",
                                         sweep=False)
        else:
            store = storage.VersionStore(env.cp_path, "cr", sweep=False)
        meta = store.meta()
        assert meta["latest"] == 1
        for v in meta["versions"]:
            assert store.version_dir(v).is_dir()


@pytest.mark.parametrize("codec", [0, 1])
def test_async_failure_surfaces_and_previous_survives(tmp_path, codec):
    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_WRITE_ASYNC": "1",
        "CRAFT_CODEC_VERSION": str(codec),
    })
    arr = np.full((16,), 1.0)
    flaky = FlakyCp(arr)
    cp = Checkpoint("acr", env=env)
    cp.add("arr", flaky)
    cp.commit()
    cp.update_and_write()
    cp.wait()
    flaky.fail_next_write = True
    arr[...] = 2.0
    cp.update_and_write()
    with pytest.raises(OSError, match="injected"):
        cp.wait()                                  # error surfaces at fence
    cp.close()

    arr2 = np.zeros((16,))
    cp2 = Checkpoint("acr", env=CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_CODEC_VERSION": str(codec),
    }))
    cp2.add("arr", FlakyCp(arr2))
    cp2.commit()
    assert cp2.restart_if_needed()
    assert cp2.version == 1
    np.testing.assert_array_equal(arr2, np.full((16,), 1.0))


# --------------------------------------------------------- across packages
@pytest.mark.parametrize("tier,codec", TIERS_CODECS)
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_crashed_write_is_swept_by_the_other_package(tmp_path, tier, codec,
                                                     writer):
    """One package dies at a chaos crash point inside v2's write; the other
    package's next start sweeps the staging dir and restores v1 bit for
    bit."""
    if writer == "port":
        from repro_torch.core.chaos import ChaosCrash as crash
        mk, Env = Checkpoint, CraftEnv
        rmk, REnv = ref_core.Checkpoint, ref_core.CraftEnv
    else:
        from repro.core.chaos import ChaosCrash as crash
        mk, Env = ref_core.Checkpoint, ref_core.CraftEnv
        rmk, REnv = Checkpoint, CraftEnv
    envmap = {"CRAFT_CP_PATH": str(tmp_path / "pfs"),
              "CRAFT_CODEC_VERSION": str(codec)}
    if tier == "node":
        envmap["CRAFT_NODE_CP_PATH"] = str(tmp_path / "node")
        envmap["CRAFT_PFS_EVERY"] = "100"      # versions land on node only
        root = tmp_path / "node" / "node-0" / "cr"
    else:
        envmap["CRAFT_USE_SCR"] = "0"
        root = tmp_path / "pfs" / "cr"
    rng = np.random.default_rng(7)
    arr = rng.standard_normal(64).astype(np.float32)
    cp = mk("cr", env=Env.capture({**envmap, "CRAFT_CHAOS": "on"}))
    cp.add("arr", arr)
    cp.commit()
    assert cp.update_and_write()
    expect = arr.copy()
    nxt = cp.chaos.op_count(tier, "write")
    cp.chaos.add(f"{tier}:crash:at={nxt}")   # die on the next file write
    arr[...] = 2.0
    with pytest.raises(crash):
        cp.update_and_write()
    assert list(root.glob(".tmp-*"))         # staging survives the "death"

    out = np.zeros_like(expect)
    cp2 = rmk("cr", env=REnv.capture(envmap))
    cp2.add("arr", out)
    cp2.commit()
    assert cp2.restart_if_needed()
    assert cp2.version == 1
    assert not list(root.glob(".tmp-*"))     # swept on start
    cp2.close()
    assert out.tobytes() == expect.tobytes()
