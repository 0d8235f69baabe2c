"""Incremental chunk-delta checkpointing (codec v2, CRAFT_DELTA=1) on the
port: the reference's ``tests/test_delta.py`` run against ``repro_torch``
on the CPU, plus delta chains that cross packages.

Covers the delta write path (refs for clean chunks, byte savings), the
chain-aware restore (bit-identical to a full-codec restore, including across
mem→node→pfs tier failover), base-version pinning in retention, compaction
at CRAFT_DELTA_MAX_CHAIN, the cross-codec version matrix (v0/v1/v2 written
in any order), and the explicit errors for broken chains.  The reference's
check that its root benchmark registers the delta scenario has no mirror:
that benchmark folder is not ported.
"""
import json
import shutil

import numpy as np
import pytest

import repro.core as ref_core
from repro_torch.core import Box, MemFabric
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core import storage, tiers
from repro_torch.core.cpbase import CheckpointError, IOContext
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemStore


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


class FakeComm:
    """Single-process stand-in: rank r of n, one rank per node."""

    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    @property
    def rank(self):
        return self._rank

    @property
    def size(self):
        return self._size

    def node_id(self):
        return self._rank

    def procs_per_node(self):
        return 1

    def barrier(self, channel="main"):
        pass

    def allreduce(self, v, op="sum", channel="main"):
        return v

    def allreduce_min(self, v):
        return v

    def bcast(self, v, root=0, channel="main"):
        return v


CHUNK = 64          # tiny chunks so a few hundred bytes span many chunks


def _env(tmp_path, **extra):
    base = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_DELTA": "1",
        "CRAFT_CHUNK_BYTES": str(CHUNK),
        "CRAFT_KEEP_VERSIONS": "8",
    }
    base.update(extra)
    return CraftEnv.capture(base)


def _header(path):
    raw = path.read_bytes()
    hlen = int.from_bytes(raw[4:12], "little")
    return json.loads(raw[12:12 + hlen])


def _refs(path):
    return [c["ref"] for c in _header(path)["chunks"] if "ref" in c]


def _tree_bytes(root):
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def _write_versions(env, name, payloads, key="a"):
    """Write one version per payload (in-place mutation of a live array)."""
    arr = payloads[0].copy()
    cp = Checkpoint(name, env=env)
    cp.add(key, arr)
    cp.commit()
    for p in payloads:
        arr[...] = p
        cp.update_and_write()
    cp.close()
    return cp


def _restore(env, name, shape, dtype=np.uint8, key="a"):
    arr = np.zeros(shape, dtype=dtype)
    cp = Checkpoint(name, env=env)
    cp.add(key, arr)
    cp.commit()
    assert cp.restart_if_needed()
    cp.close()
    return arr, cp


class TestDeltaWrite:
    def test_clean_chunks_become_refs(self, tmp_path, rng):
        env = _env(tmp_path)
        base = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        v2 = base.copy()
        v2[0] ^= 0xFF          # dirty only the first chunk
        cp = _write_versions(env, "d", [base, v2])
        f = env.cp_path / "d" / "v-2" / "a" / "array.bin"
        header = _header(f)
        assert header["fmt"] == 2
        kinds = ["ref" if "ref" in c else "lit" for c in header["chunks"]]
        assert kinds == ["lit", "ref", "ref", "ref"]
        assert _refs(f) == [1, 1, 1]
        assert cp.stats["delta_chunks_skipped"] == 3

    def test_delta_bytes_at_10pct_dirty_are_5x_smaller(self, tmp_path, rng):
        """The acceptance bar: ≤10% dirty chunks ⇒ ≥5x fewer bytes written.

        Uses chunks big enough that payload dominates the per-chunk header
        entries, as in any realistic configuration (the default is 4 MiB)."""
        chunk, n_chunks = 4096, 40
        base = rng.integers(0, 255, n_chunks * chunk, dtype=np.uint8)
        dirty = base.copy()
        for c in range(4):                   # 10% of 40 chunks
            dirty[c * 10 * chunk] ^= 0xFF
        env = _env(tmp_path, CRAFT_CHUNK_BYTES=str(chunk))
        _write_versions(env, "d", [base, dirty])
        root = env.cp_path / "d"
        full_b = _tree_bytes(root / "v-1")
        delta_b = _tree_bytes(root / "v-2")
        assert full_b >= 5 * delta_b, (full_b, delta_b)

    def test_all_dirty_writes_no_refs(self, tmp_path, rng):
        env = _env(tmp_path)
        a = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        b = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        _write_versions(env, "d", [a, b])
        f = env.cp_path / "d" / "v-2" / "a" / "array.bin"
        assert _refs(f) == []
        deps = json.loads(
            (env.cp_path / "d" / "v-2" / "deltadeps-0.json").read_text())
        assert deps["deps"] == []            # self-contained, nothing pinned

    def test_shape_change_falls_back_to_full(self, tmp_path, rng):
        env = _env(tmp_path)
        arr = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        box = Box({"w": arr})
        cp = Checkpoint("d", env=env)
        cp.add("s", box)
        cp.commit()
        cp.update_and_write()
        box.value = {"w": rng.integers(0, 255, 6 * CHUNK, dtype=np.uint8)}
        cp.update_and_write()                # regridded — must not delta
        cp.close()
        leaf = next((env.cp_path / "d" / "v-2" / "s").glob("leaf*.bin"))
        assert _refs(leaf) == []


class TestDeltaRestore:
    def test_chain_restore_bit_identical(self, tmp_path, rng):
        env = _env(tmp_path)
        payloads = [rng.integers(0, 255, 6 * CHUNK, dtype=np.uint8)]
        for v in range(2):                   # two deltas on top of the full
            p = payloads[-1].copy()
            p[v * CHUNK] ^= 0xFF
            payloads.append(p)
        _write_versions(env, "d", payloads)
        f = env.cp_path / "d" / "v-3" / "a" / "array.bin"
        assert _refs(f)                      # head really is a delta
        restored, cp = _restore(env, "d", payloads[-1].shape)
        assert cp.version == 3
        assert restored.tobytes() == payloads[-1].tobytes()

    def test_delta_restore_equals_full_codec_restore(self, tmp_path, rng):
        """The same logical state, written delta and written full, restores
        to byte-identical content."""
        payloads = [rng.integers(0, 255, 6 * CHUNK, dtype=np.uint8)]
        p = payloads[0].copy()
        p[2 * CHUNK + 7] ^= 0x55
        payloads.append(p)
        env_d = _env(tmp_path, CRAFT_CP_PATH=str(tmp_path / "pfs_d"))
        env_f = _env(tmp_path, CRAFT_CP_PATH=str(tmp_path / "pfs_f"),
                     CRAFT_DELTA="0", CRAFT_CODEC_VERSION="1")
        _write_versions(env_d, "d", payloads)
        _write_versions(env_f, "d", payloads)
        a_d, _ = _restore(env_d, "d", payloads[-1].shape)
        a_f, _ = _restore(env_f, "d", payloads[-1].shape)
        assert a_d.tobytes() == a_f.tobytes()

    def test_missing_base_is_explicit_checkpoint_error(self, tmp_path, rng):
        env = _env(tmp_path)
        base = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        v2 = base.copy()
        v2[0] ^= 1
        _write_versions(env, "d", [base, v2])
        root = env.cp_path / "d"
        shutil.rmtree(root / "v-1")          # break the chain behind retire
        arr = np.zeros(base.shape, dtype=np.uint8)
        cp = Checkpoint("d", env=env)
        cp.add("a", arr)
        cp.commit()
        # agreement sees the broken chain and refuses v-2; nothing else is
        # restorable so this is a clean "no checkpoint" start, not a crash
        assert not cp.restart_if_needed()
        cp.close()

    def test_raw_reader_without_chain_raises_explicitly(self, tmp_path, rng):
        env = _env(tmp_path)
        base = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        v2 = base.copy()
        v2[0] ^= 1
        _write_versions(env, "d", [base, v2])
        f = env.cp_path / "d" / "v-2" / "a" / "array.bin"
        with pytest.raises(CheckpointError, match="delta ref|base"):
            storage.read_array(f, IOContext(device="cpu"))


class TestCrossCodecMatrix:
    """State written v0/v1/v2 in any order restores correctly."""

    @pytest.mark.parametrize("order", [
        ("0", "1", "2"), ("2", "1", "0"), ("1", "2", "0"),
        ("0", "2", "2"), ("2", "0", "2"), ("2", "2", "2"),
    ])
    def test_mixed_codec_versions(self, tmp_path, rng, order):
        shape = (6 * CHUNK,)
        state = rng.integers(0, 255, shape, dtype=np.uint8)
        expected = None
        for i, codec in enumerate(order):
            env = _env(tmp_path, CRAFT_CODEC_VERSION=codec,
                       CRAFT_DELTA="1" if codec == "2" else "0")
            arr = np.zeros(shape, dtype=np.uint8)
            cp = Checkpoint("mx", env=env)
            cp.add("a", arr)
            cp.commit()
            if i:
                assert cp.restart_if_needed()
                assert arr.tobytes() == expected
            arr[...] = state
            arr[i * CHUNK] ^= 0xFF           # mutate a different chunk each time
            expected = arr.tobytes()
            cp.update_and_write()
            cp.close()
        final, _ = _restore(_env(tmp_path), "mx", shape)
        assert final.tobytes() == expected


class TestCompaction:
    def test_full_rewrite_at_max_chain(self, tmp_path, rng):
        env = _env(tmp_path, CRAFT_DELTA_MAX_CHAIN="3")
        arr = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        cp = Checkpoint("d", env=env)
        cp.add("a", arr)
        cp.commit()
        for v in range(1, 8):
            arr[0] = v
            cp.update_and_write()
        cp.close()
        root = env.cp_path / "d"
        deps = {
            p.parent.name: json.loads(p.read_text())["deps"]
            for p in root.glob("v-*/deltadeps-0.json")
        }
        # chain of 3 (full, delta, delta), then compaction restarts it
        assert deps["v-1"] == [] and deps["v-4"] == [] and deps["v-7"] == []
        assert deps["v-2"] == [1] and deps["v-3"] == [1, 2]
        assert cp.stats["delta_compactions"] >= 2
        restored, cp2 = _restore(env, "d", arr.shape)
        assert cp2.version == 7
        assert restored.tobytes() == arr.tobytes()


class TestPinning:
    def test_retire_never_drops_referenced_bases(self, tmp_path, rng):
        env = _env(tmp_path, CRAFT_KEEP_VERSIONS="2",
                   CRAFT_DELTA_MAX_CHAIN="8")
        arr = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        cp = Checkpoint("d", env=env)
        cp.add("a", arr)
        cp.commit()
        for v in range(1, 6):
            arr[0] = v
            cp.update_and_write()
        cp.close()
        root = env.cp_path / "d"
        kept = sorted(int(p.name[2:]) for p in root.glob("v-*"))
        # v-5's chain reaches all the way to the full v-1: everything pinned
        assert kept == [1, 2, 3, 4, 5]
        meta = json.loads((root / "meta.json").read_text())
        assert meta["versions"] == kept      # metadata advertises pinned dirs
        restored, _ = _restore(env, "d", arr.shape)
        assert restored[0] == 5

    def test_unpinned_versions_still_retire(self, tmp_path, rng):
        env = _env(tmp_path, CRAFT_KEEP_VERSIONS="2",
                   CRAFT_DELTA_MAX_CHAIN="2")
        arr = rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
        cp = Checkpoint("d", env=env)
        cp.add("a", arr)
        cp.commit()
        for v in range(1, 6):                # chain resets every 2 versions
            arr[0] = v
            cp.update_and_write()
        cp.close()
        root = env.cp_path / "d"
        kept = sorted(int(p.name[2:]) for p in root.glob("v-*"))
        assert kept[-1] == 5 and len(kept) <= 3   # old chains actually gone

    def test_read_delta_deps_ignores_garbage(self, tmp_path):
        vdir = tmp_path / "v-3"
        vdir.mkdir()
        (vdir / "deltadeps-0.json").write_text('{"deps": [1, 2]}')
        (vdir / "deltadeps-1.json").write_text("not json")
        assert tiers.read_delta_deps(vdir) == {1, 2}


class TestTierFailover:
    def _env3(self, tmp_path, **extra):
        return _env(
            tmp_path,
            CRAFT_USE_SCR="1",
            CRAFT_NODE_CP_PATH=str(tmp_path / "node"),
            CRAFT_NODE_REDUNDANCY="LOCAL",
            CRAFT_TIER_CHAIN="mem,node,pfs",
            CRAFT_MEM_SCRATCH=str(tmp_path / "shm"),
            **extra,
        )

    def _chain_state(self, tmp_path, rng):
        env = self._env3(tmp_path)
        arr = rng.integers(0, 255, 6 * CHUNK, dtype=np.uint8)
        cp = Checkpoint("fo", env=env)
        cp.add("a", arr)
        cp.commit()
        cp.update_and_write()
        arr[0] ^= 1
        cp.update_and_write()                # v2 is a delta on every disk tier
        cp.close()
        return env, arr.copy()

    def test_delta_chain_restores_after_mem_then_node_loss(
            self, tmp_path, rng):
        env, expected = self._chain_state(tmp_path, rng)
        # mem alive: fastest tier serves the (decoded, full) state
        a, cp = _restore(env, "fo", expected.shape)
        assert cp.stats["restore_tier"] == "mem"
        assert a.tobytes() == expected.tobytes()
        # RAM gone: the node tier resolves the delta chain
        MemFabric.instance().reset()
        a, cp = _restore(env, "fo", expected.shape)
        assert cp.stats["restore_tier"] == "node"
        assert a.tobytes() == expected.tobytes()
        # node tier gone too: PFS resolves the same chain
        MemFabric.instance().reset()
        shutil.rmtree(tmp_path / "node")
        a, cp = _restore(env, "fo", expected.shape)
        assert cp.stats["restore_tier"] == "pfs"
        assert a.tobytes() == expected.tobytes()

    def test_mem_restore_primes_first_write_as_delta(self, tmp_path, rng):
        """After a RAM restore the diff digests come straight from the
        decoded shards — the first resumed write already skips clean
        chunks, with zero disk reads for the digest pass."""
        env, expected = self._chain_state(tmp_path, rng)
        arr = np.zeros(expected.shape, dtype=np.uint8)
        cp = Checkpoint("fo", env=env)
        cp.add("a", arr)
        cp.commit()
        assert cp.restart_if_needed()
        assert cp.stats["restore_tier"] == "mem"
        arr[CHUNK] ^= 1                      # dirty exactly one chunk
        cp.update_and_write()
        cp.close()
        assert cp.stats["delta_chunks_skipped"] > 0
        f = env.cp_path / "fo" / "v-3" / "a" / "array.bin"
        assert len(_refs(f)) == 5            # 6 chunks, 1 dirty
        # and the delta written against RAM-served digests restores exactly
        MemFabric.instance().reset()
        a, _ = _restore(env, "fo", expected.shape)
        assert a.tobytes() == arr.tobytes()

    def test_partner_mirror_recovers_whole_delta_chain(self, tmp_path, rng):
        """Losing a node must recover the delta head *and* its bases from the
        partner mirror before the chain can be decoded."""
        def env_for(rank_unused):
            return _env(
                tmp_path,
                CRAFT_USE_SCR="1",
                CRAFT_NODE_CP_PATH=str(tmp_path / "node"),
                CRAFT_NODE_REDUNDANCY="PARTNER",
                CRAFT_PFS_EVERY="100",       # node tier only
            )

        n_nodes = 2
        payload = {r: rng.integers(0, 255, 4 * CHUNK, dtype=np.uint8)
                   for r in range(n_nodes)}
        cps = {}
        for rank in range(n_nodes):
            cp = Checkpoint("pm", FakeComm(rank, n_nodes), env=env_for(rank))
            cp.add("arr", payload[rank])
            cp.commit()
            cps[rank] = cp
        for version in range(2):             # v-1 full, v-2 delta
            for rank in range(n_nodes):
                payload[rank][0] ^= 0xFF
                cps[rank].update_and_write()
        expected = payload[0].copy()
        for cp in cps.values():
            cp.close()
        f = tmp_path / "node" / "node-0" / "pm" / "v-2" / "arr" / "array.bin"
        assert _refs(f) == [1, 1, 1]
        shutil.rmtree(tmp_path / "node" / "node-0" / "pm")  # node 0 dies
        arr = np.zeros(expected.shape, dtype=np.uint8)
        cp = Checkpoint("pm", FakeComm(0, n_nodes), env=env_for(0))
        cp.add("arr", arr)
        cp.commit()
        assert cp.restart_if_needed()
        cp.close()
        assert cp.stats["restore_tier"] == "node"
        assert cp.version == 2
        assert arr.tobytes() == expected.tobytes()

    def test_mem_chunk_digests_match_codec(self, tmp_path, rng):
        env = self._env3(tmp_path)
        arr = rng.integers(0, 255, 5 * CHUNK + 13, dtype=np.uint8)
        cp = Checkpoint("cd", env=env)
        cp.add("a", arr)
        cp.commit()
        cp.update_and_write()
        cp.close()
        mem = MemStore("cd", cp.comm, env, device="cpu")
        served = mem.chunk_digests(1, CHUNK)
        assert served is not None and "a/array.bin" in served
        f = env.cp_path / "cd" / "v-1" / "a" / "array.bin"
        header = _header(f)
        assert served["a/array.bin"]["rdigests"] == [
            c["rdigest"] for c in header["chunks"]]


# --------------------------------------------------------- across packages
def _pkg(which):
    if which == "port":
        return Checkpoint, CraftEnv
    return ref_core.Checkpoint, ref_core.CraftEnv


def _pkg_env(which, tmp_path, **extra):
    base = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_DELTA": "1",
        "CRAFT_CHUNK_BYTES": str(CHUNK),
        "CRAFT_KEEP_VERSIONS": "8",
    }
    base.update(extra)
    return _pkg(which)[1].capture(base)


def _chain(rng, n):
    """``n`` payloads: a full one, then one dirty chunk more each."""
    payloads = [rng.integers(0, 255, 6 * CHUNK, dtype=np.uint8)]
    for v in range(1, n):
        p = payloads[-1].copy()
        p[(v % 6) * CHUNK + v] ^= 0xFF
        payloads.append(p)
    return payloads


def _pkg_write(which, env, name, payloads):
    mk = _pkg(which)[0]
    arr = payloads[0].copy()
    cp = mk(name, env=env)
    cp.add("a", arr)
    cp.commit()
    for p in payloads:
        arr[...] = p
        cp.update_and_write()
    cp.close()
    return cp


def _pkg_restore(which, env, name, shape):
    mk = _pkg(which)[0]
    arr = np.zeros(shape, dtype=np.uint8)
    cp = mk(name, env=env)
    cp.add("a", arr)
    cp.commit()
    assert cp.restart_if_needed()
    cp.close()
    return arr, cp


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_delta_chain_restores_across_packages(tmp_path, rng, writer, reader):
    payloads = _chain(rng, 3)
    _pkg_write(writer, _pkg_env(writer, tmp_path), "d", payloads)
    assert _refs(tmp_path / "pfs" / "d/v-3/a/array.bin")
    out, cp = _pkg_restore(reader, _pkg_env(reader, tmp_path), "d",
                           payloads[-1].shape)
    assert cp.version == 3
    assert out.tobytes() == payloads[-1].tobytes()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_compacted_chain_continues_across_packages(tmp_path, rng, writer,
                                                   reader):
    """A chain compacted at ``CRAFT_DELTA_MAX_CHAIN`` restores in the other
    package, which writes its next version as a delta on the first
    package's versions; the first package then restores that version."""
    payloads = _chain(rng, 7)
    _pkg_write(writer, _pkg_env(writer, tmp_path,
                                CRAFT_DELTA_MAX_CHAIN="3"), "d", payloads)
    root = tmp_path / "pfs" / "d"
    deps = {p.parent.name: json.loads(p.read_text())["deps"]
            for p in root.glob("v-*/deltadeps-0.json")}
    assert deps["v-4"] == [] and deps["v-7"] == []   # compactions
    assert deps["v-5"] == [4] and deps["v-6"] == [4, 5]
    mk = _pkg(reader)[0]
    arr = np.zeros(payloads[-1].shape, dtype=np.uint8)
    cp = mk("d", env=_pkg_env(reader, tmp_path, CRAFT_DELTA_MAX_CHAIN="3"))
    cp.add("a", arr)
    cp.commit()
    assert cp.restart_if_needed()
    assert cp.version == 7
    assert arr.tobytes() == payloads[-1].tobytes()
    arr[CHUNK] ^= 0x0F
    cp.update_and_write()                    # v-8: a delta on v-7
    expect = arr.copy()
    cp.close()
    assert cp.stats["delta_chunks_skipped"] == 5
    assert _refs(root / "v-8" / "a" / "array.bin") == [7] * 5
    out, cp2 = _pkg_restore(writer, _pkg_env(writer, tmp_path), "d",
                            expect.shape)
    assert cp2.version == 8
    assert out.tobytes() == expect.tobytes()
