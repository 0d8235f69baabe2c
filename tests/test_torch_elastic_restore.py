"""Elastic reshard-on-restore on the port: the reference's cross-topology
restore matrix (``tests/test_elastic_restore.py``) run on
``repro_torch``'s ``ShardCp``, and checkpoints that cross packages: N port
ranks write, M reference ranks restore bit-exactly, and the other way round.

A checkpoint written on N ranks must restore bit-identically onto M != N
ranks, across the three array codecs and the three tiers, each restoring
rank assembling its own block extent (``elastic.block_index``) from the
writers' per-rank chunk grids.  Edge leaves ride along on every topology:
0-d scalars (replicated), empty arrays, unaligned multi-chunk grids, and
bfloat16.  The port holds bfloat16 on the host as its uint16 bits (it needs
no ``ml_dtypes``), so a port restore compares bytes and returns uint16.

All ranks run in one process through ``FakeComm``: ranks write one after
another into shared storage, as SPMD processes would, then another number
of ranks restores.  The port's checkpoints run on the CPU.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.elastic import block_index as ref_block_index

import repro_torch.core as T
from repro_torch.core.checkpointables import NdArrayCp
from repro_torch.core.elastic import block_index
from repro_torch.core.mem_level import MemFabric

from tests.test_torch_mem_level import FakeComm

_W = (np.arange(19 * 7, dtype=np.float32).reshape(19, 7) * 0.5 + 3.25)
_BF16 = np.linspace(-4.0, 4.0, 33).astype(ml_dtypes.bfloat16)
_SCALAR = np.float64(1234.5678)
_EMPTY = np.empty((0,), dtype=np.float32)


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    """The port's RAM fabric is process-global (conftest resets only the
    reference's): wipe it around every test."""
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


def _port_checkpoint(name, comm, env):
    return T.Checkpoint(name, comm, env=env, device="cpu")


# each package's (Checkpoint, Box, ShardCp, CraftEnv, block_index)
PKG = {
    "port": (_port_checkpoint, T.Box, T.ShardCp, T.CraftEnv, block_index),
    "ref": (R.Checkpoint, R.Box, R.ShardCp, R.CraftEnv, ref_block_index),
}


def _env(tmp_path, pkg="port", **extra):
    base = {
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
        "CRAFT_NODE_REDUNDANCY": "LOCAL",
        "CRAFT_TIER_CHAIN": "pfs",
        "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
        "CRAFT_CHUNK_BYTES": "64",       # multi-chunk, unaligned grids
        "CRAFT_IO_WORKERS": "1",
    }
    base.update(extra)
    return PKG[pkg][3].capture(base)


def _build_cp(rank, size, env, zero=False, pkg="port"):
    checkpoint, box, shard_cp, _, bidx = PKG[pkg]
    cp = checkpoint("elastic", FakeComm(rank, size), env)
    boxes = {}
    for key, src in (("w", _W), ("bf16", _BF16), ("empty", _EMPTY)):
        idx = bidx(src.shape, rank, size)
        block = src[idx].copy()
        boxes[key] = box(np.zeros_like(block) if zero else block)
        cp.add(key, shard_cp(boxes[key], src.shape, idx))
    boxes["scalar"] = box(np.asarray(0.0 if zero else _SCALAR))
    cp.add("scalar", shard_cp(boxes["scalar"], (), ()))
    boxes["it"] = box(0 if zero else 7)
    cp.add("it", boxes["it"])
    cp.commit()
    return cp, boxes


# Sequential-rank idiom for the shared-staging pfs tier: construct every
# rank's Checkpoint before anyone writes (rank 0's store sweeps stale .tmp
# dirs), then write rank 0 last: its publish() moves the shared staged dir
# holding every rank's files.
def _ranks_last_leader(n):
    return list(range(1, n)) + [0]


def _write_topology(n, env, pkg="port"):
    cps = [_build_cp(rank, n, env, pkg=pkg) for rank in range(n)]
    for rank in _ranks_last_leader(n):
        assert cps[rank][0].update_and_write()
    for cp, _ in cps:
        cp.close()


def _same_block(got, src, pkg):
    got = np.asarray(got)
    want = (np.dtype(np.uint16) if pkg == "port" and src.dtype == _BF16.dtype
            else src.dtype)
    return got.dtype == want and got.tobytes() == src.tobytes()


def _restore_and_check(m, env, expect_tier=None, pkg="port"):
    for rank in range(m):
        cp, boxes = _build_cp(rank, m, env, zero=True, pkg=pkg)
        assert cp.restart_if_needed()
        if expect_tier is not None:
            assert cp.stats["restore_tier"] == expect_tier
        assert boxes["it"].value == 7
        for key, src in (("w", _W), ("bf16", _BF16), ("empty", _EMPTY)):
            idx = block_index(src.shape, rank, m)
            assert _same_block(boxes[key].value, src[idx], pkg), (key, rank)
        assert np.asarray(boxes["scalar"].value).tobytes() \
            == np.asarray(_SCALAR).tobytes()
        cp.close()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_n_to_m_restore_pfs(tmp_path, n, m):
    env = _env(tmp_path)
    _write_topology(n, env)
    _restore_and_check(m, env, expect_tier="pfs")


@pytest.mark.parametrize("codec", [0, 1, 2])
@pytest.mark.parametrize("tier", ["mem", "node", "pfs"])
def test_codec_tier_matrix(tmp_path, codec, tier):
    extra = {"CRAFT_TIER_CHAIN": tier, "CRAFT_CODEC_VERSION": str(codec)}
    if codec == 2:
        extra["CRAFT_DELTA"] = "1"
    env = _env(tmp_path, **extra)
    _write_topology(4, env)
    _restore_and_check(3, env, expect_tier=tier)


def test_grow_beyond_writers_node_tier(tmp_path):
    """M > N on the node tier: the new nodes never wrote the version; they
    seed from a peer tree and range-read the rest via aux dirs."""
    env = _env(tmp_path, CRAFT_TIER_CHAIN="node")
    _write_topology(2, env)
    _restore_and_check(4, env, expect_tier="node")


def test_delta_chain_across_three_topologies(tmp_path):
    """A v2 delta version written on topology B whose base was written on
    topology A restores on topology C: refs chase across both layouts."""
    env = _env(tmp_path, CRAFT_DELTA="1")
    rep = np.arange(64, dtype=np.float64)  # rank-replicated, delta-friendly

    def build(rank, size, live, zero_w=False):
        cp = _port_checkpoint("delta3", FakeComm(rank, size), env)
        cp.add("rep", NdArrayCp(live))
        idx = block_index(_W.shape, rank, size)
        box = T.Box(np.zeros_like(_W[idx]) if zero_w else _W[idx].copy())
        cp.add("w", T.ShardCp(box, _W.shape, idx))
        cp.commit()
        return cp, box

    # topology A (N=2): v-1, a full write including a replicated array
    cps = [build(rank, 2, rep.copy()) for rank in range(2)]
    for rank in _ranks_last_leader(2):
        assert cps[rank][0].update_and_write()
    for cp, _ in cps:
        cp.close()

    # topology B (M=3): restore v-1 (primes the delta state), write v-2:
    # the unchanged replicated array becomes all-ref chunks against v-1
    cps = [build(rank, 3, rep.copy(), zero_w=True) for rank in range(3)]
    for rank in _ranks_last_leader(3):
        cp, box = cps[rank]
        assert cp.restart_if_needed()
        np.copyto(box.value, _W[block_index(_W.shape, rank, 3)])
        assert cp.update_and_write()
        if rank == 0:
            assert cp.stats["delta_chunks_skipped"] > 0
    for cp, _ in cps:
        cp.close()

    # topology C (M'=4): restore v-2, chasing refs into topology A's v-1
    for rank in range(4):
        live = np.zeros_like(rep)
        cp, box = build(rank, 4, live, zero_w=True)
        assert cp.restart_if_needed()
        assert cp.version == 2
        assert live.tobytes() == rep.tobytes()
        assert np.asarray(box.value).tobytes() \
            == _W[block_index(_W.shape, rank, 4)].tobytes()
        cp.close()


def test_range_restore_reads_less_than_payload(tmp_path):
    """CRAFT_RESHARD=range: a rank restoring 1/4 of the global array
    physically fetches well under half of the stored payload."""
    big = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    env = _env(tmp_path, CRAFT_RESHARD="range", CRAFT_CHUNK_BYTES="256")

    def build(rank):
        idx = block_index(big.shape, rank, 4)
        cp = _port_checkpoint("big", FakeComm(rank, 4), env)
        cp.add("w", T.ShardCp(T.Box(big[idx].copy()), big.shape, idx))
        cp.commit()
        return cp

    cps = [build(rank) for rank in range(4)]
    for rank in _ranks_last_leader(4):
        assert cps[rank].update_and_write()
    for cp in cps:
        cp.close()
    idx = block_index(big.shape, 0, 4)
    box = T.Box(np.zeros_like(big[idx]))
    cp = _port_checkpoint("big", FakeComm(0, 4), env)
    cp.add("w", T.ShardCp(box, big.shape, idx))
    cp.commit()
    assert cp.restart_if_needed()
    assert np.asarray(box.value).tobytes() == big[idx].tobytes()
    assert 0 < cp.stats["restore_read_bytes"] < big.nbytes // 2
    cp.close()


def test_tensor_restore_across_topologies(tmp_path):
    """Whole-tensor manifests (the reference's single-device ``jax.Array``
    case, here a torch tensor) written by several ranks reassemble on
    another rank count (every extent is full, so coverage overlaps)."""
    src = torch.arange(40, dtype=torch.float32).reshape(8, 5)
    env = _env(tmp_path)

    def build(rank):
        cp = _port_checkpoint("tx", FakeComm(rank, 3), env)
        cp.add("x", T.Box(src.clone()))
        cp.commit()
        return cp

    cps = [build(rank) for rank in range(3)]
    for rank in _ranks_last_leader(3):
        assert cps[rank].update_and_write()
    for cp in cps:
        cp.close()
    box = T.Box(torch.zeros_like(src))
    cp = _port_checkpoint("tx", FakeComm(0, 2), env)
    cp.add("x", box)
    cp.commit()
    assert cp.restart_if_needed()
    assert torch.equal(box.value, src)
    cp.close()


def test_nested_invalidation_survives_topology_change(tmp_path):
    """A parent publish on topology A wipes the child from every node tree,
    so a later restore on topology B cannot resurrect it."""
    env = _env(tmp_path, CRAFT_TIER_CHAIN="node")
    children = []
    for rank in range(2):
        child = _port_checkpoint("inner", FakeComm(rank, 2), env)
        child.add("it", T.Box(5))
        child.commit()
        assert child.update_and_write()
        children.append(child)
    parent = _port_checkpoint("outer", FakeComm(0, 2), env)
    parent.add("o", T.Box(1))
    parent.commit()
    parent.sub_cp(children[0])
    assert parent.update_and_write()   # invalidates the child everywhere
    parent.close()
    for child in children:
        child.close()
    for rank in range(3):
        child = _port_checkpoint("inner", FakeComm(rank, 3), env)
        child.add("it", T.Box(0))
        child.commit()
        assert not child.restart_if_needed()
        child.close()


# ------------------------------------------------------- across packages
@pytest.mark.parametrize("n,m", [(1, 3), (2, 3), (4, 2), (3, 1)])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_n_to_m_across_packages(tmp_path, n, m, writer, reader):
    """N ranks of one package write; M ranks of the other restore every
    block bit-exactly."""
    _write_topology(n, _env(tmp_path, writer), pkg=writer)
    _restore_and_check(m, _env(tmp_path, reader), expect_tier="pfs",
                       pkg=reader)
