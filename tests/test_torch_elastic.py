"""The port's elastic helpers (``repro_torch.core.elastic``) against the
reference's (``repro.core.elastic``): ``block_index`` on a grid of shapes,
ranks and axes, and ``hydrate_replacement`` in the reference's scenario
(``tests/test_comm_aft.py``): ranks 2 and 3 of 4 die under NON-SHRINKING
recovery over ``mem,pfs``, and the spawned replacements restore their
blocks from the survivors' RAM replicas, run on each package's SimWorld.
"""
import time

import numpy as np
import pytest

import repro.core as R
from repro.core import elastic as ref_elastic
from repro.core.aft import aft_zone as ref_aft_zone
from repro.core.comm_sim import SimWorld as RefSimWorld

import repro_torch.core as T
from repro_torch.core import elastic
from repro_torch.core.aft import aft_zone
from repro_torch.core.comm_sim import SimWorld
from repro_torch.core.mem_level import MemFabric


@pytest.fixture(autouse=True)
def _port_mem_fabric_isolation():
    MemFabric.instance().reset()
    yield
    MemFabric.instance().reset()


SHAPES = [(), (7,), (12,), (13, 5), (5, 13), (3, 4, 6), (1, 9)]
# every axis 0 and 1 that the shape has (a 0-d array is whole on every rank)
CASES = [(s, a) for s in SHAPES for a in (0, 1) if a < max(len(s), 1)]


@pytest.mark.parametrize("shape,axis", CASES, ids=str)
@pytest.mark.parametrize("size", range(1, 8))
def test_block_index_matches_reference(shape, size, axis):
    got = [elastic.block_index(shape, r, size, axis) for r in range(size)]
    want = [ref_elastic.block_index(shape, r, size, axis)
            for r in range(size)]
    assert got == want
    if shape:
        # the blocks tile the axis without gaps or overlaps
        spans = [b[axis] for b in got]
        assert spans[0].start == 0 and spans[-1].stop == shape[axis]
        assert all(a.stop == b.start for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("shape,rank,size,axis", [
    ((4, 4), 0, 2, 2), ((4,), 0, 2, -1), ((4,), 2, 2, 0), ((4,), -1, 2, 0),
    ((4,), 0, 0, 0),
])
def test_block_index_rejects_what_the_reference_rejects(shape, rank, size,
                                                        axis):
    with pytest.raises(ValueError) as ref_exc:
        ref_elastic.block_index(shape, rank, size, axis)
    with pytest.raises(ValueError) as exc:
        elastic.block_index(shape, rank, size, axis)
    assert str(exc.value) == str(ref_exc.value)


def _hydration_run(pkg, tmp_path):
    """The reference's NON-SHRINKING hydration scenario on one package;
    returns {rank: what hydrate_replacement returned, plus the PFS reads
    and whether the block came back} for the replacements."""
    if pkg == "port":
        core, world_cls, zone, el = T, SimWorld, aft_zone, elastic

        def checkpoint(name, comm, env):
            return T.Checkpoint(name, comm, env=env, device="cpu")
    else:
        core, world_cls, zone, el = R, RefSimWorld, ref_aft_zone, ref_elastic

        def checkpoint(name, comm, env):
            return R.Checkpoint(name, comm, env=env)
    src = np.arange(13 * 5, dtype=np.float32).reshape(13, 5) + 1.5
    env = core.CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path / "pfs"),
        "CRAFT_TIER_CHAIN": "mem,pfs",
        "CRAFT_MEM_REPLICAS": "2",
        "CRAFT_MEM_SCRATCH": str(tmp_path / "shm"),
        "CRAFT_USE_SCR": "0",
        "CRAFT_IO_WORKERS": "1",
    })
    world = world_cls(4, spare_nodes=2, env=env)
    hydrated = {}

    def body(comm):
        cp = checkpoint("state", comm, env)
        it = core.Box(0)
        idx = el.block_index(src.shape, comm.rank, comm.size)
        wbox = core.Box(np.zeros_like(src[idx]))
        cp.add("it", it)
        cp.add("w", core.ShardCp(wbox, src.shape, idx))
        cp.commit()
        if comm.is_replacement():
            info = el.hydrate_replacement(cp)
            info["pfs_reads"] = cp.stats["tier_reads"].get("pfs", 0)
            info["block_ok"] = np.array_equal(wbox.value, src[idx])
            hydrated[comm.rank] = info
        else:
            cp.restart_if_needed()
        while it.value < 5:
            it.value += 1
            np.copyto(wbox.value, src[idx])
            cp.update_and_write()
            if comm.rank == 0 and comm.epoch == 0 and it.value == 2:
                world.kill(2)
                world.kill(3)
            comm.barrier()
            time.sleep(0.002)
        cp.close()
        return ("done", comm.size)

    out = world.run(lambda c: zone(c, body, env=env), timeout=180)
    assert all(v == ("done", 4) for v in out.values())
    return hydrated


def test_hydrate_replacement_matches_reference(tmp_path):
    port = _hydration_run("port", tmp_path / "port")
    ref = _hydration_run("ref", tmp_path / "ref")
    assert sorted(port) == sorted(ref) == [2, 3]
    assert port == ref
    for info in port.values():
        assert info["restored"] and info["tier"] == "mem"
        assert info["pfs_reads"] == 0 and info["block_ok"]
