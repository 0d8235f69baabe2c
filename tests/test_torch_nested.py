"""Nested checkpoints on the port: the paper's Table 1 consistency
semantics, exactly — the reference's ``tests/test_nested.py`` run against
``repro_torch`` on the CPU, plus Table 1 with the program run by one
package and restarted by the other."""
import pytest

import repro.core as ref_core
from repro_torch.core import Box, MemFabric
from repro_torch.core import Checkpoint as _Checkpoint
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


def _mk(tmp_path):
    return CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0"})


def nested_program(env, fail_stage, mk=None, box=Box):
    """Paper Listing 7 with nL1iter=2, L1cpFreq=1, nL2iter=30, L2cpFreq=10.

    ``fail_stage`` ∈ I..V — the failure points of paper Fig. 3.  Returns the
    (CL1 versions on disk, CL2 versions on disk) snapshot at failure, i.e.
    what a restart would see.  ``mk`` and ``box`` are the package's
    ``Checkpoint`` and ``Box`` (the port's by default).
    """
    mk = mk or Checkpoint
    l1_box, l2_box = box(0), box(0)
    cl1 = mk("CL1", env=env)
    cl1.add("l1", l1_box)
    cl1.commit()
    cl2 = mk("CL2", env=env)
    cl2.add("l2", l2_box)
    cl2.commit()
    cl1.sub_cp(cl2)

    # stage I: before anything is written
    if fail_stage == "I":
        return cl1.version, cl2._pfs.latest_version()
    for l1 in range(1, 3):
        for l2 in range(1, 31):
            l2_box.value = l2
            cl2.update_and_write(l2, 10)
            if fail_stage == "II" and (l1, l2) == (1, 10):
                return cl1._pfs.latest_version(), cl2._pfs.latest_version()
            if fail_stage == "III" and (l1, l2) == (1, 20):
                return cl1._pfs.latest_version(), cl2._pfs.latest_version()
        l1_box.value = l1
        cl1.update_and_write(l1, 1)
        if fail_stage == "IV" and l1 == 1:
            return cl1._pfs.latest_version(), cl2._pfs.latest_version()
        if fail_stage == "V" and l1 == 1:
            # continue into the next outer iteration a bit
            for l2 in range(1, 11):
                l2_box.value = l2
                cl2.update_and_write(l2, 10)
            return cl1._pfs.latest_version(), cl2._pfs.latest_version()
    return cl1._pfs.latest_version(), cl2._pfs.latest_version()


# paper Table 1: stage -> the (l1, l2) state a restarted run must resume
# from.  0 means "no checkpoint read — start fresh".  Stage IV is the
# consistency trap: the stale CL2 (l2=30 of the previous outer iteration)
# must have been invalidated when CL1-v1 was published.
TABLE_1 = {
    "I": (0, 0),
    "II": (0, 10),
    "III": (0, 20),
    "IV": (1, 0),
    "V": (1, 10),
}


@pytest.mark.parametrize("stage", list(TABLE_1))
def test_table_1(tmp_path, stage):
    env = _mk(tmp_path)
    nested_program(env, stage)

    # restart: rebuild both checkpoints, read what is consistent
    l1_box, l2_box = Box(0), Box(0)
    cl1 = Checkpoint("CL1", env=env)
    cl1.add("l1", l1_box)
    cl1.commit()
    cl2 = Checkpoint("CL2", env=env)
    cl2.add("l2", l2_box)
    cl2.commit()
    cl1.sub_cp(cl2)
    cl1.restart_if_needed()
    cl2.restart_if_needed()
    assert (l1_box.value, l2_box.value) == TABLE_1[stage]


def test_restart_consistency_after_parent_write(tmp_path):
    """Stage IV end-to-end: restart must resume (l1=1, l2 fresh), never the
    stale CL2-v30."""
    env = _mk(tmp_path)
    nested_program(env, "IV")

    l1_box, l2_box = Box(0), Box(0)
    cl1 = Checkpoint("CL1", env=env)
    cl1.add("l1", l1_box)
    cl1.commit()
    cl2 = Checkpoint("CL2", env=env)
    cl2.add("l2", l2_box)
    cl2.commit()
    cl1.sub_cp(cl2)
    assert cl1.restart_if_needed()
    assert not cl2.restart_if_needed()   # invalidated by parent publish
    assert (l1_box.value, l2_box.value) == (1, 0)


def test_inner_restart_only_reads_once(tmp_path):
    """Paper §2.5: restartIfNeeded() of the inner CP is called every outer
    iteration but only the first call of a restarted run reads."""
    env = _mk(tmp_path)
    b = Box(0)
    cp = Checkpoint("inner", env=env)
    cp.add("x", b)
    cp.commit()
    b.value = 5
    cp.update_and_write()

    b2 = Box(0)
    cp2 = Checkpoint("inner", env=env)
    cp2.add("x", b2)
    cp2.commit()
    assert cp2.restart_if_needed()       # first call reads v-1
    assert b2.value == 5
    b2.value = 99
    assert not cp2.restart_if_needed()   # successive call: no re-read
    assert b2.value == 99


def test_subcp_cycle_rejected(tmp_path):
    env = _mk(tmp_path)
    a = Checkpoint("A", env=env)
    a.add("x", Box(1))
    a.commit()
    b = Checkpoint("B", env=env)
    b.add("x", Box(1))
    b.commit()
    a.sub_cp(b)
    with pytest.raises(ValueError, match="cycle"):
        b.sub_cp(a)
    with pytest.raises(ValueError, match="own"):
        a.sub_cp(a)


def test_multilevel_grandchild_invalidation(tmp_path):
    env = _mk(tmp_path)
    boxes = [Box(0), Box(0), Box(0)]
    cps = []
    for i, name in enumerate(("L1", "L2", "L3")):
        cp = Checkpoint(name, env=env)
        cp.add("x", boxes[i])
        cp.commit()
        cps.append(cp)
    cps[0].sub_cp(cps[1])
    cps[1].sub_cp(cps[2])
    cps[2].update_and_write()
    cps[1].update_and_write()    # parent of L3 → invalidates L3
    assert cps[2]._pfs.latest_version() == 0
    cps[2].update_and_write()
    cps[0].update_and_write()    # grandparent → invalidates L2 AND L3
    assert cps[1]._pfs.latest_version() == 0
    assert cps[2]._pfs.latest_version() == 0
    assert cps[0]._pfs.latest_version() == 1


# --------------------------------------------------------- across packages
@pytest.mark.parametrize("stage", list(TABLE_1))
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_table_1_across_packages(tmp_path, stage, writer):
    """The program runs to a failure point in one package; the restart in
    the other package resumes the state Table 1 names."""
    port = (Checkpoint, CraftEnv, Box)
    ref = (ref_core.Checkpoint, ref_core.CraftEnv, ref_core.Box)
    (mk, Env, box), (rmk, REnv, rbox) = ((port, ref) if writer == "port"
                                         else (ref, port))
    envmap = {"CRAFT_CP_PATH": str(tmp_path), "CRAFT_USE_SCR": "0"}
    nested_program(Env.capture(envmap), stage, mk=mk, box=box)

    env = REnv.capture(envmap)
    l1_box, l2_box = rbox(0), rbox(0)
    cl1 = rmk("CL1", env=env)
    cl1.add("l1", l1_box)
    cl1.commit()
    cl2 = rmk("CL2", env=env)
    cl2.add("l2", l2_box)
    cl2.commit()
    cl1.sub_cp(cl2)
    cl1.restart_if_needed()
    cl2.restart_if_needed()
    assert (l1_box.value, l2_box.value) == TABLE_1[stage]
