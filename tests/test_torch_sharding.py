"""The port's sharding layer against the reference, on the CPU.

- ``TestRules``: the reference's ``tests/test_sharding.py::TestRules`` on
  the port's ``LogicalRules`` (a stub mesh stands in for devices: the
  rules read only the mesh's dimension names and sizes).
- The rules' specs equal the reference's on stub meshes (1), (16, 16) and
  (2, 16, 16), for every pair of logical names, with and without shapes;
  their DTensor placements give each device the reference's extent.
- ``param_logical``, ``cache_logical`` and ``opt_state_logical`` (32- and
  8-bit) equal the reference's for every arch, TINY and full; the specs of
  every parameter leaf at the production mesh equal the reference's
  (``jax.eval_shape`` shapes there, meta-device shapes here).
- ``TestElasticRestore`` (marked ``slow``, as the reference's): DTensor
  checkpoints written by 8 gloo worker processes on a (4, 2) mesh restore
  on 4 fresh processes on ``shrink_mesh(4, model_parallel=2)``, then
  ``reshard``; and across packages both ways: the reference writes with
  8 forced host devices and the port restores on 4 ranks, the port writes
  on 8 ranks and the reference restores onto (2, 2).  A single float32
  tensor and the TINY h2o-danube-1.8b parameter tree (bfloat16), bit for
  bit.

No process group is ever started in the pytest process: the mesh runs are
worker processes (``runtime.Cluster``) and subprocesses.  The worker
functions are module level and this module imports no JAX at its top (a
spawned worker imports it).
"""
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptimConfig, opt_state_logical
from repro_torch.sharding.logical import (
    DEFAULT_RULES, LogicalRules, placements, shard_specs,
)

REPO = Path(__file__).resolve().parents[1]


class StubMesh:
    """What ``LogicalRules`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(shape)


MESH1 = StubMesh((1,), ("data",))
PROD = StubMesh((16, 16), ("data", "model"))
MULTI = StubMesh((2, 16, 16), ("pod", "data", "model"))


class TestRules:
    def test_spec_basic(self):
        assert LogicalRules(MESH1).spec("batch", "seq") == ("data", None)

    def test_missing_axis_dropped(self):
        # no 'model' axis on this mesh
        assert LogicalRules(MESH1).spec("batch", "heads") == ("data", None)

    def test_axis_used_once(self):
        # both dims map to data — the second one degrades to None
        assert LogicalRules(MESH1).spec("batch", "embed") == ("data", None)

    def test_divisibility_fallback(self):
        rules = LogicalRules(PROD)
        assert rules.spec("batch", "seq", shape=(1, 64)) == (None, None)
        assert rules.spec("batch", "seq", shape=(64, 64)) == ("data", None)
        # 56 heads don't divide 16 → replicated; 64 do → sharded
        assert rules.spec("embed", "heads", shape=(128, 56)) == \
            ("data", None)
        assert rules.spec("embed", "heads", shape=(128, 64)) == \
            ("data", "model")

    def test_unknown_logical_raises(self):
        with pytest.raises(KeyError):
            LogicalRules(MESH1).spec("nonsense")

    def test_tuple_rule_prefix(self):
        assert DEFAULT_RULES["batch"] == ("pod", "data")


# ------------------------------------------------- against the reference
def _ref_mesh(stub):
    class Devices:
        shape = stub.shape

    class RefStub:
        axis_names = stub.mesh_dim_names
        devices = Devices()

    return RefStub()


NAMES = [None] + sorted(DEFAULT_RULES)


@pytest.mark.parametrize("with_shape", [False, True])
@pytest.mark.parametrize("stub", [MESH1, PROD, MULTI],
                         ids=["1", "16x16", "2x16x16"])
def test_specs_equal_reference(stub, with_shape):
    """Every pair of logical names (and each name alone); with shapes, the
    sizes 1, 8, 16, 48, 64 and 512 of each dim (dividing 16, 32 and 512 or
    not)."""
    from repro.sharding.logical import LogicalRules as RefRules

    ours, ref = LogicalRules(stub), RefRules(_ref_mesh(stub))
    sizes = [1, 8, 16, 48, 64, 512] if with_shape else [None]
    n = 0
    for a, b in itertools.product(NAMES, NAMES):
        for sa, sb in itertools.product(sizes, sizes):
            shape = None if sa is None else (sa, sb)
            assert ours.spec(a, b, shape=shape) == \
                tuple(ref.spec(a, b, shape=shape)), (a, b, shape)
            n += 1
        one = None if sizes[0] is None else (sizes[-1],)
        assert ours.spec(a, shape=one) == tuple(ref.spec(a, shape=one))
    assert n >= len(NAMES) ** 2


def _extents(spec, sizes, shape):
    """Each device's extent of a tensor of ``shape`` under GSPMD's reading
    of ``spec`` (mesh axes of one dim nest in the spec's order)."""
    out = {}
    names = list(sizes)
    for coord in itertools.product(*(range(sizes[n]) for n in names)):
        at = dict(zip(names, coord))
        ext = []
        for d, ax in enumerate(spec):
            axs = () if ax is None else ((ax,) if isinstance(ax, str)
                                         else tuple(ax))
            k, idx = 1, 0
            for a in axs:
                idx = idx * sizes[a] + at[a]
                k *= sizes[a]
            step = shape[d] // k
            ext.append((idx * step, (idx + 1) * step))
        out[coord] = tuple(ext)
    return out


@pytest.mark.parametrize("profile", ["default", "fsdp"])
def test_placements_give_each_device_the_gspmd_extent(profile):
    """A tuple rule such as ("pod", "data") splits one dim over two mesh
    dims; DTensor's placements give every device of the (2, 4, 2) mesh the
    extent GSPMD gives it."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    class CoordMesh(StubMesh):
        def __init__(self, coord):
            super().__init__((2, 4, 2), ("pod", "data", "model"))
            self.coord = list(coord)

        def size(self, mesh_dim=None):
            return (int(np.prod(self.shape)) if mesh_dim is None
                    else self.shape[mesh_dim])

        def get_coordinate(self):
            return self.coord

        def _is_current_rank_part_of_mesh(self):
            return True

        def _sym_get_coordinate(self, index):
            return self.coord[index]

    stub = StubMesh((2, 4, 2), ("pod", "data", "model"))
    rules = LogicalRules(stub)
    if profile == "fsdp":
        rules.rules.update({"batch": ("pod", "data", "model"),
                            "embed": ("data", "model")})
    sizes = dict(zip(stub.mesh_dim_names, stub.shape))
    for dims, shape in [(("batch", "seq"), (16, 8)),
                        (("embed", "heads"), (64, 16)),
                        (("batch", "seq", "embed_act"), (32, 4, 8))]:
        spec = rules.spec(*dims, shape=shape)
        want = _extents(spec, sizes, shape)
        for coord, ext in want.items():
            mesh = CoordMesh(coord)
            local, off = compute_local_shape_and_global_offset(
                torch.Size(shape), mesh, placements(spec, stub))
            got = tuple((o, o + s) for o, s in zip(off, local))
            assert got == ext, (dims, coord)


def _ref_cfg(arch, tiny):
    from repro.configs import get_config as ref_config

    return ref_config(arch, tiny=tiny)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_trees_equal_reference(arch, tiny):
    from repro.models import model as RM

    cfg, rcfg = get_config(arch, tiny=tiny), _ref_cfg(arch, tiny)
    assert M.param_logical(cfg) == RM.param_logical(rcfg)
    assert M.cache_logical(cfg) == RM.cache_logical(rcfg)


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_logical_equals_reference(arch, tiny, bits):
    import jax

    from repro.models import model as RM
    from repro.optim import adamw as RA

    cfg, rcfg = get_config(arch, tiny=tiny), _ref_cfg(arch, tiny)
    ocfg = OptimConfig(state_bits=bits)
    rparams = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                             jax.random.PRNGKey(0))
    want = RA.opt_state_logical(RM.param_logical(rcfg),
                                RA.OptimConfig(state_bits=bits),
                                params=rparams)
    got = opt_state_logical(M.param_logical(cfg), ocfg,
                            params=M.init_params(None, cfg, "meta"))
    assert got == want


def _spec_paths(tree, jax_tree: bool):
    if jax_tree:
        import jax

        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {"/".join(str(k.key) for k in p): tuple(v)
                for p, v in flat[0]}
    flat = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {"/".join(str(k.key) for k in p): v for p, v in flat}


@pytest.mark.parametrize("stub", [PROD, MULTI], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_at_production_mesh(arch, stub):
    """Every parameter leaf's spec, with the divisibility fallback on the
    leaf's shape, for the arch padded for the 16-way model axis."""
    import jax

    from repro.models import model as RM
    from repro.sharding.logical import LogicalRules as RefRules
    from repro.sharding.logical import shard_specs as ref_shard_specs

    cfg = get_config(arch).padded_for_tp(16)
    rcfg = _ref_cfg(arch, False).padded_for_tp(16)
    rshapes = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                             jax.random.PRNGKey(0))
    want = _spec_paths(ref_shard_specs(RefRules(_ref_mesh(stub)),
                                       RM.param_logical(rcfg), rshapes),
                       True)
    got = _spec_paths(shard_specs(LogicalRules(stub), M.param_logical(cfg),
                                  M.init_params(None, cfg, "meta")), False)
    assert got == want


# --------------------------------------------------------- elastic restore
ARCH = "h2o-danube-1.8b"
X = np.arange(64.0, dtype=np.float32).reshape(8, 8)


def _ref_params_np():
    import jax

    from repro.models import model as RM

    rparams = RM.init_params(jax.random.PRNGKey(0), _ref_cfg(ARCH, True))
    return jax.tree_util.tree_map(np.asarray, rparams)


def _paths_np(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in pytree.tree_flatten_with_path(tree)[0]}


def _env(base):
    from repro_torch.core.env import CraftEnv

    return CraftEnv.capture({"CRAFT_CP_PATH": str(Path(base) / "pfs"),
                             "CRAFT_USE_SCR": "0"})


def _to_np(t):
    """A DTensor's (or tensor's) whole value as numpy; bfloat16 as its
    uint16 bits."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_writer(comm, port, base, np_params):
    """8 ranks: X and the params as DTensors on a (4, 2) mesh, one
    version."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core import Box, Checkpoint
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import shard_tree

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=comm.rank, world_size=comm.size)
    try:
        mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
        rules = LogicalRules(mesh)
        cfg = get_config(ARCH, tiny=True)
        x = shard_tree({"x": torch.from_numpy(X)},
                       {"x": ("batch", "mlp")}, rules)["x"]
        params = shard_tree(convert.params_from_numpy(np_params, cfg, "cpu"),
                            M.param_logical(cfg), rules)
        cp = _checkpoint(comm, base)
        cp.add("x", Box(x))
        cp.add("params", Box(params))
        cp.commit()
        cp.update_and_write()
        cp.wait()
        cp.close()
        return {"rank": comm.rank, "x": str(tuple(x.placements))}
    finally:
        dist.destroy_process_group()


def _checkpoint(comm, base):
    from repro_torch.core import Checkpoint

    return Checkpoint("el", comm, env=_env(base), device="cpu")


def _port_reader(comm, port, bases):
    """4 ranks on shrink_mesh(4, 2): restore each checkpoint of ``bases``
    into zeros DTensors, return the whole values (host numpy) and each
    rank's local extents; then ``reshard`` X onto (batch, embed)."""
    import torch.distributed as dist

    from repro_torch.core import Box
    from repro_torch.core.elastic import dp_degree, reshard, shrink_mesh
    from repro_torch.sharding.logical import sharded_zeros

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=comm.rank, world_size=comm.size)
    try:
        mesh = shrink_mesh(4, model_parallel=2, device_type="cpu")
        rules = LogicalRules(mesh)
        cfg = get_config(ARCH, tiny=True)
        out = {"rank": comm.rank, "mesh": tuple(mesh.shape),
               "dp": dp_degree(mesh)}
        for tag, base in bases.items():
            xs = rules.spec("batch", "mlp", shape=X.shape)
            box_x = Box(sharded_zeros(X.shape, torch.float32, xs, mesh,
                                      "cpu"))
            shapes = M.init_params(None, cfg, "meta")
            specs = shard_specs(rules, M.param_logical(cfg), shapes)
            box_p = Box(pytree.tree_map(
                lambda s, sp: sharded_zeros(s.shape, s.dtype, sp, mesh,
                                            "cpu"),
                shapes, specs, is_leaf=lambda t: isinstance(t, torch.Tensor)))
            cp = _checkpoint(comm, base)
            cp.add("x", box_x)
            cp.add("params", box_p)
            cp.commit()
            restored = cp.restart_if_needed()
            cp.close()
            x = box_x.value
            y, _ = reshard({"w": x}, {"w": ("batch", "embed")}, mesh)
            out[tag] = {
                "restored": bool(restored),
                "x": _to_np(x), "x_local": x.to_local().numpy().copy(),
                "x_placements": str(tuple(x.placements)),
                "y": _to_np(y["w"]),
                "y_placements": str(tuple(y["w"].placements)),
                "params": {k: _to_np(v)
                           for k, v in _paths_t(box_p.value).items()},
            }
        return out
    finally:
        dist.destroy_process_group()


def _paths_t(tree):
    return {"/".join(str(k.key) for k in p): v
            for p, v in pytree.tree_flatten_with_path(tree)[0]}


def _free_port() -> int:
    from repro_torch.examples.elastic_restore import free_port

    return free_port()


def _cluster(n, fn, *args):
    from repro_torch.runtime import Cluster

    with Cluster(n_procs=n, env_overrides={"OMP_NUM_THREADS": "1"}) as c:
        c.start(fn, *args)
        res = c.join(timeout=400)
    return [res[r] for r in sorted(res)]


_REF_PRELUDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.core import Box, Checkpoint
from repro.core.elastic import shrink_mesh
from repro.core.env import CraftEnv
from repro.models import model as M
from repro.sharding.logical import LogicalRules, shard_specs

env = CraftEnv.capture({{"CRAFT_CP_PATH": r"{base}/pfs",
                         "CRAFT_USE_SCR": "0"}})
cfg = get_config("h2o-danube-1.8b", tiny=True)
X = np.arange(64.0, dtype=np.float32).reshape(8, 8)


def on_mesh(mesh, tree, logical):
    rules = LogicalRules(mesh)
    specs = shard_specs(rules, logical, tree)
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda a: isinstance(a, (np.ndarray, jax.Array)))


params = M.init_params(jax.random.PRNGKey(0), cfg)
"""

_REF_WRITE = _REF_PRELUDE + """
mesh = jax.make_mesh((4, 2), ("data", "model"))
cp = Checkpoint("el", env=env)
cp.add("x", Box(on_mesh(mesh, {{"x": jnp.asarray(X)}},
                        {{"x": ("batch", "mlp")}})["x"]))
cp.add("params", Box(on_mesh(mesh, params, M.param_logical(cfg))))
cp.commit()
cp.update_and_write()
print("OK")
"""

_REF_READ = _REF_PRELUDE + """
mesh = shrink_mesh(4, model_parallel=2)
box_x = Box(on_mesh(mesh, {{"x": jnp.zeros((8, 8), jnp.float32)}},
                    {{"x": ("batch", "mlp")}})["x"])
box_p = Box(on_mesh(mesh, jax.tree_util.tree_map(jnp.zeros_like, params),
                    M.param_logical(cfg)))
cp = Checkpoint("el", env=env)
cp.add("x", box_x)
cp.add("params", box_p)
cp.commit()
assert cp.restart_if_needed()
assert box_x.value.sharding.mesh.devices.size == 4
np.testing.assert_array_equal(np.asarray(box_x.value), X)
for a, b in zip(jax.tree_util.tree_leaves(params),
                jax.tree_util.tree_leaves(box_p.value)):
    assert b.sharding.mesh.devices.size == 4
    np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                  np.asarray(b).view(np.uint16))
print("OK")
"""


def _ref_script(tmp, name, body, base):
    script = Path(tmp) / name
    script.write_text(body.format(base=base))
    r = subprocess.run([sys.executable, str(script)], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert "OK" in r.stdout, (r.stdout[-800:], r.stderr[-2500:])


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Port writes on (4, 2) and the reference writes with 8 forced host
    devices; 4 port ranks restore both on shrink_mesh(4, 2); the
    reference restores the port's onto (2, 2)."""
    tmp = tmp_path_factory.mktemp("elastic")
    np_params = _ref_params_np()
    port_base, ref_base = tmp / "port", tmp / "ref"
    writers = _cluster(8, _port_writer, _free_port(), str(port_base),
                       np_params)
    _ref_script(tmp, "ref_write.py", _REF_WRITE, ref_base)
    readers = _cluster(4, _port_reader, _free_port(),
                       {"port": str(port_base), "ref": str(ref_base)})
    return {"np_params": np_params, "writers": writers, "readers": readers,
            "tmp": tmp, "port_base": port_base}


@pytest.mark.slow
class TestElasticRestore:
    """A checkpoint written on a (4, 2) mesh restores onto (2, 2)."""

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_single_tensor_crosses_meshes(self, elastic, writer):
        for r in elastic["readers"]:
            got = r[writer]
            assert r["mesh"] == (2, 2) and r["dp"] == 2
            assert got["restored"]
            np.testing.assert_array_equal(got["x"], X)
            # the rank's own extent, (batch, mlp) on (data, model)
            d, m = divmod(r["rank"], 2)
            np.testing.assert_array_equal(
                got["x_local"], X[4 * d:4 * d + 4, 4 * m:4 * m + 4])

    @pytest.mark.parametrize("writer", ["port", "ref"])
    def test_params_tree_crosses_meshes(self, elastic, writer):
        want = _paths_np(elastic["np_params"])
        for r in elastic["readers"]:
            got = r[writer]["params"]
            assert set(got) == set(want)
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], _np_bits(w), k)

    def test_reshard_moves_the_live_tensor(self, elastic):
        for r in elastic["readers"]:
            got = r["port"]
            np.testing.assert_array_equal(got["y"], X)
            # ("batch", "embed"): embed finds data taken, stays whole
            assert got["y_placements"] == \
                "(Shard(dim=0), Replicate())"

    def test_reference_restores_the_port_checkpoint(self, elastic):
        _ref_script(elastic["tmp"], "ref_read.py", _REF_READ,
                    elastic["port_base"])


def test_shrink_mesh_refuses_less_than_one_model_group():
    from repro_torch.core.elastic import shrink_mesh

    with pytest.raises(ValueError, match="cannot hold one 4-way"):
        shrink_mesh(3, model_parallel=4, device_type="cpu")


def test_dp_degree_reads_data_and_pod():
    from repro_torch.core.elastic import dp_degree

    assert dp_degree(PROD) == 16
    assert dp_degree(MULTI) == 32
    assert dp_degree(MESH1) == 1
