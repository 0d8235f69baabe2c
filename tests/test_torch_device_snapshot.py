"""The port's DeviceSnapshotter against the reference's on the same bytes.

CPU tensors go through both modes of the port (``staged=True``: word buffer,
plain snapshot pass, host mirrors; ``staged=False``: private copy and numpy
pass) and are compared with the reference snapshotter in the same mode:
per-chunk digests, dirty masks, entropy estimates, the exact host bytes
across rounds, D2H accounting and the reshape reset.  Torch tensors are
mutable, so in-place updates after ``update()`` must not reach the bytes an
(asynchronous) write sees.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import metrics as ref_metrics
from repro.core.device_snapshot import DeviceSnapshotter as RefSnap
from repro.core.device_snapshot import _pack_words as ref_pack_words

from repro_torch.convert import tensor_from_numpy
from repro_torch.core import Box, Checkpoint, CraftEnv, metrics, storage
from repro_torch.core.checkpointables import PytreeCp, TorchTensorCp
from repro_torch.core.cpbase import IOContext
from repro_torch.core.device_snapshot import DeviceSnapshotter, _pack_words

CHUNK = 256


def _bytes_of(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _rounds(dtype, shape, seed=0):
    """Three versions of one array: base, a sparse in-place change, another."""
    rng = np.random.default_rng(seed)
    a0 = rng.standard_normal(shape).astype(dtype)
    a1 = a0.copy()
    a1.reshape(-1)[3] = a1.reshape(-1)[3] + 1
    a2 = a1.copy()
    a2.reshape(-1)[-1] = 0
    return [a0, a1, a2, a1]


CASES = [(np.float32, (10, 50)), (ml_dtypes.bfloat16, (9, 64)),
         (np.int32, (7,)), (np.float32, (3, 700))]


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("dtype,shape", CASES,
                         ids=[f"{np.dtype(d).name}{s}" for d, s in CASES])
def test_snapshotter_matches_reference(staged, with_hist, dtype, shape):
    ref = RefSnap(CHUNK, with_hist=with_hist, staged=staged)
    port = DeviceSnapshotter(CHUNK, with_hist=with_hist, staged=staged)
    hosts = []
    for arr in _rounds(dtype, shape):
        r_host, r_meta = ref.snapshot("k", jnp.asarray(arr))
        p_host, p_meta = port.snapshot("k", tensor_from_numpy(arr, "cpu"))
        assert p_meta == r_meta
        assert _bytes_of(p_host) == _bytes_of(r_host) == _bytes_of(arr)
        assert tuple(p_host.shape) == arr.shape
        hosts.append((p_host, _bytes_of(arr)))
    # double buffering: the previous round's host view is still intact
    assert _bytes_of(hosts[-2][0]) == hosts[-2][1]


def test_d2h_accounting_matches_reference():
    ref_metrics.install()
    metrics.install()
    try:
        ref = RefSnap(CHUNK, staged=True)
        port = DeviceSnapshotter(CHUNK, staged=True)
        for arr in _rounds(np.float32, (4, 200)):
            ref.snapshot(0, jnp.asarray(arr))
            port.snapshot(0, tensor_from_numpy(arr, "cpu"))
        r = ref_metrics.snapshot()["counters"]
        p = metrics.snapshot()["counters"]
        for key in ("snapshot_d2h_bytes", "snapshot_d2h_bytes_saved"):
            assert p[key] == r[key]
        assert p["snapshot_d2h_bytes_saved"] > 0
    finally:
        ref_metrics.uninstall()
        metrics.uninstall()


@pytest.mark.parametrize("staged", [True, False])
def test_reshape_resets_state(staged):
    ref = RefSnap(CHUNK, staged=staged)
    port = DeviceSnapshotter(CHUNK, staged=staged)
    a = np.arange(512, dtype=np.float32)
    for arr in (a, a.reshape(8, 64), a[:256]):
        _, rm = ref.snapshot(0, jnp.asarray(arr))
        _, pm = port.snapshot(0, tensor_from_numpy(arr, "cpu"))
        assert pm == rm
        assert pm["dirty"] is None        # every shape change is a reset


@pytest.mark.parametrize("arr", [
    np.zeros((0, 3), np.float32), np.arange(3, dtype=np.uint8),
    np.ones(5, np.complex64), np.array([True, False, True]),
], ids=["empty", "3-bytes", "complex", "bool-3"])
def test_fallbacks_match_reference(arr):
    _, rm = RefSnap(CHUNK).snapshot(0, jnp.asarray(arr))
    host, pm = DeviceSnapshotter(CHUNK).snapshot(0,
                                                 tensor_from_numpy(arr, "cpu"))
    assert pm is None and rm is None
    assert _bytes_of(host) == _bytes_of(arr)


@pytest.mark.parametrize("arr", [
    np.array([True, False, True, True]), np.array(7, np.int32),
    np.arange(6, dtype=np.int16), np.ones(10, ml_dtypes.bfloat16),
], ids=["bool", "0d", "int16", "bf16"])
def test_pack_words_matches_reference(arr):
    n_chunks, wpc = DeviceSnapshotter(CHUNK)._grid(arr.nbytes)
    ref = np.asarray(ref_pack_words(jnp.asarray(arr), n_chunks, wpc))
    port = _pack_words(tensor_from_numpy(arr, "cpu"), n_chunks, wpc)
    np.testing.assert_array_equal(port.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("staged", [True, False])
def test_snapshot_is_stable_against_inplace_updates(staged):
    t = torch.arange(300, dtype=torch.float32)
    snap = DeviceSnapshotter(CHUNK, staged=staged)
    host, _ = snap.snapshot(0, t)
    before = _bytes_of(t)
    t.add_(1)
    assert _bytes_of(host) == before


@pytest.mark.parametrize("device_snapshot", [True, False])
@pytest.mark.parametrize("kind", ["tensor", "tree"])
def test_write_after_inplace_update_sees_update_time_bytes(
        tmp_path, device_snapshot, kind):
    t = torch.arange(1000, dtype=torch.float32)
    if kind == "tensor":
        item = TorchTensorCp(Box(t), device_snapshot=device_snapshot,
                             chunk_bytes=CHUNK)
        fname = "shard-0-0.bin"
    else:
        item = PytreeCp(Box({"w": t}), device_snapshot=device_snapshot,
                        chunk_bytes=CHUNK)
        fname = "leaf0-shard-0-0.bin"
    item.update()
    expect = t.clone()
    t.mul_(3)                               # the application moves on
    ctx = IOContext(device="cpu", chunk_bytes=CHUNK, rel_root=tmp_path,
                    device_meta={} if device_snapshot else None)
    item.write(tmp_path, ctx)
    got = storage.read_tensor(tmp_path / fname, ctx)
    assert torch.equal(got, expect)


def test_async_write_sees_snapshot_not_later_updates(tmp_path):
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                            "CRAFT_USE_SCR": "0", "CRAFT_WRITE_ASYNC": "1",
                            "CRAFT_DEVICE_SNAPSHOT": "1",
                            "CRAFT_CHUNK_BYTES": str(CHUNK)})
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    expect = state["w"].clone()
    with Checkpoint("a", env=env, device="cpu") as cp:
        cp.add("s", Box(state))
        cp.commit()
        cp.update_and_write(1)
        state["w"].fill_(-1)                # races the writer thread
        cp.wait()
    live = {"w": torch.zeros(4096)}
    with Checkpoint("a", env=env, device="cpu") as cp:
        cp.add("s", Box(live))
        cp.commit()
        assert cp.restart_if_needed()
    assert torch.equal(live["w"], expect)


LEAVES = {
    "bf16": np.random.default_rng(3).standard_normal((33, 17)).astype(
        ml_dtypes.bfloat16),
    "bool": np.array([True, False] * 41),
    "scalar": np.array(2.5, np.float32),
    "empty": np.zeros((0,), np.float32),
    "odd": np.arange(13, dtype=np.uint8),
    "big": np.random.default_rng(4).standard_normal(2000).astype(np.float32),
}


@pytest.mark.parametrize("codec", ["1", "2"])
def test_restore_identical_with_snapshot_on_and_off(tmp_path, codec):
    files = {}
    for snap in ("0", "1"):
        root = tmp_path / f"snap{snap}"
        env = CraftEnv.capture({
            "CRAFT_CP_PATH": str(root / "pfs"),
            "CRAFT_NODE_CP_PATH": str(root / "node"),
            "CRAFT_CODEC_VERSION": codec, "CRAFT_DEVICE_SNAPSHOT": snap,
            "CRAFT_CHUNK_BYTES": str(CHUNK)})
        state = {k: tensor_from_numpy(v, "cpu") for k, v in LEAVES.items()}
        with Checkpoint("s", env=env, device="cpu") as cp:
            cp.add("s", Box(state))
            cp.commit()
            cp.update_and_write(1)
            state["big"][7] += 1
            cp.update_and_write(2)
        live = {k: torch.zeros_like(v) for k, v in state.items()}
        with Checkpoint("s", env=env, device="cpu") as cp:
            cp.add("s", Box(live))
            cp.commit()
            assert cp.restart_if_needed() and cp.version == 2
        for k in state:
            assert torch.equal(live[k], state[k]), k
        vdir = root / "pfs" / "s" / "v-2" / "s"
        files[snap] = {p.name: p.read_bytes() for p in vdir.glob("*.bin")}
    assert files["0"] == files["1"]
