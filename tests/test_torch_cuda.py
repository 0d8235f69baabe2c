"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Box, Checkpoint, CraftEnv
from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.checksum.kernel import checksum_rows
from repro_torch.kernels.checksum.ref import checksum_rows_ref
from repro_torch.kernels.rs_erasure import ops as rs_ops
from repro_torch.kernels.rs_erasure.kernel import gf_matmul_cuda
from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
from repro_torch.kernels.snapshot.ref import snapshot_ref
from repro_torch.kernels.xor_parity import ops as xor_ops
from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda
from repro_torch.kernels.xor_parity.ref import xor_reduce_ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _words(seed, shape, kind, device):
    rng = np.random.default_rng(seed)
    w = (np.zeros(shape, np.uint32) if kind == "zeros"
         else rng.integers(0, 2**32, size=shape, dtype=np.uint32))
    if kind == "near_max":
        w = np.uint32(0xFFFFFFFF) - (w & np.uint32(0xFF))
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(1, 1), (3, 131), (2, 8192 * 2 + 100),
                                   (5, 4096)])
@pytest.mark.parametrize("kind", ["random", "near_max", "zeros"])
def test_kernels_match_plain(cuda, shape, kind):
    w = _words(14, shape, kind, cuda)
    prev = _words(15, (shape[0], 2), "random", cuda)
    ck = checksum_rows(w)
    assert torch.equal(ck, checksum_rows_ref(w))
    for hist in (True, False):
        sn = snapshot_chunks_cuda(w, prev, with_hist=hist)
        assert torch.equal(sn, snapshot_ref(w, prev, with_hist=hist))
        assert torch.equal(sn[:, :2], ck)
    assert not bool(snapshot_chunks_cuda(w, ck)[:, 2].any())


def test_digest_bytes_matches_host(cuda):
    data = np.random.default_rng(16).bytes(10_003)
    assert ck_ops.digest_bytes(data, cuda) == ck_ops.digest_bytes(data, "cpu")
    assert (ck_ops.digest_chunks(data, 1024, cuda)
            == ck_ops.digest_chunks(data, 1024, "cpu"))


def test_checkpoint_roundtrip_on_the_card(cuda, tmp_path):
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path / "pfs"),
                            "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
                            "CRAFT_DEVICE_SNAPSHOT": "1", "CRAFT_DELTA": "1",
                            "CRAFT_CHUNK_BYTES": "65536"})
    g = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn((512, 300), generator=g, device=cuda,
                              dtype=torch.bfloat16)}
    launches = snapshot_chunks_cuda.launches
    with Checkpoint("c", env=env) as cp:
        cp.add("s", Box(state))
        cp.commit()
        cp.update_and_write(1)
        state["w"][0] += 1
        cp.update_and_write(2)
    # add() snapshots the state once (the reference's PytreeCp does), then
    # one launch per version
    assert snapshot_chunks_cuda.launches == launches + 3
    live = {"w": torch.zeros_like(state["w"])}
    with Checkpoint("c", env=env) as cp:
        cp.add("s", Box(live))
        cp.commit()
        assert cp.restart_if_needed()
    assert torch.equal(live["w"], state["w"])


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("n", [1, 3, 128, 4099, 70_000])
def test_parity_kernels_match_plain(cuda, g, n):
    w = _words(17 + g, (g, n), "random", cuda)
    w[g // 2] = 0
    x = xor_reduce_cuda(w)
    assert torch.equal(x, xor_reduce_ref(w))
    rng = np.random.default_rng(g)
    mat = rng.integers(0, 256, (3, g), dtype=np.uint8)
    mat[0, :] = (0, 1, 2, 0x80, 0xFF, 7, 9, 11)[:g]
    gf = gf_matmul_cuda(w, mat)
    assert torch.equal(gf.cpu(), rs_ops.gf_matmul(w.cpu(), mat))
    ones = gf_matmul_cuda(w, np.ones((1, g), np.uint8))
    assert torch.equal(ones[0], x)          # the m=1 code is the XOR


def test_every_coefficient_on_the_card(cuda):
    w = _words(18, (8, 4096 + 3), "random", cuda)
    mat = np.random.default_rng(19).permutation(256).astype(
        np.uint8).reshape(32, 8)
    assert torch.equal(gf_matmul_cuda(w, mat).cpu(),
                       rs_ops.gf_matmul(w.cpu(), mat))
    # an unaligned view takes the scalar path
    flat = _words(20, (1, 4 * 1001 + 1), "random", cuda).view(-1)[1:]
    v = flat.view(4, 1001)
    assert torch.equal(gf_matmul_cuda(v, mat[:2, :4]).cpu(),
                       rs_ops.gf_matmul(v.cpu(), mat[:2, :4]))
    assert torch.equal(xor_reduce_cuda(v), xor_reduce_ref(v))


def test_rs_encode_lose_two_decode_on_the_card(cuda):
    rng = np.random.default_rng(21)
    bufs = [rng.bytes(int(n)) for n in (100_003, 65_536, 99_000, 7)]
    sizes = [len(b) for b in bufs]
    launches = gf_matmul_cuda.launches
    parity = rs_ops.encode_parity(bufs, 2, cuda)
    assert parity == rs_ops.encode_parity(bufs, 2, "cpu")
    out = rs_ops.decode_lost(4, 2, {1: bufs[1], 3: bufs[3]},
                             dict(enumerate(parity)), sizes, cuda)
    assert out == {0: bufs[0], 2: bufs[2]}
    assert gf_matmul_cuda.launches == launches + 3
    assert xor_ops.parity_of_buffers(bufs, cuda) == parity[0]
    assert xor_ops.reconstruct_member(parity[0], bufs[1:], sizes[0],
                                      cuda) == bufs[0]
