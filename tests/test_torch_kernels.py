"""The port's checksum and snapshot kernels against the reference package.

On the CPU the port's plain versions (``ref.py``), its numpy host twins and
its dispatch (``ops.py``) are held bit-exact against the reference's jnp
oracles, its batched forms and its Pallas kernels run in interpret mode, on
the same seeded numpy words.  The hand-written CUDA kernels are held against
the plain versions on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.checksum import ops as ref_ck_ops
from repro.kernels.checksum.kernel import checksum as ref_ck_pallas
from repro.kernels.checksum.ref import checksum_ref as ref_checksum
from repro.kernels.snapshot import ops as ref_sn_ops
from repro.kernels.snapshot.kernel import snapshot as ref_sn_pallas
from repro.kernels.snapshot.ref import snapshot_ref as ref_snapshot

from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.checksum.kernel import checksum_rows
from repro_torch.kernels.checksum.ref import checksum_rows_ref
from repro_torch.kernels.snapshot import ops as sn_ops
from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
from repro_torch.kernels.snapshot.ref import META_COLS, snapshot_ref

KINDS = ["random", "near_max", "zeros"]


def _words(seed, shape, kind):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(shape, np.uint32)
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if kind == "near_max":      # wrap-around: every sum overflows 2^32
        w = np.uint32(0xFFFFFFFF) - (w & np.uint32(0xFF))
    return w


def _t(words: np.ndarray) -> torch.Tensor:
    """int32 bit view of uint32 words, as the port passes them around."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------- checksum
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 128), (2, 1000),
                                   (4, 4096)])
@pytest.mark.parametrize("kind", KINDS)
def test_checksum_ref_matches_reference_rows(shape, kind):
    w = _words(1, shape, kind)
    port = _u32(checksum_rows_ref(_t(w)))
    rows = np.asarray(ref_ck_ops._rows_checksum(jnp.asarray(w)))
    np.testing.assert_array_equal(port, rows)
    assert port.tolist() == ref_ck_ops._rows_checksum_np(w)
    for r in range(shape[0]):       # the 1-D oracle, row by row
        np.testing.assert_array_equal(
            port[r], np.asarray(ref_checksum(jnp.asarray(w[r]))))


@pytest.mark.parametrize("kind", KINDS)
def test_digest_array_matches_pallas_interpret(kind):
    w = _words(2, (8 * 128 * 2,), kind)
    pallas = np.asarray(ref_ck_pallas(jnp.asarray(w), block_rows=8,
                                      interpret=True))
    assert ck_ops.digest_array(_t(w)) == tuple(int(v) for v in pallas)
    assert ck_ops.digest_array(_t(w)) == ref_ck_ops.digest_array(
        jnp.asarray(w))


@pytest.mark.parametrize("nbytes", [0, 1, 5, 4096, 10_000, 65_537])
def test_digest_bytes_matches_reference(nbytes):
    data = np.random.default_rng(nbytes).bytes(nbytes)
    assert ck_ops.digest_bytes(data, "cpu") == ref_ck_ops.digest_bytes(data)


@pytest.mark.parametrize("nbytes,chunk", [(0, 64), (4096, 1024),
                                          (10_001, 1024), (1000, 30),
                                          (257, 256)])
def test_digest_chunks_matches_reference(nbytes, chunk):
    data = np.random.default_rng(7).bytes(nbytes)
    assert (ck_ops.digest_chunks(data, chunk, "cpu")
            == ref_ck_ops.digest_chunks(data, chunk))


def test_digest_detects_flips_and_order():
    data = bytearray(np.random.default_rng(3).bytes(10_000))
    d1 = ck_ops.digest_bytes(bytes(data), "cpu")
    data[1234] ^= 0x40
    assert ck_ops.digest_bytes(bytes(data), "cpu") != d1
    a = np.arange(1024, dtype=np.uint32)
    assert ck_ops.digest_array(_t(a)) != ck_ops.digest_array(_t(a[::-1]))


def test_cpu_tensors_take_the_plain_version():
    before = checksum_rows.launches, snapshot_chunks_cuda.launches
    w = _t(_words(4, (2, 256), "random"))
    ck_ops.rows_checksum(w)
    sn_ops.snapshot_chunks(w, torch.zeros((2, 2), dtype=torch.int32))
    assert (checksum_rows.launches, snapshot_chunks_cuda.launches) == before


def test_wrappers_refuse_cpu_tensors():
    w = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        checksum_rows(w)
    with pytest.raises(ValueError):
        snapshot_chunks_cuda(w, torch.zeros((1, 2), dtype=torch.int32))


# ------------------------------------------------------------- snapshot
@pytest.mark.parametrize("shape", [(1, 128), (4, 1024), (3, 2048), (2, 77)])
@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_ref_matches_reference(shape, with_hist, kind):
    w = _words(5, shape, kind)
    prev = _words(6, (shape[0], 2), "random")
    port = _u32(snapshot_ref(_t(w), _t(prev), with_hist=with_hist))
    ref = np.asarray(ref_snapshot(jnp.asarray(w), jnp.asarray(prev),
                                  with_hist=with_hist))
    np.testing.assert_array_equal(port, ref)
    assert port.shape[1] == (META_COLS if with_hist else 3)


@pytest.mark.parametrize("shape", [(1, 128), (4, 1024), (3, 2048)])
@pytest.mark.parametrize("with_hist", [True, False])
def test_snapshot_ops_matches_pallas_interpret(shape, with_hist):
    w = _words(8, shape, "random")
    prev = _words(9, (shape[0], 2), "random")
    pallas = np.asarray(ref_sn_pallas(
        jnp.asarray(w), jnp.asarray(prev), block_rows=shape[1] // 128,
        with_hist=with_hist, interpret=True))
    port = _u32(sn_ops.snapshot_chunks(_t(w), _t(prev), with_hist=with_hist))
    np.testing.assert_array_equal(port, pallas)


def test_snapshot_digest_columns_equal_checksum():
    w = _words(10, (4, 256), "random")
    out = _u32(sn_ops.snapshot_chunks(_t(w), torch.zeros((4, 2),
                                                         dtype=torch.int32)))
    assert out[:, :2].tolist() == ck_ops.digest_chunks(w.tobytes(), 1024,
                                                       "cpu")


def test_snapshot_dirty_column_semantics():
    w = _t(np.ones((2, 256), np.uint32))
    first = sn_ops.snapshot_chunks(w, torch.zeros((2, 2), dtype=torch.int32))
    again = sn_ops.snapshot_chunks(w, first[:, :2].contiguous())
    assert first[:, 2].tolist() == [1, 1]
    assert again[:, 2].tolist() == [0, 0]


@pytest.mark.parametrize("nbytes,chunk", [(4096, 1024), (4100, 1024),
                                          (64, 256)])
def test_snapshot_host_matches_reference(nbytes, chunk):
    buf = np.frombuffer(np.random.default_rng(11).bytes(nbytes), np.uint8)
    n_chunks = max(1, -(-nbytes // chunk))
    prev = _words(12, (n_chunks, 2), "random")
    np.testing.assert_array_equal(
        sn_ops.snapshot_host(buf, chunk, prev),
        ref_sn_ops.snapshot_host(buf, chunk, prev))


def test_entropy_helpers_match_reference():
    buf = np.random.default_rng(13).bytes(3000) + bytes(1000)
    hist = sn_ops.host_nibble_hist(buf)
    np.testing.assert_array_equal(hist, ref_sn_ops.host_nibble_hist(buf))
    np.testing.assert_array_equal(
        sn_ops.chunk_entropy_bits(hist[None]),
        ref_sn_ops.chunk_entropy_bits(hist[None]))
