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


# ------------------------------------------------------------- xor parity
from repro.kernels.rs_erasure import ops as ref_rs_ops  # noqa: E402
from repro.kernels.rs_erasure.kernel import gf_matmul as ref_gf_pallas  # noqa: E402,E501
from repro.kernels.rs_erasure.ref import gf_matmul_ref as ref_gf_matmul  # noqa: E402,E501
from repro.kernels.xor_parity import ops as ref_xor_ops  # noqa: E402
from repro.kernels.xor_parity.kernel import xor_reduce as ref_xor_pallas  # noqa: E402,E501
from repro.kernels.xor_parity.ref import xor_reduce_ref as ref_xor_reduce  # noqa: E402,E501

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rs_erasure import ops as rs_ops  # noqa: E402
from repro_torch.kernels.rs_erasure.kernel import (  # noqa: E402
    MAX_COEF, gf_matmul_cuda)
from repro_torch.kernels.rs_erasure.ref import gf_matmul_ref  # noqa: E402
from repro_torch.kernels.xor_parity import ops as xor_ops  # noqa: E402
from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda  # noqa: E402,E501
from repro_torch.kernels.xor_parity.ref import xor_reduce_ref  # noqa: E402

RAGGED = [1, 7, 128, 1001]


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("n", RAGGED)
def test_xor_reduce_ref_matches_reference(g, n):
    w = _words(20 + g, (g, n), "random")
    w[g // 2] = 0                                   # an all-zero row
    port = _u32(xor_reduce_ref(_t(w)))
    np.testing.assert_array_equal(port,
                                  np.asarray(ref_xor_reduce(jnp.asarray(w))))
    np.testing.assert_array_equal(port, _u32(xor_ops.xor_reduce(_t(w))))


@pytest.mark.parametrize("g", [1, 3, 8])
def test_xor_reduce_matches_pallas_interpret(g):
    w = _words(30 + g, (g, 256), "random")
    pallas = np.asarray(ref_xor_pallas(jnp.asarray(w), block_n=128,
                                       interpret=True))
    np.testing.assert_array_equal(_u32(xor_reduce_ref(_t(w))), pallas)


@pytest.mark.parametrize("g", range(1, 9))
def test_parity_and_rebuild_match_reference(g):
    rng = np.random.default_rng(40 + g)
    bufs = [rng.bytes(int(n)) for n in rng.integers(1, 3000, g)]
    parity = xor_ops.parity_of_buffers(bufs, "cpu")
    assert parity == ref_xor_ops.parity_of_buffers(bufs)
    assert len(parity) == xor_ops.padded_len(max(map(len, bufs)))
    lost = g - 1
    rest = bufs[:lost]
    mine = xor_ops.reconstruct_member(parity, rest, len(bufs[lost]), "cpu")
    assert mine == bufs[lost]
    assert mine == ref_xor_ops.reconstruct_member(parity, rest,
                                                  len(bufs[lost]))


# ------------------------------------------------------------- GF(2^8) matmul
def _every_coefficient(seed, rows, g):
    """A (rows, g) byte matrix holding each value 0..255 at least once."""
    rng = np.random.default_rng(seed)
    flat = np.concatenate([rng.permutation(256),
                           rng.integers(0, 256, rows * g - 256)])
    return flat.astype(np.uint8).reshape(rows, g)


def _gf_port(w, mat):
    return _u32(rs_ops.gf_matmul(_t(w), mat))


def _gf_ref(w, mat):
    out = ref_gf_matmul(jnp.asarray(np.ascontiguousarray(w).view(np.uint8)),
                        tuple(tuple(int(c) for c in row) for row in mat))
    return np.ascontiguousarray(np.asarray(out)).view(np.uint32)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("n", [7, 1001])
def test_gf_matmul_ref_matches_reference(g, n):
    w = _words(50 + g, (g, n), "random")
    mat = np.random.default_rng(g).integers(0, 256, (3, g), dtype=np.uint8)
    mat[0, 0], mat[-1, -1] = 0, 1
    np.testing.assert_array_equal(_gf_port(w, mat), _gf_ref(w, mat))


@pytest.mark.parametrize("rows,g", [(32, 8), (64, 4)])
def test_gf_matmul_every_coefficient(rows, g):
    w = _words(60 + g, (g, 37), "random")
    w[0, :4] = 0                               # zero bytes meet every c
    mat = _every_coefficient(rows, rows, g)
    port = _gf_port(w, mat)
    np.testing.assert_array_equal(port, _gf_ref(w, mat))
    # the uint8 form of the plain version, as the reference calls it
    u8 = gf_matmul_ref(torch.from_numpy(w.view(np.uint8).copy()), mat)
    np.testing.assert_array_equal(u8.numpy().view(np.uint32), port)


def test_gf_matmul_every_coefficient_matches_pallas_interpret():
    w = _words(70, (8, 128), "random")
    mat = _every_coefficient(71, 32, 8)
    pallas = np.asarray(ref_gf_pallas(
        jnp.asarray(w), matrix=tuple(tuple(int(c) for c in row)
                                     for row in mat),
        block_n=128, interpret=True))
    np.testing.assert_array_equal(_gf_port(w, mat), pallas)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("m", [1, 2, 3])
def test_rs_matrix_and_encode_match_reference(k, m):
    mat = rs_ops.rs_matrix(k, m)
    np.testing.assert_array_equal(mat, ref_rs_ops.rs_matrix(k, m))
    w = _words(80 + k, (k, 384), "random")
    port = _gf_port(w, mat)
    np.testing.assert_array_equal(port, _gf_ref(w, mat))
    if k in (4, 8):
        pallas = np.asarray(ref_gf_pallas(
            jnp.asarray(w), matrix=tuple(tuple(int(c) for c in row)
                                         for row in mat),
            block_n=128, interpret=True))
        np.testing.assert_array_equal(port, pallas)


@pytest.mark.parametrize("k,m", [(4, 2), (5, 3), (8, 3)])
def test_encode_and_every_decode_match_reference(k, m):
    """Every loss pattern up to m: the decode's syndrome and inverse
    matrices (gf_mat_inv over each e×e submatrix) give the reference's
    bytes."""
    from itertools import combinations

    rng = np.random.default_rng(90 + k)
    bufs = [rng.bytes(int(n)) for n in rng.integers(100, 900, k)]
    sizes = [len(b) for b in bufs]
    parity = rs_ops.encode_parity(bufs, m, "cpu")
    assert parity == ref_rs_ops.encode_parity(bufs, m, use_pallas=False)
    assert rs_ops.encode_parity(bufs, 1, "cpu")[0] == \
        xor_ops.parity_of_buffers(bufs, "cpu")
    rows = {j: parity[j] for j in range(m)}
    g_mat = rs_ops.rs_matrix(k, m)
    for e in range(1, m + 1):
        for lost in combinations(range(k), e):
            present = {i: bufs[i] for i in range(k) if i not in lost}
            out = rs_ops.decode_lost(k, m, present, rows, sizes, "cpu")
            assert out == {i: bufs[i] for i in lost}
            sub = g_mat[np.ix_(list(range(e)), list(lost))]
            np.testing.assert_array_equal(rs_ops.gf_mat_inv(sub),
                                          ref_rs_ops.gf_mat_inv(sub))
    if k == 4:
        ref_out = ref_rs_ops.decode_lost(
            k, m, {0: bufs[0], 3: bufs[3]}, rows, sizes, use_pallas=False)
        assert ref_out == rs_ops.decode_lost(
            k, m, {0: bufs[0], 3: bufs[3]}, rows, sizes, "cpu")


def test_decode_with_too_few_parities_raises():
    bufs = [b"a" * 64, b"b" * 64, b"c" * 64]
    parity = rs_ops.encode_parity(bufs, 1, "cpu")
    with pytest.raises(ValueError, match="parity"):
        rs_ops.decode_lost(3, 1, {0: bufs[0]}, {0: parity[0]}, [64] * 3,
                           "cpu")


def test_parity_kernels_refuse_what_they_cannot_take():
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        xor_reduce_cuda(w)
    with pytest.raises(ValueError):
        gf_matmul_cuda(w, np.ones((1, 2), np.uint8))
    with pytest.raises(ValueError, match="at most"):
        gf_matmul_cuda(torch.zeros((65, 8), dtype=torch.int32),
                       np.ones((MAX_COEF // 65 + 1, 65), np.uint8))
    with pytest.raises(ValueError, match="match"):
        gf_matmul_cuda(w, np.ones((1, 3), np.uint8))
    with pytest.raises(ValueError, match="bytes"):
        gf_matmul_cuda(w, np.array([[1, 256]]))


def test_cpu_parity_tensors_take_the_plain_version():
    before = xor_reduce_cuda.launches, gf_matmul_cuda.launches
    bufs = [b"x" * 100, b"y" * 50]
    xor_ops.parity_of_buffers(bufs, "cpu")
    rs_ops.decode_lost(2, 2, {}, dict(enumerate(
        rs_ops.encode_parity(bufs, 2, "cpu"))), [100, 50], "cpu")
    assert (xor_reduce_cuda.launches, gf_matmul_cuda.launches) == before


def test_launch_counter_counts_every_concurrent_launch():
    """Rank threads launch at once: no increment may be lost."""
    import sys
    import threading

    def fake():
        pass

    fake.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(fake) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == 16 * 2000
