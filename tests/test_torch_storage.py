"""The port's array codec against the reference package's: codecs v0/v1/v2
write byte-identical files from the same array, each package reads the
other's files bit-identically, and a flipped payload byte raises in both."""
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import storage as ref_storage
from repro.core.cpbase import CheckpointError as RefError
from repro.core.cpbase import IOContext as RefCtx

from repro_torch.convert import tensor_from_numpy
from repro_torch.core import storage
from repro_torch.core.cpbase import CheckpointError
from repro_torch.core.cpbase import IOContext

CHUNK = 64


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "bool": rng.integers(0, 2, (5, 9)).astype(bool),
        "bf16": rng.standard_normal((7, 33)).astype(ml_dtypes.bfloat16),
        "float32": rng.standard_normal((6, 50)).astype(np.float32),
        "int64": rng.integers(-2**62, 2**62, (40,), dtype=np.int64),
        "0d": np.array(3.25, np.float64),
        "empty": np.zeros((0, 4), np.float32),
        "unaligned_u8": np.frombuffer(rng.bytes(203), np.uint8).copy(),
        "unaligned_f16": rng.standard_normal(51).astype(np.float16),
        "fp8": rng.standard_normal(70).astype(ml_dtypes.float8_e4m3fn),
    }


ARRAYS = _arrays()
CODECS = [0, 1, 2]


def _ctxs(codec, **kw):
    common = dict(codec_version=codec, chunk_bytes=CHUNK, **kw)
    return RefCtx(**common), IOContext(device="cpu", **common)


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_files_identical_and_cross_readable(tmp_path, codec, name):
    arr = ARRAYS[name]
    rctx, pctx = _ctxs(codec)
    rp, pp, tp = tmp_path / "ref.bin", tmp_path / "port.bin", tmp_path / "t.bin"
    ref_storage.write_array(rp, arr, rctx)
    storage.write_array(pp, arr, pctx)
    storage.write_array(tp, tensor_from_numpy(arr, "cpu"), pctx)
    assert pp.read_bytes() == rp.read_bytes()
    assert tp.read_bytes() == rp.read_bytes()
    # reference reads the port's file
    back = ref_storage.read_array(pp, rctx)
    assert back.dtype == arr.dtype
    assert _bits(back) == _bits(arr)
    # the port reads the reference's file, as host view and as tensor
    host = storage.read_array(rp, pctx)
    assert _bits(host) == _bits(arr)
    t = storage.read_tensor(rp, pctx)
    assert tuple(t.shape) == (arr.shape if codec or arr.ndim else (1,))
    assert torch.equal(t.reshape(arr.shape),
                       tensor_from_numpy(arr, "cpu"))


@pytest.mark.parametrize("codec", CODECS)
def test_flipped_byte_raises_in_both(tmp_path, codec):
    arr = ARRAYS["float32"]
    rctx, pctx = _ctxs(codec, checksum="crc32")
    p = tmp_path / "a.bin"
    storage.write_array(p, arr, pctx)
    raw = bytearray(p.read_bytes())
    raw[-5] ^= 0x10
    p.write_bytes(bytes(raw))
    with pytest.raises(RefError, match="checksum mismatch"):
        ref_storage.read_array(p, rctx)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        storage.read_array(p, pctx)


@pytest.mark.parametrize("codec", CODECS)
def test_truncated_file_raises(tmp_path, codec):
    _, pctx = _ctxs(codec)
    p = tmp_path / "a.bin"
    storage.write_array(p, ARRAYS["int64"], pctx)
    p.write_bytes(p.read_bytes()[:-9])
    with pytest.raises(CheckpointError, match="truncated"):
        storage.read_array(p, pctx)


def _v2_pair(tmp_path, writer, ctx_cls, **ctx_kw):
    """Base version (v1 dir) + a delta version (v2 dir) of one array file
    written by ``writer``; returns (root, base array, head array)."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal(200).astype(np.float32)       # 800 B, 13 chunks
    head = base.copy()
    head[20] += 1.0                                           # one dirty chunk
    root = tmp_path / writer.__name__
    chunks: dict = {}
    c1 = ctx_cls(codec_version=2, chunk_bytes=CHUNK, chunks_db=chunks,
                 rel_root=root / "v-1", **ctx_kw)
    (root / "v-1").mkdir(parents=True)
    writer.write_array(root / "v-1" / "a.bin", base, c1)
    c2 = ctx_cls(codec_version=2, chunk_bytes=CHUNK, rel_root=root / "v-2",
                 delta_prev=chunks, delta_base=1, chunks_db={}, **ctx_kw)
    (root / "v-2").mkdir()
    writer.write_array(root / "v-2" / "a.bin", head, c2)
    return root, base, head


def test_delta_chain_written_by_each_read_by_the_other(tmp_path):
    for writer, ctx_cls, kw in ((ref_storage, RefCtx, {}),
                                (storage, IOContext, {"device": "cpu"})):
        root, base, head = _v2_pair(tmp_path, writer, ctx_cls, **kw)
        for reader, rcls, rkw in ((ref_storage, RefCtx, {}),
                                  (storage, IOContext, {"device": "cpu"})):
            ctx = rcls(rel_root=root / "v-2", base_dirs={1: root / "v-1"},
                       **rkw)
            got = reader.read_array(root / "v-2" / "a.bin", ctx)
            assert _bits(got) == _bits(head), (writer, reader)


def test_delta_files_identical_across_packages(tmp_path):
    r_root, _, _ = _v2_pair(tmp_path / "r", ref_storage, RefCtx)
    p_root, _, _ = _v2_pair(tmp_path / "p", storage, IOContext,
                            device="cpu")
    for v in ("v-1", "v-2"):
        assert (p_root / v / "a.bin").read_bytes() == \
            (r_root / v / "a.bin").read_bytes()


@pytest.mark.parametrize("codec", CODECS)
def test_chunk_range_reader_matches_reference(tmp_path, codec):
    arr = ARRAYS["unaligned_u8"]
    p = tmp_path / "a.bin"
    rctx, pctx = _ctxs(codec)
    ref_storage.write_array(p, arr, rctx)
    rr = ref_storage.ChunkRangeReader(p, rctx)
    pr = storage.ChunkRangeReader(p, pctx)
    assert pr.nbytes == rr.nbytes == arr.nbytes
    for lo, hi in [(0, 0), (0, 203), (5, 70), (63, 65), (128, 203)]:
        assert bytes(pr.read(lo, hi)) == bytes(rr.read(lo, hi))


def test_dtype_names_roundtrip():
    for name in ("bool", "bfloat16", "float8_e4m3fn", "float8_e5m2",
                 "float16", "float32", "int64", "uint8", "complex64"):
        tdt = storage.torch_dtype_from_name(name)
        assert storage._dtype_to_name(tdt) == name
        assert storage._dtype_from_name(name).itemsize == \
            torch.empty(0, dtype=tdt).element_size()


# ------------------------------------------------------------- zstd paths
class _FakeZstd:
    """zlib-backed stand-in for the optional zstandard module (the same
    object swapped into both packages, so their files stay comparable)."""

    class ZstdError(Exception):
        pass

    class ZstdCompressor:
        def __init__(self, level=3):
            self.level = level

        def compress(self, data):
            return zlib.compress(bytes(data), 6)

    class ZstdDecompressor:
        def decompress(self, data):
            try:
                return zlib.decompress(bytes(data))
            except zlib.error as exc:
                raise _FakeZstd.ZstdError(str(exc)) from exc


@pytest.fixture()
def fake_zstd(monkeypatch):
    monkeypatch.setattr(ref_storage, "_zstd", _FakeZstd)
    monkeypatch.setattr(storage, "_zstd", _FakeZstd)
    return _FakeZstd


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("gate", [0.0, 7.5])
def test_zstd_files_identical_and_cross_readable(tmp_path, fake_zstd, codec,
                                                 gate):
    rng = np.random.default_rng(2)
    arr = np.concatenate([np.zeros(300, np.uint8),
                          np.frombuffer(rng.bytes(300), np.uint8)])
    rctx, pctx = _ctxs(codec, compress="zstd", zstd_gate_bits=gate)
    rp, pp = tmp_path / "r.bin", tmp_path / "p.bin"
    ref_storage.write_array(rp, arr, rctx)
    storage.write_array(pp, arr, pctx)
    assert pp.read_bytes() == rp.read_bytes()
    assert _bits(ref_storage.read_array(pp, rctx)) == _bits(arr)
    assert _bits(storage.read_array(rp, pctx)) == _bits(arr)
