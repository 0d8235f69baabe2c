"""The port's attention and selective-scan plain versions against the
reference package.

On the CPU the port's ``ref.py`` twins and its dispatch (``ops.py``) are
held against the reference's jnp oracles, its Pallas kernels run in
interpret mode, its blocked attention and the chunked scan its models run
(``repro.models.ssm._fused_ssd_scan``), on the same seeded numpy inputs.
The hand-written CUDA kernels are held against these plain versions on the
card in ``test_torch_cuda.py``.

Tolerances: float32 2e-5 for attention (as ``tests/test_kernels.py``: the
two sum the same products in another order) and 2e-4 for the scans (the
associative scans combine in another order, and the states compound it);
bfloat16 2e-2 / 3e-2, one rounding of the output apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.blocked import blocked_attention
from repro.kernels.flash_attention.kernel import flash_attention as fa_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.ssm_scan.ops import selective_scan as jax_scan
from repro.kernels.ssm_scan.ref import s6_scan_ref
from repro.kernels.ssm_scan.ref import ssd_scan_ref
from repro.models.ssm import _fused_ssd_scan

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_split_ref)
from repro_torch.kernels.ssm_scan import kernel as scan_kernel
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.kernel import s6_scan_cuda, ssd_scan_cuda
from repro_torch.kernels.ssm_scan import ref as scan_ref
from repro_torch.kernels.ssm_scan.ref import (chunk_passes_ref,
                                              chunked_scan_ref)

# the reference's naive oracles, compiled (eager, their scans take seconds)
jax_ssd, jax_s6 = jax.jit(ssd_scan_ref), jax.jit(s6_scan_ref)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(arr: np.ndarray, dtype: str):
    """The same float32 numpy values as a jnp array and a torch tensor of
    ``dtype`` (bfloat16 rounds identically in both)."""
    j = jnp.asarray(arr, _JNP[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])


# ======================================================== flash attention
FLASH_CASES = [
    # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, dtype)
    (1, 2, 2, 128, 128, 64, True, None, 0, None, "float32"),
    (2, 4, 2, 128, 256, 64, True, None, 0, None, "float32"),
    (1, 2, 1, 256, 128, 128, False, None, 0, None, "float32"),
    (1, 2, 2, 128, 128, 64, True, 64, 0, None, "float32"),
    (1, 4, 4, 128, 128, 64, True, None, 0, None, "bfloat16"),
    (2, 8, 2, 128, 128, 32, True, None, 0, None, "bfloat16"),
    (1, 2, 2, 128, 256, 64, False, None, 0, 160, "float32"),    # kv_len
    (1, 2, 2, 128, 256, 64, True, None, 128, None, "float32"),  # q_offset
    (1, 8, 2, 100, 260, 80, True, 48, 0, None, "float32"),      # D 80
    (2, 8, 2, 1, 200, 80, True, None, 150, 151, "float32"),     # Lq = 1
    (1, 8, 2, 1, 64, 80, False, None, 0, 40, "bfloat16"),       # rolling
    (1, 2, 2, 64, 64, 32, True, 8, 0, 4, "float32"),            # masked rows
]


@functools.lru_cache(maxsize=None)
def _flash_case(i: int):
    b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, dtype = \
        FLASH_CASES[i]
    rng = np.random.default_rng(100 + i)
    q, tq = _both(rng.standard_normal((b, hq, lq, d)), dtype)
    k, tk = _both(rng.standard_normal((b, hkv, lk, d)), dtype)
    v, tv = _both(rng.standard_normal((b, hkv, lk, d)), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    return (q, k, v), (tq, tk, tv), kw, (2e-2 if dtype == "bfloat16"
                                         else 2e-5)


def _pallas(q, k, v, *, causal, window, q_offset, kv_len):
    """The Pallas kernel in interpret mode, padded to its 128-row blocks
    (padded keys masked through kv_len)."""
    lq, lk = q.shape[2], k.shape[2]
    pq, pk = -lq % 128, -lk % 128
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, 0), (0, n), (0, 0)))  # noqa
    out = fa_pallas(pad(q, pq), pad(k, pk), pad(v, pk), causal=causal,
                    window=window, q_offset=q_offset,
                    kv_len=lk if kv_len is None else kv_len, interpret=True)
    return out[:, :, :lq]


@pytest.mark.parametrize("i", range(len(FLASH_CASES)))
def test_attention_ref_matches_reference(i):
    (q, k, v), (tq, tk, tv), kw, tol = _flash_case(i)
    want = jax_attention(q, k, v, **kw)
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("i", range(len(FLASH_CASES)))
def test_attention_ref_matches_pallas_interpret(i):
    (q, k, v), (tq, tk, tv), kw, tol = _flash_case(i)
    want = _pallas(q, k, v, **kw)
    got = attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("i", [0, 3, 8, 9])
def test_attention_ref_matches_blocked(i):
    """The reference model's CPU attention (the blocked flash algorithm)."""
    (q, k, v), (tq, tk, tv), kw, tol = _flash_case(i)
    kv_len = kw["kv_len"] if kw["kv_len"] is not None else k.shape[2]
    want = blocked_attention(q, k, v, kw["causal"], kw["window"],
                             q.shape[-1] ** -0.5, kw["q_offset"], kv_len, 64)
    got = attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol, atol=tol)


def test_fully_masked_rows_are_zero():
    _, (tq, tk, tv), kw, _ = _flash_case(len(FLASH_CASES) - 1)
    out = attention_ref(tq, tk, tv, **kw)
    assert not bool(out[:, :, 12:].any()) and bool(out[:, :, :11].all())


@pytest.mark.parametrize("i", [1, 9])
def test_ops_attention_on_the_cpu_is_the_plain_version(i):
    _, (tq, tk, tv), kw, _ = _flash_case(i)
    assert torch.equal(fa_ops.attention(tq, tk, tv, **kw),
                       attention_ref(tq, tk, tv, **kw))


def test_kernel_wrappers_refuse_host_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is refused, never
    computed by a fallback."""
    _, (tq, tk, tv), kw, _ = _flash_case(0)
    with pytest.raises(ValueError, match="CUDA tensor expected"):
        flash_attention_cuda(tq, tk, tv, **kw)
    for mamba2, fn in ((True, ssd_scan_cuda), (False, s6_scan_cuda)):
        heads = (2, 8) if mamba2 else (16,)
        _, tx = _scan_args(_scan_np(1, 1, 4, mamba2, heads, 8))
        with pytest.raises(ValueError, match="CUDA tensor expected"):
            fn(*tx)


def test_ops_attention_refuses_other_devices():
    q = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.attention(q, q, q)


# ------------------------------------------- split-KV decode arithmetic
SPLIT_CASES = [
    # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, split_len)
    (2, 8, 2, 1, 300, 80, True, None, 250, 251, 64),     # growing cache
    (1, 8, 2, 1, 64, 80, False, None, 0, 40, 16),        # rolling slots
    (1, 1, 1, 64, 200, 64, True, 16, 100, None, 64),     # masked splits
    (1, 2, 2, 64, 64, 32, True, 8, 0, 4, 8),             # masked rows
    (1, 2, 1, 1, 64, 64, False, None, 0, 0, 64),         # no key at all
    (2, 4, 4, 16, 100, 16, True, 5, 40, None, 1),        # a key a split
    (1, 8, 2, 1, 4096, 80, False, None, 0, 4096, 256),   # danube's step
]


@functools.lru_cache(maxsize=None)
def _split_case(i: int):
    b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, split_len = \
        SPLIT_CASES[i]
    rng = np.random.default_rng(300 + i)
    q, tq = _both(rng.standard_normal((b, hq, lq, d)), "float32")
    k, tk = _both(rng.standard_normal((b, hkv, lk, d)), "float32")
    v, tv = _both(rng.standard_normal((b, hkv, lk, d)), "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    return (q, k, v), (tq, tk, tv), kw, split_len


@pytest.mark.parametrize("i", range(len(SPLIT_CASES)))
def test_split_decode_arithmetic_matches_both_references(i):
    """The split-and-combine arithmetic against the port's plain attention
    and the reference's jnp oracle (float32, 2e-5)."""
    (q, k, v), (tq, tk, tv), kw, split_len = _split_case(i)
    k_begin, k_end = fa_kernel.key_range(tq.shape[2], tk.shape[2], **kw)
    got = attention_split_ref(tq, tk, tv, k_begin=k_begin, k_end=k_end,
                              split_len=split_len, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np32(got), _np32(attention_ref(
        tq, tk, tv, **kw)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np32(got), _np32(jax_attention(q, k, v, **kw)),
                               rtol=2e-5, atol=2e-5)


def test_split_decode_masked_splits_and_rows_add_nothing():
    """Row 0 of case 2 sees only the first split; case 3's rows past
    kv_len + window see no key and give 0; case 4 (kv_len 0) is all 0."""
    _, (tq, tk, tv), kw, split_len = _split_case(2)
    k_begin, k_end = fa_kernel.key_range(64, 200, **kw)
    assert (k_begin, k_end) == (85, 164) and k_end - k_begin > split_len
    full = attention_split_ref(tq, tk, tv, k_begin=k_begin, k_end=k_end,
                               split_len=split_len, **kw)
    first = attention_split_ref(tq, tk, tv, k_begin=k_begin,
                                k_end=k_begin + split_len,
                                split_len=split_len, **kw)
    assert torch.equal(full[:, :, 0], first[:, :, 0])
    _, (tq, tk, tv), kw, split_len = _split_case(3)
    out = attention_split_ref(tq, tk, tv, k_begin=0, k_end=4,
                              split_len=split_len, **kw)
    assert not bool(out[:, :, 12:].any()) and bool(out[:, :, :11].all())
    _, (tq, tk, tv), kw, split_len = _split_case(4)
    k_begin, k_end = fa_kernel.key_range(1, 64, **kw)
    assert k_begin == k_end == 0
    out = attention_split_ref(tq, tk, tv, k_begin=k_begin, k_end=k_end,
                              split_len=split_len, **kw)
    assert not bool(out.any()) and not bool(out.isnan().any())


@pytest.mark.parametrize("dtype,lq,group,d,route", [
    (torch.bfloat16, 8192, 4, 80, "tc_prefill"),     # danube prefill
    (torch.bfloat16, 8192, 1, 80, "tc_prefill"),     # zamba2 prefill
    (torch.bfloat16, 1, 4, 80, "split_decode"),      # danube decode
    (torch.bfloat16, 1, 1, 80, "split_decode"),      # zamba2 decode
    (torch.float32, 1, 4, 80, "split_decode"),
    (torch.float32, 8192, 4, 80, "scalar"),          # float32 prefill
    (torch.bfloat16, 16, 4, 64, "split_decode"),     # 64 rows
    (torch.bfloat16, 17, 4, 64, "tc_prefill"),       # 68 rows
    (torch.bfloat16, 65, 1, 16, "tc_prefill"),
    (torch.bfloat16, 128, 2, 40, "scalar"),          # D not a multiple of 16
    (torch.bfloat16, 1, 2, 40, "scalar"),
    (torch.bfloat16, 128, 2, 128, "tc_prefill"),
    (torch.bfloat16, 128, 2, 144, "scalar"),         # no instance of 144
])
def test_choose_route(dtype, lq, group, d, route):
    assert fa_kernel.choose_route(dtype, lq, group, d) == route


@pytest.mark.parametrize("dtype,lq,group,dqk,dv,route", [
    (torch.bfloat16, 8192, 1, 192, 128, "tc_prefill"),   # MLA prefill
    (torch.bfloat16, 1, 1, 192, 128, "split_decode"),    # MLA expanded decode
    (torch.float32, 1, 1, 192, 128, "split_decode"),
    (torch.float32, 8192, 1, 192, 128, "scalar"),        # float32 prefill
    (torch.float32, 1, 56, 192, 128, "split_decode"),    # 56 rows fit
    (torch.float32, 1, 64, 192, 128, "scalar"),          # 64 do not
    (torch.bfloat16, 1, 64, 192, 128, "split_decode"),
    (torch.bfloat16, 8192, 1, 128, 192, "scalar"),       # no instance
    (torch.bfloat16, 8192, 1, 24, 16, "scalar"),         # TINY deepseek
    (torch.bfloat16, 8192, 1, 256, 256, "scalar"),
])
def test_choose_route_two_head_dims(dtype, lq, group, dqk, dv, route):
    """(dqk, dv) pairs without a tensor-core instance, and float32 decode
    blocks whose shared memory would pass the card's, take scalar."""
    assert fa_kernel.choose_route(dtype, lq, group, dqk, dv) == route
    rows = lq * group
    if rows <= fa_kernel.DECODE_ROWS and (dqk, dv) in fa_kernel.TC_DIMS:
        fits = fa_kernel.decode_smem_bytes(dtype, dqk, dv, rows) <= \
            fa_kernel.SMEM_MAX
        assert fits == (route == "split_decode")


def test_every_same_dim_decode_block_fits():
    """The served models' (dqk == dv) decode blocks all fit in shared
    memory at 64 rows, so adding dv moved none of them off split_decode."""
    for d in range(16, 129, 16):
        for dtype in (torch.float32, torch.bfloat16):
            assert fa_kernel.decode_smem_bytes(dtype, d, d, 64) <= \
                fa_kernel.SMEM_MAX


@pytest.mark.parametrize("args,want", [
    # (lq, lk, causal, window, q_offset, kv_len) -> [k_begin, k_end)
    ((1, 4096, False, None, 0, 4096), (0, 4096)),         # rolling, full
    ((1, 4096, False, None, 0, 17), (0, 17)),             # rolling, filling
    ((1, 8224, True, None, 8223, 8224), (0, 8224)),       # growing cache
    ((8192, 8192, True, 4096, 0, None), (0, 8192)),       # danube prefill
    ((64, 200, True, 16, 100, None), (85, 164)),
    ((4, 100, True, 8, 50, 20), (43, 43)),                # nothing visible
    ((1, 64, False, None, 0, 0), (0, 0)),
])
def test_key_range(args, want):
    assert fa_kernel.key_range(*args) == want


@pytest.mark.parametrize("batch,hkv,n_keys,want", [
    (2, 8, 4096, (16, 256)),          # danube decode: 256 blocks
    (2, 32, 8224, (5, 1664)),         # zamba2 decode: 320 blocks
    (1, 1, 0, (1, 64)),
    (1, 1, 1, (1, 64)),
    (4, 4, 64, (1, 64)),
    (600, 1, 100_000, (1, 100_032)),  # enough blocks without splitting
])
def test_decode_splits(batch, hkv, n_keys, want):
    assert fa_kernel.decode_splits(batch, hkv, n_keys) == want


@pytest.mark.parametrize("batch,hkv", [(1, 1), (2, 8), (2, 32), (4, 2),
                                       (16, 8), (1, 300)])
@pytest.mark.parametrize("n_keys", [1, 63, 64, 65, 1000, 4096, 8224,
                                    70_000])
def test_decode_splits_cover_the_keys_without_an_empty_split(batch, hkv,
                                                             n_keys):
    splits, split_len = fa_kernel.decode_splits(batch, hkv, n_keys, sms=132)
    assert split_len % fa_kernel.DECODE_TILE == 0
    assert splits * split_len >= n_keys > (splits - 1) * split_len
    tiles = -(-n_keys // fa_kernel.DECODE_TILE)
    # at least half the card's target of blocks, or one a tile (rounding
    # the tiles a split takes up can halve the split count)
    assert batch * hkv * splits >= min(
        fa_kernel.BLOCKS_PER_SM * 132, batch * hkv * tiles) * 0.5


def test_aligned_copies_only_what_the_16_byte_copies_cannot_read():
    buf = torch.zeros((2, 5, 3, 81), dtype=torch.bfloat16)
    permuted = torch.zeros((2, 7, 4, 80), dtype=torch.bfloat16).transpose(
        1, 2)                                # the model's q: row stride H hd
    assert fa_kernel._aligned(permuted) is permuted
    shifted = buf[..., 1:]                   # base 2 bytes off, rows 162 B
    fixed = fa_kernel._aligned(shifted)
    assert fixed is not shifted and fixed.is_contiguous()
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, shifted)


# ======================================================== selective scans
def _scan_np(seed, b, l, mamba2, heads, st, dt_zero=True):
    """Seeded inputs: heads = (nh, hd) for mamba2, (di,) for mamba1."""
    rng = np.random.default_rng(seed)
    if mamba2:
        nh, hd = heads
        shapes = ((b, l, nh, hd), (b, l, nh, st), (b, l, nh), (nh,),
                  (b, nh, hd, st))
    else:
        (di,) = heads
        shapes = ((b, l, di), (b, l, st), (b, l, di), (di, st), (b, di, st))
    xs, ss, dts, a_s, hs = shapes
    dt = rng.uniform(0, 0.5, dts)
    if dt_zero:
        dt[:, ::5] = 0.0                  # dt = 0 steps keep the state
    return dict(dtx=rng.standard_normal(xs), bh=rng.standard_normal(ss),
                ch=rng.standard_normal(ss), dt=dt,
                A=-rng.uniform(0.5, 2, a_s), h0=rng.standard_normal(hs))


def _scan_args(arrs, dtype="float32"):
    """(jax args, torch args): dtx/bh/ch in ``dtype``, dt/A/h0 float32."""
    jx, tx = [], []
    for name in ("dtx", "bh", "ch", "dt", "A", "h0"):
        j, t = _both(arrs[name], dtype if name in ("dtx", "bh", "ch")
                     else "float32")
        jx.append(j)
        tx.append(t)
    return jx, tx


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np32(g), _np32(w), rtol=tol, atol=tol)


SSD_SHAPES = [(1, 64, 2, 8, 8), (2, 160, 3, 16, 8), (1, 128, 4, 32, 16),
              (2, 1, 3, 8, 8), (1, 37, 2, 8, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_refs_match_reference(shape, dtype):
    b, l, nh, hd, st = shape
    jx, tx = _scan_args(_scan_np(sum(shape), b, l, True, (nh, hd), st),
                        dtype)
    want = jax_ssd(*jx)
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    y, h = scan_ref.ssd_scan_ref(*tx)
    assert y.dtype == tx[0].dtype and h.dtype == torch.float32
    _close((y, h), want, tol)
    _close(chunked_scan_ref(*tx, chunk=32), want, tol)


S6_SHAPES = [(2, 96, 128, 8), (2, 96, 256, 8), (1, 1, 64, 16),
             (2, 45, 100, 16)]


@pytest.mark.parametrize("shape", S6_SHAPES)
def test_s6_refs_match_reference(shape):
    b, l, di, st = shape
    jx, tx = _scan_args(_scan_np(sum(shape), b, l, False, (di,), st))
    want = jax_s6(*jx)
    _close(scan_ref.s6_scan_ref(*tx), want, 2e-4)
    _close(chunked_scan_ref(*tx, chunk=32), want, 2e-4)


@pytest.mark.parametrize("case", [
    # (mamba2, shape (b, l, *heads, st), blk)
    (True, (1, 64, 2, 8, 8), 32),
    (True, (2, 70, 3, 16, 8), 32),        # L not a multiple of blk (pads)
    (False, (2, 96, 128, 8), 32),
])
def test_scan_refs_match_pallas_interpret(case):
    mamba2, shape, blk = case
    b, l, *heads, st = shape
    jx, tx = _scan_args(_scan_np(7 + l, b, l, mamba2, tuple(heads), st))
    want = jax_scan(*jx, blk=blk, interpret=True, use_pallas=True)
    naive = scan_ref.ssd_scan_ref if mamba2 else scan_ref.s6_scan_ref
    _close(naive(*tx), want, 2e-4)
    _close(chunked_scan_ref(*tx, chunk=16), want, 2e-4)


@pytest.mark.parametrize("chunk", [1, 16, 256])
@pytest.mark.parametrize("case", [
    (True, (1, 64, 2, 8, 8)), (True, (2, 50, 3, 16, 16)),
    (False, (2, 50, 64, 8)), (False, (1, 1, 32, 16)),
])
def test_chunked_scan_matches_model_fused_scan(case, chunk):
    """The scan the reference model runs, ragged tail chunk included."""
    mamba2, shape = case
    b, l, *heads, st = shape
    jx, tx = _scan_args(_scan_np(3 + l + chunk, b, l, mamba2, tuple(heads),
                                 st))
    want = _fused_ssd_scan(*jx, chunk=chunk)
    _close(chunked_scan_ref(*tx, chunk=chunk), want, 2e-4)


def test_chunked_scan_with_zero_dt_keeps_the_state():
    jx, tx = _scan_args(_scan_np(5, 2, 20, True, (2, 8), 8, dt_zero=False))
    dtx, bh, ch, dt, A, h0 = tx
    y, h = chunked_scan_ref(torch.zeros_like(dtx), bh, ch,
                            torch.zeros_like(dt), A, h0, chunk=8)
    assert torch.equal(h, h0)


@pytest.mark.parametrize("mamba2", [True, False])
def test_selective_scan_on_the_cpu_is_the_chunked_scan(mamba2):
    heads = (2, 8) if mamba2 else (16,)
    _, tx = _scan_args(_scan_np(11, 2, 40, mamba2, heads, 8))
    got = scan_ops.selective_scan(*tx, chunk=16)
    want = chunked_scan_ref(*tx, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("l,h0_shape,want", [
    (1, (2, 80, 64, 64), "sequential"),          # a zamba2 decode step
    (1, (2, 8192, 16), "sequential"),            # a falcon-mamba-7b one
    (40, (2, 80, 64, 64), "sequential"),
    (40, (2, 8192, 16), "sequential"),
    (255, (2, 80, 64, 64), "sequential"),
    (256, (2, 80, 64, 64), "chunked"),
    (256, (1, 3, 16, 48), "chunked"),
    (63, (2, 8192, 16), "sequential"),
    (64, (2, 8192, 16), "chunked"),
    (8192, (2, 80, 64, 64), "chunked"),          # the prefills
    (8192, (2, 8192, 16), "chunked"),
    (8192, (2, 2, 512, 128), "sequential"),      # 1024 threads a head
    (8192, (2, 2, 30, 64), "sequential"),        # hd not a multiple of 4
    (8192, (2, 2, 128, 128), "chunked"),
])
def test_scan_choose_route(l, h0_shape, want):
    assert scan_kernel.choose_route(l, h0_shape) == want


@pytest.mark.parametrize("route,l,h0_shape,want", [
    (None, 40, (2, 80, 64, 64), "chunked"),      # short L: still chunked
    (None, 1, (2, 8192, 16), "chunked"),
    ("chunked", 8192, (2, 2, 128, 128), "chunked"),
    ("sequential", 40, (2, 80, 64, 64), "only the chunked route"),
    (None, 8192, (2, 2, 512, 128), "does not take a state"),
    (None, 300, (2, 2, 30, 64), "does not take a state"),
])
def test_scan_states_come_from_the_chunked_route(route, l, h0_shape, want):
    """Asked for the chunk states (the training forward), the wrappers take
    the chunked route at every L, and raise for the sequential route or a
    width the chunked route does not take."""
    if want == "chunked":
        assert scan_kernel._route("scan", route, l, h0_shape, True) == want
    else:
        with pytest.raises(ValueError, match=want):
            scan_kernel._route("scan", route, l, h0_shape, True)


# (mamba2, (b, l, *heads, st), blk of the Pallas kernel, stride-0 heads)
CHUNK_CASES = [
    (True, (1, 37, 2, 8, 16), 16, False),       # ragged L, h0 != 0
    (True, (2, 50, 3, 16, 8), 32, True),        # one B/C group, 3 heads
    (False, (2, 45, 128, 8), 32, False),        # mamba1, ragged L
]


@functools.lru_cache(maxsize=None)
def _chunk_case(i: int):
    """Seeded inputs (dt = 0 every fifth step, h0 != 0), the torch args
    (B/C a stride-0 view over the heads where the case says so) and the
    reference's naive and Pallas-interpret results."""
    mamba2, shape, blk, bcast = CHUNK_CASES[i]
    b, l, *heads, st = shape
    arrs = _scan_np(40 + i, b, l, mamba2, tuple(heads), st)
    if bcast:
        for k in ("bh", "ch"):
            arrs[k] = np.broadcast_to(arrs[k][:, :, :1], arrs[k].shape)
    jx, tx = _scan_args(arrs)
    if bcast:
        tx[1], tx[2] = (t[:, :, :1].expand(t.shape) for t in tx[1:3])
        assert tx[1].stride(2) == 0 and tx[2].stride(2) == 0
    naive = (jax_ssd if mamba2 else jax_s6)(*jx)
    pallas = jax_scan(*jx, blk=blk, interpret=True, use_pallas=True)
    return l, tx, naive, pallas


@pytest.mark.parametrize("chunk", [1, 3, 16, "L", "L+5"])
@pytest.mark.parametrize("i", range(len(CHUNK_CASES)))
def test_chunk_passes_match_reference_and_pallas(i, chunk):
    """The chunked route's three passes in plain PyTorch against the
    reference's naive scan and its Pallas kernel in interpret mode, 1e-4."""
    l, tx, naive, pallas = _chunk_case(i)
    q = {"L": l, "L+5": l + 5}.get(chunk, chunk)
    y, h = chunk_passes_ref(*tx, chunk=q)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close((y, h), naive, 1e-4)
    _close((y, h), pallas, 1e-4)


def test_chunk_passes_keep_the_state_over_zero_dt():
    _, tx = _scan_args(_scan_np(6, 2, 20, False, (16,), 8, dt_zero=False))
    dtx, bh, ch, dt, A, h0 = tx
    y, h = chunk_passes_ref(torch.zeros_like(dtx), bh, ch,
                            torch.zeros_like(dt), A, h0, chunk=8)
    assert torch.equal(h, h0)


# ------------------------------------------- MLA: dqk != dv (192 / 128)
MLA_CASES = [
    # (b, hq, hkv, lq, lk, dqk, dv, causal, q_offset, kv_len, dtype)
    (1, 4, 4, 128, 128, 192, 128, True, 0, None, "float32"),   # prefill
    (2, 2, 2, 100, 100, 192, 128, True, 0, None, "bfloat16"),  # ragged
    (1, 4, 4, 1, 140, 192, 128, True, 139, 140, "float32"),    # decode step
    (1, 4, 2, 64, 200, 24, 16, True, 100, None, "float32"),    # TINY, GQA
    (1, 2, 2, 64, 64, 192, 128, True, 0, 0, "float32"),        # no key
]


@functools.lru_cache(maxsize=None)
def _mla_case(i: int):
    b, hq, hkv, lq, lk, dqk, dv, causal, q_offset, kv_len, dtype = \
        MLA_CASES[i]
    rng = np.random.default_rng(700 + i)
    q, tq = _both(rng.standard_normal((b, hq, lq, dqk)), dtype)
    k, tk = _both(rng.standard_normal((b, hkv, lk, dqk)), dtype)
    v, tv = _both(rng.standard_normal((b, hkv, lk, dv)), dtype)
    kw = dict(causal=causal, window=None, q_offset=q_offset, kv_len=kv_len)
    return (q, k, v), (tq, tk, tv), kw, (2e-2 if dtype == "bfloat16"
                                         else 2e-5)


@pytest.mark.parametrize("i", range(len(MLA_CASES)))
def test_mla_attention_ref_matches_reference_and_pallas(i):
    """dv != dqk: the output takes v's head dim and the default scale is
    dqk ** -0.5, as the reference's oracle and its Pallas kernel (in
    interpret mode) compute."""
    (q, k, v), (tq, tk, tv), kw, tol = _mla_case(i)
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    assert got.shape == (*tq.shape[:3], tv.shape[3])
    for want in (jax_attention(q, k, v, **kw), _pallas(q, k, v, **kw)):
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=tol,
                                   atol=tol)
    if kw["kv_len"] == 0:
        assert not bool(got.any())


@pytest.mark.parametrize("i", [0, 2, 3])
def test_mla_split_decode_arithmetic_matches_reference(i):
    """The split-KV decode's arithmetic with dv != dqk, splits of 32 keys."""
    (q, k, v), (tq, tk, tv), kw, tol = _mla_case(i)
    k_begin, k_end = fa_kernel.key_range(tq.shape[2], tk.shape[2], **kw)
    got = attention_split_ref(tq, tk, tv, k_begin=k_begin, k_end=k_end,
                              split_len=32, **kw)
    assert got.shape == (*tq.shape[:3], tv.shape[3])
    np.testing.assert_allclose(_np32(got), _np32(jax_attention(q, k, v,
                                                               **kw)),
                               rtol=tol, atol=tol)


# ------------------------------------------------- the training path:
# the attention Function (lse, blocked backward) and the scan Function
# against the reference's VJPs, float32
from repro.kernels.flash_attention import blocked as jax_blocked  # noqa: E402

from repro_torch.kernels.flash_attention.blocked import (  # noqa: E402
    attention_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    EMPTY_LSE, attention_lse_ref)
from repro_torch.kernels.ssm_scan.backward import scan_bwd  # noqa: E402

ATTN_GRAD_CASES = [
    # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len)
    (2, 4, 4, 37, 37, 16, True, None, 0, None),      # ragged L
    (1, 8, 2, 50, 50, 8, True, None, 0, None),       # GQA 4
    (2, 4, 1, 40, 40, 16, True, 12, 0, None),        # window, GQA 4
    (1, 4, 2, 20, 60, 8, True, None, 40, None),      # q_offset
    (1, 2, 2, 30, 30, 8, False, 8, 0, None),         # window, no causal
    (1, 2, 1, 24, 70, 16, True, 10, 46, 60),         # window, offset, kv_len
    (1, 2, 2, 16, 16, 8, True, None, 0, 0),          # no key for any row
    (1, 4, 2, 33, 33, 24, True, None, 0, None, 16),  # MLA: dv 16 != 24
]


def _attn_inputs(case, seed):
    """(q, k, v, g); a case's optional 11th entry is v's head dim."""
    b, hq, hkv, lq, lk, d = case[:6]
    dv = case[10] if len(case) > 10 else d
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, dv),
                      (b, hq, lq, dv))]


@pytest.mark.parametrize("i", range(len(ATTN_GRAD_CASES)))
def test_attention_fn_matches_reference_vjp(i):
    """Output, lse and (dq, dk, dv) of the attention Function against the
    reference's blocked attention (``_fwd``'s lse, ``jax.vjp`` of
    ``blocked_attention`` with 16-key blocks), float32 within 1e-5; a row
    that sees no key has lse -1e30 and adds no gradient."""
    case = ATTN_GRAD_CASES[i]
    _, _, _, _, lk, d, causal, window, q_offset, kv_len = case[:10]
    q, k, v, g = _attn_inputs(case, i)
    scale = d ** -0.5
    kvl = lk if kv_len is None else kv_len
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _, lse_r = jax_blocked._fwd(jq, jk, jv, causal, window, scale,
                                q_offset, kvl, 16)
    out_r, vjp = jax.vjp(lambda a, b_, c: blocked_attention(
        a, b_, c, causal, window, scale, q_offset, kvl, 16, False),
        jq, jk, jv)
    grads_r = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len)
    out = fa_ops.attention(*leaves, **kw)
    out.backward(torch.from_numpy(g))
    _, lse = fa_ops.attention_lse(*(x.detach() for x in leaves), **kw)
    for got, want in zip([out, lse] + [x.grad for x in leaves],
                         [out_r, lse_r] + list(grads_r)):
        np.testing.assert_allclose(_np32(got.detach()), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    if kv_len == 0:
        assert bool((lse == EMPTY_LSE).all())
        assert not any(bool(x.grad.any()) for x in leaves)


@pytest.mark.parametrize("block", [1, 7, 1024])
@pytest.mark.parametrize("i", [0, 2, 5])
def test_blocked_backward_does_not_depend_on_the_block(i, block):
    """The key block of the backward changes the sums' grouping only."""
    case = ATTN_GRAD_CASES[i]
    _, _, _, _, _, _, causal, window, q_offset, kv_len = case[:10]
    q, k, v, g = (torch.from_numpy(x) for x in _attn_inputs(case, i))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len)
    out, lse = attention_lse_ref(q, k, v, **kw)
    ref = attention_bwd(q, k, v, out, lse, g, block=1024, **kw)
    got = attention_bwd(q, k, v, out, lse, g, block=block, **kw)
    for a, b_ in zip(got, ref):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)


SCAN_GRAD_CASES = [
    # (mamba2, b, l, heads, st, chunk, h0 nonzero)
    (True, 2, 37, (3, 4), 5, 16, True),      # ragged L, three chunks
    (True, 1, 50, (2, 8), 4, 7, False),      # h0 = 0
    (True, 2, 16, (3, 4), 6, 16, True),      # one whole chunk
    (False, 2, 37, (6,), 4, 16, True),
    (False, 1, 50, (5,), 3, 7, False),
    (False, 2, 5, (4,), 8, 16, True),        # L shorter than the chunk
]


def _scan_case(case, seed):
    mamba2, b, l, heads, st, chunk, h0_nz = case
    rng = np.random.default_rng(seed)
    if mamba2:
        nh, hd = heads
        shapes = ((b, l, nh, hd), (b, l, nh, st), (b, l, nh, st),
                  (b, l, nh), (nh,), (b, nh, hd, st))
    else:
        (di,) = heads
        shapes = ((b, l, di), (b, l, st), (b, l, st), (b, l, di), (di, st),
                  (b, di, st))
    x, bm, cm, _, _, h0 = (rng.standard_normal(s).astype(np.float32)
                           for s in shapes)
    dt = rng.uniform(0.01, 0.5, shapes[3]).astype(np.float32)
    dt[:, ::6] = 0.0
    A = -rng.uniform(0.5, 2.0, shapes[4]).astype(np.float32)
    if not h0_nz:
        h0 = np.zeros_like(h0)
    gy = rng.standard_normal(shapes[0]).astype(np.float32)
    gh = rng.standard_normal(shapes[5]).astype(np.float32)
    return [x, bm, cm, dt, A, h0], gy, gh, chunk


def _jax_scan_grads(ins, gy, gh, chunk):
    def f(*a):
        y, h = _fused_ssd_scan(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    return jax.grad(f, argnums=tuple(range(6)))(
        *[jnp.asarray(x) for x in ins])


@pytest.mark.parametrize("states", ["given", "passes"])
@pytest.mark.parametrize("i", range(len(SCAN_GRAD_CASES)))
def test_scan_fn_grads_match_reference(i, states):
    """Gradients of (dtx, B, C, dt, A, h0) against ``jax.grad`` through
    the reference model's chunked scan, float32 within 1e-4 of each one's
    largest magnitude: through the scan Function (the chunk states its
    forward kept) and through the backward given the states of the plain
    three passes (the carry that the card's chunked route leaves)."""
    ins, gy, gh, chunk = _scan_case(SCAN_GRAD_CASES[i], i)
    want = _jax_scan_grads(ins, gy, gh, chunk)
    if states == "given":
        leaves = [torch.from_numpy(x).requires_grad_() for x in ins]
        y, h = scan_ops.selective_scan(*leaves, chunk=chunk)
        ((y * torch.from_numpy(gy)).sum()
         + (h * torch.from_numpy(gh)).sum()).backward()
        got = [x.grad for x in leaves]
    else:
        t = [torch.from_numpy(x) for x in ins]
        states_in = chunk_passes_ref(*t, chunk=chunk, return_states=True)[2]
        got = scan_bwd(*t, states_in, chunk, torch.from_numpy(gy),
                       torch.from_numpy(gh))
    for n, (g_, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.abs(_np32(g_) - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-30), n


def test_scan_fn_sums_a_broadcast_head_axis():
    """B/C as one group broadcast over the heads (the model's call): the
    gradient of the group is the heads' sum, as the reference's."""
    ins, gy, gh, chunk = _scan_case(SCAN_GRAD_CASES[0], 9)
    bm1, cm1 = ins[1][:, :, :1], ins[2][:, :, :1]
    nh = ins[1].shape[2]

    def f(x, bg, cg, dt, A, h0):
        y, h = _fused_ssd_scan(x, jnp.broadcast_to(bg, ins[1].shape),
                               jnp.broadcast_to(cg, ins[2].shape), dt, A,
                               h0, chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(f, argnums=(1, 2))(*[jnp.asarray(x) for x in (
        ins[0], bm1, cm1, ins[3], ins[4], ins[5])])
    bg, cg = (torch.from_numpy(x).requires_grad_() for x in (bm1, cm1))
    y, h = scan_ops.selective_scan(
        torch.from_numpy(ins[0]), bg.expand(-1, -1, nh, -1),
        cg.expand(-1, -1, nh, -1),
        *[torch.from_numpy(x) for x in ins[3:]], chunk=chunk)
    ((y * torch.from_numpy(gy)).sum()
     + (h * torch.from_numpy(gh)).sum()).backward()
    for g_, w in zip((bg.grad, cg.grad), want):
        w = np.asarray(w)
        assert np.abs(_np32(g_) - w).max() <= 1e-4 * np.abs(w).max()


@pytest.mark.parametrize("chunk", [3, 16, 64])
@pytest.mark.parametrize("mamba2", [True, False])
def test_chunked_scan_ref_returns_its_chunk_states(mamba2, chunk):
    """The plain chunked scan's incoming states equal the plain three
    passes' carry, and the first is h0."""
    ins, _, _, _ = _scan_case(SCAN_GRAD_CASES[0 if mamba2 else 3], 4)
    t = [torch.from_numpy(x) for x in ins]
    y, h, states = chunked_scan_ref(*t, chunk=chunk, return_states=True)
    y2, h2, states2 = chunk_passes_ref(*t, chunk=chunk, return_states=True)
    assert states.shape[1] == -(-t[0].shape[1] // chunk)
    torch.testing.assert_close(states[:, 0], t[5])
    torch.testing.assert_close(states, states2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, h2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lq,group,route", [(64, 1, "scalar"),
                                             (1, 4, "scalar"),
                                             (65, 1, "tc_prefill"),
                                             (4096, 1, "tc_prefill")])
def test_choose_route_with_lse(lq, group, route):
    """A call that must return lse never takes split_decode, which writes
    none; bf16 prefill keeps tc_prefill."""
    assert fa_kernel.choose_route(torch.bfloat16, lq, group, 80,
                                  lse=True) == route
