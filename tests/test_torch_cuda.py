"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the reference package.)
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree

from repro_torch.configs import get_config, register_config
from repro_torch.core import Box, Checkpoint, CraftEnv
from repro_torch.kernels.checksum import ops as ck_ops
from repro_torch.kernels.checksum.kernel import checksum_rows
from repro_torch.kernels.checksum.ref import checksum_rows_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.rs_erasure import ops as rs_ops
from repro_torch.kernels.rs_erasure.kernel import gf_matmul_cuda
from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
from repro_torch.kernels.snapshot.ref import snapshot_ref
from repro_torch.kernels.ssm_scan import kernel as scan_kernel
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.kernel import s6_scan_cuda, ssd_scan_cuda
from repro_torch.kernels.ssm_scan.ref import (chunk_passes_ref,
                                              chunked_scan_ref, s6_scan_ref,
                                              ssd_scan_ref)
from repro_torch.kernels.xor_parity import ops as xor_ops
from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda
from repro_torch.kernels.xor_parity.ref import xor_reduce_ref
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import steps as S

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


# ------------------------------------------------------------ LM kernels
FLASH_CASES = [
    # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, route);
    # route "prefill": tc_prefill in bfloat16, scalar in float32
    (1, 2, 2, 128, 128, 64, True, None, 0, None, "prefill"),       # group 1
    (2, 8, 2, 100, 260, 80, True, None, 160, None, "prefill"),     # ragged
    (1, 4, 1, 70, 70, 128, True, 16, 0, None, "prefill"),          # window
    (2, 4, 4, 64, 200, 80, False, None, 0, 137, "split_decode"),   # kv_len
    (1, 8, 2, 1, 300, 80, True, None, 250, 251, "split_decode"),   # growing
    (1, 8, 2, 1, 64, 80, False, None, 0, 40, "split_decode"),      # rolling
    (1, 2, 2, 64, 64, 32, True, 8, 0, 4, "split_decode"),          # masked
    # the routes and their edges
    (1, 2, 1, 200, 200, 16, True, None, 0, None, "prefill"),       # D 16
    (1, 2, 2, 300, 300, 128, True, None, 0, None, "prefill"),      # D 128
    (2, 4, 2, 333, 517, 80, True, None, 184, None, "prefill"),     # ragged
    (1, 4, 2, 257, 400, 64, True, 100, 143, None, "prefill"),      # window
    (1, 4, 4, 200, 300, 80, False, 50, 0, 230, "prefill"),         # no causal
    (2, 2, 2, 140, 140, 64, True, 8, 0, 4, "prefill"),             # masked
    (1, 2, 2, 100, 100, 40, True, None, 0, None, "scalar"),        # D 40
    (1, 4, 2, 1, 40, 40, True, None, 39, 40, "scalar"),            # D 40
    (1, 2, 1, 1, 1, 64, True, None, 0, 1, "split_decode"),         # kv_len 1
    (2, 8, 8, 1, 64, 64, True, None, 63, 64, "split_decode"),      # 64
    (1, 32, 8, 1, 4096, 80, False, None, 0, 4096, "split_decode"),
    (1, 32, 32, 1, 8224, 80, True, None, 8223, 8224, "split_decode"),
    (1, 1, 1, 64, 200, 64, True, 16, 100, None, "split_decode"),   # a split
    (1, 2, 1, 1, 64, 64, False, None, 0, 0, "split_decode"),       # no key
    (1, 4, 1, 16, 600, 128, True, 300, 580, None, "split_decode"),  # 64 rows
    # the frontend models' and kimi's instances: musicgen's D 64 at group
    # 1, llava's group 7 and kimi's group 8 at D 128, over a prefix plus a
    # ragged 211 (Lq not a multiple of the 128-row tile); decode rows
    # (Lq x group) of 1, 7 (the last row group padded) and 8 at both dims
    (1, 4, 4, 64 + 211, 64 + 211, 64, True, None, 0, None, "prefill"),
    (1, 14, 2, 1152 + 211, 1152 + 211, 128, True, None, 0, None,
     "prefill"),
    (1, 16, 2, 1152 + 211, 1152 + 211, 128, True, None, 0, None,
     "prefill"),
    (2, 24, 24, 1, 8257, 64, True, None, 8256, 8257, "split_decode"),
    (1, 8, 8, 1, 8257, 128, True, None, 8256, 8257, "split_decode"),
    (1, 14, 2, 1, 9376, 64, True, None, 9375, 9376, "split_decode"),
    (2, 56, 8, 1, 9376, 128, True, None, 9375, 9376, "split_decode"),
    (1, 16, 2, 1, 8257, 64, True, None, 8256, 8257, "split_decode"),
    (2, 64, 8, 1, 8224, 128, True, None, 8223, 8224, "split_decode"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len, route = case
    if route == "prefill":
        route = "tc_prefill" if dtype == torch.bfloat16 else "scalar"
    g = torch.Generator(device=cuda).manual_seed(lq * 7 + lk)
    q = torch.randn((b, lq, hq, d), generator=g, device=cuda,
                    dtype=dtype).transpose(1, 2)          # strided q
    k = torch.randn((b, hkv, lk, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((b, hkv, lk, d), generator=g, device=cuda, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    launches = flash_attention_cuda.launches
    routes = dict(flash_attention_cuda.routes)
    out = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == launches + 1
    assert {r: n - routes[r] for r, n in flash_attention_cuda.routes.items()
            } == {r: int(r == route) for r in routes}
    ref = attention_ref(q, k, v, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if kv_len == 4:                 # rows past kv_len + window see no key
        assert not bool(out[:, :, 12:].any())
    if kv_len == 0:
        assert not bool(out.any())
    if route == "split_decode":
        k_begin, k_end = fa_kernel.key_range(lq, lk, causal, window,
                                             q_offset, kv_len)
        splits, _ = fa_kernel.decode_splits(
            b, hkv, k_end - k_begin, fa_kernel._sm_count(cuda.index or 0))
        if kv_len in (1, 64):
            assert splits == 1
        if kv_len in (4096, 8224):
            assert splits > 1


MLA_CASES = [
    # (b, hq, hkv, lq, lk, dqk, dv, causal, q_offset, kv_len, route): v's
    # head dim apart from q's and k's (MLA: 128 + 64 and 128); route
    # "prefill": tc_prefill in bfloat16, scalar in float32; "rows": 64 rows,
    # split_decode in bfloat16, scalar in float32 (its block would not fit)
    (1, 4, 4, 200, 200, 192, 128, True, 0, None, "prefill"),
    (2, 2, 2, 333, 517, 192, 128, True, 184, None, "prefill"),     # ragged
    (1, 2, 2, 140, 140, 192, 128, True, 0, 4, "prefill"),          # kv_len
    (1, 8, 8, 1, 300, 192, 128, True, 299, 300, "split_decode"),
    (2, 128, 128, 1, 8224, 192, 128, True, 8223, 8224, "split_decode"),
    (1, 2, 2, 64, 64, 192, 128, True, 0, 0, "rows"),               # no key
    (1, 64, 1, 1, 300, 192, 128, True, 299, 300, "rows"),
    (1, 2, 2, 100, 100, 24, 16, True, 0, None, "scalar"),          # TINY
    (1, 2, 2, 150, 150, 256, 256, True, 0, None, "scalar"),        # D_MAX
    (1, 2, 1, 70, 90, 192, 256, True, 20, None, "scalar"),         # dv 256
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_CASES)
def test_flash_attention_two_head_dims_match_plain(cuda, case, dtype):
    """dv != dqk on every route: the output takes v's head dim, the
    default scale is dqk ** -0.5, each call's route is the rule's."""
    b, hq, hkv, lq, lk, dqk, dv, causal, q_offset, kv_len, route = case
    bf16 = dtype == torch.bfloat16
    route = {"prefill": "tc_prefill" if bf16 else "scalar",
             "rows": "split_decode" if bf16 else "scalar"}.get(route, route)
    g = torch.Generator(device=cuda).manual_seed(lq * 7 + lk + dqk)
    q = torch.randn((b, lq, hq, dqk), generator=g, device=cuda,
                    dtype=dtype).transpose(1, 2)          # strided q
    k = torch.randn((b, hkv, lk, dqk), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((b, hkv, lk, dv), generator=g, device=cuda, dtype=dtype)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    routes = dict(flash_attention_cuda.routes)
    out = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {r: n - routes[r] for r, n in flash_attention_cuda.routes.items()
            } == {r: int(r == route) for r in routes}
    assert route == fa_kernel.choose_route(dtype, lq, hq // hkv, dqk, dv)
    assert out.shape == (b, hq, lq, dv) and out.dtype == dtype
    ref = attention_ref(q, k, v, **kw)
    tol = 2e-2 if bf16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if kv_len == 0:
        assert not bool(out.any())


def test_flash_attention_copies_a_misaligned_q(cuda):
    """A q whose rows do not start on 16 bytes is copied, not sent to
    another route."""
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn((2, 4, 160, 81), generator=g, device=cuda,
                      dtype=torch.bfloat16)
    q = buf[..., 1:]
    k = torch.randn((2, 2, 160, 80), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    for lq in (160, 1):
        routes = dict(flash_attention_cuda.routes)
        out = flash_attention_cuda(q[:, :, :lq], k, v, causal=True,
                                   q_offset=160 - lq)
        want = "tc_prefill" if lq > 1 else "split_decode"
        assert flash_attention_cuda.routes[want] == routes[want] + 1
        ref = attention_ref(q[:, :, :lq], k, v, causal=True,
                            q_offset=160 - lq)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


def _scan_inputs(cuda, shape, dtype, seed, mamba2=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, l = shape[:2]
    if mamba2:
        _, _, nh, hd, st = shape
        xs, ss, dts, a_s, hs = ((b, l, nh, hd), (b, l, nh, st), (b, l, nh),
                                (nh,), (b, nh, hd, st))
    else:
        _, _, di, st = shape
        xs, ss, dts, a_s, hs = ((b, l, di), (b, l, st), (b, l, di),
                                (di, st), (b, di, st))
    dtx = torch.randn(xs, generator=g, device=cuda).to(dtype)
    bh = torch.randn(ss, generator=g, device=cuda).to(dtype)
    ch = torch.randn(ss, generator=g, device=cuda).to(dtype)
    dt = torch.rand(dts, generator=g, device=cuda) * 0.5
    dt[:, ::5] = 0.0                      # dt = 0 steps keep the state
    A = -(0.5 + 1.5 * torch.rand(a_s, generator=g, device=cuda))
    h0 = torch.randn(hs, generator=g, device=cuda)
    return dtx, bh, ch, dt, A, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 2, 8, 8), (2, 160, 3, 16, 8),
                                   (1, 128, 4, 32, 16), (2, 1, 3, 64, 64),
                                   (1, 37, 2, 64, 64), (1, 33, 2, 16, 48)])
def test_ssd_scan_matches_plain(cuda, shape, dtype):
    args = _scan_inputs(cuda, shape, dtype, sum(shape))
    launches = ssd_scan_cuda.launches
    y, h = ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == launches + 1
    y_r, h_r = ssd_scan_ref(*args)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_r, rtol=tol, atol=tol)


def test_ssd_scan_takes_broadcast_groups(cuda):
    dtx, bh, ch, dt, A, h0 = _scan_inputs(cuda, (2, 50, 4, 16, 16),
                                          torch.float32, 3)
    bg = bh[:, :, :1].expand_as(bh)       # one B/C group over 4 heads
    cg = ch[:, :, :1].expand_as(ch)
    y, h = ssd_scan_cuda(dtx, bg, cg, dt, A, h0)
    y_r, h_r = ssd_scan_ref(dtx, bg.contiguous(), cg.contiguous(), dt, A, h0)
    torch.testing.assert_close(y, y_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 96, 128, 8), (2, 96, 256, 8),
                                   (1, 1, 64, 16), (2, 45, 100, 16),
                                   (1, 20, 70, 32), (1, 17, 64, 40)])
def test_s6_scan_matches_plain(cuda, shape, dtype):
    args = _scan_inputs(cuda, shape, dtype, sum(shape), mamba2=False)
    launches = s6_scan_cuda.launches
    y, h = s6_scan_cuda(*args)
    torch.cuda.synchronize()
    assert s6_scan_cuda.launches == launches + 1
    y_r, h_r = s6_scan_ref(*args)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_r, rtol=tol, atol=tol)


# (mamba2, shape without L, B/C one group broadcast over the heads)
SCAN_ROUTE_CASES = [
    (True, (2, 3, 64, 64), True),     # the path's layout; 2 + 1 heads a block
    (True, (1, 4, 16, 48), False),    # st not a multiple of 16, 4 threads a row
    (False, (2, 100, 16), None),      # a ragged block of 36 channels
    (False, (1, 70, 40), None),       # st 40
]


def _route_args(cuda, case, l, dtype, seed):
    mamba2, rest, bcast = case
    args = list(_scan_inputs(cuda, (rest[0], l, *rest[1:]), dtype, seed,
                             mamba2=mamba2))
    if bcast:
        args[1] = args[1][:, :, :1].expand_as(args[1])
        args[2] = args[2][:, :, :1].expand_as(args[2])
    return args, ssd_scan_cuda if mamba2 else s6_scan_cuda


def _scan_counts(fn):
    return fn.launches, dict(fn.routes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1000, 4100])
@pytest.mark.parametrize("case", SCAN_ROUTE_CASES)
def test_chunked_scans_match_plain(cuda, case, l, dtype):
    """Several chunks and a ragged tail, h0 != 0, dt = 0 steps: the
    chunked route against the plain scan, one launch counted."""
    args, fn = _route_args(cuda, case, l, dtype, l + len(case[1]))
    launches, routes = _scan_counts(fn)
    y, h = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert fn.routes["chunked"] == routes["chunked"] + 1
    plain = ssd_scan_ref if case[0] else s6_scan_ref
    y_r, h_r = plain(*[a.contiguous() for a in args])
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_r, rtol=tol, atol=tol)


@pytest.mark.parametrize("l", [1, 40])
@pytest.mark.parametrize("case", SCAN_ROUTE_CASES)
def test_short_scans_take_sequential(cuda, case, l):
    args, fn = _route_args(cuda, case, l, torch.float32, 7)
    launches, routes = _scan_counts(fn)
    fn(*args)
    assert fn.launches == launches + 1
    assert fn.routes["sequential"] == routes["sequential"] + 1
    assert fn.routes["chunked"] == routes["chunked"]


@pytest.mark.parametrize("l", [300, 1000])
@pytest.mark.parametrize("case", SCAN_ROUTE_CASES)
def test_chunked_equals_sequential(cuda, case, l):
    """Both routes, and the plain three passes, on the same inputs (a
    ragged last chunk: 300 = 2 * 128 + 44, 1000 = 7 * 128 + 104)."""
    args, fn = _route_args(cuda, case, l, torch.float32, 11)
    y_s, h_s = fn(*args, route="sequential")
    got = {"chunked": fn(*args, route="chunked"),
           "chunk_passes_ref": chunk_passes_ref(*args,
                                                chunk=scan_kernel.CHUNK)}
    for what, (y, h) in got.items():
        torch.testing.assert_close(y, y_s, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{what} y: {m}")
        torch.testing.assert_close(h, h_s, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{what} h_last: {m}")


def test_chunked_scan_takes_unaligned_views(cuda):
    """dtx, B and C that start 4 bytes off a 16-byte boundary take the
    element-wise copies; the result is the same as from aligned copies."""
    args, fn = _route_args(cuda, SCAN_ROUTE_CASES[2], 600, torch.float32, 5)
    shifted = []
    for t in args[:3]:
        buf = torch.empty(t.shape[:-1] + (t.shape[-1] + 1,), device=cuda)
        buf[..., 1:] = t
        shifted.append(buf[..., 1:])
    assert shifted[0].data_ptr() % 16 == 4
    y, h = fn(*shifted, *args[3:], route="chunked")
    y_a, h_a = fn(*args, route="chunked")
    torch.testing.assert_close(y, y_a, rtol=0, atol=0)
    torch.testing.assert_close(h, h_a, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-2.7b",
                                  "falcon-mamba-7b", "deepseek-v3-671b",
                                  "kimi-k2-1t-a32b", "musicgen-medium",
                                  "llava-next-34b"])
def test_tiny_serve_on_the_card_equals_cpu(cuda, arch):
    """float32 TINY serve: the card's greedy tokens equal the CPU's (the
    frontend models after their stub prefix)."""
    name = f"{arch}-tiny-f32-card"
    tiny = get_config(arch, tiny=True).replace(param_dtype="float32")
    register_config(name, tiny, tiny)
    sc = serve.ServeConfig(arch=name, batch=2, prompt_len=40, gen_tokens=8)
    params = M.init_params(torch.Generator().manual_seed(0), tiny, "cpu")
    cpu = serve.run(dataclasses.replace(sc, device="cpu"), params=params)
    before = (flash_attention_cuda.launches, ssd_scan_cuda.launches,
              s6_scan_cuda.launches)
    card_params = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    card = serve.run(dataclasses.replace(sc, device="cuda"),
                     params=card_params)
    after = (flash_attention_cuda.launches, ssd_scan_cuda.launches,
             s6_scan_cuda.launches)
    assert card["logits_finite"] and cpu["logits_finite"]
    np.testing.assert_array_equal(card["tokens"], cpu["tokens"])
    used = {"h2o-danube-1.8b": (0,), "zamba2-2.7b": (0, 1),
            "falcon-mamba-7b": (2,), "deepseek-v3-671b": (0,),
            "kimi-k2-1t-a32b": (0,), "musicgen-medium": (0,),
            "llava-next-34b": (0,)}[arch]
    for i in used:
        assert after[i] > before[i]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "falcon-mamba-7b"])
def test_tiny_chunked_prefill_on_the_card_matches_cpu(cuda, arch):
    """float32 TINY prefill of 300 tokens: every scan call on the chunked
    route, the logits and the SSM states within 2e-4 of the CPU's plain
    chunked scan (the bound of the float32 model tests)."""
    tiny = get_config(arch, tiny=True).replace(param_dtype="float32")
    b, prompt = 2, 300
    params = M.init_params(torch.Generator().manual_seed(0), tiny, "cpu")
    card_params = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tiny.vocab, (b, prompt), dtype=np.int32))
    fn = ssd_scan_cuda if arch == "zamba2-2.7b" else s6_scan_cuda
    routes = dict(fn.routes)
    cpu_cache, cpu_log = S.make_prefill(tiny, b, prompt + 1, "cpu")(
        params, tokens)
    card_cache, card_log = S.make_prefill(tiny, b, prompt + 1, cuda)(
        card_params, tokens.to(cuda))
    used = {r: n - routes[r] for r, n in fn.routes.items()}
    assert used["chunked"] > 0 and used["sequential"] == 0
    np.testing.assert_allclose(card_log.cpu().numpy(), cpu_log.numpy(),
                               rtol=2e-4, atol=2e-4)
    for (path, c), (_, g) in zip(
            torch.utils._pytree.tree_flatten_with_path(cpu_cache)[0],
            torch.utils._pytree.tree_flatten_with_path(card_cache)[0]):
        if c.dtype == torch.float32:
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=str(path))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-2.7b"])
def test_tiny_bf16_logits_on_the_card_match_cpu(cuda, arch):
    """bf16 TINY prefill of 80 tokens (tc_prefill: 80 or more rows) and 40
    decode steps past danube's 32-slot window (split_decode) on the card
    against the CPU's plain versions, both fed the CPU's greedy tokens:
    logits within 0.15, the bf16 bound of test_torch_models.py (the two
    devices round bf16 at other places); the scalar route never runs."""
    cfg = get_config(arch, tiny=True)
    assert cfg.param_dtype == "bfloat16"
    b, prompt, gen = 2, 80, 40
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card_params = torch.utils._pytree.tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, prompt), dtype=np.int32))
    routes = dict(flash_attention_cuda.routes)
    cpu_cache, cpu_log = S.make_prefill(cfg, b, prompt + gen, "cpu")(
        params, tokens)
    card_cache, card_log = S.make_prefill(cfg, b, prompt + gen, cuda)(
        card_params, tokens.to(cuda))
    decode = S.make_decode_step(cfg)
    for i in range(gen + 1):
        assert bool(torch.isfinite(card_log).all()), f"step {i}"
        np.testing.assert_allclose(card_log.float().cpu().numpy(),
                                   cpu_log.float().numpy(), rtol=0.15,
                                   atol=0.15, err_msg=f"step {i}")
        if i == gen:
            break
        nxt = torch.argmax(cpu_log, dim=-1).to(torch.int32)[:, None]
        cpu_cache, cpu_log = decode(params, cpu_cache, nxt, prompt + i)
        card_cache, card_log = decode(card_params, card_cache, nxt.to(cuda),
                                      prompt + i)
    used = {r: n - routes[r] for r, n in flash_attention_cuda.routes.items()}
    assert used["scalar"] == 0
    assert used["tc_prefill"] > 0 and used["split_decode"] > 0
    assert used["split_decode"] == gen * used["tc_prefill"]


# ------------------------------------------------ the training path (lse,
# the autograd Functions, AdamW on the card)
LSE_CASES = [
    # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len)
    (1, 2, 2, 128, 128, 64, True, None, 0, None),
    (2, 8, 2, 100, 260, 80, True, None, 160, None),     # GQA 4, ragged
    (1, 4, 1, 200, 200, 80, True, 16, 0, None),         # window
    (2, 2, 2, 140, 140, 64, True, 8, 0, 4),             # rows with no key
    (1, 2, 2, 100, 100, 64, False, None, 0, 0),         # kv_len 0
    (1, 2, 1, 40, 40, 64, True, None, 0, None),         # 40 rows: scalar
    (1, 4, 4, 160, 160, (192, 128), True, None, 0, None),  # MLA dims
    (1, 2, 2, 140, 140, (192, 128), True, 8, 0, 4),     # rows with no key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LSE_CASES)
def test_flash_lse_matches_plain(cuda, case, dtype):
    """The kernel's log-sum-exp on the tc_prefill (bf16, more than 64 rows)
    and scalar routes against the plain version's; -1e30 exactly where a
    row sees no key."""
    b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len = case
    d, dv = d if isinstance(d, tuple) else (d, d)
    g = torch.Generator(device=cuda).manual_seed(lq + lk + d)
    q = torch.randn((b, hq, lq, d), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((b, hkv, lk, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((b, hkv, lk, dv), generator=g, device=cuda, dtype=dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    routes = dict(flash_attention_cuda.routes)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want = ("tc_prefill" if dtype == torch.bfloat16 and lq * hq // hkv > 64
            else "scalar")
    assert flash_attention_cuda.routes[want] == routes[want] + 1
    out_r, lse_r = attention_lse_ref(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, lq)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), out_r.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_r, rtol=1e-5, atol=1e-4)
    empty = lse_r == -1e30
    if kv_len in (0, 4):
        assert bool(empty.any())
    assert torch.equal(lse == -1e30, empty)


GRAD_CASES = [
    # (b, hq, hkv, l, d, window); d a pair: (dqk, dv)
    (1, 2, 2, 160, 64, None),
    (2, 8, 2, 130, 80, None),
    (1, 4, 4, 200, 80, 32),
    (1, 8, 2, 96, 64, 40),
    (1, 4, 4, 160, (192, 128), None),                   # MLA
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_attention_fn_grads_match_plain(cuda, case, dtype):
    """The attention Function (kernel forward, blocked backward) against
    the plain version's autograd in float32 on the same values: output and
    gradients within 1e-4 (float32) or 2e-2 (bf16) of each one's max."""
    b, hq, hkv, l, d, window = case
    d, dv = d if isinstance(d, tuple) else (d, d)
    g = torch.Generator(device=cuda).manual_seed(l * d)
    q, k, v = (torch.randn((b, h, l, w), generator=g, device=cuda,
                           dtype=dtype) for h, w in ((hq, d), (hkv, d),
                                                     (hkv, dv)))
    dout = torch.randn((b, hq, l, dv), generator=g, device=cuda, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = flash_attention_cuda.launches
    out = fa_ops.attention(*leaves, causal=True, window=window)
    out.backward(dout)
    assert flash_attention_cuda.launches == launches + 1
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out_r = attention_ref(*ref_leaves, causal=True, window=window)
    out_r.backward(dout.float())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip([out] + [t.grad for t in leaves],
                         [out_r] + [t.grad for t in ref_leaves]):
        assert got.dtype == dtype
        err = float((got.detach().float() - want).abs().max())
        assert err <= tol * float(want.abs().max()), err


SCAN_GRAD_CASES = [
    (True, (2, 3, 64, 64)),      # zamba2's head layout
    (False, (2, 100, 16)),       # falcon-mamba's state
]


@pytest.mark.parametrize("l", [40, 300, 1000])
@pytest.mark.parametrize("case", SCAN_GRAD_CASES)
def test_scan_fn_grads_match_plain(cuda, case, l):
    """The scan Function, whose forward takes the chunked route at every
    L (40: one ragged chunk, where serving takes the sequential route; 300
    and 1000: several), its chunk states from the kernel, against the
    plain chunked scan's autograd, float32, h0 != 0, a stride-0 head axis
    of B/C for mamba2: every gradient within 1e-4 of its max."""
    mamba2, rest = case
    args = list(_scan_inputs(cuda, (rest[0], l, *rest[1:]), torch.float32,
                             l, mamba2=mamba2))
    if mamba2:
        base = [args[1][:, :, :1].clone(), args[2][:, :, :1].clone()]
    else:
        base = [args[1].clone(), args[2].clone()]
    g = torch.Generator(device=cuda).manual_seed(l + 1)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in
                  (args[0], base[0], base[1], args[3], args[4], args[5])]
        bh, ch = leaves[1], leaves[2]
        if mamba2:
            bh, ch = bh.expand_as(args[1]), ch.expand_as(args[2])
        y, h = fn(leaves[0], bh, ch, *leaves[3:])
        return leaves, y, h

    fn = ssd_scan_cuda if mamba2 else s6_scan_cuda
    routes = dict(fn.routes)
    leaves, y, h = run(lambda *a: scan_ops.selective_scan(*a, chunk=64))
    assert fn.routes == {**routes, "chunked": routes["chunked"] + 1}
    dy = torch.randn(y.shape, generator=g, device=cuda)
    dh = torch.randn(h.shape, generator=g, device=cuda)
    ((y * dy).sum() + (h * dh).sum()).backward()
    ref_leaves, y_r, h_r = run(
        lambda *a: chunked_scan_ref(*a, chunk=scan_kernel.CHUNK))
    ((y_r * dy).sum() + (h_r * dh).sum()).backward()
    for i, (got, want) in enumerate(zip(leaves, ref_leaves)):
        err = float((got.grad - want.grad).abs().max())
        assert err <= 1e-4 * float(want.grad.abs().max()), (i, err)


@pytest.mark.parametrize("l", [300, 1000])
@pytest.mark.parametrize("case", SCAN_ROUTE_CASES)
def test_chunked_route_returns_the_carry_states(cuda, case, l):
    """The chunked route's returned scratch: each chunk's incoming state,
    against the carry of the plain three passes; the sequential route
    keeps none, so asking it for them raises."""
    args, fn = _route_args(cuda, case, l, torch.float32, 13)
    y, h, states = fn(*args, route="chunked", return_states=True)
    _, _, states_r = chunk_passes_ref(*args, chunk=scan_kernel.CHUNK,
                                      return_states=True)
    assert states.shape == states_r.shape
    torch.testing.assert_close(states, states_r, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="only the chunked route"):
        fn(*args, route="sequential", return_states=True)


def _opt_tree(device, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (6, 40, 24), "emb": (50, 16), "ln": (6, 24), "b": (3,),
              "s": (2, 3)}
    return {k: torch.randn(v, generator=g).to(device)
            for k, v in shapes.items()}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_sliced_on_the_card_equals_whole_on_cpu(cuda, bits, master,
                                                     monkeypatch):
    """Three AdamW steps on CUDA tensors updated in slices of the leading
    axis (a slice of 100 values) against the same steps done whole on the
    CPU: float32 values within 1e-6 relative, int8 moments within one
    step.  No clipping (the two devices sum the norm in another order)."""
    ocfg = adamw.OptimConfig(lr=1e-2, warmup_steps=1, state_bits=bits,
                             master_fp32=master, clip_norm=1e9)
    out = {}
    for dev, elems in (("cpu", 1 << 30), (cuda, 100)):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", elems)
        params = _opt_tree(dev, 0)
        state = adamw.adamw_init(params, ocfg)
        for i in range(3):
            grads = _opt_tree(dev, 10 + i)
            params, state, m = adamw.adamw_update(grads, state, params, ocfg)
        out[str(dev)] = (params, state, float(m["grad_norm"]))
    (p_c, s_c, n_c), (p_g, s_g, n_g) = out["cpu"], out[str(cuda)]
    assert abs(n_c - n_g) <= 1e-6 * n_c
    flat_c = torch.utils._pytree.tree_flatten_with_path((p_c, s_c))[0]
    flat_g = torch.utils._pytree.tree_flatten_with_path((p_g, s_g))[0]
    for (path, c), (_, gpu) in zip(flat_c, flat_g):
        gpu = gpu.cpu()
        if c.dtype == torch.int8:
            assert int((c.int() - gpu.int()).abs().max()) <= 1, path
        else:
            torch.testing.assert_close(gpu, c, rtol=1e-6, atol=1e-7,
                                       msg=lambda m: f"{path}: {m}")


# -- the Lanczos app on the card ------------------------------------------
def test_lanczos_on_the_card_equals_cpu(cuda):
    """The same problem (drawn on the CPU) solved on the card and on the
    CPU: alphas and betas of 100 iterations at 64² within 1e-5."""
    from repro_torch.apps import lanczos as L

    cfg = L.GrapheneConfig(nx=64, ny=64, disorder=0.3)
    eps, v0 = L.onsite(cfg, "cpu"), L.start_vector(cfg, "cpu")
    cpu = L.run_lanczos(cfg, n_iter=100, device="cpu", init=(eps, v0))
    card = L.run_lanczos(cfg, n_iter=100, device=cuda,
                         init=(eps.to(cuda), v0.to(cuda)))
    np.testing.assert_allclose(card.alphas, cpu.alphas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.betas, cpu.betas, rtol=0, atol=1e-5)
    assert abs(card.eigenvalue - cpu.eigenvalue) < 1e-5


def test_lanczos_crash_and_rerun_on_the_card_is_bit_exact(cuda, tmp_path):
    from repro_torch.apps import lanczos as L

    cfg = L.GrapheneConfig(nx=64, ny=64, disorder=0.3)
    clean = L.run_lanczos(cfg, n_iter=100, device=cuda)
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(tmp_path),
                            "CRAFT_USE_SCR": "0"})
    with pytest.raises(RuntimeError, match="iteration 45"):
        L.run_lanczos(cfg, n_iter=100, cp_freq=20, env=env, fail_at=45,
                      device=cuda)
    res = L.run_lanczos(cfg, n_iter=100, cp_freq=20, env=env, device=cuda)
    assert res.restarted_at == 40
    assert np.array_equal(res.alphas, clean.alphas)
    assert np.array_equal(res.betas, clean.betas)


# -- the multi-process runtime on the card ---------------------------------
def _card_roundtrip(comm, base, device):
    """A Cluster worker (module level: spawn pickles it by name): one
    version of a rank-private 4 MiB tensor written and restored on the
    card, digests through the checksum kernel.  Returns host values."""
    torch.cuda.set_device(0)
    env = CraftEnv.capture({"CRAFT_CP_PATH": base, "CRAFT_USE_SCR": "0"})
    g = torch.Generator(device=device).manual_seed(comm.rank)
    x = torch.randn((1024, 1024), generator=g, device=device)
    with Checkpoint("card", comm, env=env, device=device) as cp:
        cp.add(f"x-{comm.rank}", Box(x))
        cp.commit()
        cp.update_and_write(1)
    live = Box(torch.zeros_like(x))
    with Checkpoint("card", comm, env=env, device=device) as cp:
        cp.add(f"x-{comm.rank}", live)
        cp.commit()
        restored = cp.restart_if_needed()
    return {"restored": restored, "equal": bool(torch.equal(live.value, x)),
            "launches": checksum_rows.launches}


def test_cluster_writes_and_restores_on_the_card(cuda, tmp_path):
    """Two worker processes, each with its own CUDA context, write one
    version and restore it bit for bit; each launched the checksum kernel
    (a worker's count lives in its own process)."""
    from repro_torch.runtime import Cluster

    cluster = Cluster(n_procs=2)
    try:
        cluster.start(_card_roundtrip, str(tmp_path), "cuda")
        results = cluster.join(timeout=120)
    finally:
        cluster.shutdown()
    assert sorted(results) == [0, 1]
    for r in results.values():
        assert r["restored"] and r["equal"] and r["launches"] > 0


def test_traced_chaos_loop_on_the_card_replays_exactly(cuda, tmp_path):
    """A node-tier outage under the device snapshot and the delta codec on
    a CUDA state: the breaker trips, versions route to the PFS, the node
    tier is re-admitted, the trace replays with zero decision mismatches
    and the newest version restores bit for bit; the device snapshot's
    kernel ran.  The breaker's cooldown runs on an injected clock, a
    second an iteration."""
    from repro_torch.core import trace
    from repro_torch.core.simulate import load_trace, replay

    tpath = tmp_path / "trace.jsonl"
    base = {"CRAFT_CP_PATH": str(tmp_path / "pfs"),
            "CRAFT_NODE_CP_PATH": str(tmp_path / "node"),
            "CRAFT_DEVICE_SNAPSHOT": "1", "CRAFT_DELTA": "1",
            "CRAFT_CHUNK_BYTES": str(64 * 1024)}
    env = CraftEnv.capture({
        **base, "CRAFT_TIER_EVERY": "node:2,pfs:4", "CRAFT_IO_RETRIES": "0",
        "CRAFT_CHAOS": "node:eio:p=1+after=4+count=6",
        "CRAFT_BREAKER_THRESHOLD": "2", "CRAFT_BREAKER_COOLDOWN_S": "0.05",
        "CRAFT_IO_BACKOFF_MS": "1", "CRAFT_TRACE": str(tpath)})
    gen = torch.Generator(device=cuda).manual_seed(21)
    state = {f"w{i}": torch.randn((256, 1024), generator=gen, device=cuda)
             for i in range(8)}
    snap0 = snapshot_chunks_cuda.launches
    now = [0.0]
    cp = Checkpoint("ctl", env=env, clock=lambda: now[0])
    cp.add("state", Box(state))
    cp.commit()
    try:
        for it in range(1, 13):
            now[0] += 1.0
            state[f"w{it % 8}"].add_(1.0)
            if cp.need_checkpoint(it):
                cp.update_and_write(it)
        stats = dict(cp.stats)
    finally:
        cp.close()
        trace.uninstall()
    assert stats["degraded_writes"] > 0 and stats["breaker_trips"] >= 1
    assert cp.health["node"].state == "closed"
    assert snapshot_chunks_cuda.launches > snap0
    events = load_trace(tpath)
    r = replay(events)
    assert r.decisions_match, f"mismatches at {r.mismatches[:5]}"
    assert r.tier_landed["node"] == stats["node_writes"]
    assert r.tier_landed["pfs"] == stats["pfs_writes"]
    assert sum(r.tier_landed_bytes.values()) == sum(
        e["nbytes"] for e in events if e["kind"] == "tier_write")
    live = {k: torch.zeros_like(t) for k, t in state.items()}
    cp2 = Checkpoint("ctl", env=CraftEnv.capture(base))
    cp2.add("state", Box(live))
    cp2.commit()
    assert cp2.restart_if_needed()
    cp2.close()
    assert cp2.version == cp.version
    assert all(torch.equal(state[k], live[k]) for k in state)


# ------------------------------------------------- the sharding layer
def _one_rank_mesh_worker(comm, port, base):
    """A one-rank NCCL mesh on the card: the kernels through ``local_map``
    on DTensors against the same calls on plain tensors, and a TINY train
    step on the mesh against the mesh-free one, each torch.equal."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.activations import mesh_context
    from repro_torch.sharding.logical import LogicalRules

    torch.use_deterministic_algorithms(True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        dev = torch.device("cuda")
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = LogicalRules(mesh)
        gen = torch.Generator(device=dev).manual_seed(5)

        def dt(x, *dims):
            return distribute_tensor(x, mesh, rules.placements(
                *dims, shape=tuple(x.shape)), src_data_rank=None)

        out = {}
        q = torch.randn((2, 8, 300, 64), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((2, 2, 300, 64), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        n0 = fa_kernel.flash_attention_cuda.launches
        with mesh_context(rules):
            got = fa_ops.attention(dt(q, "batch", "heads", None, None),
                                   dt(k, "batch", "kv_heads", None, None),
                                   dt(v, "batch", "kv_heads", None, None))
        # the mesh call launched the kernel once
        out["attention_launches"] = fa_kernel.flash_attention_cuda.launches - n0
        out["attention"] = bool(torch.equal(got.to_local(),
                                            fa_ops.attention(q, k, v)))
        for name, shapes, dims in (
                ("ssd", [(2, 400, 8, 16), (2, 400, 8, 16), (2, 400, 8, 16),
                         (2, 400, 8), (8,), (2, 8, 16, 16)],
                 [("batch", None, "ssm_heads", None)] * 3
                 + [("batch", None, "ssm_heads"), ("ssm_heads",),
                    ("batch", "ssm_heads", None, None)]),
                ("s6", [(2, 400, 64), (2, 400, 16), (2, 400, 16),
                        (2, 400, 64), (64, 16), (2, 64, 16)],
                 [("batch", None, "ssm_inner"), ("batch", None, None),
                  ("batch", None, None), ("batch", None, "ssm_inner"),
                  ("ssm_inner", None), ("batch", "ssm_inner", None)])):
            xs = [torch.randn(s, generator=gen, device=dev) for s in shapes]
            xs[3] = xs[3].abs() * 0.1
            xs[4] = -xs[4].abs()
            with mesh_context(rules):
                y, h = scan_ops.selective_scan(
                    *(dt(x, *d) for x, d in zip(xs, dims)), chunk=256)
            y2, h2 = scan_ops.selective_scan(*xs, chunk=256)
            out[name] = bool(torch.equal(y.to_local(), y2)
                             and torch.equal(h.to_local(), h2))
        for arch in ("h2o-danube-1.8b", "zamba2-2.7b"):
            tc = train.TrainConfig(arch=arch, steps=2, global_batch=2,
                                   seq_len=256, cp_freq=10, device="cuda")
            a = train.run(tc, mesh=mesh, env=CraftEnv.capture(
                {"CRAFT_CP_PATH": f"{base}/{arch}-mesh"}))
            b = train.run(tc, env=CraftEnv.capture(
                {"CRAFT_CP_PATH": f"{base}/{arch}-plain"}))
            out[arch] = (a["losses"] == b["losses"] and all(
                torch.equal(x.to_local(), y) for x, y in zip(
                    torch.utils._pytree.tree_leaves(a["state"]["params"]),
                    torch.utils._pytree.tree_leaves(b["state"]["params"]))))
        return out
    finally:
        dist.destroy_process_group()


def _free_port():
    from repro_torch.examples.elastic_restore import free_port

    return free_port()


def test_one_rank_mesh_on_the_card_equals_mesh_free(cuda, tmp_path):
    """The kernels enter a DTensor program through ``local_map`` and give
    the plain calls' bits (the attention kernel launched); a TINY
    danube / zamba2 training run on a one-rank NCCL mesh equals the
    mesh-free run bit for bit (in a worker process: the process group
    stays out of the test process)."""
    from repro_torch.runtime import Cluster

    cluster = Cluster(n_procs=1, env_overrides={
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    try:
        cluster.start(_one_rank_mesh_worker, _free_port(), str(tmp_path))
        out = cluster.join(timeout=300)[0]
    finally:
        cluster.shutdown()
    assert out["attention"] and out["attention_launches"] == 1
    assert out["ssd"] and out["s6"]
    assert out["h2o-danube-1.8b"] and out["zamba2-2.7b"]


def test_elastic_restore_on_the_card(cuda, tmp_path):
    """TINY danube's parameters as DTensors on a (2, 2) mesh over 4 worker
    processes sharing the card (gloo), written with the device snapshot,
    restored on shrink_mesh(2, 2) over 2 fresh processes bit for bit."""
    from repro_torch.examples.elastic_restore import elastic_restore

    out = elastic_restore(tmp_path, tiny=True, device="cuda",
                          write_mesh=(2, 2), survivors=2, snapshot=True,
                          timeout=300)
    assert out["equal"]
    assert all(r["mesh"] == (1, 2) for r in out["readers"])
    assert sum(w["launches"]["snapshot"] for w in out["writers"]) > 0
    assert sum(r["launches"]["checksum"] for r in out["readers"]) > 0
