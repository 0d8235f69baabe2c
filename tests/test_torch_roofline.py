"""The port's roofline counters (``repro_torch.analysis.roofline``) against
the reference's HLO analyzer, on the CPU.

The reference's ``tests/test_roofline.py`` on the port's counters: one
product counts exactly 2·M·K·N; a loop of 9 layers counts 9 layers (an
eager trace runs the body 9 times, so no trip count is needed); the fused
estimate of elementwise traffic lies within 1.5–4× the tensor's bytes;
an all-reduce over 8 fake ranks counts the ring's 2·in·(g−1)/g wire bytes
(in a subprocess: a process group never starts in the pytest process).
The hand kernels' custom ops count what the reference's dot count gives
for the same op (its blocked attention and chunked scans compiled on one
CPU device), and ``model_flops`` equals the reference's for every arch ×
shape.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline as R
from repro_torch.configs import ARCH_IDS, PORT_ONLY, SHAPES, get_config
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops

REPO = Path(__file__).resolve().parents[1]


class TestFlops:
    def test_single_dot(self):
        a, b = torch.randn(64, 128), torch.randn(128, 32)
        assert R.analyze(lambda: a @ b).flops == 2 * 64 * 128 * 32

    def test_loop_counts_every_layer(self):
        n = 9
        x, ws = torch.randn(32, 32), torch.randn(n, 32, 32)

        def f():
            c = x
            for i in range(n):
                c = torch.tanh(c @ ws[i])
            return c

        assert R.analyze(f).flops == n * 2 * 32 * 32 * 32

    def test_nested_loop(self):
        x, ws = torch.randn(16, 16), torch.randn(4, 16, 16)

        def f():
            c = x
            for w in ws:
                for _ in range(3):
                    c = c @ w
            return c

        assert R.analyze(f).flops == 4 * 3 * 2 * 16 ** 3

    def test_backward_is_counted(self):
        """A product's backward: two more products of the same size."""
        a = torch.randn(64, 128, requires_grad=True)
        b = torch.randn(128, 32, requires_grad=True)
        assert R.analyze(lambda: (a @ b).sum().backward()).flops == \
            3 * 2 * 64 * 128 * 32


class TestHbmBytes:
    def test_elementwise_traffic(self):
        x = torch.randn(1024, 1024)
        rep = R.analyze(lambda: torch.tanh(x) * 2 + 1)
        nbytes = 1024 * 1024 * 4
        # read x once, write the result once: the chain is one fused pass
        assert nbytes * 1.5 <= rep.hbm_bytes <= nbytes * 4
        # each of the three ops alone reads and writes the whole tensor
        assert rep.hbm_bytes_unfused == 6 * nbytes

    def test_loop_writes_counted_per_layer(self):
        """A loop saving every layer's output: charged per layer, not the
        whole stack per layer."""
        n, m = 16, 256
        x = torch.randn(m, m)

        def f():
            c, ys = x, []
            for _ in range(n):
                c = torch.sin(c)
                ys.append(c)
            return torch.stack(ys)

        slice_bytes = m * m * 4
        rep = R.analyze(f)
        assert rep.hbm_bytes < n * slice_bytes * 10
        assert rep.hbm_bytes > n * slice_bytes * 1.5

    def test_views_move_no_bytes(self):
        x = torch.randn(64, 64)
        rep = R.analyze(lambda: x.view(16, 256).t()[:8])
        assert rep.hbm_bytes == rep.hbm_bytes_unfused == 0


_SHARDED = """
import sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard
from repro_torch.analysis import roofline as R
from repro_torch.launch.mesh import make_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((8,), ("d",), device_type="cpu")
t = torch.empty(1024, 64)
rep = R.analyze(lambda: dist.all_reduce(t))
want = 2 * t.numel() * 4 * 7 / 8
assert rep.collective_bytes == want, (rep.as_dict(), want)
assert rep.collective_by_kind == {"all-reduce": want}
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(128, 64), mesh, [Shard(0)],
                           run_check=False)
    rep = R.analyze(lambda: x.sum().full_tensor())
    assert "all-reduce" in rep.collective_by_kind, rep.as_dict()
    rep = R.analyze(lambda: x.full_tensor())
    # all-gather: receives the 7 shards it does not hold
    assert rep.collective_by_kind == {"all-gather": 7 * 128 * 64 * 4}
    # the rank's own work: its (128, 64) shard, not the global (1024, 64)
    w = DTensor.from_local(torch.empty(8, 32), mesh, [Shard(0)],
                           run_check=False).redistribute(
        mesh, [torch.distributed.tensor.Replicate()])
    rep = R.analyze(lambda: x @ w)
    assert rep.flops == 2 * 128 * 64 * 32, rep.flops
print("OK")
"""


@pytest.mark.slow
class TestSharded:
    """Collectives need a process group: a subprocess with a fake one of 8
    ranks."""

    def test_collectives_counted(self, tmp_path):
        script = tmp_path / "probe.py"
        script.write_text(_SHARDED)
        r = subprocess.run([sys.executable, str(script)], cwd=str(REPO),
                           capture_output=True, text=True, timeout=300)
        assert "OK" in r.stdout, (r.stdout[-800:], r.stderr[-2000:])


# ------------------------------------------- the hand kernels' custom ops
def _ref_flops(fn, *args):
    import jax

    from repro.analysis import roofline as RR

    return RR.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("shape", [(2, 4, 64, 64, 2, 16),
                                   (1, 8, 1, 96, 2, 32),
                                   (2, 4, 128, 128, 4, 24)],
                         ids=["prefill", "decode", "gqa"])
def test_attention_formula_equals_reference_dot_count(shape):
    """The reference's blocked attention on the CPU (its off-TPU path) and
    the port's custom op on the same shapes: the same FLOPs."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import attention as ref_attention

    b, hq, lq, lk, hkv, d = shape
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    causal = lq > 1
    want = _ref_flops(lambda q, k, v: ref_attention(q, k, v, causal=causal),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = R.analyze(lambda: attn_ops.custom_ops().flash_attention(
        tq, tk, tv, causal, None, d ** -0.5, 0, None)).flops
    assert got == want
    lse = R.analyze(lambda: attn_ops.custom_ops().flash_attention_lse(
        tq, tk, tv, causal, None, d ** -0.5, 0, None)).flops
    assert lse == want


def _scan_inputs(mamba2: bool, b=2, l=40, rng=None):
    rng = rng or np.random.default_rng(1)
    if mamba2:
        nh, hd, st = 4, 8, 16
        dtx = rng.standard_normal((b, l, nh, hd))
        bh = rng.standard_normal((b, l, nh, st))
        ch = rng.standard_normal((b, l, nh, st))
        dt = rng.random((b, l, nh))
        A = -rng.random(nh)
        h0 = np.zeros((b, nh, hd, st))
    else:
        di, st = 16, 8
        dtx = rng.standard_normal((b, l, di))
        bh = rng.standard_normal((b, l, st))
        ch = rng.standard_normal((b, l, st))
        dt = rng.random((b, l, di))
        A = -rng.random((di, st))
        h0 = np.zeros((b, di, st))
    return [a.astype(np.float32) for a in (dtx, bh, ch, dt, A, h0)]


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("mamba2", [True, False], ids=["ssd", "s6"])
def test_scan_formula_equals_reference_dot_count(mamba2, chunk):
    """The reference model's chunked scan (``_fused_ssd_scan``, what it
    runs off the TPU) and the port's custom op: the same FLOPs (the ragged
    tail chunk padded, as there)."""
    import jax.numpy as jnp

    from repro.models.ssm import _fused_ssd_scan

    ins = _scan_inputs(mamba2)
    want = _ref_flops(lambda *xs: _fused_ssd_scan(*xs, chunk),
                      *(jnp.asarray(a) for a in ins))
    t = [torch.from_numpy(a) for a in ins]
    got = R.analyze(lambda: scan_ops.custom_ops().selective_scan(*t, chunk)).flops
    assert got == want
    states = R.analyze(
        lambda: scan_ops.custom_ops().selective_scan_states(*t, chunk)).flops
    assert states == want


def test_custom_ops_match_their_plain_path():
    """The custom ops compute what the wrappers do on the CPU."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16)))
    kw = dict(causal=True, window=None, sm_scale=0.25, q_offset=0,
              kv_len=None)
    assert torch.equal(attn_ops.custom_ops().flash_attention(q, k, v, *kw.values()),
                       attn_ops.attention(q, k, v, **kw))
    t = [torch.from_numpy(a) for a in _scan_inputs(True)]
    y, h = scan_ops.custom_ops().selective_scan(*t, 16)
    y2, h2 = scan_ops.selective_scan(*t, chunk=16)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_fake_tensors_pass_through_the_kernels():
    """Fake tensors (the dry-run's stand-ins) go through the custom ops'
    shape functions, with and without a gradient."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(2, 4, 32, 16, requires_grad=True)
        k = torch.empty(2, 2, 32, 16, requires_grad=True)
        v = torch.empty(2, 2, 32, 8, requires_grad=True)
        out = attn_ops.attention(q, k, v)
        assert out.shape == (2, 4, 32, 8)
        out.sum().backward()
        assert q.grad.shape == q.shape and v.grad.shape == v.shape
        with torch.no_grad():
            assert attn_ops.attention(q, k, v).shape == (2, 4, 32, 8)
        t = [torch.empty(a.shape) for a in _scan_inputs(False)]
        y, h = scan_ops.selective_scan(*t, chunk=16)
        assert y.shape == t[0].shape and h.shape == t[5].shape


# ------------------------------------------------------------- MODEL_FLOPS
#: parameters of the port-only archs, counted by hand from their widths:
#: zamba2-7b's 81 mamba layers (78,437,456 each: in_proj 3584 x 14704,
#: conv 4 x 7424 with its bias, 3 x 112 head scalars, the gated norm's
#: 7168, out_proj 7168 x 3584, the layer norm), 2 shared blocks
#: (333,982,208 each: norm 7168, q/k/v 7168 x 7168, o 7168 x 3584, norm
#: 3584, gate/up/down 3 x 3584 x 14336), 13 applications (adapter 3584 x
#: 128 + 128 x 28672, linear 3584 x 3584), the tied embedding 32000 x 3584
#: and the final norm
PORT_ONLY_PARAMS = {
    "zamba2-7b": 81 * 78_437_456 + 2 * 333_982_208
    + 13 * (4_128_768 + 12_845_056) + 114_688_000 + 3584,
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS + PORT_ONLY)
def test_model_flops_equal_reference(arch, shape):
    """The reference registry's archs against the reference's counts; each
    port-only arch against its hand count (6 N D train, 2 N D forward)."""
    s = SHAPES[shape]
    if arch in PORT_ONLY:
        n = PORT_ONLY_PARAMS[arch]
        tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
        for n_chips in (1, 256, 512):
            got = R.model_flops(get_config(arch), s.seq_len, s.global_batch,
                                s.kind, n_chips)
            per = 6.0 if s.kind == "train" else 2.0
            assert got == per * n * tokens / n_chips
        return
    from repro.analysis import roofline as RR
    from repro.configs import get_config as ref_config

    for n_chips in (1, 256, 512):
        got = R.model_flops(get_config(arch), s.seq_len, s.global_batch,
                            s.kind, n_chips)
        want = RR.model_flops(ref_config(arch), s.seq_len, s.global_batch,
                              s.kind, n_chips)
        assert got == want


def test_port_only_archs_are_not_in_the_reference_registry():
    from repro.configs import ARCH_IDS as REF_IDS

    assert set(ARCH_IDS) == set(REF_IDS)
    assert not set(PORT_ONLY) & set(REF_IDS)
    assert set(PORT_ONLY) == set(PORT_ONLY_PARAMS)


def test_report_terms_use_the_h100():
    rep = R.RooflineReport(flops=989e12, hbm_bytes=3.35e12,
                           hbm_bytes_unfused=4e12, collective_bytes=900e9,
                           collective_by_kind={"all-reduce": 900e9},
                           top_collectives=[("all-reduce", 900e9)],
                           n_collective_ops=1)
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(2.0)
    assert rep.dominant == "collective" and rep.bound_s == pytest.approx(2.0)
    text = R.format_report(rep, model_fl_per_chip=989e12 / 2)
    assert "MODEL/traced flops" in text and "0.500" in text
    assert set(rep.as_dict()) >= {"flops", "hbm_bytes", "collective_bytes",
                                  "compute_s", "memory_s", "collective_s",
                                  "dominant"}


def test_save_json(tmp_path):
    import json

    out = tmp_path / "a" / "b.json"
    R.save_json(out, {"x": np.float32(1.5)})
    assert json.loads(out.read_text()) == {"x": 1.5}
