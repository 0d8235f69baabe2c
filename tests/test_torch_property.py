"""Hypothesis property tests on the port's invariants: the reference's
``tests/test_property.py`` run against ``repro_torch`` on the CPU.

The checkpoint, reshard, range-reader and simulator properties run on the
port's own modules.  The XOR parity, cross-entropy, data and AdamW
properties hold the port's torch functions, and each also meets the
reference's answer on the same draw.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dep — skip cleanly when absent
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import torch

from repro_torch.core import Box, MemFabric
from repro_torch.core import Checkpoint as _Checkpoint
from repro_torch.core.env import CraftEnv
from repro_torch.kernels.xor_parity import ops as xor_ops
from repro_torch.train.steps import chunked_cross_entropy, cross_entropy

_SETTINGS = settings(
    max_examples=25, deadline=None,
    suppress_health_check=[HealthCheck.function_scoped_fixture])


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


# ------------------------------------------------------- checkpoint roundtrip
@_SETTINGS
@given(
    arr=hnp.arrays(
        dtype=st.sampled_from([np.float32, np.float64, np.int32, np.int64,
                               np.uint8, np.bool_]),
        shape=hnp.array_shapes(min_dims=1, max_dims=4, max_side=8),
        elements=st.nothing() | st.just(0),
    ).flatmap(lambda a: st.just(a)),
    seed=st.integers(0, 2 ** 31 - 1),
)
def test_ndarray_roundtrip_any_dtype(tmp_path_factory, arr, seed):
    rng = np.random.default_rng(seed)
    if arr.dtype == np.bool_:
        arr = rng.integers(0, 2, arr.shape).astype(np.bool_)
    elif np.issubdtype(arr.dtype, np.integer):
        arr = rng.integers(0, 100, arr.shape).astype(arr.dtype)
    else:
        arr = rng.standard_normal(arr.shape).astype(arr.dtype)
    tmp = tmp_path_factory.mktemp("rt")
    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp), "CRAFT_USE_SCR": "0"})
    cp = Checkpoint("p", env=env)
    live = arr.copy()
    cp.add("a", live)
    cp.commit()
    cp.update_and_write()
    blank = np.zeros_like(arr)
    cp2 = Checkpoint("p", env=env)
    cp2.add("a", blank)
    cp2.commit()
    assert cp2.restart_if_needed()
    np.testing.assert_array_equal(blank, arr)


@_SETTINGS
@given(
    leaves=st.lists(
        st.tuples(
            st.sampled_from(["f32", "i32", "bf16"]),
            hnp.array_shapes(min_dims=0, max_dims=3, max_side=6)),
        min_size=1, max_size=5),
    seed=st.integers(0, 2 ** 31 - 1),
)
def test_pytree_roundtrip(tmp_path_factory, leaves, seed):
    rng = np.random.default_rng(seed)
    dt = {"f32": torch.float32, "i32": torch.int32, "bf16": torch.bfloat16}
    tree = {
        f"k{i}": torch.from_numpy(
            np.asarray(rng.standard_normal(shape) * 3)).to(dt[kind])
        for i, (kind, shape) in enumerate(leaves)
    }
    tmp = tmp_path_factory.mktemp("pt")
    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp), "CRAFT_USE_SCR": "0"})
    box = Box(tree)
    cp = Checkpoint("t", env=env)
    cp.add("t", box)
    cp.commit()
    cp.update_and_write()
    blank = {k: torch.zeros_like(v) for k, v in tree.items()}
    box2 = Box(blank)
    cp2 = Checkpoint("t", env=env)
    cp2.add("t", box2)
    cp2.commit()
    assert cp2.restart_if_needed()
    for k in tree:
        assert box2.value[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(
            box2.value[k].to(torch.float32).numpy(),
            tree[k].to(torch.float32).numpy())


# ------------------------------------------------------------- xor parity
@_SETTINGS
@given(
    sizes=st.lists(st.integers(1, 700), min_size=2, max_size=9),
    lost=st.integers(0, 100),
    seed=st.integers(0, 2 ** 31 - 1),
)
def test_xor_reconstruct_any_member(sizes, lost, seed):
    from repro.kernels.xor_parity import ops as ref_xor_ops

    rng = np.random.default_rng(seed)
    bufs = [rng.bytes(n) for n in sizes]
    lost = lost % len(bufs)
    parity = xor_ops.parity_of_buffers(bufs, device="cpu")
    assert parity == ref_xor_ops.parity_of_buffers(bufs)
    survivors = [b for i, b in enumerate(bufs) if i != lost]
    assert xor_ops.reconstruct_member(
        parity, survivors, len(bufs[lost]), device="cpu") == bufs[lost]


# ------------------------------------------------------------ chunked CE
@_SETTINGS
@given(
    b=st.integers(1, 3), l=st.integers(1, 33), v=st.integers(2, 40),
    chunk=st.integers(1, 40), seed=st.integers(0, 2 ** 31 - 1),
)
def test_chunked_ce_equals_full_ce(b, l, v, chunk, seed):
    import jax.numpy as jnp

    from repro.train.steps import cross_entropy as ref_cross_entropy

    rng = np.random.default_rng(seed)
    h_np = rng.standard_normal((b, l, 8)).astype(np.float32)
    w_np = rng.standard_normal((8, v)).astype(np.float32)
    y_np = rng.integers(0, v, (b, l)).astype(np.int32)
    h, w = torch.from_numpy(h_np), torch.from_numpy(w_np)
    labels = torch.from_numpy(y_np).to(torch.int64)
    full = cross_entropy(torch.einsum("bld,dv->blv", h, w), labels)
    ck = chunked_cross_entropy(
        h, labels, lambda hc: torch.einsum("bld,dv->blv", hc, w), chunk)
    np.testing.assert_allclose(float(full), float(ck), rtol=1e-5)
    ref = ref_cross_entropy(
        jnp.einsum("bld,dv->blv", jnp.asarray(h_np), jnp.asarray(w_np)),
        jnp.asarray(y_np))
    np.testing.assert_allclose(float(full), float(ref), rtol=1e-5)


# ------------------------------------------------------------ data pipeline
@_SETTINGS
@given(step=st.integers(0, 10_000), seed=st.integers(0, 1000))
def test_data_pipeline_deterministic(step, seed):
    from repro.data.pipeline import SyntheticTokens as RefSyntheticTokens
    from repro_torch.data.pipeline import SyntheticTokens

    ds = SyntheticTokens(vocab=128, seq_len=16, global_batch=4, seed=seed)
    b1 = ds.batch(step)
    b2 = ds.batch(step)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 128
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    ref = RefSyntheticTokens(vocab=128, seq_len=16, global_batch=4,
                             seed=seed).batch(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k], np.asarray(ref[k]))


# --------------------------------------------------------- version counters
@_SETTINGS
@given(freqs=st.lists(st.integers(1, 7), min_size=1, max_size=20))
def test_version_monotonic_under_any_freq_pattern(tmp_path_factory, freqs):
    tmp = tmp_path_factory.mktemp("vm")
    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(tmp), "CRAFT_USE_SCR": "0"})
    b = Box(0)
    cp = Checkpoint("m", env=env)
    cp.add("x", b)
    cp.commit()
    prev = 0
    for i, f in enumerate(freqs, start=1):
        cp.update_and_write(i, f)
        assert cp.version >= prev
        prev = cp.version
    assert cp._pfs.latest_version() == cp.version


# ------------------------------------------------- elastic reshard geometry
@st.composite
def _reshard_case(draw):
    """A global shape, a disjoint source tiling (block decomposition over a
    random axis and rank count), and an arbitrary destination sub-box."""
    gshape = tuple(draw(st.lists(st.integers(1, 8), min_size=1, max_size=3)))
    axis = draw(st.integers(0, len(gshape) - 1))
    nsrc = draw(st.integers(1, 5))
    dst = tuple(
        sorted((draw(st.integers(0, s)), draw(st.integers(0, s))))
        for s in gshape
    )
    return gshape, axis, nsrc, tuple((lo, hi) for lo, hi in dst)


@_SETTINGS
@given(case=_reshard_case(), seed=st.integers(0, 2 ** 31 - 1))
def test_reshard_covers_every_byte_exactly_once(case, seed):
    from repro_torch.core import reshard
    from repro_torch.core.elastic import block_index

    gshape, axis, nsrc, dst = case
    rng = np.random.default_rng(seed)
    src_arr = rng.integers(0, 255, gshape).astype(np.uint8)
    sources = [
        reshard.resolve_index(block_index(gshape, r, nsrc, axis=axis), gshape)
        for r in range(nsrc)
    ]
    # exactly-once: every destination element is written by exactly one run
    counts = np.zeros(reshard.extent_size(dst), dtype=np.int64)
    for src in sources:
        for _, doff, ln in reshard.overlap_runs(src, dst):
            counts[doff:doff + ln] += 1
    assert (counts == 1).all()

    # assembly equals the source array's sub-box
    def open_reader(key):
        ext = key
        block = src_arr[tuple(slice(lo, hi) for lo, hi in ext)]
        flat = np.ascontiguousarray(block).reshape(-1).view(np.uint8)

        class _R:
            def read(self, start, stop):
                return memoryview(flat.tobytes())[start:stop]
        return _R()

    block, covered = reshard.assemble_extent(
        dst, np.uint8, [(s, s) for s in sources], open_reader)
    if covered is not None:
        assert covered.all()
        np.testing.assert_array_equal(
            block, src_arr[tuple(slice(lo, hi) for lo, hi in dst)])


@_SETTINGS
@given(
    payload=st.binary(min_size=0, max_size=200),
    chunk_bytes=st.integers(1, 64),
    codec=st.sampled_from([0, 1]),
    ranges=st.lists(
        st.tuples(st.integers(0, 200), st.integers(0, 200)),
        min_size=1, max_size=6),
)
def test_chunk_range_reader_equals_full_read(
        tmp_path_factory, payload, chunk_bytes, codec, ranges):
    from repro_torch.core.cpbase import IOContext
    from repro_torch.core.storage import ChunkRangeReader, write_array

    tmp = tmp_path_factory.mktemp("crr")
    arr = np.frombuffer(payload, dtype=np.uint8)
    ctx = IOContext(codec_version=codec, chunk_bytes=chunk_bytes,
                    device="cpu")
    path = tmp / "a.bin"
    write_array(path, arr, ctx)
    rdr = ChunkRangeReader(path, ctx)
    assert rdr.nbytes == len(payload)
    for lo, hi in ranges:
        lo, hi = sorted((min(lo, len(payload)), min(hi, len(payload))))
        assert bytes(rdr.read(lo, hi)) == payload[lo:hi]


# ------------------------------------------------------------- adamw
@_SETTINGS
@given(bits=st.sampled_from([32, 8]), seed=st.integers(0, 2 ** 31 - 1))
def test_adamw_moves_against_gradient(bits, seed):
    import jax.numpy as jnp

    from repro.optim import adamw as ref_adamw
    from repro_torch.optim.adamw import OptimConfig, adamw_init, adamw_update

    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((4, 8)).astype(np.float32)
    p = {"w": torch.from_numpy(w0.copy())}
    cfg = OptimConfig(lr=1e-2, state_bits=bits, master_fp32=False,
                      warmup_steps=0, weight_decay=0.0)
    st_ = adamw_init(p, cfg)
    g = {"w": torch.ones((4, 8), dtype=torch.float32)}
    p2, st2, _ = adamw_update(g, st_, p, cfg)      # in place
    # positive gradient → parameters must decrease
    assert float(torch.mean(p2["w"] - torch.from_numpy(w0))) < 0
    assert int(st2["count"]) == 1
    rcfg = ref_adamw.OptimConfig(lr=1e-2, state_bits=bits,
                                 master_fp32=False, warmup_steps=0,
                                 weight_decay=0.0)
    rp = {"w": jnp.asarray(w0)}
    rp2, _, _ = ref_adamw.adamw_update(
        {"w": jnp.ones((4, 8), jnp.float32)},
        ref_adamw.adamw_init(rp, rcfg), rp, rcfg)
    np.testing.assert_allclose(p2["w"].numpy(), np.asarray(rp2["w"]),
                               rtol=0, atol=1e-6)


# ------------------------------------------------- trace replay / simulator
def _synthetic_trace(count, n_steps, step_s, write_s):
    """A hand-built trace: one config + a fixed-cadence run (no live IO)."""
    env = {"CRAFT_TIER_CHAIN": "pfs", "CRAFT_TIER_EVERY": f"pfs:{count}"}
    events = [{"t": 0.0, "kind": "config", "env": env,
               "payload_bytes": 1 << 20, "comm_size": 1}]
    t, version, ticks = 0.0, 0, 0
    for it in range(n_steps):
        t += step_s
        events.append({"t": t, "kind": "step", "seconds": step_s})
        ticks += 1
        write = ticks % count == 0
        events.append({"t": t, "kind": "decision", "it": it, "cp_freq": 1,
                       "next_version": version + 1, "pending": 0,
                       "write": write, "tiers": ["pfs"] if write else [],
                       "full": False, "sync": False, "final": False,
                       "reason": "cadence" if write else ""})
        if write:
            version += 1
            t += write_s
            events.append({"t": t, "kind": "tier_write", "version": version,
                           "slot": "pfs", "seconds": write_s,
                           "nbytes": 1 << 20, "phys_bytes": 1 << 20,
                           "chunks": 1, "ref_chunks": 0, "full": False})
            events.append({"t": t, "kind": "scheduled", "version": version,
                           "tiers": ["pfs"], "reason": "cadence"})
    return events


@_SETTINGS
@given(
    count=st.integers(1, 9),
    n_steps=st.integers(5, 60),
    step_ms=st.integers(1, 50),
    write_ms=st.integers(1, 200),
)
def test_replay_is_bit_deterministic_and_matches_cadence(
        count, n_steps, step_ms, write_ms):
    """Same trace ⇒ bit-identical re-derived decision sequence, and on a
    clean fixed-cadence trace the replayed policy reproduces the recorded
    decisions exactly (the replay-vs-live contract, minus the live IO)."""
    from repro_torch.core.simulate import replay

    events = _synthetic_trace(count, n_steps, step_ms / 1e3, write_ms / 1e3)
    a = replay(events)
    b = replay(events)
    assert a.sim_decisions == b.sim_decisions          # bit-identical
    assert a.decisions_match, f"diverged at {a.mismatches[:3]}"
    assert a.scheduled_writes == n_steps // count


@_SETTINGS
@given(
    seed=st.integers(0, 2 ** 31 - 1),
    delta=st.floats(1.0, 20.0),
    mtbf=st.floats(100.0, 500.0),
    count=st.integers(1, 64),
)
def test_simulator_deterministic_under_seed(seed, delta, mtbf, count):
    """Same summary + same seed + same config ⇒ identical report; a
    different seed may (and for failure-heavy regimes does) differ."""
    from repro_torch.core.simulate import TraceSummary, simulate_config

    s = TraceSummary(
        config_env={"CRAFT_TIER_CHAIN": "pfs", "CRAFT_TIER_EVERY": "pfs:1",
                    "CRAFT_MTBF_SECONDS": str(mtbf)},
        payload_bytes=1 << 20, comm_size=1, steps=[1.0],
        tier_full_cost={"pfs": delta}, tier_delta_cost={"pfs": delta},
        tier_write_bytes={"pfs": float(1 << 20)}, restore_seconds=delta,
        failure_gaps=[mtbf], duration=1000.0, n_decisions=1000)
    ov = {"CRAFT_TIER_EVERY": f"pfs:{count}"}
    a = simulate_config(s, ov, seed=seed, horizon_steps=300)
    b = simulate_config(s, ov, seed=seed, horizon_steps=300)
    assert a.as_dict() == b.as_dict()


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    delta=st.floats(4.0, 12.0),
    mtbf=st.floats(150.0, 300.0),
)
def test_simulator_optimum_agrees_with_daly(delta, mtbf):
    """On a Poisson-failure trace with constant write cost and unit steps,
    the simulator's best fixed interval must sit in the same flat basin as
    Daly's analytic optimum: the overhead at the grid point nearest
    ``daly_interval(δ, M)`` is within 1.5× of the best grid overhead."""
    from repro_torch.core.scheduler import daly_interval
    from repro_torch.core.simulate import TraceSummary, simulate_config

    s = TraceSummary(
        config_env={"CRAFT_TIER_CHAIN": "pfs", "CRAFT_TIER_EVERY": "pfs:1",
                    "CRAFT_MTBF_SECONDS": str(mtbf)},
        payload_bytes=1 << 20, comm_size=1, steps=[1.0],
        tier_full_cost={"pfs": delta}, tier_delta_cost={"pfs": delta},
        tier_write_bytes={"pfs": float(1 << 20)}, restore_seconds=delta,
        failure_gaps=[mtbf], duration=1000.0, n_decisions=1000)
    daly = daly_interval(delta, mtbf)          # seconds == steps (1 s steps)
    grid = sorted({1, 2, 4, 8, 16, 32, 64, 128, 256,
                   max(1, int(round(daly)))})
    horizon = int(6 * mtbf)                    # several expected failures

    def overhead(count):                       # averaged over 3 seeds
        return sum(
            simulate_config(
                s, {"CRAFT_TIER_EVERY": f"pfs:{count}"},
                seed=k, horizon_steps=horizon).overhead_seconds
            for k in (0, 1, 2))

    scores = {n: overhead(n) for n in grid}
    best = min(scores.values())
    nearest = min(grid, key=lambda n: abs(n - daly))
    assert scores[nearest] <= 1.5 * best + 1e-9, (
        f"daly={daly:.1f} nearest={nearest} scores={scores}")
