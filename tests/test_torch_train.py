"""The port's training path against the reference package, on the CPU.

The same seeded numpy inputs go through both packages: the synthetic
data pipeline (bit for bit), the learning-rate schedule, the int8 moment
codec and AdamW (32-bit and 8-bit moments, with and without the float32
master copy), the cross entropies, and the loss and gradients of the TINY
dense (h2o-danube-1.8b), ssm (falcon-mamba-7b), hybrid (zamba2-2.7b) and
moe (deepseek-v3-671b: MLA, MoE aux and the MTP head; kimi-k2-1t-a32b:
GQA and MoE aux) models on the reference's ``init_params`` weights, through
``jax.value_and_grad(repro.train.steps._loss_fn)`` and the port's
autograd (its kernels' plain versions forward, the same backward code the
card runs).  The reference's train step runs without a mesh, as
``tests/test_models.py`` runs it.

Tolerances: the pipeline is bit-identical; float32 math is held to 1e-7
(the schedule), 1e-6 (AdamW state, the cross entropies) and, for the
models, 1e-5 on the loss and 1e-4 of each gradient leaf's largest
magnitude (the same sums taken in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as ref_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import steps as RS

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataCursor, SyntheticTokens
from repro_torch.models import model as M
from repro_torch.optim import adamw as A
from repro_torch.train import steps as S

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b",
         "deepseek-v3-671b", "kimi-k2-1t-a32b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _paths(tree, jax_tree: bool):
    """{key path string: leaf} in one spelling for both packages."""
    if jax_tree:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"".join(f"[{k.key!r}]" for k in p): v for p, v in flat}
    return {pytree.keystr(k): v
            for k, v in pytree.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (7, 3, 0, 1), (7, 3, 1, 2),
                          (123, 1 << 33, 3, 4)])
def test_synthetic_batches_bit_identical(seed, step, shard, n_shards):
    kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=seed,
              n_shards=n_shards, shard=shard)
    got = SyntheticTokens(**kw).batch(step)
    want = RefTokens(**kw).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_cursor_advances_like_the_reference():
    data = SyntheticTokens(vocab=50, seq_len=8, global_batch=2, seed=3)
    cursor = DataCursor(5)
    got = [b["tokens"] for b in data.batches(cursor, 3)]
    assert cursor.step == 8
    ref = RefTokens(vocab=50, seq_len=8, global_batch=2, seed=3)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, ref.batch(5 + i)["tokens"])


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("cfg", [
    dict(lr=3e-4, warmup_steps=5, total_steps=20),
    dict(lr=1e-2, warmup_steps=1, total_steps=10),
    dict(lr=2e-3, warmup_steps=100, total_steps=10_000),
])
def test_warmup_cosine_matches_reference(cfg):
    rc, pc = RA.OptimConfig(**cfg), A.OptimConfig(**cfg)
    for step in list(range(0, 30)) + [99, 100, 101, 5000, 9999, 10_000,
                                      20_000]:
        want = float(RA.warmup_cosine(rc, jnp.int32(step)))
        assert abs(A.warmup_cosine(pc, step) - want) <= 1e-7 * max(
            1.0, abs(want)), step


# ----------------------------------------------------------- int8 moments
@pytest.mark.parametrize("shape,scale", [((64, 257), 1.0), ((3, 5, 16), 1e-3),
                                         ((1000, 8), 1e4), ((4,), 0.5)])
def test_quantize_matches_reference(shape, scale):
    """q equal but where x / scale lies within one float32 ulp of a .5 tie
    (the two divide in another way); such places are counted: none in
    these draws, and a difference may only be there and only by 1."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    q_r, s_r = (np.asarray(a) for a in RA._quantize(jnp.asarray(x)))
    q, s = (a.numpy() for a in A._quantize(torch.from_numpy(x)))
    np.testing.assert_array_equal(s, s_r)
    ratio = x / s_r
    frac = np.abs(ratio - np.floor(ratio) - 0.5)
    ties = frac <= np.spacing(np.abs(ratio).astype(np.float32))
    diff = q.astype(np.int32) - q_r.astype(np.int32)
    assert np.all(np.abs(diff) <= 1) and not np.any(diff[~ties])
    assert int(ties.sum()) == 0
    np.testing.assert_array_equal(
        A._dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
        np.asarray(RA._dequantize(jnp.asarray(q_r), jnp.asarray(s_r))))


# ------------------------------------------------------------------ AdamW
def _opt_params(dtype):
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"w": (3, 8, 12), "ln": (3, 12)}, "emb": (20, 6),
              "bias": (12,), "tiny": (3,)}
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32).astype(dtype),
        shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_matches_reference(bits, master):
    """Three steps on the same params and gradients: every float32 state
    leaf within 1e-6 relative (of its largest magnitude), the int8 moments
    equal, the bf16 parameters (with the master copy) within one bf16 ulp
    and equal to the port's own master rounded."""
    import ml_dtypes

    dtype = ml_dtypes.bfloat16 if master else np.float32
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_bits=bits,
              master_fp32=master)
    rc, pc = RA.OptimConfig(**kw), A.OptimConfig(**kw)
    np_params = _opt_params(dtype)
    r_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    r_state = RA.adamw_init(r_params, rc)
    p_params = convert.state_from_numpy(np_params, "cpu")
    p_state = A.adamw_init(p_params, pc)
    rng = np.random.default_rng(1)
    for i in range(3):
        np_grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 0.3).astype(
                np.float32).astype(dtype), np_params)
        r_params, r_state, rm = RA.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, np_grads), r_state,
            r_params, rc)
        p_params, p_state, pm = A.adamw_update(
            convert.state_from_numpy(np_grads, "cpu"), p_state, p_params, pc)
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * float(rm["grad_norm"])
        assert abs(pm["lr"] - float(rm["lr"])) <= 1e-9
    assert int(p_state["count"]) == int(r_state["count"]) == 3
    got = _paths({"params": p_params, "state": p_state}, False)
    want = _paths({"params": r_params, "state": r_state}, True)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.startswith("['params']") and master:
            np.testing.assert_allclose(g, w, rtol=2 ** -7, err_msg=k)
        else:
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(),
                                                     1e-30), k
    if master:
        for k, p in _paths(p_params, False).items():
            assert torch.equal(p, _paths(p_state["master"], False)[k].to(
                p.dtype)), k


def test_adamw_state_layout_matches_reference():
    """The same tree, key for key, shape and dtype for shape and dtype."""
    for bits in (32, 8):
        for master in (False, True):
            kw = dict(state_bits=bits, master_fp32=master)
            np_params = _opt_params(np.float32)
            want = RA.adamw_init(jax.tree_util.tree_map(jnp.asarray,
                                                        np_params),
                                 RA.OptimConfig(**kw))
            got = A.adamw_init(convert.state_from_numpy(np_params, "cpu"),
                               A.OptimConfig(**kw))
            gp, wp = _paths(got, False), _paths(want, True)
            assert set(gp) == set(wp)
            for k in wp:
                assert tuple(gp[k].shape) == tuple(wp[k].shape), k
                assert str(gp[k].dtype).split(".")[-1] == str(
                    wp[k].dtype), k


# ---------------------------------------------------------- cross entropy
@pytest.mark.parametrize("chunk", [7, 16, 40, 64])
def test_cross_entropies_match_reference(chunk):
    """Masked mean CE with IGNORE labels, and its chunked form with a
    ragged last chunk (L = 37), within 1e-6."""
    rng = np.random.default_rng(chunk)
    b, l, d, v = 2, 37, 8, 50
    hidden = rng.standard_normal((b, l, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, l)).astype(np.int32)
    labels[0, :5] = RS.IGNORE
    labels[1, -9:] = RS.IGNORE
    logits = hidden @ w
    want = float(RS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(S.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    want_c = float(RS.chunked_cross_entropy(
        jnp.asarray(hidden), jnp.asarray(labels), lambda h: h @ wj, chunk))
    got_c = float(S.chunked_cross_entropy(
        torch.from_numpy(hidden), torch.from_numpy(labels),
        lambda h: h @ wt, chunk))
    assert abs(got_c - want_c) <= 1e-6 * abs(want_c)
    assert abs(got_c - got) <= 1e-6 * abs(got)


# ------------------------------------------------- loss and gradients
@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str = "float32"):
    rcfg = ref_config(arch, tiny=True).replace(param_dtype=dtype)
    cfg = get_config(arch, tiny=True).replace(param_dtype=dtype)
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40),
                                               dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -3:] = RS.IGNORE
    return rcfg, cfg, np_params, {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, cfg, np_params, batch = _setup(arch)
    scfg = RS.TrainStepConfig(loss_chunk=16)
    (total, parts), grads = jax.value_and_grad(RS._loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params), rcfg, scfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    leaves, spec = pytree.tree_flatten(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    p_total, p_parts = S._loss_fn(
        pytree.tree_unflatten(alias, spec), cfg,
        S.TrainStepConfig(loss_chunk=16),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    p_grads = torch.autograd.grad(p_total, alias)
    assert abs(float(p_total.detach()) - float(total)) <= 1e-5 * abs(
        float(total))
    assert abs(float(p_parts["loss"]) - float(parts["loss"])) <= 1e-5 * abs(
        float(parts["loss"]))
    got = _paths(pytree.tree_unflatten(list(p_grads), spec), False)
    want = _paths(grads, True)
    assert set(got) == set(want)
    for k, w in want.items():
        w = _np(w)
        assert np.abs(_np(got[k]) - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-30), k


def _step_both(arch, microbatches):
    rcfg, cfg, np_params, batch = _setup(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, master_fp32=False)
    rstep = RS.make_train_step(rcfg, RA.OptimConfig(**kw),
                               RS.TrainStepConfig(microbatches=microbatches,
                                                  loss_chunk=16))
    rparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    rp, ro, rm = jax.jit(rstep)(
        rparams, RA.adamw_init(rparams, RA.OptimConfig(**kw)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_numpy(np_params, cfg, "cpu")
    pstep = S.make_train_step(cfg, A.OptimConfig(**kw),
                              S.TrainStepConfig(microbatches=microbatches,
                                                loss_chunk=16))
    pp, po, pm = pstep(params, A.adamw_init(params, A.OptimConfig(**kw)),
                       batch)
    return (rp, ro, rm), (pp, po, pm)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    """One step (lr 1e-3): the metrics within 1e-5 relative; the moments
    within 1e-4 of each leaf's largest magnitude (they hold the
    gradients); every parameter within 2 lr of the reference's, and all
    but 1e-3 of them within lr / 100 (Adam's first step is about lr *
    sign(g), so a gradient within rounding of 0 may take either sign)."""
    (rp, ro, rm), (pp, po, pm) = _step_both(arch, microbatches)
    for k in ("loss", "aux", "grad_norm", "lr"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-5 * max(
            abs(float(rm[k])), 1e-6), k
    got, want = _paths(po, False), _paths(ro, True)
    for k, w in want.items():
        w = _np(w)
        assert np.abs(_np(got[k]) - w).max() <= 1e-4 * max(
            np.abs(w).max(), 1e-30), k
    got, want = _paths(pp, False), _paths(rp, True)
    lr = 1e-3
    far = total = 0
    for k, w in want.items():
        d = np.abs(_np(got[k]) - _np(w))
        assert d.max() <= 2 * lr + 1e-6, k
        far += int((d > lr / 100).sum())
        total += d.size
    assert far <= 1e-3 * total


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_steps_lower_the_loss(arch):
    """As tests/test_models.py: four steps on one batch lower the loss."""
    cfg = get_config(arch, tiny=True)
    ocfg = A.OptimConfig(lr=1e-2, master_fp32=False, warmup_steps=1,
                         total_steps=10, clip_norm=1e9)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    step = S.make_train_step(cfg, ocfg, S.TrainStepConfig(loss_chunk=16))
    opt = A.adamw_init(params, ocfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32),
                                             dtype=np.int32)
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-medium"])
def test_later_slices_raise(arch):
    """The modality frontends come with a later slice."""
    cfg = get_config(arch, tiny=True)
    with pytest.raises(NotImplementedError):
        M.init_params(None, cfg, "meta")
    step = S.make_train_step(cfg, A.OptimConfig())
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError):
        step({"embed": {"embedding": torch.zeros(cfg.vocab, 4)}}, {},
             {"tokens": tokens, "labels": tokens})
