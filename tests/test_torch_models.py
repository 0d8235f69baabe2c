"""The port's LM serving path against the reference package, on the CPU.

For h2o-danube-1.8b (dense GQA, sliding window), zamba2-2.7b (hybrid
mamba2 + shared attention) and falcon-mamba-7b (mamba1), at their TINY
sizes, the reference's ``init_params`` weights are carried into the port
(numpy → ``convert.params_from_numpy``) and the same seeded tokens go
through ``forward``, ``make_prefill`` and ``make_decode_step`` of both
packages.  The prompt (40) is longer than TINY danube's window (32), so
the prefill masks by window and decode writes the rolling slots.

Tolerances: float32 2e-4 on logits and cache values (the same math summed
in another order); bfloat16 0.15, the reference's own bound for its models
(``tests/test_models.py``), since the two frameworks round bfloat16 at
other places.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.train import steps as RS

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.checkpointables import _flatten
from repro_torch.models import model as M
from repro_torch.train import steps as S

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-4, "bfloat16": 0.15}
B, PROMPT, GEN = 2, 40, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _setup(arch: str, dtype: str):
    rcfg = ref_config(arch, tiny=True).replace(param_dtype=dtype)
    cfg = get_config(arch, tiny=True).replace(param_dtype=dtype)
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, "cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, PROMPT),
                                               dtype=np.int32)
    return rcfg, cfg, rparams, params, tokens


@functools.lru_cache(maxsize=None)
def _serve_both(arch: str, dtype: str):
    """Prefill + GEN decode steps in both packages, each fed the
    reference's greedy tokens: (per-step logits pairs, final caches)."""
    rcfg, cfg, rparams, params, tokens = _setup(arch, dtype)
    rcache, rlog = jax.jit(RS.make_prefill(rcfg, B, PROMPT + GEN))(
        rparams, jnp.asarray(tokens))
    cache, log = S.make_prefill(cfg, B, PROMPT + GEN, "cpu")(
        params, torch.from_numpy(tokens))
    steps = [(rlog, log)]
    rdec, dec = jax.jit(RS.make_decode_step(rcfg)), S.make_decode_step(cfg)
    for i in range(GEN):
        nxt = np.array(jnp.argmax(rlog, -1), np.int32)[:, None]
        rcache, rlog = rdec(rparams, rcache, jnp.asarray(nxt),
                            jnp.int32(PROMPT + i))
        cache, log = dec(params, cache, torch.from_numpy(nxt), PROMPT + i)
        steps.append((rlog, log))
    return steps, rcache, cache


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_reference(arch, tiny):
    """Same key paths, shapes and dtypes (shapes only: no allocation)."""
    def ref_leaves(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def port_leaves(tree):
        return {pytree.keystr(k): (tuple(v.shape),
                                   str(v.dtype).replace("torch.", ""))
                for k, v in pytree.tree_flatten_with_path(tree)[0]}

    rcfg, cfg = ref_config(arch, tiny), get_config(arch, tiny)
    rp = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                        jax.random.PRNGKey(0))
    assert port_leaves(M.init_params(None, cfg, "meta")) == ref_leaves(rp)
    rc = jax.eval_shape(lambda: RM.init_cache(rcfg, B, 8224))
    cache = M.init_cache(cfg, B, 8224, device="meta")
    assert port_leaves(cache) == ref_leaves(rc)
    assert all(t.device.type == "cpu" for k, t in
               pytree.tree_flatten_with_path(cache)[0]
               if pytree.keystr(k).endswith("['pos']"))


def test_params_from_numpy_refuses_a_mismatch():
    _, cfg, rparams, _, _ = _setup("h2o-danube-1.8b", "float32")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tree["final_ln"] = tree["final_ln"][:-1]
    with pytest.raises(ValueError, match="final_ln"):
        convert.params_from_numpy(tree, cfg, "cpu")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_numpy(tree, cfg, "cpu")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tree["final_ln"] = tree["final_ln"].astype(np.float16)
    with pytest.raises(ValueError, match="final_ln"):
        convert.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    rcfg, cfg, rparams, params, tokens = _setup(arch, dtype)
    want, _, _ = RM.forward(rparams, rcfg, tokens=jnp.asarray(tokens))
    got, cache, _ = M.forward(params, cfg, tokens=torch.from_numpy(tokens))
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (B, PROMPT, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    steps, _, _ = _serve_both(arch, dtype)
    for i, (want, got) in enumerate(steps):
        assert bool(torch.isfinite(got).all()), f"step {i}"
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"step {i}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_matches_reference(arch, dtype):
    """Same structure, leaf order, dtypes and values (pos exactly)."""
    _, rcache, cache = _serve_both(arch, dtype)
    rl, tree = jax.tree_util.tree_flatten(rcache)
    leaves = _flatten(cache)[0]
    assert len(leaves) == len(rl) == tree.num_leaves
    for r, t in zip(rl, leaves):
        assert tuple(t.shape) == r.shape
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
        if r.dtype == jnp.int32:
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(_np(t), _np(r), rtol=TOL[dtype],
                                       atol=TOL[dtype])
    assert int(cache["layers"]["pos"][0]) == PROMPT + GEN


def test_rolling_window_cache_holds_the_newest_positions():
    """danube TINY: window 32 < prompt 40 + 4 decoded; the slot of position
    p is p % 32 and every slot was written."""
    _, rcache, cache = _serve_both("h2o-danube-1.8b", "float32")
    k = cache["layers"]["k"]
    assert k.shape[3] == 32
    assert bool((k.abs().sum(-1) > 0).all())


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b",
                                  "musicgen-medium", "llava-next-34b"])
def test_later_slices_raise(arch):
    cfg = get_config(arch, tiny=True)
    with pytest.raises(NotImplementedError, match="slice"):
        M.init_params(None, cfg, "meta")
    with pytest.raises(NotImplementedError, match="slice"):
        M.init_cache(cfg, 1, 8, device="meta")


def test_mla_and_moe_blocks_raise():
    from repro_torch.models import attention, blocks
    from repro_torch.models.layers import Init

    cfg = get_config("deepseek-v3-671b", tiny=True)
    with pytest.raises(NotImplementedError, match="MLA"):
        attention.gqa_init(Init(None, "meta"), cfg)
    dense = get_config("h2o-danube-1.8b", tiny=True)
    with pytest.raises(NotImplementedError, match="MoE"):
        blocks.tblock_init(Init(None, "meta"), dense, use_moe=True)


def test_init_params_is_seeded():
    cfg = get_config("falcon-mamba-7b", tiny=True)
    a = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    b = M.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    c = M.init_params(torch.Generator().manual_seed(6), cfg, "cpu")
    la, lb, lc = (pytree.tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"]["embedding"], c["embed"]["embedding"])
    w = a["blocks"]["ssm"]["in_proj"].float()
    bound = 2.0 / np.sqrt(cfg.d_model) * (1 + 1e-2)   # truncation at ±2σ
    assert float(w.abs().max()) <= bound
    assert not torch.equal(w[0], w[1])                  # layers differ
