"""The port's LM serving path against the reference package, on the CPU.

For h2o-danube-1.8b (dense GQA, sliding window), zamba2-2.7b (hybrid
mamba2 + shared attention), falcon-mamba-7b (mamba1), deepseek-v3-671b
(MoE with MLA attention and an MTP head), kimi-k2-1t-a32b (MoE with GQA),
musicgen-medium (audio: MHA over a 64-frame prefix) and llava-next-34b
(vlm: GQA over an 8-patch prefix), at their TINY sizes, the reference's
``init_params`` weights are carried into the port (numpy →
``convert.params_from_numpy``) and the same seeded tokens go through
``forward``, ``make_prefill`` and ``make_decode_step`` of both packages;
the two frontend models get one numpy-seeded ``embeds`` prefix in both.
The prompt (40) is longer than TINY danube's window (32), so the prefill
masks by window and decode writes the rolling slots.

Tolerances: float32 2e-4 on logits and cache values (the same math summed
in another order); bfloat16 0.15, the reference's own bound for its models
(``tests/test_models.py``), since the two frameworks round bfloat16 at
other places.  deepseek in bfloat16 is the exception, held block by block
in ``tests/test_torch_moe.py``: a one-ulp difference after its first
(dense) block flips a top-k choice with a margin of 2.3e-5 two MoE layers
on, and one token's experts then differ, end to end.
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

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b",
         "deepseek-v3-671b", "kimi-k2-1t-a32b", "musicgen-medium",
         "llava-next-34b"]
FRONTENDS = ["musicgen-medium", "llava-next-34b"]
DTYPES = ["float32", "bfloat16"]
# (arch, dtype) of the end-to-end comparisons: see the module docstring
CASES = [(a, d) for a in ARCHS for d in DTYPES
         if (a, d) != ("deepseek-v3-671b", "bfloat16")]
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


def _embeds(cfg):
    """The frontend models' prefix (B, P, D) float32 numpy, else None."""
    if not cfg.frontend:
        return None
    return np.random.default_rng(5).standard_normal(
        (B, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _both(x):
    """(reference's, port's) of a numpy array or None."""
    return (None, None) if x is None else (jnp.asarray(x),
                                           torch.from_numpy(x))


@functools.lru_cache(maxsize=None)
def _serve_both(arch: str, dtype: str):
    """Prefill (after the prefix, for a frontend model) + GEN decode steps
    in both packages, each fed the reference's greedy tokens: (per-step
    logits pairs, final caches)."""
    rcfg, cfg, rparams, params, tokens = _setup(arch, dtype)
    remb, emb = _both(_embeds(cfg))
    start = PROMPT + (cfg.n_patches if cfg.frontend else 0)
    rcache, rlog = jax.jit(RS.make_prefill(rcfg, B, start + GEN))(
        rparams, jnp.asarray(tokens), remb)
    cache, log = S.make_prefill(cfg, B, start + GEN, "cpu")(
        params, torch.from_numpy(tokens), emb)
    steps = [(rlog, log)]
    rdec, dec = jax.jit(RS.make_decode_step(rcfg)), S.make_decode_step(cfg)
    for i in range(GEN):
        nxt = np.array(jnp.argmax(rlog, -1), np.int32)[:, None]
        rcache, rlog = rdec(rparams, rcache, jnp.asarray(nxt),
                            jnp.int32(start + i))
        cache, log = dec(params, cache, torch.from_numpy(nxt), start + i)
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


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_matches_reference(arch, dtype):
    rcfg, cfg, rparams, params, tokens = _setup(arch, dtype)
    remb, emb = _both(_embeds(cfg))
    want, _, _ = RM.forward(rparams, rcfg, tokens=jnp.asarray(tokens),
                            embeds=remb)
    got, cache, _ = M.forward(params, cfg, tokens=torch.from_numpy(tokens),
                              embeds=emb)
    assert cache is None and got.dtype == torch.float32
    prefix = cfg.n_patches if cfg.frontend else 0
    assert got.shape == (B, prefix + PROMPT, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    steps, _, _ = _serve_both(arch, dtype)
    for i, (want, got) in enumerate(steps):
        assert bool(torch.isfinite(got).all()), f"step {i}"
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"step {i}")


@pytest.mark.parametrize("arch,dtype", CASES)
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
    prefix = get_config(arch, tiny=True).n_patches
    assert int(cache["layers"]["pos"][0]) == PROMPT + GEN + prefix


def test_rolling_window_cache_holds_the_newest_positions():
    """danube TINY: window 32 < prompt 40 + 4 decoded; the slot of position
    p is p % 32 and every slot was written."""
    _, rcache, cache = _serve_both("h2o-danube-1.8b", "float32")
    k = cache["layers"]["k"]
    assert k.shape[3] == 32
    assert bool((k.abs().sum(-1) > 0).all())


@pytest.mark.parametrize("arch", FRONTENDS)
def test_modality_stub_prefix(arch):
    """tests/test_models.py's case on the port: the audio and vlm
    backbones take precomputed frame / patch embeddings before the tokens
    (bf16 TINY, the port's own random weights)."""
    cfg = get_config(arch, tiny=True)
    assert cfg.frontend and cfg.n_patches > 0
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b, l = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, l), dtype=np.int32))
    embeds = torch.randn((b, cfg.n_patches, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    logits, _, _ = M.forward(params, cfg, tokens=toks, embeds=embeds)
    assert logits.shape == (b, cfg.n_patches + l, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", FRONTENDS)
def test_embeds_alone_match_reference(arch):
    """A prefix with no tokens: the logits of the P stub positions."""
    rcfg, cfg, rparams, params, _ = _setup(arch, "float32")
    remb, emb = _both(_embeds(cfg))
    want, _, _ = RM.forward(rparams, rcfg, embeds=remb)
    got, _, _ = M.forward(params, cfg, embeds=emb)
    assert got.shape == (B, cfg.n_patches, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


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
