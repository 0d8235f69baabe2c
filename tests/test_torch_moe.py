"""The port's MoE feed-forward and MLA attention against the reference, on
the CPU, module by module.

``moe_apply`` (deepseek's and kimi's TINY widths, a capacity small enough
that tokens drop) is held to the reference's routing first — the top-k
expert ids, each pair's slot and keep mask, recomputed with the
reference's own jnp formula (``repro/models/moe.py``) — then to its
output and aux loss.  The smallest top-k margin of these inputs (the gap
between a token's k-th and (k+1)-th router probability) is 1.8e-4 (2.2e-4
in the bfloat16 case), far above the 1e-7 rounding of the two frameworks'
float32 router products, so the routings must agree exactly; the test
asserts a margin above 1e-4 before it compares them.

deepseek's blocks (MLA attention, the dense and the MoE feed-forward) and
its MTP head are then held to the reference block by block on the
reference's own activations: the prompt's prefill into each block's cache,
then decode steps, on both of MLA's decode routes.  In bfloat16 this is
the end-to-end check: the whole model's logits cannot be held to 0.15,
because a one-ulp difference in a bfloat16 sum after the first block flips
one top-k choice whose margin is 2.3e-5 two MoE layers later.

Tolerances: float32 1e-5 on the MoE output and aux, 2e-4 on block
outputs and caches (as ``tests/test_torch_models.py``); bfloat16 2e-2 on
the MoE output (the same products, rounded once) and 0.15 on blocks.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_config as ref_config
from repro.models import blocks as RB
from repro.models import model as RM
from repro.models import moe as RMo
from repro.models.layers import rms_norm as ref_rms_norm

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as Mo

TOL = {"float32": 2e-4, "bfloat16": 0.15}
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch(x, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


# ------------------------------------------------------------------ MoE
MOE_CASES = [
    # (arch, dtype, batch, length, capacity_factor, moe_group_size)
    ("deepseek-v3-671b", "float32", 2, 48, 0.25, 32),
    ("deepseek-v3-671b", "float32", 2, 45, 0.25, 32),   # group 30 of T = 90
    ("kimi-k2-1t-a32b", "float32", 2, 48, 0.25, 32),
    ("deepseek-v3-671b", "bfloat16", 2, 48, 0.25, 32),
    ("kimi-k2-1t-a32b", "float32", 1, 40, 1.25, 256),   # one group, no cut
]


def _ref_route(rparams, xg, rcfg):
    """The reference's routing, its own formula (``repro/models/moe.py``):
    (top-k ids, slot of each pair, keep mask, router probabilities)."""
    g, s, _ = xg.shape
    e, k = rcfg.n_experts, rcfg.top_k
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                                      rparams["router"]), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32).reshape(
        g, s * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat,
                  axis=-1).reshape(g, s, k)
    c = RMo._capacity(s, rcfg)
    return (np.asarray(gate_idx), np.asarray(pos, np.int64),
            np.asarray(pos < c), np.asarray(probs))


@functools.lru_cache(maxsize=None)
def _moe_case(i: int):
    arch, dtype, b, l, cf, group = MOE_CASES[i]
    kw = dict(param_dtype=dtype, capacity_factor=cf, moe_group_size=group)
    rcfg = ref_config(arch, tiny=True).replace(**kw)
    cfg = get_config(arch, tiny=True).replace(**kw)
    rparams = RMo.moe_init(jax.random.PRNGKey(20 + i), rcfg)
    params = convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    x = np.random.default_rng(30 + i).standard_normal(
        (b, l, cfg.d_model)).astype(np.float32)
    rx = jnp.asarray(x, rcfg.dtype)
    return rcfg, cfg, rparams, params, rx, _torch(rx, dtype)


@pytest.mark.parametrize("i", range(len(MOE_CASES)))
def test_moe_routing_matches_reference(i):
    """Top-k ids (in order), slots and keep masks equal the reference's;
    the cut-capacity cases drop tokens."""
    rcfg, cfg, rparams, params, rx, tx = _moe_case(i)
    b, l, d = tx.shape
    s = Mo._group(b * l, cfg)
    assert s == RMo._group(b * l, rcfg)
    r_idx, r_pos, r_keep, probs = _ref_route(
        rparams, rx.reshape(b * l // s, s, d), rcfg)
    top = -np.sort(-probs, axis=-1)
    margin = (top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min()
    assert margin > 1e-4, f"top-k margin {margin}: the routing is ambiguous"
    idx, gate, pos, keep, _ = Mo.route(params, tx.reshape(-1, s, d), cfg)
    np.testing.assert_array_equal(idx.numpy(), r_idx)
    np.testing.assert_array_equal(pos.numpy(), r_pos)
    np.testing.assert_array_equal(keep.numpy(), r_keep)
    assert not bool(gate[~keep].any())
    if rcfg.capacity_factor < 1:
        assert (~r_keep).sum() > 0
    else:
        assert r_keep.all()


@pytest.mark.parametrize("i", range(len(MOE_CASES)))
def test_moe_apply_matches_reference(i):
    rcfg, cfg, rparams, params, rx, tx = _moe_case(i)
    want, raux = RMo.moe_apply(rparams, rx, rcfg)
    got, aux = Mo.moe_apply(params, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert aux.dtype == torch.float32
    tol = MOE_TOL[cfg.param_dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert abs(float(aux) - float(raux)) <= 1e-5 * abs(float(raux))


def test_moe_gradients_match_reference():
    """The router, expert and shared weights' gradients and the input's
    through dispatch, drops and combine (float32, 1e-4 of each leaf's
    largest magnitude), with the aux loss in the objective."""
    rcfg, cfg, rparams, params, rx, tx = _moe_case(0)
    gy = np.random.default_rng(5).standard_normal(tx.shape).astype(
        np.float32)

    def ref_obj(p, x):
        y, aux = RMo.moe_apply(p, x, rcfg)
        return jnp.sum(y * gy) + 0.5 * aux

    r_gp, r_gx = jax.grad(ref_obj, argnums=(0, 1))(rparams, rx)
    leaves, spec = pytree.tree_flatten(params)
    alias = [p.detach().requires_grad_() for p in leaves]
    x = tx.detach().requires_grad_()
    y, aux = Mo.moe_apply(pytree.tree_unflatten(alias, spec), x, cfg)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + 0.5 * aux, alias + [x])
    got = dict(zip([pytree.keystr(k) for k, _ in
                    pytree.tree_flatten_with_path(params)[0]], grads))
    want = {"".join(f"[{k.key!r}]" for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(r_gp)[0]}
    assert set(got) == set(want)
    for k, w in list(want.items()) + [("x", r_gx)]:
        g = grads[-1] if k == "x" else got[k]
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                        1e-30), k


@pytest.mark.parametrize("t,group,cf,experts,top_k", [
    (96, 32, 0.25, 8, 2), (90, 32, 1.25, 8, 2), (16384, 256, 1.25, 256, 8),
    (2, 256, 1.25, 256, 8), (7, 256, 1.25, 384, 8), (4096, 256, 1.0, 16, 4),
])
def test_group_and_capacity_match_reference(t, group, cf, experts, top_k):
    kw = dict(moe_group_size=group, capacity_factor=cf, n_experts=experts,
              top_k=top_k)
    rcfg = ref_config("deepseek-v3-671b").replace(**kw)
    cfg = get_config("deepseek-v3-671b").replace(**kw)
    s = Mo._group(t, cfg)
    assert s == RMo._group(t, rcfg) and t % s == 0
    assert Mo._capacity(s, cfg) == RMo._capacity(s, rcfg)
    assert Mo._capacity(s, cfg) % 8 == 0 or Mo._capacity(s, cfg) == top_k


# ------------------------------------------------- deepseek, block by block
B_, PROMPT, STEPS = 2, 40, 3


@functools.lru_cache(maxsize=None)
def _deepseek(dtype: str, absorb: bool):
    rcfg = ref_config("deepseek-v3-671b", tiny=True).replace(
        param_dtype=dtype, mla_absorb=absorb)
    cfg = get_config("deepseek-v3-671b", tiny=True).replace(
        param_dtype=dtype, mla_absorb=absorb)
    rparams = RM.init_params(jax.random.PRNGKey(3), rcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), cfg, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (B_, PROMPT + STEPS), dtype=np.int32)
    return rcfg, cfg, rparams, params, tokens


def _block_list(rparams, params):
    """(name, use_moe, reference block, port block) in forward order."""
    out = []
    for stack, use_moe in (("dense_blocks", False), ("blocks", True)):
        n = jax.tree_util.tree_leaves(rparams[stack])[0].shape[0]
        for i in range(n):
            out.append((f"{stack}[{i}]", use_moe,
                        jax.tree_util.tree_map(lambda a: a[i],
                                               rparams[stack]),
                        pytree.tree_map(lambda a: a[i], params[stack])))
    return out


@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_blocks_match_reference_on_its_activations(dtype, absorb):
    """Every block, on the reference's input to it: the prompt's prefill
    into the block's MLA cache, then STEPS decode steps (``mla_absorb``:
    the latent-space route, else the re-expanded cache through the
    attention op); outputs, aux losses and caches within tolerance; then
    the final norm and the untied head."""
    rcfg, cfg, rparams, params, tokens = _deepseek(dtype, absorb)
    assert params["blocks"]["ffn"]["router"].dtype == torch.float32
    tol = TOL[dtype]
    emb = rparams["embed"]["embedding"]
    feeds = [(emb[jnp.asarray(tokens[:, :PROMPT])], 0)] + [
        (emb[jnp.asarray(tokens[:, PROMPT + j:PROMPT + j + 1])], PROMPT + j)
        for j in range(STEPS)]
    max_len = PROMPT + STEPS
    for name, use_moe, rb, pb in _block_list(rparams, params):
        rcache = RB.tblock_cache_init(rcfg, B_, max_len, rcfg.dtype)
        cache = B.tblock_cache_init(cfg, B_, max_len, cfg.dtype, "cpu")
        nxt = []
        for x, pos0 in feeds:
            l = x.shape[1]
            rpos = pos0 + jnp.arange(l)
            want, rcache, raux = RB.tblock_apply(rb, x, rcfg, rpos, rcache,
                                                 use_moe=use_moe)
            got, cache, aux = B.tblock_apply(
                pb, _torch(x, dtype), cfg, torch.arange(l) + pos0, cache,
                use_moe=use_moe)
            where = f"{name} at {pos0}"
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                       atol=tol, err_msg=where)
            assert abs(float(aux) - float(raux)) <= 1e-4 * max(
                abs(float(raux)), 1e-6), where
            nxt.append((want, pos0))
        for leaf in ("ckv", "krope"):
            np.testing.assert_allclose(_np(cache[leaf]), _np(rcache[leaf]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{name} {leaf}")
        assert int(cache["pos"]) == int(rcache["pos"]) == max_len
        feeds = nxt
    for x, _ in feeds:
        h = ref_rms_norm(x, rparams["final_ln"], rcfg.norm_eps)
        want = RM.unembed(rparams, rcfg, h)
        got = M.unembed(params, cfg, L.rms_norm(
            _torch(x, dtype), params["final_ln"], cfg.norm_eps))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mtp_head_matches_reference(dtype):
    """``mtp_hidden`` and ``mtp_logits`` on the same hidden states and next
    tokens (an MoE block with MLA inside)."""
    rcfg, cfg, rparams, params, tokens = _deepseek(dtype, True)
    x = np.random.default_rng(6).standard_normal(
        (B_, PROMPT, cfg.d_model)).astype(np.float32)
    rx = jnp.asarray(x, rcfg.dtype)
    nxt = tokens[:, 1:PROMPT + 1]
    want = RM.mtp_logits(rparams, rcfg, rx, jnp.asarray(nxt),
                         jnp.arange(PROMPT))
    got = M.mtp_logits(params, cfg, _torch(rx, dtype), torch.from_numpy(nxt),
                       torch.arange(PROMPT))
    assert got.shape == (B_, PROMPT, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_mla_decode_routes_agree_in_the_port():
    """The absorbed and re-expanded decodes give the same logits (float32),
    as the reference's own test holds its two routes."""
    outs = []
    for absorb in (True, False):
        _, cfg, _, params, tokens = _deepseek("float32", absorb)
        cache = M.init_cache(cfg, B_, PROMPT + STEPS, device="cpu")
        _, cache, _ = M.forward(params, cfg, torch.from_numpy(
            tokens[:, :PROMPT]), cache=cache, pos0=0)
        logits = [M.forward(params, cfg, torch.from_numpy(
            tokens[:, PROMPT + j:PROMPT + j + 1]), cache=cache,
            pos0=PROMPT + j)[0] for j in range(STEPS)]
        outs.append(torch.cat(logits, dim=1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


# ------------------------------------------- memory-bounded initialisation
def test_dense_init_draws_a_large_tensor_slab_by_slab(monkeypatch):
    """Past the slab size a tensor is drawn a leading-axis slab at a time:
    the first slab is what one draw of its shape gives, every value lies
    in the truncated range, and the slabs differ."""
    monkeypatch.setattr(L, "_SLAB", 12000)     # slabs of 2 rows of 600
    ini = L.Init(torch.Generator().manual_seed(9), "cpu")
    big = L.dense_init(ini, (10, 30, 20), 30, torch.float32)
    assert big.shape == (10, 30, 20) and big.dtype == torch.float32
    first = L.dense_init(L.Init(torch.Generator().manual_seed(9), "cpu"),
                         (2, 30, 20), 30, torch.float32)
    assert torch.equal(big[:2], first)
    assert float(big.abs().max()) <= 2.0 / math.sqrt(30) + 1e-6
    assert not torch.equal(big[0], big[1])


def test_stack_init_of_one_layer_is_the_layer():
    cfg = get_config("deepseek-v3-671b", tiny=True)
    gen = torch.Generator().manual_seed(2)
    one = L.stack_init(lambda i: B.tblock_init(i, cfg, use_moe=True),
                       L.Init(gen, "cpu"), 1)
    layer = B.tblock_init(L.Init(torch.Generator().manual_seed(2), "cpu"),
                          cfg, use_moe=True)
    for a, b in zip(pytree.tree_leaves(one), pytree.tree_leaves(layer)):
        assert a.shape == (1, *b.shape) and a.is_contiguous()
        assert torch.equal(a[0], b)


def test_full_width_depth_two_parameter_count():
    """deepseek-v3 at depth 2 (one dense, one MoE block): the analytic count
    (``param_count``, MTP excluded, as the reference counts) against the
    port's tree on the meta device, and the MTP head's share."""
    cfg = get_config("deepseek-v3-671b").replace(n_layers=2,
                                                 first_dense_layers=1)
    tree = M.init_params(None, cfg, "meta")
    n = sum(t.numel() for t in pytree.tree_leaves(tree))
    mtp = sum(t.numel() for t in pytree.tree_leaves(tree["mtp"]))
    norms = sum(t.numel() for k, t in pytree.tree_flatten_with_path(tree)[0]
                if "norm" in pytree.keystr(k) and "mtp" not in
                pytree.keystr(k))
    assert n - mtp - norms == cfg.param_count()
    assert 13.9e9 < cfg.param_count() < 14.0e9
    assert 25.4e9 < n < 25.6e9
