"""Attention: GQA with an optional sliding window, and MLA (the
reference's ``repro/models/attention.py``).

Every GQA attention call, prefill and decode alike, goes through
:func:`repro_torch.kernels.flash_attention.ops.attention`: the hand kernel
on CUDA, its plain twin on the CPU.  The reference sends decode to its jnp
``attention_ref``; here decode is the kernel with ``Lq = 1`` and a run-time
``kv_len`` (and ``q_offset``), the same function.

Caches (``pos`` is a host (CPU) int32 tensor, so the slots and ``kv_len``
are known without waiting on the card; a cache is updated in place, where
the reference donates it to the decode step):
  * GQA: ``{"k","v": (B, Hkv, M, hd), "pos"}`` — M = max_len, or M =
    window for SWA (rolling slots: slot = pos % window, which is exactly
    the entry leaving the window).
  * MLA: ``{"ckv": (B, M, kv_lora), "krope": (B, M, rope_dim), "pos"}`` —
    deepseek's compressed-latent cache, the reference's leaf names and
    shapes, so a decode checkpoint crosses packages.

MLA prefill re-expands per-head K (``qk_nope + qk_rope`` = 192 wide at
full size) and V (``v_head_dim`` = 128) from the latent and calls the
kernel with those two head dims.  Decode keeps the reference's two routes:
``cfg.mla_absorb`` (the default) attends in latent space with plain
einsums, as the reference (no kernel there); otherwise the whole cache is
re-expanded and, unlike the reference's ``attention_ref``, goes through
the kernel (its split-KV decode route at 192 / 128).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import Init, apply_rope, dense_init, rms_norm
from repro_torch.sharding.activations import constrain

Cache = dict


# =========================================================================
# GQA (llama-family; covers MHA when n_kv_heads == n_heads) + SWA option
# =========================================================================
def gqa_init(ini: Init, cfg):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(ini, (d, h, hd), d, cfg.dtype),
        "wk": dense_init(ini, (d, hkv, hd), d, cfg.dtype),
        "wv": dense_init(ini, (d, hkv, hd), d, cfg.dtype),
        "wo": dense_init(ini, (h, hd, d), h * hd, cfg.dtype),
    }


def gqa_logical(cfg):
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def gqa_cache_logical(cfg):
    return {
        "k": ("batch", "kv_heads", "seq", "head_dim"),
        "v": ("batch", "kv_heads", "seq", "head_dim"),
        "pos": (),
    }


def gqa_cache_init(cfg, batch: int, max_len: int, dtype,
                   device="cuda") -> Cache:
    m = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.n_kv_heads, m, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->bhlk"): a (B, H, L, hd) view of one matmul."""
    b, l, _ = x.shape
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(b, l, h, k).permute(0, 2, 1, 3)


def gqa_apply(
    params, x: torch.Tensor, cfg, positions: torch.Tensor,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    b, l, _ = x.shape
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_heads(x, params["wk"]), positions, cfg.rope_theta)
    v = _heads(x, params["wv"])
    q = constrain(q, "batch", "heads", None, "head_dim")
    k = constrain(k, "batch", "kv_heads", None, "head_dim")
    v = constrain(v, "batch", "kv_heads", None, "head_dim")

    if cache is None:
        y = attention(q, k, v, causal=True, window=cfg.window)
        new_cache = None
    else:
        m = cache["k"].shape[2]
        pos = int(cache["pos"])
        rolling = cfg.window is not None and m == cfg.window
        if rolling:
            # keep only the newest min(l, m) entries (unique slots)
            keep = min(l, m)
            start = (pos + l - keep) % m
            _scatter_seq(cache["k"], k[:, :, l - keep:], start)
            _scatter_seq(cache["v"], v[:, :, l - keep:], start)
            if l == 1:
                # decode: every valid slot is inside the newest query's
                # window (the overwritten slot is exactly the one leaving it)
                y = attention(q, cache["k"], cache["v"], causal=False,
                              kv_len=min(pos + 1, m))
            else:
                # single-shot prefill (pos == 0 assumed, as the reference)
                y = attention(q, k, v, causal=True, window=cfg.window)
        else:
            if pos + l > m:
                raise ValueError(f"KV cache full: {pos} + {l} positions "
                                 f"exceed its {m} slots")
            _scatter_seq(cache["k"], k, pos)
            _scatter_seq(cache["v"], v, pos)
            if l > 1:
                # single-shot prefill (pos == 0): attention over the chunk
                y = attention(q, k, v, causal=True, window=cfg.window)
            else:
                y = attention(q, cache["k"], cache["v"], causal=True,
                              q_offset=pos, kv_len=pos + l)
        cache["pos"] += l
        new_cache = cache
    return _out_proj(y, params["wo"]), new_cache


def _out_proj(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bhlk,hkd->bld") of the heads' outputs (B, H, L, hd)."""
    b, _, l, _ = y.shape
    h, hd, d = wo.shape
    return y.permute(0, 2, 1, 3).reshape(b, l, h * hd) @ wo.reshape(h * hd, d)


def _scatter_seq(cache_kv: torch.Tensor, new: torch.Tensor,
                 start: int) -> None:
    """Write new (B,H,L,D) entries into cache (B,H,M,D) at slots
    ``(start + i) % M``, in place (at most two contiguous runs)."""
    m, n = cache_kv.shape[2], new.shape[2]
    first = min(n, m - start)
    cache_kv[:, :, start:start + first] = new[:, :, :first]
    if n > first:
        cache_kv[:, :, :n - first] = new[:, :, first:]


# =========================================================================
# MLA — multi-head latent attention (deepseek-v3)
# =========================================================================
def mla_init(ini: Init, cfg):
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    params = {
        "wkv_a": dense_init(ini, (d, r + cfg.qk_rope_dim), d, cfg.dtype),
        "kv_norm": ini.full((r,), 1.0, cfg.dtype),
        "wkv_b": dense_init(ini, (r, h, cfg.qk_nope_dim + cfg.v_head_dim),
                            r, cfg.dtype),
        "wo": dense_init(ini, (h, cfg.v_head_dim, d), h * cfg.v_head_dim,
                         cfg.dtype),
    }
    if cfg.q_lora_rank:
        params["wq_a"] = dense_init(ini, (d, cfg.q_lora_rank), d, cfg.dtype)
        params["q_norm"] = ini.full((cfg.q_lora_rank,), 1.0, cfg.dtype)
        params["wq_b"] = dense_init(ini, (cfg.q_lora_rank, h, qk),
                                    cfg.q_lora_rank, cfg.dtype)
    else:
        params["wq"] = dense_init(ini, (d, h, qk), d, cfg.dtype)
    return params


def mla_logical(cfg):
    out = {
        "wkv_a": ("embed", "latent"),
        "kv_norm": (None,),
        "wkv_b": ("latent", "heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.q_lora_rank:
        out["wq_a"] = ("embed", "latent")
        out["q_norm"] = (None,)
        out["wq_b"] = ("latent", "heads", "head_dim")
    else:
        out["wq"] = ("embed", "heads", "head_dim")
    return out


def mla_cache_logical(cfg):
    return {
        "ckv": ("batch", "seq", "latent"),
        "krope": ("batch", "seq", None),
        "pos": (),
    }


def mla_cache_init(cfg, batch: int, max_len: int, dtype,
                   device="cuda") -> Cache:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def _mla_q(params, x, cfg, positions):
    if cfg.q_lora_rank:
        cq = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = _heads(cq, params["wq_b"])
    else:
        q = _heads(x, params["wq"])
    nope = cfg.qk_nope_dim
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return torch.cat([q[..., :nope], q_rope], dim=-1)


def _mla_expand_kv(params, ckv, krope, cfg):
    """Re-expand per-head K (B, H, L, nope + rope) and V (B, H, L, v) from
    the compressed latent (paper-faithful).  One matmul gives K's nope
    part and V side by side; V is a view of it."""
    nope = cfg.qk_nope_dim
    kv = _heads(ckv, params["wkv_b"])                  # (B, H, L, nope + v)
    b, h, l, _ = kv.shape
    k_rope = krope[:, None].expand(b, h, l, cfg.qk_rope_dim).to(kv.dtype)
    return torch.cat([kv[..., :nope], k_rope], dim=-1), kv[..., nope:]


def mla_apply(
    params, x: torch.Tensor, cfg, positions: torch.Tensor,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    b, l, _ = x.shape
    sm_scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q = _mla_q(params, x, cfg, positions)

    r = cfg.kv_lora_rank
    ckv_full = x @ params["wkv_a"]
    ckv = rms_norm(ckv_full[..., :r], params["kv_norm"], cfg.norm_eps)
    krope = apply_rope(ckv_full[..., r:][:, None], positions,
                       cfg.rope_theta)[:, 0]

    if cache is None:
        k, v = _mla_expand_kv(params, ckv, krope, cfg)
        y = attention(q, k, v, causal=True, sm_scale=sm_scale)
        new_cache = None
    else:
        pos = int(cache["pos"])
        m = cache["ckv"].shape[1]
        if pos + l > m:
            raise ValueError(f"MLA cache full: {pos} + {l} positions exceed "
                             f"its {m} slots")
        cache["ckv"][:, pos:pos + l] = ckv
        cache["krope"][:, pos:pos + l] = krope
        if l > 1:
            # single-shot prefill (pos == 0): expand only the chunk's K/V
            k, v = _mla_expand_kv(params, ckv, krope, cfg)
            y = attention(q, k, v, causal=True, sm_scale=sm_scale)
        elif cfg.mla_absorb:
            y = _mla_absorbed_decode(params, q, cache["ckv"], cache["krope"],
                                     cfg, sm_scale, pos)
        else:
            # the re-expanded cache, through the kernel (split_decode)
            k, v = _mla_expand_kv(params, cache["ckv"], cache["krope"], cfg)
            y = attention(q, k, v, causal=True, sm_scale=sm_scale,
                          q_offset=pos, kv_len=pos + l)
        cache["pos"] += l
        new_cache = cache
    return _out_proj(y, params["wo"]), new_cache


def _mla_absorbed_decode(params, q, ckv_cache, krope_cache, cfg, sm_scale,
                         pos: int):
    """Decode attention in latent space (deepseek's absorbed formulation):

    scores  = q_nope·(W_k c) + q_rope·k_rope  =  (W_k^T q_nope)·c + ...
    context = W_v^T (sum_t p_t c_t)

    No (B, H, M, ·) expanded K/V tensor; the same math as the expanded
    route.  Plain einsums with the reference's roundings (the products in
    the cache's dtype, the softmax in float32).  Returns y (B, H, 1, v).
    """
    nope = cfg.qk_nope_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    wk = params["wkv_b"][..., :nope]                  # (R, H, nope)
    wv = params["wkv_b"][..., nope:]                  # (R, H, v)
    q_lat = torch.einsum("bhln,rhn->bhlr", q_nope, wk)
    s = (torch.einsum("bhlr,bmr->bhlm", q_lat, ckv_cache)
         + torch.einsum("bhlp,bmp->bhlm", q_rope,
                        krope_cache.to(q_rope.dtype)))
    s = s.float() * sm_scale                          # (B, H, 1, M)
    m = ckv_cache.shape[1]
    valid = torch.arange(m, device=s.device) <= pos   # causal over cache
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1).to(ckv_cache.dtype)
    ctx_lat = torch.einsum("bhlm,bmr->bhlr", p, ckv_cache)
    return torch.einsum("bhlr,rhv->bhlv", ctx_lat, wv)
