"""Attention: GQA with an optional sliding window (the reference's
``repro/models/attention.py:36-124``).

Every attention call, prefill and decode alike, goes through
:func:`repro_torch.kernels.flash_attention.ops.attention`: the hand kernel
on CUDA, its plain twin on the CPU.  The reference sends decode to its jnp
``attention_ref``; here decode is the kernel with ``Lq = 1`` and a run-time
``kv_len`` (and ``q_offset``), the same function.

Cache: ``{"k","v": (B, Hkv, M, hd), "pos"}`` — M = max_len, or M = window
for SWA (rolling slots: slot = pos % window, which is exactly the entry
leaving the window).  ``pos`` is a host (CPU) int32 tensor, so the slots
and ``kv_len`` are known without waiting on the card.  The cache is updated
in place (the reference donates it to the decode step).

MLA (``attn_type == "mla"``) comes with a later slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import Init, apply_rope, dense_init

Cache = dict

MLA_SLICE = ("MLA attention (attn_type='mla') is not ported yet: it comes "
             "with the MLA slice of the port (ROADMAP.md)")


def _gqa_only(cfg) -> None:
    if cfg.attn_type == "mla":
        raise NotImplementedError(MLA_SLICE)


def gqa_init(ini: Init, cfg):
    _gqa_only(cfg)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(ini, (d, h, hd), d, cfg.dtype),
        "wk": dense_init(ini, (d, hkv, hd), d, cfg.dtype),
        "wv": dense_init(ini, (d, hkv, hd), d, cfg.dtype),
        "wo": dense_init(ini, (h, hd, d), h * hd, cfg.dtype),
    }


def gqa_cache_init(cfg, batch: int, max_len: int, dtype,
                   device="cuda") -> Cache:
    _gqa_only(cfg)
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
    _gqa_only(cfg)
    b, l, _ = x.shape
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_heads(x, params["wk"]), positions, cfg.rope_theta)
    v = _heads(x, params["wv"])

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
    h, hd, d = params["wo"].shape
    out = y.permute(0, 2, 1, 3).reshape(b, l, h * hd) @ params["wo"].reshape(
        h * hd, d)
    return out, new_cache


def _scatter_seq(cache_kv: torch.Tensor, new: torch.Tensor,
                 start: int) -> None:
    """Write new (B,H,L,D) entries into cache (B,H,M,D) at slots
    ``(start + i) % M``, in place (at most two contiguous runs)."""
    m, n = cache_kv.shape[2], new.shape[2]
    first = min(n, m - start)
    cache_kv[:, :, start:start + first] = new[:, :, :first]
    if n > first:
        cache_kv[:, :, :n - first] = new[:, :, first:]
