"""Decoder blocks assembled from the attention / ffn / ssm modules (the
reference's ``repro/models/blocks.py``), and one application of the
released Zamba2 shared block (:func:`shared_apply`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Init, dense_init, mlp_apply, mlp_init, mlp_logical, rms_norm,
)


# ---------------------------------------------------------------- transformer
def tblock_init(ini: Init, cfg, d_ff: Optional[int] = None,
                use_moe: bool = False):
    mla = cfg.attn_type == "mla"
    params = {"ln1": ini.full((cfg.attn_in,), 1.0, cfg.dtype),
              "attn": (attn.mla_init if mla else attn.gqa_init)(ini, cfg),
              "ln2": ini.full((cfg.d_model,), 1.0, cfg.dtype)}
    params["ffn"] = (moe_mod.moe_init(ini, cfg) if use_moe
                     else mlp_init(ini, cfg, d_ff=d_ff))
    return params


def tblock_logical(cfg, use_moe: bool = False):
    a = (attn.mla_logical(cfg) if cfg.attn_type == "mla"
         else attn.gqa_logical(cfg))
    f = moe_mod.moe_logical(cfg) if use_moe else mlp_logical(cfg)
    return {"ln1": ("embed_act",), "attn": a, "ln2": ("embed_act",),
            "ffn": f}


def tblock_apply(params, x, cfg, positions, cache=None, use_moe: bool = False):
    """Returns (y, new_cache, aux_loss); the aux loss is MoE's (0.0 for a
    dense feed-forward)."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    apply = attn.mla_apply if cfg.attn_type == "mla" else attn.gqa_apply
    a, new_cache = apply(params["attn"], h, cfg, positions, cache)
    x = x + a
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if use_moe:
        f, aux = moe_mod.moe_apply(params["ffn"], h, cfg)
    else:
        f, aux = mlp_apply(params["ffn"], h, cfg.ffn_act), 0.0
    return x + f, new_cache, aux


# ------------------------------------------------- released Zamba2 hybrid
def hybrid_init(ini: Init, cfg):
    """One application's own weights: the linear its output goes through
    and, with ``adapter_rank``, the LoRA pair on the MLP's gate/up."""
    d, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    out = {"linear": dense_init(ini, (d, d), d, cfg.dtype)}
    if r:
        out["adapter_in"] = dense_init(ini, (d, r), d, cfg.dtype)
        out["adapter_out"] = dense_init(ini, (r, 2 * f), r, cfg.dtype)
    return out


def hybrid_logical(cfg):
    out = {"linear": ("embed", "embed")}
    if cfg.adapter_rank:
        out["adapter_in"] = ("embed", None)
        out["adapter_out"] = (None, "mlp")
    return out


def shared_apply(params, app, x, emb, cfg, positions):
    """One application of a shared block (its weights ``params``, the
    application's own ``app``) to the residual stream ``x`` beside the
    token embeddings ``emb``: RMSNorm of concat(x, emb), attention,
    RMSNorm, the gated MLP with the application's adapter, then the
    application's linear; no residual inside.  Returns (B, L, d_model),
    which the caller adds to the next mamba layer's input."""
    h = rms_norm(torch.cat([x, emb], dim=-1), params["ln1"], cfg.norm_eps)
    a, _ = attn.gqa_apply(params["attn"], h, cfg, positions)
    h = rms_norm(a, params["ln2"], cfg.norm_eps)
    adapter = ((app["adapter_in"], app["adapter_out"])
               if cfg.adapter_rank else None)
    f = mlp_apply(params["ffn"], h, cfg.ffn_act, adapter)
    return f @ app["linear"]


# ---------------------------------------------------------------- ssm block
def sblock_init(ini: Init, cfg):
    m = (ssm_mod.mamba2_init if cfg.ssm_type == "mamba2"
         else ssm_mod.mamba1_init)(ini, cfg)
    return {"ln": ini.full((cfg.d_model,), 1.0, cfg.dtype), "ssm": m}


def sblock_logical(cfg):
    m = (ssm_mod.mamba2_logical if cfg.ssm_type == "mamba2"
         else ssm_mod.mamba1_logical)(cfg)
    return {"ln": ("embed_act",), "ssm": m}


def sblock_apply(params, x, cfg, cache=None, t=None):
    """x + mamba(norm(x)), or with a shared block's output ``t``,
    x + mamba(norm(x + t))."""
    h = rms_norm(x if t is None else x + t, params["ln"], cfg.norm_eps)
    apply = (ssm_mod.mamba2_apply if cfg.ssm_type == "mamba2"
             else ssm_mod.mamba1_apply)
    y, new_cache = apply(params["ssm"], h, cfg, cache)
    return x + y, new_cache, 0.0


# ---------------------------------------------------------------- cache ctors
def tblock_cache_init(cfg, batch: int, max_len: int, dtype, device="cuda"):
    init = (attn.mla_cache_init if cfg.attn_type == "mla"
            else attn.gqa_cache_init)
    return init(cfg, batch, max_len, dtype, device)


def sblock_cache_init(cfg, batch: int, dtype, device="cuda"):
    return (ssm_mod.mamba2_cache_init if cfg.ssm_type == "mamba2"
            else ssm_mod.mamba1_cache_init)(cfg, batch, dtype, device)


def tblock_cache_logical(cfg):
    if cfg.attn_type == "mla":
        return attn.mla_cache_logical(cfg)
    return attn.gqa_cache_logical(cfg)


def sblock_cache_logical(cfg):
    return (ssm_mod.mamba2_cache_logical if cfg.ssm_type == "mamba2"
            else ssm_mod.mamba1_cache_logical)(cfg)
