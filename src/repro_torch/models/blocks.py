"""Decoder blocks assembled from the attention / ffn / ssm modules (the
reference's ``repro/models/blocks.py``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    Init, mlp_apply, mlp_init, mlp_logical, rms_norm,
)


# ---------------------------------------------------------------- transformer
def tblock_init(ini: Init, cfg, d_ff: Optional[int] = None,
                use_moe: bool = False):
    mla = cfg.attn_type == "mla"
    params = {"ln1": ini.full((cfg.d_model,), 1.0, cfg.dtype),
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
        f, aux = mlp_apply(params["ffn"], h), 0.0
    return x + f, new_cache, aux


# ---------------------------------------------------------------- ssm block
def sblock_init(ini: Init, cfg):
    m = (ssm_mod.mamba2_init if cfg.ssm_type == "mamba2"
         else ssm_mod.mamba1_init)(ini, cfg)
    return {"ln": ini.full((cfg.d_model,), 1.0, cfg.dtype), "ssm": m}


def sblock_logical(cfg):
    m = (ssm_mod.mamba2_logical if cfg.ssm_type == "mamba2"
         else ssm_mod.mamba1_logical)(cfg)
    return {"ln": ("embed_act",), "ssm": m}


def sblock_apply(params, x, cfg, cache=None):
    h = rms_norm(x, params["ln"], cfg.norm_eps)
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
