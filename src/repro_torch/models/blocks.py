"""Decoder blocks assembled from the attention / ffn / ssm modules (the
reference's ``repro/models/blocks.py``).  MoE feed-forwards come with a
later slice of the port."""
from __future__ import annotations

from typing import Optional

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, mlp_apply, mlp_init, rms_norm

MOE_SLICE = ("MoE feed-forwards (use_moe=True) are not ported yet: they "
             "come with the MoE slice of the port (ROADMAP.md)")


def _no_moe(use_moe: bool) -> None:
    if use_moe:
        raise NotImplementedError(MOE_SLICE)


# ---------------------------------------------------------------- transformer
def tblock_init(ini: Init, cfg, d_ff: Optional[int] = None,
                use_moe: bool = False):
    _no_moe(use_moe)
    return {
        "ln1": ini.full((cfg.d_model,), 1.0, cfg.dtype),
        "attn": attn.gqa_init(ini, cfg),
        "ln2": ini.full((cfg.d_model,), 1.0, cfg.dtype),
        "ffn": mlp_init(ini, cfg, d_ff=d_ff),
    }


def tblock_apply(params, x, cfg, positions, cache=None, use_moe: bool = False):
    """Returns (y, new_cache, aux_loss); the aux loss is MoE's, so 0.0
    here."""
    _no_moe(use_moe)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    a, new_cache = attn.gqa_apply(params["attn"], h, cfg, positions, cache)
    x = x + a
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h), new_cache, 0.0


# ---------------------------------------------------------------- ssm block
def sblock_init(ini: Init, cfg):
    m = (ssm_mod.mamba2_init if cfg.ssm_type == "mamba2"
         else ssm_mod.mamba1_init)(ini, cfg)
    return {"ln": ini.full((cfg.d_model,), 1.0, cfg.dtype), "ssm": m}


def sblock_apply(params, x, cfg, cache=None):
    h = rms_norm(x, params["ln"], cfg.norm_eps)
    apply = (ssm_mod.mamba2_apply if cfg.ssm_type == "mamba2"
             else ssm_mod.mamba1_apply)
    y, new_cache = apply(params["ssm"], h, cfg, cache)
    return x + y, new_cache, 0.0


# ---------------------------------------------------------------- cache ctors
def tblock_cache_init(cfg, batch: int, max_len: int, dtype, device="cuda"):
    return attn.gqa_cache_init(cfg, batch, max_len, dtype, device)


def sblock_cache_init(cfg, batch: int, dtype, device="cuda"):
    return (ssm_mod.mamba2_cache_init if cfg.ssm_type == "mamba2"
            else ssm_mod.mamba1_cache_init)(cfg, batch, dtype, device)
