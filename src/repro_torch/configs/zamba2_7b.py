"""zamba2-7b — Zyphra's released Zamba2-7B (Instruct) hybrid block.

[hf: Zyphra/Zamba2-7B-Instruct config.json]  81 Mamba2 layers at d_model
3584 (expand 2 → d_inner 7168, head 64 → 112 SSD heads, 2 B/C groups,
d_state 64, conv 4 with bias, chunk 256; the gated norm per group).  Two
weight-shared transformer blocks, applied in turn before the mamba layers
of ``hybrid_layer_ids`` (13 applications): each reads concat(hidden, token
embeddings), 7168 wide, through RMSNorm, attention of 32 heads at 224 with
RoPE (theta 1e4, the halves of a head rotated) and softmax scale
1/sqrt(112), RMSNorm, a gated GELU MLP 3584 → 2 x 14336 → 3584 with a
rank-128 LoRA adapter of the application's own on gate/up, then a linear
of the application's own; no residual inside.  Its output t enters the
mamba layer as x + mamba(norm(x + t)).  ``tie_word_embeddings`` is not in
the published config; the ``Zamba2Config`` default (tied) is taken.

:data:`PUBLISHED` holds the published values, :func:`from_hf_config` reads
them (or any Zamba2 config of this layout) into a ``ModelConfig``, and
:func:`hf_state_dict` names a parameter tree of the port the way the
released checkpoints (and ``transformers``' ``Zamba2ForCausalLM``) do.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ModelConfig

PUBLISHED = {
    "adapter_rank": 128, "add_bias_linear": False,
    "attention_head_dim": 224, "attention_hidden_size": 7168,
    "chunk_size": 256, "ffn_hidden_size": 14336, "hidden_act": "gelu",
    "hidden_size": 3584,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "intermediate_size": 14336, "kv_channels": 112, "mamba_d_conv": 4,
    "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64,
    "mamba_ngroups": 2, "max_position_embeddings": 4096, "n_mamba_heads": 112,
    "num_attention_heads": 32, "num_hidden_layers": 81,
    "num_key_value_heads": 32, "num_mem_blocks": 2, "rms_norm_eps": 1e-05,
    "rope_theta": 10000, "use_conv_bias": True, "use_long_context": False,
    "use_mem_rope": True, "use_shared_attention_adapter": False,
    "use_shared_mlp_adapter": True, "vocab_size": 32000,
}

_ACTS = {"gelu": "gelu", "silu": "silu", "swish": "silu"}


def from_hf_config(hf: dict, arch_id: str = "zamba2-7b") -> ModelConfig:
    """A ``ModelConfig`` of a Zamba2 ``config.json``'s values.  Raises for
    the parts of Zamba2 the port does not run: attention adapters, the
    long-context RoPE, a shared block without the embedding concat, or
    linear biases."""
    d, heads = int(hf["hidden_size"]), int(hf["num_attention_heads"])
    unsupported = {
        "use_shared_attention_adapter": hf.get(
            "use_shared_attention_adapter", False),
        "use_long_context": hf.get("use_long_context", False),
        "add_bias_linear": hf.get("add_bias_linear", False),
        "use_mem_rope off": not hf.get("use_mem_rope", False),
        "attention_hidden_size != 2 hidden_size":
            int(hf.get("attention_hidden_size", 2 * d)) != 2 * d,
        "use_conv_bias off": not hf.get("use_conv_bias", True),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"{arch_id}: not ported: {', '.join(bad)}")
    d_inner = int(hf["mamba_expand"]) * d
    if d_inner // int(hf["mamba_headdim"]) != int(
            hf.get("n_mamba_heads", d_inner // int(hf["mamba_headdim"]))):
        raise ValueError(f"{arch_id}: n_mamba_heads is not "
                         "d_inner / mamba_headdim")
    return ModelConfig(
        arch_id=arch_id, family="hybrid",
        n_layers=int(hf["num_hidden_layers"]), d_model=d,
        vocab=int(hf["vocab_size"]),
        attn_type="gqa", n_heads=heads,
        n_kv_heads=int(hf.get("num_key_value_heads") or heads),
        head_dim=int(hf.get("attention_head_dim", 2 * d // heads)),
        kv_channels=int(hf.get("kv_channels", d // heads)),
        rope_theta=float(hf["rope_theta"]), rope_half=True,
        d_ff=int(hf["intermediate_size"]),
        ffn_act=_ACTS[hf.get("hidden_act", "gelu")],
        ssm_type="mamba2", ssm_state=int(hf["mamba_d_state"]),
        ssm_expand=int(hf["mamba_expand"]), ssm_conv=int(hf["mamba_d_conv"]),
        ssm_head_dim=int(hf["mamba_headdim"]),
        ssm_groups=int(hf["mamba_ngroups"]),
        ssm_chunk=int(hf["chunk_size"]),
        hybrid_layer_ids=tuple(int(i) for i in hf["hybrid_layer_ids"]),
        n_shared_blocks=int(hf["num_mem_blocks"]),
        adapter_rank=(int(hf["adapter_rank"])
                      if hf.get("use_shared_mlp_adapter", True) else 0),
        norm_eps=float(hf["rms_norm_eps"]),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
    )


CONFIG = from_hf_config(PUBLISHED)

TINY = CONFIG.replace(
    n_layers=10, d_model=64, vocab=512, n_heads=4, n_kv_heads=4,
    head_dim=32, kv_channels=16, d_ff=128, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, hybrid_layer_ids=(2, 4, 6, 8), adapter_rank=8,
)


def hf_state_dict(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """``params`` (the port's tree for ``cfg``) under the names and in the
    layouts of ``Zamba2ForCausalLM.state_dict()``: views and transposes of
    the port's tensors (gate and up concatenated).  Each shared block's
    weights (and its applications' adapters) appear under every layer
    that applies it, as there."""
    out = {"model.embed_tokens.weight": params["embed"]["embedding"],
           "model.final_layernorm.weight": params["final_ln"]}
    out["lm_head.weight"] = (params["embed"]["embedding"]
                             if cfg.tie_embeddings else params["lm_head"].t())
    ids = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}
    nb = cfg.n_shared_blocks
    for i in range(cfg.n_layers):
        blk = {k: v[i] for k, v in params["blocks"]["ssm"].items()}
        pre = f"model.layers.{i}."
        if i in ids:
            a = ids[i]
            pre_m = pre + "mamba_decoder."
            out[pre + "linear.weight"] = params["hybrid"]["linear"][a].t()
            st = pre + "shared_transformer."
            out.update(_shared(params, cfg, a % nb, st))
            if cfg.adapter_rank:
                for j in range(a % nb, len(cfg.hybrid_layer_ids), nb):
                    ad = (f"{st}feed_forward.gate_up_proj_adapter_list."
                          f"{j}.")
                    out[ad + "0.weight"] = \
                        params["hybrid"]["adapter_in"][j].t()
                    out[ad + "1.weight"] = \
                        params["hybrid"]["adapter_out"][j].t()
        else:
            pre_m = pre
        out[pre_m + "input_layernorm.weight"] = params["blocks"]["ln"][i]
        m = pre_m + "mamba."
        out[m + "in_proj.weight"] = blk["in_proj"].t()
        out[m + "conv1d.weight"] = blk["conv_w"].t().unsqueeze(1)
        out[m + "conv1d.bias"] = blk["conv_b"]
        for k in ("dt_bias", "A_log", "D"):
            out[m + k] = blk[k]
        out[m + "norm.weight"] = blk["norm_w"]
        out[m + "out_proj.weight"] = blk["out_proj"].t()
    return out


def _shared(params, cfg: ModelConfig, b: int, pre: str) -> dict:
    p = {k: v[b] for k, v in params["shared_blocks"]["attn"].items()}
    ffn = {k: v[b] for k, v in params["shared_blocks"]["ffn"].items()}
    a, h, hkv, hd = cfg.attn_in, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sa = pre + "self_attn."
    return {
        pre + "input_layernorm.weight": params["shared_blocks"]["ln1"][b],
        pre + "pre_ff_layernorm.weight": params["shared_blocks"]["ln2"][b],
        sa + "q_proj.weight": p["wq"].reshape(a, h * hd).t(),
        sa + "k_proj.weight": p["wk"].reshape(a, hkv * hd).t(),
        sa + "v_proj.weight": p["wv"].reshape(a, hkv * hd).t(),
        sa + "o_proj.weight": p["wo"].reshape(h * hd, cfg.d_model).t(),
        pre + "feed_forward.gate_up_proj.weight":
            torch.cat([ffn["w_gate"], ffn["w_up"]], dim=1).t(),
        pre + "feed_forward.down_proj.weight": ffn["w_down"].t(),
    }
