"""ModelConfig — one dataclass covering every assigned architecture family.

A copy of ``repro/models/common.py`` whose ``dtype`` is a ``torch.dtype``
built from the same ``param_dtype`` string.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # --- attention -------------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla | none
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 => d_model // n_heads
    window: Optional[int] = None    # sliding-window attention (SWA)
    rope_theta: float = 1e4
    rope_half: bool = False         # rotate the halves of a head, not pairs
    kv_channels: int = 0            # softmax scale kv_channels^-1/2; 0: hd
    # --- ffn ----------------------------------------------------------------
    d_ff: int = 0
    ffn_act: str = "silu"           # silu | gelu (exact, erf)
    # --- MLA (deepseek-style multi-head latent attention) --------------------
    q_lora_rank: int = 0            # 0 => dense wq
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = True         # absorbed-matmul decode (§Perf 4.1)
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0             # d_ff of the leading dense layers
    capacity_factor: float = 1.25
    moe_group_size: int = 256       # tokens per GShard dispatch group
    mtp: bool = False               # multi-token-prediction head (deepseek)
    # --- SSM ------------------------------------------------------------------
    ssm_type: Optional[str] = None  # mamba1 | mamba2
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64          # mamba2 heads = d_inner // ssm_head_dim
    ssm_groups: int = 1             # mamba2 B/C groups
    dt_rank: int = 0                # mamba1; 0 => ceil(d_model / 16)
    ssm_chunk: int = 256            # chunked selective-scan chunk length
    # --- hybrid (zamba2: shared attention block between mamba blocks) --------
    shared_attn_every: int = 0
    # The released Zamba2 layout (empty: ``shared_attn_every``'s): before
    # each mamba layer listed, application a of the shared blocks (block
    # a % n_shared_blocks) reads concat(x, token embeddings), has no
    # residual inside, and its output, through a linear of the
    # application's own, is added to that layer's input; ``adapter_rank``
    # > 0 gives each application a LoRA adapter on the MLP's gate/up.
    hybrid_layer_ids: Tuple[int, ...] = ()
    n_shared_blocks: int = 1
    adapter_rank: int = 0
    # --- modality stub (audio / vlm backbones) --------------------------------
    frontend: Optional[str] = None  # audio | vision
    n_patches: int = 0              # vision tokens prepended (anyres stub)
    # --- numerics / implementation --------------------------------------------
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    scan_layers: bool = True
    remat: bool = True
    logits_fp32: bool = True

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def attn_in(self) -> int:
        """The input width of a transformer block's norm and attention: 2
        d_model in the released Zamba2 layout (x beside the token
        embeddings), else d_model."""
        return 2 * self.d_model if self.hybrid_layer_ids else self.d_model

    @property
    def sm_scale(self) -> Optional[float]:
        """The softmax scale where it is not 1/sqrt(hd), else None."""
        return self.kv_channels ** -0.5 if self.kv_channels else None

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def padded_for_tp(self, tp: int) -> "ModelConfig":
        """Round head counts up so they shard evenly over a ``tp``-way axis.

        The production mesh has a fixed 16-way ``model`` axis; archs like
        yi-34b (56 heads) or phi4-mini (24 heads, 8 KV heads) cannot split
        that evenly.  Replicating attention weights instead would leave the
        whole model axis idle during attention, so we *pad*: n_kv_heads →
        next multiple of tp, n_heads → next common multiple of (tp, kv').
        Padded heads are dead compute whose waste is surfaced by the
        roofline MODEL_FLOPS/HLO_FLOPS ratio (the unpadded config is the
        MODEL_FLOPS basis).  No-op when everything already divides.
        """
        if self.attn_type == "none" or self.n_heads == 0 or tp <= 1:
            return self

        def _up(x: int, mult: int) -> int:
            return ((x + mult - 1) // mult) * mult

        hd = self.hd              # freeze head_dim before head counts move
        h = _up(self.n_heads, tp)
        if self.attn_type == "mla":
            if h == self.n_heads:
                return self
            return self.replace(n_heads=h, head_dim=hd)
        kv = self.n_kv_heads
        kv2 = kv if kv % tp == 0 else _up(kv, tp)
        h2 = _up(h, kv2)          # group size must stay integral
        if h2 == self.n_heads and kv2 == self.n_kv_heads:
            return self
        return self.replace(n_heads=h2, n_kv_heads=kv2, head_dim=hd)

    # ------------------------------------------------------- parameter count
    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        n = v * d                              # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer_attn = 0
        if self.attn_type == "gqa":
            hd = self.hd
            per_layer_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        elif self.attn_type == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            if self.q_lora_rank:
                per_layer_attn += d * self.q_lora_rank \
                    + self.q_lora_rank * self.n_heads * qk
            else:
                per_layer_attn += d * self.n_heads * qk
            per_layer_attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer_attn += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim
            )
            per_layer_attn += self.n_heads * self.v_head_dim * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = 0
        if self.n_experts:
            moe_ffn = self.n_experts * 3 * d * self.moe_d_ff \
                + self.n_shared_experts * 3 * d * self.moe_d_ff \
                + d * self.n_experts          # router
        ssm = 0
        if self.ssm_type == "mamba1":
            di, st, dtr = self.d_inner, self.ssm_state, self.dt_rank_eff
            ssm = d * 2 * di + self.ssm_conv * di + di * (dtr + 2 * st) \
                + dtr * di + di * st + di + di * d
        elif self.ssm_type == "mamba2":
            di, st = self.d_inner, self.ssm_state
            nh, g = self.ssm_heads, self.ssm_groups
            proj_in = d * (2 * di + 2 * g * st + nh)
            ssm = proj_in + self.ssm_conv * (di + 2 * g * st) + nh \
                + di + di * d + nh            # A_log, D, dt_bias, norm
        total = n
        if self.family == "hybrid" and self.hybrid_layer_ids:
            # every leaf: each mamba layer with its conv bias and norm, each
            # shared block, each application's adapter and linear
            a, hd, f, r = self.attn_in, self.hd, self.d_ff, self.adapter_rank
            conv_dim = self.d_inner + 2 * self.ssm_groups * self.ssm_state
            shared = a + a * self.n_heads * hd \
                + 2 * a * self.n_kv_heads * hd + self.n_heads * hd * d \
                + d + 3 * d * f
            total += self.n_layers * (ssm + conv_dim + self.ssm_heads + d)
            total += self.n_shared_blocks * shared
            total += len(self.hybrid_layer_ids) * (r * (d + 2 * f) + d * d)
        elif self.family == "hybrid":
            # shared attention+ffn block counted once (weights are shared)
            n_shared_applications = (
                self.n_layers // self.shared_attn_every
                if self.shared_attn_every else 0
            )
            total += self.n_layers * (ssm + 2 * d)
            if n_shared_applications:
                hd = self.hd
                shared = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d) + 3 * d * self.d_ff + 2 * d
                total += shared
        elif self.ssm_type:
            total += self.n_layers * (ssm + d)
        elif self.n_experts:
            n_moe = self.n_layers - self.first_dense_layers
            total += self.first_dense_layers * (
                per_layer_attn + 3 * d * (self.dense_d_ff or self.d_ff) + 2 * d
            )
            total += n_moe * (per_layer_attn + moe_ffn + 2 * d)
        else:
            total += self.n_layers * (per_layer_attn + dense_ffn + 2 * d)
        total += d                             # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared, not all)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        all_experts = self.n_experts * 3 * d * self.moe_d_ff
        active_experts = self.top_k * 3 * d * self.moe_d_ff
        n_moe = self.n_layers - self.first_dense_layers
        return self.param_count() - n_moe * (all_experts - active_experts)
