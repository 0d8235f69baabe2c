"""Full language-model assembly: embed → blocks → norm → logits (the
reference's ``repro/models/model.py``).

Families of the port
  * dense / audio / vlm — transformer blocks (GQA, optional sliding
    window); the modality frontends are the reference's stubs: ``embeds``
    (B, P, D), precomputed frame or patch embeddings, go before the token
    embeddings and take positions 0 … P-1,
  * moe    — ``first_dense_layers`` dense blocks, then MoE blocks (GQA or
    MLA attention), and deepseek's multi-token-prediction head
    (``cfg.mtp``: :func:`mtp_hidden`, used by the training loss),
  * ssm    — mamba1/mamba2 blocks (attention-free),
  * hybrid — zamba2: groups of ``shared_attn_every`` mamba2 blocks with ONE
    weight-shared transformer block applied between groups.

Parameters keep the reference's tree and layer-stacked layout: ``blocks``
(and the moe family's ``dense_blocks``) leaves are ``(n_layers, ...)``;
``shared_block``, ``lm_head`` and ``mtp`` are as there, and
``param_logical`` / ``cache_logical`` give the reference's logical dims
of both trees.  The reference's ``lax.scan`` over layers is a Python loop
over the stacked leaves.  The reference's mesh constraints are here too
(``sharding.activations.constrain``: the residual stream pinned to
(batch, seq, embed_act) after the embedding and every block): no-ops on
plain tensors, redistributions when the parameters and inputs are
DTensors on a mesh (``launch.train.run(mesh=...)``, the dry-run).

Training is ``forward_hidden`` without a cache.  Where autograd records,
``cfg.remat`` (the default) wraps every block in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, as the
reference wraps its blocks in ``jax.checkpoint``: only each block's input
is kept, and the backward reruns the block's forward (its hand kernels
included) before differentiating it.

Caches keep the reference's tree too (``{"layers": {...stacked},
"shared": {...stacked}}``, same leaf names, shapes and dtypes), so a decode
checkpoint has the same files in both packages.  The ``(n_layers,)`` int32
``pos`` leaves live on the host (CPU) whatever the device: each layer
reads its position without a device sync.  Every other leaf lives on the
parameters' device and is updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as blk
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (
    Init, dense_init, embed_apply, embed_init, embed_logical, rms_norm,
    stack_init, unembed_apply,
)
from repro_torch.sharding.activations import constrain
from repro_torch.sharding.logical import is_dims

SERVED_FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")
DENSE_FAMILIES = ("dense", "audio", "vlm")


def _served(cfg: ModelConfig) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.arch_id})")


def _prepend(axis: str, tree):
    return pytree.tree_map(lambda dims: (axis, *dims), tree,
                           is_leaf=is_dims)


def _layer_slice(tree, i: int):
    return pytree.tree_map(lambda x: x[i], tree)


def _layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a layer-stacked tree, taken at once
    with ``unbind``: under autograd its backward stacks the layers'
    gradients in one pass, where ``x[i]`` once a layer would add a
    zero-filled gradient of the whole stacked leaf n times."""
    leaves, spec = pytree.tree_flatten(tree)
    per = [x.unbind(0) for x in leaves]
    return [pytree.tree_unflatten([p[i] for p in per], spec)
            for i in range(n)]


# ==========================================================================
# parameters
# ==========================================================================
def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda"):
    """Random parameters from ``gen`` (a generator on ``device``), one
    tensor at a time in float32 rounded to ``cfg.dtype``.  On the ``meta``
    device ``gen`` may be None: shapes and dtypes only."""
    _served(cfg)
    ini = Init(gen, device)
    params = {"embed": embed_init(ini, cfg),
              "final_ln": ini.full((cfg.d_model,), 1.0, cfg.dtype)}
    if cfg.family in DENSE_FAMILIES:
        params["blocks"] = stack_init(
            lambda i: blk.tblock_init(i, cfg), ini, cfg.n_layers)
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            params["dense_blocks"] = stack_init(
                lambda i: blk.tblock_init(
                    i, cfg, d_ff=cfg.dense_d_ff or cfg.d_ff),
                ini, cfg.first_dense_layers)
        params["blocks"] = stack_init(
            lambda i: blk.tblock_init(i, cfg, use_moe=True), ini,
            cfg.n_layers - cfg.first_dense_layers)
    else:
        params["blocks"] = stack_init(
            lambda i: blk.sblock_init(i, cfg), ini, cfg.n_layers)
        if cfg.family == "hybrid":
            params["shared_block"] = blk.tblock_init(ini, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            ini, (cfg.d_model, cfg.vocab), cfg.d_model, cfg.dtype)
    if cfg.mtp:
        params["mtp"] = {
            "proj": dense_init(ini, (2 * cfg.d_model, cfg.d_model),
                               2 * cfg.d_model, cfg.dtype),
            "ln": ini.full((cfg.d_model,), 1.0, cfg.dtype),
            "block": blk.tblock_init(ini, cfg, use_moe=cfg.family == "moe"),
        }
    return params


def param_logical(cfg: ModelConfig):
    """The parameters' logical dims, the reference's tree."""
    out = {"embed": embed_logical(cfg), "final_ln": ("embed_act",)}
    if cfg.family in DENSE_FAMILIES:
        out["blocks"] = _prepend("layers", blk.tblock_logical(cfg))
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            out["dense_blocks"] = _prepend("layers", blk.tblock_logical(cfg))
        out["blocks"] = _prepend("layers",
                                 blk.tblock_logical(cfg, use_moe=True))
    elif cfg.family == "ssm":
        out["blocks"] = _prepend("layers", blk.sblock_logical(cfg))
    elif cfg.family == "hybrid":
        out["blocks"] = _prepend("layers", blk.sblock_logical(cfg))
        out["shared_block"] = blk.tblock_logical(cfg)
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    if cfg.mtp:
        out["mtp"] = {
            "proj": ("embed", "embed"),
            "ln": ("embed_act",),
            "block": blk.tblock_logical(cfg, use_moe=cfg.family == "moe"),
        }
    return out


# ==========================================================================
# caches
# ==========================================================================
def _stack_cache(proto, n: int, device):
    """``n`` zeroed copies of a one-layer cache, stacked; ``proto`` is on
    the meta device except its host ``pos`` leaf, which stays on the CPU."""
    return pytree.tree_map(
        lambda a: torch.zeros((n, *a.shape), dtype=a.dtype,
                              device=device if a.is_meta else a.device),
        proto)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    _served(cfg)
    dtype = dtype or cfg.dtype
    if cfg.family in DENSE_FAMILIES:
        proto = blk.tblock_cache_init(cfg, batch, max_len, dtype, "meta")
        return {"layers": _stack_cache(proto, cfg.n_layers, device)}
    if cfg.family == "moe":
        proto = blk.tblock_cache_init(cfg, batch, max_len, dtype, "meta")
        out = {"layers": _stack_cache(
            proto, cfg.n_layers - cfg.first_dense_layers, device)}
        if cfg.first_dense_layers:
            out["dense_layers"] = _stack_cache(
                proto, cfg.first_dense_layers, device)
        return out
    sproto = blk.sblock_cache_init(cfg, batch, dtype, "meta")
    out = {"layers": _stack_cache(sproto, cfg.n_layers, device)}
    if cfg.family == "hybrid":
        tproto = blk.tblock_cache_init(cfg, batch, max_len, dtype, "meta")
        n_shared = (cfg.n_layers // cfg.shared_attn_every
                    if cfg.shared_attn_every else 0)
        out["shared"] = _stack_cache(tproto, max(1, n_shared), device)
    return out


def cache_logical(cfg: ModelConfig):
    """The caches' logical dims, the reference's tree."""
    if cfg.family in DENSE_FAMILIES or cfg.family == "moe":
        proto = _prepend("layers", blk.tblock_cache_logical(cfg))
        out = {"layers": proto}
        if cfg.family == "moe" and cfg.first_dense_layers:
            out["dense_layers"] = proto
        return out
    if cfg.family == "ssm":
        return {"layers": _prepend("layers", blk.sblock_cache_logical(cfg))}
    if cfg.family == "hybrid":
        return {"layers": _prepend("layers", blk.sblock_cache_logical(cfg)),
                "shared": _prepend("layers", blk.tblock_cache_logical(cfg))}
    raise ValueError(cfg.family)


# ==========================================================================
# forward
# ==========================================================================
def _remat(block_apply, cfg: ModelConfig, cache):
    """``block_apply`` under activation checkpointing where the reference
    remats (training: no cache, ``cfg.remat``) and autograd records."""
    if cache is not None or not cfg.remat or not torch.is_grad_enabled():
        return block_apply

    def fn(p, h, c):
        return checkpoint(block_apply, p, h, c, use_reentrant=False)

    return fn


def _run_stack(block_apply, stacked_params, x, cfg: ModelConfig,
               caches=None):
    """Run a homogeneous stack of blocks, layer by layer; the stacked
    caches are updated in place.  Returns (x, aux)."""
    n = pytree.tree_leaves(stacked_params)[0].shape[0]
    fn = _remat(block_apply, cfg, caches)
    aux = 0.0
    x = constrain(x, "batch", "seq", "embed_act")
    for i, p in enumerate(_layers(stacked_params, n)):
        c = _layer_slice(caches, i) if caches is not None else None
        x, _, a = fn(p, x, c)
        x = constrain(x, "batch", "seq", "embed_act")
        aux = aux + a
    return x, aux


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Hidden (B, L, D) → logits (B, L, V); handles tied/untied heads."""
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], x, fp32=cfg.logits_fp32)
    logits = x @ params["lm_head"]
    return logits.float() if cfg.logits_fp32 else logits


def forward_hidden(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,     # (B, L) integer
    embeds: Optional[torch.Tensor] = None,     # (B, P, D) modality stub
    cache=None,
    pos0=None,                                 # host integer offset
) -> Tuple[torch.Tensor, Optional[dict], float]:
    """Returns (final hidden (B, P + L, D), new_cache, aux_loss).

    The unembed projection is not applied: serving unembeds only the
    positions it needs.  ``cache`` is updated in place and returned.  The
    aux loss is MoE's (the sum over MoE blocks; 0.0 for the other
    families).
    """
    _served(cfg)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(cfg.dtype))
    if tokens is not None:
        parts.append(embed_apply(params["embed"], tokens))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    x = constrain(x, "batch", "seq", "embed_act")
    l = x.shape[1]
    pos0 = 0 if pos0 is None else int(pos0)
    positions = torch.arange(l, device=x.device) + pos0

    def t_apply(p, h, c):
        return blk.tblock_apply(p, h, cfg, positions, c)

    def s_apply(p, h, c):
        return blk.sblock_apply(p, h, cfg, c)

    def moe_apply(p, h, c):
        return blk.tblock_apply(p, h, cfg, positions, c, use_moe=True)

    if cfg.family == "hybrid":
        x, aux = _hybrid_forward(params, x, cfg, positions, cache)
    elif cfg.family == "moe":
        aux = 0.0
        if cfg.first_dense_layers:
            caches = cache["dense_layers"] if cache is not None else None
            x, aux = _run_stack(t_apply, params["dense_blocks"], x, cfg,
                                caches)
        caches = cache["layers"] if cache is not None else None
        x, a = _run_stack(moe_apply, params["blocks"], x, cfg, caches)
        aux = aux + a
    else:
        caches = cache["layers"] if cache is not None else None
        fn = t_apply if cfg.family in DENSE_FAMILIES else s_apply
        x, aux = _run_stack(fn, params["blocks"], x, cfg, caches)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, cache, aux


def forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    cache=None,
    pos0=None,
) -> Tuple[torch.Tensor, Optional[dict], float]:
    """Returns (logits (B, L, V) fp32, new_cache, aux_loss) — materializes
    the full logits tensor; use only at decode/small shapes or in tests."""
    x, new_cache, aux = forward_hidden(
        params, cfg, tokens=tokens, embeds=embeds, cache=cache, pos0=pos0)
    return unembed(params, cfg, x), new_cache, aux


def _hybrid_forward(params, x, cfg, positions, cache):
    """zamba2: groups of ``shared_attn_every`` mamba blocks, then the
    weight-shared attention block (its own KV cache per application).
    The caches are updated in place.  Returns (x, aux)."""
    every = cfg.shared_attn_every or cfg.n_layers + 1
    n_shared = cfg.n_layers // every if cfg.shared_attn_every else 0
    s_fn = _remat(lambda p, h, c: blk.sblock_apply(p, h, cfg, c), cfg, cache)
    t_fn = _remat(lambda p, h, c: blk.tblock_apply(p, h, cfg, positions, c),
                  cfg, cache)
    blocks = _layers(params["blocks"], cfg.n_layers)
    aux = 0.0
    layer = 0
    for g in range(max(1, (cfg.n_layers + every - 1) // every)):
        hi = min(layer + every, cfg.n_layers)
        for i in range(layer, hi):
            c = (_layer_slice(cache["layers"], i)
                 if cache is not None else None)
            x, _, a = s_fn(blocks[i], x, c)
            x = constrain(x, "batch", "seq", "embed_act")
            aux = aux + a
        layer = hi
        if cfg.shared_attn_every and g < n_shared:
            c = (_layer_slice(cache["shared"], g)
                 if cache is not None else None)
            x, _, a = t_fn(params["shared_block"], x, c)
            x = constrain(x, "batch", "seq", "embed_act")
            aux = aux + a
    return x, aux


# ==========================================================================
# MTP head (deepseek multi-token prediction)
# ==========================================================================
def mtp_hidden(params, cfg: ModelConfig, hidden: torch.Tensor,
               next_tokens: torch.Tensor, positions) -> torch.Tensor:
    """Predict token t+2 from (hidden_t, embed(token_{t+1})) — one MTP depth.

    Returns the MTP head's hidden states (B, L, D); the caller unembeds
    (chunked, like the main loss).  The block's aux loss is dropped, as
    the reference drops it.
    """
    mtp = params["mtp"]
    nxt = embed_apply(params["embed"], next_tokens)
    h = torch.cat([rms_norm(hidden, mtp["ln"], cfg.norm_eps), nxt], dim=-1)
    h = h @ mtp["proj"]
    h, _, _ = blk.tblock_apply(mtp["block"], h, cfg, positions,
                               use_moe=cfg.family == "moe")
    return h


def mtp_logits(params, cfg: ModelConfig, hidden: torch.Tensor,
               next_tokens: torch.Tensor, positions) -> torch.Tensor:
    h = mtp_hidden(params, cfg, hidden, next_tokens, positions)
    return unembed(params, cfg, h)
