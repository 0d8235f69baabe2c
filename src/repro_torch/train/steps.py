"""Serving step functions: the reference's ``repro/train/steps.py:234-260``.

The train step (with ``optim/adamw.py``) comes with the training slice of
the port.  PyTorch runs eagerly, so these are plain closures (the
reference jits them).  They run under ``torch.no_grad``, not inference
mode: a checkpoint restore writes into the cache outside them.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig


def make_prefill(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """prefill(params, tokens, [embeds]) -> (cache, last_logits).

    Only the final position is unembedded — the (B, L, V) prompt logits
    tensor is never materialized.
    """

    @torch.no_grad()
    def prefill(params, tokens, embeds=None):
        cache = M.init_cache(cfg, batch, max_len, device=device)
        hidden, cache, _ = M.forward_hidden(
            params, cfg, tokens=tokens, embeds=embeds, cache=cache, pos0=0)
        logits = M.unembed(params, cfg, hidden[:, -1:])
        return cache, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B,1), pos int) -> (cache, logits).
    The cache is updated in place (the reference donates it)."""

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        logits, cache, _ = M.forward(
            params, cfg, tokens=tokens, cache=cache, pos0=int(pos))
        return cache, logits[:, -1]

    return decode
