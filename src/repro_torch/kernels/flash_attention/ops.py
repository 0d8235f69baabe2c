"""Public attention op: dispatch on the tensors' device.

``attention()`` is what the model code calls, prefill and decode alike.  A
CUDA tensor goes to the hand-written kernel (:mod:`kernel`) and nothing
else: a failed build or launch raises, and no library attention is called.
A CPU tensor goes to the plain version (:mod:`ref`).  The layout is the
reference's: q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D).  ``kv_len`` and
``q_offset`` are host integers (decode passes the cache position, kept on
the host, so no step waits on the card to learn it).

Training: where autograd records (grad mode on and q, k or v requiring a
gradient), the call goes through :class:`AttentionFn`, whose forward is
the same kernel (or plain version) returning the log-sum-exp too, and
whose backward is the plain blocked backward (:mod:`blocked`, the
reference's) on either device.  Serving and decode never record, so they
keep the path above.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention.blocked import attention_bwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref, attention_ref,
)


def attention_lse(q, k, v, **kw):
    """(out, lse): the kernel with ``return_lse`` for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, return_lse=True, **kw)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")


class AttentionFn(torch.autograd.Function):
    """Attention with a gradient: forward :func:`attention_lse`, saving
    (q, k, v, out, lse) as the reference's VJP does; backward
    :func:`blocked.attention_bwd` (float32 math, gradients in the inputs'
    dtypes)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with record_function("craft::attention_bwd"):
            dq, dk, dv = attention_bwd(q, k, v, out, lse, g, **ctx.kw)
        return dq, dk, dv, None


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    sm_scale: Optional[float] = None, q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention (GQA-aware): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kw = dict(causal=causal, window=window, sm_scale=float(sm_scale),
              q_offset=int(q_offset),
              kv_len=None if kv_len is None else int(kv_len))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return AttentionFn.apply(q, k, v, kw)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")
