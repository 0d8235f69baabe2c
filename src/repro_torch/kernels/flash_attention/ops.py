"""Public attention op: dispatch on the tensors' device.

``attention()`` is what the model code calls, prefill and decode alike.  A
CUDA tensor goes to the hand-written kernel (:mod:`kernel`) and nothing
else: a failed build or launch raises, and no library attention is called.
A CPU tensor goes to the plain version (:mod:`ref`).  The layout is the
reference's: q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D).  ``kv_len`` and
``q_offset`` are host integers (decode passes the cache position, kept on
the host, so no step waits on the card to learn it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")
