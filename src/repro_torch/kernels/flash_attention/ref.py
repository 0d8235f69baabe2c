"""Plain PyTorch attention: the twin of ``repro/kernels/flash_attention/
ref.py::attention_ref``.

Materialized-scores attention with a float32 softmax.  GQA (query head h
reads kv head ``h // group``), causal masking with a query position offset,
a sliding ``window`` (key positions in ``(q_pos - window, q_pos]``) and a
``kv_len`` bound.  Rows with no unmasked key return 0.

The scores are materialized a slab of query rows at a time, so memory
stays bounded at the serving path's full size (danube's prefill would need
17 GB of float32 scores at once); each row's arithmetic is the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

_SCORES = 1 << 27            # float32 score elements held at once (512 MiB)


def attention_ref(
    q: torch.Tensor,                   # (B, Hq, Lq, Dqk)
    k: torch.Tensor,                   # (B, Hkv, Lk, Dqk)
    v: torch.Tensor,                   # (B, Hkv, Lk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    b, hq, lq, dqk = q.shape
    _, hkv, lk, _ = k.shape
    dv = v.shape[-1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    group = hq // hkv
    if sm_scale is None:
        sm_scale = dqk ** -0.5
    kf, vf = k.float(), v.float()
    kpos = torch.arange(lk, device=q.device)[None, :]       # (1, Lk)
    out = torch.empty((b, hkv, group, lq, dv), dtype=torch.float32,
                      device=q.device)
    step = max(1, _SCORES // max(1, b * hq * lk))
    for i0 in range(0, lq, step):
        n = min(step, lq - i0)
        qg = q[:, :, i0:i0 + n].float().reshape(b, hkv, group, n, dqk)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * sm_scale
        qpos = q_offset + torch.arange(i0, i0 + n, device=q.device)[:, None]
        mask = torch.ones((n, lk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        if kv_len is not None:
            mask &= kpos < kv_len
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        p = torch.where(denom > 0,
                        p / torch.where(denom == 0, 1.0, denom), 0.0)
        out[:, :, :, i0:i0 + n] = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(b, hq, lq, dv).to(q.dtype)
