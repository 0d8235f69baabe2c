"""Plain PyTorch attention: the twin of ``repro/kernels/flash_attention/
ref.py::attention_ref``.

Materialized-scores attention with a float32 softmax.  GQA (query head h
reads kv head ``h // group``), causal masking with a query position offset,
a sliding ``window`` (key positions in ``(q_pos - window, q_pos]``) and a
``kv_len`` bound.  Rows with no unmasked key return 0.

The scores are materialized a slab of query rows at a time, so memory
stays bounded at the serving path's full size (danube's prefill would need
17 GB of float32 scores at once); each row's arithmetic is the reference's.

:func:`attention_lse_ref` also returns each row's log-sum-exp of its
scaled scores, the residual of the training backward: ``m + log(sum exp(s
- m))``, and -1e30 for a row that sees no key (:data:`EMPTY_LSE`, the
reference's blocked forward, ``repro/kernels/flash_attention/blocked.py``).

:func:`attention_split_ref` is the split-KV decode route's arithmetic
written plainly: per split of the keys, the partials (o, m, l) in base 2,
then their combination.
"""
from __future__ import annotations

from typing import Optional

import torch

_SCORES = 1 << 27            # float32 score elements held at once (512 MiB)
_LOG2E = 1.4426950408889634
EMPTY_LSE = -1e30            # lse of a row with no visible key


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
    return _attention(q, k, v, causal, window, sm_scale, q_offset, kv_len,
                      False)[0]


def attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    sm_scale: Optional[float] = None, q_offset: int = 0,
    kv_len: Optional[int] = None,
):
    """(out in q's dtype, lse float32 (B, Hq, Lq)) of :func:`attention_ref`."""
    return _attention(q, k, v, causal, window, sm_scale, q_offset, kv_len,
                      True)


def _attention(q, k, v, causal, window, sm_scale, q_offset, kv_len,
               with_lse: bool):
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
    lse = (torch.empty((b, hkv, group, lq), dtype=torch.float32,
                       device=q.device) if with_lse else None)
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
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        if with_lse:
            lse[:, :, :, i0:i0 + n] = torch.where(
                denom > 0, m + torch.log(torch.where(denom > 0, denom, 1.0)),
                EMPTY_LSE)[..., 0]
        p = torch.where(denom > 0,
                        p / torch.where(denom == 0, 1.0, denom), 0.0)
        out[:, :, :, i0:i0 + n] = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    out = out.reshape(b, hq, lq, dv).to(q.dtype)
    return out, (lse.reshape(b, hq, lq) if with_lse else None)


def attention_split_ref(
    q: torch.Tensor,                   # (B, Hq, Lq, D)
    k: torch.Tensor,                   # (B, Hkv, Lk, D)
    v: torch.Tensor,                   # (B, Hkv, Lk, D)
    *,
    k_begin: int,
    k_end: int,
    split_len: int,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention as the split-KV decode computes it, in float32.  The keys
    ``[k_begin, k_end)`` (every key a row may see) are cut into splits of
    ``split_len``.  Split s gives, per row, base-2 scores ``x = q.k *
    scale * log2 e`` (masked: -inf), ``m_s = max x``, ``l_s = sum 2^(x -
    m_s)`` and ``o_s = sum 2^(x - m_s) v`` (``m_s`` read as 0 where it is
    -inf, so a split with no visible key gives l = o = 0).  The combine:
    ``M = max m_s``, ``w_s = 2^(m_s - M)``, ``out = sum w_s o_s / sum w_s
    l_s``, and 0 where no split saw a key."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    k_lim = lk if kv_len is None else min(lk, kv_len)
    qf = q.float().reshape(b, hkv, group, lq, d)
    qpos = q_offset + torch.arange(lq, device=q.device)[:, None]
    ms, ls, os_ = [], [], []
    for s0 in range(k_begin, k_end, split_len):
        kpos = torch.arange(s0, min(s0 + split_len, k_end),
                            device=q.device)[None, :]
        kf = k[:, :, kpos[0]].float()
        vf = v[:, :, kpos[0]].float()
        x = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * (sm_scale * _LOG2E)
        mask = kpos < k_lim
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        x = x.masked_fill(~mask, float("-inf"))
        m = x.amax(dim=-1)
        p = torch.exp2(x - torch.where(m == float("-inf"), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vf))
    if not ms:
        return torch.zeros_like(q)
    m = torch.stack(ms)
    m_max = m.amax(dim=0)
    w = torch.exp2(m - torch.where(m_max == float("-inf"), 0.0, m_max))
    den = (w * torch.stack(ls)).sum(dim=0)[..., None]
    num = (w[..., None] * torch.stack(os_)).sum(dim=0)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(b, hq, lq, d).to(q.dtype)
