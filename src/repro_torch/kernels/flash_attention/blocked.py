"""Blocked attention backward in plain PyTorch: the port of the reference's
``repro/kernels/flash_attention/blocked.py::_bwd_inner``.

No TPU kernel of the reference has a backward: under differentiation it
takes its jnp blocked forward for the ``lse`` residual and this jnp
backward.  The port's forward is the hand kernel on the card (which
writes ``lse``, ``kernel.flash_attention_cuda(return_lse=True)``) or the
plain version on the CPU; the backward is this function on either device.

From the residuals (q, k, v, out, lse) and the output gradient g, in
float32: ``delta = sum(g * out)`` per row, then over key blocks of
``min(block, Lk)``: ``p = exp(s - lse)`` under the forward's masks, ``dv +=
p^T g``, ``dp = g v^T``, ``ds = p (dp - delta) * scale``, ``dq += ds k``, ``dk
+= ds^T q``; GQA sums each kv head's gradients over its group of q heads.
A row that sees no key has ``p = 0`` everywhere, so it adds nothing.  Key
blocks that no row may see (causal, window, ``kv_len``) are skipped: their
``p`` is 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mask(qpos, kpos, causal: bool, window: Optional[int], kv_len: int):
    m = kpos < kv_len
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                  window: Optional[int] = None,
                  sm_scale: Optional[float] = None, q_offset: int = 0,
                  kv_len: Optional[int] = None, block: int = 1024):
    """(dq, dk, dv) in the dtypes of q, k, v.  q (B, Hq, Lq, D), k/v
    (B, Hkv, Lk, D), out and g (B, Hq, Lq, D), lse (B, Hq, Lq) float32."""
    b, hq, lq, dk_ = q.shape
    _, hkv, lk, dv_ = v.shape
    group = hq // hkv
    if sm_scale is None:
        sm_scale = dk_ ** -0.5
    dev = q.device
    qf = q.float().reshape(b, hkv, group, lq, dk_)
    gf = g.float().reshape(b, hkv, group, lq, dv_)
    lsef = lse.float().reshape(b, hkv, group, lq, 1)
    delta = (gf * out.float().reshape(b, hkv, group, lq, dv_)).sum(
        dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hkv, lk, dk_), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hkv, lk, dv_), dtype=torch.float32, device=dev)
    kv_lim = lk if kv_len is None else min(lk, int(kv_len))
    qpos = q_offset + torch.arange(lq, device=dev)[:, None]
    blk = max(1, min(block, lk))
    for k0 in range(0, lk, blk):
        n = min(blk, lk - k0)
        if (k0 >= kv_lim or (causal and k0 > q_offset + lq - 1)
                or (window is not None
                    and k0 + n - 1 <= q_offset - window)):
            continue                        # no row sees these keys
        kb = k[:, :, k0:k0 + n].float()
        vb = v[:, :, k0:k0 + n].float()
        kpos = torch.arange(k0, k0 + n, device=dev)[None, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb).mul_(sm_scale)
        p = s.sub_(lsef).exp_()
        p = p.masked_fill_(~_mask(qpos, kpos, causal, window, kv_lim), 0.0)
        dv[:, :, k0:k0 + n] = torch.einsum("bhgqk,bhgqd->bhkd", p, gf)
        ds = torch.einsum("bhgqd,bhkd->bhgqk", gf, vb)
        ds = ds.sub_(delta).mul_(p).mul_(sm_scale)
        del p
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
        dk[:, :, k0:k0 + n] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        del ds
    return (dq.reshape(b, hq, lq, dk_).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
