"""Public attention op: dispatch on the tensors' device.

``attention()`` is what the model code calls, prefill and decode alike.  A
CUDA tensor goes to the hand-written kernel (:mod:`kernel`) and nothing
else: a failed build or launch raises, and no library attention is called.
A CPU tensor goes to the plain version (:mod:`ref`).  The layout is the
reference's: q (B, Hq, Lq, Dqk), k (B, Hkv, Lk, Dqk), v (B, Hkv, Lk, Dv)
(MLA gives v a head dim of its own; the output takes v's).  ``kv_len`` and
``q_offset`` are host integers (decode passes the cache position, kept on
the host, so no step waits on the card to learn it).

Meshes and tracing: a DTensor q, k, v (a mesh run: the model pins them
to (batch, heads, None, head_dim)) enter through ``local_map``, so each
rank's call computes exactly its batch rows and heads, on the card with the
hand kernel; where q's heads are split over a mesh dimension that k and v
are not, each rank reads the kv heads its q heads use, and their gradients
come back partial over it.  The forward is also the custom op
``craft::flash_attention`` (``craft::flash_attention_lse`` with the
log-sum-exp), with a fake-tensor shape function and a flop formula (2 B
Hq Lq Lk (Dqk + Dv), the reference's dot count of its blocked attention),
so a fake-tensor trace (``launch.specs``) passes through it and the
roofline (``analysis.roofline``) counts it.  Every call goes through it,
serving's and the gradient path's alike.  :func:`custom_ops` registers
them at first use.

Training: where autograd records (grad mode on and q, k or v requiring a
gradient), the call goes through :class:`AttentionFn`, whose forward is
the same kernel (or plain version) returning the log-sum-exp too, and
whose backward is the plain blocked backward (:mod:`blocked`, the
reference's) on either device.  Serving and decode never record, so they
keep the path above.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention.blocked import attention_bwd
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref, attention_ref,
)
from repro_torch.sharding.activations import is_dtensor


def attention_lse(q, k, v, **kw):
    """(out, lse): the kernel with ``return_lse`` for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, return_lse=True, **kw)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")


def _attention_out(q, k, v, **kw):
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")


# ----------------------------------------------------- custom ops (tracing)
_OPS = []
_LOCK = threading.Lock()


def custom_ops():
    """``torch.ops.craft`` with ``flash_attention`` and
    ``flash_attention_lse`` registered (once, at first use: registering
    costs a second of imports no serving process needs)."""
    if not _OPS:
        with _LOCK:     # threads (SimWorld ranks) race to the first call
            if not _OPS:
                _register()
    return _OPS[0]


def _register() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("craft::flash_attention", mutates_args=())
    def flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool,
                           window: Optional[int], sm_scale: float,
                           q_offset: int,
                           kv_len: Optional[int]) -> torch.Tensor:
        return _attention_out(q, k, v, causal=causal, window=window,
                              sm_scale=sm_scale, q_offset=q_offset,
                              kv_len=kv_len)

    @flash_attention_op.register_fake
    def _(q, k, v, causal, window, sm_scale, q_offset, kv_len):
        return q.new_empty((*q.shape[:-1], v.shape[-1]))

    @torch.library.custom_op("craft::flash_attention_lse", mutates_args=())
    def flash_attention_lse_op(
            q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], sm_scale: float, q_offset: int,
            kv_len: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        return attention_lse(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale, q_offset=q_offset,
                             kv_len=kv_len)

    @flash_attention_lse_op.register_fake
    def _(q, k, v, causal, window, sm_scale, q_offset, kv_len):
        return (q.new_empty((*q.shape[:-1], v.shape[-1])),
                q.new_empty(q.shape[:-1], dtype=torch.float32))

    register_flop_formula([torch.ops.craft.flash_attention,
                           torch.ops.craft.flash_attention_lse])(
        _attention_flops)
    _OPS.append(torch.ops.craft)


def _attention_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """2 B Hq Lq Lk (Dqk + Dv): the two products over every key, as the
    reference's dot count of its blocked attention gives it."""
    b, hq, lq, dqk = q_shape
    return 2 * b * hq * lq * k_shape[2] * (dqk + v_shape[-1])


def _op_kw(kw) -> tuple:
    return (kw["causal"], kw["window"], kw["sm_scale"], kw["q_offset"],
            kw["kv_len"])


# ----------------------------------------------------------------- meshes
def _mesh_attention(q, k, v, kw):
    """Attention on DTensors: each rank's local call on its own rows and
    heads (``local_map``); the plain or gradient path inside."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    # attention is not linear in q, k or v: a partial sum (MLA's K and V
    # come from a product split over its latent dim) is reduced first
    q, k, v = (t.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                     for pl in t.placements])
               if any(pl.is_partial() for pl in t.placements) else t
               for t in (q, k, v))
    qp, kp, vp = tuple(q.placements), tuple(k.placements), \
        tuple(v.placements)
    for pl in qp + kp + vp:
        if isinstance(pl, Shard) and pl.dim not in (0, 1):
            raise ValueError(f"attention on a mesh: q, k, v split on dim "
                             f"{pl.dim}; pin them to (batch, heads, None, "
                             "head_dim) first")
    # mesh dims that split q's heads but not k's: k and v are whole there
    narrow = [isinstance(a, Shard) and a.dim == 1
              and not (isinstance(b, Shard) and b.dim == 1)
              for a, b in zip(qp, kp)]
    grad_kv = tuple(Partial() if n else pl for n, pl in zip(narrow, kp))
    group = q.shape[1] // k.shape[1]
    if any(narrow):
        _, offset = compute_local_shape_and_global_offset(
            q.shape, mesh, qp)
        h0 = offset[1]

    def local(ql, kl, vl):
        if any(narrow):
            lo, hi = h0 // group, (h0 + ql.shape[1] - 1) // group + 1
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return _local_attention(ql, kl, vl, kw)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kp, vp),
                     in_grad_placements=(qp, grad_kv, grad_kv),
                     device_mesh=mesh)(q, k, v)


class AttentionFn(torch.autograd.Function):
    """Attention with a gradient: forward :func:`attention_lse`, saving
    (q, k, v, out, lse) as the reference's VJP does; backward
    :func:`blocked.attention_bwd` (float32 math, gradients in the inputs'
    dtypes)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = custom_ops().flash_attention_lse(q, k, v, *_op_kw(kw))
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
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if is_dtensor(q):
        return _mesh_attention(q, k, v, kw)
    return _local_attention(q, k, v, kw)


def _local_attention(q, k, v, kw):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return AttentionFn.apply(q, k, v, kw)
    return custom_ops().flash_attention(q, k, v, *_op_kw(kw))
