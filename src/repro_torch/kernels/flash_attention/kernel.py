"""Hand-written CUDA attention kernel (``csrc/flash_attention.cu``) and its
wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``: blocked attention forward with an online softmax and
float32 accumulation, GQA, causal / sliding-window / ``q_offset`` /
``kv_len`` masks, fully masked rows giving 0.  Every argument is a run-time
value (one build serves prefill and decode); the ragged edge is masked in
the kernel, so nothing is padded.  See the source for the design.

``flash_attention_cuda.launches`` counts the kernel launches of this
process.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous last axis (a copy only where it is not)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    sm_scale: Optional[float] = None, q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention of CUDA tensors q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D), all
    float32 or all bfloat16, D <= 128; returns (B, Hq, Lq, D) in q's dtype.
    Any strides of the batch, head and row axes are taken as they are.
    Raises for tensors that are not on a CUDA device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: CUDA tensor expected "
                             f"for {name}, got {t.device}")
        if t.dim() != 4:
            raise TypeError(f"flash_attention_cuda: {name} must be 4-D, got "
                            f"{tuple(t.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q, k, v must share a dtype "
                        f"in {list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d
            or v.shape[3] != d):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if not 0 < d <= D_MAX:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"1..{D_MAX}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    kv_len = lk if kv_len is None else int(kv_len)
    if kv_len < 0 or (window is not None and int(window) <= 0):
        raise ValueError(f"flash_attention_cuda: kv_len {kv_len} must be "
                         f">= 0 and window {window} None or > 0")
    window = 0 if window is None else int(window)      # 0: no window
    q, k, v = _rows_view(q), _rows_view(k), _rows_view(v)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.craft_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, lq, lk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(sm_scale), int(bool(causal)), window,
            int(q_offset), kv_len, _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention_cuda")
    _build.count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
