"""Hand-written CUDA selective-scan kernels (``csrc/ssm_scan.cu``) and
their wrappers.

Replace the Pallas TPU kernels ``repro/kernels/ssm_scan/kernel.py::
ssd_scan`` (mamba2: scalar decay per head, state (hd, st) per batch row and
head) and ``::s6_scan`` (mamba1: per-channel decay ``exp(dt ⊗ A)``, state
(st,) per channel).  The time loop runs inside a block with the state in
registers; L is a run-time argument (decode is L = 1) and nothing is
padded.  See the source for the design.

``ssd_scan_cuda.launches`` and ``s6_scan_cuda.launches`` count the kernel
launches of this process.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ST_MAX = 128


def _check(what: str, dtx, bh, ch, dt, A, h0) -> None:
    for name, t in (("dtx", dtx), ("bh", bh), ("ch", ch), ("dt", dt),
                    ("A", A), ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: CUDA tensor expected for {name}, got "
                             f"{t.device}")
        if t.device != dtx.device:
            raise ValueError(f"{what}: {name} on {t.device}, dtx on "
                             f"{dtx.device}")
    if dtx.dtype not in _DTYPES or bh.dtype != dtx.dtype \
            or ch.dtype != dtx.dtype:
        raise TypeError(f"{what}: dtx, bh, ch must share a dtype in "
                        f"{list(_DTYPES)}; got {dtx.dtype}, {bh.dtype}, "
                        f"{ch.dtype}")
    st = bh.shape[-1]
    if not 0 < st <= ST_MAX:
        raise ValueError(f"{what}: state size {st} not in 1..{ST_MAX}")


def _last_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def ssd_scan_cuda(dtx, bh, ch, dt, A, h0) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """mamba2 scan of CUDA tensors.  dtx (B, L, nh, hd); bh/ch
    (B, L, nh, st) (stride-0 head axes accepted, as a broadcast of grouped
    B/C); dt (B, L, nh); A (nh,); h0 (B, nh, hd, st).  dtx, bh, ch float32
    or bfloat16 (one type); dt, A, h0 are taken as float32.  Returns (y
    (B, L, nh, hd) in dtx's dtype, h_last (B, nh, hd, st) float32)."""
    _check("ssd_scan_cuda", dtx, bh, ch, dt, A, h0)
    b, l, nh, hd = dtx.shape
    st = bh.shape[-1]
    if (bh.shape != (b, l, nh, st) or ch.shape != bh.shape
            or dt.shape != (b, l, nh) or A.shape != (nh,)
            or h0.shape != (b, nh, hd, st)):
        raise ValueError(
            f"ssd_scan_cuda: shapes dtx {tuple(dtx.shape)}, bh "
            f"{tuple(bh.shape)}, ch {tuple(ch.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, h0 {tuple(h0.shape)} do not agree")
    dtx, bh, ch = (_last_contiguous(t) for t in (dtx, bh, ch))
    dt = dt.to(torch.float32)
    A, h0 = _f32(A), _f32(h0)
    y = torch.empty((b, l, nh, hd), dtype=dtx.dtype, device=dtx.device)
    if l == 0:
        return y, h0.clone()
    h_last = torch.empty((b, nh, hd, st), dtype=torch.float32,
                         device=dtx.device)
    lib = _build.load("ssm_scan")
    with torch.cuda.device(dtx.device):
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        rc = lib.craft_ssd_scan(
            dtx.data_ptr(), bh.data_ptr(), ch.data_ptr(), dt.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            b, l, nh, hd, st, dtx.stride(0), dtx.stride(1), dtx.stride(2),
            bh.stride(0), bh.stride(1), bh.stride(2), ch.stride(0),
            ch.stride(1), ch.stride(2), dt.stride(0), dt.stride(1),
            dt.stride(2), _DTYPES[dtx.dtype], stream)
    _build.check(rc, "ssd_scan_cuda")
    _build.count_launch(ssd_scan_cuda)
    return y, h_last


ssd_scan_cuda.launches = 0


def s6_scan_cuda(dtx, bh, ch, dt, A, h0) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """mamba1 scan of CUDA tensors.  dtx/dt (B, L, di); bh/ch (B, L, st);
    A (di, st); h0 (B, di, st).  dtx, bh, ch float32 or bfloat16 (one
    type); dt, A, h0 are taken as float32.  Returns (y (B, L, di) in dtx's
    dtype, h_last (B, di, st) float32)."""
    _check("s6_scan_cuda", dtx, bh, ch, dt, A, h0)
    b, l, di = dtx.shape
    st = bh.shape[-1]
    if (bh.shape != (b, l, st) or ch.shape != bh.shape
            or dt.shape != (b, l, di) or A.shape != (di, st)
            or h0.shape != (b, di, st)):
        raise ValueError(
            f"s6_scan_cuda: shapes dtx {tuple(dtx.shape)}, bh "
            f"{tuple(bh.shape)}, ch {tuple(ch.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, h0 {tuple(h0.shape)} do not agree")
    dtx, bh, ch = (_last_contiguous(t) for t in (dtx, bh, ch))
    dt = _last_contiguous(dt.to(torch.float32))
    A, h0 = _f32(A), _f32(h0)
    y = torch.empty((b, l, di), dtype=dtx.dtype, device=dtx.device)
    if l == 0:
        return y, h0.clone()
    h_last = torch.empty((b, di, st), dtype=torch.float32, device=dtx.device)
    lib = _build.load("ssm_scan")
    with torch.cuda.device(dtx.device):
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        rc = lib.craft_s6_scan(
            dtx.data_ptr(), bh.data_ptr(), ch.data_ptr(), dt.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            b, l, di, st, dtx.stride(0), dtx.stride(1), bh.stride(0),
            bh.stride(1), ch.stride(0), ch.stride(1), dt.stride(0),
            dt.stride(1), _DTYPES[dtx.dtype], stream)
    _build.check(rc, "s6_scan_cuda")
    _build.count_launch(s6_scan_cuda)
    return y, h_last


s6_scan_cuda.launches = 0
