"""Plain PyTorch selective scans: the twins of ``repro/kernels/ssm_scan/
ref.py`` (naive, L-length state tensors) and of the chunked scan the
reference model runs, ``repro/models/ssm.py::_fused_ssd_scan``.

    h_t = exp(dt_t * A) * h_{t-1} + dtx_t (x) B_t,   y_t = <h_t, C_t>_state

The associative scan of the reference (``jax.lax.associative_scan`` over
the pairs (a, b) with ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``) is a
Hillis-Steele scan here: log2(L) doubling steps.  The float sums run in
another order than JAX's, hence the tolerances of the tests.
"""
from __future__ import annotations

import torch


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the linear recurrence pairs along axis 1.  ``a``
    may broadcast against ``b`` (size-1 trailing axes); returns (prod,
    acc) with ``h_t = prod_t * h_0 + acc_t``."""
    n = b.shape[1]
    shift = 1
    while shift < n:
        a_hi, b_hi = a[:, shift:], b[:, shift:]
        a_lo, b_lo = a[:, :n - shift], b[:, :n - shift]
        b = torch.cat([b[:, :shift], a_hi * b_lo + b_hi], dim=1)
        a = torch.cat([a[:, :shift], a_hi * a_lo], dim=1)
        shift *= 2
    return a, b


def _terms(dtx, bh, dt, A):
    """Decay and injection of every step: mamba2 when dtx is 4-D (decay
    (B, L, nh, 1, 1), a scalar per head), mamba1 when 3-D (decay
    (B, L, di, st))."""
    dtf = dt.float()
    if dtx.dim() == 4:
        decay = torch.exp(dtf * A[None, None])[..., None, None]
        inject = dtx.float()[..., None] * bh.float()[:, :, :, None, :]
    else:
        decay = torch.exp(dtf[..., None] * A[None, None])
        inject = dtx.float()[..., None] * bh.float()[:, :, None, :]
    return decay, inject


def _readout(h_all, ch):
    if h_all.dim() == 5:
        return torch.einsum("blhds,blhs->blhd", h_all, ch.float())
    return torch.einsum("blds,bls->bld", h_all, ch.float())


def _naive(dtx, bh, ch, dt, A, h0):
    decay, inject = _terms(dtx, bh, dt, A.float())
    prod, acc = _assoc_scan(decay, inject)
    h_all = prod * h0.float()[:, None] + acc
    return _readout(h_all, ch).to(dtx.dtype), h_all[:, -1]


def ssd_scan_ref(dtx, bh, ch, dt, A, h0):
    """mamba2.  dtx (B,L,nh,hd); bh/ch (B,L,nh,st); dt (B,L,nh); A (nh,);
    h0 (B,nh,hd,st).  Returns (y in dtx's dtype, h_last float32)."""
    return _naive(dtx, bh, ch, dt, A, h0)


def s6_scan_ref(dtx, bh, ch, dt, A, h0):
    """mamba1.  dtx/dt (B,L,di); bh/ch (B,L,st); A (di,st); h0 (B,di,st).
    Returns (y in dtx's dtype, h_last float32)."""
    return _naive(dtx, bh, ch, dt, A, h0)


def chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk: int = 256):
    """The reference model's chunked scan (``_fused_ssd_scan``), either
    variant by the rank of ``dtx``: an associative scan inside chunks of
    ``chunk`` steps, the state carried from chunk to chunk, so nothing
    L-by-state is ever held (memory stays bounded at full size).

    Returns (y (B, L, *head) float32 as the reference's, h_last).
    """
    l = dtx.shape[1]
    chunk = max(1, min(chunk, l))
    A = A.float()
    h = h0.float()
    ys = []
    for t0 in range(0, l, chunk):
        sl = slice(t0, t0 + chunk)
        decay, inject = _terms(dtx[:, sl], bh[:, sl], dt[:, sl], A)
        prod, acc = _assoc_scan(decay, inject)
        h_all = prod * h[:, None] + acc
        ys.append(_readout(h_all, ch[:, sl]))
        h = h_all[:, -1]
        del decay, inject, prod, acc, h_all
    y = torch.cat(ys, dim=1) if ys else torch.empty(
        dtx.shape, dtype=torch.float32, device=dtx.device)
    return y, h
