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


def chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk: int = 256,
                     return_states: bool = False):
    """The reference model's chunked scan (``_fused_ssd_scan``), either
    variant by the rank of ``dtx``: an associative scan inside chunks of
    ``chunk`` steps, the state carried from chunk to chunk, so nothing
    L-by-state is ever held (memory stays bounded at full size).

    Returns (y (B, L, *head) float32 as the reference's, h_last), and with
    ``return_states`` also each chunk's incoming state, float32 (B, nc,
    *state) for chunks of ``min(chunk, L)`` steps (the training backward's
    residual).
    """
    l = dtx.shape[1]
    chunk = max(1, min(chunk, l))
    A = A.float()
    h = h0.float()
    ys, h_in = [], []
    for t0 in range(0, l, chunk):
        sl = slice(t0, t0 + chunk)
        if return_states:
            h_in.append(h)
        decay, inject = _terms(dtx[:, sl], bh[:, sl], dt[:, sl], A)
        prod, acc = _assoc_scan(decay, inject)
        h_all = prod * h[:, None] + acc
        ys.append(_readout(h_all, ch[:, sl]))
        h = h_all[:, -1]
        del decay, inject, prod, acc, h_all
    y = torch.cat(ys, dim=1) if ys else torch.empty(
        dtx.shape, dtype=torch.float32, device=dtx.device)
    if return_states:
        states = (torch.stack(h_in, dim=1) if h_in else h.new_empty(
            (h.shape[0], 0) + h.shape[1:]))
        return y, h, states
    return y, h


def chunk_passes_ref(dtx, bh, ch, dt, A, h0, chunk: int,
                     return_states: bool = False):
    """The chunked route's three passes (``csrc/ssm_scan.cu``), either
    variant by the rank of ``dtx``, with chunks of ``chunk`` steps (one
    chunk of L where ``chunk`` >= L; the ragged tail is padded with dt = 0
    and dtx = 0 steps, which leave the state as it is):

    1. each chunk's end state from 0, ``S_c = sum_j exp(A * sum_{k>j}
       dt_k) * dtx_j (x) B_j``, and its sum of dt;
    2. the carry, sequential over the chunks: ``h_in[c] = h``, ``h =
       exp(A * sum_c dt) * h + S_c``; the last ``h`` is h_last;
    3. each chunk's outputs: the recurrence replayed over its steps from
       ``h_in[c]``.

    Returns (y in dtx's dtype, h_last float32), and with ``return_states``
    the carry's ``h_in`` of every chunk, float32 (B, nc, *state): what the
    chunked route leaves in its scratch."""
    mamba2 = dtx.dim() == 4
    b, l = dtx.shape[:2]
    q = max(1, min(int(chunk), l))
    nc = -(-l // q)

    def chunks(x):
        x = x.float()
        pad = nc * q - l
        if pad:
            x = torch.cat([x, x.new_zeros((b, pad) + x.shape[2:])], dim=1)
        return x.reshape((b, nc, q) + x.shape[2:])

    x, bc, cc, dtc = (chunks(t) for t in (dtx, bh, ch, dt))
    A = A.float()
    # 1. chunk states: weights exp(A * (sum of dt after step j)), the sums
    # taken from the chunk's end (a difference of prefix sums would cancel)
    dsum = dtc.sum(dim=2)                                  # (b, nc, G)
    sfx = torch.flip(torch.cumsum(torch.flip(dtc, [2]), dim=2), [2])
    sfx = torch.cat([sfx[:, :, 1:], torch.zeros_like(sfx[:, :, :1])], dim=2)
    if mamba2:
        w = torch.exp(sfx * A)                             # (b, nc, q, nh)
        states = torch.einsum("bcqh,bcqhd,bcqhs->bchds", w, x, bc)
    else:
        w = torch.exp(sfx[..., None] * A)                  # (b, nc, q, di, st)
        states = torch.einsum("bcqds,bcqd,bcqs->bcds", w, x, bc)
    # 2. carry over the chunks
    h, h_in = h0.float(), []
    for c in range(nc):
        h_in.append(h)
        decay = (torch.exp(dsum[:, c] * A)[..., None, None] if mamba2
                 else torch.exp(dsum[:, c, :, None] * A))
        h = decay * h + states[:, c]
    # 3. outputs: every chunk replayed from its incoming state at once
    hc, ys = torch.stack(h_in, dim=1), []
    for t in range(q):
        if mamba2:
            decay = torch.exp(dtc[:, :, t] * A)[..., None, None]
            hc = decay * hc + x[:, :, t, ..., None] * bc[:, :, t, :, None, :]
            ys.append(torch.einsum("bchds,bchs->bchd", hc, cc[:, :, t]))
        else:
            decay = torch.exp(dtc[:, :, t, :, None] * A)
            hc = decay * hc + x[:, :, t, :, None] * bc[:, :, t, None, :]
            ys.append(torch.einsum("bcds,bcs->bcd", hc, cc[:, :, t]))
    y = torch.stack(ys, dim=2).reshape((b, nc * q) + dtx.shape[2:])
    if return_states:
        return y[:, :l].to(dtx.dtype), h, torch.stack(h_in, dim=1)
    return y[:, :l].to(dtx.dtype), h
