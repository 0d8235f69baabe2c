"""Selective-scan backward in plain PyTorch, one chunk per batch slot.

No TPU kernel of the reference has a backward: the reference model
differentiates its jnp chunked scan (``repro/models/ssm.py::
_fused_ssd_scan``) by autodiff, with ``jax.checkpoint`` on each chunk, so
the backward recomputes a chunk from its incoming state and its four
inputs.  Here the forward (the hand kernel on the card, the plain chunked
scan on the CPU) leaves each chunk's incoming state h_in[c], so every
chunk is recomputed at once, side by side on a chunk axis:

1. The gradient reaching each chunk's end state comes first, by a reverse
   carry over the chunks (the scan is linear in h_in):
   ``dh_out[c-1] = G_c + D_c * dh_out[c]``, where ``G_c`` is what the
   chunk's own outputs give its incoming state (``sum_t exp(A * sum_{k<=t}
   dt_k) C_t dy_t``) and ``D_c = exp(A * sum_c dt)`` its total decay;
   ``dh_out`` of the last chunk is the gradient of h_last, and the same step
   once more gives dh0.
2. Then each chunk's gradients from its outputs' and its end state's:
   - mamba2 (``dtx`` 4-D, a scalar decay a head) in the matrix form of the
     chunk (the SSD product): ``y = (L * C B^T) X + exp(cum) C h_in`` with
     ``L[t, j] = exp(sum_{k=j+1..t} dt_k A)``, the sums taken by a masked
     cumulative sum (no difference of prefix sums), differentiated by
     ``torch.autograd.grad``;
   - mamba1 (``dtx`` 3-D, a decay a (channel, state)) by the recurrence's
     adjoint: the states replayed forward over the chunk's steps, the
     adjoint ``lam_t = C_t dy_t + a_{t+1} lam_{t+1}`` backward from 0, the
     end-state gradient added as ``exp(A * sum_{k>t} dt_k) dh_out`` (suffix
     sums from the chunk's end), then the products of states, adjoints
     and inputs summed for each input.

The ragged tail is padded with dt = 0 and dtx = 0 steps, which leave the
state as it is.  Gradients come back in the inputs' dtypes.
"""
from __future__ import annotations

import torch


def _chunks(x: torch.Tensor, q: int) -> torch.Tensor:
    """(B, L, ...) float32 → (B, nc, q, ...), the tail padded with 0."""
    b, l = x.shape[:2]
    nc = -(-l // q)
    x = x.float()
    pad = nc * q - l
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad) + x.shape[2:])], dim=1)
    return x.reshape((b, nc, q) + x.shape[2:])


def _unchunk(x: torch.Tensor, l: int) -> torch.Tensor:
    return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :l]


def _carry_back(g_loc, decay, dh_last):
    """Step 1: dh_out of every chunk and dh0, from each chunk's local
    incoming-state gradient ``g_loc`` (B, nc, *state) and total decay
    ``decay`` (broadcasting against it)."""
    nc = g_loc.shape[1]
    dh_out = torch.empty_like(g_loc)
    dh = dh_last.float()
    for c in range(nc - 1, -1, -1):
        dh_out[:, c] = dh
        dh = g_loc[:, c] + decay[:, c] * dh
    return dh_out, dh


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) → (..., q, q): ``sum_{k=j+1..t} a_k`` at [t, j] for j <= t,
    -inf above the diagonal; a masked cumulative sum (stable)."""
    q = a.shape[-1]
    x = a[..., :, None].expand(*a.shape[:-1], q, q)      # x[t, j] = a_t
    low = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device), -1)
    seg = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    diag = torch.tril(torch.ones(q, q, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~diag, float("-inf"))


def _ssd_chunks(x, bm, cm, dtc, A, h_in):
    """mamba2, every chunk at once: x (B, nc, q, nh, hd), bm/cm (B, nc, q,
    nh, st), dtc (B, nc, q, nh), A (nh,), h_in (B, nc, nh, hd, st) →
    (y (B, nc, q, nh, hd), h_out (B, nc, nh, hd, st))."""
    a = (dtc * A).permute(0, 1, 3, 2)                  # (B, nc, nh, q)
    lmat = torch.exp(_segsum(a))                       # (B, nc, nh, q, q)
    cb = torch.einsum("bcqhs,bckhs->bchqk", cm, bm)
    y = torch.einsum("bchqk,bckhd->bcqhd", lmat * cb, x)
    cum = torch.cumsum(a, dim=-1)                      # (B, nc, nh, q)
    y = y + torch.einsum("bcqhs,bchds->bcqhd", cm, h_in) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    w = lmat[..., -1, :]                               # to the chunk's end
    h_out = torch.exp(cum[..., -1])[..., None, None] * h_in \
        + torch.einsum("bchq,bcqhd,bcqhs->bchds", w, x, bm)
    return y, h_out


def _ssd_bwd(x, bm, cm, dtc, A, h_in, dyc, dh_last):
    cum = torch.cumsum(dtc * A, dim=2)                 # (B, nc, q, nh)
    g_loc = torch.einsum("bcqh,bcqhd,bcqhs->bchds", torch.exp(cum), dyc, cm)
    decay = torch.exp(cum[:, :, -1])[..., None, None]
    dh_out, dh0 = _carry_back(g_loc, decay, dh_last)
    del g_loc
    leaves = [t.detach().requires_grad_() for t in (x, bm, cm, dtc, A)]
    with torch.enable_grad():
        y, h_out = _ssd_chunks(*leaves, h_in)
        grads = torch.autograd.grad((y, h_out), leaves, (dyc, dh_out))
    return (*grads, dh0)


def _s6_bwd(x, bm, cm, dtc, A, h_in, dyc, dh_last):
    q = x.shape[2]
    decays = torch.exp(dtc[..., None] * A)             # (B, nc, q, di, st)
    # the states, replayed forward over the chunk's steps
    hs = torch.empty_like(decays)
    h = h_in
    for t in range(q):
        h = torch.addcmul(x[:, :, t, :, None] * bm[:, :, t, None, :],
                          decays[:, :, t], h, out=hs[:, :, t])
    # the adjoint from the outputs alone (0 past the chunk's end)
    lam = torch.empty_like(decays)
    cur = None
    for t in range(q - 1, -1, -1):
        inj = dyc[:, :, t, :, None] * cm[:, :, t, None, :]
        cur = (inj if cur is None
               else torch.addcmul(inj, decays[:, :, t + 1], cur))
        lam[:, :, t] = cur
    g_loc = decays[:, :, 0] * lam[:, :, 0]
    decay = torch.exp(dtc.sum(dim=2)[..., None] * A)   # (B, nc, di, st)
    dh_out, dh0 = _carry_back(g_loc, decay, dh_last)
    del g_loc, decay
    # the end state's gradient reaches step t through the later decays
    sfx = torch.flip(torch.cumsum(torch.flip(dtc, [2]), dim=2), [2])
    sfx = torch.cat([sfx[:, :, 1:], torch.zeros_like(sfx[:, :, :1])], dim=2)
    lam.addcmul_(torch.exp(sfx[..., None] * A), dh_out[:, :, None])
    del sfx
    d_c = torch.einsum("bcqd,bcqds->bcqs", dyc, hs)
    d_x = torch.einsum("bcqds,bcqs->bcqd", lam, bm)
    d_b = torch.einsum("bcqds,bcqd->bcqs", lam, x)
    # d(decay_t) = lam_t * h_{t-1}; d(dt_t A) = that * decay_t
    lam.mul_(decays)
    lam[:, :, 1:].mul_(hs[:, :, :-1])
    lam[:, :, 0].mul_(h_in)
    del hs, decays
    d_dt = torch.einsum("bcqds,ds->bcqd", lam, A)
    d_a = torch.einsum("bcqds,bcqd->ds", lam, dtc)
    return d_x, d_b, d_c, d_dt, d_a, dh0


def scan_bwd(dtx, bh, ch, dt, A, h0, states, chunk: int, dy, dh_last):
    """Gradients (d_dtx, d_bh, d_ch, d_dt, d_A, d_h0) of the selective
    scan, either variant by the rank of ``dtx`` (shapes as
    ``ref.chunked_scan_ref``), from the output gradients ``dy`` (B, L,
    *head) and ``dh_last``.  ``states``: each chunk's incoming state for
    chunks of ``chunk`` steps, float32 (B, nc, *state), as the forward
    left it (the kernel's chunked route, or the plain chunked scan)."""
    l = dtx.shape[1]
    q = max(1, min(int(chunk), l))
    x, bm, cm, dtc, dyc = (_chunks(t, q) for t in (dtx, bh, ch, dt, dy))
    fn = _ssd_bwd if dtx.dim() == 4 else _s6_bwd
    d_x, d_b, d_c, d_dt, d_a, dh0 = fn(x, bm, cm, dtc, A.float(),
                                       states.float(), dyc, dh_last)
    return (_unchunk(d_x, l).to(dtx.dtype), _unchunk(d_b, l).to(bh.dtype),
            _unchunk(d_c, l).to(ch.dtype), _unchunk(d_dt, l).to(dt.dtype),
            d_a.to(A.dtype), dh0.to(h0.dtype))
