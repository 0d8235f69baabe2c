"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

The reference's ``repro/models/ssm.py:157-363`` on tensors.  Both scan
call sites go through :func:`repro_torch.kernels.ssm_scan.ops.
selective_scan`: the hand-written CUDA scans on the card (a chunked scan
for a long prefill, one sequential pass with the state in registers for
decode and short L), the plain chunked scan of the reference model
(``_fused_ssd_scan``, ``cfg.ssm_chunk`` steps a chunk) on the CPU.  Decode
is the same call with L = 1.

Recurrence (both variants):  h_t = a_t ⊙ h_{t-1} + b_t,
  a_t = exp(Δ_t A)        (elementwise decay)
  b_t = Δ_t · B_t ⊗ x_t   (input injection)
  y_t = C_t · h_t + D x_t

Caches ``{"conv", "h", "pos"}`` are updated in place; ``pos`` is a host
(CPU) int32 tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.models.layers import Init, dense_init
from repro_torch.sharding.activations import constrain

Cache = dict


def _causal_conv(x, w, b, state: Optional[torch.Tensor]):
    """Depthwise causal conv1d.  x: (B, L, C); w: (K, C); b: (C,).

    ``state``: (B, K-1, C) carry of the previous K-1 inputs (decode), or None
    (left-zero padding).  Returns (y, new_state); every product and sum
    rounds to x's dtype, as the reference's.
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, K-1+L, C)
    l = x.shape[1]
    y = xp[:, 0:l, :] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + l, :] * w[i][None, None]
    y = y + b[None, None]
    new_state = (xp[:, -(k - 1):, :].clone() if k > 1 else torch.zeros(
        (x.shape[0], 0, x.shape[2]), dtype=x.dtype, device=x.device))
    return y, new_state


def _update_cache(cache: Cache, new_conv, h_last, l: int) -> Cache:
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(h_last)
    cache["pos"] += l
    return cache


# =========================================================================
# Mamba1
# =========================================================================
def mamba1_init(ini: Init, cfg):
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, kc = cfg.dt_rank_eff, cfg.ssm_conv
    a_init = torch.arange(1, st + 1, dtype=torch.float32,
                          device=ini.device)[None].expand(di, st)
    return {
        "in_proj": dense_init(ini, (d, 2 * di), d, cfg.dtype),
        "conv_w": dense_init(ini, (kc, di), kc, cfg.dtype),
        "conv_b": ini.full((di,), 0.0, cfg.dtype),
        "x_proj": dense_init(ini, (di, dtr + 2 * st), di, cfg.dtype),
        "dt_proj": dense_init(ini, (dtr, di), dtr, cfg.dtype),
        "dt_bias": ini.full((di,), -4.0, cfg.dtype),   # softplus ≈ small Δ
        "A_log": torch.log(a_init).contiguous(),        # fp32 for stability
        "D": ini.full((di,), 1.0, torch.float32),
        "out_proj": dense_init(ini, (di, d), di, cfg.dtype),
    }


def mamba1_logical(cfg):
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "x_proj": ("ssm_inner", None),
        "dt_proj": ("dt_rank", "ssm_inner"),
        "dt_bias": ("ssm_inner",),
        "A_log": ("ssm_inner", "ssm_state"),
        "D": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def mamba1_cache_logical(cfg):
    return {
        "conv": ("batch", "conv", "ssm_inner"),
        "h": ("batch", "ssm_inner", "ssm_state"),
        "pos": (),
    }


def mamba1_cache_init(cfg, batch: int, dtype, device="cuda") -> Cache:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def mamba1_apply(
    params, x: torch.Tensor, cfg, cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    b, l, _ = x.shape
    di, st, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_eff
    xz = x @ params["in_proj"]
    xs, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                conv_state)
    xs = F.silu(xs.float())
    dbc = xs.to(cfg.dtype) @ params["x_proj"]
    dt = F.softplus(
        (dbc[..., :dtr] @ params["dt_proj"]).float()
        + params["dt_bias"].float())                       # (B, L, di)
    bmat = dbc[..., dtr:dtr + st].float()                  # (B, L, st)
    cmat = dbc[..., dtr + st:].float()                     # (B, L, st)
    a_mat = -torch.exp(params["A_log"].float())            # (di, st)

    h0 = (cache["h"] if cache is not None
          else torch.zeros((b, di, st), dtype=torch.float32, device=x.device))
    # the scan's inputs and state: batch x channels (the rest follows)
    dtx = constrain(dt * xs, "batch", None, "ssm_inner")
    h0 = constrain(h0, "batch", "ssm_inner", "ssm_state")
    y, h_last = selective_scan(dtx, bmat, cmat, dt, a_mat, h0,
                               chunk=cfg.ssm_chunk)
    y = y + params["D"].float()[None, None] * xs
    y = y * F.silu(z.float())
    out = y.to(cfg.dtype) @ params["out_proj"]
    new_cache = None
    if cache is not None:
        new_cache = _update_cache(cache, new_conv, h_last, l)
    return out, new_cache


# =========================================================================
# Mamba2 (SSD): scalar decay per head, grouped B/C
# =========================================================================
def gated_norm(y, z, w, groups: int, eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm, float32: norm(y * silu(z)) over each B/C
    group's d_inner / groups values (Mamba2's RMSNormGated), times w."""
    b, l, di = y.shape
    gated = (y * F.silu(z.float())).reshape(b, l, groups, di // groups)
    var = gated.square().mean(dim=-1, keepdim=True)
    return (gated * torch.rsqrt(var + eps)).reshape(b, l, di) \
        * w.float()[None, None]


def mamba2_init(ini: Init, cfg):
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, g, kc = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_conv
    d_in_proj = 2 * di + 2 * g * st + nh
    conv_dim = di + 2 * g * st
    return {
        "in_proj": dense_init(ini, (d, d_in_proj), d, cfg.dtype),
        "conv_w": dense_init(ini, (kc, conv_dim), kc, cfg.dtype),
        "conv_b": ini.full((conv_dim,), 0.0, cfg.dtype),
        "dt_bias": ini.full((nh,), -4.0, torch.float32),
        "A_log": ini.full((nh,), 0.0, torch.float32),
        "D": ini.full((nh,), 1.0, torch.float32),
        "norm_w": ini.full((di,), 1.0, cfg.dtype),
        "out_proj": dense_init(ini, (di, d), di, cfg.dtype),
    }


def mamba2_logical(cfg):
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm_w": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def mamba2_cache_logical(cfg):
    return {
        "conv": ("batch", "conv", "ssm_inner"),
        "h": ("batch", "ssm_heads", None, "ssm_state"),
        "pos": (),
    }


def mamba2_cache_init(cfg, batch: int, dtype, device="cuda") -> Cache:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "h": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def mamba2_apply(
    params, x: torch.Tensor, cfg, cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    b, l, _ = x.shape
    di, st = cfg.d_inner, cfg.ssm_state
    nh, hd, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups
    proj = x @ params["in_proj"]
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * st]
    dt = proj[..., di + di + 2 * g * st:]                  # (B, L, nh)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xbc = F.silu(xbc.float())
    xs = xbc[..., :di].reshape(b, l, nh, hd)               # (B,L,nh,hd)
    bmat = xbc[..., di:di + g * st].reshape(b, l, g, st)
    cmat = xbc[..., di + g * st:].reshape(b, l, g, st)
    hpg = nh // g
    # each group's B/C broadcast over its heads (a view, no copy)
    bh = bmat[:, :, :, None].expand(b, l, g, hpg, st).reshape(b, l, nh, st)
    ch = cmat[:, :, :, None].expand(b, l, g, hpg, st).reshape(b, l, nh, st)

    dt = F.softplus(dt.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])                        # (nh,)
    h0 = (cache["h"] if cache is not None
          else torch.zeros((b, nh, hd, st), dtype=torch.float32,
                           device=x.device))
    # the scan's inputs and state: batch x heads (the rest follows)
    dtx = constrain(dt[..., None] * xs, "batch", None, "ssm_heads", None)
    h0 = constrain(h0, "batch", "ssm_heads", None, "ssm_state")
    y, h_last = selective_scan(dtx, bh, ch, dt, a, h0,
                               chunk=cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xs
    y = y.reshape(b, l, di)
    y = gated_norm(y, z, params["norm_w"], g, cfg.norm_eps)
    out = y.to(cfg.dtype) @ params["out_proj"]
    new_cache = None
    if cache is not None:
        new_cache = _update_cache(cache, new_conv, h_last, l)
    return out, new_cache
