"""Mixture-of-experts FFN with top-k routing: the reference's GShard grouped
dispatch (``repro/models/moe.py``), the same function, drops included.

Tokens are cut into ``(groups, group_size)``; in each group every token's
top-k experts are ranked by an exclusive cumulative count over the group's
(token, k) pairs in token-major order, and a pair whose rank reaches the
expert's capacity is dropped (its gate weight becomes 0 after the top-k
renormalisation).  The router runs in float32; the auxiliary loss is the
Switch load-balance loss ``E * sum(me * ce)``.

Where the reference builds one-hot dispatch and combine tensors (G, S, E,
C) and contracts them with einsums, the port moves the same values by
index: each expert slot gathers its token's row (an empty slot reads a
zero row), the experts run as three batched matmuls over (E, G * C, ·),
and each token gathers its k slots' outputs and sums them, weighted, in
float32 in a fixed order (k = 0 .. top_k - 1), then rounds once as the
reference's combine einsum does.  Nothing scatters floats, so the result
does not move from run to run (no ``index_add_`` atomics), which the
bit-exact decode resume relies on.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Init, dense_init, mlp_apply, mlp_init


def moe_init(ini: Init, cfg):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    params = {
        "router": dense_init(ini, (d, e), d, torch.float32),
        "w_gate": dense_init(ini, (e, d, f), d, cfg.dtype),
        "w_up": dense_init(ini, (e, d, f), d, cfg.dtype),
        "w_down": dense_init(ini, (e, f, d), f, cfg.dtype),
    }
    if cfg.n_shared_experts:
        params["shared"] = mlp_init(
            ini, cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return params


def _capacity(group_size: int, cfg) -> int:
    """Slots per expert and group: the reference's rule (rounded up to a
    multiple of 8, at least ``top_k``), which decides which tokens drop."""
    raw = group_size * cfg.top_k / cfg.n_experts * cfg.capacity_factor
    return max(cfg.top_k, int(math.ceil(raw / 8.0)) * 8)


def _group(t: int, cfg) -> int:
    """Tokens per dispatch group: the largest divisor of ``t`` that is at
    most ``moe_group_size``."""
    s = min(cfg.moe_group_size, t)
    while t % s:
        s -= 1
    return s


def route(params, xg: torch.Tensor, cfg):
    """Routing of grouped tokens xg (G, S, D): ``(gate_idx (G, S, k) int64,
    gate (G, S, k) float32 renormalised with dropped pairs 0, pos (G, S,
    k) slot of each pair in its expert's buffer, keep (G, S, k) bool,
    aux)``."""
    g, s, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, cfg)
    probs = torch.softmax(xg.float() @ params["router"], dim=-1)  # (G,S,E)
    gate, gate_idx = torch.topk(probs, k, dim=-1)                 # sorted
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # exclusive count of earlier (token, k) pairs on the same expert
    onehot = F.one_hot(gate_idx.reshape(g, s * k), e).to(torch.int32)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(before, 2, gate_idx.reshape(g, s * k, 1)).reshape(
        g, s, k)
    keep = pos < c

    # Switch-style load-balance loss (global mean over groups)
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(dim=1).sum(dim=0).to(torch.float32) / (g * s)
    aux = e * torch.sum(me * ce)
    return gate_idx, gate * keep, pos, keep, aux


def moe_apply(params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Returns (output (B, L, D), aux_loss float32 scalar)."""
    b, l, d = x.shape
    t = b * l
    e = cfg.n_experts
    s = _group(t, cfg)
    g = t // s
    c = _capacity(s, cfg)
    xg = x.reshape(g, s, d)
    gate_idx, gate, pos, keep, aux = route(params, xg, cfg)

    # slot (expert, capacity index) -> token of its group; empty slots, and
    # the one dummy column every dropped pair writes to, read row s (zeros)
    dest = torch.where(keep, gate_idx * c + pos, e * c).reshape(g, -1)
    src = torch.arange(s, device=x.device).repeat_interleave(cfg.top_k)
    tok = torch.full((g, e * c + 1), s, dtype=torch.long, device=x.device)
    tok.scatter_(1, dest, src.expand(g, -1))
    tok = tok[:, :e * c].reshape(g, e, c).permute(1, 0, 2)        # (E, G, C)
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    gi = torch.arange(g, device=x.device)
    expert_in = xg_pad[gi[None, :, None], tok].reshape(e, g * c, d)

    h = F.silu((expert_in @ params["w_gate"]).float()).to(x.dtype) * (
        expert_in @ params["w_up"])
    expert_out = (h @ params["w_down"]).reshape(e, g, c, d)

    # combine: each token's k slots, weighted, summed in float32 in k order;
    # the weights rounded to the activations' dtype as the reference's
    # combine tensor is
    w = gate.to(x.dtype).float()
    slot = pos.clamp(max=c - 1).long()
    out = torch.zeros((g, s, d), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        got = expert_out[gate_idx[..., j], gi[:, None], slot[..., j]]
        out += got.float() * w[..., j, None]
    out = out.to(x.dtype)
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], xg)
    return out.reshape(b, l, d), aux
