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

On a mesh (DTensor activations) :func:`_mesh_moe` runs the same steps on
each rank's own groups, with the experts split over the model axis as
the reference's constraints pin them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    Init, dense_init, mlp_apply, mlp_init, mlp_logical,
)
from repro_torch.sharding.activations import current_rules, is_dtensor


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


def moe_logical(cfg):
    out = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared_experts:
        out["shared"] = mlp_logical(cfg)
    return out


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
    gate_idx, gate, pos, keep, me, ce = _route(params["router"], xg, cfg)
    return gate_idx, gate, pos, keep, cfg.n_experts * torch.sum(me * ce)


def _route(router, xg: torch.Tensor, cfg):
    """:func:`route`, with the load-balance loss's two means (router
    probability ``me`` and routed fraction ``ce``, each (E,) over the
    groups given) in place of the loss."""
    g, s, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, cfg)
    probs = torch.softmax(xg.float() @ router, dim=-1)            # (G,S,E)
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
    return gate_idx, gate * keep, pos, keep, me, ce


def _dispatch(xg, gate_idx, pos, keep, cfg) -> torch.Tensor:
    """Each expert slot's token row: (E, G, C, D); an empty slot, and the
    one dummy column every dropped pair writes to, read row S (zeros)."""
    g, s, d = xg.shape
    e = cfg.n_experts
    c = _capacity(s, cfg)
    dest = torch.where(keep, gate_idx * c + pos, e * c).reshape(g, -1)
    src = torch.arange(s, device=xg.device).repeat_interleave(cfg.top_k)
    tok = torch.full((g, e * c + 1), s, dtype=torch.long, device=xg.device)
    tok.scatter_(1, dest, src.expand(g, -1))
    tok = tok[:, :e * c].reshape(g, e, c).permute(1, 0, 2)        # (E, G, C)
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    gi = torch.arange(g, device=xg.device)
    return xg_pad[gi[None, :, None], tok]


def _experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their slots: (E, G, C, D) -> (E, G, C, D),
    three batched matmuls over (E, G * C, .)."""
    e, g, c, d = expert_in.shape
    x = expert_in.reshape(e, g * c, d)
    h = F.silu((x @ params["w_gate"]).float()).to(x.dtype) * (
        x @ params["w_up"])
    return (h @ params["w_down"]).reshape(e, g, c, d)


def _combine(expert_out, gate_idx, gate, pos, cfg) -> torch.Tensor:
    """Each token's k slots, weighted, summed in float32 in k order; the
    weights rounded to the activations' dtype as the reference's combine
    tensor is.  (E, G, C, D) -> (G, S, D)."""
    _, g, c, d = expert_out.shape
    s = gate_idx.shape[1]
    w = gate.to(expert_out.dtype).float()
    slot = pos.clamp(max=c - 1).long()
    gi = torch.arange(g, device=expert_out.device)
    out = torch.zeros((g, s, d), dtype=torch.float32,
                      device=expert_out.device)
    for j in range(cfg.top_k):
        got = expert_out[gate_idx[..., j], gi[:, None], slot[..., j]]
        out += got.float() * w[..., j, None]
    return out.to(expert_out.dtype)


def moe_apply(params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Returns (output (B, L, D), aux_loss float32 scalar)."""
    if is_dtensor(x):
        return _mesh_moe(params, x, cfg)
    b, l, d = x.shape
    xg = x.reshape(-1, _group(b * l, cfg), d)
    gate_idx, gate, pos, keep, aux = route(params, xg, cfg)
    expert_out = _experts(params, _dispatch(xg, gate_idx, pos, keep, cfg))
    out = _combine(expert_out, gate_idx, gate, pos, cfg)
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], xg)
    return out.reshape(b, l, d), aux


def _group_placements(x, s: int) -> list:
    """x's placements with each rank's tokens in whole groups of ``s``: the
    batch split kept over the mesh dimensions (in order) for which every
    rank's rows still hold whole groups, every other split undone."""
    from torch.distributed.tensor import Replicate, Shard

    b, l, _ = x.shape
    out, n = [], 1
    for size, pl in zip(x.device_mesh.shape, x.placements):
        keep = (isinstance(pl, Shard) and pl.dim == 0
                and b % (n * size) == 0 and (b // (n * size) * l) % s == 0)
        n *= size if keep else 1
        out.append(Shard(0) if keep else Replicate())
    return out


def _mesh_moe(params, x, cfg):
    """:func:`moe_apply` on DTensors, each step a ``local_map`` (the ops of
    one device on each rank's part).  Groups never cross ranks: each rank
    routes and dispatches its own groups; runs its experts (split over the
    rules' experts axis where that axis does not split the groups: expert
    parallelism) on them; gathers the experts' outputs for its groups and
    combines them.  The load-balance loss's means come back partial over
    the mesh dimensions that split the groups (each rank's share of the
    global mean)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    b, l, d = x.shape
    s = _group(b * l, cfg)
    xp = _group_placements(x, s)
    if tuple(x.placements) != tuple(xp):
        x = x.redistribute(mesh, xp)
    split = [isinstance(pl, Shard) for pl in xp]
    n_split = math.prod(n for n, sp in zip(mesh.shape, split) if sp)
    whole = [Replicate()] * mesh.ndim
    part = [Partial() if sp else Replicate() for sp in split]
    per_group = [Shard(0) if sp else Replicate() for sp in split]
    per_slot = [Shard(1) if sp else Replicate() for sp in split]
    router = params["router"]
    router = (router.redistribute(mesh, whole) if is_dtensor(router)
              else router)

    def dispatch(xl, rl):
        xg = xl.reshape(-1, s, d)
        gate_idx, gate, pos, keep, me, ce = _route(rl, xg, cfg)
        return (_dispatch(xg, gate_idx, pos, keep, cfg), gate_idx, gate,
                pos, me / n_split, ce / n_split)

    expert_in, gate_idx, gate, pos, me, ce = local_map(
        dispatch, device_mesh=mesh, in_placements=(xp, whole),
        in_grad_placements=(xp, part),
        out_placements=(per_slot, per_group, per_group, per_group, part,
                        part))(x, router)
    aux = cfg.n_experts * torch.sum(me * ce)

    # the experts as the reference pins their slots and weights (experts
    # over the model axis, groups over the batch axes): each rank runs its
    # experts on its groups, with the weights whole but for the expert split
    rules = current_rules()
    ax = rules.physical("experts") if rules is not None else None
    on_e = [name == ax and not sp and cfg.n_experts % n == 0
            for name, n, sp in zip(mesh.mesh_dim_names, mesh.shape, split)]
    slot_pl = [Shard(0) if ep else pl for ep, pl in zip(on_e, per_slot)]
    w_pl = [Shard(0) if ep else Replicate() for ep in on_e]
    w_grad = [Shard(0) if ep else pl for ep, pl in zip(on_e, part)]
    names = ("w_gate", "w_up", "w_down")
    ws = {n: params[n].redistribute(mesh, w_pl) for n in names}
    expert_out = local_map(
        lambda xi, wg, wu, wd: _experts(
            {"w_gate": wg, "w_up": wu, "w_down": wd}, xi),
        device_mesh=mesh, out_placements=slot_pl,
        in_placements=(slot_pl, w_pl, w_pl, w_pl),
        in_grad_placements=(slot_pl, w_grad, w_grad, w_grad))(
        expert_in.redistribute(mesh, slot_pl), *(ws[n] for n in names))
    expert_out = expert_out.redistribute(mesh, per_slot)
    out = local_map(
        lambda eo, gi, gt, ps: _combine(eo, gi, gt, ps, cfg).reshape(
            -1, l, d),
        device_mesh=mesh, out_placements=xp,
        in_placements=(per_slot, per_group, per_group, per_group),
        in_grad_placements=(per_slot, per_group, per_group, per_group))(
        expert_out, gate_idx, gate, pos)
    if cfg.n_shared_experts:
        out = out + mlp_apply(params["shared"], x)
    return out, aux
